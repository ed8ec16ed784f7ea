"""The general traffic generator: every traffic file under
`perfbench/traffic/` is parameters that these functions read.

Every seed gets the same work: the same number of batches of frames of
the file's size, drawn from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.lib import weights


def batch_pool(traffic: Dict, seed: int, device) -> List[np.ndarray]:
    """`pool_batches` batches of `batch` seeded uint8 frames of
    `frame_hw`, in pageable host memory."""
    hw = tuple(traffic['frame_hw'])
    return [weights.frames(traffic['batch'], hw, seed, salt=1 + i,
                           device=device)
            for i in range(traffic['pool_batches'])]
