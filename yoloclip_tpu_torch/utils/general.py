"""General utilities the CLIs use. Counterpart of the seeding part of
`yoloclip_tpu/utils/general.py`."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed Python's and numpy's global generators and return an explicit
    torch.Generator seeded with `seed` (torch randomness in the port is
    drawn from generators passed by the caller, never the global one)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
    return torch.Generator().manual_seed(seed)
