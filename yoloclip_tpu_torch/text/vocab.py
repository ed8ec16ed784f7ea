"""Offline vocabulary loading. Counterpart of
`yoloclip_tpu/text/vocab.py::VocabularyBuilder.load_offline_vocabulary`.

The file is JSON, {class name: [E floats]}, as the JAX package writes it.
Building a vocabulary needs the text tower, which is not ported yet.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np


def load_offline_vocabulary(path: str) -> Dict[str, np.ndarray]:
    """JSON vocabulary -> {class name: float32 (E,) array}, file order."""
    with open(path) as f:
        raw = json.load(f)
    return {k: np.asarray(v, np.float32) for k, v in raw.items()}
