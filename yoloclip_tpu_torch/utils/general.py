"""General utilities: seeding, YAML IO, logging, timing, run dirs.
Counterpart of `yoloclip_tpu/utils/general.py` (copied, not imported).

The JAX module's `enable_compile_cache` has no counterpart: the port
compiles nothing at run time but its CUDA kernels, and `_build.py`'s
build directory (`_kernels/`) already is their cache.
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import time
from typing import Any, Dict, Optional

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


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


def save_yaml(data: Dict[str, Any], path: str) -> None:
    import yaml
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, 'w') as f:
        yaml.safe_dump(data, f, sort_keys=False)


def setup_logger(name: str = 'yoloclip_tpu_torch',
                 log_file: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter(
        '%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        d = os.path.dirname(log_file)
        if d:
            os.makedirs(d, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class Timer:
    """Context-manager stopwatch. CUDA work is asynchronous: `.block(x)`
    waits for the device holding x (a tensor, or a dict / list of them),
    and entry and exit synchronise the current CUDA device (where CUDA is
    in use), so `elapsed` covers the device work launched inside."""

    def __init__(self, name: str = '',
                 logger: Optional[logging.Logger] = None):
        self.name = name
        self.logger = logger
        self.elapsed = 0.0
        self._start = None

    def __enter__(self):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._start = time.perf_counter()
        return self

    def block(self, x):
        from yoloclip_tpu_torch.utils.profiling import _synchronize
        _synchronize(x)
        return x

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._start
        if self.logger:
            self.logger.info('%s took %.4fs', self.name or 'block',
                             self.elapsed)
        return False


def create_unique_output_dir(base_dir: str, prefix: str = 'run') -> str:
    """Create base/prefix_NNN with the first free index."""
    os.makedirs(base_dir, exist_ok=True)
    i = 0
    while True:
        path = os.path.join(base_dir, f'{prefix}_{i:03d}')
        if not os.path.exists(path):
            os.makedirs(path)
            return path
        i += 1


def copy_code_to_dir(output_dir: str, src_dir: Optional[str] = None) -> str:
    """Snapshot the package source into the run dir for reproducibility
    (not the built kernels under `_kernels/`)."""
    if src_dir is None:
        src_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(output_dir, 'code')
    shutil.copytree(src_dir, dst,
                    ignore=shutil.ignore_patterns('__pycache__', '*.pyc',
                                                  '_kernels'),
                    dirs_exist_ok=True)
    return dst
