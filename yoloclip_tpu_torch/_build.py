"""Build the CUDA kernels under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions (no PyTorch headers), so a
build takes seconds. The first call to `load(name)` in a process compiles
the source for Hopper (`sm_90a`) into `_kernels/lib<name>.so` next to this
file (listed in .gitignore) and loads it; later calls reuse the loaded
library. A library already on disk is rebuilt when its source is newer.

Every exported launcher returns `cudaGetLastError()` as an int; callers
pass the result to `check`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / 'csrc'
BUILD_DIR = _HERE / '_kernels'

# Per-source extra flags. nms.cu must not contract its IoU arithmetic into
# FMAs: its keep mask is compared bit for bit with the plain PyTorch
# version, whose elementwise ops each round separately.
_EXTRA_FLAGS: Dict[str, List[str]] = {
    'similarity': [],
    'nms': ['-fmad=false'],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which('nvcc')
    if path is None and Path('/usr/local/cuda/bin/nvcc').exists():
        path = '/usr/local/cuda/bin/nvcc'
    if path is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'yoloclip_tpu_torch need the CUDA toolkit')
    return path


def _compile(name: str) -> str:
    """nvcc `csrc/<name>.cu` into `_kernels/lib<name>.so`; returns ptxas's
    report (registers, shared memory and spills of each kernel)."""
    src = CSRC / f'{name}.cu'
    out = BUILD_DIR / f'lib{name}.so'
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.so.tmp{os.getpid()}.{threading.get_ident()}')
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
           '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
           '-Xptxas=-v', *_EXTRA_FLAGS[name], '-o', str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {src}:\n{proc.stdout}\n'
                           f'{proc.stderr}')
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return proc.stdout + proc.stderr


def load(name: str, rebuild: bool = False) -> ctypes.CDLL:
    """Build (if needed, or always with rebuild=True) and load
    `csrc/<name>.cu`; the loaded library is cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = BUILD_DIR / f'lib{name}.so'
        src = CSRC / f'{name}.cu'
        if (rebuild or not out.exists()
                or out.stat().st_mtime < src.stat().st_mtime):
            _compile(name)
        lib = ctypes.CDLL(str(out))
        lib.yc_error_string.argtypes = [ctypes.c_int]
        lib.yc_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def build_all(names: Sequence[str] = ('similarity', 'nms')
              ) -> Dict[str, str]:
    """Compile every kernel source from scratch, one nvcc per source, all
    started together, then load them. Call before any kernel has run in
    the process (chip_smoke.py does). Returns ptxas's report per source."""
    with ThreadPoolExecutor(len(names)) as pool:
        jobs = {name: pool.submit(_compile, name) for name in names}
        reports = {name: job.result() for name, job in jobs.items()}
    for name in names:
        load(name)
    return reports


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (launch refused, bad
    configuration, or an earlier asynchronous fault)."""
    if err != 0:
        msg = lib.yc_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
