"""Build the CUDA kernels under `csrc/` with nvcc, and the host library
under `native/` with g++, and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions (no PyTorch headers), so a
build takes seconds. The first call to `load(name)` in a process compiles
the source for Hopper (`sm_90a`) into `_kernels/lib<name>.so` next to this
file (listed in .gitignore) and loads it; later calls reuse the loaded
library. A library already on disk is rebuilt when its source is newer.

Every exported launcher returns `cudaGetLastError()` as an int; callers
pass the result to `check`.

`load_native(name)` does the same for the host C++ source
`native/<name>.cpp` with g++ and the flags of the JAX package's
`native/Makefile`, into `_kernels/libycl_<name>.so`. Without the
libjpeg/libpng headers it builds the source again with -DYCL_NO_CODECS
(letterbox only); the library's `ycl_has_codecs()` says which build it is.
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
NATIVE = _HERE / 'native'
BUILD_DIR = _HERE / '_kernels'

# yoloclip_tpu/native/Makefile's CXXFLAGS and LIBS
_GXX_FLAGS = ['-O3', '-march=native', '-fPIC', '-shared', '-std=c++17',
              '-Wall']
_CODEC_LIBS = ['-ljpeg', '-lpng']

# Per-source extra flags. nms.cu and int8_conv.cu must not contract their
# arithmetic into FMAs: the keep mask and the int8 conv's pre-SiLU values
# are compared bit for bit with the plain PyTorch versions, whose
# elementwise ops each round separately.
_EXTRA_FLAGS: Dict[str, List[str]] = {
    'similarity': [],
    'nms': ['-fmad=false'],
    'int8_conv': ['-fmad=false'],
}
KERNELS = tuple(_EXTRA_FLAGS)

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


def _gxx() -> str:
    path = shutil.which('g++')
    if path is None:
        raise RuntimeError('g++ not found: the native host library of '
                           'yoloclip_tpu_torch needs a C++ compiler')
    return path


def _native_out(name: str) -> Path:
    return BUILD_DIR / f'libycl_{name}.so'


def compile_native(name: str = 'dataload') -> str:
    """g++ `native/<name>.cpp` into `_kernels/libycl_<name>.so`, with the
    JPEG/PNG codecs, or with -DYCL_NO_CODECS when that build fails (no
    libjpeg/libpng headers). Returns which build it made and g++'s
    messages."""
    src = NATIVE / f'{name}.cpp'
    out = _native_out(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.so.tmp{os.getpid()}.{threading.get_ident()}')
    base = [_gxx(), *_GXX_FLAGS, '-o', str(tmp), str(src)]
    full = subprocess.run(base + _CODEC_LIBS + ['-lpthread'],
                          capture_output=True, text=True)
    kind = 'with JPEG/PNG codecs'
    if full.returncode != 0:
        bare = subprocess.run(base + ['-DYCL_NO_CODECS', '-lpthread'],
                              capture_output=True, text=True)
        if bare.returncode != 0:
            raise RuntimeError(f'g++ failed for {src}:\n{full.stderr}\n'
                               f'without codecs:\n{bare.stderr}')
        kind = ('without codecs (-DYCL_NO_CODECS; the build with them '
                f'failed: {full.stderr.strip().splitlines()[0]})')
    os.replace(tmp, out)
    return kind


def load_native(name: str = 'dataload') -> ctypes.CDLL:
    """Build (if missing or older than its source) and load
    `native/<name>.cpp`; the loaded library is cached per process."""
    key = f'native/{name}'
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        out, src = _native_out(name), NATIVE / f'{name}.cpp'
        if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
            compile_native(name)
        lib = ctypes.CDLL(str(out))
        _libs[key] = lib
        return lib


def build_all(names: Sequence[str] = KERNELS,
              native: Sequence[str] = ('dataload',)) -> Dict[str, str]:
    """Compile every kernel source and native library from scratch, one
    nvcc or g++ per source, all started together, then load them. Call
    before any of them has been loaded in the process (chip_smoke.py
    does). Returns ptxas's report per kernel source and which build each
    native library got."""
    with ThreadPoolExecutor(len(names) + len(native)) as pool:
        jobs = {name: pool.submit(_compile, name) for name in names}
        jobs.update({f'native/{n}': pool.submit(compile_native, n)
                     for n in native})
        reports = {name: job.result() for name, job in jobs.items()}
    for name in names:
        load(name)
    for name in native:
        load_native(name)
    return reports


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (launch refused, bad
    configuration, or an earlier asynchronous fault)."""
    if err != 0:
        msg = lib.yc_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
