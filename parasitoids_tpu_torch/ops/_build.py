"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, under ``build/kernels/`` of
the checkout.  The library's name carries a hash of the source and flags,
so an edited source is rebuilt and a stale build is never loaded.  Nothing
here runs at import: the CPU-only test hosts have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

__all__ = ['BUILD_DIR', 'NVCC_FLAGS', 'load', 'nvcc_path']

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# C signatures of each source's exported functions: name -> argtypes
_SIGNATURES = {
    'day_kernel': {
        'parasitoids_day_smem_bytes': [_INT],
        'parasitoids_day_accumulate': [_VP] * 4 + [_INT] * 5 + [_VP] * 6 +
                                      [_VP],
        'parasitoids_day_accumulate_timed': [_VP] * 4 + [_INT] * 5 +
                                            [_VP] * 6 + [_INT, _VP, _VP],
        'parasitoids_day_bwd_smem_bytes': [_INT, _INT],
        'parasitoids_day_accumulate_bwd': [_VP] * 6 + [_INT] * 4 +
                                          [_VP] * 6 + [_VP],
        'parasitoids_day_accumulate_bwd_timed': [_VP] * 6 + [_INT] * 4 +
                                                [_VP] * 6 + [_INT, _VP, _VP],
        'parasitoids_lattice_probe': [_VP, _VP, _INT, _INT] + [_VP] * 4,
    },
}


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit that PyTorch finds (``CUDA_HOME``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found (CUDA_HOME unset and no '
                           'nvcc on PATH): the CUDA kernels cannot be built')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; returns the library
    with ``argtypes``/``restype`` set for every exported function."""
    src = CSRC_DIR / (name + '.cu')
    digest = hashlib.sha256(src.read_bytes() +
                            ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / '{}-{}.so'.format(name, digest)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, '-o', tmp,
                                   str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed on {}:\n{}{}'.format(
                    src, proc.stdout, proc.stderr))
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
