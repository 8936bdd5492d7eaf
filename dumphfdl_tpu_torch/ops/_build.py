"""Build the hand-written CUDA kernels from ``csrc/*.cu`` at first use.

All sources compile in one call into ``build/kernels/`` at the repo root
(listed in ``.gitignore``), for ``sm_90a`` only.  The sources expose a
plain C interface and include no PyTorch header, so a build takes seconds
rather than minutes; the wrappers bind them with ``ctypes`` and pass
``tensor.data_ptr()`` and the current stream.

``torch.utils.cpp_extension.load`` drives the build when ``ninja`` is
present; without it ``nvcc`` is invoked directly.  ``--fmad=false`` keeps
every float multiply and add separately rounded, as PyTorch's elementwise
ops round them, so the tracker kernel can reproduce its plain version's
arithmetic.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NAME = 'dumphfdl_kernels'
CUDA_FLAGS = ['-O3', '-gencode=arch=compute_90a,code=sm_90a', '--fmad=false',
              '-std=c++17']

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in ([os.path.join(CUDA_HOME, 'bin', 'nvcc')] if CUDA_HOME else []) \
            + [shutil.which('nvcc') or '']:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (CUDA_HOME and PATH searched)')


def _build() -> pathlib.Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(str(p) for p in CSRC.glob('*.cu'))
    if shutil.which('ninja'):
        from torch.utils.cpp_extension import load
        path = load(name=NAME, sources=sources,
                    build_directory=str(BUILD_DIR),
                    extra_cuda_cflags=CUDA_FLAGS, is_python_module=False)
        build_info['route'] = 'torch.utils.cpp_extension.load'
        return pathlib.Path(path)
    out = BUILD_DIR / f'lib{NAME}.so'
    cmd = [_nvcc(), *CUDA_FLAGS, '-shared', '-Xcompiler', '-fPIC', '-o', str(out),
           *sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f'nvcc failed ({res.returncode}): {" ".join(cmd)}\n'
                           + res.stdout + res.stderr)
    build_info['route'] = 'nvcc -shared'
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path = _build()
            lib = ctypes.CDLL(str(path))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.hfdl_viterbi.argtypes = [p, p, i, i, p]
            lib.hfdl_viterbi.restype = i
            lib.hfdl_tracker.argtypes = [p] * 16 + [i, i] + [f] * 4 + [p]
            lib.hfdl_tracker.restype = i
            lib.hfdl_error_string.argtypes = [i]
            lib.hfdl_error_string.restype = ctypes.c_char_p
            build_info['seconds'] = time.perf_counter() - t0
            build_info['path'] = str(path)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err:
        raise RuntimeError(f'{what}: CUDA error {err} '
                           f'({lib.hfdl_error_string(err).decode()})')
