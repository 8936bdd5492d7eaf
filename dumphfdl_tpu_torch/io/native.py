# Copy of dumphfdl_tpu/io/native.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""ctypes bindings for the native host runtime (native/hfdl_host.cpp).

Provides the C++ SPSC sample ring and sample-format converters; every
entry point has a numpy fallback so the framework runs without the
compiled library (it is built on demand with `make -C native`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), '..', '..', 'native')
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, 'libhfdl_host.so'))
_lib = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL | None:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(['make', '-C', os.path.abspath(_NATIVE_DIR)],
                               check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.hfdl_ring_create.restype = ctypes.c_void_p
        lib.hfdl_ring_create.argtypes = [ctypes.c_int64]
        lib.hfdl_ring_destroy.argtypes = [ctypes.c_void_p]
        for fn in ('hfdl_ring_size', 'hfdl_ring_space', 'hfdl_ring_overruns'):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ('hfdl_ring_write', 'hfdl_ring_read'):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_float),
                                         ctypes.c_int64]
        lib.hfdl_convert_cu8.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                         ctypes.POINTER(ctypes.c_float),
                                         ctypes.c_int64]
        lib.hfdl_convert_cs16.argtypes = [ctypes.POINTER(ctypes.c_int16),
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def convert_cu8(raw: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(len(raw), dtype=np.float32)
    lib.hfdl_convert_cu8(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         len(raw))
    return out.view(np.complex64)


def convert_cs16(raw: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw).view(np.int16)
    out = np.empty(len(raw), dtype=np.float32)
    lib.hfdl_convert_cs16(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          len(raw))
    return out.view(np.complex64)


class SampleRing:
    """Lock-free SPSC complex64 ring (native; numpy-deque fallback)."""

    def __init__(self, capacity: int):
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.hfdl_ring_create(capacity)
            if not self._h:
                raise MemoryError('hfdl_ring_create failed')
        else:
            self._h = None
            self._buf = np.zeros(0, dtype=np.complex64)
            self._fallback_lock = threading.Lock()
            self._capacity = capacity
            self.overruns_py = 0

    def write(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, dtype=np.complex64)
        if self._h is not None:
            ptr = samples.view(np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))
            return int(self._lib.hfdl_ring_write(self._h, ptr, len(samples)))
        with self._fallback_lock:
            space = self._capacity - len(self._buf)
            n = min(space, len(samples))
            self.overruns_py += len(samples) - n
            self._buf = np.concatenate([self._buf, samples[:n]])
            return n

    def read(self, n: int) -> np.ndarray:
        if self._h is not None:
            out = np.empty(n, dtype=np.complex64)
            ptr = out.view(np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))
            got = int(self._lib.hfdl_ring_read(self._h, ptr, n))
            return out[:got]
        with self._fallback_lock:
            out = self._buf[:n].copy()
            self._buf = self._buf[n:]
            return out

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.hfdl_ring_size(self._h))
        with self._fallback_lock:
            return len(self._buf)

    @property
    def overruns(self) -> int:
        if self._h is not None:
            return int(self._lib.hfdl_ring_overruns(self._h))
        return self.overruns_py

    def close(self):
        if self._h is not None:
            self._lib.hfdl_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
