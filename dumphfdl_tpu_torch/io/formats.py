# Copy of dumphfdl_tpu/io/formats.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Raw I/Q sample-format conversion (CU8 / CS16 / CF32 -> complex64).

Scaling matches reference src/input-helpers.c:94-126: CU8 divides by
127 after mid-shift of 63.5, CS16 divides by 32767.5, CF32 passes through.
"""

from __future__ import annotations

import numpy as np

SAMPLE_FORMATS = ('CU8', 'CS16', 'CF32')

_BYTES_PER_SAMPLE = {'CU8': 2, 'CS16': 4, 'CF32': 8}
_FULL_SCALE = {'CU8': 127.0, 'CS16': 32767.5, 'CF32': 1.0}


def bytes_per_sample(fmt: str) -> int:
    return _BYTES_PER_SAMPLE[fmt.upper()]


def full_scale(fmt: str) -> float:
    return _FULL_SCALE[fmt.upper()]


def silence_byte(fmt: str) -> int:
    """Pad byte representing (near-)zero signal: CU8 is offset-binary, so
    zero bytes would be a -0.5 DC step (input-helpers.c:96)."""
    return 64 if fmt.upper() == 'CU8' else 0


def convert(raw: bytes | np.ndarray, fmt: str) -> np.ndarray:
    """Raw bytes -> normalized complex64 samples.

    Uses the native C++ converters (io/native.py) when available."""
    from . import native
    fmt = fmt.upper()
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(raw, dtype=np.uint8)
    raw = raw[:len(raw) - len(raw) % _BYTES_PER_SAMPLE[fmt]]
    if fmt == 'CU8':
        out = native.convert_cu8(raw)
        if out is not None:
            return out
        v = raw.astype(np.float32)
        iq = (v - 127.0 / 2.0) / 127.0
        return (iq[0::2] + 1j * iq[1::2]).astype(np.complex64)
    if fmt == 'CS16':
        out = native.convert_cs16(raw)
        if out is not None:
            return out
        v = raw.view(np.int16).astype(np.float32) / 32767.5
        return (v[0::2] + 1j * v[1::2]).astype(np.complex64)
    if fmt == 'CF32':
        v = raw.view(np.float32)
        return (v[0::2] + 1j * v[1::2]).astype(np.complex64)
    raise ValueError(f'unknown sample format {fmt}')


def serialize(samples: np.ndarray, fmt: str) -> bytes:
    """complex64 -> raw bytes (test-vector generation)."""
    fmt = fmt.upper()
    i = np.real(samples)
    q = np.imag(samples)
    inter = np.empty(2 * len(samples), dtype=np.float32)
    inter[0::2] = i
    inter[1::2] = q
    if fmt == 'CF32':
        return inter.astype(np.float32).tobytes()
    if fmt == 'CS16':
        return np.clip(np.round(inter * 32767.5), -32768, 32767) \
            .astype(np.int16).tobytes()
    if fmt == 'CU8':
        return np.clip(np.round(inter * 127.0 + 63.5), 0, 255) \
            .astype(np.uint8).tobytes()
    raise ValueError(f'unknown sample format {fmt}')
