# Copy of dumphfdl_tpu/ops/bits.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Bit-order helpers shared by the FEC path and protocol stack.

HFDL transmits user data LSB-first within each octet relative to the
Viterbi chainback's MSB-first packing; the reference applies REVERSE_BYTE
to every decoded octet (reference src/hfdl.c:1051-1053,
reference src/util.h:97-104).
"""

from __future__ import annotations

import numpy as np

_REV = np.array([int(f'{i:08b}'[::-1], 2) for i in range(256)], dtype=np.uint8)


def reverse_bytes(data: np.ndarray) -> np.ndarray:
    """Bit-reverse each octet of a uint8 array."""
    return _REV[np.asarray(data, dtype=np.uint8)]


def bytes_to_bits_lsb_first(data: bytes | np.ndarray) -> np.ndarray:
    """Expand octets to a bit stream, LSB of each octet first (TX order)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, dtype=np.uint8)
    return np.unpackbits(arr, bitorder='little').astype(np.int8)


def bits_to_bytes_lsb_first(bits: np.ndarray) -> np.ndarray:
    """Pack a bit stream into octets, first bit -> LSB of first octet."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), bitorder='little')


def bytes_to_bits_msb_first(data: bytes | np.ndarray) -> np.ndarray:
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, dtype=np.uint8)
    return np.unpackbits(arr).astype(np.int8)


def bits_to_bytes_msb_first(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8))
