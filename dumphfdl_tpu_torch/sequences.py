# Copy of dumphfdl_tpu/sequences.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""HFDL synchronization and scrambling sequences.

Protocol constants per ICAO Doc 9741; values cross-checked against the
reference decoder (reference src/hfdl.c:419-466, 300-346).  All
sequences are exposed as numpy int8 arrays of {0,1} bits plus bipolar
{+1,-1} helpers (bit 0 -> +1.0, matching BPSK mapping).
"""

from __future__ import annotations

import functools

import numpy as np

from . import constants as C

# The A preamble is distributed as 16 octets (128 bits MSB-first) of which
# the leading bit is masked off, leaving 127 chips (hfdl.c:420-439 and the
# 127-bit window semantics of liquid bsequence_init).
_A_OCTETS = bytes([
    0b01011011, 0b10111100, 0b01110100, 0b01010111,
    0b00000011, 0b11011001, 0b10001001, 0b00111001,
    0b11110010, 0b00001000, 0b11010101, 0b00110110,
    0b10010100, 0b00101100, 0b00110010, 0b11111110,
])

# The M1 base sequence: 127 bits; each of the 8 modes transmits the cyclic
# shift starting at offset M_SHIFTS[mode] (hfdl.c:441-459).
_M1_BASE_BITS = [
    0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0, 0,
    1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1,
    0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 1, 1,
    0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1,
    1, 1, 1, 0, 0, 1, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
]


def _octets_to_bits_msb_first(octets: bytes) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(octets, dtype=np.uint8))
    return bits.astype(np.int8)


@functools.cache
def a_bits() -> np.ndarray:
    """127-chip A preamble sequence, oldest chip first."""
    return _octets_to_bits_msb_first(_A_OCTETS)[1:].copy()


@functools.cache
def m1_base_bits() -> np.ndarray:
    return np.array(_M1_BASE_BITS, dtype=np.int8)


@functools.cache
def m1_bits(mode: int) -> np.ndarray:
    """127-chip M1 sequence for the given mode (cyclic shift of the base)."""
    base = m1_base_bits()
    return np.roll(base, -C.M_SHIFTS[mode]).copy()


@functools.cache
def m1_bits_all() -> np.ndarray:
    """(8, 127) stack of all mode M1 sequences."""
    return np.stack([m1_bits(m) for m in range(C.M_SHIFT_CNT)])


@functools.cache
def m2_bits(mode: int) -> np.ndarray:
    """15-chip M2 sequence: leading 15 chips of the shifted M1 (hfdl.c:456-458)."""
    return m1_bits(mode)[:C.M2_LEN].copy()


@functools.cache
def t_bits() -> np.ndarray:
    """15-bit training sequence 0x9AF, MSB first (hfdl.c:181, 952-961)."""
    v = C.T_BITS_VALUE
    return np.array([(v >> (C.T_LEN - 1 - i)) & 1 for i in range(C.T_LEN)],
                    dtype=np.int8)


@functools.cache
def scrambler_bits() -> np.ndarray:
    """The 120-bit scrambling sequence.

    15-stage Fibonacci LFSR, polynomial x^15+x+1, initial state 0x4D4B
    (liquid >=1.6 parameterization selected by hfdl.c:332-346), restarted
    every 120 output bits (hfdl.c:321-329).  One scrambler bit is consumed
    per *data symbol*; bit 1 flips the symbol phase by pi (hfdl.c:1010-1013).
    """
    v = C.SCRAMBLER_INIT
    g = C.SCRAMBLER_GENPOLY
    mask = (1 << C.SCRAMBLER_NUMBITS) - 1
    out = np.empty(C.SCRAMBLER_PERIOD, dtype=np.int8)
    for i in range(C.SCRAMBLER_PERIOD):
        b = bin(v & g).count('1') & 1
        v = ((v << 1) | b) & mask
        out[i] = b
    return out


def scrambler_for_symbols(num_symbols: int) -> np.ndarray:
    """Scrambler bit per data symbol for a frame of num_symbols symbols.

    HFDL frame data-symbol counts (2160, 5040) are exact multiples of the
    120-bit period, so every frame starts at sequence offset 0.
    """
    reps = -(-num_symbols // C.SCRAMBLER_PERIOD)
    return np.tile(scrambler_bits(), reps)[:num_symbols]


def bipolar(bits: np.ndarray) -> np.ndarray:
    """Map bits {0,1} -> {+1.0,-1.0} float32 (BPSK convention)."""
    return (1.0 - 2.0 * np.asarray(bits, dtype=np.float32))
