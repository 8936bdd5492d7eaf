"""PSK maps (liquid-dsp conventions): tables in numpy, demodulators in torch.

Counterpart of ``dumphfdl_tpu/ops/psk.py``; the numpy tables and helpers
are copied (that module imports jax), the demodulators take torch tensors.

* BPSK:  bit 0 -> +1, bit 1 -> -1.
* QPSK:  sym = (Re>0?0:1)|(Im>0?0:2); points (+-1 +-1j)/sqrt(2).
* 8PSK:  point = exp(j*2*pi*gray_decode(sym)/8).

Soft bits are uint8 (0 = strong 0, 255 = strong 1), MSB first per symbol.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import constants as C


def gray_encode(p: np.ndarray) -> np.ndarray:
    return p ^ (p >> 1)


def gray_decode(s: np.ndarray) -> np.ndarray:
    # valid for values < 16 (HFDL arity <= 3 bits)
    b = np.asarray(s).copy()
    b ^= b >> 1
    b ^= b >> 2
    return b


@functools.cache
def constellation(arity: int) -> np.ndarray:
    """Complex points indexed by *symbol* (bit pattern), liquid conventions."""
    if arity == C.M_BPSK:
        return np.array([1.0 + 0j, -1.0 + 0j], dtype=np.complex64)
    if arity == C.M_PSK4:
        s = np.arange(4)
        re = np.where(s & 1, -1.0, 1.0) / np.sqrt(2.0)
        im = np.where(s & 2, -1.0, 1.0) / np.sqrt(2.0)
        return (re + 1j * im).astype(np.complex64)
    if arity == C.M_PSK8:
        s = np.arange(8)
        p = gray_decode(s)
        return np.exp(2j * np.pi * p / 8).astype(np.complex64)
    raise ValueError(f'bad arity {arity}')


def modulate(symbols: np.ndarray, arity: int) -> np.ndarray:
    """Map symbol indices to constellation points."""
    return constellation(arity)[np.asarray(symbols, dtype=np.int64)]


def bits_to_symbols(bits: np.ndarray, arity: int) -> np.ndarray:
    """Group a chip stream into symbol indices, MSB-first per symbol."""
    bits = np.asarray(bits, dtype=np.int64).reshape(-1, arity)
    weights = 1 << np.arange(arity - 1, -1, -1)
    return bits @ weights


def demodulate(x: torch.Tensor, arity: int) -> torch.Tensor:
    """Hard-decision demod of complex x -> int64 symbol indices."""
    one = torch.ones((), dtype=torch.int64, device=x.device)
    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    if arity == C.M_BPSK:
        return torch.where(x.real > 0, zero, one)
    if arity == C.M_PSK4:
        return torch.where(x.real > 0, zero, one) \
            + torch.where(x.imag > 0, zero, 2 * one)
    if arity == C.M_PSK8:
        theta = torch.atan2(x.imag, x.real)
        p = torch.round(theta * (8 / (2 * math.pi))).to(torch.int64) % 8
        return p ^ (p >> 1)              # gray encode (3-bit)
    raise ValueError(f'bad arity {arity}')


def phase_error(x: torch.Tensor, arity: int) -> torch.Tensor:
    """Angle from the received point to the nearest constellation point."""
    theta = torch.atan2(x.imag, x.real)
    m = {C.M_BPSK: 2, C.M_PSK4: 4, C.M_PSK8: 8}[arity]
    if arity == C.M_PSK4:
        # liquid's QPSK constellation sits at odd multiples of pi/4
        theta = theta - math.pi / 4
    step = 2 * math.pi / m
    return theta - torch.round(theta / step) * step


def _q(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), 0, 255).to(torch.uint8)


def soft_demodulate(x: torch.Tensor, arity: int) -> torch.Tensor:
    """Approximate-LLR soft demod -> (..., arity) uint8 soft bits, MSB first.

    BPSK follows liquid's gamma=4 linear map (clip(127 - 128*Re)); QPSK
    applies it per axis with the sqrt(2) constellation scale; 8PSK takes
    the max-log LLR over the ring.
    """
    if arity == C.M_BPSK:
        return _q(127.0 - 128.0 * x.real)[..., None]
    if arity == C.M_PSK4:
        scale = 128.0 * math.sqrt(2.0)
        b1 = _q(127.0 - scale * x.imag)      # MSB (bit1) from the imag axis
        b0 = _q(127.0 - scale * x.real)
        return torch.stack([b1, b0], dim=-1)
    if arity == C.M_PSK8:
        pts = torch.as_tensor(constellation(C.M_PSK8), device=x.device)
        d2 = (x[..., None] - pts).abs() ** 2                # (..., 8)
        sym = np.arange(8)
        inf = torch.tensor(float('inf'), device=x.device)
        out = []
        for bitpos in (2, 1, 0):         # MSB first
            mask1 = torch.as_tensor(((sym >> bitpos) & 1) == 1,
                                    device=x.device)
            d2_0 = torch.where(~mask1, d2, inf).amin(dim=-1)
            d2_1 = torch.where(mask1, d2, inf).amin(dim=-1)
            llr = d2_0 - d2_1            # > 0 => bit 1 likelier
            out.append(_q(128.0 + 64.0 * llr))
        return torch.stack(out, dim=-1)
    raise ValueError(f'bad arity {arity}')
