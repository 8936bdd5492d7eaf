"""K=7 R=1/2 convolutional FEC: encoder and the plain batched Viterbi decoder.

Counterpart of ``dumphfdl_tpu/ops/fec.py``.  Trellis conventions are Phil
Karn's viterbi27 (polynomials 0x6d/0x4f, new bit shifted into the LSB,
soft chips 0 = strong 0 .. 255 = strong 1, traceback from state 0 through
six virtual zero decisions past the block end).

``viterbi_decode`` here is the plain PyTorch version of kernel K1
(``csrc/viterbi.cu``): a Python loop of (batch, 64) int32 add-compare-
select steps followed by chainback.  ``ops/fec_cuda.py`` routes CPU tensors
to it and CUDA tensors to the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C

_NSTATES = 64


@functools.cache
def _branch_tables() -> tuple[np.ndarray, np.ndarray]:
    """Expected soft symbols (0/255) for transitions out of states 0..31."""
    i = np.arange(32)
    b0 = np.array([bin((2 * s) & C.V27_POLY_A).count('1') & 1 for s in i]) * 255
    b1 = np.array([bin((2 * s) & C.V27_POLY_B).count('1') & 1 for s in i]) * 255
    return b0.astype(np.int32), b1.astype(np.int32)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Encode a bit stream; returns interleaved chips [c0_0, c1_0, c0_1, ...]."""
    bits = np.asarray(bits, dtype=np.int64)
    n = len(bits)
    reg = np.zeros(n, dtype=np.int64)
    acc = 0
    for k in range(n):
        acc = ((acc << 1) | int(bits[k])) & 0x7F
        reg[k] = acc
    popcount = np.vectorize(lambda v: bin(v).count('1'))
    c0 = popcount(reg & C.V27_POLY_A) & 1
    c1 = popcount(reg & C.V27_POLY_B) & 1
    out = np.empty(2 * n, dtype=np.int8)
    out[0::2] = c0
    out[1::2] = c1
    return out


def hard_to_soft(chips: np.ndarray) -> np.ndarray:
    """Map hard chips {0,1} to soft uint8 {0,255}."""
    return (np.asarray(chips, dtype=np.uint8) * 255).astype(np.uint8)


def viterbi_decode(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """Plain batched Viterbi decode.

    Args:
      soft: (batch, 2*nbits) soft chips with values 0..255 (any int dtype).
      nbits: decoded bits per frame.

    Returns:
      (batch, nbits) int8 decoded bits, on soft's device.
    """
    dev = soft.device
    b0_np, b1_np = _branch_tables()
    b0 = torch.as_tensor(b0_np, device=dev)[None, :]
    b1 = torch.as_tensor(b1_np, device=dev)[None, :]
    batch = soft.shape[0]
    pairs = soft.to(torch.int32).reshape(batch, nbits, 2)
    metrics = torch.full((batch, _NSTATES), 63, dtype=torch.int32, device=dev)
    metrics[:, 0] = 0
    decisions = torch.empty((nbits, batch, _NSTATES), dtype=torch.bool,
                            device=dev)
    for t in range(nbits):
        s0 = pairs[:, t, 0:1]
        s1 = pairs[:, t, 1:2]
        bm = (b0 - s0).abs() + (b1 - s1).abs()          # (B, 32)
        lo, hi = metrics[:, :32], metrics[:, 32:]
        m0e = lo + bm
        m1e = hi + 510 - bm
        de = m0e > m1e                                  # strict: ties keep m0
        even = torch.where(de, m1e, m0e)
        m0o = lo + 510 - bm
        m1o = hi + bm
        do = m0o > m1o
        odd = torch.where(do, m1o, m0o)
        metrics = torch.stack([even, odd], dim=-1).reshape(batch, _NSTATES)
        decisions[t] = torch.stack([de, do], dim=-1).reshape(batch, _NSTATES)
    out = torch.zeros((batch, nbits), dtype=torch.int8, device=dev)
    state = torch.zeros((batch,), dtype=torch.int64, device=dev)
    # six virtual zero decisions past the end force the flush bits to 0
    for n in range(nbits - 7, -1, -1):
        k = decisions[n + 6].gather(1, state[:, None])[:, 0].to(torch.int64)
        out[:, n] = k.to(torch.int8)
        state = (state >> 1) | (k << 5)
    return out
