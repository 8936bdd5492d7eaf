"""Kernel K1's wrapper: batched Viterbi decode.

Counterpart of ``dumphfdl_tpu/ops/fec_pallas.py``.  A CUDA tensor goes to
the hand-written kernel ``csrc/viterbi.cu`` (one warp per frame, ACS and
chainback in one launch); a CPU tensor goes to the plain version,
``ops/fec.py:viterbi_decode``.  Any other device raises.
"""

from __future__ import annotations

import torch

from . import _build
from . import fec

launches = 0            # kernel launches (CUDA path only)


def viterbi_decode(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """(batch, 2*nbits) soft chips valued 0..255 -> (batch, nbits) int8."""
    if soft.device.type == 'cpu':
        return fec.viterbi_decode(soft, nbits)
    if soft.device.type != 'cuda':
        raise ValueError(f'unsupported device {soft.device}')
    global launches
    if soft.dim() != 2 or soft.shape[1] != 2 * nbits or nbits <= 6:
        raise ValueError(f'soft chips of shape {tuple(soft.shape)} do not '
                         f'hold {nbits}-bit frames')
    batch = soft.shape[0]
    chips = soft.to(torch.uint8).contiguous()
    out = torch.empty((batch, nbits), dtype=torch.int8, device=soft.device)
    if batch == 0:
        return out
    lib = _build.library()
    err = lib.hfdl_viterbi(chips.data_ptr(), out.data_ptr(), batch, nbits,
                           torch.cuda.current_stream(soft.device).cuda_stream)
    _build.check(lib, err, 'viterbi kernel')
    launches += 1
    return out
