"""Kernel K1's wrapper: batched Viterbi decode.

Counterpart of ``dumphfdl_tpu/ops/fec_pallas.py``.  A CUDA tensor goes to
the hand-written kernel ``csrc/viterbi.cu`` (one warp per frame, ACS and an
all-lane chainback in one launch); a CPU tensor goes to the plain version,
``ops/fec.py:viterbi_decode``.  Any other device raises.

``viterbi_decode`` takes one batch of one frame length (the event
decode's gather route, ``ChannelBank._decode_by_gather``, one launch per
mode).  ``viterbi_decode_many`` takes several batches of different frame
lengths (the eight modes of an event block) and decodes them in one launch.
Each wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import on
from . import _build
from . import fec

launches = 0            # viterbi_decode_many's launches (CUDA path only)
one_mode_launches = 0   # viterbi_decode's launches (CUDA path only)


def _check(soft: torch.Tensor, nbits: int) -> None:
    if soft.dim() != 2 or soft.shape[1] != 2 * nbits or nbits <= 6:
        raise ValueError(f'soft chips of shape {tuple(soft.shape)} do not '
                         f'hold {nbits}-bit frames')


def viterbi_decode(soft: torch.Tensor, nbits: int) -> torch.Tensor:
    """(batch, 2*nbits) soft chips valued 0..255 -> (batch, nbits) int8."""
    if soft.device.type == 'cpu':
        return fec.viterbi_decode(soft, nbits)
    if soft.device.type != 'cuda':
        raise ValueError(f'unsupported device {soft.device}')
    global one_mode_launches
    _check(soft, nbits)
    batch = soft.shape[0]
    chips = soft.to(torch.uint8).contiguous()
    out = torch.empty((batch, nbits), dtype=torch.int8, device=soft.device)
    if batch == 0:
        return out
    lib = _build.library()
    with on(soft.device):         # the launch goes to the current device
        err = lib.hfdl_viterbi(
            chips.data_ptr(), out.data_ptr(), batch, nbits,
            torch.cuda.current_stream(soft.device).cuda_stream)
    _build.check(lib, err, 'viterbi kernel')
    one_mode_launches += 1
    return out


def viterbi_decode_many(softs: list[torch.Tensor],
                        nbits: list[int]) -> list[torch.Tensor]:
    """Decode several batches at once: softs[i] is (batch_i, 2*nbits[i])
    soft chips valued 0..255; returns the (batch_i, nbits[i]) int8 bits in
    the same order.  CUDA tensors (all on one device) take one launch of
    K1 for all of them; CPU tensors take the plain version per batch."""
    if len(softs) != len(nbits):
        raise ValueError('one frame length per batch of chips')
    if not softs:
        return []
    dev = softs[0].device
    if any(s.device != dev for s in softs):
        raise ValueError('all batches must lie on one device')
    for s, n in zip(softs, nbits):
        _check(s, n)
    if dev.type == 'cpu':
        return [fec.viterbi_decode(s, n) for s, n in zip(softs, nbits)]
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    global launches
    chips = [s.to(torch.uint8).contiguous() for s in softs]
    outs = [torch.empty((s.shape[0], n), dtype=torch.int8, device=dev)
            for s, n in zip(softs, nbits)]
    # longest frames first, so that the longest chains start first
    order = sorted((i for i, s in enumerate(chips) if s.shape[0]),
                   key=lambda i: -nbits[i])
    if not order:
        return outs
    lib = _build.library()
    n = len(order)
    with on(dev):
        err = lib.hfdl_viterbi_many(
            (ctypes.c_void_p * n)(*[chips[i].data_ptr() for i in order]),
            (ctypes.c_void_p * n)(*[outs[i].data_ptr() for i in order]),
            (ctypes.c_int * n)(*[chips[i].shape[0] for i in order]),
            (ctypes.c_int * n)(*[nbits[i] for i in order]),
            n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'viterbi kernel')
    launches += 1
    return outs
