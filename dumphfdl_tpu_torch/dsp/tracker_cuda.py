"""Kernel K2's wrapper: the tracker entry point of the demodulator.

Counterpart of ``dumphfdl_tpu/dsp/tracker_pallas.py``.  It computes the
block-parallel acquisition gate in plain torch (``acq_hits``: the 448-symbol
prekey and the repeated 127-symbol A sequence make every frame start
periodic at a lag of 127 symbols, which the gate detects open-loop), marks
each 128-channel tile active or idle, and then runs the symbol loop:

* CUDA tensor -> ``csrc/tracker.cu`` (raises if it cannot launch);
* CPU tensor  -> the plain version, ``dsp/tracker.py:tracker_block``.

The public layout is the JAX one: TrackerState in and out, TrackerOutputs
(T, C), a (C, 44) f32 event table and (C, 4) f32 counters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from dumphfdl_tpu import sequences as seq
from ..ops import _build
from . import tracker as trk
from .tracker import (A1_SEARCH, CT, EV_FIELDS, HALO, K_EVENTS,
                      TrackerOutputs, TrackerState)

launches = 0            # kernel launches (CUDA path only)

ACQ_LAG = 3 * C.A_LEN   # 381 samples = 127 symbols
# gate threshold on the lag-127-symbol periodicity statistic: frames at
# 3 dB SNR measure >= 0.87, noise <= 0.27 (tracker_pallas.py:46-62)
ACQ_THRESHOLD = 0.5


def acq_hits(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """(C,) int32 preamble-energy verdict for one block of tracker input
    ((C, T) matched-filtered complex at 5400 sps)."""
    d = w = ACQ_LAG
    c, t = x.shape
    if t <= d + w + 1:          # block too short to assess: stay active
        return torch.ones((c,), dtype=torch.int32, device=x.device)
    p = x[:, :-d] * torch.conj(x[:, d:])
    e = 0.5 * (x[:, :-d].abs() ** 2 + x[:, d:].abs() ** 2)
    cp = torch.cumsum(p, dim=1)
    ce = torch.cumsum(e, dim=1)
    num = (cp[:, w:] - cp[:, :-w]).abs()
    den = ce[:, w:] - ce[:, :-w]
    stat = num / (den + 1e-9)
    return (stat.amax(dim=1) > threshold).to(torch.int32)


def tile_activity(state: TrackerState, x: torch.Tensor, use_acq: bool):
    """(act per 128-channel tile, acq_hit carry for the next block).  A tile
    runs the loop when a channel in it is mid-frame or saw preamble energy
    in this block or the previous one; with the gate off every tile runs."""
    c = x.shape[0]
    prev = state.acq_hit if state.acq_hit is not None \
        else torch.zeros((c,), dtype=torch.int32, device=x.device)
    n_tiles = -(-c // CT)
    if not use_acq:
        return torch.ones((n_tiles,), dtype=torch.int32, device=x.device), prev
    hits = acq_hits(x, ACQ_THRESHOLD)
    need = (state.fr_state != A1_SEARCH).to(torch.int32) | hits | prev
    need = torch.nn.functional.pad(need, (0, n_tiles * CT - c))
    act = (need.reshape(n_tiles, CT).amax(dim=1) > 0).to(torch.int32)
    return act, hits


@functools.cache
def _kernel_tables(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(banks (2,33,8) f32, eq0 (15) f32, seqs (67) int32) for the kernel."""
    h, dh = trk._interp_banks()
    banks = np.stack([h, dh]).astype(np.float32)
    eq0 = np.real(trk._init_eq_taps()).astype(np.float32)

    def words(bits):                       # 127 bits -> 4 uint32, bit i at i
        b = np.zeros(128, np.uint64)
        b[:len(bits)] = np.asarray(bits, np.uint64)
        return [int((b[32 * k:32 * k + 32] << np.arange(32, dtype=np.uint64))
                    .sum()) for k in range(4)]

    seqs = words(seq.a_bits())
    for m in range(len(C.MODES)):
        seqs += words(seq.m1_bits_all()[m])
    seqs += [int(b) for b in seq.t_bits()]
    seqs += [m.data_segment_cnt for m in C.MODES]
    seqs += [m.arity for m in C.MODES]
    seqs = np.asarray(seqs, np.uint32).view(np.int32)
    t = lambda a: torch.as_tensor(a, device=device).contiguous()
    return t(banks), t(eq0), t(seqs)


_SF = ('tau', 'rate', 'phi', 'dphi', 'freq_err', 'signal_level',
       'frame_sym_cnt', 'noise_floor')
_SI = ('fr_state', 'symbols_wanted', 'search_retries', 'bitmask', 'mode',
       'data_arity', 'cur_arity', 'data_segments_left', 'eq_train_cnt',
       't_idx', 'data_idx', 'frame_counter', 'symbol_cnt', 'abs_symbol',
       'frame_start_sym', 'train_bad', 'train_total', 'nf_clk', 'out_idx')


def _pack_window(window: torch.Tensor) -> torch.Tensor:
    """(C, 127) +-1 f32 -> (4, C) int32 bit words (bit i = 1 where -1)."""
    c = window.shape[0]
    bits = torch.zeros((c, 128), dtype=torch.int64, device=window.device)
    bits[:, :C.A_LEN] = (window < 0).to(torch.int64)
    weights = (torch.ones(32, dtype=torch.int64, device=window.device)
               << torch.arange(32, device=window.device))
    w = (bits.reshape(c, 4, 32) * weights).sum(-1)          # (C, 4) < 2^32
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32).T


def _unpack_window(words: torch.Tensor, c: int) -> torch.Tensor:
    w = words[:, :c].T.to(torch.int64) & 0xFFFFFFFF         # (C, 4)
    shifts = torch.arange(32, device=words.device)
    bits = ((w[:, :, None] >> shifts) & 1).reshape(c, 128)[:, :C.A_LEN]
    return 1.0 - 2.0 * bits.to(torch.float32)


def _tracker_kernel(state: TrackerState, x: torch.Tensor,
                    level: torch.Tensor, num_steps: int,
                    act: torch.Tensor):
    """Launch K2 on one block; same contract as tracker.tracker_block."""
    global launches
    dev = x.device
    c, t_len = x.shape
    if (x.dtype != torch.complex64 or level.dtype != torch.float32
            or level.shape != x.shape or level.device != dev):
        raise ValueError('tracker kernel takes x (C, T) complex64 and level '
                         '(C, T) float32 on one device')
    if t_len < 3 * num_steps + HALO:
        raise ValueError(f'block of {t_len} samples is too short for '
                         f'{num_steps} symbols')
    c_pad = -(-c // CT) * CT
    x_al, lvl_al, tau, shift = trk.align_block(state, x, level)
    lvl_sym = trk.level_per_symbol(lvl_al, num_steps)

    pad_n = c_pad - c
    st = state._replace(tau=tau)
    if pad_n:                     # dummy channels: fresh state, no signal
        init = trk.tracker_init(pad_n, dev)
        st = TrackerState(*[None if a is None else torch.cat([a, b])
                            for a, b in zip(st, init)])
    tc = lambda a, fill=0.0: torch.nn.functional.pad(
        a, (0, 0, 0, pad_n), value=fill).T.contiguous()
    xre, xim = tc(x_al.real), tc(x_al.imag)
    lvl = tc(lvl_sym.contiguous(), 1.0)
    sf = torch.stack([getattr(st, f) for f in _SF]).contiguous()
    si = torch.stack([getattr(st, f).to(torch.int32) for f in _SI]) \
        .contiguous()
    eq = torch.cat([st.eq_taps.real.T, st.eq_taps.imag.T,
                    st.eq_buf.real.T, st.eq_buf.imag.T]).contiguous()
    win = _pack_window(st.window).contiguous()
    banks, eq0, seqs = _kernel_tables(dev)
    act = act.to(device=dev, dtype=torch.int32).contiguous()

    f32 = dict(dtype=torch.float32, device=dev)
    sym_re = torch.empty((num_steps, c_pad), **f32)
    sym_im = torch.empty((num_steps, c_pad), **f32)
    packed = torch.empty((num_steps, c_pad), dtype=torch.int32, device=dev)
    ev = torch.empty((K_EVENTS * EV_FIELDS, c_pad), **f32)
    cnt = torch.empty((4, c_pad), **f32)

    lib = _build.library()
    ptr = lambda a: a.data_ptr()
    err = lib.hfdl_tracker(
        ptr(act), ptr(xre), ptr(xim), ptr(lvl), ptr(banks), ptr(eq0),
        ptr(seqs), ptr(sf), ptr(si), ptr(eq), ptr(win), ptr(sym_re),
        ptr(sym_im), ptr(packed), ptr(ev), ptr(cnt), c_pad, num_steps,
        trk.K1, trk.K2, C.COSTAS_BETA, trk.BASE_STEP,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'tracker kernel')
    launches += 1

    fields = {f: sf[i, :c] for i, f in enumerate(_SF)}
    fields.update({f: si[i, :c] for i, f in enumerate(_SI)})
    fields['bitmask'] = fields['bitmask'] != 0
    fields['eq_taps'] = torch.complex(eq[0:15, :c].T, eq[15:30, :c].T)
    fields['eq_buf'] = torch.complex(eq[30:45, :c].T, eq[45:60, :c].T)
    fields['window'] = _unpack_window(win, c)
    fields['acq_hit'] = state.acq_hit
    final = TrackerState(**fields)
    final = final._replace(
        tau=final.tau + shift.to(torch.float32) - float(t_len - HALO))
    p = packed[:, :c]
    outs = TrackerOutputs(
        sym=torch.complex(sym_re[:, :c], sym_im[:, :c]),
        is_data=(p & 1) != 0,
        data_idx=p // (2 * C.FRAME_PARITY_SLOTS),
        frame_parity=(p >> 1) & (C.FRAME_PARITY_SLOTS - 1))
    return final, outs, ev[:, :c].T, cnt[:, :c].T


def tracker_block(state: TrackerState, x: torch.Tensor, level: torch.Tensor,
                  num_steps: int, use_acq: bool = True,
                  debug_taps: bool = False):
    """Run the tracker over one block (the JAX ``tracker_block_pallas``
    contract): CUDA tensors go to kernel K2, CPU tensors to the plain
    version.  use_acq=False runs every tile (full-trajectory parity).
    The per-symbol loop taps of --datadumps (debug_taps) are not ported."""
    if debug_taps:
        raise NotImplementedError('tracker debug taps (--datadumps) are not '
                                  'yet ported to dumphfdl_tpu_torch')
    act, hits = tile_activity(state, x, use_acq)
    if x.device.type == 'cuda':
        out = _tracker_kernel(state, x, level, num_steps, act)
    elif x.device.type == 'cpu':
        out = trk.tracker_block(state, x, level, num_steps, act)
    else:
        raise ValueError(f'unsupported device {x.device}')
    final, outs, ev, counters = out
    return final._replace(acq_hit=hits), outs, ev, counters
