"""Kernel K2's wrapper: the tracker entry point of the demodulator.

Counterpart of ``dumphfdl_tpu/dsp/tracker_pallas.py``.  It computes the
block-parallel acquisition gate in plain torch (``acq_hits``: the 448-symbol
prekey and the repeated 127-symbol A sequence make every frame start
periodic at a lag of 127 symbols, which the gate detects open-loop), marks
each 128-channel tile active or idle, and then runs the symbol loop:

* CUDA tensor -> ``csrc/tracker.cu`` (one warp of 32 channels per block,
  the samples staged through shared memory; raises if it cannot launch);
* CPU tensor  -> the plain version, ``dsp/tracker.py:tracker_block``.

The public layout is the JAX one: TrackerState in and out, TrackerOutputs
(T, C), a (C, 44) f32 event table and (C, 4) f32 counters.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from .. import sequences as seq
from ..device import on
from ..ops import _build
from . import tracker as trk
from .tracker import (A1_SEARCH, CT, EV_FIELDS, HALO, K_EVENTS,
                      TrackerOutputs, TrackerState)

# kernel launches (CUDA path only), counted where the wrapper launches.  A
# launch recorded into a CUDA graph counts once, when it is recorded; the
# graph's replays are counted by their owner (SuperstepEngine.replays).
launches = 0
taps_launches = 0       # launches of the kernel's debug_taps instantiation

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


@functools.cache
def _padding_state(n: int, device) -> TrackerState:
    """Fresh state of the n dummy channels that fill the last tile (made
    once per size: the kernel copies its state planes, so this is never
    written).  Later calls may come from other streams of the device, so
    the fills are waited for here."""
    state = trk.tracker_init(n, device)
    torch.cuda.current_stream(device).synchronize()
    return state


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


class _Call(NamedTuple):
    """One K2 launch, its inputs and output planes made ready
    (_prepare); the launch (_launch) updates the state planes in place."""
    state: TrackerState
    shift: torch.Tensor
    c: int
    t_len: int
    num_steps: int
    args: tuple             # the launcher's tensors, in its order
    debug_taps: bool


def _prepare(state: TrackerState, x: torch.Tensor, level: torch.Tensor,
             num_steps: int, act: torch.Tensor, debug_taps: bool) -> _Call:
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
    # the block alignment of tracker.align_block, as a shift the kernel
    # applies while it copies the samples in: tau counts aligned samples
    shift = trk.block_shift(state)
    pad_n = c_pad - c
    st = state._replace(tau=state.tau - shift.to(torch.float32))
    if pad_n:                     # dummy channels: fresh state, no signal
        init = _padding_state(pad_n, dev)
        st = TrackerState(*[None if a is None else torch.cat([a, b])
                            for a, b in zip(st, init)])
    shifts = torch.nn.functional.pad(shift, (0, pad_n)).contiguous()
    xc = torch.view_as_real(x.contiguous())
    lvl = level.contiguous()
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
    taps = torch.empty((3, num_steps, c_pad), **f32) if debug_taps else None
    return _Call(state, shift, c, t_len, num_steps,
                 (act, xc, lvl, shifts, banks, eq0, seqs, sf, si, eq, win,
                  sym_re, sym_im, packed, ev, cnt, taps), debug_taps)


def _launch(call: _Call) -> None:
    """The launch itself, in the current stream of the tensors' device."""
    global launches, taps_launches
    dev = call.args[1].device
    c_pad = call.args[3].shape[0]
    lib = _build.library()
    ptrs = [None if a is None else a.data_ptr() for a in call.args]
    with on(dev):                 # the launch goes to the current device
        err = lib.hfdl_tracker(
            *ptrs, c_pad, call.c, call.t_len, call.num_steps, trk.K1, trk.K2,
            C.COSTAS_BETA, trk.BASE_STEP,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'tracker kernel')
    if call.debug_taps:
        taps_launches += 1
    else:
        launches += 1


def _results(call: _Call):
    """The launched call's (state, outputs, event table, counters)."""
    c, t_len = call.c, call.t_len
    sf, si, eq, win, sym_re, sym_im, packed, ev, cnt, taps = call.args[7:]
    fields = {f: sf[i, :c] for i, f in enumerate(_SF)}
    fields.update({f: si[i, :c] for i, f in enumerate(_SI)})
    fields['bitmask'] = fields['bitmask'] != 0
    fields['eq_taps'] = torch.complex(eq[0:15, :c].T, eq[15:30, :c].T)
    fields['eq_buf'] = torch.complex(eq[30:45, :c].T, eq[45:60, :c].T)
    fields['window'] = _unpack_window(win, c)
    fields['acq_hit'] = call.state.acq_hit
    final = TrackerState(**fields)
    final = final._replace(
        tau=final.tau + call.shift.to(torch.float32) - float(t_len - HALO))
    p = packed[:, :c]
    outs = TrackerOutputs(
        sym=torch.complex(sym_re[:, :c], sym_im[:, :c]),
        is_data=(p & 1) != 0,
        data_idx=p // (2 * C.FRAME_PARITY_SLOTS),
        frame_parity=(p >> 1) & (C.FRAME_PARITY_SLOTS - 1),
        taps=taps[:, :, :c].permute(1, 2, 0) if call.debug_taps else None)
    return final, outs, ev[:, :c].T, cnt[:, :c].T


def _tracker_kernel(state: TrackerState, x: torch.Tensor,
                    level: torch.Tensor, num_steps: int,
                    act: torch.Tensor, debug_taps: bool = False):
    """Launch K2 on one block; same contract as tracker.tracker_block.
    debug_taps launches the kernel's taps instantiation, which also fills
    three (num_steps, c_pad) planes."""
    call = _prepare(state, x, level, num_steps, act, debug_taps)
    _launch(call)
    return _results(call)


def kernel_alone_ms(state: TrackerState, x: torch.Tensor,
                    level: torch.Tensor, num_steps: int,
                    use_acq: bool = True, reps: int = 5) -> float:
    """Mean device milliseconds of K2's launch alone on one block (CUDA
    events around reps launches, each on its own copy of the prepared
    state planes, all prepared beforehand; one launch to warm up): the
    wrapper's time less its host work and the gate."""
    act, _ = tile_activity(state, x, use_acq)
    calls = [_prepare(state, x, level, num_steps, act, False)
             for _ in range(reps + 1)]
    dev = x.device
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    with on(dev):
        _launch(calls[0])
        torch.cuda.synchronize(dev)
        stream = torch.cuda.current_stream(dev)
        start.record(stream)
        for call in calls[1:]:
            _launch(call)
        end.record(stream)
        torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def trig_mismatches(device) -> int:
    """How many of K2's own cosine and sine results (it evaluates the CUDA
    math library's algorithm inline, both phases of a symbol side by side)
    differ in any bit from ``cosf``/``sinf``, over every float the inline
    path takes.  0 on a toolkit whose library the kernel reproduces; the
    plain version's ``torch.cos``/``torch.sin`` then agree with it too."""
    out = torch.zeros((1,), dtype=torch.int64, device=device)
    lib = _build.library()
    with on(out.device):
        err = lib.hfdl_tracker_trig_mismatches(
            out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, err, 'tracker trig check')
    return int(out.item())


def tracker_block(state: TrackerState, x: torch.Tensor, level: torch.Tensor,
                  num_steps: int, use_acq: bool = True,
                  debug_taps: bool = False):
    """Run the tracker over one block (the JAX ``tracker_block_pallas``
    contract): CUDA tensors go to kernel K2, CPU tensors to the plain
    version.  use_acq=False runs every tile (full-trajectory parity).
    debug_taps (--datadumps) also returns the loop's per-symbol internals
    in outputs.taps (T, C, 3) and turns the gate off, as the JAX package
    does, so that every channel has them."""
    act, hits = tile_activity(state, x, use_acq and not debug_taps)
    if x.device.type == 'cuda':
        out = _tracker_kernel(state, x, level, num_steps, act, debug_taps)
    elif x.device.type == 'cpu':
        out = trk.tracker_block(state, x, level, num_steps, act, debug_taps)
    else:
        raise ValueError(f'unsupported device {x.device}')
    final, outs, ev, counters = out
    return final._replace(acq_hit=hits), outs, ev, counters
