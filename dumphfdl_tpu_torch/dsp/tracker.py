"""Per-channel demodulator state and the plain PyTorch symbol loop (K2's
plain version).

Counterpart of ``dumphfdl_tpu/dsp/tracker.py``.  All channels advance in
lockstep through a Python loop over the symbol clock; each iteration is one
full symbol: the even half-step (8-tap polyphase interpolation with its
derivative bank, ML timing error, Costas step) and the odd half-step
(interpolation, Costas step, 15-tap NLMS equalizer, demod, framer FSM).

The arithmetic is written on real/imag planes with every sum accumulated
in a fixed left-to-right order of separately rounded products, and no
fused multiply-add: ``csrc/tracker.cu`` performs the same operations in the
same order (built with ``--fmad=false``), so kernel and plain version can
agree to the last bit apart from the transcendental functions.

``dsp/tracker_cuda.py`` is the entry point the demodulator calls: it
decides which 128-channel tiles run the symbol loop (the acquisition gate)
and routes CPU tensors here, CUDA tensors to the kernel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from dumphfdl_tpu import sequences as seq

# --- framer states (hfdl.c:54-62) ---
A1_SEARCH, A2_SEARCH, M1_SEARCH, M2_SKIP, EQ_TRAIN, DATA_1, DATA_2 = range(1, 8)

# --- interpolator geometry ---
NPHASES = 32
ITAPS = 8          # interpolation taps
HALO_FRONT = 24    # window margin before the first processed sample
HALO_BACK = 12     # margin after the last processed sample
HALO = HALO_FRONT + HALO_BACK   # carried tail between blocks (36)
SLAB_BASE_OFF = HALO_FRONT - 5  # slab start for symbol t is 3*t + this
CT = 128           # channels per acquisition-gate tile

_TS_CORRECTION_SYMBOLS = C.PREKEY_LEN + 2 * C.A_LEN

# event-table geometry shared with dsp/channel.py
K_EVENTS = 4
EV_FIELDS = 11   # valid, mode, bitmask, parity, freq_err, rssi, nf,
                 # train_bad, train_total, start_sym, start_sym mod 2^22

# loop constants, evaluated in float64 like the reference and rounded to
# float32 where they meet the state (the kernel receives these values)
BASE_STEP = C.SPS / C.SYMSYNC_OUT_RATE      # 1.5 input samples per half-step
_BW = C.SYMSYNC_LOOP_BW
_ZETA = 1.0 / np.sqrt(2.0)
_DENOM = 1 + 2 * _ZETA * _BW + _BW * _BW
K1 = float(4 * _ZETA * _BW / _DENOM)
K2 = float(4 * _BW * _BW / _DENOM)
NF_PERIOD = 85   # noise-floor EMA cadence in symbols (~256 input samples)
# division by a constant is a multiply by its float32 reciprocal, the form
# PyTorch's CUDA kernels use for a scalar divisor, so that every version
# (CPU, CUDA, csrc/tracker.cu) rounds the same way
_INV_PI = 1 / math.pi
_INV_A_LEN = 1 / C.A_LEN


@functools.cache
def _interp_banks() -> tuple[np.ndarray, np.ndarray]:
    """(NPHASES+1, ITAPS) windowed-sinc interpolation + derivative banks."""
    h = np.zeros((NPHASES + 1, ITAPS), dtype=np.float32)
    dh = np.zeros((NPHASES + 1, ITAPS), dtype=np.float32)
    center = ITAPS // 2 - 1
    n = np.arange(ITAPS)
    for p in range(NPHASES + 1):
        mu = p / NPHASES
        t = n - (center + mu)
        w = np.kaiser(ITAPS, 6.0)
        h[p] = np.sinc(t) * w
        h[p] /= h[p].sum() if abs(h[p].sum()) > 1e-6 else 1.0
        with np.errstate(divide='ignore', invalid='ignore'):
            ds = np.where(np.abs(t) < 1e-8, 0.0,
                          (np.cos(np.pi * t) - np.sinc(t)) / t)
        dh[p] = ds * w
    return h, dh


def _init_eq_taps() -> np.ndarray:
    """Initial equalizer: near-Nyquist lowpass == pass-through with delay
    (liquid eqlms_cccf_create_lowpass(15, 0.45), hfdl.c:495)."""
    n = np.arange(C.EQ_LEN) - (C.EQ_LEN - 1) / 2
    h = 2 * 0.45 * np.sinc(2 * 0.45 * n) * np.hamming(C.EQ_LEN)
    h = h / h.sum()
    return h.astype(np.complex64)


class TrackerState(NamedTuple):
    """Carried per-channel state; field names and dtypes as in the JAX
    package (``bitmask`` bool, complex64 equalizer, f32 +-1 bit window)."""
    tau: torch.Tensor            # (C,) f32 position in the aligned block
    rate: torch.Tensor           # (C,) f32 timing-loop integrator
    out_idx: torch.Tensor        # (C,) i32
    phi: torch.Tensor            # (C,) f32 Costas phase
    dphi: torch.Tensor           # (C,) f32 Costas frequency
    eq_taps: torch.Tensor        # (C, EQ_LEN) c64
    eq_buf: torch.Tensor         # (C, EQ_LEN) c64
    window: torch.Tensor         # (C, 127) f32 bipolar (+1 = bit 0)
    fr_state: torch.Tensor       # (C,) i32
    symbols_wanted: torch.Tensor
    search_retries: torch.Tensor
    bitmask: torch.Tensor        # (C,) bool
    mode: torch.Tensor
    data_arity: torch.Tensor
    cur_arity: torch.Tensor
    data_segments_left: torch.Tensor
    eq_train_cnt: torch.Tensor
    t_idx: torch.Tensor
    data_idx: torch.Tensor
    frame_counter: torch.Tensor
    symbol_cnt: torch.Tensor
    abs_symbol: torch.Tensor
    frame_start_sym: torch.Tensor
    train_bad: torch.Tensor
    train_total: torch.Tensor
    freq_err: torch.Tensor       # (C,) f32
    signal_level: torch.Tensor
    frame_sym_cnt: torch.Tensor
    noise_floor: torch.Tensor
    nf_clk: torch.Tensor         # (C,) i32
    acq_hit: torch.Tensor = None  # (C,) i32 acquisition-gate carry


class TrackerOutputs(NamedTuple):
    """Per-symbol, per-channel outputs; axes (T_out, C)."""
    sym: torch.Tensor            # c64 equalized symbol
    is_data: torch.Tensor        # bool
    data_idx: torch.Tensor       # i32 slot within frame
    frame_parity: torch.Tensor   # i32 frame_counter & 3


_F32_FIELDS = ('tau', 'rate', 'phi', 'dphi', 'freq_err', 'signal_level',
               'frame_sym_cnt', 'noise_floor')


def _field_dtype(name: str) -> torch.dtype:
    if name in _F32_FIELDS or name == 'window':
        return torch.float32
    if name in ('eq_taps', 'eq_buf'):
        return torch.complex64
    if name == 'bitmask':
        return torch.bool
    return torch.int32


def tracker_init(num_channels: int, device) -> TrackerState:
    c = num_channels
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda: torch.zeros((c,), **i32)
    return TrackerState(
        tau=torch.full((c,), float(HALO_FRONT), **f32),
        rate=torch.zeros((c,), **f32),
        out_idx=z(),
        phi=torch.zeros((c,), **f32),
        dphi=torch.zeros((c,), **f32),
        eq_taps=torch.as_tensor(np.tile(_init_eq_taps()[None, :], (c, 1)),
                                device=device),
        eq_buf=torch.zeros((c, C.EQ_LEN), dtype=torch.complex64,
                           device=device),
        window=torch.ones((c, C.A_LEN), **f32),
        fr_state=torch.full((c,), A1_SEARCH, **i32),
        symbols_wanted=torch.ones((c,), **i32),
        search_retries=z(),
        bitmask=torch.zeros((c,), dtype=torch.bool, device=device),
        mode=z(),
        data_arity=torch.ones((c,), **i32),
        cur_arity=torch.ones((c,), **i32),
        data_segments_left=z(),
        eq_train_cnt=z(),
        t_idx=z(),
        data_idx=z(),
        frame_counter=z(),
        symbol_cnt=z(),
        abs_symbol=z(),
        frame_start_sym=z(),
        train_bad=z(),
        train_total=z(),
        freq_err=torch.zeros((c,), **f32),
        signal_level=torch.full((c,), 1e-3, **f32),
        frame_sym_cnt=torch.zeros((c,), **f32),
        noise_floor=torch.ones((c,), **f32),
        nf_clk=z(),
        acq_hit=z(),
    )


def state_from_numpy(st, device) -> TrackerState:
    """A TrackerState of numpy arrays (e.g. a JAX state passed through
    ``np.asarray``) -> TrackerState of tensors on ``device``."""
    out = {}
    for f in TrackerState._fields:
        v = getattr(st, f)
        if v is None:
            v = np.zeros(np.shape(st.tau), np.int32)
        out[f] = torch.as_tensor(np.array(v), device=device).to(
            _field_dtype(f))
    return TrackerState(**out)


def state_to_numpy(st: TrackerState) -> TrackerState:
    """TrackerState of tensors -> TrackerState of numpy arrays."""
    return TrackerState(*[None if v is None else v.cpu().numpy() for v in st])


def select_channels(st: TrackerState, idx: torch.Tensor) -> TrackerState:
    return TrackerState(*[None if v is None else v[idx] for v in st])


def framer_fsm_step(*, fr, sw, retries, bitmask, mode, data_arity,
                    cur_arity, segs_left, eq_cnt, t_idx, data_idx,
                    freq_err, frame_start, sig, fsc, lvl, dphi, abs_symbol,
                    train_bad, train_total, corr_a, corr_m1, m1_match,
                    mode_segments, mode_arity):
    """Framer FSM transitions (hfdl.c:779-891), elementwise over channels.

    The same transitions as ``dumphfdl_tpu.dsp.tracker.framer_fsm_step``;
    ``csrc/tracker.cu`` carries them a second time, in C++ (``framer``).
    Returns (updates dict, flags dict)."""
    w = torch.where
    run_fsm = sw <= 1
    sw = w(~run_fsm, sw - 1, sw)

    a1_hit = run_fsm & (fr == A1_SEARCH) & (corr_a.abs() > C.CORR_THRESHOLD_A1)
    bitmask = w(a1_hit, corr_a < 0, bitmask)
    sig = w(a1_hit, lvl, sig)
    fsc = w(a1_hit, 1.0, fsc)
    retries = w(a1_hit, 0, retries)
    sw = w(a1_hit, C.A_LEN, sw)

    in_a2 = run_fsm & (fr == A2_SEARCH)
    a2_hit = in_a2 & (corr_a.abs() > C.CORR_THRESHOLD_A2)
    a2_miss = in_a2 & ~a2_hit
    a2_fail = a2_miss & (retries + 1 >= C.MAX_SEARCH_RETRIES)
    retries = w(a2_miss, retries + 1, retries)
    # displayed frequency error as the reference computes it (hfdl.c:812);
    # dphi is radians per half-symbol in both decoders
    freq_err = w(a2_hit, dphi * C.SYMBOL_RATE * (0.5 * _INV_PI), freq_err)
    frame_start = w(a2_hit, abs_symbol - _TS_CORRECTION_SYMBOLS, frame_start)
    sw = w(a2_hit, C.M1_LEN, sw)
    retries = w(a2_hit, 0, retries)

    in_m1 = run_fsm & (fr == M1_SEARCH)
    m1_hit = in_m1 & (corr_m1 > C.CORR_THRESHOLD_M1)
    m1_fail = in_m1 & ~m1_hit
    mode = w(m1_hit, m1_match, mode)
    segs_left = w(m1_hit, mode_segments[m1_match], segs_left)
    data_arity = w(m1_hit, mode_arity[m1_match], data_arity)
    sw = w(m1_hit, C.M2_LEN, sw)
    retries = w(m1_hit, 0, retries)

    m2_done = run_fsm & (fr == M2_SKIP)
    sw = w(m2_done, C.T_LEN, sw)
    eq_cnt = w(m2_done, C.EQ_TRAIN_SEQ_CNT, eq_cnt)
    data_idx = w(m2_done, 0, data_idx)

    eqt = run_fsm & (fr == EQ_TRAIN)
    more_train = eqt & (eq_cnt > 1)
    to_data = eqt & (eq_cnt <= 1) & (segs_left > 0)
    frame_done = eqt & (eq_cnt <= 1) & (segs_left <= 0)
    eq_cnt = w(more_train, eq_cnt - 1, eq_cnt)
    sw = w(more_train, C.T_LEN, sw)
    sw = w(to_data, C.DATA_FRAME_LEN // 2, sw)
    t_idx = w(more_train, 0, t_idx)
    cur_arity = w(to_data, data_arity, cur_arity)

    d1 = run_fsm & (fr == DATA_1)
    sw = w(d1, C.DATA_FRAME_LEN // 2, sw)
    d2 = run_fsm & (fr == DATA_2)
    segs_left = w(d2, segs_left - 1, segs_left)
    cur_arity = w(d2, 1, cur_arity)
    eq_cnt = w(d2, 1, eq_cnt)
    sw = w(d2, C.T_LEN, sw)
    t_idx = w(d2, 0, t_idx)

    fr = w(a1_hit, A2_SEARCH, fr)
    fr = w(a2_hit, M1_SEARCH, fr)
    fr = w(m1_hit, M2_SKIP, fr)
    fr = w(m2_done, EQ_TRAIN, fr)
    fr = w(to_data, DATA_1, fr)
    fr = w(d1, DATA_2, fr)
    fr = w(d2, EQ_TRAIN, fr)

    # event fields snapshot the frame's values before the reset clears them
    ev_bitmask, ev_train_bad, ev_train_total = bitmask, train_bad, train_total

    do_reset = a2_fail | m1_fail | frame_done
    fr = w(do_reset, A1_SEARCH, fr)
    sw = w(do_reset, 1, sw)
    retries = w(do_reset, 0, retries)
    cur_arity = w(do_reset, 1, cur_arity)
    train_bad = w(do_reset, 0, train_bad)
    train_total = w(do_reset, 0, train_total)
    t_idx = w(do_reset, 0, t_idx)
    bitmask = bitmask & ~do_reset
    data_idx = w(do_reset, 0, data_idx)

    upd = dict(fr=fr, sw=sw, retries=retries, bitmask=bitmask, mode=mode,
               data_arity=data_arity, cur_arity=cur_arity,
               segs_left=segs_left, eq_cnt=eq_cnt, t_idx=t_idx,
               data_idx=data_idx, freq_err=freq_err,
               frame_start=frame_start, sig=sig, fsc=fsc,
               train_bad=train_bad, train_total=train_total)
    flags = dict(a2_hit=a2_hit, m1_hit=m1_hit, m1_fail=m1_fail,
                 frame_done=frame_done, do_reset=do_reset,
                 ev_bitmask=ev_bitmask, ev_train_bad=ev_train_bad,
                 ev_train_total=ev_train_total)
    return upd, flags


def align_block(state: TrackerState, x: torch.Tensor, level: torch.Tensor):
    """Per-block channel alignment (as the JAX tracker does it): shift each
    channel's window by round(tau) - HALO_FRONT (clipped to +-8) so every
    channel reads near the same slab.  Returns (x_al, lvl_al, tau, shift);
    x_al/lvl_al are (C, T + 8)."""
    c, t = x.shape
    shift = torch.clamp(torch.round(state.tau).to(torch.int32) - HALO_FRONT,
                        -8, 8)
    zx = torch.zeros((c, 8), dtype=x.dtype, device=x.device)
    x_pad = torch.cat([zx, x, torch.zeros((c, 16), dtype=x.dtype,
                                          device=x.device)], dim=1)
    lvl_pad = torch.cat([level[:, :1].expand(c, 8), level,
                         level[:, -1:].expand(c, 16)], dim=1)
    idx = (shift.to(torch.int64) + 8)[:, None] \
        + torch.arange(t + 8, device=x.device)[None, :]
    x_al = torch.gather(x_pad, 1, idx)
    lvl_al = torch.gather(lvl_pad, 1, idx)
    return x_al, lvl_al, state.tau - shift.to(torch.float32), shift


def level_per_symbol(lvl_al: torch.Tensor, num_steps: int) -> torch.Tensor:
    """AGC level at each symbol's slab centre (sample 3t + SLAB_BASE_OFF + 6)
    -> (C, num_steps)."""
    s0 = SLAB_BASE_OFF + 6
    return lvl_al[:, s0:s0 + 3 * num_steps:3]


def _ordered_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis strictly left to right (the kernel's order)."""
    acc = p[..., 0]
    for j in range(1, p.shape[-1]):
        acc = acc + p[..., j]
    return acc


def _costas_step(phi, dphi):
    phi = phi + dphi
    return torch.where(phi > np.pi, phi - 2 * np.pi,
                       torch.where(phi < -np.pi, phi + 2 * np.pi, phi))


@functools.cache
def _tables(device) -> dict:
    h, dh = _interp_banks()
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                    device=device)
    return dict(
        h=t(h), dh=t(dh),
        a_bip=t(seq.bipolar(seq.a_bits())),
        m1_bip=t(seq.bipolar(seq.m1_bits_all()).T),           # (127, 8)
        t_bits=t(seq.t_bits(), torch.int32),
        t_bip=t(seq.bipolar(seq.t_bits())),
        mode_segments=t([m.data_segment_cnt for m in C.MODES], torch.int32),
        mode_arity=t([m.arity for m in C.MODES], torch.int32),
        eq0=t(np.real(_init_eq_taps())),
        k8=torch.arange(ITAPS, device=device),
    )


def _run_loop(st: TrackerState, x_al, lvl_sym, tau, num_steps: int):
    """The full symbol loop for every channel of st (tau already aligned).
    Returns (final state, outputs, ev (C, K_EVENTS*EV_FIELDS), counters)."""
    dev = x_al.device
    tb = _tables(dev)
    c = x_al.shape[0]
    xr = x_al.real.contiguous()
    xi = x_al.imag.contiguous()
    cidx = torch.arange(c, device=dev)
    w = torch.where
    i32 = torch.int32

    rate, phi, dphi = st.rate, st.phi, st.dphi
    tre, tim = st.eq_taps.real.contiguous(), st.eq_taps.imag.contiguous()
    bre, bim = st.eq_buf.real.contiguous(), st.eq_buf.imag.contiguous()
    window = st.window
    fr, sw, retries = st.fr_state, st.symbols_wanted, st.search_retries
    bitmask, mode = st.bitmask, st.mode
    data_arity, cur_arity = st.data_arity, st.cur_arity
    segs_left, eq_cnt = st.data_segments_left, st.eq_train_cnt
    t_idx, data_idx = st.t_idx, st.data_idx
    frame_counter, symbol_cnt = st.frame_counter, st.symbol_cnt
    abs_symbol, frame_start = st.abs_symbol, st.frame_start_sym
    train_bad, train_total = st.train_bad, st.train_total
    freq_err, sig, fsc = st.freq_err, st.signal_level, st.frame_sym_cnt
    nf, nf_clk, out_idx = st.noise_floor, st.nf_clk, st.out_idx

    ev_table = torch.zeros((c, K_EVENTS + 1, EV_FIELDS), dtype=torch.float32,
                           device=dev)
    ev_count = torch.zeros((c,), dtype=i32, device=dev)
    counters = torch.zeros((c, 4), dtype=torch.float32, device=dev)
    sym_re = torch.empty((num_steps, c), dtype=torch.float32, device=dev)
    sym_im = torch.empty_like(sym_re)
    packed = torch.empty((num_steps, c), dtype=i32, device=dev)

    def interp(tau, base, banks):
        """Interpolate every channel at its own tau from its 8-sample slab;
        one output per bank per plane, ordered accumulation."""
        i = torch.floor(tau)
        mu = tau - i
        off = torch.clamp(i.to(torch.int64) - base, 3, 8)
        phase = torch.round(mu * NPHASES).to(torch.int64)
        cols = (base - 3 + off)[:, None] + tb['k8'][None, :]     # (C, 8)
        sr = torch.gather(xr, 1, cols)
        si = torch.gather(xi, 1, cols)
        taps = [bk[phase] for bk in banks]                        # (C, 8)
        prods = torch.stack([p for tp in taps for p in (sr * tp, si * tp)])
        return _ordered_sum(prods)                                # (2*nb, C)

    for t in range(num_steps):
        base = 3 * t + SLAB_BASE_OFF
        # ===== even half-step: interpolate, ML TED, Costas step =====
        ye_re, ye_im, yd_re, yd_im = interp(tau, base, (tb['h'], tb['dh']))
        q = torch.clamp(ye_re * yd_re + ye_im * yd_im, -1.0, 1.0)
        rate = rate + K2 * q
        tau_o = tau + BASE_STEP + K1 * q + rate
        phi = _costas_step(phi, dphi)
        ce, se = torch.cos(phi), torch.sin(phi)
        ve_re = ye_re * ce + ye_im * se                  # y * exp(-i phi)
        ve_im = ye_im * ce - ye_re * se
        # Costas runaway watchdog during search (hfdl.c:711-715)
        runaway = (dphi.abs() > C.COSTAS_DPHI_RESET_LIMIT) & (fr == A1_SEARCH)
        phi = w(runaway, 0.0, phi)
        dphi = w(runaway, 0.0, dphi)
        rate = w(runaway, 0.0, rate)
        # ===== odd half-step =====
        yo_re, yo_im = interp(tau_o, base, (tb['h'],))
        tau_next = tau_o + BASE_STEP + rate
        phi = _costas_step(phi, dphi)
        co, so = torch.cos(phi), torch.sin(phi)
        vo_re = yo_re * co + yo_im * so
        vo_im = yo_im * co - yo_re * so
        lvl = lvl_sym[:, t]
        bre = torch.cat([bre[:, 2:], ve_re[:, None], vo_re[:, None]], dim=1)
        bim = torch.cat([bim[:, 2:], ve_im[:, None], vo_im[:, None]], dim=1)

        # ---- symbol processing ----
        yq_re, yq_im, en = _ordered_sum(torch.stack([
            tre * bre - tim * bim, tre * bim + tim * bre,
            bre * bre + bim * bim]))
        theta = torch.atan2(yq_im, yq_re)
        err_b = theta - torch.round(theta * _INV_PI) * math.pi
        tq = theta - math.pi / 4
        err_q = tq - torch.round(tq * (2 * _INV_PI)) * (math.pi / 2)
        err_8 = theta - torch.round(theta * (4 * _INV_PI)) * (math.pi / 4)
        perr = w(cur_arity == 1, err_b, w(cur_arity == 2, err_q, err_8))
        bit_raw = (yq_re < 0).to(i32)
        err = torch.clamp(perr, -1.0, 1.0)
        phi = phi + C.COSTAS_ALPHA * err
        dphi = dphi + C.COSTAS_BETA * err

        # EQ training on the T sequence (hfdl.c:730-733)
        in_train = fr == EQ_TRAIN
        t_i = torch.clamp(t_idx, 0, C.T_LEN - 1).to(torch.int64)
        d_re = tb['t_bip'][t_i] * w(bitmask, -1.0, 1.0)
        e_re = d_re - yq_re
        e_im = -yq_im
        den = en + 1e-6
        g_re = C.EQ_BANDWIDTH * e_re / den
        g_im = C.EQ_BANDWIDTH * e_im / den
        upd_re = g_re[:, None] * bre + g_im[:, None] * bim   # g * conj(buf)
        upd_im = g_im[:, None] * bre - g_re[:, None] * bim
        tre = w(in_train[:, None], tre + upd_re, tre)
        tim = w(in_train[:, None], tim + upd_im, tim)
        t_idx = w(in_train, t_idx + 1, t_idx)

        # training-bit errors (hfdl.c:952-966, incremental)
        tbit = bit_raw ^ bitmask.to(i32)
        t_err = (tbit != tb['t_bits'][t_i]).to(i32)
        train_bad = train_bad + w(in_train, t_err, 0)
        train_total = train_total + in_train.to(i32)

        # bit window push during bit-emitting states
        emit_bits = fr <= M1_SEARCH
        wbit = 1.0 - 2.0 * tbit.to(torch.float32)
        window = w(emit_bits[:, None],
                   torch.cat([window[:, 1:], wbit[:, None]], dim=1), window)

        in_data = (fr == DATA_1) | (fr == DATA_2)
        out_data_idx = data_idx
        data_idx = data_idx + in_data.to(i32)
        out_idx = out_idx + 2

        # signal level averaging inside a frame (hfdl.c:766-773)
        in_frame = fr > A1_SEARCH
        sig = w(in_frame, (sig * fsc + lvl) / (fsc + 1.0), sig)
        fsc = w(in_frame, fsc + 1.0, fsc)

        # noise-floor EMA while hunting (hfdl.c:699-706)
        nf_clk = nf_clk + 1
        nf_due = (nf_clk >= NF_PERIOD) & (fr == A1_SEARCH)
        nf = w(nf_due, 0.65 * nf + 0.35 * torch.minimum(nf, lvl) + 1e-6, nf)
        nf_clk = w(nf_due, 0, nf_clk)

        abs_symbol = abs_symbol + 1
        symbol_cnt = symbol_cnt + 1
        # long-hunt watchdog (hfdl.c:746-752)
        stale = (symbol_cnt >= C.MAX_SYMBOLS_WITHOUT_FRAME) & (fr == A1_SEARCH)
        phi = w(stale, 0.0, phi)
        dphi = w(stale, 0.0, dphi)
        rate = w(stale, 0.0, rate)
        symbol_cnt = w(stale, 0, symbol_cnt)

        # ---- framer FSM ----
        corr_a = (window @ tb['a_bip']) * _INV_A_LEN
        corr_m = ((window @ tb['m1_bip']) * _INV_A_LEN).abs()    # (C, 8)
        corr_m1, m1_match = corr_m.max(dim=1)   # first index of the maximum
        upd, flags = framer_fsm_step(
            fr=fr, sw=sw, retries=retries, bitmask=bitmask, mode=mode,
            data_arity=data_arity, cur_arity=cur_arity, segs_left=segs_left,
            eq_cnt=eq_cnt, t_idx=t_idx, data_idx=data_idx,
            freq_err=freq_err, frame_start=frame_start, sig=sig, fsc=fsc,
            lvl=lvl, dphi=dphi, abs_symbol=abs_symbol,
            train_bad=train_bad, train_total=train_total,
            corr_a=corr_a, corr_m1=corr_m1, m1_match=m1_match.to(i32),
            mode_segments=tb['mode_segments'], mode_arity=tb['mode_arity'])

        # frame completion -> event table (slot K_EVENTS = overflow)
        emit = flags['frame_done']
        fields = torch.stack([
            torch.ones_like(sig), upd['mode'].to(torch.float32),
            flags['ev_bitmask'].to(torch.float32),
            (frame_counter % C.FRAME_PARITY_SLOTS).to(torch.float32),
            upd['freq_err'], upd['sig'], nf,
            flags['ev_train_bad'].to(torch.float32),
            flags['ev_train_total'].to(torch.float32),
            upd['frame_start'].to(torch.float32),
            (upd['frame_start'] & ((1 << 22) - 1)).to(torch.float32),
        ], dim=-1)
        slot = w(emit, torch.clamp(ev_count, max=K_EVENTS), K_EVENTS) \
            .to(torch.int64)
        ev_table[cidx, slot] = w(emit[:, None], fields, ev_table[cidx, slot])
        ev_count = ev_count + emit.to(i32)
        ev_dropped = emit & (ev_count > K_EVENTS)
        counters = counters + torch.stack(
            [flags['a2_hit'], flags['m1_hit'], flags['m1_fail'], ev_dropped],
            dim=-1).to(torch.float32)

        sym_re[t] = yq_re
        sym_im[t] = yq_im
        packed[t] = (in_data.to(i32) + 2 * (frame_counter & 3)
                     + 2 * C.FRAME_PARITY_SLOTS * out_data_idx)
        frame_counter = w(emit, frame_counter + 1, frame_counter)
        symbol_cnt = w(emit, 0, symbol_cnt)

        # framer reset, non-scalar part
        do_reset = flags['do_reset']
        tre = w(do_reset[:, None], tb['eq0'][None, :], tre)
        tim = w(do_reset[:, None], 0.0, tim)
        rate = w(do_reset, 0.0, rate)

        tau = tau_next
        fr, sw, retries = upd['fr'], upd['sw'], upd['retries']
        bitmask, mode = upd['bitmask'], upd['mode']
        data_arity, cur_arity = upd['data_arity'], upd['cur_arity']
        segs_left, eq_cnt = upd['segs_left'], upd['eq_cnt']
        t_idx, data_idx = upd['t_idx'], upd['data_idx']
        freq_err, frame_start = upd['freq_err'], upd['frame_start']
        sig, fsc = upd['sig'], upd['fsc']
        train_bad, train_total = upd['train_bad'], upd['train_total']

    final = TrackerState(
        tau=tau, rate=rate, out_idx=out_idx, phi=phi, dphi=dphi,
        eq_taps=torch.complex(tre, tim), eq_buf=torch.complex(bre, bim),
        window=window, fr_state=fr, symbols_wanted=sw,
        search_retries=retries, bitmask=bitmask, mode=mode,
        data_arity=data_arity, cur_arity=cur_arity,
        data_segments_left=segs_left, eq_train_cnt=eq_cnt, t_idx=t_idx,
        data_idx=data_idx, frame_counter=frame_counter,
        symbol_cnt=symbol_cnt, abs_symbol=abs_symbol,
        frame_start_sym=frame_start, train_bad=train_bad,
        train_total=train_total, freq_err=freq_err, signal_level=sig,
        frame_sym_cnt=fsc, noise_floor=nf, nf_clk=nf_clk,
        acq_hit=st.acq_hit)
    outs = TrackerOutputs(
        sym=torch.complex(sym_re, sym_im),
        is_data=(packed & 1) != 0,
        data_idx=packed // (2 * C.FRAME_PARITY_SLOTS),
        frame_parity=(packed >> 1) & (C.FRAME_PARITY_SLOTS - 1))
    ev = ev_table[:, :K_EVENTS].reshape(c, K_EVENTS * EV_FIELDS)
    return final, outs, ev, counters


def idle_update(st: TrackerState, lvl_sym: torch.Tensor, tau: torch.Tensor,
                num_steps: int) -> TrackerState:
    """Closed-form state after num_steps symbols of a hunting channel whose
    tile skips the loop (the acquisition gate's idle path).

    Exact for everything frame detection depends on: the symbol clocks,
    the hunt watchdog and its resets, and the noise-floor EMA at its
    cadence with the same level samples.  tau follows the nominal advance
    and phi/dphi hold (the no-noise limit of the loop, as in the JAX
    kernel).  The EMA cadence also covers an nf_clk carried past the
    period out of a frame, where the loop updates on the first symbol."""
    n = num_steps
    sc = st.symbol_cnt
    sc2 = sc + n
    crossed = sc2 >= C.MAX_SYMBOLS_WITHOUT_FRAME
    k_cross = torch.clamp(C.MAX_SYMBOLS_WITHOUT_FRAME - sc, 0, n) \
        .to(torch.float32)
    new_tau = tau + 2.0 * BASE_STEP * float(n) + 2.0 * st.rate * k_cross
    zero = lambda v: torch.where(crossed, 0.0, v)
    # EMA updates land on local symbols t0, t0 + 85, ... (t0 = 84 - nf_clk,
    # or 0 when the clock is already past the period)
    nfclk = st.nf_clk
    t0 = torch.clamp(NF_PERIOD - 1 - nfclk, min=0)
    nf = st.noise_floor
    for m in range(n // NF_PERIOD + 1):
        t_m = t0 + NF_PERIOD * m
        valid = t_m < n
        lv = torch.gather(lvl_sym, 1,
                          torch.clamp(t_m, max=n - 1).to(torch.int64)[:, None])
        nf = torch.where(valid, 0.65 * nf + 0.35 * torch.minimum(nf, lv[:, 0])
                         + 1e-6, nf)
    n_upd = torch.where(t0 < n, (n - 1 - t0) // NF_PERIOD + 1, 0)
    t_last = t0 + NF_PERIOD * (n_upd - 1)
    new_clk = torch.where(n_upd > 0, n - 1 - t_last, nfclk + n)
    return st._replace(
        tau=new_tau, rate=zero(st.rate), phi=zero(st.phi),
        dphi=zero(st.dphi),
        symbol_cnt=torch.where(crossed, sc2 - C.MAX_SYMBOLS_WITHOUT_FRAME,
                               sc2),
        abs_symbol=st.abs_symbol + n, out_idx=st.out_idx + 2 * n,
        noise_floor=nf, nf_clk=new_clk.to(torch.int32))


def tracker_block(state: TrackerState, x: torch.Tensor, level: torch.Tensor,
                  num_steps: int, act: torch.Tensor | None = None):
    """Plain version of kernel K2: run the tracker over one block.

    Args:
      state: carried TrackerState.
      x: (C, T) matched-filtered complex64 input at 5400 sps, *including*
         the HALO samples carried from the previous block at the front.
      level: (C, T) f32 AGC level aligned with x.
      num_steps: symbols to run ((T - HALO) / 3).
      act: (ceil(C/128),) int per 128-channel tile; 0 = the tile takes the
         closed-form idle update (every channel hunting, no preamble
         energy).  None = every tile runs the loop.

    Returns (new_state, outputs, ev (C, 44) f32, counters (C, 4) f32);
    new_state.tau is rebased for the next block.
    """
    c, t_len = x.shape
    x_al, lvl_al, tau, shift = align_block(state, x, level)
    lvl_sym = level_per_symbol(lvl_al, num_steps)
    dev = x.device
    active = torch.ones((c,), dtype=torch.bool, device=dev) if act is None \
        else (act.to(dev).repeat_interleave(CT)[:c] != 0)
    a_idx = torch.nonzero(active)[:, 0]
    i_idx = torch.nonzero(~active)[:, 0]

    final = state._replace(tau=tau)
    outs = TrackerOutputs(
        sym=torch.zeros((num_steps, c), dtype=torch.complex64, device=dev),
        is_data=torch.zeros((num_steps, c), dtype=torch.bool, device=dev),
        data_idx=torch.zeros((num_steps, c), dtype=torch.int32, device=dev),
        frame_parity=torch.zeros((num_steps, c), dtype=torch.int32,
                                 device=dev))
    ev = torch.zeros((c, K_EVENTS * EV_FIELDS), dtype=torch.float32,
                     device=dev)
    counters = torch.zeros((c, 4), dtype=torch.float32, device=dev)
    parts = []
    if len(a_idx):
        sub = select_channels(final, a_idx)
        st_a, o_a, ev_a, cnt_a = _run_loop(sub, x_al[a_idx], lvl_sym[a_idx],
                                           sub.tau, num_steps)
        parts.append((a_idx, st_a))
        for full, part in zip(outs, o_a):
            full[:, a_idx] = part
        ev[a_idx] = ev_a
        counters[a_idx] = cnt_a
    if len(i_idx):
        sub = select_channels(final, i_idx)
        parts.append((i_idx, idle_update(sub, lvl_sym[i_idx], sub.tau,
                                         num_steps)))
    fields = {}
    for f in TrackerState._fields:
        base = getattr(final, f)
        if base is None:
            fields[f] = None
            continue
        merged = base.clone()
        for idx, st_p in parts:
            merged[idx] = getattr(st_p, f)
        fields[f] = merged
    final = TrackerState(**fields)
    # undo the alignment shift, then rebase tau for the next block
    final = final._replace(
        tau=final.tau + shift.to(torch.float32) - float(t_len - HALO))
    return final, outs, ev, counters
