"""Narrowband channel demodulator: 5400 sps complex in -> decoded PDUs out.

Counterpart of ``dumphfdl_tpu/dsp/channel.py``, batched over channels:

  resampler (coset polyphase, from the channelizer's fs1 ring) ->
  AGC (chunked first-order scan, hfdl.c:485-487) ->
  matched filter (19 shifted multiply-adds, hfdl.c:148-155) ->
  tracker (kernel K2, dsp/tracker_cuda.py) ->
  contiguous per-channel symbol ring (the frame sink) ->
  event decode (dsp/backend.py, kernel K1).

Ring cursors (write cursor, base row) and the resampler cursor are plain
host integers: the host already mirrors them exactly, so no device value
is read back for them.  The per-block event-table readback is the only
sync point of the loop; the 8-mode decode runs only when it shows an
event.  The symbol ring is updated in place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from dumphfdl_tpu.ops import crc
from . import backend
from . import tracker_cuda
from .tracker import (EV_FIELDS, HALO, K_EVENTS, TrackerState,
                      tracker_init)


class AgcState(NamedTuple):
    gain: torch.Tensor      # (C,) f32
    energy: torch.Tensor    # (C,) f32 smoothed input energy


def agc_init(num_channels: int, device) -> AgcState:
    return AgcState(gain=torch.ones((num_channels,), device=device),
                    energy=torch.ones((num_channels,), device=device))


def agc_state_from_numpy(st, device) -> AgcState:
    """An AgcState of numpy arrays -> AgcState of f32 tensors on device."""
    return AgcState(*[torch.as_tensor(np.array(v, np.float32), device=device)
                      for v in st])


_AGC_CHUNK = 256


@functools.cache
def _agc_powers(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 float]:
    """(d^-j, d^j, d^(j+1)) for j < _AGC_CHUNK, and d^_AGC_CHUNK."""
    d = 1.0 - C.AGC_BANDWIDTH
    j = np.arange(_AGC_CHUNK, dtype=np.float64)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return t(d ** -j), t(d ** j), t(d ** (j + 1)), float(d ** _AGC_CHUNK)


def agc_block(state: AgcState, x: torch.Tensor
              ) -> tuple[AgcState, torch.Tensor, torch.Tensor]:
    """AGC: normalize each channel to unit RMS with bandwidth 0.01.

    The input-energy EMA e_t = (1-a) e_{t-1} + a |x_t|^2 is a first-order
    recurrence.  A closed form over a whole block needs (1-a)^-t, which
    overflows float32 long before a block ends, so the scan is chunked:
    inside a chunk of 256 samples it is a cumsum of p_j (1-a)^-j rescaled
    by (1-a)^j (bounded by 0.99^-255 < 13), and chunk ends carry
    sequentially.  Against the JAX associative scan this reorders float32
    sums: relative error ~1e-6.

    Returns (state, y (C,T) normalized, level (C,T) input-level estimate)."""
    c, t = x.shape
    winv, wpow, wnext, d_chunk = _agc_powers(x.device)
    n = -(-t // _AGC_CHUNK)
    p = C.AGC_BANDWIDTH * (x.real ** 2 + x.imag ** 2)
    p = torch.nn.functional.pad(p, (0, n * _AGC_CHUNK - t))
    local = torch.cumsum(p.reshape(c, n, _AGC_CHUNK) * winv, dim=-1) * wpow
    carry = [state.energy]                     # energy before each chunk
    for k in range(n - 1):
        carry.append(local[:, k, -1] + d_chunk * carry[-1])
    e = local + wnext * torch.stack(carry, dim=1)[:, :, None]
    e = e.reshape(c, n * _AGC_CHUNK)[:, :t]
    level = torch.sqrt(torch.clamp(e, min=1e-12))
    g = torch.clamp(1.0 / level, 1e-6, 1e6)
    return AgcState(gain=g[:, -1], energy=e[:, -1]), x * g, level


_MF_TAPS = tuple(float(np.float32(v)) for v in C.MF_TAPS)


def matched_filter(x: torch.Tensor) -> torch.Tensor:
    """19-tap matched FIR, causal, batched over channels (hfdl.c:694-695).

    Written as 19 shifted multiply-adds in float32 (no convolution
    library call, so no TF32 path on the card)."""
    k = len(_MF_TAPS)
    t = x.shape[1]
    xp = torch.cat([torch.zeros((x.shape[0], k - 1), dtype=x.dtype,
                                device=x.device), x], dim=1)
    y = xp[:, k - 1:k - 1 + t] * _MF_TAPS[0]
    for j in range(1, k):
        y = y + xp[:, k - 1 - j:k - 1 - j + t] * _MF_TAPS[j]
    return y


class FrameEvent(NamedTuple):
    """Host-side record of one completed frame."""
    channel: int
    mode: int
    bitmask: bool
    freq_err_hz: float
    rssi: float           # linear signal level
    noise_floor: float    # linear
    train_bad: int
    train_total: int
    start_symbol: int     # absolute symbol index of frame start (prekey)
    pdu: bytes | None = None
    fcs_ok: bool = False  # header-FCS verdict (junk frames are False)


# ---- per-channel symbol ring (the frame sink) ---------------------------
#
# Every equalized symbol is appended contiguously to a per-channel ring;
# completed frames are gathered from it by the rigid post-A2 schedule
# (backend.gather_event_symbols).  When the write cursor would pass RING_T
# the last RING_KEEP symbols slide to the front and the base row advances;
# RING_KEEP covers a double-slot frame collected up to two blocks late.

RING_T = 32768
MAX_BLOCK_SYMBOLS = 5400            # 16200 samples (3 s) per demod block
RING_KEEP = C.DOUBLE_SLOT_FRAME_LEN + 2 * MAX_BLOCK_SYMBOLS + 64

_GATHER_BATCH_MIN = 32      # smallest padded gather batch
_GATHER_BATCH_MAX = 2048    # largest single dispatch


def _ring_update(symring: torch.Tensor, ringmeta: tuple[int, int],
                 sym_tc: torch.Tensor) -> tuple[int, int]:
    """Append one block of symbols ((C, T) channel-major) to symring in
    place at the write cursor; ringmeta = (wcur, base22) host ints.  When
    the block would pass the ring end the kept history slides to the
    front first.  Returns the new (wcur, base22)."""
    wcur, base22 = ringmeta
    t = sym_tc.shape[1]
    if wcur + t > RING_T:
        shift = wcur - RING_KEEP
        symring[:, :RING_KEEP] = symring[:, shift:wcur].clone()
        base22 = (base22 + shift) & ((1 << 22) - 1)
        wcur = RING_KEEP
    symring[:, wcur:wcur + t] = sym_tc
    return wcur + t, base22


def _resample_ring(fs1_ring: torch.Tensor, bank: np.ndarray,
                   rs_state: tuple[int, int, int], rs_const: tuple
                   ) -> torch.Tensor:
    """Polyphase resample of one out-chunk from the fs1 ring.

    With the exact rational ratio num/den, outputs i and i+den read the
    ring exactly num samples apart with the same fractional phase, so the
    chunk splits into den cosets, each a fixed-phase FIR over a stride-num
    slice of one contiguous (modular) slab.  rs_state = (a_frac_num,
    a_int, rstart) host ints."""
    k, num, den, n_out = rs_const
    m = n_out // den
    c, r1 = fs1_ring.shape
    a_fnum, a_int, rstart = rs_state
    slab_len = m * num + k + 2
    start = (rstart + a_int - (k // 2 - 1)) % r1
    idx = (start + torch.arange(slab_len, device=fs1_ring.device)) % r1
    slab = fs1_ring[:, idx]
    span = (m - 1) * num + 1
    out = torch.empty((c, m, den), dtype=fs1_ring.dtype,
                      device=fs1_ring.device)
    for j in range(den):
        tj = a_fnum + j * num
        b_j = tj // den
        frac = np.float32(tj - b_j * den) / np.float32(den)
        taps = bank[int(np.round(frac * np.float32(64)))]
        acc = slab[:, b_j:b_j + span:num] * float(taps[0])
        for t in range(1, k):
            acc = acc + slab[:, b_j + t:b_j + t + span:num] * float(taps[t])
        out[:, :, j] = acc
    return out.reshape(c, n_out)


def _rs_advance(rs_state: tuple[int, int, int], rs_const: tuple,
                ring_len: int) -> tuple[int, int, int]:
    """Advance the resampler cursor past one out-chunk and free consumed
    ring space (the JAX package does this on device; mirrored by
    Channelizer.consume_chunk)."""
    k, num, den, n_out = rs_const
    a_num = rs_state[0] + rs_state[1] * den + n_out * num
    a_int = a_num // den
    a_fnum = a_num - a_int * den
    drop = max(a_int - k, 0)
    return a_fnum, a_int - drop, (rs_state[2] + drop) % ring_len


def channel_step(agc_state: AgcState, tracker_state: TrackerState,
                 symring: torch.Tensor, ringmeta: tuple[int, int],
                 tail: torch.Tensor, lvl_tail: torch.Tensor,
                 x: torch.Tensor, num_steps: int):
    """One demod block of (C, T) samples at 5400 sps: AGC -> MF -> tracker
    -> ring append (symring in place).  Returns (agc_state, tracker_state,
    ringmeta, tail, lvl_tail, outs, ev_table, counters)."""
    agc_state, y, level = agc_block(agc_state, x)
    mf = matched_filter(y)
    mf_ext = torch.cat([tail, mf], dim=1)
    lvl_ext = torch.cat([lvl_tail, level], dim=1)
    tracker_state, outs, ev_table, counters = tracker_cuda.tracker_block(
        tracker_state, mf_ext, lvl_ext, num_steps)
    ringmeta = _ring_update(symring, ringmeta, outs.sym.T)
    return (agc_state, tracker_state, ringmeta, mf_ext[:, -HALO:],
            lvl_ext[:, -HALO:], outs, ev_table, counters)


def channel_step_fused(agc_state: AgcState, tracker_state: TrackerState,
                       symring: torch.Tensor, ringmeta: tuple[int, int],
                       tail: torch.Tensor, lvl_tail: torch.Tensor,
                       fs1_ring: torch.Tensor, rs_state: tuple,
                       rs_bank: np.ndarray, num_steps: int, rs_const: tuple):
    """channel_step straight from the channelizer's fs1 ring, the resampler
    folded in; additionally returns the advanced resampler cursor."""
    x = _resample_ring(fs1_ring, rs_bank, rs_state, rs_const)
    out = channel_step(agc_state, tracker_state, symring, ringmeta, tail,
                       lvl_tail, x, num_steps)
    return out + (_rs_advance(rs_state, rs_const, fs1_ring.shape[1]),)


def fused_collect(symring: torch.Tensor, base22: int,
                  ev_table: torch.Tensor, e_max: int) -> torch.Tensor:
    """The block's event decode: up to e_max frames decoded in one padded
    batch on the table's device (backend.decode_events_inline).  The JAX
    package gates this on "any event" inside the program; here the caller
    decides on the host from the read-back table and calls it only then."""
    return backend.decode_events_inline(symring, base22, ev_table, e_max)


class _Readback(NamedTuple):
    """An event table on its way to the host (non-blocking copy)."""
    device_table: torch.Tensor
    host_table: torch.Tensor
    done: object            # torch.cuda.Event, or None on the CPU


def _start_readback(ev_table: torch.Tensor) -> _Readback:
    if ev_table.device.type != 'cuda':
        return _Readback(ev_table, ev_table, None)
    host = torch.empty(ev_table.shape, dtype=ev_table.dtype, pin_memory=True)
    host.copy_(ev_table, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return _Readback(ev_table, host, done)


@dataclasses.dataclass
class ChannelBank:
    """Streaming demodulator for a batch of channels at 5400 sps.

    Event collection runs one block behind: a step returns the previous
    block's events, so the event-table copy of block N-1 overlaps block N's
    device work; drain_events() collects the last one.
    fused_event_decode is the number of frames decoded per block in one
    padded batch (e_max); events past it take the per-mode gather path."""
    num_channels: int
    device: torch.device
    fused_event_decode: int = 64
    agc_state: AgcState = None
    tracker_state: TrackerState = None
    symring: torch.Tensor = None      # (C, RING_T) contiguous symbol history
    _ringmeta: tuple = (0, 0)         # (write cursor, base row mod 2^22)
    _tail: torch.Tensor = None        # (C, HALO) carried MF output
    _lvl_tail: torch.Tensor = None

    def __post_init__(self):
        c = self._c = self.num_channels
        dev = self.device = torch.device(self.device)
        self.agc_state = agc_init(c, dev)
        self.tracker_state = tracker_init(c, dev)
        self.symring = torch.zeros((c, RING_T), dtype=torch.complex64,
                                   device=dev)
        self._ringmeta = (0, 0)
        self._tail = torch.zeros((c, HALO), dtype=torch.complex64, device=dev)
        self._lvl_tail = torch.ones((c, HALO), dtype=torch.float32, device=dev)
        self._pending = None
        self.last_counters = None

    def _check_block_invariant(self, num_steps: int) -> None:
        # an event's data (up to a double-slot frame back) must still be in
        # the ring when it is decoded, up to 2 blocks after completion
        if num_steps > MAX_BLOCK_SYMBOLS:
            raise ValueError(
                f'block of {num_steps * C.SPS} samples ({num_steps} '
                f'symbols) exceeds the symbol-ring history invariant '
                f'(max {MAX_BLOCK_SYMBOLS} symbols = '
                f'{MAX_BLOCK_SYMBOLS * C.SPS} samples)')

    def process(self, samples) -> list[FrameEvent]:
        """Feed a (C, T) block at 5400 sps; returns completed frames."""
        x = torch.as_tensor(samples, dtype=torch.complex64, device=self.device)
        num_steps = int(x.shape[1] // C.SPS)
        self._check_block_invariant(num_steps)
        (self.agc_state, self.tracker_state, self._ringmeta, self._tail,
         self._lvl_tail, _outs, ev_table, counters) = channel_step(
            self.agc_state, self.tracker_state, self.symring,
            self._ringmeta, self._tail, self._lvl_tail, x, num_steps)
        return self._finish_step(ev_table, counters)

    def process_fused(self, chan) -> list[FrameEvent]:
        """Consume one out_chunk from a Channelizer's fs1 ring: resample +
        AGC + MF + tracker + ring append, then collect events."""
        num_steps = chan.out_chunk // C.SPS
        self._check_block_invariant(num_steps)
        rs_const = (chan._rs_taps, chan._rs_num, chan._rs_den,
                    chan.out_chunk)
        (self.agc_state, self.tracker_state, self._ringmeta, self._tail,
         self._lvl_tail, _outs, ev_table, counters,
         new_rs) = channel_step_fused(
            self.agc_state, self.tracker_state, self.symring,
            self._ringmeta, self._tail, self._lvl_tail, chan._fs1_ring,
            chan.rs_device_state(), chan._bank, num_steps, rs_const)
        chan.consume_chunk(new_rs)
        return self._finish_step(ev_table, counters)

    def _finish_step(self, ev_table, counters) -> list[FrameEvent]:
        self.last_counters = counters    # (C, 4): A2, M1, M1-miss, overflow
        prev, self._pending = self._pending, _start_readback(ev_table)
        return self._collect_events(prev) if prev is not None else []

    def drain_events(self) -> list[FrameEvent]:
        """Collect the deferred block's events."""
        prev, self._pending = self._pending, None
        return self._collect_events(prev) if prev is not None else []

    def _collect_events(self, rb: _Readback) -> list[FrameEvent]:
        """Decode completed frames of one block from its event table."""
        if rb.done is not None:
            rb.done.synchronize()
        table = rb.host_table.numpy().reshape(self._c, K_EVENTS, EV_FIELDS)
        valid = table[:, :, 0] > 0.5
        if not valid.any():
            return []
        chans, slots = np.nonzero(valid)
        flat_rows = chans * K_EVENTS + slots    # ascending, = device order
        f = table[chans, slots]
        modes = f[:, 1].astype(np.int64)
        bitmasks = f[:, 2] > 0.5
        start22s = f[:, 10].astype(np.int64)
        events = [FrameEvent(
            channel=int(chans[i]), mode=int(modes[i]),
            bitmask=bool(bitmasks[i]), freq_err_hz=float(f[i, 4]),
            rssi=float(f[i, 5]), noise_floor=float(f[i, 6]),
            train_bad=int(f[i, 7]), train_total=int(f[i, 8]),
            start_symbol=int(f[i, 9])) for i in range(len(chans))]
        need_gather = list(range(len(events)))
        if self.fused_event_decode:
            dec = fused_collect(self.symring, self._ringmeta[1],
                                rb.device_table,
                                self.fused_event_decode).cpu().numpy()
            by_row = {int(r): j for j, r in enumerate(dec[:, 0]) if r >= 0}
            need_gather = []
            for i, ev in enumerate(events):
                j = by_row.get(int(flat_rows[i]))
                if j is None:                    # past the fused capacity
                    need_gather.append(i)
                    continue
                fb = C.MODES[ev.mode].framebits
                words = dec[j, 2:].astype(np.uint32)
                bits = ((words[:, None] >> np.arange(32, dtype=np.uint32))
                        & 1).astype(np.uint8).reshape(-1)[:fb]
                events[i] = ev._replace(
                    pdu=backend.pdu_bytes_from_bits(bits[None])[0],
                    fcs_ok=bool(dec[j, 1]))
        if need_gather:
            events = self._decode_by_gather(events, np.asarray(need_gather),
                                            chans, start22s, modes, bitmasks)
        return events

    def _decode_by_gather(self, events, idxs, chans, start22s, modes,
                          bitmasks) -> list[FrameEvent]:
        """Gather + decode the given events on the device in per-mode
        batches (padded to powers of two); only the bits come back."""
        dev = self.device
        sub_modes = modes[idxs]
        for mode in np.unique(sub_modes):
            rel = np.nonzero(sub_modes == mode)[0]
            p = C.MODES[mode]
            for off in range(0, len(rel), _GATHER_BATCH_MAX):
                n = min(_GATHER_BATCH_MAX, len(rel) - off)
                sel = idxs[rel[off:off + n]]
                batch = max(_GATHER_BATCH_MIN, 1 << int(np.ceil(np.log2(n))))
                pad = lambda a: torch.as_tensor(
                    np.pad(a[sel].astype(np.int64), (0, batch - n)),
                    device=dev)
                syms = backend.gather_event_symbols(
                    self.symring, pad(start22s), self._ringmeta[1],
                    pad(chans))[:, :p.num_data_symbols]
                bits = backend._decode_core(syms, pad(bitmasks) != 0,
                                            int(mode))
                pdus = backend.pdu_bytes_from_bits(bits[:n].cpu().numpy())
                for r, pdu in zip(sel, pdus):
                    events[r] = events[r]._replace(
                        pdu=pdu, fcs_ok=crc.pdu_fcs_ok(pdu))
        return events
