"""Streaming superstep: one raw SDR chunk -> frame events, one CUDA graph.

Counterpart of ``dumphfdl_tpu/dsp/superstep.py``.  The eager streaming
loop issues thousands of small device operations per demod block and the
card waits for the host most of the time.  With an exact cadence alignment
the whole steady state has static shapes and no host decision, so it can
be captured once and replayed: choose the demod block length ``out`` so
that

    out % SPS == 0                  (whole symbols)
    out * num % (den * post) == 0   (whole channelizer frames)

where num/den is the exact reduced fs1/5400 ratio and ``post`` the
overlap-save frames' per-frame output.  Then every super-block consumes
exactly F = out*num/(den*post) overlap-save frames = F * input_size
wideband samples:

  raw int16/uint8 samples (the upload, untouched bytes)
    -> format conversion on the device (io/ingest.convert_on_device)
    -> overlap-save framing from the carried wideband tail (no ring)
    -> F/SUB sub-batches of the bin-window DDC (frontend.ddc_frames; the
       sub-batch bounds the (SUB, rows, W) working set)
    -> polyphase resample with static coset phases (the cursor advances
       by an exact integer per block, so slice starts and tap rows are
       Python constants)
    -> demod step (AGC -> MF -> tracker kernel K2 -> symbol ring)
    -> the block's event table.

The JAX package compiles this into one program per super-block; here it is
``SuperstepEngine._step``, which runs eagerly once (a warm-up that also
fills every cache) and is then captured into one CUDA graph that each
later block replays.  Every carried value lives in a fixed buffer that the
step updates in place; the step's temporaries belong to the graph's pool.
On the CPU the same ``_step`` runs eagerly.  A capture that fails raises.
The event table's readback and the event decode stay outside the graph
(ChannelBank._swap_pending, _collect), as they are outside the step on
every path.

The resampler introduces one block of latency: block j's demod consumes
the fs1 samples produced by block j-1 (with +-taps/2 lookahead into block
j), so the first super-block demodulates carried silence.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import constants as C
from ..device import on
from ..io import formats
from ..io import ingest
from ..utils import profiling
from .channel import (MAX_BLOCK_SYMBOLS, AgcState, _ring_slide,
                      channel_step)
from .tracker import EV_FIELDS, K_EVENTS, TrackerState


@dataclasses.dataclass(frozen=True)
class SuperstepPlan:
    """Static cadence of one super-block."""
    out_chunk: int        # 5400-sps samples demodulated per block
    frames: int           # overlap-save frames channelized per block (F)
    sub: int              # frames per DDC sub-batch (divisor of F)
    wb_chunk: int         # wideband samples ingested per block
    fs1_chunk: int        # fs1 samples produced per block (= F * post)

    @property
    def symbols(self) -> int:
        return self.out_chunk // C.SPS


def plan_superstep(chz, max_symbols: int = MAX_BLOCK_SYMBOLS,
                   ) -> SuperstepPlan | None:
    """Smallest aligned super-block for this channelizer geometry, or
    None when the cadence cannot align within the symbol-ring invariant
    (e.g. 2.16 Msps, whose reduced ratio 25/16 needs a 16 s block)."""
    if not chz._rs_exact:
        return None
    num, den = chz._rs_num, chz._rs_den
    post = chz.geo.post_input_size
    g = math.gcd(num, den * post)
    need = den * post // g            # out_chunk must be a multiple
    unit = need * C.SPS // math.gcd(need, C.SPS)
    if unit // C.SPS > max_symbols:
        return None
    frames = unit * num // (den * post)
    # smallest sub-batch >= frames/8 that divides frames (bounds the DDC
    # working set at ~1/8 of the all-at-once product)
    sub = next(s for s in range(-(-frames // 8), frames + 1)
               if frames % s == 0)
    return SuperstepPlan(out_chunk=unit, frames=frames, sub=sub,
                         wb_chunk=frames * chz.geo.input_size,
                         fs1_chunk=frames * post)


class SuperstepEngine:
    """Holds the carried device state and the captured super-block step.

    Demod-side state (AGC, tracker, symbol ring, MF tails) lives in the
    ChannelBank as for the other paths; the engine adds the frontend's
    carries: the overlap-save wideband tail, the per-channel mixer phase,
    the previous fs1 block (+taps/2 pre-roll) for the one-block-delayed
    resampler, and the symbol ring's cursor in its device form.

    On a CUDA device the step is replayed as a CUDA graph (use_graph), on
    the CPU it runs eagerly; the device decides, there is no option.
    """

    def __init__(self, chz, bank, input_kind: str = 'CS16'):
        plan = plan_superstep(chz)
        if plan is None:
            raise ValueError('geometry does not align for superstep')
        self.chz = chz
        self.bank = bank
        self.plan = plan
        self.input_kind = input_kind.upper()
        if self.input_kind not in ('CS16', 'CU8', 'CF32'):
            raise ValueError(f'unsupported input kind {input_kind}')
        dev = self.device = chz.device
        self.rows = chz.rows
        self.pre = chz._rs_taps // 2  # fs1 pre-roll before the delayed block
        c64 = dict(dtype=torch.complex64, device=dev)
        self._wb_tail = torch.zeros(chz.geo.overlap_length, **c64)
        self._fs1_tail = torch.zeros((self.rows, self.pre + plan.fs1_chunk),
                                     **c64)
        self._ringmeta = torch.zeros(2, dtype=torch.int64, device=dev)
        self._raw = torch.zeros(
            self.plan.wb_chunk * (1 if self.input_kind == 'CF32' else 2),
            dtype=ingest.RAW_DTYPES[self.input_kind], device=dev)
        f32 = dict(dtype=torch.float32, device=dev)     # the step's outputs
        self._ev_table = torch.zeros((self.rows, K_EVENTS * EV_FIELDS), **f32)
        self._counters = torch.zeros((self.rows, 4), **f32)
        self.use_graph = dev.type == 'cuda'
        # the buffers the step (and its graph) is bound to, and the ring
        # cursor their device copy holds
        self._fixed = self.carried()
        self._meta_host = (0, 0)
        self._graph = None
        self.blocks_done = 0
        self.replays = 0

    # latency between the stream sample clock and the tracker's symbol
    # clock introduced by the one-block resampler delay
    @property
    def delay_symbols(self) -> int:
        return self.plan.symbols

    @property
    def raw_chunk_bytes(self) -> int:
        return self.plan.wb_chunk * formats.bytes_per_sample(self.input_kind)

    def carried(self) -> dict[str, torch.Tensor]:
        """Every tensor the step reads and updates in place, by name (for
        comparing two runs, or saving and restoring the engine's state)."""
        b = self.bank
        out = dict(wb_tail=self._wb_tail, fs1_tail=self._fs1_tail,
                   mixer_phase=self.chz._mixer_phase,
                   ringmeta=self._ringmeta, symring=b.symring,
                   mf_tail=b._tail, lvl_tail=b._lvl_tail,
                   agc_gain=b.agc_state.gain, agc_energy=b.agc_state.energy)
        out.update({f'tracker.{f}': v for f, v in
                    zip(b.tracker_state._fields, b.tracker_state)})
        return out

    def _adopt_state(self) -> None:
        """The other paths (fused, unfused) leave their results in new
        tensors and move the ring cursor on the host only.  If one of
        them ran on this receiver since the last super-block, copy what it
        left into the fixed buffers and point the bank back at them."""
        b = self.bank
        moved = False
        for name, cur in self.carried().items():
            if cur is not self._fixed[name]:
                self._fixed[name].copy_(cur)
                moved = True
        if moved:
            fx = self._fixed
            self.chz._mixer_phase = fx['mixer_phase']
            b.symring, b._tail, b._lvl_tail = \
                fx['symring'], fx['mf_tail'], fx['lvl_tail']
            b.agc_state = AgcState(fx['agc_gain'], fx['agc_energy'])
            b.tracker_state = TrackerState(
                *[fx[f'tracker.{f}'] for f in TrackerState._fields])
        if b._ringmeta != self._meta_host:
            self._ringmeta.copy_(torch.tensor(b._ringmeta,
                                              dtype=torch.int64))

    # ---- host API ----

    def upload(self, raw) -> torch.Tensor:
        """Host raw bytes (exactly raw_chunk_bytes; the chunker
        silence-pads the last chunk) -> the device tensor process_packed
        takes: the samples in their native width (int16 / uint8 /
        complex64), through pinned memory."""
        raw = ingest.as_raw_array(raw, self.input_kind)
        if raw.size != self._raw.numel():
            raise ValueError(f'superstep chunk of {raw.nbytes} bytes, '
                             f'expected {self.raw_chunk_bytes}')
        return ingest.put_raw(raw, self.device)

    def process_packed(self, packed: torch.Tensor) -> list:
        """One super-block: run the step on the uploaded chunk (eagerly
        the first time, then as a graph replay) and hand the event table
        to the bank's collector, which returns the previous block's
        events.  Everything up to the table's readback start is the span
        'rx.launch' (utils/profiling), a capture inside it 'rx.capture'."""
        b = self.bank
        sp = profiling.begin('rx.launch', b.blocks)
        self._adopt_state()
        self._raw.copy_(packed, non_blocking=True)
        if not self.use_graph or self.blocks_done == 0:
            self._step()
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            self.replays += 1
        # the ring cursor's host mirror (what the event decode addresses by)
        _shift, wcur, base22 = _ring_slide(b._ringmeta, self.plan.symbols)
        b._ringmeta = self._meta_host = (wcur + self.plan.symbols, base22)
        self.blocks_done += 1
        # the step's output buffers are overwritten by the next block, the
        # collector reads this block's table one block later
        rb = b._swap_pending(self._ev_table.clone(), self._counters.clone())
        profiling.end(sp)
        return b._collect(rb)

    def _capture(self) -> None:
        """Record one step into a CUDA graph.  K2's wrapper counts the one
        launch it records here; what the graph runs afterwards is counted
        in self.replays, not in the wrapper's count.  Other threads (the
        uploader) keep working while this thread records."""
        sp = profiling.begin('rx.capture', self.bank.blocks)
        with on(self.device):     # the capture stream is the current device's
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode='thread_local'):
                self._step()
        self._graph = graph
        profiling.end(sp)

    def verify_graph(self, packed: torch.Tensor) -> int:
        """Hold the graph against the eager step on one uploaded chunk:
        run the step eagerly, put the state back, replay the graph on the
        same chunk, and compare every carried tensor and both outputs bit
        for bit.  Returns the number of tensors compared; raises on any
        difference.  Leaves the engine as after one super-block whose
        events are dropped (a check for a receiver that decodes nothing
        else, after at least one block has run)."""
        if not self.use_graph or self.blocks_done == 0:
            raise RuntimeError('verify_graph needs a graph engine that has '
                               'run its warm-up block')
        self._adopt_state()
        self._raw.copy_(packed)
        before = {k: v.clone() for k, v in self.carried().items()}
        results = []
        for replay in (False, True):
            for k, v in self.carried().items():
                v.copy_(before[k])
            if replay:
                if self._graph is None:
                    self._capture()
                self._graph.replay()
            else:
                self._step()
            results.append({**{k: v.clone() for k, v in
                               self.carried().items()},
                            'ev_table': self._ev_table.clone(),
                            'counters': self._counters.clone()})
        eager, graph = results
        for k, v in eager.items():
            same = torch.equal(torch.view_as_real(v), torch.view_as_real(
                graph[k])) if v.is_complex() else torch.equal(v, graph[k])
            if not same:
                raise RuntimeError(f'graph replay differs from the eager '
                                   f'step in {k}')
        _shift, wcur, base22 = _ring_slide(self.bank._ringmeta,
                                           self.plan.symbols)
        self.bank._ringmeta = self._meta_host = (wcur + self.plan.symbols,
                                                 base22)
        self.blocks_done += 1
        return len(eager)

    # ---- the step ----

    def _resample_static(self, buf: torch.Tensor) -> torch.Tensor:
        """Static-phase coset resampler over the delayed fs1 buffer.

        buf = [pre-roll | previous block | current block]; output i of the
        block reads the window starting at pre + floor(i*num/den) -
        (taps/2 - 1).  Because out_chunk*num/den is an exact integer, the
        per-output fractional phases repeat with period den: coset j
        (outputs j, j+den, ...) is one fixed-phase FIR over a stride-num
        slice; all slice starts and tap values are Python constants."""
        chz = self.chz
        k, num, den = chz._rs_taps, chz._rs_num, chz._rs_den
        n_out = self.plan.out_chunk
        m = n_out // den
        span = (m - 1) * num + 1
        out = torch.empty((buf.shape[0], m, den), dtype=buf.dtype,
                          device=buf.device)
        for j in range(den):
            tj = j * num
            b_j = tj // den
            frac_j = (tj - b_j * den) / den
            taps_j = chz._bank[int(round(frac_j * 64))]
            start0 = self.pre + b_j - (k // 2 - 1)
            acc = buf[:, start0:start0 + span:num] * float(taps_j[0])
            for t in range(1, k):
                acc = acc + buf[:, start0 + t:start0 + t + span:num] \
                    * float(taps_j[t])
            out[:, :, j] = acc
        return out.reshape(buf.shape[0], n_out)

    def _step(self) -> None:
        """One super-block on self._raw.  No host decision and no host
        readback; every carried tensor is updated in place, the event
        table and counters land in self._ev_table / self._counters."""
        plan, chz, b = self.plan, self.chz, self.bank
        geo = chz.geo
        x = ingest.convert_on_device(self._raw, self.input_kind)
        wb = torch.cat([self._wb_tail, x])     # (overlap + F*input,)
        subwin = (plan.sub - 1) * geo.input_size + geo.fft_size
        phase = chz._mixer_phase
        parts = []
        for i in range(plan.frames // plan.sub):
            start = i * plan.sub * geo.input_size
            frames = wb[start:start + subwin].unfold(0, geo.fft_size,
                                                     geo.input_size)
            out, phase = chz.ddc_frames(frames, phase)
            parts.append(out)
        buf = torch.cat([self._fs1_tail] + parts, dim=1)
        y = self._resample_static(buf)
        (agc_state, tracker_state, _meta, mtail, ltail, _outs, ev_table,
         counters) = channel_step(
            b.agc_state, b.tracker_state, b.symring, self._ringmeta,
            b._tail, b._lvl_tail, y, plan.symbols)
        # carried values back into their fixed buffers
        self._wb_tail.copy_(wb[wb.shape[0] - geo.overlap_length:])
        self._fs1_tail.copy_(buf[:, plan.fs1_chunk:])
        chz._mixer_phase.copy_(phase)
        for dst, src in zip((*b.agc_state, *b.tracker_state, b._tail,
                             b._lvl_tail),
                            (*agc_state, *tracker_state, mtail, ltail)):
            dst.copy_(src)
        self._ev_table.copy_(ev_table)
        self._counters.copy_(counters)
