"""Wideband receiver: glue from raw wideband samples to decoded frames.

Counterpart of ``dumphfdl_tpu/dsp/receiver.py``: a Channelizer
(frontend.py) feeding one batched ChannelBank (channel.py).  Which of the
three paths a receiver takes follows from its sample rate and block
length:

* superstep (dsp/superstep.py): the rate's cadence aligns (plan_superstep)
  and block_len is at least the aligned block -- one CUDA graph per
  super-block, fed raw bytes through process_packed; a file is read in
  super-blocks (raw_chunk_bytes);
* fused: the exact resampler cursor fits and block_len is a whole number of
  its cosets -- the demod step resamples straight from the fs1 ring;
* unfused: everything else, and any receiver with --datadumps on -- the
  channelizer resamples into 5400-sps blocks for ChannelBank.process.

On the fused and unfused paths a file is read in file_chunk_samples: whole
overlap-save frames, so that each process() call channelizes one batch.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import constants as C
from ..utils import profiling
from .channel import ChannelBank, FrameEvent
from .frontend import Channelizer


@dataclasses.dataclass(eq=False)
class WidebandReceiver:
    """Wideband samples in -> frame events out, bulk data on the device."""
    sample_rate: int
    centerfreq: int
    frequencies: list[int]          # Hz
    device: torch.device
    block_len: int = 5400           # 5400-sps samples per demod block
    # format of the raw stream (what the superstep converts on the device)
    sample_format: str = 'CF32'

    def __post_init__(self):
        if self.block_len % C.SPS:
            raise ValueError(f'demod block of {self.block_len} samples is '
                             f'not a whole number of symbols ({C.SPS} '
                             'samples each)')
        self.bank = ChannelBank(len(self.frequencies), self.device)
        self.channelizer = Channelizer(self.sample_rate, self.centerfreq,
                                       self.frequencies, self.device,
                                       out_chunk=self.block_len,
                                       rows=self.bank._c)
        self.sample_clock = 0       # wideband samples consumed
        self.fused = self.channelizer.fused_ready
        # the superstep engages when the geometry aligns and the caller's
        # block length asks for throughput (>= the aligned block); shorter
        # blocks keep the lower-latency fused path
        self.superstep = None
        if self.fused and os.environ.get('DUMPHFDL_NO_SUPERSTEP') != '1':
            from .superstep import SuperstepEngine, plan_superstep
            plan = plan_superstep(self.channelizer)
            if plan is not None and self.block_len >= plan.out_chunk:
                self.superstep = SuperstepEngine(
                    self.channelizer, self.bank,
                    input_kind=self.sample_format)

    @property
    def raw_chunk_bytes(self) -> int | None:
        """Raw bytes per super-block when the superstep is engaged (the
        ingest chunker delivers exactly this much, silence-padding the
        last chunk), else None."""
        return None if self.superstep is None \
            else self.superstep.raw_chunk_bytes

    @property
    def file_chunk_samples(self) -> int:
        """Wideband samples per process() call on the file path: n whole
        overlap-save frames, n the largest power of two whose frames fit in
        the wideband span of one demod block (block_len * sample_rate /
        5400 samples), at least 1 and at most the channelizer's batch cap.
        The wideband ring starts holding exactly the overlap, so every such
        call channelizes one batch of n frames."""
        chz = self.channelizer
        step = chz.geo.input_size
        n = 1
        while (2 * n <= chz._max_frames and 2 * n * step * C.INTERNAL_RATE
               <= self.block_len * self.sample_rate):
            n *= 2
        return n * step

    @property
    def engine(self):
        """The superstep engine while this receiver runs on it: engaged,
        and no --datadumps wanted (dumps take the unfused path from the
        first sample to the end of the flush, so that frames in flight at
        the end of the input complete and are dumped)."""
        return self.superstep if self.bank.dumps is None else None

    def process_packed(self, packed: torch.Tensor) -> list[FrameEvent]:
        """Superstep path: one uploaded raw chunk (SuperstepEngine.upload)
        in, the previous super-block's events out.  The call is the span
        'rx.step' (utils/profiling), with the stream samples it takes."""
        n = self.superstep.plan.wb_chunk
        sp = profiling.begin('rx.step', self.bank.blocks, n)
        self.sample_clock += n
        events = self.superstep.process_packed(packed)
        profiling.end(sp)
        return events

    def process(self, wideband) -> list[FrameEvent]:
        """Feed wideband complex samples; returns completed frames.  The
        call is the span 'rx.step' (utils/profiling), with the stream
        samples it takes; the channelizer's part of it is an 'rx.launch',
        with the overlap-save frames it channelized."""
        sp = profiling.begin('rx.step', self.bank.blocks, len(wideband))
        self.sample_clock += len(wideband)
        events: list[FrameEvent] = []
        chz = self.channelizer
        frames = chz.ddc_frames_run
        if self.fused and self.bank.dumps is None:
            launch = profiling.begin('rx.launch', self.bank.blocks)
            chz.ingest(wideband)
            chz.channelize_available()
            profiling.end(launch, chz.ddc_frames_run - frames)
            while chz.chunk_ready():
                events.extend(self.bank.process_fused(chz))
        else:
            launch = profiling.begin('rx.launch', self.bank.blocks)
            chunks = chz.process_device(wideband)
            profiling.end(launch, chz.ddc_frames_run - frames)
            for chunk in chunks:
                events.extend(self.bank.process(chunk))
        profiling.end(sp)
        return events

    def flush(self) -> list[FrameEvent]:
        """Drain buffered samples (silence covers a full double-slot frame
        plus channelizer/resampler latency so in-flight frames complete)."""
        chz = self.channelizer
        pad_wb = int((C.DOUBLE_SLOT_FRAME_LEN + 200) * C.SPS
                     * self.sample_rate / C.INTERNAL_RATE) \
            + 4 * chz.geo.fft_size
        events: list[FrameEvent] = []
        ss = self.engine
        if ss is not None:
            from ..io.formats import silence_byte
            zero = ss.upload(np.full(ss.raw_chunk_bytes,
                                     silence_byte(ss.input_kind), np.uint8))
            # +1 block for the superstep's one-block resampler delay
            for _ in range(-(-pad_wb // ss.plan.wb_chunk) + 1):
                events.extend(self.process_packed(zero))
            events.extend(self.bank.drain_events())
            return events
        step = min(self.sample_rate,
                   chz._rw - chz.geo.overlap_length - chz.geo.input_size)
        pad = torch.zeros(step, dtype=torch.complex64, device=self.device)
        for _ in range(-(-pad_wb // step)):
            events.extend(self.process(pad))
        events.extend(self.bank.drain_events())
        return events


@dataclasses.dataclass
class NarrowbandReceiver:
    """Single-stream receiver for input already at 5400 sps (one channel)."""
    device: torch.device
    block_len: int = 5400

    def __post_init__(self):
        self.bank = ChannelBank(1, self.device)
        self._buf = np.zeros(0, dtype=np.complex64)

    def process(self, samples: np.ndarray) -> list[FrameEvent]:
        self._buf = np.concatenate([self._buf,
                                    np.asarray(samples, np.complex64)])
        events: list[FrameEvent] = []
        while len(self._buf) >= self.block_len:
            block = self._buf[None, :self.block_len]
            self._buf = self._buf[self.block_len:]
            events.extend(self.bank.process(block))
        return events

    def flush(self) -> list[FrameEvent]:
        pad = np.zeros((C.DOUBLE_SLOT_FRAME_LEN + 200) * C.SPS, np.complex64)
        return self.process(pad) + self.bank.drain_events()
