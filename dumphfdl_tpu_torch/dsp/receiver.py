"""Wideband receiver: glue from raw wideband samples to decoded frames.

Counterpart of ``dumphfdl_tpu/dsp/receiver.py``: a Channelizer
(frontend.py) feeding one batched ChannelBank (channel.py) through the
resample-fused demod step.  The superstep engine and the unfused
channelize-then-resample path of the JAX package are not ported; a
geometry the fused step cannot take raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
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

    def __post_init__(self):
        self.bank = ChannelBank(len(self.frequencies), self.device)
        self.channelizer = Channelizer(self.sample_rate, self.centerfreq,
                                       self.frequencies, self.device,
                                       out_chunk=self.block_len,
                                       rows=self.bank._c)
        if not (self.channelizer.fused_ready and self.block_len % C.SPS == 0):
            step = C.SPS * self.channelizer._rs_den \
                // np.gcd(C.SPS, self.channelizer._rs_den)
            raise ValueError(
                f'demod block of {self.block_len} samples cannot run the '
                f'fused resample step at {self.sample_rate} sps (it needs a '
                f'multiple of {step}, e.g. {self.block_len // step * step}); '
                'the unfused path is not ported')

    def process(self, wideband) -> list[FrameEvent]:
        """Feed wideband complex samples; returns completed frames."""
        events: list[FrameEvent] = []
        self.channelizer.ingest(wideband)
        self.channelizer.channelize_available()
        while self.channelizer.chunk_ready():
            events.extend(self.bank.process_fused(self.channelizer))
        return events

    def flush(self) -> list[FrameEvent]:
        """Drain buffered samples (silence covers a full double-slot frame
        plus channelizer/resampler latency so in-flight frames complete)."""
        chz = self.channelizer
        pad_wb = int((C.DOUBLE_SLOT_FRAME_LEN + 200) * C.SPS
                     * self.sample_rate / C.INTERNAL_RATE) \
            + 4 * chz.geo.fft_size
        step = min(self.sample_rate,
                   chz._rw - chz.geo.overlap_length - chz.geo.input_size)
        pad = torch.zeros(step, dtype=torch.complex64, device=self.device)
        events: list[FrameEvent] = []
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
