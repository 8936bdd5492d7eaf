"""Application orchestration: input -> receiver -> protocol -> outputs.

Counterpart of ``dumphfdl_tpu/app.py`` for the offline file path
(``run_file``); the protocol stack, formatters and outputs are the JAX
package's host modules, which import no jax.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time as time_mod

import torch

from . import constants as C
from .io.outputs import OutputManager
from .ops.crc import pdu_hdr_len
from .protocol.pdu import PduMetadata, parse_pdu
from .protocol.runtime import ProtocolContext
from .dsp.channel import FrameEvent
from .dsp.receiver import WidebandReceiver


def level_to_db(level: float) -> float:
    return 20.0 * math.log10(max(level, 1e-12))


@dataclasses.dataclass
class AppConfig:
    frequencies: list[int]              # Hz
    sample_rate: int
    device: torch.device = None         # required: no default device
    centerfreq: int | None = None       # Hz; None -> auto midpoint
    freq_offset: int = 0                # --freq-offset
    read_buffer_size: int = 320_000     # bytes (input-file.c:15)
    sample_format: str = 'CF32'
    output_queue_hwm: int = 1000
    nf_stats_interval: int = 10
    mesh: str | None = None             # multi-device mesh: not ported
    # demod block length in 5400-sps samples (<= 16200)
    demod_block_len: int = 5400


def compute_centerfreq(frequencies: list[int], sample_rate: int,
                       centerfreq: int | None) -> int:
    """main.c:214-239: auto centerfreq = midpoint; span check."""
    fmin, fmax = min(frequencies), max(frequencies)
    if fmax - fmin > sample_rate:
        raise ValueError(
            f'channel span {fmax - fmin} Hz exceeds sample rate {sample_rate}')
    if centerfreq is None:
        centerfreq = (fmin + fmax) // 2
    return centerfreq


class HfdlApp:
    def __init__(self, cfg: AppConfig, ctx: ProtocolContext,
                 outputs: OutputManager, statsd=None):
        if cfg.device is None:
            raise ValueError('AppConfig.device is required')
        if cfg.mesh:
            raise NotImplementedError('--mesh is not yet ported to '
                                      'dumphfdl_tpu_torch')
        self.cfg = cfg
        self.ctx = ctx
        self.outputs = outputs
        self.statsd = statsd
        centerfreq = compute_centerfreq(cfg.frequencies, cfg.sample_rate,
                                        cfg.centerfreq)
        self.centerfreq = centerfreq + cfg.freq_offset
        self.receiver = WidebandReceiver(cfg.sample_rate, self.centerfreq,
                                         list(cfg.frequencies), cfg.device,
                                         block_len=cfg.demod_block_len)
        self.stream_epoch = time_mod.time()
        self.frames_decoded = 0     # FCS-valid frames parsed
        self.frames_junk = 0        # FCS-fail frames (false locks/errors)
        self._stop = threading.Event()
        self._nf_thread = None

    # -- frame handling --

    def _metadata_for(self, ev: FrameEvent) -> PduMetadata:
        p = C.MODES[ev.mode]
        ts = self.stream_epoch + max(ev.start_symbol, 0) / C.SYMBOL_RATE
        return PduMetadata(
            freq=self.cfg.frequencies[ev.channel],
            freq_err_hz=ev.freq_err_hz,
            rssi=level_to_db(ev.rssi),
            noise_floor=level_to_db(ev.noise_floor),
            bit_rate=p.bit_rate,
            slot=p.slot,
            rx_timestamp=ts,
        )

    def publish_demod_counters(self) -> None:
        """Push per-channel preamble counters to StatsD (statsd.c:17-49),
        one packet per non-zero counter and channel."""
        if self.statsd is None:
            return
        counters = self.receiver.bank.last_counters
        if counters is None:
            return
        c = counters.cpu().numpy()
        names = ('demod.preamble.A2_found', 'demod.preamble.M1_found',
                 'demod.preamble.errors.M1_not_found',
                 'demod.errors.event_table_overflow')
        for i, freq in enumerate(self.cfg.frequencies):
            for j, name in enumerate(names):
                if c[i, j]:
                    self.statsd.increment(f'channels.{freq}.{name}',
                                          int(c[i, j]))

    def handle_events(self, events: list[FrameEvent]) -> None:
        self.publish_demod_counters()
        for ev in events:
            if ev.pdu is None:
                continue
            meta = self._metadata_for(ev)
            if not ev.fcs_ok:
                # junk frame (noise false-lock / uncorrected errors): count
                # it without deep parsing unless corrupted PDUs are wanted
                self.frames_junk += 1
                if self.ctx.options.output_corrupted_pdus:
                    trees = parse_pdu(ev.pdu, meta, self.ctx)
                    if trees:
                        self.outputs.dispatch(meta, trees)
                else:
                    self._count_junk(ev.pdu, meta)
                continue
            trees = parse_pdu(ev.pdu, meta, self.ctx)
            self.frames_decoded += 1
            if trees:
                self.outputs.dispatch(meta, trees)

    def _count_junk(self, pdu: bytes, meta: PduMetadata) -> None:
        """StatsD parity for skipped junk frames (frames.processed plus
        too_short/bad_fcs, mpdu.c:56-89 / spdu.c:40)."""
        statsd = self.ctx.statsd
        statsd.increment_per_channel(meta.freq, 'frames.processed')
        if pdu_hdr_len(pdu) is None:
            statsd.increment_per_channel(meta.freq, 'frame.errors.too_short')
        else:
            statsd.increment_per_channel(meta.freq, 'frame.errors.bad_fcs')

    # -- main loop --

    def run_file(self, path: str, sample_format: str | None = None) -> int:
        """Offline decode of a raw I/Q file ('-' = stdin, input-file.c).
        A background thread reads, converts and uploads one chunk ahead
        of the device work (io/ingest.py)."""
        from .io import ingest
        fmt = (sample_format or self.cfg.sample_format).upper()
        fh = sys.stdin.buffer if path == '-' else open(path, 'rb')
        self._start_nf_stats()
        try:
            raw_iter = ingest.file_chunks(fh, fmt, self.cfg.read_buffer_size,
                                          stop=self._stop)
            for xd in ingest.uploaded_stream(raw_iter, fmt, self.cfg.device):
                if self._stop.is_set():
                    break
                self.handle_events(self.receiver.process(xd))
            self.handle_events(self.receiver.flush())
        finally:
            if path != '-':
                fh.close()
            self._stop.set()
        return 0

    def stop(self) -> None:
        self._stop.set()

    def shutdown(self) -> None:
        self.outputs.shutdown()

    # -- noise floor stats thread (hfdl.c:1082-1105) --

    def _start_nf_stats(self) -> None:
        if self.statsd is None or self.cfg.nf_stats_interval <= 0:
            return

        def loop():
            while not self._stop.wait(self.cfg.nf_stats_interval):
                nf = self.receiver.bank.tracker_state.noise_floor.cpu().numpy()
                for i, freq in enumerate(self.cfg.frequencies):
                    db = level_to_db(float(nf[i]))
                    if db <= 0.0:
                        # gauges are non-negative ints: tenths of -dBFS
                        self.statsd.set_per_channel(
                            freq, 'noise_floor', round(abs(db) * 10))

        self._nf_thread = threading.Thread(target=loop, daemon=True,
                                           name='nf-stats')
        self._nf_thread.start()
