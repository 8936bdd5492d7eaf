"""Application orchestration: input -> receiver -> protocol -> outputs.

Counterpart of ``dumphfdl_tpu/app.py``: the offline file path
(``run_file``) and the live paths (``run_stream`` for complex chunks,
``run_stream_raw`` for buffers in the SDR's native width), each through
the superstep when the receiver engaged it, or, with a mesh configured,
through the sharded receiver (parallel/sharding.py), which takes host
chunks and uploads each shard's span itself.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time as time_mod

import numpy as np
import torch

from . import constants as C
from .io.outputs import OutputManager
from .ops.crc import pdu_hdr_len
from .protocol.pdu import PduMetadata, parse_pdu
from .protocol.runtime import ProtocolContext
from .dsp.channel import FrameEvent
from .dsp.receiver import WidebandReceiver
from .utils import profiling


def level_to_db(level: float) -> float:
    return 20.0 * math.log10(max(level, 1e-12))


@dataclasses.dataclass
class AppConfig:
    frequencies: list[int]              # Hz
    sample_rate: int
    device: torch.device = None         # required: no default device
    centerfreq: int | None = None       # Hz; None -> auto midpoint
    freq_offset: int = 0                # --freq-offset
    read_buffer_size: int = 320_000     # mesh file reads (input-file.c:15)
    sample_format: str = 'CF32'
    output_queue_hwm: int = 1000
    nf_stats_interval: int = 10
    # multi-device mesh: 'TIMExCHAN' takes cuda:0 .. cuda:(T*K-1), or in a
    # multi-process job one shard per process; a parallel.sharding.
    # DeviceMesh is used as it is (tests, chip_smoke.py)
    mesh: object = None
    # demod block length in 5400-sps samples (<= 16200): longer blocks
    # amortize the per-block dispatch at the cost of event latency
    demod_block_len: int = 5400
    # live-stream ingest chunk (wideband samples per upload); None = about
    # fs/8 (~0.2 s, low latency)
    stream_chunk_samples: int | None = None


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


def _mesh_for(mesh, device):
    """cfg.mesh -> a DeviceMesh.  A 'TIMExCHAN' string takes T*K shards: in
    one process the first T*K CUDA devices, in a multi-process job the
    first T*K of the job's shards, one per process on its own device
    (multihost.global_shards, the JAX package's global jax.devices()); it
    raises when there are fewer (no smaller mesh, no CPU, no device named
    twice).  A DeviceMesh is taken as it is."""
    from .parallel import multihost
    from .parallel.sharding import DeviceMesh, parse_mesh
    if isinstance(mesh, DeviceMesh):
        return mesh
    t_ax, k_ax = parse_mesh(mesh)
    if multihost.process_count() > 1:
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        shards = multihost.global_shards([device])
    else:
        shards = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
    if t_ax * k_ax > len(shards):
        raise ValueError(f'mesh {mesh} needs {t_ax * k_ax} devices, '
                         f'have {len(shards)}')
    return DeviceMesh([shards[t * k_ax:(t + 1) * k_ax] for t in range(t_ax)])


class HfdlApp:
    def __init__(self, cfg: AppConfig, ctx: ProtocolContext,
                 outputs: OutputManager, statsd=None):
        if cfg.device is None:
            raise ValueError('AppConfig.device is required')
        self.cfg = cfg
        self.ctx = ctx
        self.outputs = outputs
        self.statsd = statsd
        centerfreq = compute_centerfreq(cfg.frequencies, cfg.sample_rate,
                                        cfg.centerfreq)
        self.centerfreq = centerfreq + cfg.freq_offset
        if cfg.mesh:
            # decode on a ('time', 'chan') mesh: the frontend shards over
            # time with a halo copy, the demodulator's channels over all
            # shards
            from .parallel.sharding import ShardedWidebandReceiver
            self.receiver = ShardedWidebandReceiver(
                cfg.sample_rate, self.centerfreq, list(cfg.frequencies),
                _mesh_for(cfg.mesh, cfg.device),
                block_len=cfg.demod_block_len)
        else:
            self.receiver = WidebandReceiver(
                cfg.sample_rate, self.centerfreq, list(cfg.frequencies),
                cfg.device, block_len=cfg.demod_block_len,
                sample_format=cfg.sample_format)
        self.stream_epoch = time_mod.time()
        self.frames_decoded = 0     # FCS-valid frames parsed
        self.frames_junk = 0        # FCS-fail frames (false locks/errors)
        self.last_ingest_overruns = 0   # samples a live run dropped
        self._stop = threading.Event()
        self._nf_thread = None

    # -- frame handling --

    def _metadata_for(self, ev: FrameEvent) -> PduMetadata:
        p = C.MODES[ev.mode]
        # the superstep's one-block resampler delay shifts the tracker's
        # symbol clock relative to the stream epoch
        ss = self.receiver.engine
        off = ss.delay_symbols if ss is not None else 0
        ts = self.stream_epoch + max(ev.start_symbol - off, 0) / C.SYMBOL_RATE
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
        """Parse and output the decoded frames.  Each frame's parse and
        output are the spans 'app.parse' and 'app.output'
        (utils/profiling), with the block whose table held it."""
        self.publish_demod_counters()
        block = getattr(self.receiver.bank, 'collected_block', -1) \
            if profiling.recording() else -1
        for ev in events:
            if ev.pdu is None:
                continue
            meta = self._metadata_for(ev)
            if not ev.fcs_ok:
                # junk frame (noise false-lock / uncorrected errors): count
                # it without deep parsing unless corrupted PDUs are wanted
                self.frames_junk += 1
                if self.ctx.options.output_corrupted_pdus:
                    self._parse_and_output(ev, meta, block)
                else:
                    self._count_junk(ev.pdu, meta)
                continue
            self._parse_and_output(ev, meta, block)
            self.frames_decoded += 1

    def _parse_and_output(self, ev: FrameEvent, meta: PduMetadata,
                          block: int) -> None:
        sp = profiling.begin('app.parse', block, 1)
        trees = parse_pdu(ev.pdu, meta, self.ctx)
        profiling.end(sp)
        if trees:
            sp = profiling.begin('app.output', block, 1)
            self.outputs.dispatch(meta, trees)
            profiling.end(sp)

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
        A background thread reads and uploads ahead of the device work
        (io/ingest.py); the integer formats upload in their native width
        and convert on the device.  The chunk each branch reads: on the
        superstep one super-block (the receiver's raw_chunk_bytes); on a
        mesh cfg.read_buffer_size (the sharded receiver cuts its own
        super-blocks); otherwise the receiver's file_chunk_samples, whole
        overlap-save frames, so that each receiver call channelizes one
        batch of them."""
        from .io import formats, ingest
        fmt = (sample_format or self.cfg.sample_format).upper()
        fh = sys.stdin.buffer if path == '-' else open(path, 'rb')
        self._start_nf_stats()
        try:
            if self._superstep_for(fmt) is not None:
                # one graph replay per super-block: fixed-size raw chunks,
                # native-width upload, conversion inside the step
                raw_iter = ingest.file_chunks(
                    fh, fmt, self.receiver.raw_chunk_bytes,
                    stop=self._stop, pad_final=True)
                for pk in ingest.superstep_stream(self.receiver, raw_iter):
                    if self._stop.is_set():
                        break
                    self.handle_events(self.receiver.process_packed(pk))
                self.handle_events(self.receiver.flush())
                return 0
            if self.cfg.mesh:
                # host chunks: the sharded receiver cuts each super-block
                # into its shards' spans, so samples go up once, sharded
                raw_iter = ingest.file_chunks(
                    fh, fmt, self.cfg.read_buffer_size, stop=self._stop)
                stream = (formats.convert(raw, fmt) for raw in raw_iter)
            else:
                raw_iter = ingest.file_chunks(
                    fh, fmt, self.receiver.file_chunk_samples
                    * formats.bytes_per_sample(fmt), stop=self._stop)
                stream = ingest.uploaded_stream(raw_iter, fmt,
                                                self.cfg.device)
            for xd in stream:
                if self._stop.is_set():
                    break
                self.handle_events(self.receiver.process(xd))
            self.handle_events(self.receiver.flush())
        finally:
            if path != '-':
                fh.close()
            self._stop.set()
        return 0

    def _superstep_for(self, *formats: str):
        """The receiver's superstep engine when it is engaged for one of
        these input formats and no dumps are wanted, else None."""
        ss = self.receiver.engine
        return ss if ss is not None and ss.input_kind in formats else None

    def _refuse_live_on_multiprocess_mesh(self) -> None:
        """A mesh across processes steps every rank on the same samples
        (ShardedFrontend.step); a live source differs between ranks, and
        each rank's ingest ring drops samples at its own moments, so the
        copies between ranks would splice different streams.  run_file is
        not refused: every rank reads the same file in the same chunks."""
        if self.cfg.mesh and self.receiver.mesh.multiprocess:
            raise ValueError('live input is not available on a mesh across '
                             'processes: every rank must step on the same '
                             'samples')

    def _report_overruns(self, dropped: int) -> None:
        print(f'input: ring overrun, {dropped} samples dropped',
              file=sys.stderr)
        if self.statsd is not None:
            self.statsd.increment('input.overruns', dropped)

    def run_stream(self, sample_iter, packed: bool = False) -> int:
        """Decode an iterator of complex64 chunks (live sources).

        A reader thread drains the source into the lock-free SampleRing,
        fixed blocks are uploaded one step ahead of the device work, and
        ring overruns are counted like the reference's
        complex_samples_produce (input-helpers.c:80-92).  packed=True
        uploads at CS16 precision (half the bytes; for SDR sources whose
        native format is integer anyway).  Refused on a mesh across
        processes (_refuse_live_on_multiprocess_mesh)."""
        from .io import formats, ingest
        self._refuse_live_on_multiprocess_mesh()
        self._start_nf_stats()
        ss = self._superstep_for('CF32', 'CS16')
        if ss is not None:
            block = ss.plan.wb_chunk    # the super-block cadence
        else:
            block = self.cfg.stream_chunk_samples or max(
                32768, 1 << int(math.ceil(math.log2(
                    max(self.cfg.sample_rate // 8, 1)))))
        src = ingest.StreamIngest(sample_iter, block,
                                  ring_capacity=4 * block, stop=self._stop)
        if self.cfg.mesh:
            stream = src.blocks()       # the sharded receiver uploads
            step = self.receiver.process
        elif ss is None:
            stream = ingest.uploaded_stream(src.blocks(), 'CF32',
                                            self.cfg.device, packed=packed)
            step = self.receiver.process
        else:
            if ss.input_kind == 'CS16':
                # quantize to CS16 on the ingest thread: half the bytes
                raw_iter = (np.frombuffer(formats.serialize(b, 'CS16'),
                                          np.uint8) for b in src.blocks())
            else:
                raw_iter = (b.view(np.uint8) for b in src.blocks())
            stream = ingest.superstep_stream(self.receiver, raw_iter)
            step = self.receiver.process_packed
        last_over = 0
        try:
            for xd in stream:
                if self._stop.is_set():
                    break
                self.handle_events(step(xd))
                over = src.overruns
                if over != last_over:
                    self._report_overruns(over - last_over)
                    last_over = over
        finally:
            self.last_ingest_overruns = src.overruns
            src.stop()
            self._stop.set()
        return 0

    def run_stream_raw(self, raw_iter, sample_format: str | None = None
                       ) -> int:
        """Decode an iterator of raw sample buffers in the SDR's native
        width (bytes / uint8 arrays; CS16 = 4 bytes per sample).

        The high-rate live path: no float conversion on the host.  Raw
        bytes ride the SampleRing in 8-byte slots (viewed as complex64 for
        storage only), are re-chunked to the superstep cadence, and
        convert on the device inside the step.  Without a superstep for
        this format the buffers are converted on the host and take
        run_stream.  Refused on a mesh across processes, as run_stream."""
        from .io import formats, ingest
        self._refuse_live_on_multiprocess_mesh()
        fmt = (sample_format or self.cfg.sample_format).upper()
        if self._superstep_for(fmt) is None:
            return self.run_stream(
                formats.convert(raw, fmt) for raw in raw_iter)
        self._start_nf_stats()
        chunk_bytes = self.receiver.raw_chunk_bytes
        assert chunk_bytes % 8 == 0
        slots = chunk_bytes // 8          # 8-byte ring slots
        bps = formats.bytes_per_sample(fmt)

        def as_slots(raw):
            b = np.frombuffer(raw, np.uint8) if isinstance(
                raw, (bytes, bytearray, memoryview)) else \
                np.asarray(raw, np.uint8)
            return b[:len(b) - len(b) % 8].view(np.complex64)

        src = ingest.StreamIngest((as_slots(r) for r in raw_iter), slots,
                                  ring_capacity=4 * slots, stop=self._stop)
        stream = ingest.superstep_stream(
            self.receiver, (b.view(np.uint8) for b in src.blocks()))
        last_over = 0
        try:
            for pk in stream:
                if self._stop.is_set():
                    break
                self.handle_events(self.receiver.process_packed(pk))
                over = src.overruns
                if over != last_over:
                    self._report_overruns((over - last_over) * 8 // bps)
                    last_over = over
        finally:
            self.last_ingest_overruns = src.overruns * 8 // bps
            src.stop()
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
