"""Command-line interface of the PyTorch port.

Same flag surface as ``dumphfdl_tpu/cli.py`` (which mirrors the reference
decoder, main.c:378-425).  The decoder runs on the CUDA device and refuses
to start without one; --mesh TIMExCHAN decodes on the first TIME*CHAN CUDA
devices (parallel/sharding.py) and refuses to start with fewer; --profile
DIR records a torch.profiler trace of the run.  With DUMPHFDL_COORDINATOR,
DUMPHFDL_NUM_PROCESSES and DUMPHFDL_PROCESS_ID set, each process decodes its
slice of the channel list (parallel/multihost.py), or, with --mesh, is one
shard of a mesh across the processes (one card each, nccl), every process
fed the same stream and emitting the whole decode.

    python -m dumphfdl_tpu_torch.cli --iq-file CAPTURE --sample-format CS16 \
        --sample-rate 48000 --centerfreq 8930 8912 8942

The sample rate and --demod-block choose the path (dsp/receiver.py): the
superstep (one CUDA graph per block) where the rate aligns and the block is
at least the aligned one, else the fused step where the block is a whole
number of resampler cosets, else the unfused path.
"""

from __future__ import annotations

import argparse
import signal
import sys

import torch

from .io.outputs import OutputManager, OutputSpec, parse_kvargs
from .protocol.enrichment import AcCache, AcData, SysTable
from .protocol.runtime import ProtocolContext, ProtocolOptions
from .utils.statsd import StatsdClient
from . import __version__
from .app import AppConfig, HfdlApp
from .device import require_cuda


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='dumphfdl-tpu-torch',
        description='Multichannel HFDL decoder (PyTorch + CUDA)',
    )
    p.add_argument('--version', action='version',
                   version=f'dumphfdl-tpu-torch {__version__}')
    src = p.add_argument_group('input options')
    src.add_argument('--iq-file', metavar='FILE',
                     help="read I/Q samples from file ('-' = stdin)")
    src.add_argument('--soapysdr', metavar='DEVICE',
                     help='use a SoapySDR device (e.g. driver=rtlsdr)')
    src.add_argument('--sample-format', choices=['CU8', 'CS16', 'CF32'],
                     type=str.upper, help='input sample format')
    src.add_argument('--sample-rate', type=int, help='sampling rate in Hz')
    src.add_argument('--centerfreq', type=float, default=None,
                     help='center frequency in kHz (default: auto)')
    src.add_argument('--freq-offset', type=float, default=0.0,
                     help='frequency offset in kHz (e.g. upconverters)')
    src.add_argument('--gain', type=float, default=None,
                     help='overall end-to-end gain in dB (SoapySDR)')
    src.add_argument('--gain-elements', metavar='K1=V1,...',
                     help='per-element gains (SoapySDR)')
    src.add_argument('--freq-correction', type=float, default=0.0,
                     help='frequency correction in ppm (SoapySDR)')
    src.add_argument('--antenna', help='antenna port name (SoapySDR)')
    src.add_argument('--device-settings', metavar='K1=V1,...',
                     help='device-specific settings (SoapySDR)')
    src.add_argument('--read-buffer-size', type=int, default=320_000,
                     help='file input buffer size in bytes, on a --mesh '
                          '(a single device reads whole channelizer frames '
                          'or super-blocks)')
    src.add_argument('--fft-threads', type=int, default=4,
                     help='accepted for compatibility (cuFFT manages threads)')
    src.add_argument('--demod-block', type=int, default=5400,
                     metavar='SAMPLES',
                     help='demod block length in 5400-sps samples, a '
                          'multiple of 3 (max 16200): larger blocks '
                          'amortize per-block dispatch at the cost of '
                          'event latency, and engage the superstep where '
                          'the sample rate aligns')
    src.add_argument('--mesh', metavar='TIMExCHAN', default=None,
                     help="decode on a ('time', 'chan') mesh of the first "
                          'TIME*CHAN CUDA devices, e.g. 2x2 (in a '
                          'multi-process job: of the processes, one card '
                          'each): the frontend shards over time, the '
                          'demodulator over channels')

    out = p.add_argument_group('output options')
    out.add_argument('--output', action='append', default=[],
                     metavar='SPEC', help='output spec: what:format:type:params')
    out.add_argument('--output-queue-hwm', type=int, default=1000,
                     help='output queue high-water mark (0 = unlimited)')
    out.add_argument('--utc', action='store_true',
                     help='timestamps in UTC')
    out.add_argument('--milliseconds', action='store_true',
                     help='millisecond timestamp resolution')
    out.add_argument('--raw-frames', action='store_true',
                     help='include raw frame hexdumps')
    out.add_argument('--output-mpdus', action='store_true',
                     help='emit MPDU-level log entries')
    out.add_argument('--output-corrupted-pdus', action='store_true',
                     help='emit PDUs that failed CRC checks')
    out.add_argument('--freq-as-squawk', action='store_true',
                     help='put channel freq (kHz) into basestation squawk')
    out.add_argument('--station-id', help='station id added to output metadata')
    out.add_argument('--prettify-json', action='store_true',
                     help='pretty-print JSON output')
    out.add_argument('--prettify-xml', action='store_true',
                     help='pretty-print XML payloads in ACARS and MIAM '
                          'CORE PDUs (main.c:305)')

    enr = p.add_argument_group('enrichment options')
    enr.add_argument('--system-table', metavar='FILE',
                     help='ground station table (libconfig format)')
    enr.add_argument('--system-table-save', metavar='FILE',
                     help='save OTA system table updates here')
    enr.add_argument('--aircraft-cache-ttl', type=int, default=3600,
                     help='aircraft cache TTL in seconds')
    enr.add_argument('--bs-db', metavar='FILE',
                     help='basestation SQLite aircraft database')
    enr.add_argument('--ac-details', choices=['normal', 'verbose'],
                     default='normal', help='aircraft info detail level')

    obs = p.add_argument_group('observability')
    obs.add_argument('--statsd', metavar='HOST:PORT',
                     help='send statistics to a StatsD server')
    obs.add_argument('--noise-floor-stats-interval', type=int, default=0,
                     help='noise floor gauge reporting interval (seconds)')
    obs.add_argument('--debug', metavar='CLASS1,CLASS2,...', default='',
                     help='enable debug logging classes (sdr,dsp,frame,'
                          'proto,stats,cache,output,misc,all)')
    obs.add_argument('--datadumps', action='store_true',
                     help='dump per-stage DSP signals to raw files in the '
                          'current directory (takes the unfused path)')
    obs.add_argument('--profile', metavar='DIR',
                     help='record a torch.profiler trace of the run (host '
                          'operations, the decoder\'s own spans and the '
                          'card\'s kernels) as a Chrome trace in DIR (the '
                          'gperftools -DPROFILING bracket of the reference, '
                          'main.c:766-768)')

    p.add_argument('frequencies', nargs='*', type=float, metavar='FREQ',
                   help='HFDL channel frequencies in kHz')
    return p


def build_app(args, device: torch.device) -> HfdlApp:
    if not args.frequencies:
        raise SystemExit('error: no channel frequencies given')
    if not args.sample_rate:
        raise SystemExit('error: --sample-rate is required')
    freqs_hz = [int(round(f * 1000)) for f in args.frequencies]

    # multi-host deployment (DUMPHFDL_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID):
    # without --mesh each host ingests and demodulates its contiguous slice
    # of the channel list and runs its own output stack (the counterpart of
    # the reference's N instances plus ZMQ aggregator, README.md:969); with
    # --mesh every host is fed the whole band and the mesh spans the hosts
    # (one shard each), so nothing is sliced
    from .parallel import multihost
    multi = multihost.init_distributed(device=device)
    if multi and args.mesh and args.soapysdr is not None:
        # a mesh across processes steps every rank on the same samples
        # (ShardedFrontend.step), but each rank would open its own SDR, and
        # each rank's ingest ring drops samples at its own moments: the halo
        # and reshard copies would splice different streams together
        raise SystemExit('error: --soapysdr cannot feed --mesh in a '
                         'multi-process job (every rank of the mesh must '
                         'step on the same samples); use --iq-file, which '
                         'every rank reads alike')
    if multi and not args.mesh:
        sl = multihost.local_channel_slice(len(freqs_hz))
        print(f'multi-host: process {multihost.process_index()}/'
              f'{multihost.process_count()}, channels [{sl.start}:{sl.stop}] '
              f'of {len(freqs_hz)}', file=sys.stderr)
        freqs_hz = freqs_hz[sl]
        if not freqs_hz:
            raise SystemExit('error: no channels assigned to this host')

    options = ProtocolOptions(
        output_raw_frames=args.raw_frames,
        output_mpdus=args.output_mpdus,
        output_corrupted_pdus=args.output_corrupted_pdus,
        utc=args.utc,
        milliseconds=args.milliseconds,
        freq_as_squawk=args.freq_as_squawk,
        ac_data_details=args.ac_details,
        station_id=args.station_id,
        prettify_json=args.prettify_json,
        prettify_xml=args.prettify_xml,
    )
    systable = SysTable(args.system_table, save_path=args.system_table_save)
    ac_cache = AcCache(ttl=args.aircraft_cache_ttl)
    ac_data = None
    if args.bs_db:
        try:
            ac_data = AcData(args.bs_db)
        except Exception as e:
            print(f'bs-db: cannot open {args.bs_db}: {e}', file=sys.stderr)
    statsd = None
    if args.statsd:
        statsd = StatsdClient(args.statsd, args.station_id)
        statsd.initialize_counters(freqs_hz)
    ctx = ProtocolContext(systable=systable, ac_cache=ac_cache,
                          ac_data=ac_data, options=options)
    if statsd is not None:
        ctx.statsd = statsd

    # HWM disabled for file input -> lossless offline decode (main.c:452)
    hwm = 0 if args.iq_file else args.output_queue_hwm
    outputs = OutputManager(ctx, hwm=hwm)
    for spec in args.output or ['decoded:text:file:path=-']:
        outputs.add_output(OutputSpec.parse(spec))

    cfg = AppConfig(
        frequencies=freqs_hz,
        sample_rate=args.sample_rate,
        device=device,
        centerfreq=int(round(args.centerfreq * 1000)) if args.centerfreq else None,
        freq_offset=int(round(args.freq_offset * 1000)),
        read_buffer_size=args.read_buffer_size,
        sample_format=args.sample_format or 'CF32',
        output_queue_hwm=hwm,
        nf_stats_interval=args.noise_floor_stats_interval,
        mesh=args.mesh,
        demod_block_len=args.demod_block,
    )
    app = HfdlApp(cfg, ctx, outputs, statsd=statsd)
    if multi and args.mesh:
        mesh = app.receiver.mesh
        print(f'multi-host: process {multihost.process_index()}/'
              f'{multihost.process_count()}, mesh {mesh.shape["time"]}x'
              f'{mesh.shape["chan"]}, shards '
              f'{[mesh.index(s) for s in mesh.local_shards]}',
              file=sys.stderr)
    if args.debug:
        from .utils import debug
        debug.set_classes(args.debug)
    if args.datadumps:
        from .dsp.dumpfile import DumpSet
        app.receiver.bank.dumps = DumpSet()
    return app


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the decoder; device defaults to the CUDA device (required)."""
    args = build_parser().parse_args(argv)
    print(f'dumphfdl-tpu-torch {__version__}', file=sys.stderr)
    if not args.iq_file and args.soapysdr is None:
        raise SystemExit('error: no input selected (--iq-file / --soapysdr)')
    if args.iq_file and not args.sample_format:
        raise SystemExit('error: --sample-format is required with --iq-file')
    device = require_cuda() if device is None else torch.device(device)
    app = build_app(args, device)
    signal.signal(signal.SIGINT, lambda *_: app.stop())
    signal.signal(signal.SIGTERM, lambda *_: app.stop())
    prof = None
    if args.profile:
        from .utils import profiling
        prof = profiling.profiler(device)
        profiling.clear()       # the trace holds this run's spans only
        prof.start()
        print(f'profiling to {args.profile} (view {profiling.TRACE_NAME} '
              'with Perfetto or chrome://tracing)', file=sys.stderr)
    try:
        if args.iq_file:
            rc = app.run_file(args.iq_file, args.sample_format)
        else:
            from .io.soapy_input import SoapyInput
            src = SoapyInput(
                device=args.soapysdr,
                sample_rate=args.sample_rate,
                centerfreq=app.centerfreq,
                gain=args.gain,
                gain_elements=parse_kvargs(args.gain_elements or ''),
                freq_correction=args.freq_correction,
                antenna=args.antenna,
                device_settings=parse_kvargs(args.device_settings or ''),
                sample_format=args.sample_format,
            )
            src.connect()
            # integer-native sources lose nothing to the CS16-quantized
            # upload (half the transfer bytes)
            rc = app.run_stream(src.stream(), packed=src.is_integer_format)
    finally:
        if prof is not None:
            prof.stop()
            profiling.export(prof, args.profile)
        dumps = app.receiver.bank.dumps
        if dumps is not None:
            dumps.close()
        app.shutdown()
    print(f'{app.frames_decoded} frames decoded', file=sys.stderr)
    return rc


if __name__ == '__main__':
    sys.exit(main())
