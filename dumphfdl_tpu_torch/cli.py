"""Command-line interface of the PyTorch port.

Same flag surface as ``dumphfdl_tpu/cli.py`` (which mirrors the reference
decoder, main.c:378-425).  Offline file decode is ported; --soapysdr,
--mesh, --profile and --datadumps raise a "not yet ported" error.  The
decoder runs on the CUDA device and refuses to start without one.

    python -m dumphfdl_tpu_torch.cli --iq-file CAPTURE --sample-format CS16 \
        --sample-rate 48000 --centerfreq 8930 8912 8942
"""

from __future__ import annotations

import argparse
import signal
import sys

import torch

from dumphfdl_tpu.io.outputs import OutputManager, OutputSpec
from dumphfdl_tpu.protocol.enrichment import AcCache, AcData, SysTable
from dumphfdl_tpu.protocol.runtime import ProtocolContext, ProtocolOptions
from dumphfdl_tpu.utils.statsd import StatsdClient
from . import __version__
from .app import AppConfig, HfdlApp
from .device import require_cuda

_NOT_PORTED = ('soapysdr', 'mesh', 'profile', 'datadumps')


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
                     help='use a SoapySDR device (not yet ported)')
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
                     help='file input buffer size in bytes')
    src.add_argument('--fft-threads', type=int, default=4,
                     help='accepted for compatibility (cuFFT manages threads)')
    src.add_argument('--demod-block', type=int, default=5400,
                     metavar='SAMPLES',
                     help='demod block length in 5400-sps samples '
                          '(max 16200; the fused resampler needs a '
                          'multiple of 3 x its ratio denominator)')
    src.add_argument('--mesh', metavar='TIMExCHAN', default=None,
                     help='multi-device mesh (not yet ported)')

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
                     help='dump per-stage DSP signals (not yet ported)')
    obs.add_argument('--profile', metavar='DIR',
                     help='record a profiler trace (not yet ported)')

    p.add_argument('frequencies', nargs='*', type=float, metavar='FREQ',
                   help='HFDL channel frequencies in kHz')
    return p


def build_app(args, device: torch.device) -> HfdlApp:
    if not args.frequencies:
        raise SystemExit('error: no channel frequencies given')
    if not args.sample_rate:
        raise SystemExit('error: --sample-rate is required')
    freqs_hz = [int(round(f * 1000)) for f in args.frequencies]
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
        demod_block_len=args.demod_block,
    )
    app = HfdlApp(cfg, ctx, outputs, statsd=statsd)
    if args.debug:
        from dumphfdl_tpu.utils import debug
        debug.set_classes(args.debug)
    return app


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the decoder; device defaults to the CUDA device (required)."""
    args = build_parser().parse_args(argv)
    print(f'dumphfdl-tpu-torch {__version__}', file=sys.stderr)
    for flag in _NOT_PORTED:
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f'error: --{flag} is not yet ported to '
                             'dumphfdl_tpu_torch')
    if not args.iq_file:
        raise SystemExit('error: no input selected (--iq-file)')
    if not args.sample_format:
        raise SystemExit('error: --sample-format is required with --iq-file')
    device = require_cuda() if device is None else torch.device(device)
    app = build_app(args, device)
    signal.signal(signal.SIGINT, lambda *_: app.stop())
    signal.signal(signal.SIGTERM, lambda *_: app.stop())
    try:
        rc = app.run_file(args.iq_file, args.sample_format)
    finally:
        app.shutdown()
    print(f'{app.frames_decoded} frames decoded', file=sys.stderr)
    return rc


if __name__ == '__main__':
    sys.exit(main())
