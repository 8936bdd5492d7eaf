# Copy of dumphfdl_tpu/utils/statsd.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Etsy StatsD UDP client.

Reference: reference src/statsd.c + doc/STATSD_METRICS.md.
Namespace is ``dumphfdl[.station_id].``; per-channel metrics are
``channels.<freq_hz>.<metric>``; per-direction ACARS metrics are
``<metric>.<air2gnd|gnd2air>``.  Gauges only accept non-negative
integers (noise floor is reported in tenths of -dBFS, statsd.c:94-101
note in hfdl.c:1093-1101).
"""

from __future__ import annotations

import socket

NAMESPACE = 'dumphfdl'

COUNTERS_PER_CHANNEL = (
    'demod.preamble.A2_found',
    'demod.preamble.M1_found',
    'demod.preamble.errors.M1_not_found',
    'frames.processed',
    'frames.good',
    'frame.errors.bad_fcs',
    'frame.errors.too_short',
    'frame.dir.air2gnd',
    'frame.dir.gnd2air',
    'lpdus.processed',
    'lpdus.good',
    'lpdu.errors.bad_fcs',
    'lpdu.errors.too_short',
)

COUNTERS_PER_MSGDIR = (
    'acars.reasm.unknown',
    'acars.reasm.complete',
    'acars.reasm.skipped',
    'acars.reasm.duplicate',
    'acars.reasm.out_of_seq',
    'acars.reasm.invalid_args',
    # MIAM file-transfer reassembly (protocol/miam.py MiamFileReasm)
    'miam.reasm.complete',
    'miam.reasm.skipped',
    'miam.reasm.duplicate',
    'miam.reasm.out_of_seq',
    'miam.reasm.invalid_args',
)


class StatsdClient:
    def __init__(self, address: str, station_id: str | None = None):
        """address: 'host:port' (main.c --statsd)."""
        host, _, port = address.rpartition(':')
        if not host:
            raise ValueError(f'statsd address {address!r}: want host:port')
        self._dest = (host, int(port))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        ns = NAMESPACE + (f'.{station_id}' if station_id else '')
        self._prefix = ns + '.'

    def _send(self, metric: str, value, kind: str) -> None:
        msg = f'{self._prefix}{metric}:{value}|{kind}'
        try:
            self._sock.sendto(msg.encode('ascii'), self._dest)
        except OSError:
            pass

    def increment(self, metric: str, count: int = 1) -> None:
        self._send(metric, int(count), 'c')

    def gauge(self, metric: str, value: int) -> None:
        self._send(metric, int(value), 'g')

    def timing(self, metric: str, ms: float) -> None:
        self._send(metric, int(ms), 'ms')

    # -- the per-channel / per-direction API used by the stack --

    def increment_per_channel(self, freq: int, metric: str) -> None:
        self._send(f'channels.{freq}.{metric}', 1, 'c')

    def increment_per_msgdir(self, msgdir: str, metric: str) -> None:
        self._send(f'{metric}.{msgdir}', 1, 'c')

    def set_per_channel(self, freq: int, metric: str, value: int) -> None:
        self._send(f'channels.{freq}.{metric}', int(value), 'g')

    def initialize_counters(self, frequencies: list[int]) -> None:
        """Zero-initialize counters so dashboards see them immediately
        (statsd.c:74-101)."""
        for freq in frequencies:
            for m in COUNTERS_PER_CHANNEL:
                self._send(f'channels.{freq}.{m}', 0, 'c')
        for d in ('air2gnd', 'gnd2air'):
            for m in COUNTERS_PER_MSGDIR:
                self._send(f'{m}.{d}', 0, 'c')
