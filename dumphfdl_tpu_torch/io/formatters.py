# Copy of dumphfdl_tpu/io/formatters.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Message formatters: text / json / basestation.

References: reference src/fmtr-text.c, fmtr-json.c,
fmtr-basestation.c.  A formatter turns (PduMetadata, ProtoNode) into an
output payload string, or None when it does not apply.
"""

from __future__ import annotations

import json
import time as time_mod

from .. import __version__ as VERSION
from ..protocol import position as position_mod
from ..protocol.pdu import PduMetadata
from ..protocol.tree import ProtoNode

POSITION_MAX_AGE = 300      # fmtr-basestation.c:10


def _format_timestamp_text(meta: PduMetadata, utc: bool, milliseconds: bool) -> str:
    t = meta.rx_timestamp
    tm = time_mod.gmtime(t) if utc else time_mod.localtime(t)
    base = time_mod.strftime('%Y-%m-%d %H:%M:%S', tm)
    if milliseconds:
        base += '.%03d' % (round((t % 1) * 1000) % 1000)
    tz = time_mod.strftime('%Z', tm) or ('UTC' if utc else '')
    return f'{base} {tz}'


class TextFormatter:
    name = 'text'
    description = 'Human readable text'
    output_format = 'text'

    def __init__(self, ctx):
        self.ctx = ctx

    def format(self, meta: PduMetadata, tree: ProtoNode) -> str | None:
        opt = self.ctx.options
        ts = _format_timestamp_text(meta, opt.utc, opt.milliseconds)
        header = (f'[{ts}] [{meta.freq / 1000.0:.1f} kHz] '
                  f'[{meta.freq_err_hz:.1f} Hz] '
                  f'[{meta.rssi:.1f}/{meta.noise_floor:.1f} dBFS] '
                  f'[{meta.snr_db:.1f} dB] '
                  f'[{meta.bit_rate} bps] [{meta.slot}]\n')
        return header + tree.format_text(0) + '\n'


class JsonFormatter:
    name = 'json'
    description = 'Javascript object notation'
    output_format = 'json'

    def __init__(self, ctx):
        self.ctx = ctx

    def format(self, meta: PduMetadata, tree: ProtoNode) -> str | None:
        obj = {
            'app': {'name': 'dumphfdl-tpu', 'ver': VERSION},
        }
        if self.ctx.options.station_id:
            obj['station'] = self.ctx.options.station_id
        obj['t'] = {'sec': int(meta.rx_timestamp),
                    'usec': int((meta.rx_timestamp % 1) * 1e6)}
        obj.update({
            'freq': meta.freq,
            'bit_rate': meta.bit_rate,
            'sig_level': meta.rssi,
            'noise_level': meta.noise_floor,
            'freq_skew': meta.freq_err_hz,
            'slot': meta.slot,
        })
        obj[tree.json_key] = tree.to_json()
        if getattr(self.ctx.options, 'prettify_json', False):
            return json.dumps({'hfdl': obj}, indent=1,
                              ensure_ascii=False) + '\n'
        return json.dumps({'hfdl': obj}, separators=(',', ':'),
                          ensure_ascii=False) + '\n'


class BasestationFormatter:
    name = 'basestation'
    description = 'Position data in Basestation format (CSV)'
    output_format = 'basestation'

    def __init__(self, ctx):
        self.ctx = ctx

    def format(self, meta: PduMetadata, tree: ProtoNode) -> str | None:
        pos = position_mod.extract(tree, self.ctx)
        if pos is None:
            return None
        now = time_mod.time()
        if pos.t > now or pos.t + POSITION_MAX_AGE < now:
            return None        # fmtr-basestation.c:37-47
        ts = time_mod.strftime('%Y/%m/%d,%H:%M:%S.000', pos.tm)
        freq = meta.freq // 1000 if self.ctx.options.freq_as_squawk else 0
        return (f'MSG,3,1,1,{pos.icao:06X},1,{ts},{ts},'
                f'{pos.flight_id or ""},,,,{pos.lat:f},{pos.lon:f},,{freq},,,,0\n')


FORMATTERS = {
    'text': TextFormatter,
    'json': JsonFormatter,
    'basestation': BasestationFormatter,
}


def create(name: str, ctx):
    try:
        return FORMATTERS[name.lower()](ctx)
    except KeyError:
        raise ValueError(f'unknown format: {name}') from None
