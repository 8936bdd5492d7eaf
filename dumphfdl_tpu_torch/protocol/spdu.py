# Copy of dumphfdl_tpu/protocol/spdu.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""SPDU (squitter) parser.  Reference: reference src/spdu.c."""

from __future__ import annotations

from ..ops import crc
from .tree import ProtoNode, hexdump_lines, iprintf

SPDU_LEN = 66
GS_STATUS_CNT = 3

CHANGE_NOTE = ['None', 'Channel down', 'Upcoming frequency change',
               'Ground station down']


def parse(buf: bytes, metadata, ctx) -> list[ProtoNode]:
    freq = metadata.freq
    data = {'err': True, 'raw': buf, 'freq': freq}
    if len(buf) < SPDU_LEN:
        ctx.statsd.increment_per_channel(freq, 'frame.errors.too_short')
    elif not crc.fcs_check(buf, 64):
        ctx.statsd.increment_per_channel(freq, 'frame.errors.bad_fcs')
    else:
        ctx.statsd.increment_per_channel(freq, 'frames.good')
        ctx.statsd.increment_per_channel(freq, 'frame.dir.gnd2air')
        src_id = buf[1] & 0x7F
        gs = [
            {'id': src_id, 'utc_sync': bool(buf[1] & 0x80),
             'freqs': buf[54] >> 4 | buf[55] << 4 | buf[56] << 12},
            {'id': buf[57] & 0x7F, 'utc_sync': bool(buf[57] & 0x80),
             'freqs': buf[58] | buf[59] << 8 | (buf[60] & 0xF) << 16},
            {'id': buf[60] >> 4 | (buf[61] & 0x7) << 4,
             'utc_sync': bool(buf[61] & 0x8),
             'freqs': buf[61] >> 4 | buf[62] << 4 | buf[63] << 12},
        ]
        data.update({
            'err': False,
            'src_id': src_id,
            'rls': bool(buf[0] & 2),
            'version': (buf[0] >> 2) & 3,
            'iso': bool(buf[0] & 0x20),
            'change_note': (buf[0] & 0xC0) >> 6,
            'frame_index': buf[2] | ((buf[3] & 0xF) << 8),
            'frame_offset': buf[3] >> 4,
            'min_priority': buf[52] & 0xF,
            'systable_version': buf[53] | ((buf[54] & 0xF) << 8),
            'gs_status': gs,
        })

    if data['err'] and not ctx.options.output_corrupted_pdus:
        return []
    node = ProtoNode('spdu', data)

    def fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
        d = n.data
        if ctx.options.output_raw_frames:
            lines.extend(hexdump_lines(d['raw'], indent + 1))
        if d['err']:
            iprintf(lines, indent, '-- Unparseable PDU (CRC check failed)')
            return
        iprintf(lines, indent, 'Uplink SPDU:')
        indent += 1
        iprintf(lines, indent, f"Src GS: {ctx.gs_text(d['src_id'])}")
        iprintf(lines, indent,
                f"Squitter: ver: {d['version']} rls: {int(d['rls'])} "
                f"iso: {int(d['iso'])}")
        indent += 1
        iprintf(lines, indent, f"Change note: {CHANGE_NOTE[d['change_note']]}")
        iprintf(lines, indent,
                f"TDMA Frame: index: {d['frame_index']} offset: {d['frame_offset']}")
        iprintf(lines, indent, f"Minimum priority: {d['min_priority']}")
        iprintf(lines, indent, f"System table version: {d['systable_version']}")
        iprintf(lines, indent, 'Ground station status:')
        for gs in d['gs_status']:
            iprintf(lines, indent, f"ID: {ctx.gs_text(gs['id'])}")
            iprintf(lines, indent + 1, f"UTC sync: {int(gs['utc_sync'])}")
            iprintf(lines, indent + 1,
                    'Frequencies in use: '
                    + ctx.freq_list_text(gs['id'], gs['freqs']))

    def js(n: ProtoNode) -> dict:
        d = n.data
        if d['err']:
            return {'err': True}
        return {
            'err': False,
            'src': ctx.gs_json(d['src_id']),
            'spdu_version': d['version'],
            'rls': d['rls'],
            'iso': d['iso'],
            'change_note': CHANGE_NOTE[d['change_note']],
            'frame_index': d['frame_index'],
            'frame_offset': d['frame_offset'],
            'min_priority': d['min_priority'],
            'systable_version': d['systable_version'],
            'gs_status': [
                {'gs': ctx.gs_json(gs['id']), 'utc_sync': gs['utc_sync'],
                 'freqs': ctx.freq_list_json(gs['id'], gs['freqs'])}
                for gs in d['gs_status']],
        }

    node.text_formatter = fmt
    node.json_formatter = js
    return [node]
