# Copy of dumphfdl_tpu/protocol/lpdu.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""LPDU (link layer) parser.  Reference: reference src/lpdu.c."""

from __future__ import annotations

from ..ops import crc
from .enrichment import parse_icao_hex
from .tree import ProtoNode, hexdump_lines, iprintf, unknown_proto_node
from . import hfnpdu as hfnpdu_mod

UNNUMBERED_DATA = 0x0D
UNNUMBERED_ACKED_DATA = 0x1D
LOGON_DENIED = 0x2F
LOGOFF_REQUEST = 0x3F
LOGON_RESUME_CONFIRM = 0x5F
LOGON_RESUME = 0x4F
LOGON_REQUEST_NORMAL = 0x8F
LOGON_CONFIRM = 0x9F
LOGON_REQUEST_DLS = 0xBF

TYPE_NAMES = {
    UNNUMBERED_DATA: 'Unnumbered data',
    UNNUMBERED_ACKED_DATA: "Unnumbered ack'ed data",
    LOGON_DENIED: 'Logon denied',
    LOGOFF_REQUEST: 'Logoff request',
    LOGON_RESUME_CONFIRM: 'Logon resume confirm',
    LOGON_RESUME: 'Logon resume',
    LOGON_REQUEST_NORMAL: 'Logon request (normal)',
    LOGON_CONFIRM: 'Logon confirm',
    LOGON_REQUEST_DLS: 'Logon request (DLS)',
}

LOGOFF_REASONS = {
    0x01: 'Not within slot boundaries',
    0x02: 'Downlink set in uplink slot',
    0x03: 'RLS protocol error',
    0x04: 'Invalid aircraft ID',
    0x05: 'HFDL Ground Station subsystem does not support RLS',
    0x06: 'Other',
}

LOGON_DENIED_REASONS = {
    0x01: 'Aircraft ID not available',
    0x02: 'HFDL Ground Station subsystem does not support RLS',
}

LOGON_REQUEST_TYPES = (LOGON_RESUME, LOGON_REQUEST_NORMAL, LOGON_REQUEST_DLS)
LOGON_CONFIRM_TYPES = (LOGON_CONFIRM, LOGON_RESUME_CONFIRM)
LOGOFF_TYPES = (LOGON_DENIED, LOGOFF_REQUEST)


def parse(buf: bytes, mpdu_header: dict, metadata, ctx) -> ProtoNode | None:
    """Parse one LPDU; returns its proto tree (lpdu.c:122-199)."""
    freq = mpdu_header['freq']
    ctx.statsd.increment_per_channel(freq, 'lpdus.processed')
    data = {'err': False, 'crc_ok': False, 'type': None, 'raw': buf,
            'mpdu_header': dict(mpdu_header)}
    node = ProtoNode('lpdu', data)
    node.text_formatter = lambda n, lines, ind: _fmt(n, lines, ind, ctx)
    node.json_formatter = lambda n: _js(n, ctx)

    if len(buf) < 3:
        data['err'] = True
        ctx.statsd.increment_per_channel(freq, 'lpdu.errors.too_short')
        return _finish(node, ctx)

    payload_len = len(buf) - 2     # strip FCS
    data['crc_ok'] = crc.fcs_check(buf, payload_len)
    if not data['crc_ok']:
        data['err'] = True
        ctx.statsd.increment_per_channel(freq, 'lpdu.errors.bad_fcs')
        return _finish(node, ctx)
    ctx.statsd.increment_per_channel(freq, 'lpdus.good')

    body = buf[:payload_len]
    lpdu_type = body[0]
    data['type'] = lpdu_type
    consumed = 0
    if lpdu_type in (UNNUMBERED_DATA, UNNUMBERED_ACKED_DATA):
        consumed = 1
    elif lpdu_type in LOGOFF_TYPES:
        if len(body) < 5:
            consumed = -1
        else:
            data['icao'] = parse_icao_hex(body[1:4])
            data['reason_code'] = body[4]
            consumed = 5
            ctx.ac_cache.delete(freq, data['icao'])         # lpdu.c:163-166
    elif lpdu_type in LOGON_CONFIRM_TYPES:
        if len(body) < 8:
            consumed = -1
        else:
            data['icao'] = parse_icao_hex(body[1:4])
            data['ac_id'] = body[4]
            consumed = 8
            ctx.ac_cache.create(freq, data['ac_id'], data['icao'])  # lpdu.c:172-175
    elif lpdu_type in LOGON_REQUEST_TYPES:
        if len(body) < 4:
            consumed = -1
        else:
            data['icao'] = parse_icao_hex(body[1:4])
            consumed = 4
    else:
        node.next = unknown_proto_node(body)
        consumed = len(body)

    if consumed < 0:
        data['err'] = True
    elif consumed < len(body):
        node.next = hfnpdu_mod.parse(body[consumed:],
                                     mpdu_header['direction'], metadata, ctx)
    return _finish(node, ctx)


def _finish(node: ProtoNode, ctx) -> ProtoNode | None:
    if node.data['err'] and not ctx.options.output_corrupted_pdus:
        return None
    return node


def _fmt(n: ProtoNode, lines: list[str], indent: int, ctx) -> None:
    d = n.data
    hdr = d['mpdu_header']
    if ctx.options.output_raw_frames:
        lines.extend(hexdump_lines(d['raw'], indent + 1))
    if d['err']:
        suffix = '' if d['crc_ok'] else ' (CRC check failed)'
        iprintf(lines, indent, f'-- Unparseable LPDU{suffix}')
        return
    if hdr['direction'] == 'uplink':
        iprintf(lines, indent, 'Uplink LPDU:')
        indent += 1
        iprintf(lines, indent, f"Src GS: {ctx.gs_text(hdr['src_id'])}")
        actext, icao = ctx.ac_text(hdr['freq'], hdr['dst_id'])
        iprintf(lines, indent, f'Dst AC: {actext}')
        _maybe_ac_info(lines, indent + 1, icao, ctx)
    else:
        iprintf(lines, indent, 'Downlink LPDU:')
        indent += 1
        actext, icao = ctx.ac_text(hdr['freq'], hdr['src_id'])
        iprintf(lines, indent, f'Src AC: {actext}')
        _maybe_ac_info(lines, indent + 1, icao, ctx)
        iprintf(lines, indent, f"Dst GS: {ctx.gs_text(hdr['dst_id'])}")
    tname = TYPE_NAMES.get(d['type'])
    if tname is not None:
        iprintf(lines, indent, f'Type: {tname}')
    else:
        iprintf(lines, indent, f"Type: unknown (0x{d['type']:02x})")
    indent += 1
    t = d['type']
    if t in LOGOFF_TYPES:
        iprintf(lines, indent, f"ICAO: {d['icao']:06X}")
        _maybe_ac_info(lines, indent + 1, d['icao'], ctx)
        reasons = LOGON_DENIED_REASONS if t == LOGON_DENIED else LOGOFF_REASONS
        descr = reasons.get(d['reason_code'], 'Reserved')
        iprintf(lines, indent, f"Reason: {d['reason_code']} ({descr})")
    elif t in LOGON_CONFIRM_TYPES:
        iprintf(lines, indent, f"ICAO: {d['icao']:06X}")
        _maybe_ac_info(lines, indent + 1, d['icao'], ctx)
        iprintf(lines, indent, f"Assigned AC ID: {d['ac_id']}")
    elif t in LOGON_REQUEST_TYPES:
        iprintf(lines, indent, f"ICAO: {d['icao']:06X}")
        _maybe_ac_info(lines, indent + 1, d['icao'], ctx)


def _maybe_ac_info(lines: list[str], indent: int, icao, ctx) -> None:
    if icao is None:
        return
    info = ctx.ac_info_text(icao)
    if info is not None:
        iprintf(lines, indent, info)


def _js(n: ProtoNode, ctx) -> dict:
    d = n.data
    hdr = d['mpdu_header']
    obj = {'err': d['err']}
    if d['err']:
        return obj
    if hdr['direction'] == 'uplink':
        obj['src'] = ctx.gs_json(hdr['src_id'])
        obj['dst'] = ctx.ac_json(hdr['freq'], hdr['dst_id'])
    else:
        obj['src'] = ctx.ac_json(hdr['freq'], hdr['src_id'])
        obj['dst'] = ctx.gs_json(hdr['dst_id'])
    obj['type'] = {'id': d['type'],
                   'name': TYPE_NAMES.get(d['type'], 'unknown')}
    t = d['type']
    if t in LOGOFF_TYPES:
        obj['ac_info'] = ctx.ac_info_json(d['icao'])
        reasons = LOGON_DENIED_REASONS if t == LOGON_DENIED else LOGOFF_REASONS
        obj['reason'] = {'code': d['reason_code'],
                         'descr': reasons.get(d['reason_code'], 'Reserved')}
    elif t in LOGON_CONFIRM_TYPES:
        obj['ac_info'] = ctx.ac_info_json(d['icao'])
        obj['assigned_ac_id'] = d['ac_id']
    elif t in LOGON_REQUEST_TYPES:
        obj['ac_info'] = ctx.ac_info_json(d['icao'])
    return obj
