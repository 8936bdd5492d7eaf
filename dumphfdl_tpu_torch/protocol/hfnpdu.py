# Copy of dumphfdl_tpu/protocol/hfnpdu.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""HFNPDU (network layer) parser.  Reference: reference src/hfnpdu.c."""

from __future__ import annotations

from .tree import ProtoNode, iprintf, unknown_proto_node

SYSTEM_TABLE = 0xD0
PERFORMANCE_DATA = 0xD1
SYSTEM_TABLE_REQUEST = 0xD2
FREQUENCY_DATA = 0xD5
DELAYED_ECHO = 0xDE
ENVELOPED_DATA = 0xFF

TYPE_NAMES = {
    SYSTEM_TABLE: 'System table (partial)',
    PERFORMANCE_DATA: 'Performance data',
    SYSTEM_TABLE_REQUEST: 'System table request',
    FREQUENCY_DATA: 'Frequency data',
    DELAYED_ECHO: 'Delayed echo',
    ENVELOPED_DATA: 'Enveloped data',
}

FREQ_CHANGE_CODES = {
    0: 'First freq. search in this flight leg',
    1: 'Too many NACKs',
    2: 'SPDUs no longer received',
    3: 'HFDL disabled',
    4: 'GS frequency change',
    5: 'GS down / channel down',
    6: 'Poor uplink channel quality',
    7: 'No change',
}

PROP_FREQS_CNT_MAX = 6


def parse_coordinate(c: int) -> float:
    """20-bit signed coordinate -> degrees (util.c:399-405)."""
    c &= 0xFFFFF
    if c & 0x80000:
        c -= 1 << 20
    return c * 180.0 / 0x7FFFF


def parse_utc_time(t: int) -> dict:
    return {'hour': t // 3600, 'min': t % 3600 // 60, 'sec': t % 60}


def _u16(buf: bytes, off: int) -> int:
    return buf[off] | buf[off + 1] << 8


def _coords(buf: bytes, off: int) -> tuple[float, float]:
    lat_raw = buf[off] | buf[off + 1] << 8 | (buf[off + 2] & 0xF) << 16
    lon_raw = (buf[off + 2] & 0xF0) >> 4 | buf[off + 3] << 4 | buf[off + 4] << 12
    return parse_coordinate(lat_raw), parse_coordinate(lon_raw)


def parse(buf: bytes, direction: str, metadata, ctx) -> ProtoNode | None:
    """hfnpdu.c:235-299."""
    if len(buf) == 0:
        return None
    if buf[0] != 0xFF:
        return unknown_proto_node(buf)
    if len(buf) < 2:
        return None

    data = {'err': False, 'type': buf[1]}
    node = ProtoNode('hfnpdu', data)
    node.text_formatter = lambda n, lines, ind: _fmt(n, lines, ind, ctx)
    node.json_formatter = lambda n: _js(n, ctx)

    t = buf[1]
    if t == SYSTEM_TABLE:
        if len(buf) < 5:
            data['err'] = True
        else:
            data['total_pdu_cnt'] = (buf[2] >> 4) + 1
            data['pdu_seq_num'] = buf[2] & 0xF
            data['systable_version'] = buf[3] >> 4 | buf[4] << 4
            if len(buf) > 5:
                ctx.systable.store_pdu(data['systable_version'],
                                       data['pdu_seq_num'],
                                       data['total_pdu_cnt'], buf[5:])
                complete = ctx.systable.process_pdu_set()
                if complete is not None:
                    node.next = _systable_complete_node(complete, ctx)
    elif t == PERFORMANCE_DATA:
        if len(buf) < 47:
            data['err'] = True
        else:
            data.update(_parse_perf(buf))
    elif t == SYSTEM_TABLE_REQUEST:
        if len(buf) < 4:
            data['err'] = True
        else:
            data['request_data'] = _u16(buf, 2)
    elif t == FREQUENCY_DATA:
        if len(buf) < 15:
            data['err'] = True
        else:
            data.update(_parse_freq_data(buf))
    elif t == DELAYED_ECHO:
        pass
    elif t == ENVELOPED_DATA:
        from . import acars as acars_mod
        node.next = acars_mod.parse(buf[2:], direction, metadata, ctx)
        if node.next is None:
            node.next = unknown_proto_node(buf[2:])
    return node


def _parse_perf(buf: bytes) -> dict:
    lat, lon = _coords(buf, 8)
    return {
        'flight_id': buf[2:8].split(b'\0')[0].decode('ascii', 'replace'),
        'lat': lat, 'lon': lon,
        'utc_time': parse_utc_time(2 * _u16(buf, 13)),
        'version': buf[15],
        'flight_leg': buf[16],
        'gs_id': buf[17] & 0x7F,
        'freq_id': buf[18],
        'prev_leg_freq_search_cnt': _u16(buf, 19),
        'cur_leg_freq_search_cnt': _u16(buf, 21),
        'prev_leg_hf_off_dur': _u16(buf, 23),
        'cur_leg_hf_off_dur': _u16(buf, 25),
        'mpdus_rx': list(buf[27:31]),          # 1800/1200/600/300 bps
        'mpdus_rx_errs': list(buf[31:35]),
        'spdus_rx': _u16(buf, 35),
        'spdus_rx_errs': buf[37],
        'mpdus_tx': list(buf[38:42]),
        'mpdus_delivered': list(buf[42:46]),
        'freq_change_code': buf[46] & 0xF,
    }


def _parse_freq_data(buf: bytes) -> dict:
    lat, lon = _coords(buf, 8)
    out = {
        'flight_id': buf[2:8].split(b'\0')[0].decode('ascii', 'replace'),
        'lat': lat, 'lon': lon,
        'utc_time': parse_utc_time(2 * _u16(buf, 13)),
        'propagating_freqs': [],
    }
    for f in range(PROP_FREQS_CNT_MAX):
        pos = 15 + f * 6
        if pos + 6 > len(buf):
            break
        out['propagating_freqs'].append({
            'gs_id': buf[pos] & 0x7F,
            'prop_freqs': buf[pos + 1] | buf[pos + 2] << 8
            | (buf[pos + 3] & 0xF) << 16,
            'tuned_freqs': (buf[pos + 3] & 0xF0) >> 4 | buf[pos + 4] << 4
            | buf[pos + 5] << 12,
        })
    return out


def _mpdu_stats_line(label: str, stats: list[int]) -> str:
    # stats order: 1800, 1200, 600, 300 (hfnpdu.c:165-170)
    return (f'{label}: 300 bps: {stats[3]:3d}   600 bps: {stats[2]:3d}   '
            f'1200 bps: {stats[1]:3d}   1800 bps: {stats[0]:3d}')


def _fmt(n: ProtoNode, lines: list[str], indent: int, ctx) -> None:
    d = n.data
    if d['err']:
        iprintf(lines, indent, '-- Unparseable HFNPDU')
        return
    name = TYPE_NAMES.get(d['type'])
    if name is not None:
        iprintf(lines, indent, f'{name}:')
    else:
        iprintf(lines, indent, f"Unknown HFNPDU type (0x{d['type']:02x}):")
    indent += 1
    t = d['type']
    if t == SYSTEM_TABLE:
        iprintf(lines, indent, f"Version: {d['systable_version']}")
        iprintf(lines, indent,
                f"Part: {d['pdu_seq_num'] + 1} of {d['total_pdu_cnt']}")
    elif t == PERFORMANCE_DATA:
        iprintf(lines, indent, f"Version: {d['version']}")
        iprintf(lines, indent, f"Flight ID: {d['flight_id']}")
        iprintf(lines, indent, f"Lat: {d['lat']:.7f}")
        iprintf(lines, indent, f"Lon: {d['lon']:.7f}")
        tm = d['utc_time']
        iprintf(lines, indent,
                f"Time: {tm['hour']:02d}:{tm['min']:02d}:{tm['sec']:02d}")
        iprintf(lines, indent, f"Flight leg: {d['flight_leg']}")
        iprintf(lines, indent, f"GS ID: {ctx.gs_text(d['gs_id'])}")
        iprintf(lines, indent, 'Frequency: '
                + ctx.freq_list_text(d['gs_id'], 1 << d['freq_id']))
        iprintf(lines, indent, 'Frequency search count:')
        iprintf(lines, indent + 1, f"This leg: {d['cur_leg_freq_search_cnt']}")
        iprintf(lines, indent + 1, f"Prev leg: {d['prev_leg_freq_search_cnt']}")
        iprintf(lines, indent, 'HFDL disabled duration:')
        iprintf(lines, indent + 1, f"This leg: {d['cur_leg_hf_off_dur']} sec")
        iprintf(lines, indent + 1, f"Prev leg: {d['prev_leg_hf_off_dur']} sec")
        iprintf(lines, indent, _mpdu_stats_line('MPDUs received             ', d['mpdus_rx']))
        iprintf(lines, indent, _mpdu_stats_line('MPDUs received with errors ', d['mpdus_rx_errs']))
        iprintf(lines, indent, _mpdu_stats_line('MPDUs transmitted          ', d['mpdus_tx']))
        iprintf(lines, indent, _mpdu_stats_line('MPDUs delivered            ', d['mpdus_delivered']))
        iprintf(lines, indent, f"SPDUs received: {d['spdus_rx']}")
        iprintf(lines, indent, f"SPDUs missed: {d['spdus_rx_errs']}")
        descr = FREQ_CHANGE_CODES.get(d['freq_change_code'], 'unknown')
        iprintf(lines, indent,
                f"Last frequency change cause: {d['freq_change_code']} ({descr})")
    elif t == SYSTEM_TABLE_REQUEST:
        iprintf(lines, indent, f"Request data: 0x{d['request_data']:x}")
    elif t == FREQUENCY_DATA:
        iprintf(lines, indent, f"Flight ID: {d['flight_id']}")
        iprintf(lines, indent, f"Lat: {d['lat']:.7f}")
        iprintf(lines, indent, f"Lon: {d['lon']:.7f}")
        tm = d['utc_time']
        iprintf(lines, indent,
                f"Time: {tm['hour']:02d}:{tm['min']:02d}:{tm['sec']:02d}")
        for pf in d['propagating_freqs']:
            iprintf(lines, indent, f"GS ID: {ctx.gs_text(pf['gs_id'])}")
            iprintf(lines, indent + 2, 'Listening on: '
                    + ctx.freq_list_text(pf['gs_id'], pf['tuned_freqs']))
            iprintf(lines, indent + 2, 'Heard on: '
                    + ctx.freq_list_text(pf['gs_id'], pf['prop_freqs']))


def _js(n: ProtoNode, ctx) -> dict:
    d = n.data
    obj = {'err': d['err']}
    if d['err']:
        return obj
    obj['type'] = {'id': d['type'],
                   'name': TYPE_NAMES.get(d['type'], 'unknown')}
    t = d['type']
    if t == SYSTEM_TABLE:
        obj['version'] = d['systable_version']
        obj['systable_partial'] = {'part_num': d['pdu_seq_num'] + 1,
                                   'parts_cnt': d['total_pdu_cnt']}
    elif t == PERFORMANCE_DATA:
        obj.update({
            'version': d['version'],
            'flight_id': d['flight_id'],
            'pos': {'lat': d['lat'], 'lon': d['lon']},
            'time': d['utc_time'],
            'flight_leg_num': d['flight_leg'],
            'gs': ctx.gs_json(d['gs_id']),
            'frequency': _freq_json(d, ctx),
            'freq_search_cnt': {'cur_leg': d['cur_leg_freq_search_cnt'],
                                'prev_leg': d['prev_leg_freq_search_cnt']},
            'hfdl_disabled_duration': {'this_leg': d['cur_leg_hf_off_dur'],
                                       'prev_leg': d['prev_leg_hf_off_dur']},
            'pdu_stats': {
                'mpdus_rx_ok_cnt': _stats_json(d['mpdus_rx']),
                'mpdus_rx_err_cnt': _stats_json(d['mpdus_rx_errs']),
                'mpdus_tx_cnt': _stats_json(d['mpdus_tx']),
                'mpdus_delivered_cnt': _stats_json(d['mpdus_delivered']),
                'spdus_rx_ok_cnt': d['spdus_rx'],
                'spdus_missed_cnt': d['spdus_rx_errs'],
            },
            'last_freq_change_cause': {
                'code': d['freq_change_code'],
                'descr': FREQ_CHANGE_CODES.get(d['freq_change_code'], 'unknown'),
            },
        })
    elif t == SYSTEM_TABLE_REQUEST:
        obj['request_data'] = d['request_data']
    elif t == FREQUENCY_DATA:
        obj.update({
            'flight_id': d['flight_id'],
            'pos': {'lat': d['lat'], 'lon': d['lon']},
            'utc_time': d['utc_time'],
            'freq_data': [
                {'gs': ctx.gs_json(pf['gs_id']),
                 'listening_on_freqs': ctx.freq_list_json(pf['gs_id'], pf['tuned_freqs']),
                 'heard_on_freqs': ctx.freq_list_json(pf['gs_id'], pf['prop_freqs'])}
                for pf in d['propagating_freqs']],
        })
    return obj


def _stats_json(stats: list[int]) -> dict:
    return {'300bps': stats[3], '600bps': stats[2],
            '1200bps': stats[1], '1800bps': stats[0]}


def _freq_json(d: dict, ctx) -> dict:
    obj = {'id': 1 << d['freq_id']}
    f = ctx.systable.station_frequency(d['gs_id'], d['freq_id'])
    if f is not None:
        obj['freq'] = f
    return obj


def _systable_complete_node(summary: dict, ctx) -> ProtoNode:
    node = ProtoNode('systable_complete', summary)

    def fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
        d = n.data
        if d.get('systable_decoding_error'):
            iprintf(lines, indent, '-- Unparseable System Table message')
            return
        iprintf(lines, indent, 'System Table (complete):')
        indent += 1
        iprintf(lines, indent, f"Version: {d['version']}")
        for gs in d['stations']:
            iprintf(lines, indent, f"ID: {ctx.gs_text(gs['id'])}")
            iprintf(lines, indent + 1, f"UTC sync: {int(bool(gs.get('utc_sync', False)))}")
            iprintf(lines, indent + 1, 'Location:')
            iprintf(lines, indent + 2, f"Lat: {gs['lat']:.7f}")
            iprintf(lines, indent + 2, f"Lon: {gs['lon']:.7f}")
            iprintf(lines, indent + 1, 'Frequencies:')
            for f in gs['frequencies_khz']:
                iprintf(lines, indent + 2, f'{f:8.1f}')

    node.text_formatter = fmt
    return node
