# Copy of dumphfdl_tpu/protocol/mpdu.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""MPDU (media access) parser.  Reference: reference src/mpdu.c."""

from __future__ import annotations

from ..ops import crc
from .tree import ProtoNode, hexdump_lines, iprintf
from . import lpdu as lpdu_mod

UPLINK, DOWNLINK = 'uplink', 'downlink'


def parse(buf: bytes, metadata, ctx) -> list[ProtoNode]:
    """Parse an MPDU into a list of LPDU trees (mpdu.c:31-134).

    When options.output_mpdus is set, the first list element is an MPDU
    summary node whose children are the LPDUs.
    """
    freq = metadata.freq
    lpdu_trees: list[ProtoNode] = []
    hdr = {'freq': freq, 'crc_ok': False, 'direction': UPLINK,
           'src_id': 0, 'dst_id': 0}
    dst_aircraft: list[tuple[int, int]] = []
    ok = False

    if buf[0] & 0x2:                     # downlink (mpdu.c:56-59)
        hdr['direction'] = DOWNLINK
        lpdu_cnt = (buf[0] >> 2) & 0xF
        hdr_len = 6 + lpdu_cnt
        if len(buf) >= hdr_len + 2 and crc.fcs_check(buf, hdr_len):
            hdr['crc_ok'] = True
            ctx.statsd.increment_per_channel(freq, 'frames.good')
            ctx.statsd.increment_per_channel(freq, 'frame.dir.air2gnd')
            hdr['src_id'] = buf[2]
            hdr['dst_id'] = buf[1] & 0x7F
            sizes = buf[6:6 + lpdu_cnt]
            data_off = hdr_len + 2
            for j in range(lpdu_cnt):
                lpdu_len = sizes[j] + 1
                if data_off + lpdu_len > len(buf):
                    break
                node = lpdu_mod.parse(buf[data_off:data_off + lpdu_len],
                                      hdr, metadata, ctx)
                if node is not None:
                    lpdu_trees.append(node)
                data_off += lpdu_len
            ok = True
        elif len(buf) < hdr_len + 2:
            ctx.statsd.increment_per_channel(freq, 'frame.errors.too_short')
        else:
            ctx.statsd.increment_per_channel(freq, 'frame.errors.bad_fcs')
    else:                                # uplink (mpdu.c:60-75)
        aircraft_cnt = ((buf[0] & 0x70) >> 4) + 1
        hdr_len = 2
        lpdu_cnts = []
        too_short = False
        for _ in range(aircraft_cnt):
            if len(buf) < hdr_len + 2:
                too_short = True
                break
            n = buf[hdr_len + 1] >> 4
            lpdu_cnts.append((hdr_len, n))
            hdr_len += 2 + n
        if too_short or len(buf) < hdr_len + 2:
            ctx.statsd.increment_per_channel(freq, 'frame.errors.too_short')
        elif not crc.fcs_check(buf, hdr_len):
            ctx.statsd.increment_per_channel(freq, 'frame.errors.bad_fcs')
        else:
            hdr['crc_ok'] = True
            ctx.statsd.increment_per_channel(freq, 'frames.good')
            ctx.statsd.increment_per_channel(freq, 'frame.dir.gnd2air')
            hdr['src_id'] = buf[1] & 0x7F
            data_off = hdr_len + 2
            for ac_off, lpdu_cnt in lpdu_cnts:
                ac_hdr = dict(hdr)
                ac_hdr['dst_id'] = buf[ac_off]
                sizes = buf[ac_off + 2:ac_off + 2 + lpdu_cnt]
                dst_aircraft.append((ac_hdr['dst_id'], lpdu_cnt))
                for j in range(lpdu_cnt):
                    lpdu_len = sizes[j] + 1
                    if data_off + lpdu_len > len(buf):
                        break
                    node = lpdu_mod.parse(buf[data_off:data_off + lpdu_len],
                                          ac_hdr, metadata, ctx)
                    if node is not None:
                        lpdu_trees.append(node)
                    data_off += lpdu_len
            ok = True

    if ctx.options.output_mpdus and (hdr['crc_ok'] or
                                     ctx.options.output_corrupted_pdus):
        mnode = _mpdu_node(buf, hdr, dst_aircraft, ctx)
        return [mnode] + lpdu_trees
    return lpdu_trees if ok else []


def _mpdu_node(buf: bytes, hdr: dict, dst_aircraft, ctx) -> ProtoNode:
    node = ProtoNode('mpdu', {
        'err': not hdr['crc_ok'],
        'direction': hdr['direction'],
        'src_id': hdr['src_id'],
        'dst_id': hdr['dst_id'],
        'freq': hdr['freq'],
        'dst_aircraft': list(dst_aircraft),
        'raw': buf,
    })

    def fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
        d = n.data
        if ctx.options.output_raw_frames:
            lines.extend(hexdump_lines(d['raw'], indent + 1))
        if d['err']:
            iprintf(lines, indent, '-- Unparseable PDU (CRC check failed)')
            return
        if d['direction'] == UPLINK:
            iprintf(lines, indent, 'Uplink MPDU:')
            iprintf(lines, indent + 1, f"Src GS: {ctx.gs_text(d['src_id'])}")
            for ac_id, cnt in d['dst_aircraft']:
                actext, _ = ctx.ac_text(d['freq'], ac_id)
                iprintf(lines, indent + 1, f'Dst AC: {actext}')
                iprintf(lines, indent + 2, f'LPDU count: {cnt}')
        else:
            iprintf(lines, indent, 'Downlink MPDU:')
            actext, _ = ctx.ac_text(d['freq'], d['src_id'])
            iprintf(lines, indent + 1, f'Src AC: {actext}')
            iprintf(lines, indent + 1, f"Dst GS: {ctx.gs_text(d['dst_id'])}")

    def js(n: ProtoNode) -> dict:
        d = n.data
        obj = {'err': d['err']}
        if d['err']:
            return obj
        if d['direction'] == UPLINK:
            obj['src'] = ctx.gs_json(d['src_id'])
            obj['dsts'] = [
                {'dst': ctx.ac_json(d['freq'], ac_id), 'lpdu_cnt': cnt}
                for ac_id, cnt in d['dst_aircraft']]
        else:
            obj['src'] = ctx.ac_json(d['freq'], d['src_id'])
            obj['dst'] = ctx.gs_json(d['dst_id'])
        return obj

    node.text_formatter = fmt
    node.json_formatter = js
    return node
