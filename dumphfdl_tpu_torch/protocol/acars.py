# Copy of dumphfdl_tpu/protocol/acars.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""ACARS parser: framing, multiblock reassembly, ARINC-622 recognition.

Host-side reimplementation of the libacars subset the reference uses
(reference src/acars.c:28-40 calls la_acars_parse_and_reassemble).

Frame layout after the SOH octet (stripped by the caller):

  mode(1) registration(7) ack(1) label(2) block_id(1) STX
  [downlink only: msg_num(4) flight_id(6)] text ... ETX|ETB

Characters carry ACARS parity in bit 7 and are stripped to 7 bits.  A
block ending in ETB is a partial multiblock message; blocks are
reassembled per (direction, registration, label, msg_num base) like
libacars' la_reasm with a timeout.  ARINC-622 ATS application payloads
(ADS-C, CPDLC, AFN) are recognized by their IMI and exposed as a child
node (deep decode phases in later; see SURVEY.md §7 step 5).
"""

from __future__ import annotations

import dataclasses
import time as time_mod

from .tree import ProtoNode, iprintf

SOH, STX, ETX, ETB, ACK, NAK, DEL = 0x01, 0x02, 0x03, 0x17, 0x06, 0x15, 0x7F

REASM_TIMEOUT = 300.0      # seconds, like libacars' acars reassembly TTL

REASM_UNKNOWN = 'unknown'
REASM_COMPLETE = 'complete'
REASM_IN_PROGRESS = 'in_progress'
REASM_SKIPPED = 'skipped'
REASM_DUPLICATE = 'duplicate'
REASM_OUT_OF_SEQ = 'out_of_seq'


@dataclasses.dataclass
class _PartialMsg:
    reg: str
    label: str
    msg_num: str          # first block's msg number
    text: str
    raw: bytes            # unstripped text-region bytes (ARINC-622 payloads)
    last_block_id: str
    created: float


class ReasmCtx:
    """Multiblock ACARS reassembly state (la_reasm_ctx equivalent)."""

    def __init__(self):
        self._partial: dict[tuple, _PartialMsg] = {}

    def _expire(self, now: float):
        dead = [k for k, v in self._partial.items()
                if now - v.created > REASM_TIMEOUT]
        for k in dead:
            del self._partial[k]

    def add(self, direction: str, reg: str, label: str, msg_num: str,
            block_id: str, text: str, more: bool,
            now: float | None = None,
            raw: bytes = b'') -> tuple[str, str, bytes]:
        """Returns (reasm_status, full_text, full_raw)."""
        now = time_mod.monotonic() if now is None else now
        self._expire(now)
        key = (direction, reg, label)
        cur = self._partial.get(key)
        if cur is None:
            if not more:
                return REASM_SKIPPED, text, raw
            self._partial[key] = _PartialMsg(reg, label, msg_num, text,
                                             raw, block_id, now)
            return REASM_IN_PROGRESS, text, raw
        # continuation: block ids ascend ('A', 'B', ...)
        if block_id == cur.last_block_id:
            return REASM_DUPLICATE, text, raw
        if len(block_id) == 1 and len(cur.last_block_id) == 1 and \
                ord(block_id) != ord(cur.last_block_id) + 1:
            del self._partial[key]
            return REASM_OUT_OF_SEQ, text, raw
        cur.text += text
        cur.raw += raw
        cur.last_block_id = block_id
        cur.created = now
        if more:
            return REASM_IN_PROGRESS, cur.text, cur.raw
        full, full_raw = cur.text, cur.raw
        del self._partial[key]
        return REASM_COMPLETE, full, full_raw


def _strip7(b: bytes) -> str:
    return ''.join(chr(c & 0x7F) for c in b)


def parse(buf: bytes, direction: str, metadata, ctx) -> ProtoNode | None:
    """acars.c:28-40 + la_acars core parse."""
    if len(buf) == 0 or buf[0] != SOH:
        return None
    msg_dir = 'gnd2air' if direction == 'uplink' else 'air2gnd'
    node = _parse_body(buf[1:], msg_dir, metadata, ctx)
    if node is not None and not node.data.get('err'):
        status = node.data.get('reasm_status')
        metric = {
            REASM_UNKNOWN: 'acars.reasm.unknown',
            REASM_COMPLETE: 'acars.reasm.complete',
            REASM_SKIPPED: 'acars.reasm.skipped',
            REASM_DUPLICATE: 'acars.reasm.duplicate',
            REASM_OUT_OF_SEQ: 'acars.reasm.out_of_seq',
        }.get(status)
        if metric:
            ctx.statsd.increment_per_msgdir(msg_dir, metric)
    return node


def _parse_body(buf: bytes, msg_dir: str, metadata, ctx) -> ProtoNode:
    data: dict = {'err': False}
    node = ProtoNode('acars', data)
    node.text_formatter = lambda n, lines, ind: _fmt(n, lines, ind, ctx)
    node.json_formatter = _js

    if len(buf) and buf[-1] == DEL:
        buf = buf[:-1]
    if len(buf) < 12:
        data['err'] = True
        return node
    data['mode'] = chr(buf[0] & 0x7F)
    data['reg'] = _strip7(buf[1:8]).lstrip('.')
    ack = buf[8] & 0x7F
    data['ack'] = chr(ack) if ack != NAK else None
    data['label'] = _strip7(buf[9:11]).replace(chr(DEL), 'd')
    data['block_id'] = chr(buf[11] & 0x7F)
    data['msg_num'] = ''
    data['flight_id'] = ''
    text = ''
    raw = b''
    more = False
    if len(buf) > 12:
        if (buf[12] & 0x7F) != STX:
            data['err'] = True
            return node
        body = buf[13:]
        if len(body) and body[-1] & 0x7F in (ETX, ETB):
            more = (body[-1] & 0x7F) == ETB
            body = body[:-1]
        text = _strip7(body)
        raw = bytes(body)
        downlink = msg_dir == 'air2gnd'
        if downlink and len(text) >= 10 and data['block_id'] not in '\x00':
            data['msg_num'] = text[:4]
            data['flight_id'] = text[4:10]
            text = text[10:]
            raw = raw[10:]
    data['more_to_come'] = more

    status, full_text, full_raw = ctx.reasm.add(
        msg_dir, data['reg'], data['label'], data['msg_num'],
        data['block_id'], text, more, raw=raw)
    data['reasm_status'] = status
    data['text'] = full_text if status == REASM_COMPLETE else text

    if status in (REASM_COMPLETE, REASM_SKIPPED) and data['text']:
        use_raw = full_raw if status == REASM_COMPLETE else raw
        child = _parse_arinc622(data['text'], use_raw, msg_dir)
        if child is None and data['label'] == 'SA':
            from . import media_adv as media_adv_mod
            child = media_adv_mod.parse(data['label'], data['text'])
        if child is None and data['label'] == 'MA':
            from . import miam as miam_mod
            child = miam_mod.parse(data['label'], data['text'], use_raw,
                                   msg_dir=msg_dir, ctx=ctx,
                                   reg=data['reg'])
        if child is None and data['text'].startswith('OHMA'):
            from . import ohma as ohma_mod
            child = ohma_mod.parse(data['text'], ctx=ctx)
        if child is not None:
            node.next = child
    return node


# --- ARINC 622 ATS applications ---

IMI_NAMES = {
    'ADS': 'ADS-C message',
    'DIS': 'ADS-C disconnect',
    'AFN': 'AFN message',
    'CPD': 'CPDLC message',
    'CR1': 'CPDLC Connect Request',
    'CC1': 'CPDLC Connect Confirm',
    'DR1': 'CPDLC Disconnect Request',
    'AT1': 'CPDLC message',
}


def _parse_arinc622(text: str, raw: bytes, msg_dir: str) -> ProtoNode | None:
    """Recognize '/<ground addr>.<IMI><aircraft reg>' ATS payloads.

    ADS-C ('ADS'/'DIS') payloads decode via protocol/adsc.py; CPDLC and
    AFN are surfaced with IMI + raw payload (deep decode phases in).
    """
    if not text.startswith('/') or len(text) < 12 or text[8] != '.':
        return None
    imi = text[9:12]
    if imi not in IMI_NAMES:
        return None
    payload = raw[19:] if len(raw) >= 19 else b''
    node = ProtoNode('arinc622', {
        'gs_addr': text[1:8],
        'imi': imi,
        'name': IMI_NAMES[imi],
        'air_addr': text[12:19],
        'payload_hex': payload.hex(),
    })

    def fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
        d = n.data
        iprintf(lines, indent, f"{d['name']}:")
        iprintf(lines, indent + 1, f"Ground address: {d['gs_addr']}")
        iprintf(lines, indent + 1, f"Aircraft address: {d['air_addr']}")

    node.text_formatter = fmt
    if imi == 'ADS' and msg_dir == 'air2gnd' and len(payload) > 2:
        from . import adsc as adsc_mod
        # the last 2 octets are the ARINC-622 application CRC
        node.next = adsc_mod.parse(payload[:-2])
    elif imi == 'AT1' and len(payload) > 2:
        from . import cpdlc as cpdlc_mod
        node.next = cpdlc_mod.parse(payload[:-2],
                                    uplink=(msg_dir == 'gnd2air'))
    elif imi in ('CR1', 'DR1', 'CC1') and len(payload) > 2:
        # connect-management payloads are plain ATC messages: CR1/DR1 are
        # aircraft-initiated (downlink grammar), CC1 is the ground confirm
        # (uplink grammar) -- mirrors libacars' per-IMI type dispatch
        from . import cpdlc as cpdlc_mod
        node.next = cpdlc_mod.parse(payload[:-2], uplink=(imi == 'CC1'))
    return node


def _fmt(n: ProtoNode, lines: list[str], indent: int, ctx) -> None:
    d = n.data
    if d['err']:
        iprintf(lines, indent, '-- Unparseable ACARS message')
        return
    iprintf(lines, indent, 'ACARS:')
    indent += 1
    reasm = d.get('reasm_status')
    if reasm not in (None, REASM_SKIPPED):
        iprintf(lines, indent, f'Reassembly: {reasm}')
    iprintf(lines, indent,
            f"Reg: {d['reg']} Flight: {d['flight_id'] or '-':8s} "
            f"Label: {d['label']} Blk id: {d['block_id']} "
            f"Ack: {d['ack'] or '!'} Mode: {d['mode']} "
            f"Msg num: {d['msg_num'] or '-'}")
    if d['text']:
        iprintf(lines, indent, 'Message:')
        text = d['text']
        if getattr(ctx.options, 'prettify_xml', False):
            text = prettify_xml(text)
        for chunk in text.split('\r\n'):
            for line in chunk.split('\n'):
                if line:
                    iprintf(lines, indent + 1, line)


def prettify_xml(text: str) -> str:
    """Pretty-print an XML payload (--prettify-xml, main.c:305: 'Pretty-
    print XML payloads in ACARS and MIAM CORE PDUs').  Returns the text
    unchanged when it is not well-formed XML."""
    stripped = text.strip()
    if not stripped.startswith('<'):
        return text
    try:
        from xml.dom import minidom
        dom = minidom.parseString(stripped)
    except Exception:
        return text
    pretty = dom.toprettyxml(indent='  ')
    return '\n'.join(ln for ln in pretty.split('\n') if ln.strip())


def _js(n: ProtoNode) -> dict:
    d = n.data
    obj = {'err': d['err']}
    if d['err']:
        return obj
    obj.update({
        'crc_ok': True,
        'more': d.get('more_to_come', False),
        'reg': d['reg'],
        'mode': d['mode'],
        'label': d['label'],
        'blk_id': d['block_id'],
        'ack': d['ack'] if d['ack'] is not None else False,
        'flight': d['flight_id'],
        'msg_num': d['msg_num'][:3] if d['msg_num'] else '',
        'msg_num_seq': d['msg_num'][3:] if len(d['msg_num']) > 3 else '',
        'msg_text': d['text'],
    })
    if d.get('reasm_status'):
        obj['reasm_status'] = d['reasm_status']
    return obj
