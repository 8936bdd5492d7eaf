# Copy of dumphfdl_tpu/protocol/miam.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""MIAM (Media Independent Aircraft Messaging, ARINC 841) decode.

The reference gets MIAM decoding from libacars (la_miam_parse is invoked
from la_acars_parse_and_reassemble, which reference src/acars.c:33
delegates to; the statsd counters acars.c:47-52 count its reassembly
outcomes).  MIAM rides ordinary ACARS messages with label 'MA': the
message text is one ACARS Convergence Function (CF) frame, identified by
its first character, and the Single Transfer frame body carries a MIAM
CORE PDU.

Decode depth:

- ACARS CF frame classification by frame-id character (the seven ARINC
  841 CF frame types).
- For Single Transfer frames, CORE PDU header recognition (leading
  ASCII-hex version/PDU-type pair) and **body recovery**: MIAM CORE
  compresses application data with DEFLATE and armors binary PDUs in a
  base-85 text encoding for the ACARS channel, so the body pipeline
  tries (a) a raw zlib stream in the 8-bit body, (b) base85-decoding
  the text tail (both the ASCII85 and RFC-1924 alphabets) and then a
  zlib stream inside the result.  A recovered payload is DEFLATE-
  decompressed and classified: an embedded ACARS message (leading SOH)
  recurses into the ACARS parser (the 'ACARS over MIAM' application),
  printable text is shown as text, anything else as hex.
- **File-transfer reassembly** (la_miam_* file transfer equivalent,
  VERDICT r4 #6): F/K/S/A frames are tracked per (direction,
  registration, file id) with a TTL; File Segment payloads accumulate
  by segment id, completion fires when the contiguous prefix reaches
  the size announced by the File Transfer Request, and the assembled
  file runs through the same CORE body pipeline as a Single Transfer.
  Reassembly outcomes feed per-direction statsd counters
  (miam.reasm.*), mirroring the reference's acars.reasm.* counters
  (acars.c:47-52, doc/STATSD_METRICS.md).

No ARINC 841 test vectors or off-air MIAM captures were available in
this environment, so the CORE header layout and the file-transfer
field widths (3-digit file id / 3-digit segment id / 6-digit file
size) are labeled best-effort in the output ('hdr_confidence')
rather than presented as authoritative; the frame-id table, the
DEFLATE use, and the base85 armoring are well-documented public
facts.  The reassembly machinery (keying, TTL, duplicate/ordering/
abort semantics, counters) round-trips against this module's own
segmenter in tests/test_protocol.py.
"""

from __future__ import annotations

import base64
import dataclasses
import time as time_mod
import zlib

from .tree import ProtoNode, iprintf

# ARINC 841 ACARS CF frame identifiers (first char of the message text).
FRAME_IDS = {
    'T': 'Single Transfer',
    'F': 'File Transfer Request',
    'K': 'File Transfer Accept',
    'S': 'File Segment',
    'A': 'File Transfer Abort',
    'Y': 'MIAM XOFF IND',
    'X': 'MIAM XON IND',
}

CORE_PDU_TYPES = {
    0: 'Data',
    1: 'Ack',
    2: 'Aloha',
    3: 'Aloha reply',
}

_SOH = 0x01

# ---- file-transfer reassembly (F/K/S/A frames) --------------------------

FILE_REASM_TTL = 1800.0     # seconds a pending transfer survives without
                            # a new segment (transfers pace segments over
                            # minutes; generous like libacars' miam TTL)

REASM_COMPLETE = 'complete'
REASM_IN_PROGRESS = 'in_progress'
REASM_SKIPPED = 'skipped'          # segment without a tracked request
REASM_DUPLICATE = 'duplicate'
REASM_OUT_OF_SEQ = 'out_of_seq'    # segment id beyond the announced size
REASM_INVALID = 'invalid_args'

ABORT_REASONS = {
    0: 'undefined',
    1: 'file transfer refused',
    2: 'file transfer cancelled',
    3: 'segment timeout',
    4: 'file CRC check failure',
}


@dataclasses.dataclass
class _FileTransfer:
    file_id: int
    file_size: int
    segments: dict            # segment_id -> bytes
    created: float
    updated: float


class MiamFileReasm:
    """Per-(direction, registration, file id) segment reassembly."""

    def __init__(self):
        self._active: dict[tuple, _FileTransfer] = {}

    def _expire(self, now: float) -> None:
        dead = [k for k, v in self._active.items()
                if now - v.updated > FILE_REASM_TTL]
        for k in dead:
            del self._active[k]

    def request(self, msg_dir: str, reg: str, file_id: int,
                file_size: int, now: float | None = None) -> str:
        now = time_mod.monotonic() if now is None else now
        self._expire(now)
        if file_size <= 0:
            return REASM_INVALID
        self._active[(msg_dir, reg, file_id)] = _FileTransfer(
            file_id, file_size, {}, now, now)
        return REASM_IN_PROGRESS

    def segment(self, msg_dir: str, reg: str, file_id: int,
                segment_id: int, data: bytes,
                now: float | None = None) -> tuple[str, bytes | None]:
        """Returns (status, assembled file or None)."""
        now = time_mod.monotonic() if now is None else now
        self._expire(now)
        cur = self._active.get((msg_dir, reg, file_id))
        if cur is None:
            return REASM_SKIPPED, None
        if segment_id in cur.segments:
            return REASM_DUPLICATE, None
        if segment_id < 1 or sum(len(s) for s in cur.segments.values()) \
                >= cur.file_size:
            return REASM_OUT_OF_SEQ, None
        cur.segments[segment_id] = data
        cur.updated = now
        # complete when the contiguous prefix 1..n covers file_size
        total = 0
        sid = 1
        while sid in cur.segments:
            total += len(cur.segments[sid])
            sid += 1
        if total >= cur.file_size:
            blob = b''.join(cur.segments[i] for i in range(1, sid))
            del self._active[(msg_dir, reg, file_id)]
            return REASM_COMPLETE, blob[:cur.file_size]
        return REASM_IN_PROGRESS, None

    def abort(self, msg_dir: str, reg: str, file_id: int) -> bool:
        return self._active.pop((msg_dir, reg, file_id), None) is not None

    def pending(self) -> int:
        return len(self._active)


def _find_zlib(body: bytes):
    """Locate and inflate a zlib stream inside `body`.

    Returns (offset, decompressed) or None."""
    for i in range(len(body) - 1):
        if body[i] == 0x78 and body[i + 1] in (0x01, 0x5E, 0x9C, 0xDA):
            try:
                out = zlib.decompressobj().decompress(bytes(body[i:]))
            except zlib.error:
                continue
            if out:
                return i, out
    return None


def _try_base85(text: str):
    """base85-decode `text` with the common alphabets; returns the first
    variant whose result contains an inflatable zlib stream."""
    t = ''.join(text.split())
    for name, dec in (('ascii85', base64.a85decode),
                      ('base85', base64.b85decode)):
        for trim in range(4):          # tolerate a ragged tail
            if len(t) - trim < 8:
                break
            try:
                blob = dec(t[:len(t) - trim])
            except ValueError:
                continue
            z = _find_zlib(blob)
            if z is not None:
                return name, z[0], z[1]
    return None


def _classify_payload(payload: bytes, core: dict, msg_dir, ctx) -> None:
    """Attach the decompressed application payload to the core dict,
    recursing into an embedded ACARS message when present."""
    core['decompressed_len'] = len(payload)
    if payload[:1] == bytes([_SOH]) and ctx is not None:
        from . import acars as acars_mod
        child = acars_mod._parse_body(payload[1:], msg_dir or 'air2gnd',
                                      None, ctx)
        if child is not None and not child.data.get('err'):
            core['app'] = 'ACARS message'
            core['_acars_child'] = child
            return
    try:
        text = payload.decode('ascii')
        printable = all(' ' <= ch <= '~' or ch in '\r\n\t' for ch in text)
    except UnicodeDecodeError:
        printable = False
    if printable:
        core['app'] = 'text'
        if ctx is not None and getattr(ctx.options, 'prettify_xml', False):
            from .acars import prettify_xml
            text = prettify_xml(text)
        core['app_text'] = text
    else:
        core['app'] = 'binary'
        core['app_hex'] = payload[:512].hex()


def _parse_core_body(data: dict, node: ProtoNode, body: bytes, text: str,
                     msg_dir, ctx) -> None:
    """Single-Transfer / reassembled-file CORE pipeline (shared)."""
    core: dict = {'hdr_confidence': 'best-effort'}
    # leading ASCII-hex version / PDU-type pair
    v, t = chr(body[0] & 0x7F), chr(body[1] & 0x7F)
    if v in '0123456789abcdefABCDEF':
        core['version'] = int(v, 16)
    if t in '0123456789abcdefABCDEF':
        tv = int(t, 16)
        core['pdu_type'] = CORE_PDU_TYPES.get(tv, f'unknown ({tv})')
    # body recovery: raw zlib stream, else base85-armored zlib
    z = _find_zlib(body)
    if z is not None:
        core['compression'] = f'deflate (zlib stream at offset {z[0]})'
        core['deflate_offset'] = z[0]
        _classify_payload(z[1], core, msg_dir, ctx)
    else:
        b85 = _try_base85(text)
        if b85 is not None:
            alph, off, payload = b85
            core['compression'] = \
                f'deflate ({alph}-armored, stream at offset {off})'
            core['encoding'] = alph
            _classify_payload(payload, core, msg_dir, ctx)
        else:
            core['compression'] = 'none detected'
    data['core'] = core
    child = core.pop('_acars_child', None)
    if child is not None:
        node.next = child


def _miam_reasm(ctx) -> MiamFileReasm:
    r = getattr(ctx, '_miam_file_reasm', None)
    if r is None:
        r = MiamFileReasm()
        ctx._miam_file_reasm = r
    return r


def _count(ctx, msg_dir, status: str) -> None:
    """Per-direction reassembly counters, mirroring the reference's
    acars.reasm.* statsd family (acars.c:47-52; final states only)."""
    if ctx is None or status == REASM_IN_PROGRESS:
        return
    ctx.statsd.increment_per_msgdir(msg_dir or 'air2gnd',
                                    f'miam.reasm.{status}')


def _int_field(text: str, a: int, b: int) -> int | None:
    return int(text[a:b]) if text[a:b].isdigit() else None


def parse(label: str, text: str, raw: bytes,
          msg_dir: str | None = None, ctx=None,
          reg: str = '') -> ProtoNode | None:
    """Decode a MIAM ACARS-CF frame (label 'MA')."""
    if label != 'MA' or not text:
        return None
    fid = text[0]
    ftype = FRAME_IDS.get(fid)
    if ftype is None:
        return None
    data: dict = {'frame_id': fid, 'frame_type': ftype}
    node = ProtoNode('miam', data)
    node.text_formatter = _fmt
    node.json_formatter = _js
    body = raw[1:] if len(raw) > 1 else text[1:].encode('latin-1')
    data['body_len'] = len(body)
    if fid == 'T' and len(body) >= 2:
        _parse_core_body(data, node, body, text[3:] if len(text) > 3 else '',
                         msg_dir, ctx)
    elif fid == 'F':
        # File Transfer Request: file id (3 digits) + file size (6 digits)
        data['file_id'] = _int_field(text, 1, 4)
        data['file_size'] = _int_field(text, 4, 10)
        if ctx is not None and data['file_id'] is not None \
                and data['file_size'] is not None:
            st = _miam_reasm(ctx).request(msg_dir or '', reg,
                                          data['file_id'],
                                          data['file_size'])
            data['reasm_status'] = st
            _count(ctx, msg_dir, st)
        elif ctx is not None:
            data['reasm_status'] = REASM_INVALID
            _count(ctx, msg_dir, REASM_INVALID)
    elif fid == 'K':
        # File Transfer Accept: file id + segment size
        data['file_id'] = _int_field(text, 1, 4)
        data['segment_size'] = _int_field(text, 4, 7)
    elif fid == 'S':
        # File Segment: file id (3) + segment id (3) + segment data
        data['file_id'] = _int_field(text, 1, 4)
        data['segment_id'] = _int_field(text, 4, 7)
        seg = body[6:]
        data['segment_len'] = len(seg)
        if ctx is not None and data['file_id'] is not None \
                and data['segment_id'] is not None:
            st, blob = _miam_reasm(ctx).segment(
                msg_dir or '', reg, data['file_id'], data['segment_id'],
                bytes(seg))
            data['reasm_status'] = st
            _count(ctx, msg_dir, st)
            if st == REASM_COMPLETE and len(blob) >= 2:
                data['assembled_len'] = len(blob)
                _parse_core_body(
                    data, node, blob,
                    ''.join(chr(b & 0x7F) for b in blob[2:]), msg_dir, ctx)
        elif ctx is not None:
            data['reasm_status'] = REASM_INVALID
            _count(ctx, msg_dir, REASM_INVALID)
    elif fid == 'A':
        data['file_id'] = _int_field(text, 1, 4)
        r = _int_field(text, 4, 5)
        if r is not None:
            data['reason'] = ABORT_REASONS.get(r, f'unknown ({r})')
        if ctx is not None and data['file_id'] is not None:
            data['transfer_dropped'] = _miam_reasm(ctx).abort(
                msg_dir or '', reg, data['file_id'])
    elif fid in 'XY':
        arg = text[1:4]
        data['file_id'] = 'ALL' if arg.startswith('ALL') \
            else _int_field(text, 1, 4)
    data['payload_hex'] = bytes(b & 0xFF for b in body).hex()
    return node


def _fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
    d = n.data
    iprintf(lines, indent, f"MIAM ACARS CF frame: {d['frame_type']}")
    indent += 1
    for key, lbl in (('file_id', 'File ID'), ('file_size', 'File size'),
                     ('segment_id', 'Segment ID'),
                     ('segment_size', 'Segment size'),
                     ('segment_len', 'Segment bytes'),
                     ('reason', 'Reason'),
                     ('assembled_len', 'Assembled file bytes')):
        if d.get(key) is not None:
            iprintf(lines, indent, f'{lbl}: {d[key]}')
    if d.get('reasm_status'):
        iprintf(lines, indent, f"Reassembly: {d['reasm_status']}")
    core = d.get('core')
    if core:
        iprintf(lines, indent, 'MIAM CORE PDU (header fields best-effort):')
        if 'version' in core:
            iprintf(lines, indent + 1, f"Version: {core['version']}")
        if 'pdu_type' in core:
            iprintf(lines, indent + 1, f"PDU type: {core['pdu_type']}")
        iprintf(lines, indent + 1, f"Compression: {core['compression']}")
        if 'decompressed_len' in core:
            iprintf(lines, indent + 1,
                    f"Decompressed: {core['decompressed_len']} bytes "
                    f"({core.get('app', '?')})")
        if 'app_text' in core:
            first, *rest = core['app_text'].split('\n')
            iprintf(lines, indent + 1, f"Text: {first}")
            for ln in rest:
                iprintf(lines, indent + 2, ln)
        if 'app_hex' in core:
            iprintf(lines, indent + 1, f"Data: {core['app_hex'][:64]}"
                    f"{'...' if core['decompressed_len'] > 32 else ''}")
        if core.get('app') == 'ACARS message':
            iprintf(lines, indent + 1, 'Embedded ACARS message:')
    else:
        iprintf(lines, indent, f"Payload ({d['body_len']} bytes): "
                f"{d['payload_hex'][:64]}{'...' if d['body_len'] > 32 else ''}")


def _js(n: ProtoNode) -> dict:
    return {k: v for k, v in n.data.items() if k != 'payload_hex'} \
        if 'core' in n.data else dict(n.data)
