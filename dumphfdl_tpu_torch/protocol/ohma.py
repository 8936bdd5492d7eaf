# Copy of dumphfdl_tpu/protocol/ohma.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""OHMA message decoder (B737MAX maintenance/diagnostic downlinks).

Reimplements the libacars OHMA subset the reference gets for free
(reference README.md:713: "OHMA messages ... contain JSON data",
rendered by libacars >= 2.2; --prettify-json reformats the payload).

Wire format: an ACARS text body beginning with the literal "OHMA"
followed by base64: the decoded bytes are a zlib (RFC 1950) stream
whose inflation yields a JSON document.  Decode failures degrade
gracefully to the raw text (never an exception into the ACARS parser).
"""

from __future__ import annotations

import base64
import json
import zlib

from .tree import ProtoNode, iprintf


def parse(text: str, ctx=None) -> ProtoNode | None:
    """Decode an 'OHMA...' ACARS text body; None when not OHMA."""
    if not text.startswith('OHMA'):
        return None
    data: dict = {'ok': False, 'raw': text[4:]}
    node = ProtoNode('ohma', data)
    node.text_formatter = lambda n, lines, ind: _fmt(n, lines, ind, ctx)
    node.json_formatter = _js
    try:
        comp = base64.b64decode(text[4:], validate=False)
        plain = zlib.decompress(comp)
        doc = json.loads(plain)
    except Exception as e:
        data['error'] = f'{type(e).__name__}: {e}'
        return node
    data['ok'] = True
    data['json'] = doc
    return node


def _fmt(n: ProtoNode, lines: list[str], indent: int, ctx) -> None:
    d = n.data
    iprintf(lines, indent, 'OHMA message:')
    if not d['ok']:
        iprintf(lines, indent + 1,
                f"-- Unparseable OHMA payload ({d.get('error', '?')})")
        return
    pretty = getattr(getattr(ctx, 'options', None), 'prettify_json', False)
    text = json.dumps(d['json'], indent=2 if pretty else None,
                      separators=None if pretty else (',', ':'))
    for line in text.split('\n'):
        iprintf(lines, indent + 1, line)


def _js(n: ProtoNode) -> dict:
    d = n.data
    if not d['ok']:
        return {'err': True, 'raw': d['raw']}
    return {'msg': d['json']}
