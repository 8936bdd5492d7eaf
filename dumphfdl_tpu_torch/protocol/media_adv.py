# Copy of dumphfdl_tpu/protocol/media_adv.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Media Advisory (ACARS label SA) decoder.

Aircraft report datalink media availability changes with label-SA
messages.  The reference gets this decode from libacars
(la_media_adv_parse, reached via la_acars_parse_and_reassemble at
reference src/acars.c:33); reimplemented here from the public
message format:

  <version><state><current link><HHMMSS><available links...>[/<text>]

  version  '0' (the only defined version)
  state    'E' = link established, 'L' = link lost
  link     single-letter media code (table below)
  HHMMSS   UTC time of the event
  then the codes of all currently available links, optionally followed
  by '/' and free text.
"""

from __future__ import annotations

from .tree import ProtoNode, iprintf

LINK_NAMES = {
    'V': 'VHF ACARS',
    'S': 'Default SATCOM',
    'H': 'HF',
    'G': 'Global Star SATCOM',
    'C': 'ICO SATCOM',
    '2': 'VDL Mode 2',
    'X': 'Inmarsat Aero',
    'I': 'Iridium SATCOM',
}

_STATES = {'E': 'established', 'L': 'lost'}


def parse(label: str, text: str) -> ProtoNode | None:
    """Parse a label-SA Media Advisory; None when it doesn't match."""
    if label != 'SA' or len(text) < 9:
        return None
    version, state, link = text[0], text[1], text[2]
    hhmmss = text[3:9]
    if state not in _STATES or not hhmmss.isdigit():
        return None
    hour, minute, second = (int(hhmmss[0:2]), int(hhmmss[2:4]),
                            int(hhmmss[4:6]))
    if hour > 23 or minute > 59 or second > 59:
        return None
    rest = text[9:]
    avail, _, free_text = rest.partition('/')
    links = [{'code': c, 'name': LINK_NAMES.get(c, 'unknown')}
             for c in avail]
    node = ProtoNode('media_adv', {
        'version': version,
        'state': _STATES[state],
        'current_link': {'code': link,
                         'name': LINK_NAMES.get(link, 'unknown')},
        'hour': hour, 'minute': minute, 'second': second,
        'available_links': links,
        'text': free_text,
    })

    def fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
        d = n.data
        iprintf(lines, indent, 'Media Advisory:')
        indent += 1
        iprintf(lines, indent,
                f"Version: {d['version']}")
        cl = d['current_link']
        iprintf(lines, indent,
                f"Link {cl['name']} ({cl['code']}) {d['state']} at "
                f"{d['hour']:02d}:{d['minute']:02d}:{d['second']:02d}")
        if d['available_links']:
            iprintf(lines, indent, 'Available links:')
            for l in d['available_links']:
                iprintf(lines, indent + 1, f"{l['name']} ({l['code']})")
        if d['text']:
            iprintf(lines, indent, f"Text: {d['text']}")

    def js(n: ProtoNode) -> dict:
        return dict(n.data)

    node.text_formatter = fmt
    node.json_formatter = js
    return node
