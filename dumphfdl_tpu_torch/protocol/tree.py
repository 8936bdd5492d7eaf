# Copy of dumphfdl_tpu/protocol/tree.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Protocol tree: host-side analogue of libacars' la_proto_node.

Every parsed layer is a ProtoNode with a json_key, a dict payload, and an
optional child; formatters walk the chain producing indented text or a
nested JSON object, mirroring la_proto_tree_format_text /
la_proto_tree_format_json semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class ProtoNode:
    json_key: str
    data: dict[str, Any] = dataclasses.field(default_factory=dict)
    next: 'ProtoNode | None' = None
    text_formatter: 'Callable[[ProtoNode, list[str], int], None] | None' = None
    json_formatter: 'Callable[[ProtoNode], dict] | None' = None

    def find(self, json_key: str) -> 'ProtoNode | None':
        node = self
        while node is not None:
            if node.json_key == json_key:
                return node
            node = node.next
        return None

    def format_text(self, indent: int = 0) -> str:
        lines: list[str] = []
        node = self
        while node is not None:
            if node.text_formatter is not None:
                node.text_formatter(node, lines, indent)
            else:
                iprintf(lines, indent, f'{node.json_key}: {node.data}')
            indent += 1
            node = node.next
        return ''.join(lines)

    def to_json(self) -> dict:
        if self.json_formatter:
            obj = self.json_formatter(self)
        else:
            obj = {k: (v.hex() if isinstance(v, (bytes, bytearray)) else v)
                   for k, v in self.data.items()}
        if self.next is not None:
            obj[self.next.json_key] = self.next.to_json()
        return obj

    def tree_json(self) -> dict:
        """Nested {json_key: {...}} including children."""
        return {self.json_key: self.to_json()}


def iprintf(lines: list[str], indent: int, text: str) -> None:
    for ln in text.split('\n'):
        lines.append(' ' * indent + ln + '\n')


def hexdump_lines(data: bytes, indent: int) -> list[str]:
    """Hexdump in the reference's util.c:126 style (offset: hex |ascii|)."""
    out = []
    for off in range(0, len(data), 16):
        chunk = data[off:off + 16]
        hexpart = ' '.join(f'{b:02x}' for b in chunk)
        asciipart = ''.join(chr(b) if 32 <= b < 127 else '.' for b in chunk)
        out.append(' ' * indent + f'{off:05x}: {hexpart:<48} |{asciipart:<16}|\n')
    return out


def unknown_proto_node(data: bytes) -> ProtoNode:
    """Equivalent of libacars' unknown_proto_pdu_new: raw hexdump leaf."""
    node = ProtoNode('unknown_proto', {'data': data.hex()})

    def fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
        iprintf(lines, indent, '-- Unknown protocol')
        lines.extend(hexdump_lines(bytes.fromhex(n.data['data']), indent + 1))

    node.text_formatter = fmt
    return node
