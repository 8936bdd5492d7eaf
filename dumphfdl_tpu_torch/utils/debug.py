# Copy of dumphfdl_tpu/utils/debug.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Class-filtered debug logging (reference: src/util.h:17-85).

Eleven debug classes selected by name on the command line
(--debug sdr,frame,...), mirroring main.c:93-108.  Unlike the reference
this is runtime- rather than compile-time-gated.
"""

from __future__ import annotations

import sys

CLASSES = {
    'none': 0,
    'sdr': 1 << 0,
    'dsp': 1 << 1,
    'dsp_detail': 1 << 2,
    'frame': 1 << 3,
    'frame_detail': 1 << 4,
    'proto': 1 << 5,
    'proto_detail': 1 << 6,
    'stats': 1 << 7,
    'cache': 1 << 8,
    'output': 1 << 9,
    'misc': 1 << 10,
}
CLASSES['all'] = (1 << 11) - 1

_mask = 0


def set_classes(spec: str) -> None:
    """Comma-separated class list, e.g. 'dsp,frame'."""
    global _mask
    mask = 0
    for name in spec.split(','):
        name = name.strip().lower()
        if not name:
            continue
        if name not in CLASSES:
            raise ValueError(
                f'unknown debug class {name!r}; known: {", ".join(CLASSES)}')
        mask |= CLASSES[name]
    _mask = mask


def enabled(cls: str) -> bool:
    return bool(_mask & CLASSES.get(cls, 0))


def debug_print(cls: str, msg: str) -> None:
    if enabled(cls):
        print(f'[{cls}] {msg}', file=sys.stderr)
