"""The exact ledger: decoded frames against the frames that were sent.

Every frame the traffic put on the air is one (channel, global slot) cell
(global slot = loop * slots + slot), and must be decoded exactly once with
the emitted PDU's bytes.  A decoded frame goes to the slot its start falls
in, by the tracker's symbol clock (``FrameEvent.start_symbol``, less the
superstep's one-block delay), and must start within START_SLACK symbols of
the frame sent there.

Nothing else may come out (limit 0 each): an FCS-valid frame that is not
the one sent on that channel in that slot is `other`; an FCS-failing frame
is `junk`, unless it is an image by the port's alias rule
(``tools/alias.py``, copied): on a channel carrying no frame then, one or
two channels from an emitter whose frame was decoded, of that frame's mode
and starting within ALIAS_WINDOW symbols of it.  Images are counted apart.
"""

from __future__ import annotations

import dataclasses

from . import tx

IMAGE_STEPS = (1, 2)
ALIAS_WINDOW = 64           # symbols around the emitter's frame start
START_SLACK = 200           # symbols


@dataclasses.dataclass
class Decoded:
    """One frame as the program handed it to the app."""
    channel: int
    mode: int
    start_symbol: int           # on the stream's symbol clock
    pdu: bytes
    fcs_ok: bool
    t_handled: float = 0.0      # perf_counter when it reached the app
    t_wall: int = 0             # wall clock ns then, while tracing


def by_channel(emissions) -> dict:
    """channel -> {slot of the loop: its tx.Emission}."""
    out: dict = {}
    for e in emissions:
        out.setdefault(e.channel, {})[e.slot] = e
    return out


def expected_start(e: tx.Emission, g: int, slots: int) -> float:
    """Stream symbol where emission e starts in global slot g."""
    return (g - e.slot) * tx.SLOT_SYMBOLS + e.start_symbol \
        if g % slots == e.slot else float('nan')


def settle(decoded: list[Decoded], emissions, slots: int, loops: int
           ) -> dict:
    """The ledger over `loops` whole loops of the capture: cells (channel,
    global slot) -> the decoded frames in them, and the counts compared."""
    sent = by_channel(emissions)
    cells: dict = {}
    other, failing, heard = [], [], {}
    for d in decoded:
        if not d.fcs_ok:
            failing.append(d)           # judged once every emitter is heard
            continue
        g = round(d.start_symbol / tx.SLOT_SYMBOLS)
        e = sent.get(d.channel, {}).get(g % slots)
        if (e is None or not 0 <= g < loops * slots
                or abs(d.start_symbol - expected_start(e, g, slots))
                > START_SLACK
                or d.mode != e.mode or d.pdu[:len(e.pdu)] != e.pdu):
            other.append([d.channel, d.mode, d.start_symbol,
                          d.pdu[:12].hex()])
            continue
        cells.setdefault((d.channel, g), []).append(d)
        heard.setdefault(d.channel, []).append((d.start_symbol, d.mode))
    alias_at, junk_at = [], []
    for d in failing:
        where = [d.channel, d.mode, d.start_symbol]
        g = round(d.start_symbol / tx.SLOT_SYMBOLS)
        near = [] if g % slots in sent.get(d.channel, {}) else [
            h for step in IMAGE_STEPS
            for c in (d.channel - step, d.channel + step)
            for h in heard.get(c, ())]
        if any(abs(d.start_symbol - s0) <= ALIAS_WINDOW and d.mode == m0
               for s0, m0 in near):
            alias_at.append(where)
        else:
            junk_at.append(where)
    missing = [[e.channel, k * slots + e.slot] for e in emissions
               for k in range(loops)
               if (e.channel, k * slots + e.slot) not in cells]
    dup = sum(len(v) - 1 for v in cells.values())
    offs = [d.start_symbol - expected_start(sent[c][g % slots], g, slots)
            for (c, g), ds in cells.items() for d in ds]
    return dict(cells=cells, missing=missing, duplicate=dup, other=other,
                junk_at=junk_at, alias_at=alias_at,
                expected=loops * len(emissions),
                start_offsets=[min(offs), max(offs)] if offs else [])
