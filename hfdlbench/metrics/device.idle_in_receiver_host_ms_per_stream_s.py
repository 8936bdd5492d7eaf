"""device.idle_in_receiver_host_ms_per_stream_s (ms/s): the traced
window's device idle time (the window less the union of the device's
kernel, copy and set intervals) that falls inside the program's 'rx.step'
spans and outside the 'rx.sync' spans within them: how long the card waits
on the receiver's own host code, per second of capture consumed there.

The spans come from the program's span recorder
(dumphfdl_tpu_torch.utils.profiling, which records while the run's
profiler is on, on the clock of the device trace), taken from the modules
the run has loaded: a program without it reads nothing."""

import bisect
import sys

from hfdlbench import trace

RECORDER = 'dumphfdl_tpu_torch.utils.profiling'


def host_intervals(got, t0: int, t1: int) -> list:
    """[start, end) of the rx.step spans, clipped to [t0, t1), less the
    rx.sync spans of the same thread inside them."""
    syncs = sorted((s.start, s.end, s.tid) for s in got
                   if s.name == 'rx.sync')
    out = []
    for st in (s for s in got if s.name == 'rx.step'):
        cur, stop = max(st.start, t0), min(st.end, t1)
        for a, b, tid in syncs:
            if tid != st.tid or b <= cur or a >= stop:
                continue
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if cur < stop:
            out.append((cur, stop))
    return out


def read(w):
    spans = getattr(sys.modules.get(RECORDER), 'spans', None)
    if spans is None or w.stream_s <= 0:
        return None
    host = host_intervals(spans(w.t0, w.t1), w.t0, w.t1)
    if not host:
        return None
    busy = trace.union((s, e) for _, s, e in w.device)
    starts = [s for s, _ in busy]
    idle = 0
    for a, b in host:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        covered = 0
        while i < len(busy) and busy[i][0] < b:
            covered += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        idle += b - a - covered
    return idle / 1e6 / w.stream_s
