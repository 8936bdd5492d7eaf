"""What the traced window holds: the harness's host spans and the device's
intervals from ``torch.profiler``, and the arithmetic over them.

Spans are recorded by the harness around its calls into the program
(``Spans``); device intervals come from the profiler's kineto events, whose
clock is the wall clock in nanoseconds.  The union of device intervals and
the time by kernel kind are the port's ``utils/profiling.device_profile``
arithmetic, copied; the kinds are its KINDS.
"""

from __future__ import annotations

import dataclasses
import time

# kernel kinds by a key in the kernel's name; the first key that matches
# names the kind
KINDS = (('viterbi27_kernel', 'K1 Viterbi'), ('tracker_kernel', 'K2 tracker'),
         ('memcpy', 'memcpy/memset'), ('memset', 'memcpy/memset'),
         ('fft', 'cuFFT'), ('index', 'gather/index'),
         ('gather', 'gather/index'), ('scan', 'scan'), ('sort', 'sort'),
         ('reduce', 'reduce'), ('cat', 'cat/copy'), ('copy', 'cat/copy'),
         ('elementwise', 'elementwise'))


def kind_of(name: str) -> str:
    n = name.lower()
    return next((k for key, k in KINDS if key in n), 'other')


@dataclasses.dataclass
class Spans:
    """Host spans of the main thread, on the wall clock in ns: receiver
    calls (start, end, stream samples consumed) and app.handle_events
    calls (start, end, frames handled)."""
    receiver: list = dataclasses.field(default_factory=list)
    handle: list = dataclasses.field(default_factory=list)
    on: bool = False
    _off: int = 0

    def start(self) -> None:
        self._off = time.time_ns() - time.perf_counter_ns()
        self.on = True

    def now(self) -> int:
        return time.perf_counter_ns() + self._off


@dataclasses.dataclass
class Window:
    """The traced window and what the readers take from it."""
    t0: int                     # wall clock ns
    t1: int
    samples: int                # stream samples the receiver consumed
    fs: int
    spans: Spans
    device: list                # (name, start ns, end ns), clipped
    frames: list                # (channel, mode) of frames handled
    power_limit_w: float | None = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def stream_s(self) -> float:
        return self.samples / self.fs

    def kernel_s(self, key: str) -> float:
        """Summed device time of the kernels whose name holds key."""
        return sum(e - s for n, s, e in self.device if key in n) / 1e9


def device_events(prof, t0: int, t1: int) -> tuple[list, dict]:
    """(name, start, end) of every device operation (kernel, copy, set)
    of a stopped profiler, clipped to [t0, t1), and how many there were
    before clipping and how far they reach beyond the window (s)."""
    from torch.autograd import DeviceType
    out, n, lo, hi = [], 0, None, None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns()
        end = s + e.duration_ns()
        n += 1
        lo = s if lo is None else min(lo, s)
        hi = end if hi is None else max(hi, end)
        s, end = max(s, t0), min(end, t1)
        if end > s:
            out.append((e.name(), s, end))
    return out, dict(events=n, kept=len(out),
                     first_s=None if lo is None else (lo - t0) / 1e9,
                     last_s=None if hi is None else (hi - t1) / 1e9)


def union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(w: Window) -> float:
    return sum(e - s for s, e in union((s, e) for _, s, e in w.device)) / 1e9


def breakdown(w: Window) -> dict:
    """The device operations that took most time, by kind, and the idle
    time by what the host's main thread was doing (in a receiver call, in
    app.handle_events, or between them, waiting on the source)."""
    kinds: dict = {}
    for n, s, e in w.device:
        k = kind_of(n)
        kinds[k] = kinds.get(k, 0.0) + (e - s) / 1e9
    busy = union((s, e) for _, s, e in w.device)
    gaps, cur = [], w.t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w.t1:
        gaps.append((cur, w.t1))
    host = sorted([(s, e, 'receiver_call') for s, e, _ in w.spans.receiver]
                  + [(s, e, 'handle_events') for s, e, _ in w.spans.handle])
    idle: dict = {}
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(host) and host[j][1] <= g0:
            j += 1
        k = j
        while k < len(host) and host[k][0] < g1:
            s, e, label = host[k]
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                idle[label] = idle.get(label, 0.0) + ov / 1e9
                covered += ov
            k += 1
        if g1 - g0 > covered:
            idle['source_wait'] = idle.get('source_wait', 0.0) \
                + (g1 - g0 - covered) / 1e9
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(device_ops=top(kinds), idle_gaps=top(idle))
