"""torch.profiler plumbing shared by the CLI's --profile and the scripts
that read a profiled pass (chip_smoke.py), and the program's host spans.

``profiler(device)`` traces host operations and, for a CUDA device, the
card's kernels and copies; ``export`` writes the Chrome trace --profile
promises, the host spans with it; ``device_profile`` sums a finished
trace's device time.

Host spans (``begin``/``end``, read with ``spans``) time the program's own
work where it happens: ingest, the receiver's launch, its waits on the
card, event decode, protocol and output.  They are recorded exactly while
a torch profiler runs in the process, on any thread: torch sets
``torch.autograd.profiler._is_profiler_enabled`` when a profiler starts and
clears it when it stops.  Off, a site costs a call and that one flag read.
Their times are the clock of the profiler's kineto events (Unix-epoch
nanoseconds): ``time.perf_counter_ns()`` plus one offset to the wall clock,
taken when the first span after a ``clear()`` opens.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_NAME = 'dumphfdl_trace.json'

# kernel kinds of a profiled pass, by a key in the kernel's name (the first
# key that matches names the kind)
KINDS = (('viterbi27_kernel', 'K1 Viterbi'), ('tracker_kernel', 'K2 tracker'),
         ('memcpy', 'memcpy/memset'), ('memset', 'memcpy/memset'),
         ('fft', 'cuFFT'), ('index', 'gather/index'),
         ('gather', 'gather/index'), ('scan', 'scan'), ('sort', 'sort'),
         ('reduce', 'reduce'), ('cat', 'cat/copy'), ('copy', 'cat/copy'),
         ('elementwise', 'elementwise'))

# spans kept in memory, past which they are counted as dropped: about a
# minute of profiled decoding at 3,700 spans a second
SPAN_LIMIT = 1 << 18


def profiler(device) -> torch.profiler.profile:
    """A profiler of host activity and, on a CUDA device, of the card's."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def export(prof: torch.profiler.profile, directory: str) -> str:
    """Write a stopped profiler's Chrome trace under directory (made if
    missing), with the recorded host spans as complete events on their
    threads' rows; returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TRACE_NAME)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    trace['traceEvents'].extend(_chrome_events(
        spans(), trace.get('baseTimeNanoseconds', 0), trace['traceEvents']))
    with open(path, 'w') as fh:
        json.dump(trace, fh)
    return path


def _chrome_events(recorded: list, base_ns: int, existing: list) -> list:
    """Spans as Chrome-trace complete events of this process (ts and dur in
    microseconds from base_ns, the trace's own base), with a name for each
    thread row the existing events do not name."""
    pid = os.getpid()
    named = {e.get('tid') for e in existing if e.get('ph') == 'M'
             and e.get('name') == 'thread_name' and e.get('pid') == pid}
    out = []
    for tid, thread in sorted({(s.tid, s.thread) for s in recorded}):
        if tid not in named:
            out.append({'ph': 'M', 'name': 'thread_name', 'pid': pid,
                        'tid': tid, 'args': {'name': thread}})
    for s in recorded:
        out.append({'ph': 'X', 'cat': 'dumphfdl_span', 'name': s.name,
                    'pid': pid, 'tid': s.tid, 'ts': (s.start - base_ns) / 1e3,
                    'dur': (s.end - s.start) / 1e3,
                    'args': {'block': s.block, 'n': s.n, 'id': s.id,
                             'parent': s.parent}})
    return out


def device_profile(prof: torch.profiler.profile, wall_s: float) -> dict:
    """Device time of a torch.profiler run: busy milliseconds (the union of
    the device intervals), busy share of wall_s, and time by kernel kind."""
    from torch.autograd import DeviceType
    spans, kinds = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        n = e.name.lower()
        kind = next((k for key, k in KINDS if key in n), 'other')
        ms, cnt = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + (t1 - t0) / 1e3, cnt + 1)
    busy_us, end = 0.0, float('-inf')
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return dict(device_events=len(spans), busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e6 / wall_s,
                by_kind={k: [ms, cnt] for k, (ms, cnt) in
                         sorted(kinds.items(), key=lambda kv: -kv[1][0])})


# ---- host spans ----

class Span(NamedTuple):
    """One recorded span of host work."""
    name: str
    thread: str             # name of the thread that ran it
    start: int              # ns on the device trace's clock (Unix epoch)
    end: int
    parent: int | None      # id of the enclosing open span on that thread
    block: int              # super-block or chunk it belongs to, -1 none
    n: int                  # work done: samples, bytes or frames
    id: int
    tid: int                # the thread's native id (its trace row)


class SpanRecorder:
    """Bounded store of finished spans and each thread's open ones.  An
    open span is a list [name, block, n, id, parent, stack, who, start];
    the store keeps perf_counter times, spans() adds the offset.  The hot
    path is plain lists and tuples, and only a full store takes the lock
    (an append is atomic), so the bound may be passed by a span or two
    when threads race: a span costs 1.6 us of a quiet thread, several
    where another thread contends for the interpreter."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self.limit = limit
        self.dropped = 0
        self._done: list[tuple] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._local = threading.local()
        self._offset: int | None = None

    def begin(self, name: str, block: int = -1, n: int = 0) -> list | None:
        """Open a span on this thread while a profiler runs; None otherwise
        (no clock read, nothing allocated).  Hand the result to end()."""
        if not _autograd_profiler._is_profiler_enabled:
            return None
        try:
            stack, who = self._local.state
        except AttributeError:
            stack, who = self._local.state = ([], (
                threading.current_thread().name, threading.get_native_id()))
        if self._offset is None:
            self._offset = time.time_ns() - time.perf_counter_ns()
        sp = [name, block, n, next(self._ids),
              stack[-1][3] if stack else None, stack, who, 0]
        stack.append(sp)
        sp[7] = time.perf_counter_ns()
        return sp

    def end(self, sp: list | None, n: int | None = None) -> None:
        """Close a span begin() opened (n, if given, replaces its count)."""
        if sp is None:
            return
        t = time.perf_counter_ns()
        stack = sp[5]
        if stack and stack[-1] is sp:
            stack.pop()
        elif any(o is sp for o in stack):   # children left open by a raise
            del stack[next(i for i, o in enumerate(stack) if o is sp):]
        done = self._done
        if len(done) < self.limit:
            done.append((sp[0], sp[6], sp[7], t, sp[4], sp[1],
                         sp[2] if n is None else n, sp[3]))
        else:
            with self._lock:
                self.dropped += 1

    def spans(self, t0: int | None, t1: int | None) -> list[Span]:
        done, off = list(self._done), self._offset
        if off is None:             # a span open across a clear()
            off = self._offset = time.time_ns() - time.perf_counter_ns()
        out = []
        for name, (thread, tid), start, end, parent, block, n, i in done:
            start, end = start + off, end + off
            if (t0 is None or end > t0) and (t1 is None or start < t1):
                out.append(Span(name, thread, start, end, parent, block, n,
                                i, tid))
        return out

    def clear(self) -> None:
        with self._lock:
            self._done = []
            self.dropped = 0
            self._offset = None


RECORDER = SpanRecorder()


def begin(name: str, block: int = -1, n: int = 0) -> list | None:
    """RECORDER.begin; off, one flag read and nothing else."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return RECORDER.begin(name, block, n)


def end(sp: list | None, n: int | None = None) -> None:
    """RECORDER.end."""
    if sp is not None:
        RECORDER.end(sp, n)


def recording() -> bool:
    """True while a torch profiler runs in this process."""
    return _autograd_profiler._is_profiler_enabled


def spans(t0: int | None = None, t1: int | None = None) -> list[Span]:
    """The recorded spans that overlap [t0, t1) (ns, the device trace's
    clock), in the order they ended; all of them without bounds."""
    return RECORDER.spans(t0, t1)


def dropped() -> int:
    """Spans not kept since the last clear(): the store was full."""
    return RECORDER.dropped


def clear() -> None:
    """Forget every recorded span and the dropped count; the next span
    takes the clock's offset anew."""
    RECORDER.clear()
