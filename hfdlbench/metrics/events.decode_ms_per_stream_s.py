"""events.decode_ms_per_stream_s (ms/s): self time of the program's
'events.collect' spans (ChannelBank._collect_events: the event table's
decode into frames on the host, the event decode's launches and the bit
unpacking), their 'rx.sync' children (waits on the card) taken out,
inside the traced window, per second of capture consumed there.

Read from the program's span recorder (dumphfdl_tpu_torch.utils.profiling,
which records while the run's profiler is on), taken from the modules the
run has loaded: a program without it reads nothing."""

import sys

RECORDER = 'dumphfdl_tpu_torch.utils.profiling'


def read(w):
    spans = getattr(sys.modules.get(RECORDER), 'spans', None)
    if spans is None or w.stream_s <= 0:
        return None
    got = spans(w.t0, w.t1)
    collect = {s.id for s in got if s.name == 'events.collect'}
    if not collect:
        return None
    clipped = lambda s: min(s.end, w.t1) - max(s.start, w.t0)
    own = sum(clipped(s) for s in got if s.id in collect) \
        - sum(clipped(s) for s in got
              if s.name == 'rx.sync' and s.parent in collect)
    return own / 1e6 / w.stream_s
