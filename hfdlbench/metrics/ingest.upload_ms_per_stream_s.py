"""ingest.upload_ms_per_stream_s (ms/s): host wall of the program's
'ingest.upload' spans (utils/prefetch.ahead's worker:
SuperstepEngine.upload, or io/ingest.upload's pinned staging, copy and
conversion; the upload thread) inside the traced window, per second of
capture consumed there.

Read from the program's span recorder (dumphfdl_tpu_torch.utils.profiling,
which records while the run's profiler is on), taken from the modules the
run has loaded: a program without it reads nothing."""

import sys

RECORDER = 'dumphfdl_tpu_torch.utils.profiling'


def read(w):
    spans = getattr(sys.modules.get(RECORDER), 'spans', None)
    if spans is None or w.stream_s <= 0:
        return None
    got = [s for s in spans(w.t0, w.t1) if s.name == 'ingest.upload']
    if not got:
        return None
    return sum(min(s.end, w.t1) - max(s.start, w.t0)
               for s in got) / 1e6 / w.stream_s
