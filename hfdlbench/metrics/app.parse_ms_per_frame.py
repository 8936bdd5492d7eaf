"""app.parse_ms_per_frame (ms): host wall of the program's 'app.parse' spans
(protocol/pdu.parse_pdu in HfdlApp.handle_events, one a frame) that begin
in the traced window, per frame.

Read from the program's span recorder (dumphfdl_tpu_torch.utils.profiling,
which records while the run's profiler is on), taken from the modules the
run has loaded: a program without it reads nothing."""

import sys

RECORDER = 'dumphfdl_tpu_torch.utils.profiling'


def read(w):
    spans = getattr(sys.modules.get(RECORDER), 'spans', None)
    if spans is None:
        return None
    got = [s.end - s.start for s in spans(w.t0, w.t1)
           if s.name == 'app.parse' and s.start >= w.t0]
    if not got:
        return None
    return sum(got) / 1e6 / len(got)
