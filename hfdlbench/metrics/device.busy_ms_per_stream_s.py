"""device.busy_ms_per_stream_s (ms/s): the union of device intervals in
the traced window, per second of capture the receiver consumed there."""

from hfdlbench import trace


def read(w):
    if w.stream_s <= 0:
        return None
    return trace.busy_s(w) * 1e3 / w.stream_s
