"""device.idle_share (%): the traced window's wall less the union of the
device's kernel, copy and set intervals, over the wall."""

from hfdlbench import trace


def read(w):
    if w.seconds <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(w) / w.seconds)
