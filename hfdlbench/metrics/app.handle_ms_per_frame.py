"""app.handle_ms_per_frame (ms): host wall inside app.handle_events over
the traced window, per decoded frame handed to it (protocol parse, output
formatting and queueing)."""


def read(w):
    frames = sum(n for _, _, n in w.spans.handle)
    if not frames:
        return None
    return sum(e - s for s, e, _ in w.spans.handle) / 1e6 / frames
