"""receiver.host_ms_per_stream_s (ms/s): host wall inside the receiver's
calls (process_packed or process: ingest hand-off, channelizer or
superstep, demod step, event collection, with the waits on the device
inside them) over the traced window, per second of capture consumed."""


def read(w):
    if not w.spans.receiver or w.stream_s <= 0:
        return None
    return sum(e - s for s, e, _ in w.spans.receiver) / 1e6 / w.stream_s
