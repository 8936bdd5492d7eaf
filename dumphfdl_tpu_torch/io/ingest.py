"""Offline ingest: fixed-size raw chunks from a file, converted on the host
and uploaded to the device one chunk ahead of the consumer.

Counterpart of the file path of ``dumphfdl_tpu/io/ingest.py``
(``file_chunks`` and ``uploaded_stream``); live ingest over the native
ring is not ported.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from . import formats


def file_chunks(fh, fmt: str, chunk_bytes: int,
                stop: threading.Event | None = None) -> Iterator[np.ndarray]:
    """Read fixed-size raw chunks, accumulating short reads so pipes
    deliver full blocks like the reference's blocking fread
    (input-file.c:35-52); the final chunk may be shorter."""
    bps = formats.bytes_per_sample(fmt)
    chunk_bytes = max(bps, chunk_bytes - chunk_bytes % bps)
    pending = b''
    eof = False
    while not eof and not (stop is not None and stop.is_set()):
        while len(pending) < chunk_bytes:
            data = fh.read(chunk_bytes - len(pending))
            if not data:
                eof = True
                break
            pending += data
        emit = pending[:len(pending) - len(pending) % bps]
        pending = pending[len(emit):]
        if emit:
            yield np.frombuffer(emit, dtype=np.uint8)


def upload(raw, fmt: str, device) -> torch.Tensor:
    """Raw sample bytes -> complex64 tensor on device (converted on the
    host by the JAX package's format converters, io/formats.py)."""
    x = formats.convert(raw, fmt)
    if device.type == 'cuda':
        return torch.from_numpy(x).pin_memory().to(device, non_blocking=True)
    return torch.from_numpy(x).to(device)


def uploaded_stream(raw_iter: Iterable, fmt: str, device,
                    depth: int = 2) -> Iterator[torch.Tensor]:
    """Yield device complex64 chunks for an iterable of raw host chunks; a
    daemon thread converts and uploads `depth` chunks ahead of the
    consumer (the bounded queue is backpressure on the reader)."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for raw in raw_iter:
                q.put(upload(raw, fmt, device))
        except BaseException as e:          # surface errors to the consumer
            q.put((sentinel, e))
            return
        q.put((sentinel, None))

    threading.Thread(target=worker, daemon=True, name='ingest-upload').start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and item[0] is sentinel:
            if item[1] is not None:
                raise item[1]
            return
        yield item
