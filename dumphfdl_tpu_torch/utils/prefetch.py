"""Host->device transfer/compute overlap.

Counterpart of ``dumphfdl_tpu/utils/prefetch.py``.  While the card works
on block N a background thread uploads block N+1 (through pinned memory,
with a non-blocking copy), so the steady-state block period is
max(transfer, compute) instead of their sum.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections.abc import Callable, Iterable, Iterator

import torch

from . import profiling


def ahead(items: Iterable, put: Callable, depth: int = 2,
          name: str = 'prefetch') -> Iterator:
    """Yield put(item) for each item; a daemon thread runs `depth` items
    ahead of the consumer (the bounded queue is backpressure on the
    producer).  An exception in the producer or in put surfaces in the
    consumer.  Spans (utils/profiling): put on the worker thread
    ('ingest.upload', with the samples of a tensor put returns) and the
    consumer's wait for an item ('ingest.wait'), each with the item's
    index."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for k, item in enumerate(items):
                sp = profiling.begin('ingest.upload', k)
                out = put(item)
                if sp is not None:
                    profiling.end(sp, _samples(out))
                q.put(out)
        except BaseException as e:          # surface errors to the consumer
            q.put((sentinel, e))
            return
        q.put((sentinel, None))

    threading.Thread(target=worker, daemon=True, name=name).start()
    for k in itertools.count():
        sp = profiling.begin('ingest.wait', k)
        item = q.get()
        profiling.end(sp)
        if isinstance(item, tuple) and len(item) == 2 and item[0] is sentinel:
            if item[1] is not None:
                raise item[1]
            return
        yield item


def _samples(out) -> int:
    """Complex samples in what an upload returns: a complex tensor, or the
    interleaved I/Q pairs of a native-width one; 0 for anything else."""
    if not isinstance(out, torch.Tensor):
        return 0
    return out.numel() if out.is_complex() else out.numel() // 2


def device_prefetch(blocks: Iterable, device, depth: int = 2,
                    packed: bool = True) -> Iterator:
    """Yield complex64 tensors on `device` for an iterable of host complex
    blocks, `depth` transfers ahead of the consumer.  packed=True uploads
    int16 pairs (half the bytes; io/ingest.put_quantized), for inputs
    normalized to [-1, 1]."""
    from ..io import ingest
    if packed:
        put = lambda b: ingest.put_quantized(b, device)
    else:
        put = lambda b: ingest.upload(b, 'CF32', device)
    return ahead(blocks, put, depth)
