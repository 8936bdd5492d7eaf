"""Decoupled ingest: reader thread -> ring/queue -> upload thread -> device.

Counterpart of ``dumphfdl_tpu/io/ingest.py``.  While the card works on
block N, the reader fills block N+1 and a background thread moves it to
device memory through a pinned buffer, so the steady-state block period is
max(read, transfer, compute) instead of their sum.

Raw SDR formats upload in their native width (int16 or uint8 pairs: half
or a quarter of the float-pair bytes) and convert on the device
(``convert_on_device``), bit-equal to the host converters of
``io/formats.py``.  The superstep (dsp/superstep.py) uploads with the same
functions and converts inside its step.
"""

from __future__ import annotations

import functools
import threading
import time
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from ..utils import profiling
from ..utils.prefetch import ahead
from . import formats
from .native import SampleRing

# how each format's raw bytes are viewed on the host and held on the device
RAW_DTYPES = {'CS16': torch.int16, 'CU8': torch.uint8,
              'CF32': torch.complex64}
_RAW_NUMPY = {'CS16': np.int16, 'CU8': np.uint8, 'CF32': np.complex64}
# what put_raw carries: the raw formats, and the small tables and phases
# a mesh uploads per shard
_TORCH_OF = {np.dtype(v): RAW_DTYPES[k] for k, v in _RAW_NUMPY.items()}
_TORCH_OF.update({np.dtype(np.float32): torch.float32,
                  np.dtype(np.int64): torch.int64})

_CS16_SCALE = float(np.float32(1.0) / np.float32(32767.5))
_QUANT_SCALE = float(np.float32(1.0) / np.float32(32767.0))


def as_raw_array(raw, fmt: str) -> np.ndarray:
    """Raw samples (bytes, a uint8 array, or already the format's natural
    dtype) -> a contiguous numpy array of that dtype, whole samples only."""
    fmt = fmt.upper()
    if fmt not in _RAW_NUMPY:
        raise ValueError(f'unknown sample format {fmt}')
    want = _RAW_NUMPY[fmt]
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(raw, dtype=np.uint8)
    raw = np.asarray(raw)
    if raw.dtype == want and fmt != 'CU8':
        return np.ascontiguousarray(raw)
    if raw.dtype != np.uint8:
        if fmt == 'CF32':
            return np.ascontiguousarray(raw, np.complex64)
        raise ValueError(f'{fmt} samples given as {raw.dtype}')
    bps = formats.bytes_per_sample(fmt)
    raw = np.ascontiguousarray(raw[:len(raw) - len(raw) % bps])
    return raw.view(want)


def put_raw(raw: np.ndarray, device) -> torch.Tensor:
    """A host array -> a tensor of the same dtype on device.  For a CUDA
    device the bytes pass through a pinned buffer (from PyTorch's caching
    host allocator, which holds it until the copy is done) and the copy
    does not block the calling thread."""
    device = torch.device(device)
    if device.type != 'cuda':
        return torch.from_numpy(raw.copy()).to(device)
    staged = torch.empty(raw.shape, dtype=_TORCH_OF[raw.dtype],
                         pin_memory=True)
    staged.numpy()[...] = raw
    return staged.to(device, non_blocking=True)


@functools.cache
def _cu8_table(device) -> torch.Tensor:
    """(byte - 63.5) / 127 for the 256 byte values, divided on the host:
    a division by a constant on the card is a multiply by its reciprocal
    and would differ from formats.convert in the last bit."""
    v = (np.arange(256, dtype=np.float32) - np.float32(63.5)) \
        / np.float32(127.0)
    return torch.as_tensor(v, device=device)


def convert_on_device(raw: torch.Tensor, fmt: str) -> torch.Tensor:
    """Native-width samples on the device (put_raw of as_raw_array) ->
    (n,) complex64, bit-equal to formats.convert (input-helpers.c:94-126):
    CS16 int16 pairs times 1/32767.5 as a float32 product, CU8 (byte -
    63.5) / 127 through a table, CF32 as it is."""
    fmt = fmt.upper()
    if fmt == 'CF32':
        return raw
    if fmt == 'CS16':
        v = raw.to(torch.float32) * _CS16_SCALE
    elif fmt == 'CU8':
        v = torch.index_select(_cu8_table(raw.device), 0,
                               raw.to(torch.int32))
    else:
        raise ValueError(f'unknown sample format {fmt}')
    return torch.view_as_complex(v.reshape(-1, 2))


def upload(raw, fmt: str, device) -> torch.Tensor:
    """Raw samples (bytes or the format's natural numpy dtype) -> complex64
    tensor on device; the integer formats cross in their native width and
    convert there."""
    return convert_on_device(put_raw(as_raw_array(raw, fmt), device), fmt)


def put_quantized(x: np.ndarray, device) -> torch.Tensor:
    """Upload complex samples as int16 pairs (half the bytes of the float
    pairs) and scale back on the device.  Quantizes to CS16 precision
    (about 90 dB at full scale, no worse than an SDR's CS16 format); the
    input is expected in [-1, 1] and is clipped."""
    iq = np.ascontiguousarray(x, np.complex64).view(np.float32)
    q = np.clip(np.round(iq * np.float32(32767.0)), -32768, 32767) \
        .astype(np.int16)
    v = put_raw(q, device).to(torch.float32) * _QUANT_SCALE
    return torch.view_as_complex(v.reshape(-1, 2)).reshape(np.shape(x))


def file_chunks(fh, fmt: str, chunk_bytes: int,
                stop: threading.Event | None = None,
                pad_final: bool = False) -> Iterator[np.ndarray]:
    """Read fixed-size raw chunks, accumulating short reads so pipes
    deliver full blocks like the reference's blocking fread
    (input-file.c:35-52); the final chunk may be shorter, unless
    pad_final, which silence-pads it to exactly chunk_bytes (for
    fixed-shape consumers like the superstep).  The reads that fill chunk
    k are the span 'ingest.read' (utils/profiling), with the bytes they
    gathered."""
    bps = formats.bytes_per_sample(fmt)
    chunk_bytes = max(bps, chunk_bytes - chunk_bytes % bps)
    pending = b''
    eof = False
    k = 0
    while not eof and not (stop is not None and stop.is_set()):
        sp = profiling.begin('ingest.read', k)
        while len(pending) < chunk_bytes:
            data = fh.read(chunk_bytes - len(pending))
            if not data:
                eof = True
                break
            pending += data
        profiling.end(sp, len(pending))
        k += 1
        emit = pending[:len(pending) - len(pending) % bps]
        pending = pending[len(emit):]
        if emit and pad_final and len(emit) < chunk_bytes:
            out = np.full(chunk_bytes, formats.silence_byte(fmt), np.uint8)
            out[:len(emit)] = np.frombuffer(emit, np.uint8)
            yield out
        elif emit:
            yield np.frombuffer(emit, dtype=np.uint8)


def uploaded_stream(raw_iter: Iterable, fmt: str, device, depth: int = 2,
                    packed: bool = False) -> Iterator[torch.Tensor]:
    """Yield device complex64 chunks for an iterable of raw host chunks; a
    daemon thread uploads `depth` chunks ahead of the consumer.
    packed=True additionally quantizes CF32 input to CS16 precision for
    half the transfer bytes (put_quantized)."""
    device = torch.device(device)
    if packed and fmt.upper() == 'CF32':
        put = lambda raw: put_quantized(as_raw_array(raw, 'CF32'), device)
    else:
        put = lambda raw: upload(raw, fmt, device)
    return ahead(raw_iter, put, depth, 'ingest-upload')


def superstep_stream(receiver, raw_iter: Iterable, depth: int = 2
                     ) -> Iterator[torch.Tensor]:
    """Upload thread for the superstep path: each fixed-size raw chunk
    becomes the native-width device tensor the superstep's step converts
    itself (SuperstepEngine.upload), `depth` ahead of the consumer."""
    return ahead(raw_iter, receiver.superstep.upload, depth, 'ss-upload')


class StreamIngest:
    """Live-source ingest: a reader thread drains `sample_iter` (complex64
    chunks of any length) into the lock-free SPSC SampleRing; `blocks()`
    assembles fixed-size blocks for the uploader.

    The ring decouples the SDR read cadence from the compute block size
    like the reference's input thread + ring (block.c:15-33); overruns
    (ring full while a real-time source keeps producing) are counted, not
    blocked on, mirroring complex_samples_produce
    (input-helpers.c:80-92)."""

    def __init__(self, sample_iter: Iterable[np.ndarray], block_samples: int,
                 ring_capacity: int | None = None,
                 stop: threading.Event | None = None):
        self.block = int(block_samples)
        self.ring = SampleRing(ring_capacity or 8 * self.block)
        self.stop_event = stop or threading.Event()
        self._done = threading.Event()
        self._exc: BaseException | None = None

        def reader():
            try:
                for chunk in sample_iter:
                    if self.stop_event.is_set():
                        break
                    self.ring.write(np.asarray(chunk, np.complex64))
            except BaseException as e:
                self._exc = e
            finally:
                self._done.set()

        self._thread = threading.Thread(target=reader, daemon=True,
                                        name='ingest-reader')
        self._thread.start()

    @property
    def overruns(self) -> int:
        return self.ring.overruns

    def stop(self) -> None:
        self.stop_event.set()

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield (block,) complex64 arrays; the final partial block is
        zero-padded (trailing silence) so every block has a static shape."""
        while True:
            n = len(self.ring)
            if n >= self.block:
                yield self.ring.read(self.block)
                continue
            if self._done.is_set() or self.stop_event.is_set():
                if n:
                    tail = self.ring.read(n)
                    yield np.pad(tail, (0, self.block - len(tail)))
                break
            time.sleep(0.002)
        if self._exc is not None:
            raise self._exc
