"""Multi-device sharding: time-axis halo exchange + channel data parallelism.

Counterpart of ``dumphfdl_tpu/parallel/sharding.py``.  Channels are
independent, so the demodulator shards over them without any exchange; the
overlap-save forward FFT needs, at each boundary between two time spans,
the last ``overlap`` samples of the span before (the reference's memmove,
fft.c:49-54), which becomes a copy between neighbouring time shards.

Mapping on a ('time', 'chan') mesh of T x K shards:

* **Frontend** (cost grows with the sample rate): each super-block of
  wideband samples is cut into T contiguous spans.  Shard (t, k) gets span
  t, the overlap tail before it (shard t-1's last samples, copied from that
  shard; for t = 0 the end of the previous super-block), frames it, runs
  the batched forward FFT and the bin-window gather DDC (dsp/frontend.py)
  for channel block k.
* **Demodulator** (cost grows with the channels): the tracker is serial in
  time per channel, so channels shard over both axes, T*K ways.  Shard
  (t, k) splits its DDC rows into T sub-blocks, keeps sub-block t and sends
  the others along the time axis, so that each shard ends with one
  sub-block over the whole super-block: exactly (T-1)/T of the fs1 stream
  crosses between shards, and nothing crosses after that (each shard
  appends to its own fs1 ring, resamples and demodulates its channels).

Where the JAX package has one ``shard_map`` with ``ppermute``, ``psum`` and
``all_to_all``, the port has explicit copies between shards.  Every copy
goes through ``DeviceMesh.exchange`` (or ``send``, one copy), which counts
its bytes on the sending side (and, between processes, on the receiving
side too), so the traffic is held against ``comm_model()`` by counts.
Between two shards of one process a copy runs in the sending shard's
stream and the receiving shard's stream waits for its event.

A mesh may span processes (parallel/multihost.py): its shard list is then
every rank's local shards in rank order (``multihost.global_shards``), and
each process holds stream, state and buffers for its own shards only.  A
copy between shards of two ranks is a ``torch.distributed`` send and
receive, all copies of one exchange phase posted together: under nccl one
``batch_isend_irecv`` per phase, card to card (nccl takes one card per
process, so a rank's shards all lie on one card); under gloo an
``isend``/``irecv`` per copy, tagged by (kind, source, destination), and a
CUDA tensor is staged through pinned host memory on both sides.  The
transport is the group's backend; nothing falls back to the other.  Every
process reads the same wideband stream (what the JAX ``place_global``
assumes) and uploads only its own shards' spans.

There is no global array type here, so ``place_global`` and
``fetch_global`` have no counterpart: state is made shard by shard on its
device (``MeshChannelBank``, one ``Fs1Resampler`` ring per shard), host
blocks are cut by ``MeshChannelBank.process``, and what the host reads back
(event tables, counters, noise floors) is joined by ``MeshChannelBank``,
across processes by one gather per block.

A mesh is always given its devices; nothing picks them.  The list may name
one device several times: these are logical shards, each with its own state
and (on CUDA) its own stream, which is how the tests run a 2x2 mesh on the
CPU and ``chip_smoke.py`` runs one on a single card.  The CLI never builds
such a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch

from .. import constants as C
from ..dsp import frontend as fe
from ..dsp.channel import FrameEvent, MeshChannelBank
from ..io import ingest
from . import multihost


@dataclasses.dataclass(eq=False)
class Shard:
    """One cell of the mesh: a device of a rank and, on CUDA in this
    process, a stream of its own."""
    t: int
    k: int
    device: torch.device
    stream: object = None           # torch.cuda.Stream, None on the CPU
    rank: int = 0                   # the process that holds it

    def run(self):
        """Context in which this shard's work is enqueued."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def synchronize(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


# the kinds of copy between shards, in the order of their tags
EXCHANGE_KINDS = ('halo', 'reshard')


class DeviceMesh:
    """A (T, K) grid of shards with axes ('time', 'chan'): the port's
    stand-in for ``jax.sharding.Mesh``.  devices is a T-long list of K-long
    lists, all of one device type; each entry is a ``torch.device`` (or its
    name) of this process, or a (rank, device) pair of
    ``multihost.global_shards`` for a mesh across processes."""

    axis_names = ('time', 'chan')

    def __init__(self, devices):
        me = multihost.process_index()
        devices = [list(row) for row in devices]
        # the job's shards, (rank, device) pairs, in a multi-process job
        self.multiprocess = multihost.process_count() > 1 and any(
            isinstance(d, tuple) for row in devices for d in row)
        grid = [[(int(d[0]), torch.device(d[1])) if isinstance(d, tuple)
                 else (me, torch.device(d)) for d in row] for row in devices]
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError('a mesh needs a rectangular grid of devices')
        kinds = {d.type for row in grid for _, d in row}
        if len(kinds) != 1 or kinds - {'cpu', 'cuda'}:
            raise ValueError(f'a mesh needs devices of one type, cpu or '
                             f'cuda; got {sorted(kinds)}')
        self.rank = me
        self.shape = {'time': len(grid), 'chan': len(grid[0])}
        self.grid = [[Shard(t, k, d, torch.cuda.Stream(d)
                            if d.type == 'cuda' and r == me else None, r)
                      for k, (r, d) in enumerate(row)]
                     for t, row in enumerate(grid)]
        self.shards = [s for row in self.grid for s in row]   # time-major
        self.size = len(self.shards)
        self.local_shards = [s for s in self.shards if s.rank == me]
        self.backend = None
        if self.multiprocess:
            self._join_group(kinds.pop())
        # bytes and copies this process sent to other shards, by kind, the
        # bytes it received from other processes' shards, and the copies
        # that went through host memory (gloo between cards)
        self.moved: dict[str, int] = {}
        self.copies: dict[str, int] = {}
        self.received: dict[str, int] = {}
        self.staged: dict[str, int] = {}

    def _join_group(self, kind: str) -> None:
        """Checks and set-up of a mesh across processes: every rank holds
        shards, nccl carries one card per process, and under nccl a first
        collective over every rank brings up its communicator here, not
        inside the first exchange."""
        # every rank gathers each block's decode, so every rank holds shards
        ranks = {s.rank for s in self.shards}
        if ranks != set(range(multihost.process_count())):
            raise ValueError(f'a mesh across processes takes shards from '
                             f'every rank of the job; it has ranks '
                             f'{sorted(ranks)} of {multihost.process_count()}')
        self.backend = torch.distributed.get_backend()
        if self.backend != 'nccl':
            return
        devs = {s.device for s in self.local_shards}
        if kind != 'cuda' or len(devs) > 1:
            raise ValueError(f'nccl carries one CUDA device per process; '
                             f'this rank holds shards on '
                             f'{sorted(map(str, devs))}')
        dev = devs.pop()
        torch.cuda.set_device(dev)
        torch.distributed.all_reduce(torch.zeros(1, device=dev))
        torch.cuda.synchronize(dev)

    def shard(self, t: int, k: int) -> Shard:
        return self.grid[t][k]

    def is_local(self, shard: Shard) -> bool:
        """Whether this process holds the shard."""
        return shard.rank == self.rank

    def index(self, shard: Shard) -> int:
        """The shard's position in the time-major shard list."""
        return shard.t * self.shape['chan'] + shard.k

    def demod_order(self) -> list[Shard]:
        """The shards in the order of the demodulator's channel blocks:
        'chan' major, 'time' minor."""
        return [self.grid[t][k] for k in range(self.shape['chan'])
                for t in range(self.shape['time'])]

    @property
    def physical_devices(self) -> list[torch.device]:
        """This process's devices."""
        return sorted({s.device for s in self.local_shards}, key=str)

    def send(self, x, src: Shard, dst: Shard, kind: str, shape=None,
             dtype=None):
        """One copy: exchange() of one move.  On src's rank x is the tensor
        (on src's device, produced in src's stream); on dst's rank, when
        src is another process's, x is None and shape and dtype say what
        comes.  Returns the copy on dst's rank, else None."""
        if shape is None:
            shape, dtype = x.shape, x.dtype
        return self.exchange(kind, [(src, dst, x)], shape, dtype) \
            .get((src, dst))

    def exchange(self, kind: str, moves, shape,
                 dtype=torch.complex64) -> dict:
        """One exchange phase: the copies (src, dst, x) of one kind, each a
        tensor of `shape` and `dtype`, x the tensor on src's rank (None
        elsewhere).  moves may list the whole mesh's copies; a process acts
        on those that touch its shards.  Returns {(src, dst): copy} for
        each move whose dst is this process's, safe to use in dst's stream.
        A copy is always a new buffer, never x itself: two shards on one
        device must not share a buffer that one of them updates in place.

        Every process must call it for the phase, with the same moves for
        each pair of its shards and another rank's (a send waits for its
        receive)."""
        out, remote = {}, []
        for src, dst, x in moves:
            if src is dst:
                raise ValueError('a shard does not send to itself')
            if self.is_local(src):
                self.moved[kind] = self.moved.get(kind, 0) \
                    + x.numel() * x.element_size()
                self.copies[kind] = self.copies.get(kind, 0) + 1
                if self.is_local(dst):
                    out[(src, dst)] = self._copy_local(x, src, dst)
                    continue
            elif not self.is_local(dst):
                continue
            else:
                self.received[kind] = self.received.get(kind, 0) \
                    + math.prod(shape) * dtype.itemsize
            remote.append((src, dst, x))
        if remote:
            remote.sort(key=lambda m: (self.index(m[0]), self.index(m[1])))
            post = self._post_nccl if self.backend == 'nccl' \
                else self._post_gloo
            out.update(post(kind, remote, tuple(shape), dtype))
        return out

    @staticmethod
    def _copy_local(x: torch.Tensor, src: Shard, dst: Shard) -> torch.Tensor:
        if src.stream is None:
            return x.to(dst.device, copy=True)
        with src.run():
            out = x.to(dst.device, copy=True, non_blocking=True)
            done = torch.cuda.Event()
            done.record(src.stream)
        dst.stream.wait_event(done)
        out.record_stream(dst.stream)
        return out

    def _tag(self, kind: str, src: Shard, dst: Shard) -> int:
        n = self.size
        return (EXCHANGE_KINDS.index(kind) * n + self.index(src)) * n \
            + self.index(dst)

    def _post_nccl(self, kind, moves, shape, dtype) -> dict:
        """The phase's copies with other ranks as one batch_isend_irecv,
        posted in the same order on every rank, card to card.  The batch
        is posted from the device's current stream after every local
        shard's work so far (the sent tensors are done, the receive buffers
        free); each receiving shard's stream then waits for the batch, and
        each sent tensor is kept for the allocator until the batch is
        done."""
        dist = torch.distributed
        dev = self.local_shards[0].device
        recvs, sent, ops = [], [], []
        with torch.cuda.device(dev):
            post = torch.cuda.current_stream(dev)
            for sh in self.local_shards:
                post.wait_stream(sh.stream)
            for src, dst, x in moves:
                tag = self._tag(kind, src, dst)
                if self.is_local(src):
                    x = x.contiguous()
                    sent.append(x)
                    ops.append(dist.P2POp(dist.isend, _wire(x), dst.rank,
                                          tag=tag))
                else:
                    with dst.run():
                        buf = torch.empty(shape, dtype=dtype,
                                          device=dst.device)
                    recvs.append((src, dst, buf))
                    ops.append(dist.P2POp(dist.irecv, _wire(buf), src.rank,
                                          tag=tag))
            works = dist.batch_isend_irecv(ops)
            for w in works:
                w.wait()            # the post stream waits for the batch
            for x in sent:
                x.record_stream(post)
        out = {}
        for src, dst, buf in recvs:
            with dst.run():
                for w in works:
                    w.wait()
            out[(src, dst)] = buf
        return out

    def _post_gloo(self, kind, moves, shape, dtype) -> dict:
        """The phase's copies with other ranks as tagged isend/irecv pairs
        over gloo, which carries host tensors: a CUDA tensor is copied to
        pinned host memory in its shard's stream before it is sent, and a
        received one copied up in the receiving shard's stream."""
        dist = torch.distributed
        staged, works, recvs = [], [], []
        for src, dst, x in moves:
            if not self.is_local(src):
                continue
            if x.device.type == 'cuda':
                with src.run():
                    host = torch.empty(x.shape, dtype=x.dtype,
                                       pin_memory=True)
                    host.copy_(x, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(src.stream)
                self.staged[kind] = self.staged.get(kind, 0) + 1
            else:
                host, done = x.contiguous(), None
            staged.append((src, dst, host, done))
        for src, dst, host, done in staged:
            if done is not None:
                done.synchronize()
            works.append(dist.isend(_wire(host), dst.rank,
                                    tag=self._tag(kind, src, dst)))
        for src, dst, _ in moves:
            if self.is_local(src):
                continue
            buf = torch.empty(shape, dtype=dtype,
                              pin_memory=dst.device.type == 'cuda')
            works.append(dist.irecv(_wire(buf), src.rank,
                                    tag=self._tag(kind, src, dst)))
            recvs.append((src, dst, buf))
        for w in works:
            w.wait()
        out = {}
        for src, dst, buf in recvs:
            if dst.device.type == 'cuda':
                with dst.run():
                    buf = buf.to(dst.device, non_blocking=True)
            out[(src, dst)] = buf
        return out

    def synchronize(self) -> None:
        for s in self.local_shards:
            s.synchronize()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """What goes over the wire for x: its real view when complex (both
    backends move real tensors)."""
    return torch.view_as_real(x) if x.is_complex() else x


def make_mesh(devices, time_axis: int | None = None) -> DeviceMesh:
    """The (time, chan) mesh over a list of devices (or of the (rank,
    device) pairs of multihost.global_shards): two time shards when the
    count is even and at least 4, else one; row t takes the list's t-th run
    of K entries."""
    devices = list(devices)
    n = len(devices)
    if time_axis is None:
        time_axis = 2 if n % 2 == 0 and n >= 4 else 1
    chan_axis = n // time_axis
    return DeviceMesh([devices[t * chan_axis:(t + 1) * chan_axis]
                       for t in range(time_axis)])


def parse_mesh(spec: str) -> tuple[int, int]:
    """'TIMExCHAN' -> (T, K)."""
    t_str, _, k_str = spec.lower().partition('x')
    return int(t_str), int(k_str)


class ShardedFrontend:
    """Time-sharded overlap-&-scrap channelizer step.

    One step consumes T * F * input_size contiguous wideband samples and
    returns, per shard in demod order, that shard's (rows/(T*K), T*F*post)
    block of the narrowband fs1 stream: the DDC runs per (time span,
    channel block), then the time shards of a channel block exchange column
    spans for row sub-blocks.

    tables is the dsp/frontend._design_tables result for all rows (a
    multiple of the shard count)."""

    def __init__(self, geo: fe.DdcGeometry, tables: tuple, mesh: DeviceMesh,
                 frames_per_shard: int = 4):
        self.geo, self.mesh = geo, mesh
        self.T, self.K = mesh.shape['time'], mesh.shape['chan']
        self.F = frames_per_shard
        self.span = self.F * geo.input_size
        self.super_len = self.T * self.span
        self.nb_cols = self.T * self.F * geo.post_input_size
        _coarse, residual64, self.window_images, idx, hwin = tables
        self.c_pad = idx.shape[0]
        if self.c_pad % mesh.size:
            raise ValueError(f'{self.c_pad} rows do not divide over '
                             f'{mesh.size} shards')
        self.rows_per_chan_block = self.c_pad // self.K
        self.rows_per_shard = self.c_pad // mesh.size
        self._residual64 = np.asarray(residual64, np.float64)
        # every shard of chan block k holds that block's tables (this
        # process's shards only)
        cl = self.rows_per_chan_block
        self._tables = {}
        for sh in mesh.local_shards:
            rows = slice(sh.k * cl, (sh.k + 1) * cl)
            with sh.run():
                self._tables[sh] = (
                    ingest.put_raw(np.asarray(idx[rows], np.int64),
                                   sh.device),
                    ingest.put_raw(np.asarray(hwin[rows], np.complex64),
                                   sh.device),
                    ingest.put_raw(residual64[rows].astype(np.float32),
                                   sh.device))
        self._tail = np.zeros(geo.overlap_length, np.complex64)
        self._nb_count = 0          # fs1 samples emitted so far
        self.upload_bytes = 0       # host -> shards, over all steps
        self.steps = 0

    @property
    def halo_bytes(self) -> int:
        return self.mesh.moved.get('halo', 0)

    @property
    def reshard_bytes(self) -> int:
        return self.mesh.moved.get('reshard', 0)

    def _upload(self, a: np.ndarray, sh: Shard) -> torch.Tensor:
        self.upload_bytes += a.nbytes
        return ingest.put_raw(a, sh.device)

    def step(self, x: np.ndarray) -> list[torch.Tensor]:
        """x: (super_len,) contiguous wideband samples -> each of this
        process's shards' (rows_per_shard, nb_cols) fs1 block on its
        device, in demod order; carries the overlap tail to the next step.
        Every process of the mesh steps on the same samples."""
        geo, mesh, T = self.geo, self.mesh, self.T
        ov, post, rps = geo.overlap_length, geo.post_input_size, \
            self.rows_per_shard
        x = np.ascontiguousarray(x, np.complex64)
        if x.shape != (self.super_len,):
            raise ValueError(f'a step takes {self.super_len} samples')
        # start phase of the residual mixer per (time shard, channel), in
        # float64 on the host; the ramp inside a span stays small in float32
        starts = self._nb_count + np.arange(T) * self.F * post
        ph0 = np.mod(self._residual64[None, :] * starts[:, None], 1.0) \
            .astype(np.float32)
        cl = self.rows_per_chan_block
        spans, phases = {}, {}
        for sh in mesh.local_shards:
            piece = x[sh.t * self.span:(sh.t + 1) * self.span]
            if sh.t == 0:           # the previous super-block's end
                piece = np.concatenate([self._tail, piece])
            with sh.run():
                spans[sh] = self._upload(piece, sh)
                phases[sh] = self._upload(
                    ph0[sh.t, sh.k * cl:(sh.k + 1) * cl], sh)
        # the halo: the last samples of shard (t-1, k)'s span to (t, k)
        halos = mesh.exchange('halo', [
            (prev, sh, spans[prev][-ov:] if prev in spans else None)
            for sh in mesh.shards if sh.t
            for prev in (mesh.shard(sh.t - 1, sh.k),)], (ov,))
        nbs = {}
        for sh, xs in spans.items():
            with sh.run():
                if sh.t:
                    xs = torch.cat([halos[(mesh.shard(sh.t - 1, sh.k), sh)],
                                    xs])
                frames = xs.unfold(0, geo.fft_size, geo.input_size)
                nbs[sh], _ = fe.ddc_frames(geo, self.window_images,
                                           *self._tables[sh], frames,
                                           phases[sh])
        # the reshard: shard (t, k)'s row sub-block t2 to (t2, k)
        sub = lambda sh, t2: nbs[sh][t2 * rps:(t2 + 1) * rps]
        got = mesh.exchange('reshard', [
            (src, dst, sub(src, dst.t) if src in nbs else None)
            for src in mesh.shards for dst in mesh.shards
            if dst.k == src.k and dst is not src],
            (rps, self.F * post))
        out = []
        for sh in mesh.demod_order():
            if sh not in nbs:
                continue
            parts = [sub(sh, t2) if t2 == sh.t
                     else got[(mesh.shard(t2, sh.k), sh)] for t2 in range(T)]
            with sh.run():
                out.append(torch.cat(parts, dim=1) if T > 1 else parts[0])
        self._tail = x[-ov:].copy()
        self._nb_count += self.nb_cols
        self.steps += 1
        return out

    def gather(self, blocks: list[torch.Tensor]) -> np.ndarray:
        """step's result on a mesh of one process as one (c_pad, nb_cols)
        host array, row for row the channel axis."""
        self.mesh.synchronize()     # made in their shards' streams
        return np.concatenate([b.cpu().numpy() for b in blocks])


class ShardedWidebandReceiver:
    """The wideband receiver on a ('time', 'chan') mesh: wideband samples
    in, frame events out.  The frontend shards over time with a halo copy,
    the demodulator's channels over all shards; each shard's fs1 ring and
    demodulator state live on its device.  Decodes on the unfused path
    (Fs1Resampler._drain_resampler -> ChannelBank.process), as the JAX
    receiver does on a mesh.

    instrument=True makes process() time each stage between waits for all
    shards (slower; for a breakdown only), into stage_time."""

    superstep = None            # a mesh runs no superstep: what the app
    engine = None               # asks a receiver before it picks a path

    def __init__(self, sample_rate: int, centerfreq: int,
                 frequencies: list[int], mesh: DeviceMesh,
                 block_len: int = 5400, frames_per_shard: int = 4):
        if block_len % C.SPS:
            raise ValueError(f'demod block of {block_len} samples is not a '
                             f'whole number of symbols ({C.SPS} samples '
                             'each)')
        self.sample_rate, self.centerfreq = int(sample_rate), int(centerfreq)
        self.frequencies = list(frequencies)
        self.mesh, self.block_len = mesh, block_len
        self.bank = MeshChannelBank(len(self.frequencies), mesh)
        c_pad, rps = self.bank._c, self.bank.rows_per_shard
        self.geo = geo = fe.compute_geometry(
            fe.compute_fft_decimation_rate(self.sample_rate),
            C.CHANNEL_TRANSITION_BW_HZ / self.sample_rate)
        tables = fe._design_tables(geo, self.sample_rate, self.centerfreq,
                                   tuple(self.frequencies), c_pad)
        self.frontend = ShardedFrontend(geo, tables, mesh, frames_per_shard)
        # per shard of this process, in demod order, the fs1 ring of its
        # rows (room for one sharded step per append) and its resampler
        self.shards = [sh for sh in mesh.demod_order() if mesh.is_local(sh)]
        self.resamplers = [
            fe.Fs1Resampler(self.sample_rate, geo.decimation, rps, sh.device,
                            block_len, 2 * self.frontend.nb_cols)
            for sh in self.shards]
        self.sample_clock = 0       # wideband samples consumed
        self._pending: list[np.ndarray] = []    # chunks short of a step
        self._pending_len = 0
        self.instrument = False
        self.stage_time = {'frontend': 0.0, 'fs1_append': 0.0,
                           'resample_demod': 0.0}

    @contextlib.contextmanager
    def _stage(self, name: str):
        if not self.instrument:
            yield
            return
        t0 = time.perf_counter()
        yield
        self.mesh.synchronize()
        self.stage_time[name] += time.perf_counter() - t0

    def process(self, wideband) -> list[FrameEvent]:
        """Feed wideband complex samples: a host array, which the receiver
        cuts into spans and uploads itself.  On a mesh across processes
        every process is fed the same samples and returns the whole
        decode."""
        if isinstance(wideband, torch.Tensor):
            raise TypeError('the sharded receiver takes host samples (a '
                            'numpy array), not a tensor')
        self.sample_clock += len(wideband)
        self._pending.append(np.asarray(wideband, np.complex64))
        self._pending_len += len(wideband)
        events: list[FrameEvent] = []
        sl = self.frontend.super_len
        if self._pending_len < sl:
            return events
        buf = np.concatenate(self._pending)
        whole = len(buf) - len(buf) % sl
        self._pending = [buf[whole:].copy()]
        self._pending_len = len(buf) - whole
        shards = self.shards
        for off in range(0, whole, sl):
            x = buf[off:off + sl]
            with self._stage('frontend'):
                blocks = self.frontend.step(x)
            with self._stage('fs1_append'):
                for sh, rs, nb in zip(shards, self.resamplers, blocks):
                    with sh.run():
                        rs._append_fs1(nb)
            with self._stage('resample_demod'):
                chunks = []
                for sh, rs in zip(shards, self.resamplers):
                    with sh.run():
                        chunks.append(rs._drain_resampler())
                # every shard's cursors move alike: the same chunk count
                # (on every process: the bank gathers once per chunk)
                for per_shard in zip(*chunks, strict=True):
                    events.extend(self.bank.process_shards(list(per_shard)))
        return events

    def comm_model(self) -> dict:
        """The volumes this geometry moves, from its shapes alone.

        The ``*_per_s`` keys are the JAX package's, per second of stream:
        halo_bytes_per_s is the halo of ONE chan column ((T-1) x overlap x
        8 B per super-block; every one of the K columns moves as much),
        fs1_reshard_bytes_per_s the whole mesh's reshard, exactly (T-1)/T
        of the fs1 stream; the demodulator exchanges nothing.  The
        ``*_bytes_per_superblock`` keys are what DeviceMesh.send and the
        frontend's uploads count per step over the whole mesh: K columns of
        halo, the reshard, and the upload (each chan column gets its own
        copy of a span, plus the carried tail and the mixer phases)."""
        from ..dsp.backend import PACK_WORDS
        from ..dsp.tracker import EV_FIELDS, K_EVENTS
        geo, front, fs = self.geo, self.frontend, self.sample_rate
        T, K = front.T, front.K
        sb_per_s = fs / front.super_len
        c_pad = self.bank._c
        fs1_rate = fs / geo.decimation
        fused = self.bank.fused_event_decode or 0
        blocks_per_s = C.INTERNAL_RATE / self.block_len
        return {
            'devices': self.mesh.size,
            'time_shards': T,
            'halo_bytes_per_s': int((T - 1) * geo.overlap_length * 8
                                    * sb_per_s),
            'fs1_reshard_bytes_per_s': int(c_pad * fs1_rate * 8
                                           * (T - 1) / T),
            'demod_collective_bytes_per_s': 0,
            'event_readback_bytes_per_s': int(
                (c_pad * K_EVENTS * EV_FIELDS
                 + fused * (2 + PACK_WORDS)) * 4 * blocks_per_s),
            'wideband_upload_bytes_per_s': int(fs * 8),
            'halo_bytes_per_superblock': K * (T - 1) * geo.overlap_length * 8,
            'reshard_bytes_per_superblock':
                c_pad * front.nb_cols * 8 * (T - 1) // T,
            'upload_bytes_per_superblock':
                K * (front.super_len + geo.overlap_length) * 8 + T * c_pad * 4,
        }

    def flush(self) -> list[FrameEvent]:
        """Drain buffered samples: silence for a double-slot frame plus the
        channelizer's and resampler's latency, and two super-blocks for
        the sharded step's own buffering."""
        pad_wb = int((C.DOUBLE_SLOT_FRAME_LEN + 200) * C.SPS
                     * self.sample_rate / C.INTERNAL_RATE) \
            + 4 * self.geo.fft_size + 2 * self.frontend.super_len
        events: list[FrameEvent] = []
        step = self.sample_rate
        pad = np.zeros(step, dtype=np.complex64)
        for _ in range(-(-pad_wb // step)):
            events.extend(self.process(pad))
        events.extend(self.bank.drain_events())
        return events


def dryrun_multichip(n_devices: int, devices) -> dict:
    """Production-shaped dry run on a mesh of the first n_devices of
    devices: decode a synthesized capture through the sharded receiver and
    assert that every emitted PDU comes out bit for bit on its channel.
    Returns the run's detail (per-stage wall, comm_model, counted bytes).

    Default geometry: 64 channels at 432 ksps, traffic on 8 of them;
    DUMPHFDL_DRYRUN_CHANNELS and DUMPHFDL_DRYRUN_FS scale it."""
    from ..dsp import modulator

    devices = list(devices)
    if len(devices) < n_devices:
        raise ValueError(f'dry run on {n_devices} devices, given '
                         f'{len(devices)}')
    mesh = make_mesh(devices[:n_devices])
    fs = int(os.environ.get('DUMPHFDL_DRYRUN_FS', '432000'))
    nch = int(os.environ.get('DUMPHFDL_DRYRUN_CHANNELS', '64'))
    center = 10_000_000
    spacing = max(3000, min(8000, (fs - 20000) // nch))
    chans = [center + (i - nch // 2) * spacing for i in range(nch)]
    rng = np.random.default_rng(7)
    # traffic on 8 channels spread across the band, cycling the
    # single-slot modes; the rest hunt over noise
    modes = [1, 3, 0, 2, 1, 3, 0, 2]
    traffic = list(range(0, nch, max(1, nch // 8)))[:8]
    pdus = {ci: modulator.make_test_mpdu(modes[k], rng, icao=0x3C0000 + ci)
            for k, ci in enumerate(traffic)}
    wb = modulator.synthesize_wideband_fft(
        [(pdus[ci], modes[k], chans[ci]) for k, ci in enumerate(traffic)],
        fs=fs, centerfreq=center, snr_db=30.0)
    rx = ShardedWidebandReceiver(fs, center, chans, mesh)
    rx.instrument = True
    events = []
    step = fs // 2
    for off in range(0, len(wb), step):
        events.extend(rx.process(wb[off:off + step]))
    events.extend(rx.flush())
    got: dict[int, set] = {}
    for e in events:
        if e.pdu:
            got.setdefault(e.channel, set()).add(e.pdu)
    # every traffic channel must decode its PDU bit for bit (a noise
    # channel may emit a false frame now and then; its FCS fails
    # downstream, so that is no error here)
    missing = [ci for ci, p in pdus.items() if p not in got.get(ci, set())]
    assert not missing, (
        f'sharded decode mismatch: channels {missing} missing their PDU; '
        f'decoded channels {sorted(got)}')
    return {
        'devices': n_devices, 'mesh': dict(mesh.shape),
        'physical_devices': len(mesh.physical_devices),
        'sample_rate': fs, 'channels': nch,
        'stream_seconds': len(wb) / fs,
        'stage_wall_s': dict(rx.stage_time),
        'comm_model': rx.comm_model(),
        'super_blocks': rx.frontend.steps,
        'moved_bytes': dict(mesh.moved), 'copies': dict(mesh.copies),
        'upload_bytes': rx.frontend.upload_bytes,
        'decoded_ok': len(pdus),
    }
