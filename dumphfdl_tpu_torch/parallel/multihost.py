"""Multi-host deployment plumbing (torch.distributed).

Counterpart of ``dumphfdl_tpu/parallel/multihost.py``.  Every process
calls ``init_distributed`` (rendezvous at process 0) and is one rank of a
``torch.distributed`` group.  Two deployments stand on it:

* **Channel slicing** (the CLI without ``--mesh``): each process takes its
  contiguous slice of the channel list (``local_channel_slice``), feeds
  only its local SDR stream and runs its own output stack, so no samples
  cross between hosts.  The reference scales past one machine the same way,
  with independent processes aggregated over ZMQ
  (extras/log_aggregator.py).
* **A global mesh** (``--mesh`` in a multi-process job): every rank
  contributes its local shards (``global_shards``), the ('time', 'chan')
  mesh of parallel/sharding.py spans the ranks, and its halo and reshard
  copies go between processes (``DeviceMesh.exchange``).  Every process is
  fed the same wideband stream and ends each block with the whole decode.

Objects the ranks share (device lists, decoded events) go through
``host_group()``, a gloo group, so they never pass through a card; under
nccl the card carries only the mesh's sample copies.

Environment variables (systemd-friendly):
  DUMPHFDL_COORDINATOR   host:port of process 0
  DUMPHFDL_NUM_PROCESSES total process count
  DUMPHFDL_PROCESS_ID    this process's rank
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
import socket
import subprocess
import time

import torch
import torch.distributed as dist


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device,
                     timeout: float | None = None,
                     backend: str | None = None) -> bool:
    """Join the process group named by the arguments or, for each one not
    given, the environment; returns True when running multi-process, False
    for a single process (nothing is initialized then).  A process that
    has joined a group already stays in it (True).  device is the one the
    process decodes on and decides the backend: nccl for a CUDA device,
    gloo for the CPU; backend='gloo' for a CUDA device is for ranks that
    share one card, which nccl refuses (a mesh then stages its copies
    through host memory).  timeout (seconds) bounds every collective of
    the group (torch's default where None)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None:
        coordinator = os.environ.get('DUMPHFDL_COORDINATOR')
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = os.environ.get('DUMPHFDL_NUM_PROCESSES', '1')
    if process_id is None:
        process_id = os.environ.get('DUMPHFDL_PROCESS_ID', '0')
    num_processes, process_id = int(num_processes), int(process_id)
    if num_processes <= 1:
        return False
    kind = torch.device(device).type
    if kind not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {device}')
    if backend is None:
        backend = 'nccl' if kind == 'cuda' else 'gloo'
    elif backend not in ('gloo', 'nccl') or (kind, backend) == ('cpu', 'nccl'):
        raise ValueError(f'backend {backend} for a {kind} device')
    extra = {} if timeout is None else \
        {'timeout': datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        backend=backend, init_method=f'tcp://{coordinator}',
        world_size=num_processes, rank=process_id, **extra)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_channel_slice(num_channels: int) -> slice:
    """The contiguous slice of the global channel list this host feeds."""
    n, idx = process_count(), process_index()
    per = -(-num_channels // n)
    return slice(idx * per, min((idx + 1) * per, num_channels))


_host_groups: dict = {}


def host_group():
    """The group host objects are gathered over: the default group when its
    backend is gloo, else a gloo group over the same ranks, made once (a
    collective: every rank makes it at the same point, from the thread that
    issues the group's other collectives)."""
    if dist.get_backend() == 'gloo':
        return dist.group.WORLD
    key = id(dist.group.WORLD)
    if key not in _host_groups:
        _host_groups[key] = dist.new_group(backend='gloo')
    return _host_groups[key]


def all_gather_host(obj) -> list:
    """Every rank's obj, in rank order, over host_group()."""
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def global_shards(local_devices) -> list[tuple[int, torch.device]]:
    """The job's shards: each rank's local devices in rank order, as (rank,
    device) pairs.  A single process gets its own list, rank 0.  Every rank
    must call it (a collective)."""
    mine = [torch.device(d) for d in local_devices]
    if not dist.is_initialized():
        return [(0, d) for d in mine]
    return [(rank, torch.device(d))
            for rank, devs in enumerate(all_gather_host([str(d)
                                                         for d in mine]))
            for d in devs]


ROOT = pathlib.Path(__file__).resolve().parents[2]


def launch_local_ranks(cmds: list[list[str]], logdir, deadline_s: float,
                       env: dict | None = None) -> list[dict]:
    """Run one process per command as the ranks of one torch.distributed
    job on this host (rank r runs cmds[r], the environment naming a free
    localhost port, the job's size and r; variables of env on top) and
    return the JSON object on each rank's last line of output, in rank
    order.  Rank r's output goes to logdir/r.out and logdir/r.err.  A rank
    that exits non-zero, or ranks still running after deadline_s seconds,
    end the job: the others are killed and it raises RuntimeError with the
    failing rank's last lines of error output."""
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    base = {k: v for k, v in os.environ.items()
            if not k.startswith('DUMPHFDL_')}
    base['PYTHONPATH'] = os.pathsep.join(
        p for p in (str(ROOT), base.get('PYTHONPATH', '')) if p)
    # every rank is on this host
    base.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    base.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    base.update(env or {})
    base.update(DUMPHFDL_COORDINATOR=f'127.0.0.1:{port}',
                DUMPHFDL_NUM_PROCESSES=str(len(cmds)))
    logdir = pathlib.Path(logdir)
    logs = [(logdir / f'{r}.out', logdir / f'{r}.err')
            for r in range(len(cmds))]
    procs = []
    try:
        for r, (cmd, (out, err)) in enumerate(zip(cmds, logs)):
            with open(out, 'w') as fo, open(err, 'w') as fe:
                procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, stdout=fo, stderr=fe,
                    env={**base, 'DUMPHFDL_PROCESS_ID': str(r)}))
        deadline = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs) \
                or any(p.returncode for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll()]
            if bad:
                r = bad[0]
                raise RuntimeError(f'rank {r} of {len(cmds)} exited with '
                                   f'{procs[r].returncode}: '
                                   f'{logs[r][1].read_text()[-3000:]}')
            if time.monotonic() > deadline:
                raise RuntimeError(f'ranks still running after '
                                   f'{deadline_s:.0f} s')
            time.sleep(0.2)
        return [json.loads(out.read_text().strip().splitlines()[-1])
                for out, _ in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
