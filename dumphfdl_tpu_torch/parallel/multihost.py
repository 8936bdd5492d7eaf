"""Multi-host deployment plumbing (torch.distributed).

Counterpart of ``dumphfdl_tpu/parallel/multihost.py``.  The reference
scales past one machine by running independent processes aggregated over
ZMQ (extras/log_aggregator.py).  Here every process calls
``init_distributed`` (rendezvous at process 0), takes its contiguous slice
of the channel list (``local_channel_slice``), feeds only its local SDR
stream and runs its own output stack, so no samples cross between hosts.
A ('time', 'chan') mesh that spans processes is not ported: a mesh
(parallel/sharding.py) lives in one process.

Environment variables (systemd-friendly):
  DUMPHFDL_COORDINATOR   host:port of process 0
  DUMPHFDL_NUM_PROCESSES total process count
  DUMPHFDL_PROCESS_ID    this process's rank
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device) -> bool:
    """Join the process group named by the arguments or, for each one not
    given, the environment; returns True when running multi-process, False
    for a single process (nothing is initialized then).  device is the one
    the process decodes on and decides the backend: nccl for a CUDA device,
    gloo for the CPU."""
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
    dist.init_process_group(
        backend='nccl' if kind == 'cuda' else 'gloo',
        init_method=f'tcp://{coordinator}',
        world_size=num_processes, rank=process_id)
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
