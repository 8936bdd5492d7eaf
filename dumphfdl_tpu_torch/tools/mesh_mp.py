"""One rank of a ('time', 'chan') mesh across processes, driven through the
decoder's own entry points: the program chip_smoke.py's mesh_mp phase and
the tests spawn once per rank.

    DUMPHFDL_COORDINATOR=127.0.0.1:PORT DUMPHFDL_NUM_PROCESSES=N \\
    DUMPHFDL_PROCESS_ID=R python -m dumphfdl_tpu_torch.tools.mesh_mp \\
        --mesh 2x2 --shards-per-rank 2 --device cuda:0 --backend gloo \\
        --timeout 300 [--design FILE] [--passes 2] [--profile] \\
        [--check-kernels] -- <decoder arguments: --iq-file ... FREQ ...>

The process joins the group (``multihost.init_distributed``, with the
given backend and timeout), contributes --shards-per-rank shards on
--device (logical shards where more than one), builds the T x K mesh over
the first T*K of the job's shards (``multihost.global_shards``, rank
order) and decodes the capture with the app ``cli.build_app`` makes, once
per pass, each pass with a fresh mesh and app.  Every rank reads the same
file and ends with the whole decode.

--design FILE is a pickle of {deployment: tables} of
``dsp.frontend._design_tables``, made by the caller, which the app takes
over instead of designing the channel filters again.  --profile runs one
more pass under torch.profiler (CUDA only); --check-kernels one more while
recording what this rank's shards hand K2's and K1's wrappers, and the last
rank holds both against their plain versions on its own blocks
(tools/kernel_check.py).

The result is one JSON object on the last line of standard output: the
rank, the transport, and per pass the events the app handled (every field;
the PDU in hex), the wall time, the wrappers' launches, the bytes this rank
sent between shards by kind, its copies, the bytes it received from other
ranks, the copies staged through host memory, its uploads, the bytes it
put into the event gathers, the super-blocks and demod blocks, and
comm_model().
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pickle
import sys
import time

import torch


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog='mesh_mp')
    p.add_argument('--mesh', required=True, metavar='TIMExCHAN')
    p.add_argument('--shards-per-rank', type=int, default=1)
    p.add_argument('--device', required=True)
    p.add_argument('--backend', choices=['gloo', 'nccl'], default=None)
    p.add_argument('--timeout', type=float, required=True,
                   help='seconds any collective of the group may take')
    p.add_argument('--design', default=None)
    p.add_argument('--passes', type=int, default=1)
    p.add_argument('--profile', action='store_true')
    p.add_argument('--check-kernels', action='store_true')
    p.add_argument('decoder', nargs=argparse.REMAINDER)
    return p


def _take_design(path: str) -> None:
    """Make the app take the caller's filter tables for the deployments
    they were made for."""
    from ..dsp import frontend
    with open(path, 'rb') as f:
        tables = pickle.load(f)
    design = frontend._design_tables
    frontend._design_tables = lambda *dep: tables[dep] if dep in tables \
        else design(*dep)


def _event_fields(ev) -> list:
    return [v.hex() if isinstance(v, bytes) else v for v in ev]


def _one_pass(argv, dev, spec: str, per_rank: int, prof=None) -> dict:
    """Build a fresh mesh and app and decode the capture once."""
    from .. import cli
    from ..app import HfdlApp
    from ..parallel import multihost
    from ..parallel.sharding import DeviceMesh, parse_mesh
    from .kernel_check import launches, zero_launches
    t_ax, k_ax = parse_mesh(spec)
    shards = multihost.global_shards([dev] * per_rank)[:t_ax * k_ax]
    mesh = DeviceMesh([shards[t * k_ax:(t + 1) * k_ax] for t in range(t_ax)])
    args = cli.build_parser().parse_args(argv)
    args.mesh = mesh
    app = cli.build_app(args, dev)
    rx = app.receiver
    seen = []
    handle = HfdlApp.handle_events
    app.handle_events = lambda evs: (seen.extend(evs), handle(app, evs))[1]
    zero_launches()
    try:
        with prof if prof is not None else contextlib.nullcontext():
            mesh.synchronize()
            t0 = time.perf_counter()
            app.run_file(args.iq_file, args.sample_format)
            mesh.synchronize()
            wall = time.perf_counter() - t0
            counts = launches()
    finally:
        app.shutdown()
    return dict(
        wall_s=wall, events=[_event_fields(e) for e in seen],
        launches=counts,
        moved=dict(mesh.moved), copies=dict(mesh.copies),
        received=dict(mesh.received),
        staged=dict(mesh.staged), upload_bytes=rx.frontend.upload_bytes,
        gather_bytes=rx.bank.gather_bytes, super_blocks=rx.frontend.steps,
        demod_blocks=rx.resamplers[0]._out_count // rx.block_len,
        local_shards=[mesh.index(s) for s in mesh.local_shards],
        rows_per_shard=rx.bank.rows_per_shard, comm_model=rx.comm_model(),
        physical_devices=[str(d) for d in mesh.physical_devices])


def main(argv: list[str] | None = None) -> int:
    opts = _parser().parse_args(argv)
    decoder = opts.decoder[1:] if opts.decoder[:1] == ['--'] \
        else opts.decoder
    from ..parallel import multihost
    torch.set_num_threads(1)
    dev = torch.device(opts.device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if not multihost.init_distributed(device=dev, backend=opts.backend,
                                      timeout=opts.timeout):
        raise SystemExit('mesh_mp: not a multi-process job '
                         '(DUMPHFDL_COORDINATOR, _NUM_PROCESSES, _PROCESS_ID)')
    rank, world = multihost.process_index(), multihost.process_count()
    backend = torch.distributed.get_backend()
    if opts.design:
        _take_design(opts.design)
    try:
        passes = [_one_pass(decoder, dev, opts.mesh, opts.shards_per_rank)
                  for _ in range(opts.passes)]
        out = dict(rank=rank, world=world, backend=backend,
                   transport=backend if dev.type == 'cpu' or backend == 'nccl'
                   else 'gloo-staged', device=str(dev), mesh=opts.mesh,
                   passes=passes)
        if opts.profile:
            from ..utils import profiling
            prof = profiling.profiler(dev)
            p = _one_pass(decoder, dev, opts.mesh, opts.shards_per_rank,
                          prof)
            out['profiled'] = dict(wall_s=p['wall_s'], **profiling
                                   .device_profile(prof, p['wall_s']))
        if opts.check_kernels:
            from . import kernel_check
            with kernel_check.recording() as (k2_seen, k1_seen):
                p = _one_pass(decoder, dev, opts.mesh, opts.shards_per_rank)
            if rank == world - 1:
                out['kernels'] = kernel_check.check_shard_blocks(
                    k2_seen, k1_seen, p['rows_per_shard'],
                    len(p['local_shards']))
                out['kernels']['launches'] = p['launches']
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
