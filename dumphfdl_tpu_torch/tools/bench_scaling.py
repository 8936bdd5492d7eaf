"""Weak scaling of the sharded receiver over 1, 2 and 4 devices.

Twin of ``extras/bench_scaling.py``, with the measured parts of
``extras/bench_scaling2.py``.  ``ShardedWidebandReceiver`` runs on an N x 1
('time', 'chan') mesh, time-sharded as in JAX, with one process per device
(nccl between cards, gloo between CPU shards), each process a rank of a
torch.distributed group over localhost, as tools/mesh_mp.py is run.  The
span per device is fixed: N devices get N times the sample rate and N
times the channels.  Every rank synthesizes the same capture (traffic on
four channels, seed 0).  Two warm super-blocks come first, then the best
of two timed runs of a fixed number of super-blocks each, max(8, 3 s *
rate // super-block), with the host chunks served one super-block ahead
by a thread.  The stream is one: the capture repeated end to end in whole
copies, as bench_scaling2 repeats it, then silence to the end, and the
second run goes on where the first stopped.  (bench_scaling pads the
capture with silence and times the same stretch twice: the timed runs of a
wide point, whose super-blocks last 2-3 s, then hold no frame while those
of N = 1 do, and the points time different work.)  Per point:

* wideband samples per second (the timed samples over the slowest rank's
  wall) and efficiency = sps(N) / (N * sps(1));
* the instrumented per-stage wall (``stage_time``) and ``comm_model()``,
  with the bytes ``DeviceMesh`` counted between shards, summed over the
  ranks, against the model's bytes per super-block;
* each rank's set-up seconds (the receiver's construction);
* from bench_scaling2: process CPU seconds per stream second over the
  timed runs, summed over the ranks, and work_inflation = that over its
  value at N = 1; whether the decoded PDU set equals the emitted one and
  the set at N = 1.

N goes up to the devices that are visible (CUDA) or to --devices (CPU);
there is no stand-in of logical shards.  The GSPMD collective extraction
and ICI prediction of bench_scaling2 have no counterpart: the port inserts
no collective of its own, DeviceMesh counts every copy.

    python -m dumphfdl_tpu_torch.tools.bench_scaling [--devices 4]
        [--fs-per-device 2160000] [--channels-per-device 512]
        [--device cuda|cpu] [--out PATH]

Prints one JSON object; --out also writes it to PATH.  Exits 1 when a
point decodes another PDU set or moves other bytes than the model.  Runs
on the CUDA devices unless --device names the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

CENTER = 10_000_000
EMITTERS = 4
WARM_STEPS = 2
REPS = 2
SECONDS = 3.0           # of stream a timed run holds at least (8 super-blocks)
# seconds any collective of a point's group may take (the ranks design their
# filters apart, minutes at 2048 channels, before their first exchange); a
# point whose ranks outlive twice this is ended
GROUP_TIMEOUT_S = 900


def capture(n: int, fs_per_dev: int, ch_per_dev: int) -> dict:
    """The point's capture, as in the JAX script: N times the rate and the
    channels, spaced half the rate per channel within 3-8 kHz, a frame on
    four evenly spaced channels (the single-slot modes in turn, seed 0,
    30 dB).  Returns fs, freqs, the complex64 capture and the emitted PDUs
    in hex, sorted."""
    from .. import constants as C
    from ..dsp import modulator
    fs, nch = fs_per_dev * n, ch_per_dev * n
    spacing = max(3000, min(8000, (fs // nch) // 2))
    freqs = [CENTER + (i - nch // 2) * spacing for i in range(nch)]
    rng = np.random.default_rng(0)
    single_slot = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
    emissions = []
    for k, ci in enumerate(range(0, nch, max(1, nch // EMITTERS))[:EMITTERS]):
        mode = single_slot[k % len(single_slot)]
        emissions.append((modulator.make_test_mpdu(mode, rng), mode,
                          freqs[ci]))
    wb = modulator.synthesize_wideband_fft(emissions, fs=fs,
                                           centerfreq=CENTER, snr_db=30.0)
    return dict(fs=fs, freqs=freqs, wb=wb,
                expected=sorted(p.hex() for p, _, _ in emissions))


def _cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def run_rank(n: int, fs_per_dev: int, ch_per_dev: int, device) -> dict:
    """One rank of the N-device point (the process's group comes from the
    DUMPHFDL_* variables; none for N = 1).  Returns its measurements."""
    from ..parallel import multihost
    from ..parallel.sharding import DeviceMesh, ShardedWidebandReceiver
    from ..utils.prefetch import ahead
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    joined = multihost.init_distributed(device=dev, timeout=GROUP_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        cap = capture(n, fs_per_dev, ch_per_dev)
        synth_s = time.perf_counter() - t0
        fs, wb = cap['fs'], cap['wb']
        shards = multihost.global_shards([dev])
        if len(shards) != n:
            raise ValueError(f'{len(shards)} shards for a point of {n}')
        t0 = time.perf_counter()
        mesh = DeviceMesh([[s] for s in shards])
        rx = ShardedWidebandReceiver(fs, CENTER, cap['freqs'], mesh)
        mesh.synchronize()
        setup_s = time.perf_counter() - t0
        rx.instrument = True
        sl = rx.frontend.super_len
        n_steps = max(8, int(SECONDS * fs) // sl)
        need = (WARM_STEPS + REPS * n_steps) * sl
        # whole copies (no frame cut), then silence
        copies = max(1, need // len(wb))
        wb = np.concatenate([np.tile(wb, copies), np.zeros(
            max(0, need - copies * len(wb)), np.complex64)])[:need]

        def chunks(count, off0=0):
            for k in range(off0, off0 + count):
                yield wb[k * sl:(k + 1) * sl]

        pdus, frames = [], 0

        def take(evs):
            nonlocal frames
            for ev in evs:
                if ev.pdu is not None:
                    frames += 1
                    if ev.fcs_ok:
                        pdus.append(ev.pdu.hex())

        for c in chunks(WARM_STEPS):
            take(rx.process(c))
        mesh.synchronize()
        walls, cpus = [], []
        for rep in range(REPS):
            cpu0, t0 = _cpu_seconds(), time.perf_counter()
            for c in ahead(chunks(n_steps, WARM_STEPS + rep * n_steps),
                           np.ascontiguousarray, 2, 'scaling-feed'):
                take(rx.process(c))
            mesh.synchronize()
            walls.append(time.perf_counter() - t0)
            cpus.append(_cpu_seconds() - cpu0)
        stage = dict(rx.stage_time)
        take(rx.flush())
        mesh.synchronize()
        return dict(
            rank=multihost.process_index(), world=multihost.process_count(),
            device=str(dev), backend=torch.distributed.get_backend()
            if joined else None, sample_rate=fs, channels=len(cap['freqs']),
            super_len=sl, super_blocks=n_steps, synth_s=synth_s,
            setup_s=setup_s, walls=walls, cpu_s=cpus, stage_wall_s=stage,
            steps=rx.frontend.steps, moved=dict(mesh.moved),
            received=dict(mesh.received), copies=dict(mesh.copies),
            comm_model=rx.comm_model(), frames_decoded=frames,
            decoded=sorted(set(pdus)), expected=cap['expected'],
            max_memory_allocated=torch.cuda.max_memory_allocated(dev)
            if dev.type == 'cuda' else None)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def run_point(n: int, fs_per_dev: int, ch_per_dev: int,
              device_type: str) -> list[dict]:
    """The N-device point: N rank processes over localhost, rank r on
    cuda:r (or the CPU); each rank's result in rank order.  A rank that
    fails, or ranks that outlive twice GROUP_TIMEOUT_S, end the point: the
    others are killed and it raises (multihost.launch_local_ranks)."""
    from ..parallel import multihost
    cmds = [[sys.executable, '-m', 'dumphfdl_tpu_torch.tools.bench_scaling',
             '--rank-of', str(n),
             '--device', f'cuda:{r}' if device_type == 'cuda' else 'cpu',
             '--fs-per-device', str(fs_per_dev),
             '--channels-per-device', str(ch_per_dev)] for r in range(n)]
    with tempfile.TemporaryDirectory(prefix='bench_scaling') as tmp:
        try:
            return multihost.launch_local_ranks(cmds, tmp,
                                                2 * GROUP_TIMEOUT_S)
        except RuntimeError as e:
            raise RuntimeError(f'scaling point {n}: {e}') from None


def summarize(n: int, ranks: list[dict]) -> dict:
    """One point from its ranks' results."""
    r0 = ranks[0]
    timed = r0['super_blocks'] * r0['super_len']
    # the ranks step together (each exchange waits for its peers): the
    # slowest rank's wall is the mesh's
    walls = [max(r['walls'][i] for r in ranks) for i in range(REPS)]
    best = min(walls)
    moved, received = {}, {}
    for r in ranks:
        for k, v in r['moved'].items():
            moved[k] = moved.get(k, 0) + v
        for k, v in r['received'].items():
            received[k] = received.get(k, 0) + v
    model, steps = r0['comm_model'], r0['steps']
    want = {} if n == 1 else {
        'halo': steps * model['halo_bytes_per_superblock'],
        'reshard': steps * model['reshard_bytes_per_superblock']}
    stream_s = REPS * timed / r0['sample_rate']
    return dict(
        devices=n, mesh=f'{n}x1', backend=r0['backend'],
        sample_rate=r0['sample_rate'], channels=r0['channels'],
        super_len=r0['super_len'], super_blocks=r0['super_blocks'],
        wideband_sps=timed / best, wall_s=best, walls_s=walls,
        frames_decoded=r0['frames_decoded'],
        stage_wall_s=[r['stage_wall_s'] for r in ranks],
        comm_model=model, steps=steps, moved_bytes=moved,
        received_bytes=received, modelled_bytes=want,
        bytes_equal_comm_model=moved == want and (n == 1 or received == moved),
        setup_s=[r['setup_s'] for r in ranks],
        synth_s=[r['synth_s'] for r in ranks],
        cpu_s=sum(sum(r['cpu_s']) for r in ranks),
        cpu_s_per_stream_s=sum(sum(r['cpu_s']) for r in ranks) / stream_s,
        max_memory_allocated=[r['max_memory_allocated'] for r in ranks],
        decoded=r0['decoded'],
        decoded_equal_across_ranks=all(r['decoded'] == r0['decoded']
                                       for r in ranks),
        decode_ok=r0['decoded'] == r0['expected'])


def scaling(counts, fs_per_dev: int, ch_per_dev: int, device_type: str,
            say=None) -> dict:
    """Every point, efficiency and work inflation against N = 1."""
    points = []
    for n in counts:
        pt = summarize(n, run_point(n, fs_per_dev, ch_per_dev, device_type))
        p1 = points[0] if points else pt
        pt['efficiency'] = pt['wideband_sps'] / (n * p1['wideband_sps'])
        pt['work_inflation'] = pt['cpu_s_per_stream_s'] \
            / p1['cpu_s_per_stream_s']
        pt['decoded_equal_n1'] = pt['decoded'] == p1['decoded']
        points.append(pt)
        if say is not None:
            say(pt)
    ok = all(p['decode_ok'] and p['decoded_equal_n1']
             and p['decoded_equal_across_ranks']
             and p['bytes_equal_comm_model'] for p in points)
    return dict(
        metric='weak-scaling samples/s, ShardedWidebandReceiver '
               '(time-sharded channelizer + channel-sharded demod)',
        mesh='N x 1 (time), one process per device over localhost',
        device_type=device_type, host_cpus=os.cpu_count(),
        fs_per_device=fs_per_dev, channels_per_device=ch_per_dev,
        points=points, ok=ok)


def main(argv=None) -> int:
    from ..device import require_cuda
    ap = argparse.ArgumentParser(
        prog='python -m dumphfdl_tpu_torch.tools.bench_scaling',
        description=__doc__.splitlines()[0])
    ap.add_argument('--devices', type=int, default=4,
                    help='the largest N (1, 2, 4, ...)')
    ap.add_argument('--fs-per-device', type=int, default=2_160_000)
    ap.add_argument('--channels-per-device', type=int, default=512)
    ap.add_argument('--device', default=None,
                    help='cuda (default; rank r on cuda:r) or cpu; a rank '
                         'process: its device')
    ap.add_argument('--out', default=None)
    # what a rank process runs: its share of the point of N devices
    ap.add_argument('--rank-of', type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        out = run_rank(args.rank_of, args.fs_per_device,
                       args.channels_per_device, args.device)
        print(json.dumps(out), flush=True)
        return 0
    device_type = torch.device(args.device or 'cuda').type
    if device_type == 'cuda':
        require_cuda()
        visible = torch.cuda.device_count()
    else:
        visible = args.devices
    counts = [n for n in (1, 2, 4, 8, 16) if n <= min(args.devices, visible)]
    out = scaling(counts, args.fs_per_device, args.channels_per_device,
                  device_type,
                  say=lambda pt: print(f'# {json.dumps(pt)}', file=sys.stderr,
                                       flush=True))
    text = json.dumps(out)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(text + '\n')
    print(text)
    return 0 if out['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
