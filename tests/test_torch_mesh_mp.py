"""PyTorch port, the ('time', 'chan') mesh across processes: two real gloo
processes over localhost, each rank holding its own shards.  DeviceMesh's
copies between ranks, the sharded receiver's events against the
one-process mesh's (which tests/test_torch_mesh_app.py holds to the JAX
sharded receiver), HfdlApp on the golden capture through the child program
chip_smoke.py spawns (dumphfdl_tpu_torch/tools/mesh_mp.py), the CLI under
--mesh in a multi-process job, and a rank that fails."""

import datetime
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu_torch.app import AppConfig, HfdlApp  # noqa: E402
from dumphfdl_tpu_torch.dsp import modulator  # noqa: E402
from dumphfdl_tpu_torch.io import formats  # noqa: E402
from dumphfdl_tpu_torch.io.outputs import OutputManager  # noqa: E402
from dumphfdl_tpu_torch.parallel import sharding as sh  # noqa: E402
from dumphfdl_tpu_torch.protocol.runtime import ProtocolContext  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / 'tests' / 'golden'
MANIFEST = json.loads((GOLDEN / 'manifest.json').read_text())
TIMEOUT = 60            # seconds any collective of a group may take
WAIT = 120              # seconds a child may run in all


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start(n: int, argv: list[str]) -> list[subprocess.Popen]:
    """n processes of one gloo job over localhost, each running argv."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('DUMPHFDL_')}
    env.update(PYTHONPATH=str(ROOT), DUMPHFDL_NO_SUPERSTEP='1',
               DUMPHFDL_COORDINATOR=f'127.0.0.1:{_free_port()}',
               DUMPHFDL_NUM_PROCESSES=str(n))
    return [subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                             env={**env, 'DUMPHFDL_PROCESS_ID': str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(n)]


def _finish(procs) -> list[tuple[int, dict | None, str]]:
    """(return code, the JSON of the last stdout line or None, stderr) of
    each process, in rank order; kills them all if one outlives WAIT."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=WAIT)
            lines = o.strip().splitlines()
            out.append((p.returncode,
                        json.loads(lines[-1]) if p.returncode == 0 and lines
                        else None, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _ok(results):
    for rc, res, err in results:
        assert rc == 0 and res is not None, err[-3000:]
    return [res for _, res, _ in results]


def test_backend_and_timeout_of_the_group(monkeypatch):
    """backend='gloo' makes a CUDA device's ranks a gloo group (ranks that
    share a card, which nccl refuses); nccl for a CPU device and other
    backends are refused; timeout bounds the group's collectives."""
    from dumphfdl_tpu_torch.parallel import multihost as mh
    calls = []
    monkeypatch.setattr(mh.dist, 'init_process_group',
                        lambda **kw: calls.append(kw))
    assert mh.init_distributed('127.0.0.1:1', 2, 0, device='cuda:0',
                               backend='gloo', timeout=30) is True
    assert calls == [dict(backend='gloo', init_method='tcp://127.0.0.1:1',
                          world_size=2, rank=0,
                          timeout=datetime.timedelta(seconds=30))]
    for device, backend in (('cpu', 'nccl'), ('cuda:0', 'mpi')):
        with pytest.raises(ValueError, match=f'backend {backend}'):
            mh.init_distributed('127.0.0.1:1', 2, 0, device=device,
                                backend=backend)
    assert len(calls) == 1


_SEND_CHILD = r'''
import json, torch
torch.set_num_threads(1)
from dumphfdl_tpu_torch.parallel import multihost
from dumphfdl_tpu_torch.parallel.sharding import make_mesh
assert multihost.init_distributed(device='cpu', timeout=20)
rank = multihost.process_index()
# two shards per rank: time row 0 is rank 0, row 1 rank 1
shards = multihost.global_shards(['cpu', 'cpu'])
mesh = make_mesh(shards)
try:        # rank 0's shards alone: rank 1 would hold none
    make_mesh(shards[:2])
    refused = None
except ValueError as e:
    refused = str(e)
assert mesh.shape == {'time': 2, 'chan': 2} and mesh.multiprocess
got = {}
for i, kind in enumerate(('halo', 'reshard')):
    x = (torch.arange(6, dtype=torch.float32) + 10 * i) \
        * (1 + 1j) ** torch.arange(6)
    x = x.to(torch.complex64)
    a, b, c = mesh.shard(0, 0), mesh.shard(1, 0), mesh.shard(0, 1)
    # one copy each way between the ranks, one within rank 0
    moves = [(a, b, x if rank == 0 else None),
             (mesh.shard(1, 1), c, x + 1 if rank == 1 else None),
             (a, c, x - 1 if rank == 0 else None)]
    out = mesh.exchange(kind, moves, (6,))
    got[kind] = {f'{mesh.index(s)}->{mesh.index(d)}':
                 torch.view_as_real(v).tolist() for (s, d), v in out.items()}
    # send(): the single copy, its shape named on the receiving rank
    one = mesh.send(x * 2 if rank == 1 else None, b, a, kind, (6,),
                    torch.complex64)
    got[kind]['send'] = None if one is None else \
        torch.view_as_real(one).tolist()
print(json.dumps({'rank': rank, 'refused': refused, 'got': got,
                  'moved': mesh.moved,
                  'copies': mesh.copies, 'received': mesh.received,
                  'staged': mesh.staged,
                  'local': [mesh.index(s) for s in mesh.local_shards]}))
torch.distributed.destroy_process_group()
'''


def test_send_between_ranks_copies_and_counts():
    """Copies between ranks and within one, for each kind: exact, counted
    by the sending rank and, between ranks, by the receiving one too (none
    staged: CPU tensors)."""
    r0, r1 = _ok(_finish(_start(2, ['-c', _SEND_CHILD])))
    assert (r0['local'], r1['local']) == ([0, 1], [2, 3])
    for r in (r0, r1):
        assert 'takes shards from every rank' in r['refused']
    for i, kind in enumerate(('halo', 'reshard')):
        x = ((torch.arange(6, dtype=torch.float32) + 10 * i)
             * (1 + 1j) ** torch.arange(6)).to(torch.complex64)
        real = lambda v: torch.view_as_real(v).tolist()
        assert r1['got'][kind] == {'0->2': real(x), 'send': None}
        assert r0['got'][kind] == {'3->1': real(x + 1), '0->1': real(x - 1),
                                   'send': real(x * 2)}
    assert r0['moved'] == {'halo': 96, 'reshard': 96}
    assert r0['copies'] == {'halo': 2, 'reshard': 2}
    assert r1['moved'] == {'halo': 96, 'reshard': 96}
    assert r1['copies'] == {'halo': 2, 'reshard': 2}
    # 48 B a copy: rank 0 gets two from rank 1, rank 1 one from rank 0
    assert r0['received'] == {'halo': 96, 'reshard': 96}
    assert r1['received'] == {'halo': 48, 'reshard': 48}
    assert r0['staged'] == r1['staged'] == {}


def _child(capture: pathlib.Path, fmt: str, fs: int, center: int, freqs,
           mesh: str, per_rank: int) -> list[str]:
    return ['-m', 'dumphfdl_tpu_torch.tools.mesh_mp', '--mesh', mesh,
            '--shards-per-rank', str(per_rank), '--device', 'cpu',
            '--timeout', str(TIMEOUT), '--',
            '--iq-file', str(capture), '--sample-format', fmt,
            '--sample-rate', str(fs), '--centerfreq', str(center / 1000),
            '--output', 'decoded:text:file:path=/dev/null'] \
        + [str(f / 1000) for f in freqs]


def _one_process(capture, fmt, fs, center, freqs, mesh):
    """The same file through HfdlApp on a mesh of CPU shards in this
    process: (events as the child reports them, the app)."""
    seen = []
    ctx = ProtocolContext()
    cfg = AppConfig(frequencies=list(freqs), sample_rate=fs, device='cpu',
                    centerfreq=center, sample_format=fmt, mesh=mesh)
    app = HfdlApp(cfg, ctx, OutputManager(ctx, hwm=0))
    handle = app.handle_events
    app.handle_events = lambda evs: (seen.extend(evs), handle(evs))[1]
    assert app.run_file(str(capture)) == 0
    app.shutdown()
    return [[v.hex() if isinstance(v, bytes) else v for v in ev]
            for ev in seen], app


@pytest.mark.parametrize('spec,ranks,per_rank', [
    ('2x2', 2, 2),      # two ranks of two CPU shards: time row t is rank t
    ('4x1', 4, 1),      # four ranks of one: three halos cross processes
])
def test_two_process_mesh_equals_one_process_mesh(tmp_path, monkeypatch,
                                                  spec, ranks, per_rank):
    """The 43.2 kHz three-channel capture of tests/test_torch_mesh_app.py
    on a mesh whose time rows are processes: each rank's events equal the
    one-process mesh's of the same shape field for field (same arithmetic,
    copies exact), and the bytes counted over the ranks equal the
    one-process mesh's and comm_model()'s."""
    monkeypatch.setenv('DUMPHFDL_NO_SUPERSTEP', '1')
    fs, center = 43_200, 10_000_000
    chans = [9_990_000, 10_000_000, 10_008_000]
    rng = np.random.default_rng(42)
    pdus = [modulator.make_test_mpdu(1, rng, icao=0xABCDEF),
            modulator.make_test_mpdu(3, rng, icao=0x777777)]
    wb = modulator.synthesize_wideband_fft(
        [(pdus[0], 1, chans[0]), (pdus[1], 3, chans[2])],
        fs=fs, centerfreq=center, snr_db=25.0)
    cap = tmp_path / 'mesh.cf32'
    cap.write_bytes(formats.serialize(wb, 'CF32'))
    procs = _start(ranks, _child(cap, 'CF32', fs, center, chans, spec,
                                 per_rank))
    t_ax, k_ax = sh.parse_mesh(spec)
    try:
        want, app = _one_process(cap, 'CF32', fs, center, chans,
                                 sh.DeviceMesh([['cpu'] * k_ax] * t_ax))
    finally:
        results = _ok(_finish(procs))
    assert sorted((e[0], e[1], bytes.fromhex(e[9])) for e in want
                  if e[9]) == [(0, 1, pdus[0]), (2, 3, pdus[1])]
    rx = app.receiver
    model, steps = rx.comm_model(), rx.frontend.steps
    for r in results:
        p = r['passes'][0]
        assert r['transport'] == 'gloo' and p['events'] == want
        assert p['super_blocks'] == steps
        assert p['gather_bytes'] > 0 and not p['staged']
    passes = [r['passes'][0] for r in results]
    moved = {k: sum(p['moved'].get(k, 0) for p in passes)
             for k in ('halo', 'reshard')}
    assert moved == rx.mesh.moved == {
        'halo': steps * model['halo_bytes_per_superblock'],
        'reshard': steps * model['reshard_bytes_per_superblock']}
    # every copy of this mesh crosses between the ranks
    assert {k: sum(p['received'].get(k, 0) for p in passes)
            for k in moved} == moved
    assert sum(p['upload_bytes'] for p in passes) == \
        rx.frontend.upload_bytes == \
        steps * model['upload_bytes_per_superblock']
    assert [p['comm_model'] for p in passes] == [model] * ranks


def test_app_on_two_process_mesh_emits_golden_pdus(tmp_path):
    """HfdlApp (built as the CLI builds it) on the golden capture with a
    2x1 mesh whose time rows are the two ranks: both ranks emit the pinned
    PDUs, the halo and the reshard crossing between the processes."""
    capture = GOLDEN / MANIFEST['capture']
    results = _ok(_finish(_start(2, _child(
        capture, MANIFEST['format'], MANIFEST['sample_rate'],
        MANIFEST['centerfreq'], MANIFEST['frequencies'], '2x1', 1))))
    want = {(f['channel'], f['mode']): f['pdu_hex']
            for f in MANIFEST['frames']}
    for r in results:
        p = r['passes'][0]
        assert {(e[0], e[1]): e[9] for e in p['events'] if e[9]} == want
    p0, p1 = (r['passes'][0] for r in results)
    assert (p0['local_shards'], p1['local_shards']) == ([0], [1])
    # the halo goes from time row 0 to row 1, the reshard both ways
    assert set(p0['moved']) == {'halo', 'reshard'}
    assert set(p1['moved']) == {'reshard'}


_CLI_CHILD = r'''
import json, sys, torch
torch.set_num_threads(1)
torch.cuda.device_count = lambda: 8     # what counts is the job's shards
from dumphfdl_tpu_torch import app as app_mod, cli
from dumphfdl_tpu_torch.parallel import multihost
base = ['--iq-file', 'unused', '--sample-format', 'CS16', '--sample-rate',
        '48000', '--centerfreq', '8930', '--output',
        'decoded:text:file:path=/dev/null', '8912', '8927', '8942']
app = cli.build_app(cli.build_parser().parse_args(['--mesh', '2x1'] + base),
                    torch.device('cpu'))
mesh = app.receiver.mesh
res = {'rank': multihost.process_index(), 'freqs': app.cfg.frequencies,
       'shape': mesh.shape,
       'local': [mesh.index(s) for s in mesh.local_shards],
       'ranks': [s.rank for s in mesh.shards]}
app.shutdown()
for argv in (['--mesh', '2x2'], ['--mesh', '2x1', '--datadumps']):
    try:
        cli.build_app(cli.build_parser().parse_args(argv + base),
                      torch.device('cpu')).shutdown()
        res[argv[-1]] = None
    except ValueError as e:
        res[argv[-1]] = str(e)
print(json.dumps(res))
torch.distributed.destroy_process_group()
'''


def test_cli_mesh_in_a_multiprocess_job_takes_the_jobs_shards():
    """--mesh in a two-process job: no channel slicing, the mesh over the
    job's shards (one per process, rank order, whatever the local device
    count says), the CLI's one line; a mesh larger than the job raises as
    app._mesh_for does in one process, and --datadumps is refused there
    (the JAX package cannot fetch a non-addressable array for it either)."""
    results = _finish(_start(2, ['-c', _CLI_CHILD]))
    (r0, r1) = _ok(results)
    for r, (_, _, err) in zip((r0, r1), results):
        assert r['freqs'] == [8_912_000, 8_927_000, 8_942_000]
        assert r['shape'] == {'time': 2, 'chan': 1} and r['ranks'] == [0, 1]
        assert r['local'] == [r['rank']]
        assert f'multi-host: process {r["rank"]}/2, mesh 2x1, shards ' \
            f'[{r["rank"]}]' in err
        assert 'channels [' not in err
        assert r['2x2'] == 'mesh 2x2 needs 4 devices, have 2'
        assert 'not available on a mesh across processes' in r['--datadumps']


_FAIL_CHILD = r'''
import torch
torch.set_num_threads(1)
from dumphfdl_tpu_torch.parallel import multihost
from dumphfdl_tpu_torch.parallel.sharding import make_mesh
assert multihost.init_distributed(device='cpu', timeout=10)
mesh = make_mesh(multihost.global_shards(['cpu']), time_axis=2)
a, b = mesh.shard(0, 0), mesh.shard(1, 0)
if multihost.process_index() == 1:
    raise RuntimeError('rank 1 fails before its first exchange')
mesh.send(None, b, a, 'halo', (8,), torch.complex64)   # waits for rank 1
print('{}')
'''


def test_a_failing_rank_ends_the_other_within_the_timeout():
    """A rank that raises before its first exchange leaves the other
    waiting on a receive: that one exits non-zero within the group's
    timeout, it does not hang."""
    t0 = time.perf_counter()
    (rc0, out0, err0), (rc1, _, err1) = _finish(_start(2, ['-c', _FAIL_CHILD]))
    assert rc1 != 0 and 'rank 1 fails' in err1
    assert rc0 != 0 and out0 is None, err0[-2000:]
    assert time.perf_counter() - t0 < 10 + 30


_LIVE_CHILD = r'''
import json, torch
torch.set_num_threads(1)
torch.cuda.device_count = lambda: 8     # what counts is the job's shards
from dumphfdl_tpu_torch import cli
from dumphfdl_tpu_torch.io import soapy_input
from dumphfdl_tpu_torch.parallel import multihost
opened = []


class NoSdr:
    """Stands in for SoapyInput: records being built and connected."""
    def __init__(self, *a, **kw):
        opened.append('built')

    def connect(self):
        opened.append('connect')


soapy_input.SoapyInput = NoSdr
freqs = ['--output', 'decoded:text:file:path=/dev/null', '8912', '8927',
         '8942']
res = {'rank': None, 'refused': None}
try:
    cli.main(['--mesh', '2x1', '--soapysdr', 'driver=none', '--sample-rate',
              '48000', '--centerfreq', '8930'] + freqs, device='cpu')
except SystemExit as e:
    res['refused'] = str(e)
res['rank'] = multihost.process_index()
res['opened'] = opened
# the app API: the live paths raise on a mesh across processes, before they
# take a sample from the source
app = cli.build_app(cli.build_parser().parse_args(
    ['--mesh', '2x1', '--iq-file', 'unused', '--sample-format', 'CS16',
     '--sample-rate', '48000', '--centerfreq', '8930'] + freqs),
    torch.device('cpu'))
taken = []


def source():
    taken.append(1)
    yield from ()


for name, run in (('run_stream', lambda: app.run_stream(source())),
                  ('run_stream_raw',
                   lambda: app.run_stream_raw(source(), 'CS16'))):
    try:
        run()
        res[name] = None
    except ValueError as e:
        res[name] = str(e)
res['multiprocess'] = app.receiver.mesh.multiprocess
res['samples_taken'] = len(taken)
app.shutdown()
print(json.dumps(res))
torch.distributed.destroy_process_group()
'''


@pytest.fixture(scope='module')
def live_on_a_multiprocess_mesh():
    """The ranks of a two-process gloo job, each trying a live source on a
    2x1 mesh across the processes: through the CLI, then through the app."""
    return _ok(_finish(_start(2, ['-c', _LIVE_CHILD])))


def test_cli_refuses_soapysdr_on_a_multiprocess_mesh(
        live_on_a_multiprocess_mesh):
    """--soapysdr with --mesh in a multi-process job: every rank exits with
    the refusal before any SDR is built or connected (so no SoapySDR is
    needed here)."""
    for rank, r in enumerate(live_on_a_multiprocess_mesh):
        assert r['rank'] == rank
        assert '--soapysdr cannot feed --mesh in a multi-process job' \
            in r['refused']
        assert r['opened'] == []


def test_live_paths_raise_on_a_multiprocess_mesh(live_on_a_multiprocess_mesh):
    """HfdlApp.run_stream and run_stream_raw raise a ValueError on a mesh
    across processes before they take a sample (the API's callers, not
    only the CLI's, are covered)."""
    for r in live_on_a_multiprocess_mesh:
        assert r['multiprocess'] is True
        for name in ('run_stream', 'run_stream_raw'):
            assert 'not available on a mesh across processes' in r[name]
        assert r['samples_taken'] == 0
