"""PyTorch port, parallel/multihost: the channel slice of each process
against the JAX package's, the single-process return, and two real gloo
processes over localhost, each through cli.build_app, started by
launch_local_ranks, which ends a job whose rank fails or runs late."""

import sys
import time

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from dumphfdl_tpu.parallel import multihost as jmh  # noqa: E402
from dumphfdl_tpu_torch.parallel import multihost as mh  # noqa: E402

_VARS = ('DUMPHFDL_COORDINATOR', 'DUMPHFDL_NUM_PROCESSES',
         'DUMPHFDL_PROCESS_ID')


@pytest.mark.parametrize('n,num_channels', [(1, 5), (2, 8), (2, 3), (3, 8),
                                            (4, 2), (8, 512)])
def test_local_channel_slice_partitions_as_jax(monkeypatch, n, num_channels):
    got, want = [], []
    for rank in range(n):
        monkeypatch.setattr(mh, 'process_count', lambda: n)
        monkeypatch.setattr(mh, 'process_index', lambda: rank)
        monkeypatch.setattr(jax, 'process_count', lambda: n)
        monkeypatch.setattr(jax, 'process_index', lambda: rank)
        got.append(mh.local_channel_slice(num_channels))
        want.append(jmh.local_channel_slice(num_channels))
    assert got == want
    # contiguous, disjoint, covering
    chans = list(range(num_channels))
    assert sum((chans[s] for s in got), []) == chans


def test_single_process_is_not_distributed(monkeypatch):
    """No coordinator, or one process: False, nothing initialized, the
    whole channel list local (as the JAX function)."""
    for v in _VARS:
        monkeypatch.delenv(v, raising=False)
    assert mh.init_distributed(device='cpu') is False
    assert jmh.init_distributed() is False
    monkeypatch.setenv('DUMPHFDL_COORDINATOR', '127.0.0.1:1')
    monkeypatch.setenv('DUMPHFDL_NUM_PROCESSES', '1')
    assert mh.init_distributed(device='cpu') is False
    assert mh.init_distributed('127.0.0.1:1', 1, 0, device='cpu') is False
    with pytest.raises(TypeError):       # the device is always named
        mh.init_distributed()
    assert not torch.distributed.is_initialized()
    assert (mh.process_count(), mh.process_index()) == (1, 0)
    assert mh.local_channel_slice(7) == slice(0, 7)


def test_arguments_override_the_environment(monkeypatch):
    """An argument that is given wins over its environment variable, rank 0
    included; the backend follows the device."""
    monkeypatch.setenv('DUMPHFDL_COORDINATOR', 'elsewhere:9')
    monkeypatch.setenv('DUMPHFDL_NUM_PROCESSES', '7')
    monkeypatch.setenv('DUMPHFDL_PROCESS_ID', '5')
    calls = []
    monkeypatch.setattr(mh.dist, 'init_process_group',
                        lambda **kw: calls.append(kw))
    assert mh.init_distributed('127.0.0.1:1', 2, 0, device='cpu') is True
    assert mh.init_distributed(device='cuda:0') is True
    assert calls == [
        dict(backend='gloo', init_method='tcp://127.0.0.1:1', world_size=2,
             rank=0),
        dict(backend='nccl', init_method='tcp://elsewhere:9', world_size=7,
             rank=5)]


_CHILD = r'''
import json, sys
import torch
torch.set_num_threads(1)
from dumphfdl_tpu_torch import cli
from dumphfdl_tpu_torch.parallel import multihost
freqs = sys.argv[1:]
args = cli.build_parser().parse_args(
    ['--iq-file', 'unused', '--sample-format', 'CS16', '--sample-rate',
     '48000', '--centerfreq', '8930', '--output',
     'decoded:text:file:path=/dev/null'] + freqs)
try:
    app = cli.build_app(args, torch.device('cpu'))
    local = app.cfg.frequencies
    app.shutdown()
except SystemExit as e:
    local = str(e)
print(json.dumps({'rank': multihost.process_index(),
                  'nprocs': multihost.process_count(),
                  'initialized': torch.distributed.is_initialized(),
                  'backend': torch.distributed.get_backend(),
                  'local': local,
                  'modules': sorted(m for m in sys.modules
                                    if m.split('.')[0] in ('jax',
                                                           'dumphfdl_tpu'))}),
      flush=True)
torch.distributed.destroy_process_group()
'''


def _two_processes(freqs, tmp_path):
    """Two ranks through mh.launch_local_ranks: each rank's JSON and its
    standard error, in rank order."""
    results = mh.launch_local_ranks(
        [[sys.executable, '-c', _CHILD, *freqs]] * 2, tmp_path, 120)
    return [(r, (tmp_path / f'{i}.err').read_text())
            for i, r in enumerate(results)]


def test_two_gloo_processes_slice_the_channel_list(tmp_path):
    """Two real processes rendezvous over localhost (gloo, a CPU device);
    cli.build_app gives each its contiguous slice and prints the JAX CLI's
    line."""
    (r0, err0), (r1, err1) = _two_processes(['8912', '8927', '8942'], tmp_path)
    for r in (r0, r1):
        assert r['nprocs'] == 2 and r['initialized']
        assert r['backend'] == 'gloo' and r['modules'] == []
    assert (r0['rank'], r1['rank']) == (0, 1)
    assert r0['local'] == [8_912_000, 8_927_000]
    assert r1['local'] == [8_942_000]
    assert 'multi-host: process 0/2, channels [0:2] of 3' in err0
    assert 'multi-host: process 1/2, channels [2:3] of 3' in err1


def test_a_process_without_channels_exits(tmp_path):
    """One channel for two processes: the second has none and exits with
    the JAX CLI's message."""
    (r0, _), (r1, err1) = _two_processes(['8912'], tmp_path)
    assert r0['local'] == [8_912_000]
    assert r1['local'] == 'error: no channels assigned to this host'
    assert 'channels [1:1] of 1' in err1


_SLOW_OR_FAILING = r'''
import os, sys, time
if os.environ['DUMPHFDL_PROCESS_ID'] == sys.argv[1]:
    sys.exit('rank fails on purpose')
time.sleep(60)
'''


@pytest.mark.parametrize('failing, deadline, why', [
    ('1', 60, 'rank 1 of 2 exited with 1: rank fails on purpose'),
    ('none', 2, 'ranks still running after 2 s')])
def test_launch_local_ranks_ends_the_job(tmp_path, failing, deadline, why):
    """A rank that exits non-zero, or ranks that outlive the deadline, end
    the job at once: the launcher raises with the reason and kills the
    ranks still running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        mh.launch_local_ranks(
            [[sys.executable, '-c', _SLOW_OR_FAILING, failing]] * 2,
            tmp_path, deadline)
    assert str(err.value).startswith(why)
    assert time.monotonic() - t0 < 30
