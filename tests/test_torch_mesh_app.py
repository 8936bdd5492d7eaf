"""PyTorch port, the multi-device slice as a whole on CPU shards: the
sharded receiver against the JAX sharded receiver and against the port's
own single-device receiver, HfdlApp and the CLI with a mesh, and
--profile."""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

import jax  # noqa: E402

from dumphfdl_tpu.parallel import sharding as jsh  # noqa: E402
from dumphfdl_tpu_torch import cli  # noqa: E402
from dumphfdl_tpu_torch.app import AppConfig, HfdlApp  # noqa: E402
from dumphfdl_tpu_torch.dsp import modulator  # noqa: E402
from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver  # noqa: E402
from dumphfdl_tpu_torch.io import formats  # noqa: E402
from dumphfdl_tpu_torch.io.outputs import OutputManager  # noqa: E402
from dumphfdl_tpu_torch.parallel import sharding as sh  # noqa: E402
from dumphfdl_tpu_torch.protocol.runtime import ProtocolContext  # noqa: E402
from dumphfdl_tpu_torch.utils import profiling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / 'tests' / 'golden'
MANIFEST = json.loads((GOLDEN / 'manifest.json').read_text())


@pytest.fixture(autouse=True)
def _pinned_paths(monkeypatch):
    """The single-device receiver on its unfused or fused path (the path
    the mesh runs is the unfused one), and no JAX bank sharding itself."""
    monkeypatch.setenv('DUMPHFDL_NO_SUPERSTEP', '1')
    monkeypatch.setenv('DUMPHFDL_NO_AUTOSHARD', '1')


def _decode(rx, wb, step):
    events = []
    for off in range(0, len(wb), step):
        events.extend(rx.process(wb[off:off + step]))
    events.extend(rx.flush())
    return (sorted((e.channel, e.mode, e.pdu) for e in events if e.pdu),
            {e.channel: e.freq_err_hz for e in events if e.pdu})


@pytest.fixture(scope='module')
def decodes():
    """The capture of tests/test_sharding.py (43.2 kHz, three channels, a
    mode-1 frame on the first and a mode-3 frame on the last) through the
    port's single-device receiver, its sharded receiver on a 2x2 mesh of
    CPU shards, and the JAX sharded receiver on a 2x2 mesh of virtual CPU
    devices."""
    fs, center = 43_200, 10_000_000
    chans = [9_990_000, 10_000_000, 10_008_000]
    rng = np.random.default_rng(42)
    pdus = [modulator.make_test_mpdu(1, rng, icao=0xABCDEF),
            modulator.make_test_mpdu(3, rng, icao=0x777777)]
    wb = modulator.synthesize_wideband_fft(
        [(pdus[0], 1, chans[0]), (pdus[1], 3, chans[2])],
        fs=fs, centerfreq=center, snr_db=25.0)
    mesh = sh.make_mesh(['cpu'] * 4)
    assert mesh.shape == {'time': 2, 'chan': 2}
    # the function-scoped pins above do not reach a module's fixture
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DUMPHFDL_NO_SUPERSTEP', '1')
        mp.setenv('DUMPHFDL_NO_AUTOSHARD', '1')
        rxs = {'single': WidebandReceiver(fs, center, chans, 'cpu'),
               'sharded': sh.ShardedWidebandReceiver(fs, center, chans, mesh),
               'jax': jsh.ShardedWidebandReceiver(
                   fs, center, chans,
                   mesh=jsh.make_mesh(jax.devices()[:4]))}
        out = {name: _decode(rx, wb, fs // 3) for name, rx in rxs.items()}
    return pdus, out, rxs['sharded']


def test_sharded_receiver_matches_single_device(decodes):
    pdus, out, _ = decodes
    assert out['sharded'][0] == out['single'][0] == \
        [(0, 1, pdus[0]), (2, 3, pdus[1])]
    for chan, ferr in out['single'][1].items():
        assert abs(ferr - out['sharded'][1][chan]) < 0.1


def test_sharded_receiver_matches_jax_sharded_receiver(decodes):
    _, out, _ = decodes
    assert out['sharded'][0] == out['jax'][0]
    for chan, ferr in out['jax'][1].items():
        assert abs(ferr - out['sharded'][1][chan]) < 0.1


def test_sharded_receiver_traffic_is_the_models(decodes):
    """Over the whole decode, flush included, only halo and reshard bytes
    crossed between shards, the model's amount per super-block."""
    _, _, rx = decodes
    model, steps = rx.comm_model(), rx.frontend.steps
    assert steps > 4
    assert rx.mesh.moved == {
        'halo': steps * model['halo_bytes_per_superblock'],
        'reshard': steps * model['reshard_bytes_per_superblock']}
    assert rx.frontend.upload_bytes == \
        steps * model['upload_bytes_per_superblock']


def _golden_argv(out, *extra):
    return ['--iq-file', str(GOLDEN / MANIFEST['capture']),
            '--sample-format', MANIFEST['format'],
            '--sample-rate', str(MANIFEST['sample_rate']),
            '--centerfreq', str(MANIFEST['centerfreq'] / 1000),
            '--output', f'decoded:text:file:path={out}', *extra] \
        + [str(f / 1000) for f in MANIFEST['frequencies']]


def test_app_with_cpu_mesh_decodes_golden_capture(tmp_path, monkeypatch):
    """HfdlApp with a mesh the test supplies (1x2 CPU shards, one golden
    channel each): run_file feeds host chunks to the sharded receiver and
    the pinned bytes come out."""
    seen = []
    handle = HfdlApp.handle_events
    monkeypatch.setattr(HfdlApp, 'handle_events', lambda self, evs: (
        seen.extend(evs), handle(self, evs))[1])
    ctx = ProtocolContext()
    cfg = AppConfig(frequencies=MANIFEST['frequencies'],
                    sample_rate=MANIFEST['sample_rate'], device='cpu',
                    centerfreq=MANIFEST['centerfreq'],
                    sample_format=MANIFEST['format'],
                    mesh=sh.make_mesh(['cpu'] * 2))
    app = HfdlApp(cfg, ctx, OutputManager(ctx, hwm=0))
    assert isinstance(app.receiver, sh.ShardedWidebandReceiver)
    assert app.run_file(str(GOLDEN / MANIFEST['capture'])) == 0
    app.shutdown()
    assert {(e.channel, e.mode): e.pdu.hex() for e in seen if e.pdu} == \
        {(f['channel'], f['mode']): f['pdu_hex'] for f in MANIFEST['frames']}
    assert app.frames_decoded == len(MANIFEST['frames'])


def test_cli_mesh_needs_its_cuda_devices(tmp_path):
    """--mesh 2x2 takes cuda:0..3 and nothing else: with fewer visible it
    raises the JAX app's ValueError (no CPU mesh, no smaller mesh, no
    device named twice)."""
    if torch.cuda.device_count() >= 4:
        pytest.skip('four CUDA devices are visible')
    with pytest.raises(ValueError, match=r'mesh 2x2 needs 4 devices, have '
                       + str(torch.cuda.device_count())):
        cli.main(_golden_argv(tmp_path / 'o.txt', '--mesh', '2x2'),
                 device='cpu')


def _quiet_capture(tmp_path, seconds=0.4):
    """A 48 kHz CS16 capture of faint noise: a few blocks, no frame."""
    rng = np.random.default_rng(1)
    n = int(48_000 * seconds)
    wb = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 1e-3) \
        .astype(np.complex64)
    path = tmp_path / 'quiet.cs16'
    path.write_bytes(formats.serialize(wb, 'CS16'))
    return path, wb


def test_profile_writes_a_parsable_trace(tmp_path, capsys):
    """--profile DIR brackets the run with torch.profiler and leaves a
    Chrome trace that parses and holds the run's operations."""
    path, _ = _quiet_capture(tmp_path)
    prof_dir = tmp_path / 'prof'
    rc = cli.main(['--iq-file', str(path), '--sample-format', 'CS16',
                   '--sample-rate', '48000', '--centerfreq', '8930',
                   '--profile', str(prof_dir),
                   '--output', f'decoded:text:file:path={tmp_path / "o.txt"}',
                   '8912', '8942'], device='cpu')
    assert rc == 0
    assert f'profiling to {prof_dir}' in capsys.readouterr().err
    trace = json.loads((prof_dir / profiling.TRACE_NAME).read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'aten::_fft_c2c' in names and len(trace['traceEvents']) > 100


def test_profile_closes_when_the_run_fails(tmp_path, monkeypatch):
    """The trace is closed and written in the finally, as the JAX CLI
    closes its own."""
    path, _ = _quiet_capture(tmp_path)

    def boom(self, *a, **k):
        raise RuntimeError('input failed')
    monkeypatch.setattr(HfdlApp, 'run_file', boom)
    with pytest.raises(RuntimeError, match='input failed'):
        cli.main(['--iq-file', str(path), '--sample-format', 'CS16',
                  '--sample-rate', '48000', '--profile', str(tmp_path / 'p'),
                  '8912'], device='cpu')
    assert (tmp_path / 'p' / profiling.TRACE_NAME).exists()


def test_run_stream_feeds_the_mesh_host_blocks(tmp_path):
    """run_stream with a mesh hands the ingest ring's host blocks straight
    to the sharded receiver (no upload thread).  The ring holds four
    blocks, more than the whole capture, so the generator, which does not
    wait as an SDR would, overruns nothing."""
    _, wb = _quiet_capture(tmp_path, seconds=1.5)
    ctx = ProtocolContext()
    cfg = AppConfig(frequencies=[8_912_000, 8_942_000], sample_rate=48_000,
                    device='cpu', centerfreq=8_930_000,
                    mesh=sh.make_mesh(['cpu'] * 2),
                    stream_chunk_samples=32_768)
    app = HfdlApp(cfg, ctx, OutputManager(ctx, hwm=0))
    assert app.run_stream(wb[o:o + 4096] for o in range(0, len(wb), 4096)) \
        == 0
    app.shutdown()
    rx = app.receiver
    assert rx.sample_clock == -(-len(wb) // 32_768) * 32_768
    assert rx.frontend.steps == rx.sample_clock // rx.frontend.super_len >= 1
    assert app.last_ingest_overruns == 0


def test_device_profile_sums_no_device_time_on_the_cpu():
    """device_profile reads only device events: a CPU trace has none."""
    with profiling.profiler('cpu') as prof:
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    dp = profiling.device_profile(prof, 1.0)
    assert dp['device_events'] == 0 and dp['busy_ms'] == 0.0
    assert dp['by_kind'] == {}
