"""PyTorch port, the offline decode slice end to end on the CPU: the
golden capture through the port's WidebandReceiver and CLI against the
manifest and the JAX package, and the port's independence from jax."""

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu import cli as jcli  # noqa: E402
from dumphfdl_tpu.dsp.receiver import WidebandReceiver as JReceiver  # noqa: E402
from dumphfdl_tpu.io import formats  # noqa: E402
from dumphfdl_tpu_torch import cli  # noqa: E402
from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / 'tests' / 'golden'
MANIFEST = json.loads((GOLDEN / 'manifest.json').read_text())
INT_FIELDS = ('channel', 'mode', 'bitmask', 'train_bad', 'train_total',
              'start_symbol', 'fcs_ok', 'pdu')


@pytest.fixture
def jax_fused_path(monkeypatch):
    """Hold the port against the JAX path it ports: the resample-fused step
    on one device.  Without these settings the JAX receiver takes the
    unfused channel-sharded path when the test mesh has several devices,
    or engages the superstep; those paths differ from the fused one in
    float rounding and in the noise-floor start-up, and the suite's other
    files set DUMPHFDL_NO_AUTOSHARD process-wide when they are collected."""
    monkeypatch.setenv('DUMPHFDL_NO_AUTOSHARD', '1')
    monkeypatch.setenv('DUMPHFDL_NO_SUPERSTEP', '1')


def _decode(rx):
    wb = formats.convert((GOLDEN / MANIFEST['capture']).read_bytes(),
                         MANIFEST['format'])
    events = []
    step = MANIFEST['sample_rate'] // 4
    for off in range(0, len(wb), step):
        events.extend(rx.process(wb[off:off + step]))
    events.extend(rx.flush())
    return sorted((tuple(getattr(e, f) for f in INT_FIELDS)
                   for e in events if e.pdu), key=lambda t: t[:2])


def _manifest_pdus():
    return {(f['channel'], f['mode']): f['pdu_hex']
            for f in MANIFEST['frames']}


def test_golden_capture_through_port_receiver(jax_fused_path):
    """The port's receiver against the manifest and against the JAX
    receiver's fused path, integer field by integer field."""
    args = (MANIFEST['sample_rate'], MANIFEST['centerfreq'],
            MANIFEST['frequencies'])
    got = _decode(WidebandReceiver(*args, 'cpu'))
    assert {(g[0], g[1]): g[-1].hex() for g in got} == _manifest_pdus()
    assert got == _decode(JReceiver(*args))


def _cli_text(main, path, **kw):
    rc = main(['--iq-file', str(GOLDEN / MANIFEST['capture']),
               '--sample-format', MANIFEST['format'],
               '--sample-rate', str(MANIFEST['sample_rate']),
               '--centerfreq', '8930',
               '--system-table', str(ROOT / 'etc' / 'systable.conf'),
               '--utc', '--output', f'decoded:text:file:path={path}',
               '8912', '8942'], **kw)
    assert rc == 0
    # reception timestamps come from the wall clock: mask them
    return re.sub(r'^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d [A-Z]+\]', '[T]',
                  path.read_text(), flags=re.M)


def test_cli_text_matches_jax_cli(tmp_path, monkeypatch, jax_fused_path):
    """The port's CLI (acquisition gate on) prints what the JAX CLI prints,
    and the frames it hands to the protocol stack carry the pinned PDU
    bytes."""
    from dumphfdl_tpu_torch.app import HfdlApp
    seen = []
    handle = HfdlApp.handle_events
    monkeypatch.setattr(HfdlApp, 'handle_events', lambda self, evs: (
        seen.extend(evs), handle(self, evs)))
    got = _cli_text(cli.main, tmp_path / 'port.txt', device='cpu')
    want = _cli_text(jcli.main, tmp_path / 'jax.txt')
    assert {(e.channel, e.mode): e.pdu.hex() for e in seen if e.pdu} \
        == _manifest_pdus()
    assert 'ICAO: 400000' in got and 'Auckland' in got
    assert got == want


def test_cli_refuses_what_is_not_ported(tmp_path):
    """Nothing of the CLI is left unported: the list of refused flags is
    gone, --mesh gets as far as counting CUDA devices, --soapysdr as far
    as looking for the SoapySDR bindings, --datadumps and --profile as far
    as their input."""
    assert not hasattr(cli, '_NOT_PORTED')
    if torch.cuda.device_count() < 8:
        with pytest.raises(ValueError, match='mesh 2x4 needs 8 devices'):
            cli.main(['--mesh', '2x4', '--iq-file',
                      str(GOLDEN / MANIFEST['capture']), '--sample-format',
                      'CS16', '--sample-rate', '48000', '8912'], device='cpu')
    with pytest.raises(SystemExit, match='SoapySDR python bindings'):
        cli.main(['--soapysdr', 'driver=rtlsdr', '--sample-rate', '48000',
                  '8912'], device='cpu')
    for flag in (['--datadumps'], ['--profile', str(tmp_path)]):
        with pytest.raises(SystemExit, match='no input selected'):
            cli.main(flag + ['--sample-rate', '48000', '8912'], device='cpu')


def test_cli_requires_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['--iq-file', str(GOLDEN / MANIFEST['capture']),
                  '--sample-format', 'CS16', '--sample-rate', '48000',
                  '8912'])


def _env():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = str(ROOT)
    return env


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py, the CLI and
    the app) leaves jax and the JAX package out of sys.modules."""
    code = ('import importlib, pkgutil, sys, dumphfdl_tpu_torch as p\n'
            'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
            '    importlib.import_module(m.name)\n'
            'import chip_smoke, dumphfdl_tpu_torch.cli, dumphfdl_tpu_torch.app\n'
            'print(sorted(k for k in sys.modules if k.split(".")[0] in'
            ' ("jax", "dumphfdl_tpu") or k.startswith("jaxlib")))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), check=True)
    assert out.stdout.strip() == '[]'


def _import_roots(path):
    tree = ast.parse(path.read_text())
    roots = {a.name.split('.')[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    # level > 0 is a relative import: it stays inside the port
    return roots | {n.module.split('.')[0] for n in ast.walk(tree)
                    if isinstance(n, ast.ImportFrom) and n.module
                    and n.level == 0}


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No .py of the port, and not chip_smoke.py, has an import statement
    (at any depth of the syntax tree) naming jax or dumphfdl_tpu."""
    files = sorted((ROOT / 'dumphfdl_tpu_torch').rglob('*.py')) \
        + [ROOT / 'chip_smoke.py']
    assert len(files) > 40
    assert {'dumphfdl_tpu_torch/parallel/__init__.py',
            'dumphfdl_tpu_torch/parallel/sharding.py',
            'dumphfdl_tpu_torch/parallel/multihost.py',
            'dumphfdl_tpu_torch/utils/profiling.py',
            'dumphfdl_tpu_torch/tools/sensitivity.py',
            'dumphfdl_tpu_torch/tools/soak_events.py',
            'dumphfdl_tpu_torch/tools/soak_stream.py',
            'dumphfdl_tpu_torch/tools/alias.py',
            'dumphfdl_tpu_torch/tools/bench.py',
            'dumphfdl_tpu_torch/tools/bench_scaling.py'} <= {
        str(f.relative_to(ROOT)) for f in files}
    bad = {str(f.relative_to(ROOT)): sorted(
        _import_roots(f) & {'dumphfdl_tpu', 'jax', 'jaxlib'}) for f in files}
    assert {f: r for f, r in bad.items() if r} == {}


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: it imports neither jax nor the
    JAX package, at module level or inside a phase."""
    roots = _import_roots(ROOT / 'chip_smoke.py')
    assert 'dumphfdl_tpu_torch' in roots
    assert not roots & {'dumphfdl_tpu', 'jax', 'jaxlib'}


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke.py exits non-zero with no result line on a machine
    without CUDA, and alone in a directory without the repo."""
    alone = tmp_path / 'chip_smoke.py'
    shutil.copy(ROOT / 'chip_smoke.py', alone)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    runs = [subprocess.run([sys.executable, str(alone)], capture_output=True,
                           text=True, cwd=tmp_path, env=env)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, 'chip_smoke.py'],
                                   capture_output=True, text=True, cwd=ROOT,
                                   env=_env()))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_default_demod_block_at_2160k_decodes(tmp_path, monkeypatch):
    """2.16 Msps with the CLI's default --demod-block 5400: the resampler's
    ratio is 25/16, the block is no whole number of cosets and the rate
    does not align for the superstep, so the receiver takes the unfused
    path (the port used to refuse this; the JAX CLI always decoded it).
    Two channels, one short frame each."""
    import numpy as np
    from dumphfdl_tpu_torch.app import HfdlApp
    from dumphfdl_tpu_torch.dsp import modulator
    from dumphfdl_tpu_torch.io import formats as tformats
    fs, center = 2_160_000, 10_000_000
    freqs = [9_700_000, 10_400_000]
    rng = np.random.default_rng(9)
    emissions = [(modulator.make_test_mpdu(m, rng), m, f)
                 for m, f in zip((3, 1), freqs)]
    wb = modulator.synthesize_wideband_fft(emissions, fs=fs,
                                           centerfreq=center, snr_db=30.0,
                                           pad_symbols=100)
    path = tmp_path / 'cap.cs16'
    path.write_bytes(tformats.serialize(wb, 'CS16'))
    seen, apps = [], []
    handle = HfdlApp.handle_events
    monkeypatch.setattr(HfdlApp, 'handle_events', lambda self, evs: (
        apps.append(self), seen.extend(evs), handle(self, evs))[2])
    rc = cli.main(['--iq-file', str(path), '--sample-format', 'CS16',
                   '--sample-rate', str(fs), '--centerfreq', '10000',
                   '--output', f'decoded:text:file:path={tmp_path / "o.txt"}',
                   '9700', '10400'], device='cpu')
    assert rc == 0
    rx = apps[0].receiver
    assert not rx.fused and rx.superstep is None and rx.block_len == 5400
    assert [(e.channel, e.mode, e.fcs_ok, e.pdu) for e in
            sorted(seen) if e.pdu] == \
        [(k, m, True, pdu) for k, (pdu, m, _f) in enumerate(emissions)]
