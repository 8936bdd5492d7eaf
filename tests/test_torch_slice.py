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
    for flag in (['--soapysdr', 'driver=rtlsdr'], ['--mesh', '2x4'],
                 ['--profile', str(tmp_path)], ['--datadumps']):
        with pytest.raises(SystemExit, match='not yet ported'):
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
    """Importing every module of the port (and chip_smoke.py) leaves jax
    out of sys.modules."""
    code = ('import importlib, pkgutil, sys, dumphfdl_tpu_torch as p\n'
            'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
            '    importlib.import_module(m.name)\n'
            'import chip_smoke, dumphfdl_tpu_torch.cli\n'
            'print(sorted(k for k in sys.modules if k.split(".")[0] == "jax"'
            ' or k.startswith("jaxlib")))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), check=True)
    assert out.stdout.strip() == '[]'


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: it imports neither jax nor the
    JAX package, at module level or inside a phase."""
    tree = ast.parse((ROOT / 'chip_smoke.py').read_text())
    roots = {a.name.split('.')[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split('.')[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
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
