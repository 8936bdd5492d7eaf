"""Nothing the harness loads is JAX or the JAX package: the check on
whole top-level names, the harness's sources, and a fresh process that
loads the harness and the program's entry points as a run does."""

import ast
import re
import pathlib
import subprocess
import sys

import pytest

from hfdlbench import run

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
REFERENCE = ('tx.py', 'traffic.py', 'ledger.py', 'trace.py', 'roofline.py',
             'spec.py', 'source.py')


@pytest.mark.parametrize('name,bad', [
    ('jax', True), ('jax.numpy', True), ('jaxlib.xla_client', True),
    ('flax', True), ('dumphfdl_tpu', True), ('dumphfdl_tpu.dsp', True),
    ('dumphfdl_tpu_torch', False), ('dumphfdl_tpu_torch.cli', False),
    ('jaxtyping', False), ('dumphfdl_tpuX', False)])
def test_forbidden_names_are_whole_top_level_names(monkeypatch, name, bad):
    for m in [m for m in sys.modules
              if m.split('.')[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert bool(run.forbidden_modules()) == bad


def imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.')[0])
    return out


@pytest.mark.parametrize('path', sorted(
    p.relative_to(HERE).as_posix() for p in HERE.rglob('*.py')
    if 'tests' not in p.parts))
def test_harness_sources(path):
    found = imports(HERE / path)
    assert not found & {'jax', 'jaxlib', 'flax', 'dumphfdl_tpu'}
    if path in REFERENCE or path.startswith('metrics/'):
        # the yardstick takes nothing of the program
        assert 'dumphfdl_tpu_torch' not in found
    # nothing reads the JAX package's bench entry points or its figures
    for node in ast.walk(ast.parse((HERE / path).read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not re.fullmatch(r'.*((^|/)bench\.py|extras/.*|'
                                    r'BENCH_\w*\.json)', node.value)


def test_a_run_loads_no_jax():
    code = ('import sys; import hfdlbench.run as r; '
            'from dumphfdl_tpu_torch import cli, app; '
            'from dumphfdl_tpu_torch.io import ingest; '
            'from dumphfdl_tpu_torch.dsp import receiver, superstep; '
            'print(r.forbidden_modules())')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'
