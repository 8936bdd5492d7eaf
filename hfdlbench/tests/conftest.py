"""The harness's own tests: run from the repository root with
``python -m pytest hfdlbench/tests``.  Tests that need a CUDA device are
marked ``cuda`` and decide inside a fixture whether one is there."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip('torch')
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)
