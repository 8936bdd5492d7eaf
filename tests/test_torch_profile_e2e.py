"""PyTorch port: the stage profile (tools/profile_e2e.py) on the CPU, and
what every tool of dumphfdl_tpu_torch/tools takes for its device.

One pass at 8 channels (a frame on each) through the four stages: each
stage runs and is timed, and the full path decodes every emitted frame
once per pass with its bytes (the untimed warm-up pass included)."""

import importlib

import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu_torch.tools import profile_e2e  # noqa: E402
from torch_time_limit import time_limit  # noqa: E402


def test_one_pass_through_the_four_stages():
    lines = []
    with time_limit(300):
        out = profile_e2e.profile(fs=108_000, channels=8, passes=1,
                                  device='cpu', say=lines.append)
    assert list(out['wall_s_per_pass']) == list(profile_e2e.STAGES)
    assert all(v > 0 for v in out['wall_s_per_pass'].values())
    assert len(lines) == 4
    assert out['frames_emitted'] == 8 and out['full_passes'] == 2
    assert out['frames_per_full_pass'] == 8 and out['frames_decoded'] == 16
    assert out['exact'] and out['frames_junk'] == out['frames_other'] == 0


@pytest.mark.parametrize('tool', ['sensitivity', 'soak_events',
                                  'soak_stream', 'profile_e2e'])
def test_tools_run_on_the_card_unless_asked(tool, monkeypatch):
    """Without --device a tool takes the CUDA device, and on a machine
    without one it stops before any work (no fallback to the CPU)."""
    mod = importlib.import_module(f'dumphfdl_tpu_torch.tools.{tool}')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main([])
