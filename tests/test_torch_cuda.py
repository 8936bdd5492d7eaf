"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions on the card.  Marked ``cuda``; they skip without a CUDA device.

This file imports no jax, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from dumphfdl_tpu_torch import constants as C  # noqa: E402
from dumphfdl_tpu_torch.dsp import tracker as trk  # noqa: E402
from dumphfdl_tpu_torch.dsp import tracker_cuda  # noqa: E402
from dumphfdl_tpu_torch.ops import fec, fec_cuda  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('mode', [0, 7])
def test_viterbi_kernel_matches_plain(cuda, mode):
    nbits = C.MODES[mode].framebits
    rng = np.random.default_rng(mode)
    bits = rng.integers(0, 2, (64, nbits))
    bits[:, -6:] = 0
    soft = np.stack([fec.hard_to_soft(fec.conv_encode(b)).astype(np.int32)
                     for b in bits])
    soft = np.clip(soft + rng.integers(-100, 101, soft.shape), 0, 255)
    s = torch.as_tensor(soft.astype(np.uint8), device=cuda)
    launches = fec_cuda.launches
    got = fec_cuda.viterbi_decode(s, nbits)
    assert fec_cuda.launches == launches + 1
    assert torch.equal(got, fec.viterbi_decode(s, nbits))


def test_tracker_kernel_matches_plain(cuda):
    """Through the wrapper, gate on: tile 0 runs the loop on noise (its
    channels carry a preamble hit from the last block) and tile 1 is idle.
    The kernel reproduces the plain version's arithmetic exactly, and the
    wrapper carries this block's hits."""
    nch, steps = 130, 200
    t = steps * 3 + trk.HALO
    rng = np.random.default_rng(1)
    x = torch.as_tensor((rng.standard_normal((nch, t))
                         + 1j * rng.standard_normal((nch, t)))
                        .astype(np.complex64), device=cuda)
    lvl = torch.as_tensor((np.abs(rng.standard_normal((nch, t))) + 0.5)
                          .astype(np.float32), device=cuda)
    st = trk.tracker_init(nch, cuda)._replace(
        acq_hit=(torch.arange(nch, device=cuda) < trk.CT).to(torch.int32))
    act, hits = tracker_cuda.tile_activity(st, x, True)
    assert act.tolist() == [1, 0]
    launches = tracker_cuda.launches
    k = tracker_cuda.tracker_block(st, x, lvl, steps, use_acq=True)
    assert tracker_cuda.launches == launches + 1
    p = trk.tracker_block(st, x, lvl, steps, act)
    assert torch.equal(k[0].acq_hit, hits)
    for a, b in zip(k[0][:-1], p[0][:-1]):
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(k[1].sym, p[1].sym)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
