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
    launches = fec_cuda.one_mode_launches, fec_cuda.launches
    got = fec_cuda.viterbi_decode(s, nbits)
    assert (fec_cuda.one_mode_launches, fec_cuda.launches) == \
        (launches[0] + 1, launches[1])
    assert torch.equal(got, fec.viterbi_decode(s, nbits))


def test_viterbi_many_mode_launch_matches_plain(cuda):
    """All eight frame lengths in one launch (one batch of 1 frame, one
    empty): the plain version bit for bit, and one launch counted."""
    rng = np.random.default_rng(8)
    softs, lengths = [], []
    for m, p in enumerate(C.MODES):
        batch = (64, 1, 0, 7, 64, 3, 64, 64)[m]
        softs.append(torch.as_tensor(
            rng.integers(0, 256, (batch, 2 * p.framebits)).astype(np.uint8),
            device=cuda))
        lengths.append(p.framebits)
    launches = fec_cuda.launches
    got = fec_cuda.viterbi_decode_many(softs, lengths)
    assert fec_cuda.launches == launches + 1
    for g, s, n in zip(got, softs, lengths):
        assert torch.equal(g, fec.viterbi_decode(s, n))


def test_tracker_kernel_ragged_channel_count(cuda):
    """Gate off, 200 channels (not a multiple of the 128-channel tile, nor
    of a block's 32) and 150 symbols (two full chunks of the kernel's
    shared-memory stages and a partial one): exact against the plain
    version."""
    nch, steps = 200, 150
    t = steps * 3 + trk.HALO
    rng = np.random.default_rng(4)
    x = torch.as_tensor((rng.standard_normal((nch, t))
                         + 1j * rng.standard_normal((nch, t)))
                        .astype(np.complex64), device=cuda)
    lvl = torch.as_tensor((np.abs(rng.standard_normal((nch, t))) + 0.5)
                          .astype(np.float32), device=cuda)
    st = trk.tracker_init(nch, cuda)
    k = tracker_cuda.tracker_block(st, x, lvl, steps, use_acq=False)
    p = trk.tracker_block(st, x, lvl, steps, None)
    for a, b in zip(k[0][:-1], p[0][:-1]):
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(k[1].sym, p[1].sym)
    assert torch.equal(k[1].data_idx, p[1].data_idx)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])


def test_tracker_kernel_matches_plain(cuda):
    """Through the wrapper, gate on: tile 0 runs the loop on noise (its
    channels carry a preamble hit from the last block) and tile 1 is idle.
    The kernel reproduces the plain version's arithmetic exactly, and the
    wrapper carries this block's hits."""
    nch, steps = 130, 300     # long enough for the gate to assess
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


def test_tracker_kernel_debug_taps(cuda):
    """debug_taps launches the kernel's taps instantiation (its own launch
    count): the three per-symbol planes equal the plain version's exactly,
    and everything else is bit-equal to the normal instantiation with the
    gate off, which the taps turn off themselves."""
    nch, steps = 200, 450
    t = steps * 3 + trk.HALO
    rng = np.random.default_rng(6)
    x = torch.as_tensor((rng.standard_normal((nch, t))
                         + 1j * rng.standard_normal((nch, t)))
                        .astype(np.complex64), device=cuda)
    lvl = torch.as_tensor((np.abs(rng.standard_normal((nch, t))) + 0.5)
                          .astype(np.float32), device=cuda)
    st = trk.tracker_init(nch, cuda)
    before = tracker_cuda.launches, tracker_cuda.taps_launches
    k = tracker_cuda.tracker_block(st, x, lvl, steps, debug_taps=True)
    assert (tracker_cuda.launches, tracker_cuda.taps_launches) == \
        (before[0], before[1] + 1)
    p = trk.tracker_block(st, x, lvl, steps, None, debug_taps=True)
    off = tracker_cuda.tracker_block(st, x, lvl, steps, use_acq=False)
    assert off[1].taps is None and k[1].taps.shape == (steps, nch, 3)
    assert torch.equal(k[1].taps, p[1].taps)
    assert float(k[1].taps.abs().max()) > 0
    for other in (p, off):
        for a, b in zip(k[0][:-1], other[0][:-1]):
            assert torch.equal(a, b)
        assert torch.equal(k[1].sym, other[1].sym)
        assert torch.equal(k[1].data_idx, other[1].data_idx)
        assert torch.equal(k[2], other[2]) and torch.equal(k[3], other[3])


def test_wrappers_launch_on_their_tensors_device(cuda):
    """Both wrappers, given tensors on the last visible CUDA device while
    device 0 is the current one, launch there (a launch on device 0 with
    another device's stream and pointers fails or computes nothing) and
    stay exact against the plain versions; so does a mesh shard's event
    readback."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f'{n} CUDA device visible: needs two, to launch on one '
                    'that is not the current device')
    from dumphfdl_tpu_torch.dsp.channel import _start_readback
    dev = torch.device('cuda', n - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(9)
    nbits = C.MODES[1].framebits
    soft = torch.as_tensor(rng.integers(0, 256, (16, 2 * nbits))
                           .astype(np.uint8), device=dev)
    before = fec_cuda.one_mode_launches, fec_cuda.launches
    got = fec_cuda.viterbi_decode(soft, nbits)
    many = fec_cuda.viterbi_decode_many([soft], [nbits])
    assert (fec_cuda.one_mode_launches, fec_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.device == dev and torch.cuda.current_device() == 0
    want = fec.viterbi_decode(soft, nbits)
    assert torch.equal(got, want) and torch.equal(many[0], want)

    nch, steps = 40, 150
    t = steps * 3 + trk.HALO
    x = torch.as_tensor((rng.standard_normal((nch, t))
                         + 1j * rng.standard_normal((nch, t)))
                        .astype(np.complex64), device=dev)
    lvl = torch.as_tensor((np.abs(rng.standard_normal((nch, t))) + 0.5)
                          .astype(np.float32), device=dev)
    st = trk.tracker_init(nch, dev)
    assert tracker_cuda.trig_mismatches(dev) == 0
    before = tracker_cuda.launches
    k = tracker_cuda.tracker_block(st, x, lvl, steps, use_acq=False)
    assert tracker_cuda.launches == before + 1
    p = trk.tracker_block(st, x, lvl, steps, None)
    assert k[1].sym.device == dev and torch.cuda.current_device() == 0
    for a, b in zip(k[0][:-1], p[0][:-1]):
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(k[1].sym, p[1].sym)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    rb = _start_readback(k[2])
    rb.done.synchronize()
    assert torch.equal(rb.host_table, p[2].cpu())
