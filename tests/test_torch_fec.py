"""PyTorch port, ops/fec: plain Viterbi (kernel K1's plain version) against
the JAX package's decoders; bit-exact."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu import constants as C  # noqa: E402
from dumphfdl_tpu.ops import fec as jfec  # noqa: E402
from dumphfdl_tpu.ops.fec_pallas import viterbi_decode_pallas  # noqa: E402
from dumphfdl_tpu_torch.ops import fec, fec_cuda  # noqa: E402


def _noisy_frames(rng, nbits, batch, spread):
    bits = rng.integers(0, 2, (batch, nbits)).astype(np.int8)
    bits[:, -6:] = 0
    soft = np.stack([jfec.hard_to_soft(jfec.conv_encode(b)).astype(np.int32)
                     for b in bits])
    return bits, np.clip(soft + rng.integers(-spread, spread + 1, soft.shape),
                         0, 255)


def test_tables_and_encoder_are_copies():
    for a, b in zip(fec._branch_tables(), jfec._branch_tables()):
        np.testing.assert_array_equal(a, b)
    bits = np.random.default_rng(0).integers(0, 2, 300)
    np.testing.assert_array_equal(fec.conv_encode(bits),
                                  jfec.conv_encode(bits))


@pytest.mark.parametrize('nbits,batch', [(540, 3), (1080, 8)])
def test_plain_matches_jax_decoders(nbits, batch):
    """The cases of tests/test_fec_pallas.py: scan, numpy and Pallas
    (interpret mode) decoders all agree with the port bit for bit."""
    rng = np.random.default_rng(11)
    _, soft = _noisy_frames(rng, nbits, batch, 70)
    got = fec.viterbi_decode(torch.as_tensor(soft), nbits).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jfec.viterbi_decode(soft, nbits)))
    np.testing.assert_array_equal(got, np.asarray(viterbi_decode_pallas(
        soft, nbits, interpret=True)))
    for row, s in zip(got, soft):
        np.testing.assert_array_equal(row, jfec.viterbi_decode_np(s, nbits))


@pytest.mark.parametrize('mode', range(len(C.MODES)))
def test_plain_matches_jax_every_frame_length(mode):
    nbits = C.MODES[mode].framebits
    rng = np.random.default_rng(100 + mode)
    _, soft = _noisy_frames(rng, nbits, 2, 110)
    got = fec.viterbi_decode(torch.as_tensor(soft), nbits).numpy()
    for row, s in zip(got, soft):
        np.testing.assert_array_equal(row, jfec.viterbi_decode_np(s, nbits))


def test_wrapper_routes_cpu_tensors_to_plain():
    rng = np.random.default_rng(3)
    bits, soft = _noisy_frames(rng, 540, 4, 60)
    before = fec_cuda.launches
    got = fec_cuda.viterbi_decode(torch.as_tensor(soft.astype(np.uint8)), 540)
    assert fec_cuda.launches == before          # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), bits)
