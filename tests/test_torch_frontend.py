"""PyTorch port, dsp/frontend: the copied numpy design tables, the DDC on
torch.fft and the streaming ring bookkeeping against the JAX Channelizer."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dumphfdl_tpu.dsp import frontend as jfe  # noqa: E402
from dumphfdl_tpu_torch.dsp import frontend as fe  # noqa: E402

CASES = [(48_000, 8_930_000, [8_912_000, 8_942_000]),
         (2_160_000, 10_000_000, [9_500_000, 9_990_000, 10_003_000,
                                  10_700_000])]


def test_design_helpers_are_copies():
    for n in (1, 7, 8, 1000):
        assert fe.next_pow2(n) == jfe.next_pow2(n)
    for fs in (48_000, 912_000, 2_160_000, 13_824_000):
        assert fe.compute_fft_decimation_rate(fs) == \
            jfe.compute_fft_decimation_rate(fs)
    np.testing.assert_array_equal(fe.firdes_lowpass(1025, 0.0625),
                                  jfe.firdes_lowpass(1025, 0.0625))
    np.testing.assert_array_equal(fe.firdes_bandpass_c(513, 0.01, 0.05),
                                  jfe.firdes_bandpass_c(513, 0.01, 0.05))
    for ratio, ntaps in ((1111, 16), (1562, 16), (1250, 16)):
        np.testing.assert_array_equal(fe._resampler_bank(ratio, ntaps),
                                      jfe._resampler_bank(ratio, ntaps))
    geo = fe.compute_geometry(256, 250 / 2_160_000)
    assert geo.__dict__ == jfe.compute_geometry(256, 250 / 2_160_000).__dict__
    assert fe.plan_channel(geo, 2_160_000, 10_000_000, 9_990_000).__dict__ \
        == jfe.plan_channel(geo, 2_160_000, 10_000_000, 9_990_000).__dict__


@pytest.mark.parametrize('fs,center,freqs', CASES)
def test_channelizer_tables_are_copies(fs, center, freqs):
    chz = fe.Channelizer(fs, center, freqs, 'cpu', rows=len(freqs) + 1)
    jchz = jfe.Channelizer(fs, center, freqs, rows=len(freqs) + 1)
    np.testing.assert_array_equal(chz._idx_np, jchz._idx_np)
    np.testing.assert_array_equal(chz._hwin_np, jchz._hwin_np)
    np.testing.assert_array_equal(chz._residual64, jchz._residual64)
    for attr in ('window_images', '_max_frames', '_rw', '_r1', '_rs_num',
                 '_rs_den', '_rs_taps', '_rs_exact', 'ratio'):
        assert getattr(chz, attr) == getattr(jchz, attr), attr
    np.testing.assert_array_equal(chz._bank, np.asarray(jchz._bank))
    assert chz.fused_ready == jchz.fused_ready


def test_tables_from_numpy_installs_tables():
    fs, center, freqs = CASES[0]
    jchz = jfe.Channelizer(fs, center, freqs)
    chz = fe.Channelizer(fs, center, freqs, 'cpu')
    chz.tables_from_numpy(jchz._idx_np, jchz._hwin_np[::-1].copy(),
                          jchz._residual64 * 2)
    np.testing.assert_array_equal(chz._hwin.numpy(), jchz._hwin_np[::-1])
    np.testing.assert_array_equal(chz._residual_dev.numpy(),
                                  (jchz._residual64 * 2).astype(np.float32))


def test_ddc_frames_matches_jax():
    """Random overlap-save frames through both DDCs (FFT rounding differs
    between torch.fft and XLA: 2e-5 of the output peak)."""
    fs, center, freqs = CASES[0]
    jchz = jfe.Channelizer(fs, center, freqs)
    chz = fe.Channelizer(fs, center, freqs, 'cpu')
    rng = np.random.default_rng(0)
    frames = ((rng.standard_normal((4, chz.geo.fft_size))
               + 1j * rng.standard_normal((4, chz.geo.fft_size))) * 0.3) \
        .astype(np.complex64)
    phase0 = np.asarray([0.25, 0.7], np.float32)
    want, wph = jchz.channelize_frames(frames, jnp.asarray(phase0))
    got, ph = chz.ddc_frames(torch.as_tensor(frames), torch.as_tensor(phase0))
    peak = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5 * peak)
    np.testing.assert_allclose(ph.numpy(), np.asarray(wph), atol=1e-6)


def test_streaming_rings_match_jax():
    """ingest + channelize_available in uneven chunks: the fs1 ring within
    the DDC tolerance, every host cursor equal to the JAX bookkeeping."""
    fs, center, freqs = CASES[0]
    jchz = jfe.Channelizer(fs, center, freqs)
    chz = fe.Channelizer(fs, center, freqs, 'cpu')
    rng = np.random.default_rng(1)
    x = ((rng.standard_normal(60_000) + 1j * rng.standard_normal(60_000))
         * 0.2).astype(np.complex64)
    for a, b in ((0, 9000), (9000, 31_000), (31_000, 60_000)):
        jchz.ingest(x[a:b])
        jchz.channelize_available()
        chz.ingest(x[a:b])
        chz.channelize_available()
        assert (chz._wb_fill, chz._fs1_fill) == (jchz._wb_fill,
                                                 jchz._fs1_fill)
        assert chz._wb_rcur == int(np.asarray(jchz._wb_rcur)[0, 0])
        assert chz._fs1_wcur == int(np.asarray(jchz._fs1_wcur)[0, 0])
        assert chz.chunk_ready() == jchz.chunk_ready()
    want = np.asarray(jchz._fs1_ring)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(chz._fs1_ring.numpy(), want, atol=2e-5 * peak)
    np.testing.assert_allclose(chz._mixer_phase.numpy(),
                               np.asarray(jchz._mixer_phase), atol=1e-6)
    assert chz.rs_device_state() == tuple(
        np.asarray(jchz.rs_device_state())[:, 0].tolist())


def test_receiver_refuses_blocks_the_fused_step_cannot_take():
    """At 2.16 Msps the resampler ratio is 25/16: a 5400-sample demod block
    is not a whole number of cosets, and the port (fused path only)
    raises, naming a block length that works."""
    from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver
    fs, center, freqs = CASES[1]
    with pytest.raises(ValueError, match='5376'):
        WidebandReceiver(fs, center, freqs, 'cpu')
    assert WidebandReceiver(fs, center, freqs, 'cpu',
                            block_len=5376).channelizer.fused_ready
