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
    is not a whole number of cosets.  The receiver no longer raises for it
    but takes the unfused path, as the JAX receiver does; what it still
    refuses is a block that is not a whole number of symbols."""
    from dumphfdl_tpu.dsp.receiver import WidebandReceiver as JReceiver
    from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver
    fs, center, freqs = CASES[1]
    rx = WidebandReceiver(fs, center, freqs, 'cpu')
    assert not rx.fused and rx.superstep is None
    assert rx.fused == JReceiver(fs, center, freqs).fused
    assert WidebandReceiver(fs, center, freqs, 'cpu', block_len=5376).fused
    with pytest.raises(ValueError, match='whole number of symbols'):
        WidebandReceiver(fs, center, freqs, 'cpu', block_len=5402)


def _noise(n, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _exact_params(chz):
    a_num = chz._out_count * chz._rs_num \
        - chz._ring_global_start * chz._rs_den
    a_int, a_fnum = divmod(a_num, chz._rs_den)
    return a_fnum, a_int, chz._fs1_start


@pytest.mark.parametrize('exact', [True, False])
def test_resample_matches_jax(exact):
    """The gather-interpolate resampler on the same fs1 ring and cursor:
    the exact path (integer positions) and the float32 fallback (forced
    here, as for a rate whose reduced ratio is huge).  The taps are summed
    in another order than XLA's einsum: 2e-5 of the output's peak."""
    fs, center, freqs = CASES[0]
    jchz = jfe.Channelizer(fs, center, freqs, out_chunk=1800)
    chz = fe.Channelizer(fs, center, freqs, 'cpu', out_chunk=1800)
    jchz._rs_exact = chz._rs_exact = exact
    ring = _noise(2 * chz._r1, 3).reshape(2, chz._r1)
    if exact:
        params = (7, 1234, chz._r1 - 300)       # the window wraps the ring
        jparams = np.asarray(params, np.int32)[:, None]
    else:
        params = (0.28125, 1234, chz._r1 - 300)
        jparams = np.asarray(params, np.float32)[:, None]
    want = np.asarray(jchz._resample(jnp.asarray(ring), jchz._bank,
                                     jnp.asarray(jparams), 1800))
    got = chz._resample(torch.as_tensor(ring), params, 1800).numpy()
    assert got.shape == want.shape == (2, 1800)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize('fs,center,freqs,chunk', [
    CASES[0] + (5400,), CASES[0] + (1000,),
    (250_000, 10_000_000, [9_950_000, 10_040_000], 2700)])
def test_process_device_matches_jax_block_for_block(fs, center, freqs, chunk):
    """The unfused path in uneven uploads: process_device hands out the
    same number of (rows, out_chunk) blocks as the JAX channelizer after
    every upload, each within 2e-5 of the peak, with the same host
    cursors; process() is their concatenation on the host.  48 kHz has
    the ratio 10/9 (its 1000-sample chunk is no whole number of cosets:
    only this path can take it); 250 kHz has 625/432."""
    jchz = jfe.Channelizer(fs, center, freqs, out_chunk=chunk)
    chz = fe.Channelizer(fs, center, freqs, 'cpu', out_chunk=chunk)
    assert chz._rs_exact and jchz._rs_exact
    x = _noise(int(2.6 * fs), 4)
    cuts = [0, fs // 5, fs // 5 + 7001, int(1.5 * fs), len(x)]
    n_blocks = 0
    for a, b in zip(cuts, cuts[1:]):
        want = jchz.process_device(x[a:b])
        got = chz.process_device(x[a:b])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape == (len(freqs), chunk)
            np.testing.assert_allclose(g.numpy(), w,
                                       atol=2e-5 * np.abs(w).max())
        n_blocks += len(got)
        for attr in ('_out_count', '_fs1_start', '_fs1_fill',
                     '_ring_global_start', '_wb_fill'):
            assert getattr(chz, attr) == getattr(jchz, attr), attr
    assert n_blocks >= 2
    tail = _noise(int(1.2 * fs), 5)       # at least one more block
    want, got = jchz.process(tail), chz.process(tail)
    assert got.shape == want.shape and got.dtype == np.complex64
    assert got.shape[1] >= chunk
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    none = chz.process(tail[:10])
    assert none.shape == (len(freqs), 0)


def test_channelize_frames_and_append_fs1_match_jax():
    """The offline helper and the fs1 ring's append: channelize_frames
    from phase zero as the JAX helper, its output appended to the ring at
    the write cursor, and an append past the ring's room refused."""
    fs, center, freqs = CASES[0]
    jchz = jfe.Channelizer(fs, center, freqs)
    chz = fe.Channelizer(fs, center, freqs, 'cpu')
    frames = _noise(3 * chz.geo.fft_size, 6, 0.3).reshape(3, -1)
    want, wph = jchz.channelize_frames(frames)
    got, ph = chz.channelize_frames(frames)
    peak = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5 * peak)
    np.testing.assert_allclose(ph.numpy(), np.asarray(wph), atol=1e-6)
    jchz._append_fs1(want)
    chz._append_fs1(got)
    assert chz._fs1_fill == jchz._fs1_fill == got.shape[1]
    assert chz._fs1_wcur == int(np.asarray(jchz._fs1_wcur)[0, 0])
    np.testing.assert_allclose(chz._fs1_ring.numpy(),
                               np.asarray(jchz._fs1_ring), atol=2e-5 * peak)
    with pytest.raises(RuntimeError, match='fs1 ring overflow'):
        chz._append_fs1(torch.zeros((2, chz._r1), dtype=torch.complex64))
