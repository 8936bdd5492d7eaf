"""PyTorch port, dsp/channel: AGC, matched filter, coset resampler, symbol
ring and cursor arithmetic against the JAX package, plus a narrowband
decode through ChannelBank."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dumphfdl_tpu.dsp import channel as jch  # noqa: E402
from dumphfdl_tpu.dsp import modulator as jmod  # noqa: E402
from dumphfdl_tpu.dsp.frontend import Channelizer as JChannelizer  # noqa: E402
from dumphfdl_tpu_torch.dsp import channel as ch  # noqa: E402
from dumphfdl_tpu_torch.dsp.frontend import Channelizer, _resampler_bank  # noqa: E402
from dumphfdl_tpu_torch.dsp.receiver import NarrowbandReceiver  # noqa: E402

from test_resample_coset import _ref_resample  # noqa: E402


def _noise(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def test_agc_matches_jax():
    """Two consecutive blocks (state carried) with a 20 dB level step:
    output, level and state within 1e-5 relative (the chunked scan sums in
    another order than the associative scan)."""
    rng = np.random.default_rng(0)
    x = _noise(rng, (3, 2 * 16200))
    x[:, 20000:] *= 10.0
    js, ts = jch.agc_init(3), ch.agc_init(3, 'cpu')
    for off in (0, 16200):
        blk = x[:, off:off + 16200]
        js, jy, jl = jch.agc_block(js, jnp.asarray(blk))
        ts, ty, tl = ch.agc_block(ts, torch.as_tensor(blk))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    st = ch.agc_state_from_numpy(tuple(np.asarray(v) for v in js), 'cpu')
    for a, b in zip(st, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_matched_filter_matches_jax():
    x = _noise(np.random.default_rng(1), (4, 5400))
    np.testing.assert_allclose(
        ch.matched_filter(torch.as_tensor(x)).numpy(),
        np.asarray(jch.matched_filter(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize('num,den,k', [(5, 4, 16), (10, 9, 16), (25, 16, 16),
                                       (3, 2, 16)])
def test_resample_ring_scenarios(num, den, k):
    """The scenarios of tests/test_resample_coset.py: against the gather
    reference and the JAX coset resampler, within 1e-5."""
    rng = np.random.default_rng(0)
    r1 = 1 << 14
    ring = _noise(rng, (5, r1))
    bank = _resampler_bank(int(round(num / den * 1000)), k)
    n_out = 5400 - (5400 % den)
    st = (2 % den, 37, 1200)
    got = ch._resample_ring(torch.as_tensor(ring), bank, st,
                            (k, num, den, n_out)).numpy()
    np.testing.assert_allclose(got, _ref_resample(ring, bank, *st, k, num,
                                                  den, n_out), atol=1e-5)
    want = jch._resample_ring(jnp.asarray(ring), jnp.asarray(bank),
                              jnp.asarray(np.asarray(st, np.int32)[:, None]),
                              (k, num, den, n_out))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_resample_ring_wrap():
    rng = np.random.default_rng(1)
    r1 = 1 << 13
    ring = _noise(rng, (3, r1))
    bank = _resampler_bank(1250, 16)
    got = ch._resample_ring(torch.as_tensor(ring), bank, (1, 20, r1 - 300),
                            (16, 5, 4, 5400)).numpy()
    np.testing.assert_allclose(
        got, _ref_resample(ring, bank, 1, 20, r1 - 300, 16, 5, 4, 5400),
        atol=1e-5)


def test_ring_update_matches_jax():
    """Appends that cross the compaction point twice: ring content and the
    (write cursor, base row) pair identical to the JAX device version."""
    rng = np.random.default_rng(2)
    c = 2
    jring = jnp.zeros((c, ch.RING_T), jnp.complex64)
    jmeta = jnp.zeros((2, 1), jnp.int32)
    tring = torch.zeros((c, ch.RING_T), dtype=torch.complex64)
    tmeta = (0, 0)
    for _ in range(16):
        blk = _noise(rng, (c, 5400))
        jring, jmeta = jch._ring_update(jring, jmeta, jnp.asarray(blk))
        tmeta = ch._ring_update(tring, tmeta, torch.as_tensor(blk))
        assert list(tmeta) == np.asarray(jmeta)[:, 0].tolist()
    assert tmeta[1] > 0                          # compacted at least once
    np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))


@pytest.mark.parametrize('fs', [48_000, 2_160_000])
def test_resampler_cursor_arithmetic(fs):
    """The host-int cursor advance equals the JAX device arithmetic, and
    Channelizer.consume_chunk's bookkeeping mirrors it (the ring read
    cursor and the integer position agree after every chunk)."""
    freqs = [10_000_000, 10_010_000]
    out_chunk = 5400 if fs == 48_000 else 5376
    chz = Channelizer(fs, 10_005_000, freqs, 'cpu', out_chunk=out_chunk)
    jchz = JChannelizer(fs, 10_005_000, freqs, out_chunk=out_chunk)
    assert chz.fused_ready and jchz.fused_ready
    rs_const = (chz._rs_taps, chz._rs_num, chz._rs_den, chz.out_chunk)
    chz._fs1_fill = 10 ** 9          # plenty buffered: drops never clip
    jst = jnp.asarray(np.asarray(chz.rs_device_state(), np.int32)[:, None])
    for _ in range(50):
        st = chz.rs_device_state()
        new = ch._rs_advance(st, rs_const, chz._r1)
        jst = jch._rs_advance(jst, rs_const, chz._r1)
        assert list(new) == np.asarray(jst)[:, 0].tolist()
        chz.consume_chunk(new)
        assert new[2] == chz._fs1_start
        a_num = chz._out_count * chz._rs_num \
            - chz._ring_global_start * chz._rs_den
        assert (new[1], new[0]) == divmod(a_num, chz._rs_den)


def test_narrowband_decode():
    """A mode-2 frame at 5400 sps through NarrowbandReceiver (unfused
    channel_step, the same AGC/MF/tracker/ring/event decode) decodes to
    its PDU with a valid header FCS."""
    rng = np.random.default_rng(4)
    pdu = jmod.make_test_mpdu(2, rng, icao=0x3C0042)
    iq = jmod.synthesize_iq(jmod.frame_symbols(pdu, 2), imp=jmod.Impairments(
        snr_db=25.0, cfo_hz=-7.0, timing_offset=0.2, seed=6))
    rx = NarrowbandReceiver('cpu')
    rx.bank.fused_event_decode = 8
    events = rx.process(iq) + rx.flush()
    good = [e for e in events if e.pdu]
    assert len(good) == 1
    assert good[0].pdu == pdu and good[0].fcs_ok and good[0].mode == 2
