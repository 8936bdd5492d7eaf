"""PyTorch port, dsp/backend: frame decode, device FCS and the event decode
from the symbol ring, against the JAX package; exact."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dumphfdl_tpu import constants as C  # noqa: E402
from dumphfdl_tpu.dsp import backend as jbackend  # noqa: E402
from dumphfdl_tpu.dsp import modulator as jmod  # noqa: E402
from dumphfdl_tpu.ops import crc  # noqa: E402
from dumphfdl_tpu.ops import psk as jpsk  # noqa: E402
from dumphfdl_tpu_torch.dsp import backend  # noqa: E402
from dumphfdl_tpu_torch.ops import psk  # noqa: E402

from test_fcs_device import _make_spdu, _to_bits  # noqa: E402
from test_protocol import (make_downlink_mpdu, make_lpdu,  # noqa: E402
                           make_uplink_mpdu)


@pytest.mark.parametrize('arity', [1, 2, 3])
def test_psk_demodulators_match_jax(arity):
    rng = np.random.default_rng(arity)
    x = ((rng.standard_normal(400) + 1j * rng.standard_normal(400)) * 0.8) \
        .astype(np.complex64)
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(psk.soft_demodulate(xt, arity).numpy(),
                                  np.asarray(jpsk.soft_demodulate(
                                      jnp.asarray(x), arity)))
    np.testing.assert_array_equal(psk.demodulate(xt, arity).numpy(),
                                  np.asarray(jpsk.demodulate(x, arity)))
    np.testing.assert_allclose(psk.phase_error(xt, arity).numpy(),
                               jpsk.phase_error(x, arity), atol=1e-6)
    np.testing.assert_array_equal(psk.constellation(arity),
                                  jpsk.constellation(arity))


@pytest.mark.parametrize('mode', range(len(C.MODES)))
def test_decode_core_bytes_every_mode(mode):
    """Modulated PDU -> _decode_core -> the same bytes, for both carrier
    phase ambiguities (bitmask flips the symbols back)."""
    rng = np.random.default_rng(40 + mode)
    pdus = [jmod.random_pdu(mode, rng) for _ in range(2)]
    syms = np.stack([jmod.encode_pdu_to_data_symbols(p, mode) for p in pdus])
    syms[1] *= -1                                  # locked pi out of phase
    bits = backend.decode_frame_batch(torch.as_tensor(syms),
                                      torch.tensor([False, True]), mode)
    assert backend.pdu_bytes_from_bits(bits.numpy()) == pdus


def test_decode_core_matches_jax_on_noisy_symbols():
    rng = np.random.default_rng(9)
    pdu = jmod.random_pdu(2, rng)
    syms = jmod.encode_pdu_to_data_symbols(pdu, 2)
    noisy = (syms + 0.35 * (rng.standard_normal(syms.shape)
                            + 1j * rng.standard_normal(syms.shape))) \
        .astype(np.complex64)[None]
    want = jbackend.decode_frames(noisy, np.asarray([False]), 2)
    got = backend.decode_frames(noisy, np.asarray([False]), 2, 'cpu')
    assert got == want


def _fcs_cases():
    good = make_downlink_mpdu([make_lpdu(bytes([0x0D, 0xFF, 0xD2]))])
    pdus = [good,
            make_uplink_mpdu([make_lpdu(bytes([0x1D, 0xFF, 0xD2])),
                              make_lpdu(bytes([0x0D] + [0x55] * 8))]),
            _make_spdu()]
    for i in range(crc.pdu_hdr_len(good) + 2):      # corrupted header bytes
        b = bytearray(good)
        b[i] ^= 0x40
        pdus.append(bytes(b))
    rng = np.random.default_rng(7)
    pdus += [bytes(rng.integers(0, 256, 80, dtype=np.uint8))
             for _ in range(32)]
    return pdus


def test_device_fcs_matches_host_and_jax():
    pdus = _fcs_cases()
    bits = np.stack([_to_bits(p) for p in pdus])
    got = backend._device_fcs_ok(torch.as_tensor(bits)).numpy().tolist()
    assert got == [crc.pdu_fcs_ok(p) for p in pdus]
    assert got == np.asarray(jbackend._device_fcs_ok(
        jnp.asarray(bits))).tolist()


def test_first_valid_rows_is_static_nonzero():
    rng = np.random.default_rng(5)
    for n, e_max in ((40, 8), (6, 16), (64, 64)):
        valid = rng.random(n) < 0.3
        want = np.asarray(jnp.nonzero(jnp.asarray(valid), size=e_max,
                                      fill_value=n)[0])
        got = backend.first_valid_rows(torch.as_tensor(valid), e_max)
        np.testing.assert_array_equal(got.numpy(), want)


def test_decode_events_inline_matches_jax():
    """A synthetic ring holding frames of modes 0 and 2 (one locked pi out
    of phase), one junk event and empty slots: the packed (row, FCS,
    words) matrix is identical, and the frames decode to their PDUs."""
    rng = np.random.default_rng(12)
    c, ring_t, base22 = 3, 16384, (1 << 22) - 500
    ring = ((rng.standard_normal((c, ring_t))
             + 1j * rng.standard_normal((c, ring_t))) * 0.7) \
        .astype(np.complex64)
    sched = np.asarray(jbackend._data_schedule())
    table = np.zeros((c, 4, 11), np.float32)
    pdus = {}
    for ch, slot, mode, flip, rel in ((0, 0, 0, False, 100),
                                      (2, 1, 2, True, 3000)):
        pdu = jmod.make_test_mpdu(mode, rng, icao=0x3C0000 + ch)
        s = jmod.encode_pdu_to_data_symbols(pdu, mode)
        ring[ch, rel + jbackend.FIRST_DATA_OFFSET + sched[:len(s)]] = \
            -s if flip else s
        start22 = (base22 + rel) & ((1 << 22) - 1)
        table[ch, slot, [0, 1, 2, 10]] = [1, mode, flip, start22]
        pdus[ch * 4 + slot] = pdu
    table[1, 0, [0, 1, 10]] = [1, 1, (base22 + 900) & ((1 << 22) - 1)]
    ev = table.reshape(c, 44)
    want = np.asarray(jbackend.decode_events_inline(
        jnp.asarray(ring), jnp.int32(base22), jnp.asarray(ev), 4))
    got = backend.decode_events_inline(torch.as_tensor(ring), base22,
                                       torch.as_tensor(ev), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:3, 0].tolist() == [0, 4, 9] and got[3, 0] == -1
    assert got[:3, 1].tolist() == [1, 0, 1]
    for row in (0, 2):
        fb = C.MODES[int(table.reshape(-1, 11)[got[row, 0], 1])].framebits
        words = got[row, 2:].astype(np.uint32)
        bits = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1) \
            .reshape(-1)[:fb]
        assert backend.pdu_bytes_from_bits(bits[None])[0] \
            == pdus[int(got[row, 0])]
