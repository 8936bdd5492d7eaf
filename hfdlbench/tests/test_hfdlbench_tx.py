"""The benchmark's frozen transmitter against the port's modulator (the
same PDUs, symbols, shaped frame and bytes for the same inputs), and the
loop's placement of each frame by slot, delay and Es/N0."""

import numpy as np
import pytest

from hfdlbench import tx

modulator = pytest.importorskip('dumphfdl_tpu_torch.dsp.modulator')
from dumphfdl_tpu_torch import constants as C  # noqa: E402
from dumphfdl_tpu_torch.io import formats  # noqa: E402


@pytest.mark.parametrize('mode', range(8))
def test_mode_geometry_and_frame(mode):
    m, p = tx.MODES[mode], C.MODES[mode]
    assert (m.framebits, m.pdu_len, m.viterbi_input_len, m.frame_symbols,
            m.single_slot) == (p.framebits, p.pdu_len_octets,
                               p.viterbi_input_len, p.frame_len_symbols,
                               p.slot == 'S')
    pdu = tx.make_mpdu(mode, 0x42, 0x05, 0x4007F5)
    assert pdu == modulator.make_test_mpdu(mode, np.random.default_rng(0))
    np.testing.assert_array_equal(tx.frame_symbols(pdu, mode),
                                  modulator.frame_symbols(pdu, mode))


def test_frame_baseband_and_serialize_equal_the_port():
    pdu = tx.make_mpdu(2, 7, 3, 0x123456)
    ours = tx.frame_baseband(pdu, 2)
    port = modulator.pulse_shape(modulator.frame_symbols(pdu, 2), C.SPS)
    np.testing.assert_array_equal(ours, port)
    for fmt in ('CS16', 'CU8', 'CF32'):
        assert tx.serialize(ours, fmt) == formats.serialize(ours, fmt)


@pytest.mark.parametrize('snr_db,delay_s', [(10.0, 0.0), (25.0, 0.0137)])
def test_wideband_loop_places_each_frame_at_its_slot_delay_and_es_n0(
        snr_db, delay_s):
    """Mixed down and cut to its 5400-Hz band, the loop gives the frame
    back, delayed and scaled to its Es/N0 over the band's noise."""
    fs, centre, ratio = 54_000, 10_000_000, 10
    e = tx.Emission(channel=0, hz=10_004_000, slot=1, mode=1,
                    pdu=tx.make_mpdu(1, 1, 2, 3), snr_db=snr_db,
                    delay_s=delay_s)
    wb = tx.wideband_loop([e], 2, fs, centre, seed=5)
    n_slot = tx.SLOT_SYMBOLS * 3 * ratio
    n_nb = tx.FRAME_GRID
    n_wb = n_nb * ratio
    assert len(wb) == 2 * n_slot
    quiet = np.fft.fft(wb[:n_wb])
    seg = np.fft.fft(wb[n_slot:n_slot + n_wb])
    m0 = round((e.hz + tx.SSB_CARRIER_OFFSET_HZ - centre) * n_wb / fs)
    bins = np.fft.fftfreq(n_nb, 1.0 / n_nb).astype(np.int64)
    got = np.fft.ifft(seg[(m0 + bins) % n_wb]) / ratio
    noise = np.fft.ifft(quiet[(m0 + bins) % n_wb]) / ratio
    bb = tx.frame_baseband(e.pdu, e.mode)
    hz = np.fft.fftfreq(n_nb, 1.0 / tx.INTERNAL_RATE)
    want_spec = np.fft.fft(bb, n=n_nb) * np.exp(-2j * np.pi * hz * delay_s)
    want = np.fft.ifft(want_spec)
    gain = np.vdot(want, got).real / np.vdot(want, want).real
    es_n0 = 10 * np.log10(gain ** 2 * np.mean(np.abs(bb) ** 2)
                          / np.mean(np.abs(noise) ** 2))
    assert es_n0 == pytest.approx(snr_db, abs=0.2)
    resid = got - gain * want
    assert np.mean(np.abs(resid) ** 2) == pytest.approx(
        np.mean(np.abs(noise) ** 2), rel=0.05)


def test_fcs_is_the_hfdl_crc():
    from dumphfdl_tpu_torch.ops import crc
    data = bytes(range(40))
    assert tx.fcs_append(data) == crc.fcs_append(data)
    pdu = tx.make_mpdu(2, 200, 100, 0xABCDEF)
    assert crc.pdu_fcs_ok(pdu)
