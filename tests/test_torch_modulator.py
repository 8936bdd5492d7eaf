"""PyTorch port, dsp/modulator: the numpy-only copy gives arrays identical
to the JAX package's modulator for the same inputs and seeds."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu import constants as C  # noqa: E402
from dumphfdl_tpu.dsp import modulator as jmod  # noqa: E402
from dumphfdl_tpu_torch.dsp import modulator as mod  # noqa: E402


@pytest.mark.parametrize('mode', range(len(C.MODES)))
def test_frame_symbols_identical(mode):
    pdu = jmod.random_pdu(mode, np.random.default_rng(mode))
    assert mod.random_pdu(mode, np.random.default_rng(mode)) == pdu
    np.testing.assert_array_equal(mod.encode_pdu_to_data_symbols(pdu, mode),
                                  jmod.encode_pdu_to_data_symbols(pdu, mode))
    np.testing.assert_array_equal(mod.frame_symbols(pdu, mode),
                                  jmod.frame_symbols(pdu, mode))


def test_test_mpdu_and_impaired_iq_identical():
    pdus = [m.make_test_mpdu(1, np.random.default_rng(3), icao=0x3C0001)
            for m in (mod, jmod)]
    assert pdus[0] == pdus[1]
    syms = jmod.frame_symbols(pdus[0], 1)
    imp = dict(snr_db=12.0, cfo_hz=-20.0, phase=0.3, timing_offset=0.4,
               gain=0.7, seed=9)
    np.testing.assert_array_equal(
        mod.synthesize_iq(syms, imp=mod.Impairments(**imp)),
        jmod.synthesize_iq(syms, imp=jmod.Impairments(**imp)))
    np.testing.assert_array_equal(
        mod.synthesize_iq(syms, fs=10_800),
        jmod.synthesize_iq(syms, fs=10_800))


def test_wideband_synthesis_identical():
    rng = np.random.default_rng(5)
    emissions = [(jmod.make_test_mpdu(0, rng), 0, 8_912_000),
                 (jmod.make_test_mpdu(2, rng), 2, 8_942_000)]
    kw = dict(fs=48_000, centerfreq=8_930_000, snr_db=20.0, seed=4)
    np.testing.assert_array_equal(mod.synthesize_wideband(emissions, **kw),
                                  jmod.synthesize_wideband(emissions, **kw))
    kw['fs'] = 43_200
    np.testing.assert_array_equal(
        mod.synthesize_wideband_fft(emissions, **kw),
        jmod.synthesize_wideband_fft(emissions, **kw))
    frames = [(jmod.frame_symbols(p, m), m) for p, m, _ in emissions]
    np.testing.assert_array_equal(
        mod.synthesize_channel_iq(frames, fs=5400, channel_offset_hz=1440),
        jmod.synthesize_channel_iq(frames, fs=5400, channel_offset_hz=1440))
