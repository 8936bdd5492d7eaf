"""HFDL modulator (frame synthesizer), numpy only.

Counterpart of ``dumphfdl_tpu/dsp/modulator.py`` (which reaches jax
through its ops imports); it gives identical arrays for the same inputs
and seeds, so the card can synthesize traffic without jax.  It exists to
synthesize test vectors for every mode, exercising the exact inverse of the
decode chain documented in SURVEY.md §2.4 (the reference's hfdl.c):

  PDU octets -> LSB-first bits -> K=7 R=1/2 conv encode (+chip doubling for
  rate 1/4) -> interleave -> PSK symbols (MSB-first grouping) -> scrambler
  phase flips -> frame assembly (prekey | A A | M1 | M2 | 9xT | [data30 T15]xN)
  -> 3 sps pulse shaping -> optional channel impairments.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants as C
from dumphfdl_tpu import sequences as seq
from dumphfdl_tpu.ops import bits as bitops
from dumphfdl_tpu.ops import crc as crc_mod
from dumphfdl_tpu.ops import interleave
from ..ops import fec
from ..ops import psk


def encode_pdu_to_data_symbols(pdu: bytes, mode: int) -> np.ndarray:
    """PDU octets -> complex data symbols (scrambled), length num_data_symbols."""
    p = C.MODES[mode]
    if len(pdu) != p.pdu_len_octets:
        raise ValueError(f'mode {mode} wants {p.pdu_len_octets} octets, got {len(pdu)}')
    bits = bitops.bytes_to_bits_lsb_first(pdu)[:p.framebits].copy()
    if bits[-6:].any():
        raise ValueError('last 6 bits must be zero (encoder flush)')
    chips = fec.conv_encode(bits)                       # 2*framebits
    if p.code_rate == 4:
        chips = np.repeat(chips, 2)                     # each chip sent twice
    assert len(chips) == p.num_encoded_bits
    tx_chips = chips[interleave.interleave_perm(mode)]
    syms = psk.bits_to_symbols(tx_chips, p.arity)
    points = psk.modulate(syms, p.arity)
    scr = seq.scrambler_for_symbols(p.num_data_symbols)
    return (points * seq.bipolar(scr)).astype(np.complex64)


def frame_symbols(pdu: bytes, mode: int) -> np.ndarray:
    """Full frame at 1 sample/symbol, unit amplitude."""
    p = C.MODES[mode]
    bp = seq.bipolar
    t = bp(seq.t_bits()).astype(np.complex64)
    parts = [
        np.ones(C.PREKEY_LEN, dtype=np.complex64),              # prekey
        bp(seq.a_bits()).astype(np.complex64),
        bp(seq.a_bits()).astype(np.complex64),
        bp(seq.m1_bits(mode)).astype(np.complex64),
        bp(seq.m2_bits(mode)).astype(np.complex64),
        np.tile(t, C.EQ_TRAIN_SEQ_CNT),
    ]
    data = encode_pdu_to_data_symbols(pdu, mode)
    for s in range(p.data_segment_cnt):
        parts.append(data[s * C.DATA_FRAME_LEN:(s + 1) * C.DATA_FRAME_LEN])
        parts.append(t)
    out = np.concatenate(parts)
    assert len(out) == p.frame_len_symbols
    return out


def random_pdu(mode: int, rng: np.random.Generator) -> bytes:
    """Random PDU payload with valid flush bits (and MPDU-plausible byte 0)."""
    p = C.MODES[mode]
    data = rng.integers(0, 256, p.pdu_len_octets, dtype=np.uint8)
    bits = bitops.bytes_to_bits_lsb_first(data)
    bits[p.framebits - 6:] = 0
    return bytes(bitops.bits_to_bytes_lsb_first(bits)[:p.pdu_len_octets])


@dataclasses.dataclass
class Impairments:
    """Channel impairments applied to synthesized I/Q."""
    snr_db: float | None = None          # AWGN Es/N0 at symbol rate
    cfo_hz: float = 0.0                  # carrier frequency offset
    phase: float = 0.0                   # static carrier phase
    timing_offset: float = 0.0           # fractional-sample delay at fs
    gain: float = 1.0
    seed: int = 0


def pulse_shape(symbols: np.ndarray, sps: int = C.SPS) -> np.ndarray:
    """Upsample and shape with the reference matched-filter taps.

    Using the RX matched filter as the TX pulse gives the cascade the
    response the demodulator was designed for (hfdl.c:148-155).
    """
    taps = np.asarray(C.MF_TAPS, dtype=np.float32) * sps
    up = np.zeros(len(symbols) * sps, dtype=np.complex64)
    up[::sps] = symbols
    return np.convolve(up, taps, mode='full')[:len(up)].astype(np.complex64)


def synthesize_iq(symbols: np.ndarray,
                  fs: float = C.INTERNAL_RATE,
                  imp: Impairments | None = None,
                  pad_symbols: tuple[int, int] = (64, 64)) -> np.ndarray:
    """Frame symbols -> complex baseband at fs (centered on the PSK carrier)."""
    sps_f = fs / C.SYMBOL_RATE
    if abs(sps_f - round(sps_f)) > 1e-9:
        raise ValueError('use an integer samples-per-symbol rate here')
    sps = int(round(sps_f))
    silence0 = np.zeros(pad_symbols[0] * sps, dtype=np.complex64)
    silence1 = np.zeros(pad_symbols[1] * sps, dtype=np.complex64)
    if sps == C.SPS:
        shaped = pulse_shape(symbols, sps)
    else:
        # shape at 3 sps then integer-upsample via zero-order polyphase sinc
        shaped3 = pulse_shape(symbols, C.SPS)
        shaped = _resample_poly(shaped3, sps, C.SPS)
    iq = np.concatenate([silence0, shaped, silence1])
    if imp is not None:
        rng = np.random.default_rng(imp.seed)
        n = np.arange(len(iq))
        if imp.timing_offset:
            iq = _fractional_delay(iq, imp.timing_offset)
        if imp.cfo_hz or imp.phase:
            iq = iq * np.exp(1j * (2 * np.pi * imp.cfo_hz / fs * n + imp.phase))
        iq = iq * imp.gain
        if imp.snr_db is not None:
            # Es measured over the frame's active region
            es = np.mean(np.abs(shaped) ** 2) * (imp.gain ** 2)
            n0 = es / (10 ** (imp.snr_db / 10)) * (fs / C.SYMBOL_RATE) / C.SPS
            noise = (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq)))
            iq = iq + noise.astype(np.complex64) * np.sqrt(n0 / 2)
    return iq.astype(np.complex64)


def _fractional_delay(x: np.ndarray, delay: float, ntaps: int = 63) -> np.ndarray:
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(n - delay) * np.hamming(ntaps)
    h /= h.sum()
    return np.convolve(x, h, mode='same').astype(np.complex64)


def _resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    from math import gcd
    g = gcd(up, down)
    up //= g
    down //= g
    nz = np.zeros(len(x) * up, dtype=np.complex64)
    nz[::up] = x
    cutoff = 0.5 / max(up, down)
    ntaps = 16 * max(up, down) + 1
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * n) * np.hamming(ntaps) * up
    y = np.convolve(nz, h, mode='same')
    return y[::down].astype(np.complex64)


def make_test_mpdu(mode: int, rng: np.random.Generator,
                   src_ac: int = 0x42, dst_gs: int = 0x05,
                   icao: int = 0x4007F5) -> bytes:
    """A protocol-valid downlink MPDU (logon request) padded to the frame's
    PDU size -- for golden-file decode tests through the full stack."""
    p = C.MODES[mode]
    icao_rev = bytes(bitops.reverse_bytes(
        np.frombuffer(icao.to_bytes(3, 'big'), np.uint8)))
    lpdu = crc_mod.fcs_append(bytes([0x8F]) + icao_rev)
    hdr = bytes([0x3 | (1 << 2), dst_gs, src_ac, 0, 0, 0, len(lpdu) - 1])
    payload = crc_mod.fcs_append(hdr) + lpdu
    if len(payload) > p.pdu_len_octets:
        raise ValueError('payload too large for mode')
    pdu = payload + bytes(p.pdu_len_octets - len(payload))
    # zero flush bits are guaranteed by the zero padding
    return pdu


def synthesize_wideband(emissions: list[tuple[bytes, int, int]],
                        fs: int, centerfreq: int,
                        snr_db: float | None = 30.0,
                        amplitude: float = 0.25,
                        pad_symbols: int = 300,
                        seed: int = 0) -> np.ndarray:
    """Synthesize a wideband capture with one frame per (pdu, mode, freq_hz).

    Each emission is upconverted to its channel's SSB carrier offset from
    centerfreq; AWGN at snr_db (None = clean) covers the whole capture.
    """
    sigs = []
    for pdu, mode, chan in emissions:
        syms = frame_symbols(pdu, mode)
        iq = synthesize_iq(syms, pad_symbols=(pad_symbols, pad_symbols))
        sigs.append((iq, chan))
    n_max = max(len(s[0]) for s in sigs)
    n_wb = int(np.ceil(n_max * fs / C.INTERNAL_RATE)) + fs // 10
    wb = np.zeros(n_wb, dtype=np.complex64)
    for iq, chan in sigs:
        up = _resample_poly(iq, fs, C.INTERNAL_RATE)
        f_off = (chan + C.SSB_CARRIER_OFFSET_HZ) - centerfreq
        n = np.arange(len(up))
        wb[:len(up)] += (up * np.exp(2j * np.pi * f_off / fs * n)
                         ).astype(np.complex64) * amplitude
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        es = amplitude ** 2 * 0.5 * (C.SPS / (fs / C.INTERNAL_RATE)) / C.SPS
        n0 = es / (10 ** (snr_db / 10))
        noise = (rng.standard_normal(n_wb) + 1j * rng.standard_normal(n_wb))
        wb = wb + noise.astype(np.complex64) * np.sqrt(n0 / 2)
    return _prevent_clipping(wb.astype(np.complex64))


def synthesize_channel_iq(frames: list[tuple[np.ndarray, int]],
                          fs: float,
                          channel_offset_hz: float = 0.0,
                          gap_symbols: int = 200) -> np.ndarray:
    """Concatenate multiple frames (symbols, mode) into one channel capture.

    channel_offset_hz shifts the emission away from complex baseband zero,
    e.g. +SSB_CARRIER_OFFSET_HZ relative to a channel centered at DC.
    """
    parts = []
    for symbols, _mode in frames:
        parts.append(synthesize_iq(symbols, fs=fs, pad_symbols=(gap_symbols, gap_symbols)))
    iq = np.concatenate(parts)
    if channel_offset_hz:
        n = np.arange(len(iq))
        iq = iq * np.exp(2j * np.pi * channel_offset_hz / fs * n)
    return iq.astype(np.complex64)


def synthesize_wideband_fft(emissions: list[tuple[bytes, int, int]],
                            fs: int, centerfreq: int,
                            snr_db: float | None = 30.0,
                            amplitude: float = 0.25,
                            pad_symbols: int = 300,
                            seed: int = 0) -> np.ndarray:
    """Fast wideband synthesis: exact frequency-domain upconversion.

    Equivalent to synthesize_wideband but O(n log n): each frame's 5400-sps
    spectrum is placed directly into the wideband FFT grid (bin spacings
    match exactly when fs is a multiple of INTERNAL_RATE) and one inverse
    FFT produces the capture.  Used for large benchmark captures where the
    polyphase time-domain path would take minutes.
    """
    if fs % C.INTERNAL_RATE:
        raise ValueError('fs must be a multiple of the 5400 sps internal rate')
    ratio = fs // C.INTERNAL_RATE
    sigs = []
    for pdu, mode, chan in emissions:
        syms = frame_symbols(pdu, mode)
        iq = synthesize_iq(syms, pad_symbols=(pad_symbols, pad_symbols))
        sigs.append((iq, chan))
    n_nb = max(len(s[0]) for s in sigs) + C.INTERNAL_RATE // 10
    n_wb = n_nb * ratio
    spec = np.zeros(n_wb, dtype=np.complex128)
    bins = np.fft.fftfreq(n_nb, 1.0 / n_nb).astype(np.int64)   # 0..+- order
    for iq, chan in sigs:
        x = np.fft.fft(iq, n=n_nb)
        f_off = (chan + C.SSB_CARRIER_OFFSET_HZ) - centerfreq
        m0 = int(round(f_off * n_wb / fs))
        spec[(m0 + bins) % n_wb] += x * amplitude
    wb = (np.fft.ifft(spec) * ratio).astype(np.complex64)
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        es = amplitude ** 2 * 0.5 * (C.SPS / ratio) / C.SPS
        n0 = es / (10 ** (snr_db / 10))
        noise = (rng.standard_normal(n_wb) + 1j * rng.standard_normal(n_wb))
        wb = wb + noise.astype(np.complex64) * np.sqrt(n0 / 2).astype(np.float32)
    return _prevent_clipping(wb)


def _prevent_clipping(wb: np.ndarray) -> np.ndarray:
    """Scale a synthesized capture into integer-format full scale.

    Many coherently-starting emissions sum to peaks far above 1.0; the
    CS16/CU8 serializers clip at full scale, and a clipped multi-carrier
    capture decodes spurious intermodulation "frames" on quiet channels
    (observed: 67 FCS-failing junk frames on a 16-emission 256-channel
    bench capture that peaked at 6.7).  Uniform scaling preserves every
    per-emission SNR, so decode behavior is unchanged."""
    peak = max(float(np.abs(wb.real).max(initial=0.0)),
               float(np.abs(wb.imag).max(initial=0.0)))
    if peak > 0.95:
        wb = wb * np.float32(0.95 / peak)
    return wb.astype(np.complex64)
