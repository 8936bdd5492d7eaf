"""The benchmark's own HFDL transmitter: PDU octets to a wideband capture.

A frozen copy of the port's modulator (``dsp/modulator.py``) and of the
protocol facts it needs (frame geometry, sequences, scrambler, K=7 R=1/2
convolutional code, interleaver, PSK mapping, FCS), so that the traffic the
benchmark offers does not change when the program changes, and so that the
truth the decoded frames are held against is made without the program.
``hfdlbench/tests/test_hfdlbench_tx.py`` holds it equal to the port's
modulator array for array.

Chain (ICAO Doc 9741; SURVEY.md section 2.4): PDU octets -> LSB-first bits ->
convolutional code (+ chip doubling at rate 1/4) -> interleaver -> PSK
symbols, MSB-first groups -> scrambler phase flips -> frame (prekey | A A |
M1 | M2 | 9 x T | [30 data, 15 T] x segments) -> 3 samples a symbol shaped
by the matched filter -> each emission placed at its slot, delay and Es/N0
on its channel's carrier in the slot's wideband FFT grid, over white
noise a tenth of full scale.  (The port's modulator places every frame at
one time, over noise set per wideband sample; the benchmark's traffic
places frames by the HFDL slot structure at Es/N0 in the channel.)
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools

import numpy as np

# --- symbol clock and frame geometry ---
SPS = 3
SYMBOL_RATE = 1800
INTERNAL_RATE = SYMBOL_RATE * SPS
SSB_CARRIER_OFFSET_HZ = 1440
PREKEY_LEN = 448
A_LEN = 127
M2_LEN = 15
T_LEN = 15
EQ_TRAIN_SEQ_CNT = 9
DATA_FRAME_LEN = 30
SINGLE_SLOT_SEGMENTS = 72
DOUBLE_SLOT_SEGMENTS = 168
PREAMBLE_LEN = 2 * A_LEN + 127 + M2_LEN + EQ_TRAIN_SEQ_CNT * T_LEN
# a TDMA slot, 32/13 s (13 slots make HFDL's 32-s frame), to the symbol
SLOT_SYMBOLS = 4431
# the FFT grid a slot's frames are made in: 2.4 s, at least the longest
# single-slot frame and its delay (12657 + 146 samples), of small factors
FRAME_GRID = 12960              # 5400-sps samples
NOISE_RMS = 0.05                # wideband noise per I and Q, of full scale
WORKERS = 8                     # threads that make a capture
M_SHIFTS = (72, 82, 113, 123, 61, 103, 93, 9)
T_BITS_VALUE = 0x9AF
SCRAMBLER_GENPOLY, SCRAMBLER_INIT, SCRAMBLER_PERIOD = 0x4001, 0x4D4B, 120
INTERLEAVER_ROWS, INTERLEAVER_POP_ROW_SHIFT = 40, 9
V27_POLY_A, V27_POLY_B = 0x6D, 0x4F
MF_TAPS = (
    -0.0170974647427123, 0.01148231492068473, 0.03138375667422348,
    0.009454398851680437, -0.04161644170893816, -0.06451564801420356,
    -0.005495792933327306, 0.1316404671361545, 0.2759693160697777,
    0.3375901874933208, 0.2759693160697777, 0.1316404671361545,
    -0.005495792933327306, -0.06451564801420356, -0.04161644170893816,
    0.009454398851680437, 0.03138375667422348, 0.01148231492068473,
    -0.0170974647427123,
)


@dataclasses.dataclass(frozen=True)
class Mode:
    arity: int                  # bits per symbol
    segments: int               # 72 single slot, 168 double slot
    code_rate: int              # 2, or 4 (every chip sent twice)
    push_shift: int             # interleaver push column shift

    @property
    def data_symbols(self) -> int:
        return self.segments * DATA_FRAME_LEN

    @property
    def encoded_bits(self) -> int:
        return self.data_symbols * self.arity

    @property
    def viterbi_input_len(self) -> int:
        """Soft values the Viterbi decoder takes (rate 1/4: chip pairs
        combined)."""
        return self.encoded_bits // (2 if self.code_rate == 4 else 1)

    @property
    def framebits(self) -> int:
        """Decoded bits, the encoder's 6 flush bits included."""
        return self.viterbi_input_len // 2

    @property
    def pdu_len(self) -> int:
        return (self.framebits + 7) // 8

    @property
    def single_slot(self) -> bool:
        return self.segments == SINGLE_SLOT_SEGMENTS

    @property
    def frame_symbols(self) -> int:
        return PREKEY_LEN + PREAMBLE_LEN + self.segments * (DATA_FRAME_LEN
                                                            + T_LEN)


MODES = tuple(Mode(*m) for m in [
    (1, 72, 4, 17), (1, 72, 2, 17), (2, 72, 2, 17), (3, 72, 2, 17),
    (1, 168, 4, 23), (1, 168, 2, 23), (2, 168, 2, 23), (3, 168, 2, 23)])
SINGLE_SLOT_MODES = tuple(i for i, m in enumerate(MODES) if m.single_slot)

_A_OCTETS = bytes([
    0b01011011, 0b10111100, 0b01110100, 0b01010111,
    0b00000011, 0b11011001, 0b10001001, 0b00111001,
    0b11110010, 0b00001000, 0b11010101, 0b00110110,
    0b10010100, 0b00101100, 0b00110010, 0b11111110,
])
_M1_BASE_BITS = [
    0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0, 0,
    1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1,
    0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 1, 1,
    0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1,
    1, 1, 1, 0, 0, 1, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
]


def _bipolar(bits) -> np.ndarray:
    return 1.0 - 2.0 * np.asarray(bits, dtype=np.float32)


def a_bits() -> np.ndarray:
    return np.unpackbits(np.frombuffer(_A_OCTETS, np.uint8))[1:].astype(
        np.int8)


def m1_bits(mode: int) -> np.ndarray:
    return np.roll(np.array(_M1_BASE_BITS, np.int8), -M_SHIFTS[mode])


def t_bits() -> np.ndarray:
    return np.array([(T_BITS_VALUE >> (T_LEN - 1 - i)) & 1
                     for i in range(T_LEN)], np.int8)


@functools.cache
def _scrambler_bits() -> np.ndarray:
    """15-stage LFSR x^15 + x + 1 from 0x4D4B, 120 bits, one per data
    symbol."""
    v, mask = SCRAMBLER_INIT, (1 << 15) - 1
    out = np.empty(SCRAMBLER_PERIOD, np.int8)
    for i in range(SCRAMBLER_PERIOD):
        b = bin(v & SCRAMBLER_GENPOLY).count('1') & 1
        v = ((v << 1) | b) & mask
        out[i] = b
    return out


_CRC_TABLE = np.array([
    [(c := i), *[(c := (c >> 1) ^ 0x8408 if c & 1 else c >> 1)
                 for _ in range(8)]][-1] for i in range(256)], np.uint16)


def fcs(data: bytes) -> int:
    """HFDL FCS: reflected CRC-16/CCITT from 0xFFFF, complemented."""
    crc = 0xFFFF
    for b in data:
        crc = (crc >> 8) ^ int(_CRC_TABLE[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFF


def fcs_append(data: bytes) -> bytes:
    f = fcs(data)
    return bytes(data) + bytes([f & 0xFF, f >> 8])


def _reverse_byte(b: int) -> int:
    return int(f'{b:08b}'[::-1], 2)


def make_mpdu(mode: int, src_ac: int, dst_gs: int, icao: int) -> bytes:
    """A protocol-valid downlink MPDU (a logon request from `icao` to
    ground station `dst_gs`), zero-padded to the mode's PDU size."""
    lpdu = fcs_append(bytes([0x8F]) + bytes(
        _reverse_byte(b) for b in icao.to_bytes(3, 'big')))
    hdr = bytes([0x3 | (1 << 2), dst_gs, src_ac, 0, 0, 0, len(lpdu) - 1])
    payload = fcs_append(hdr) + lpdu
    return payload + bytes(MODES[mode].pdu_len - len(payload))


@functools.cache
def _interleave_perm(mode: int) -> np.ndarray:
    """tx_chips[k] = coded_chips[perm[k]] (the reference's push/pop
    walk over a 40-row table)."""
    m = MODES[mode]
    cols = m.encoded_bits // INTERLEAVER_ROWS
    n = INTERLEAVER_ROWS * cols
    k = np.arange(n, dtype=np.int64)
    push_cell = (k % INTERLEAVER_ROWS) * cols \
        + (k // INTERLEAVER_ROWS - k * m.push_shift) % cols
    pop_cell = (INTERLEAVER_POP_ROW_SHIFT * k) % INTERLEAVER_ROWS * cols \
        + k // INTERLEAVER_ROWS
    cell_to_push = np.empty(n, np.int64)
    cell_to_push[push_cell] = k
    deint = cell_to_push[pop_cell]
    inter = np.empty(n, np.int64)
    inter[deint] = k
    return inter


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """K=7 R=1/2 (polynomials 0x6D, 0x4F): chips [c0_0, c1_0, c0_1, ...]."""
    reg = np.zeros(len(bits), np.int64)
    acc = 0
    for k, b in enumerate(np.asarray(bits, np.int64)):
        acc = ((acc << 1) | int(b)) & 0x7F
        reg[k] = acc
    parity = np.vectorize(lambda v: bin(v).count('1') & 1)
    out = np.empty(2 * len(bits), np.int8)
    out[0::2] = parity(reg & V27_POLY_A)
    out[1::2] = parity(reg & V27_POLY_B)
    return out


def _constellation(arity: int) -> np.ndarray:
    if arity == 1:
        return np.array([1.0 + 0j, -1.0 + 0j], np.complex64)
    s = np.arange(1 << arity)
    if arity == 2:
        return ((np.where(s & 1, -1.0, 1.0) + 1j * np.where(s & 2, -1.0, 1.0))
                / np.sqrt(2.0)).astype(np.complex64)
    gray = s ^ (s >> 1)
    gray ^= gray >> 2
    return np.exp(2j * np.pi * gray / 8).astype(np.complex64)


def data_symbols(pdu: bytes, mode: int) -> np.ndarray:
    """PDU octets -> the frame's scrambled data symbols."""
    m = MODES[mode]
    bits = np.unpackbits(np.frombuffer(pdu, np.uint8),
                         bitorder='little')[:m.framebits].astype(np.int8)
    if bits[-6:].any():
        raise ValueError('the last 6 bits must be zero (encoder flush)')
    chips = conv_encode(bits)
    if m.code_rate == 4:
        chips = np.repeat(chips, 2)
    tx = chips[_interleave_perm(mode)].astype(np.int64).reshape(-1, m.arity)
    syms = tx @ (1 << np.arange(m.arity - 1, -1, -1))
    scr = np.tile(_scrambler_bits(), -(-m.data_symbols // SCRAMBLER_PERIOD))
    return (_constellation(m.arity)[syms]
            * _bipolar(scr[:m.data_symbols])).astype(np.complex64)


def frame_symbols(pdu: bytes, mode: int) -> np.ndarray:
    """The whole frame at one sample a symbol, unit amplitude."""
    t = _bipolar(t_bits()).astype(np.complex64)
    parts = [np.ones(PREKEY_LEN, np.complex64),
             _bipolar(a_bits()).astype(np.complex64),
             _bipolar(a_bits()).astype(np.complex64),
             _bipolar(m1_bits(mode)).astype(np.complex64),
             _bipolar(m1_bits(mode)[:M2_LEN]).astype(np.complex64),
             np.tile(t, EQ_TRAIN_SEQ_CNT)]
    data = data_symbols(pdu, mode)
    for s in range(MODES[mode].segments):
        parts.append(data[s * DATA_FRAME_LEN:(s + 1) * DATA_FRAME_LEN])
        parts.append(t)
    return np.concatenate(parts)


def frame_baseband(pdu: bytes, mode: int) -> np.ndarray:
    """The frame at 5400 sps, shaped by the matched filter's taps."""
    syms = frame_symbols(pdu, mode)
    up = np.zeros(len(syms) * SPS, np.complex64)
    up[::SPS] = syms
    taps = np.asarray(MF_TAPS, np.float32) * SPS
    return np.convolve(up, taps, mode='full')[:len(up)].astype(np.complex64)


@dataclasses.dataclass(frozen=True)
class Emission:
    """One frame on the air within a loop of the capture."""
    channel: int                # index into the deployment's channel list
    hz: int                     # the channel's frequency
    slot: int                   # TDMA slot of the loop it starts in
    mode: int
    pdu: bytes
    snr_db: float               # Es/N0 in the channel
    delay_s: float              # after the slot's start (propagation)

    @property
    def start_symbol(self) -> float:
        """Where the frame starts within its loop, in symbols."""
        return self.slot * SLOT_SYMBOLS + self.delay_s * SYMBOL_RATE


def _slot_spectrum(here, fs: int, centerfreq: int) -> np.ndarray:
    """The wideband spectrum of one slot's frames on its FRAME_GRID grid."""
    ratio = fs // INTERNAL_RATE
    n_wb = FRAME_GRID * ratio
    hz_nb = np.fft.fftfreq(FRAME_GRID, 1.0 / INTERNAL_RATE)
    bins = np.fft.fftfreq(FRAME_GRID, 1.0 / FRAME_GRID).astype(np.int64)
    n0_band = 2 * NOISE_RMS ** 2 / ratio    # noise power in 5400 Hz
    spec = np.zeros(n_wb, np.complex64)
    for e in here:
        bb = frame_baseband(e.pdu, e.mode)
        if len(bb) + e.delay_s * INTERNAL_RATE > FRAME_GRID:
            raise ValueError('a frame and its delay outlast the grid')
        gain = np.sqrt(10 ** (e.snr_db / 10) * n0_band
                       / np.mean(np.abs(bb) ** 2))
        m0 = int(round((e.hz + SSB_CARRIER_OFFSET_HZ - centerfreq)
                       * n_wb / fs))
        spec[(m0 + bins) % n_wb] += np.fft.fft(bb, n=FRAME_GRID) * gain \
            * np.exp(-2j * np.pi * hz_nb * e.delay_s)
    return spec


def wideband_loop(emissions, slots: int, fs: int, centerfreq: int,
                  seed: int) -> np.ndarray:
    """One loop of `slots` TDMA slots holding every emission, slot by slot
    (slots in parallel threads, each with its own noise stream): white
    noise of NOISE_RMS per I and Q from `seed`; each frame's 5400-sps
    spectrum, delayed by its delay_s (a phase ramp, so any fraction of a
    sample) and scaled to its Es/N0 against the noise in a 5400-Hz band
    (the sensitivity sweep's measure: Es over the frame's own samples),
    placed on its carrier (channel + 1440 Hz) in the wideband FFT grid of
    the first FRAME_GRID samples of its slot; one inverse FFT a slot that
    holds frames."""
    import scipy.fft
    if fs % INTERNAL_RATE:
        raise ValueError('fs must be a multiple of 5400 sps')
    ratio = fs // INTERNAL_RATE
    n_slot = SLOT_SYMBOLS * SPS * ratio
    n_wb = FRAME_GRID * ratio
    noise = np.random.SeedSequence([seed, 2]).spawn(slots)
    out = np.empty(slots * n_slot, np.complex64)

    def slot(s: int) -> None:
        seg = out[s * n_slot:(s + 1) * n_slot]
        flat = seg.view(np.float32)
        np.random.default_rng(noise[s]).standard_normal(
            out=flat, dtype=np.float32)
        flat *= np.float32(NOISE_RMS)
        here = [e for e in emissions if e.slot == s]
        if here:
            seg[:n_wb] += scipy.fft.ifft(
                _slot_spectrum(here, fs, centerfreq), overwrite_x=True) \
                * np.float32(ratio)

    with concurrent.futures.ThreadPoolExecutor(WORKERS) as pool:
        list(pool.map(slot, range(slots)))
    return out


def serialize(samples: np.ndarray, fmt: str) -> bytes:
    """complex64 -> raw interleaved I/Q bytes of CS16, CU8 or CF32 (in
    parallel threads over pieces of the samples)."""
    inter = np.ascontiguousarray(samples, np.complex64).view(np.float32)
    fmt = fmt.upper()
    if fmt == 'CF32':
        return inter.tobytes()
    if fmt == 'CS16':
        scale, offset, lo, hi, kind = 32767.5, 0.0, -32768, 32767, np.int16
    elif fmt == 'CU8':
        scale, offset, lo, hi, kind = 127.0, 63.5, 0, 255, np.uint8
    else:
        raise ValueError(f'unknown sample format {fmt}')
    out = np.empty(len(inter), kind)
    step = -(-len(inter) // WORKERS)

    def piece(a: int) -> None:
        y = inter[a:a + step] * np.float32(scale)
        if offset:
            y += np.float32(offset)
        np.round(y, out=y)
        np.clip(y, lo, hi, out=y)
        out[a:a + step] = y

    with concurrent.futures.ThreadPoolExecutor(WORKERS) as pool:
        list(pool.map(piece, range(0, len(inter), step)))
    return out.tobytes()


BYTES_PER_SAMPLE = {'CU8': 2, 'CS16': 4, 'CF32': 8}
