# Copy of dumphfdl_tpu/constants.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""HFDL physical-layer constants.

Behavioral spec extracted from the reference implementation
(szpajder/dumphfdl); each constant cites its source location so parity can
be audited.  These are protocol facts (ICAO Doc 9741 / ARINC 635 HFDL), not
code: the framework re-derives all algorithms TPU-first.

Citations: reference src/hfdl.h:6-8, reference src/hfdl.c:29-46,
reference src/hfdl.c:74-138.
"""

from __future__ import annotations

import dataclasses

# --- Symbol clock (hfdl.h:6-8) ---
SPS = 3                         # samples per symbol at internal rate
SYMBOL_RATE = 1800              # Bd
INTERNAL_RATE = SYMBOL_RATE * SPS   # 5400 sps narrowband processing rate
CHANNEL_TRANSITION_BW_HZ = 250
SSB_CARRIER_OFFSET_HZ = 1440    # channel freq -> suppressed-carrier freq (hfdl.c:46)

# --- Frame geometry (hfdl.c:29-41) ---
PREKEY_LEN = 448                # unmodulated-carrier symbols
A_LEN = 127                     # A preamble chips (sent twice)
M1_LEN = 127
M2_LEN = 15
M_SHIFT_CNT = 8                 # number of M1 cyclic shifts == number of modes
T_LEN = 15                      # training probe length
EQ_TRAIN_SEQ_CNT = 9            # training sequences after M2, before data
DATA_FRAME_LEN = 30             # data symbols per segment
DATA_FRAME_CNT_SINGLE_SLOT = 72
DATA_FRAME_CNT_DOUBLE_SLOT = 168
DATA_SYMBOLS_MAX = DATA_FRAME_CNT_DOUBLE_SLOT * DATA_FRAME_LEN  # 5040
# depth of the per-channel rotating frame buffers: a completed frame's
# buffer survives until the (FRAME_PARITY_SLOTS)-th next frame starts
# writing data, so deeper buffers allow longer demod blocks (the
# collection window must fit inside (P-1)*SINGLE_SLOT_FRAME_LEN+PREKEY
# symbols; see channel.ChannelBank._check_block_invariant)
FRAME_PARITY_SLOTS = 4
PREAMBLE_LEN = 2 * A_LEN + M1_LEN + M2_LEN + EQ_TRAIN_SEQ_CNT * T_LEN  # 531
SINGLE_SLOT_FRAME_LEN = (PREKEY_LEN + PREAMBLE_LEN
                         + DATA_FRAME_CNT_SINGLE_SLOT * (DATA_FRAME_LEN + T_LEN))  # 4219
DOUBLE_SLOT_FRAME_LEN = (PREKEY_LEN + PREAMBLE_LEN
                         + DATA_FRAME_CNT_DOUBLE_SLOT * (DATA_FRAME_LEN + T_LEN))  # 8539

# --- Acquisition thresholds (hfdl.c:42-45) ---
CORR_THRESHOLD_A1 = 0.36
CORR_THRESHOLD_A2 = 0.3
CORR_THRESHOLD_M1 = 0.3
MAX_SEARCH_RETRIES = 3
MAX_SYMBOLS_WITHOUT_FRAME = 13 * SINGLE_SLOT_FRAME_LEN  # watchdog (hfdl.c:613)

# --- Training sequence: 15 bits, MSB first (hfdl.c:181) ---
T_BITS_VALUE = 0x9AF

# --- M1 cyclic shifts, one per mode (hfdl.c:449) ---
M_SHIFTS = (72, 82, 113, 123, 61, 103, 93, 9)

# --- Modulation arity (bits/symbol) per mode (hfdl.c:65-70) ---
M_BPSK, M_PSK4, M_PSK8 = 1, 2, 3
MOD_ARITY_MAX = M_PSK8

# --- Scrambler: 15-bit LFSR, x^15+x+1, restart every 120 bits
#     (hfdl.c:332-346; liquid>=1.6 parameterization) ---
SCRAMBLER_NUMBITS = 15
SCRAMBLER_GENPOLY = 0x4001
SCRAMBLER_INIT = 0x4D4B
SCRAMBLER_PERIOD = 120

# --- Deinterleaver geometry (hfdl.c:360-361) ---
DEINTERLEAVER_ROW_CNT = 40
DEINTERLEAVER_POP_ROW_SHIFT = 9

# --- Convolutional code K=7 R=1/2, Phil Karn polys (libfec/fec.h:13-14) ---
V27_POLY_A = 0x6D
V27_POLY_B = 0x4F
V27_K = 7

# --- Matched filter taps, 19 taps = SPS*3 symbol delay*2+1 (hfdl.c:146-155) ---
MF_SYMBOL_DELAY = 3
MF_TAPS = (
    -0.0170974647427123, 0.01148231492068473, 0.03138375667422348,
    0.009454398851680437, -0.04161644170893816, -0.06451564801420356,
    -0.005495792933327306, 0.1316404671361545, 0.2759693160697777,
    0.3375901874933208, 0.2759693160697777, 0.1316404671361545,
    -0.005495792933327306, -0.06451564801420356, -0.04161644170893816,
    0.009454398851680437, 0.03138375667422348, 0.01148231492068473,
    -0.0170974647427123,
)

# --- Control-loop gains (hfdl.c:250-294, 468-505) ---
COSTAS_ALPHA = 0.1
COSTAS_BETA = 0.047 * COSTAS_ALPHA * COSTAS_ALPHA
COSTAS_DPHI_RESET_LIMIT = 0.25
AGC_BANDWIDTH = 0.01
EQ_LEN = 15
EQ_BANDWIDTH = 0.1
SYMSYNC_PFB_CNT = 16
SYMSYNC_LOOP_BW = 0.001
SYMSYNC_OUT_RATE = 2            # symsync output samples per symbol
RESAMPLER_ATTENUATION_DB = 60.0
NOISE_FLOOR_DECIM = 256         # noise-floor EMA stride in samples (hfdl.c:700)


@dataclasses.dataclass(frozen=True)
class ModeParams:
    """Per-mode frame parameters (hfdl.c:74-138)."""
    index: int
    arity: int                  # bits per symbol (1=BPSK, 2=QPSK, 3=8PSK)
    data_segment_cnt: int       # 72 single slot / 168 double slot
    code_rate: int              # denominator: 2 or 4
    interleaver_push_column_shift: int  # 17 single / 23 double

    @property
    def num_data_symbols(self) -> int:
        return self.data_segment_cnt * DATA_FRAME_LEN

    @property
    def num_encoded_bits(self) -> int:
        return self.num_data_symbols * self.arity

    @property
    def interleaver_column_cnt(self) -> int:
        return self.num_encoded_bits // DEINTERLEAVER_ROW_CNT

    @property
    def viterbi_input_len(self) -> int:
        # rate 1/4 sends every chip twice; pairs are averaged (hfdl.c:1020-1033)
        n = self.num_encoded_bits
        return n // 2 if self.code_rate == 4 else n

    @property
    def framebits(self) -> int:
        """Decoded user-data bits (includes 6 flush bits at the tail)."""
        return self.viterbi_input_len // 2

    @property
    def pdu_len_octets(self) -> int:
        return (self.framebits + 7) // 8

    @property
    def bit_rate(self) -> int:
        return (SYMBOL_RATE * self.arity // self.code_rate
                * DATA_FRAME_LEN // (DATA_FRAME_LEN + T_LEN))

    @property
    def slot(self) -> str:
        return 'S' if self.data_segment_cnt == DATA_FRAME_CNT_SINGLE_SLOT else 'D'

    @property
    def frame_len_symbols(self) -> int:
        return (PREKEY_LEN + PREAMBLE_LEN
                + self.data_segment_cnt * (DATA_FRAME_LEN + T_LEN))


MODES = tuple(
    ModeParams(i, arity, segs, rate, shift)
    for i, (arity, segs, rate, shift) in enumerate([
        (M_BPSK, DATA_FRAME_CNT_SINGLE_SLOT, 4, 17),   # 300 bps S
        (M_BPSK, DATA_FRAME_CNT_SINGLE_SLOT, 2, 17),   # 600 bps S
        (M_PSK4, DATA_FRAME_CNT_SINGLE_SLOT, 2, 17),   # 1200 bps S
        (M_PSK8, DATA_FRAME_CNT_SINGLE_SLOT, 2, 17),   # 1800 bps S
        (M_BPSK, DATA_FRAME_CNT_DOUBLE_SLOT, 4, 23),   # 300 bps D
        (M_BPSK, DATA_FRAME_CNT_DOUBLE_SLOT, 2, 23),   # 600 bps D
        (M_PSK4, DATA_FRAME_CNT_DOUBLE_SLOT, 2, 23),   # 1200 bps D
        (M_PSK8, DATA_FRAME_CNT_DOUBLE_SLOT, 2, 23),   # 1800 bps D
    ])
)
