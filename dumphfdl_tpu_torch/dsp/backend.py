"""Frame backend: scrambled data symbols -> PDU octets, batched on device.

Counterpart of ``dumphfdl_tpu/dsp/backend.py``: phase flips (scrambler +
BPSK ambiguity) -> soft PSK demod -> deinterleave gather -> (rate-1/4 chip
averaging) -> batched Viterbi (kernel K1 on CUDA) -> LSB-first packing,
plus the on-device header-FCS verdict and the event decode straight from
the symbol ring (reference behaviour: hfdl.c:993-1056).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from dumphfdl_tpu import sequences as seq
from dumphfdl_tpu.ops import bits as bitops
from dumphfdl_tpu.ops import crc
from dumphfdl_tpu.ops import interleave
from ..ops import fec_cuda
from ..ops import psk


@functools.cache
def _mode_tables(mode: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    p = C.MODES[mode]
    scr = seq.bipolar(seq.scrambler_for_symbols(p.num_data_symbols))
    return (torch.as_tensor(scr, device=device),
            torch.as_tensor(interleave.deinterleave_perm(mode),
                            device=device))


def _viterbi(soft: torch.Tensor, framebits: int) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    return fec_cuda.viterbi_decode(soft, framebits)


def _decode_core(data_symbols: torch.Tensor, bitmask: torch.Tensor,
                 mode: int) -> torch.Tensor:
    """(B, num_data_symbols) complex64 symbols + (B,) bitmask -> (B,
    framebits) int8 decoded bits."""
    p = C.MODES[mode]
    scr, perm = _mode_tables(mode, data_symbols.device)
    flip = torch.where(bitmask.reshape(-1).to(torch.bool), -1.0, 1.0)
    syms = data_symbols * scr[None, :] * flip[:, None]
    soft = psk.soft_demodulate(syms, p.arity)            # (B, S, arity) u8
    soft = soft.reshape(syms.shape[0], p.num_encoded_bits)[:, perm]
    if p.code_rate == 4:
        pairs = soft.reshape(soft.shape[0], -1, 2).to(torch.int32)
        a, b = pairs[..., 0], pairs[..., 1]
        soft = ((a & b) + ((a ^ b) >> 1)).to(torch.uint8)  # floor avg (hfdl.c:1032)
    return _viterbi(soft, p.framebits)


def decode_frame_batch(data_symbols: torch.Tensor, bitmask: torch.Tensor,
                       mode: int) -> torch.Tensor:
    """Decode a batch of frames of one mode -> (B, framebits) int8 bits."""
    return _decode_core(data_symbols, bitmask, mode)


MAX_FRAMEBITS = max(m.framebits for m in C.MODES)
PACK_WORDS = (MAX_FRAMEBITS + 31) // 32

# largest FCS-protected header: uplink MPDU with 8 aircraft x 15 LPDUs
# (2 + 8*(2+15) bytes, mpdu.c:60-75); SPDU = 64; downlink <= 21
_HDR_MAX_BYTES = 144


def _device_fcs_ok(bits: torch.Tensor) -> torch.Tensor:
    """Header-FCS verdict for a batch of decoded frames, on device.

    bits: (E, F) LSB-first frame bits.  Finds each frame's header length
    from its first bytes as the host parsers do (SPDU 64, downlink MPDU
    6+lpdu_cnt, uplink MPDU per-aircraft walk), runs the reflected
    CRC-16/CCITT over the header and compares with the little-endian FCS
    after it (pdu.c:66-79).  The CRC runs byte-wise through the 256-entry
    table, which is the bit-serial reflected CRC eight bits at a time."""
    e, f = bits.shape
    dev = bits.device
    nbytes = min(f // 8, _HDR_MAX_BYTES + 2)
    w8 = torch.arange(8, device=dev, dtype=torch.int64)
    byts = (bits[:, :nbytes * 8].to(torch.int64).reshape(e, nbytes, 8)
            << w8).sum(-1)                                  # (E, nbytes)
    b0 = byts[:, 0]
    is_mpdu = (b0 & 1) == 1
    downlink = (b0 & 2) == 2
    ac_cnt = ((b0 & 0x70) >> 4) + 1
    h = torch.full((e,), 2, dtype=torch.int64, device=dev)
    for it in range(8):
        active = (it < ac_cnt) & is_mpdu & ~downlink
        nb = byts.gather(1, torch.clamp(h + 1, 0, nbytes - 1)[:, None])[:, 0] >> 4
        h = torch.where(active, h + 2 + nb, h)
    hdr_len = torch.where(is_mpdu,
                          torch.where(downlink, 6 + ((b0 >> 2) & 0xF), h),
                          torch.full_like(h, 64))
    hdr_len = torch.clamp(hdr_len, 1, nbytes - 2)
    fits = hdr_len + 2 <= nbytes
    table = torch.as_tensor(crc._TABLE.astype(np.int64), device=dev)
    c = torch.full((e,), 0xFFFF, dtype=torch.int64, device=dev)
    cap = torch.zeros((e,), dtype=torch.int64, device=dev)
    for k in range(nbytes - 2):
        c = (c >> 8) ^ table[(c ^ byts[:, k]) & 0xFF]
        cap = torch.where(hdr_len == k + 1, c, cap)
    fcs = cap ^ 0xFFFF
    exp = byts.gather(1, hdr_len[:, None])[:, 0] \
        | (byts.gather(1, (hdr_len + 1)[:, None])[:, 0] << 8)
    return fits & (fcs == exp)


# data symbol d sits FIRST_DATA_OFFSET + 45*(d//30) + d%30 symbols after
# the frame start (30-symbol data halves between 15-symbol probes)
FIRST_DATA_OFFSET = C.PREKEY_LEN + C.PREAMBLE_LEN        # 979


@functools.cache
def _data_schedule(device) -> torch.Tensor:
    d = np.arange(C.DATA_SYMBOLS_MAX)
    return torch.as_tensor(45 * (d // 30) + d % 30, device=device)


def gather_event_symbols(symring: torch.Tensor, start22: torch.Tensor,
                         base22: int, ch: torch.Tensor) -> torch.Tensor:
    """(E, DATA_SYMBOLS_MAX) data symbols of events from the per-channel
    symbol ring; start22/base22 are stream rows mod 2^22."""
    ring_t = symring.shape[1]
    rel = (start22.to(torch.int64) - base22) & ((1 << 22) - 1)
    pos = torch.clamp(rel[:, None] + FIRST_DATA_OFFSET
                      + _data_schedule(symring.device)[None, :], 0, ring_t - 1)
    return symring[ch.to(torch.int64)[:, None], pos]


def first_valid_rows(valid: torch.Tensor, e_max: int) -> torch.Tensor:
    """Static-shape ``nonzero``: the first e_max flat indices where valid is
    True, in ascending order, padded with valid.numel() -- without a host
    sync (a stable sort of the negated mask)."""
    flat = valid.reshape(-1)
    n = flat.numel()
    if n < e_max:
        flat = torch.cat([flat, torch.zeros(e_max - n, dtype=torch.bool,
                                            device=flat.device)])
    order = torch.sort((~flat).to(torch.uint8), stable=True).indices[:e_max]
    return torch.where(flat[order], order, torch.full_like(order, n))


def decode_events_inline(symring: torch.Tensor, base22: int,
                         ev_table: torch.Tensor, e_max: int) -> torch.Tensor:
    """Decode up to e_max completed frames from the symbol ring and the
    (C, K_EVENTS*EV_FIELDS) event table, on the table's device.

    Returns an (e_max, 2 + PACK_WORDS) int32 matrix: column 0 is the flat
    event-table row (-1 = empty slot), column 1 the header-FCS verdict, the
    rest the decoded bits packed LSB-first into int32 words.  Every mode's
    decoder runs on the padded batch and each event takes its mode's
    result."""
    from .tracker import EV_FIELDS, K_EVENTS
    c = symring.shape[0]
    dev = symring.device
    tab = ev_table.reshape(c, K_EVENTS, EV_FIELDS)
    flat = first_valid_rows(tab[:, :, 0] > 0.5, e_max)
    ok = flat < c * K_EVENTS
    ch = torch.where(ok, flat // K_EVENTS, 0)
    sl = torch.where(ok, flat % K_EVENTS, 0)
    rows = tab[ch, sl]                                   # (E, EV_FIELDS)
    # padded slots get neutral parameters, not copies of a live event
    mode = torch.clamp(torch.where(ok, rows[:, 1].to(torch.int64), 0),
                       0, len(C.MODES) - 1)
    bmask = ok & (rows[:, 2] > 0.5)
    start22 = torch.where(ok, rows[:, 10].to(torch.int64), 0)
    syms = gather_event_symbols(symring, start22, base22, ch)
    sel = torch.zeros((e_max, MAX_FRAMEBITS), dtype=torch.int32, device=dev)
    for m, p in enumerate(C.MODES):
        bits_m = _decode_core(syms[:, :p.num_data_symbols], bmask, m)
        sel[:, :p.framebits] = torch.where(
            (mode == m)[:, None], bits_m.to(torch.int32),
            sel[:, :p.framebits])
    padded = torch.nn.functional.pad(sel, (0, PACK_WORDS * 32 - MAX_FRAMEBITS))
    w32 = torch.arange(32, device=dev, dtype=torch.int64)
    words = (padded.to(torch.int64).reshape(e_max, PACK_WORDS, 32)
             << w32).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    row = torch.where(ok, flat, -1)
    fcs = _device_fcs_ok(sel)
    return torch.cat([row[:, None], fcs[:, None].to(torch.int64), words],
                     dim=1).to(torch.int32)


def pdu_bytes_from_bits(bits: np.ndarray) -> list[bytes]:
    """(B, framebits) bits -> list of PDU byte strings (LSB-first packing)."""
    arr = np.asarray(bits, dtype=np.uint8)
    return [bytes(bitops.bits_to_bytes_lsb_first(row)) for row in arr]


def decode_frames(data_symbols: np.ndarray, bitmask: np.ndarray, mode: int,
                  device) -> list[bytes]:
    """Host convenience wrapper: symbols -> PDU octet strings."""
    syms = torch.as_tensor(np.asarray(data_symbols, np.complex64),
                           device=device)
    mask = torch.as_tensor(np.asarray(bitmask).reshape(-1).astype(bool),
                           device=device)
    bits = decode_frame_batch(syms, mask, mode)
    return pdu_bytes_from_bits(bits.cpu().numpy())
