# Copy of dumphfdl_tpu/ops/crc.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""CRC-16/CCITT (poly 0x1021, reflected) used for all HFDL FCS fields.

Behavior matches reference src/crc.c:4-47 (reflected table-driven
update, i.e. CRC-16/X-25 core) and the FCS convention of
reference src/pdu.c:66-79: init 0xFFFF, final XOR 0xFFFF, check
bytes stored little-endian after the protected region.
"""

from __future__ import annotations

import numpy as np

_POLY_REFLECTED = 0x8408  # 0x1021 bit-reversed


def _make_table() -> np.ndarray:
    table = np.empty(256, dtype=np.uint16)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY_REFLECTED if crc & 1 else crc >> 1
        table[i] = crc
    return table


_TABLE = _make_table()


def crc16_ccitt(data: bytes | np.ndarray, crc_init: int = 0xFFFF) -> int:
    """Raw reflected CRC update over data (no final XOR)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, dtype=np.uint8)
    crc = np.uint16(crc_init)
    for b in arr:
        crc = np.uint16(crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return int(crc)


def fcs_compute(data: bytes | np.ndarray) -> int:
    """HFDL FCS: crc16_ccitt(init 0xFFFF) ^ 0xFFFF (pdu.c:70)."""
    return crc16_ccitt(data) ^ 0xFFFF


def fcs_check(buf: bytes | np.ndarray, hdr_len: int) -> bool:
    """Check the FCS stored little-endian at buf[hdr_len:hdr_len+2]."""
    buf = bytes(buf) if not isinstance(buf, (bytes, bytearray)) else bytes(buf)
    if len(buf) < hdr_len + 2:
        return False
    expected = buf[hdr_len] | (buf[hdr_len + 1] << 8)
    return fcs_compute(buf[:hdr_len]) == expected


def pdu_hdr_len(buf: bytes) -> int | None:
    """FCS-protected header length of a decoded HFDL frame, mirroring the
    parsers' geometry (SPDU: 64, spdu.c:40; downlink MPDU: 6+lpdu_cnt,
    mpdu.c:56-59; uplink MPDU: per-aircraft walk, mpdu.c:60-75).
    Returns None when the frame is too short to hold its own header."""
    if not buf:
        return None
    b0 = buf[0]
    if not b0 & 1:                    # SPDU
        return 64 if len(buf) >= 66 else None
    if b0 & 2:                        # downlink MPDU
        h = 6 + ((b0 >> 2) & 0xF)
    else:                             # uplink MPDU
        h = 2
        for _ in range(((b0 & 0x70) >> 4) + 1):
            if len(buf) < h + 2:
                return None
            h += 2 + (buf[h + 1] >> 4)
    return h if len(buf) >= h + 2 else None


def pdu_fcs_ok(buf: bytes) -> bool:
    """Host-side header-FCS verdict for a decoded frame (the same check
    backend._device_fcs_ok performs on device)."""
    h = pdu_hdr_len(buf)
    return h is not None and fcs_check(buf, h)


def fcs_append(data: bytes) -> bytes:
    """Return data with its little-endian FCS appended (TX side)."""
    fcs = fcs_compute(data)
    return bytes(data) + bytes([fcs & 0xFF, fcs >> 8])
