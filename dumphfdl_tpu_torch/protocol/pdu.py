# Copy of dumphfdl_tpu/protocol/pdu.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""PDU decoder entry point: decoded frame octets -> protocol tree.

Equivalent of the reference's PDU decoder thread dispatch
(reference src/pdu.c:91-178): MPDU vs SPDU by the LSB of octet 0;
FCS per pdu.c:66-79.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

from .tree import ProtoNode
from . import mpdu as mpdu_mod
from . import spdu as spdu_mod
from .runtime import ProtocolContext


@dataclasses.dataclass
class PduMetadata:
    """Per-frame metadata (struct hfdl_pdu_metadata, pdu.h)."""
    freq: int                     # Hz
    freq_err_hz: float = 0.0
    rssi: float = 0.0             # dBFS
    noise_floor: float = 0.0      # dBFS
    bit_rate: int = 0
    slot: str = 'S'
    rx_timestamp: float = 0.0     # unix seconds
    station_id: str | None = None
    version: int = 1

    @property
    def snr_db(self) -> float:
        return self.rssi - self.noise_floor

    def rx_datetime(self, utc: bool = True) -> datetime.datetime:
        tz = datetime.timezone.utc if utc else None
        return datetime.datetime.fromtimestamp(self.rx_timestamp, tz=tz)


def is_mpdu(buf: bytes) -> bool:
    return bool(buf[0] & 1)         # pdu.c:102


def parse_pdu(buf: bytes, metadata: PduMetadata,
              ctx: ProtocolContext) -> list[ProtoNode]:
    """Parse one decoded frame into a list of protocol trees.

    An MPDU yields one tree per LPDU (pdu.c:124-127); an SPDU yields one.
    """
    if not buf:
        return []
    ctx.statsd.increment_per_channel(metadata.freq, 'frames.processed')
    if is_mpdu(buf):
        return mpdu_mod.parse(buf, metadata, ctx)
    return spdu_mod.parse(buf, metadata, ctx)
