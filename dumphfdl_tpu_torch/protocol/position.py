# Copy of dumphfdl_tpu/protocol/position.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Aircraft position extraction pipeline.

Reference: reference src/position.c, lpdu.c:314-371,
hfnpdu.c:599-654.  Walks a parsed tree for downlink position sources
(Performance data, Frequency data, ADS-C), back-fills the ICAO address
from the LPDU or the AC cache, validates, and fixes up partial
timestamps to the nearest past time.
"""

from __future__ import annotations

import calendar
import dataclasses
import time as time_mod

from .tree import ProtoNode
from . import lpdu as lpdu_mod
from . import hfnpdu as hfnpdu_mod


@dataclasses.dataclass
class PositionInfo:
    lat: float
    lon: float
    icao: int | None = None
    flight_id: str | None = None
    # timestamp parts (None == not present)
    hour: int | None = None
    minute: int | None = None
    second: int | None = None
    # resolved epoch timestamp after fixup
    t: float | None = None
    tm: time_mod.struct_tm = None


def extract(tree: ProtoNode, ctx, now: float | None = None) -> PositionInfo | None:
    """position_info_extract equivalent."""
    pos = _extract_from_lpdu(tree, ctx)
    if pos is None:
        return None
    if not (abs(pos.lat) <= 90.0 and abs(pos.lon) <= 180.0):
        return None
    _fixup_timestamp(pos, now)
    return pos


def _extract_from_lpdu(tree: ProtoNode, ctx) -> PositionInfo | None:
    lpdu_node = tree.find('lpdu')
    if lpdu_node is None:
        return None
    hdr = lpdu_node.data.get('mpdu_header', {})
    if hdr.get('direction') != 'downlink':       # lpdu.c:323
        return None
    pos = _extract_from_hfnpdu(tree)
    if pos is None:
        return None
    if pos.icao is None:
        t = lpdu_node.data.get('type')
        if t in lpdu_mod.LOGON_REQUEST_TYPES:
            pos.icao = lpdu_node.data.get('icao')
        else:
            ac_id = hdr['dst_id'] if hdr['direction'] == 'uplink' \
                else hdr['src_id']
            pos.icao = ctx.ac_cache.lookup(hdr['freq'], ac_id)
    if pos.icao is None:
        return None        # incomplete without ICAO (lpdu.c:366-370)
    return pos


def _extract_from_hfnpdu(tree: ProtoNode) -> PositionInfo | None:
    node = tree.find('hfnpdu')
    if node is None:
        return None
    d = node.data
    t = d.get('type')
    if t in (hfnpdu_mod.PERFORMANCE_DATA, hfnpdu_mod.FREQUENCY_DATA):
        tm = d['utc_time']
        return PositionInfo(
            lat=d['lat'], lon=d['lon'],
            flight_id=d['flight_id'] or None,
            hour=tm['hour'], minute=tm['min'], second=tm['sec'])
    if t == hfnpdu_mod.ENVELOPED_DATA:
        return _extract_from_adsc(tree)
    return None


def _extract_from_adsc(tree: ProtoNode) -> PositionInfo | None:
    """ADS-C basic-report positions (acars.c:86-173).

    Activates once the arinc622/adsc deep decode lands (SURVEY.md §7
    step 5 phase-in); the recognition layer exists in protocol/acars.py.
    """
    node = tree.find('adsc')
    if node is None:
        return None
    d = node.data
    if 'lat' not in d:
        return None
    return PositionInfo(lat=d['lat'], lon=d['lon'], icao=d.get('icao'),
                        flight_id=d.get('flight_id'),
                        minute=d.get('minute'), second=d.get('second'))


def _fixup_timestamp(pos: PositionInfo, now: float | None = None) -> None:
    """position.c:65-118: fill missing fields with nearest past time."""
    now = time_mod.time() if now is None else now
    tm_now = time_mod.gmtime(now)
    sec = pos.second if pos.second is not None else 0
    minute = pos.minute if pos.minute is not None else 0
    hour = pos.hour
    if hour is None:
        if (minute, sec) <= (tm_now.tm_min, tm_now.tm_sec):
            hour = tm_now.tm_hour
        else:
            hour = tm_now.tm_hour - 1 if tm_now.tm_hour > 0 else 23
    t = calendar.timegm((tm_now.tm_year, tm_now.tm_mon, tm_now.tm_mday,
                         hour, minute, sec, 0, 0, 0))
    if t > now:
        t -= 86400.0
    pos.hour, pos.minute, pos.second = hour, minute, sec
    pos.t = t
    pos.tm = time_mod.gmtime(t)
