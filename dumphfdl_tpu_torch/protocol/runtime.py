# Copy of dumphfdl_tpu/protocol/runtime.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Shared protocol-stack runtime context (enrichment state + metrics).

Bundles what the reference keeps as globals guarded by mutexes
(reference src/globals.h:39-58): the system table, the AC cache,
the basestation DB handle, statsd, and output options.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .enrichment import AcCache, AcData, SysTable


class _NullStatsd:
    def increment_per_channel(self, freq: int, metric: str) -> None:
        pass

    def increment_per_msgdir(self, msgdir: str, metric: str) -> None:
        pass

    def set_per_channel(self, freq: int, metric: str, value: int) -> None:
        pass


@dataclasses.dataclass
class ProtocolOptions:
    """Output-affecting flags (subset of struct dumphfdl_config)."""
    output_raw_frames: bool = False
    output_mpdus: bool = False
    output_corrupted_pdus: bool = False
    utc: bool = False
    milliseconds: bool = False
    freq_as_squawk: bool = False
    ac_data_details: str = 'normal'     # 'normal' | 'verbose'
    prettify_json: bool = False
    prettify_xml: bool = False          # main.c:305,538 (libacars config)
    station_id: str | None = None


@dataclasses.dataclass
class ProtocolContext:
    systable: SysTable = dataclasses.field(default_factory=SysTable)
    ac_cache: AcCache = dataclasses.field(default_factory=AcCache)
    ac_data: AcData | None = None
    statsd: Any = dataclasses.field(default_factory=_NullStatsd)
    options: ProtocolOptions = dataclasses.field(default_factory=ProtocolOptions)
    reasm: Any = None   # ACARS reassembly context (protocol/acars.py)

    def __post_init__(self):
        if self.reasm is None:
            from .acars import ReasmCtx
            self.reasm = ReasmCtx()

    # -- formatting helpers shared by parsers (util.c:288-398) --

    def gs_text(self, gs_id: int) -> str:
        name = self.systable.station_name(gs_id)
        return name if name is not None else str(gs_id)

    def gs_json(self, gs_id: int) -> dict:
        obj = {'type': 'Ground station', 'id': gs_id}
        name = self.systable.station_name(gs_id)
        if name is not None:
            obj['name'] = name
        return obj

    def ac_text(self, freq: int, ac_id: int) -> tuple[str, int | None]:
        icao = self.ac_cache.lookup(freq, ac_id)
        if icao is not None:
            return f'{ac_id} ({icao:06X})', icao
        return str(ac_id), None

    def ac_json(self, freq: int, ac_id: int) -> dict:
        obj = {'type': 'Aircraft', 'id': ac_id}
        icao = self.ac_cache.lookup(freq, ac_id)
        if icao is not None:
            obj['ac_info'] = self.ac_info_json(icao)
        return obj

    def ac_info_text(self, icao: int) -> str | None:
        if self.ac_data is None:
            return None
        ac = self.ac_data.lookup(icao)
        g = lambda v: v if v else '-'
        if self.options.ac_data_details == 'verbose':
            return (f'AC info: {g(ac and ac.registration)}, '
                    f'{g(ac and ac.manufacturer)}, {g(ac and ac.type)}, '
                    f'{g(ac and ac.registeredowners)}')
        return (f'AC info: {g(ac and ac.registration)}, '
                f'{g(ac and ac.icaotypecode)}, '
                f'{g(ac and ac.operatorflagcode)}')

    def ac_info_json(self, icao: int) -> dict:
        obj = {'icao': f'{icao:06X}'}
        if self.ac_data is not None:
            ac = self.ac_data.lookup(icao)
            if ac is not None:
                if ac.registration:
                    obj['regnr'] = ac.registration
                if ac.icaotypecode:
                    obj['typecode'] = ac.icaotypecode
                if ac.operatorflagcode:
                    obj['opercode'] = ac.operatorflagcode
                if self.options.ac_data_details == 'verbose':
                    if ac.manufacturer:
                        obj['manuf'] = ac.manufacturer
                    if ac.type:
                        obj['model'] = ac.type
                    if ac.registeredowners:
                        obj['owner'] = ac.registeredowners
        return obj

    def freq_list_text(self, gs_id: int, freqs_bitmap: int) -> str:
        parts = []
        for i in range(20):     # GS_MAX_FREQ_CNT
            if (freqs_bitmap >> i) & 1:
                f = self.systable.station_frequency(gs_id, i)
                parts.append(f'{f:.1f}' if f is not None else str(i))
        return ', '.join(parts)

    def freq_list_json(self, gs_id: int, freqs_bitmap: int) -> list[dict]:
        out = []
        for i in range(20):
            if (freqs_bitmap >> i) & 1:
                obj = {'id': i}
                f = self.systable.station_frequency(gs_id, i)
                if f is not None:
                    obj['freq'] = f
                out.append(obj)
        return out
