# Copy of dumphfdl_tpu/protocol/enrichment.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Enrichment state: system table, aircraft-ID cache, basestation DB.

Host-side equivalents of reference src/systable.c, ac_cache.c and
ac_data.c.  Thread safety via one lock per object (the reference uses
global mutexes, globals.h:48-58).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time as time_mod

from . import libconfig
from ..ops import bits as bitops


class SysTableError(ValueError):
    """Schema violation in a system table file (systable.c:440-557)."""

GS_MAX_FREQ_CNT = 20   # size of the freqs-in-use bitmaps (systable.h)

AC_CACHE_TTL = 3600            # --aircraft-cache-ttl default (ac_cache.h:7)
AC_CACHE_EXPIRY_INTERVAL = 309  # sweep period (ac_cache.h:8)
AC_DATA_TTL = 3600             # ac_data.c:25
AC_DATA_EXPIRY_INTERVAL = 1800  # ac_data.c:26


# ---------------------------------------------------------------------------
# System table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GroundStation:
    gs_id: int
    name: str | None = None
    lat: float = 0.0
    lon: float = 0.0
    frequencies: list[float] = dataclasses.field(default_factory=list)  # kHz
    utc_sync: bool = False
    spdu_version: int = 0
    master_frame_slots: list[int] = dataclasses.field(default_factory=list)


class SysTable:
    """Ground-station table with OTA update reassembly (systable.c).

    File format is the libconfig subset used by etc/systable.conf.
    """

    def __init__(self, path: str | None = None, save_path: str | None = None):
        self.lock = threading.RLock()
        self.version: int | None = None
        self.stations: dict[int, GroundStation] = {}
        self.save_path = save_path
        self.available = False
        # OTA reassembly state: version -> {seq: bytes}, expected count
        self._pdu_set_version: int | None = None
        self._pdu_fragments: dict[int, bytes] = {}
        self._pdu_total: int = 0
        if path:
            self.load(path)

    # -- file I/O (libconfig subset) --

    def load(self, path: str) -> bool:
        try:
            with open(path, 'r', encoding='utf-8') as f:
                text = f.read()
        except OSError:
            return False
        try:
            ok = self._parse_config(text)
        except (libconfig.LibconfigError, SysTableError) as e:
            print(f'systable: cannot load {path}: {e}', file=sys.stderr)
            return False
        self.available = ok
        return ok

    def _parse_config(self, text: str) -> bool:
        """Parse + schema-validate a system table file.

        Real libconfig grammar (nested groups, comments, string escapes)
        via protocol/libconfig.py; the schema checks mirror
        reference src/systable.c:440-557 and reject loudly
        (SysTableError) instead of silently mis-parsing.
        """
        cfg = libconfig.loads(text)
        version = cfg.get('version')
        if not isinstance(version, int):
            raise SysTableError('missing or non-integer "version"')
        st_list = cfg.get('stations')
        if not isinstance(st_list, list):
            raise SysTableError('missing "stations" list')
        stations: dict[int, GroundStation] = {}
        for entry in st_list:
            if not isinstance(entry, dict):
                raise SysTableError('station entry is not a group')
            gs_id = entry.get('id')
            if not isinstance(gs_id, int):
                raise SysTableError('station without integer "id"')
            if gs_id in stations:
                # duplicate id -> invalid (systable.c:514)
                raise SysTableError(f'duplicate station id {gs_id}')
            gs = GroundStation(gs_id=gs_id)
            name = entry.get('name')
            if name is not None:
                if not isinstance(name, str):
                    raise SysTableError(f'station {gs_id}: "name" not a string')
                gs.name = name
            lat, lon = entry.get('lat'), entry.get('lon')
            if lat is not None or lon is not None:
                if not isinstance(lat, (int, float)) or \
                        not isinstance(lon, (int, float)):
                    raise SysTableError(f'station {gs_id}: bad lat/lon')
                gs.lat, gs.lon = float(lat), float(lon)
            freqs = entry.get('frequencies')
            if freqs is not None:
                if not isinstance(freqs, list) or \
                        not all(isinstance(f, (int, float)) for f in freqs):
                    raise SysTableError(f'station {gs_id}: bad frequencies')
                gs.frequencies = [float(f) for f in freqs]
            # extension fields (not written by the reference's save, but
            # emitted by ours so OTA tables round-trip fully)
            utc = entry.get('utc_sync')
            if utc is not None:
                if not isinstance(utc, bool):
                    raise SysTableError(f'station {gs_id}: bad utc_sync')
                gs.utc_sync = utc
            slots = entry.get('master_frame_slots')
            if slots is not None:
                if not isinstance(slots, list) or \
                        not all(isinstance(s, int) for s in slots):
                    raise SysTableError(f'station {gs_id}: bad master_frame_slots')
                gs.master_frame_slots = list(slots)
            stations[gs_id] = gs
        self.version = version
        self.stations = stations
        return True

    def save(self, path: str | None = None) -> bool:
        """Write the table back as libconfig (systable.c:818-878).

        The reference persists id/lat/lon/frequencies/name only; we
        additionally persist utc_sync and master_frame_slots so an
        OTA-updated table survives a restart without information loss
        (both fields are accepted-but-ignored extras for the reference's
        own parser).
        """
        path = path or self.save_path
        if not path:
            return False
        st_list = []
        for gs in self.stations.values():
            entry: dict = {'id': gs.gs_id,
                           'lat': round(gs.lat, 6),
                           'lon': round(gs.lon, 6),
                           'frequencies': [float(f) for f in gs.frequencies]}
            if gs.name is not None:
                entry['name'] = gs.name
            if gs.utc_sync:
                entry['utc_sync'] = True
            if gs.master_frame_slots:
                entry['master_frame_slots'] = list(gs.master_frame_slots)
            st_list.append(entry)
        text = libconfig.dumps({'version': self.version, 'stations': st_list})
        try:
            with open(path, 'w', encoding='utf-8') as f:
                f.write(text)
            return True
        except OSError:
            return False

    # -- lookups (systable.c:234-259) --

    def station_name(self, gs_id: int) -> str | None:
        with self.lock:
            gs = self.stations.get(gs_id)
            return gs.name if gs else None

    def station_frequency(self, gs_id: int, freq_id: int) -> float | None:
        """Frequency in kHz for bitmap position freq_id (0 = highest)."""
        with self.lock:
            gs = self.stations.get(gs_id)
            if gs is None or freq_id < 0 or freq_id >= len(gs.frequencies):
                return None
            return gs.frequencies[freq_id]

    # -- OTA update (systable.c:281-392, 633-697) --

    def store_pdu(self, version: int, seq_num: int, total_cnt: int,
                  payload: bytes) -> None:
        with self.lock:
            if self._pdu_set_version != version:
                self._pdu_set_version = version
                self._pdu_fragments = {}
            self._pdu_total = total_cnt
            self._pdu_fragments[seq_num] = bytes(payload)

    def process_pdu_set(self) -> dict | None:
        """If the fragment set is complete, decode + swap in the new table.

        Returns a summary dict for the proto tree (or None)."""
        with self.lock:
            v = self._pdu_set_version
            if v is None or len(self._pdu_fragments) < self._pdu_total:
                return None
            if self.version is not None and not self._version_is_newer(v):
                return None
            blob = b''.join(self._pdu_fragments[i]
                            for i in sorted(self._pdu_fragments))
            decoded = self._decode_binary_table(v, blob)
            if decoded is None:
                return {'systable_decoding_error': True}
            # copy names from the old table when the station moved < 1 degree
            for gs in decoded.values():
                old = self.stations.get(gs.gs_id)
                if old and old.name and abs(old.lat - gs.lat) <= 1.0 \
                        and abs(old.lon - gs.lon) <= 1.0:
                    gs.name = old.name
            self.stations = decoded
            self.version = v
            self.available = True
            self._pdu_set_version = None
            self._pdu_fragments = {}
            if self.save_path:
                self.save()
            return {
                'version': v,
                'stations': [
                    {'id': gs.gs_id, 'name': gs.name,
                     'lat': gs.lat, 'lon': gs.lon,
                     'frequencies_khz': gs.frequencies}
                    for gs in decoded.values()
                ],
            }

    def _version_is_newer(self, v: int) -> bool:
        """Wraparound-aware version comparison (systable.c:794-808)."""
        if self.version is None:
            return True
        diff = (v - self.version) % 4096
        return 0 < diff < 2048

    @staticmethod
    def decode_frequency_hz(f: bytes) -> int:
        """BCD-nibble frequency field, value in Hz (systable.c:688-697)."""
        return (100 * (f[0] & 0xF) + 1_000 * (f[0] >> 4)
                + 10_000 * (f[1] & 0xF) + 100_000 * (f[1] >> 4)
                + 1_000_000 * (f[2] & 0xF) + 10_000_000 * (f[2] >> 4))

    @staticmethod
    def _decode_binary_table(version: int, blob: bytes) -> dict[int, GroundStation] | None:
        """Decode reassembled OTA ground-station records (systable.c:633-686).

        Per station: [id|utc_sync] [5 octets packed 20+20-bit lat/lon]
        [spdu_version(3b) | freq_cnt(5b)] then freq_cnt x (3-octet BCD
        frequency in Hz + 1-octet master frame slot)."""
        from .hfnpdu import parse_coordinate
        stations: dict[int, GroundStation] = {}
        pos = 0
        min_len = 8   # SYSTABLE_GS_DATA_MIN_LEN (systable.c:409)
        while len(blob) - pos >= min_len:
            b = blob[pos:]
            gs_id = b[0] & 0x7F
            utc_sync = bool(b[0] & 0x80)
            lat_raw = b[1] | b[2] << 8 | (b[3] & 0xF) << 16
            lon_raw = b[3] >> 4 | b[4] << 4 | b[5] << 12
            spdu_version = b[6] & 7
            freq_cnt = (b[6] >> 3) & 0x1F
            if freq_cnt > GS_MAX_FREQ_CNT:
                return None
            consumed = min_len - 1
            freqs, slots = [], []
            for f in range(freq_cnt):
                fpos = min_len - 1 + f * 4
                if fpos + 4 > len(b):
                    return None
                freqs.append(SysTable.decode_frequency_hz(b[fpos:fpos + 3]) / 1000.0)
                slots.append(b[fpos + 3] & 0xF)
                consumed += 4
            stations[gs_id] = GroundStation(
                gs_id=gs_id, lat=parse_coordinate(lat_raw),
                lon=parse_coordinate(lon_raw), frequencies=freqs,
                utc_sync=utc_sync, spdu_version=spdu_version,
                master_frame_slots=slots)
            pos += consumed
        return stations if stations else None


# ---------------------------------------------------------------------------
# Aircraft-ID cache (ac_cache.c): (freq, AC ID) <-> ICAO with TTL
# ---------------------------------------------------------------------------

class AcCache:
    def __init__(self, ttl: float = AC_CACHE_TTL):
        self.lock = threading.RLock()
        self.ttl = ttl
        self._fwd: dict[tuple[int, int], tuple[int, float]] = {}
        self._inv: dict[tuple[int, int], tuple[int, float]] = {}

    def _now(self) -> float:
        return time_mod.monotonic()

    def create(self, freq: int, ac_id: int, icao: int) -> None:
        """Logon confirm: map (freq, ac_id) -> icao, dropping stale
        conflicting entries in both maps (ac_cache.c:67-107)."""
        with self.lock:
            now = self._now()
            old = self._fwd.pop((freq, ac_id), None)
            if old is not None:
                self._inv.pop((freq, old[0]), None)
            oldinv = self._inv.pop((freq, icao), None)
            if oldinv is not None:
                self._fwd.pop((freq, oldinv[0]), None)
            self._fwd[(freq, ac_id)] = (icao, now)
            self._inv[(freq, icao)] = (ac_id, now)

    def delete(self, freq: int, icao: int) -> None:
        """Logoff / logon denied (ac_cache.c, lpdu.c:163-166)."""
        with self.lock:
            entry = self._inv.pop((freq, icao), None)
            if entry is not None:
                self._fwd.pop((freq, entry[0]), None)

    def lookup(self, freq: int, ac_id: int) -> int | None:
        with self.lock:
            entry = self._fwd.get((freq, ac_id))
            if entry is None:
                return None
            icao, created = entry
            if self._now() - created > self.ttl:
                self._fwd.pop((freq, ac_id), None)
                self._inv.pop((freq, icao), None)
                return None
            return icao

    def expire(self) -> int:
        """Periodic sweep; returns number of surviving entries."""
        with self.lock:
            now = self._now()
            dead = [k for k, (_, t) in self._fwd.items() if now - t > self.ttl]
            for k in dead:
                icao, _ = self._fwd.pop(k)
                self._inv.pop((k[0], icao), None)
            return len(self._fwd)

    def __len__(self):
        with self.lock:
            return len(self._fwd)


# ---------------------------------------------------------------------------
# Basestation aircraft DB (ac_data.c): read-only SQLite lookups + TTL cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AcDataEntry:
    registration: str | None = None
    icaotypecode: str | None = None
    operatorflagcode: str | None = None
    manufacturer: str | None = None
    type: str | None = None
    registeredowners: str | None = None


class AcData:
    COLUMNS = ('Registration', 'ICAOTypeCode', 'OperatorFlagCode',
               'Manufacturer', 'Type', 'RegisteredOwners')

    def __init__(self, db_path: str, ttl: float = AC_DATA_TTL):
        import sqlite3
        self.lock = threading.RLock()
        self.ttl = ttl
        self._cache: dict[int, tuple[AcDataEntry | None, float]] = {}
        self._conn = sqlite3.connect(f'file:{db_path}?mode=ro', uri=True,
                                     check_same_thread=False)
        # probe the schema up front like ac_data.c:227-247
        cols = ', '.join(self.COLUMNS)
        self._query = (f'SELECT {cols} FROM Aircraft WHERE "ModeS" = ?')
        self._conn.execute(self._query, ('000000',)).fetchone()

    def lookup(self, icao: int) -> AcDataEntry | None:
        with self.lock:
            now = time_mod.monotonic()
            hit = self._cache.get(icao)
            if hit is not None and now - hit[1] <= self.ttl:
                return hit[0]
            row = self._conn.execute(
                self._query, (f'{icao:06X}',)).fetchone()
            entry = None
            if row is not None:
                entry = AcDataEntry(*[v if v else None for v in row])
            self._cache[icao] = (entry, now)   # negative results cached too
            return entry

    def close(self):
        self._conn.close()


def parse_icao_hex(buf: bytes) -> int:
    """3 bit-reversed octets -> 24-bit ICAO address (util.c:236-242)."""
    rev = bitops.reverse_bytes(bytearray(buf[:3]))
    return int(rev[0]) << 16 | int(rev[1]) << 8 | int(rev[2])
