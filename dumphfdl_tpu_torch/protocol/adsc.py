# Copy of dumphfdl_tpu/protocol/adsc.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""ADS-C (Automatic Dependent Surveillance - Contract) decoder.

Decodes the ARINC 745 ADS message carried in ARINC-622 'ADS' IMI payloads
(downlink).  The reference delegates this to libacars
(reference src/acars.c:86-173); position extraction there consumes
basic-report-bearing tags {7,9,10,18,19,20}, airframe-ID tag 17 (24-bit
ICAO, acars.c:130-131) and flight-ID tag 12.  Beyond those, the v1 group
set decoded here (predicted route, earth/air reference, meteo,
intermediate & fixed projected intent, acknowledgements, noncompliance)
matches the surface libacars renders for the reference's output.

Field packing follows ARINC 745-2 (all fields MSB-first):

  coordinate     21 bits two's complement, LSB 180/2^20 deg
  altitude       16 bits two's complement, LSB 4 ft
  timestamp      15 bits, LSB 0.125 s (seconds past the hour)
  angle          12 bits two's complement binary angle, LSB 360/2^12 deg
  ground speed   13 bits, LSB 0.5 kt
  mach           13 bits, LSB 0.0005
  vertical rate  12 bits two's complement, LSB 16 ft/min
  wind speed      9 bits, LSB 0.5 kt
  temperature    12 bits two's complement, LSB 0.25 deg C
  ETA            14 bits, LSB 1 s
  distance       16 bits, LSB 0.125 nm

Every group has a round-trip encoder (encode_*) used by the test suite;
no off-air capture is available in this environment, so scale factors are
spec-derived and pinned by round-trip tests.  Tags after the first
unknown tag are surfaced as raw hex rather than mis-parsed (libacars
likewise abandons the walk on an unrecognized tag).
"""

from __future__ import annotations

from .tree import ProtoNode, iprintf

TAG_NAMES = {
    3: 'Acknowledgement',
    4: 'Negative acknowledgement',
    5: 'Noncompliance notification',
    6: 'Cancel emergency mode',
    7: 'Basic report',
    9: 'Emergency basic report',
    10: 'Lateral deviation change event',
    12: 'Flight ID',
    13: 'Predicted route group',
    14: 'Earth reference group',
    15: 'Air reference group',
    16: 'Meteo group',
    17: 'Airframe ID',
    18: 'Vertical rate change event',
    19: 'Altitude range change event',
    20: 'Waypoint change event',
    22: 'Intermediate projected intent group',
    23: 'Fixed projected intent group',
}

BASIC_REPORT_TAGS = (7, 9, 10, 18, 19, 20)

# fixed payload octets per tag (tag 5 is variable, handled in the walk)
_TAG_LEN = {3: 1, 4: 2, 6: 0, 7: 10, 9: 10, 10: 12, 12: 6, 13: 17,
            14: 5, 15: 5, 16: 4, 17: 3, 18: 12, 19: 14, 20: 10,
            22: 8, 23: 9}


# ---- bit-level helpers --------------------------------------------------

class _Bits:
    """MSB-first bit reader."""

    def __init__(self, data: bytes):
        self.v = int.from_bytes(data, 'big')
        self.left = 8 * len(data)

    def u(self, n: int) -> int:
        self.left -= n
        return (self.v >> self.left) & ((1 << n) - 1)

    def s(self, n: int) -> int:
        x = self.u(n)
        return x - (1 << n) if x & (1 << (n - 1)) else x


class _BitW:
    """MSB-first bit writer (round-trip encoders for tests)."""

    def __init__(self):
        self.v = 0
        self.n = 0

    def u(self, x: int, n: int) -> '_BitW':
        self.v = (self.v << n) | (int(x) & ((1 << n) - 1))
        self.n += n
        return self

    def bytes(self) -> bytes:
        pad = (-self.n) % 8
        return ((self.v << pad)).to_bytes((self.n + pad) // 8, 'big')


def _coord(c: int) -> float:
    """21-bit two's-complement binary angle, LSB = 180/2^20 degrees."""
    c &= 0x1FFFFF
    if c & 0x100000:
        c -= 1 << 21
    return c * 180.0 / (1 << 20)


def _coord_enc(deg: float) -> int:
    return int(round(deg / 180.0 * (1 << 20))) & 0x1FFFFF


def _angle12(x: int) -> float:
    """12-bit binary angle -> degrees in [0, 360)."""
    return (x * 360.0 / 4096.0) % 360.0


def _decode_flight_id(b: bytes) -> str:
    """Flight ID (tag 12): 8 characters of 6 bits across 6 octets,
    MSB-first; each 6-bit value is ASCII - 0x20 (space..'_', covering
    digits and uppercase).  The reference reads the decoded string from
    libacars' la_adsc_flight_id_t (acars.c:130-139) and feeds it to
    position info; trailing spaces are padding."""
    fid = int.from_bytes(b[:6], 'big')
    chars = [chr(((fid >> (42 - 6 * i)) & 0x3F) + 0x20) for i in range(8)]
    return ''.join(chars).rstrip()


# ---- group parsers ------------------------------------------------------

def parse_basic_report(b: bytes) -> dict:
    r = _Bits(b[:10])
    lat, lon = _coord(r.u(21)), _coord(r.u(21))
    alt = r.s(16) * 4
    ts = r.u(15) * 0.125
    return {
        'lat': lat,
        'lon': lon,
        'alt_ft': alt,
        'timestamp_s': ts,     # seconds past the hour
    }


def encode_basic_report(lat, lon, alt_ft, ts_s) -> bytes:
    w = _BitW()
    w.u(_coord_enc(lat), 21).u(_coord_enc(lon), 21)
    w.u(alt_ft // 4, 16).u(int(round(ts_s / 0.125)), 15).u(0, 7)
    return w.bytes()


def parse_predicted_route(b: bytes) -> dict:
    r = _Bits(b[:17])
    return {
        'next_lat': _coord(r.u(21)), 'next_lon': _coord(r.u(21)),
        'next_alt_ft': r.s(16) * 4, 'next_eta_s': r.u(14),
        'next_next_lat': _coord(r.u(21)), 'next_next_lon': _coord(r.u(21)),
        'next_next_alt_ft': r.s(16) * 4,
    }


def encode_predicted_route(nlat, nlon, nalt, eta, nnlat, nnlon, nnalt) -> bytes:
    w = _BitW()
    w.u(_coord_enc(nlat), 21).u(_coord_enc(nlon), 21).u(nalt // 4, 16)
    w.u(eta, 14)
    w.u(_coord_enc(nnlat), 21).u(_coord_enc(nnlon), 21).u(nnalt // 4, 16)
    w.u(0, 6)
    return w.bytes()


def parse_earth_ref(b: bytes) -> dict:
    r = _Bits(b[:5])
    return {'true_track_deg': _angle12(r.u(12)),
            'ground_speed_kt': r.u(13) * 0.5,
            'vertical_rate_fpm': r.s(12) * 16}


def encode_earth_ref(track, gs_kt, vr_fpm) -> bytes:
    w = _BitW()
    w.u(int(round(track / 360.0 * 4096)), 12)
    w.u(int(round(gs_kt / 0.5)), 13).u(vr_fpm // 16, 12).u(0, 3)
    return w.bytes()


def parse_air_ref(b: bytes) -> dict:
    r = _Bits(b[:5])
    return {'true_heading_deg': _angle12(r.u(12)),
            'mach': r.u(13) * 0.0005,
            'vertical_rate_fpm': r.s(12) * 16}


def encode_air_ref(heading, mach, vr_fpm) -> bytes:
    w = _BitW()
    w.u(int(round(heading / 360.0 * 4096)), 12)
    w.u(int(round(mach / 0.0005)), 13).u(vr_fpm // 16, 12).u(0, 3)
    return w.bytes()


def parse_meteo(b: bytes) -> dict:
    r = _Bits(b[:4])
    return {'wind_speed_kt': r.u(9) * 0.5,
            'wind_dir_deg': (r.u(9) * 360.0 / 512.0) % 360.0,
            'temperature_c': r.s(12) * 0.25}


def encode_meteo(wind_kt, wind_dir, temp_c) -> bytes:
    w = _BitW()
    w.u(int(round(wind_kt / 0.5)), 9)
    w.u(int(round(wind_dir / 360.0 * 512)), 9)
    w.u(int(round(temp_c / 0.25)), 12).u(0, 2)
    return w.bytes()


def parse_intermediate_intent(b: bytes) -> dict:
    r = _Bits(b[:8])
    return {'distance_nm': r.u(16) * 0.125,
            'true_track_deg': _angle12(r.u(12)),
            'alt_ft': r.s(16) * 4,
            'eta_s': r.u(14)}


def encode_intermediate_intent(dist_nm, track, alt_ft, eta) -> bytes:
    w = _BitW()
    w.u(int(round(dist_nm / 0.125)), 16)
    w.u(int(round(track / 360.0 * 4096)), 12)
    w.u(alt_ft // 4, 16).u(eta, 14).u(0, 6)
    return w.bytes()


def parse_fixed_intent(b: bytes) -> dict:
    r = _Bits(b[:9])
    return {'lat': _coord(r.u(21)), 'lon': _coord(r.u(21)),
            'alt_ft': r.s(16) * 4, 'eta_s': r.u(14)}


def encode_fixed_intent(lat, lon, alt_ft, eta) -> bytes:
    w = _BitW()
    w.u(_coord_enc(lat), 21).u(_coord_enc(lon), 21)
    w.u(alt_ft // 4, 16).u(eta, 14)
    return w.bytes()


def _parse_event_extra(tag: int, b: bytes) -> dict:
    """Event-group octets following the embedded basic report."""
    if tag == 10:       # lateral deviation change: offset, LSB 0.0625 nm
        v = int.from_bytes(b[:2], 'big')
        v -= 1 << 16 if v & 0x8000 else 0
        return {'lateral_deviation_nm': v * 0.0625}
    if tag == 18:       # vertical rate change: rate in top 12 bits
        r = _Bits(b[:2])
        return {'vertical_rate_fpm': r.s(12) * 16}
    if tag == 19:       # altitude range: ceiling + floor
        r = _Bits(b[:4])
        return {'ceiling_alt_ft': r.s(16) * 4, 'floor_alt_ft': r.s(16) * 4}
    return {}


NACK_REASONS = {
    0: 'reason not specified',
    1: 'duplicate tag in request',
    2: 'noncompliance with contract request',
    3: 'undefined reason',
}


def parse(payload: bytes) -> ProtoNode | None:
    """Parse a downlink ADS message (tag walk); returns an 'adsc' node."""
    tags = []
    pos = 0
    err = False
    while pos < len(payload):
        tag = payload[pos]
        pos += 1
        if tag == 5:
            # noncompliance notification: contract request number, group
            # count, then (noncompliant tag, availability octet) pairs
            if pos + 2 > len(payload):
                tags.append({'tag': tag, 'name': TAG_NAMES[5],
                             'raw': payload[pos:].hex()})
                break
            req, cnt = payload[pos], payload[pos + 1]
            pos += 2
            groups = []
            for _ in range(min(cnt, (len(payload) - pos) // 2)):
                groups.append({'noncompliant_tag': payload[pos],
                               'availability': payload[pos + 1]})
                pos += 2
            tags.append({'tag': tag, 'name': TAG_NAMES[5],
                         'contract_req_num': req, 'group_cnt': cnt,
                         'groups': groups})
            continue
        tlen = _TAG_LEN.get(tag)
        if tlen is None or pos + tlen > len(payload):
            if len(payload) - pos + 1 > 2:   # unknown tail beyond CRC
                tags.append({'tag': tag, 'name': 'unknown',
                             'raw': payload[pos:].hex()})
            pos = len(payload)
            break
        body = payload[pos:pos + tlen]
        pos += tlen
        entry = {'tag': tag, 'name': TAG_NAMES.get(tag, 'unknown')}
        if tag in BASIC_REPORT_TAGS:
            entry.update(parse_basic_report(body))
            entry.update(_parse_event_extra(tag, body[10:]))
        elif tag == 3:
            entry['contract_req_num'] = body[0]
        elif tag == 4:
            entry['contract_req_num'] = body[0]
            entry['reason'] = body[1]
            entry['reason_text'] = NACK_REASONS.get(body[1],
                                                    f'reason {body[1]}')
        elif tag == 12:
            entry['flight_id'] = _decode_flight_id(body)
        elif tag == 13:
            entry.update(parse_predicted_route(body))
        elif tag == 14:
            entry.update(parse_earth_ref(body))
        elif tag == 15:
            entry.update(parse_air_ref(body))
        elif tag == 16:
            entry.update(parse_meteo(body))
        elif tag == 17:
            entry['icao'] = body[0] << 16 | body[1] << 8 | body[2]
        elif tag == 22:
            entry.update(parse_intermediate_intent(body))
        elif tag == 23:
            entry.update(parse_fixed_intent(body))
        elif body:
            entry['raw'] = body.hex()
        tags.append(entry)
    if not tags:
        return None

    node = ProtoNode('adsc', {'err': err, 'tags': tags})
    # surface the position fields for protocol/position.py
    for t in tags:
        if t['tag'] in BASIC_REPORT_TAGS and 'lat' in t:
            node.data['lat'] = t['lat']
            node.data['lon'] = t['lon']
            node.data['minute'] = int(t['timestamp_s'] // 60) % 60
            node.data['second'] = int(t['timestamp_s']) % 60
            break
    for t in tags:
        if 'icao' in t:
            node.data['icao'] = t['icao']
            break
    for t in tags:
        if 'flight_id' in t:
            node.data['flight_id'] = t['flight_id']
            break

    def fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
        iprintf(lines, indent, 'ADS-C message:')
        indent += 1
        for t in n.data['tags']:
            iprintf(lines, indent, f"{t['name']}:")
            _fmt_tag(t, lines, indent + 1)

    def js(n: ProtoNode) -> dict:
        return {'err': n.data['err'], 'tags': n.data['tags']}

    node.text_formatter = fmt
    node.json_formatter = js
    return node


def _fmt_pos(lines, indent, lat, lon, alt=None):
    iprintf(lines, indent, f'Lat: {lat:.7f}')
    iprintf(lines, indent, f'Lon: {lon:.7f}')
    if alt is not None:
        iprintf(lines, indent, f'Alt: {alt} ft')


def _fmt_tag(t: dict, lines: list[str], indent: int) -> None:
    tag = t['tag']
    if 'raw' in t:      # unknown or truncated tag: raw hex only
        iprintf(lines, indent, f"Data: {t['raw']}")
    elif tag in BASIC_REPORT_TAGS:
        _fmt_pos(lines, indent, t['lat'], t['lon'], t['alt_ft'])
        ts = t['timestamp_s']
        iprintf(lines, indent, f'Time: {int(ts // 60):02d}:{ts % 60:06.3f}')
        if 'lateral_deviation_nm' in t:
            iprintf(lines, indent,
                    f"Lateral deviation: {t['lateral_deviation_nm']:.4f} nm")
        if tag == 18:
            iprintf(lines, indent,
                    f"Vertical rate: {t['vertical_rate_fpm']} ft/min")
        if 'ceiling_alt_ft' in t:
            iprintf(lines, indent, f"Ceiling: {t['ceiling_alt_ft']} ft")
            iprintf(lines, indent, f"Floor: {t['floor_alt_ft']} ft")
    elif tag == 3:
        iprintf(lines, indent,
                f"Contract request number: {t['contract_req_num']}")
    elif tag == 4:
        iprintf(lines, indent,
                f"Contract request number: {t['contract_req_num']}")
        iprintf(lines, indent, f"Reason: {t['reason_text']}")
    elif tag == 5 and 'groups' in t:
        iprintf(lines, indent,
                f"Contract request number: {t['contract_req_num']}")
        for g in t['groups']:
            iprintf(lines, indent,
                    f"Noncompliant group tag: {g['noncompliant_tag']} "
                    f"(availability: 0x{g['availability']:02x})")
    elif tag == 12:
        iprintf(lines, indent, f"Flight ID: {t['flight_id']}")
    elif tag == 13:
        iprintf(lines, indent, 'Next waypoint:')
        _fmt_pos(lines, indent + 1, t['next_lat'], t['next_lon'],
                 t['next_alt_ft'])
        iprintf(lines, indent + 1, f"ETA: {t['next_eta_s']} s")
        iprintf(lines, indent, 'Next+1 waypoint:')
        _fmt_pos(lines, indent + 1, t['next_next_lat'], t['next_next_lon'],
                 t['next_next_alt_ft'])
    elif tag == 14:
        iprintf(lines, indent, f"True track: {t['true_track_deg']:.1f} deg")
        iprintf(lines, indent,
                f"Ground speed: {t['ground_speed_kt']:.1f} kt")
        iprintf(lines, indent,
                f"Vertical rate: {t['vertical_rate_fpm']} ft/min")
    elif tag == 15:
        iprintf(lines, indent,
                f"True heading: {t['true_heading_deg']:.1f} deg")
        iprintf(lines, indent, f"Mach: {t['mach']:.4f}")
        iprintf(lines, indent,
                f"Vertical rate: {t['vertical_rate_fpm']} ft/min")
    elif tag == 16:
        iprintf(lines, indent, f"Wind speed: {t['wind_speed_kt']:.1f} kt")
        iprintf(lines, indent,
                f"Wind direction: {t['wind_dir_deg']:.1f} deg")
        iprintf(lines, indent, f"Temperature: {t['temperature_c']:.2f} C")
    elif tag == 17:
        iprintf(lines, indent, f"ICAO: {t['icao']:06X}")
    elif tag == 22:
        iprintf(lines, indent, f"Distance: {t['distance_nm']:.3f} nm")
        iprintf(lines, indent, f"True track: {t['true_track_deg']:.1f} deg")
        iprintf(lines, indent, f"Alt: {t['alt_ft']} ft")
        iprintf(lines, indent, f"ETA: {t['eta_s']} s")
    elif tag == 23:
        _fmt_pos(lines, indent, t['lat'], t['lon'], t['alt_ft'])
        iprintf(lines, indent, f"ETA: {t['eta_s']} s")
    elif 'raw' in t:
        iprintf(lines, indent, f"Data: {t['raw']}")
