# Copy of dumphfdl_tpu/protocol/cpdlc.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""CPDLC (FANS-1/A) decoder for ARINC-622 'AT1' payloads.

The reference delegates CPDLC decoding to libacars (the HFDL tree shows
libacars' FANS-1/A output under ACARS nodes; reference src/acars.c:28
calls la_acars_parse_and_reassemble which dispatches ARINC-622 IMIs).
This is an independent reimplementation of the subset that matters for
HFDL monitoring: the ATC message header (message id / message ref /
timestamp) and the message element identifiers with their standard
FANS-1/A phraseology, from the DO-258A ASN.1 (unaligned PER).

Wire format notes (unaligned PER, no extension markers in FANS-1/A):

  ATCDownlinkMessage ::= SEQUENCE { header, messageData }
  ATCMessageHeader   ::= SEQUENCE {
      msgIdentificationNumber INTEGER (0..63),       -- 6 bits
      msgReferenceNumber      INTEGER (0..63) OPTIONAL,
      timestamp               Timestamp OPTIONAL }   -- 5+6+6 bits
  messageData ::= SEQUENCE SIZE (1..5) OF MsgElementId  -- 3-bit count
  ATCUplinkMsgElementId   ::= CHOICE of 183 alternatives  -- 8-bit index
  ATCDownlinkMsgElementId ::= CHOICE of 81 alternatives   -- 7-bit index

Element *arguments* decode for the scalar types (altitude, speed, time,
position, frequency, degrees, beacon code, free text, ...) AND the large
compound types (route clearance, position report, predeparture
clearance, placeBearingDistance, satchannel -- see the compound section
below); the argument signature of each element is derived from the
bracketed placeholders of its phraseology string, which follow the ASN.1
SEQUENCE field order by construction of the DO-258A message set.  The
only remaining undecoded construct is RouteClearance's
routeInformationAdditional annex, which falls back to the raw-bits
rendering and stops the element walk there (element boundaries are
unknowable past an undecoded argument).  All integer ranges are the
PER-visible constraints recorded in the decoder table; every decoder is
round-trip tested against the encoders in tests/test_cpdlc.py, but none
of this is yet validated bit-for-bit against libacars on an off-air
capture (see NOTES.md).

CR1/CC1/DR1 connect-management payloads carry the same ATC message
structure (CR1/DR1 are aircraft-initiated -> ATCDownlinkMessage, CC1 is
the ground confirm -> ATCUplinkMessage), mirroring libacars' type
dispatch for these IMIs.
"""

from __future__ import annotations

import re

from .tree import ProtoNode, iprintf


class BitReader:
    """MSB-first bit reader for unaligned PER."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0          # bit position

    def remaining(self) -> int:
        return len(self.buf) * 8 - self.pos

    def read(self, nbits: int) -> int:
        if nbits > self.remaining():
            raise ValueError('out of bits')
        val = 0
        pos = self.pos
        for _ in range(nbits):
            byte = self.buf[pos >> 3]
            val = (val << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return val


class BitWriter:
    """MSB-first bit writer (test-vector encoder)."""

    def __init__(self):
        self.bits: list[int] = []

    def write(self, val: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.bits.append((val >> i) & 1)

    def tobytes(self) -> bytes:
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (7 - (i & 7))
        return bytes(out)


# --- FANS-1/A message element phraseology (DO-258A) ---
# Uplink: uM0..uM182 (183 alternatives -> 8-bit choice index).

UPLINK_MSG = {
    0: 'UNABLE', 1: 'STANDBY', 2: 'REQUEST DEFERRED', 3: 'ROGER',
    4: 'AFFIRM', 5: 'NEGATIVE',
    6: 'EXPECT [altitude]',
    7: 'EXPECT CLIMB AT [time]', 8: 'EXPECT CLIMB AT [position]',
    9: 'EXPECT DESCENT AT [time]', 10: 'EXPECT DESCENT AT [position]',
    11: 'EXPECT CRUISE CLIMB AT [time]',
    12: 'EXPECT CRUISE CLIMB AT [position]',
    13: 'AT [time] EXPECT CLIMB TO [altitude]',
    14: 'AT [position] EXPECT CLIMB TO [altitude]',
    15: 'AT [time] EXPECT DESCENT TO [altitude]',
    16: 'AT [position] EXPECT DESCENT TO [altitude]',
    17: 'AT [time] EXPECT CRUISE CLIMB TO [altitude]',
    18: 'AT [position] EXPECT CRUISE CLIMB TO [altitude]',
    19: 'MAINTAIN [altitude]',
    20: 'CLIMB TO AND MAINTAIN [altitude]',
    21: 'AT [time] CLIMB TO AND MAINTAIN [altitude]',
    22: 'AT [position] CLIMB TO AND MAINTAIN [altitude]',
    23: 'DESCEND TO AND MAINTAIN [altitude]',
    24: 'AT [time] DESCEND TO AND MAINTAIN [altitude]',
    25: 'AT [position] DESCEND TO AND MAINTAIN [altitude]',
    26: 'CLIMB TO REACH [altitude] BY [time]',
    27: 'CLIMB TO REACH [altitude] BY [position]',
    28: 'DESCEND TO REACH [altitude] BY [time]',
    29: 'DESCEND TO REACH [altitude] BY [position]',
    30: 'MAINTAIN BLOCK [altitude] TO [altitude]',
    31: 'CLIMB TO AND MAINTAIN BLOCK [altitude] TO [altitude]',
    32: 'DESCEND TO AND MAINTAIN BLOCK [altitude] TO [altitude]',
    33: 'CRUISE [altitude]',
    34: 'CRUISE CLIMB TO [altitude]',
    35: 'CRUISE CLIMB ABOVE [altitude]',
    36: 'EXPEDITE CLIMB TO [altitude]',
    37: 'EXPEDITE DESCENT TO [altitude]',
    38: 'IMMEDIATELY CLIMB TO [altitude]',
    39: 'IMMEDIATELY DESCEND TO [altitude]',
    40: 'IMMEDIATELY STOP CLIMB AT [altitude]',
    41: 'IMMEDIATELY STOP DESCENT AT [altitude]',
    42: 'EXPECT TO CROSS [position] AT [altitude]',
    43: 'EXPECT TO CROSS [position] AT OR ABOVE [altitude]',
    44: 'EXPECT TO CROSS [position] AT OR BELOW [altitude]',
    45: 'EXPECT TO CROSS [position] AT AND MAINTAIN [altitude]',
    46: 'CROSS [position] AT [altitude]',
    47: 'CROSS [position] AT OR ABOVE [altitude]',
    48: 'CROSS [position] AT OR BELOW [altitude]',
    49: 'CROSS [position] AT AND MAINTAIN [altitude]',
    50: 'CROSS [position] BETWEEN [altitude] AND [altitude]',
    51: 'CROSS [position] AT [time]',
    52: 'CROSS [position] AT OR BEFORE [time]',
    53: 'CROSS [position] AT OR AFTER [time]',
    54: 'CROSS [position] BETWEEN [time] AND [time]',
    55: 'CROSS [position] AT [speed]',
    56: 'CROSS [position] AT OR LESS THAN [speed]',
    57: 'CROSS [position] AT OR GREATER THAN [speed]',
    58: 'CROSS [position] AT [time] AT [altitude]',
    59: 'CROSS [position] AT OR BEFORE [time] AT [altitude]',
    60: 'CROSS [position] AT OR AFTER [time] AT [altitude]',
    61: 'CROSS [position] AT AND MAINTAIN [altitude] AT [speed]',
    62: 'AT [time] CROSS [position] AT AND MAINTAIN [altitude]',
    63: 'AT [time] CROSS [position] AT AND MAINTAIN [altitude] AT [speed]',
    64: 'OFFSET [distance offset] [direction] OF ROUTE',
    65: 'AT [position] OFFSET [distance offset] [direction] OF ROUTE',
    66: 'AT [time] OFFSET [distance offset] [direction] OF ROUTE',
    67: 'PROCEED BACK ON ROUTE',
    68: 'REJOIN ROUTE BY [position]',
    69: 'REJOIN ROUTE BY [time]',
    70: 'EXPECT BACK ON ROUTE BY [position]',
    71: 'EXPECT BACK ON ROUTE BY [time]',
    72: 'RESUME OWN NAVIGATION',
    73: '[predeparture clearance]',
    74: 'PROCEED DIRECT TO [position]',
    75: 'WHEN ABLE PROCEED DIRECT TO [position]',
    76: 'AT [time] PROCEED DIRECT TO [position]',
    77: 'AT [position] PROCEED DIRECT TO [position]',
    78: 'AT [altitude] PROCEED DIRECT TO [position]',
    79: 'CLEARED TO [position] VIA [route clearance]',
    80: 'CLEARED [route clearance]',
    81: 'CLEARED [procedure name]',
    82: 'CLEARED TO DEVIATE UP TO [distance offset] [direction] OF ROUTE',
    83: 'AT [position] CLEARED [route clearance]',
    84: 'AT [position] CLEARED [procedure name]',
    85: 'EXPECT [route clearance]',
    86: 'AT [position] EXPECT [route clearance]',
    87: 'EXPECT DIRECT TO [position]',
    88: 'AT [position] EXPECT DIRECT TO [position]',
    89: 'AT [time] EXPECT DIRECT TO [position]',
    90: 'AT [altitude] EXPECT DIRECT TO [position]',
    91: 'HOLD AT [position] MAINTAIN [altitude] INBOUND TRACK [degrees] '
        '[direction] TURNS [leg type]',
    92: 'HOLD AT [position] AS PUBLISHED MAINTAIN [altitude]',
    93: 'EXPECT FURTHER CLEARANCE AT [time]',
    94: 'TURN [direction] HEADING [degrees]',
    95: 'TURN [direction] GROUND TRACK [degrees]',
    96: 'FLY PRESENT HEADING',
    97: 'AT [position] FLY HEADING [degrees]',
    98: 'IMMEDIATELY TURN [direction] HEADING [degrees]',
    99: 'EXPECT [procedure name]',
    100: 'AT [time] EXPECT [speed]',
    101: 'AT [position] EXPECT [speed]',
    102: 'AT [altitude] EXPECT [speed]',
    103: 'AT [time] EXPECT [speed] TO [speed]',
    104: 'AT [position] EXPECT [speed] TO [speed]',
    105: 'AT [altitude] EXPECT [speed] TO [speed]',
    106: 'MAINTAIN [speed]',
    107: 'MAINTAIN PRESENT SPEED',
    108: 'MAINTAIN [speed] OR GREATER',
    109: 'MAINTAIN [speed] OR LESS',
    110: 'MAINTAIN [speed] TO [speed]',
    111: 'INCREASE SPEED TO [speed]',
    112: 'INCREASE SPEED TO [speed] OR GREATER',
    113: 'REDUCE SPEED TO [speed]',
    114: 'REDUCE SPEED TO [speed] OR LESS',
    115: 'DO NOT EXCEED [speed]',
    116: 'RESUME NORMAL SPEED',
    117: 'CONTACT [icao unit name] [frequency]',
    118: 'AT [position] CONTACT [icao unit name] [frequency]',
    119: 'AT [time] CONTACT [icao unit name] [frequency]',
    120: 'MONITOR [icao unit name] [frequency]',
    121: 'AT [position] MONITOR [icao unit name] [frequency]',
    122: 'AT [time] MONITOR [icao unit name] [frequency]',
    123: 'SQUAWK [beacon code]',
    124: 'STOP SQUAWK',
    125: 'SQUAWK ALTITUDE',
    126: 'STOP ALTITUDE SQUAWK',
    127: 'REPORT BACK ON ROUTE',
    128: 'REPORT LEAVING [altitude]',
    129: 'REPORT LEVEL [altitude]',
    130: 'REPORT PASSING [position]',
    131: 'REPORT REMAINING FUEL AND SOULS ON BOARD',
    132: 'CONFIRM POSITION',
    133: 'CONFIRM ALTITUDE',
    134: 'CONFIRM SPEED',
    135: 'CONFIRM ASSIGNED ALTITUDE',
    136: 'CONFIRM ASSIGNED SPEED',
    137: 'CONFIRM ASSIGNED ROUTE',
    138: 'CONFIRM TIME OVER REPORTED WAYPOINT',
    139: 'CONFIRM REPORTED WAYPOINT',
    140: 'CONFIRM NEXT WAYPOINT',
    141: 'CONFIRM NEXT WAYPOINT ETA',
    142: 'CONFIRM ENSUING WAYPOINT',
    143: 'CONFIRM REQUEST',
    144: 'CONFIRM SQUAWK',
    145: 'CONFIRM HEADING',
    146: 'CONFIRM GROUND TRACK',
    147: 'REQUEST POSITION REPORT',
    148: 'WHEN CAN YOU ACCEPT [altitude]',
    149: 'CAN YOU ACCEPT [altitude] AT [position]',
    150: 'CAN YOU ACCEPT [altitude] AT [time]',
    151: 'WHEN CAN YOU ACCEPT [speed]',
    152: 'WHEN CAN YOU ACCEPT [distance offset] [direction] OFFSET',
    153: 'ALTIMETER [altimeter]',
    154: 'RADAR SERVICES TERMINATED',
    155: 'RADAR CONTACT [position]',
    156: 'RADAR CONTACT LOST',
    157: 'CHECK STUCK MICROPHONE [frequency]',
    158: 'ATIS [atis code]',
    159: 'ERROR [error information]',
    160: 'NEXT DATA AUTHORITY [icao facility designation]',
    161: 'END SERVICE',
    162: 'SERVICE UNAVAILABLE',
    163: '[icao facility designation]',
    164: 'WHEN READY',
    165: 'THEN',
    166: 'DUE TO TRAFFIC',
    167: 'DUE TO AIRSPACE RESTRICTION',
    168: 'DISREGARD',
    169: '[free text]',
    170: '[free text]',
    171: 'CLIMB AT [vertical rate] MINIMUM',
    172: 'CLIMB AT [vertical rate] MAXIMUM',
    173: 'DESCEND AT [vertical rate] MINIMUM',
    174: 'DESCEND AT [vertical rate] MAXIMUM',
    175: 'REPORT REACHING [altitude]',
    176: 'MAINTAIN OWN SEPARATION AND VMC',
    177: 'AT PILOTS DISCRETION',
    178: '[reserved]',
    179: 'SQUAWK IDENT',
    180: 'REPORT REACHING BLOCK [altitude] TO [altitude]',
    181: 'REPORT DISTANCE [to/from] [position]',
    182: 'CONFIRM ATIS CODE',
}

# Downlink: dM0..dM80 (81 alternatives -> 7-bit choice index).
DOWNLINK_MSG = {
    0: 'WILCO', 1: 'UNABLE', 2: 'STANDBY', 3: 'ROGER', 4: 'AFFIRM',
    5: 'NEGATIVE',
    6: 'REQUEST [altitude]',
    7: 'REQUEST BLOCK [altitude] TO [altitude]',
    8: 'REQUEST CRUISE CLIMB TO [altitude]',
    9: 'REQUEST CLIMB TO [altitude]',
    10: 'REQUEST DESCENT TO [altitude]',
    11: 'AT [position] REQUEST CLIMB TO [altitude]',
    12: 'AT [position] REQUEST DESCENT TO [altitude]',
    13: 'AT [time] REQUEST CLIMB TO [altitude]',
    14: 'AT [time] REQUEST DESCENT TO [altitude]',
    15: 'REQUEST OFFSET [distance offset] [direction] OF ROUTE',
    16: 'AT [position] REQUEST OFFSET [distance offset] [direction] '
        'OF ROUTE',
    17: 'AT [time] REQUEST OFFSET [distance offset] [direction] OF ROUTE',
    18: 'REQUEST [speed]',
    19: 'REQUEST [speed] TO [speed]',
    20: 'REQUEST VOICE CONTACT',
    21: 'REQUEST VOICE CONTACT [frequency]',
    22: 'REQUEST DIRECT TO [position]',
    23: 'REQUEST [procedure name]',
    24: 'REQUEST [route clearance]',
    25: 'REQUEST CLEARANCE',
    26: 'REQUEST WEATHER DEVIATION TO [position] VIA [route clearance]',
    27: 'REQUEST WEATHER DEVIATION UP TO [distance offset] [direction] '
        'OF ROUTE',
    28: 'LEAVING [altitude]',
    29: 'CLIMBING TO [altitude]',
    30: 'DESCENDING TO [altitude]',
    31: 'PASSING [position]',
    32: 'PRESENT ALTITUDE [altitude]',
    33: 'PRESENT POSITION [position]',
    34: 'PRESENT SPEED [speed]',
    35: 'PRESENT HEADING [degrees]',
    36: 'PRESENT GROUND TRACK [degrees]',
    37: 'LEVEL [altitude]',
    38: 'ASSIGNED ALTITUDE [altitude]',
    39: 'ASSIGNED SPEED [speed]',
    40: 'ASSIGNED ROUTE [route clearance]',
    41: 'BACK ON ROUTE',
    42: 'NEXT WAYPOINT [position]',
    43: 'NEXT WAYPOINT ETA [time]',
    44: 'ENSUING WAYPOINT [position]',
    45: 'REPORTED WAYPOINT [position]',
    46: 'REPORTED WAYPOINT [time]',
    47: 'SQUAWKING [beacon code]',
    48: 'POSITION REPORT [position report]',
    49: 'WHEN CAN WE EXPECT [speed]',
    50: 'WHEN CAN WE EXPECT [speed] TO [speed]',
    51: 'WHEN CAN WE EXPECT BACK ON ROUTE',
    52: 'WHEN CAN WE EXPECT LOWER ALTITUDE',
    53: 'WHEN CAN WE EXPECT HIGHER ALTITUDE',
    54: 'WHEN CAN WE EXPECT CRUISE CLIMB TO [altitude]',
    55: 'PAN PAN PAN',
    56: 'MAYDAY MAYDAY MAYDAY',
    57: '[remaining fuel] OF FUEL REMAINING AND [souls] SOULS ON BOARD',
    58: 'CANCEL EMERGENCY',
    59: 'DIVERTING TO [position] VIA [route clearance]',
    60: 'OFFSETTING [distance offset] [direction] OF ROUTE',
    61: 'DESCENDING TO [altitude]',
    62: 'ERROR [error information]',
    63: 'NOT CURRENT DATA AUTHORITY',
    64: '[icao facility designation]',
    65: 'DUE TO WEATHER',
    66: 'DUE TO AIRCRAFT PERFORMANCE',
    67: '[free text]',
    68: '[free text]',
    69: 'REQUEST VMC DESCENT',
    70: 'REQUEST HEADING [degrees]',
    71: 'REQUEST GROUND TRACK [degrees]',
    72: 'REACHING [altitude]',
    73: '[version number]',
    74: 'MAINTAIN OWN SEPARATION AND VMC',
    75: 'AT PILOTS DISCRETION',
    76: 'REACHING BLOCK [altitude] TO [altitude]',
    77: 'ASSIGNED BLOCK [altitude] TO [altitude]',
    78: 'AT [time] [distance] [to/from] [position]',
    79: 'ATIS [atis code]',
    80: 'DEVIATING [distance offset] [direction] OF ROUTE',
}

# Elements whose argument type is NULL: decoding can continue past them.
UPLINK_NULL = frozenset({
    0, 1, 2, 3, 4, 5, 67, 72, 96, 107, 116, 124, 125, 126, 127, 131,
    132, 133, 134, 135, 136, 137, 138, 139, 140, 141, 142, 143, 144,
    145, 146, 147, 154, 156, 161, 162, 164, 165, 166, 167, 168, 176,
    177, 179, 182,
})
DOWNLINK_NULL = frozenset({
    0, 1, 2, 3, 4, 5, 20, 25, 41, 51, 52, 53, 55, 56, 58, 63, 65, 66,
    69, 74, 75,
})

UPLINK_CHOICE_BITS = 8       # 183 alternatives
DOWNLINK_CHOICE_BITS = 7     # 81 alternatives
UPLINK_COUNT = 183
DOWNLINK_COUNT = 81


# --- element argument decoders (DO-258A types, unaligned PER) ---------------
#
# Each decoder consumes bits from a BitReader and returns a display string.
# A placeholder type outside this table (route clearance, position report,
# predeparture clearance, ...) raises _Unsupported and the element falls
# back to the raw-bits rendering.


class _Unsupported(ValueError):
    """Argument type we deliberately do not decode (compound DO-258A types).

    Subclasses ValueError so that even an uncaught escape degrades to the
    'unparseable message' path instead of crashing on off-air frames.
    parse() additionally catches it explicitly at the _decode_args call
    site and falls back to the raw-bits rendering for that element.
    """


def _uint(rd: BitReader, lo: int, hi: int) -> int:
    """PER constrained whole number (unaligned): ceil(log2(range)) bits."""
    span = hi - lo
    if span == 0:
        return lo
    val = lo + rd.read(span.bit_length())
    if val > hi:
        raise ValueError('constrained int out of range')
    return val


def _ia5(rd: BitReader, lo: int, hi: int) -> str:
    """IA5String SIZE(lo..hi): constrained length + 7-bit characters."""
    n = _uint(rd, lo, hi)
    s = ''.join(chr(rd.read(7)) for _ in range(n))
    if any(ch < ' ' or ch > '~' for ch in s):
        raise ValueError('non-printable IA5')
    return s


def _arg_time(rd):
    return f'{_uint(rd, 0, 23):02d}:{_uint(rd, 0, 59):02d}'


# Altitude CHOICE alternatives.  Scale resolution: the PER-visible range
# IS the carried value range, so the unit must make the range span the
# physical envelope.  (-600..70000) only makes sense as whole feet
# (10-ft units would mean a 700,000 ft ceiling); (-30..25000) as whole
# meters; (30..600) as a flight level; (100..2500) as tens of meters
# (1,000-25,000 m).  This resolves the earlier '10-ft resolution?' doubt
# on range-consistency grounds; bit-for-bit validation against libacars
# on an off-air capture is still outstanding (NOTES.md).
_ALT_ALTS = (
    # (label fmt, lo, hi, scale)
    ('{} FT QNH', -600, 70000, 1),       # altitudeQNH, whole feet
    ('{} M QNH', -30, 25000, 1),         # altitudeQNHMeters, whole meters
    ('{} FT QFE', -600, 70000, 1),       # altitudeQFE
    ('{} M QFE', -30, 25000, 1),         # altitudeQFEMeters
    ('{} FT GNSS', 0, 70000, 1),         # altitudeGNSSFeet
    ('{} M GNSS', 0, 25000, 1),          # altitudeGNSSMeters
    ('FL{}', 30, 600, 1),                # altitudeFlightLevel
    ('FL{} (METRIC)', 100, 2500, 10),    # altitudeFlightLevelMetric, 10 m units
)


def _arg_altitude(rd):
    fmt, lo, hi, scale = _ALT_ALTS[_uint(rd, 0, 7)]
    return fmt.format(_uint(rd, lo, hi) * scale)


# Speed CHOICE alternatives.  Same range-consistency argument: (0..400)
# spans indicated airspeeds only as whole knots (10-kt units would give
# a 4,000 kt IAS ceiling); mach alternatives carry mach x1000
# (500..4000 -> M0.5..M4.0).
_SPEED_ALTS = (
    ('{} KT IAS', 0, 400, 1),
    ('{} KM/H IAS', 0, 800, 1),
    ('{} KT TAS', 0, 2000, 1),
    ('{} KM/H TAS', 0, 4000, 1),
    ('{} KT GS', -50, 2000, 1),
    ('{} KM/H GS', -100, 4000, 1),
    ('M{:.3f}', 500, 4000, 1),           # mach x1000
    ('M{:.3f}', 500, 4000, 1),           # machLarge
)


def _arg_speed(rd):
    idx = _uint(rd, 0, 7)
    fmt, lo, hi, _ = _SPEED_ALTS[idx]
    v = _uint(rd, lo, hi)
    return fmt.format(v / 1000.0) if idx >= 6 else fmt.format(v)


def _arg_latlon(rd):
    lat = _uint(rd, 0, 90000) / 1000.0
    ns = 'NS'[rd.read(1)]
    lon = _uint(rd, 0, 180000) / 1000.0
    ew = 'EW'[rd.read(1)]
    return f'{lat:.3f}{ns} {lon:.3f}{ew}'


def _arg_position(rd):
    c = _uint(rd, 0, 4)
    if c == 0:
        return _ia5(rd, 1, 5)            # published fix name
    if c == 1:
        return _ia5(rd, 1, 4)            # navaid
    if c == 2:
        return _ia5(rd, 4, 4)            # airport
    if c == 3:
        return _arg_latlon(rd)
    return _arg_place_bearing_distance(rd)


def _arg_distance_offset(rd):
    if rd.read(1):
        return f'{_uint(rd, 1, 256)} KM'
    return f'{_uint(rd, 1, 128)} NM'


_DIRECTIONS = ('LEFT', 'RIGHT', 'EITHER SIDE', 'NORTH', 'SOUTH', 'EAST',
               'WEST', 'NORTH EAST', 'NORTH WEST', 'SOUTH EAST',
               'SOUTH WEST')


def _arg_direction(rd):
    return _DIRECTIONS[_uint(rd, 0, len(_DIRECTIONS) - 1)]


def _arg_degrees(rd):
    kind = 'TRUE' if rd.read(1) else 'MAGNETIC'
    return f'{_uint(rd, 1, 360)} DEGREES {kind}'


def _arg_frequency(rd):
    c = _uint(rd, 0, 3)
    if c == 0:                           # HF, kHz
        return f'{_uint(rd, 2850, 28000)} KHZ'
    if c == 1:                           # VHF, 25 kHz raster
        return f'{(_uint(rd, 0, 759) * 25 + 118000) / 1000.0:.3f} MHZ'
    if c == 2:                           # UHF, 25 kHz raster
        return f'{(_uint(rd, 0, 6999) * 25 + 225000) / 1000.0:.3f} MHZ'
    # SatChannel ::= NumericString SIZE(12): PER 4-bit chars over the
    # canonical NumericString alphabet (space, then '0'..'9')
    return 'SATCOM ' + _numeric(rd, 12).strip()


_NUMERIC_ALPHABET = ' 0123456789'


def _numeric(rd: BitReader, n: int) -> str:
    out = []
    for _ in range(n):
        v = rd.read(4)
        if v >= len(_NUMERIC_ALPHABET):
            raise ValueError('bad NumericString char')
        out.append(_NUMERIC_ALPHABET[v])
    return ''.join(out)


def _arg_beacon_code(rd):
    return ''.join(str(_uint(rd, 0, 7)) for _ in range(4))


def _arg_free_text(rd):
    return _ia5(rd, 1, 256)


def _arg_facility(rd):
    return _ia5(rd, 4, 8)                # ICAO facility designation


_FACILITY_FUNCTIONS = ('CENTER', 'APPROACH', 'TOWER', 'FINAL',
                       'GROUND CONTROL', 'CLEARANCE DELIVERY', 'DEPARTURE',
                       'CONTROL', 'RADIO')


def _arg_unit_name(rd):
    # SEQUENCE { facility CHOICE {designation, name}, function ENUM }
    name = _ia5(rd, 3, 18) if rd.read(1) else _arg_facility(rd)
    func = _FACILITY_FUNCTIONS[_uint(rd, 0, len(_FACILITY_FUNCTIONS) - 1)]
    return f'{name} {func}'


def _arg_atis(rd):
    ch = _ia5(rd, 1, 1)
    if not ch.isalpha():
        raise ValueError('bad ATIS code')
    return ch


def _arg_altimeter(rd):
    if rd.read(1):
        return f'{_uint(rd, 7500, 12500) / 10.0:.1f} HPA'
    return f'{_uint(rd, 2200, 3200) / 100.0:.2f} INHG'


def _arg_vertical_rate(rd):
    if rd.read(1):
        return f'{_uint(rd, 0, 3000)} M/MIN'
    return f'{_uint(rd, 0, 6000)} FT/MIN'


def _arg_leg_type(rd):
    if rd.read(1):
        return f'{_uint(rd, 1, 100) / 10.0:.1f} MIN LEG'
    return f'{_uint(rd, 1, 128) / 10.0:.1f} NM LEG'


def _arg_tofrom(rd):
    return 'FROM' if rd.read(1) else 'TO'


def _arg_distance(rd):
    return f'{_uint(rd, 0, 8000)} NM'


_ERRORS = ('APPLICATION ERROR', 'DUPLICATE MESSAGE ID',
           'UNRECOGNIZED MESSAGE REFERENCE NUMBER',
           'LOGICAL ACKNOWLEDGMENT NOT ACCEPTED', 'INSUFFICIENT RESOURCES',
           'INVALID MESSAGE ELEMENT COMBINATION', 'INVALID MESSAGE ELEMENT')


def _arg_error(rd):
    return _ERRORS[_uint(rd, 0, len(_ERRORS) - 1)]


def _arg_version(rd):
    return str(_uint(rd, 0, 15))


_PROC_TYPES = ('ARRIVAL', 'APPROACH', 'DEPARTURE')


def _arg_procedure(rd):
    has_transition = rd.read(1)          # OPTIONAL preamble
    ptype = _PROC_TYPES[_uint(rd, 0, len(_PROC_TYPES) - 1)]
    name = _ia5(rd, 1, 20)
    out = f'{name} {ptype}'
    if has_transition:
        out += f' TRANSITION {_ia5(rd, 1, 5)}'
    return out


# --- compound DO-258A types -------------------------------------------------
#
# These decode the large SEQUENCE types (route clearance, position
# report, predeparture clearance) that the reference gets from libacars
# (reference src/acars.c:28-40 -> la_acars_parse_and_reassemble).
# Layouts follow the DO-258A ASN.1 structure (unaligned PER: leading
# optional-field preamble, then fields in order); primitive encodings
# reuse this module's scalar decoders so the whole family shares one set
# of PER conventions.  Like the scalar arguments they are round-trip
# tested against the encoders below but not yet validated bit-for-bit
# against libacars on an off-air capture (no libacars in this tree);
# any mismatch on real traffic degrades to the raw-bits rendering via
# the ValueError fallback in parse().


def _arg_remaining_fuel(rd):
    """RemainingFuel ::= Time (fuel endurance hh:mm)."""
    return _arg_time(rd)


def _arg_souls(rd):
    """RemainingSouls ::= INTEGER (1..1024)."""
    return str(_uint(rd, 1, 1024))


def _arg_published_identifier(rd):
    """PublishedIdentifier ::= SEQUENCE { fixName, latitudeLongitude OPT }."""
    has_ll = rd.read(1)
    name = _ia5(rd, 1, 5)
    if has_ll:
        name += f' ({_arg_latlon(rd)})'
    return name


def _arg_place_bearing(rd):
    """PlaceBearing ::= SEQUENCE { publishedIdentifier, degrees }."""
    pid = _arg_published_identifier(rd)
    return f'{pid} BEARING {_arg_degrees(rd)}'


def _arg_place_bearing_distance(rd):
    """PlaceBearingDistance ::= SEQUENCE { placeBearing, distance }."""
    return f'{_arg_place_bearing(rd)} DISTANCE {_arg_distance(rd)}'


_RUNWAY_CONF = ('L', 'R', 'C', '')


def _arg_runway(rd):
    """Runway ::= SEQUENCE { direction (1..36), configuration ENUM }."""
    d = _uint(rd, 1, 36)
    conf = _RUNWAY_CONF[_uint(rd, 0, 3)]
    return f'RWY {d:02d}{conf}'


# RouteInformation ::= CHOICE (6 alternatives, 3-bit index)
def _arg_route_information(rd):
    c = _uint(rd, 0, 5)
    if c == 0:
        return _arg_published_identifier(rd)
    if c == 1:
        return _arg_latlon(rd)
    if c == 2:      # placeBearingPlaceBearing: SEQUENCE of exactly 2
        return f'{_arg_place_bearing(rd)} / {_arg_place_bearing(rd)}'
    if c == 3:
        return _arg_place_bearing_distance(rd)
    if c == 4:      # airwayIdentifier
        return f'AIRWAY {_ia5(rd, 1, 7)}'
    # trackDetail ::= SEQUENCE { trackName, SEQ SIZE(1..128) OF LatLon }
    name = _ia5(rd, 1, 8)
    n = _uint(rd, 1, 128)
    pts = ', '.join(_arg_latlon(rd) for _ in range(n))
    return f'TRACK {name} [{pts}]'


def _arg_route_clearance(rd):
    """RouteClearance ::= SEQUENCE, 9 OPTIONAL fields (9-bit preamble):
    airportDeparture, airportDestination, runwayDeparture,
    procedureDeparture, runwayArrival, procedureApproach,
    procedureArrival, routeInformations SEQ SIZE(1..128),
    routeInformationAdditional.

    routeInformationAdditional (the ATW/hold/RTA annex) is not decoded:
    if present the whole element falls back to the raw rendering, since
    element boundaries are unknowable past an undecoded field."""
    opt = [rd.read(1) for _ in range(9)]
    parts = []
    if opt[0]:
        parts.append(f'DEPARTING {_ia5(rd, 4, 4)}')
    if opt[1]:
        parts.append(f'DESTINATION {_ia5(rd, 4, 4)}')
    if opt[2]:
        parts.append(f'DEP {_arg_runway(rd)}')
    if opt[3]:
        parts.append(f'DEP PROC {_arg_procedure(rd)}')
    if opt[4]:
        parts.append(f'ARR {_arg_runway(rd)}')
    if opt[5]:
        parts.append(f'APPROACH {_arg_procedure(rd)}')
    if opt[6]:
        parts.append(f'ARR PROC {_arg_procedure(rd)}')
    if opt[7]:
        n = _uint(rd, 1, 128)
        route = ' '.join(_arg_route_information(rd) for _ in range(n))
        parts.append(f'ROUTE: {route}')
    if opt[8]:
        raise _Unsupported('routeInformationAdditional')
    return ' | '.join(parts) if parts else '(empty)'


_TURBULENCE = ('LIGHT', 'MODERATE', 'SEVERE')
_ICING = ('RESERVED', 'LIGHT', 'MODERATE', 'SEVERE')


def _arg_winds(rd):
    """Winds ::= SEQUENCE { windDirection (1..360), windSpeed Speed }."""
    return f'WIND {_uint(rd, 1, 360)} DEG AT {_arg_speed(rd)}'


def _arg_vertical_change(rd):
    """VerticalChange ::= SEQUENCE { direction ENUM{up,down}, rate }."""
    d = 'DOWN' if rd.read(1) else 'UP'
    return f'{d} {_arg_vertical_rate(rd)}'


def _arg_position_report(rd):
    """PositionReport ::= SEQUENCE: 3 mandatory fields (current position,
    time, altitude) + 19 OPTIONAL fields (19-bit preamble), in DO-258A
    field order."""
    opt = [rd.read(1) for _ in range(19)]
    parts = [f'AT {_arg_position(rd)}',
             f'TIME {_arg_time(rd)}',
             f'ALT {_arg_altitude(rd)}']
    optional = (
        ('NEXT FIX {}', _arg_position),
        ('ETA {}', _arg_time),
        ('THEN {}', _arg_position),
        ('DEST ETA {}', _arg_time),
        ('FUEL {}', _arg_remaining_fuel),
        ('TEMP {} C', lambda r: str(_uint(r, -100, 100))),
        ('{}', _arg_winds),
        ('TURBULENCE {}', lambda r: _TURBULENCE[_uint(r, 0, 2)]),
        ('ICING {}', lambda r: _ICING[_uint(r, 0, 3)]),
        ('SPEED {}', _arg_speed),
        ('GS {}', _arg_speed),
        ('{}', _arg_vertical_change),
        ('TRACK {}', _arg_degrees),
        ('HDG {}', _arg_degrees),
        ('DIST {}', _arg_distance),
        ('REMARKS: {}', _arg_free_text),
        ('REPORTED WPT {}', _arg_position),
        ('REPORTED WPT TIME {}', _arg_time),
        ('REPORTED WPT ALT {}', _arg_altitude),
    )
    for flag, (fmt, dec) in zip(opt, optional):
        if flag:
            parts.append(fmt.format(dec(rd)))
    return ' | '.join(parts)


def _arg_predeparture_clearance(rd):
    """PredepartureClearance ::= SEQUENCE: flight id + departure +
    destination (mandatory) + 4 OPTIONAL fields (4-bit preamble):
    runwayDeparture, procedureDeparture, routeClearance, freeText."""
    opt = [rd.read(1) for _ in range(4)]
    parts = [f'FLT {_ia5(rd, 2, 8)}',
             f'DEPARTING {_ia5(rd, 4, 4)}',
             f'DESTINATION {_ia5(rd, 4, 4)}']
    if opt[0]:
        parts.append(f'DEP {_arg_runway(rd)}')
    if opt[1]:
        parts.append(f'DEP PROC {_arg_procedure(rd)}')
    if opt[2]:
        parts.append(f'CLEARED {_arg_route_clearance(rd)}')
    if opt[3]:
        parts.append(f'REMARKS: {_arg_free_text(rd)}')
    return ' | '.join(parts)


_ARG_DECODERS = {
    'altitude': _arg_altitude,
    'speed': _arg_speed,
    'time': _arg_time,
    'position': _arg_position,
    'distance offset': _arg_distance_offset,
    'direction': _arg_direction,
    'degrees': _arg_degrees,
    'frequency': _arg_frequency,
    'beacon code': _arg_beacon_code,
    'free text': _arg_free_text,
    'icao facility designation': _arg_facility,
    'icao unit name': _arg_unit_name,
    'atis code': _arg_atis,
    'altimeter': _arg_altimeter,
    'vertical rate': _arg_vertical_rate,
    'leg type': _arg_leg_type,
    'to/from': _arg_tofrom,
    'distance': _arg_distance,
    'error information': _arg_error,
    'version number': _arg_version,
    'procedure name': _arg_procedure,
    'remaining fuel': _arg_remaining_fuel,
    'souls': _arg_souls,
    'route clearance': _arg_route_clearance,
    'position report': _arg_position_report,
    'predeparture clearance': _arg_predeparture_clearance,
}

_PLACEHOLDER_RE = re.compile(r'\[([^\]]+)\]')


def _decode_args(rd: BitReader, phraseology: str) -> list[str]:
    """Decode an element's arguments per its placeholder signature."""
    args = []
    for token in _PLACEHOLDER_RE.findall(phraseology):
        dec = _ARG_DECODERS.get(token)
        if dec is None:
            raise _Unsupported(token)
        args.append(dec(rd))
    return args


def render_element(text: str, args: list[str]) -> str:
    """Substitute decoded argument values into the phraseology string."""
    it = iter(args)
    return _PLACEHOLDER_RE.sub(lambda _: f'[{next(it)}]', text)


def parse(payload: bytes, uplink: bool) -> ProtoNode | None:
    """Decode a FANS-1/A ATCUplinkMessage / ATCDownlinkMessage."""
    data: dict = {'err': False, 'dir': 'uplink' if uplink else 'downlink'}
    node = ProtoNode('cpdlc', data)
    node.text_formatter = _fmt
    node.json_formatter = _js
    rd = BitReader(payload)
    elements: list[dict] = []
    try:
        has_ref = rd.read(1)
        has_ts = rd.read(1)
        data['min'] = rd.read(6)
        if has_ref:
            data['mrn'] = rd.read(6)
        if has_ts:
            h, m, s = rd.read(5), rd.read(6), rd.read(6)
            data['timestamp'] = f'{h:02d}:{m:02d}:{s:02d}'
        count = rd.read(3) + 1
        if count > 5:
            raise ValueError('bad element count')
        names = UPLINK_MSG if uplink else DOWNLINK_MSG
        nulls = UPLINK_NULL if uplink else DOWNLINK_NULL
        nbits = UPLINK_CHOICE_BITS if uplink else DOWNLINK_CHOICE_BITS
        limit = UPLINK_COUNT if uplink else DOWNLINK_COUNT
        prefix = 'uM' if uplink else 'dM'
        for i in range(count):
            idx = rd.read(nbits)
            if idx >= limit:
                raise ValueError('bad choice index')
            el = {'id': f'{prefix}{idx}',
                  'text': names.get(idx, f'{prefix}{idx}')}
            if idx not in nulls:
                # decode the element's arguments per its placeholder
                # signature; on an unsupported compound type or a PER
                # decode failure, rewind and fall back to the raw-bits
                # rendering -- element boundaries are unknowable past an
                # undecodable argument, so the walk stops there.
                save = rd.pos
                try:
                    args = _decode_args(rd, el['text'])
                except (_Unsupported, ValueError):
                    rd.pos = save
                    rem = rd.remaining()
                    if rem > 0:
                        el['arg_bits'] = rem
                        bits = BitWriter()
                        while rd.remaining() >= 8:
                            bits.write(rd.read(8), 8)
                        tail = rd.remaining()
                        if tail:
                            bits.write(rd.read(tail) << (8 - tail), 8)
                        el['arg_raw'] = bits.tobytes().hex()
                    elements.append(el)
                    if i + 1 < count:
                        data['undecoded_elements'] = count - i - 1
                    break
                el['args'] = args
                el['rendered'] = render_element(el['text'], args)
            elements.append(el)
        data['elements'] = elements
    except ValueError:
        # keep any elements decoded before the failure point for display
        data['err'] = True
        if elements:
            data['elements'] = elements
    return node


# --- element argument encoders (test-vector generation) ---------------------
#
# Mirror images of the decoders above, accepting semantic value tuples so
# every entry in _ARG_DECODERS can be round-trip tested.


def _wuint(w: BitWriter, val: int, lo: int, hi: int) -> None:
    span = hi - lo
    if span == 0:
        return
    if not lo <= val <= hi:
        raise ValueError(f'{val} outside [{lo},{hi}]')
    w.write(val - lo, span.bit_length())


def _wia5(w: BitWriter, s: str, lo: int, hi: int) -> None:
    _wuint(w, len(s), lo, hi)
    for ch in s:
        w.write(ord(ch), 7)


def _enc_time(w, v):                      # (h, m)
    _wuint(w, v[0], 0, 23)
    _wuint(w, v[1], 0, 59)


def _enc_altitude(w, v):                  # (alt_idx, carried_int)
    idx, val = v
    _wuint(w, idx, 0, 7)
    _, lo, hi, _ = _ALT_ALTS[idx]
    _wuint(w, val, lo, hi)


def _enc_speed(w, v):                     # (alt_idx, carried_int)
    idx, val = v
    _wuint(w, idx, 0, 7)
    _, lo, hi, _ = _SPEED_ALTS[idx]
    _wuint(w, val, lo, hi)


def _enc_position(w, v):
    # (0|1|2, name) | (3, (lat_milli, ns, lon_milli, ew))
    c, val = v
    _wuint(w, c, 0, 4)
    if c == 0:
        _wia5(w, val, 1, 5)
    elif c == 1:
        _wia5(w, val, 1, 4)
    elif c == 2:
        _wia5(w, val, 4, 4)
    elif c == 3:
        _enc_latlon(w, val)
    else:
        _enc_place_bearing_distance(w, val)


def _enc_latlon(w, v):                    # (lat_milli, ns, lon_milli, ew)
    lat, ns, lon, ew = v
    _wuint(w, lat, 0, 90000)
    w.write(ns, 1)
    _wuint(w, lon, 0, 180000)
    w.write(ew, 1)


def _enc_published_identifier(w, v):      # (name, latlon|None)
    name, latlon = v
    w.write(1 if latlon is not None else 0, 1)
    _wia5(w, name, 1, 5)
    if latlon is not None:
        _enc_latlon(w, latlon)


def _enc_place_bearing(w, v):             # (pubid, degrees)
    _enc_published_identifier(w, v[0])
    _enc_degrees(w, v[1])


def _enc_place_bearing_distance(w, v):    # (pubid, degrees, dist)
    _enc_published_identifier(w, v[0])
    _enc_degrees(w, v[1])
    _enc_distance(w, v[2])


def _enc_distance_offset(w, v):           # ('nm'|'km', val)
    unit, val = v
    w.write(1 if unit == 'km' else 0, 1)
    _wuint(w, val, 1, 256 if unit == 'km' else 128)


def _enc_direction(w, v):
    idx = _DIRECTIONS.index(v) if isinstance(v, str) else v
    _wuint(w, idx, 0, len(_DIRECTIONS) - 1)


def _enc_degrees(w, v):                   # (is_true, val)
    w.write(1 if v[0] else 0, 1)
    _wuint(w, v[1], 1, 360)


def _enc_frequency(w, v):                 # (choice, raw)
    c, raw = v
    _wuint(w, c, 0, 3)
    if c == 0:
        _wuint(w, raw, 2850, 28000)
    elif c == 1:
        _wuint(w, raw, 0, 759)
    elif c == 2:
        _wuint(w, raw, 0, 6999)
    else:                                 # satchannel: 12-char NumericString
        for ch in raw:
            w.write(_NUMERIC_ALPHABET.index(ch), 4)


def _enc_beacon(w, v):                    # '0137'
    for ch in v:
        _wuint(w, int(ch), 0, 7)


def _enc_free_text(w, v):
    _wia5(w, v, 1, 256)


def _enc_facility(w, v):
    _wia5(w, v, 4, 8)


def _enc_unit_name(w, v):                 # (is_name, str, func_idx)
    is_name, s, func = v
    w.write(1 if is_name else 0, 1)
    if is_name:
        _wia5(w, s, 3, 18)
    else:
        _wia5(w, s, 4, 8)
    _wuint(w, func, 0, len(_FACILITY_FUNCTIONS) - 1)


def _enc_atis(w, v):
    _wia5(w, v, 1, 1)


def _enc_altimeter(w, v):                 # ('hpa'|'inhg', raw)
    unit, raw = v
    w.write(1 if unit == 'hpa' else 0, 1)
    if unit == 'hpa':
        _wuint(w, raw, 7500, 12500)
    else:
        _wuint(w, raw, 2200, 3200)


def _enc_vrate(w, v):                     # ('m'|'ft', val)
    unit, val = v
    w.write(1 if unit == 'm' else 0, 1)
    _wuint(w, val, 0, 3000 if unit == 'm' else 6000)


def _enc_leg_type(w, v):                  # ('min'|'nm', raw_tenths)
    unit, raw = v
    w.write(1 if unit == 'min' else 0, 1)
    _wuint(w, raw, 1, 100 if unit == 'min' else 128)


def _enc_tofrom(w, v):
    w.write(1 if v == 'FROM' else 0, 1)


def _enc_distance(w, v):
    _wuint(w, v, 0, 8000)


def _enc_error(w, v):
    _wuint(w, v, 0, len(_ERRORS) - 1)


def _enc_version(w, v):
    _wuint(w, v, 0, 15)


def _enc_procedure(w, v):                 # (ptype_idx, name, transition|None)
    ptype, name, transition = v
    w.write(1 if transition is not None else 0, 1)
    _wuint(w, ptype, 0, len(_PROC_TYPES) - 1)
    _wia5(w, name, 1, 20)
    if transition is not None:
        _wia5(w, transition, 1, 5)


# compound-type encoders (value forms documented inline)

def _enc_runway(w, v):                    # (direction, conf_idx)
    _wuint(w, v[0], 1, 36)
    _wuint(w, v[1], 0, 3)


def _enc_route_information(w, v):
    kind, val = v
    idx = ('fix', 'latlon', 'pbpb', 'pbd', 'airway', 'track').index(kind)
    _wuint(w, idx, 0, 5)
    if kind == 'fix':
        _enc_published_identifier(w, val)
    elif kind == 'latlon':
        _enc_latlon(w, val)
    elif kind == 'pbpb':
        _enc_place_bearing(w, val[0])
        _enc_place_bearing(w, val[1])
    elif kind == 'pbd':
        _enc_place_bearing_distance(w, val)
    elif kind == 'airway':
        _wia5(w, val, 1, 7)
    else:                                 # ('track', (name, [latlon...]))
        name, pts = val
        _wia5(w, name, 1, 8)
        _wuint(w, len(pts), 1, 128)
        for p in pts:
            _enc_latlon(w, p)


def _enc_route_clearance(w, v):           # dict, optional keys
    keys = ('dep', 'dest', 'dep_rwy', 'dep_proc', 'arr_rwy', 'approach',
            'arr_proc', 'route', 'additional')
    if v.get('additional') is not None:
        raise ValueError('cannot encode routeInformationAdditional')
    for k in keys:
        w.write(1 if v.get(k) is not None else 0, 1)
    if v.get('dep') is not None:
        _wia5(w, v['dep'], 4, 4)
    if v.get('dest') is not None:
        _wia5(w, v['dest'], 4, 4)
    if v.get('dep_rwy') is not None:
        _enc_runway(w, v['dep_rwy'])
    if v.get('dep_proc') is not None:
        _enc_procedure(w, v['dep_proc'])
    if v.get('arr_rwy') is not None:
        _enc_runway(w, v['arr_rwy'])
    if v.get('approach') is not None:
        _enc_procedure(w, v['approach'])
    if v.get('arr_proc') is not None:
        _enc_procedure(w, v['arr_proc'])
    if v.get('route') is not None:
        _wuint(w, len(v['route']), 1, 128)
        for ri in v['route']:
            _enc_route_information(w, ri)


def _enc_winds(w, v):                     # (direction, speed_value)
    _wuint(w, v[0], 1, 360)
    _enc_speed(w, v[1])


def _enc_vertical_change(w, v):           # (is_down, vrate_value)
    w.write(1 if v[0] else 0, 1)
    _enc_vrate(w, v[1])


_PR_OPTIONAL_ENCODERS = (
    ('next_fix', _enc_position), ('eta', _enc_time),
    ('then', _enc_position), ('dest_eta', _enc_time),
    ('fuel', _enc_time), ('temp', lambda w, v: _wuint(w, v, -100, 100)),
    ('winds', _enc_winds),
    ('turbulence', lambda w, v: _wuint(w, v, 0, 2)),
    ('icing', lambda w, v: _wuint(w, v, 0, 3)),
    ('speed', _enc_speed), ('gs', _enc_speed),
    ('vchange', _enc_vertical_change),
    ('track', _enc_degrees), ('heading', _enc_degrees),
    ('dist', _enc_distance), ('remarks', _enc_free_text),
    ('rep_wpt', _enc_position), ('rep_wpt_time', _enc_time),
    ('rep_wpt_alt', _enc_altitude),
)


def _enc_position_report(w, v):           # dict: position/time/alt + opts
    for k, _ in _PR_OPTIONAL_ENCODERS:
        w.write(1 if v.get(k) is not None else 0, 1)
    _enc_position(w, v['position'])
    _enc_time(w, v['time'])
    _enc_altitude(w, v['alt'])
    for k, enc in _PR_OPTIONAL_ENCODERS:
        if v.get(k) is not None:
            enc(w, v[k])


def _enc_pdc(w, v):                       # dict: flt/dep/dest + opts
    opts = ('dep_rwy', 'dep_proc', 'route', 'remarks')
    for k in opts:
        w.write(1 if v.get(k) is not None else 0, 1)
    _wia5(w, v['flt'], 2, 8)
    _wia5(w, v['dep'], 4, 4)
    _wia5(w, v['dest'], 4, 4)
    if v.get('dep_rwy') is not None:
        _enc_runway(w, v['dep_rwy'])
    if v.get('dep_proc') is not None:
        _enc_procedure(w, v['dep_proc'])
    if v.get('route') is not None:
        _enc_route_clearance(w, v['route'])
    if v.get('remarks') is not None:
        _enc_free_text(w, v['remarks'])


_ARG_ENCODERS = {
    'altitude': _enc_altitude,
    'speed': _enc_speed,
    'time': _enc_time,
    'position': _enc_position,
    'distance offset': _enc_distance_offset,
    'direction': _enc_direction,
    'degrees': _enc_degrees,
    'frequency': _enc_frequency,
    'beacon code': _enc_beacon,
    'free text': _enc_free_text,
    'icao facility designation': _enc_facility,
    'icao unit name': _enc_unit_name,
    'atis code': _enc_atis,
    'altimeter': _enc_altimeter,
    'vertical rate': _enc_vrate,
    'leg type': _enc_leg_type,
    'to/from': _enc_tofrom,
    'distance': _enc_distance,
    'error information': _enc_error,
    'version number': _enc_version,
    'procedure name': _enc_procedure,
    'remaining fuel': _enc_time,
    'souls': lambda w, v: _wuint(w, v, 1, 1024),
    'route clearance': _enc_route_clearance,
    'position report': _enc_position_report,
    'predeparture clearance': _enc_pdc,
}


def encode_args(w: BitWriter, phraseology: str, values: list) -> None:
    """Encode argument values per the element's placeholder signature."""
    tokens = _PLACEHOLDER_RE.findall(phraseology)
    if len(tokens) != len(values):
        raise ValueError(f'{len(tokens)} placeholders, {len(values)} values')
    for token, value in zip(tokens, values):
        enc = _ARG_ENCODERS.get(token)
        if enc is None:
            raise ValueError(f'no encoder for [{token}]')
        enc(w, value)


def encode(uplink: bool, min_: int, elements: list,
           mrn: int | None = None,
           timestamp: tuple[int, int, int] | None = None,
           arg_bits: tuple[int, int] | None = None) -> bytes:
    """Encode a CPDLC message (test-vector generator).

    Each entry of `elements` is either a bare choice index (NULL-argument
    element, or legacy arg_bits appended verbatim at the end) or an
    (index, [arg values...]) pair encoded via encode_args.
    """
    w = BitWriter()
    w.write(1 if mrn is not None else 0, 1)
    w.write(1 if timestamp is not None else 0, 1)
    w.write(min_, 6)
    if mrn is not None:
        w.write(mrn, 6)
    if timestamp is not None:
        h, m, s = timestamp
        w.write(h, 5)
        w.write(m, 6)
        w.write(s, 6)
    w.write(len(elements) - 1, 3)
    nbits = UPLINK_CHOICE_BITS if uplink else DOWNLINK_CHOICE_BITS
    names = UPLINK_MSG if uplink else DOWNLINK_MSG
    for entry in elements:
        if isinstance(entry, tuple):
            idx, values = entry
            w.write(idx, nbits)
            encode_args(w, names[idx], values)
        else:
            w.write(entry, nbits)
    if arg_bits is not None:
        val, n = arg_bits
        w.write(val, n)
    return w.tobytes()


def _fmt(n: ProtoNode, lines: list[str], indent: int) -> None:
    d = n.data
    iprintf(lines, indent, 'CPDLC %s message:'
            % ('uplink' if d['dir'] == 'uplink' else 'downlink'))
    indent += 1
    if d['err']:
        iprintf(lines, indent, '-- Unparseable CPDLC message')
        if 'elements' not in d:
            return
    hdr = f"Msg ID: {d['min']}"
    if 'mrn' in d:
        hdr += f" Msg Ref: {d['mrn']}"
    if 'timestamp' in d:
        hdr += f" Timestamp: {d['timestamp']}"
    iprintf(lines, indent, hdr)
    for el in d['elements']:
        iprintf(lines, indent, f"{el['id']}: {el.get('rendered', el['text'])}")
        if 'arg_raw' in el:
            iprintf(lines, indent + 1, f"Arguments (undecoded): "
                    f"{el['arg_raw']}")
    if d.get('undecoded_elements'):
        iprintf(lines, indent,
                f"({d['undecoded_elements']} further element(s) follow "
                f"the undecoded arguments)")


def _js(n: ProtoNode) -> dict:
    return dict(n.data)
