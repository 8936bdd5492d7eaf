"""The port's own copies of the host-only modules (no jax in them) against
the JAX package's originals: equal sources, equal behaviour from the same
inputs, and the protocol tests that need the system table, run against the
copies with the table the repo ships (etc/systable.conf)."""

import importlib
import json
import pathlib
import time

import numpy as np
import pytest

from dumphfdl_tpu import constants as JC
from dumphfdl_tpu import sequences as jseq
from dumphfdl_tpu.io import formatters as jformatters
from dumphfdl_tpu.ops import crc as jcrc
from dumphfdl_tpu.ops import interleave as jinterleave
from dumphfdl_tpu.protocol import pdu as jpdu
from dumphfdl_tpu.protocol.runtime import ProtocolContext as JProtocolContext
from dumphfdl_tpu_torch import cli
from dumphfdl_tpu_torch import constants as C
from dumphfdl_tpu_torch import sequences as seq
from dumphfdl_tpu_torch.dsp import modulator
from dumphfdl_tpu_torch.io import formats, formatters
from dumphfdl_tpu_torch.ops import bits as bitops
from dumphfdl_tpu_torch.ops import crc, interleave
from dumphfdl_tpu_torch.protocol.enrichment import SysTable
from dumphfdl_tpu_torch.protocol.pdu import PduMetadata, parse_pdu
from dumphfdl_tpu_torch.protocol.runtime import ProtocolContext

ROOT = pathlib.Path(__file__).resolve().parent.parent
SYSTABLE = str(ROOT / 'etc' / 'systable.conf')

COPIED = ['constants.py', 'sequences.py', 'ops/bits.py', 'ops/crc.py',
          'ops/interleave.py', 'io/formats.py', 'io/formatters.py',
          'io/native.py', 'io/outputs.py', 'io/soapy_input.py',
          'dsp/dumpfile.py', 'utils/statsd.py', 'utils/debug.py'] + [
    f'protocol/{m}.py' for m in (
        'tree', 'libconfig', 'enrichment', 'runtime', 'pdu', 'mpdu', 'spdu',
        'lpdu', 'hfnpdu', 'acars', 'adsc', 'cpdlc', 'media_adv', 'miam',
        'ohma', 'position')]

# the originals cite the reference decoder's sources by an absolute path;
# the copies read that prefix as 'reference ' (their header line says so)
_CITE_PREFIX = '/'.join(['', 'root', 'reference', ''])


@pytest.mark.parametrize('rel', COPIED)
def test_copy_equals_original(rel):
    """A copy is its original after one header line, so the two cannot
    drift; and it imports as a module of the port."""
    head, body = (ROOT / 'dumphfdl_tpu_torch' / rel).read_text().split('\n', 1)
    assert head.startswith(f'# Copy of dumphfdl_tpu/{rel}: ')
    orig = (ROOT / 'dumphfdl_tpu' / rel).read_text()
    assert body == orig.replace(_CITE_PREFIX, 'reference ')
    mod = importlib.import_module(
        'dumphfdl_tpu_torch.' + rel[:-3].replace('/', '.'))
    assert mod.__name__.startswith('dumphfdl_tpu_torch.')


def test_crc_and_header_length_match():
    rng = np.random.default_rng(3)
    for n in (1, 2, 17, 66, 300):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc.crc16_ccitt(data) == jcrc.crc16_ccitt(data)
        assert crc.fcs_append(data) == jcrc.fcs_append(data)
    for first in range(256):
        buf = bytes([first]) + rng.integers(0, 256, 200,
                                            dtype=np.uint8).tobytes()
        assert crc.pdu_hdr_len(buf) == jcrc.pdu_hdr_len(buf)
        assert crc.pdu_fcs_ok(buf) == jcrc.pdu_fcs_ok(buf)


@pytest.mark.parametrize('mode', range(len(JC.MODES)))
def test_interleaver_matches(mode):
    assert repr(C.MODES[mode]) == repr(JC.MODES[mode])   # two classes
    np.testing.assert_array_equal(interleave.interleave_perm(mode),
                                  jinterleave.interleave_perm(mode))
    np.testing.assert_array_equal(interleave.deinterleave_perm(mode),
                                  jinterleave.deinterleave_perm(mode))


def test_sequences_match():
    np.testing.assert_array_equal(seq.a_bits(), jseq.a_bits())
    np.testing.assert_array_equal(seq.m1_bits_all(), jseq.m1_bits_all())
    np.testing.assert_array_equal(seq.t_bits(), jseq.t_bits())
    np.testing.assert_array_equal(seq.scrambler_bits(), jseq.scrambler_bits())
    for m in range(len(C.MODES)):
        np.testing.assert_array_equal(seq.m2_bits(m), jseq.m2_bits(m))


def _golden_pdus():
    man = json.loads((ROOT / 'tests' / 'golden' / 'manifest.json').read_text())
    return [(f['mode'], man['frequencies'][f['channel']],
             bytes.fromhex(f['pdu_hex'])) for f in man['frames']]


@pytest.mark.parametrize('fmt', ['TextFormatter', 'JsonFormatter'])
def test_golden_pdus_parse_and_format_alike(fmt):
    """parse_pdu and a formatter on the PDUs pinned in the golden manifest:
    the port's copies give the JAX package's strings."""
    outs = []
    for ctx_cls, parse, meta_cls, fmts in (
            (ProtocolContext, parse_pdu, PduMetadata, formatters),
            (JProtocolContext, jpdu.parse_pdu, jpdu.PduMetadata,
             jformatters)):
        ctx = ctx_cls()
        assert ctx.systable.load(SYSTABLE)
        ctx.options.utc = True
        f = getattr(fmts, fmt)(ctx)
        got = []
        for mode, freq, pdu in _golden_pdus():
            p = C.MODES[mode]
            meta = meta_cls(freq=freq, rx_timestamp=1_700_000_000.25,
                            bit_rate=p.bit_rate, slot=p.slot, rssi=-20.0,
                            noise_floor=-40.0, freq_err_hz=1.2)
            trees = parse(pdu, meta, ctx)
            assert trees
            got += [f.format(meta, t) for t in trees]
        outs.append(got)
    assert outs[0] == outs[1]
    assert any('Auckland' in s for s in outs[0])


# --- counterparts of the protocol, enrichment and CLI tests that load the
# system table, against the port's copies and etc/systable.conf -------------

def icao_bytes(icao: int) -> bytes:
    return bytes(bitops.reverse_bytes(
        np.frombuffer(icao.to_bytes(3, 'big'), np.uint8)))


def make_lpdu(body: bytes) -> bytes:
    return crc.fcs_append(body)


def make_downlink_mpdu(lpdus, src_ac=0x42, dst_gs=0x05) -> bytes:
    hdr = bytes([0x3 | (len(lpdus) << 2), dst_gs, src_ac, 0, 0, 0]) \
        + bytes(len(p) - 1 for p in lpdus)
    return crc.fcs_append(hdr) + b''.join(lpdus)


def make_perf_hfnpdu(lat_deg, lon_deg, hour, minute, sec, flight=b'BAW123'):
    perf = bytearray(47)
    perf[0] = 0xFF
    perf[1] = 0xD1
    perf[2:8] = flight
    lat = int(lat_deg / 180 * 0x7FFFF) & 0xFFFFF
    lon = int(lon_deg / 180 * 0x7FFFF) & 0xFFFFF
    perf[8] = lat & 0xFF
    perf[9] = (lat >> 8) & 0xFF
    perf[10] = ((lat >> 16) & 0xF) | ((lon & 0xF) << 4)
    perf[11] = (lon >> 4) & 0xFF
    perf[12] = (lon >> 12) & 0xFF
    s2 = (hour * 3600 + minute * 60 + sec) // 2
    perf[13] = s2 & 0xFF
    perf[14] = s2 >> 8
    return bytes(perf)


@pytest.fixture
def ctx():
    c = ProtocolContext()
    c.systable.load(SYSTABLE)
    return c


@pytest.fixture
def meta():
    return PduMetadata(freq=8912000, rx_timestamp=time.time(),
                       bit_rate=600, slot='S', rssi=-20.0,
                       noise_floor=-40.0, freq_err_hz=1.2)


def test_downlink_logon_and_perf(ctx, meta):
    lp1 = make_lpdu(bytes([0x8F]) + icao_bytes(0x4007F5))
    now = time.gmtime()
    lp2 = make_lpdu(bytes([0x0D]) + make_perf_hfnpdu(
        51.5, -0.12, now.tm_hour, now.tm_min, max(0, now.tm_sec - 5)))
    trees = parse_pdu(make_downlink_mpdu([lp1, lp2]), meta, ctx)
    assert len(trees) == 2
    txt = trees[0].format_text()
    assert 'Logon request (normal)' in txt
    assert 'ICAO: 4007F5' in txt
    assert 'Auckland' in txt            # systable enrichment
    txt2 = trees[1].format_text()
    assert 'Performance data' in txt2
    assert 'BAW123' in txt2
    js = trees[1].to_json()
    assert abs(js['hfnpdu']['pos']['lat'] - 51.5) < 0.001


def test_spdu_parse(ctx, meta):
    buf = bytearray(66)
    buf[0] = 0x2 | (1 << 2)             # not MPDU (bit0=0), rls, version 1
    buf[1] = 0x80 | 0x05                # utc sync + GS 5
    buf[2] = 0x34                       # frame index low
    buf[3] = 0x12                       # index high nibble + offset 1
    buf[52] = 0x3
    buf[53] = 52                        # systable version
    buf[54] = (0x0) | (0x1 << 4)        # freq bitmap low bits
    fcs = crc.fcs_compute(bytes(buf[:64]))
    buf[64] = fcs & 0xFF
    buf[65] = fcs >> 8
    trees = parse_pdu(bytes(buf), meta, ctx)
    assert len(trees) == 1
    d = trees[0].data
    assert d['src_id'] == 5
    assert d['systable_version'] == 52
    assert d['frame_index'] == 0x234
    txt = trees[0].format_text()
    assert 'Uplink SPDU' in txt
    assert 'Auckland' in txt


def test_systable_reference_file():
    st = SysTable(SYSTABLE)
    assert st.version == 52
    assert st.station_name(1) == 'San Francisco, California'
    assert st.station_frequency(1, 0) == 21934.0
    assert st.station_frequency(99, 0) is None
    assert st.station_frequency(1, 99) is None


def test_systable_roundtrip_extras(tmp_path):
    st = SysTable(SYSTABLE)
    assert st.available and len(st.stations) >= 10
    st.stations[1].utc_sync = True
    st.stations[1].master_frame_slots = [0, 3, 1]
    p = tmp_path / 'st.conf'
    assert st.save(str(p))
    st2 = SysTable(str(p))
    assert st2.available and st2.version == st.version
    assert st2.stations[1].utc_sync is True
    assert st2.stations[1].master_frame_slots == [0, 3, 1]
    assert st2.stations[2].frequencies == st.stations[2].frequencies
    assert st2.stations[1].name == st.stations[1].name


def test_cli_text_output(tmp_path):
    """The port's CLI (on the CPU) on a CF32 capture with one frame on each
    of two channels: text output with the system table's station names."""
    fs, center = 48_000, 8_930_000
    chans = [8_912_000, 8_942_000]
    rng = np.random.default_rng(5)
    pdus = [modulator.make_test_mpdu(1, rng, icao=0x4007F5),
            modulator.make_test_mpdu(2, rng, icao=0xA1B2C3)]
    wb = modulator.synthesize_wideband(
        [(pdus[0], 1, chans[0]), (pdus[1], 2, chans[1])],
        fs=fs, centerfreq=center, snr_db=30.0)
    path = tmp_path / 'capture.cf32'
    path.write_bytes(formats.serialize(wb, 'CF32'))
    out = tmp_path / 'out.txt'
    rc = cli.main([
        '--iq-file', str(path),
        '--sample-format', 'CF32',
        '--sample-rate', str(fs),
        '--centerfreq', '8930',
        '--system-table', SYSTABLE,
        '--utc',
        '--output', f'decoded:text:file:path={out}',
    ] + [str(c / 1000) for c in chans], device='cpu')
    assert rc == 0
    text = out.read_text()
    assert 'Downlink LPDU' in text
    assert 'ICAO: 4007F5' in text
    assert 'ICAO: A1B2C3' in text
    assert 'Auckland' in text               # systable name for GS 5
    assert '[8912.0 kHz]' in text
    assert '[8942.0 kHz]' in text
