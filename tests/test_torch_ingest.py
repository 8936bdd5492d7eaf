"""PyTorch port, io/ingest, utils/prefetch, io/soapy_input and the app's
live paths: the conversions on the device bit-equal to the host converters,
chunking and the stream ring as the JAX package's (tests/test_ingest.py),
the SoapySDR input's copy against a fake module (tests/test_soapy.py), and
run_stream / run_stream_raw decoding what run_file decodes."""

import functools
import io as io_mod
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu.io import ingest as jingest  # noqa: E402
from dumphfdl_tpu.utils.xfer import device_get  # noqa: E402
from dumphfdl_tpu_torch import constants as C  # noqa: E402
from dumphfdl_tpu_torch.app import AppConfig, HfdlApp  # noqa: E402
from dumphfdl_tpu_torch.dsp import modulator  # noqa: E402
from dumphfdl_tpu_torch.io import formats, ingest  # noqa: E402
from dumphfdl_tpu_torch.io.outputs import OutputManager  # noqa: E402
from dumphfdl_tpu_torch.io.soapy_input import (  # noqa: E402
    SOAPY_READ_ERROR_LIMIT, SoapyInput)
from dumphfdl_tpu_torch.protocol.enrichment import AcCache, SysTable  # noqa: E402
from dumphfdl_tpu_torch.protocol.runtime import (  # noqa: E402
    ProtocolContext, ProtocolOptions)
from dumphfdl_tpu_torch.utils import prefetch  # noqa: E402
from test_soapy import fake_soapy  # noqa: E402,F401  (the fake SoapySDR module)


def within(seconds):
    """The test's own time limit: its body runs in a thread that is given
    up (and the test failed) when it is still running after `seconds`."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            box = {}

            def body():
                try:
                    fn(*args, **kw)
                except BaseException as e:
                    box['exc'] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f'still running after {seconds} s')
            if 'exc' in box:
                raise box['exc']
        return run
    return deco


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize('fmt', ['CU8', 'CS16', 'CF32'])
def test_upload_matches_host_convert(fmt):
    """upload() converts on the device, bit for bit what formats.convert
    gives on the host (CS16: a float32 product with 1/32767.5; CU8: a
    table of the 256 quotients), and within 1 ULP of the JAX upload."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)) \
        .astype(np.complex64) * 0.3
    raw = formats.serialize(x, fmt)
    want = formats.convert(raw, fmt)
    got = ingest.upload(raw, fmt, 'cpu')
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_allclose(got.numpy(),
                               device_get(jingest.upload(raw, fmt)),
                               rtol=3e-7, atol=1e-9)


def test_upload_cs16_extremes():
    raw = np.asarray([-32768, 32767, 0, -1, 1, -32768], np.int16)
    want = formats.convert(raw.tobytes(), 'CS16')
    for given in (raw.tobytes(), raw, raw.view(np.uint8)):
        got = ingest.upload(given, 'CS16', 'cpu').numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_upload_cu8_all_bytes_and_odd_sample_count():
    raw = bytes(range(256)) + bytes(range(10))    # 133 samples, 266 bytes
    want = formats.convert(raw, 'CU8')
    got = ingest.upload(raw, 'CU8', 'cpu').numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    odd = ingest.upload(bytes(range(11)), 'CU8', 'cpu')   # half a sample over
    assert odd.shape == (5,)


def test_upload_refuses_unknown_formats():
    with pytest.raises(ValueError, match='unknown sample format'):
        ingest.upload(b'\0' * 8, 'CS8', 'cpu')
    with pytest.raises(ValueError, match='given as'):
        ingest.upload(np.zeros(4, np.float64), 'CS16', 'cpu')


def test_put_quantized_is_cs16_precision():
    rng = np.random.default_rng(1)
    x = ((rng.standard_normal(500) + 1j * rng.standard_normal(500)) * 0.2) \
        .astype(np.complex64)
    x[:2] = [2.0 - 2.0j, 1.0 + 0.5j]              # clipped to full scale
    got = ingest.put_quantized(x, 'cpu').numpy()
    assert got.dtype == np.complex64 and got.shape == x.shape
    np.testing.assert_allclose(got[2:], x[2:], atol=0.75 / 32767)
    np.testing.assert_allclose(got[0], 1.0 - 32768 / 32767 * 1j, rtol=1e-6)


class ShortReadFile:
    """File-like object that returns at most 7 bytes per read."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read(self, n: int) -> bytes:
        take = min(n, 7, len(self._data) - self._pos)
        out = self._data[self._pos:self._pos + take]
        self._pos += take
        return out


@pytest.mark.parametrize('fmt,chunk,pad', [
    ('CS16', 256, False), ('CS16', 250, True), ('CU8', 64, True),
    ('CF32', 100, False), ('CU8', 96, False)])
def test_file_chunks_match_jax(fmt, chunk, pad):
    """Short reads accumulate, a trailing partial sample is dropped, and
    pad_final fills the last chunk with the format's silence byte: chunk
    for chunk what the JAX package's chunker yields."""
    data = bytes(range(256)) * 4 + b'\x01\x02\x03'
    got = list(ingest.file_chunks(ShortReadFile(data), fmt, chunk,
                                  pad_final=pad))
    want = list(jingest.file_chunks(ShortReadFile(data), fmt, chunk,
                                    pad_final=pad))
    assert [c.tobytes() for c in got] == [c.tobytes() for c in want]
    if pad:
        assert len({len(c) for c in got}) == 1
        assert got[-1][-1] == formats.silence_byte(fmt)


def test_file_chunks_stop_event():
    stop = threading.Event()
    it = ingest.file_chunks(io_mod.BytesIO(bytes(4096)), 'CS16', 64,
                            stop=stop)
    next(it)
    stop.set()
    assert list(it) == []


@pytest.mark.parametrize('packed', [False, True])
def test_uploaded_stream_order_and_error(packed):
    blocks = [np.full(64, i / 8, np.complex64) for i in range(5)]

    def bad():
        yield from blocks
        raise RuntimeError('source died')

    it = ingest.uploaded_stream(iter(blocks), 'CF32', 'cpu', depth=2,
                                packed=packed)
    vals = [round(float(b[0].real) * 8) for b in it]
    assert vals == [0, 1, 2, 3, 4]
    it = ingest.uploaded_stream(bad(), 'CF32', 'cpu', depth=2, packed=packed)
    with pytest.raises(RuntimeError, match='source died'):
        for _ in it:
            pass


@pytest.mark.parametrize('packed', [False, True])
def test_device_prefetch_order_and_error(packed):
    blocks = [np.full((2, 8), i / 8, np.complex64) for i in range(4)]
    out = list(prefetch.device_prefetch(iter(blocks), 'cpu', depth=1,
                                        packed=packed))
    assert [b.shape for b in out] == [(2, 8)] * 4
    assert [round(float(b[0, 0].real) * 8) for b in out] == [0, 1, 2, 3]

    def bad():
        yield blocks[0]
        raise OSError('link down')

    with pytest.raises(OSError, match='link down'):
        list(prefetch.device_prefetch(bad(), 'cpu', packed=packed))


@within(60)
def test_ahead_applies_put_in_order():
    seen = []
    out = list(prefetch.ahead(range(6), lambda v: seen.append(v) or v * v,
                              depth=2))
    assert out == [0, 1, 4, 9, 16, 25] and seen == list(range(6))


@within(60)
def test_stream_ingest_blocks_and_tail_padding():
    chunks = [np.arange(i * 100, i * 100 + 100).astype(np.complex64)
              for i in range(5)]                # 500 samples total
    src = ingest.StreamIngest(iter(chunks), block_samples=128)
    out = list(src.blocks())
    assert [len(b) for b in out] == [128, 128, 128, 128]
    flat = np.concatenate(out)
    np.testing.assert_array_equal(flat[:500].real, np.arange(500))
    np.testing.assert_array_equal(flat[500:], np.zeros(12, np.complex64))
    assert src.overruns == 0


@within(60)
def test_stream_ingest_error_propagates():
    def bad():
        yield np.zeros(10, np.complex64)
        raise ValueError('sdr gone')

    src = ingest.StreamIngest(bad(), block_samples=16)
    with pytest.raises(ValueError, match='sdr gone'):
        list(src.blocks())


@within(60)
def test_stream_ingest_stop_event():
    stop = threading.Event()

    def endless():
        while True:
            yield np.zeros(64, np.complex64)
            time.sleep(0.001)

    src = ingest.StreamIngest(endless(), block_samples=64, stop=stop)
    it = src.blocks()
    next(it)
    stop.set()
    # must terminate (remaining buffered blocks then StopIteration)
    n = sum(1 for _ in it)
    assert n <= src.ring.overruns + 16


@within(60)
def test_stream_ingest_counts_overruns():
    """A ring smaller than what the source delivers before anyone reads:
    the excess is counted, not blocked on."""
    src = ingest.StreamIngest(iter([np.ones(100, np.complex64)] * 3),
                              block_samples=64, ring_capacity=128)
    src._thread.join(10)
    assert src.overruns >= 300 - 129
    assert sum(len(b) for b in src.blocks()) <= 128


# ---- the SoapySDR input's copy (tests/test_soapy.py's five cases) ----

def _soapy(**kw):
    return SoapyInput(device='driver=fake', sample_rate=250_000,
                      centerfreq=10_000_000, **kw)


def test_soapy_native_format_negotiation_and_full_scale(fake_soapy):  # noqa: F811
    src = _soapy()
    src.connect()
    assert src.negotiated_format == 'CS16'
    assert src.full_scale == 2047.0
    assert src.is_integer_format
    dev = fake_soapy[0]
    names = [c[0] for c in dev.calls]
    assert 'setDCOffsetMode' in names           # input-soapysdr.c:111-115
    assert ('setGainMode', (1, 0, True)) in dev.calls   # AGC default


def test_soapy_fallback_format_when_native_unsupported(fake_soapy):  # noqa: F811
    src = _soapy()
    import SoapySDR
    orig = SoapySDR.Device

    def make(args):
        dev = orig(args)
        dev.native = ('CS8', 127.0)            # not in the supported set
        dev.formats = ['CS8', 'CU8', 'CF32']
        return dev

    SoapySDR.Device = make
    src.connect()
    assert src.negotiated_format == 'CU8'      # first supported in the list
    assert src.full_scale == 127.0


def test_soapy_stream_converts_with_device_full_scale(fake_soapy):  # noqa: F811
    src = _soapy(buffer_samples=4)
    src.connect()
    dev = fake_soapy[0]
    raw = np.asarray([2047, 0, -2047, 1024, 0, -1024, 2047, -2047], np.int16)
    dev.reads = [raw, -1]                       # one good read, then stop
    chunk = next(src.stream())
    assert chunk.dtype == np.complex64
    s = 1024 / 2047
    np.testing.assert_allclose(
        chunk, np.asarray([1 + 0j, -1 + s * 1j, -s * 1j, 1 - 1j],
                          np.complex64), rtol=1e-6)


def test_soapy_exit_after_read_error_limit(fake_soapy):  # noqa: F811
    src = _soapy(buffer_samples=4)
    src.connect()
    dev = fake_soapy[0]
    dev.reads = [-1] * SOAPY_READ_ERROR_LIMIT
    with pytest.raises(SystemExit) as ei:
        for _ in src.stream():
            pass
    assert ei.value.code == 1                   # nonzero for systemd restart
    names = [c[0] for c in dev.calls]
    assert 'deactivateStream' in names and 'closeStream' in names


def test_soapy_forced_format_skips_negotiation(fake_soapy):  # noqa: F811
    src = _soapy(sample_format='CF32')
    src.connect()
    assert src.negotiated_format == 'CF32'
    assert src.full_scale == 1.0
    assert not src.is_integer_format


def test_cli_runs_a_soapysdr_stream(fake_soapy, monkeypatch):  # noqa: F811
    """--soapysdr through the port's CLI: the device is opened with the
    flags' settings and its stream is what HfdlApp.run_stream gets, at
    CS16 precision for an integer-native device."""
    from dumphfdl_tpu_torch import cli
    seen = {}

    def run_stream(self, sample_iter, packed=False):
        seen.update(packed=packed, first=next(iter(sample_iter)))
        return 0

    monkeypatch.setattr(HfdlApp, 'run_stream', run_stream)
    import SoapySDR
    orig = SoapySDR.Device

    def make(args):
        dev = orig(args)
        dev.reads = [np.zeros(8, np.int16)] + [-1] * SOAPY_READ_ERROR_LIMIT
        return dev

    SoapySDR.Device = make
    rc = cli.main(['--soapysdr', 'driver=fake', '--sample-rate', '48000',
                   '--gain', '30', '--antenna', 'RX2',
                   '--output', 'decoded:text:file:path=/dev/null',
                   '8912', '8942'], device='cpu')
    assert rc == 0 and seen['packed'] is True
    assert seen['first'].dtype == np.complex64 and len(seen['first']) == 4
    calls = fake_soapy[0].calls
    assert ('setAntenna', (1, 0, 'RX2')) in calls
    assert ('setGain', (1, 0, 30.0)) in calls
    assert ('setFrequency', (1, 0, 8_927_000.0)) in calls


# ---- the app's live paths against its file path ----

FS, CENTER = 192_000, 10_000_000
FREQS = [CENTER - 20_000, CENTER + 20_000]


@pytest.fixture(scope='module')
def capture():
    """One mode-2 frame on the second of two channels at 192 kHz (where the
    superstep aligns: 143360 wideband samples per block), CS16."""
    rng = np.random.default_rng(3)
    pdu = modulator.make_test_mpdu(2, rng, icao=0x4840D6)
    wb = modulator.synthesize_wideband([(pdu, 2, FREQS[1])], fs=FS,
                                       centerfreq=CENTER, snr_db=30.0,
                                       pad_symbols=60)
    return pdu, formats.serialize(wb, 'CS16')


def _app(fmt, monkeypatch, block=5400, superstep=True, **cfg):
    if superstep:
        monkeypatch.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
    else:
        monkeypatch.setenv('DUMPHFDL_NO_SUPERSTEP', '1')
    ctx = ProtocolContext(systable=SysTable(None), ac_cache=AcCache(),
                          ac_data=None, options=ProtocolOptions())
    app = HfdlApp(AppConfig(frequencies=FREQS, sample_rate=FS, device='cpu',
                            centerfreq=CENTER, demod_block_len=block,
                            sample_format=fmt, **cfg),
                  ctx, OutputManager(ctx, hwm=0))
    events = []
    handle = app.handle_events
    app.handle_events = lambda evs: (events.extend(evs), handle(evs))[1]
    return app, events


def _frames(events):
    return [(e.channel, e.mode, e.fcs_ok, e.start_symbol, e.train_bad,
             e.pdu) for e in events if e.pdu]


@pytest.fixture(scope='module')
def file_frames(capture, tmp_path_factory):
    """What run_file decodes from the capture on the superstep path."""
    mp = pytest.MonkeyPatch()
    try:
        app, events = _app('CS16', mp)
        path = tmp_path_factory.mktemp('cap') / 'capture.cs16'
        path.write_bytes(capture[1])
        assert app.receiver.superstep is not None
        assert app.run_file(str(path), 'CS16') == 0
        return _frames(events), app.receiver.superstep.blocks_done
    finally:
        mp.undo()


def test_run_file_takes_the_superstep(capture, file_frames):
    frames, blocks = file_frames
    assert frames == [(1, 2, True, frames[0][3], frames[0][4], capture[0])]
    assert blocks >= -(-len(capture[1]) // (143_360 * 4))


@within(600)
def test_run_stream_decodes_what_run_file_decodes(capture, file_frames,
                                                  monkeypatch):
    """65536-sample complex64 chunks through the ring and the superstep at
    CS16 precision, then the receiver's flush: the same frames, same
    symbol clock, no overrun."""
    app, events = _app('CS16', monkeypatch)
    x = formats.convert(capture[1], 'CS16')
    chunks = (x[o:o + 65_536] for o in range(0, len(x), 65_536))
    assert app.run_stream(chunks) == 0
    app.handle_events(app.receiver.flush())
    assert app.receiver.superstep.blocks_done > 0
    assert _frames(events) == file_frames[0]
    assert app.last_ingest_overruns == 0


@within(600)
def test_run_stream_raw_decodes_what_run_file_decodes(capture, file_frames,
                                                      monkeypatch):
    """Raw CS16 buffers of an odd size, re-chunked to the super-block
    without a float conversion on the host."""
    app, events = _app('CS16', monkeypatch)
    raw = capture[1]
    bufs = (raw[o:o + 100_004] for o in range(0, len(raw), 100_004))
    assert app.run_stream_raw(bufs, 'CS16') == 0
    app.handle_events(app.receiver.flush())
    assert _frames(events) == file_frames[0]
    assert app.last_ingest_overruns == 0


@within(600)
def test_run_stream_without_superstep(capture, file_frames, monkeypatch):
    """With the superstep off run_stream_raw converts on the host and the
    stream takes the fused path in blocks of stream_chunk_samples (the
    ring, four blocks, holds this whole capture: the source is no
    real-time one): the same bytes at another symbol clock, since the
    superstep's runs one block late, which _metadata_for takes off."""
    app, events = _app('CS16', monkeypatch, superstep=False,
                       stream_chunk_samples=262_144)
    assert app.receiver.superstep is None and app.receiver.fused
    raw = capture[1]
    bufs = (raw[o:o + 80_000] for o in range(0, len(raw), 80_000))
    assert app.run_stream_raw(bufs, 'CS16') == 0
    app.handle_events(app.receiver.flush())
    got, want = _frames(events), file_frames[0]
    assert [f[:3] + f[5:] for f in got] == [f[:3] + f[5:] for f in want]
    delay = 4032 // C.SPS
    assert got[0][3] == want[0][3] - delay
    ss_app, _ = _app('CS16', monkeypatch)
    ev = [e for e in events if e.pdu][0]
    assert ss_app._metadata_for(ev._replace(start_symbol=want[0][3])) \
        .rx_timestamp - ss_app.stream_epoch == pytest.approx(
            (want[0][3] - delay) / C.SYMBOL_RATE, abs=1e-5)
