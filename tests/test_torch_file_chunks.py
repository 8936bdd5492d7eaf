"""PyTorch port: the chunk run_file reads off the superstep.

Off the superstep and off a mesh, run_file reads, uploads and hands
WidebandReceiver.process whole overlap-save frames
(WidebandReceiver.file_chunk_samples), so that each call channelizes one
batch of them.  Here: the rule at the 2.16 Msps cell's geometry (no decode),
the superstep's raw chunk left as it was, the frames run_file decodes on the
unfused and the fused path against the same receiver fed the old
320,000-byte reads, one DDC batch of n frames in every call (the
channelizer's counters and the 'rx.launch' span's count), and the
channelizer's fs1 output against a feed of one frame at a time.
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu_torch.app import AppConfig, HfdlApp  # noqa: E402
from dumphfdl_tpu_torch.dsp import modulator  # noqa: E402
from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver  # noqa: E402
from dumphfdl_tpu_torch.io import formats, ingest  # noqa: E402
from dumphfdl_tpu_torch.io.outputs import OutputManager  # noqa: E402
from dumphfdl_tpu_torch.protocol.enrichment import AcCache, SysTable  # noqa: E402
from dumphfdl_tpu_torch.protocol.runtime import (ProtocolContext,  # noqa: E402
                                                 ProtocolOptions)
from dumphfdl_tpu_torch.utils import profiling  # noqa: E402
from torch_time_limit import time_limit  # noqa: E402

CPU = torch.profiler.ProfilerActivity.CPU
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / 'hfdlbench' / 'configs'
OLD_READ_BYTES = 320_000        # the --read-buffer-size default


def _config(name):
    cfg = json.loads((CONFIGS / f'{name}.json').read_text())
    return (cfg['sample_rate'], cfg['centerfreq'],
            [khz * 1000 for khz, _ in cfg['channels']])


# ---- the rule, without decoding ----

@pytest.mark.parametrize('block, frames', [(16200, 8), (5400, 4)])
def test_the_chunk_at_the_2160k_cells_geometry(monkeypatch, block, frames):
    """2.16 Msps with the cell's 24 channels: an FFT of 524,288 with 65,536
    of overlap, so 458,752 new samples a frame; one demod block of 16200
    spans 6,480,000 samples (14.1 frames), of 5400 (the CLI's default)
    2,160,000 (4.7 frames)."""
    monkeypatch.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
    fs, center, freqs = _config('hfdl2160k_2band_cs16')
    rx = WidebandReceiver(fs, center, freqs, 'cpu', block_len=block,
                          sample_format='CS16')
    geo = rx.channelizer.geo
    assert (geo.fft_size, geo.overlap_length, geo.input_size) == \
        (524_288, 65_536, 458_752)
    assert rx.superstep is None and not rx.fused
    assert rx.raw_chunk_bytes is None
    assert rx.channelizer._max_frames >= frames
    assert rx.file_chunk_samples == frames * 458_752
    if block == 16200:
        assert rx.file_chunk_samples == 3_670_016
        assert rx.file_chunk_samples * formats.bytes_per_sample('CS16') \
            == 14_680_064


def test_the_superstep_keeps_its_raw_chunk(monkeypatch):
    """The 3.456 Msps cell's superstep still reads one 1.99-s super-block
    (6,881,280 samples, 27,525,120 CS16 bytes); its receiver's chunk for
    process() follows the same rule as any other's."""
    monkeypatch.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
    fs, center, freqs = _config('hfdl3456k_3band_cs16')
    rx = WidebandReceiver(fs, center, freqs[:4], 'cpu', block_len=16200,
                          sample_format='CS16')
    assert rx.superstep is not None
    assert rx.superstep.plan.wb_chunk == 6_881_280
    assert rx.raw_chunk_bytes == 27_525_120
    assert rx.file_chunk_samples == 16 * rx.channelizer.geo.input_size


@pytest.mark.parametrize('block, frames', [(1, 1), (5403, 4), (16200, 16)])
def test_the_chunk_is_whole_frames_within_one_demod_block(block, frames):
    """At least one frame, else the largest power of two of frames that
    fits in the block's wideband span (48 kHz: 7168 new samples a frame)."""
    rx = WidebandReceiver(48_000, 10_000_000, [10_010_000], 'cpu',
                          block_len=3 * -(-block // 3))
    step = rx.channelizer.geo.input_size
    assert step == 7168
    assert rx.file_chunk_samples == frames * step
    span = rx.block_len * 48_000 / 5400
    assert frames == 1 or (frames * step <= span < 2 * frames * step)


# ---- whole decodes on the CPU ----

FS, CENTER = 48_000, 10_000_000
FREQS = [CENTER - 10_000, CENTER + 10_000]
# 5403 is no whole number of the resampler's cosets at 48 kHz: unfused;
# 5400 is, and with the superstep off takes the fused step
PATHS = {'unfused': (5403, '0'), 'fused': (5400, '1')}


@pytest.fixture(scope='module')
def capture(tmp_path_factory):
    """A mode-0 frame on the second channel and a mode-2 frame on the
    first, CS16: about five chunks of four frames."""
    rng = np.random.default_rng(7)
    wb = modulator.synthesize_wideband(
        [(modulator.make_test_mpdu(0, rng, icao=0x4840D6), 0, FREQS[1]),
         (modulator.make_test_mpdu(2, rng, icao=0xABCDEF), 2, FREQS[0])],
        fs=FS, centerfreq=CENTER, snr_db=30.0, pad_symbols=60)
    path = tmp_path_factory.mktemp('chunks') / 'capture.cs16'
    path.write_bytes(formats.serialize(wb, 'CS16'))
    return path


def _frames(events):
    return [(e.channel, e.mode, e.fcs_ok, e.start_symbol, e.train_bad,
             e.pdu) for e in events if e.pdu is not None]


@pytest.fixture(scope='module')
def decodes(capture):
    """Per path: run_file under a profiler (its frames, each receiver
    call's samples and channelizer counts, the spans), and the old reads'
    frames."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for path, (block, no_superstep) in PATHS.items():
            mp.setenv('DUMPHFDL_NO_SUPERSTEP', no_superstep)
            ctx = ProtocolContext(systable=SysTable(None),
                                  ac_cache=AcCache(), ac_data=None,
                                  options=ProtocolOptions())
            app = HfdlApp(AppConfig(frequencies=FREQS, sample_rate=FS,
                                    device='cpu', centerfreq=CENTER,
                                    demod_block_len=block,
                                    sample_format='CS16'),
                          ctx, OutputManager(ctx, hwm=0))
            rx = app.receiver
            assert ('fused' if rx.fused else 'unfused') == path
            assert rx.engine is None
            events, calls, flushed_at = [], [], []
            handle = app.handle_events
            app.handle_events = lambda evs: (events.extend(evs),
                                             handle(evs))[1]
            chz, process, flush = rx.channelizer, rx.process, rx.flush

            def counted(x, chz=chz, process=process, calls=calls):
                b, f = chz.ddc_batches, chz.ddc_frames_run
                got = process(x)
                calls.append((len(x), chz.ddc_batches - b,
                              chz.ddc_frames_run - f))
                return got

            rx.process = counted
            rx.flush = lambda calls=calls, flushed_at=flushed_at, \
                flush=flush: (flushed_at.append(len(calls)), flush())[1]
            profiling.clear()
            with time_limit(300), torch.profiler.profile(
                    activities=[CPU]) as prof:
                prof.toggle_collection_dynamic(False, [CPU])
                assert app.run_file(str(capture), 'CS16') == 0
            spans = profiling.spans()
            profiling.clear()

            ref = WidebandReceiver(FS, CENTER, FREQS, 'cpu', block_len=block,
                                   sample_format='CS16')
            assert ref.fused == rx.fused and ref.engine is None
            old = []
            with time_limit(300), open(capture, 'rb') as fh:
                for x in ingest.uploaded_stream(ingest.file_chunks(
                        fh, 'CS16', OLD_READ_BYTES), 'CS16', 'cpu'):
                    old.extend(ref.process(x))
                old.extend(ref.flush())
            out[path] = dict(frames=_frames(events), old=_frames(old),
                             calls=calls, file_calls=flushed_at[0],
                             chunk=rx.file_chunk_samples,
                             step=chz.geo.input_size, spans=spans)
    finally:
        mp.undo()
        profiling.clear()
    return out


@pytest.mark.parametrize('path', list(PATHS))
def test_run_file_decodes_what_the_old_reads_decode(decodes, capture, path):
    run = decodes[path]
    frames = run['frames']
    assert frames == run['old']
    assert sorted((ch, mode, ok) for ch, mode, ok, *_ in frames) == \
        [(0, 2, True), (1, 0, True)]
    # the file took several calls of whole frames and a shorter last one
    samples = len(capture.read_bytes()) // 4
    assert run['chunk'] == 4 * run['step']
    assert run['file_calls'] == -(-samples // run['chunk']) >= 3


@pytest.mark.parametrize('path', list(PATHS))
def test_every_call_channelizes_one_batch_of_n_frames(decodes, path):
    """Every receiver call of the file but the last: its chunk, one DDC
    batch, n frames; the last channelizes what whole frames it holds.  The
    channelizer's 'rx.launch' (the first in each 'rx.step') carries the
    frames the counters saw, on the flush's calls too."""
    run = decodes[path]
    calls, n_file, chunk = run['calls'], run['file_calls'], run['chunk']
    n = chunk // run['step']
    assert calls[:n_file - 1] == [(chunk, 1, n)] * (n_file - 1)
    last, batches, frames = calls[n_file - 1]
    assert 0 < last <= chunk
    assert frames == last // run['step']
    assert batches == bin(frames).count('1')
    spans = run['spans']
    steps = sorted((s for s in spans if s.name == 'rx.step'),
                   key=lambda s: s.start)
    assert len(steps) == len(calls)
    launches = {}
    for s in sorted(spans, key=lambda s: s.start):
        if s.name == 'rx.launch':
            launches.setdefault(s.parent, s)
    assert [launches[st.id].n for st in steps] == [c[2] for c in calls]
    assert [st.n for st in steps] == [c[0] for c in calls]


# ---- the channelizer's numbers ----

@pytest.mark.parametrize('fs, block', [(48_000, 5403), (192_000, 16200)])
def test_batched_frames_match_one_frame_at_a_time(fs, block):
    """The fs1 samples of chunks of n frames (one DDC batch each) against
    the same samples fed one frame at a time: within 2e-5 of the peak."""
    freqs = [CENTER - 30_000, CENTER - 2_000, CENTER + 25_000]
    rxs = [WidebandReceiver(fs, CENTER, freqs, 'cpu', block_len=block)
           for _ in range(2)]
    chunk = rxs[0].file_chunk_samples
    step = rxs[0].channelizer.geo.input_size
    n = chunk // step
    assert n >= 4
    rng = np.random.default_rng(11)
    x = ((rng.standard_normal(5 * chunk)
          + 1j * rng.standard_normal(5 * chunk)) * 0.2).astype(np.complex64)
    outs = []
    for rx, size in zip(rxs, (chunk, step)):
        chz, got = rx.channelizer, []
        chz._append_fs1 = lambda c, got=got: got.append(c.clone())
        for i in range(0, len(x), size):
            chz.ingest(x[i:i + size])
            chz.channelize_available()
        outs.append(torch.cat(got, dim=1).numpy())
    batched, single = (rx.channelizer for rx in rxs)
    assert (batched.ddc_batches, batched.ddc_frames_run) == (5, 5 * n)
    assert (single.ddc_batches, single.ddc_frames_run) == (5 * n, 5 * n)
    want = outs[1]
    assert outs[0].shape == want.shape == \
        (len(freqs), 5 * n * batched.geo.post_input_size)
    np.testing.assert_allclose(outs[0], want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
