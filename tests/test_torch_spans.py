"""PyTorch port: the host spans of utils/profiling.

The recorder on its own (on exactly while a torch profiler runs, nothing
recorded or allocated otherwise, parents and threads, the bound, the
clock against the profiler's kineto events), a whole run_file on the CPU
on the superstep and on the unfused path with every span of the port in
place, the benchmark's span readers on those runs, and the --profile
export.  One test needs the card (marked cuda); this file imports no jax,
so on the GPU machine:

    python -m pytest --noconftest tests/test_torch_spans.py

The decodes run under a CPU profiler whose operator collection is toggled
off: the plain tracker's loop is millions of operator events, and the
spans need only the profiler to be running.
"""

import io
import itertools
import json
import threading
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu_torch.app import AppConfig, HfdlApp  # noqa: E402
from dumphfdl_tpu_torch.dsp import modulator  # noqa: E402
from dumphfdl_tpu_torch.io import formats, ingest  # noqa: E402
from dumphfdl_tpu_torch.io.outputs import OutputManager  # noqa: E402
from dumphfdl_tpu_torch.protocol.enrichment import AcCache, SysTable  # noqa: E402
from dumphfdl_tpu_torch.protocol.runtime import (ProtocolContext,  # noqa: E402
                                                 ProtocolOptions)
from dumphfdl_tpu_torch.utils import profiling  # noqa: E402
from hfdlbench import spec, trace  # noqa: E402
from torch_time_limit import time_limit  # noqa: E402

CPU = torch.profiler.ProfilerActivity.CPU
CUDA = torch.profiler.ProfilerActivity.CUDA
CLOCK_SLACK_NS = 50_000

PORT_SPANS = {'ingest.read', 'ingest.upload', 'ingest.wait', 'rx.step',
              'rx.launch', 'rx.sync', 'events.collect', 'app.parse',
              'app.output'}
READERS = ('ingest.read_ms_per_stream_s', 'ingest.upload_ms_per_stream_s',
           'ingest.wait_ms_per_stream_s', 'receiver.step_ms_per_stream_s',
           'receiver.launch_ms_per_stream_s', 'receiver.sync_ms_per_stream_s',
           'events.decode_ms_per_stream_s',
           'device.idle_in_receiver_host_ms_per_stream_s',
           'app.parse_ms_per_frame', 'app.output_ms_per_frame')


@pytest.fixture(autouse=True)
def no_spans_left():
    profiling.clear()
    yield
    profiling.clear()


def _stream(raw: bytes, chunk_bytes: int) -> list:
    return list(ingest.uploaded_stream(
        ingest.file_chunks(io.BytesIO(raw), 'CS16', chunk_bytes), 'CS16',
        'cpu'))


# ---- the recorder ----

@pytest.mark.parametrize('form', ['with', 'start_stop', 'other_thread'])
def test_torch_sets_the_profiler_flag_the_recorder_reads(form):
    """torch.autograd.profiler._is_profiler_enabled (private) is what
    tells the recorder a profiler runs: set by every start, cleared by
    every stop, one value for all threads."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled
    assert flag() is False and not profiling.recording()
    seen = []
    if form == 'with':
        with torch.profiler.profile(activities=[CPU]):
            seen.append(flag())
    else:
        prof = torch.profiler.profile(activities=[CPU])
        prof.start()
        if form == 'other_thread':
            t = threading.Thread(target=lambda: seen.append(flag()))
            t.start()
            t.join(30)
            assert not t.is_alive()
        else:
            seen.append(flag())
        prof.stop()
    assert seen == [True]
    assert flag() is False and not profiling.recording()


def test_nothing_is_recorded_or_allocated_without_a_profiler():
    raw = np.arange(8000, dtype=np.int16).tobytes()
    assert len(_stream(raw, 4000)) == 4
    assert profiling.spans() == [] and profiling.dropped() == 0
    profiling.end(profiling.begin('warm', 1, 1))
    sites = itertools.repeat(None, 10_000)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in sites:
            profiling.end(profiling.begin('site', 1, 1))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak - base == 0
    assert profiling.spans() == []


def test_recording_turns_on_and_off_with_the_profiler():
    assert profiling.begin('before') is None
    with torch.profiler.profile(activities=[CPU]):
        inside = profiling.begin('inside', 3, 7)
        assert inside is not None
        profiling.end(inside, 9)
        late = profiling.begin('late')
    profiling.end(late)                 # ended after the stop: still kept
    assert profiling.begin('after') is None
    got = profiling.spans()
    assert [(s.name, s.block, s.n) for s in got] == \
        [('inside', 3, 9), ('late', -1, 0)]
    assert all(s.start <= s.end for s in got)
    assert got[0].thread == threading.current_thread().name
    assert got[0].tid == threading.get_native_id()


def test_parents_and_threads_across_the_ingest_threads():
    """file_chunks' reads and the uploads run on the upload thread with no
    parent; the consumer's waits nest in the span open on its thread."""
    raw = np.arange(8200, dtype=np.int16).tobytes()   # 4 chunks and a tail
    with torch.profiler.profile(activities=[CPU]):
        outer = profiling.begin('outer')
        assert len(_stream(raw, 4000)) == 5
        profiling.end(outer)
    got = profiling.spans()
    by = lambda name: [s for s in got if s.name == name]
    (out,) = by('outer')
    reads, uploads, waits = by('ingest.read'), by('ingest.upload'), \
        by('ingest.wait')
    assert [(s.block, s.n) for s in reads] == \
        [(0, 4000), (1, 4000), (2, 4000), (3, 4000), (4, 400)]
    assert [(s.block, s.n) for s in uploads] == \
        [(0, 1000), (1, 1000), (2, 1000), (3, 1000), (4, 100)]
    assert [s.block for s in waits] == [0, 1, 2, 3, 4, 5]  # and the end
    for s in reads + uploads:
        assert s.thread == 'ingest-upload' and s.parent is None
        assert s.tid != out.tid
    for s in waits:
        assert s.thread == out.thread and s.parent == out.id
        assert out.start <= s.start <= s.end <= out.end
    for r, u in zip(reads, uploads):
        assert r.end <= u.start


def test_the_bound_and_the_dropped_count(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, 'limit', 3)
    with torch.profiler.profile(activities=[CPU]):
        for k in range(5):
            profiling.end(profiling.begin('s', k))
    assert [s.block for s in profiling.spans()] == [0, 1, 2]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_a_span_holds_the_kineto_event_inside_it():
    """The span's clock is the kineto events' own: an event the profiler
    records inside a span lies within it (50 us).  (The CPU profiler
    records operators on the thread that started it only.)"""
    x = torch.ones(4096)
    with torch.profiler.profile(activities=[CPU]) as prof:
        for k in range(3):
            sp = profiling.begin('clock', k)
            with torch.profiler.record_function(f'probe{k}'):
                (x * 2.0).sum()
            profiling.end(sp)
    spans = {s.block: s for s in profiling.spans() if s.name == 'clock'}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith('probe')}
    assert len(spans) == len(events) == 3
    for k, s in spans.items():
        e = events[f'probe{k}']
        assert s.start - CLOCK_SLACK_NS <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end + CLOCK_SLACK_NS


# ---- the port's spans on a whole run ----

FS, CENTER = 48_000, 10_000_000
FREQS = [CENTER - 10_000, CENTER + 10_000]
# the superstep at 48 kHz; a block that is no whole number of resampler
# cosets takes the unfused path at the same rate
BLOCKS = {'superstep': 5400, 'unfused': 5403}


@pytest.fixture(scope='module')
def capture(tmp_path_factory):
    """One mode-0 frame on the second of two channels, CS16."""
    rng = np.random.default_rng(3)
    pdu = modulator.make_test_mpdu(0, rng, icao=0x4840D6)
    wb = modulator.synthesize_wideband([(pdu, 0, FREQS[1])], fs=FS,
                                       centerfreq=CENTER, snr_db=30.0,
                                       pad_symbols=60)
    path = tmp_path_factory.mktemp('spans') / 'capture.cs16'
    path.write_bytes(formats.serialize(wb, 'CS16'))
    return path


@pytest.fixture(scope='module')
def runs(capture):
    """run_file on each path under a profiler: its spans, the frames the
    app handled and the stream samples."""
    mp = pytest.MonkeyPatch()
    mp.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
    out = {}
    try:
        for path, block in BLOCKS.items():
            ctx = ProtocolContext(systable=SysTable(None),
                                  ac_cache=AcCache(), ac_data=None,
                                  options=ProtocolOptions())
            app = HfdlApp(AppConfig(frequencies=FREQS, sample_rate=FS,
                                    device='cpu', centerfreq=CENTER,
                                    demod_block_len=block,
                                    sample_format='CS16'),
                          ctx, OutputManager(ctx, hwm=0))
            rx = app.receiver
            assert ('superstep' if rx.engine is not None else
                    'fused' if rx.fused else 'unfused') == path
            frames = []
            handle = app.handle_events
            app.handle_events = lambda evs: (frames.extend(
                e for e in evs if e.pdu is not None), handle(evs))[1]
            profiling.clear()
            with time_limit(300), torch.profiler.profile(
                    activities=[CPU]) as prof:
                prof.toggle_collection_dynamic(False, [CPU])
                assert app.run_file(str(capture), 'CS16') == 0
            got = profiling.spans()
            # the benchmark's readers over the whole run, as a traced
            # window (no device intervals on the CPU)
            w = trace.Window(t0=min(s.start for s in got),
                             t1=max(s.end for s in got) + 1,
                             samples=sum(s.n for s in got
                                         if s.name == 'rx.step'),
                             fs=FS, spans=trace.Spans(), device=[],
                             frames=[])
            out[path] = dict(spans=got, frames=frames,
                             dropped=profiling.dropped(),
                             read={m: spec.reader(m)(w) for m in READERS})
    finally:
        mp.undo()
        profiling.clear()
    return out


@pytest.mark.parametrize('path', list(BLOCKS))
def test_run_file_records_every_span_of_the_port(runs, path):
    run = runs[path]
    got, frames = run['spans'], run['frames']
    assert run['dropped'] == 0
    assert PORT_SPANS <= {s.name for s in got}
    assert len(frames) == 1 and frames[0].fcs_ok
    by_id = {s.id: s for s in got}
    parent = lambda s: by_id[s.parent].name if s.parent is not None \
        else None
    upload = 'ss-upload' if path == 'superstep' else 'ingest-upload'
    for s in got:
        assert s.start <= s.end
        if s.name in ('ingest.read', 'ingest.upload'):
            assert s.thread == upload and s.parent is None
        else:
            assert s.thread == 'MainThread'
        if s.name == 'rx.launch':
            assert parent(s) == 'rx.step'
        elif s.name == 'rx.sync':
            assert parent(s) == 'events.collect'
        elif s.name == 'events.collect':       # flush drains the last
            assert parent(s) in ('rx.step', None)
    # what a receiver call holds: its launches, its waits and the decode
    steps = [s for s in got if s.name == 'rx.step']
    inside = {'rx.launch': 0, 'rx.sync': 0, 'events.collect': 0}
    for s in got:
        if s.name in inside and any(st.start <= s.start and s.end <= st.end
                                    for st in steps):
            inside[s.name] += s.end - s.start
    collect_self = inside['events.collect'] - inside['rx.sync']
    step = sum(s.end - s.start for s in steps)
    assert inside['rx.launch'] + inside['rx.sync'] + collect_self \
        >= 0.9 * step
    # the frames the tables held are the frames the app handled
    assert sum(s.n for s in got if s.name == 'events.collect') == \
        len(frames)
    assert [s.n for s in got if s.name in ('app.parse', 'app.output')] \
        == [1, 1]
    # the stream samples the receiver calls took
    assert sum(s.n for s in steps) >= \
        sum(s.n for s in got if s.name == 'ingest.upload')
    assert not [s for s in got if s.name == 'rx.capture' and s.block > 1]


@pytest.mark.parametrize('metric', READERS)
def test_the_benchmark_reads_each_metric_on_both_paths(runs, metric):
    """Every per-layer reader of the port's spans (hfdlbench/metrics)
    reads a number from each path's run through the recorder."""
    assert metric in {m['name'] for m in spec.load_benchmark()['per_layer']}
    for path, run in runs.items():
        value = run['read'][metric]
        assert value is not None and value >= 0, (path, value)


def test_profile_export_holds_the_spans_on_the_trace_time_base(tmp_path):
    """--profile on a capture without frames (a profiled CPU run records
    every operator): the spans are complete events of the process beside
    the profiler's, and each FFT the channelizer runs lies inside one of
    the receiver's launch spans."""
    from dumphfdl_tpu_torch import cli
    rng = np.random.default_rng(5)
    noise = (rng.standard_normal(48_000) + 1j * rng.standard_normal(48_000)) \
        * 0.01
    cap = tmp_path / 'noise.cs16'
    cap.write_bytes(formats.serialize(noise.astype(np.complex64), 'CS16'))
    out = tmp_path / 'prof'
    with time_limit(120):
        rc = cli.main(['--iq-file', str(cap), '--sample-format', 'CS16',
                       '--sample-rate', '48000', '--centerfreq', '8930',
                       '--profile', str(out),
                       '--output', 'decoded:text:file:path=/dev/null',
                       '8912', '8942'], device='cpu')
    assert rc == 0
    trace = json.loads((out / profiling.TRACE_NAME).read_text())
    events = trace['traceEvents']
    spans = [e for e in events if e.get('cat') == 'dumphfdl_span']
    names = {e['name'] for e in spans}
    assert {'ingest.read', 'ingest.upload', 'ingest.wait', 'rx.step',
            'rx.launch', 'events.collect'} <= names
    assert all(e['ph'] == 'X' and e['dur'] >= 0 for e in spans)
    rows = {e['tid']: e['args']['name'] for e in events
            if e.get('ph') == 'M' and e.get('name') == 'thread_name'}
    upload = {e['tid'] for e in spans if e['name'] == 'ingest.upload'}
    assert len(upload) == 1 and upload.pop() in rows
    main = {e['tid'] for e in spans if e['name'] == 'rx.step'}
    assert len(main) == 1
    tid = main.pop()
    launches = [(e['ts'], e['ts'] + e['dur']) for e in spans
                if e['name'] == 'rx.launch']
    ffts = [e for e in events if e.get('cat') == 'cpu_op'
            and e['tid'] == tid and 'fft' in e['name']]
    assert ffts
    slack = CLOCK_SLACK_NS / 1e3
    for e in ffts:
        assert any(a - slack <= e['ts'] and e['ts'] + e['dur'] <= b + slack
                   for a, b in launches), e


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('activities', [(CUDA,), (CPU, CUDA)],
                         ids=['cuda', 'cpu_cuda'])
def test_a_span_holds_the_k1_kernel_it_launched_and_awaited(cuda,
                                                           activities):
    """A span around one K1 launch and its synchronize() holds the
    kernel's kineto interval, under the harness's profiler (the card's
    activity alone) and under --profile's."""
    from torch.autograd import DeviceType
    from dumphfdl_tpu_torch import constants as C
    from dumphfdl_tpu_torch.ops import fec_cuda
    nbits = C.MODES[3].framebits
    soft = torch.as_tensor(np.random.default_rng(1).integers(
        0, 256, (64, 2 * nbits)).astype(np.uint8), device=cuda)
    fec_cuda.viterbi_decode_many([soft], [nbits])     # build and warm up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=list(activities)) as prof:
        sp = profiling.begin('k1')
        fec_cuda.viterbi_decode_many([soft], [nbits])
        torch.cuda.synchronize()
        profiling.end(sp)
    (span,) = [s for s in profiling.spans() if s.name == 'k1']
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and 'viterbi27_kernel' in e.name()]
    assert len(kernels) == 1
    assert all(span.start <= a and b <= span.end for a, b in kernels), \
        (span, kernels)
