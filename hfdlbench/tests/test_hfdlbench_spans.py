"""The readers of the program's spans (metrics/ingest.*, receiver.step,
.launch, .sync, events.decode, device.idle_in_receiver_host, app.parse,
app.output) on a synthetic window and synthetic spans with known answers,
and nothing read where the program records no spans."""

import sys
import types

import pytest

from dumphfdl_tpu_torch.utils.profiling import Span
from hfdlbench import spec, trace

RECORDER = 'dumphfdl_tpu_torch.utils.profiling'
MS = 1_000_000                      # ns

# (name, start ms, end ms, id, parent, thread id); the window is [0, 1000)
# ms over 2 s of capture
SPANS = [
    ('ingest.read', -100, 50, 1, None, 2), ('ingest.read', 200, 300, 2,
                                            None, 2),
    ('ingest.upload', 300, 340, 3, None, 2),
    ('ingest.upload', 950, 1050, 4, None, 2),
    ('ingest.wait', 0, 10, 5, None, 1), ('ingest.wait', 500, 520, 6, None, 1),
    ('rx.step', 100, 400, 10, None, 1),
    ('rx.launch', 100, 250, 11, 10, 1),
    ('events.collect', 250, 400, 12, 10, 1),
    ('rx.sync', 260, 300, 13, 12, 1), ('rx.sync', 350, 360, 14, 12, 1),
    ('rx.step', 600, 800, 20, None, 1),
    ('rx.launch', 600, 700, 21, 20, 1),
    ('events.collect', 700, 800, 22, 20, 1),
    ('rx.sync', 700, 780, 23, 22, 1),
    ('rx.sync', 610, 690, 24, None, 2),         # another thread's wait
    ('events.collect', 900, 1100, 30, None, 1),  # the flush's, past t1
    ('rx.sync', 1000, 1050, 31, 30, 1),
    ('app.parse', -5, -2, 40, None, 1), ('app.parse', 420, 421, 41, None, 1),
    ('app.parse', 430, 433, 42, None, 1),
    ('app.parse', 999, 1003, 43, None, 1),
    ('app.output', -1, 1, 44, None, 1), ('app.output', 421, 423, 45, None, 1),
]
DEVICE = [('k', 150, 200), ('k', 320, 330), ('k', 650, 900)]

KNOWN = {
    'ingest.read_ms_per_stream_s': (50 + 100) / 2,
    'ingest.upload_ms_per_stream_s': (40 + 50) / 2,
    'ingest.wait_ms_per_stream_s': (10 + 20) / 2,
    'receiver.step_ms_per_stream_s': (300 + 200) / 2,
    'receiver.launch_ms_per_stream_s': (150 + 100) / 2,
    'receiver.sync_ms_per_stream_s': (40 + 10 + 80 + 80) / 2,
    # the collects' own time less their waits, clipped to the window
    'events.decode_ms_per_stream_s': (150 + 100 + 100 - 40 - 10 - 80) / 2,
    # idle inside [100,260) [300,350) [360,400) [600,700) [780,800)
    'device.idle_in_receiver_host_ms_per_stream_s':
        ((160 - 50) + (50 - 10) + 40 + (100 - 50) + 0) / 2,
    'app.parse_ms_per_frame': (1 + 3 + 4) / 3,
    'app.output_ms_per_frame': 2.0,
}


def window():
    return trace.Window(t0=0, t1=1000 * MS, samples=2 * 216_000, fs=216_000,
                        spans=trace.Spans(),
                        device=[(n, s * MS, e * MS) for n, s, e in DEVICE],
                        frames=[])


def recorder(rows):
    done = [Span(name=n, thread=f't{tid}', start=s * MS, end=e * MS,
                 parent=p, block=-1, n=1, id=i, tid=tid)
            for n, s, e, i, p, tid in rows]
    return types.SimpleNamespace(spans=lambda t0=None, t1=None: [
        s for s in done if s.end > t0 and s.start < t1])


@pytest.mark.parametrize('metric', sorted(KNOWN))
def test_a_span_reader_reads_its_known_answer_and_nothing_without(
        metric, monkeypatch):
    assert metric in {m['name'] for m in spec.load_benchmark()['per_layer']}
    read = spec.reader(metric)
    monkeypatch.setitem(sys.modules, RECORDER, recorder(SPANS))
    assert read(window()) == pytest.approx(KNOWN[metric])
    monkeypatch.setitem(sys.modules, RECORDER, recorder([]))
    assert read(window()) is None
    # a program whose recorder module has no spans, or none at all
    monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace())
    assert read(window()) is None
    monkeypatch.delitem(sys.modules, RECORDER)
    assert read(window()) is None
