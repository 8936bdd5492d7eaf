"""BENCHMARK.json against the contract's shape, every part found by name,
a throwaway entry found without editing a file, and the frozen work
counts of the two roofline metrics."""

import json
import re
import shutil

import pytest

from hfdlbench import roofline, spec, trace

BENCH = spec.load_benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_contract_shape():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    names = [c['name'] for c in BENCH['configs']] \
        + [w['name'] for w in BENCH['workloads']] \
        + [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('hfdlbench/') and c['reduced'] == []
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
    e2e = {m['name'] for m in BENCH['end_to_end']}
    assert e2e == {'rt_factor', 'setup_s'}
    for m in BENCH['end_to_end']:
        assert UNIT.match(m['unit']) and m['source'] in ('host_clock',
                                                         'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['moves'] in e2e
        for w in m['workloads']:        # each cell reports what it moves
            cell = spec.cell(w)
            assert m['moves'] in {x['name'] for x in cell.end_to_end}
    for w in BENCH['workloads']:
        cell = spec.cell(w['name'])
        assert 'setup_s' in {m['name'] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_every_part_is_found_by_name(cell):
    c = spec.cell(cell)
    assert c.config['path'] in ('superstep', 'unfused')
    assert c.mix['frames'] in ('squitter', 'every_slot')
    for m in c.per_layer:
        assert callable(spec.reader(m['name']))


def test_a_new_entry_needs_only_new_files(tmp_path):
    """A later change adds a configuration, a mix and a metric as files
    and entries; the harness finds them with no file of it edited."""
    root = tmp_path / 'checkout'
    shutil.copytree(spec.HERE, root / 'hfdlbench')
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((spec.HERE / 'configs/hfdl2160k_2band_cs16.json')
                     .read_text())
    cfg['name'] = 'wb256_1080k_cs16'
    (root / 'hfdlbench/configs/wb256_1080k_cs16.json').write_text(
        json.dumps(cfg))
    (root / 'hfdlbench/traffic/quiet.json').write_text(json.dumps(
        dict(frames='squitter', slots=26, modes=[0], snr_db=[20.0, 20.0],
             delay_ms=[5.0, 5.0], warm_s=5.0, trace_seconds=3.0)))
    (root / 'hfdlbench/metrics/throwaway.frames.py').write_text(
        'def read(w):\n    return float(len(w.frames)) or None\n')
    bench['configs'].append(dict(name='wb256_1080k_cs16', source='s',
                                 file='hfdlbench/configs/'
                                 'wb256_1080k_cs16.json', reduced=[],
                                 why='w'))
    bench['workloads'].append(dict(name='wb256_1080k.quiet',
                                   config='wb256_1080k_cs16',
                                   traffic='quiet', chips=1, why='w'))
    bench['per_layer'].append(dict(name='throwaway.frames', unit='x',
                                   better='higher', source='host_clock',
                                   layer='app', moves='rt_factor',
                                   workloads=['wb256_1080k.quiet']))
    for m in bench['end_to_end']:
        if m['name'] == 'rt_factor':
            m['workloads'].append('wb256_1080k.quiet')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    cell = spec.cell('wb256_1080k.quiet', root=root)
    assert cell.config['name'] == 'wb256_1080k_cs16'
    assert cell.mix['slots'] == 26
    assert [m['name'] for m in cell.per_layer] == ['throwaway.frames']
    w = trace.Window(t0=0, t1=1, samples=1, fs=1, spans=trace.Spans(),
                     device=[], frames=[(0, 1)])
    assert spec.reader('throwaway.frames', root=root)(w) == 1.0


def window(frames=(), device=()):
    return trace.Window(t0=0, t1=10**9, samples=3_456_000, fs=3_456_000,
                        spans=trace.Spans(), device=list(device),
                        frames=list(frames))


@pytest.mark.parametrize('metric', [m['name'] for m in BENCH['per_layer']])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    w = trace.Window(t0=0, t1=0, samples=0, fs=1, spans=trace.Spans(),
                     device=[], frames=[])
    assert spec.reader(metric)(w) is None


@pytest.mark.parametrize('metric,kernel', [
    ('k1_viterbi_roofline', 'viterbi27_kernel'),
    ('k2_tracker_roofline', 'void tracker_kernel<false>(int const*)')])
def test_work_counts_depend_on_shapes_only(metric, kernel):
    """The count is a function of the frames' modes alone: the same
    frames in another order, on other channels, give the same work, and
    the share follows the kernel time, not the program."""
    mod = spec.reader(metric).__globals__
    frames = [(0, 0), (64, 1), (128, 2), (192, 3)] * 3
    again = [(c + 1, m) for c, m in reversed(frames)]
    assert mod['work'](m for _, m in frames) == mod['work'](
        m for _, m in again)
    assert mod['work']([]) == (0, 0)
    one = [mod['work']([m]) for m in range(4)]
    assert sum(b for b, _ in one) * 3 == mod['work'](
        m for _, m in frames)[0]
    name = kernel if 'tracker' in metric else f'void {kernel}(Groups)'
    w1 = window(frames, [(name, 0, 10**6)])
    w2 = window(again, [(name, 0, 2 * 10**6), ('elementwise', 0, 10**6)])
    r1, r2 = spec.reader(metric)(w1), spec.reader(metric)(w2)
    assert r1 == pytest.approx(2 * r2) and 0 < r1 < 100
    b, o = mod['work'](m for _, m in frames)
    assert r1 == pytest.approx(100 * roofline.least_s(b, o) / 1e-3)


def test_k1_and_k2_counts_by_hand():
    k1 = spec.reader('k1_viterbi_roofline').__globals__
    # mode 3: 6480 soft bytes in, 405 PDU bytes out, 3240 bits x 265
    assert k1['work']([3]) == (6480 + 405, 3240 * 265)
    k2 = spec.reader('k2_tracker_roofline').__globals__
    assert k2['work']([0, 1]) == (2 * 4219 * 32, 2 * 4219 * 436)
