"""PyTorch port: the bench entry points (tools/bench.py, the twin of
bench.py, and tools/bench_scaling.py, the twin of extras/bench_scaling*.py)
on the CPU.

* A rung of the ladder against bench.py's own end-to-end child at 8
  channels (so every channel emits), WARM=1 and PASSES=1, at two rates:
  216 ksps in CS16, where both take the superstep, and 2.16 Msps in CU8,
  the first card rung's rate, on the unfused path at block 16200.  Every
  frames_* field, coverage_ok and superstep equal exactly.  The four
  processes (two JAX children, two of the port's rung children) run at
  once.
* The ladder's rules with the rung runner stubbed: it stops after the first
  rung below real time, the headline is the widest rung real-time with
  coverage_ok, a failing child is recorded with its reason and main exits
  1, without CUDA and without --device both tools raise, and
  bench.faults excuses only a rung's size (its watchdog, CUDA out of
  memory) and holds every measured rung's ledger exact.
* demod_only at 16 channels on noise.
* The scaling twin with N = 1 and 2 gloo processes of CPU shards at the
  JAX script's CPU size (8 channels and 108 ksps per shard), started with
  the four rung processes: the decoded PDU set equal to the emitted one at
  both N and to the port's single-device receiver's, the bytes between
  shards equal to comm_model()'s.
"""

import concurrent.futures
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench as jax_bench  # noqa: E402

from dumphfdl_tpu_torch.tools import bench, bench_scaling  # noqa: E402
from torch_time_limit import time_limit  # noqa: E402

NCH = 8
RUNGS = {'216k_cs16': (216_000, 'CS16'), '2160k_cu8': (2_160_000, 'CU8')}
CHILD_S = 600           # each child's own limit


@pytest.fixture(autouse=True)
def _limit():
    """Every test's own limit; the slow parts set their own inside."""
    with time_limit(CHILD_S):
        yield


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both rungs through bench.py's child and the port's rung child, and
    the scaling twin's main over 1 and 2 processes, all started together;
    futures by (side, rung), and 'scaling': (exit code, its JSON)."""
    cache = tmp_path_factory.mktemp('jax_cache')
    out = tmp_path_factory.mktemp('scaling') / 'scaling.json'

    def scaling():
        rc = bench_scaling.main(['--device', 'cpu', '--devices', '2',
                                 '--fs-per-device', '108000',
                                 '--channels-per-device', '8',
                                 '--out', str(out)])
        return rc, json.loads(out.read_text())

    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(5) as pool:
        mp.setenv('OMP_NUM_THREADS', '1')
        runs = {'scaling': pool.submit(scaling)}
        for name, (fs, fmt) in RUNGS.items():
            runs['jax', name] = pool.submit(
                jax_bench.run_child, jax_bench._E2E_CHILD, 'e2e_rt_channels',
                force_cpu=True, timeout=CHILD_S, extra_env={
                    'BENCH_E2E_CHANNELS': str(NCH), 'BENCH_E2E_FS': str(fs),
                    'BENCH_E2E_FMT': fmt, 'BENCH_E2E_PASSES': '1',
                    'BENCH_E2E_WARM': '1',
                    'JAX_COMPILATION_CACHE_DIR': str(cache)})
            runs['port', name] = pool.submit(
                bench.rung_child, NCH, fs, fmt, device='cpu', warm=1,
                passes=1, block=bench.DEFAULT_BLOCK, check_kernels=False)
        yield runs


@pytest.mark.parametrize('rung', list(RUNGS))
def test_rung_ledger_equals_bench_py(rung, runs):
    with time_limit(CHILD_S):
        want = runs['jax', rung].result()
        got, why = runs['port', rung].result()
    assert want is not None, jax_bench.FAILURES
    assert got is not None, why
    keys = [k for k in want if k.startswith('frames_')] \
        + ['coverage_ok', 'superstep']
    assert len(keys) == 10
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    superstep = rung == '216k_cs16'
    assert want['superstep'] is superstep
    assert got['path'] == ('superstep' if superstep else 'unfused')
    # every channel emits once per pass, two passes
    assert got['frames_ok'] == got['frames_expected_total'] == 2 * NCH
    assert got['coverage_ok'] and got['exact']
    assert got['frames_alias_junk'] == 0
    assert got['sample_format'] == RUNGS[rung][1]
    assert got['demod_block_len'] == 16200
    assert len(got['pass_s']) == 1 and got['rt_factor'] > 0
    assert got['setup_s'] > 0 and got['synth_s'] > 0
    assert got['max_memory_allocated'] is None
    assert got['launches'] == dict.fromkeys(
        ('viterbi27', 'viterbi27_one_mode', 'tracker', 'tracker_taps'), 0)


def _rung(nch, fs, fmt, rt, coverage=True):
    return dict(channels=nch, sample_rate=fs, sample_format=fmt,
                rt_factor=rt, coverage_ok=coverage, exact=coverage,
                path='superstep', device='cuda:0',
                frames_lost_midstream=0 if coverage else 3,
                lost_at=[] if coverage else [[0, 1], [16, 1], [32, 1]],
                frames_other=0, frames_duplicate=0, junk_at=[])


def _stub(monkeypatch, results):
    """Rung children answer from results by channels; records the calls."""
    calls = []

    def rung_child(nch, fs, fmt, **kw):
        calls.append((nch, fs, fmt, kw))
        r = results[nch]
        return (None, r) if isinstance(r, str) else (_rung(nch, fs, fmt, *r),
                                                     None)
    monkeypatch.setattr(bench, 'rung_child', rung_child)
    monkeypatch.setattr(bench, 'demod_child', lambda device: (
        dict(chan_sps=5400.0 * 3000, demod_only_channels=3000.0), None))
    return calls


def _main(tmp_path, argv=()):
    out = tmp_path / 'bench.json'
    rc = bench.main(['--device', 'cpu', '--out', str(out), *argv])
    return rc, json.loads(out.read_text())


def test_ladder_stops_after_the_first_rung_below_real_time(monkeypatch,
                                                           tmp_path):
    calls = _stub(monkeypatch, {512: (5.0,), 1024: (2.0,), 2048: (0.9,)})
    rc, out = _main(tmp_path)
    assert rc == 0 and out['ok']
    assert [c[:3] for c in calls] == [(512, 2_160_000, 'CS16'),
                                      (1024, 3_456_000, 'CS16'),
                                      (2048, 6_912_000, 'CS16')]
    # bench.py's warm passes and the rest of its settings
    assert [c[3]['warm'] for c in calls] == [3, 3, 2]
    assert all(c[3]['passes'] == 4 and c[3]['device'] == 'cpu'
               and c[3]['block'] == 16200 for c in calls)
    assert out['value'] == 1024 and out['vs_baseline'] == 1024 / 12
    assert out['unit'] == 'channels' and 'rt_factor 2.00' in out['metric']
    assert [s['channels'] for s in out['search']] == [512, 1024, 2048]
    assert out['failures'] == {'4096@13824000@CU8': (
        'not run: 2048@6912000@CS16 ran below real time (rt_factor 0.900)')}
    assert out['demod_only_channels'] == 3000.0


def test_ladder_headline_needs_coverage(monkeypatch, tmp_path):
    """A real-time rung that lost a (channel, pass) cell is a failure; the
    headline stays with the widest rung that decoded every cell."""
    _stub(monkeypatch, {512: (3.0,), 1024: (2.5, False)})
    rc, out = _main(tmp_path)
    assert rc == 1 and not out['ok']
    assert out['value'] == 512
    assert out['failures']['1024@3456000@CS16'].startswith(
        'coverage: 3 (channel, pass) cells lost')
    assert set(out['failures']) == {'1024@3456000@CS16', '2048@6912000@CS16',
                                    '4096@13824000@CU8'}


def test_failing_child_is_recorded_and_main_exits_1(monkeypatch, tmp_path):
    why = 'exit 1: torch.OutOfMemoryError: CUDA out of memory.'
    calls = _stub(monkeypatch, {512: (4.0,), 1024: why})
    rc, out = _main(tmp_path, ['--warm', '1', '--passes', '2',
                               '--demod-block', '5400'])
    assert rc == 1 and not out['ok'] and len(calls) == 2
    assert [(c[3]['warm'], c[3]['block']) for c in calls] == [(1, 5400)] * 2
    assert out['failures']['1024@3456000@CS16'] == why
    assert out['failures']['2048@6912000@CS16'] == \
        'not run: the ladder stopped at 1024@3456000@CS16'
    assert out['value'] == 512 and len(out['search']) == 1


def test_nothing_measured_is_no_headline(monkeypatch, tmp_path):
    _stub(monkeypatch, {512: 'timeout after 700 s (last: no output)'})
    monkeypatch.setattr(bench, 'demod_child',
                        lambda device: (None, 'exit 1: boom'))
    rc, out = _main(tmp_path, ['--search', '512@2160000'])
    assert rc == 1 and out['value'] == 0 and out['metric'] == 'bench failed'
    assert out['failures'] == {
        '512@2160000@CS16': 'timeout after 700 s (last: no output)',
        'demod_only': 'exit 1: boom'}
    assert out['demod_only_channels'] is None


@pytest.mark.parametrize('label, why, fault', [
    ('1024@3456000@CS16', 'timeout after 2100 s (last: no output)', False),
    ('1024@3456000@CS16', 'exit 1: torch.OutOfMemoryError: CUDA out of '
     'memory. Tried to allocate 2.00 GiB', False),
    ('2048@6912000@CS16', 'not run: the ladder stopped at 1024@3456000@CS16',
     False),
    ('1024@3456000@CS16', 'coverage: 3 (channel, pass) cells lost, first '
     '[[0, 1]]', True),
    ('1024@3456000@CS16', 'exit 1: RuntimeError: CUDA error: an illegal '
     'memory access was encountered', True),
    ('1024@3456000@CS16', 'exit -11: no output', True),
    ('demod_only', 'timeout after 480 s (last: no output)', True)])
def test_faults_excuse_only_a_rungs_size(label, why, fault):
    """Only a rung's watchdog or CUDA out-of-memory is its size; a lost
    cell, a crash or a signal is a fault, and so is any demod-only
    failure."""
    out = dict(failures={label: why}, rungs=[_rung(512, 2_160_000, 'CS16',
                                                   40.0)])
    assert bench.faults(out) == ({label: why} if fault else {})


@pytest.mark.parametrize('field, value', [
    ('frames_other', 1), ('frames_duplicate', 2),
    ('junk_at', [[130, 1, 4200]])])
def test_faults_hold_every_measured_rung_exact(field, value):
    """A rung with every cell decoded but an other or duplicate frame, or
    junk that is no alias image, is a fault though the ladder counts it."""
    r = dict(_rung(2048, 6_912_000, 'CS16', 30.0), exact=False,
             **{field: value})
    got = bench.faults(dict(failures={}, rungs=[_rung(512, 2_160_000, 'CS16',
                                                      40.0), r]))
    assert list(got) == ['2048@6912000@CS16']
    assert got['2048@6912000@CS16'].startswith('ledger not exact')
    assert str(value) in got['2048@6912000@CS16']


@pytest.mark.parametrize('tool', [bench, bench_scaling])
def test_tools_raise_without_cuda_unless_asked(tool, monkeypatch):
    """Without --device a tool takes the CUDA device, and without one it
    raises before any work (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(bench, 'rung_child', None)
    monkeypatch.setattr(bench_scaling, 'run_point', None)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tool.main([])


def test_search_parsing_and_watchdog():
    assert bench.parse_search(bench.DEFAULT_SEARCH) == [
        (512, 2_160_000, 'CS16'), (1024, 3_456_000, 'CS16'),
        (2048, 6_912_000, 'CS16'), (4096, 13_824_000, 'CU8')]
    assert [bench.watchdog_s(n) for n in (512, 1024)] == [700, 2100]


def test_demod_only_on_noise():
    with time_limit(120):
        out = bench.demod_only(16, device='cpu')
    assert out['frames'] == 0 and out['chan_sps'] > 0
    assert out['demod_only_channels'] == out['chan_sps'] / 5400
    assert (out['channels'], out['block'], out['timed_blocks']) == \
        (16, 5400, 24)


def test_scaling_decodes_the_same_set_at_1_and_2_processes(runs):
    from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver
    with time_limit(CHILD_S):
        # the port's single-device receiver on the N = 1 capture
        cap = bench_scaling.capture(1, 108_000, 8)
        rx = WidebandReceiver(cap['fs'], bench_scaling.CENTER, cap['freqs'],
                              'cpu')
        evs = rx.process(cap['wb']) + rx.flush()
        rc, out = runs['scaling'].result()
    single = sorted({e.pdu.hex() for e in evs if e.pdu is not None
                     and e.fcs_ok})
    assert rc == 0 and out['ok']
    p1, p2 = out['points']
    assert (p1['devices'], p1['mesh'], p1['backend']) == (1, '1x1', None)
    assert (p2['devices'], p2['mesh'], p2['backend']) == (2, '2x1', 'gloo')
    assert (p1['channels'], p1['sample_rate']) == (8, 108_000)
    assert (p2['channels'], p2['sample_rate']) == (16, 216_000)
    assert len(single) == 4 and single == cap['expected']
    assert p1['decoded'] == p2['decoded'] == single
    assert p1['decode_ok'] and p2['decoded_equal_n1']
    assert p2['decoded_equal_across_ranks']
    # bytes between shards: none on one shard, the model's on two
    assert p1['moved_bytes'] == p1['modelled_bytes'] == {}
    assert p2['moved_bytes'] == p2['received_bytes'] == p2['modelled_bytes']
    assert p2['moved_bytes']['reshard'] == \
        p2['steps'] * p2['comm_model']['reshard_bytes_per_superblock'] > 0
    assert p1['efficiency'] == 1.0 and p2['efficiency'] > 0
    assert p1['work_inflation'] == 1.0 and p2['cpu_s_per_stream_s'] > 0
    assert p1['super_blocks'] == p2['super_blocks'] == 8
    # the capture repeated in whole copies: 3 over N = 1's 18 super-blocks
    # of 0.53 s, 6 over N = 2's of 1.06 s, four frames each
    assert (p1['frames_decoded'], p2['frames_decoded']) == (12, 24)
    assert len(p2['setup_s']) == 2 and all(s > 0 for s in p2['setup_s'])
    assert set(p2['stage_wall_s'][0]) == {'frontend', 'fs1_append',
                                          'resample_demod'}


def test_alias_rule():
    """tools/alias.split_junk, the rule chip_smoke.py's ledgers and the
    rungs share: junk on a quiet channel two from an emitter, of the mode
    of a frame heard there and within 64 symbols of its start, is an image;
    any frame heard there counts (a rung hears each emitter once a pass)."""
    import types
    from dumphfdl_tpu_torch.tools import alias
    ev = lambda c, m, s: types.SimpleNamespace(channel=c, mode=m,
                                               start_symbol=s)
    emitters = {0: b'a', 16: b'b'}
    heard = {0: [(100, 1)], 16: [(100, 2), (9100, 2)]}
    images = [ev(2, 1, 130), ev(14, 2, 36), ev(18, 2, 9164)]
    others = [ev(1, 1, 100),           # one channel away
              ev(14, 1, 100),          # another mode
              ev(18, 2, 5000),         # another time
              ev(16, 2, 100),          # on the emitter
              ev(30, 2, 100)]          # near nothing
    got = alias.split_junk(images + others, emitters, heard)
    assert got == ([[2, 1, 130], [14, 2, 36], [18, 2, 9164]],
                   [[1, 1, 100], [14, 1, 100], [18, 2, 5000], [16, 2, 100],
                    [30, 2, 100]])
    assert alias.split_junk(images, emitters, heard, ()) == \
        ([], [[2, 1, 130], [14, 2, 36], [18, 2, 9164]])
    assert alias.ALIAS_STEP == 2 and alias.ALIAS_WINDOW == 64


def test_first_frame_block_keeps_that_block_and_its_event_block():
    """What --check-kernels holds against the plain versions on the card,
    recorded here on the CPU (the wrappers' plain route): the first block
    that completes a frame, cut to whole gate tiles (8 channels are one
    part tile), and the event block decoded after it."""
    from dumphfdl_tpu_torch.dsp import tracker as trk
    from dumphfdl_tpu_torch.dsp import tracker_cuda as tc
    from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver
    from dumphfdl_tpu_torch.ops import fec, fec_cuda
    from dumphfdl_tpu_torch.tools import kernel_check
    cap = bench_scaling.capture(1, 108_000, 8)
    rx = WidebandReceiver(cap['fs'], bench_scaling.CENTER, cap['freqs'],
                          'cpu')
    with time_limit(120), kernel_check.first_frame_block(trk.CT) as kept:
        evs = rx.process(cap['wb']) + rx.flush()
    # the wrappers are put back
    assert tc.tracker_block.__name__ == 'tracker_block'
    assert fec_cuda.viterbi_decode_many.__name__ == 'viterbi_decode_many'
    assert set(kept) == {'k2', 'rows', 'k1'} and kept['rows'] == [0, 8]
    st, x, lvl, steps = kept['k2']
    assert x.shape[0] == lvl.shape[0] == st.tau.shape[0] == 8
    act, _ = tc.tile_activity(st, x, True)
    ev = trk.tracker_block(st, x, lvl, steps, act)[2]
    done = (ev.reshape(8, trk.K_EVENTS, trk.EV_FIELDS)[:, :, 0] > 0.5)
    frames = [e for e in evs if e.pdu is not None]
    assert int(done.sum()) == len(frames) == 4
    softs, nbits = kept['k1']
    assert sum(s.shape[0] for s in softs) >= 4
    assert all(fec.viterbi_decode(s, n).shape == (s.shape[0], n)
               for s, n in zip(softs, nbits))
