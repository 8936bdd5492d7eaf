"""The harness end to end on the CPU at a tiny size (4 HFDL frequencies at
216 ksps CS16, block 16200: the superstep path, as the 3.456 Msps cells
take it, every slot of a one-slot loop carrying a frame),
with the port's plain kernels: the decoded frames hold against the
transmitter's exactly, and each fault a cell can have, planted under the
timed path, turns `correct` false.  The same on the card, marked cuda."""

import json

import pytest

from hfdlbench import run, spec

torch = pytest.importorskip('torch')

TINY = dict(name='tiny_216k_cs16',
            channels=[[8912, [2, 4]], [8921, [5]], [8936, [2, 9]],
                      [8948, [17]]],
            sample_rate=216_000, sample_format='CS16',
            centerfreq=8_930_000, demod_block=16200, path='superstep')
SEED = 2**31 + 4321          # larger than 32 signed bits hold


def cell(mix_name='slots_spaced', **over):
    mix = json.loads((spec.HERE / 'traffic' / f'{mix_name}.json')
                     .read_text())
    mix.update(slots=1, warm_s=0.5, trace_seconds=1.0, **over)
    return spec.Cell(name=f'tiny.{mix_name}', chips=1, config=dict(TINY),
                     mix=mix,
                     end_to_end=[{'name': 'rt_factor', 'unit': 'x'},
                                 {'name': 'setup_s', 'unit': 's'}],
                     per_layer=[])


def one(device, fault=None, seconds=1.0):
    import time
    torch.set_num_threads(2)
    return run.run(cell(), SEED, seconds, False, device, time.perf_counter(),
                   fault=fault)


def test_sound_run_is_correct_and_its_line_has_the_contract_keys():
    res = one(torch.device('cpu'))
    assert res['correct'], res['checks']
    assert list(res)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(res)[-1] == 'checks'
    assert set(res['metrics']) == {'rt_factor', 'setup_s'}
    assert res['failed'] == 0 and res['attempted'] > 0
    assert res['detail']['path'] == 'superstep'
    assert all(c['value'] <= c['limit'] for c in res['checks'].values())
    json.loads(json.dumps(res))


@pytest.mark.parametrize('fault,check', [
    ('stall', 'missing'),       # a step that leaves its state unchanged
    ('half', 'missing'),        # half of the channels left out
    ('byte', 'other'),          # a byte of a frame altered where made
    ('drop', 'missing')])       # the control: one frame in 100 lost
def test_each_fault_turns_correct_false(fault, check):
    res = one(torch.device('cpu'), fault=fault)
    assert not res['correct']
    assert res['checks'][check]['value'] > res['checks'][check]['limit']


def test_a_wrong_path_is_not_correct():
    c = cell()
    c.config['path'] = 'unfused'
    import time
    res = run.run(c, SEED, 0.5, False, torch.device('cpu'),
                  time.perf_counter())
    assert not res['correct'] and res['checks']['path']['value'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('fault', [None, 'drop'])
def test_on_the_card(cuda_device, fault):
    res = one(cuda_device, fault=fault, seconds=2.0)
    assert res['correct'] is (fault is None)


def test_the_source_ends_after_its_loop_and_on_kill():
    import time
    c = cell()
    cap = run.traffic.build(c.config, c.mix, SEED)
    src = run.Source(dict(config=c.config, mix=c.mix, seed=SEED))
    try:
        with open(src.fifo, 'rb') as fh:
            got = fh.read(len(cap.raw) + 10)
            src.finish()
            rest = fh.read()
        assert got[:len(cap.raw)] == cap.raw
        assert (len(got) + len(rest)) % len(cap.raw) == 0
        assert src.loops() == (len(got) + len(rest)) // len(cap.raw)
    finally:
        src.close()
    stuck = run.Source(dict(config=c.config, mix=c.mix, seed=SEED))
    time.sleep(0.3)             # nobody reads: its writes wait
    stuck.close()
    assert stuck.proc.returncode is not None
    assert not run.os.path.exists(stuck.fifo)
