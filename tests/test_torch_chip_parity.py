"""PyTorch port: the chip-parity scenarios of extras/chip_parity.py replayed
through the port's plain versions (the wrappers' route for CPU tensors) and
held to tests/golden/chip_parity.json, the record of the JAX package's
kernels, as tests/test_chip_parity.py holds the interpret-mode kernels:
integer fields and the Viterbi digests exact, floats to 1e-4, except the
four random-walk fields named in chip_parity.FLOAT_TOLERANCE, which keep
the bounds of tests/test_chip_parity.py."""

import json
import pathlib

import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu_torch.tools import chip_parity  # noqa: E402

ART = pathlib.Path(__file__).parent / 'golden' / 'chip_parity.json'


@pytest.fixture(scope='module')
def record():
    return json.loads(ART.read_text())


@pytest.fixture(scope='module')
def diffs(record):
    return chip_parity.compare(chip_parity.tracker_scenario('cpu'),
                               chip_parity.viterbi_scenario('cpu'), record)


def test_viterbi_digests_match_the_record(record):
    got = chip_parity.viterbi_scenario('cpu')
    assert got == record['viterbi']
    assert len(got['digests']) == 8


def test_tracker_integer_fields_match_the_record(diffs):
    """compare() raises on any integer field, counter or digest that
    differs; reaching here with the float fields listed means all held."""
    assert {'ev.4', 'ev.5', 'ev.6', 'state.phi', 'sym_sum_re'} <= set(diffs)


def test_tracker_float_fields_within_tolerance(diffs):
    assert chip_parity.over_tolerance(diffs) == {}
    # the fields that are held to 1e-4 are all but the four random walks
    tight = {f for f in diffs if f not in chip_parity.FLOAT_TOLERANCE}
    assert len(tight) == 8 and max(diffs[f] for f in tight) <= 1e-4


def test_compare_catches_a_changed_field(record):
    """The comparison is not vacuous: one flipped event bit, one changed
    digest and one float moved past its bound are each caught."""
    import copy
    t = copy.deepcopy(record['tracker'])
    v = copy.deepcopy(record['viterbi'])
    assert chip_parity.over_tolerance(chip_parity.compare(t, v, record)) == {}
    bad = copy.deepcopy(t)
    bad['ev_tables'][1][0][1] += 1          # the event's mode
    with pytest.raises(AssertionError, match='event field 1'):
        chip_parity.compare(bad, v, record)
    with pytest.raises(AssertionError, match='digests'):
        chip_parity.compare(t, {**v, 'digests': v['digests'][::-1]}, record)
    bad = copy.deepcopy(t)
    bad['state_float']['freq_err'][0] += 2e-4
    assert list(chip_parity.over_tolerance(
        chip_parity.compare(bad, v, record))) == ['state.freq_err']
