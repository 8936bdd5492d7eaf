"""PyTorch port: the decode-sensitivity sweep (tools/sensitivity.py)
against the JAX script it twins (extras/sensitivity.py), the same trials
on the CPU: equal pass rates, the demodulator's reported SNR within 0.1
dB.  The JAX sweep runs in a thread beside the port's, which spends most
of its time in the plain tracker's loop."""

import concurrent.futures
import pathlib
import sys

import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / 'extras'))
import sensitivity as jsens  # noqa: E402

from dumphfdl_tpu_torch.tools import sensitivity  # noqa: E402
from torch_time_limit import time_limit  # noqa: E402

MODES, SNRS, TRIALS = [0, 3], [6.0, 20.0], 2


def test_sweep_matches_the_jax_sweep():
    """Modes 0 and 3 (the 300 and 1800 bps single-slot frames) at 6 and
    20 dB, two trials each, seeds 1000 * mode + t in both."""
    with time_limit(600), concurrent.futures.ThreadPoolExecutor(1) as ex:
        jax_rows = ex.submit(jsens.sweep, MODES, SNRS, TRIALS)
        rows = sensitivity.sweep(MODES, SNRS, trials=TRIALS, device='cpu')
        want = jax_rows.result()
    assert [(r['mode'], r['snr_db']) for r in rows] == \
        [(r['mode'], r['snr_db']) for r in want] == \
        [(m, s) for m in MODES for s in SNRS]
    for r, w in zip(rows, want):
        assert r['pass_rate'] == w['pass_rate'], (r, w)
        if w['mean_reported_snr_db'] is None:
            assert r['mean_reported_snr_db'] is None
        else:
            assert abs(r['mean_reported_snr_db']
                       - w['mean_reported_snr_db']) <= 0.1, (r, w)
    # at 20 dB every frame decodes, and the estimate tracks the truth
    for r in rows:
        if r['snr_db'] == 20.0:
            assert r['pass_rate'] == 1.0
            assert abs(r['mean_reported_snr_db'] - 20.0) < 1.5
