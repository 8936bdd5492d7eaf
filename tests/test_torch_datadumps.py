"""PyTorch port, --datadumps: the per-stage signal files of dsp/dumpfile
written by the port's CLI against the JAX CLI's on the golden capture
(same names, same lengths; values within 2e-5 of the stage's peak up to
the matched filter, and within 1e-4 of it for what the tracker's recursion
puts out over the whole capture, the two ends of the tolerance the repo
holds between its own Pallas and scan trackers; the timing fraction is
compared on the circle, since it wraps at 1, and the Costas phase error,
the angle of a symbol, is allowed what that symbol's tolerance does to its
angle: 1e-4 of the symbols' peak over the symbol's magnitude), and the
decoded bytes, which the dumps must not change."""

import json
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu import cli as jcli  # noqa: E402
from dumphfdl_tpu_torch import cli  # noqa: E402
from dumphfdl_tpu_torch.app import HfdlApp  # noqa: E402
from dumphfdl_tpu_torch.dsp import dumpfile  # noqa: E402
from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / 'tests' / 'golden'
MANIFEST = json.loads((GOLDEN / 'manifest.json').read_text())
TOL = 2e-5
TOL_TRACKER = 1e-4
# whole demod blocks of capture; the blocks after them are the flush's
# digital silence, where a symbol is rounding dust and its angle (the Costas
# phase error, and the frequency that integrates it) is anybody's: there
# only the lengths are compared
CAPTURE_BLOCKS = (GOLDEN / MANIFEST['capture']).stat().st_size // 4 \
    * 5400 // MANIFEST['sample_rate'] // 5400


def _argv(out):
    return ['--iq-file', str(GOLDEN / MANIFEST['capture']),
            '--sample-format', MANIFEST['format'],
            '--sample-rate', str(MANIFEST['sample_rate']),
            '--centerfreq', str(MANIFEST['centerfreq'] / 1000),
            '--datadumps', '--output', f'decoded:text:file:path={out}'] \
        + [str(f / 1000) for f in MANIFEST['frequencies']]


@pytest.fixture(scope='module')
def dumps(tmp_path_factory):
    """Both CLIs with --datadumps, each in a directory of its own (the
    files go to the current directory); JAX on one device.  At this rate
    the superstep would engage: the port, left free to engage it, must
    dump and flush on the unfused path all the same; the JAX receiver is
    pinned off the superstep, since with it engaged its flush goes through
    the engine and dumps nothing of the last blocks."""
    mp = pytest.MonkeyPatch()
    seen = []
    handle = HfdlApp.handle_events
    mp.setattr(HfdlApp, 'handle_events', lambda self, evs: (
        seen.extend(evs), handle(self, evs))[1])
    mp.setenv('DUMPHFDL_NO_AUTOSHARD', '1')
    dirs = {}
    try:
        for name, run in (('port', lambda a: cli.main(a, device='cpu')),
                          ('jax', jcli.main)):
            if name == 'port':
                mp.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
            else:
                mp.setenv('DUMPHFDL_NO_SUPERSTEP', '1')
            dirs[name] = tmp_path_factory.mktemp(name)
            mp.chdir(dirs[name])
            assert run(_argv(dirs[name] / 'out.txt')) == 0
    finally:
        mp.undo()
    # the JAX CLI leaves its files open: what it wrote is flushed by now
    # only if the objects are gone, so read sizes after a collection
    import gc
    gc.collect()
    return dirs, seen


def _files(d):
    return sorted(p.name for p in d.iterdir() if p.suffix in ('.cf32',
                                                              '.rf32'))


def test_nine_stages_per_channel(dumps):
    dirs, _ = dumps
    want = sorted(f'{stage}.ch{ch}.{"rf32" if stage in ("agc_level", "costas_dphi", "costas_err", "symsync_tau") else "cf32"}'
                  for stage in dumpfile.STAGES
                  for ch in range(len(MANIFEST['frequencies'])))
    assert len(dumpfile.STAGES) == 9
    assert _files(dirs['port']) == want == _files(dirs['jax'])


def test_datadumps_take_the_unfused_path(monkeypatch):
    """With dumps set the receiver resamples in the channelizer and the
    bank's process() runs the tracker with its taps on, whatever path the
    geometry would take otherwise."""
    monkeypatch.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
    rx = WidebandReceiver(MANIFEST['sample_rate'], MANIFEST['centerfreq'],
                          MANIFEST['frequencies'], 'cpu')
    assert rx.fused

    class Sink:
        def __init__(self):
            self.seen = {}

        def write(self, stage, data):
            self.seen.setdefault(stage, []).append(np.asarray(data).shape)

    assert rx.superstep is not None and rx.engine is rx.superstep
    rx.bank.dumps = sink = Sink()
    assert rx.engine is None            # flush and timestamps follow suit
    rng = np.random.default_rng(0)
    n = MANIFEST['sample_rate'] * 3 // 2
    rx.process(((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                * 0.1).astype(np.complex64))
    assert rx.channelizer._out_count == 5400      # resampled there
    assert set(sink.seen) == set(dumpfile.STAGES)
    assert sink.seen['chan_out'] == [(2, 5400)]
    assert sink.seen['costas_err'] == sink.seen['sym_out'] == [(2, 1800)]


@pytest.mark.parametrize('stage', dumpfile.STAGES)
def test_dump_values_match_jax(dumps, stage):
    dirs, _ = dumps
    for name in (n for n in _files(dirs['port']) if n.startswith(stage + '.')):
        dt = np.complex64 if name.endswith('.cf32') else np.float32
        got = np.fromfile(dirs['port'] / name, dt)
        want = np.fromfile(dirs['jax'] / name, dt)
        per_symbol = stage in ('sym_out', 'const', 'costas_dphi',
                               'costas_err', 'symsync_tau')
        assert len(got) == len(want) > 0, name
        block = 1800 if per_symbol else 5400
        assert len(got) % block == 0 and len(got) > CAPTURE_BLOCKS * block
        got, want = (a[:CAPTURE_BLOCKS * block] for a in (got, want))
        if stage == 'const':        # NaN outside a frame's data symbols
            assert np.array_equal(np.isnan(got), np.isnan(want))
            assert 0 < np.isnan(got).sum() < len(got)
            got, want = np.nan_to_num(got), np.nan_to_num(want)
        d = got - want
        if stage == 'symsync_tau':
            d = (d + 0.5) % 1.0 - 0.5
        tol = (TOL_TRACKER if per_symbol else TOL) \
            * max(1.0, np.abs(want).max())
        if stage == 'costas_err':
            sym = np.fromfile(dirs['jax'] / name.replace(stage, 'sym_out')
                              .replace('rf32', 'cf32'), np.complex64)[:len(d)]
            tol = tol + TOL_TRACKER * np.abs(sym).max() \
                / np.maximum(np.abs(sym), 1e-9)
        assert (np.abs(d) <= tol).all(), name


def test_dumps_leave_the_decode_alone(dumps):
    dirs, seen = dumps
    got = {(e.channel, e.mode): e.pdu.hex() for e in seen if e.pdu}
    assert got == {(f['channel'], f['mode']): f['pdu_hex']
                   for f in MANIFEST['frames']}
    assert 'ICAO' in (dirs['port'] / 'out.txt').read_text()
    assert os.path.getsize(dirs['port'] / 'out.txt') == \
        os.path.getsize(dirs['jax'] / 'out.txt')
