"""PyTorch port: the soak tools on the CPU.

* tools/soak_events.py: a frame on every one of 16 channels, all ending in
  one block, through the port's ChannelBank with a fused capacity of 4
  (so both event routes run: 4 decoded in the padded batch, the rest by
  gather) against the JAX ChannelBank on the same input (its CPU default
  decodes every event by gather): channel, mode, PDU and FCS verdict
  exact, frequency error, RSSI and noise floor within the tolerances the
  superstep test uses.  The JAX bank runs in a thread beside the port's.
* tools/soak_stream.py: a short real-time paced stream at 16 channels.
  On the CPU the plain tracker runs several times slower than real time,
  so the paced part is kept within the ingest ring (four chunks of
  131072 samples, 4.9 s at 108 ksps): the run shows the pacing, the
  warm-up, the continuous stream and the ledger; keeping up in real time
  is the card's to show (chip_smoke.py phase soak_stream).

And what every tool of dumphfdl_tpu_torch/tools takes for its device.
"""

import concurrent.futures
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu import constants as JC  # noqa: E402
from dumphfdl_tpu.dsp.channel import ChannelBank as JChannelBank  # noqa: E402
from dumphfdl_tpu_torch.ops import fec_cuda  # noqa: E402
from dumphfdl_tpu_torch.tools import soak_events, soak_stream  # noqa: E402
from torch_time_limit import time_limit  # noqa: E402


def _jax_events(x: np.ndarray) -> list:
    bank = JChannelBank(x.shape[0], auto_shard=False)
    bank.process(np.zeros((x.shape[0], soak_events.BLOCK), np.complex64))
    events = []
    for off in range(0, x.shape[1], soak_events.BLOCK):
        events += bank.process(x[:, off:off + soak_events.BLOCK])
    return events + bank.drain_events()


def test_soak_events_matches_jax_on_both_routes(monkeypatch):
    monkeypatch.setenv('DUMPHFDL_NO_AUTOSHARD', '1')
    # the run counts every wrapper from 0 (the CPU launches none)
    monkeypatch.setattr(fec_cuda, 'one_mode_launches', 7)
    x, expected = soak_events.build_inputs(16, 0)
    assert x.shape == (16, 21_600) and x.dtype == np.complex64
    with time_limit(400), concurrent.futures.ThreadPoolExecutor(1) as ex:
        jax_events = ex.submit(_jax_events, x)
        out, events, recorded = soak_events.run(
            x, expected, 'cpu', fused_event_decode=4, record_k1=True)
        want = jax_events.result()
    assert out['exact'] and out['events'] == out['events_decoded_ok'] == 16
    # every block with events: min(events, 4) fused, the rest by gather
    assert out['blocks_with_events']
    for b in out['blocks_with_events']:
        assert b['fused'] == min(b['events'], 4)
        assert b['gathered'] == b['events'] - b['fused']
    assert sum(b['gathered'] for b in out['blocks_with_events']) == 12
    # the gather route's K1 calls, one per mode, padded to 32 frames
    assert sorted(n for _, n in recorded) == [540, 1080, 2160, 3240]
    assert all(s.shape == (32, 2 * n) for s, n in recorded)
    assert out['collect_only_s_per_block'] > 0
    assert out['launches'] == dict.fromkeys(
        ('viterbi27', 'viterbi27_one_mode', 'tracker', 'tracker_taps'), 0)

    by_chan = lambda evs: sorted((e for e in evs if e.pdu is not None),
                                 key=lambda e: e.channel)
    got, want = by_chan(events), by_chan(want)
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        assert (a.channel, a.mode, a.pdu, a.fcs_ok) == \
            (b.channel, b.mode, b.pdu, b.fcs_ok)
        assert a.pdu[:len(expected[a.channel])] == expected[a.channel]
        for f in ('rssi', 'noise_floor'):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-4,
                                                  abs=1e-4), f
        assert a.freq_err_hz == pytest.approx(
            b.freq_err_hz, abs=1e-4 * JC.SYMBOL_RATE / (2 * np.pi))


def _ev(channel, mode, start, pdu, fcs_ok=True):
    return types.SimpleNamespace(channel=channel, mode=mode,
                                 start_symbol=start, pdu=pdu, fcs_ok=fcs_ok)


def test_soak_events_ledger_counts_what_is_wrong():
    exp = [b'a', b'b', b'c']
    good = [_ev(c, 0, 0, p) for c, p in enumerate(exp)]
    assert soak_events.ledger(good, exp)['exact']
    led = soak_events.ledger(good[:2] + [_ev(2, 0, 0, b'x'), good[0]], exp)
    assert (led['events_other'], led['duplicates'], led['missing_channels'],
            led['exact']) == (1, 1, 1, False)


def test_soak_stream_ledger_sets_images_apart():
    """Per loop of the capture every emitter once; junk on a quiet channel
    one or two from an emitter, of its mode and near its frame, is an
    image of that frame, any other junk counts against the ledger."""
    emit = {0: (b'p0', 1), 8: (b'p8', 2)}
    evs = [_ev(0, 1, 100, b'p0'), _ev(8, 2, 100, b'p8'),
           _ev(0, 1, 9000, b'p0'), _ev(8, 2, 9000, b'p8')]
    assert soak_stream.ledger(evs, emit, 2)['exact']
    images = [_ev(6, 2, 130, b'zz', fcs_ok=False),       # two below 8
              _ev(7, 2, 9010, b'zz', fcs_ok=False),      # the next one
              _ev(1, 1, 90, b'zz', fcs_ok=False)]        # next to 0
    led = soak_stream.ledger(evs + images, emit, 2)
    assert (led['frames_alias_junk'], led['frames_junk'], led['exact']) == \
        (3, 0, True)
    for bad in (_ev(6, 3, 130, b'zz', fcs_ok=False),     # another mode
                _ev(5, 2, 130, b'zz', fcs_ok=False),     # three away
                _ev(6, 2, 500, b'zz', fcs_ok=False),     # another time
                _ev(8, 2, 100, b'zz', fcs_ok=False)):    # an emitter
        led = soak_stream.ledger(evs + [bad], emit, 2)
        assert (led['frames_junk'], led['exact']) == (1, False)
    led = soak_stream.ledger(evs[:3], emit, 2)
    assert led['channels_short'] == [8] and not led['exact']
    led = soak_stream.ledger(evs + [_ev(8, 2, 5, b'p0')], emit, 2)
    assert led['frames_other'] == 1 and not led['exact']


def test_soak_stream_paced_run_is_exact():
    """16 channels at 108 ksps, the JAX script's warm-up (5.15 s of
    stream, five chunks), then paced to the end of the capture's third
    loop: every emitter's frame once a loop, nothing else, no overrun, a
    latency for every paced frame."""
    with time_limit(300):
        out = soak_stream.run(channels=16, seconds=0.5, fs=108_000,
                              fmt='CF32', chunk_s=1.0, block=5400,
                              device='cpu')
    assert out['chunk_samples'] == 131_072
    assert out['input_overrun_samples'] == 0
    assert (out['loops'], out['frames_expected'], out['frames_ok']) == \
        (3, 48, 48)
    assert out['exact'] and out['frames_junk'] == out['frames_other'] == 0
    assert out['paced_stream_s'] > 1.0
    assert out['latency_s']['n'] > 0 and out['latency_s']['p50'] > 0
    assert out['rss_end_kb'] > 0 and out['device_memory_end'] == {}


@pytest.mark.parametrize('tool', ['sensitivity', 'soak_events',
                                  'soak_stream'])
def test_tools_run_on_the_card_unless_asked(tool, monkeypatch):
    """Without --device a tool takes the CUDA device, and on a machine
    without one it stops before any work (no fallback to the CPU)."""
    mod = importlib.import_module(f'dumphfdl_tpu_torch.tools.{tool}')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main([])
