"""PyTorch port: the frames that fail their FCS in the live soak at 512
channels are the JAX package's too.

tools/soak_stream.py's capture at 512 channels and 2.16 Msps, looped end to
end and decoded with demod blocks of 16200 (the chip_smoke.py phase
soak_stream), yields besides every emitter's frame two frames that fail
their FCS on quiet channels: 415 (mode 1, next to emitter 416) at symbol
10335 and 130 (mode 0, two channels from emitter 128) at symbol 25363.
The soak's ledger counts such frames apart (soak_stream.IMAGE_STEPS).
Here both packages decode the same samples on the CPU:

* the channel next to an emitter carries the emitter: both channelizers
  give the same output, in which channel 415 holds emitter 416's frame
  about 36 dB below the emitter's own channel and about 49 dB above a
  quiet channel's noise, while channel 130 holds nothing of emitter 128
  above its noise;
* JAX's receiver, on channels 415 and 130 alone, decodes exactly those two
  FCS-failing frames at those symbols, and the port's plain path decodes
  no FCS-failing frame there that JAX's does not.

Run with -s to print the levels.
"""

import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from dumphfdl_tpu.dsp import frontend as jfrontend  # noqa: E402
from dumphfdl_tpu.dsp import receiver as jreceiver  # noqa: E402
from dumphfdl_tpu_torch.dsp import frontend, receiver  # noqa: E402
from dumphfdl_tpu_torch.tools import soak_stream  # noqa: E402
from torch_time_limit import time_limit  # noqa: E402

FS = 2_160_000
NCH = 512
BLOCK = 16_200
CHUNK = 1 << 21
STREAM_S = 16           # six loops of the capture, both frames inside
# (channel, mode, start symbol) of the FCS-failing frames on the card
CARD_JUNK = [(415, 1, 10335), (130, 0, 25363)]


@pytest.fixture(scope='module')
def cap():
    return soak_stream.capture(NCH, FS)


def _db(p: np.ndarray) -> float:
    return float(10 * np.log10(p.mean()))


def test_the_next_channel_carries_the_emitter(cap):
    chans = [414, 415, 416, 128, 130]
    freqs = [cap['freqs'][c] for c in chans]
    port = frontend.Channelizer(FS, soak_stream.CENTER, freqs, 'cpu')
    ref = jfrontend.Channelizer(FS, soak_stream.CENTER, freqs)
    wb = cap['wb']
    with time_limit(120):
        y = np.concatenate([np.asarray(port.process(wb[o:o + CHUNK]))
                            for o in range(0, len(wb), CHUNK)], axis=1)
        yj = np.concatenate([np.asarray(ref.process(wb[o:o + CHUNK]))
                             for o in range(0, len(wb), CHUNK)], axis=1)
    n = min(y.shape[1], yj.shape[1])
    assert n >= 10_000
    np.testing.assert_allclose(y[:, :n], yj[:, :n],
                               atol=2e-5 * np.abs(yj).max())
    # the frames start at symbol 340 (sample 1020) and outlast the output
    level = dict(zip(chans, map(_db, np.abs(yj[:, 1500:n]) ** 2)))
    port_level = dict(zip(chans, map(_db, np.abs(y[:, 1500:n]) ** 2)))
    for c in chans:
        assert port_level[c] == pytest.approx(level[c], abs=0.01), c
    rejection = level[416] - level[415]
    above_noise = level[415] - level[414]
    print(f'levels {level} dB; next channel {rejection:.2f} dB below the '
          f'emitter, {above_noise:.2f} dB above the noise')
    assert 30 < rejection < 40
    assert above_noise > 40
    assert abs(level[130] - level[414]) < 1


def _junk(rx, wb) -> list:
    events = []
    for p in range(0, STREAM_S * FS, CHUNK):
        events += rx.process(soak_stream.looped(wb, p, CHUNK))
    events += rx.flush()
    return [e for e in events if e.pdu is not None and not e.fcs_ok]


def test_jax_decodes_the_same_fcs_failing_frames(cap, monkeypatch):
    monkeypatch.setenv('DUMPHFDL_NO_AUTOSHARD', '1')
    chans = [415, 130]
    freqs = [cap['freqs'][c] for c in chans]
    ref = jreceiver.WidebandReceiver(FS, soak_stream.CENTER, freqs,
                                     block_len=BLOCK, sample_format='CF32')
    port = receiver.WidebandReceiver(FS, soak_stream.CENTER, freqs, 'cpu',
                                     block_len=BLOCK, sample_format='CF32')
    with time_limit(300), concurrent.futures.ThreadPoolExecutor(1) as ex:
        want = ex.submit(_junk, ref, cap['wb'])
        got = _junk(port, cap['wb'])
        want = want.result()
    rows = lambda evs: [(chans[e.channel], e.mode, e.start_symbol)
                        for e in evs]
    print(f'FCS-failing frames: JAX {rows(want)}, the port {rows(got)}')
    assert rows(want) == CARD_JUNK
    assert set(rows(got)) <= set(CARD_JUNK)
