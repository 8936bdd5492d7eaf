"""The one traffic generator: a configuration and a mix -> the capture.

A mix (``traffic/<name>.json``) is parameters only; this module reads them.
A loop of the capture is `slots` HFDL TDMA slots (tx.SLOT_SYMBOLS each; 13
slots make the 32-s TDMA frame), looped end to end into one continuous
stream.  Which slots of which channels carry a frame is the mix's
`frames` rule:

* ``squitter``: every ground station sends one frame a TDMA frame on each
  of its frequencies (its squitter), in slot (station id mod `slots`);
  the configuration lists each channel's stations.
* ``every_slot``: every slot of every channel carries a frame, the most
  the TDMA can carry; channels closer than `turns_within_hz` to the one
  below them (whose signals overlap) take the slots in turn, and with
  `quiet_within_hz` a channel with another that close carries none.

Frames are single-slot and start at their slot's start plus a propagation
delay.  Over the frames of a loop (in slot, then channel order) the modes
go in turn through `modes`, the Es/N0 values are spread evenly over
`snr_db` [low, high] and the delays over `delay_ms` [low, high]; the seed
permutes which frame gets which Es/N0 and which delay, and decides the
PDUs' contents (aircraft, ground station, ICAO address) and the noise.
It does not decide the sizes, the modes, which slots carry frames, or the
set of Es/N0 values and delays, so every seed asks for the same work.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import tx


@dataclasses.dataclass
class Capture:
    """One loop of the traffic, and the truth about it."""
    freqs: list[int]                # Hz, one per channel of the deployment
    fs: int
    fmt: str
    slots: int
    emissions: list                 # tx.Emission, by slot then channel
    raw: bytes | None = None        # one loop in the sample format
    synth_s: float = 0.0

    @property
    def ratio(self) -> int:
        return self.fs // tx.INTERNAL_RATE

    @property
    def loop_symbols(self) -> int:
        return self.slots * tx.SLOT_SYMBOLS

    @property
    def loop_len(self) -> int:
        """Wideband samples per loop."""
        return self.loop_symbols * tx.SPS * self.ratio

    @property
    def loop_s(self) -> float:
        return self.loop_len / self.fs

    def end_sample(self, e: tx.Emission) -> int:
        """Wideband sample of the frame's last sample within its loop."""
        return int((e.start_symbol + tx.MODES[e.mode].frame_symbols)
                   * tx.SPS * self.ratio) - 1


def channel_freqs(config: dict) -> list[int]:
    """The deployment's channels in Hz, from the [kHz, [station ids]]
    pairs of its `channels`."""
    return [int(round(khz * 1000)) for khz, _ in config['channels']]


def occupancy(config: dict, mix: dict) -> list[tuple[int, int]]:
    """(slot, channel index) of every frame of a loop, sorted."""
    slots, rule = mix['slots'], mix['frames']
    occ = []
    if rule == 'squitter':
        for i, (_, stations) in enumerate(config['channels']):
            used = {st % slots for st in stations}
            if len(used) != len(stations):
                raise ValueError(f'two stations of channel {i} share a slot')
            occ += [(s, i) for s in used]
    elif rule == 'every_slot':
        hz, runs = channel_freqs(config), []
        apart = mix.get('quiet_within_hz', 0)
        for i in range(len(hz)):
            if any(0 < abs(hz[i] - f) < apart for f in hz):
                continue
            if runs and hz[i] - hz[runs[-1][-1]] < mix['turns_within_hz']:
                runs[-1].append(i)
            else:
                runs.append([i])
        for run in runs:
            if slots % len(run):
                raise ValueError(f'{len(run)} channels cannot take turns '
                                 f'over {slots} slots')
            occ += [(s, i) for j, i in enumerate(run)
                    for s in range(j, slots, len(run))]
    else:
        raise KeyError(f'no frames rule {rule!r}')
    return sorted(occ)


def plan(config: dict, mix: dict, seed: int) -> list[tx.Emission]:
    """The frames of a loop, from the mix's parameters and the seed."""
    hz = channel_freqs(config)
    occ = occupancy(config, mix)
    n = len(occ)
    rng = np.random.default_rng([seed, 1])
    snrs = np.linspace(*mix['snr_db'], n)[rng.permutation(n)]
    delays = np.linspace(*mix['delay_ms'], n)[rng.permutation(n)] / 1e3
    modes = mix['modes']
    out = []
    for k, (s, i) in enumerate(occ):
        mode = modes[k % len(modes)]
        src, gs, icao = (int(rng.integers(1, 256)), int(rng.integers(1, 128)),
                         int(rng.integers(1, 1 << 24)))
        out.append(tx.Emission(channel=i, hz=hz[i], slot=s, mode=mode,
                               pdu=tx.make_mpdu(mode, src, gs, icao),
                               snr_db=float(snrs[k]),
                               delay_s=float(delays[k])))
    return out


def build(config: dict, mix: dict, seed: int, samples: bool = True
          ) -> Capture:
    """The capture's truth, and with `samples` its bytes too."""
    cap = Capture(freqs=channel_freqs(config), fs=config['sample_rate'],
                  fmt=config['sample_format'], slots=mix['slots'],
                  emissions=plan(config, mix, seed))
    if samples:
        t = time.perf_counter()
        wb = tx.wideband_loop(cap.emissions, cap.slots, cap.fs,
                              config['centerfreq'], int(seed))
        cap.raw = tx.serialize(wb, cap.fmt)
        cap.synth_s = time.perf_counter() - t
    return cap


def frames_ending_in(cap: Capture, s0: int, s1: int) -> list[tuple]:
    """(channel, global slot) of every frame whose last sample lies in
    stream samples [s0, s1); global slot = loop * slots + slot."""
    out = []
    for e in cap.emissions:
        end = cap.end_sample(e)
        k = max(0, -(-(s0 - end) // cap.loop_len))
        while k * cap.loop_len + end < s1:
            out.append((e.channel, k * cap.slots + e.slot))
            k += 1
    return out
