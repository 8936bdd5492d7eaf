"""Decode-sensitivity sweep of the port: frame pass rate against Es/N0 per
HFDL mode.

Twin of ``extras/sensitivity.py``, the same trials on the port: for each
(mode, SNR) point it synthesizes frames with random payloads, carrier
frequency offset (+-25 Hz) and fractional timing, prepends hunting noise at
the same N0, runs them through the port's demodulator (``ChannelBank``:
AGC, matched filter, the tracker K2, the event decode through K1's
``viterbi_decode_many``) and reports the fraction whose PDU decodes bit for
bit, with the demodulator's own SNR estimate (frame RSSI over noise floor).
Seeds (``1000 * mode + t``), impairments, hunting noise and the demod block
of 16200 samples are the JAX script's, and so are the rows.

    python -m dumphfdl_tpu_torch.tools.sensitivity [--modes 0,3,7]
        [--snrs 0:21:3] [--trials 10] [--json] [--device cuda:0]
        [--out PATH]

Runs on the CUDA device unless --device names another (the CPU takes the
kernels' plain versions); --out also writes the rows as JSON to PATH.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# the demod block the trials stream in (state carries across blocks; one
# block the length of the capture would break the frame-parity invariant
# of the double-slot modes)
BLOCK = 16200


def _trial_iq(mode: int, snr_db: float, seed: int):
    """(impaired frame with hunting noise before it, its PDU) of one trial;
    the JAX script's synthesis, draw for draw."""
    from ..dsp import modulator
    rng = np.random.default_rng(seed)
    pdu = modulator.make_test_mpdu(mode, rng, icao=0x400000 + seed % 0xFFFF)
    syms = modulator.frame_symbols(pdu, mode)
    iq = modulator.synthesize_iq(syms, imp=modulator.Impairments(
        snr_db=snr_db,
        cfo_hz=float(rng.uniform(-25, 25)),
        timing_offset=float(rng.uniform(0, 1)),
        seed=seed + 1))
    # noise-only hunting time at the same N0 first, so that the noise-floor
    # estimate (hfdl.c:699-706 cadence) has converged when the frame starts:
    # that makes the reported RSSI/noise-floor SNR meaningful
    sigma = float(np.std(iq[:180])) / np.sqrt(2)
    hunt = (rng.standard_normal(4500)
            + 1j * rng.standard_normal(4500)).astype(np.complex64) * sigma
    return np.concatenate([hunt, iq]), pdu


def _reported_snr_db(ev) -> float:
    # levels are amplitudes: LEVEL_TO_DB is 20 log10 (hfdl.c:591)
    return float(20 * np.log10(max(ev.rssi, 1e-12)
                               / max(ev.noise_floor, 1e-12)))


def decode_trials_batched(mode: int, snr_db: float, seeds, device):
    """Many independent trials of one (mode, SNR) point as one ChannelBank
    batch on device, a trial per channel (the mapping the receiver uses).

    Returns (ok list[bool], reported SNR list[float | None]) per seed."""
    from ..dsp.channel import ChannelBank
    trials = [_trial_iq(mode, snr_db, seed) for seed in seeds]
    tmax = max(len(iq) for iq, _ in trials)
    x = np.zeros((len(seeds), -(-tmax // BLOCK) * BLOCK), np.complex64)
    for i, (iq, _) in enumerate(trials):
        x[i, :len(iq)] = iq
    bank = ChannelBank(len(seeds), device)
    events = []
    for off in range(0, x.shape[1], BLOCK):
        events += bank.process(x[:, off:off + BLOCK])
    events += bank.process(np.zeros((len(seeds), BLOCK), np.complex64))
    ok = [False] * len(seeds)
    est: list = [None] * len(seeds)
    for ev in events:
        if ev.pdu == trials[ev.channel][1] and not ok[ev.channel]:
            ok[ev.channel] = True
            est[ev.channel] = _reported_snr_db(ev)
    return ok, est


def decode_trial(mode: int, snr_db: float, seed: int, device):
    """One impaired frame through a one-channel bank: (ok, reported SNR in
    dB or None)."""
    ok, est = decode_trials_batched(mode, snr_db, [seed], device)
    return ok[0], est[0]


def sweep(modes, snrs, trials, device, progress=None) -> list[dict]:
    """[{mode, snr_db, pass_rate, mean_reported_snr_db}, ...], trials
    1000 * mode + t for t < trials at every point."""
    rows = []
    for mode in modes:
        for snr in snrs:
            oks, ests = decode_trials_batched(
                mode, snr, [1000 * mode + t for t in range(trials)], device)
            ests = [e for e in ests if e is not None]
            if progress:
                progress(mode, snr, trials - 1, sum(oks))
            rows.append({
                'mode': mode,
                'snr_db': float(snr),
                'pass_rate': sum(oks) / trials,
                'mean_reported_snr_db':
                    float(np.mean(ests)) if ests else None,
            })
    return rows


def main(argv=None) -> int:
    from ..device import require_cuda
    ap = argparse.ArgumentParser(
        prog='python -m dumphfdl_tpu_torch.tools.sensitivity',
        description=__doc__.splitlines()[0])
    ap.add_argument('--modes', default='0,3,7',
                    help='comma-separated mode indices (0-7)')
    ap.add_argument('--snrs', default='0:21:3',
                    help='start:stop:step dB sweep (stop exclusive)')
    ap.add_argument('--trials', type=int, default=10)
    ap.add_argument('--json', action='store_true')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the CUDA device)')
    ap.add_argument('--out', default=None,
                    help='also write the rows as JSON to this file')
    args = ap.parse_args(argv)
    device = require_cuda() if args.device is None \
        else torch.device(args.device)
    modes = [int(m) for m in args.modes.split(',')]
    a, b, c = (float(v) for v in args.snrs.split(':'))
    snrs = list(np.arange(a, b, c))

    def prog(mode, snr, t, ok):
        print(f'\rmode {mode} snr {snr:5.1f} dB trials {t + 1} ok {ok}',
              end='', file=sys.stderr)

    rows = sweep(modes, snrs, args.trials, device, progress=prog)
    print(file=sys.stderr)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(rows, fh, indent=1)
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(f'{"mode":>4} {"SNR dB":>7} {"pass":>6} {"est SNR":>8}')
        for r in rows:
            est = (f"{r['mean_reported_snr_db']:8.1f}"
                   if r['mean_reported_snr_db'] is not None else '       -')
            print(f"{r['mode']:>4} {r['snr_db']:>7.1f} "
                  f"{r['pass_rate']:>6.0%} {est}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
