"""Event-path soak of the port: a frame on every channel, all completing in
the same demod block.

Twin of ``extras/soak_events.py``.  N channels each carry one frame of a
single-slot mode (the four cycle over the channels), so one block hands the
host N events at once: the worst case for the event collection
(``ChannelBank._collect_events``).  The bank decodes the first
``fused_event_decode`` events of a block in one padded batch
(``fused_collect``: K1 through ``fec_cuda.viterbi_decode_many``, one launch)
and the rest by gather (``_decode_by_gather``: K1 through
``fec_cuda.viterbi_decode``, one launch per mode and batch, padded to a
power of two).

Reports the ledger (each channel's frame decoded once with its bytes), the
events of each block decoded fused and by gather, every kernel wrapper's
launches over the timed run (``kernel_check.launches``: K1 by route, K2
and its taps instantiation; 0 on the CPU, which takes the plain versions),
events per second through ``ChannelBank.process`` (demodulation and
collection), and the collection-only seconds per block: ``_collect_events``
on the block's readback, timed after the device work that made it.

    python -m dumphfdl_tpu_torch.tools.soak_events [--channels 1024]
        [--seed 0] [--device cuda:0] [--out PATH]

Prints one JSON object; --out also writes it to PATH.  Runs on the CUDA
device unless --device names another (the CPU takes the kernels' plain
versions).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

BLOCK = 5400            # one-second demod blocks, as in the JAX script
COLLECT_REPS = 5        # timed collections of one readback, as in JAX


def build_inputs(nch: int, seed: int = 0) -> tuple[np.ndarray, list[bytes]]:
    """(x, expected): x (nch, T) complex64 at 5400 sps, channel c carrying
    one frame of the c-th single-slot mode (cycling) at half amplitude from
    its first sample, in noise of 1e-3; expected[c] is that frame's PDU.
    T leaves two blocks of silence after the longest frame.  The JAX
    script's input, draw for draw."""
    from .. import constants as C
    from ..dsp import modulator
    rng = np.random.default_rng(seed)
    single_slot = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
    protos = []
    for mode in single_slot:
        pdu = modulator.make_test_mpdu(mode, rng)
        syms = modulator.frame_symbols(pdu, mode)
        protos.append((modulator.synthesize_iq(syms, pad_symbols=(100, 100)),
                       pdu))
    n_max = max(len(iq) for iq, _ in protos)
    x = np.zeros((nch, ((n_max // BLOCK) + 2) * BLOCK), np.complex64)
    expected = []
    for c in range(nch):
        iq, pdu = protos[c % len(protos)]
        x[c, :len(iq)] = iq * 0.5
        expected.append(pdu)
    x += (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
          ).astype(np.complex64) * 1e-3
    return x, expected


def ledger(events, expected: list[bytes]) -> dict:
    """Each channel's frame decoded once with its bytes, nothing else."""
    ok = {}
    other = 0
    for ev in events:
        exp = expected[ev.channel]
        if ev.pdu is not None and ev.fcs_ok and ev.pdu[:len(exp)] == exp:
            ok[ev.channel] = ok.get(ev.channel, 0) + 1
        else:
            other += 1
    led = dict(events=len(events), events_decoded_ok=sum(ok.values()),
               events_other=other,
               duplicates=sum(n - 1 for n in ok.values() if n > 1),
               missing_channels=len(expected) - len(ok))
    led['exact'] = (led['events_decoded_ok'] == len(expected) == len(events)
                    and not other and not led['duplicates'])
    return led


@contextlib.contextmanager
def _routes(bank):
    """While open, counts the events each of the bank's collections decodes
    fused (valid rows of fused_collect's batch) and by gather, and keeps
    the readback of the last collection that found events: yields
    (splits, last), splits the list of [fused, gathered] pairs, one per
    collection that found events, in order, and last a list holding that
    readback."""
    from ..dsp import channel
    fused_collect = channel.fused_collect
    collect, by_gather = bank._collect_events, bank._decode_by_gather
    splits, last = [], [None]

    def collecting(rb):
        splits.append([0, 0])
        events = collect(rb)
        if events:
            last[0] = rb
        else:
            splits.pop()
        return events

    def fused(*a, **kw):
        dec = fused_collect(*a, **kw)
        splits[-1][0] += int((dec[:, 0] >= 0).sum())
        return dec

    def gather(events, idxs, *a):
        splits[-1][1] += len(idxs)
        return by_gather(events, idxs, *a)

    channel.fused_collect = fused
    bank._collect_events, bank._decode_by_gather = collecting, gather
    try:
        yield splits, last
    finally:
        channel.fused_collect = fused_collect
        del bank._collect_events, bank._decode_by_gather


@contextlib.contextmanager
def recording_one_mode_k1():
    """While open, every call of fec_cuda.viterbi_decode (K1's one-mode
    wrapper: the gather route) is recorded: yields the list of (soft chips,
    nbits) it was handed."""
    from ..ops import fec_cuda
    wrapper, seen = fec_cuda.viterbi_decode, []

    def recording(soft, nbits):
        seen.append((soft.clone(), nbits))
        return wrapper(soft, nbits)

    fec_cuda.viterbi_decode = recording
    try:
        yield seen
    finally:
        fec_cuda.viterbi_decode = wrapper


def _sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(x: np.ndarray, expected: list[bytes], device,
        fused_event_decode: int = 64, record_k1: bool = False):
    """Decode x block by block through a fresh ChannelBank on device.
    Returns (summary dict, the events, the calls of K1's one-mode wrapper
    recorded while the block with the events is collected once more
    (record_k1; else [])).

    Timed: every block through ChannelBank.process after one silent
    warm-up block, then the deferred block's events (drain_events).  Then,
    untimed, the collection of the last block with events alone
    (_collect_events on its readback, the device work done) COLLECT_REPS
    times; it must give that block's events again (the symbol ring still
    holds their frames), and with record_k1 it runs once more while K1's
    one-mode calls are recorded."""
    from ..dsp.channel import ChannelBank
    from .kernel_check import launches, zero_launches
    device = torch.device(device)
    nch = x.shape[0]
    bank = ChannelBank(nch, device, fused_event_decode=fused_event_decode)
    bank.process(np.zeros((nch, BLOCK), np.complex64))
    bank.drain_events()
    zero_launches()
    per_block = []
    with _routes(bank) as (splits, last):
        _sync(device)
        t0 = time.perf_counter()
        events = []
        for off in range(0, x.shape[1], BLOCK):
            got = bank.process(x[:, off:off + BLOCK])
            per_block.append(got)
            events.extend(got)
        got = bank.drain_events()
        per_block.append(got)
        events.extend(got)
        _sync(device)
        wall = time.perf_counter() - t0
    counts = launches()
    with_events = [got for got in per_block if got]
    blocks = [dict(events=len(got), fused=f, gathered=g)
              for got, (f, g) in zip(with_events, splits, strict=True)]

    # the collection alone, on the readback of the last block with events
    recorded, coll_s = [], None
    if last[0] is not None:
        t0 = time.perf_counter()
        for _ in range(COLLECT_REPS):
            again = bank._collect_events(last[0])
        coll_s = (time.perf_counter() - t0) / COLLECT_REPS
        if again != with_events[-1]:
            raise AssertionError('the collection alone decoded other events '
                                 'than the timed run')
        if record_k1:
            with recording_one_mode_k1() as recorded:
                bank._collect_events(last[0])
            _sync(device)

    out = dict(metric='event-path soak: a frame on every channel, one block',
               channels=nch, device=str(device),
               fused_event_decode=fused_event_decode,
               **ledger(events, expected), blocks_with_events=blocks,
               launches=counts, wall_s=wall, events_per_s=len(events) / wall,
               collect_only_s_per_block=coll_s)
    return out, events, recorded


def main(argv=None) -> int:
    from ..device import require_cuda
    ap = argparse.ArgumentParser(
        prog='python -m dumphfdl_tpu_torch.tools.soak_events',
        description=__doc__.splitlines()[0])
    ap.add_argument('--channels', type=int, default=1024)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help='torch device (default: the CUDA device)')
    ap.add_argument('--out', default=None,
                    help='also write the JSON result to this file')
    args = ap.parse_args(argv)
    device = require_cuda() if args.device is None \
        else torch.device(args.device)
    x, expected = build_inputs(args.channels, args.seed)
    out, _, _ = run(x, expected, device)
    text = json.dumps(out)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(text + '\n')
    print(text)
    return 0 if out['exact'] else 1


if __name__ == '__main__':
    sys.exit(main())
