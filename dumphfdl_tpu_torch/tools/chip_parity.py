"""Replay the chip-parity scenarios through the port.

``tests/golden/chip_parity.json`` holds what the JAX package's two kernels
gave for two fixed, seeded scenarios (``extras/chip_parity.py`` wrote it
and is its only writer).  This module rebuilds the same inputs with the
port's own modulator, AGC and matched filter and runs them through the
port's wrappers, so that on a CPU device the plain versions, and on a CUDA
device kernels K1 and K2, are held to the same record:

* tracker: a mode-1 frame with 12 Hz of carrier offset and 0.4 of a sample
  of timing offset on channel 0 (seeds 5 and 3), noise on channel 1, in
  two blocks with the state carried over;
* Viterbi: 8 rows of seeded random soft bits (seed 11), 1800 frame bits,
  as SHA-256 digests of the decoded bits.

``compare`` holds integer fields and digests exactly and gives the largest
difference of every float field; ``FLOAT_TOLERANCE`` is the bound of each.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..dsp import modulator
from ..dsp import tracker_cuda
from ..dsp.channel import agc_block, agc_init, matched_filter
from ..dsp.tracker import EV_FIELDS, HALO, tracker_init
from ..ops import fec_cuda

# integer-valued fields of an event slot: valid, mode, bitmask, parity,
# train_bad, train_total, start symbol, start row
EV_INT_FIELDS = (0, 1, 2, 3, 7, 8, 9, 10)
STATE_INT = ('fr_state', 'mode', 'frame_counter', 'abs_symbol',
             'symbols_wanted', 'data_idx')
STATE_FLOAT = ('tau', 'phi', 'dphi', 'freq_err', 'signal_level',
               'noise_floor')

# Bound of each float field's difference from the record: 1e-4, except the
# fields the record's own replay (tests/test_chip_parity.py) already holds
# wider, with its bounds.  On the noise channel the Costas phase and the
# equalized symbols are random walks over ~4000 symbols, and float32 sums
# taken in another order drift: the final phase by a few milliradians, the
# sums over ~8000 symbols by about 1, the largest |symbol| by a few 1e-3.
FLOAT_TOLERANCE = {'state.phi': 5e-3, 'sym_sum_re': 2.0, 'sym_sum_im': 2.0,
                   'sym_absmax': 5e-3}
DEFAULT_TOLERANCE = 1e-4


def tracker_scenario(device) -> dict:
    """The two-block tracker run, as extras/chip_parity.py records it."""
    rng = np.random.default_rng(5)
    pdu = modulator.make_test_mpdu(1, rng, icao=0x3C0001)
    syms = modulator.frame_symbols(pdu, 1)
    iq = modulator.synthesize_iq(
        syms, imp=modulator.Impairments(snr_db=30.0, cfo_hz=12.0,
                                        timing_offset=0.4, seed=3))
    n = len(iq)
    noise = (rng.standard_normal(n)
             + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.01
    x = torch.as_tensor(np.stack([iq, noise]).astype(np.complex64),
                        device=device)
    blk = (n // 2 // 3) * 3

    ast = agc_init(2, device)
    tst = tracker_init(2, device)
    tail = torch.zeros((2, HALO), dtype=torch.complex64, device=device)
    ltail = torch.ones((2, HALO), dtype=torch.float32, device=device)
    evs, counters = [], []
    sym_sum = np.zeros(2, np.complex128)
    sym_absmax = np.zeros(2)
    for off in (0, blk):
        ast, y, lv = agc_block(ast, x[:, off:off + blk])
        mfe = torch.cat([tail, matched_filter(y)], dim=1)
        lve = torch.cat([ltail, lv], dim=1)
        tail, ltail = mfe[:, -HALO:], lve[:, -HALO:]
        tst, outs, ev, cnt = tracker_cuda.tracker_block(tst, mfe, lve,
                                                        blk // 3)
        evs.append(ev.cpu().numpy())
        counters.append(cnt.cpu().numpy())
        s = outs.sym.cpu().numpy()
        sym_sum += s.sum(axis=0)
        sym_absmax = np.maximum(sym_absmax, np.abs(s).max(axis=0))
    host = lambda f: getattr(tst, f).cpu().numpy()
    return {
        'ev_tables': [e.astype(float).tolist() for e in evs],
        'counters': [c.astype(float).tolist() for c in counters],
        'state_int': {f: host(f).tolist() for f in STATE_INT},
        'state_float': {f: host(f).astype(float).tolist()
                        for f in STATE_FLOAT},
        'sym_sum_re': sym_sum.real.tolist(),
        'sym_sum_im': sym_sum.imag.tolist(),
        'sym_absmax': sym_absmax.tolist(),
        'blk': blk,
    }


def viterbi_scenario(device) -> dict:
    """Seeded soft bits -> decoded bits, as SHA-256 digests per row."""
    rng = np.random.default_rng(11)
    framebits = 1800
    soft = rng.integers(0, 256, size=(8, 2 * framebits),
                        dtype=np.int64).astype(np.uint8)
    bits = fec_cuda.viterbi_decode(torch.as_tensor(soft, device=device),
                                   framebits).cpu().numpy()
    return {'framebits': framebits,
            'digests': [hashlib.sha256(np.packbits(row).tobytes()).hexdigest()
                        for row in bits.astype(np.uint8)]}


def compare(tracker: dict, viterbi: dict, ref: dict) -> dict[str, float]:
    """Hold a replay against the record: raises AssertionError where an
    integer field or a digest differs; returns the largest absolute
    difference of each float field (event fields as 'ev.<index>')."""
    rt, rv = ref['tracker'], ref['viterbi']
    if viterbi != rv:
        raise AssertionError('Viterbi digests differ from the record')
    if tracker['blk'] != rt['blk']:
        raise AssertionError(f'block length {tracker["blk"]}, recorded '
                             f'{rt["blk"]}')
    diffs: dict[str, float] = {}

    def worst(name, got, want):
        d = float(np.max(np.abs(np.asarray(got, float)
                                - np.asarray(want, float))))
        diffs[name] = max(diffs.get(name, 0.0), d)

    for b in range(2):
        got = np.asarray(tracker['ev_tables'][b]).reshape(2, -1, EV_FIELDS)
        want = np.asarray(rt['ev_tables'][b]).reshape(2, -1, EV_FIELDS)
        for i in range(EV_FIELDS):
            if i in EV_INT_FIELDS:
                if not np.array_equal(got[:, :, i], want[:, :, i]):
                    raise AssertionError(f'block {b}: event field {i} '
                                         'differs from the record')
            else:
                worst(f'ev.{i}', got[:, :, i], want[:, :, i])
        if tracker['counters'][b] != rt['counters'][b]:
            raise AssertionError(f'block {b}: counters differ')
    for f in STATE_INT:
        if tracker['state_int'][f] != rt['state_int'][f]:
            raise AssertionError(f'state field {f} differs from the record')
    for f in STATE_FLOAT:
        worst(f'state.{f}', tracker['state_float'][f], rt['state_float'][f])
    for f in ('sym_sum_re', 'sym_sum_im', 'sym_absmax'):
        worst(f, tracker[f], rt[f])
    return diffs


def over_tolerance(diffs: dict[str, float]) -> dict[str, float]:
    """The float fields of compare's result that miss their bound."""
    return {f: d for f, d in diffs.items()
            if d > FLOAT_TOLERANCE.get(f, DEFAULT_TOLERANCE)}
