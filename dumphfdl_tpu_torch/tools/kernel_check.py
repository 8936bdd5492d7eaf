"""Checks of the two hand-written kernels on one NVIDIA GPU, shared by
chip_smoke.py and the cross-process mesh's child program (tools/mesh_mp.py).

* Roofline bounds of a K1 or K2 call (``k1_bound``, ``k2_bound``): the
  larger of the bytes the call must move over the memory rate and its
  operations over the float32 rate, from the shapes of the call.
* CUDA-event timers (``cuda_ms``, ``timed_ms``).
* The wrappers' launch counts, all four at once (``zero_launches``,
  ``launches``): every path that reports launches counts through these.
* K2's wrapper against its plain version (``k2_pair``, ``compare_k2``).
* ``recording()`` keeps what every shard of a mesh hands K2's and K1's
  wrappers in its own stream during a pass, and ``check_shard_blocks``
  holds both wrappers exact against their plain versions on one shard's
  own blocks and times them, K2 also by its launch alone (``k2_entry``,
  ``k1_entry``: one block each).
* ``first_frame_block(rows)`` keeps, during a run on one device, the first
  block that completes a frame (cut to `rows` channels from the first tile
  that completes one) and that block's event block; ``check_frame_block``
  holds both wrappers exact against their plain versions on them and
  times them (tools/bench.py's rungs).

Nothing here runs without a CUDA device but the bounds and the counts.
"""

from __future__ import annotations

import contextlib

import torch

# NVIDIA H100 SXM data sheet: device memory rate, and the float32 rate
# outside the tensor cores (taken for the integer add-compare-select too)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per step, counted from the kernels' sources: K1 does, for each
# of the 32 butterflies of a bit, 5 for the branch metric, 4 adds, 2
# compares and 2 selects; K2 does about 400 float operations per channel
# and symbol outside a frame's training (interpolations 90, rotations 12,
# equalizer 120, two cosine/sine pairs 60, arctangent and the loops' updates
# the rest)
K1_OPS_PER_BIT = 32 * 13
K2_OPS_PER_SYMBOL = 400


def zero_launches() -> None:
    """Sets every kernel wrapper's launch count to 0."""
    from ..dsp import tracker_cuda
    from ..ops import fec_cuda
    fec_cuda.launches = fec_cuda.one_mode_launches = 0
    tracker_cuda.launches = tracker_cuda.taps_launches = 0


def launches() -> dict:
    """Every wrapper's launch count, by the kernels line's entry names."""
    from ..dsp import tracker_cuda
    from ..ops import fec_cuda
    return {'viterbi27': fec_cuda.launches,
            'viterbi27_one_mode': fec_cuda.one_mode_launches,
            'tracker': tracker_cuda.launches,
            'tracker_taps': tracker_cuda.taps_launches}


def bound(n_bytes: int, n_ops: int) -> dict:
    """Roofline bound of a call that must move n_bytes and do n_ops."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by='bytes' if t_b >= t_o else 'operations',
                bound_bytes=n_bytes, bound_ops=n_ops)


def k1_bound(softs, outs) -> dict:
    """Chips read once, bits written once; 416 operations per decoded bit.
    chain_steps: the dependent steps of the longest frame (its bits
    forward, then a lane's share of the traceback with its merge run)."""
    n_bytes = sum(a.numel() * a.element_size() for a in (*softs, *outs))
    longest = max(o.shape[1] for o in outs)
    return dict(bound(n_bytes, K1_OPS_PER_BIT * sum(o.numel() for o in outs)),
                chain_steps=longest + -(-(longest - 6) // 32) + 96)


def k2_bound(nch: int, t_len: int, n_sym: int, taps: bool = False) -> dict:
    """What one tracker call must move, in 4-byte words: x (nch, t_len)
    complex64 in, one level sample per channel and symbol in (the function
    needs no other of the (nch, t_len) level), sym_re/sym_im/packed
    (n_sym, c_pad) out, the state planes (8 + 19 + 60 + 4 rows of c_pad)
    in and out, the shifts (c_pad) in, the event table (44) and counters
    (4) out, and with taps three more (n_sym, c_pad) planes out.
    chain_steps: the symbols of a channel, each depending on the one
    before."""
    c_pad = -(-nch // 128) * 128
    words = nch * (2 * t_len + n_sym) \
        + c_pad * ((6 if taps else 3) * n_sym + 2 * 91 + 1 + 48)
    return dict(bound(4 * words, K2_OPS_PER_SYMBOL * nch * n_sym),
                chain_steps=n_sym)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (after one
    warm-up call), timed with CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(fn):
    """(fn(), device milliseconds of that one call), CUDA-event timed."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    """Max |a-b| after asserting |a-b| <= tol + tol*|b| elementwise."""
    d = (a - b).abs()
    if bool((d > tol + tol * b.abs()).any()):
        raise AssertionError(f'max |diff| {float(d.max())} beyond {tol}')
    return float(d.max()) if d.numel() else 0.0


def compare_k2(what, s1, o1, e1, c1, s2, o2, e2, c2, tol) -> float:
    """Two K2 results (state, outputs, events, counters) against each
    other: floats within tol, everything else equal; returns max |diff|."""
    from ..dsp.tracker import TrackerState
    err = 0.0
    for f in TrackerState._fields:
        a, b = getattr(s1, f), getattr(s2, f)
        if a is None or b is None:
            if a is not b:
                raise AssertionError(f'K2 {what}: state field {f} differs')
        elif a.is_floating_point() or a.is_complex():
            err = max(err, close(a, b, tol))
        elif not torch.equal(a, b):
            raise AssertionError(f'K2 {what}: state field {f} differs')
    err = max(err, close(o1.sym, o2.sym, tol))
    for name, a, b in (('is_data', o1.is_data, o2.is_data),
                       ('data_idx', o1.data_idx, o2.data_idx),
                       ('frame_parity', o1.frame_parity, o2.frame_parity),
                       ('events', e1, e2), ('counters', c1, c2)):
        if not torch.equal(a, b):
            raise AssertionError(f'K2 {what}: {name} differ')
    return err


def k2_pair(state, x, lvl, steps: int, use_acq: bool):
    """(wrapper result, plain result, plain ms): the wrapper launches K2;
    the plain version runs with the tile activity and acq_hit carry the
    wrapper derives (tracker_cuda.tile_activity)."""
    from ..dsp import tracker as trk
    from ..dsp import tracker_cuda as tc
    before = tc.launches
    r_k = tc.tracker_block(state, x, lvl, steps, use_acq=use_acq)
    if tc.launches != before + 1:
        raise AssertionError('K2 wrapper did not launch its kernel')
    act, hits = tc.tile_activity(state, x, use_acq)
    r_p, t_p = timed_ms(lambda: trk.tracker_block(state, x, lvl, steps, act))
    return r_k, (r_p[0]._replace(acq_hit=hits), *r_p[1:]), t_p


@contextlib.contextmanager
def recording():
    """While open, every call of tracker_cuda.tracker_block and
    fec_cuda.viterbi_decode_many is recorded, by the shard that made it (a
    shard is known by its device and the stream its work is in): yields
    (k2_seen, k1_seen), dicts of lists of the calls' inputs (the carried
    TrackerState and the blocks; the soft chips and frame lengths)."""
    from ..dsp import tracker as trk
    from ..dsp import tracker_cuda as tc
    from ..ops import fec_cuda
    k2_seen, k1_seen = {}, {}
    k2_wrapper, k1_wrapper = tc.tracker_block, fec_cuda.viterbi_decode_many

    def shard_of(t):
        return str(t.device), torch.cuda.current_stream(t.device).cuda_stream

    def k2_recording(state, x, level, num_steps, use_acq=True,
                     debug_taps=False):
        k2_seen.setdefault(shard_of(x), []).append(
            (trk.TrackerState(*[None if v is None else v.clone()
                                for v in state]),
             x.clone(), level.clone(), num_steps, use_acq, debug_taps))
        return k2_wrapper(state, x, level, num_steps, use_acq, debug_taps)

    def k1_recording(softs, nbits):
        k1_seen.setdefault(shard_of(softs[0]), []).append(
            ([s.clone() for s in softs], list(nbits)))
        return k1_wrapper(softs, nbits)

    tc.tracker_block = k2_recording
    fec_cuda.viterbi_decode_many = k1_recording
    try:
        yield k2_seen, k1_seen
    finally:
        tc.tracker_block = k2_wrapper
        fec_cuda.viterbi_decode_many = k1_wrapper


def k2_entry(state, x, lvl, steps: int, what: str) -> dict:
    """K2's wrapper on one recorded block (gate on, carried state) against
    the plain version: exact, or it raises; then timed through the wrapper
    and by its launch alone.  Returns the block's line: shape, tiles,
    events, times and the bound of the work of its active tiles."""
    from ..dsp import tracker as trk
    from ..dsp import tracker_cuda as tc
    act, _ = tc.tile_activity(state, x, True)
    r_k, r_p, t_p = k2_pair(state, x, lvl, steps, use_acq=True)
    if compare_k2(what, *r_k, *r_p, tol=0.0) != 0.0:
        raise AssertionError(f'K2 {what}: not exact')
    ev = r_k[2].reshape(-1, trk.K_EVENTS, trk.EV_FIELDS)
    tiles = int(act.sum())
    return dict(
        channels=x.shape[0], symbols=steps, gate=True, active_tiles=tiles,
        tiles=len(act), events=int((ev[:, :, 0] > 0.5).sum()),
        max_abs_err=0.0,
        kernel_ms=cuda_ms(lambda: tc.tracker_block(state, x, lvl, steps,
                                                   use_acq=True), 5),
        kernel_alone_ms=tc.kernel_alone_ms(state, x, lvl, steps),
        plain_ms=t_p,
        # the work of this block's data: its active tiles' channels
        **k2_bound(tiles * trk.CT, x.shape[1], steps))


def k1_entry(softs, nbits, what: str) -> dict:
    """K1's wrapper on one recorded event block against the plain version:
    bit-exact, or it raises; timed.  Returns the event block's line."""
    from ..ops import fec, fec_cuda
    before = fec_cuda.launches
    got = fec_cuda.viterbi_decode_many(softs, nbits)
    if fec_cuda.launches != before + 1:
        raise AssertionError(f'K1 {what}: the wrapper did not launch')
    plain, t_p = timed_ms(lambda: [fec.viterbi_decode(s_, n_)
                                   for s_, n_ in zip(softs, nbits)])
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        raise AssertionError(f'K1 {what}: differs from the plain version')
    return dict(frames=[int(s_.shape[0]) for s_ in softs], nbits=list(nbits),
                bit_exact=True,
                kernel_ms=cuda_ms(lambda: fec_cuda.viterbi_decode_many(
                    softs, nbits), 20),
                plain_ms=t_p, **k1_bound(softs, got))


@contextlib.contextmanager
def first_frame_block(rows: int):
    """While open, keeps the inputs of the first call of
    tracker_cuda.tracker_block whose block completes a frame, cut to `rows`
    channels of whole acquisition-gate tiles (trk.CT, 128 channels) from
    the tile of the first channel that completes one (each channel's
    recursion is its own, and the gate decides tile by tile), and the first
    call of fec_cuda.viterbi_decode_many after it: that block's event
    block, as events are collected one block behind and no block before it
    completed a frame.  Yields a dict that gets 'k2': (state, x, level,
    num_steps), 'rows': [first, end) and 'k1': (softs, nbits)."""
    from ..dsp import tracker as trk
    from ..dsp import tracker_cuda as tc
    from ..ops import fec_cuda
    if rows % trk.CT:
        raise ValueError(f'{rows} rows are no whole number of tiles')
    kept = {}
    k2_wrapper, k1_wrapper = tc.tracker_block, fec_cuda.viterbi_decode_many

    def k2_keeping(state, x, level, num_steps, use_acq=True,
                   debug_taps=False):
        if 'k2' in kept or debug_taps or not use_acq:
            return k2_wrapper(state, x, level, num_steps, use_acq, debug_taps)
        # the caller may write the new state into the old one's buffers
        before = trk.TrackerState(*[None if v is None else v.clone()
                                    for v in state])
        out = k2_wrapper(state, x, level, num_steps, use_acq, debug_taps)
        done = (out[2].reshape(-1, trk.K_EVENTS, trk.EV_FIELDS)[:, :, 0]
                > 0.5).any(dim=1).nonzero()
        if len(done):
            c = x.shape[0]
            first = min(int(done[0]) // trk.CT,
                        max(c - rows, 0) // trk.CT) * trk.CT
            cut = slice(first, first + rows)
            kept['k2'] = (trk.TrackerState(*[None if v is None
                                             else v[cut].clone()
                                             for v in before]),
                          x[cut].clone(), level[cut].clone(), num_steps)
            kept['rows'] = [first, min(first + rows, c)]
        return out

    def k1_keeping(softs, nbits):
        if 'k2' in kept and 'k1' not in kept:
            kept['k1'] = ([s.clone() for s in softs], list(nbits))
        return k1_wrapper(softs, nbits)

    tc.tracker_block = k2_keeping
    fec_cuda.viterbi_decode_many = k1_keeping
    try:
        yield kept
    finally:
        tc.tracker_block = k2_wrapper
        fec_cuda.viterbi_decode_many = k1_wrapper


def check_frame_block(kept: dict) -> dict:
    """The blocks first_frame_block kept, each wrapper against its plain
    version (exact) and timed: {'k2': K2's line, 'k1': K1's line}."""
    if set(kept) != {'k2', 'rows', 'k1'}:
        raise AssertionError(f'no frame block recorded: {sorted(kept)}')
    st, x, lvl, steps = kept['k2']
    with torch.cuda.device(x.device):
        k2 = k2_entry(st, x, lvl, steps, 'first frame block')
        if k2['events'] < 1:
            raise AssertionError('K2: the kept block completed no frame')
        return dict(k2=dict(rows=kept['rows'], **k2),
                    k1=k1_entry(*kept['k1'], 'first frame block'))


def check_shard_blocks(k2_seen: dict, k1_seen: dict, rows: int,
                       shards: int, n_sym: int = 1800) -> dict:
    """The recorded calls of a mesh pass over `shards` shards, each of
    `rows` channels in blocks of n_sym symbols, gate on.  For the last
    shard that decoded frames: K2 on two consecutive blocks, the second the
    first that completes a frame, and K1 on the shard's first two event
    blocks, each exact against its plain version and timed (K2 through its
    wrapper and by its launch alone).  Returns {'shard_device', 'blocks',
    'k2': [one dict per K2 block], 'k1': [one dict per event block]}."""
    from ..dsp import tracker as trk
    from ..dsp import tracker_cuda as tc
    blocks = {len(v) for v in k2_seen.values()}
    if len(k2_seen) != shards or len(blocks) != 1 or not k1_seen or \
            not set(k1_seen) <= set(k2_seen):
        raise AssertionError(f'mesh kernels: K2 calls from {len(k2_seen)} '
                             f'streams ({blocks} blocks each), K1 calls '
                             f'from {len(k1_seen)}')
    shard = list(k1_seen)[-1]
    seen = k2_seen[shard]
    out = dict(shard_device=shard[0], blocks=len(seen), k2=[], k1=[])
    with torch.cuda.device(seen[0][1].device):
        # the first block of this shard that completes a frame, and the one
        # before it
        first = None
        for i, (st, x, lvl, steps, use_acq, taps) in enumerate(seen):
            if (tuple(x.shape), steps, use_acq, taps) != \
                    ((rows, 3 * n_sym + trk.HALO), n_sym, True, False):
                raise AssertionError(f'mesh K2: a shard handed the wrapper '
                                     f'{tuple(x.shape)}, {steps}, {use_acq}')
            ev = tc.tracker_block(st, x, lvl, steps, use_acq)[2]
            if first is None and bool(
                    (ev.reshape(-1, trk.K_EVENTS, trk.EV_FIELDS)[:, :, 0]
                     > 0.5).any()):
                first = i
        if not first:
            raise AssertionError(f'mesh K2: no block after the first '
                                 f'completes a frame ({first})')
        for i in (first - 1, first):
            st, x, lvl, steps, _, _ = seen[i]
            out['k2'].append(dict(block=i, **k2_entry(
                st, x, lvl, steps, f'mesh block {i}')))
        last = out['k2'][-1]
        if last['events'] < 1 or last['active_tiles'] < 1:
            raise AssertionError('mesh K2: the compared block carried no '
                                 'frame')
        # K1 on the event blocks the same shard decoded
        for j, (softs, nbits) in enumerate(k1_seen[shard][:2]):
            out['k1'].append(dict(event_block=j,
                                  event_blocks=len(k1_seen[shard]),
                                  **k1_entry(softs, nbits, f'event block {j}')))
    return out
