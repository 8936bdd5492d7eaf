"""PyTorch port, dsp/tracker and dsp/tracker_cuda: the plain symbol loop
(kernel K2's plain version) and the acquisition gate against the JAX
scan tracker and the Pallas kernel (interpret mode).

Tolerances are those between the JAX scan and Pallas trackers
(tests/test_tracker_pallas.py): state 2e-5, symbols 2e-5; integer state,
per-symbol labels, counters and the integer event fields exact.  The
float event fields (frequency error, signal level, noise floor) are
within 2e-5: they are snapshots of float state."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dumphfdl_tpu import constants as C  # noqa: E402
from dumphfdl_tpu.dsp import modulator as jmod  # noqa: E402
from dumphfdl_tpu.dsp import tracker as jtrk  # noqa: E402
from dumphfdl_tpu.dsp.channel import agc_block, agc_init, matched_filter  # noqa: E402
from dumphfdl_tpu.dsp.tracker_pallas import acq_hits as jacq_hits  # noqa: E402
from dumphfdl_tpu.dsp.tracker_pallas import tracker_block_pallas  # noqa: E402
from dumphfdl_tpu_torch.dsp import tracker as trk  # noqa: E402
from dumphfdl_tpu_torch.dsp import tracker_cuda  # noqa: E402

TOL = 2e-5
EV_INT_FIELDS = [0, 1, 2, 3, 7, 8, 9, 10]
EV_FLOAT_FIELDS = [4, 5, 6]


def _np_state(st):
    return jax.tree.map(np.asarray, st)


def _assert_state_close(js, ts, tol=TOL):
    ts = trk.state_to_numpy(ts)
    for f in jtrk.TrackerState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f)
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f'state field {f}')
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=f'state field {f}')


def _assert_events(jev, tev):
    jev = np.asarray(jev).reshape(-1, trk.K_EVENTS, trk.EV_FIELDS)
    tev = tev.numpy().reshape(jev.shape)
    np.testing.assert_array_equal(tev[..., EV_INT_FIELDS],
                                  jev[..., EV_INT_FIELDS])
    np.testing.assert_allclose(tev[..., EV_FLOAT_FIELDS],
                               jev[..., EV_FLOAT_FIELDS], rtol=TOL, atol=TOL)


def _assert_outputs(jo, to):
    np.testing.assert_allclose(to.sym.numpy(), np.asarray(jo.sym), atol=TOL)
    for f in ('is_data', 'data_idx', 'frame_parity'):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)


def test_tables_are_copies():
    for a, b in zip(trk._interp_banks(), jtrk._interp_banks()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trk._init_eq_taps(), jtrk._init_eq_taps())
    assert (trk.HALO, trk.SLAB_BASE_OFF, trk.K_EVENTS, trk.EV_FIELDS) == \
        (jtrk.HALO, jtrk.SLAB_BASE_OFF, jtrk.K_EVENTS, jtrk.EV_FIELDS)


def test_init_and_numpy_roundtrip():
    js = _np_state(jtrk.tracker_init(5))
    ts = trk.tracker_init(5, 'cpu')
    _assert_state_close(js, ts, tol=0)
    back = trk.state_to_numpy(trk.state_from_numpy(js, 'cpu'))
    for f in jtrk.TrackerState._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(js, f))
        assert getattr(back, f).dtype == getattr(js, f).dtype, f


def test_framer_fsm_matches_jax():
    """Both copies of the framer FSM give the same transitions on random
    states and correlator values (every state, threshold and counter)."""
    rng = np.random.default_rng(0)
    n = 4000
    i = lambda lo, hi: rng.integers(lo, hi, n).astype(np.int32)
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    args = dict(fr=i(1, 8), sw=i(0, 3), retries=i(0, 3),
                bitmask=rng.random(n) < 0.5, mode=i(0, 8),
                data_arity=i(1, 4), cur_arity=i(1, 4), segs_left=i(0, 3),
                eq_cnt=i(0, 3), t_idx=i(0, 16), data_idx=i(0, 100),
                freq_err=f(-5, 5), frame_start=i(0, 10000), sig=f(0, 1),
                fsc=f(0, 100), lvl=f(0, 1), dphi=f(-0.01, 0.01),
                abs_symbol=i(1000, 100000), train_bad=i(0, 9),
                train_total=i(0, 99), corr_a=f(-0.6, 0.6),
                corr_m1=f(0, 0.6), m1_match=i(0, 8))
    segs = np.asarray([m.data_segment_cnt for m in C.MODES], np.int32)
    arity = np.asarray([m.arity for m in C.MODES], np.int32)
    ju, jf = jtrk.framer_fsm_step(
        **{k: jnp.asarray(v) for k, v in args.items()},
        mode_lookup=lambda m: (jnp.asarray(segs)[m], jnp.asarray(arity)[m]),
        as_flag=lambda b: b)
    tu, tf = trk.framer_fsm_step(
        **{k: torch.as_tensor(v) for k, v in args.items()},
        mode_segments=torch.as_tensor(segs), mode_arity=torch.as_tensor(arity))
    for k in ju:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                   rtol=1e-6, err_msg=k)
    for k in jf:
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]),
                                      err_msg=k)


def test_noise_block_parity():
    """4 channels x 100 symbols of noise, gate off: state, symbols,
    events and counters against the scan tracker."""
    nch, steps = 4, 100
    t = steps * 3 + trk.HALO
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((nch, t))
         + 1j * rng.standard_normal((nch, t))).astype(np.complex64)
    lvl = np.abs(rng.standard_normal((nch, t)).astype(np.float32)) + 0.5
    js = jtrk.tracker_init(nch)
    s1, o1, ev1, c1 = jtrk.tracker_block(js, jnp.asarray(x), jnp.asarray(lvl),
                                         steps)
    s2, o2, ev2, c2 = tracker_cuda.tracker_block(
        trk.state_from_numpy(_np_state(js), 'cpu'), torch.as_tensor(x),
        torch.as_tensor(lvl), steps, use_acq=False)
    _assert_state_close(_np_state(s1), s2)
    _assert_outputs(o1, o2)
    _assert_events(ev1, ev2)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(c1))


def test_frame_block_from_jax_state():
    """A mode-1 frame with CFO and timing offset over two blocks: the JAX
    scan tracker runs block 1, its state is carried into the port, and
    block 2 (where the frame completes) runs in both."""
    rng = np.random.default_rng(5)
    pdu = jmod.make_test_mpdu(1, rng, icao=0x3C0001)
    iq = jmod.synthesize_iq(jmod.frame_symbols(pdu, 1), imp=jmod.Impairments(
        snr_db=30.0, cfo_hz=12.0, timing_offset=0.4, seed=3))
    noise = (rng.standard_normal(len(iq))
             + 1j * rng.standard_normal(len(iq))).astype(np.complex64) * 0.01
    x = np.stack([iq, noise]).astype(np.complex64)
    blk = (len(iq) // 2 // 3) * 3
    _, y, lv = agc_block(agc_init(2), jnp.asarray(x[:, :2 * blk]))
    mf = jnp.concatenate([jnp.zeros((2, trk.HALO), jnp.complex64),
                          matched_filter(y)], axis=1)
    lve = jnp.concatenate([jnp.ones((2, trk.HALO), jnp.float32), lv], axis=1)
    steps = blk // 3
    js, _, ev_a, _ = jtrk.tracker_block(jtrk.tracker_init(2),
                                        mf[:, :blk + trk.HALO],
                                        lve[:, :blk + trk.HALO], steps)
    assert not (np.asarray(ev_a)[:, 0] > 0.5).any()
    x2, l2 = mf[:, blk:], lve[:, blk:]
    s1, o1, ev1, c1 = jtrk.tracker_block(js, x2, l2, steps)
    s2, o2, ev2, c2 = tracker_cuda.tracker_block(
        trk.state_from_numpy(_np_state(js), 'cpu'),
        torch.as_tensor(np.array(x2)), torch.as_tensor(np.array(l2)),
        steps, use_acq=False)
    assert (np.asarray(ev1)[:, 0] > 0.5).sum() == 1
    _assert_events(ev1, ev2)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(c1))
    _assert_state_close(_np_state(s1), s2)
    _assert_outputs(o1, o2)


def test_gated_idle_parity(monkeypatch):
    """The gate on pure noise, against the Pallas kernel in interpret
    mode (as tests/test_tracker_pallas.py:test_gated_idle_parity): the
    idle path is exact for events, counters and clocks."""
    monkeypatch.setenv('DUMPHFDL_PALLAS_SYMS', '128')
    nch, steps = 3, 300
    t = steps * 3 + trk.HALO
    rng = np.random.default_rng(3)
    x = ((rng.standard_normal((nch, t))
          + 1j * rng.standard_normal((nch, t))) * 0.2).astype(np.complex64)
    lvl = np.abs(rng.standard_normal((nch, t)).astype(np.float32)) + 0.5
    js = jtrk.tracker_init(nch)
    s1, o1, ev1, c1 = tracker_block_pallas(js, jnp.asarray(x),
                                           jnp.asarray(lvl), steps)
    s2, o2, ev2, c2 = tracker_cuda.tracker_block(
        trk.state_from_numpy(_np_state(js), 'cpu'), torch.as_tensor(x),
        torch.as_tensor(lvl), steps)
    np.testing.assert_array_equal(ev2.numpy(), np.asarray(ev1))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(c1))
    for f in ('abs_symbol', 'out_idx', 'symbol_cnt', 'nf_clk', 'fr_state',
              'symbols_wanted', 'frame_counter', 'acq_hit'):
        np.testing.assert_array_equal(getattr(s2, f).numpy(),
                                      np.asarray(getattr(s1, f)), err_msg=f)
    np.testing.assert_allclose(s2.noise_floor.numpy(),
                               np.asarray(s1.noise_floor), rtol=1e-6)
    np.testing.assert_allclose(s2.tau.numpy(), np.asarray(s1.tau), atol=1e-3)
    assert not o2.is_data.any()


def test_idle_update_follows_the_loop():
    """The closed-form idle update equals the symbol loop for a hunting
    channel on its clocks, watchdog and noise-floor EMA -- including an
    EMA clock carried past its period out of a frame."""
    nch, steps = 4, 400
    t = steps * 3 + trk.HALO
    rng = np.random.default_rng(8)
    x = torch.as_tensor(((rng.standard_normal((nch, t))
                          + 1j * rng.standard_normal((nch, t))) * 0.05)
                        .astype(np.complex64))
    lvl = torch.as_tensor(rng.uniform(0.1, 2.0, (nch, t)).astype(np.float32))
    st = trk.tracker_init(nch, 'cpu')._replace(
        nf_clk=torch.tensor([0, 84, 85, 3000], dtype=torch.int32),
        symbol_cnt=torch.tensor([0, C.MAX_SYMBOLS_WITHOUT_FRAME - 50, 7, 0],
                                dtype=torch.int32))
    loop, _, _, _ = trk.tracker_block(st, x, lvl, steps)
    idle, _, _, _ = trk.tracker_block(st, x, lvl, steps, torch.tensor([0]))
    for f in ('noise_floor', 'nf_clk', 'abs_symbol', 'out_idx', 'symbol_cnt',
              'fr_state'):
        assert torch.equal(getattr(loop, f), getattr(idle, f)), f


def test_acq_hits_match_jax():
    rng = np.random.default_rng(11)
    pdu = jmod.make_test_mpdu(0, rng)
    iq = jmod.synthesize_iq(jmod.frame_symbols(pdu, 0), imp=jmod.Impairments(
        snr_db=3.0, cfo_hz=45.0, timing_offset=0.3, seed=4))
    n = (len(iq) // 3) * 3
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64) * 0.1
    _, y, _ = agc_block(agc_init(2), jnp.asarray(np.stack([iq[:n], noise])))
    mf = np.asarray(matched_filter(y))
    want = np.asarray(jacq_hits(jnp.asarray(mf), 0.5))
    got = tracker_cuda.acq_hits(torch.as_tensor(mf), 0.5).numpy()
    assert got.tolist() == want.tolist() == [1, 0]


def _noise_block(nch, steps, seed):
    t = steps * 3 + trk.HALO
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((nch, t))
         + 1j * rng.standard_normal((nch, t))).astype(np.complex64)
    lvl = np.abs(rng.standard_normal((nch, t)).astype(np.float32)) + 0.5
    return x, lvl


def test_debug_taps_are_refused():
    """debug_taps is not refused: the wrapper returns the loop's per-symbol
    internals (Costas frequency, clamped phase error, timing fraction) like
    the JAX scan tracker: (T, C, 3), 2e-5."""
    nch, steps = 3, 120
    x, lvl = _noise_block(nch, steps, 11)
    js = jtrk.tracker_init(nch)
    s1, o1, ev1, c1 = jtrk.tracker_block(js, jnp.asarray(x), jnp.asarray(lvl),
                                         steps, debug_taps=True)
    s2, o2, ev2, c2 = tracker_cuda.tracker_block(
        trk.state_from_numpy(_np_state(js), 'cpu'), torch.as_tensor(x),
        torch.as_tensor(lvl), steps, debug_taps=True)
    assert o2.taps.shape == (steps, nch, 3) == np.asarray(o1.taps).shape
    np.testing.assert_allclose(o2.taps.numpy(), np.asarray(o1.taps),
                               rtol=TOL, atol=TOL)
    assert float(o2.taps.abs().amax(dim=(0, 1)).min()) > 0   # all 3 planes
    _assert_state_close(_np_state(s1), s2)
    _assert_outputs(o1, o2)
    _assert_events(ev1, ev2)


@pytest.mark.parametrize('use_acq', [False, True])
def test_debug_taps_change_nothing_else(use_acq):
    """With the taps on the gate is off (as in the JAX package), so state,
    symbols, events and counters are bit-equal to a taps-off block with the
    gate off, whatever use_acq says; without debug_taps there are no taps."""
    nch, steps = 3, 400            # long enough for the gate to assess
    x, lvl = _noise_block(nch, steps, 12)
    x *= 0.2
    st = trk.tracker_init(nch, 'cpu')
    args = (st, torch.as_tensor(x), torch.as_tensor(lvl), steps)
    off = tracker_cuda.tracker_block(*args, use_acq=False)
    on = tracker_cuda.tracker_block(*args, use_acq=use_acq, debug_taps=True)
    assert off[1].taps is None
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    for f in ('sym', 'is_data', 'data_idx', 'frame_parity'):
        assert torch.equal(getattr(on[1], f), getattr(off[1], f)), f
    assert torch.equal(on[2], off[2]) and torch.equal(on[3], off[3])
    if use_acq:     # the gate alone would have idled this all-noise tile
        gated = tracker_cuda.tracker_block(*args, use_acq=True)
        assert not torch.equal(gated[1].sym, off[1].sym)


def test_debug_taps_on_a_frame():
    """The taps over a block that holds a frame's preamble and training,
    from the JAX scan tracker's state after the block before."""
    rng = np.random.default_rng(7)
    pdu = jmod.make_test_mpdu(0, rng, icao=0x3C0002)
    iq = jmod.synthesize_iq(jmod.frame_symbols(pdu, 0), imp=jmod.Impairments(
        snr_db=25.0, cfo_hz=-8.0, timing_offset=0.3, seed=4))
    x = iq[None, :].astype(np.complex64)
    blk = 1500
    _, y, lv = agc_block(agc_init(1), jnp.asarray(x[:, :2 * blk]))
    mf = jnp.concatenate([jnp.zeros((1, trk.HALO), jnp.complex64),
                          matched_filter(y)], axis=1)
    lve = jnp.concatenate([jnp.ones((1, trk.HALO), jnp.float32), lv], axis=1)
    steps = blk // 3
    js, _, _, _ = jtrk.tracker_block(jtrk.tracker_init(1),
                                     mf[:, :blk + trk.HALO],
                                     lve[:, :blk + trk.HALO], steps)
    x2, l2 = mf[:, blk:], lve[:, blk:]
    _, o1, _, _ = jtrk.tracker_block(js, x2, l2, steps, debug_taps=True)
    _, o2, _, _ = tracker_cuda.tracker_block(
        trk.state_from_numpy(_np_state(js), 'cpu'),
        torch.as_tensor(np.array(x2)), torch.as_tensor(np.array(l2)), steps,
        debug_taps=True)
    # the timing fraction wraps at 1: compare it on the circle
    d = o2.taps.numpy() - np.asarray(o1.taps)
    d[..., 2] = (d[..., 2] + 0.5) % 1.0 - 0.5
    assert np.abs(d).max() <= 1e-4
    _assert_outputs(o1, o2)
