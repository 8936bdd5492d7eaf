"""PyTorch port, dsp/superstep: the super-block plan, the static coset
resampler, the device form of the symbol ring's cursor, and one whole
superstep decode against the JAX superstep (DUMPHFDL_NO_SUPERSTEP unset,
one device).

The decode runs at 192 kHz with 4 channels, where the plan is 4032 samples
(1344 symbols) and 5 frames of a 32768-point FFT per block.  Integer event
fields and PDU bytes are exact; the float event fields agree to 1e-4:
signal level and noise floor relative and absolute, the frequency error in
the Costas loop's own unit (radians per half-symbol; the event holds it in
Hz, 286 times that).  They are snapshots of float state after thousands of
symbols whose sums the two frameworks order differently."""

import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

# the superstep is a one-device path: keep the JAX bank off the test mesh
os.environ['DUMPHFDL_NO_AUTOSHARD'] = '1'

from dumphfdl_tpu.dsp import frontend as jfe  # noqa: E402
from dumphfdl_tpu.dsp import superstep as jss  # noqa: E402
from dumphfdl_tpu.dsp.receiver import WidebandReceiver as JReceiver  # noqa: E402
from dumphfdl_tpu_torch import constants as C  # noqa: E402
from dumphfdl_tpu_torch.dsp import channel, modulator, superstep  # noqa: E402
from dumphfdl_tpu_torch.dsp import frontend as fe  # noqa: E402
from dumphfdl_tpu_torch.dsp.receiver import WidebandReceiver  # noqa: E402
from dumphfdl_tpu_torch.io import formats  # noqa: E402

# rates whose cadence aligns within the symbol ring's invariant, with the
# plan's (out_chunk, frames), and rates where it cannot
ALIGNED = {96_000: (4032, 5), 192_000: (4032, 5), 384_000: (4032, 5),
           768_000: (4032, 5), 1_024_000: (6048, 5),
           3_456_000: (10752, 15), 6_912_000: (10752, 15)}
UNALIGNED = (2_160_000, 2_400_000, 4_000_000, 8_000_000, 10_000_000,
             12_000_000)


@pytest.mark.parametrize('fs', list(ALIGNED) + list(UNALIGNED))
def test_plan_superstep_matches_jax(fs):
    center = 10_000_000
    chz = fe.Channelizer(fs, center, [center + 3000], 'cpu')
    jchz = jfe.Channelizer(fs, center, [center + 3000])
    plan, jplan = superstep.plan_superstep(chz), jss.plan_superstep(jchz)
    if fs in UNALIGNED:
        assert plan is None and jplan is None
        return
    assert plan.__dict__ == jplan.__dict__
    assert (plan.out_chunk, plan.frames) == ALIGNED[fs]
    assert plan.symbols == jplan.symbols == plan.out_chunk // 3
    assert plan.wb_chunk == plan.frames * chz.geo.input_size
    assert plan.frames % plan.sub == 0


def test_plan_respects_the_symbol_limit():
    chz = fe.Channelizer(192_000, 10_000_000, [10_003_000], 'cpu')
    assert superstep.plan_superstep(chz, max_symbols=1343) is None
    assert superstep.plan_superstep(chz, max_symbols=1344).symbols == 1344


FS, CENTER = 192_000, 10_000_000
FREQS = [CENTER + d for d in (-60_000, -20_000, 20_000, 60_000)]


def _receivers(monkeypatch, fmt='CS16', block=5400):
    monkeypatch.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
    rx = WidebandReceiver(FS, CENTER, FREQS, 'cpu', block_len=block,
                          sample_format=fmt)
    jrx = JReceiver(FS, CENTER, FREQS, block_len=block, sample_format=fmt)
    return rx, jrx


def test_engagement_rule(monkeypatch):
    """The superstep engages where the JAX receiver engages it: an aligned
    rate, a block length of at least the aligned block, and the environment
    not saying no (read at construction)."""
    rx, jrx = _receivers(monkeypatch)
    assert rx.superstep is not None and jrx.superstep is not None
    assert rx.superstep.plan.__dict__ == jrx.superstep.plan.__dict__
    assert rx.raw_chunk_bytes == jrx.raw_chunk_bytes == 143_360 * 4
    assert rx.superstep.delay_symbols == jrx.superstep.delay_symbols == 1344
    assert not rx.superstep.use_graph          # a CPU engine steps eagerly
    short, jshort = _receivers(monkeypatch, block=2016)
    assert short.superstep is None and jshort.superstep is None
    assert short.fused and short.raw_chunk_bytes is None
    monkeypatch.setenv('DUMPHFDL_NO_SUPERSTEP', '1')
    assert WidebandReceiver(FS, CENTER, FREQS, 'cpu').superstep is None
    with pytest.raises(TypeError):          # the device decides, no option
        superstep.SuperstepEngine(rx.channelizer, rx.bank, graph=True)
    with pytest.raises(ValueError, match='unsupported input kind'):
        superstep.SuperstepEngine(rx.channelizer, rx.bank, input_kind='CS8')


def test_unaligned_rate_has_no_engine():
    chz = fe.Channelizer(2_160_000, CENTER, [CENTER + 3000], 'cpu')
    with pytest.raises(ValueError, match='does not align'):
        superstep.SuperstepEngine(chz, channel.ChannelBank(1, 'cpu'))


def test_resample_static_matches_jax(monkeypatch):
    """The static-phase coset resampler on the same random [pre-roll |
    previous block | current block] buffer: 2e-5 of the output's peak (the
    taps are summed in the same order; XLA fuses the multiply-adds)."""
    rx, jrx = _receivers(monkeypatch)
    ss, js = rx.superstep, jrx.superstep
    assert ss.pre == js.pre
    rng = np.random.default_rng(2)
    shape = (len(FREQS), ss.pre + 2 * ss.plan.fs1_chunk)
    buf = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
           * 0.3).astype(np.complex64)
    want = np.asarray(js._resample_static(jnp.asarray(buf),
                                          jrx.channelizer._bank))
    got = ss._resample_static(torch.as_tensor(buf)).numpy()
    assert got.shape == want.shape == (len(FREQS), ss.plan.out_chunk)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize('fmt', ['CS16', 'CU8', 'CF32'])
def test_engine_upload_and_convert(monkeypatch, fmt):
    """upload() keeps the raw samples in their native width and the step's
    conversion is formats.convert bit for bit; a chunk of another size than
    the super-block's is refused."""
    from dumphfdl_tpu_torch.io import ingest
    monkeypatch.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
    rx = WidebandReceiver(FS, CENTER, FREQS[:1], 'cpu', sample_format=fmt)
    ss = rx.superstep
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, ss.raw_chunk_bytes, dtype=np.uint8)
    if fmt == 'CF32':       # random bytes would hold NaNs
        raw = ((rng.standard_normal(ss.plan.wb_chunk)
                + 1j * rng.standard_normal(ss.plan.wb_chunk)) * 0.3) \
            .astype(np.complex64).view(np.uint8)
    up = ss.upload(raw)
    assert up.dtype == ingest.RAW_DTYPES[fmt]
    assert up.numel() * up.element_size() == ss.raw_chunk_bytes
    got = ingest.convert_on_device(up, fmt).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  formats.convert(raw, fmt).view(np.uint32))
    with pytest.raises(ValueError, match='superstep chunk'):
        ss.upload(raw[:-8])


def test_ring_cursor_on_device_follows_the_host_form():
    """_ring_update_device (the cursor a tensor, every block the same work)
    against _ring_update (host integers, a slide only when needed) over
    enough blocks to slide twice: the same ring and the same cursor."""
    rng = np.random.default_rng(0)
    c, t = 2, 5376
    ring_h = torch.zeros((c, channel.RING_T), dtype=torch.complex64)
    ring_d = ring_h.clone()
    meta_h, meta_d = (0, 0), torch.zeros(2, dtype=torch.int64)
    slides = 0
    for _ in range(9):
        blk = torch.as_tensor((rng.standard_normal((c, t))
                               + 1j * rng.standard_normal((c, t)))
                              .astype(np.complex64))
        slides += channel._ring_slide(meta_h, t)[0] > 0
        meta_h = channel._ring_update(ring_h, meta_h, blk)
        channel._ring_update_device(ring_d, meta_d, blk)
        assert tuple(meta_d.tolist()) == meta_h
        keep = slice(meta_h[0] - channel.RING_KEEP, meta_h[0])
        assert torch.equal(ring_d[:, keep], ring_h[:, keep])
    assert slides == 2 and meta_h[1] > 0


def _capture():
    rng = np.random.default_rng(5)
    emissions = [(modulator.make_test_mpdu(m, rng), m, FREQS[k])
                 for k, m in enumerate((2, 5, 7, 3))]
    wb = modulator.synthesize_wideband(emissions, fs=FS, centerfreq=CENTER,
                                       snr_db=30.0)
    return emissions, np.frombuffer(formats.serialize(wb, 'CS16'), np.uint8)


def _decode(rx, raw):
    n = rx.raw_chunk_bytes
    events = []
    for off in range(0, len(raw), n):
        chunk = raw[off:off + n]
        if len(chunk) < n:
            chunk = np.concatenate([chunk, np.zeros(n - len(chunk),
                                                    np.uint8)])
        events += rx.process_packed(rx.superstep.upload(chunk))
    return sorted(events + rx.flush())


def test_superstep_decode_matches_jax_superstep(monkeypatch):
    """Four frames (modes 2, 5, 7, 3) on four channels, CS16, through both
    supersteps block by block and their flushes.  Both demodulate carried
    silence in the first block, so the noise floor starts as the JAX
    superstep's does.  (Which of the two BPSK phases a Costas loop locks
    in, the event's bitmask, hangs on where noise left its phase when the
    preamble arrives; on this capture no channel sits near that boundary,
    on others a last-bit difference between the frameworks can flip it
    without changing a decoded bit.)"""
    emissions, raw = _capture()
    rx, jrx = _receivers(monkeypatch)
    got, want = _decode(rx, raw), _decode(jrx, raw)
    assert rx.superstep.blocks_done == jrx.superstep.blocks_done
    assert rx.sample_clock == jrx.sample_clock
    assert [(e.channel, e.mode, e.pdu, e.fcs_ok) for e in got] == \
        [(k, m, pdu, True) for k, (pdu, m, _f) in enumerate(emissions)]
    for a, b in zip(got, want, strict=True):
        for f in ('channel', 'mode', 'bitmask', 'train_bad', 'train_total',
                  'start_symbol', 'pdu', 'fcs_ok'):
            assert getattr(a, f) == getattr(b, f), f
        for f in ('rssi', 'noise_floor'):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-4,
                                                  abs=1e-4), f
        assert a.freq_err_hz == pytest.approx(
            b.freq_err_hz, abs=1e-4 * C.SYMBOL_RATE / (2 * np.pi))
        # the noise floor is the few-updates start-up value of a stream
        # that began in carried silence, not a settled estimate
        assert a.noise_floor < 1e-3
    # what the step carried is what the JAX step carried
    jb, b = jrx.bank, rx.bank
    assert b._ringmeta == tuple(np.asarray(jb._ringmeta)[:, 0].tolist())
    assert tuple(rx.superstep._ringmeta.tolist()) == b._ringmeta
    for name, jv in (('mixer_phase', jrx.channelizer._mixer_phase),
                     ('wb_tail', jrx.superstep._wb_tail),
                     ('agc_energy', jb.agc_state.energy)):
        np.testing.assert_allclose(rx.superstep.carried()[name].numpy(),
                                   np.asarray(jv), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_other_paths_hand_their_state_to_the_engine(monkeypatch):
    """A receiver whose superstep is engaged can still be fed through
    process(); the engine then finds the bank's state in new tensors and
    the ring cursor moved on the host, and takes both over."""
    monkeypatch.delenv('DUMPHFDL_NO_SUPERSTEP', raising=False)
    rx = WidebandReceiver(FS, CENTER, FREQS[:1], 'cpu', sample_format='CF32')
    ss = rx.superstep
    rng = np.random.default_rng(6)
    n = ss.plan.wb_chunk
    x = ((rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n))
         * 0.1).astype(np.complex64)
    rx.process(x)                                  # the fused path
    assert rx.bank._ringmeta[0] > 0
    assert rx.bank.symring is ss._fixed['symring']          # in place
    assert rx.bank._tail is not ss._fixed['mf_tail']        # replaced
    energy = rx.bank.agc_state.energy.clone()
    before = rx.bank._ringmeta
    rx.process_packed(ss.upload(x[:n].view(np.uint8)))
    assert rx.bank._tail is ss._fixed['mf_tail']
    assert rx.bank.agc_state.energy is ss._fixed['agc_energy']
    assert not torch.equal(rx.bank.agc_state.energy, energy)
    assert rx.bank._ringmeta == (before[0] + ss.plan.symbols, before[1])
    assert tuple(ss._ringmeta.tolist()) == rx.bank._ringmeta
