"""PyTorch port, parallel/sharding and the meshed ChannelBank on CPU shards,
against the JAX package on its virtual CPU devices: mesh shapes, one
sharded frontend step row for row, the meshed bank's events, and the bytes
counted between shards against comm_model()."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

import jax  # noqa: E402

from dumphfdl_tpu.dsp import frontend as jfe  # noqa: E402
from dumphfdl_tpu.dsp.channel import ChannelBank as JChannelBank  # noqa: E402
from dumphfdl_tpu.parallel import sharding as jsh  # noqa: E402
from dumphfdl_tpu_torch.dsp import dumpfile, frontend as fe, modulator  # noqa: E402
from dumphfdl_tpu_torch.dsp.channel import ChannelBank, MeshChannelBank  # noqa: E402
from dumphfdl_tpu_torch.parallel import sharding as sh  # noqa: E402

FS, CENTER = 43_200, 10_000_000
CHANS = [9_990_000, 10_000_000, 10_008_000]


@pytest.fixture(autouse=True)
def _explicit_meshes_only(monkeypatch):
    """Every mesh here is passed explicitly; keep the JAX bank from
    sharding itself over the 8 virtual devices where a test wants one."""
    monkeypatch.setenv('DUMPHFDL_NO_AUTOSHARD', '1')


def cpu_mesh(t, k, repeated=True):
    """A t x k mesh of CPU shards: one device object named t*k times, or
    t*k distinct torch.device('cpu') objects."""
    dev = torch.device('cpu')
    return sh.DeviceMesh([[dev if repeated else torch.device('cpu')
                           for _ in range(k)] for _ in range(t)])


@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_make_mesh_shapes_equal_jax(n):
    want = jsh.make_mesh(jax.devices()[:n]).shape
    mesh = sh.make_mesh(['cpu'] * n)
    assert mesh.shape == dict(want)
    assert mesh.size == n and mesh.axis_names == ('time', 'chan')
    assert len(mesh.demod_order()) == n


def test_make_mesh_time_axis_and_order():
    mesh = sh.make_mesh(['cpu'] * 6, time_axis=3)
    assert mesh.shape == {'time': 3, 'chan': 2}
    # demod order is 'chan' major, 'time' minor
    assert [(s.t, s.k) for s in mesh.demod_order()] == \
        [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1)]
    assert sh.parse_mesh('2X4') == (2, 4)


def test_mesh_refuses_what_is_no_grid():
    with pytest.raises(ValueError, match='rectangular'):
        sh.DeviceMesh([['cpu', 'cpu'], ['cpu']])
    with pytest.raises(ValueError, match='one type'):
        sh.DeviceMesh([['cpu', 'meta']])


def test_send_copies_and_counts():
    """A send between two shards on one device is a new buffer (an in-place
    update of the source must not reach the receiver) and is counted; a
    shard cannot send to itself."""
    mesh = cpu_mesh(2, 1)
    a, b = mesh.shard(0, 0), mesh.shard(1, 0)
    x = torch.arange(6, dtype=torch.float32)
    y = mesh.send(x, a, b, 'halo')
    x += 100
    assert y.tolist() == [0, 1, 2, 3, 4, 5]
    assert mesh.moved == {'halo': 24} and mesh.copies == {'halo': 1}
    with pytest.raises(ValueError, match='itself'):
        mesh.send(x, a, a, 'halo')


def _tables(rows):
    geo = fe.compute_geometry(fe.compute_fft_decimation_rate(FS),
                              250 / FS)
    return geo, fe._design_tables(geo, FS, CENTER, tuple(CHANS), rows)


def _wideband(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3) \
        .astype(np.complex64)


def test_sharded_frontend_step_matches_jax():
    """Two consecutive super-blocks (the second starts from the carried
    tail and from a non-zero mixer phase) through the port's frontend on a
    2x2 mesh of CPU shards and the JAX one on a 2x2 mesh of virtual CPU
    devices: the (rows, columns) fs1 block row for row, within 2e-5 of its
    peak (FFT rounding differs between torch.fft and XLA)."""
    jch = jfe.Channelizer(FS, CENTER, CHANS, rows=4)
    jfront = jsh.ShardedFrontend(jch, jsh.make_mesh(jax.devices()[:4]))
    geo, tables = _tables(4)
    assert geo.__dict__ == jch.geo.__dict__
    front = sh.ShardedFrontend(geo, tables, cpu_mesh(2, 2))
    assert (front.super_len, front.nb_cols, front.c_pad) == \
        (jfront.super_len, jfront.nb_cols, jfront.c_pad)
    x = _wideband(2 * front.super_len, 3)
    for i in range(2):
        blk = x[i * front.super_len:(i + 1) * front.super_len]
        want = np.asarray(jfront.step(blk))
        blocks = front.step(blk)
        assert [tuple(b.shape) for b in blocks] == \
            [(1, front.nb_cols)] * 4
        got = front.gather(blocks)
        peak = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=2e-5 * peak)
        assert peak > 0.01


@pytest.mark.parametrize('t,k', [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharded_frontend_matches_channelizer(t, k):
    """Any mesh gives what the port's own Channelizer gives for the same
    frames (one device, no copies), within 2e-5 of the peak."""
    geo, tables = _tables(4)
    front = sh.ShardedFrontend(geo, tables, cpu_mesh(t, k))
    chz = fe.Channelizer(FS, CENTER, CHANS, 'cpu', rows=4)
    x = _wideband(front.super_len, 4)
    got = front.gather(front.step(x))
    ext = np.concatenate([np.zeros(geo.overlap_length, np.complex64), x])
    frames = np.lib.stride_tricks.sliding_window_view(
        ext, geo.fft_size)[::geo.input_size]
    want, _ = chz.channelize_frames(frames.copy())
    peak = float(want.abs().max())
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5 * peak)
    # T-1 halos per chan column, (T-1)/T of the block resharded
    assert front.halo_bytes == k * (t - 1) * geo.overlap_length * 8
    assert front.reshard_bytes == 4 * front.nb_cols * 8 * (t - 1) // t


def test_counted_bytes_equal_comm_model_and_jax():
    """What DeviceMesh.send counted over three steps, per super-block,
    against the port's comm_model() and the JAX comm_model() of the same
    geometry (whose halo figure is one chan column's)."""
    mesh = cpu_mesh(2, 2)
    rx = sh.ShardedWidebandReceiver(FS, CENTER, CHANS, mesh)
    jrx = jsh.ShardedWidebandReceiver(
        FS, CENTER, CHANS, mesh=jsh.make_mesh(jax.devices()[:4]))
    # the JAX bank decodes 64 events per block on the device on a TPU and
    # none on its CPU test mesh; the port always 64: model the former
    jrx.bank.fused_event_decode = 64
    model, jmodel = rx.comm_model(), jrx.comm_model()
    assert {k: model[k] for k in jmodel} == jmodel
    front = rx.frontend
    x = _wideband(3 * front.super_len, 5)
    for i in range(3):
        front.step(x[i * front.super_len:(i + 1) * front.super_len])
    assert front.steps == 3
    assert front.halo_bytes == 3 * model['halo_bytes_per_superblock']
    assert front.reshard_bytes == 3 * model['reshard_bytes_per_superblock']
    assert front.upload_bytes == 3 * model['upload_bytes_per_superblock']
    assert set(mesh.moved) == {'halo', 'reshard'}
    sb_per_s = FS / front.super_len
    T, K = 2, 2
    assert int(front.halo_bytes / 3 / K * sb_per_s) == \
        jmodel['halo_bytes_per_s']
    assert int(front.reshard_bytes / 3 * sb_per_s) == \
        jmodel['fs1_reshard_bytes_per_s']
    # the reshard is exactly (T-1)/T of the fs1 chunk
    assert front.reshard_bytes / 3 == \
        rx.bank._c * front.nb_cols * 8 * (T - 1) / T


def test_append_resample_demod_move_nothing():
    """After the frontend's reshard nothing crosses between shards: a
    whole process() call counts only halo and reshard bytes, equal to the
    frontend's steps times the model."""
    mesh = cpu_mesh(2, 2)
    rx = sh.ShardedWidebandReceiver(FS, CENTER, CHANS, mesh)
    x = _wideband(FS, 6) * 0.01
    for _ in range(3):
        rx.process(x)
    model = rx.comm_model()
    assert rx.frontend.steps == 3 * FS // rx.frontend.super_len >= 2
    assert mesh.moved == {
        'halo': rx.frontend.steps * model['halo_bytes_per_superblock'],
        'reshard': rx.frontend.steps * model['reshard_bytes_per_superblock']}
    assert rx.sample_clock == 3 * len(x)
    assert rx.superstep is None and rx.engine is None


def test_sharded_ring_holds_one_step_per_append():
    """The per-shard fs1 ring is sized as the JAX sharded receiver sizes
    its ring (sharding.py:228-230); a shard holds the ring and resampler
    of its rows only, and the frontend each channel block's tables once per
    time shard."""
    rx = sh.ShardedWidebandReceiver(FS, CENTER, CHANS, cpu_mesh(2, 2))
    jrx = jsh.ShardedWidebandReceiver(
        FS, CENTER, CHANS, mesh=jsh.make_mesh(jax.devices()[:4]))
    assert [r._r1 for r in rx.resamplers] == [jrx.channelizer._r1] * 4
    assert [r.rows for r in rx.resamplers] == [1] * 4
    assert not any(isinstance(r, fe.Channelizer) for r in rx.resamplers)
    for t in range(2):
        np.testing.assert_array_equal(
            np.concatenate([rx.frontend._tables[rx.mesh.shard(t, k)][0]
                            .numpy() for k in range(2)]),
            jrx.channelizer._idx_np)
    with pytest.raises(TypeError):        # host samples only
        rx.process(torch.zeros(8, dtype=torch.complex64))
    # a plain Channelizer's ring is as before
    assert fe.Channelizer(FS, CENTER, CHANS, 'cpu')._r1 == \
        jfe.Channelizer(FS, CENTER, CHANS)._r1


def _bank_blocks():
    mode = 1
    rng = np.random.default_rng(123)
    pdu = modulator.random_pdu(mode, rng)
    iq = modulator.synthesize_iq(modulator.frame_symbols(pdu, mode),
                                 pad_symbols=(300, 300)) * 0.5
    blocks = []
    for off in range(0, len(iq), 5400):
        chunk = iq[off:off + 5400]
        block = np.zeros((3, 5400), np.complex64)
        block[1, :len(chunk)] = chunk
        blocks.append(block)
    return pdu, blocks


def _run_bank(bank, blocks):
    events = []
    for block in blocks:
        events.extend(bank.process(block))
    if not isinstance(bank, JChannelBank):
        events.extend(bank.drain_events())
    return events


@pytest.fixture(scope='module')
def bank_runs():
    """One frame on channel 1 of 3 through: the port's single bank, its
    meshed bank on a repeated device and on distinct device objects (3
    channels padded to 4, one per shard), and the JAX single bank."""
    pdu, blocks = _bank_blocks()
    runs = {'single': _run_bank(ChannelBank(3, 'cpu'), blocks)}
    for name, repeated in (('mesh', True), ('mesh_distinct', False)):
        bank = MeshChannelBank(3, cpu_mesh(2, 2, repeated))
        assert bank._c == 4 and bank.rows_per_shard == 1
        runs[name] = _run_bank(bank, blocks)
    runs['jax'] = _run_bank(JChannelBank(3, auto_shard=False), blocks)
    return pdu, runs


def test_channelbank_sharded_matches_single(bank_runs):
    """As tests/test_sharding.py::test_channelbank_sharded_matches_single:
    the meshed bank decodes the frame the single bank decodes, on its
    global channel, with the frequency error within 1e-3 Hz."""
    pdu, runs = bank_runs
    assert len(runs['single']) == 1 and len(runs['mesh']) == 1
    e0, e1 = runs['single'][0], runs['mesh'][0]
    assert e0.channel == e1.channel == 1
    assert e0.pdu == pdu and e1.pdu == pdu
    assert e0.fcs_ok == e1.fcs_ok
    assert abs(e0.freq_err_hz - e1.freq_err_hz) < 1e-3


def test_meshed_bank_matches_jax_bank(bank_runs):
    pdu, runs = bank_runs
    assert [(e.channel, e.mode, e.pdu) for e in runs['jax']] == \
        [(e.channel, e.mode, e.pdu) for e in runs['mesh']] == [(1, 1, pdu)]
    assert abs(runs['jax'][0].freq_err_hz - runs['mesh'][0].freq_err_hz) < 0.1


def test_repeated_device_mesh_equals_distinct_devices(bank_runs):
    """Logical shards on one device object give, field for field, the
    events of shards on distinct device objects."""
    _, runs = bank_runs
    assert runs['mesh'] == runs['mesh_distinct']


def test_meshed_bank_state_and_counters():
    """What the app reads of a bank: counters (num_channels, 4) and the
    tracker state joined over the shards, padding included."""
    bank = MeshChannelBank(3, cpu_mesh(1, 2))
    assert bank._c == 4 and bank.last_counters is None
    x = _wideband(3 * 5400, 7).reshape(3, 5400) * 0.01
    assert bank.process(x) == []
    assert tuple(bank.last_counters.shape) == (3, 4)
    st = bank.tracker_state
    assert tuple(st.noise_floor.shape) == (4,)
    single = ChannelBank(3, 'cpu')
    single.process(x)
    np.testing.assert_allclose(st.noise_floor[:3].numpy(),
                               single.tracker_state.noise_floor.numpy(),
                               rtol=1e-6)
    assert bank.drain_events() == []


def test_meshed_bank_dumps_use_global_channels(tmp_path):
    """--datadumps on a mesh does what the JAX bank does there: every
    stage of every row of the padded channel axis, padding channels too,
    under the global channel number."""
    bank = MeshChannelBank(3, cpu_mesh(2, 2))
    bank.dumps = dumpfile.DumpSet(prefix=str(tmp_path) + '/')
    # a short block: with dumps on the gate is off and the plain tracker
    # walks every symbol of every shard
    x = _wideband(3 * 900, 8).reshape(3, 900) * 0.01
    bank.process(x)
    bank.dumps.close()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 9 * 4
    assert 'chan_out.ch3.cf32' in names and 'symsync_tau.ch0.rf32' in names
    got = np.fromfile(tmp_path / 'chan_out.ch2.cf32', np.complex64)
    np.testing.assert_array_equal(got, x[2])
    assert not np.fromfile(tmp_path / 'chan_out.ch3.cf32', np.complex64).any()
    assert (tmp_path / 'sym_out.ch1.cf32').stat().st_size == 300 * 8
    bank.dumps = None
    assert all(b.dumps is None for b in bank.banks)
