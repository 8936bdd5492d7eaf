#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line with the card's name and power limit:

1. device   -- require a CUDA device; toolchain (torch, CUDA, nvcc);
2. build    -- build the hand-written kernels from csrc/ (seconds);
3. K1       -- Viterbi kernel vs its plain version for every mode's frame
               length, 64 noisy frames each: bit-exact; both times;
4. K2       -- the tracker wrapper (tracker_cuda.tracker_block) vs the
               plain version: 512 noise channels with the gate off, in a
               block of 1800 symbols (the CLI's default) and of 5376 (the
               scale run's), state and symbols within 2e-5, events and
               counters exact; 1800-symbol blocks carrying real frames of
               all 8 modes with the gate on (events exact); an all-idle
               gated tile (exact); both times;
5. golden   -- the CLI on tests/golden/capture.cs16 gives the PDU bytes
               pinned in tests/golden/manifest.json;
6. scale    -- the main path at deployment size: a 512-channel CS16 capture
               at 2.16 Msps with 16 emitting channels, decoded in demod
               blocks of 16128 samples by the app the CLI builds
               (cli.build_app, HfdlApp.run_file); the ledger must be exact
               (16/16, no junk, no other, no duplicates).  Kernel launch
               counters are reset just before and read just after the
               first pass.  A second pass (fresh app) gives the warm wall
               time, a third runs under torch.profiler and gives the
               device's busy share and its time by kernel kind.

The second-to-last line is the kernels' JSON summary, the last line
{"ok": true, "device": {...}}.  Any failed phase raises (exit code != 0).
Nothing runs without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from dumphfdl_tpu_torch import constants as C
from dumphfdl_tpu_torch.device import require_cuda

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / 'build' / 'smoke'
# demod block of the scale run: the multiple of 48 samples (the fused
# resampler's step at 2.16 Msps) nearest bench.py's 16200
DEMOD_BLOCK = 16128
STEPS = DEMOD_BLOCK // C.SPS          # tracker symbols per block (5376)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def say(card: str, phase: str, **kv) -> None:
    print(f'[{card}] {phase}: ' + json.dumps(kv), flush=True)


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


def phase_device(card: str, dev: torch.device) -> None:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = pathlib.Path(CUDA_HOME or '/usr/local/cuda') / 'bin' / 'nvcc'
    ver = subprocess.run([str(nvcc), '--version'], capture_output=True,
                         text=True).stdout.strip().splitlines()
    say(card, 'device', torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=ver[-1] if ver else 'not found', python=sys.version.split()[0],
        name=torch.cuda.get_device_name(dev),
        count=torch.cuda.device_count())


def phase_build(card: str) -> None:
    from dumphfdl_tpu_torch.ops import _build
    _build.library()
    say(card, 'build', seconds=_build.build_info['seconds'],
        route=_build.build_info['route'])


def phase_k1(card: str, dev: torch.device) -> dict:
    from dumphfdl_tpu_torch.ops import fec, fec_cuda
    rng = np.random.default_rng(1)
    ms = plain_ms = 0.0
    for m, p in enumerate(C.MODES):
        nb = p.framebits
        bits = rng.integers(0, 2, (64, nb))
        bits[:, -6:] = 0
        soft = np.stack([fec.hard_to_soft(fec.conv_encode(b)).astype(np.int32)
                         for b in bits])
        soft = np.clip(soft + rng.integers(-100, 101, soft.shape), 0, 255)
        s = torch.as_tensor(soft.astype(np.uint8), device=dev)
        before = fec_cuda.launches
        k = fec_cuda.viterbi_decode(s, nb)
        if fec_cuda.launches != before + 1:
            raise AssertionError('K1 wrapper did not launch its kernel')
        pl, t_p = timed_ms(lambda: fec.viterbi_decode(s, nb))
        if not torch.equal(k, pl):
            raise AssertionError(f'K1 mode {m}: kernel differs from plain '
                                 f'in {int((k != pl).sum())} bits')
        t_k = cuda_ms(lambda: fec_cuda.viterbi_decode(s, nb), 20)
        ms += t_k
        plain_ms += t_p
        say(card, f'K1 mode {m}', frames=64, nbits=nb, bit_exact=True,
            bit_errors_vs_sent=int((k.cpu().numpy() != bits).sum()),
            kernel_ms=t_k, plain_ms=t_p)
    return dict(name='viterbi27', route='cuda',
                source='dumphfdl_tpu_torch/csrc/viterbi.cu',
                replaces='dumphfdl_tpu/ops/fec_pallas.py:50',
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms)


def _close(a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    """Max |a-b| after asserting |a-b| <= tol + tol*|b| elementwise."""
    d = (a - b).abs()
    if bool((d > tol + tol * b.abs()).any()):
        raise AssertionError(f'max |diff| {float(d.max())} beyond {tol}')
    return float(d.max()) if d.numel() else 0.0


def _compare_k2(what, s1, o1, e1, c1, s2, o2, e2, c2, tol) -> float:
    from dumphfdl_tpu_torch.dsp.tracker import TrackerState
    err = 0.0
    for f in TrackerState._fields:
        a, b = getattr(s1, f), getattr(s2, f)
        if a is None or b is None:
            if a is not b:
                raise AssertionError(f'K2 {what}: state field {f} differs')
        elif a.is_floating_point() or a.is_complex():
            err = max(err, _close(a, b, tol))
        elif not torch.equal(a, b):
            raise AssertionError(f'K2 {what}: state field {f} differs')
    err = max(err, _close(o1.sym, o2.sym, tol))
    for name, a, b in (('is_data', o1.is_data, o2.is_data),
                       ('data_idx', o1.data_idx, o2.data_idx),
                       ('frame_parity', o1.frame_parity, o2.frame_parity),
                       ('events', e1, e2), ('counters', c1, c2)):
        if not torch.equal(a, b):
            raise AssertionError(f'K2 {what}: {name} differ')
    return err


def _k2_pair(state, x, lvl, steps: int, use_acq: bool):
    """(wrapper result, plain result, plain ms): the wrapper launches K2;
    the plain version runs with the tile activity and acq_hit carry the
    wrapper derives (tracker_cuda.tile_activity)."""
    from dumphfdl_tpu_torch.dsp import tracker as trk
    from dumphfdl_tpu_torch.dsp import tracker_cuda as tc
    before = tc.launches
    r_k = tc.tracker_block(state, x, lvl, steps, use_acq=use_acq)
    if tc.launches != before + 1:
        raise AssertionError('K2 wrapper did not launch its kernel')
    act, hits = tc.tile_activity(state, x, use_acq)
    r_p, t_p = timed_ms(lambda: trk.tracker_block(state, x, lvl, steps, act))
    return r_k, (r_p[0]._replace(acq_hit=hits), *r_p[1:]), t_p


def phase_k2(card: str, dev: torch.device) -> dict:
    from dumphfdl_tpu_torch.dsp import modulator, tracker as trk
    from dumphfdl_tpu_torch.dsp import tracker_cuda as tc
    from dumphfdl_tpu_torch.dsp.channel import agc_block, agc_init, \
        matched_filter
    rng = np.random.default_rng(2)
    steps = 5400 // C.SPS               # the CLI's default demod block
    T = 3 * steps + trk.HALO

    # (a) 512 noise channels, gate off: every tile runs the loop; blocks of
    # the CLI's default length and of the scale run's (the kernels line)
    nch = 512
    err = 0.0
    for n_sym in (steps, STEPS):
        t = 3 * n_sym + trk.HALO
        x = torch.as_tensor((rng.standard_normal((nch, t))
                             + 1j * rng.standard_normal((nch, t)))
                            .astype(np.complex64), device=dev)
        lvl = torch.as_tensor((np.abs(rng.standard_normal((nch, t))) + 0.5)
                              .astype(np.float32), device=dev)
        st = trk.tracker_init(nch, dev)
        r_k, r_p, t_p = _k2_pair(st, x, lvl, n_sym, use_acq=False)
        e = _compare_k2('noise', *r_k, *r_p, tol=2e-5)
        err = max(err, e)
        t_k = cuda_ms(lambda: tc.tracker_block(st, x, lvl, n_sym,
                                               use_acq=False), 5)
        say(card, 'K2 noise', channels=nch, symbols=n_sym, max_abs_err=e,
            kernel_ms=t_k, plain_ms=t_p)

    # (b) real frames of all 8 modes (channel m carries mode m) beside 8
    # noise channels, gate on, the kernel's state (and acq_hit) carried
    # over consecutive blocks
    sigs = []
    for m in range(len(C.MODES)):
        pdu = modulator.make_test_mpdu(m, rng, icao=0x3C0100 + m)
        sigs.append(modulator.synthesize_iq(
            modulator.frame_symbols(pdu, m),
            imp=modulator.Impairments(snr_db=25.0, cfo_hz=4.0 * m - 12.0,
                                      timing_offset=0.1 * m, seed=m)))
    n_blk = -(-max(len(s) for s in sigs) // (3 * steps)) + 1
    n = n_blk * 3 * steps
    xf = (rng.standard_normal((16, n)) + 1j * rng.standard_normal((16, n))) \
        .astype(np.complex64) * 0.05
    for m, s in enumerate(sigs):
        xf[m, :len(s)] += s
    _, y, level = agc_block(agc_init(16, dev), torch.as_tensor(xf, device=dev))
    mf = torch.cat([torch.zeros((16, trk.HALO), dtype=torch.complex64,
                                device=dev), matched_filter(y)], dim=1)
    lv = torch.cat([torch.ones((16, trk.HALO), device=dev), level], dim=1)
    st = trk.tracker_init(16, dev)
    events = 0
    err_f = 0.0
    for b in range(n_blk):
        xb = mf[:, 3 * steps * b:3 * steps * (b + 1) + trk.HALO]
        lb = lv[:, 3 * steps * b:3 * steps * (b + 1) + trk.HALO]
        r_k, r_p, _ = _k2_pair(st, xb, lb, steps, use_acq=True)
        err_f = max(err_f, _compare_k2(f'frames block {b}', *r_k, *r_p,
                                       tol=2e-5))
        st = r_k[0]
        ev = r_k[2].reshape(16, trk.K_EVENTS, trk.EV_FIELDS)
        events += int((ev[:, :, 0] > 0.5).sum())
    if events < len(C.MODES):
        raise AssertionError(f'K2 frames: {events} events for '
                             f'{len(C.MODES)} frames')
    say(card, 'K2 frames', channels=16, blocks=n_blk, symbols=steps,
        events=events, events_exact=True, max_abs_err=err_f)

    # (c) an all-idle gated tile beside an active one (carried preamble
    # hits keep tile 1 running): exact
    x = torch.as_tensor(((rng.standard_normal((256, T))
                          + 1j * rng.standard_normal((256, T))) * 0.2)
                        .astype(np.complex64), device=dev)
    lvl = torch.as_tensor((np.abs(rng.standard_normal((256, T))) + 0.5)
                          .astype(np.float32), device=dev)
    st = trk.tracker_init(256, dev)._replace(
        nf_clk=torch.as_tensor(rng.integers(0, 300, 256), dtype=torch.int32,
                               device=dev),
        acq_hit=(torch.arange(256, device=dev) >= trk.CT).to(torch.int32))
    act, _ = tc.tile_activity(st, x, True)
    if act.tolist() != [0, 1]:
        raise AssertionError(f'K2 idle: tile activity {act.tolist()}, '
                             'expected [0, 1]')
    r_k, r_p, _ = _k2_pair(st, x, lvl, steps, use_acq=True)
    if _compare_k2('idle', *r_k, *r_p, tol=0.0) != 0.0:
        raise AssertionError('K2 idle tile not exact')
    say(card, 'K2 idle', channels=256, symbols=steps, idle_tiles=1,
        exact=True)
    return dict(name='tracker', route='cuda',
                source='dumphfdl_tpu_torch/csrc/tracker.cu',
                replaces='dumphfdl_tpu/dsp/tracker_pallas.py:103',
                max_abs_err=max(err, err_f), ms=t_k, plain_ms=t_p)


class _Recorder:
    """Records the events an HfdlApp hands to its protocol stack."""

    def __init__(self):
        from dumphfdl_tpu_torch.app import HfdlApp
        self.events = []
        self._cls, self._orig = HfdlApp, HfdlApp.handle_events
        rec = self

        def handle(app, events):
            rec.events.extend(events)
            return rec._orig(app, events)
        HfdlApp.handle_events = handle

    def close(self):
        self._cls.handle_events = self._orig


def phase_golden(card: str, dev: torch.device) -> None:
    from dumphfdl_tpu_torch import cli
    gold = ROOT / 'tests' / 'golden'
    man = json.loads((gold / 'manifest.json').read_text())
    rec = _Recorder()
    try:
        t0 = time.perf_counter()
        rc = cli.main([
            '--iq-file', str(gold / man['capture']),
            '--sample-format', man['format'],
            '--sample-rate', str(man['sample_rate']),
            '--centerfreq', str(man['centerfreq'] / 1000),
            '--system-table', str(ROOT / 'etc' / 'systable.conf'),
            '--output', f'decoded:text:file:path={WORK / "golden.txt"}',
        ] + [str(f / 1000) for f in man['frequencies']], device=dev)
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    got = {(e.channel, e.mode): e.pdu.hex() for e in rec.events if e.pdu}
    for exp in man['frames']:
        if got.get((exp['channel'], exp['mode'])) != exp['pdu_hex']:
            raise AssertionError(f'golden frame {exp["channel"]}/'
                                 f'{exp["mode"]} missing or wrong')
    if rc != 0:
        raise AssertionError(f'cli returned {rc}')
    say(card, 'golden', frames=len(man['frames']), pdu_bytes_match=True,
        wall_s=wall)


# kernel kinds of the profiled pass, by a key in the kernel's name (the
# first key that matches names the kind)
_KINDS = (('viterbi27_kernel', 'K1 Viterbi'), ('tracker_kernel', 'K2 tracker'),
          ('memcpy', 'memcpy/memset'), ('memset', 'memcpy/memset'),
          ('fft', 'cuFFT'), ('index', 'gather/index'),
          ('gather', 'gather/index'), ('scan', 'scan'), ('sort', 'sort'),
          ('reduce', 'reduce'), ('cat', 'cat/copy'), ('copy', 'cat/copy'),
          ('elementwise', 'elementwise'))


def device_profile(prof, wall_s: float) -> dict:
    """Device time of a torch.profiler run: busy milliseconds (the union of
    the device intervals), busy share of wall_s, and time by kernel kind."""
    from torch.autograd import DeviceType
    spans, kinds = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        n = e.name.lower()
        kind = next((k for key, k in _KINDS if key in n), 'other')
        ms, cnt = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + (t1 - t0) / 1e3, cnt + 1)
    busy_us, end = 0.0, float('-inf')
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return dict(device_events=len(spans), busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e6 / wall_s,
                by_kind={k: [ms, cnt] for k, (ms, cnt) in
                         sorted(kinds.items(), key=lambda kv: -kv[1][0])})


def _ledger(events, emit_by_chan: dict) -> dict:
    """Every decoded frame against the emitted set: exact when each
    emitting channel decoded its frame once and nothing else came out."""
    cells, junk, other = {}, 0, 0
    for ev in events:
        if ev.pdu is None:
            continue
        if not ev.fcs_ok:
            junk += 1
            continue
        exp = emit_by_chan.get(ev.channel)
        if exp is not None and ev.pdu[:len(exp)] == exp:
            cells[ev.channel] = cells.get(ev.channel, 0) + 1
        else:
            other += 1
    led = dict(frames_ok=sum(cells.values()), frames_expected=len(emit_by_chan),
               frames_junk=junk, frames_other=other,
               frames_duplicate=sum(n - 1 for n in cells.values() if n > 1),
               missing_channels=sorted(set(emit_by_chan) - set(cells)))
    led['exact'] = (led['frames_ok'] == len(emit_by_chan) and not junk
                    and not other and not led['frames_duplicate']
                    and not led['missing_channels'])
    return led


def _scale_pass(argv: list[str], dev: torch.device, emit_by_chan: dict,
                prof=None):
    """Build the app as the CLI does and decode the capture once:
    (set-up seconds, run_file wall seconds, ledger)."""
    from dumphfdl_tpu_torch import cli
    args = cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    app = cli.build_app(args, dev)
    setup = time.perf_counter() - t0
    rec = _Recorder()
    torch.cuda.synchronize()
    try:
        with prof if prof is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            app.run_file(args.iq_file, args.sample_format)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        rec.close()
        app.shutdown()
    led = _ledger(rec.events, emit_by_chan)
    if not led['exact']:
        raise AssertionError(f'scale ledger not exact: {led}')
    return setup, wall, led


def phase_scale(card: str, dev: torch.device) -> dict:
    """bench.py's end-to-end child, first rung: 512 channels at 2.16 Msps
    CS16, traffic on every 32nd channel cycling through the single-slot
    modes, 30 dB SNR; decoded in three passes, each with a fresh app and
    an exact ledger."""
    from dumphfdl_tpu_torch.dsp import modulator, tracker_cuda
    from dumphfdl_tpu_torch.io import formats
    from dumphfdl_tpu_torch.ops import fec_cuda

    nch, fs, center = 512, 2_160_000, 10_000_000
    spacing = max(3000, min(8000, (fs - 20000) // nch))
    freqs = [center + (i - nch // 2) * spacing for i in range(nch)]
    single = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
    rng = np.random.default_rng(0)
    emissions, emit_by_chan = [], {}
    for k, ci in enumerate(range(0, nch, nch // 16)):
        mode = single[k % len(single)]
        pdu = modulator.make_test_mpdu(mode, rng)
        emissions.append((pdu, mode, freqs[ci]))
        emit_by_chan[ci] = pdu
    t0 = time.perf_counter()
    wb = modulator.synthesize_wideband_fft(emissions, fs=fs, centerfreq=center,
                                           snr_db=30.0)
    path = WORK / 'scale.cs16'
    path.write_bytes(formats.serialize(wb, 'CS16'))
    duration = len(wb) / fs
    synth_s = time.perf_counter() - t0
    del wb
    argv = ['--iq-file', str(path), '--sample-format', 'CS16',
            '--sample-rate', str(fs), '--centerfreq', str(center / 1000),
            '--demod-block', str(DEMOD_BLOCK),
            '--output', f'decoded:text:file:path={WORK / "scale.txt"}'] \
        + [str(f / 1000) for f in freqs]

    # pass 1, the first of the process: launch counters and peak memory
    torch.cuda.reset_peak_memory_stats()
    fec_cuda.launches = tracker_cuda.launches = 0
    setup, wall, led = _scale_pass(argv, dev, emit_by_chan)
    launches = {'viterbi27': fec_cuda.launches,
                'tracker': tracker_cuda.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    # pass 2: warm
    setup2, wall2, _ = _scale_pass(argv, dev, emit_by_chan)
    say(card, 'scale', channels=nch, sample_rate=fs, fmt='CS16',
        demod_block=DEMOD_BLOCK, capture_s=duration, synth_s=synth_s,
        setup_s=[setup, setup2], wall_s=wall, rt_factor=duration / wall,
        warm_wall_s=wall2, warm_rt_factor=duration / wall2,
        max_memory_allocated=peak, launches=launches, **led)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f'main path never launched kernel {name}')
    # pass 3: warm, under the profiler
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    _, wall3, _ = _scale_pass(argv, dev, emit_by_chan, prof)
    say(card, 'scale profile', wall_s=wall3, **device_profile(prof, wall3))
    return launches


def main() -> int:
    dev = require_cuda()
    card = card_line()
    WORK.mkdir(parents=True, exist_ok=True)
    phase_device(card, dev)
    phase_build(card)
    k1 = phase_k1(card, dev)
    k2 = phase_k2(card, dev)
    phase_golden(card, dev)
    launches = phase_scale(card, dev)
    k1['launches'], k2['launches'] = launches['viterbi27'], launches['tracker']
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms')
    print(card)
    print(json.dumps({'kernels': [{k: d[k] for k in keys} for d in (k1, k2)]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
