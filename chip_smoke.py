#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py mesh      # only phases 1, 2, 8 and 12-14: the
                                    # multi-device paths and the pass they
                                    # are held to (for a machine with four
                                    # cards)
    python3 chip_smoke.py extras    # only phases 1, 2 and 18-20: the tools
                                    # beside the JAX extras
    python3 chip_smoke.py bench     # only phases 1, 2 and 21: bench.py's
                                    # whole ladder (about 20-30 minutes)

Phases, each printing one line with the card's name and power limit:

1. device   -- require a CUDA device; toolchain (torch, CUDA, nvcc);
2. build    -- build the hand-written kernels from csrc/ (seconds);
3. K1       -- Viterbi kernel vs its plain version for every mode's frame
               length, 64 noisy frames each, through both entries (one
               mode per launch, and all eight modes in the one launch the
               main path makes per event block): bit-exact; both times;
4. K2       -- the kernel's inline cosine/sine against cosf/sinf over every
               float it takes (0 mismatches); the tracker wrapper
               (tracker_cuda.tracker_block) vs the plain version: 512 noise channels with the gate off, in a
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
               first pass: K2 twice (one block of capture, one of flush
               padding), K1 once (one event block).  A second pass (fresh app) gives the warm wall
               time, a third runs under torch.profiler and gives the
               device's busy share and its time by kernel kind;
6a. bench   -- the port's bench entry point (tools/bench.py) at bench.py's
               first rung: e2e_rung(512 channels, 2.16 Msps, CS16), one
               app through 3 warm and 4 timed passes and the flush (block
               16200: the unfused path), on the scale phase's filter
               tables; the exact (channel, pass) ledger 112/112 with no
               junk, other frames or duplicates, K2 and K1 launched; then
               demod_only(1024);
7. K2 taps  -- the kernel's debug_taps instantiation at 512 x 1800 symbols:
               exact against the plain version, taps included, and
               bit-equal in symbols, state, events and counters to the
               normal instantiation with the gate off; its time, bound and
               both instantiations' registers (ptxas);
8. unfused  -- the same 512-channel capture with the CLI's default
               --demod-block 5400, which at 2.16 Msps takes the unfused
               channelizer path: exact ledger, wall and device operations
               beside the fused phase's;
9. superstep - the streaming main path at full width: 1024 channels at
               3.456 Msps CS16 with --demod-block 16200 (the aligned block
               is 10752 samples, 15 frames of a 524288-point FFT,
               6,881,280 wideband samples per block), every 32nd channel
               emitting, a capture of more than three super-blocks.
               Through HfdlApp.run_file: the engine engaged, every block
               after the first a graph replay, exact ledger (all 32 frames
               once, nothing else decoded; the only FCS-failing frames
               allowed are the alias images two channels from an emitter,
               see ALIAS_STEP, and the same emissions under in-band noise
               that covers the images must give no junk at all); the graph
               held bit for bit against the eager step on the same input
               (SuperstepEngine.verify_graph); K2's wrapper against the
               plain version on the very blocks the step hands it (1024
               channels x 3584 symbols, gate on, carried state: exact);
               cold and warm wall; one eager and one graph pass under
               torch.profiler, whose kernel events give K2's launches per
               block on either path;
10. stream  -- the same capture as 65536-sample complex64 chunks through
               run_stream and as raw CS16 buffers through run_stream_raw:
               the same ledger, 0 overruns;
11. datadumps - the golden capture through the CLI with --datadumps in a
               scratch directory: nine files per channel with the expected
               sample counts, the pinned bytes decoded, the taps kernel
               launched;
12. mesh    -- the multi-device path at full width: the 512-channel capture
               of the scale phase (default --demod-block 5400) through the
               app cli.build_app makes with a mesh: 2x2, and also 1x1 (one
               shard, no copies) and 4x1 (time only).  A mesh takes cuda:0..3
               where four devices are visible, else four logical shards on
               cuda:0, each with its own state and stream (the line says
               which: physical_devices).  Exact ledger; the (channel, mode,
               PDU) set of the unfused single-device pass, frequency errors
               within 0.1 Hz; the bytes DeviceMesh.send counted per
               super-block equal to comm_model()'s, the reshard exactly
               (T-1)/T of the fs1 chunk, nothing else moved between shards;
               K2 launched shards x blocks times, K1 once per (shard, block)
               that carried events; wall, device operations, peak memory,
               per-stage wall of an instrumented pass.  On the 2x2 mesh,
               K2's wrapper against the plain version on the very blocks a
               shard hands it in its own stream (128 channels x 1800
               symbols, gate on, carried state, two consecutive blocks:
               exact; timed through the wrapper and by the launch alone),
               and K1 on that shard's event blocks (bit-exact);
13. mesh frontend - two consecutive ShardedFrontend.step on the 2x2 mesh
               against Channelizer.channelize_frames on one device for the
               same frames: within 2e-5 of the peak where each span starts
               from the sharded frontend's own start phase (float64 on the
               host), within 1e-4 where the channelizer carries its phase
               itself in float32 over the whole block;
13a. mesh_mp - the same capture on a mesh across processes: child
               processes (dumphfdl_tpu_torch/tools/mesh_mp.py), each a rank
               of a torch.distributed group decoding through the app
               cli.build_app makes.  One card: two processes of two logical
               shards each on cuda:0 form a 2x2 mesh over gloo, the copies
               between them staged through pinned host memory.  Four cards:
               four processes, one card each, over nccl, on 2x2 and 4x1.
               Every rank reads the same file and gives an exact ledger and
               the one-process mesh's PDUs (frequency errors within 1e-6
               Hz); the bytes counted over the ranks equal the one-process
               mesh's and comm_model()'s; on 2x2 the last rank holds K2 and
               K1 exact against their plain versions on its own shard
               blocks (K2 timed through its wrapper and by its launch
               alone).  The children take over this process's filter
               tables from a file; a child that fails or outlives its
               deadline ends the phase (the others are killed), and every
               collective has a timeout;
14. dryrun  -- parallel.sharding.dryrun_multichip at its default geometry
               (64 channels at 432 ksps, 8 emitters) on a 2x2 mesh;
15. profile -- the golden capture through the CLI with --profile: the Chrome
               trace exists, parses and holds K1's and K2's kernel events
               and every span of the decoder's superstep path, each K1
               kernel inside an events.collect span;
16. parity  -- the two scenarios of tests/golden/chip_parity.json through K1
               and K2 (tools/chip_parity.py): integers and digests exact,
               floats within their stated bounds;
17. multihost - the single-process answers of parallel/multihost (the
               process groups are the mesh_mp phase's);
18. sensitivity - the decode-sensitivity sweep (tools/sensitivity.py,
               impaired frames at low Es/N0, 20 trials a point, a trial per
               channel of one ChannelBank): the eight pins of
               tests/test_sensitivity.py must pass >= 0.9; modes 2, 3, 6, 7
               at 0, 2 and 4 dB must lie within 0.2 in pass rate and 0.05
               dB in mean reported SNR of SENSITIVITY_r05.json (a TPU run,
               the same seeds and modulator);
19. soak_events - 1024 channels, a frame on each, all ending in one block
               (tools/soak_events.py): an exact 1024/1024 ledger, in every
               block with events min(events, 64) decoded fused and the rest
               by gather; K1 through its one-mode wrapper
               (fec_cuda.viterbi_decode, the gather's route) bit-exact
               against the plain version on the very soft chips the gather
               handed it, its time and bound (the viterbi27_one_mode entry
               of the kernels line);
20. soak_stream - 512 channels at 2.16 Msps CF32 fed to run_stream in real
               time for 30 s after an unpaced warm-up (tools/soak_stream.py):
               0 overruns, every frame of every loop of the capture decoded
               once with its bytes (FCS-failing frames next to an emitter,
               which the JAX package decodes too, counted apart), latency,
               resident and device memory after the warm-up and at the end;
21. bench ladder - (subcommand bench only) tools/bench.main with bench.py's
               default search (512, 1024, 2048 channels and 4096 in CU8),
               each rung in a child process under bench.py's watchdog, and
               --check-kernels: on the widest rung measured with every cell
               decoded, K2 on the first block that completes frames, 256
               rows (two whole 128-channel gate tiles from the first that
               completes one; each channel's recursion is its own), and
               K1 on that block's event block, both exact against their
               plain versions.  Every rung is measured or
               listed in the summary's failures with its reason.  Where two
               or more cards are visible, tools/bench_scaling too (N = 1, 2,
               4 cards, one nccl process each): equal PDU sets and counted
               bytes equal to comm_model() at every N.

Each kernel's line carries bound_ms, the least time the card could take
for the same work: the larger of the bytes the function must move over the
memory rate and its operations over the peak rate, both computed here from
the shapes that were run.  Neither kernel can reach it (both are chains of
dependent steps), so the chain's length is printed beside it.

Every kernel wrapper counts its launches (K1 by wrapper: viterbi_decode_many
and viterbi_decode; K2 and its taps instantiation); each path's counts are
set to 0 just before it runs and read just after, all four at once
(tools/kernel_check.py; the cross-process ranks and soak_events' timed run
count through the same helpers), and the kernels line carries them
(launches_<path>).

Every pass decodes with a fresh app.  The first app of a configuration
designs its channel filters (setup_s is that construction's time); the
later apps of the same configuration take over its tables (_shared_design),
so that the script's time goes into the passes and not into repeating one
host computation.

The second-to-last line is the kernels' JSON summary, the last line
{"ok": true, "device": {...}}.  Any failed phase raises (exit code != 0).
Nothing runs without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

from dumphfdl_tpu_torch import constants as C
from dumphfdl_tpu_torch.device import require_cuda
from dumphfdl_tpu_torch.tools.alias import ALIAS_STEP, split_junk
from dumphfdl_tpu_torch.tools.kernel_check import (
    compare_k2 as _compare_k2, cuda_ms, k1_bound, k2_bound,
    k2_pair as _k2_pair, launches as _launches, timed_ms,
    zero_launches as _zero_launches)
from dumphfdl_tpu_torch.utils.profiling import device_profile

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


T0 = time.monotonic()


def say(card: str, phase: str, **kv) -> None:
    """One line of a phase's results; at_s is the script's wall so far."""
    kv['at_s'] = round(time.monotonic() - T0, 1)
    print(f'[{card}] {phase}: ' + json.dumps(kv), flush=True)


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
    single_ms = plain_ms = 0.0
    softs, plains, lengths = [], [], []
    for m, p in enumerate(C.MODES):
        nb = p.framebits
        bits = rng.integers(0, 2, (64, nb))
        bits[:, -6:] = 0
        soft = np.stack([fec.hard_to_soft(fec.conv_encode(b)).astype(np.int32)
                         for b in bits])
        soft = np.clip(soft + rng.integers(-100, 101, soft.shape), 0, 255)
        s = torch.as_tensor(soft.astype(np.uint8), device=dev)
        before = fec_cuda.one_mode_launches
        k = fec_cuda.viterbi_decode(s, nb)
        if fec_cuda.one_mode_launches != before + 1:
            raise AssertionError('K1 wrapper did not launch its kernel')
        pl, t_p = timed_ms(lambda: fec.viterbi_decode(s, nb))
        if not torch.equal(k, pl):
            raise AssertionError(f'K1 mode {m}: kernel differs from plain '
                                 f'in {int((k != pl).sum())} bits')
        t_k = cuda_ms(lambda: fec_cuda.viterbi_decode(s, nb), 20)
        single_ms += t_k
        plain_ms += t_p
        softs.append(s)
        plains.append(pl)
        lengths.append(nb)
        say(card, f'K1 mode {m}', frames=64, nbits=nb, bit_exact=True,
            bit_errors_vs_sent=int((k.cpu().numpy() != bits).sum()),
            kernel_ms=t_k, plain_ms=t_p)
    # the main path's call: the eight modes of an event block, one launch
    before = fec_cuda.launches
    many = fec_cuda.viterbi_decode_many(softs, lengths)
    if fec_cuda.launches != before + 1:
        raise AssertionError('K1 many-mode wrapper did not launch once')
    for m, (k, pl) in enumerate(zip(many, plains)):
        if not torch.equal(k, pl):
            raise AssertionError(f'K1 many-mode, mode {m}: kernel differs '
                                 f'from plain in {int((k != pl).sum())} bits')
    ms = cuda_ms(lambda: fec_cuda.viterbi_decode_many(softs, lengths), 20)
    bnd = k1_bound(softs, many)
    say(card, 'K1 event block', frames=64, modes=len(lengths), launches=1,
        bit_exact=True, kernel_ms=ms, one_launch_per_mode_ms=single_ms,
        plain_ms=plain_ms, **bnd)
    return dict(name='viterbi27', route='cuda',
                source='dumphfdl_tpu_torch/csrc/viterbi.cu',
                replaces='dumphfdl_tpu/ops/fec_pallas.py:50',
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bnd)


def phase_k2(card: str, dev: torch.device) -> dict:
    from dumphfdl_tpu_torch.dsp import modulator, tracker as trk
    from dumphfdl_tpu_torch.dsp import tracker_cuda as tc
    from dumphfdl_tpu_torch.dsp.channel import agc_block, agc_init, \
        matched_filter
    rng = np.random.default_rng(2)
    steps = 5400 // C.SPS               # the CLI's default demod block
    T = 3 * steps + trk.HALO

    # the kernel's inline cosine/sine are cosf/sinf bit for bit
    bad = tc.trig_mismatches(dev)
    if bad:
        raise AssertionError(f'K2 inline cos/sin differ from cosf/sinf for '
                             f'{bad} arguments')
    say(card, 'K2 trig', mismatches_vs_cosf_sinf=bad)

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
        bnd = k2_bound(nch, t, n_sym)
        say(card, 'K2 noise', channels=nch, symbols=n_sym, max_abs_err=e,
            kernel_ms=t_k, plain_ms=t_p, **bnd)

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
                max_abs_err=max(err, err_f), ms=t_k, plain_ms=t_p,
                library_ms=None, **bnd)


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


# The 1024-channel capture may decode alias images two channels from an
# emitter as FCS-failing frames (tools/alias.py, ALIAS_STEP); the superstep
# phase shows the cause: the same emissions under noise of NOISY_SNR_DB
# (about 30 dB in a channel's band, 46 dB above the images) must decode with
# no junk at all.
NOISY_SNR_DB = -26.0


def _ledger(events, emit_by_chan: dict, alias_steps: tuple = ()) -> dict:
    """Every decoded frame against the emitted set: exact when each
    emitting channel decoded its frame once and nothing else came out.
    FCS-failing frames that tools/alias.split_junk calls images of an
    emitter's frame, alias_steps channels away, are counted apart
    (frames_alias_junk) and allowed."""
    cells, other, junk_evs, heard = {}, 0, [], {}
    for ev in events:
        if ev.pdu is None:
            continue
        if not ev.fcs_ok:
            junk_evs.append(ev)
            continue
        exp = emit_by_chan.get(ev.channel)
        if exp is not None and ev.pdu[:len(exp)] == exp:
            cells[ev.channel] = cells.get(ev.channel, 0) + 1
            heard.setdefault(ev.channel, []).append((ev.start_symbol,
                                                     ev.mode))
        else:
            other += 1
    alias_at, junk_at = split_junk(junk_evs, emit_by_chan, heard, alias_steps)
    junk = len(junk_at)
    led = dict(frames_ok=sum(cells.values()), frames_expected=len(emit_by_chan),
               frames_junk=junk, frames_alias_junk=len(alias_at),
               frames_other=other,
               frames_duplicate=sum(n - 1 for n in cells.values() if n > 1),
               missing_channels=sorted(set(emit_by_chan) - set(cells)),
               # [channel, mode, start symbol]
               junk_at=junk_at[:8], alias_at=alias_at[:12])
    led['exact'] = (led['frames_ok'] == len(emit_by_chan) and not junk
                    and not other and not led['frames_duplicate']
                    and not led['missing_channels'])
    return led


def _sync_all() -> None:
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def _scale_pass(argv: list[str], dev: torch.device, emit_by_chan: dict,
                prof=None, drive=None, prepare=None, alias_steps=(),
                mesh=None):
    """Build the app as the CLI does and decode the capture once:
    (set-up seconds, wall seconds of the decode, ledger, app).  drive(app,
    args) feeds the app (default: run_file on the file); prepare(app) may
    adjust it first.  mesh: a DeviceMesh to decode on (what --mesh would
    build, where this script names the devices itself).  The events the
    app handled are left in app.smoke_events."""
    from dumphfdl_tpu_torch import cli
    args = cli.build_parser().parse_args(argv)
    if mesh is not None:
        args.mesh = mesh
    t0 = time.perf_counter()
    app = cli.build_app(args, dev)
    setup = time.perf_counter() - t0
    if prepare is not None:
        prepare(app)
    if drive is None:
        drive = lambda app, args: app.run_file(args.iq_file,
                                               args.sample_format)
    rec = _Recorder()
    _sync_all()
    try:
        with prof if prof is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            drive(app, args)
            _sync_all()
            wall = time.perf_counter() - t0
    finally:
        rec.close()
        app.shutdown()
    app.smoke_events = rec.events
    led = _ledger(rec.events, emit_by_chan, alias_steps)
    if not led['exact']:
        raise AssertionError(f'ledger not exact: {led}')
    return setup, wall, led, app


def _profiler():
    from dumphfdl_tpu_torch.utils import profiling
    return profiling.profiler('cuda')


@contextlib.contextmanager
def _shared_design():
    """While this is open, a Channelizer whose deployment (geometry, rate,
    centre, channel list, rows) was designed before takes over those filter
    tables instead of designing them again.  The tables are a pure function
    of the deployment and are only read."""
    from dumphfdl_tpu_torch.dsp import frontend
    design, done = frontend._design_tables, {}

    def shared(*deployment):
        if deployment not in done:
            done[deployment] = design(*deployment)
        return done[deployment]
    frontend._design_tables = shared
    try:
        yield done
    finally:
        frontend._design_tables = design


def _bench_capture(nch: int, fs: int, name: str, pad_symbols: int = 300,
                   emitters: int = 16, snr_db: float = 30.0):
    """bench.py's end-to-end capture: nch channels around 10 MHz, traffic
    on `emitters` evenly spaced channels cycling through the single-slot
    modes, snr_db of SNR (bench.py's 30 dB), CS16, made by the numpy
    modulator from seed 0.  Returns (path, freqs, center, emitted PDU by
    channel, seconds of capture, seconds it took to make)."""
    from dumphfdl_tpu_torch.dsp import modulator
    from dumphfdl_tpu_torch.io import formats
    center = 10_000_000
    spacing = max(3000, min(8000, (fs - 20000) // nch))
    freqs = [center + (i - nch // 2) * spacing for i in range(nch)]
    single = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
    rng = np.random.default_rng(0)
    emissions, emit_by_chan = [], {}
    for k, ci in enumerate(range(0, nch, nch // emitters)):
        mode = single[k % len(single)]
        pdu = modulator.make_test_mpdu(mode, rng)
        emissions.append((pdu, mode, freqs[ci]))
        emit_by_chan[ci] = pdu
    t0 = time.perf_counter()
    wb = modulator.synthesize_wideband_fft(emissions, fs=fs, centerfreq=center,
                                           snr_db=snr_db,
                                           pad_symbols=pad_symbols)
    path = WORK / name
    path.write_bytes(formats.serialize(wb, 'CS16'))
    return (path, freqs, center, emit_by_chan, len(wb) / fs,
            time.perf_counter() - t0)


def _argv(path, fs: int, center: int, freqs, block: int, out: str) -> list:
    return ['--iq-file', str(path), '--sample-format', 'CS16',
            '--sample-rate', str(fs), '--centerfreq', str(center / 1000),
            '--demod-block', str(block),
            '--output', f'decoded:text:file:path={WORK / out}'] \
        + [str(f / 1000) for f in freqs]


def phase_scale(card: str, dev: torch.device):
    """bench.py's end-to-end child, first rung: 512 channels at 2.16 Msps
    CS16, traffic on every 32nd channel cycling through the single-slot
    modes, 30 dB SNR; decoded in three passes, each with a fresh app and
    an exact ledger.  Returns (launches, capture) for the unfused phase."""
    nch, fs = 512, 2_160_000
    cap = _bench_capture(nch, fs, 'scale.cs16')
    path, freqs, center, emit_by_chan, duration, synth_s = cap
    argv = _argv(path, fs, center, freqs, DEMOD_BLOCK, 'scale.txt')

    # pass 1, the first of the process: launch counters and peak memory
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    setup, wall, led, _ = _scale_pass(argv, dev, emit_by_chan)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    # pass 2: warm (a fresh app on the first one's filter tables)
    setup2, wall2, _, _ = _scale_pass(argv, dev, emit_by_chan)
    say(card, 'scale', channels=nch, sample_rate=fs, fmt='CS16',
        demod_block=DEMOD_BLOCK, capture_s=duration, synth_s=synth_s,
        setup_s=setup, setup_shared_design_s=setup2, wall_s=wall,
        rt_factor=duration / wall, warm_wall_s=wall2,
        warm_rt_factor=duration / wall2, max_memory_allocated=peak,
        launches=launches, **led)
    # one demod block of capture and one of flush padding; all 16 frames
    # end in the first, so there is one event block
    if launches != {'viterbi27': 1, 'viterbi27_one_mode': 0, 'tracker': 2,
                    'tracker_taps': 0}:
        raise AssertionError(f'main path launched {launches}, expected K2 '
                             'twice and K1 once (in one event block)')
    # pass 3: warm, under the profiler
    prof = _profiler()
    _, wall3, _, _ = _scale_pass(argv, dev, emit_by_chan, prof)
    say(card, 'scale profile', wall_s=wall3, **device_profile(prof, wall3))
    return launches, cap


def phase_bench(card: str, dev: torch.device) -> dict:
    """bench.py's first rung through the port's bench entry point: one app,
    3 warm and 4 timed passes and the flush, an exact (channel, pass)
    ledger on the unfused path; then the demod-only measurement at 1024
    channels.  Returns the wrappers' launches over the rung."""
    from dumphfdl_tpu_torch.tools import bench
    out = bench.e2e_rung(512, 2_160_000, 'CS16', device=dev, warm=3,
                         passes=4)
    launches = out['launches']
    say(card, 'bench', **out)
    if not out['exact'] or out['frames_ok'] != 112 \
            or out['frames_expected_total'] != 112 or out['frames_junk'] \
            or out['path'] != 'unfused' or not launches['tracker'] \
            or not launches['viterbi27']:
        raise AssertionError(f'bench rung: {out}')
    demod = bench.demod_only(1024, device=dev)
    say(card, 'bench demod_only', **demod)
    if demod['frames'] or not demod['launches']['tracker']:
        raise AssertionError(f'bench demod_only: {demod}')
    return launches


def phase_bench_ladder(card: str) -> list:
    """bench.py's ladder through tools/bench.main (each rung in a child
    process, --check-kernels), and where two or more cards are visible
    tools/bench_scaling.  Returns the kernels line's entries of the widest
    rung measured with every cell decoded."""
    from dumphfdl_tpu_torch.tools import bench, bench_scaling
    path = WORK / 'bench.json'
    t0 = time.perf_counter()
    rc = bench.main(['--check-kernels', '--out', str(path)])
    wall = time.perf_counter() - t0
    out = json.loads(path.read_text())
    for r in out['rungs']:
        say(card, 'bench rung', **{k: v for k, v in r.items()
                                   if k != 'kernels'})
    say(card, 'bench ladder', rc=rc, wall_s=wall,
        **{k: v for k, v in out.items() if k not in ('rungs', 'demod_only')})
    say(card, 'bench demod_only', **(out['demod_only'] or {}))
    done = {f"{r['channels']}@{r['sample_rate']}@{r['sample_format']}"
            for r in out['rungs'] if r['coverage_ok']}
    labels = [f'{n}@{fs}@{fmt}' for n, fs, fmt in
              bench.parse_search(bench.DEFAULT_SEARCH)]
    if not all(lb in done or lb in out['failures'] for lb in labels):
        raise AssertionError(f'bench ladder: a rung neither measured nor '
                             f'failed: {out["search"]}, {out["failures"]}')
    # a rung may fail for its size (its watchdog, CUDA out of memory); any
    # other failure, and any measured rung whose ledger is not exact, is a
    # fault
    wrong = bench.faults(out)
    if wrong or rc != (0 if out['ok'] else 1):
        raise AssertionError(f'bench ladder: rc {rc}, {wrong}')
    if not out['rungs']:
        raise AssertionError('bench ladder: no rung measured')
    widest = max(out['rungs'], key=lambda r: r['channels'])
    k = widest['kernels']
    where = dict(rung=f"{widest['channels']}@{widest['sample_rate']}@"
                 f"{widest['sample_format']}", path=widest['path'])
    say(card, 'bench K2', **where, **k['k2'])
    say(card, 'bench K1', **where, **k['k1'])
    if torch.cuda.device_count() >= 2:
        spath = WORK / 'bench_scaling.json'
        src = bench_scaling.main(['--out', str(spath)])
        sc = json.loads(spath.read_text())
        for pt in sc['points']:
            say(card, 'bench_scaling', **{k_: v for k_, v in pt.items()
                                          if k_ != 'decoded'})
        if src or not sc['ok']:
            raise AssertionError('bench_scaling: PDU sets or counted bytes '
                                 'differ')
    common = dict(route='cuda', max_abs_err=0.0, library_ms=None, **where)
    return [
        dict(name='tracker_bench', source='dumphfdl_tpu_torch/csrc/tracker.cu',
             replaces='dumphfdl_tpu/dsp/tracker_pallas.py:103',
             launches=widest['launches']['tracker'], ms=k['k2']['kernel_ms'],
             plain_ms=k['k2']['plain_ms'], **common,
             **{f: k['k2'][f] for f in ('bound_ms', 'bound_by', 'bound_bytes',
                                        'bound_ops', 'chain_steps',
                                        'kernel_alone_ms')}),
        dict(name='viterbi27_bench', source='dumphfdl_tpu_torch/csrc/viterbi.cu',
             replaces='dumphfdl_tpu/ops/fec_pallas.py:50',
             launches=widest['launches']['viterbi27'],
             ms=k['k1']['kernel_ms'], plain_ms=k['k1']['plain_ms'], **common,
             **{f: k['k1'][f] for f in ('bound_ms', 'bound_by', 'bound_bytes',
                                        'bound_ops', 'chain_steps')})]


def phase_k2_taps(card: str, dev: torch.device) -> dict:
    """K2's debug_taps instantiation at 512 channels x 1800 symbols."""
    from dumphfdl_tpu_torch.dsp import tracker as trk
    from dumphfdl_tpu_torch.dsp import tracker_cuda as tc
    from dumphfdl_tpu_torch.tools import kernel_times
    rng = np.random.default_rng(12)
    nch, n_sym = 512, 5400 // C.SPS
    t = 3 * n_sym + trk.HALO
    x = torch.as_tensor((rng.standard_normal((nch, t))
                         + 1j * rng.standard_normal((nch, t)))
                        .astype(np.complex64), device=dev)
    lvl = torch.as_tensor((np.abs(rng.standard_normal((nch, t))) + 0.5)
                          .astype(np.float32), device=dev)
    st = trk.tracker_init(nch, dev)
    before = tc.launches, tc.taps_launches
    r_k = tc.tracker_block(st, x, lvl, n_sym, debug_taps=True)
    if (tc.launches, tc.taps_launches) != (before[0], before[1] + 1):
        raise AssertionError('K2 taps: the wrapper did not launch the taps '
                             'instantiation once')
    r_p, t_p = timed_ms(lambda: trk.tracker_block(st, x, lvl, n_sym, None,
                                                  debug_taps=True))
    # acq_hit is the wrapper's to carry; with the gate off it stays
    r_p = (r_p[0]._replace(acq_hit=r_k[0].acq_hit), *r_p[1:])
    if _compare_k2('taps vs plain', *r_k, *r_p, tol=0.0) != 0.0:
        raise AssertionError('K2 taps: not exact against the plain version')
    if r_k[1].taps.shape != (n_sym, nch, 3) \
            or not torch.equal(r_k[1].taps, r_p[1].taps):
        raise AssertionError('K2 taps: the taps differ from the plain '
                             "version's")
    if not bool((r_k[1].taps.abs().amax(dim=(0, 1)) > 0).all()):
        raise AssertionError('K2 taps: a plane of taps is all zero')
    r_off = tc.tracker_block(st, x, lvl, n_sym, use_acq=False)
    if r_off[1].taps is not None or \
            _compare_k2('taps on vs off', *r_k, *r_off, tol=0.0) != 0.0:
        raise AssertionError('K2 taps: taps-on differs from taps-off')
    ms = cuda_ms(lambda: tc.tracker_block(st, x, lvl, n_sym,
                                          debug_taps=True), 5)
    off_ms = cuda_ms(lambda: tc.tracker_block(st, x, lvl, n_sym,
                                              use_acq=False), 5)
    lines = kernel_times.ptxas_report()['tracker.cu']
    regs = {'normal': kernel_times.registers(lines, 'tracker_kernelILb0EE'),
            'taps': kernel_times.registers(lines, 'tracker_kernelILb1EE')}
    bnd = k2_bound(nch, t, n_sym, taps=True)
    say(card, 'K2 taps', channels=nch, symbols=n_sym, exact_vs_plain=True,
        taps_exact=True, bit_equal_to_taps_off=True, kernel_ms=ms,
        taps_off_ms=off_ms, plain_ms=t_p, registers=regs, **bnd)
    return dict(name='tracker_taps', route='cuda',
                source='dumphfdl_tpu_torch/csrc/tracker.cu',
                replaces='dumphfdl_tpu/dsp/tracker_pallas.py:426',
                max_abs_err=0.0, ms=ms, plain_ms=t_p, library_ms=None, **bnd)


def phase_unfused(card: str, dev: torch.device, cap) -> list:
    """The scale capture with the CLI's default --demod-block 5400: at
    2.16 Msps no whole number of resampler cosets, so the receiver takes
    the unfused channelizer path.  Returns the pass's events, which the
    mesh phase is held to."""
    path, freqs, center, emit_by_chan, duration, _ = cap
    argv = _argv(path, 2_160_000, center, freqs, 5400, 'unfused.txt')
    checked = []

    def prepare(app):
        rx = app.receiver
        if rx.fused or rx.superstep is not None:
            raise AssertionError('unfused phase: the receiver took another '
                                 'path')
        checked.append(rx)
    _, wall, led, app = _scale_pass(argv, dev, emit_by_chan, prepare=prepare)
    prof = _profiler()
    _, wall_p, _, _ = _scale_pass(argv, dev, emit_by_chan, prof,
                                  prepare=prepare)
    dp = device_profile(prof, wall_p)
    say(card, 'unfused', channels=len(freqs), sample_rate=2_160_000,
        demod_block=5400, capture_s=duration, wall_s=wall,
        rt_factor=duration / wall, profiled_wall_s=wall_p,
        receivers_checked=len(checked), **led, **dp)
    return app.smoke_events


def _superstep_pass(*args, **kw):
    """_scale_pass for the 1024-channel capture, whose ledger allows the
    alias images (ALIAS_STEP)."""
    return _scale_pass(*args, alias_steps=(ALIAS_STEP,), **kw)


def _k2_events(dp: dict) -> int:
    """K2's kernel events in a profiled pass (device_profile)."""
    return dp['by_kind'].get('K2 tracker', [0.0, 0])[1]


def _k2_on_superstep_blocks(card: str, vapp, chunks) -> dict:
    """K2 at the shape the superstep gives it.  Runs the engine's step
    eagerly on the uploaded chunks while recording what it hands
    tracker_cuda.tracker_block (the carried TrackerState, the extended
    matched-filter block and level, 1024 x (3 * 3584 + HALO), gate on), then
    holds the wrapper against the plain version on each recorded block:
    exact.  Times the wrapper on the last one.  Returns the kernels-line
    entry (without its launches)."""
    from dumphfdl_tpu_torch.dsp import tracker as trk
    from dumphfdl_tpu_torch.dsp import tracker_cuda as tc
    ss = vapp.receiver.superstep
    seen, wrapper = [], tc.tracker_block

    def recording(state, x, level, num_steps, use_acq=True,
                  debug_taps=False):
        seen.append((trk.TrackerState(*[None if v is None else v.clone()
                                        for v in state]),
                     x.clone(), level.clone(), num_steps, use_acq,
                     debug_taps))
        return wrapper(state, x, level, num_steps, use_acq, debug_taps)

    ss.use_graph = False            # eager steps: the wrapper is called
    tc.tracker_block = recording
    try:
        for chunk in chunks:
            vapp.receiver.process_packed(chunk)
    finally:
        tc.tracker_block = wrapper
    if len(seen) != len(chunks):
        raise AssertionError(f'superstep K2: {len(seen)} wrapper calls in '
                             f'{len(chunks)} steps')
    events = 0
    for i, (st, x, lvl, n_sym, use_acq, taps) in enumerate(seen):
        if (tuple(x.shape), n_sym, use_acq, taps) != \
                ((ss.rows, 3 * ss.plan.symbols + trk.HALO),
                 ss.plan.symbols, True, False):
            raise AssertionError(f'superstep K2: the step handed the wrapper '
                                 f'{tuple(x.shape)}, {n_sym}, {use_acq}')
        act, _ = tc.tile_activity(st, x, True)
        r_k, r_p, t_p = _k2_pair(st, x, lvl, n_sym, use_acq=True)
        if _compare_k2(f'superstep block {i}', *r_k, *r_p, tol=0.0) != 0.0:
            raise AssertionError('superstep K2: not exact')
        ev = r_k[2].reshape(-1, trk.K_EVENTS, trk.EV_FIELDS)
        n_ev = int((ev[:, :, 0] > 0.5).sum())
        events += n_ev
        tiles = int(act.sum())
        t_k = cuda_ms(lambda: tc.tracker_block(st, x, lvl, n_sym,
                                               use_acq=True), 5)
        # the work of this block's data: its active tiles' channels
        bnd = k2_bound(tiles * trk.CT, x.shape[1], n_sym)
        say(card, 'superstep K2', block=i, channels=x.shape[0],
            symbols=n_sym, gate=True, active_tiles=tiles, tiles=len(act),
            events=n_ev, max_abs_err=0.0, kernel_ms=t_k, plain_ms=t_p, **bnd)
    if events < 1 or tiles < 1:
        raise AssertionError('superstep K2: the compared blocks carried no '
                             'frame')
    return dict(name='tracker_superstep', route='cuda',
                source='dumphfdl_tpu_torch/csrc/tracker.cu',
                replaces='dumphfdl_tpu/dsp/tracker_pallas.py:103',
                max_abs_err=0.0, ms=t_k, plain_ms=t_p, library_ms=None, **bnd)


def phase_superstep(card: str, dev: torch.device):
    """The second rung of bench.py's end-to-end child on the superstep:
    1024 channels at 3.456 Msps CS16, --demod-block 16200, a frame on
    every 32nd channel.  Returns (the wrappers' launch counts over the
    first pass, K2's kernels-line entry at this path's shape)."""
    from dumphfdl_tpu_torch.io import formats, ingest
    nch, fs, block = 1024, 3_456_000, 16200
    # 3488 symbols of silence either side of the frames: 6.3 s of capture,
    # a length whose FFT has only small factors (the synthesis is one FFT)
    cap = _bench_capture(nch, fs, 'superstep.cs16', pad_symbols=3488,
                         emitters=nch // 32)
    path, freqs, center, emit_by_chan, duration, synth_s = cap
    argv = _argv(path, fs, center, freqs, block, 'superstep.txt')
    engines = []

    def engaged(app):
        ss = app.receiver.superstep
        if ss is None or not ss.use_graph or ss.input_kind != 'CS16':
            raise AssertionError('superstep phase: the engine did not '
                                 'engage with a graph')
        engines.append(ss)

    def eager(app):
        engaged(app)
        app.receiver.superstep.use_graph = False

    # pass 1, cold: the wrappers' launch counts, peak memory, the plan
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    setup, wall, led, app = _superstep_pass(argv, dev, emit_by_chan,
                                            prepare=engaged)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    ss = engines[-1]
    plan = ss.plan
    want = dict(out_chunk=10752, frames=15, wb_chunk=6_881_280)
    if {k: getattr(plan, k) for k in want} != want:
        raise AssertionError(f'superstep plan {plan}, expected {want}')
    n_capture = -(-os.path.getsize(path) // ss.raw_chunk_bytes)
    if n_capture < 3:
        raise AssertionError('capture shorter than three super-blocks')
    # the wrapper launches K2 in the eager first block and once more while
    # the graph is recorded; every later block is a replay of that graph
    # (what the replays run is read from the profiled passes below)
    if ss.replays != ss.blocks_done - 1 or ss.replays < n_capture \
            or launches['tracker'] != 2 or launches['viterbi27'] < 1 \
            or launches['tracker_taps']:
        raise AssertionError(
            f'superstep ran {ss.blocks_done} blocks, {ss.replays} replays, '
            f'launched {launches}')
    # pass 2, warm: a fresh app on the first one's filter tables (the graph
    # is captured anew)
    setup2, wall2, _, _ = _superstep_pass(argv, dev, emit_by_chan,
                                          prepare=engaged)
    say(card, 'superstep', channels=nch, sample_rate=fs, fmt='CS16',
        demod_block=block, out_chunk=plan.out_chunk, frames=plan.frames,
        sub=plan.sub, wb_chunk=plan.wb_chunk,
        raw_chunk_bytes=ss.raw_chunk_bytes, capture_s=duration,
        synth_s=synth_s, capture_blocks=n_capture, blocks=ss.blocks_done,
        graph_replays=ss.replays, setup_s=setup, setup_shared_design_s=setup2,
        wall_s=wall, rt_factor=duration / wall, warm_wall_s=wall2,
        warm_rt_factor=duration / wall2, max_memory_allocated=peak,
        wrapper_launches=launches, **led)

    # the graph against the eager step, bit for bit, on the capture's
    # second block after the first has run (a receiver of its own); then K2
    # against its plain version on the blocks the next two steps give it
    _, _, _, vapp = _superstep_pass(
        _argv(path, fs, center, freqs, block, 'superstep.txt'), dev, {},
        prepare=engaged, drive=lambda app, args: None)
    vss = vapp.receiver.superstep
    with open(path, 'rb') as fh:
        chunks = [vss.upload(c) for _, c in zip(range(4), ingest.file_chunks(
            fh, 'CS16', vss.raw_chunk_bytes, pad_final=True))]
    vapp.receiver.process_packed(chunks[0])
    compared = vss.verify_graph(chunks[1])
    torch.cuda.synchronize()
    k2 = _k2_on_superstep_blocks(card, vapp, chunks[2:])
    # the replay's time alone, on the last block's input
    ms_replay = cuda_ms(vss._graph.replay, 5)
    ms_eager = cuda_ms(vss._step, 2)
    say(card, 'superstep graph', tensors_bit_equal=compared,
        replay_ms_per_block=ms_replay, eager_ms_per_block=ms_eager,
        block_s=plan.wb_chunk / fs)

    # one eager and one graph pass under the profiler: K2's kernel events
    # are its launches on the device, one per block on either path
    for name, prep in (('eager', eager), ('graph', engaged)):
        prof = _profiler()
        _, wall_p, _, _ = _superstep_pass(argv, dev, emit_by_chan, prof,
                                          prepare=prep)
        ess = engines[-1]
        blocks = ess.blocks_done
        dp = device_profile(prof, wall_p)
        if _k2_events(dp) != blocks or \
                ess.replays != (blocks - 1 if name == 'graph' else 0):
            raise AssertionError(
                f'superstep {name} pass: {_k2_events(dp)} K2 kernel events '
                f'in {blocks} blocks, {ess.replays} replays')
        say(card, f'superstep profile {name}', wall_s=wall_p,
            rt_factor=duration / wall_p, blocks=blocks,
            graph_replays=ess.replays, k2_kernel_events=_k2_events(dp),
            k2_launches_per_block=_k2_events(dp) / blocks,
            device_events_per_block=dp['device_events'] / blocks, **dp)
    k2['kernel_events_graph_pass'] = _k2_events(dp)
    k2['graph_replays'] = ess.replays

    # the cause of the alias junk: the same emissions under noise that
    # covers the images (about 30 dB in a channel's band) decode with no
    # junk at all, through the same graph path
    ncap = _bench_capture(nch, fs, 'superstep_noisy.cs16', pad_symbols=3488,
                          emitters=nch // 32, snr_db=NOISY_SNR_DB)
    if ncap[3] != emit_by_chan:
        raise AssertionError('noisy capture: other emissions')
    _, wall_n, led_n, _ = _scale_pass(
        _argv(ncap[0], fs, center, freqs, block, 'superstep_noisy.txt'), dev,
        emit_by_chan, prepare=engaged)
    say(card, 'superstep noisy', snr_db=NOISY_SNR_DB,
        in_band_snr_db=NOISY_SNR_DB
        + 20 * float(np.log10(fs // C.INTERNAL_RATE)),
        wall_s=wall_n, **led_n)

    # the live paths on the same capture: complex64 chunks of 65536
    # samples through run_stream, raw CS16 buffers through run_stream_raw;
    # each ends with the receiver's flush, as a file run does
    raw = path.read_bytes()

    def stream(app, args):
        x = formats.convert(raw, 'CS16')
        app.run_stream(x[o:o + 65_536] for o in range(0, len(x), 65_536))
        app.handle_events(app.receiver.flush())

    def stream_raw(app, args):
        n = 65_536 * 4
        app.run_stream_raw((raw[o:o + n] for o in range(0, len(raw), n)),
                           'CS16')
        app.handle_events(app.receiver.flush())

    for name, drive in (('run_stream', stream),
                        ('run_stream_raw', stream_raw)):
        _, wall_s, led_s, sapp = _superstep_pass(argv, dev, emit_by_chan,
                                                 prepare=engaged, drive=drive)
        if sapp.last_ingest_overruns or engines[-1].replays < n_capture - 1:
            raise AssertionError(
                f'{name}: {sapp.last_ingest_overruns} samples overrun, '
                f'{engines[-1].replays} replays')
        say(card, f'stream {name}', wall_s=wall_s,
            rt_factor=duration / wall_s, overruns=0,
            blocks=engines[-1].blocks_done, **led_s)
    return launches, k2


def phase_datadumps(card: str, dev: torch.device) -> int:
    """The golden capture through the CLI with --datadumps, in a scratch
    directory: nine stages per channel, whole blocks each, the pinned
    bytes, and the taps instantiation of K2 on the path."""
    import shutil
    from dumphfdl_tpu_torch import cli
    from dumphfdl_tpu_torch.dsp import dumpfile, tracker_cuda
    gold = ROOT / 'tests' / 'golden'
    man = json.loads((gold / 'manifest.json').read_text())
    out = WORK / 'dumps'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    rec = _Recorder()
    cwd = os.getcwd()
    tracker_cuda.taps_launches = 0
    normal_before = tracker_cuda.launches
    try:
        os.chdir(out)
        rc = cli.main([
            '--iq-file', str(gold / man['capture']),
            '--sample-format', man['format'],
            '--sample-rate', str(man['sample_rate']),
            '--centerfreq', str(man['centerfreq'] / 1000), '--datadumps',
            '--output', f'decoded:text:file:path={out / "golden.txt"}',
        ] + [str(f / 1000) for f in man['frequencies']], device=dev)
    finally:
        os.chdir(cwd)
        rec.close()
    launches = tracker_cuda.taps_launches
    if rc != 0 or launches < 1 or tracker_cuda.launches != normal_before:
        raise AssertionError(f'datadumps: rc {rc}, {launches} taps launches, '
                             f'{tracker_cuda.launches - normal_before} '
                             'normal ones')
    got = {(e.channel, e.mode): e.pdu.hex() for e in rec.events if e.pdu}
    for exp in man['frames']:
        if got.get((exp['channel'], exp['mode'])) != exp['pdu_hex']:
            raise AssertionError(f'datadumps: golden frame {exp["channel"]}/'
                                 f'{exp["mode"]} missing or wrong')
    real = ('agc_level', 'costas_dphi', 'costas_err', 'symsync_tau')
    counts = {}
    for stage in dumpfile.STAGES:
        per_sample = stage in ('chan_out', 'agc_out', 'agc_level', 'mf_out')
        for ch in range(len(man['frequencies'])):
            ext, size = ('rf32', 4) if stage in real else ('cf32', 8)
            f = out / f'{stage}.ch{ch}.{ext}'
            n = f.stat().st_size // size if f.exists() else 0
            want = launches * (5400 if per_sample else 1800)
            if n != want:
                raise AssertionError(f'datadumps: {f.name} holds {n} '
                                     f'samples, expected {want}')
            counts[stage] = n
    if len(counts) != 9:
        raise AssertionError('datadumps: not nine stages')
    say(card, 'datadumps', files=9 * len(man['frequencies']),
        samples_per_channel=counts, taps_launches=launches,
        pdu_bytes_match=True)
    return launches


def _mesh_of(t: int, k: int):
    """(what to decode on, physical device count): the CLI's --mesh string
    where enough devices are visible for it, else a DeviceMesh of t*k
    logical shards on cuda:0."""
    from dumphfdl_tpu_torch.parallel.sharding import DeviceMesh
    n = torch.cuda.device_count()
    if n >= t * k:
        return f'{t}x{k}', t * k
    return DeviceMesh([['cuda:0'] * k for _ in range(t)]), 1


def _mesh_pass(argv, dev, emit_by_chan, t, k, prof=None, instrument=False):
    """One decode on a t x k mesh; (wall, ledger, app, physical devices)."""
    from dumphfdl_tpu_torch.parallel.sharding import ShardedWidebandReceiver
    mesh, physical = _mesh_of(t, k)

    def prepare(app):
        rx = app.receiver
        if not isinstance(rx, ShardedWidebandReceiver) or \
                rx.mesh.shape != {'time': t, 'chan': k}:
            raise AssertionError('mesh phase: not the sharded receiver')
        rx.instrument = instrument
    if isinstance(mesh, str):
        argv, mesh = ['--mesh', mesh] + argv, None
    _, wall, led, app = _scale_pass(argv, dev, emit_by_chan, prof,
                                    prepare=prepare, mesh=mesh)
    return wall, led, app, physical


def _check_mesh_traffic(rx) -> dict:
    """The bytes counted between shards over a pass against comm_model():
    halo and reshard per super-block as modelled, the reshard exactly
    (T-1)/T of the fs1 chunk, and no other kind of copy (so the append,
    resample and demod part moved nothing)."""
    model, fr, mesh = rx.comm_model(), rx.frontend, rx.mesh
    T = fr.T
    want = {}
    if T > 1:
        want = {'halo': fr.steps * model['halo_bytes_per_superblock'],
                'reshard': fr.steps * model['reshard_bytes_per_superblock']}
    chunk = rx.bank._c * fr.nb_cols * 8
    if mesh.moved != want or fr.steps < 1 or \
            model['reshard_bytes_per_superblock'] * T != chunk * (T - 1) or \
            fr.upload_bytes != fr.steps * model['upload_bytes_per_superblock']:
        raise AssertionError(f'mesh traffic {mesh.moved} over {fr.steps} '
                             f'steps, modelled {want}')
    return dict(super_blocks=fr.steps,
                halo_bytes_per_superblock=model['halo_bytes_per_superblock'],
                reshard_bytes_per_superblock=model[
                    'reshard_bytes_per_superblock'],
                fs1_chunk_bytes=chunk,
                upload_bytes_per_superblock=model[
                    'upload_bytes_per_superblock'],
                copies=dict(mesh.copies), other_bytes_between_shards=0,
                comm_model={k: v for k, v in model.items()
                            if k.endswith('_per_s')})


def _say_shard_kernels(card: str, checked: dict, **where) -> dict:
    """Print kernel_check.check_shard_blocks's lines; returns K2's
    kernels-line entry at a mesh shard's shape (without its launches)."""
    for k2 in checked['k2']:
        say(card, 'mesh K2', **where, shard_device=checked['shard_device'],
            blocks=checked['blocks'], **k2)
    for k1 in checked['k1']:
        say(card, 'mesh K1', **where, shard_device=checked['shard_device'],
            **k1)
    k2 = checked['k2'][-1]
    return dict(name='tracker_mesh', route='cuda',
                source='dumphfdl_tpu_torch/csrc/tracker.cu',
                replaces='dumphfdl_tpu/dsp/tracker_pallas.py:103',
                max_abs_err=0.0, ms=k2['kernel_ms'],
                kernel_alone_ms=k2['kernel_alone_ms'], plain_ms=k2['plain_ms'],
                library_ms=None,
                **{k: k2[k] for k in ('bound_ms', 'bound_by', 'bound_bytes',
                                      'bound_ops', 'chain_steps')})


def _kernels_on_mesh_blocks(card: str, argv, dev, emit_by_chan) -> dict:
    """K2 and K1 at the shapes the 2x2 mesh gives them.  Decodes the
    capture once more on the mesh while recording what every shard hands
    tracker_cuda.tracker_block (the carried TrackerState, its 128 channels'
    extended matched-filter block and level, 1800 symbols, gate on, in the
    shard's own stream) and fec_cuda.viterbi_decode_many (an event block's
    soft chips for the eight modes).  Then, for the last shard that decoded
    frames, holds each wrapper against its plain version on those inputs
    (kernel_check.check_shard_blocks): K2 on two consecutive blocks, the
    second the first that completes a frame, and K1 on the shard's event
    blocks, all exact; K2 timed through its wrapper and by its launch
    alone.  Returns K2's kernels-line entry at this shape (without its
    launches)."""
    from dumphfdl_tpu_torch.tools import kernel_check
    with kernel_check.recording() as (k2_seen, k1_seen):
        _, _, app, physical = _mesh_pass(argv, dev, emit_by_chan, 2, 2)
    checked = kernel_check.check_shard_blocks(
        k2_seen, k1_seen, app.receiver.bank.rows_per_shard, 4)
    return _say_shard_kernels(card, checked, mesh='2x2',
                              physical_devices=physical)


def phase_mesh(card: str, dev: torch.device, cap, unfused_events) -> dict:
    """The 512-channel capture on a 2x2, a 1x1 and a 4x1 mesh.  Returns
    (the wrappers' launch counts over the first 2x2 pass, K2's kernels-line
    entry at a shard's shape, each mesh's first pass: its PDU events and
    the bytes it moved between shards)."""
    from dumphfdl_tpu_torch.dsp import channel
    path, freqs, center, emit_by_chan, duration, _ = cap
    fs = 2_160_000
    argv = _argv(path, fs, center, freqs, 5400, 'mesh.txt')
    want = sorted((e.channel, e.mode, e.pdu) for e in unfused_events if e.pdu)
    want_ferr = {e.channel: e.freq_err_hz for e in unfused_events if e.pdu}
    n_dev = torch.cuda.device_count()
    peers = {f'{a}->{b}': torch.cuda.can_device_access_peer(a, b)
             for a in range(n_dev) for b in range(n_dev) if a != b}
    collects = []
    fused_collect = channel.fused_collect

    def counting(*a, **kw):
        collects.append(1)
        return fused_collect(*a, **kw)

    launches, passes = None, {}
    for t, k in ((2, 2), (1, 1), (4, 1)):
        for d in range(n_dev):
            torch.cuda.reset_peak_memory_stats(d)
        collects.clear()
        _zero_launches()
        channel.fused_collect = counting
        try:
            wall, led, app, physical = _mesh_pass(argv, dev, emit_by_chan,
                                                  t, k)
        finally:
            channel.fused_collect = fused_collect
        got_launches = _launches()
        peak = [torch.cuda.max_memory_allocated(d) for d in range(physical)]
        rx = app.receiver
        events = [e for e in app.smoke_events if e.pdu]
        got = sorted((e.channel, e.mode, e.pdu) for e in events)
        ferr = max(abs(e.freq_err_hz - want_ferr[e.channel]) for e in events) \
            if got == want else float('nan')
        if got != want or not ferr < 0.1:
            raise AssertionError(f'mesh {t}x{k}: events differ from the '
                                 f'unfused single-device pass (freq_err '
                                 f'{ferr})')
        traffic = _check_mesh_traffic(rx)
        passes[f'{t}x{k}'] = dict(events=events, moved=dict(rx.mesh.moved),
                                  super_blocks=rx.frontend.steps,
                                  comm_model=rx.comm_model())
        blocks = rx.resamplers[0]._out_count // 5400
        shards_with_events = len({e.channel // rx.bank.rows_per_shard
                                  for e in events})
        if got_launches['tracker'] != t * k * blocks or \
                got_launches['viterbi27'] != len(collects) or \
                not shards_with_events <= len(collects) <= t * k * blocks:
            raise AssertionError(
                f'mesh {t}x{k}: launched {got_launches} in {blocks} blocks '
                f'on {t * k} shards, {len(collects)} event collections')
        # a second pass under the profiler, a third instrumented
        prof = _profiler()
        wall_p, _, _, _ = _mesh_pass(argv, dev, emit_by_chan, t, k, prof)
        dp = device_profile(prof, wall_p)
        _, _, iapp, _ = _mesh_pass(argv, dev, emit_by_chan, t, k,
                                   instrument=True)
        say(card, 'mesh', mesh=f'{t}x{k}', shards=t * k,
            physical_devices=physical, visible_devices=n_dev,
            peer_access=peers, channels=len(freqs), sample_rate=fs,
            demod_block=5400, capture_s=duration, wall_s=wall,
            rt_factor=duration / wall, profiled_wall_s=wall_p,
            max_memory_allocated=peak, launches=got_launches,
            demod_blocks=blocks, event_collections=len(collects),
            shards_with_events=shards_with_events,
            pdus_equal_unfused=True, max_freq_err_diff_hz=ferr,
            stage_wall_s=iapp.receiver.stage_time, **traffic, **led, **dp)
        if launches is None:
            launches = got_launches
            k2_mesh = _kernels_on_mesh_blocks(card, argv, dev, emit_by_chan)
    return launches, k2_mesh, passes


def phase_mesh_frontend(card: str, dev: torch.device, cap) -> None:
    """One sharded frontend step on the 2x2 mesh at the 512-channel
    geometry against the plain Channelizer on one device."""
    from dumphfdl_tpu_torch.dsp import frontend as fe
    from dumphfdl_tpu_torch.parallel.sharding import (DeviceMesh,
                                                      ShardedFrontend)
    _, freqs, center, _, _, _ = cap
    fs = 2_160_000
    n = torch.cuda.device_count()
    names = [f'cuda:{i}' for i in range(4)] if n >= 4 else ['cuda:0'] * 4
    mesh = DeviceMesh([names[:2], names[2:]])
    geo = fe.compute_geometry(fe.compute_fft_decimation_rate(fs),
                              C.CHANNEL_TRANSITION_BW_HZ / fs)
    tables = fe._design_tables(geo, fs, center, tuple(freqs), len(freqs))
    front = ShardedFrontend(geo, tables, mesh)
    rng = np.random.default_rng(13)
    x = ((rng.standard_normal(2 * front.super_len)
          + 1j * rng.standard_normal(2 * front.super_len)) * 0.3) \
        .astype(np.complex64)
    chz = fe.Channelizer(fs, center, freqs, dev, rows=len(freqs))
    ext = torch.as_tensor(np.concatenate(
        [np.zeros(geo.overlap_length, np.complex64), x]), device=dev)
    residual64 = tables[1]
    n_span = front.F * geo.post_input_size
    carried = None              # the plain channelizer's own float32 phase
    worst = worst_carried = 0.0
    for i in range(2):          # the second step starts from carried state
        got = front.gather(front.step(
            x[i * front.super_len:(i + 1) * front.super_len]))
        frames = ext[i * front.super_len:].unfold(
            0, geo.fft_size, geo.input_size)[:front.T * front.F]
        # the reference: the same frames through the plain channelizer in
        # batches of a shard's span, each from the start phase the sharded
        # frontend's policy gives it (float64 on the host); and once more
        # from the phase the plain channelizer carries itself in float32
        parts = []
        for t in range(front.T):
            start = i * front.nb_cols + t * n_span
            ph0 = torch.as_tensor(np.mod(residual64 * start, 1.0)
                                  .astype(np.float32), device=dev)
            parts.append(chz.channelize_frames(
                frames[t * front.F:(t + 1) * front.F], ph0)[0])
        want = torch.cat(parts, dim=1).cpu().numpy()
        own, carried = chz.channelize_frames(frames, carried)
        peak = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        err_carried = float(np.abs(got - own.cpu().numpy()).max())
        if got.shape != want.shape or not err <= 2e-5 * peak \
                or not err_carried <= 1e-4 * peak:
            raise AssertionError(
                f'mesh frontend step {i}: max |diff| {err} (from the '
                f"channelizer's carried phase {err_carried}) against a "
                f'peak of {peak}')
        worst = max(worst, err / peak)
        worst_carried = max(worst_carried, err_carried / peak)
    say(card, 'mesh frontend', mesh='2x2',
        physical_devices=len(mesh.physical_devices), channels=len(freqs),
        steps=2, super_len=front.super_len, fs1_cols=front.nb_cols,
        max_err_over_peak=worst, tolerance=2e-5,
        max_err_over_peak_vs_carried_float32_phase=worst_carried,
        tolerance_vs_carried_phase=1e-4,
        moved_bytes=dict(mesh.moved), upload_bytes=front.upload_bytes)


# how long a rank of the cross-process mesh may wait in one collective, and
# how long a child of the mesh_mp phase may run in all
MP_GROUP_TIMEOUT_S = 180
MP_CHILD_DEADLINE_S = 600


def _mp_layout() -> tuple[str, int, list[str], list[str]]:
    """(backend, ranks, each rank's device, meshes) of the mesh_mp phase:
    four processes on cuda:0..3 over nccl, 2x2 and 4x1, where four cards
    are visible; else two processes sharing cuda:0 over gloo (nccl refuses
    two ranks on one card), two logical shards each, 2x2."""
    if torch.cuda.device_count() >= 4:
        return 'nccl', 4, [f'cuda:{r}' for r in range(4)], ['2x2', '4x1']
    return 'gloo', 2, ['cuda:0', 'cuda:0'], ['2x2']


def _run_ranks(spec: str, backend: str, devices: list[str], argv: list[str],
               design: pathlib.Path, check_kernels: bool) -> list[dict]:
    """Run the mesh_mp child (dumphfdl_tpu_torch/tools/mesh_mp.py) once per
    rank over localhost (parallel/multihost.launch_local_ranks) and return
    each rank's JSON result.  Each child's output goes to a file under
    WORK; a child that fails or outlives MP_CHILD_DEADLINE_S ends the
    phase: the others are killed and the phase raises."""
    from dumphfdl_tpu_torch.parallel import multihost
    per_rank = 4 // len(devices) if spec == '2x2' else 1
    cmds = [[sys.executable, '-m', 'dumphfdl_tpu_torch.tools.mesh_mp',
             '--mesh', spec, '--shards-per-rank', str(per_rank),
             '--device', d, '--backend', backend,
             '--timeout', str(MP_GROUP_TIMEOUT_S), '--design', str(design),
             '--passes', '2', '--profile']
            + (['--check-kernels'] if check_kernels else []) + ['--']
            + [a.replace('mesh_mp.txt', f'mesh_mp.{spec}.{r}.txt')
               for a in argv]
            for r, d in enumerate(devices)]
    logdir = WORK / f'mesh_mp.{spec}'
    logdir.mkdir(exist_ok=True)
    try:
        return multihost.launch_local_ranks(cmds, logdir, MP_CHILD_DEADLINE_S)
    except RuntimeError as e:
        raise AssertionError(f'mesh_mp {spec}: {e}') from None


def phase_mesh_mp(card: str, cap, mesh_passes: dict, design: dict) -> dict:
    """The 512-channel capture of the mesh phase on a mesh across
    processes, each process one rank of a torch.distributed group that
    decodes through the app cli.build_app makes (tools/mesh_mp.py).  On one
    card two processes of two logical shards each form a 2x2 mesh over
    gloo, their copies staged through pinned host memory; on four cards four
    processes, one card each, over nccl, form a 2x2 and a 4x1 mesh.  Every
    rank reads the same file and must give an exact ledger and the
    one-process mesh's PDUs (frequency errors within 1e-6 Hz); the bytes
    counted over the ranks must equal the one-process mesh's and
    comm_model()'s; on the 2x2 mesh the last rank holds K2 and K1 exact
    against their plain versions on its own shard blocks.  Returns the
    wrappers' launches summed over the ranks' first 2x2 pass."""
    from dumphfdl_tpu_torch.dsp.channel import FrameEvent
    path, freqs, center, emit_by_chan, duration, _ = cap
    argv = _argv(path, 2_160_000, center, freqs, 5400, 'mesh_mp.txt')
    backend, n, devices, specs = _mp_layout()
    # the children take over the filter tables this process designed
    design_file = WORK / 'mesh_mp_design.pkl'
    with open(design_file, 'wb') as f:
        pickle.dump({dep: t for dep, t in design.items()
                     if dep[3] == tuple(freqs)}, f)
    launches = None
    for spec in specs:
        t0 = time.perf_counter()
        ranks = _run_ranks(spec, backend, devices, argv, design_file,
                           check_kernels=spec == '2x2')
        phase_s = time.perf_counter() - t0
        ref = mesh_passes[spec]
        want = sorted((e.channel, e.mode, e.pdu) for e in ref['events'])
        want_ferr = {e.channel: e.freq_err_hz for e in ref['events']}
        first = [r['passes'][0] for r in ranks]
        ledgers, ferr = [], 0.0
        for r, p in zip(ranks, first):
            evs = [FrameEvent(*f[:9], bytes.fromhex(f[9]) if f[9] else None,
                              f[10]) for f in p['events']]
            led = _ledger(evs, emit_by_chan)
            got = [e for e in evs if e.pdu]
            if not led['exact'] or \
                    sorted((e.channel, e.mode, e.pdu) for e in got) != want:
                raise AssertionError(f'mesh_mp {spec} rank {r["rank"]}: '
                                     f'ledger {led}, or PDUs differ from the '
                                     'one-process pass')
            ferr = max(ferr, max(abs(e.freq_err_hz - want_ferr[e.channel])
                                 for e in got))
            ledgers.append(led)
        if not ferr <= 1e-6:
            raise AssertionError(f'mesh_mp {spec}: frequency errors differ '
                                 f'from the one-process pass by {ferr} Hz')
        moved, received = {}, {}
        for p in first:
            for k, v in p['moved'].items():
                moved[k] = moved.get(k, 0) + v
            for k, v in p['received'].items():
                received[k] = received.get(k, 0) + v
        model, steps = ref['comm_model'], ref['super_blocks']
        # every copy of these meshes crosses between ranks, so what the
        # ranks received is what they sent
        if moved != ref['moved'] or received != moved \
                or any(p['super_blocks'] != steps for p in first) or moved != {
                'halo': steps * model['halo_bytes_per_superblock'],
                'reshard': steps * model['reshard_bytes_per_superblock']} \
                or sum(p['upload_bytes'] for p in first) != \
                steps * model['upload_bytes_per_superblock']:
            raise AssertionError(f'mesh_mp {spec}: moved {moved} over the '
                                 f'ranks, the one-process pass {ref["moved"]}')
        got_launches = {k: sum(p['launches'][k] for p in first)
                        for k in first[0]['launches']}
        blocks = first[0]['demod_blocks']
        shards = len(first[0]['local_shards'])
        if any(p['launches']['tracker'] != shards * blocks
               or not p['launches']['viterbi27'] for p in first):
            raise AssertionError(f'mesh_mp {spec}: launches '
                                 f'{[p["launches"] for p in first]} in '
                                 f'{blocks} blocks, {shards} shards a rank')
        say(card, 'mesh_mp', mesh=spec, processes=n, backend=backend,
            transport=ranks[0]['transport'],
            devices=[r['device'] for r in ranks], channels=len(freqs),
            sample_rate=2_160_000, demod_block=5400, capture_s=duration,
            phase_s=phase_s,
            wall_s=[p['wall_s'] for p in first],
            warm_wall_s=[r['passes'][1]['wall_s'] for r in ranks],
            profiled_wall_s=[r['profiled']['wall_s'] for r in ranks],
            device_events=[r['profiled']['device_events'] for r in ranks],
            busy_ms=[r['profiled']['busy_ms'] for r in ranks],
            by_kind_rank0=ranks[0]['profiled']['by_kind'],
            launches=[p['launches'] for p in first], demod_blocks=blocks,
            super_blocks=steps, moved_bytes=moved,
            moved_by_rank=[p['moved'] for p in first],
            copies_by_rank=[p['copies'] for p in first],
            received_by_rank=[p['received'] for p in first],
            staged_by_rank=[p['staged'] for p in first],
            event_gather_bytes=[p['gather_bytes'] for p in first],
            upload_bytes=[p['upload_bytes'] for p in first],
            moved_equal_one_process_and_comm_model=True,
            pdus_equal_one_process=True, max_freq_err_diff_hz=ferr,
            ledger_exact_on_every_rank=True,
            frames_ok=[led['frames_ok'] for led in ledgers])
        checked = next((r['kernels'] for r in ranks if 'kernels' in r), None)
        if spec == '2x2':
            if checked is None:
                raise AssertionError('mesh_mp: no rank checked the kernels')
            _say_shard_kernels(card, checked, mesh='mesh_mp 2x2',
                               rank=n - 1, backend=backend)
            launches = got_launches
    return launches


def phase_dryrun(card: str) -> None:
    from dumphfdl_tpu_torch.parallel.sharding import dryrun_multichip
    n = torch.cuda.device_count()
    names = [f'cuda:{i}' for i in range(4)] if n >= 4 else ['cuda:0'] * 4
    t0 = time.perf_counter()
    detail = dryrun_multichip(4, names)
    say(card, 'dryrun', wall_s=time.perf_counter() - t0, **detail)


# the spans a profiled superstep decode with frames records (utils/profiling)
PROFILE_SPANS = {'ingest.read', 'ingest.upload', 'ingest.wait', 'rx.step',
                 'rx.launch', 'rx.capture', 'rx.sync', 'events.collect',
                 'app.parse', 'app.output'}


def phase_profile(card: str, dev: torch.device) -> None:
    """The golden capture through the CLI with --profile."""
    import shutil
    from dumphfdl_tpu_torch import cli
    from dumphfdl_tpu_torch.utils import profiling
    gold = ROOT / 'tests' / 'golden'
    man = json.loads((gold / 'manifest.json').read_text())
    out = WORK / 'profile'
    shutil.rmtree(out, ignore_errors=True)
    rc = cli.main([
        '--iq-file', str(gold / man['capture']),
        '--sample-format', man['format'],
        '--sample-rate', str(man['sample_rate']),
        '--centerfreq', str(man['centerfreq'] / 1000),
        '--profile', str(out),
        '--output', f'decoded:text:file:path={WORK / "profile.txt"}',
    ] + [str(f / 1000) for f in man['frequencies']], device=dev)
    trace = json.loads((out / profiling.TRACE_NAME).read_text())
    kernels = [e for e in trace['traceEvents'] if e.get('cat') == 'kernel']
    names = [e.get('name', '') for e in kernels]
    k1 = sum('viterbi27_kernel' in n for n in names)
    k2 = sum('tracker_kernel' in n for n in names)
    # the decoder's spans, on the kernels' time base: each K1 kernel runs
    # inside the event decode that launched it and waited for it
    spans = [e for e in trace['traceEvents']
             if e.get('cat') == 'dumphfdl_span']
    missing = PROFILE_SPANS - {e['name'] for e in spans}
    collects = [(e['ts'], e['ts'] + e['dur']) for e in spans
                if e['name'] == 'events.collect']
    k1_outside = sum(
        not any(a <= e['ts'] and e['ts'] + e['dur'] <= b
                for a, b in collects)
        for e in kernels if 'viterbi27_kernel' in e.get('name', ''))
    if rc != 0 or k1 < 1 or k2 < 1 or missing or k1_outside:
        raise AssertionError(f'profile: rc {rc}, {k1} K1 and {k2} K2 kernel '
                             f'events among {len(names)}; spans missing '
                             f'{sorted(missing)}; {k1_outside} K1 kernels '
                             'outside every events.collect span')
    say(card, 'profile', trace=str((out / profiling.TRACE_NAME)
                                   .relative_to(ROOT)),
        trace_bytes=(out / profiling.TRACE_NAME).stat().st_size,
        trace_events=len(trace['traceEvents']), kernel_events=len(names),
        k1_kernel_events=k1, k2_kernel_events=k2, span_events=len(spans))


def phase_parity(card: str, dev: torch.device) -> None:
    """tests/golden/chip_parity.json's scenarios through K1 and K2."""
    from dumphfdl_tpu_torch.dsp import tracker_cuda
    from dumphfdl_tpu_torch.ops import fec_cuda
    from dumphfdl_tpu_torch.tools import chip_parity
    ref = json.loads((ROOT / 'tests' / 'golden' / 'chip_parity.json')
                     .read_text())
    # the Viterbi scenario decodes one mode through K1's one-mode wrapper
    before = fec_cuda.one_mode_launches, tracker_cuda.launches
    diffs = chip_parity.compare(chip_parity.tracker_scenario(dev),
                                chip_parity.viterbi_scenario(dev), ref)
    got = (fec_cuda.one_mode_launches - before[0],
           tracker_cuda.launches - before[1])
    over = chip_parity.over_tolerance(diffs)
    if over or got != (1, 2):
        raise AssertionError(f'parity: float fields over their bound {over}; '
                             f'K1, K2 launches {got}')
    say(card, 'parity', integers_and_digests_exact=True,
        k1_launches=got[0], k2_launches=got[1], max_abs_diff=diffs,
        tolerance={f: chip_parity.FLOAT_TOLERANCE.get(
            f, chip_parity.DEFAULT_TOLERANCE) for f in diffs})


def phase_multihost(card: str) -> None:
    """The single-process answers of parallel/multihost.  Process groups
    are made by the mesh_mp phase's children: two gloo ranks sharing one
    card (nccl refuses two ranks on one device) or, with four cards, four
    nccl ranks; tests/test_torch_multihost.py and test_torch_mesh_mp.py run
    two gloo processes on the CPU."""
    from dumphfdl_tpu_torch.parallel import multihost
    for v in ('DUMPHFDL_COORDINATOR', 'DUMPHFDL_NUM_PROCESSES',
              'DUMPHFDL_PROCESS_ID'):
        os.environ.pop(v, None)
    single = multihost.init_distributed(device='cuda')
    one = multihost.init_distributed('127.0.0.1:1', 1, 0, device='cuda')
    sl = multihost.local_channel_slice(512)
    if single or one or (sl.start, sl.stop) != (0, 512) or \
            torch.distributed.is_initialized():
        raise AssertionError(f'multihost: {single}, {one}, {sl}')
    say(card, 'multihost', single_process_returns=False,
        local_channel_slice=[sl.start, sl.stop],
        process_groups='made by the mesh_mp phase: ' + (
            'four nccl ranks, one card each' if _mp_layout()[0] == 'nccl'
            else 'two gloo ranks sharing cuda:0 (nccl refuses two ranks on '
            'one device)'))


# tests/test_sensitivity.py's pins: (mode, Es/N0 in dB that must decode
# in at least SENS_BAR of SENS_TRIALS trials)
SENS_PINS = ((0, 3.0), (1, 4.0), (2, 5.0), (3, 6.0),
             (4, 3.0), (5, 4.0), (6, 5.0), (7, 6.0))
SENS_BAR = 0.9
SENS_TRIALS = 20
# the curve's points where SENSITIVITY_r05.json's pass rate is below 1 (a
# TPU run of the JAX package, the same seeds and modulator), and how far
# the port may lie from it: in pass rate 4 of the 20 trials (modes 3 and 7
# rise by 0.35-0.43 a dB from 2 to 4 dB, so about half a dB of lost
# sensitivity); in mean reported SNR 0.05 dB, where the
# card has come within 1e-5 dB of r05, so that a drift of the tracker's or
# the soft demodulator's numerics far below the 1-2 dB that would cost
# sensitivity shows
SENS_CURVE = ((2, 3, 6, 7), (0.0, 2.0, 4.0))
SENS_PASS_TOL = 0.2
SENS_SNR_TOL_DB = 0.05


def phase_sensitivity(card: str, dev: torch.device) -> dict:
    """The sensitivity pins and curve (tools/sensitivity.py) on the card.
    Returns the wrappers' launches over the sweeps."""
    from dumphfdl_tpu_torch.tools import sensitivity
    r05 = json.loads((ROOT / 'SENSITIVITY_r05.json').read_text())
    ref = {(r['mode'], r['snr_db']): r for r in r05['rows']}
    _zero_launches()
    t0 = time.perf_counter()
    pins = [sensitivity.sweep([m], [snr], SENS_TRIALS, dev)[0]
            for m, snr in SENS_PINS]
    curve = sensitivity.sweep(*SENS_CURVE, SENS_TRIALS, dev)
    wall = time.perf_counter() - t0
    launches = _launches()
    say(card, 'sensitivity pins', trials=SENS_TRIALS, bar=SENS_BAR,
        pass_rates={f'{r["mode"]}@{r["snr_db"]}': r['pass_rate']
                    for r in pins})
    bad = [r for r in pins if not r['pass_rate'] >= SENS_BAR]
    for r in curve:
        want = ref[(r['mode'], r['snr_db'])]
        d_pass = abs(r['pass_rate'] - want['pass_rate'])
        d_snr = None if None in (r['mean_reported_snr_db'],
                                 want['mean_reported_snr_db']) else \
            abs(r['mean_reported_snr_db'] - want['mean_reported_snr_db'])
        say(card, 'sensitivity', mode=r['mode'], snr_db=r['snr_db'],
            trials=SENS_TRIALS, pass_rate=r['pass_rate'],
            r05_pass_rate=want['pass_rate'],
            mean_reported_snr_db=r['mean_reported_snr_db'],
            r05_mean_reported_snr_db=want['mean_reported_snr_db'],
            r05='TPU run of the JAX package')
        if d_pass > SENS_PASS_TOL or (d_snr is not None
                                      and d_snr > SENS_SNR_TOL_DB):
            bad.append(r)
    say(card, 'sensitivity summary', points=len(pins) + len(curve),
        wall_s=wall, launches=launches, failed=bad)
    if bad or not launches['tracker'] or not launches['viterbi27']:
        raise AssertionError(f'sensitivity: {bad}, launches {launches}')
    return launches


def phase_soak_events(card: str, dev: torch.device) -> tuple[dict, dict]:
    """1024 channels, a frame on each ending in one block
    (tools/soak_events.py), and K1's one-mode wrapper held against its plain
    version on what the gather handed it.  Returns (the wrappers' launches
    over the timed run, the one-mode wrapper's kernels-line entry)."""
    from dumphfdl_tpu_torch.ops import fec, fec_cuda
    from dumphfdl_tpu_torch.tools import soak_events
    nch = 1024
    x, expected = soak_events.build_inputs(nch, 0)
    # the tool counts every wrapper from 0 over its timed run
    out, _, recorded = soak_events.run(x, expected, dev, record_k1=True)
    launches = out['launches']
    say(card, 'soak_events', **out)
    cap = out['fused_event_decode']
    split_ok = all(b['fused'] == min(b['events'], cap)
                   and b['gathered'] == b['events'] - b['fused']
                   for b in out['blocks_with_events'])
    if not out['exact'] or out['events'] != nch or not split_ok \
            or not launches['viterbi27_one_mode'] or not recorded:
        raise AssertionError(f'soak_events: {out}')
    # K1 through viterbi_decode on the gather's own soft chips
    before = fec_cuda.one_mode_launches
    kern = [fec_cuda.viterbi_decode(soft, n) for soft, n in recorded]
    if fec_cuda.one_mode_launches != before + len(recorded):
        raise AssertionError('K1 one-mode: the wrapper did not launch once '
                             'per call')
    plain, plain_ms = timed_ms(lambda: [fec.viterbi_decode(soft, n)
                                        for soft, n in recorded])
    for (soft, n), k, pl in zip(recorded, kern, plain):
        if not torch.equal(k, pl):
            raise AssertionError(f'K1 one-mode, {n}-bit frames: kernel '
                                 f'differs from plain in '
                                 f'{int((k != pl).sum())} bits')
    ms = cuda_ms(lambda: [fec_cuda.viterbi_decode(soft, n)
                          for soft, n in recorded], 20)
    bnd = k1_bound([soft for soft, _ in recorded], kern)
    shapes = [[int(soft.shape[0]), n] for soft, n in recorded]
    say(card, 'K1 gather', calls=len(recorded), frames_nbits=shapes,
        bit_exact=True, kernel_ms=ms, plain_ms=plain_ms,
        launches_soak_events=launches['viterbi27_one_mode'], **bnd)
    return launches, dict(name='viterbi27_one_mode', route='cuda',
                          source='dumphfdl_tpu_torch/csrc/viterbi.cu',
                          replaces='dumphfdl_tpu/ops/fec_pallas.py:50',
                          max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                          library_ms=None, frames_nbits=shapes, **bnd)


SOAK_STREAM_S = 30.0
# (channel, mode, start symbol) of the FCS-failing frames the soak's stream
# holds near an emitter: the JAX package decodes these from the same
# samples (tests/test_torch_soak_junk.py); the card may decode no others
SOAK_STREAM_JUNK = {(415, 1, 10335), (130, 0, 25363)}


def phase_soak_stream(card: str, dev: torch.device) -> dict:
    """512 channels at 2.16 Msps CF32 through run_stream in real time
    (tools/soak_stream.py).  Returns the wrappers' launches over the run."""
    from dumphfdl_tpu_torch.tools import soak_stream
    _zero_launches()
    out = soak_stream.run(channels=512, seconds=SOAK_STREAM_S,
                          fs=2_160_000, fmt='CF32', device=dev)
    launches = _launches()
    say(card, 'soak_stream', launches=launches, **out)
    if out['input_overrun_samples'] or not out['exact'] \
            or not out['frames_ok'] or not launches['tracker'] \
            or out['frames_alias_junk'] != len(out['alias_at']) \
            or not {tuple(a) for a in out['alias_at']} <= SOAK_STREAM_JUNK:
        raise AssertionError(f'soak_stream: {out}')
    return launches


def _ok_line() -> None:
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def main() -> int:
    if sys.argv[1:] not in ([], ['mesh'], ['extras'], ['bench']):
        raise SystemExit('usage: chip_smoke.py [mesh|extras|bench]')
    dev = require_cuda()
    card = card_line()
    WORK.mkdir(parents=True, exist_ok=True)
    phase_device(card, dev)
    phase_build(card)
    if sys.argv[1:] == ['mesh']:
        with _shared_design() as design:
            cap = _bench_capture(512, 2_160_000, 'scale.cs16')
            unfused_events = phase_unfused(card, dev, cap)
            _, _, mesh_passes = phase_mesh(card, dev, cap, unfused_events)
            phase_mesh_frontend(card, dev, cap)
            phase_mesh_mp(card, cap, mesh_passes, design)
        phase_dryrun(card)
        print(card)
        _ok_line()
        return 0
    if sys.argv[1:] == ['extras']:
        with _shared_design():
            phase_soak_stream(card, dev)
        phase_sensitivity(card, dev)
        phase_soak_events(card, dev)
        print(card)
        _ok_line()
        return 0
    if sys.argv[1:] == ['bench']:
        rows = phase_bench_ladder(card)
        print(card)
        print(json.dumps({'kernels': rows}))
        _ok_line()
        return 0
    k1 = phase_k1(card, dev)
    k2 = phase_k2(card, dev)
    phase_golden(card, dev)
    with _shared_design() as design:
        launches, cap = phase_scale(card, dev)
        # bench.py's first rung: the same channel list, so the same tables
        bench_launches = phase_bench(card, dev)
        taps = phase_k2_taps(card, dev)
        unfused_events = phase_unfused(card, dev, cap)
        mesh_launches, k2_mesh, mesh_passes = phase_mesh(card, dev, cap,
                                                         unfused_events)
        phase_mesh_frontend(card, dev, cap)
        mp_launches = phase_mesh_mp(card, cap, mesh_passes, design)
        # the same channel list: the scale phase's filter tables serve
        stream_launches = phase_soak_stream(card, dev)
    with _shared_design():
        ss_launches, k2_ss = phase_superstep(card, dev)
    taps['launches'] = phase_datadumps(card, dev)
    phase_dryrun(card)
    phase_profile(card, dev)
    phase_parity(card, dev)
    phase_multihost(card)
    sens_launches = phase_sensitivity(card, dev)
    events_launches, k1_one_mode = phase_soak_events(card, dev)
    # launches: each wrapper's count from 0 over a path's first pass.  K1 and
    # K2 on the scale phase's fused path (and, launches_superstep, on the
    # superstep path), K2 at the superstep's shape on the superstep path
    # (the eager first block and the one recorded into the graph; its
    # replays and the kernel events of the profiled graph pass beside it),
    # K2 at a mesh shard's shape on the 2x2 mesh pass (shards x blocks),
    # the taps instantiation on the --datadumps path; launches_mesh_mp sums
    # the ranks' first pass on the cross-process 2x2 mesh; K1's one-mode
    # wrapper (the event decode's gather route) on the soak_events run, the
    # only path that puts more events in a block than the fused capacity;
    # launches_sensitivity, _soak_events and _soak_stream
    # over those phases' runs, launches_bench over the bench phase's rung
    k1['launches'], k2['launches'] = launches['viterbi27'], launches['tracker']
    k2_ss['launches'] = ss_launches['tracker']
    k2_mesh['launches'] = mesh_launches['tracker']
    k1_one_mode['launches'] = events_launches['viterbi27_one_mode']
    paths = (('superstep', ss_launches), ('mesh', mesh_launches),
             ('mesh_mp', mp_launches), ('sensitivity', sens_launches),
             ('soak_events', events_launches),
             ('soak_stream', stream_launches),
             ('bench', bench_launches))
    rows = ((k1, 'viterbi27'), (k2, 'tracker'), (k2_ss, 'tracker'),
            (k2_mesh, 'tracker'), (taps, 'tracker_taps'),
            (k1_one_mode, 'viterbi27_one_mode'))
    for d, name in rows:
        for path, counts in paths:
            d[f'launches_{path}'] = counts[name]
    if not all(d['launches'] > 0 for d, _ in rows) \
            or not k1['launches_superstep'] \
            or not (k1['launches_mesh'] and k2['launches_mesh']) \
            or not (k1['launches_mesh_mp'] and k2['launches_mesh_mp']) \
            or not all(k1[f'launches_{p}'] and k2[f'launches_{p}']
                       for p in ('sensitivity', 'soak_events', 'soak_stream',
                                 'bench')):
        raise AssertionError('a kernel of a path was never launched there')
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
            'bound_bytes', 'bound_ops', 'chain_steps',
            *(f'launches_{path}' for path, _ in paths))
    print(card)
    print(json.dumps({'kernels': [
        {k: d[k] for k in (*keys, *sorted(set(d) - set(keys)))}
        for d, _ in rows]}))
    _ok_line()
    return 0


if __name__ == '__main__':
    sys.exit(main())
