"""Benchmark of the port: the most HFDL channels one card decodes in real
time, measured end to end.

Twin of ``bench.py``.  Two measurements, each in a child process with a
watchdog, so that a hang or an out-of-memory at one rung is recorded with
its reason instead of ending the run:

1. **The rung ladder** (the headline, ``e2e_rung``): bench.py's capture
   (channels around 10 MHz, a frame on every (channels // 16)-th channel,
   the single-slot modes in turn, 30 dB, seed 0; tools/soak_stream.capture)
   serialized to the rung's sample format, decoded through one HfdlApp in
   warm passes and then timed passes, with the flush after the timed ones.
   On the superstep the raw chunks go through ``ingest.superstep_stream``
   into ``process_packed``, else through ``ingest.uploaded_stream`` into
   ``process``.  Every decoded frame is put in its (channel, pass) cell by
   the symbol clock; a rung counts only with every cell decoded
   (coverage_ok).  rt_factor counts processed stream seconds, pad
   included, over the wall of the timed passes.  The ladder stops at the
   first rung that fails, or after the first below real time.
2. **Demod-only** (``demod_only``): channel-samples per second through a
   ChannelBank alone on noise blocks of 5400 samples, uploaded ahead of
   the bank (utils/prefetch.device_prefetch); the bank collects each
   block's events one block behind, as the JAX bank does with
   pipeline_events.

    python -m dumphfdl_tpu_torch.tools.bench
        [--search 512@2160000,1024@3456000,2048@6912000,4096@13824000@CU8]
        [--warm N] [--passes 4] [--demod-block 16200] [--check-kernels]
        [--device cuda:0] [--out PATH]

Demod blocks of 16200 samples by default, as in bench.py.  --warm defaults
to 3 passes up to 1024 channels and 2 above, as in bench.py.
--check-kernels makes each rung run one more pass, untimed and
outside the ledger, on the eager path, that keeps the first block that
completes a frame, cut to 256 channels (two whole 128-channel gate tiles)
from the first that completes one, and that block's event block, then
holds K2 and K1 exact against their plain versions on them
(tools/kernel_check.check_frame_block).

Prints bench.py's summary as one JSON object: metric, value (the widest
rung measured real-time with coverage_ok), unit, vs_baseline (value / 12,
the reference decoder's channels on a small ARM board), search,
demod_only_channels and failures, and beside them every rung's full result
(rungs); --out also writes it to PATH.  Exits 1 when a measurement failed.
``faults`` tells the failures a rung's size explains (its watchdog, CUDA
out of memory) from wrong decodes and crashes.
Runs on the CUDA device unless --device names another; nothing falls back
to the CPU.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_CHANNELS = 12.0
DEFAULT_SEARCH = '512@2160000,1024@3456000,2048@6912000,4096@13824000@CU8'
DEFAULT_BLOCK = 16200       # demod block, samples (bench.py's)
READ_CHUNK = 1 << 23        # bytes per read on the uploaded path
CHECK_ROWS = 256            # K2's rows held against the plain version
DEMOD_BLOCK = 5400          # demod-only: 5400-sps samples per block
DEMOD_TIMED_BLOCKS = 24
ROOT = pathlib.Path(__file__).resolve().parents[2]


def parse_search(text: str) -> list[tuple[int, int, str]]:
    """'CHANNELS@RATE[@FORMAT],...' -> [(channels, rate, format)]."""
    rungs = []
    for item in text.split(','):
        parts = item.split('@')
        rungs.append((int(parts[0]), int(parts[1]),
                      parts[2].upper() if len(parts) > 2 else 'CS16'))
    return rungs


def warm_passes(channels: int) -> int:
    """bench.py's warm passes: fewer above 1024 channels."""
    return 3 if channels <= 1024 else 2


def watchdog_s(channels: int) -> float:
    """bench.py's limit for a rung's child process."""
    return 700 if channels <= 512 else 2100


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def e2e_rung(channels: int, fs: int, fmt: str, *, device, warm: int,
             passes: int, block: int = DEFAULT_BLOCK,
             check_kernels: bool = False) -> dict:
    """One rung of the ladder; returns bench.py's keys and beside them the
    path, setup_s (HfdlApp construction), synth_s, pass_s (each timed
    pass, the device synchronised at its end), max_memory_allocated,
    frames_alias_junk (tools/alias.py; counted inside frames_junk, as
    bench.py counts them), exact, launches (all four wrappers, from 0
    before the first pass to after the flush) and, with check_kernels,
    kernels."""
    from .. import constants as C
    from ..app import AppConfig, HfdlApp
    from ..io import formats, ingest
    from ..io.outputs import OutputManager, OutputSpec
    from ..protocol.enrichment import AcCache, SysTable
    from ..protocol.runtime import ProtocolContext, ProtocolOptions
    from . import kernel_check
    from .alias import split_junk
    from .soak_stream import CENTER, capture
    device = torch.device(device)
    fmt = fmt.upper()
    t0 = time.perf_counter()
    cap = capture(channels, fs)
    raw = formats.serialize(cap['wb'], fmt)
    synth_s = time.perf_counter() - t0
    freqs = cap['freqs']
    emit_by_chan = {c: pdu for c, (pdu, _) in cap['emit_by_chan'].items()}
    n_emitted = len(cap['emissions'])
    del cap
    duration = len(raw) // formats.bytes_per_sample(fmt) / fs

    ctx = ProtocolContext(systable=SysTable(None), ac_cache=AcCache(),
                          ac_data=None, options=ProtocolOptions())
    outputs = OutputManager(ctx, hwm=0)
    outputs.add_output(OutputSpec.parse('decoded:text:file:path=/dev/null'))
    cfg = AppConfig(frequencies=freqs, sample_rate=fs, centerfreq=CENTER,
                    device=device, demod_block_len=block, sample_format=fmt)
    if device.type == 'cuda':
        torch.cuda.init()           # the allocator's statistics need it
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    app = HfdlApp(cfg, ctx, outputs)
    setup_s = time.perf_counter() - t0
    rx = app.receiver
    ss = rx.superstep

    # the exact ledger: every frame decoded with its bytes goes to the
    # (channel, pass) cell its start on the symbol clock falls in
    cells: dict = {}
    counts = {'junk': 0, 'other': 0}
    junk, heard = [], {}
    pass_symbols = [0.0]            # cumulative symbol clock at pass ends

    def record(evs):
        sym_off = ss.delay_symbols if ss is not None else 0
        for ev in evs:
            if ev.pdu is None:
                continue
            if not ev.fcs_ok:
                counts['junk'] += 1
                junk.append(ev)
                continue
            exp = emit_by_chan.get(ev.channel)
            if exp is not None and ev.pdu[:len(exp)] == exp:
                s = ev.start_symbol - sym_off
                p = next((i for i, e in enumerate(pass_symbols[1:])
                          if s < e), len(pass_symbols) - 1)
                cells[(ev.channel, p)] = cells.get((ev.channel, p), 0) + 1
                heard.setdefault(ev.channel, []).append((ev.start_symbol,
                                                         ev.mode))
            else:
                counts['other'] += 1
        return evs

    def handled(evs):
        app.handle_events(record(evs))

    def one_pass(sink) -> float:
        """The capture once through the receiver; processed symbols."""
        fh = io.BytesIO(raw)
        if ss is not None:
            n_sym = 0
            for pk in ingest.superstep_stream(
                    rx, ingest.file_chunks(fh, fmt, rx.raw_chunk_bytes,
                                           pad_final=True)):
                sink(rx.process_packed(pk))
                n_sym += ss.plan.symbols
            return n_sym
        for xd in ingest.uploaded_stream(
                ingest.file_chunks(fh, fmt, READ_CHUNK), fmt, device):
            sink(rx.process(xd))
        return duration * C.SYMBOL_RATE

    kernel_check.zero_launches()
    t0 = time.perf_counter()
    for _ in range(warm):
        pass_symbols.append(pass_symbols[-1] + one_pass(handled))
    _sync(device)
    warm_s = time.perf_counter() - t0
    pass_s, secs = [], 0.0
    for _ in range(passes):
        t0 = time.perf_counter()
        n_sym = one_pass(handled)
        _sync(device)
        pass_s.append(time.perf_counter() - t0)
        pass_symbols.append(pass_symbols[-1] + n_sym)
        secs += n_sym / C.SYMBOL_RATE
    rt = secs / sum(pass_s)
    # flush in-flight state, then settle the ledger: every (emitting
    # channel, pass) cell must have decoded exactly once
    handled(rx.flush())
    _sync(device)
    launches = kernel_check.launches()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else None

    kernels = None
    if check_kernels:
        if ss is not None:
            ss.use_graph = False    # eager steps: the wrapper sees each
        with kernel_check.first_frame_block(CHECK_ROWS) as kept:
            one_pass(lambda evs: None)
            rx.flush()
        kernels = kernel_check.check_frame_block(kept)
    app.shutdown()

    total_passes = warm + passes
    missing = [(ci, p) for ci in emit_by_chan for p in range(total_passes)
               if (ci, p) not in cells]
    dup = sum(n - 1 for n in cells.values() if n > 1)
    alias_at, junk_at = split_junk(junk, emit_by_chan, heard)
    out = dict(
        e2e_rt_channels=channels * rt, wideband_sps=fs * rt, rt_factor=rt,
        channels=channels, sample_format=fmt, superstep=ss is not None,
        frames_ok=sum(cells.values()),
        frames_expected_total=total_passes * n_emitted,
        frames_lost_midstream=len(missing), frames_junk=counts['junk'],
        frames_other=counts['other'], frames_duplicate=dup,
        coverage_ok=not missing, frames_decoded=app.frames_decoded,
        frames_junk_app=app.frames_junk,
        path='superstep' if ss is not None
        else 'fused' if rx.fused else 'unfused',
        device=str(device), sample_rate=fs, demod_block_len=block,
        capture_s=duration, synth_s=synth_s, setup_s=setup_s,
        warm_passes=warm, warm_s=warm_s, timed_passes=passes, pass_s=pass_s,
        max_memory_allocated=peak, frames_alias_junk=len(alias_at),
        # [channel, pass] and [channel, mode, start symbol]
        lost_at=[list(m) for m in missing[:20]], junk_at=junk_at[:8],
        alias_at=alias_at[:12], launches=launches)
    out['exact'] = (not missing and not dup and not counts['other']
                    and not junk_at)
    if ss is not None:
        out['superstep_plan'] = dict(out_chunk=ss.plan.out_chunk,
                                     frames=ss.plan.frames,
                                     wb_chunk=ss.plan.wb_chunk)
    if kernels is not None:
        out['kernels'] = kernels
    return out


def demod_only(channels: int = 1024, *, device) -> dict:
    """bench.py's demod-only child: a ChannelBank on four distinct noise
    blocks of 5400 samples, uploaded ahead of the bank as int16 pairs; one
    first block and one warm block, then 24 timed blocks (the device
    synchronised at the end).  Returns chan_sps and demod_only_channels =
    chan_sps / 5400 (real-time channels at 5400 sps)."""
    from ..dsp.channel import ChannelBank
    from ..utils.prefetch import device_prefetch
    from . import kernel_check
    device = torch.device(device)
    bank = ChannelBank(channels, device)
    rng = np.random.default_rng(0)
    blocks = [(rng.standard_normal((channels, DEMOD_BLOCK))
               + 1j * rng.standard_normal((channels, DEMOD_BLOCK))
               ).astype(np.complex64) * 0.1 for _ in range(4)]
    frames = 0
    t0 = time.perf_counter()
    for b in blocks[:2]:            # the first block, then a warm one
        frames += sum(ev.pdu is not None for ev in bank.process(
            next(iter(device_prefetch([b], device)))))
    _sync(device)
    first_s = time.perf_counter() - t0
    kernel_check.zero_launches()
    stream = (blocks[i % len(blocks)] for i in range(DEMOD_TIMED_BLOCKS))
    t0 = time.perf_counter()
    for xd in device_prefetch(stream, device):
        frames += sum(ev.pdu is not None for ev in bank.process(xd))
    _sync(device)
    wall = time.perf_counter() - t0
    launches = kernel_check.launches()
    frames += sum(ev.pdu is not None for ev in bank.drain_events())
    chan_sps = DEMOD_TIMED_BLOCKS * channels * DEMOD_BLOCK / wall
    return dict(chan_sps=chan_sps, demod_only_channels=chan_sps / DEMOD_BLOCK,
                channels=channels, block=DEMOD_BLOCK,
                timed_blocks=DEMOD_TIMED_BLOCKS, wall_s=wall,
                first_two_blocks_s=first_s, frames=frames, launches=launches,
                device=str(device))


def run_child(argv: list[str], key: str, timeout: float
              ) -> tuple[dict | None, str | None]:
    """Run this module as a child process on argv within timeout seconds:
    (the JSON object of its output that holds key, None), or (None, why
    there is none).  The child's standard error ends up on ours."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (str(ROOT), env.get('PYTHONPATH', '')) if p)
    try:
        out = subprocess.run(
            [sys.executable, '-m', 'dumphfdl_tpu_torch.tools.bench', *argv],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=ROOT)
    except subprocess.TimeoutExpired as te:
        part = te.stderr or b''
        if isinstance(part, bytes):
            part = part.decode('utf-8', 'replace')
        sys.stderr.write(part[-2000:])
        tail = (part.strip().splitlines() or ['no output'])[-1]
        return None, f'timeout after {timeout:.0f} s (last: {tail[-160:]})'
    sys.stderr.write(out.stderr[-2000:])
    for line in reversed(out.stdout.strip().splitlines()):
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and key in obj:
            return obj, None
    tail = (out.stderr.strip().splitlines() or ['no output'])[-1]
    return None, f'exit {out.returncode}: {tail[-200:]}'


def rung_child(channels: int, fs: int, fmt: str, *, device: str, warm: int,
               passes: int, block: int, check_kernels: bool
               ) -> tuple[dict | None, str | None]:
    """One rung in its own process, under bench.py's watchdog."""
    argv = ['--child', 'e2e', '--search', f'{channels}@{fs}@{fmt}',
            '--warm', str(warm), '--passes', str(passes),
            '--demod-block', str(block), '--device', device]
    return run_child(argv + (['--check-kernels'] if check_kernels else []),
                     'e2e_rt_channels', watchdog_s(channels))


def demod_child(*, device: str) -> tuple[dict | None, str | None]:
    """The demod-only measurement in its own process (bench.py's 480 s)."""
    return run_child(['--child', 'demod', '--device', device], 'chan_sps',
                     480)


def ladder(search, *, device: str, warm: int | None, passes: int,
           block: int = DEFAULT_BLOCK, check_kernels: bool = False) -> dict:
    """The rungs in order, each in a child (rung_child); the summary."""
    rungs, failures, failed = [], {}, False
    for i, (nch, fs, fmt) in enumerate(search):
        label = f'{nch}@{fs}@{fmt}'
        r, why = rung_child(nch, fs, fmt, device=device,
                            warm=warm_passes(nch) if warm is None else warm,
                            passes=passes, block=block,
                            check_kernels=check_kernels)
        if r is not None:
            rungs.append(r)
            if not r['coverage_ok']:
                why = (f"coverage: {r['frames_lost_midstream']} (channel, "
                       f"pass) cells lost, first {r['lost_at'][:4]}")
        if why is not None:
            failures[label] = why
            failed = True
            stop = f'not run: the ladder stopped at {label}'
        elif r['rt_factor'] < 1.0:
            stop = (f'not run: {label} ran below real time (rt_factor '
                    f"{r['rt_factor']:.3f})")
        else:
            continue
        for n2, f2, m2 in search[i + 1:]:
            failures[f'{n2}@{f2}@{m2}'] = stop
        break
    demod, why = demod_child(device=device)
    if why is not None:
        failures['demod_only'] = why
        failed = True
    realtime = [r for r in rungs if r['rt_factor'] >= 1.0
                and r['coverage_ok']]
    if realtime:
        best = max(realtime, key=lambda r: r['channels'])
        value = best['channels']
        metric = ('max MEASURED real-time HFDL channels, FULL pipeline: '
                  f"wideband {best['sample_format']} capture -> upload -> "
                  'channelizer -> demod -> Viterbi -> protocol -> text '
                  f"output (1 {best['device']} device, rt_factor "
                  f"{best['rt_factor']:.2f} at {best['channels']} ch @ "
                  f"{best['sample_rate'] / 1e6:.3f} Msps, {best['path']})")
    elif rungs:
        best = rungs[-1]
        value = best['channels'] * best['rt_factor']
        metric = ('real-time HFDL channel equivalent, FULL pipeline, NOT '
                  f"real-time (rt_factor {best['rt_factor']:.2f} at "
                  f"{best['channels']} ch @ {best['sample_rate'] / 1e6:.3f} "
                  'Msps)')
    else:
        value, metric = 0, 'bench failed'
    return dict(
        metric=metric, value=value, unit='channels',
        vs_baseline=value / BASELINE_CHANNELS,
        search=[dict(channels=r['channels'], rt_factor=r['rt_factor'],
                     msps=r['sample_rate'] / 1e6, fmt=r['sample_format'],
                     path=r['path'], coverage_ok=r['coverage_ok'])
                for r in rungs],
        demod_only_channels=None if demod is None
        else demod['demod_only_channels'],
        failures=failures, ok=not failed, rungs=rungs, demod_only=demod)


def faults(out: dict) -> dict:
    """The faults in a ladder's result, label -> reason: every failure but
    a rung's watchdog timeout or CUDA out-of-memory (its size, not a wrong
    decode) and the rungs not run after the rung that stopped the ladder
    (that rung is judged itself), and every measured rung whose ledger is
    not exact (a lost cell, an other or duplicate frame, junk that is no
    alias image)."""
    bad = {}
    for label, why in out['failures'].items():
        size = label != 'demod_only' and (why.startswith('timeout after')
                                          or 'torch.OutOfMemoryError' in why)
        if not (size or why.startswith('not run:')):
            bad[label] = why
    for r in out['rungs']:
        if not r['exact']:
            label = f"{r['channels']}@{r['sample_rate']}@{r['sample_format']}"
            bad.setdefault(label, (
                f"ledger not exact: {r['frames_lost_midstream']} cells lost, "
                f"{r['frames_other']} other, {r['frames_duplicate']} "
                f"duplicate, junk that is no alias image at {r['junk_at']}"))
    return bad


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog='python -m dumphfdl_tpu_torch.tools.bench',
                                 description=__doc__.splitlines()[0])
    ap.add_argument('--search', default=DEFAULT_SEARCH,
                    help='rungs as CHANNELS@RATE[@FORMAT],...')
    ap.add_argument('--warm', type=int, default=None)
    ap.add_argument('--passes', type=int, default=4)
    ap.add_argument('--demod-block', type=int, default=DEFAULT_BLOCK,
                    help='demod block length, samples')
    ap.add_argument('--check-kernels', action='store_true')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the CUDA device)')
    ap.add_argument('--out', default=None,
                    help='also write the JSON result to this file')
    # what a child process runs: one rung, or the demod-only measurement
    ap.add_argument('--child', choices=['e2e', 'demod'],
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    from ..device import require_cuda
    args = _parser().parse_args(argv)
    device = require_cuda() if args.device is None \
        else torch.device(args.device)
    if args.child == 'e2e':
        (nch, fs, fmt), = parse_search(args.search)
        out = e2e_rung(nch, fs, fmt, device=device,
                       warm=warm_passes(nch) if args.warm is None
                       else args.warm, passes=args.passes,
                       block=args.demod_block,
                       check_kernels=args.check_kernels)
    elif args.child == 'demod':
        out = demod_only(device=device)
    else:
        out = ladder(parse_search(args.search), device=str(device),
                     warm=args.warm, passes=args.passes,
                     block=args.demod_block,
                     check_kernels=args.check_kernels)
    text = json.dumps(out)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(text + '\n')
    print(text, flush=True)
    return 0 if args.child is not None or out['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
