"""One run of one cell of the benchmark of ``dumphfdl_tpu_torch``.

    python3 -m hfdlbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell's configuration and traffic mix are
found by name (spec.py).  A source process synthesizes the mix from the
seed (traffic.py; the time is printed apart and is not set-up); the run
builds the decoder as its command line builds it (``cli.build_app``), warms
it up on the cell's own stream, measures for `seconds`, lets every frame of
the stream come out, and holds the decoded frames against the frames sent
(ledger.py).

The looped capture's bytes go through a named pipe under $TMPDIR into
``HfdlApp.run_file``, as an SDR is piped into the command line: a process
of its own (source.py) synthesizes the capture and writes it; the pipe
blocks, so nothing is dropped.  The window opens after `warm_s` seconds of
decoding and opens and closes at a receiver call's return with the device
synchronised.  rt_factor = capture seconds the receiver consumed in it over
its wall.

With --trace 1 torch.profiler records the device over the first
`trace_seconds` of the window, the harness records its spans around the
calls into the program, and the per-layer metrics (metrics/<name>.py) are
read from both.  The last line of standard output is the result's JSON;
the numbers compared for `correct` end standard error.  Without enough
CUDA devices the run exits 3 with no result; if jax, jaxlib, flax or
dumphfdl_tpu is loaded once the window has closed, it exits 4.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _process_start() -> float:
    """perf_counter's reading when this process started (Linux /proc)."""
    now = time.perf_counter()
    try:
        with open('/proc/self/stat') as fh:
            ticks = int(fh.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as fh:
            up = float(fh.read().split()[0])
        return now - max(0.0, up - ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return now


T_PROC0 = _process_start()

# every cache of the program and its libraries at a fixed path inside the
# checkout, so that only a checkout's first run builds
for _var, _dir in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton'),
                   ('CUDA_CACHE_PATH', 'nv_compute_cache')):
    os.environ[_var] = str(ROOT / 'build' / _dir)
os.environ['USE_FLAX'] = '0'

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402

from hfdlbench import ledger, spec, traffic, trace  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dumphfdl_tpu')
FAULTS = ('stall', 'half', 'byte', 'drop')


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build_app(config: dict, cap, device):
    """The decoder as its command line builds it for this deployment, the
    stream on standard input; text output to /dev/null."""
    from dumphfdl_tpu_torch import cli
    argv = ['--iq-file', '-', '--sample-format', config['sample_format'],
            '--sample-rate', str(config['sample_rate']),
            '--centerfreq', repr(config['centerfreq'] / 1000),
            '--demod-block', str(config['demod_block']),
            '--output', 'decoded:text:file:path=/dev/null',
            *[repr(f / 1000) for f in cap.freqs]]
    args = cli.build_parser().parse_args(argv)
    app = cli.build_app(args, device)
    if app.cfg.frequencies != cap.freqs:
        raise RuntimeError('the command line changed the channel list')
    return app


def receiver_path(rx) -> str:
    if rx.engine is not None:
        return 'superstep'
    return 'fused' if rx.fused else 'unfused'


class Probe:
    """Wraps, by assignment on the instances, the receiver's step
    (process_packed on the superstep, else process) and the app's
    handle_events: counts the stream consumed, opens and closes the window
    (closed loop), records spans and every decoded frame, and plants a
    fault for the harness's own tests."""

    def __init__(self, app, cap, *, seconds: float, warm_s: float,
                 trace_s: float, tracing: bool, device, fault: str | None):
        import torch
        self.torch = torch
        self.app, self.cap, self.device = app, cap, device
        rx = app.receiver
        ss = rx.engine
        self.delay = ss.delay_symbols if ss is not None else 0
        self.per_call = ss.plan.wb_chunk if ss is not None else None
        self.name = 'process_packed' if ss is not None else 'process'
        self.step = getattr(rx, self.name)
        setattr(rx, self.name, self.call)
        self.handle = app.handle_events
        app.handle_events = self.handled
        self.seconds, self.warm_s = seconds, warm_s
        self.t_first = None             # the first call's return
        self.trace_s, self.tracing, self.fault = trace_s, tracing, fault
        self.nch = len(cap.freqs)
        self.samples = 0
        self.phase = 'warm'
        self.t0 = self.t1 = None        # window, perf_counter seconds
        self.s0 = self.s1 = None        # window, stream samples
        self.decoded: list[ledger.Decoded] = []
        self.calls: list = []           # (t_in, t_out) perf_counter s
        self.spans = trace.Spans()
        self.prof = None
        self.traced: trace.Window | None = None
        self.on_close = None
        self.dropped = 0
        self.trace_diag = None

    def sync(self) -> None:
        if self.device.type == 'cuda':
            self.torch.cuda.synchronize(self.device)

    # -- the window --

    def open_window(self) -> None:
        self.sync()
        if self.tracing:
            self.start_trace()
        self.t0 = time.perf_counter()
        self.s0 = self.samples
        self.phase = 'window'

    def start_trace(self) -> None:
        act = self.torch.profiler.ProfilerActivity
        self.prof = self.torch.profiler.profile(activities=[
            act.CUDA if self.device.type == 'cuda' else act.CPU])
        self.prof.start()
        self.spans.start()
        self._trace_t0 = self.spans.now()
        self._trace_s0 = self.samples

    def stop_trace(self) -> None:
        self.sync()
        t1 = self.spans.now()
        self.spans.on = False
        samples = self.samples - self._trace_s0
        self.prof.stop()
        dev, self.trace_diag = trace.device_events(
            self.prof, self._trace_t0, t1)
        self.prof = None
        frames = [(d.channel, d.mode) for d in self.decoded
                  if d.fcs_ok and self._trace_t0 <= d.t_wall < t1]
        self.traced = trace.Window(
            t0=self._trace_t0, t1=t1, samples=samples, fs=self.cap.fs,
            spans=self.spans, device=dev, frames=frames)

    def close_window(self) -> None:
        self.sync()
        self.t1 = time.perf_counter()
        self.s1 = self.samples
        self.phase = 'drain'
        if self.prof is not None:
            self.stop_trace()
        if self.on_close is not None:
            self.on_close()

    def advance(self, now: float) -> None:
        if self.t_first is None:
            self.t_first = now
        if self.phase == 'warm' and now - self.t_first >= self.warm_s:
            self.open_window()
        elif self.phase == 'window':
            if self.prof is not None and self.spans.on \
                    and now - self.t0 >= self.trace_s:
                self.stop_trace()
            if now - self.t0 >= self.seconds:
                self.close_window()

    # -- the wrapped calls --

    def call(self, x):
        t_in = time.perf_counter()
        w_in = self.spans.now() if self.spans.on else 0
        if self.fault == 'stall':
            evs = []
        else:
            evs = self.step(x)
        evs = self.planted(evs)
        t_out = time.perf_counter()
        n = self.per_call or len(x)
        self.samples += n
        if self.phase == 'window':
            self.calls.append((t_in, t_out, self.samples))
        if self.spans.on:
            self.spans.receiver.append((w_in, self.spans.now(), n))
        self.advance(t_out)
        return evs

    def planted(self, evs):
        if self.fault == 'half':
            return [e for e in evs if e.channel < self.nch // 2]
        if self.fault == 'byte':
            return [e._replace(pdu=bytes([e.pdu[0] ^ 0x40]) + e.pdu[1:])
                    if e.pdu else e for e in evs]
        if self.fault == 'drop':
            keep = []
            for e in evs:
                if e.pdu is not None and e.fcs_ok:
                    self.dropped += 1
                    if self.dropped % 100 == 1:
                        continue
                keep.append(e)
            return keep
        return evs

    def handled(self, evs):
        t = time.perf_counter()
        w_in = self.spans.now() if self.spans.on else 0
        n = 0
        for e in evs:
            if e.pdu is None:
                continue
            n += 1
            self.decoded.append(ledger.Decoded(
                channel=e.channel, mode=e.mode,
                start_symbol=e.start_symbol - self.delay, pdu=bytes(e.pdu),
                fcs_ok=bool(e.fcs_ok), t_handled=t, t_wall=w_in))
        self.handle(evs)
        if self.spans.on:
            self.spans.handle.append((w_in, self.spans.now(), n))


class Source:
    """The source process (source.py) and its named pipe under $TMPDIR:
    started before the decoder is built, and ready once the capture is
    synthesized; finish() closes its standard input, so the stream ends
    after the loop in progress."""

    def __init__(self, job: dict):
        self.fifo = os.path.join(tempfile.gettempdir(),
                                 f'hfdlbench-{os.getpid()}.iq')
        if os.path.exists(self.fifo):
            os.unlink(self.fifo)
        os.mkfifo(self.fifo)
        t = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, '-m', 'hfdlbench.source', self.fifo],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT)
        self.proc.stdin.write(json.dumps(job).encode() + b'\n')
        self.proc.stdin.flush()
        ready = self.proc.stdout.readline().split()
        if ready[:1] != [b'ready']:
            self.close()
            raise RuntimeError(f'the source did not start: {ready}')
        self.synth_s = float(ready[1])
        self.wait_s = time.perf_counter() - t

    def finish(self) -> None:
        if not self.proc.stdin.closed:
            self.proc.stdin.close()

    def loops(self) -> int:
        """Loops written, once the stream has ended."""
        self.finish()
        said = self.proc.stdout.readline().split()
        if self.proc.wait(60) or said[:1] != [b'loops']:
            raise RuntimeError(f'the source failed: {said}')
        return int(said[1])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        if os.path.exists(self.fifo):
            os.unlink(self.fifo)


def closed_loop(app, src: Source, cap, probe) -> dict:
    probe.on_close = src.finish
    app.run_file(src.fifo, cap.fmt)
    loops = src.loops()
    if probe.t1 is None:
        raise RuntimeError(
            f'the stream ended before the window closed: {loops} loops '
            f'written, {probe.samples} samples consumed, phase {probe.phase}')
    attempted = traffic.frames_ending_in(cap, probe.s0, probe.s1)
    quarters, prev = [], (probe.t0, probe.s0)
    for t, s in [(b, n) for _, b, n in probe.calls if b <= probe.t1]:
        if t - prev[0] >= (probe.t1 - probe.t0) / 4:
            quarters.append(round((s - prev[1]) / cap.fs / (t - prev[0]), 2))
            prev = (t, s)
    return dict(loops=loops, attempted=attempted, rt_quarters=quarters,
                rt_factor=(probe.s1 - probe.s0) / cap.fs
                / (probe.t1 - probe.t0))


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits', '-i', '0'],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(cell: spec.Cell, seed: int, seconds: float, tracing: bool, device,
        t_proc0: float, fault: str | None = None) -> dict:
    """One run; returns the result object (the last line's JSON) with the
    numbers compared under 'checks'."""
    import torch
    config, mix = cell.config, cell.mix
    cap = traffic.build(config, mix, seed, samples=False)
    src = Source(dict(config=config, mix=mix, seed=seed))
    print(f'hfdlbench: traffic {cell.name} seed {seed}: '
          f'{len(cap.emissions)} frames a loop of {cap.loop_s:.4f} s, '
          f'synthesis {src.synth_s:.3f} s in the source, {src.wait_s:.3f} s '
          'waited (not set-up)', file=sys.stderr, flush=True)
    try:
        if device.type == 'cuda':
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats(device)
        app = build_app(config, cap, device)
        path = receiver_path(app.receiver)
        probe = Probe(app, cap, seconds=seconds, warm_s=mix['warm_s'],
                      trace_s=min(seconds, mix['trace_seconds']),
                      tracing=tracing, device=device, fault=fault)
        try:
            out = closed_loop(app, src, cap, probe)
        finally:
            app.shutdown()
    finally:
        src.close()
    setup_s = probe.t0 - t_proc0 - src.wait_s
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    led = ledger.settle(probe.decoded, cap.emissions, cap.slots, out['loops'])
    cells = led['cells']
    bad_window = sum(1 for f in out['attempted'] if len(cells.get(f, ())) != 1)
    checks = {'path': (int(path != config['path']), 0),
              'missing': (len(led['missing']), 0),
              'duplicate': (led['duplicate'], 0),
              'other': (len(led['other']), 0),
              'junk': (len(led['junk_at']), 0)}
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    if not tracing:
        for m in cell.end_to_end:
            if m['name'] == 'setup_s':
                v = setup_s
            elif m['name'] == 'rt_factor':
                v = out['rt_factor']
            else:
                raise KeyError(f"no end-to-end metric {m['name']}")
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': torch.cuda.get_device_name(device)
           if device.type == 'cuda' else 'cpu',
           'count': cell.chips, 'memory_peak_bytes': peak}
    result = {'correct': correct, 'attempted': len(out['attempted']),
              'failed': bad_window + len(led['other']) + len(led['junk_at']),
              'metrics': metrics, 'device': dev}
    if tracing:
        w = probe.traced
        w.power_limit_w = power_limit_w() if device.type == 'cuda' else None
        for m in cell.per_layer:
            v = spec.reader(m['name'])(w)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        dev['busy_s'] = trace.busy_s(w)
        dev['window_s'] = w.seconds
        dev['power_limit_w'] = w.power_limit_w
        result['breakdown'] = trace.breakdown(w)
    result['detail'] = {
        'path': path, 'synth_s': src.synth_s, 'loops': out['loops'],
        'frames_a_loop': len(cap.emissions),
        'frames_expected': led['expected'],
        'frames_alias_junk': len(led['alias_at']),
        'missing_at': led['missing'][:12], 'other_at': led['other'][:8],
        'junk_at': led['junk_at'][:8], 'window_s': seconds,
        'start_offsets': led['start_offsets'],
        'stream_samples': probe.samples, 'trace': probe.trace_diag,
        'rt_quarters': out['rt_quarters']}
    result['checks'] = {k: {'value': v, 'limit': lim}
                        for k, (v, lim) in checks.items()}
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog='python3 -m hfdlbench.run',
                                 description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    # a planted fault, for the harness's own checks; runs never pass it
    ap.add_argument('--fault', choices=FAULTS, default=None,
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'hfdlbench: {cell.name} needs {cell.chips} CUDA device(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'device_count {torch.cuda.device_count()}', file=sys.stderr)
        return 3
    device = torch.device('cuda', 0)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 T_PROC0, fault=args.fault)
    bad = forbidden_modules()
    if bad:
        print(f'hfdlbench: forbidden modules loaded: {bad}', file=sys.stderr)
        return 4
    for k, c in result['checks'].items():
        print(f"check {k}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
