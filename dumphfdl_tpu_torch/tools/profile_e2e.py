"""Stage-level wall-clock profile of the port's end-to-end file path.

Twin of ``extras/profile_e2e.py``.  One in-memory CS16 capture (bench.py's
end-to-end workload: channels around 10 MHz, a frame on every
(channels // 16)-th channel, the single-slot modes in turn, 30 dB, seed 0)
goes through four ever longer stages, each timed per pass after one
warm-up pass:

1. upload: read + native-width upload + convert (``ingest.uploaded_stream``);
2. + channelizer (``Channelizer.process_device``);
3. + demodulator and events (``WidebandReceiver.process``);
4. the full path: + protocol and text output (``HfdlApp.handle_events``).

Every stage ends in ``torch.cuda.synchronize`` on a CUDA device.  Stages 3
and 4 keep one receiver across their passes (steady state, as in the JAX
script); the full path is then flushed and its ledger checked: each emitted
frame once per pass with its bytes, nothing else.  --trace DIR writes a
torch.profiler Chrome trace of one more full pass
(``utils/profiling.export``, as the CLI's --profile).

    python -m dumphfdl_tpu_torch.tools.profile_e2e [--fs 1728000]
        [--channels 128] [--passes 2] [--trace DIR] [--device cuda:0]
        [--out PATH]

Prints a line per stage and, last, one JSON object (--out also writes it
to PATH).  Runs on the CUDA device unless --device names another.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

import torch

READ_BYTES = 320_000        # the app's read buffer (AppConfig)

STAGES = ('upload', 'upload+channelizer', 'upload+channelizer+demod',
          'full')


def capture(fs: int, nch: int) -> dict:
    """The CS16 capture (soak_stream.capture's, serialized), its channel
    list and the emitted PDU by channel."""
    from ..io import formats
    from .soak_stream import capture as wideband
    cap = wideband(nch, fs)
    return dict(raw=formats.serialize(cap['wb'], 'CS16'), freqs=cap['freqs'],
                emit_by_chan={c: pdu for c, (pdu, _) in
                              cap['emit_by_chan'].items()},
                duration_s=cap['loop_len'] / fs)


def profile(fs: int = 1_728_000, channels: int = 128, passes: int = 2,
            device='cuda', trace: str | None = None, say=print) -> dict:
    """The four stages; returns the JSON result (say prints each stage's
    line)."""
    from ..app import AppConfig, HfdlApp
    from ..dsp.frontend import Channelizer
    from ..dsp.receiver import WidebandReceiver
    from ..io import ingest
    from ..io.outputs import OutputManager, OutputSpec
    from ..protocol.enrichment import AcCache, SysTable
    from ..protocol.runtime import ProtocolContext, ProtocolOptions
    from .soak_stream import CENTER
    device = torch.device(device)
    cap = capture(fs, channels)
    raw, freqs, duration = cap['raw'], cap['freqs'], cap['duration_s']

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    def stream():
        return ingest.uploaded_stream(
            ingest.file_chunks(io.BytesIO(raw), 'CS16', READ_BYTES), 'CS16',
            device)

    walls = {}

    def timed(name, fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(passes):
            fn()
        sync()
        dt = (time.perf_counter() - t0) / passes
        walls[name] = dt
        say(f'{name:<26} {dt:9.4f} s/pass   rt={duration / dt:7.2f}x')

    def upload_only():
        for _ in stream():
            pass
    timed('upload', upload_only)

    cz = Channelizer(fs, CENTER, freqs, device)

    def channelizer_only():
        for xd in stream():
            cz.process_device(xd)
    timed('upload+channelizer', channelizer_only)

    rx = WidebandReceiver(fs, CENTER, freqs, device)

    def dsp_only():
        for xd in stream():
            rx.process(xd)
    timed('upload+channelizer+demod', dsp_only)

    ctx = ProtocolContext(systable=SysTable(None), ac_cache=AcCache(),
                          ac_data=None, options=ProtocolOptions())
    outputs = OutputManager(ctx, hwm=0)
    outputs.add_output(OutputSpec.parse('decoded:text:file:path=/dev/null'))
    app = HfdlApp(AppConfig(frequencies=freqs, sample_rate=fs,
                            centerfreq=CENTER, device=device), ctx, outputs)
    events = []
    handle = app.handle_events

    def handled(evs):
        events.extend(ev for ev in evs if ev.pdu is not None)
        handle(evs)
    app.handle_events = handled

    def full():
        for xd in stream():
            app.handle_events(app.receiver.process(xd))
    timed('full', full)
    app.handle_events(app.receiver.flush())
    full_passes = passes + 1
    trace_path = None
    if trace:
        from ..utils import profiling
        prof = profiling.profiler(device)
        with prof:
            full()
            sync()
        trace_path = profiling.export(prof, trace)
        app.handle_events(app.receiver.flush())
        full_passes += 1
    outputs.shutdown()

    emit = cap['emit_by_chan']
    ok = {}
    other = junk = 0
    for ev in events:
        if not ev.fcs_ok:
            junk += 1
        elif ev.channel in emit and ev.pdu[:len(emit[ev.channel])] \
                == emit[ev.channel]:
            ok[ev.channel] = ok.get(ev.channel, 0) + 1
        else:
            other += 1
    exact = (ok == {c: full_passes for c in emit} and not other
             and not junk)
    return dict(
        metric='stage wall per pass of the end-to-end file path',
        channels=channels, sample_rate=fs, fmt='CS16', device=str(device),
        path=('fused' if app.receiver.fused else 'unfused'),
        capture_s=duration, passes=passes, wall_s_per_pass=walls,
        rt_factor={k: duration / v for k, v in walls.items()},
        full_passes=full_passes, frames_emitted=len(emit),
        frames_decoded=app.frames_decoded,
        frames_per_full_pass=sum(ok.values()) / full_passes,
        frames_other=other, frames_junk=junk, exact=exact, trace=trace_path)


def main(argv=None) -> int:
    from ..device import require_cuda
    ap = argparse.ArgumentParser(
        prog='python -m dumphfdl_tpu_torch.tools.profile_e2e',
        description=__doc__.splitlines()[0])
    ap.add_argument('--fs', type=int, default=1_728_000)
    ap.add_argument('--channels', type=int, default=128)
    ap.add_argument('--passes', type=int, default=2)
    ap.add_argument('--trace', default=None,
                    help='write a Chrome trace of one full pass here')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the CUDA device)')
    ap.add_argument('--out', default=None,
                    help='also write the JSON result to this file')
    args = ap.parse_args(argv)
    device = require_cuda() if args.device is None \
        else torch.device(args.device)
    out = profile(args.fs, args.channels, args.passes, device, args.trace,
                  say=lambda line: print(line, file=sys.stderr, flush=True))
    text = json.dumps(out)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(text + '\n')
    print(text)
    return 0 if out['exact'] else 1


if __name__ == '__main__':
    sys.exit(main())
