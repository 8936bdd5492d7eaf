"""Live-path endurance soak of the port: a stream fed in real time.

Twin of ``extras/soak_stream.py``.  A source releases wideband chunks of a
looping synthetic capture no earlier than their stream time, as an SDR
would, into ``HfdlApp.run_stream`` (``run_stream_raw`` for an integer
format, buffers in its native width).  Before the pacing starts the whole
chain is warmed up without pacing: on the superstep through the engine's
own API (``SuperstepEngine.upload`` and the receiver's ``process_packed``),
else through ``WidebandReceiver.process``.  The paced stream continues the
warm-up's stream where it stopped, and once the paced seconds are over it
runs on to the end of the capture's loop, so that no frame is cut; the
receiver is flushed at the end.  Records:

* input ring overruns (0: the decoder kept up);
* event latency, from a frame's end on the air to its event being handled:
  p50, p95 and max over the paced frames;
* the ledger against the emitted schedule: every frame of every loop
  decoded once with its bytes, frames with the wrong bytes, junk (frames
  failing their FCS), and among the junk the frames on a quiet channel one
  or two channels from an emitter (IMAGE_STEPS), of the emitter's mode and
  within 64 symbols of its frame's start;
* resident memory (current and peak) after the warm-up and at the end, and
  on a CUDA device the allocated device memory at both points.

The settings are the JAX script's SOAK_STREAM_* environment variables, each
also a flag (the flag wins):

    python -m dumphfdl_tpu_torch.tools.soak_stream [--channels 256]
        [--seconds 120] [--fs HZ] [--fmt CF32|CS16|CU8] [--chunk-s 0.75]
        [--block 16200] [--label TEXT] [--device cuda:0] [--out PATH]

The unpaced warm-up is the JAX script's: three demod blocks plus two
seconds of stream.  Prints one JSON object; --out also writes it to PATH.  Runs on the CUDA device unless --device
names another.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

CENTER = 10_000_000
EMITTERS = 16
# A quiet channel one or two from an emitter may decode, as the emitter's
# frame starts, a frame of the emitter's mode that fails its FCS; the JAX
# package decodes the same frames from the same samples
# (tests/test_torch_soak_junk.py).  The next channel carries the emitter:
# at 512 channels and 2.16 Msps (4179 Hz apart) the channel filter leaves
# it 36 dB down, 49 dB above the capture's noise.  Two channels away the
# channelizer's output rate folds it onto the channel at 1024 channels
# (3355 Hz apart, 6750 sps); at 512 channels nothing of it shows there
# above the noise, and a false lock there still coincides with its frame.
# Such junk is counted apart from other junk (tools/alias.split_junk).
IMAGE_STEPS = (1, 2)


def capture(nch: int, fs: int) -> dict:
    """bench.py's end-to-end capture, which the JAX soak and profile scripts
    use too: nch channels around 10 MHz, a frame on every (nch // 16)-th
    channel, the single-slot modes in turn, 30 dB, from seed 0.  Returns
    freqs, emissions, the emitted PDU and mode by channel, the complex64
    capture (looped end to end by the soak) and its length."""
    from .. import constants as C
    from ..dsp import modulator
    spacing = max(3000, min(8000, (fs - 20000) // max(nch, 1)))
    freqs = [CENTER + (i - nch // 2) * spacing for i in range(nch)]
    rng = np.random.default_rng(0)
    single_slot = [m for m in range(len(C.MODES)) if C.MODES[m].slot == 'S']
    emissions, emit_by_chan = [], {}
    for k, ci in enumerate(range(0, nch, max(1, nch // EMITTERS))):
        mode = single_slot[k % len(single_slot)]
        pdu = modulator.make_test_mpdu(mode, rng)
        emissions.append((pdu, mode, freqs[ci]))
        emit_by_chan[ci] = (pdu, mode)
    wb = modulator.synthesize_wideband_fft(emissions, fs=fs,
                                           centerfreq=CENTER, snr_db=30.0)
    return dict(freqs=freqs, emissions=emissions, emit_by_chan=emit_by_chan,
                wb=wb, loop_len=len(wb))


def looped(wb: np.ndarray, start: int, n: int) -> np.ndarray:
    """Samples [start, start + n) of the capture repeated end to end."""
    idx = (start + np.arange(n)) % len(wb)
    return wb[idx]


def ledger(events, emit_by_chan: dict, loops: int) -> dict:
    """The decoded frames against the schedule: every emitter's frame once
    per loop of the capture, with its bytes."""
    from .alias import split_junk
    ok, other, junk, heard = {}, 0, [], {}
    for ev in events:
        if ev.pdu is None:
            continue
        if not ev.fcs_ok:
            junk.append(ev)
            continue
        exp = emit_by_chan.get(ev.channel)
        if exp is not None and ev.pdu[:len(exp[0])] == exp[0]:
            ok[ev.channel] = ok.get(ev.channel, 0) + 1
            heard.setdefault(ev.channel, []).append((ev.start_symbol,
                                                     ev.mode))
        else:
            other += 1
    alias, junk_at = split_junk(junk, emit_by_chan, heard, IMAGE_STEPS)
    led = dict(loops=loops, frames_expected=loops * len(emit_by_chan),
               frames_ok=sum(ok.values()), frames_other=other,
               frames_junk=len(junk_at), frames_alias_junk=len(alias),
               channels_short=sorted(c for c in emit_by_chan
                                     if ok.get(c, 0) < loops),
               channels_over=sorted(c for c, n in ok.items() if n > loops),
               junk_at=junk_at[:8], alias_at=alias[:8])
    led['exact'] = (led['frames_ok'] == led['frames_expected']
                    and not other and not junk_at
                    and not led['channels_short'] and not led['channels_over'])
    return led


def _rss_kb() -> tuple[int, int]:
    """(current, peak) resident set size of this process in kB."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with open('/proc/self/statm') as fh:
        pages = int(fh.read().split()[1])
    return pages * os.sysconf('SC_PAGE_SIZE') // 1024, peak


def _device_memory(device) -> dict:
    if device.type != 'cuda':
        return {}
    torch.cuda.synchronize(device)
    return dict(memory_allocated=torch.cuda.memory_allocated(device),
                max_memory_allocated=torch.cuda.max_memory_allocated(device))


def run(channels: int = 256, seconds: float = 120.0, fs: int | None = None,
        fmt: str = 'CF32', chunk_s: float = 0.75, block: int = 16200,
        device='cuda', label: str | None = None) -> dict:
    """One soak; returns the JSON result."""
    from .. import constants as C
    from ..app import AppConfig, HfdlApp
    from ..io import formats
    from ..io.outputs import OutputManager, OutputSpec
    from ..protocol.runtime import ProtocolContext
    device = torch.device(device)
    nch = channels
    fs = fs or max(2_160_000, nch * 3375)
    fmt = fmt.upper()
    cap = capture(nch, fs)
    wb, loop_len = cap['wb'], cap['loop_len']

    ctx = ProtocolContext()
    outputs = OutputManager(ctx, hwm=1000)
    outputs.add_output(OutputSpec.parse('decoded:text:file:path=/dev/null'))
    cs = 1 << int(np.ceil(np.log2(max(int(fs * chunk_s), 32768))))
    cfg = AppConfig(frequencies=cap['freqs'], sample_rate=fs,
                    centerfreq=CENTER, device=device, demod_block_len=block,
                    sample_format=fmt, stream_chunk_samples=cs)
    t0 = time.perf_counter()
    app = HfdlApp(cfg, ctx, outputs)
    setup_s = time.perf_counter() - t0
    rx = app.receiver
    ss = rx.superstep

    events, latencies = [], []
    t_start = [None]
    warm_end = [0]
    handle = app.handle_events

    def handled(evs):
        now = time.time()
        for ev in evs:
            if ev.pdu is None:
                continue
            events.append(ev)
            if not ev.fcs_ok:
                continue
            # the frame's end in stream seconds: its start on the symbol
            # clock (which counts the warm-up's samples, less the
            # superstep's one-block delay) plus its length
            sym = ev.start_symbol - (ss.delay_symbols if ss is not None
                                     else 0)
            end_s = (sym + C.MODES[ev.mode].frame_len_symbols) \
                / C.SYMBOL_RATE - warm_end[0] / fs
            if t_start[0] is not None and end_s > 0:
                latencies.append(now - (t_start[0] + end_s))
        handle(evs)

    app.handle_events = handled
    app.stream_epoch = time.time()

    # warm-up, not paced: every kernel, FFT plan and (superstep) the graph
    # capture is made here, not while the paced chunks pile up
    warm_need = 3 * block * (fs // C.INTERNAL_RATE + 1) + 2 * fs
    pos = 0
    while pos < warm_need:
        if ss is not None:
            chunk = looped(wb, pos, ss.plan.wb_chunk)
            raw = formats.serialize(chunk, ss.input_kind)
            app.handle_events(rx.process_packed(ss.upload(raw)))
            pos += ss.plan.wb_chunk
        else:
            app.handle_events(rx.process(looped(wb, pos, cs)))
            pos += cs
    warm_end[0] = pos
    rss0 = _rss_kb()
    mem0 = _device_memory(device)
    stream_end = [warm_end[0]]

    def source():
        """Chunks of cs samples from the warm-up's end, each released no
        earlier than its stream time; once `seconds` of stream are out, the
        last ones run on to the end of a loop of the capture."""
        p = warm_end[0]
        while True:
            n = cs
            if p - warm_end[0] >= seconds * fs:
                n = min(cs, (-p) % loop_len)
                if n == 0:
                    return
            if t_start[0] is None:
                t_start[0] = time.time()
            delay = t_start[0] + (p - warm_end[0]) / fs - time.time()
            if delay > 0:
                time.sleep(delay)
            chunk = looped(wb, p, n)
            yield chunk if fmt == 'CF32' else np.frombuffer(
                formats.serialize(chunk, fmt), np.uint8)
            p += n
            stream_end[0] = p

    t0 = time.perf_counter()
    if fmt == 'CF32':
        app.run_stream(source())
    else:
        app.run_stream_raw(source(), sample_format=fmt)
    wall = time.perf_counter() - t0
    app.handle_events(rx.flush())
    rss1 = _rss_kb()
    mem1 = _device_memory(device)
    app.shutdown()

    total = stream_end[0]
    led = ledger(events, cap['emit_by_chan'], total // loop_len)
    lat = np.asarray(latencies) if latencies else np.zeros(1)
    return dict(
        metric='live-path endurance: real-time paced stream',
        label=label or ('superstep' if ss is not None
                        else f'block={block}'),
        superstep=ss is not None, path='superstep' if ss is not None
        else 'fused' if rx.fused else 'unfused',
        demod_block_len=block, channels=nch, sample_rate=fs, fmt=fmt,
        chunk_samples=cs, device=str(device), setup_s=setup_s,
        warm_stream_s=warm_end[0] / fs,
        paced_stream_s=(total - warm_end[0]) / fs, seconds=wall,
        input_overrun_samples=app.last_ingest_overruns,
        **led,
        latency_s=dict(p50=float(np.percentile(lat, 50)),
                       p95=float(np.percentile(lat, 95)),
                       max=float(lat.max()), n=len(latencies)),
        rss_start_kb=rss0[0], rss_end_kb=rss1[0],
        maxrss_start_kb=rss0[1], maxrss_end_kb=rss1[1],
        device_memory_start=mem0, device_memory_end=mem1)


def main(argv=None) -> int:
    from ..device import require_cuda
    env = os.environ.get
    ap = argparse.ArgumentParser(
        prog='python -m dumphfdl_tpu_torch.tools.soak_stream',
        description=__doc__.splitlines()[0])
    ap.add_argument('--channels', type=int,
                    default=int(env('SOAK_STREAM_CHANNELS', '256')))
    ap.add_argument('--seconds', type=float,
                    default=float(env('SOAK_STREAM_SECONDS', '120')))
    ap.add_argument('--fs', type=int, default=(
        int(env('SOAK_STREAM_FS')) if env('SOAK_STREAM_FS') else None))
    ap.add_argument('--fmt', default=env('SOAK_STREAM_FMT', 'CF32'))
    ap.add_argument('--chunk-s', type=float,
                    default=float(env('SOAK_STREAM_CHUNK_S', '0.75')))
    ap.add_argument('--block', type=int,
                    default=int(env('SOAK_STREAM_BLOCK', '16200')))
    ap.add_argument('--label', default=env('SOAK_STREAM_LABEL'))
    ap.add_argument('--device', default=None,
                    help='torch device (default: the CUDA device)')
    ap.add_argument('--out', default=None,
                    help='also write the JSON result to this file')
    args = ap.parse_args(argv)
    device = require_cuda() if args.device is None \
        else torch.device(args.device)
    out = run(args.channels, args.seconds, args.fs, args.fmt, args.chunk_s,
              args.block, device, args.label)
    text = json.dumps(out)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(text + '\n')
    print(text)
    return 0 if out['exact'] and not out['input_overrun_samples'] else 1


if __name__ == '__main__':
    sys.exit(main())
