"""torch.profiler plumbing shared by the CLI's --profile and the scripts
that read a profiled pass (chip_smoke.py).

``profiler(device)`` traces host operations and, for a CUDA device, the
card's kernels and copies; ``export`` writes the Chrome trace --profile
promises; ``device_profile`` sums a finished trace's device time.
"""

from __future__ import annotations

import os

import torch

TRACE_NAME = 'dumphfdl_trace.json'

# kernel kinds of a profiled pass, by a key in the kernel's name (the first
# key that matches names the kind)
KINDS = (('viterbi27_kernel', 'K1 Viterbi'), ('tracker_kernel', 'K2 tracker'),
         ('memcpy', 'memcpy/memset'), ('memset', 'memcpy/memset'),
         ('fft', 'cuFFT'), ('index', 'gather/index'),
         ('gather', 'gather/index'), ('scan', 'scan'), ('sort', 'sort'),
         ('reduce', 'reduce'), ('cat', 'cat/copy'), ('copy', 'cat/copy'),
         ('elementwise', 'elementwise'))


def profiler(device) -> torch.profiler.profile:
    """A profiler of host activity and, on a CUDA device, of the card's."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def export(prof: torch.profiler.profile, directory: str) -> str:
    """Write a stopped profiler's Chrome trace under directory (made if
    missing); returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TRACE_NAME)
    prof.export_chrome_trace(path)
    return path


def device_profile(prof: torch.profiler.profile, wall_s: float) -> dict:
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
        kind = next((k for key, k in KINDS if key in n), 'other')
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
