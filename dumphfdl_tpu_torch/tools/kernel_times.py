"""Time the two hand-written kernels alone on one NVIDIA GPU.

    python -m dumphfdl_tpu_torch.tools.kernel_times

A quicker look than chip_smoke.py (under a minute, no plain versions): for
K1 (Viterbi) each mode's 64-frame batch through the one-mode entry and the
eight-mode event block through the one-launch entry, on uniformly random
chips (no code words: the traceback's guessed states merge later than on
real frames, so this is its slow case); for K2 (tracker) noise blocks with
the gate off at 512 x 1800, 512 x 5376 and 2048 x 5376 symbols, through
the wrapper (CUDA events) and the kernel alone (torch.profiler), and its
debug_taps instantiation at 512 x 1800 and 512 x 5376.  It also prints what
ptxas reports for each kernel of each source (registers, spills, shared
memory; K2's two instantiations are tracker_kernelILb0EE, the normal one,
and tracker_kernelILb1EE, with the taps).  Every line carries the card's name and power limit.  It checks
nothing: chip_smoke.py and tests/test_torch_cuda.py hold the kernels
against their plain versions.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import constants as C
from ..device import require_cuda
from ..dsp import tracker as trk
from ..dsp import tracker_cuda
from ..ops import _build, fec_cuda
from .kernel_check import cuda_ms


def _kernel_alone_ms(fn, name: str) -> float:
    """Mean device time of the kernels whose name holds `name` in fn()."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    return sum(e.device_time_total for e in hits) / 1e3 \
        / max(1, sum(e.count for e in hits))


def ptxas_report() -> dict[str, list[str]]:
    """What ptxas says of each kernel of each source (its -v lines that
    name the entry function, its registers and its spills), from a
    compile of csrc/*.cu with the build's own flags into a scratch
    directory."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(_build.CSRC.glob('*.cu')):
            res = subprocess.run(
                [_build._nvcc(), *_build.CUDA_FLAGS, '-Xptxas', '-v', '-c',
                 '-o', f'{tmp}/{src.stem}.o', str(src)],
                capture_output=True, text=True)
            out[src.name] = [
                ln.strip() for ln in res.stderr.splitlines()
                if 'registers' in ln or 'spill' in ln
                or 'Compiling entry function' in ln]
    return out


def registers(lines: list[str], entry: str) -> int:
    """Registers per thread of the kernel whose mangled name holds `entry`,
    from ptxas_report()'s lines of its source."""
    for i, ln in enumerate(lines):
        if 'Compiling entry function' in ln and entry in ln:
            used = next(x for x in lines[i + 1:] if 'Used' in x)
            return int(used.split('Used')[1].split('registers')[0])
    raise KeyError(entry)


def main() -> int:
    dev = require_cuda()
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def say(what: str, **kv) -> None:
        print(f'[{card}] {what}: ' + json.dumps(kv), flush=True)

    for name, lines in ptxas_report().items():
        say(f'ptxas {name}', lines=lines)

    rng = np.random.default_rng(1)
    lengths = [p.framebits for p in C.MODES]
    softs = [torch.as_tensor(rng.integers(0, 256, (64, 2 * n))
                             .astype(np.uint8), device=dev) for n in lengths]
    for s, n in zip(softs, lengths):
        say('K1 one mode', frames=64, nbits=n,
            ms=cuda_ms(lambda: fec_cuda.viterbi_decode(s, n), 20))
    say('K1 event block', frames=64, modes=len(lengths), launches=1,
        ms=cuda_ms(lambda: fec_cuda.viterbi_decode_many(softs, lengths), 20))

    for nch, n_sym in ((512, 1800), (512, 5376), (2048, 5376)):
        t = 3 * n_sym + trk.HALO
        x = torch.as_tensor((rng.standard_normal((nch, t))
                             + 1j * rng.standard_normal((nch, t)))
                            .astype(np.complex64), device=dev)
        lvl = torch.as_tensor((np.abs(rng.standard_normal((nch, t))) + 0.5)
                              .astype(np.float32), device=dev)
        st = trk.tracker_init(nch, dev)
        run = lambda: tracker_cuda.tracker_block(st, x, lvl, n_sym,
                                                 use_acq=False)
        say('K2 noise', channels=nch, symbols=n_sym,
            wrapper_ms=cuda_ms(run, 5),
            kernel_alone_ms=_kernel_alone_ms(run, 'tracker_kernel'))
        if nch == 512:
            taps = lambda: tracker_cuda.tracker_block(st, x, lvl, n_sym,
                                                      debug_taps=True)
            say('K2 noise, debug_taps', channels=nch, symbols=n_sym,
                wrapper_ms=cuda_ms(taps, 5),
                kernel_alone_ms=_kernel_alone_ms(taps, 'tracker_kernel'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
