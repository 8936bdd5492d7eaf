# Copy of dumphfdl_tpu/dsp/dumpfile.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""Per-stage DSP signal taps for offline analysis.

Equivalent of the reference's --datadumps system (src/dumpfile.c,
src/config.h.in:12-24): raw rf32/cf32 files of intermediate signals,
loadable in NumPy/Octave.  Stage names mirror the reference's dump
points (hfdl.c:616-655):

  chan_out   cf32  channelizer output at 5400 sps
  agc_out    cf32  AGC output
  agc_level  rf32  AGC signal-level estimate
  mf_out     cf32  matched-filter output
  sym_out    cf32  tracker symbol-strobe output (equalized)
  const      cf32  data-symbol constellation points
  costas_dphi rf32 Costas loop frequency estimate per symbol (rad/half-sym)
  costas_err rf32  Costas phase-detector error per symbol
  symsync_tau rf32 symbol-sync fractional timing offset per symbol

One file per (stage, channel): <prefix><stage>.ch<N>.<ext>
"""

from __future__ import annotations

import numpy as np


STAGES = ('chan_out', 'agc_out', 'agc_level', 'mf_out', 'sym_out', 'const',
          'costas_dphi', 'costas_err', 'symsync_tau')


class DumpSet:
    def __init__(self, prefix: str = '', stages: tuple[str, ...] = STAGES):
        self.prefix = prefix
        self.stages = set(stages)
        self._files: dict[tuple[str, int], object] = {}

    def _fh(self, stage: str, channel: int, is_complex: bool):
        key = (stage, channel)
        fh = self._files.get(key)
        if fh is None:
            ext = 'cf32' if is_complex else 'rf32'
            path = f'{self.prefix}{stage}.ch{channel}.{ext}'
            fh = open(path, 'ab')
            self._files[key] = fh
        return fh

    def write(self, stage: str, data: np.ndarray) -> None:
        """data: (C, T) complex64 or float32 block for all channels."""
        if stage not in self.stages:
            return
        data = np.asarray(data)
        is_complex = np.iscomplexobj(data)
        dt = np.complex64 if is_complex else np.float32
        for ch in range(data.shape[0]):
            self._fh(stage, ch, is_complex).write(
                np.ascontiguousarray(data[ch], dtype=dt).tobytes())

    def close(self) -> None:
        for fh in self._files.values():
            fh.close()
        self._files.clear()
