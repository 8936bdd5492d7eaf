"""Explicit device selection: the port never picks a device by itself.

Every constructor takes a ``device``; the CLI and ``chip_smoke.py`` get
theirs from :func:`require_cuda`, which refuses to run without a card
instead of falling back to the CPU.  Only the tests pass ``'cpu'``.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: dumphfdl_tpu_torch needs an '
                           'NVIDIA GPU (torch.cuda.is_available() is False)')
    return torch.device('cuda', torch.cuda.current_device())
