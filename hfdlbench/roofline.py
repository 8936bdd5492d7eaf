"""A kernel's share of its roofline over the traced window.

least time = max(operations / peak float32 rate, bytes / peak memory rate)
for the work the window's inputs need, from peaks.json (the H100 SXM data
sheet at 700 W; the card's own power limit is reported beside the reading
as device.power_limit_w).  The share is least time over the summed
profiler time of the kernel's launches, in percent.  No time, or no work:
no reading.
"""

from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent
                    / 'peaks.json').read_text())


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_ops / PEAKS['fp32_flops_per_s'],
               n_bytes / PEAKS['hbm_bytes_per_s'])


def share(n_bytes: float, n_ops: float, kernel_s: float) -> float | None:
    if kernel_s <= 0 or (n_bytes <= 0 and n_ops <= 0):
        return None
    return 100.0 * least_s(n_bytes, n_ops) / kernel_s
