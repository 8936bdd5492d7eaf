# Copy of dumphfdl_tpu/ops/interleave.py: equal to it below this line, the citations' absolute path to the reference tree read as 'reference ' (tests/test_torch_hostcopies.py).
"""HFDL block interleaver permutations.

The reference deinterleaver is a 40-row table written by a "push" walk and
read by a "pop" walk (reference src/hfdl.c:353-413):

  push k  -> cell (k mod 40, (floor(k/40) - k*shift) mod cols)
  pop  j  -> cell ((9*j) mod 40,  floor(j/40))

with shift = 17 (single slot) or 23 (double slot) and
cols = data_bits/40.  Rather than walking cells serially, we precompute the
composite permutation once per mode so the TPU path de/interleaves with a
single gather.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import constants as C


@functools.cache
def _perms(column_cnt: int, push_column_shift: int) -> tuple[np.ndarray, np.ndarray]:
    rows = C.DEINTERLEAVER_ROW_CNT
    n = rows * column_cnt
    k = np.arange(n, dtype=np.int64)
    push_row = k % rows
    push_col = (k // rows - k * push_column_shift) % column_cnt
    push_cell = push_row * column_cnt + push_col

    j = np.arange(n, dtype=np.int64)
    pop_row = (C.DEINTERLEAVER_POP_ROW_SHIFT * j) % rows
    pop_col = j // rows
    pop_cell = pop_row * column_cnt + pop_col

    # cell -> push index that wrote it
    cell_to_push = np.empty(n, dtype=np.int64)
    cell_to_push[push_cell] = k
    # deinterleave: pop j reads the value pushed at index deint[j]
    deint = cell_to_push[pop_cell]
    # interleave (TX): pushed stream position k carries pop-stream bit int[k]
    inter = np.empty(n, dtype=np.int64)
    inter[deint] = j
    return deint, inter


def deinterleave_perm(mode: int) -> np.ndarray:
    """perm such that deinterleaved[j] = received_chips[perm[j]]."""
    p = C.MODES[mode]
    return _perms(p.interleaver_column_cnt, p.interleaver_push_column_shift)[0]


def interleave_perm(mode: int) -> np.ndarray:
    """perm such that tx_chips[k] = coded_chips[perm[k]]."""
    p = C.MODES[mode]
    return _perms(p.interleaver_column_cnt, p.interleaver_push_column_shift)[1]
