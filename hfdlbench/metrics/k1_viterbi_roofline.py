"""k1_viterbi_roofline (%): kernel K1 (the K=7 R=1/2 Viterbi decoder,
kernels named viterbi27_kernel*) against the least time for the decoding
the traced window's frames need.

Frozen work count, from the algorithm's inputs and outputs at the frame's
mode, whatever a kernel reads again or computes besides:

* bytes: the decoder's soft input, one byte per soft value
  (viterbi_input_len = 2 x framebits; at rate 1/4 the chip pairs are
  combined before the decoder), read once, and the decoded frame,
  pdu_len bytes, written once;
* operations per decoded bit: 64 states x (2 path-metric adds, 1 compare,
  1 select) = 256 for add-compare-select, 4 branch metrics x 2 = 8, and 1
  for the traceback: 265.

The frames are the decoded frames (FCS valid, of the emitted modes) that
reached the app in the traced window; alias images and junk are work the
inputs do not need and are not counted.
"""

from hfdlbench import roofline, tx

OPS_PER_BIT = 64 * 4 + 4 * 2 + 1


def work(modes) -> tuple[int, int]:
    """(bytes, operations) to decode one frame of each mode listed."""
    n_bytes = n_ops = 0
    for m in modes:
        p = tx.MODES[m]
        n_bytes += p.viterbi_input_len + p.pdu_len
        n_ops += p.framebits * OPS_PER_BIT
    return n_bytes, n_ops


def read(w):
    n_bytes, n_ops = work(mode for _, mode in w.frames)
    return roofline.share(n_bytes, n_ops, w.kernel_s('viterbi27_kernel'))
