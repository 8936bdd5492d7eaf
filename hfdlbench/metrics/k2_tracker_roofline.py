"""k2_tracker_roofline (%): kernel K2 (the symbol tracker: timing
recovery, carrier loop, equalizer and framer; kernels named
tracker_kernel*) against the least time for the tracking the traced
window's frames need.

Frozen work count per channel and symbol of a frame on the air, from the
algorithm's inputs and outputs, whatever a kernel reads again:

* bytes: 3 matched-filtered complex64 samples in (24 B) and one complex64
  soft symbol out (8 B): 32 B;
* operations: the interpolating timing filters, a value and a derivative
  filter of 8 real taps on complex samples at 2 outputs a symbol
  (2 x 2 x 8 x 4 = 128); the timing error and its loop (10); the 15-tap
  complex equalizer (15 x 8 = 120) and its LMS update (15 x 8 + 4 = 124);
  the carrier rotation with its sine and cosine, phase error and loop
  (50); the level (4): 436.

The work the inputs need is the frames' own symbols (frame_symbols of
their mode, preamble and prekey included) on the channels that carry
them: a channel with no frame on the air needs no tracking, only the
acquisition gate outside the kernel.  The frames are the decoded frames
that reached the app in the traced window.
"""

from hfdlbench import roofline, tx

BYTES_PER_SYMBOL = 3 * 8 + 8
OPS_PER_SYMBOL = 128 + 10 + 120 + 124 + 50 + 4


def work(modes) -> tuple[int, int]:
    """(bytes, operations) to track one frame of each mode listed."""
    symbols = sum(tx.MODES[m].frame_symbols for m in modes)
    return symbols * BYTES_PER_SYMBOL, symbols * OPS_PER_SYMBOL


def read(w):
    n_bytes, n_ops = work(mode for _, mode in w.frames)
    return roofline.share(n_bytes, n_ops, w.kernel_s('tracker_kernel'))
