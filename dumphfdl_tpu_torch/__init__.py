"""dumphfdl-tpu-torch: the HFDL decoder on PyTorch with hand-written CUDA
kernels for NVIDIA Hopper.

Mirrors the tree of the JAX package (``dumphfdl_tpu``), which stays the
reference it is tested against.  The port is self-contained: it imports
nothing of that package and keeps its own copies of the host-only modules
(constants, sequences, ops/{crc,interleave,bits}, protocol,
io/{formats,formatters,outputs}, utils/{statsd,debug}), which a test holds
equal to the originals.
"""

__version__ = '0.1.0'
