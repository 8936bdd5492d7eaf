"""dumphfdl-tpu-torch: the HFDL decoder on PyTorch with hand-written CUDA
kernels for NVIDIA Hopper.

Mirrors the tree of the JAX package (``dumphfdl_tpu``), which stays the
reference it is tested against.  Host-only modules of that package that
import no jax (constants, sequences, ops/{crc,interleave,bits}, protocol,
io/{formats,formatters,outputs}, utils/statsd) are imported, not copied.
"""

__version__ = '0.1.0'
