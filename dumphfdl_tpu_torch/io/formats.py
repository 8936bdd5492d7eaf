"""Raw I/Q sample formats (``dumphfdl_tpu/io/formats.py``, which imports no
jax), re-exported so code built on the port needs no import of the JAX
package."""

from dumphfdl_tpu.io.formats import *  # noqa: F401,F403
