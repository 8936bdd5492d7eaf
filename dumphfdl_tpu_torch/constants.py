"""HFDL constants (``dumphfdl_tpu/constants.py``, which imports no jax),
re-exported so code built on the port needs no import of the JAX package."""

from dumphfdl_tpu.constants import *  # noqa: F401,F403
