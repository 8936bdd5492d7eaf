"""The benchmark of dumphfdl_tpu_torch (see README.md)."""
