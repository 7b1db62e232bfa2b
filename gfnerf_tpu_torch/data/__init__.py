"""Port of ``gfnerf_tpu.data``."""
