"""Port of ``gfnerf_tpu.ops``."""
