"""Port of ``gfnerf_tpu.utils``."""
