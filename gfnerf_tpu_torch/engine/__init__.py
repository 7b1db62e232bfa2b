"""Port of ``gfnerf_tpu.engine``."""
