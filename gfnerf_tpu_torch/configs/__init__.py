"""Port of ``gfnerf_tpu.configs``."""
