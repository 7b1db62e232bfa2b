"""Port of ``gfnerf_tpu.models``."""
