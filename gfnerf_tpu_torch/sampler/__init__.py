"""Port of ``gfnerf_tpu.sampler``."""
