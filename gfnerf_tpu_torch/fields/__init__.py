"""Port of ``gfnerf_tpu.fields``."""
