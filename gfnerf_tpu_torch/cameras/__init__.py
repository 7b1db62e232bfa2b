"""Port of ``gfnerf_tpu.cameras``."""
