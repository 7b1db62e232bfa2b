"""Port of ``gfnerf_tpu.model_components``."""
