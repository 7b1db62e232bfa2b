"""Capture processing: COLMAP's model readers (``colmap_utils``), the
capture-format converters (``converters``) and ``python -m
gfnerf_tpu_torch.process_data``."""
