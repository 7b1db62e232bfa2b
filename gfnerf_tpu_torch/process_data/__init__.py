"""Capture processing: COLMAP's model readers (``colmap_utils``)."""
