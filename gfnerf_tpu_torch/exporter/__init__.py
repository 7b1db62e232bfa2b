"""Export utilities (``exporter.py``); ``python -m gfnerf_tpu_torch.export``
drives them on a trained run."""
