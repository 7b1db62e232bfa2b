"""Interactive web viewer (``gfnerf_tpu_torch.viewer.server``): ``python -m
gfnerf_tpu_torch.viewer --load-config RUN/config.json``."""
