"""Port of ``gfnerf_tpu.pipelines``."""
