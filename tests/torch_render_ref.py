"""The JAX package's scripts on a tiny run, for the port's video test.

Run as a script in a process of its own, with one JAX CPU device:

  python tests/torch_render_ref.py SCENE_DIR OUT_DIR STEPS

Trains ``gf-nerf-tiny`` on the npz scene through ``scripts/train.py`` (the
minimal parser, 128 rays a batch, S3IM patches of height 8) for STEPS
steps into OUT_DIR/run, then renders the run's spiral (3 frames at half
size) through ``scripts/render.py`` twice in the same process: as
``render.mp4`` (``cv2.VideoWriter``, ``mp4v``, 24 fps) into OUT_DIR/video
and as PNG frames into OUT_DIR/images.  The second call takes the first
one's ``eval_setup`` (the same config and checkpoint, loaded once).
"""

from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path

RENDER_ARGS = ["--spiral-steps", "3", "--downscale-factor", "2"]
TRAIN_OVERRIDES = ["--pipeline.datamanager.train_num_rays_per_batch", "128",
                   "--pipeline.model.s3im_patch_height", "8"]


def _script(name):
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(scene, out_dir, steps):
    out = Path(out_dir)
    _script("train").main([
        "gf-nerf-tiny", "--data", str(scene), "--dataparser", "minimal",
        "--output-dir", str(out / "run"), "--experiment-name", "tiny",
        "--max-num-iterations", str(steps), "--vis", "local",
        *TRAIN_OVERRIDES])
    (config,) = (out / "run").glob("tiny/gf-nerf-tiny/*/config.yml")
    render = _script("render")
    from gfnerf_tpu.utils import eval_utils

    loaded = {}
    setup = eval_utils.eval_setup
    eval_utils.eval_setup = lambda *a: loaded.get(a) or loaded.setdefault(
        a, setup(*a))
    for fmt, sub in (("video", "video"), ("images", "images")):
        render.main(["--load-config", str(config), "--output-format", fmt,
                     "--output-path", str(out / sub), *RENDER_ARGS])


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
