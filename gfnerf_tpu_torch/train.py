"""Train a registered method on one CUDA card (or the CPU).

The port's counterpart of ``scripts/train.py`` (its arguments, minus the
multi-host ones):

  python -m gfnerf_tpu_torch.train METHOD --data DIR
      [--dataparser {minimal,nerfstudio,blender,instant-ngp,dnerf,scannet,
                     sdfstudio,phototourism,sitcoms3d,arkitscenes,nuscenes,
                     dycheck}] [--dataparser-scale-factor F]
      [--max-num-iterations N] [--output-dir DIR] [--experiment-name NAME]
      [--load-dir DIR] [--vis {local,viewer}] [--device {cuda,cpu}]
      [a.b.c=value ...] [--a.b.c value ...]

The default parser is ``minimal`` (the JAX script's is ``nerfstudio``).

Extra arguments are dotted config overrides, e.g.
``pipeline.model.n_blocks=4``.  Methods: gf-nerf (the paper's: 1024 march
slots, a budget of 256 field samples a ray), gf-nerf-perf, gf-nerf-prop,
gf-nerf-tiny, and on the vanilla pipeline nerfacto, semantic-nerfw
(whose labels are the npz's ``road_masks``), instant-ngp (e.g. on a
Blender scene of PNGs, ``--dataparser blender``), mipnerf, tensorf, neus,
vanilla-nerf, and the dynamic-scene pair nerfplayer-nerfacto and
nerfplayer-ngp (on a D-NeRF or DyCheck capture, ``--dataparser dnerf`` or
``dycheck``, whose frames carry times).  A COLMAP capture in the wild
trains with ``--dataparser phototourism``, e.g. at half its image size and
with gradient clipping: ``pipeline.datamanager.camera_res_scale_factor=0.5
pipeline.optimizers.max_norm=1.0``.  ``python -m
gfnerf_tpu_torch.eval`` and ``python -m gfnerf_tpu_torch.render`` read a
run's ``config.json`` and checkpoint.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# the JAX script's dataparsers (data/dataparsers/__init__.py)
DATAPARSERS = ["minimal", "nerfstudio", "blender", "instant-ngp", "dnerf",
               "scannet", "sdfstudio", "phototourism", "sitcoms3d",
               "arkitscenes", "nuscenes", "dycheck"]


def parse_overrides(extra) -> list:
    """[(dotted key, value)] from ``a.b=v`` and ``--a.b v`` arguments."""
    out, i = [], 0
    while i < len(extra):
        arg = extra[i]
        if arg.startswith("--"):
            if i + 1 >= len(extra):
                raise SystemExit(f"override {arg!r} has no value")
            out.append((arg[2:], extra[i + 1]))
            i += 2
        elif "=" in arg:
            key, value = arg.split("=", 1)
            out.append((key, value))
            i += 1
        else:
            raise SystemExit(f"unexpected argument {arg!r}")
    return out


def build_trainer(argv=None):
    """The Trainer the command line ``argv`` describes, set up (None, with
    a note on stderr, where it asks for a card that is not there)."""
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    parser.add_argument("method", help="registered method name")
    parser.add_argument("--data", type=Path, required=True)
    parser.add_argument("--dataparser", default="minimal",
                        choices=DATAPARSERS)
    parser.add_argument("--dataparser-scale-factor", type=float,
                        default=None)
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"))
    parser.add_argument("--experiment-name", default=None)
    parser.add_argument("--max-num-iterations", type=int, default=None)
    parser.add_argument("--vis", default="local",
                        choices=["local", "viewer"],
                        help="viewer: serve the web viewer while training, "
                             "on viewer_port (an override, default 7007)")
    parser.add_argument("--load-dir", type=Path, default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, extra = parser.parse_known_args(argv)

    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer

    config = get_method(args.method)
    config.data = args.data
    config.output_dir = args.output_dir
    config.vis = args.vis
    config.device = args.device
    if args.experiment_name:
        config.experiment_name = args.experiment_name
    if args.max_num_iterations is not None:
        config.max_num_iterations = args.max_num_iterations
    if args.load_dir is not None:
        config.load_dir = args.load_dir
    for key, value in parse_overrides(extra):
        apply_override(config, key, value)
    if config.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("train: no CUDA card (pass --device cpu to train on the "
                  "CPU)", file=sys.stderr)
            return None

    trainer = Trainer(config, build_dataparser(
        args.dataparser, args.data, args.dataparser_scale_factor))
    trainer.setup()
    return trainer


def main(argv=None):
    trainer = build_trainer(argv)
    if trainer is None:
        return 1
    trainer.train()
    print(f"training complete; outputs in {trainer.base_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
