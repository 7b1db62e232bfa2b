"""Train a registered method on one CUDA card (or the CPU), or on several.

The port's counterpart of ``scripts/train.py``:

  python -m gfnerf_tpu_torch.train METHOD --data DIR
      [--dataparser {minimal,nerfstudio,blender,instant-ngp,dnerf,scannet,
                     sdfstudio,phototourism,sitcoms3d,arkitscenes,nuscenes,
                     dycheck}] [--dataparser-scale-factor F]
      [--max-num-iterations N] [--output-dir DIR] [--experiment-name NAME]
      [--load-dir DIR] [--vis {local,viewer}] [--device {cuda,cpu}]
      [--parallel-blocks] [--num-machines N --machine-rank I
      --dist-url tcp://HOST:PORT] [--dist-backend {nccl,gloo}]
      [a.b.c=value ...] [--a.b.c value ...]

The default parser is ``minimal`` (the JAX script's is ``nerfstudio``).

Several ranks, one process each (GF-NeRF methods): ``python -m
torch.distributed.run --nproc-per-node N -m gfnerf_tpu_torch.train ...``
on each machine, or one process per machine with ``--num-machines N
--machine-rank I --dist-url tcp://HOST:PORT``.  Rank k trains on card
``LOCAL_RANK % device_count`` (``--device cpu``: the CPU).  The backend is
NCCL on cards and gloo on the CPU unless ``--dist-backend`` says; NCCL needs
a card per rank and raises otherwise (gloo lets ranks share a card).  The
init stage and the sequential focal stage train data-parallel;
``--parallel-blocks`` trains the focal tables concurrently on a (data,
block) grid of the ranks.

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
    parser.add_argument("--parallel-blocks", action="store_true",
                        help="train the focal residual tables concurrently "
                             "on a (data, block) grid of the ranks (needs "
                             ">= 2 ranks; parallel/sharding.py)")
    parser.add_argument("--num-machines", type=int, default=1,
                        help="ranks launched one per machine (reference "
                             "scripts/train.py:146-214)")
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="",
                        help="rendezvous address tcp://HOST:PORT of "
                             "--num-machines")
    parser.add_argument("--dist-backend", default=None,
                        choices=["nccl", "gloo"],
                        help="default: nccl on cards, gloo on the CPU")
    parser.add_argument("--dist-timeout", type=float, default=600.0,
                        help="seconds any collective, the rendezvous "
                             "included, may wait for a rank")
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
    if args.parallel_blocks:
        config.pipeline.parallel_blocks = True
    for key, value in parse_overrides(extra):
        apply_override(config, key, value)
    if config.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("train: no CUDA card (pass --device cpu to train on the "
                  "CPU)", file=sys.stderr)
            return None
    init_ranks(args, config.device)

    trainer = Trainer(config, build_dataparser(
        args.dataparser, args.data, args.dataparser_scale_factor))
    trainer.setup()
    return trainer


def init_ranks(args, device: str) -> None:
    """Join the process group when the launch has several ranks
    (``--num-machines`` > 1, or ``torch.distributed.run``'s
    ``WORLD_SIZE`` > 1), on card ``LOCAL_RANK % device_count``.  A rank
    that cannot join raises; nothing falls back to one card."""
    import os

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.num_machines <= 1 and world <= 1:
        return
    import torch

    from gfnerf_tpu_torch.parallel import comm

    backend = args.dist_backend or ("nccl" if device == "cuda" else "gloo")
    if backend == "nccl" and device != "cuda":
        raise ValueError("the nccl backend runs on cards: pass --device "
                         "cuda or --dist-backend gloo")
    if args.num_machines > 1:
        if not args.dist_url:
            raise ValueError("--num-machines > 1 needs --dist-url "
                             "tcp://HOST:PORT")
        world_comm = comm.initialize_multihost(
            args.dist_url, args.num_machines, args.machine_rank, backend,
            args.dist_timeout, n_hosts=args.num_machines, device=device)
    else:
        world_comm = comm.initialize_multihost(
            backend=backend, timeout_s=args.dist_timeout, device=device)
    print(f"train: rank {world_comm.rank} of {world_comm.size}, backend "
          f"{backend}, device "
          f"{torch.cuda.current_device() if device == 'cuda' else 'cpu'}",
          flush=True)


def main(argv=None):
    trainer = build_trainer(argv)
    if trainer is None:
        return 1
    trainer.train()
    if trainer.comm is None:
        print(f"training complete; outputs in {trainer.base_dir}")
        return 0
    from gfnerf_tpu_torch.parallel import comm, state_digest

    # the ranks end bit-identical: each prints its state's digest
    print(f"train: rank {trainer.comm.rank} parameters "
          f"{state_digest(trainer.pipeline.field)}", flush=True)
    if trainer.is_main:
        print(f"training complete; outputs in {trainer.base_dir}")
    comm.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
