"""Multi-card training: the rank grid and the two multi-card train steps.

Port of ``gfnerf_tpu/parallel/sharding.py`` (the reference's DDP,
``scripts/train.py:90-214``) onto ``torch.distributed``, one process per
rank; the collectives, and ``initialize_multihost`` (the process group's
rendezvous), are :mod:`gfnerf_tpu_torch.parallel.comm`'s.

- :class:`RankGrid`, the counterpart of the JAX package's ("data",
  "block") mesh: each rank's (data, block) coordinates.
  :func:`make_grid` lays the ranks out as ``make_mesh`` lays out the
  devices; :func:`multihost_grid` as ``make_multihost_mesh`` does (block
  groups span whole hosts when the hosts divide among them, so that the
  data groups' every-step all-reduce stays inside a host).
- Data-parallel steps (``make_dp_train_step``): the one-card step on each
  rank's slice of the batch, every term reduced over the whole batch
  (``models/gfnerf.make_train_step`` given the world group), so a step
  equals the one-card step on the whole batch.
- :func:`make_parallel_block_step`, the concurrent focal step: block group
  g trains its own residual table on its own camera cluster's rays, its
  gradient and loss averaged over the group's data ranks alone, with the
  block Adam (eps 1e-15, a constant step of 5e-3); the shared parameters
  are frozen, so the groups never exchange a gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gfnerf_tpu_torch.cameras.cameras import Cameras, generate_rays_multi
from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig, OptState,
                                                PerGroupAdam,
                                                active_block_table,
                                                apply_updates)
from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT, GFNeRFField
from gfnerf_tpu_torch.model_components.losses import (charbonnier_loss,
                                                      s3im_loss,
                                                      s3im_permutations)
from gfnerf_tpu_torch.parallel.comm import Comm
from gfnerf_tpu_torch.sampler.perssampler import OctreeDevice, SamplerConfig

# the block optimizer of the concurrent step (pipeline.py:256-259 of the
# JAX package): Adam with eps 1e-15, then a constant step of -5e-3
BLOCK_LR = 5e-3


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """``layout[d, b]`` is the global rank at data index d of block group
    b: shape (n_data, n_block)."""

    layout: np.ndarray

    @property
    def n_data(self) -> int:
        return self.layout.shape[0]

    @property
    def n_block(self) -> int:
        return self.layout.shape[1]

    @property
    def world(self) -> int:
        return self.layout.size

    def coords(self, rank: int) -> tuple:
        """(data index, block group) of a global rank."""
        d, b = np.argwhere(self.layout == rank)[0]
        return int(d), int(b)

    def data_ranks(self, block: int) -> list:
        """Block group ``block``'s ranks, by data index."""
        return [int(r) for r in self.layout[:, block]]


def make_grid(n_data: int, n_block: int = 1) -> RankGrid:
    """Ranks in ``make_mesh``'s device order: rank d * n_block + b sits at
    (d, b)."""
    return RankGrid(np.arange(n_data * n_block).reshape(n_data, n_block))


def multihost_grid(world: int, n_hosts: int, n_block: int = 1) -> RankGrid:
    """``make_multihost_mesh``'s layout (sharding.py:73-97 of the JAX
    package) for ranks numbered host-major, ``world / n_hosts`` a host:
    with ``n_hosts % n_block == 0`` block group b is the b-th run of
    ``n_hosts / n_block`` whole hosts; otherwise the ranks fill the grid
    row by row, as ``make_mesh`` does."""
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not spread evenly over "
                         f"{n_hosts} hosts")
    if n_block <= 1:
        return make_grid(world, 1)
    if world % n_block:
        raise ValueError(f"{world} ranks do not divide into {n_block} "
                         "block groups")
    per_host = world // n_hosts
    ranks = np.arange(world)
    if n_hosts % n_block == 0:
        return RankGrid(ranks.reshape(
            n_block, (n_hosts // n_block) * per_host).T.copy())
    return RankGrid(ranks.reshape(-1, n_block))


def block_axis(world: int, n_blocks: int, requested: int = 0) -> int:
    """The block groups of the concurrent focal stage (pipeline.py:224-231
    of the JAX package): ``requested`` if > 0, else the largest b <=
    min(world, n_blocks) dividing both; it must divide both."""
    b = requested
    if b <= 0:
        b = max(c for c in range(1, min(world, n_blocks) + 1)
                if world % c == 0 and n_blocks % c == 0)
    if world % b or n_blocks % b:
        raise ValueError(f"a block axis of {b} must divide the {world} "
                         f"ranks and the {n_blocks} blocks")
    return b


def state_digest(module: torch.nn.Module) -> str:
    """A SHA-256 of a module's state, names and bytes: equal on ranks that
    hold it bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def make_dp_train_step(model_cfg, sampler_cfg: SamplerConfig,
                       tx: PerGroupAdam, comm: Comm,
                       stage: int = STAGE_INIT):
    """The data-parallel train step: ``make_train_step`` over ``comm``
    (each rank passes its slice of the batch and the whole batch's draws;
    every term, the gradients and the occupancy statistics reduce over the
    group).  ``make_dp_train_step`` of the JAX package is the one-card step
    on a sharded batch; this is its counterpart."""
    from gfnerf_tpu_torch.models.gfnerf import make_train_step

    return make_train_step(model_cfg, sampler_cfg, tx, stage, comm=comm)


def block_optimizer() -> PerGroupAdam:
    """The concurrent step's optimizer: Adam (b1 0.9, b2 0.999, eps 1e-15)
    and a constant step of 5e-3 on the one "block" group, every update
    applied; the run's optimizer config does not enter it, as in the JAX
    package (``tx_block``)."""
    return PerGroupAdam(OptimizersConfig(adam_eps=1e-15),
                        schedules={"block": lambda count: BLOCK_LR},
                        skip_nonfinite=False)


def make_parallel_block_step(model_cfg, sampler_cfg: SamplerConfig,
                             tx_block: PerGroupAdam,
                             data_comm: Optional[Comm]):
    """The concurrent focal step of one rank (``shard_fn``, sharding.py:
    181-289 of the JAX package).

    Returns ``step(field, opt_state, oct_dev, cameras, batch, fineness,
    block, generator=None, noise=None, s3im_perms=None)`` -> (opt_state,
    loss, per-ray error).  ``batch`` is this rank's share of its block
    group's rays; ``block`` the group's active block.  The loss is
    Charbonnier plus S3IM on those rays alone; the march noise (R, S) and
    the S3IM permutations of R are drawn from ``generator`` unless passed
    in, so every rank, drawing from one seed, draws the same (as every
    shard of the JAX step splits one replicated key).  The table's
    gradient and the loss are averaged over ``data_comm`` (the group's
    data ranks); then Adam (``tx_block``) updates block ``block``'s table
    in place.  The step ignores ``use_ch_loss``, the trust and empty-space
    terms, the semantics and camera terms, ``max_norm`` and the run's
    optimizer config, and updates no occupancy statistics, as the JAX
    step does."""
    from gfnerf_tpu_torch.models.gfnerf import model_forward, sample_rays

    def step(field: GFNeRFField, opt_state: OptState, oct_dev: OctreeDevice,
             cameras: Cameras, batch: dict, fineness: float, block: int,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             s3im_perms: Optional[torch.Tensor] = None):
        target = batch["image"]
        r = target.shape[0]
        dev = target.device
        rays = generate_rays_multi(cameras, batch["camera_indices"],
                                   batch["coords"])
        if noise is None:
            noise = (torch.rand((r, sampler_cfg.max_samples),
                                generator=generator, device=dev)
                     - 0.5) + 1.0
        if s3im_perms is None and model_cfg.s3im_loss_mult > 0:
            s3im_perms = s3im_permutations(
                r, model_cfg.s3im_repeat_time, generator=generator,
                device=dev)
        with torch.no_grad():
            samples = sample_rays(oct_dev, rays["origins"],
                                  rays["directions"], noise, fineness,
                                  sampler_cfg)
        field.zero_grad(set_to_none=True)
        table = active_block_table(field, block, requires_grad=True)
        out = model_forward(field, model_cfg, samples, rays["directions"],
                            batch["rel_camera_indices"], STAGE_BLOCK,
                            oct_dev, block, table)
        loss = charbonnier_loss(out["rgb"], target)
        if model_cfg.s3im_loss_mult > 0:
            loss = loss + model_cfg.s3im_loss_mult * s3im_loss(
                out["rgb"], target, s3im_perms,
                kernel_size=model_cfg.s3im_kernel_size,
                stride=model_cfg.s3im_stride,
                patch_height=model_cfg.s3im_patch_height)
        loss.backward(inputs=[table])
        with torch.no_grad():
            err = torch.sum(torch.abs(out["rgb"] - target), dim=-1)
            # the gradient and the loss averaged over the group's data
            # ranks in one all-reduce (pmean over "data")
            n = table.numel()
            buf = torch.cat([table.grad.reshape(-1),
                             loss.detach().reshape(1)])
            if data_comm is not None and data_comm.size > 1:
                buf = data_comm.all_reduce(buf) / data_comm.size
            grad = buf[:n].view_as(table)
            params = {"block": [table]}
            updates, opt_state = tx_block.update({"block": [grad]},
                                                 opt_state, params)
            apply_updates(params, updates)
        return opt_state, buf[n], err

    return step
