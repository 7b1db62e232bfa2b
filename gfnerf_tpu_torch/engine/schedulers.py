"""Learning-rate schedules.

Port of ``gfnerf_tpu/engine/schedulers.py`` (nerfstudio's
``schedulers.py``): exponential decay with warm-up (:77-109) and the
GF-NeRF variant (:138-185) that restarts the decay for every focal
split-dataset phase (:163-171), and optax's ``exponential_decay``, which
the vanilla pipeline's Adam reads.  A schedule maps the step (an int or a
tensor) to the learning rate as a float32 tensor, computed in float32 as
the JAX package computes it.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class ExponentialDecaySchedulerConfig:
    lr_final: float | None = None
    warmup_steps: int = 0
    lr_pre_warmup: float = 1e-8
    max_steps: int = 100000
    ramp: str = "cosine"


@dataclasses.dataclass
class GFNerfExponentialDecaySchedulerConfig(ExponentialDecaySchedulerConfig):
    n_split_dataset: int = 1
    n_dataset_circles: int = 1
    steps_per_split_dataset: int = 1000
    steps_perssampler_init: int = 10000


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _decay(relative_step, cfg, lr_init: float, lr_final: float):
    t = torch.clamp((relative_step - cfg.warmup_steps)
                    / max(cfg.max_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return torch.exp(torch.log(_f32(lr_init)) * (1 - t)
                     + torch.log(_f32(lr_final)) * t)


def _warmup(step, cfg, lr_init: float):
    if cfg.ramp == "cosine":
        return cfg.lr_pre_warmup + (1 - cfg.lr_pre_warmup) * torch.sin(
            0.5 * math.pi * torch.clamp(step / max(cfg.warmup_steps, 1),
                                        0, 1))
    return cfg.lr_pre_warmup + (lr_init - cfg.lr_pre_warmup) * step / max(
        cfg.warmup_steps, 1)


def exponential_decay_schedule(cfg: ExponentialDecaySchedulerConfig,
                               lr_init: float):
    """schedulers.py:77-109. Returns step -> lr."""
    lr_final = cfg.lr_final if cfg.lr_final is not None else lr_init

    def schedule(step):
        step = _f32(step)
        return torch.where(step < cfg.warmup_steps,
                           _warmup(step, cfg, lr_init),
                           _decay(step, cfg, lr_init, lr_final))

    return schedule


def optax_exponential_decay(init_value: float, transition_steps: int,
                            decay_rate: float):
    """optax's ``exponential_decay`` (no staircase, no delay): ``init *
    rate ** (count / transition_steps)``, in float32 as optax computes
    it.  Returns count -> lr."""
    init = _f32(init_value)
    rate = _f32(decay_rate)

    def schedule(count):
        count = _f32(count)
        return torch.where(count <= 0, init,
                           init * torch.pow(rate, count / transition_steps))

    return schedule


def gfnerf_exponential_decay_schedule(
        cfg: GFNerfExponentialDecaySchedulerConfig, lr_init: float):
    """schedulers.py:138-185: restart the decay for each split phase."""
    lr_final = cfg.lr_final if cfg.lr_final is not None else lr_init

    def schedule(step):
        step = _f32(step)
        init = cfg.steps_perssampler_init
        per_split = cfg.steps_per_split_dataset
        n_split = cfg.n_split_dataset
        after = torch.clamp(step - init, min=0)
        split_idx = torch.remainder(torch.div(after, per_split,
                                              rounding_mode="floor"), n_split)
        circles = torch.div(after, per_split * n_split,
                            rounding_mode="floor")
        relative = (step - init - circles * per_split * n_split
                    - split_idx * per_split + circles * per_split)
        in_init = (init > 0) & (step < init)
        relative = torch.where(in_init, step, relative)
        return torch.where(step < cfg.warmup_steps,
                           _warmup(step, cfg, lr_init),
                           _decay(relative, cfg, lr_init, lr_final))

    return schedule
