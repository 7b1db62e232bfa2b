"""LPIPS-style perceptual distance over fixed random conv features.

Port of ``gfnerf_tpu/model_components/lpips.py``: the LPIPS computation
(multi-scale deep features, channel-unit normalization, spatially averaged
squared distance, uniform layer weights) over a deterministic, randomly
initialized VGG16-shaped conv stack drawn from a fixed numpy seed, so that
there are no weights to fetch.  Scores are comparable across checkpoints of
this code base, not with published pretrained-LPIPS tables; the eval
reports it as ``lpips_proxy``.  ``load_weights`` installs other kernels
(pretrained VGG16 ones, where a user has them) in the JAX package's
layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 feature stages used by LPIPS: (channels, convs) per stage
_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SEED = 1810  # part of the metric's definition


@functools.lru_cache(maxsize=1)
def _default_weights():
    """He-initialized conv kernels (3, 3, c_in, c_out), numpy, drawn as
    the JAX package draws them."""
    rng = np.random.default_rng(_SEED)
    weights = []
    c_in = 3
    for c_out, n_convs in _STAGES:
        stage = []
        for _ in range(n_convs):
            fan_in = 3 * 3 * c_in
            k = rng.standard_normal((3, 3, c_in, c_out)).astype(np.float32)
            k *= np.sqrt(2.0 / fan_in)
            stage.append(k)
            c_in = c_out
        weights.append(stage)
    return weights


_loaded_weights = None


def _torch_layout(weights) -> list:
    """Stages of (3, 3, c_in, c_out) kernels as (c_out, c_in, 3, 3) CPU
    tensors, the layout ``conv2d`` takes."""
    return [[torch.as_tensor(np.asarray(k, np.float32)).permute(3, 2, 0, 1)
             .contiguous() for k in stage] for stage in weights]


def load_weights(weights) -> None:
    """Install pretrained VGG16 kernels (a list of stages, each a list of
    (3, 3, c_in, c_out) arrays, as the JAX package's ``load_weights``
    takes them) in place of the random features; None restores those."""
    global _loaded_weights
    _loaded_weights = None if weights is None else _torch_layout(weights)


@functools.lru_cache(maxsize=1)
def _default_torch_weights() -> list:
    return _torch_layout(_default_weights())


def _features(x: torch.Tensor) -> list:
    """x (N, 3, H, W) in [0, 1] -> the stages' feature maps."""
    x = (x - 0.5) / 0.5
    feats = []
    weights = _loaded_weights or _default_torch_weights()
    for si, stage in enumerate(weights):
        for k in stage:
            x = F.relu(F.conv2d(x, k.to(x.device), padding=1))
        feats.append(x)
        if si < len(weights) - 1:
            x = F.avg_pool2d(x, 2)
    return feats


@torch.no_grad()
def lpips(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Perceptual distance between images a, b of shape (H, W, 3) or
    (N, H, W, 3), values in [0, 1]; a scalar (mean over the batch)."""
    if a.dim() == 3:
        a, b = a[None], b[None]
    fa = _features(a.permute(0, 3, 1, 2).float())
    fb = _features(b.permute(0, 3, 1, 2).float())
    total = 0.0
    for xa, xb in zip(fa, fb):
        # unit-normalize channels (LPIPS eq. 1)
        na = xa * torch.rsqrt(torch.sum(xa * xa, 1, keepdim=True) + 1e-10)
        nb = xb * torch.rsqrt(torch.sum(xb * xb, 1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum((na - nb) ** 2, dim=1))
    return total / len(fa)
