"""Activation functions.

``trunc_exp`` ports ``gfnerf_tpu/fields/activations.py``: exp in the forward
pass, gradient computed with the input clamped to [-15, 15].
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
