"""Volume-rendering heads.

Port of ``gfnerf_tpu/model_components/renderers.py`` (nerfstudio's
``renderers.py``): colour with a background, accumulation, expected depth
and a weighted sum of any per-sample values (semantic logits, normals),
all on (R, S[, C]) weights and sample values.
"""

from __future__ import annotations

import torch


def render_rgb(weights: torch.Tensor, rgbs: torch.Tensor,
               background_color: str = "black") -> torch.Tensor:
    """(R, 3) colour of (R, S) weights and (R, S, 3) colours; the
    background fills what the weights leave: "black", "white", or
    "last_sample" (the ray's last sample's colour)."""
    comp = torch.sum(weights[..., None] * rgbs, dim=-2)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    if background_color == "white":
        comp = comp + (1.0 - acc)
    elif background_color == "last_sample":
        comp = comp + (1.0 - acc) * rgbs[..., -1, :]
    elif background_color != "black":
        raise ValueError(f"unknown background {background_color!r}")
    return comp


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights, dim=-1, keepdim=True)


def render_expected_depth(weights: torch.Tensor,
                          ts: torch.Tensor) -> torch.Tensor:
    """E[t] under the weights, (R, 1) (DepthRenderer "expected")."""
    acc = torch.sum(weights, dim=-1, keepdim=True)
    depth = torch.sum(weights * ts, dim=-1, keepdim=True) / (acc + 1e-10)
    return torch.nan_to_num(depth)


def render_weighted(weights: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """The weighted sum (R, C) of (R, S, C) values."""
    return torch.sum(weights[..., None] * values, dim=-2)
