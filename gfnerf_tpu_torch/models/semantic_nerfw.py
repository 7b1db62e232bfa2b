"""Semantic NeRF-W: nerfacto with a semantics head.

Port of ``gfnerf_tpu/models/semantic_nerfw.py`` (nerfstudio's
``semantic_nerfw.py:58-300``): nerfacto (``models/nerfacto.py``) plus a
semantics MLP on the geometry features, detached unless
``pass_semantic_gradients`` (the default keeps them out, :104), whose
per-sample logits are summed by the weights (``SemanticRenderer``) and
trained by cross-entropy against the batch's labels, clipped to the
classes; ``semantics_colormap`` colours each pixel's argmax class.  The
reference's transient embedding raises in its own code (:89-90) and is
not implemented in either package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gfnerf_tpu_torch.fields.mlp import apply_mlp, init_mlp
from gfnerf_tpu_torch.model_components.losses import mse_loss
from gfnerf_tpu_torch.models.nerfacto import (
    NerfactoConfig,
    NerfactoModel,
    init_nerfacto_params,
    nerfacto_forward,
    proposal_losses,
)
from gfnerf_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class SemanticNerfWConfig(NerfactoConfig):
    num_semantic_classes: int = 2
    semantic_loss_weight: float = 1.0     # semantic_nerfw.py:64
    pass_semantic_gradients: bool = False


def init_semantic_nerfw_params(cfg: SemanticNerfWConfig, seed: int = 0):
    """Nerfacto's (params, statics) from ``seed``, and the semantics heads
    (geometry features -> 64 -> 64 -> classes, semantic_nerfw.py:118-123)
    drawn from ``default_rng(seed + 7)``, as the JAX package draws them."""
    params, statics = init_nerfacto_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 7)
    params["mlp_semantics"] = init_mlp(rng, cfg.geo_feat_dim, 64, 64, 1)
    params["semantics_head"] = init_mlp(rng, 64, cfg.num_semantic_classes,
                                        64, 0)
    return params, statics


def semantic_nerfw_forward(model: NerfactoModel, rays_o, rays_d, rel,
                           draws=None) -> dict:
    """``nerfacto_forward`` plus "semantics" (R, classes), the logits
    summed by the weights."""
    cfg = model.cfg
    out = nerfacto_forward(model, rays_o, rays_d, rel, draws)
    geo = out["geo"]                       # (R, S, G)
    sem_in = geo if cfg.pass_semantic_gradients else geo.detach()
    with span("semantics"):
        x = apply_mlp(model.mlp_semantics,
                      sem_in.reshape(-1, cfg.geo_feat_dim))
        logits = apply_mlp(model.semantics_head, x).reshape(
            *geo.shape[:2], cfg.num_semantic_classes)
        out["semantics"] = torch.sum(out["weights"][..., None] * logits,
                                     dim=1)
    return out


def semantic_nerfw_loss(model: NerfactoModel, rays_o, rays_d, rel, target,
                        semantics: Optional[torch.Tensor] = None,
                        draws=None):
    """(total, (losses, outputs)): nerfacto's losses and, given labels
    ``semantics`` (R,), the cross-entropy of the rendered logits."""
    cfg = model.cfg
    out = semantic_nerfw_forward(model, rays_o, rays_d, rel, draws)
    with span("loss"):
        losses = {"rgb_loss": mse_loss(out["rgb"], target),
                  **proposal_losses(cfg, out)}
        if semantics is not None:
            logp = torch.log_softmax(out["semantics"], dim=-1)
            labels = torch.clamp(semantics.long(), 0,
                                 cfg.num_semantic_classes - 1)
            ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
            losses["semantics_loss"] = (cfg.semantic_loss_weight
                                        * torch.mean(ce))
        total = sum(losses.values())
    return total, (losses, out)


def semantics_colormap(logits: torch.Tensor,
                       colors: np.ndarray) -> torch.Tensor:
    """Each pixel's argmax class's colour (semantic_nerfw.py:238-241)."""
    cls = torch.argmax(logits, dim=-1)
    return torch.as_tensor(np.asarray(colors), device=logits.device)[cls]
