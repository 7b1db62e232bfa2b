"""Plain ReLU MLP: numpy init and a PyTorch module.

Port of ``gfnerf_tpu/fields/mlp.py`` (the reference's ``MLPNetwork``).
Weights are stored (in, out), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def init_mlp(
    rng: np.random.Generator,
    n_input: int,
    n_output: int,
    hidden: int,
    n_hidden_layers: int,
):
    """Kaiming-uniform init (torch.nn.Linear default) for a ReLU MLP, drawn
    in the JAX package's order.  Returns {"w": [W0, ...], "b": [b0, ...]}
    of numpy f32 arrays, W stored (in, out)."""
    dims = [n_input] + [hidden] * n_hidden_layers + [n_output]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        bound_w = float(np.sqrt(1.0 / dims[i]))
        w = rng.uniform(-bound_w * np.sqrt(3.0), bound_w * np.sqrt(3.0),
                        (dims[i], dims[i + 1])).astype(np.float32)
        b = rng.uniform(-bound_w, bound_w, (dims[i + 1],)).astype(np.float32)
        ws.append(w)
        bs.append(b)
    return {"w": ws, "b": bs}


class MLP(nn.Module):
    """Parameters of one MLP: ``w[i]`` (in, out) and ``b[i]`` (out,)."""

    def __init__(self, params: dict, device="cuda"):
        super().__init__()
        self.w = nn.ParameterList(
            [nn.Parameter(torch.tensor(np.asarray(w, np.float32),
                                          device=device))
             for w in params["w"]])
        self.b = nn.ParameterList(
            [nn.Parameter(torch.tensor(np.asarray(b, np.float32),
                                          device=device))
             for b in params["b"]])

    def to_numpy(self) -> dict:
        return {"w": [w.detach().cpu().numpy() for w in self.w],
                "b": [b.detach().cpu().numpy() for b in self.b]}


def apply_mlp(
    mlp: MLP,
    x: torch.Tensor,
    output_activation: str = "none",
    compute_dtype: torch.dtype = torch.float32,
    start_layer: int = 0,
) -> torch.Tensor:
    """ReLU MLP forward. ``output_activation``: "none" | "sigmoid".

    Hidden activations stay in ``compute_dtype`` between layers; the last
    layer multiplies ``compute_dtype`` operands with f32 accumulation and
    returns f32 (mlp.py:64-78).  ``start_layer`` > 0: ``x`` is that layer's
    pre-activation (the split colour head).
    """
    n = len(mlp.w)
    h = torch.relu(x) if start_layer > 0 else x
    h = h.to(compute_dtype)
    for i in range(start_layer, n):
        w = mlp.w[i].to(compute_dtype)
        if i == n - 1:
            # products of compute_dtype values are exact in f32, so an f32
            # matmul of the upcast operands is the f32-accumulated product
            h = torch.matmul(h.float(), w.float()) + mlp.b[i]
        else:
            h = torch.relu(torch.matmul(h, w) + mlp.b[i].to(compute_dtype))
    if output_activation == "sigmoid":
        h = torch.sigmoid(h)
    return h.float()
