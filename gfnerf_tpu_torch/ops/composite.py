"""Fused volume-rendering composite, forward.

Port of ``gfnerf_tpu/ops/pallas/composite.py``.  From (R, S) densities,
step sizes, distances and (R, S, 3) colours it computes

    alpha_i = 1 - exp(-sigma_i * dt_i)
    T_i     = exp(-sum_{j<i} sigma_j * dt_j)
    w_i     = alpha_i * T_i
    rgb = sum w_i c_i ; acc = sum w_i ; depth = sum w_i t_i / (acc + 1e-10)

``composite_reference`` is the plain PyTorch version (the JAX package's
``_composite_reference``).  ``fused_composite`` is the kernel wrapper: on CPU
tensors it runs the plain version, on CUDA tensors it launches
``csrc/composite_fwd.cu`` or raises.  The backward kernel is not ported yet.
"""

from __future__ import annotations

import torch

from gfnerf_tpu_torch.ops import build


def composite_reference(densities, dts, ts, rgbs):
    """(weights, alphas, rgb (R, 3), acc (R, 1), depth (R, 1))."""
    delta_density = dts * densities
    alphas = 1.0 - torch.exp(-delta_density)
    accum = torch.cumsum(delta_density, dim=-1)
    accum = torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]],
                      dim=-1)
    trans = torch.exp(-accum)
    weights = torch.nan_to_num(alphas * trans)
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    depth = torch.nan_to_num(
        torch.sum(weights * ts, dim=-1, keepdim=True) / (acc + 1e-10))
    return weights, alphas, rgb, acc, depth


def fused_composite(densities, dts, ts, rgbs):
    """(weights, alphas, rgb, acc, depth) from (R, S) samples: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if densities.device.type == "cpu":
        return composite_reference(densities, dts, ts, rgbs)
    return _composite_cuda(densities, dts, ts, rgbs)


fused_composite.launches = 0


def _composite_cuda(densities, dts, ts, rgbs):
    dev = densities.device
    if dev.type != "cuda":
        raise ValueError(f"fused_composite: unsupported device {dev}")
    if densities.dim() != 2:
        raise ValueError(f"fused_composite: densities must be (R, S), got "
                         f"{tuple(densities.shape)}")
    r, s = densities.shape
    for name, t, shape in (("densities", densities, (r, s)),
                           ("dts", dts, (r, s)), ("ts", ts, (r, s)),
                           ("rgbs", rgbs, (r, s, 3))):
        if t.device != dev or t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"fused_composite: {name} must be f32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    dens, dt, tt, col = (t.contiguous() for t in (densities, dts, ts, rgbs))
    w = torch.empty((r, s), dtype=torch.float32, device=dev)
    alpha = torch.empty_like(w)
    rgb = torch.empty((r, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((r, 1), dtype=torch.float32, device=dev)
    depth = torch.empty((r, 1), dtype=torch.float32, device=dev)
    err = build.library().gfnerf_composite_fwd(
        dens.data_ptr(), dt.data_ptr(), tt.data_ptr(), col.data_ptr(),
        w.data_ptr(), alpha.data_ptr(), rgb.data_ptr(), acc.data_ptr(),
        depth.data_ptr(), r, s, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "gfnerf_composite_fwd")
    fused_composite.launches += 1
    return w, alpha, rgb, acc, depth
