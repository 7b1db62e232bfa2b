"""Fused volume-rendering composite, forward and backward.

Port of ``gfnerf_tpu/ops/pallas/composite.py``.  From (R, S) densities,
step sizes, distances and (R, S, 3) colours it computes

    alpha_i = 1 - exp(-sigma_i * dt_i)
    T_i     = exp(-sum_{j<i} sigma_j * dt_j)
    w_i     = alpha_i * T_i
    rgb = sum w_i c_i ; acc = sum w_i ; depth = sum w_i t_i / (acc + 1e-10)

``composite_reference`` and ``composite_backward_reference`` are the plain
PyTorch versions of the forward (the JAX package's ``_composite_reference``)
and of the backward (its Pallas ``_bwd_kernel``'s math).
``fused_composite`` is the differentiable wrapper: on CPU tensors it runs
the plain pair, on CUDA tensors the forward launches ``csrc/
composite_fwd.cu`` (K1) and the backward ``csrc/composite_bwd.cu`` (K2), or
raises.  ``plain_fused_composite`` is the same function through the plain
pair on any device, the yardstick the kernels are held to on the card.
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


def composite_backward_reference(densities, dts, ts, rgbs, g,
                                 needs=(True, True, True, True)):
    """The composite's vector-Jacobian product, as ``_bwd_kernel`` forms it.

    ``g`` = (g_weights, g_alphas (R, S), g_rgb (R, 3), g_acc, g_depth
    (R, 1)); a None cotangent counts as zero.  Returns (g_densities, g_dts,
    g_ts (R, S), g_rgbs (R, S, 3)), each None where ``needs`` says the
    input needs no gradient.  Two roundings of ``_bwd_kernel`` are
    avoided: d alpha / d(sigma dt) is exp(-sigma dt) itself, not 1 - alpha
    (which keeps no digits of it once alpha is near 1), and the exclusive
    suffix sum of ``-w * dL/dw`` is summed from the later samples alone (a
    reversed cumulative sum shifted by one), not taken as a difference of
    sums.
    """
    r, s = densities.shape
    zeros = densities.new_zeros
    gw, ga, grgb, gacc, gdepth = (
        zeros(shape) if x is None else x
        for x, shape in zip(g, ((r, s), (r, s), (r, 3), (r, 1), (r, 1))))
    dd = densities * dts
    keep = torch.exp(-dd)          # 1 - alpha = d alpha / d dd
    alphas = 1.0 - keep
    accum = torch.cumsum(dd, dim=-1)
    excl = torch.cat([torch.zeros_like(accum[:, :1]), accum[:, :-1]], dim=-1)
    trans = torch.exp(-excl)
    w = torch.nan_to_num(alphas * trans)
    acc = torch.sum(w, dim=-1, keepdim=True)
    a_eps = acc + 1e-10
    depth = torch.sum(w * ts, dim=-1, keepdim=True) / a_eps
    gw_tot = (gw + grgb[:, 0:1] * rgbs[..., 0] + grgb[:, 1:2] * rgbs[..., 1]
              + grgb[:, 2:3] * rgbs[..., 2] + gacc
              + gdepth * (ts - depth) / a_eps)
    g_alpha = ga + gw_tot * trans
    g_excl = -w * gw_tot
    sfx = torch.flip(torch.cumsum(torch.flip(g_excl, [-1]), -1), [-1])
    later = torch.cat([sfx[:, 1:], torch.zeros_like(sfx[:, :1])], dim=-1)
    g_dd = g_alpha * keep + later
    return (g_dd * dts if needs[0] else None,
            g_dd * densities if needs[1] else None,
            gdepth * w / a_eps if needs[2] else None,
            grgb[:, None, :] * w[..., None] if needs[3] else None)


class _FusedComposite(torch.autograd.Function):
    """K1 forward and K2 backward on CUDA tensors; the plain pair on CPU
    tensors or when ``plain`` is set."""

    @staticmethod
    def forward(ctx, densities, dts, ts, rgbs, plain):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(densities, dts, ts, rgbs)
        ctx.plain = plain or densities.device.type == "cpu"
        if ctx.plain:
            return composite_reference(densities, dts, ts, rgbs)
        return _composite_cuda(densities, dts, ts, rgbs)

    @staticmethod
    def backward(ctx, *g):
        x = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        if ctx.plain:
            return (*composite_backward_reference(*x, g, needs), None)
        return (*_composite_bwd_cuda(*x, g, needs), None)


def fused_composite(densities, dts, ts, rgbs):
    """(weights, alphas, rgb, acc, depth) from (R, S) samples,
    differentiable in all four inputs: the plain pair for CPU tensors, the
    CUDA kernels for CUDA tensors."""
    return _FusedComposite.apply(densities, dts, ts, rgbs, False)


def plain_fused_composite(densities, dts, ts, rgbs):
    """``fused_composite`` through the plain forward and backward on any
    device (launches no kernel)."""
    return _FusedComposite.apply(densities, dts, ts, rgbs, True)


fused_composite.launches = 0       # K1 launches
fused_composite.bwd_launches = 0   # K2 launches


def _check_inputs(what, densities, dts, ts, rgbs):
    dev = densities.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if densities.dim() != 2:
        raise ValueError(f"{what}: densities must be (R, S), got "
                         f"{tuple(densities.shape)}")
    r, s = densities.shape
    for name, t, shape in (("densities", densities, (r, s)),
                           ("dts", dts, (r, s)), ("ts", ts, (r, s)),
                           ("rgbs", rgbs, (r, s, 3))):
        if t.device != dev or t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{what}: {name} must be f32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return r, s


def _composite_cuda(densities, dts, ts, rgbs):
    r, s = _check_inputs("fused_composite", densities, dts, ts, rgbs)
    dev = densities.device
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


def _ptr(x) -> int:
    """A tensor's device address, or a null pointer for None."""
    return 0 if x is None else x.data_ptr()


def _composite_bwd_cuda(densities, dts, ts, rgbs, g,
                        needs=(True, True, True, True), tiled=False):
    """K2: ``composite_backward_reference`` on CUDA tensors; an output the
    caller does not need is neither allocated nor written.  Rays of up to
    512 samples go to the kernel that holds a ray in registers, longer ones
    (or any, with ``tiled``) to the tiled kernel."""
    r, s = _check_inputs("fused_composite backward", densities, dts, ts, rgbs)
    dev = densities.device
    if -(-s // 32) * 8 * 4 > 48 * 1024:
        raise ValueError(f"fused_composite backward: {s} samples per ray "
                         f"exceed the tiled kernel's shared memory")
    dens, dt, tt, col = (t.contiguous() for t in (densities, dts, ts, rgbs))
    cots = []
    for name, x, shape in zip(("g_weights", "g_alphas", "g_rgb", "g_acc",
                               "g_depth"), g,
                              ((r, s), (r, s), (r, 3), (r, 1), (r, 1))):
        if x is not None and (x.device != dev or x.shape != shape):
            raise ValueError(f"fused_composite backward: {name} must be "
                             f"{shape} on {dev}, got {tuple(x.shape)} on "
                             f"{x.device}")
        cots.append(None if x is None
                    else x.to(torch.float32).contiguous())
    outs = [torch.empty(shape, dtype=torch.float32, device=dev) if need
            else None for need, shape in zip(needs, ((r, s), (r, s), (r, s),
                                                     (r, s, 3)))]
    err = build.library().gfnerf_composite_bwd(
        dens.data_ptr(), dt.data_ptr(), tt.data_ptr(), col.data_ptr(),
        *map(_ptr, cots), *map(_ptr, outs), r, s, int(tiled),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "gfnerf_composite_bwd")
    fused_composite.bwd_launches += 1
    return tuple(outs)
