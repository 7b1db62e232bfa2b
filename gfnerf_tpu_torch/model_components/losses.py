"""Training losses of the GF-NeRF path.

Port of ``gfnerf_tpu/model_components/losses.py``: Charbonnier, MSE and
S3IM (the reference's ``nerfstudio/model_components/losses.py:713-794``),
the proposal samplers' interlevel and distortion losses (mip-NeRF 360,
nerfstudio losses.py:154, 186), depth-nerfacto's DS-NeRF depth loss, the
scale-and-shift-invariant depth loss, the orientation and predicted-normal
regularizers, and the TV loss on octree-leaf boundary samples.
S3IM's random permutations come from an explicit ``torch.Generator``, or
are passed in, since the two packages draw different random numbers; in a
data-parallel step S3IM runs over the whole batch, gathered from every rank
(``s3im_loss_whole_batch``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def charbonnier_loss(pred, target, eps: float = 1e-6) -> torch.Tensor:
    """CharbonnierLoss with out_norm='b': sum sqrt((x-y)^2+eps^2) / batch."""
    loss = torch.sum(torch.sqrt((pred - target) ** 2 + eps * eps))
    return loss / pred.shape[0]


def _gaussian_kernel(size: int, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64)
    g = np.exp(-((x - size // 2) ** 2) / (2.0 * sigma * sigma))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_on(size: int, device: torch.device) -> torch.Tensor:
    """``_gaussian_kernel`` on ``device``, copied there once: a step
    replayed as a CUDA graph copies nothing from the host."""
    return torch.as_tensor(_gaussian_kernel(size), device=device)


def s3im_permutations(n: int, repeat_time: int = 10,
                      generator: torch.Generator | None = None,
                      device=None) -> torch.Tensor:
    """(repeat_time - 1, n) random permutations of the ray batch."""
    return torch.stack([torch.randperm(n, generator=generator, device=device)
                        for _ in range(repeat_time - 1)])


def s3im_loss(
    pred: torch.Tensor,     # (R, 3)
    target: torch.Tensor,   # (R, 3)
    perms: torch.Tensor,    # (repeat_time - 1, R) permutations
    kernel_size: int = 4,
    stride: int = 4,
    patch_height: int = 32,
) -> torch.Tensor:
    """Stochastic structural-similarity loss (S3IM).

    Repeats the ray batch ``len(perms) + 1`` times, the identity first and
    then each permutation, reshapes it into a (patch_height x W)
    pseudo-image and returns 1 - SSIM.
    """
    n = pred.shape[0]
    idx = torch.cat([torch.arange(n, device=pred.device),
                     perms.reshape(-1).to(pred.device)])
    tar_patch = target[idx].T.reshape(1, 3, patch_height, -1)
    src_patch = pred[idx].T.reshape(1, 3, patch_height, -1)
    return 1.0 - _ssim(src_patch, tar_patch, kernel_size, stride)


def s3im_loss_whole_batch(pred: torch.Tensor, target: torch.Tensor,
                          perms: torch.Tensor, comm, **kw) -> torch.Tensor:
    """S3IM over the whole batch of a data-parallel step: every rank's
    rays gathered in rank order (``comm``, a
    :class:`~gfnerf_tpu_torch.parallel.comm.Comm`), ``perms`` permuting the
    whole batch, the gradient reaching this rank's own rays alone.  The
    value is the same on every rank, and the sum of the ranks' gradients is
    S3IM's gradient on the whole batch."""
    n = pred.shape[0]
    both = comm.all_gather(torch.cat([pred.detach(), target], dim=1))
    lo, hi = comm.rank * n, (comm.rank + 1) * n
    full = torch.cat([both[:lo, :3], pred, both[hi:, :3]])
    return s3im_loss(full, both[:, 3:], perms, **kw)


def _ssim(img1: torch.Tensor, img2: torch.Tensor, kernel_size: int,
          stride: int) -> torch.Tensor:
    c = img1.shape[1]
    kernel = _gaussian_kernel_on(kernel_size, img1.device)
    weight = kernel[None, None].expand(c, 1, kernel_size, kernel_size)
    pad = (kernel_size - 1) // 2

    def conv(x):   # depthwise: the kernel applied per channel
        return F.conv2d(x, weight, stride=stride, padding=pad, groups=c)

    mu1 = conv(img1)
    mu2 = conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


# (R, Sc, Sf) overlap entries the interlevel loss builds at a time
_OVERLAP_CHUNK = 1 << 25


def interlevel_loss(weights_fine, spacing_starts_fine, spacing_ends_fine,
                    weights_coarse, spacing_starts_coarse,
                    spacing_ends_coarse) -> torch.Tensor:
    """mip-NeRF 360's proposal loss: for each coarse bin, the fine weights
    whose bins overlap it, summed; the coarse weight's shortfall from that
    sum, squared over the coarse weight.  The fine weights and every
    spacing are constants (the JAX package stops their gradients), so the
    overlap sums are built without a graph, a block of rays at a time (the
    whole (R, Sc, Sf) overlap would be 134 M entries at 8192 rays, 256
    coarse and 64 fine bins): the gradient reaches the coarse weights
    alone."""
    with torch.no_grad():
        wf = weights_fine.detach()
        r, sc = weights_coarse.shape
        step = max(1, _OVERLAP_CHUNK // (sc * wf.shape[1]))
        inner = []
        for i in range(0, r, step):
            j = slice(i, i + step)
            overlap = ((spacing_ends_fine[j, None, :]
                        > spacing_starts_coarse[j, :, None])
                       & (spacing_starts_fine[j, None, :]
                          < spacing_ends_coarse[j, :, None]))
            inner.append(torch.sum(wf[j, None, :] * overlap, dim=-1))
        inner = torch.cat(inner)
    w = weights_coarse
    return torch.mean(torch.clamp(inner - w, min=0.0) ** 2 / (w + 1e-7))


def distortion_loss(weights, spacing_starts, spacing_ends) -> torch.Tensor:
    """mip-NeRF 360's distortion regularizer on (R, S) weights and bins."""
    mid = (spacing_starts + spacing_ends) / 2.0
    dist = torch.abs(mid[..., :, None] - mid[..., None, :])
    inter = torch.sum(weights[..., :, None] * weights[..., None, :] * dist,
                      dim=(-1, -2))
    intra = torch.sum(weights ** 2 * (spacing_ends - spacing_starts),
                      dim=-1) / 3.0
    return torch.mean(inter + intra)


def ds_nerf_depth_loss(weights, termination_depth, steps, lengths,
                       sigma: float = 0.01) -> torch.Tensor:
    """DS-NeRF's depth log-likelihood (nerfstudio's DepthLossType.DS_NERF):
    -log(w) under a Gaussian of variance ``sigma`` around each ray's
    ground-truth depth (R, 1), weighted by the bins' ``lengths``; rays
    whose depth is 0 (unknown) add nothing.  ``steps`` (R, S) are the
    bins' midpoints."""
    depth_mask = termination_depth > 0
    loss = -torch.log(weights + 1e-7) * torch.exp(
        -((steps - termination_depth[:, None]) ** 2) / (2 * sigma)
    ) * lengths
    loss = torch.sum(loss, dim=-1) * depth_mask[..., 0]
    return torch.mean(loss)


def scale_and_shift_invariant_depth_loss(prediction, target, mask):
    """MiDaS's scale- and shift-invariant MSE (nerfstudio losses.py:685,
    ``ScaleAndShiftInvariantLoss`` with alpha 0): each image's scale and
    shift solved in closed form, then the masked MSE.  prediction,
    target, mask: (B, H, W)."""
    a00 = torch.sum(mask * prediction * prediction, dim=(1, 2))
    a01 = torch.sum(mask * prediction, dim=(1, 2))
    a11 = torch.sum(mask, dim=(1, 2))
    b0 = torch.sum(mask * prediction * target, dim=(1, 2))
    b1 = torch.sum(mask * target, dim=(1, 2))
    det = a00 * a11 - a01 * a01
    valid = det > 0
    scale = torch.where(valid, (a11 * b0 - a01 * b1) / (det + 1e-12), 0.0)
    shift = torch.where(valid, (-a01 * b0 + a00 * b1) / (det + 1e-12), 0.0)
    pred_ssi = scale[:, None, None] * prediction + shift[:, None, None]
    res = (pred_ssi - target) ** 2 * mask
    return torch.sum(res) / torch.clamp(torch.sum(mask), min=1.0)


def orientation_loss(weights, normals, view_dirs):
    """mip-NeRF 360's orientation regularizer (nerfstudio
    ``orientation_loss``): normals (R, S, 3) facing away from the camera
    along view_dirs (R, 3), weighted by the weights (R, S) taken as
    constants."""
    w = weights.detach()
    n_dot_v = torch.sum(normals * -view_dirs[:, None, :], dim=-1)
    return torch.mean(torch.sum(w * torch.clamp(-n_dot_v, min=0.0) ** 2,
                                dim=-1))


def pred_normal_loss(weights, normals, pred_normals):
    """The predicted normals' agreement with the density-gradient ones
    (nerfstudio ``pred_normal_loss``), weighted by the weights taken as
    constants."""
    w = weights.detach()
    return torch.mean(torch.sum(
        w * (1.0 - torch.sum(normals * pred_normals, dim=-1)), dim=-1))


def tv_edge_loss(field_fn, edge_pts, edge_trans):
    """The TV loss over octree-leaf boundary samples (the reference's
    ``GetEdgeSamples`` mechanism, PersSampler_cuda.cu:479-516): the field
    ``field_fn(points (N, 3), anchors (N,))`` should agree when a boundary
    point is queried through either adjacent warp.  edge_pts (N, 2, 3) and
    edge_trans (N, 2) as ``perssampler.get_edge_samples`` returns them."""
    fa = field_fn(edge_pts[:, 0], edge_trans[:, 0])
    fb = field_fn(edge_pts[:, 1], edge_trans[:, 1])
    return torch.mean((fa - fb) ** 2)
