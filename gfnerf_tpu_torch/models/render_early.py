"""Two-phase early-termination eval renderer.

Port of ``gfnerf_tpu/models/render_early.py``.  The single-pass render
(``make_render_fn``) evaluates the field on every marched sample of every
ray, but in a converged scene most rays saturate (transmittance ~ 0) long
before the sample budget.  The reference's CUDA renderer leaves its per-ray
march loop when transmittance falls below a threshold; here:

  phase 1  march the full sample lattice once, evaluate the field on the
           FIRST ``s1`` samples of every ray, composite -> per-ray partial
           (rgb, acc, depth) and transmittance T = 1 - acc;
  host     rays with T > eps survive;
  phase 2  the survivors' remaining samples [s1:] are evaluated and
           composited: their tail (rgb, acc, depth);
  compose  out = out1 + T[surv] * out2, depth in weighted-sum space.

Compositing is transmittance-linear (rgb and acc are ``sum_i w_i x_i`` with
``w_i = T_in * alpha_i * prod_{j<i}(1 - alpha_j)``; depth is the normalized
``sum(w t) / (acc + 1e-10)``, so each phase's depth is un-normalized, the
two are summed and the sum is normalized by the total accumulation), and
invalid sample slots carry dists == 0 (alpha == 0): splitting the sample
axis at ``s1`` and scaling the tail by the head's outgoing transmittance
reproduces the single pass for surviving rays; a terminated ray drops a
tail whose total weight is at most eps.

The JAX package pads the survivors to power-of-two buckets, so that its
phase 2 compiles for a few static shapes; PyTorch needs none, so phase 2
runs on exactly the survivors (the padded rays' outputs were never read:
the outputs are the same).  The survivors are counted on the host, one
wait per chunk, as in the JAX package.  Each phase's compaction budget is
scaled to its segment's share of the lattice (``_seg_cfg``): with a budget
below S a phase caps its own segment's samples, which the single pass does
not, so only the dense path (no budget, or one of S) matches the single
pass at eps = 0.  ``remat_chunks`` does not apply (no backward).  The
background must be black (a phase must not add its own background term),
and the proposal branch is refused (render_early.py:106 of the JAX
package): its fine samples are drawn from the whole ray's probe weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gfnerf_tpu_torch.cameras.rays import WarpedSamples
from gfnerf_tpu_torch.models.gfnerf import (RENDER_KEYS, GFNeRFModelConfig,
                                            render_forward, sample_rays)
from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig
from gfnerf_tpu_torch.utils.profiling import span

_PER_RAY = ("num_valid", "first_oct_dis", "num_hits")


def _slice_samples(samples: WarpedSamples, start: int,
                   stop: int) -> WarpedSamples:
    """The samples [start:stop] of every ray (the per-ray fields kept,
    ``num_valid`` recounted)."""
    kw = {f.name: getattr(samples, f.name) for f in dataclasses.fields(
        samples)}
    for name, val in kw.items():
        if val is not None and name not in _PER_RAY:
            kw[name] = val[:, start:stop]
    kw["num_valid"] = kw["valid"].sum(dim=1)
    return WarpedSamples(**kw)


def _gather_samples(samples: WarpedSamples, idx) -> WarpedSamples:
    """The rays ``idx`` of the samples."""
    return WarpedSamples(**{
        f.name: (None if getattr(samples, f.name) is None
                 else getattr(samples, f.name)[idx])
        for f in dataclasses.fields(samples)})


def _seg_cfg(model_cfg: GFNeRFModelConfig, seg: int,
             total: int) -> GFNeRFModelConfig:
    """The model config of a segment of ``seg`` of the ``total`` slots:
    the compaction budget scaled to the segment's share (at least 32, at
    most the segment; the full-ray budget on a partial segment would turn
    compaction off and evaluate the field on invalid slots), no remat."""
    budget = model_cfg.samples_budget_per_ray
    if budget > 0:
        budget = min(max(32, -(-budget * seg // total)), seg)
    return dataclasses.replace(model_cfg, samples_budget_per_ray=budget,
                               remat_chunks=0)


class EarlyTermRenderer:
    """Render ray chunks with early termination.

    ``eps``: transmittance below which a ray counts as terminated after
    phase 1 (its dropped tail weighs less than eps).  ``s1``: the head
    segment's samples (default max(32, S // 4)).  ``last_survivor_frac``:
    the share of the last chunk's rays that survived phase 1."""

    def __init__(self, model_cfg: GFNeRFModelConfig,
                 sampler_cfg: SamplerConfig, s1: Optional[int] = None,
                 eps: float = 5e-3):
        total = sampler_cfg.max_samples
        self.s1 = s1 if s1 is not None else max(32, total // 4)
        if not 0 < self.s1 < total:
            raise ValueError(f"s1={self.s1} must lie in (0, {total})")
        if model_cfg.background_color != "black":
            raise ValueError("early termination composes phases without a "
                             "background: it needs background_color "
                             "'black'")
        if model_cfg.num_proposal_resamples > 0:
            raise ValueError("early-termination rendering does not compose "
                             "with proposal resampling: render with "
                             "make_render_fn")
        self.eps = eps
        self.sampler_cfg = sampler_cfg
        self.cfg1 = _seg_cfg(model_cfg, self.s1, total)
        self.cfg2 = _seg_cfg(model_cfg, total - self.s1, total)
        self.last_survivor_frac: Optional[float] = None

    @torch.no_grad()
    def phase1(self, field, oct_dev, rays_o, rays_d, rel_camera_index,
               active_block=0, stage_is_block: bool = False):
        """(the head's outputs, the marched samples of the whole lattice)."""
        r = rays_o.shape[0]
        noise = torch.ones((r, self.sampler_cfg.max_samples),
                           device=rays_o.device)
        with span("march"):
            samples = sample_rays(oct_dev, rays_o, rays_d, noise, 1.0,
                                  self.sampler_cfg)
        out = render_forward(field, self.cfg1,
                             _slice_samples(samples, 0, self.s1), rays_d,
                             rel_camera_index, oct_dev, active_block,
                             stage_is_block)
        return {k: out[k] for k in RENDER_KEYS}, samples

    @torch.no_grad()
    def phase2(self, field, oct_dev, samples, rays_d, rel_camera_index,
               active_block, idx, stage_is_block: bool = False):
        """The tail's (rgb, accumulation, depth) of the rays ``idx``."""
        def pick(x):
            x = torch.as_tensor(x, device=rays_d.device)
            return x[idx] if x.dim() == 1 else x

        seg = _slice_samples(_gather_samples(samples, idx), self.s1,
                             self.sampler_cfg.max_samples)
        out = render_forward(field, self.cfg2, seg, rays_d[idx],
                             pick(rel_camera_index), oct_dev,
                             (active_block if isinstance(active_block, int)
                              else pick(active_block)), stage_is_block)
        return {k: out[k] for k in ("rgb", "accumulation", "depth")}

    def render_chunk(self, field, oct_dev, rays_o, rays_d, rel_camera_index,
                     active_block=0, stage_is_block: bool = False) -> dict:
        """One chunk: {rgb, accumulation, depth, oct_depth} tensors, as
        ``make_render_fn``'s render_chunk returns them.  A frame renders
        chunk after chunk (the JAX package's ``render_chunks`` queues every
        chunk's phase 1 first, which here would hold every chunk's marched
        samples at once)."""
        out, samples = self.phase1(field, oct_dev, rays_o, rays_d,
                                   rel_camera_index, active_block,
                                   stage_is_block)
        trans = 1.0 - out["accumulation"][:, 0]
        surv = torch.nonzero(trans > self.eps)[:, 0]
        self.last_survivor_frac = surv.shape[0] / rays_d.shape[0]
        if surv.shape[0]:
            out2 = self.phase2(field, oct_dev, samples, rays_d,
                               rel_camera_index, active_block, surv,
                               stage_is_block)
            self._compose(out, surv, trans, out2)
        return out

    @staticmethod
    def _compose(out, surv, trans, out2):
        """out[surv] += the tail scaled by the head's transmittance, in
        place; depth composed in weighted-sum space."""
        t = trans[surv][:, None]
        acc1 = out["accumulation"][surv]
        acc2 = out2["accumulation"]
        # depth is sum(w t) / (acc + 1e-10): un-normalize each phase, sum,
        # re-normalize with the total accumulation
        dsum1 = out["depth"][surv] * (acc1 + 1e-10)
        dsum2 = out2["depth"] * (acc2 + 1e-10)
        acc_tot = acc1 + t * acc2
        out["rgb"][surv] += t * out2["rgb"]
        out["accumulation"][surv] = acc_tot
        out["depth"][surv] = (dsum1 + t * dsum2) / (acc_tot + 1e-10)
        return out
