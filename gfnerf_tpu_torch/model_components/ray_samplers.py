"""Ray samplers: spaced bins, the PDF importance sampler and the
proposal-network sampler.

Port of ``gfnerf_tpu/model_components/ray_samplers.py`` (nerfstudio's
``ray_samplers.py``): ``spaced_sample`` (uniform, linear in disparity,
sqrt or log spacing, :32-200), ``pdf_sample`` (``PDFSampler``, :220-330),
which the GF-NeRF proposal branch and the proposal-network sampler share,
and ``proposal_sample`` (mip-NeRF 360's ``ProposalNetworkSampler``,
:510-601), which the nerfacto family samples with.  The random draws are
passed in as tensors (uniform in [0, 1)), so that tests can hand over the
JAX package's; None means eval (no jitter).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gfnerf_tpu_torch.cameras.rays import get_weights_f2nerf
from gfnerf_tpu_torch.fields.hash_encoding import _fma


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """(1, num) f32 values from 0 to ``stop``, rounded as the JAX package's
    ``jnp.linspace(0, stop, num)`` comes out of XLA, which folds the
    constants of ``stop * (i / (num - 1))``: ``f32(i) * f32(f32(stop) *
    f32(1 / (num - 1)))``, the last one ``stop`` itself."""
    f32 = np.float32
    c = float(f32(stop) * (f32(1.0) / f32(num - 1)))
    vals = torch.arange(num - 1, dtype=torch.float32, device=device) * c
    return torch.cat([vals, vals.new_full((1,), float(f32(stop)))])[None, :]


def pdf_sample(spacing_starts: torch.Tensor,   # (R, S_old)
               spacing_ends: torch.Tensor,     # (R, S_old)
               weights: torch.Tensor,          # (R, S_old)
               num_samples: int,
               jitter: Optional[torch.Tensor] = None,
               histogram_padding: float = 0.01,
               include_original: bool = False):
    """Importance-sample ``num_samples`` new bins from a weight histogram
    over the bins [starts, ends).  Returns (starts, ends), each (R,
    num_samples), without a graph; with ``include_original`` the new edges
    and the old ones sorted together, each (R, num_samples + S_old + 1).

    ``jitter`` (R, num_samples + 1), uniform draws in [0, 1), places each
    new bin edge at random within its stratum (training); None places it
    at the stratum's middle (eval and render).  The stratum's offset is
    added to ``jitter / (num_samples + 1)`` in one rounding, as the JAX
    package's jitted step fuses it.  The bin of each edge is the count of
    CDF values at or below it, a ``searchsorted`` (the CDF is
    monotone)."""
    with torch.no_grad():
        r = weights.shape[0]
        num_bins = num_samples + 1
        weights = weights + histogram_padding
        weights_sum = torch.sum(weights, dim=-1, keepdim=True)
        padding = torch.clamp(1e-5 - weights_sum, min=0.0)
        weights = weights + padding / weights.shape[-1]
        weights_sum = weights_sum + padding

        pdf = weights / weights_sum
        cdf = torch.clamp(torch.cumsum(pdf[:, :-1], dim=-1), max=1.0)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf,
                         torch.ones_like(cdf[:, :1])], dim=-1)  # (R, S+1)

        lin = _linspace(1.0 - 1.0 / num_bins, num_bins, weights.device)
        if jitter is not None:
            u = _fma(jitter.to(weights.device), float(np.float32(
                1.0 / num_bins)), lin)
        else:
            u = (lin + float(np.float32(0.5 / num_bins))).expand(r, num_bins)

        existing_bins = torch.cat([spacing_starts[:, :1], spacing_ends],
                                  dim=-1)   # (R, S_old + 1)
        inds = torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                  right=True)
        last = cdf.shape[-1] - 1
        below = torch.clamp(inds - 1, 0, last)
        above = torch.clamp(inds, 0, last)
        cdf_g0 = torch.gather(cdf, -1, below)
        cdf_g1 = torch.gather(cdf, -1, above)
        bins_g0 = torch.gather(existing_bins, -1, below)
        bins_g1 = torch.gather(existing_bins, -1, above)
        t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0),
                                         nan=0.0), 0.0, 1.0)
        bins = bins_g0 + t * (bins_g1 - bins_g0)
        if include_original:
            bins = torch.sort(torch.cat([bins, existing_bins], dim=-1),
                              dim=-1).values
    return bins[:, :-1], bins[:, 1:]


def spaced_sample(nears: torch.Tensor,       # (R, 1)
                  fars: torch.Tensor,        # (R, 1)
                  num_samples: int,
                  spacing: str = "uniform",  # uniform | lindisp | sqrt | log
                  jitter: Optional[torch.Tensor] = None):
    """``num_samples`` bins between each ray's near and far, evenly spaced
    in the ``spacing`` function of t.  Returns (bin_starts, bin_ends,
    spacing_starts, spacing_ends), each (R, num_samples): t and the
    normalized spacing in [0, 1].

    ``jitter`` (R, num_samples + 1), uniform draws in [0, 1), moves each
    edge at random between the midpoints of its neighbouring bins
    (stratified training samples; the JAX package draws ``uniform - 0.5``
    and adds the 0.5 back, which the port repeats for the same rounding);
    None keeps the even edges."""
    r = nears.shape[0]
    bins = _linspace(1.0, num_samples + 1, nears.device)   # (1, S + 1)
    if jitter is not None:
        centers = (bins[:, 1:] + bins[:, :-1]) / 2.0
        upper = torch.cat([centers, bins[:, -1:]], dim=-1)
        lower = torch.cat([bins[:, :1], centers], dim=-1)
        bins = lower + (upper - lower) * ((jitter.to(nears.device) - 0.5)
                                          + 0.5)
    if spacing == "uniform":
        def fn(x):
            return x
        fn_inv = fn
    elif spacing == "lindisp":
        def fn(x):
            return 1.0 / x
        fn_inv = fn
    elif spacing == "sqrt":
        fn, fn_inv = torch.sqrt, torch.square
    elif spacing == "log":
        fn, fn_inv = torch.log, torch.exp
    else:
        raise ValueError(f"unknown spacing {spacing!r}")
    # bins * far + (1 - bins) * near, the first product contracted into a
    # multiply-add as XLA compiles the JAX package's
    euclid = fn_inv(_fma(bins, fn(fars), (1.0 - bins) * fn(nears)))
    spacing_bins = bins.expand(r, num_samples + 1)
    return (euclid[:, :-1], euclid[:, 1:], spacing_bins[:, :-1],
            spacing_bins[:, 1:])


def proposal_sample(nears: torch.Tensor,          # (R, 1)
                    fars: torch.Tensor,           # (R, 1)
                    density_fns: Sequence[Callable],
                    rays_o: torch.Tensor,         # (R, 3)
                    rays_d: torch.Tensor,         # (R, 3)
                    num_proposal_samples: Sequence[int] = (256,),
                    num_nerf_samples: int = 48,
                    initial_spacing: str = "uniform",
                    anneal: float = 1.0,
                    draws: Optional[List[torch.Tensor]] = None):
    """Hierarchical importance sampling through small density fields
    (``ProposalNetworkSampler``): level 0 spaces ``num_proposal_samples[0]``
    bins in [near, far]; each later level resamples its count from the
    weights of the one before (``pdf_sample``) and the field's samples,
    ``num_nerf_samples`` a ray, come from the last level's weights.  Each
    level's ``density_fns[level]`` maps positions (R, S, 3) to densities
    (R, S), whose compositing weights (``get_weights_f2nerf``) keep their
    graph: the interlevel loss trains the proposal fields through them.
    The normalized spacing maps to t linearly in [near, far] (the JAX
    package's ``spacing_to_t``).

    ``draws``: None (eval: no jitter, each new edge at its stratum's
    middle), or L + 1 uniform tensors in [0, 1) for L levels, in the JAX
    package's key order (``keys = jax.random.split(rng, L + 1)``):
    ``draws[0]`` (R, n_0 + 1) is ``spaced_sample``'s jitter
    (``uniform(keys[0], (R, n_0 + 1))``), ``draws[level]`` (R, n_level +
    1) for level >= 1 ``pdf_sample``'s (``uniform(keys[level], ...)``) and
    ``draws[L]`` (R, num_nerf_samples + 1) the final resample's
    (``keys[-1]``).

    Returns {bin_starts, bin_ends, spacing_starts, spacing_ends} of the
    final bins (R, num_nerf_samples), and "weights_list" and
    "spacing_list", each level's weights and (starts, ends)."""
    n_levels = len(num_proposal_samples)
    if draws is not None and len(draws) != n_levels + 1:
        raise ValueError(f"{len(draws)} draws for {n_levels} levels: "
                         f"{n_levels + 1} expected")

    def draw(i):
        return None if draws is None else draws[i]

    def spacing_to_t(x):
        return x * fars + (1.0 - x) * nears

    weights_list, spacing_list = [], []
    s_starts = s_ends = weights = None
    for level, n in enumerate(num_proposal_samples):
        if level == 0:
            bs, be, s_starts, s_ends = spaced_sample(
                nears, fars, n, initial_spacing, draw(0))
        else:
            s_starts, s_ends = pdf_sample(
                s_starts, s_ends, torch.pow(weights.detach(), anneal), n,
                draw(level))
            bs, be = spacing_to_t(s_starts), spacing_to_t(s_ends)
        mid = (bs + be) / 2.0
        pos = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
        weights = get_weights_f2nerf(be - bs, density_fns[level](pos))[0]
        weights_list.append(weights)
        spacing_list.append((s_starts, s_ends))
    s_starts, s_ends = pdf_sample(s_starts, s_ends,
                                  torch.pow(weights.detach(), anneal),
                                  num_nerf_samples, draw(n_levels))
    return {"bin_starts": spacing_to_t(s_starts),
            "bin_ends": spacing_to_t(s_ends),
            "spacing_starts": s_starts, "spacing_ends": s_ends,
            "weights_list": weights_list, "spacing_list": spacing_list}
