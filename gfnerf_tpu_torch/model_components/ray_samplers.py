"""The PDF importance sampler of the proposal path.

Port of ``pdf_sample`` from ``gfnerf_tpu/model_components/ray_samplers.py``
(nerfstudio's ``PDFSampler``, ray_samplers.py:220-330).  The JAX package's
spaced and proposal-network samplers serve the other model families and
are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gfnerf_tpu_torch.fields.hash_encoding import _fma


def pdf_sample(spacing_starts: torch.Tensor,   # (R, S_old)
               spacing_ends: torch.Tensor,     # (R, S_old)
               weights: torch.Tensor,          # (R, S_old)
               num_samples: int,
               jitter: Optional[torch.Tensor] = None,
               histogram_padding: float = 0.01):
    """Importance-sample ``num_samples`` new bins from a weight histogram
    over the bins [starts, ends).  Returns (starts, ends), each (R,
    num_samples), without a graph.

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

        lin = torch.as_tensor(
            np.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, dtype=np.float32),
            device=weights.device)[None, :]
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
    return bins[:, :-1], bins[:, 1:]
