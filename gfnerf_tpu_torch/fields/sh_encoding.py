"""Spherical-harmonics direction encoding (degree 4, 16 coefficients).

Port of ``gfnerf_tpu/fields/sh_encoding.py`` (tcnn SphericalHarmonics,
evaluated directly on the unit direction).
"""

from __future__ import annotations

import torch


def sh_encode_deg4(directions: torch.Tensor) -> torch.Tensor:
    """Real SH basis up to l=3 at unit directions. (..., 3) -> (..., 16)."""
    x = directions[..., 0]
    y = directions[..., 1]
    z = directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),           # l=0
            -0.48860251190291987 * y,                          # l=1
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,                           # l=2
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
            0.59004358992664352 * y * (-3.0 * xx + yy),        # l=3
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        dim=-1,
    )
