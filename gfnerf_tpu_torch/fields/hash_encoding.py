"""Anchored multi-resolution hash encoding, forward and table gradient.

Port of ``gfnerf_tpu/fields/hash_encoding.py`` (the reference's
``Hash3DAnchored``): the table is ``(n_levels, local_size, n_channels)``,
the hash primes and bias offsets are per (level, volume), and each (point,
level) interpolates the 8 corners of its cell, each found by the hash
``((x*ux) ^ (y*uy) ^ (z*uz)) & (local_size - 1)`` in uint32 arithmetic.

``init_hash_params`` draws the numpy parameters exactly as the JAX package
does; the prime sampling and level scales are shared with the packed
layout.  ``hash_encode_raw`` is the plain PyTorch forward in the form the
JAX package's ``hash_encode_sorted`` runs (the table read through a bf16
copy) and ``hash_backward_reference`` the plain dense table gradient
(``index_add_`` of weight x upstream gradient, in f32; the JAX package's
sort + prefix + run-end-difference backward with its bf16 payload is a TPU
workaround and is not carried over); ``hash_bwd_reductions`` counts the
reductions the table gradient's kernel makes, from the same addressing.
``hash_encode`` is the differentiable
wrapper, with a gradient for the table only: on CPU tensors it runs the
plain pair, on CUDA tensors the forward launches
``csrc/hash_anchored_fwd.cu`` (H4) and the backward
``csrc/hash_anchored_bwd.cu`` (H5), or raises.  ``plain_hash_encode`` is the
same function through the plain pair on any device.  Both take an optional
``base``, another table's encode that this one is a residual of, and return
``base + encode`` (the focal stage's residual sum): on CUDA tensors H4 adds
it as it writes, bit for bit the separate sum; ``in_place`` writes it over
the base.

Coordinates: ``p * scale_l + bias`` is one fused multiply-add in the jitted
JAX encode (XLA contracts it) and a ``floor`` follows, so the plain version
rounds it the same way (``_fma``) and the kernels use ``fmaf``: the corner
indices agree exactly with the jitted JAX encode.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Optional

import numpy as np
import torch

from gfnerf_tpu_torch.ops import build

_U32 = 0xFFFFFFFF
KERNEL_CHANNELS = (2, 4)   # channels the CUDA kernels are instantiated for
N_CHANNELS = 2          # Hash3DAnchored.h:17
N_LEVELS = 16           # Hash3DAnchored.h:18
RES_FINE_POW_2 = 10.0   # Hash3DAnchored.h:20
RES_BASE_POW_2 = 3.0    # Hash3DAnchored.h:22


# the odd primes below 128: trial division by them rejects about 77% of
# odd 30-bit candidates before Miller-Rabin
_SMALL_PRIMES = [p for p in range(3, 128, 2)
                 if all(p % q for q in range(3, int(p ** 0.5) + 1, 2))]


def _is_prime_vec(n: np.ndarray) -> np.ndarray:
    """Deterministic Miller-Rabin for 32-bit ints (bases 2, 7, 61), vectorized;
    the candidates with a small odd factor are rejected first."""
    n = n.astype(np.uint64)
    live = (n % 2 == 1) & (n > 2)
    for p in _SMALL_PRIMES:
        live &= (n % np.uint64(p) != 0) | (n == p)
    res = np.zeros(n.shape, dtype=bool)
    res[live] = _miller_rabin(n[live])
    return res


def _miller_rabin(n: np.ndarray) -> np.ndarray:
    """Miller-Rabin with bases 2, 7 and 61 on odd uint64 n < 2^32."""
    res = np.ones(n.shape, dtype=bool)
    d = (n - 1) >> 1
    r = np.ones_like(n)
    more = (d % 2 == 0)
    while more.any():
        d = np.where(more, d >> 1, d)
        r = np.where(more, r + 1, r)
        more = more & (d % 2 == 0)

    def powmod(base, exp, mod):
        out = np.ones_like(mod)
        b = base % mod
        e = exp.copy()
        while (e > 0).any():
            bit = (e & 1).astype(bool)
            out = np.where(bit, (out * b) % mod, out)
            e = e >> 1
            b = (b * b) % mod
        return out

    for a in (2, 7, 61):
        a_arr = np.full_like(n, a)
        x = powmod(a_arr, d, n)
        ok = (x == 1) | (x == n - 1)
        cur = x.copy()
        for i in range(32):
            cur = (cur * cur) % n
            ok |= (cur == n - 1) & (np.uint64(i + 1) < r)
        res &= ok | (n == a)
    return res


def _random_primes(rng: np.random.Generator, count: int) -> np.ndarray:
    """Random primes in [2^28, 2^30) (Hash3DAnchored.cpp:39-54)."""
    out = np.empty((count,), dtype=np.uint32)
    n = 0
    while n < count:
        cand = rng.integers(1 << 28, 1 << 30, size=max(2 * (count - n), 64),
                            dtype=np.int64)
        cand = cand[_is_prime_vec(cand)]
        take = min(len(cand), count - n)
        out[n:n + take] = cand[:take].astype(np.uint32)
        n += take
    return out


def _level_scales(n_levels: int) -> np.ndarray:
    """Per-level resolution multiplier exp2(3 + 7*l/(L-1)) (_cuda.cu:28)."""
    levels = np.arange(n_levels, dtype=np.float32)
    return np.exp2(
        (RES_FINE_POW_2 - RES_BASE_POW_2) * levels / float(n_levels - 1)
        + RES_BASE_POW_2
    )


def init_hash_params(
    seed: int,
    log2_table_size: int,
    n_volumes: int,
    n_levels: int = N_LEVELS,
    n_channels: int = N_CHANNELS,
    init_mode: str = "reset",
    rand_bias: bool = True,
):
    """(feat_pool, prim_pool, bias_pool) as numpy arrays, drawn in the JAX
    package's order from the same numpy generator.

    feat_pool: (n_levels, local_size, n_channels) f32 — learnable
    prim_pool: (n_levels, n_volumes, 3) uint32 — fixed
    bias_pool: (n_levels, n_volumes, 3) f32 — fixed

    ``init_mode``: "reset" = uniform(-1e-2, 1e-2) (the global table);
    "zero" = zeros (focal residual tables).
    """
    local_size = ((1 << log2_table_size) >> 4) << 4   # Hash3DAnchored.cpp:66
    rng = np.random.default_rng(seed)
    primes = _random_primes(rng, 3 * n_levels * n_volumes).reshape(
        n_levels, n_volumes, 3)
    if rand_bias:
        bias = (rng.random((n_levels, n_volumes, 3)) * 1000.0 + 100.0).astype(
            np.float32)   # Hash3DAnchored.cpp:58
    else:
        bias = np.zeros((n_levels, n_volumes, 3), dtype=np.float32)
    if init_mode == "zero":
        feat = np.zeros((n_levels, local_size, n_channels), dtype=np.float32)
    elif init_mode == "reset":
        feat = rng.uniform(-1e-2, 1e-2, (n_levels, local_size, n_channels)
                           ).astype(np.float32)   # Hash3DAnchored.cpp:172
    else:
        raise ValueError(init_mode)
    return feat, primes, bias


def _fma(a: torch.Tensor, s, b: torch.Tensor) -> torch.Tensor:
    """a * s + b rounded once to f32, as a fused multiply-add rounds it; s
    a float or a tensor."""
    s = s.double() if isinstance(s, torch.Tensor) else float(s)
    return (a.double() * s + b.double()).float()


def _level_cells(points, bias_l, scale):
    """Per axis, each point's cell at one level: (lower corner (P,) int64
    holding uint32 bits, fraction (P,) f32).  bias_l (P, 3) is each
    point's bias."""
    cells = []
    for a in range(3):
        pt = _fma(points[:, a], scale, bias_l[:, a])
        x0f = torch.floor(pt)
        cells.append((x0f.to(torch.int32).long() & _U32, pt - x0f))
    return cells


def _level_corners(points, prim_l, bias_l, scale, local_size):
    """The 8 corners of one level: a list of (index (P,) int64, weight (P,)
    f32) in the JAX encode's order, x outermost and z innermost
    (hash_encoding.py:242-262).  prim_l (P, 3) int64 and bias_l (P, 3) are
    each point's primes and biases."""
    per_axis = []
    for a, (x0, f) in enumerate(_level_cells(points, bias_l, scale)):
        u = prim_l[:, a]
        per_axis.append((((x0 * u) & _U32, 1.0 - f),
                         ((((x0 + 1) & _U32) * u) & _U32, f)))
    corners = []
    for (hx, wx), (hy, wy), (hz, wz) in itertools.product(*per_axis):
        corners.append(((hx ^ hy ^ hz) & (local_size - 1), wx * wy * wz))
    return corners


def _anchor_rows(prim_pool, bias_pool, anchors):
    """Each point's clamped volume's primes (L, P, 3) int64 and biases
    (L, P, 3)."""
    vol = anchors.long().clamp(0, prim_pool.shape[1] - 1)
    return prim_pool.long()[:, vol], bias_pool[:, vol]


def _check_table(local_size: int) -> None:
    if local_size & (local_size - 1):
        raise ValueError(f"local_size {local_size} is not a power of two")


def hash_corner_indices(prim_pool, bias_pool, points, anchors,
                        local_size: int) -> torch.Tensor:
    """(L, 8, P) int64 table entry of every (level, corner, point) — the
    addressing half of the encode, exposed for tests."""
    _check_table(local_size)
    prims, biases = _anchor_rows(prim_pool, bias_pool, anchors)
    scales = _level_scales(prim_pool.shape[0])
    return torch.stack([
        torch.stack([idx for idx, _ in _level_corners(
            points, prims[l], biases[l], scales[l], local_size)])
        for l in range(prim_pool.shape[0])])


def hash_encode_raw(
    feat_pool: torch.Tensor,   # (L, local_size, C) f32
    prim_pool: torch.Tensor,   # (L, V, 3) int64 (uint32 values)
    bias_pool: torch.Tensor,   # (L, V, 3) f32
    points: torch.Tensor,      # (P, 3) f32, normalized ((warp+1.5)/3)
    anchors: torch.Tensor,     # (P,) volume index; < 0 -> masked output
    base: Optional[torch.Tensor] = None,   # (P, L * C) f32
) -> torch.Tensor:
    """Plain forward anchored encoding. Returns (P, L * C) f32, laid out
    ``out[:, level * C + c]``, added to ``base`` if one is given (the
    residual sum of two encodes).

    Reads the table through a bf16 copy, as ``hash_encode_sorted``'s forward
    does for even C (hash_encoding.py:224-232, :365-367)."""
    n_levels, local_size, n_channels = feat_pool.shape
    _check_table(local_size)
    valid = (anchors >= 0).to(torch.float32)[:, None]
    prims, biases = _anchor_rows(prim_pool, bias_pool, anchors)
    scales = _level_scales(n_levels)
    flat = feat_pool.to(torch.bfloat16).reshape(n_levels * local_size,
                                                n_channels)
    cols = []
    for l in range(n_levels):
        acc = torch.zeros((points.shape[0], n_channels), dtype=torch.float32,
                          device=points.device)
        for idx, w in _level_corners(points, prims[l], biases[l], scales[l],
                                     local_size):
            acc = acc + w[:, None] * flat[idx + l * local_size].float()
        cols.append(acc * valid)
    out = torch.cat(cols, dim=-1)
    return out if base is None else base + out


def hash_scatter_terms(g, prim_pool, bias_pool, points, anchors,
                       local_size: int, n_channels: int):
    """The table gradient's terms, one (rows, payload) pair per (level,
    corner): ``rows`` (P,) indexes the gradient viewed as (L * local_size,
    C), and ``payload`` (P, C) is the corner's weight times the point's
    upstream gradient; points with anchor < 0 add zeros."""
    _check_table(local_size)
    n_levels = prim_pool.shape[0]
    p = points.shape[0]
    valid = (anchors >= 0).to(torch.float32)
    g = g.reshape(p, n_levels, n_channels).to(torch.float32) \
        * valid[:, None, None]
    prims, biases = _anchor_rows(prim_pool, bias_pool, anchors)
    scales = _level_scales(n_levels)
    for l in range(n_levels):
        for idx, w in _level_corners(points, prims[l], biases[l], scales[l],
                                     local_size):
            yield idx + l * local_size, w[:, None] * g[:, l]


def hash_backward_reference(g, prim_pool, bias_pool, points, anchors,
                            local_size: int, n_channels: int):
    """Plain dense table gradient (L, local_size, C) f32 of the encode:
    every term of :func:`hash_scatter_terms` added with ``index_add_``."""
    n_levels = prim_pool.shape[0]
    grad = torch.zeros((n_levels * local_size, n_channels),
                       dtype=torch.float32, device=g.device)
    for rows, payload in hash_scatter_terms(g, prim_pool, bias_pool, points,
                                            anchors, local_size, n_channels):
        grad.index_add_(0, rows, payload)
    return grad.view(n_levels, local_size, n_channels)


def hash_bwd_reductions(prim_pool, bias_pool, points, anchors,
                        warp: int = 32) -> torch.Tensor:
    """(L,) int64: the vector reductions the table-gradient kernel (H5)
    makes per level.  Its warps take ``warp`` consecutive points from a
    multiple of ``warp`` on, at one level; a run of consecutive valid
    points in one cell, that is with equal (clamped volume, x0, y0, z0), is
    one contributor, which adds its 8 corners with one reduction each.  A
    masked point ends a run and adds nothing; equal cells of two volumes
    (other primes) are two runs."""
    n_levels = prim_pool.shape[0]
    valid = anchors >= 0
    vol = anchors.long().clamp(0, prim_pool.shape[1] - 1)
    biases = bias_pool[:, vol]
    scales = _level_scales(n_levels)
    first = torch.arange(points.shape[0], device=points.device) % warp == 0
    ops = []
    for l in range(n_levels):
        key = torch.stack([vol, *(x0 for x0, _ in _level_cells(
            points, biases[l], scales[l]))], -1)
        same = torch.zeros_like(valid)
        same[1:] = (key[1:] == key[:-1]).all(-1) & valid[:-1]
        ops.append(8 * (valid & (first | ~same)).sum())
    return torch.stack(ops)


def check_base(what, base, points, n_cols, in_place):
    """The base (P, n_cols) f32 an encode is added to, as the kernels and
    the plain versions take it: on the points' device, without a gradient
    (the sum's graph carries the encode's table alone), contiguous (copied
    if not, which writing in place cannot be)."""
    if base is None:
        if in_place:
            raise ValueError(f"{what}: in_place needs a base")
        return None
    if base.requires_grad:
        raise ValueError(f"{what}: the base must not require a gradient")
    if (base.shape != (points.shape[0], n_cols)
            or base.dtype != torch.float32 or base.device != points.device):
        raise ValueError(
            f"{what}: base must be ({points.shape[0]}, {n_cols}) f32 on "
            f"{points.device}, got {tuple(base.shape)} {base.dtype} on "
            f"{base.device}")
    if not base.is_contiguous():
        if in_place:
            raise ValueError(f"{what}: a base written in place must be "
                             f"contiguous")
        base = base.contiguous()
    return base


class _HashEncode(torch.autograd.Function):
    """H4 forward and H5 table gradient on CUDA tensors; the plain pair on
    CPU tensors or when ``plain`` is set.  No gradient flows to the points,
    primes, biases, anchors (``_hes_bwd`` returns None for them) or the base
    (a constant of the sum)."""

    @staticmethod
    def forward(ctx, feat_pool, prim_pool, bias_pool, points, anchors, base,
                plain, in_place):
        ctx.save_for_backward(prim_pool, bias_pool, points, anchors)
        ctx.table_shape = tuple(feat_pool.shape)
        ctx.plain = plain or points.device.type == "cpu"
        args = (feat_pool, prim_pool, bias_pool, points, anchors)
        if in_place:
            ctx.mark_dirty(base)
        if ctx.plain:
            if in_place:
                return base.add_(hash_encode_raw(*args))
            return hash_encode_raw(*args, base=base)
        return _hash_encode_cuda(*args, base=base, in_place=in_place)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 8
        prim_pool, bias_pool, points, anchors = ctx.saved_tensors
        _, local_size, n_channels = ctx.table_shape
        args = (g, prim_pool, bias_pool, points, anchors, local_size,
                n_channels)
        if ctx.plain:
            grad = hash_backward_reference(*args)
        else:
            grad = _hash_backward_cuda(*args)
        return (grad,) + (None,) * 7


def _apply_encode(plain, feat_pool, prim_pool, bias_pool, points, anchors,
                  base, in_place):
    base = check_base("hash_encode", base, points,
                      feat_pool.shape[0] * feat_pool.shape[2], in_place)
    return _HashEncode.apply(feat_pool, prim_pool, bias_pool, points, anchors,
                             base, plain, in_place)


def hash_encode(feat_pool, prim_pool, bias_pool, points, anchors,
                base: Optional[torch.Tensor] = None, in_place: bool = False):
    """Anchored encoding (P, L * C), differentiable in ``feat_pool``: the
    plain pair for CPU tensors, the CUDA kernels (``csrc/
    hash_anchored_fwd.cu``, ``csrc/hash_anchored_bwd.cu``) for CUDA
    tensors.

    With ``base`` (P, L * C) f32, another table's encode that this one is a
    residual of, the result is ``base + encode``, bit for bit (on CUDA
    tensors the kernel's write-back adds it: no separate pass); the table's
    gradient is the same with or without it.  The base must not require a
    gradient.  With ``in_place`` the sum is written into ``base``, which is
    returned."""
    return _apply_encode(False, feat_pool, prim_pool, bias_pool, points,
                         anchors, base, in_place)


def plain_hash_encode(feat_pool, prim_pool, bias_pool, points, anchors,
                      base: Optional[torch.Tensor] = None,
                      in_place: bool = False):
    """``hash_encode`` through the plain forward and backward on any device
    (launches no kernel)."""
    return _apply_encode(True, feat_pool, prim_pool, bias_pool, points,
                         anchors, base, in_place)


hash_encode.calls = 0          # H4 calls, one per forward
hash_encode.base_calls = 0     # of those, calls given a base
hash_encode.launches = 0       # H4 launches (one per group of levels)
hash_encode.bwd_launches = 0   # H5 launches (one per group of levels)
hash_encode.bwd_calls = 0      # H5 calls, one per backward

# H4's levels per launch when the caller does not set them (kLevelGroup of
# csrc/hash_anchored_fwd.cu); H5's are 8 / C (csrc/hash_anchored_bwd.cu)
FWD_LEVEL_GROUP = 4


def encode_launches(n_levels: int, per_launch: int = 0) -> int:
    """H4's launches for one call at ``per_launch`` levels a launch (0: the
    kernel's own choice)."""
    group = per_launch if per_launch > 0 else FWD_LEVEL_GROUP
    return -(-n_levels // min(group, n_levels))


def table_grad_launches(n_levels: int, n_channels: int,
                        per_launch: int = 0) -> int:
    """H5's launches for one call (one per group of levels; 0: the
    kernel's own choice)."""
    group = per_launch if per_launch > 0 else max(1, 8 // n_channels)
    return -(-n_levels // min(group, n_levels))


@functools.lru_cache(maxsize=32)
def _device_scales(n_levels, dev):
    """The level scales (L,) f32 on ``dev``, built once: a copy from host
    memory would otherwise wait for the stream to drain at every launch."""
    return torch.as_tensor(_level_scales(n_levels), device=dev)


def _kernel_args(what, prim_pool, bias_pool, points, anchors, local_size,
                 n_channels, tensors):
    """Check what both kernels take and return the device tensors of the
    addressing: (primes i32, bias, scales, points, anchors i32)."""
    n_levels = prim_pool.shape[0]
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if n_channels not in KERNEL_CHANNELS:
        raise ValueError(f"{what}: no kernel for {n_channels} channels "
                         f"(have {KERNEL_CHANNELS})")
    _check_table(local_size)
    if prim_pool.shape != bias_pool.shape or prim_pool.dim() != 3 \
            or prim_pool.shape[2] != 3:
        raise ValueError(f"{what}: primes {tuple(prim_pool.shape)} and "
                         f"biases {tuple(bias_pool.shape)} are not (L, V, 3)")
    for name, t in (("prim_pool", prim_pool), ("bias_pool", bias_pool),
                    ("anchors", anchors), *tensors):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, points on {dev}")
    if (points.dim() != 2 or points.shape[1] != 3
            or points.dtype != torch.float32):
        raise ValueError(f"{what}: points must be (P, 3) f32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if anchors.shape != (points.shape[0],):
        raise ValueError(f"{what}: anchors {tuple(anchors.shape)} != "
                         f"({points.shape[0]},)")
    return (prim_pool.to(torch.int32).contiguous(),   # values < 2^30
            bias_pool.to(torch.float32).contiguous(),
            _device_scales(n_levels, dev), points.contiguous(),
            anchors.to(torch.int32).contiguous())


def _hash_encode_cuda(feat_pool, prim_pool, bias_pool, points, anchors,
                      base=None, in_place=False, levels_per_launch=0):
    """H4 on CUDA tensors: (P, L * C).  The kernel reads an f32 table and
    rounds each value to bf16 as it reads it, the values of the bf16 copy
    the plain version reads; a bf16 table it reads as it is.  With ``base``
    (checked by the caller, :func:`check_base`) the kernel writes ``base +
    encode``, over the base with ``in_place``.  ``levels_per_launch`` > 0
    sets the levels each of the kernel's launches covers (0: its own
    choice)."""
    n_levels, local_size, n_channels = feat_pool.shape
    if prim_pool.shape[0] != n_levels:
        raise ValueError(f"hash_encode: table of {n_levels} levels, primes "
                         f"of {prim_pool.shape[0]}")
    if feat_pool.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hash_encode: the table must be f32 or bf16, got "
                         f"{feat_pool.dtype}")
    addr = _kernel_args("hash_encode", prim_pool, bias_pool, points, anchors,
                        local_size, n_channels, [("feat_pool", feat_pool)])
    table = feat_pool.detach().contiguous()
    p = points.shape[0]
    out = base if in_place else torch.empty(
        (p, n_levels * n_channels), dtype=torch.float32, device=points.device)
    launches = ctypes.c_int(0)
    err = build.library().gfnerf_hash_anchored_fwd(
        table.data_ptr(), int(table.dtype == torch.bfloat16),
        *(t.data_ptr() for t in addr),
        None if base is None else base.data_ptr(), out.data_ptr(),
        ctypes.addressof(launches), p, n_levels, prim_pool.shape[1],
        local_size, n_channels, levels_per_launch,
        torch.cuda.current_stream(points.device).cuda_stream)
    build.check(err, "gfnerf_hash_anchored_fwd")
    hash_encode.calls += 1
    hash_encode.base_calls += base is not None
    hash_encode.launches += launches.value
    return out


def _hash_backward_cuda(g, prim_pool, bias_pool, points, anchors, local_size,
                        n_channels, red_ops=None, levels_per_launch=0):
    """H5 on CUDA tensors: the (L, local_size, C) table gradient.
    ``red_ops``, an (L,) int64 tensor on the card, if given, gets the
    number of vector reductions the kernel made per level added to it.
    ``levels_per_launch`` > 0 sets the levels each of the kernel's launches
    covers (0: its own choice)."""
    n_levels = prim_pool.shape[0]
    p = points.shape[0]
    if g.shape != (p, n_levels * n_channels):
        raise ValueError(f"hash_encode backward: gradient {tuple(g.shape)} "
                         f"!= ({p}, {n_levels * n_channels})")
    if red_ops is not None and (red_ops.shape != (n_levels,)
                                or red_ops.dtype != torch.int64
                                or red_ops.device != points.device):
        raise ValueError(f"hash_encode backward: red_ops must be "
                         f"({n_levels},) int64 on {points.device}")
    addr = _kernel_args("hash_encode backward", prim_pool, bias_pool, points,
                        anchors, local_size, n_channels, [("gradient", g)])
    gc = g.to(torch.float32).contiguous()
    grad = torch.empty((n_levels, local_size, n_channels),
                       dtype=torch.float32, device=points.device)
    launches = ctypes.c_int(0)
    err = build.library().gfnerf_hash_anchored_bwd(
        gc.data_ptr(), *(t.data_ptr() for t in addr), grad.data_ptr(),
        None if red_ops is None else red_ops.data_ptr(),
        ctypes.addressof(launches), p, n_levels, prim_pool.shape[1],
        local_size, n_channels, levels_per_launch,
        torch.cuda.current_stream(points.device).cuda_stream)
    build.check(err, "gfnerf_hash_anchored_bwd")
    hash_encode.bwd_calls += 1
    hash_encode.bwd_launches += launches.value
    return grad
