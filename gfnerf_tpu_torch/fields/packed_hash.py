"""Packed (supercell) anchored hash encoding, forward and table gradient.

Port of ``gfnerf_tpu/fields/packed_hash.py``: the table is keyed by
*supercell* (a cube of ``pack``^3 grid cells) and each row holds the feature
vectors of the supercell's whole ``(pack+1)^3`` corner lattice, padded to
``row_width``.  One row per (point, level) serves every corner of the
trilinear interpolation.

``packed_hash_encode_raw`` is the plain PyTorch forward (the JAX package's
XLA formulation, op for op) and ``packed_hash_backward_reference`` the plain
dense table gradient (what the JAX package's ``_phe_bwd`` computes, its f32
terms summed exactly in int64 fixed point, so that the result does not
depend on the order of the sum: ``hash_encoding.fixed_point_table_grad``);
``packed_hash_bwd_records`` builds, plainly, the rows' records that the
table gradient's kernel sums (its count, scan and scatter passes), and
``packed_hash_bwd_reductions`` counts the atomics the kernel issues, from
the same addressing.  ``packed_hash_encode``
is the differentiable wrapper, with a gradient for the table only, as
``_phe_bwd`` has: on CPU tensors it runs the plain pair, on CUDA tensors
the forward launches ``csrc/packed_hash_fwd.cu`` (H1) and the backward
``csrc/packed_hash_bwd.cu`` (H2), or raises.  ``plain_packed_hash_encode``
is the same function through the plain pair on any device.

``packed_hash_encode_routed`` is the block-routed encode of the eval path
(forward only): stacked tables ``(B, L, rows, W)``, primes and biases
``(B, L, V, 3)`` and a block per point.  ``packed_hash_encode_routed_raw`` is
its plain version; on CUDA tensors the wrapper launches
``csrc/packed_hash_routed.cu`` (H3), or raises.

Both encodes take an optional ``base``, another table's encode that theirs
is a residual of, and return ``base + encode`` (the focal stage's sum of
the global and the block's features): the kernels add it in their
write-back, the result rounded first, so it equals the separate sum bit for
bit; ``in_place`` writes it over the base.

Coordinates: the grid coordinate of level l is ``p * scale_l + bias``, which
XLA contracts into one fused multiply-add in the jitted JAX encode.  The
plain version rounds it the same way by computing in float64 (the product is
exact there) and rounding once; the CUDA kernel uses ``fmaf``.  Supercell
decomposition, and with it the hash row, then agrees bit for bit with the
jitted JAX encode.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Optional

import numpy as np
import torch

from gfnerf_tpu_torch.fields.hash_encoding import (_fma, _level_scales,
                                                   _random_primes, check_base,
                                                   fixed_point_table_grad)
from gfnerf_tpu_torch.ops import build

_U32 = 0xFFFFFFFF
# (lattice edge, channels) the CUDA kernel is instantiated for
KERNEL_SHAPES = ((2, 8), (3, 4), (4, 2))


def pack_for_channels(n_channels: int, row_width: int = 128) -> int:
    """Largest supercell edge whose corner lattice fits in ``row_width``."""
    pack = 1
    while (pack + 2) ** 3 * n_channels <= row_width:
        pack += 1
    return pack


def init_packed_hash_params(
    seed: int,
    n_rows_log2: int,
    n_volumes: int,
    n_levels: int,
    n_channels: int,
    row_width: int = 128,
    init_mode: str = "reset",
    rand_bias: bool = True,
):
    """(feat_pool, prim_pool, bias_pool) as numpy arrays, drawn in the JAX
    package's order from the same numpy generator.

    feat_pool: (n_levels, n_rows, row_width) f32 — learnable
    prim_pool: (n_levels, n_volumes, 3) uint32 — fixed
    bias_pool: (n_levels, n_volumes, 3) f32 — fixed
    """
    pack = pack_for_channels(n_channels, row_width)
    if (pack + 1) ** 3 * n_channels > row_width:
        raise ValueError(f"{n_channels} channels do not fit row width "
                         f"{row_width}")
    n_rows = 1 << n_rows_log2
    rng = np.random.default_rng(seed)
    primes = _random_primes(rng, 3 * n_levels * n_volumes).reshape(
        n_levels, n_volumes, 3)
    if rand_bias:
        bias = (rng.random((n_levels, n_volumes, 3)) * 1000.0 + 100.0).astype(
            np.float32)
    else:
        bias = np.zeros((n_levels, n_volumes, 3), dtype=np.float32)
    if init_mode == "zero":
        feat = np.zeros((n_levels, n_rows, row_width), dtype=np.float32)
    elif init_mode == "reset":
        feat = rng.uniform(-1e-2, 1e-2, (n_levels, n_rows, row_width)).astype(
            np.float32)
    else:
        raise ValueError(init_mode)
    return feat, primes, bias


def dense_level_extents(n_levels, pack, n_volumes, n_rows, dense_levels):
    """Per-level dense-grid extents for collision-free addressing.

    Returns (m (L,) int32, use (L,) bool): level l is addressed linearly,
    ``vol*m^3 + (sx%m)*m^2 + (sy%m)*m + sz%m``, when it is among the first
    ``dense_levels`` and ``V * m^3 <= n_rows``; other levels keep the hash.
    """
    scales = _level_scales(n_levels)
    m = np.zeros((n_levels,), np.int32)
    use = np.zeros((n_levels,), bool)
    for l in range(min(dense_levels, n_levels)):
        ml = int(np.ceil(scales[l] / pack)) + 2
        if n_volumes * ml ** 3 <= n_rows:
            m[l] = ml
            use[l] = True
    return m, use


def _div_pack(cell: torch.Tensor, pack: int) -> torch.Tensor:
    """floor(cell / pack) computed as the JAX encode computes it on int32
    cells: logical shift for powers of two, multiply-shift for 3."""
    c = cell.long()
    if pack & (pack - 1) == 0:
        return (c & _U32) >> (pack.bit_length() - 1)
    if pack == 3:
        return ((c * 21846) & _U32) >> 16
    return torch.div(c, pack, rounding_mode="floor")


def _decompose_dim(pk: torch.Tensor, pack: int):
    """(supercell, local cell, fraction) of one coordinate (P,)."""
    cell_f = torch.floor(pk)
    frac = pk - cell_f
    cell = cell_f.to(torch.int32)
    sup = _div_pack(cell, pack)
    local = (cell.long() - sup * pack).to(torch.int32).long()  # int32 wrap
    return sup, local, frac


def _hash_flat(sx, sy, sz, ux, uy, uz, n_rows):
    """Supercell XOR hash in uint32 arithmetic, carried in int64."""
    h = (((sx & _U32) * ux) & _U32) ^ (((sy & _U32) * uy) & _U32) \
        ^ (((sz & _U32) * uz) & _U32)
    return h & (n_rows - 1)


def _level_coords(points, prim_l, bias_l, scale, vol, pack, n_rows, m_l):
    """Row index (P,) int64 and per-axis (local, fraction) of one level."""
    s, loc, frac = zip(*[
        _decompose_dim(_fma(points[:, a], scale, bias_l[:, a]), pack)
        for a in range(3)])
    if m_l > 0:
        h = (vol * m_l ** 3 + torch.remainder(s[0], m_l) * m_l * m_l
             + torch.remainder(s[1], m_l) * m_l
             + torch.remainder(s[2], m_l)).clamp(max=n_rows - 1)
    else:
        h = _hash_flat(s[0], s[1], s[2], prim_l[:, 0], prim_l[:, 1],
                       prim_l[:, 2], n_rows)
    return h, loc, frac


def _anchor_rows(prim_pool, bias_pool, anchors):
    """Per-level primes (L, P, 3) int64 and biases (L, P, 3) of each
    point's clamped volume."""
    n_volumes = prim_pool.shape[1]
    vol = anchors.long().clamp(0, n_volumes - 1)
    return vol, prim_pool.long()[:, vol], bias_pool[:, vol]


def packed_hash_rows(prim_pool, bias_pool, points, anchors, n_rows, pack,
                     dense_levels=0) -> torch.Tensor:
    """(L, P) int64 table row of every (level, point) — the addressing half
    of the encode, exposed for tests."""
    n_levels, n_volumes = prim_pool.shape[:2]
    vol, prims, biases = _anchor_rows(prim_pool, bias_pool, anchors)
    scales = _level_scales(n_levels)
    dm, _ = dense_level_extents(n_levels, pack, n_volumes, n_rows,
                                dense_levels)
    return torch.stack([
        _level_coords(points, prims[l], biases[l], scales[l], vol, pack,
                      n_rows, int(dm[l]))[0]
        for l in range(n_levels)])


def packed_hash_encode_raw(
    feat_pool: torch.Tensor,   # (L, n_rows, row_width) f32
    prim_pool: torch.Tensor,   # (L, V, 3) int64 (uint32 values)
    bias_pool: torch.Tensor,   # (L, V, 3) f32
    points: torch.Tensor,      # (P, 3) f32, normalized ((warp+1.5)/3)
    anchors: torch.Tensor,     # (P,) volume index; < 0 -> masked output
    n_channels: int,
    pack: int,
    dense_levels: int = 0,
    base: Optional[torch.Tensor] = None,   # (P, L * n_channels) f32
) -> torch.Tensor:
    """Plain forward packed encoding. Returns (P, L * n_channels) f32, added
    to ``base`` if one is given (the residual sum of two encodes).

    Reads the table through a bf16 copy, as the JAX encode does
    (packed_hash.py:235).
    """
    n_levels, n_rows, row_width = feat_pool.shape
    n_volumes = prim_pool.shape[1]
    e = pack + 1
    valid = (anchors >= 0)[:, None]
    vol, prims, biases = _anchor_rows(prim_pool, bias_pool, anchors)
    scales = _level_scales(n_levels)
    dm, _ = dense_level_extents(n_levels, pack, n_volumes, n_rows,
                                dense_levels)
    flat = feat_pool.to(torch.bfloat16).reshape(n_levels * n_rows, row_width)
    outs = []
    for l in range(n_levels):
        h, loc, frac = _level_coords(points, prims[l], biases[l], scales[l],
                                     vol, pack, n_rows, int(dm[l]))
        rows = flat[h + l * n_rows]                   # (P, row_width) bf16
        outs.extend(_interp_level(rows, *frac, *loc, e, n_channels))
    out = torch.stack(outs, dim=-1) * valid
    return out if base is None else base + out


def packed_hash_encode_routed_raw(
    block_feats: torch.Tensor,   # (B, L, n_rows, row_width) f32 or bf16
    block_prims: torch.Tensor,   # (B, L, V, 3) int64 (uint32 values)
    block_biases: torch.Tensor,  # (B, L, V, 3) f32
    points: torch.Tensor,        # (P, 3) f32
    anchors: torch.Tensor,       # (P,) volume index; < 0 -> masked output
    blocks: torch.Tensor,        # (P,) block index; < 0 -> masked output
    n_channels: int,
    pack: int,
    dense_levels: int = 0,
    base: Optional[torch.Tensor] = None,   # (P, L * n_channels) f32
) -> torch.Tensor:
    """Plain block-routed forward (packed_hash.py:336-393 of the JAX
    package): each point reads the table of its own block, with that
    block's primes and biases.  Returns (P, L * n_channels) f32, zero where
    the anchor or the block is < 0; a block past the last is clipped to it;
    added to ``base`` if one is given (the global encode the routed one is
    a residual of, field.py:407-413 of the JAX package).
    """
    n_blocks, n_levels, n_rows, row_width = block_feats.shape
    n_volumes = block_prims.shape[2]
    e = pack + 1
    valid = ((anchors >= 0) & (blocks >= 0))[:, None]
    vol = anchors.long().clamp(0, n_volumes - 1)
    blk = blocks.long().clamp(0, n_blocks - 1)
    prims = block_prims.long()[blk, :, vol]       # (P, L, 3)
    biases = block_biases[blk, :, vol]
    scales = _level_scales(n_levels)
    dm, _ = dense_level_extents(n_levels, pack, n_volumes, n_rows,
                                dense_levels)
    flat = block_feats.to(torch.bfloat16).reshape(
        n_blocks * n_levels * n_rows, row_width)
    row_base = blk * (n_levels * n_rows)
    outs = []
    for l in range(n_levels):
        h, loc, frac = _level_coords(points, prims[:, l], biases[:, l],
                                     scales[l], vol, pack, n_rows, int(dm[l]))
        rows = flat[row_base + l * n_rows + h]        # (P, row_width) bf16
        outs.extend(_interp_level(rows, *frac, *loc, e, n_channels))
    out = torch.stack(outs, dim=-1) * valid
    return out if base is None else base + out


def _interp_level(rows, fx, fy, fz, lx, ly, lz, e, n_channels):
    """Per-level lattice interpolation from gathered (P, row_width) rows.

    Returns a list of ``n_channels`` (P,) f32 columns.  e == 2: the 8
    lattice entries are the 8 corners (a 7-lerp chain per channel); e >= 3:
    the trilinear sum factorized per axis with weights
    w_u = (u == l)(1-f) + (u == l+1)f.
    """
    C = n_channels

    def col(o, c):
        return rows[:, o * C + c].float()

    if e == 2:
        chans = []
        for c in range(C):
            z00 = col(0, c) + fz * (col(1, c) - col(0, c))
            z01 = col(2, c) + fz * (col(3, c) - col(2, c))
            z10 = col(4, c) + fz * (col(5, c) - col(4, c))
            z11 = col(6, c) + fz * (col(7, c) - col(6, c))
            y0 = z00 + fy * (z01 - z00)
            y1 = z10 + fy * (z11 - z10)
            chans.append(y0 + fx * (y1 - y0))
        return chans

    def dim_w(local, frac, u):
        return ((local == u).float() * (1.0 - frac)
                + (local + 1 == u).float() * frac)

    wx = [dim_w(lx, fx, i) for i in range(e)]
    wy = [dim_w(ly, fy, j) for j in range(e)]
    wz = [dim_w(lz, fz, k) for k in range(e)]
    chans = []
    for c in range(C):
        out = None
        for i in range(e):
            acc_y = None
            for j in range(e):
                base = (i * e + j) * e
                acc_z = None
                for k in range(e):
                    term = wz[k] * col(base + k, c)
                    acc_z = term if acc_z is None else acc_z + term
                term = wy[j] * acc_z
                acc_y = term if acc_y is None else acc_y + term
            term = wx[i] * acc_y
            out = term if out is None else out + term
        chans.append(out)
    return chans


def packed_hash_scatter_terms(g, prim_pool, bias_pool, points, anchors,
                              n_rows, row_width, n_channels, pack,
                              dense_levels=0):
    """The table gradient's terms, one (rows, payload) pair per (level,
    corner): ``rows`` (P,) indexes the gradient viewed as
    (L * n_rows * row_width / C, C) rows of C channels, and ``payload``
    (P, C) is the corner's trilinear weight ``(wx * wy) * wz`` times the
    point's upstream gradient.  The row and the per-axis (local cell,
    fraction) are recomputed exactly as the forward computes them.  Lattice
    entries outside the cell have weight exactly 0 (``_lattice_weights``)
    and are not among the terms; points with anchor < 0 add zeros."""
    n_levels, n_volumes = prim_pool.shape[:2]
    C = n_channels
    if row_width % C:
        raise ValueError(f"row width {row_width} is not a multiple of {C} "
                         f"channels")
    e = pack + 1
    p = points.shape[0]
    valid = (anchors >= 0).to(torch.float32)
    g = g.reshape(p, n_levels, C).to(torch.float32) * valid[:, None, None]
    vol, prims, biases = _anchor_rows(prim_pool, bias_pool, anchors)
    scales = _level_scales(n_levels)
    dm, _ = dense_level_extents(n_levels, pack, n_volumes, n_rows,
                                dense_levels)
    for l in range(n_levels):
        h, loc, frac = _level_coords(points, prims[l], biases[l], scales[l],
                                     vol, pack, n_rows, int(dm[l]))
        row_base = (l * n_rows + h) * (row_width // C)
        wts = [(1.0 - f, f) for f in frac]
        for corner in itertools.product((0, 1), repeat=3):
            pos = [lc + u for lc, u in zip(loc, corner)]
            inside = ((pos[0] >= 0) & (pos[0] < e) & (pos[1] >= 0)
                      & (pos[1] < e) & (pos[2] >= 0) & (pos[2] < e))
            w = (wts[0][corner[0]] * wts[1][corner[1]]
                 * wts[2][corner[2]]) * inside
            q = [x.clamp(0, e - 1) for x in pos]
            yield row_base + (q[0] * e + q[1]) * e + q[2], w[:, None] * g[:, l]


def packed_hash_backward_reference(g, prim_pool, bias_pool, points, anchors,
                                   n_rows, row_width, n_channels, pack,
                                   dense_levels=0):
    """Plain dense table gradient (L, n_rows, row_width) f32 of the encode:
    every term of :func:`packed_hash_scatter_terms` summed exactly in fixed
    point (``hash_encoding.fixed_point_table_grad``), what H2 computes, bit
    for bit.  Columns past ``lattice * C`` stay zero (NaN throughout a
    level whose upstream gradient is not finite)."""
    n_levels = prim_pool.shape[0]
    grad = fixed_point_table_grad(
        g, packed_hash_scatter_terms(g, prim_pool, bias_pool, points,
                                     anchors, n_rows, row_width, n_channels,
                                     pack, dense_levels),
        n_levels, n_rows * row_width // n_channels, n_channels)
    return grad.view(n_levels, n_rows, row_width)


# H2's structure (csrc/packed_hash_bwd.cu): a warp sums at most BWD_CHUNK
# records of a row (longer rows are split into chunks that meet in an int64
# slot of the row); the scan takes BWD_SCAN_TILE counters a block; a call
# makes BWD_LAUNCHES launches (count, scan, scatter, owner) and two
# zero-fills (the counters, the slots).
BWD_CHUNK = 1024
BWD_SCAN_TILE = 16384
BWD_LAUNCHES = 4


def table_grad_launches(n_points: int) -> int:
    """H2's launches for one call on ``n_points`` points (none without
    points), whatever its levels: the count, the scan, the scatter and the
    owner pass."""
    return BWD_LAUNCHES if n_points else 0


def table_grad_memsets(n_points: int) -> int:
    """H2's zero-fills for one call: the counters' and the long rows'
    slots'; without points, the gradient's."""
    return 2 if n_points else 1


def _level_rows(prim_pool, bias_pool, points, anchors, n_rows, pack,
                dense_levels):
    """Per level, (row (P,) int64, local cell per axis, fraction per axis),
    with each point's clamped volume: the forward's addressing."""
    n_levels, n_volumes = prim_pool.shape[:2]
    vol, prims, biases = _anchor_rows(prim_pool, bias_pool, anchors)
    scales = _level_scales(n_levels)
    dm, _ = dense_level_extents(n_levels, pack, n_volumes, n_rows,
                                dense_levels)
    return [_level_coords(points, prims[l], biases[l], scales[l], vol, pack,
                          n_rows, int(dm[l])) for l in range(n_levels)]


def packed_hash_bwd_records(g, prim_pool, bias_pool, points, anchors,
                            n_rows, n_channels, pack, dense_levels=0) -> dict:
    """What H2's count, scan and scatter passes build, plainly: every valid
    (point, level) as one record in its row's bucket.  Returns ``counts``
    (L * rows,) int64, the records of each (level, row) bucket (key ``level
    * rows + row``); ``starts`` (L * rows + 1,) int64, each bucket's first
    record (an exclusive scan of the counts; the last entry is the total);
    and per record, in bucket order (inside a bucket in point order; the
    kernel's order there is free, the sum being exact): ``key``, ``point``
    (int64), ``loc`` (n, 3) int64, the local cell per axis clamped to [-2,
    E] as the kernel packs it, ``frac`` (n, 3) f32, the fraction per axis,
    and ``g`` (n, C) f32, the level's columns of the upstream gradient.
    Points with anchor < 0 have no record."""
    n_levels = prim_pool.shape[0]
    e = pack + 1
    p = points.shape[0]
    valid = anchors >= 0
    keys, locs, fracs = [], [], []
    for l, (h, loc, frac) in enumerate(_level_rows(
            prim_pool, bias_pool, points, anchors, n_rows, pack,
            dense_levels)):
        keys.append(l * n_rows + h)
        locs.append(torch.stack([x.clamp(-2, e) for x in loc], -1))
        fracs.append(torch.stack(frac, -1))
    key = torch.stack(keys)                          # (L, P)
    keep = valid[None].expand(n_levels, p)
    point = torch.arange(p, device=points.device).expand(n_levels, p)[keep]
    level = torch.arange(n_levels, device=points.device)[:, None].expand(
        n_levels, p)[keep]
    key = key[keep]
    counts = torch.bincount(key, minlength=n_levels * n_rows)
    starts = torch.zeros(n_levels * n_rows + 1, dtype=torch.int64,
                         device=points.device)
    starts[1:] = torch.cumsum(counts, 0)
    # each record's place: its bucket's start plus the records of the same
    # bucket before it (level-major, then point order)
    order = torch.argsort(key, stable=True)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(len(order), device=points.device)
    gl = g.reshape(p, n_levels, n_channels).to(torch.float32)
    out = {"counts": counts, "starts": starts}
    for name, x in (("key", key), ("point", point),
                    ("loc", torch.stack(locs)[keep]),
                    ("frac", torch.stack(fracs)[keep]),
                    ("g", gl[point, level])):
        placed = torch.empty_like(x)
        placed[slot] = x
        out[name] = placed
    return out


def packed_hash_bwd_reductions(prim_pool, bias_pool, points, anchors,
                               n_rows, n_channels, pack, dense_levels=0,
                               warp=32) -> torch.Tensor:
    """(L,) int64: the atomics the table-gradient kernel (H2) issues per
    level.  Its warps take ``warp`` consecutive points from a multiple of
    ``warp`` on, at one level; a run of consecutive valid points in one row
    bumps the row's counter once (the count pass) and claims its records
    with one cursor atomic (the scatter pass).  A masked point ends a run
    and has no record.  A row of more than ``BWD_CHUNK`` records is summed
    in chunks of ``BWD_CHUNK``, each of which adds the row's ``(pack + 1)^3
    * C`` lattice columns into the row's slot with one 64-bit reduction
    apiece (at a finite level; the count assumes every level is)."""
    live = (pack + 1) ** 3 * n_channels
    valid = anchors >= 0
    p = points.shape[0]
    first = torch.arange(p, device=points.device) % warp == 0
    ops = []
    for h, _, _ in _level_rows(prim_pool, bias_pool, points, anchors, n_rows,
                               pack, dense_levels):
        same = torch.zeros_like(valid)
        same[1:] = (h[1:] == h[:-1]) & valid[:-1]
        heads = (valid & (first | ~same)).sum()
        counts = torch.bincount(h[valid], minlength=n_rows)
        chunks = torch.div(counts + BWD_CHUNK - 1, BWD_CHUNK,
                           rounding_mode="floor")
        ops.append(2 * heads + live * chunks[counts > BWD_CHUNK].sum())
    return torch.stack(ops)


class _PackedHashEncode(torch.autograd.Function):
    """H1 forward and H2 table gradient on CUDA tensors; the plain pair on
    CPU tensors or when ``plain`` is set.  No gradient flows to the points,
    primes, biases, anchors or the base (``_phe_bwd`` returns None for the
    first four; the base is a constant of the sum)."""

    @staticmethod
    def forward(ctx, feat_pool, prim_pool, bias_pool, points, anchors, base,
                n_channels, pack, dense_levels, plain, in_place):
        ctx.save_for_backward(prim_pool, bias_pool, points, anchors)
        ctx.table_shape = tuple(feat_pool.shape)
        ctx.args = (n_channels, pack, dense_levels)
        ctx.plain = plain or points.device.type == "cpu"
        args = (feat_pool, prim_pool, bias_pool, points, anchors, n_channels,
                pack, dense_levels)
        if in_place:
            ctx.mark_dirty(base)
        if ctx.plain:
            if in_place:
                return base.add_(packed_hash_encode_raw(*args))
            return packed_hash_encode_raw(*args, base=base)
        return _packed_hash_encode_cuda(*args, base=base, in_place=in_place)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 11
        prim_pool, bias_pool, points, anchors = ctx.saved_tensors
        _, n_rows, row_width = ctx.table_shape
        args = (g, prim_pool, bias_pool, points, anchors, n_rows, row_width,
                *ctx.args)
        if ctx.plain:
            grad = packed_hash_backward_reference(*args)
        else:
            grad = _packed_hash_backward_cuda(*args)
        return (grad,) + (None,) * 10


def _apply_encode(plain, feat_pool, prim_pool, bias_pool, points, anchors,
                  n_channels, pack, dense_levels, base, in_place):
    base = check_base("packed_hash_encode", base, points,
                       feat_pool.shape[0] * n_channels, in_place)
    return _PackedHashEncode.apply(feat_pool, prim_pool, bias_pool, points,
                                   anchors, base, n_channels, pack,
                                   dense_levels, plain, in_place)


def packed_hash_encode(feat_pool, prim_pool, bias_pool, points, anchors,
                       n_channels: int, pack: int, dense_levels: int = 0,
                       base: Optional[torch.Tensor] = None,
                       in_place: bool = False):
    """Packed encoding (P, L * n_channels), differentiable in ``feat_pool``:
    the plain pair for CPU tensors, the CUDA kernels (``csrc/
    packed_hash_fwd.cu``, ``csrc/packed_hash_bwd.cu``) for CUDA tensors.

    With ``base`` (P, L * n_channels) f32, another table's encode that
    this one is a residual of, the result is ``base + encode``, bit for bit
    (on CUDA tensors the kernel's write-back adds it: no separate pass);
    the table's gradient is the same with or without it.  The base must
    not require a gradient.  With ``in_place`` the sum is written into
    ``base``, which is returned."""
    return _apply_encode(False, feat_pool, prim_pool, bias_pool, points,
                         anchors, n_channels, pack, dense_levels, base,
                         in_place)


def plain_packed_hash_encode(feat_pool, prim_pool, bias_pool, points,
                             anchors, n_channels: int, pack: int,
                             dense_levels: int = 0,
                             base: Optional[torch.Tensor] = None,
                             in_place: bool = False):
    """``packed_hash_encode`` through the plain forward and backward on any
    device (launches no kernel)."""
    return _apply_encode(True, feat_pool, prim_pool, bias_pool, points,
                         anchors, n_channels, pack, dense_levels, base,
                         in_place)


packed_hash_encode.launches = 0       # H1 launches
packed_hash_encode.bwd_launches = 0   # H2 launches: table_grad_launches a call
packed_hash_encode.bwd_memsets = 0    # H2 zero-fills: two a call
packed_hash_encode.bwd_calls = 0      # H2 calls, one per backward


@functools.lru_cache(maxsize=32)
def _level_constants(n_levels, pack, n_volumes, n_rows, dense_levels, dev):
    """(scales f32, dense_m i32) of the levels on ``dev``, built once and
    shared by every launch (the kernels only read them): a copy from host
    memory would otherwise wait for the stream to drain at every launch."""
    dm, _ = dense_level_extents(n_levels, pack, n_volumes, n_rows,
                                dense_levels)
    return (torch.as_tensor(_level_scales(n_levels), device=dev),
            torch.as_tensor(dm, dtype=torch.int32, device=dev))


def _kernel_args(what, prim_pool, bias_pool, points, anchors, n_rows,
                 row_width, n_channels, pack, dense_levels, tensors,
                 level=None):
    """Check what the kernels take and return the device tensors of the
    addressing: (primes i32, bias, scales, dense_m, points, anchors i32).
    Inputs that already have the kernel's type and layout are passed as
    they are.  The pools are (L, V, 3), or (B, L, V, 3) for the routed
    encode.  With ``level``, the primes, biases, scales and dense extents
    are that level's rows alone, for a launch over that one level."""
    n_levels, n_volumes = prim_pool.shape[-3:-1]
    e = pack + 1
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if (e, n_channels) not in KERNEL_SHAPES:
        raise ValueError(f"{what}: no kernel for lattice edge {e} x "
                         f"{n_channels} channels (have {KERNEL_SHAPES})")
    if e ** 3 * n_channels > row_width or row_width % 8:
        raise ValueError(f"{what}: row width {row_width} does not hold a "
                         f"{e}^3 x {n_channels} lattice in 16-byte aligned "
                         f"rows")
    if n_rows & (n_rows - 1):
        raise ValueError(f"{what}: {n_rows} rows is not a power of two")
    if level is not None and not 0 <= level < n_levels:
        raise ValueError(f"{what}: level {level} of {n_levels}")
    for name, t in (("prim_pool", prim_pool), ("bias_pool", bias_pool),
                    ("anchors", anchors), *tensors):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, points on {dev}")
    if (points.dim() != 2 or points.shape[1] != 3
            or points.dtype != torch.float32):
        raise ValueError(f"{what}: points must be (P, 3) f32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    p = points.shape[0]
    if anchors.shape != (p,):
        raise ValueError(f"{what}: anchors {tuple(anchors.shape)} != ({p},)")
    per_level = [prim_pool.to(torch.int32),   # values < 2^30
                 bias_pool.to(torch.float32),
                 *_level_constants(n_levels, pack, n_volumes, n_rows,
                                   dense_levels, dev)]
    if level is not None:
        per_level = [t[level:level + 1] for t in per_level]
    return (*(t.contiguous() for t in per_level), points.contiguous(),
            anchors.to(torch.int32).contiguous())


def _packed_hash_encode_cuda(feat_pool, prim_pool, bias_pool, points,
                             anchors, n_channels, pack, dense_levels,
                             level=None, base=None, in_place=False):
    """H1 on CUDA tensors: (P, L * C).  With ``level``, that level alone:
    (P, C), its columns of the whole.  The kernel reads a bf16 copy of the
    table, as the plain version does (no copy if it is bf16 already).
    With ``base`` (checked by the caller, :func:`check_base`) the kernel
    writes ``base + encode``, over the base with ``in_place``."""
    n_levels, n_rows, row_width = feat_pool.shape
    if base is not None and level is not None:
        raise ValueError("packed_hash_encode: a base goes with all levels")
    addr = _kernel_args("packed_hash_encode", prim_pool, bias_pool, points,
                        anchors, n_rows, row_width, n_channels, pack,
                        dense_levels, [("feat_pool", feat_pool)], level)
    table = feat_pool.to(torch.bfloat16).contiguous()
    if level is not None:
        table, n_levels = table[level:level + 1], 1
    p = points.shape[0]
    out = base if in_place else torch.empty(
        (p, n_levels * n_channels), dtype=torch.float32, device=points.device)
    err = build.library().gfnerf_packed_hash_fwd(
        table.data_ptr(), *(t.data_ptr() for t in addr),
        None if base is None else base.data_ptr(), out.data_ptr(), p,
        n_levels, prim_pool.shape[1], n_rows, row_width, n_channels, pack + 1,
        torch.cuda.current_stream(points.device).cuda_stream)
    build.check(err, "gfnerf_packed_hash_fwd")
    if p:   # no points, no launch
        packed_hash_encode.launches += 1
    return out


def _bwd_workspace(p, n_levels, n_rows, n_channels, pack, dev):
    """H2's scratch on ``dev`` (csrc/packed_hash_bwd.cu says what each
    holds), from the caching allocator: nothing is copied from the host, so
    a CUDA graph can capture the call.  The records' count must fit int32."""
    n_keys = n_levels * n_rows
    n_rec = p * n_levels
    if n_rec >= 2 ** 31 - 1:
        raise ValueError(f"packed_hash_encode backward: {p} points x "
                         f"{n_levels} levels is past int32's records")
    n_scan = -(-n_keys // BWD_SCAN_TILE)
    n_slots = _bwd_slots(p, n_levels, n_rows)

    def empty(n, dtype):
        return torch.empty((max(1, n),), dtype=dtype, device=dev)

    return (empty(n_rec * (4 + n_channels), torch.float32),     # records
            empty(n_keys + n_scan + 4 + n_levels + n_slots,      # ctrl
                  torch.int32),
            empty(n_keys, torch.int32),                          # slot_of
            empty(2 * (n_rec // BWD_CHUNK), torch.int32),        # items
            empty(n_slots * (pack + 1) ** 3 * n_channels,        # slot_sums
                  torch.int64))


def _bwd_slots(n_points: int, n_levels: int, n_rows: int) -> int:
    """H2's slots of long-row sums for a call: at least the rows of more
    than BWD_CHUNK records there can be, at least one."""
    return max(1, min(n_levels * n_rows,
                      n_points * n_levels // (BWD_CHUNK + 1)))


def _packed_hash_backward_cuda(g, prim_pool, bias_pool, points, anchors,
                               n_rows, row_width, n_channels, pack,
                               dense_levels, red_ops=None, level=None):
    """H2 on CUDA tensors: the (L, rows, W) table gradient, equal to
    :func:`packed_hash_backward_reference` bit for bit.  With ``level``,
    that level alone: ``g`` is its (P, C) columns and the result (1, rows,
    W), that level of the whole (its scale is its own).  ``red_ops``, an
    int64 tensor on the card with one entry per level computed, if given,
    gets the atomics the kernel issued per level added to it
    (:func:`packed_hash_bwd_reductions` reckons them)."""
    n_levels = 1 if level is not None else prim_pool.shape[0]
    p = points.shape[0]
    if g.shape != (p, n_levels * n_channels):
        raise ValueError(f"packed_hash_encode backward: gradient "
                         f"{tuple(g.shape)} != ({p}, {n_levels * n_channels})")
    if red_ops is not None and (red_ops.shape != (n_levels,)
                                or red_ops.dtype != torch.int64
                                or red_ops.device != points.device):
        raise ValueError(f"packed_hash_encode backward: red_ops must be "
                         f"({n_levels},) int64 on {points.device}")
    addr = _kernel_args("packed_hash_encode backward", prim_pool, bias_pool,
                        points, anchors, n_rows, row_width, n_channels, pack,
                        dense_levels, [("gradient", g)], level)
    gc = g.to(torch.float32).contiguous()
    dev = points.device
    grad = torch.empty((n_levels, n_rows, row_width), dtype=torch.float32,
                       device=dev)
    work = _bwd_workspace(p, n_levels, n_rows, n_channels, pack, dev)
    launches, memsets = ctypes.c_int(0), ctypes.c_int(0)
    err = build.library().gfnerf_packed_hash_bwd(
        gc.data_ptr(), *(t.data_ptr() for t in addr), grad.data_ptr(),
        *(t.data_ptr() for t in work),
        None if red_ops is None else red_ops.data_ptr(),
        ctypes.addressof(launches), ctypes.addressof(memsets), p, n_levels,
        prim_pool.shape[1], n_rows, row_width, n_channels, pack + 1,
        _bwd_slots(p, n_levels, n_rows),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "gfnerf_packed_hash_bwd")
    packed_hash_encode.bwd_calls += 1
    packed_hash_encode.bwd_launches += launches.value
    packed_hash_encode.bwd_memsets += memsets.value
    return grad


def _apply_routed(plain, block_feats, block_prims, block_biases, points,
                  anchors, blocks, n_channels, pack, dense_levels, base,
                  in_place):
    base = check_base("packed_hash_encode_routed", base, points,
                       block_feats.shape[1] * n_channels, in_place)
    args = (block_feats, block_prims, block_biases, points, anchors, blocks,
            n_channels, pack, dense_levels)
    with torch.no_grad():
        if not plain and points.device.type != "cpu":
            return _packed_hash_routed_cuda(*args, base, in_place)
        if in_place:
            return base.add_(packed_hash_encode_routed_raw(*args))
        return packed_hash_encode_routed_raw(*args, base)


def packed_hash_encode_routed(block_feats, block_prims, block_biases, points,
                              anchors, blocks, n_channels: int, pack: int,
                              dense_levels: int = 0,
                              base: Optional[torch.Tensor] = None,
                              in_place: bool = False):
    """Block-routed packed encoding (P, L * n_channels), forward only (the
    eval path; no gradient flows): the plain version for CPU tensors, the
    CUDA kernel (``csrc/packed_hash_routed.cu``) for CUDA tensors.  The
    tables may be given in bf16, the type the kernel reads; an f32 stack is
    copied to bf16 at every call.

    With ``base`` (P, L * n_channels) f32, the global encode the routed one
    is a residual of, the result is ``base + encode``, bit for bit (on CUDA
    tensors the kernel's write-back adds it: no separate pass); with
    ``in_place`` it is written into ``base``, which is returned."""
    return _apply_routed(False, block_feats, block_prims, block_biases,
                         points, anchors, blocks, n_channels, pack,
                         dense_levels, base, in_place)


def plain_packed_hash_encode_routed(block_feats, block_prims, block_biases,
                                    points, anchors, blocks, n_channels: int,
                                    pack: int, dense_levels: int = 0,
                                    base: Optional[torch.Tensor] = None,
                                    in_place: bool = False):
    """``packed_hash_encode_routed`` through the plain version on any device
    (launches no kernel)."""
    return _apply_routed(True, block_feats, block_prims, block_biases, points,
                         anchors, blocks, n_channels, pack, dense_levels,
                         base, in_place)


packed_hash_encode_routed.launches = 0   # H3 launches


def _packed_hash_routed_cuda(block_feats, block_prims, block_biases, points,
                             anchors, blocks, n_channels, pack, dense_levels,
                             base=None, in_place=False):
    """H3 on CUDA tensors: (P, L * C); with ``base`` (checked by the caller,
    :func:`check_base`) ``base + encode``, over the base with
    ``in_place``."""
    if block_feats.dim() != 4 or block_prims.dim() != 4 \
            or block_prims.shape[:2] != block_feats.shape[:2] \
            or block_biases.shape != block_prims.shape:
        raise ValueError(
            f"packed_hash_encode_routed: tables {tuple(block_feats.shape)}, "
            f"primes {tuple(block_prims.shape)}, biases "
            f"{tuple(block_biases.shape)} are not (B, L, rows, W) and "
            f"(B, L, V, 3) twice")
    n_blocks, n_levels, n_rows, row_width = block_feats.shape
    p = points.shape[0]
    if blocks.shape != (p,):
        raise ValueError(f"packed_hash_encode_routed: blocks "
                         f"{tuple(blocks.shape)} != ({p},)")
    addr = _kernel_args("packed_hash_encode_routed", block_prims,
                        block_biases, points, anchors, n_rows, row_width,
                        n_channels, pack, dense_levels,
                        [("block_feats", block_feats), ("blocks", blocks)])
    tables = block_feats.to(torch.bfloat16).contiguous()
    blk = blocks.to(torch.int32).contiguous()
    out = base if in_place else torch.empty(
        (p, n_levels * n_channels), dtype=torch.float32, device=points.device)
    err = build.library().gfnerf_packed_hash_routed(
        tables.data_ptr(), *(t.data_ptr() for t in addr), blk.data_ptr(),
        None if base is None else base.data_ptr(), out.data_ptr(), p,
        n_blocks, n_levels, block_prims.shape[2], n_rows, row_width,
        n_channels, pack + 1,
        torch.cuda.current_stream(points.device).cuda_stream)
    build.check(err, "gfnerf_packed_hash_routed")
    if p:   # no points, no launch
        packed_hash_encode_routed.launches += 1
    return out
