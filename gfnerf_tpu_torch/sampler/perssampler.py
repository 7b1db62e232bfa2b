"""Perspective octree sampler — device-side state and the per-point warp.

Port of ``gfnerf_tpu/sampler/perssampler.py``: the padded device octree
(``OctreeDevice``), its upload (``octree_to_device``) and the pull of its
mutable state back to the host tree (``octree_from_device``), the tree cut
of the hierarchical march, and the perspective warp ``warp_points`` with its
Jacobian-direction norm, the occupancy statistics of the init stage
(``update_oct_nodes``), the march-fineness anneal (``ray_march_fineness``),
the scan march (``get_samples`` with its top-down point location
``locate_points``: the plain version of kernel M1,
``ops/scan_march.py``) and the TV-loss edge samples
(``get_edge_samples``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from gfnerf_tpu_torch.cameras.rays import WarpedSamples
from gfnerf_tpu_torch.fields.hash_encoding import _fma
from gfnerf_tpu_torch.sampler.octree import PersOctree

INIT_NODE_STAT = 1000  # PersSampler.h:14
# occupancy-stat constants (PersSampler_cuda.cu:11-17)
OCC_WEIGHT_BASE = 512
ABS_WEIGHT_THRES = 0.01
REL_WEIGHT_THRES = 0.1
OCC_ALPHA_BASE = 32
ABS_ALPHA_THRES = 0.02
REL_ALPHA_THRES = 0.1
CUT_F = 32  # max descendant leaves per tree-cut node


@dataclasses.dataclass
class OctreeDevice:
    """Device-resident octree SoA, padded to a fixed node capacity."""

    centers: torch.Tensor      # (C, 3) f32
    side_lens: torch.Tensor    # (C,) f32
    childs: torch.Tensor       # (C, 8) i32 (-1 none; padding rows all -1)
    is_leaf: torch.Tensor      # (C,) bool (padding True)
    trans_idx: torch.Tensor    # (C,) i32 (-1 invalid)
    block_idx: torch.Tensor    # (C,) i32
    weight_stats: torch.Tensor  # (C,) i32
    alpha_stats: torch.Tensor   # (C,) i32
    visit_cnt: torch.Tensor     # (C,) i32
    n_nodes: int
    leaf_idx: torch.Tensor      # (Lcap,) i32 valid-leaf node ids, -1 pad
    n_leaves: int
    cut_nodes: torch.Tensor      # (Ccap,) i32 node ids, -1 pad
    cut_leaf_slots: torch.Tensor  # (Ccap, CUT_F) i32 positions into leaf_idx
    w2xz: torch.Tensor          # (T, 12, 2, 4) f32
    warp_weight: torch.Tensor   # (T, 3, 12) f32
    # the same tables as flat rows: w2xz_flat in [j][i][k] order (j the
    # homogeneous coordinate, i numerator/denominator, k the 12 projections)
    w2xz_flat: torch.Tensor     # (T, 96) f32
    warp_weight_flat: torch.Tensor  # (T, 36) f32
    t_center: torch.Tensor      # (T, 3) f32
    t_dis_summary: torch.Tensor  # (T,) f32


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling hyper-parameters (gfnerf/perssampler.py:48-76): the fields
    of the JAX ``SamplerConfig``, with its defaults.  ``global_far`` and
    ``locate_iters`` (the descent's depth bound, at least the tree's) are
    read by the scan march alone; ``max_hits``, ``ray_chunk`` and
    ``coarse_hits`` by the fast march alone."""

    max_samples: int = 1024     # MAX_SAMPLE_PER_RAY
    sample_l: float = 1.0 / 256
    scale_by_dis: bool = True
    global_near: float = 0.01
    global_far: float = 1e8
    locate_iters: int = 24      # >= max tree depth
    march: str = "fast"         # "fast" (leaf-list) | "scan" (sequential)
    max_hits: int = 64          # leaf hits per ray (fast march)
    ray_chunk: int = 1024       # slab-test ray chunking
    coarse_hits: int = 0        # hierarchical march (0 = brute force)


def leaf_capacity_for(n: int, minimum: int = 1024) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def build_tree_cut(tree: PersOctree, leaf_idx: np.ndarray,
                   f_max: int = CUT_F):
    """Tree cut for the hierarchical march: the shallowest antichain of
    nodes whose valid-leaf descendant counts are all <= f_max.

    Returns (cut_nodes (Ccap,) i32, cut_leaf_slots (Ccap, f_max) i32), both
    -1 padded; slots index into ``leaf_idx``.
    """
    slot_of_node = {int(n): i for i, n in enumerate(leaf_idx) if n >= 0}
    cut, lists = [], []

    def leaf_slots(node: int):
        if tree.is_leaf[node]:
            s = slot_of_node.get(node)
            return [s] if s is not None else []
        out = []
        for c in tree.childs[node]:
            if c >= 0:
                out.extend(leaf_slots(int(c)))
        return out

    def descend(node: int):
        slots = leaf_slots(node)
        if not slots:
            return
        if len(slots) <= f_max or tree.is_leaf[node]:
            cut.append(node)
            lists.append(slots)
        else:
            for c in tree.childs[node]:
                if c >= 0:
                    descend(int(c))

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        descend(0)
    finally:
        sys.setrecursionlimit(old_limit)
    ccap = leaf_capacity_for(max(len(cut), 1), minimum=128)
    cut_nodes = np.full(ccap, -1, np.int32)
    cut_slots = np.full((ccap, f_max), -1, np.int32)
    for i, (n, slots) in enumerate(zip(cut, lists)):
        cut_nodes[i] = n
        cut_slots[i, : len(slots)] = slots
    return cut_nodes, cut_slots


def octree_to_device(tree: PersOctree, capacity: int,
                     leaf_capacity: int | None = None,
                     device="cuda") -> OctreeDevice:
    """Upload a host octree into padded device tensors."""
    m = tree.n_nodes
    if m > capacity:
        raise ValueError(f"octree has {m} nodes > capacity {capacity}")

    valid_leaves = np.where(tree.is_leaf & (tree.trans_idx >= 0))[0].astype(
        np.int32)
    if leaf_capacity is None:
        leaf_capacity = leaf_capacity_for(len(valid_leaves))
    if len(valid_leaves) > leaf_capacity:
        raise ValueError(f"{len(valid_leaves)} valid leaves > leaf capacity "
                         f"{leaf_capacity}")
    leaf_idx = np.full(leaf_capacity, -1, np.int32)
    leaf_idx[: len(valid_leaves)] = valid_leaves
    cut_nodes, cut_leaf_slots = build_tree_cut(tree, leaf_idx)

    def dev(arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=device)

    def pad(arr, fill, dtype=None):
        arr = np.asarray(arr)
        out = np.full((capacity,) + arr.shape[1:], fill,
                      dtype=dtype or arr.dtype)
        out[:m] = arr
        return dev(out)

    w2xz = np.asarray(tree.w2xz)
    weight = np.asarray(tree.weight)
    return OctreeDevice(
        leaf_idx=dev(leaf_idx),
        n_leaves=len(valid_leaves),
        cut_nodes=dev(cut_nodes),
        cut_leaf_slots=dev(cut_leaf_slots),
        centers=pad(tree.centers, 0.0),
        side_lens=pad(tree.side_lens, 1.0),
        childs=pad(tree.childs, -1),
        is_leaf=pad(tree.is_leaf, True),
        trans_idx=pad(tree.trans_idx, -1),
        block_idx=pad(tree.block_idx, -1),
        weight_stats=pad(tree.weight_stats.astype(np.int32), INIT_NODE_STAT),
        alpha_stats=pad(tree.alpha_stats.astype(np.int32), INIT_NODE_STAT),
        visit_cnt=pad(tree.visit_cnt.astype(np.int32), 0),
        n_nodes=m,
        w2xz=dev(w2xz),
        warp_weight=dev(weight),
        w2xz_flat=dev(np.transpose(w2xz, (0, 3, 2, 1)).reshape(len(w2xz), 96)),
        warp_weight_flat=dev(weight.reshape(len(weight), 36)),
        t_center=dev(tree.t_center),
        t_dis_summary=dev(tree.t_dis_summary),
    )


def octree_from_device(oct: OctreeDevice, tree: PersOctree) -> PersOctree:
    """The host tree with the device's mutable state pulled back: the
    occupancy statistics and the anchors the statistics invalidated."""
    m = tree.n_nodes

    def host(t, dtype):
        return t[:m].cpu().numpy().astype(dtype)

    return dataclasses.replace(
        tree,
        trans_idx=host(oct.trans_idx, np.int32),
        weight_stats=host(oct.weight_stats, np.int64),
        alpha_stats=host(oct.alpha_stats, np.int64),
        visit_cnt=host(oct.visit_cnt, np.int64),
    )


# ------------------------------------------------------------------ warp ----


def _proj_terms(g: torch.Tensor, p: torch.Tensor):
    """Numerator a and denominator b of the 12 homogeneous projections of
    points p (..., 3) under flat warp rows g (..., 96)."""
    a = g[..., 0:12] * p[..., 0:1]
    b = g[..., 12:24] * p[..., 0:1]
    for j in (1, 2):
        a = a + g[..., j * 24: j * 24 + 12] * p[..., j: j + 1]
        b = b + g[..., j * 24 + 12: j * 24 + 24] * p[..., j: j + 1]
    # homogeneous coordinate 1
    return a + g[..., 72:84], b + g[..., 84:96]


def _dir_terms(g: torch.Tensor, d: torch.Tensor):
    """A.d and B.d: the projections' linear parts applied to directions."""
    ad = g[..., 0:12] * d[..., 0:1]
    bd = g[..., 12:24] * d[..., 0:1]
    for j in (1, 2):
        ad = ad + g[..., j * 24: j * 24 + 12] * d[..., j: j + 1]
        bd = bd + g[..., j * 24 + 12: j * 24 + 24] * d[..., j: j + 1]
    return ad, bd


def _weighted3(wf: torch.Tensor, v: torch.Tensor) -> list:
    """Three (...,) sums of the (..., 12) values v against the warp weight
    rows wf (..., 36)."""
    return [torch.sum(wf[..., c * 12: (c + 1) * 12] * v, dim=-1)
            for c in range(3)]


def warp_points(oct: OctreeDevice, trans: torch.Tensor, p: torch.Tensor):
    """QueryFrameTransform (PersSampler_cuda.cu:155-170), batched.

    trans: (R,) clamped anchor indices; p: (R, 3). Returns warped (R, 3).
    """
    a, b = _proj_terms(oct.w2xz_flat[trans], p)
    return torch.stack(_weighted3(oct.warp_weight_flat[trans], a / b), dim=-1)


def _jacobian_norm(g, wf, p, d):
    """||J(p) . d|| from gathered warp rows g (..., 96) and wf (..., 36)."""
    a, b = _proj_terms(g, p)
    ad, bd = _dir_terms(g, d)
    # dv/dxyz_j = A_j / b - (a / b^2) B_j, folded against the direction
    proj = ad / b - (a / (b * b)) * bd
    jd = _weighted3(wf, proj)
    return torch.sqrt(jd[0] ** 2 + jd[1] ** 2 + jd[2] ** 2)


def warp_jacobian_dir(oct: OctreeDevice, trans: torch.Tensor, p: torch.Tensor,
                      d: torch.Tensor):
    """||J(p) . d|| for the warp (QueryFrameTransformJac, cu:172-188)."""
    return _jacobian_norm(oct.w2xz_flat[trans], oct.warp_weight_flat[trans],
                          p, d)


# ---------------------------------------------------------------- scan ----


def locate_points(oct: OctreeDevice, p: torch.Tensor, locate_iters: int):
    """Top-down point location for a batch of points (perssampler.py:236).

    p: (R, 3).  Returns (node (R,), cube centre (R, 3), cube side (R,),
    trans (R,), block (R,)), the indices int64.  Each of ``locate_iters``
    levels takes the child octant of ``p >= c``; a missing child ends the
    descent at that (empty) octant's cube with trans and block -1.  The
    loop stops once every point is done: later levels change nothing."""
    r = p.shape[0]
    dev = p.device
    u = torch.zeros(r, dtype=torch.int64, device=dev)
    c = oct.centers[0].expand(r, 3)
    s = oct.side_lens[0].expand(r)
    done = torch.zeros(r, dtype=torch.bool, device=dev)
    virt = torch.zeros_like(done)
    for _ in range(locate_iters):
        leaf = oct.is_leaf[u]
        bits = p >= c
        oct_id = (bits[:, 0].long() * 4 + bits[:, 1].long() * 2
                  + bits[:, 2].long())
        child = oct.childs[u, oct_id].long()
        has_child = child >= 0
        descend = ~done & ~leaf
        offset = bits.to(p.dtype) - 0.5
        c = torch.where(descend[:, None], c + s[:, None] * 0.5 * offset, c)
        s = torch.where(descend, s * 0.5, s)
        u = torch.where(descend & has_child, child, u)
        virt = virt | (descend & ~has_child)
        done = done | leaf | (descend & ~has_child)
        if bool(done.all()):
            break
    trans = torch.where(virt | ~oct.is_leaf[u], -1, oct.trans_idx[u].long())
    block = torch.where(virt, -1, oct.block_idx[u].long())
    return u, c, s, trans, block


def _ray_aabb(o, d, center, side):
    """Slab test (near, far) (R,) of rays o, d (R, 3) against cubes center
    (R, 3), side (R,)."""
    hf = side[:, None] * 0.5
    small = torch.where(d >= 0, 1e-10, -1e-10)
    inv = 1.0 / torch.where(d.abs() < 1e-10, small, d)
    t0 = (center - hf - o) * inv
    t1 = (center + hf - o) * inv
    return (torch.amax(torch.minimum(t0, t1), dim=-1),
            torch.amin(torch.maximum(t0, t1), dim=-1))


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """The length of (..., 3) vectors: x x, then y y and z z added by
    multiply-adds (as XLA:CPU contracts them in the JAX package's jitted
    march, and as kernel M1 forms them with ``fmaf``)."""
    x = v[..., 0] * v[..., 0]
    x = _fma(v[..., 1], v[..., 1], x)
    return torch.sqrt(_fma(v[..., 2], v[..., 2], x))


def _weighted3_seq(wf: torch.Tensor, v: torch.Tensor) -> list:
    """``_weighted3`` summed by multiply-adds in the order of the 12
    projections (the order kernel M1 sums in)."""
    out = []
    for c in range(3):
        acc = wf[..., c * 12] * v[..., 0]
        for k in range(1, 12):
            acc = _fma(wf[..., c * 12 + k], v[..., k], acc)
        out.append(acc)
    return out


def _scan_warp(oct: OctreeDevice, trc: torch.Tensor, p: torch.Tensor,
               d: torch.Tensor):
    """(warped points (R, 3), ||J(p) . d|| (R,)) at clamped anchors trc:
    ``warp_points`` and ``warp_jacobian_dir`` with their sums taken in a
    fixed order."""
    g = oct.w2xz_flat[trc]
    wf = oct.warp_weight_flat[trc]
    a, b = _proj_terms(g, p)
    ad, bd = _dir_terms(g, d)
    jd = _weighted3_seq(wf, ad / b - (a / (b * b)) * bd)
    jn = torch.sqrt(jd[0] ** 2 + jd[1] ** 2 + jd[2] ** 2)
    return torch.stack(_weighted3_seq(wf, a / b), dim=-1), jn


def get_samples(oct: OctreeDevice, rays_o: torch.Tensor, rays_d: torch.Tensor,
                noise: torch.Tensor, cfg: SamplerConfig) -> WarpedSamples:
    """The scan march (``get_samples``, perssampler.py:337-429; the
    reference's ``PersSampler::GetSamples``, PersSampler_cuda.cu:321-477):
    one sequential march per ray over the S = noise.shape[1] slots, the
    plain version of kernel M1.

    noise (R, S) is the per-slot march noise already times the fineness.
    Each slot locates its point ``o + t d`` top-down (``locate_points``);
    in a valid leaf it steps ``sample_l * noise / |J.d|`` (times the
    distance scale), the warp-space delta being ``sample_l * noise``; in an
    empty region it skips past the cube's exit in whole steps of the last
    step taken (quantized skip).  The first valid-leaf slot of a ray is
    consumed without being emitted, and empty regions use up slots too, as
    in the JAX package, whose distribution of samples matches the
    reference's.  Returns fixed-shape (R, S) samples with ``warp_pts``."""
    r, s_slots = noise.shape
    d = rays_d / _norm3(rays_d)[:, None]
    o = rays_o
    n_trans = oct.w2xz.shape[0]
    root_near, root_far = _ray_aabb(o, d, oct.centers[0].expand(r, 3),
                                    oct.side_lens[0].expand(r))
    t = torch.clamp(root_near, min=cfg.global_near)
    alive = (root_near < root_far) & (root_far > cfg.global_near)
    t_end = torch.clamp(root_far, max=cfg.global_far)
    prev_step = torch.zeros_like(t)
    first = torch.ones_like(alive)
    first_oct = torch.full_like(t, 1e9)
    outs = []
    for i in range(s_slots):
        p = _fma(t[:, None], d, o)
        u, cc, cs, trans, block = locate_points(oct, p, cfg.locate_iters)
        valid_leaf = trans >= 0
        trc = trans.clamp(0, n_trans - 1)
        warp_p, jn = _scan_warp(oct, trc, p, d)
        jnorm = jn + 1e-6
        radius = torch.clamp(_norm3(o - oct.t_center[trc])
                             / oct.t_dis_summary[trc], min=1.0)
        step_world = cfg.sample_l * noise[:, i] / jnorm
        if cfg.scale_by_dis:
            step_world = step_world * radius
        emit = alive & valid_leaf & ~first
        dt = step_world * jnorm                 # warp-space delta (cu:285)
        # the first valid leaf's entry distance (cu:229-234)
        cube_near, cube_far = _ray_aabb(o, d, cc, cs)
        hit_first = alive & valid_leaf & (first_oct >= 1e8)
        first_oct = torch.where(
            hit_first, torch.clamp(cube_near, min=cfg.global_near),
            first_oct)
        # a valid leaf: one step; an empty region: a quantized skip past
        # the cube's exit (cu:295-305)
        exit_t = torch.maximum(cube_far, t) + 1e-4 * cs
        q = torch.clamp(torch.ceil((exit_t - t)
                                   / torch.clamp(prev_step, min=1e-8)),
                        min=1.0)
        skip_t = torch.where(prev_step > 0, t + prev_step * q, exit_t)
        t_next = torch.where(valid_leaf, t + step_world, skip_t)
        outs.append((p, warp_p, dt, t, trans, u, block, emit))
        prev_step = torch.where(valid_leaf, step_world, prev_step)
        first = first & ~(alive & valid_leaf)
        alive = alive & (t_next < t_end)
        t = t_next
    world, warp, dts, ts, trans, node, block, valid = (
        torch.stack(x, dim=1) for x in zip(*outs))
    return WarpedSamples(
        world_pts=torch.where(valid[..., None], world, 0.0),
        warp_pts=torch.where(valid[..., None], warp, 0.0),
        dists=torch.where(valid, dts, 0.0),
        ts=torch.where(valid, ts, 0.0),
        trans_idx=torch.where(valid, trans, -1).to(torch.int32),
        oct_idx=torch.where(valid, node, -1).to(torch.int32),
        block_idx=torch.where(valid, block, -1).to(torch.int32),
        valid=valid,
        num_valid=valid.sum(dim=-1),
        first_oct_dis=first_oct)


def get_edge_samples(edge_t_idx: torch.Tensor, edge_center: torch.Tensor,
                     edge_dirs: torch.Tensor, n_pts: int,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[tuple] = None):
    """Points on octree-leaf boundary faces for the TV loss
    (``get_edge_samples``, perssampler.py:516; the reference's
    ``PersSampler::GetEdgeSamples``, PersSampler_cuda.cu:479-516): random
    face-adjacency edges of the host octree's edge pool
    (``octree.construct_edge_pool``), a random (u, v) in [-1, 1]^2 on the
    shared face, each point twice with the two adjacent warp anchors.

    ``draws`` = (edge indices (n_pts,) int, uniforms (n_pts, 2) in [0,
    1)), or None to draw them from ``generator``.  Returns (points (n_pts,
    2, 3), anchors (n_pts, 2))."""
    dev = edge_center.device
    if draws is None:
        n_edges = max(int(edge_t_idx.shape[0]), 1)
        eidx = torch.randint(0, n_edges, (n_pts,), generator=generator,
                             device=dev)
        uv = torch.rand((n_pts, 2), generator=generator, device=dev)
    else:
        eidx, uv = (torch.as_tensor(x, device=dev) for x in draws)
    eidx = eidx.long()
    coord = uv * 2.0 - 1.0
    dirs = edge_dirs[eidx]
    pts = (edge_center[eidx] + dirs[:, 0] * coord[:, 0:1]
           + dirs[:, 1] * coord[:, 1:2])
    return torch.stack([pts, pts], dim=1), edge_t_idx[eidx]


# -------------------------------------------------------- occupancy stats ----


def _scatter_max(base: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """base (C,) with base[i] = max(base[i], src[j]) for index[j] == i;
    indices == C are dropped."""
    out = torch.cat([base, base.new_zeros(1)])
    out = out.scatter_reduce(0, index, src.to(base.dtype), reduce="amax",
                             include_self=True)
    return out[:-1]


@torch.no_grad()
def update_oct_nodes(oct: OctreeDevice, samples, weights: torch.Tensor,
                     alphas: torch.Tensor, comm=None) -> OctreeDevice:
    """Occupancy statistics update (UpdateOctNodes, cu:518-677).

    Per ray: thresholds rel/abs on the ray's max weight/alpha; per visited
    node: +BASE if any sample exceeded, else -1; EMA-like integer stats
    with clamping; nodes whose stats go negative get trans_idx = -1.
    Returns a new OctreeDevice; weights and alphas (R, S) are not
    differentiated.  With ``comm`` (a data-parallel step's
    :class:`~gfnerf_tpu_torch.parallel.comm.Comm`) the per-node adders,
    marks and visit counts, scatter-maxima of each rank's rays, are merged
    by a maximum over the ranks before the statistics update: the maximum
    is associative, so every rank's octree equals the one-card octree of
    the whole batch.
    """
    cap = oct.centers.shape[0]
    valid = samples.valid
    node = torch.where(valid, samples.oct_idx.long(), cap)   # cap -> dropped
    w = torch.where(valid, weights, 0.0)
    a = torch.where(valid, alphas, 0.0)
    w_thres = torch.clamp(w.amax(-1, keepdim=True) * REL_WEIGHT_THRES,
                          max=ABS_WEIGHT_THRES)
    a_thres = torch.clamp(a.amax(-1, keepdim=True) * REL_ALPHA_THRES,
                          max=ABS_ALPHA_THRES)
    exceed_w = valid & (w > w_thres)
    exceed_a = valid & (a > a_thres)

    flat_node = node.reshape(-1)
    minus = torch.full((cap,), -1, dtype=torch.int32, device=node.device)
    adder_w = _scatter_max(minus, flat_node, torch.where(
        exceed_w, OCC_WEIGHT_BASE, -1).reshape(-1))
    adder_a = _scatter_max(minus, flat_node, torch.where(
        exceed_a, OCC_ALPHA_BASE, -1).reshape(-1))
    mark = _scatter_max(torch.zeros_like(minus), flat_node,
                        valid.reshape(-1))

    # max run length per node (atomicMax(visit_cnt, cur_visit_cnt), cu:556):
    # running position within each same-node run, then scatter-max
    s = valid.shape[1]
    pos = torch.arange(s, device=node.device)[None, :]
    change = torch.cat([torch.ones_like(node[:, :1], dtype=torch.bool),
                        node[:, 1:] != node[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(change, pos, -1), dim=1).values
    run_pos = pos - run_start + 1
    visit_cnt = _scatter_max(oct.visit_cnt, flat_node,
                             torch.where(valid, run_pos, 0).reshape(-1))
    if comm is not None:   # the whole batch's maxima, in one all-reduce
        merged = comm.all_reduce(
            torch.stack([adder_w, adder_a, mark,
                         visit_cnt.to(adder_w.dtype)]), op="max")
        adder_w, adder_a, mark = merged[0], merged[1], merged[2]
        visit_cnt = merged[3].to(visit_cnt.dtype)

    def update_stats(stats, adder):
        occ = (adder > 0).to(torch.int32)
        stats = torch.maximum(stats, occ * adder)
        stats = stats + mark * (1 - occ) * adder
        return torch.clamp(stats, -100, 1 << 20)

    weight_stats = update_stats(oct.weight_stats, adder_w)
    alpha_stats = update_stats(oct.alpha_stats, adder_a)
    trans_idx = torch.where((weight_stats < 0) | (alpha_stats < 0), -1,
                            oct.trans_idx)
    return dataclasses.replace(oct, weight_stats=weight_stats,
                               alpha_stats=alpha_stats, visit_cnt=visit_cnt,
                               trans_idx=trans_idx)


def ray_march_fineness(cur_step: int, init_fineness: float = 16.0,
                       decay_end_iter: int = 10000) -> float:
    """Annealed march fineness (UpdateRayMarch, PersSampler.cpp:958-967)."""
    if cur_step >= decay_end_iter:
        return 1.0
    progress = float(cur_step) / float(decay_end_iter)
    return float(np.exp(np.log(init_fineness) * (1.0 - progress)))
