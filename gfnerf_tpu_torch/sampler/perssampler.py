"""Perspective octree sampler — device-side state and the per-point warp.

Port of ``gfnerf_tpu/sampler/perssampler.py``: the padded device octree
(``OctreeDevice``), its upload (``octree_to_device``) and the pull of its
mutable state back to the host tree (``octree_from_device``), the tree cut
of the hierarchical march, and the perspective warp ``warp_points`` with its
Jacobian-direction norm, the occupancy statistics of the init stage
(``update_oct_nodes``) and the march-fineness anneal
(``ray_march_fineness``).  The scan march (``get_samples``/
``locate_points``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

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
    of the JAX ``SamplerConfig`` that the fast march reads, with its
    defaults.  ``global_far`` and ``locate_iters`` join with the scan march
    and ``locate_points``."""

    max_samples: int = 1024     # MAX_SAMPLE_PER_RAY
    sample_l: float = 1.0 / 256
    scale_by_dis: bool = True
    global_near: float = 0.01
    march: str = "fast"         # only the leaf-list march is ported
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
                     alphas: torch.Tensor) -> OctreeDevice:
    """Occupancy statistics update (UpdateOctNodes, cu:518-677).

    Per ray: thresholds rel/abs on the ray's max weight/alpha; per visited
    node: +BASE if any sample exceeded, else -1; EMA-like integer stats
    with clamping; nodes whose stats go negative get trans_idx = -1.
    Returns a new OctreeDevice; weights and alphas (R, S) are not
    differentiated.
    """
    cap = oct.centers.shape[0]
    valid = samples.valid
    node = torch.where(valid, samples.oct_idx, cap)   # cap -> dropped
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
