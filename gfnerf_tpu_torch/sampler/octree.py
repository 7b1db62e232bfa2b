"""Perspective octree construction and maintenance (host numpy, torch
visibility test).

Port of ``gfnerf_tpu/sampler/octree.py``: the numpy builder and the host
maintenance (``construct_edge_pool``, ``proc_octree``'s compaction and
milestone subdivision, ``mark_invisible_nodes``, ``update_block_idxs``) are
copied as they are, so a tree built or rebuilt from the same inputs is
identical array for array; the jitted visibility test
(``_make_visibility_fn``) becomes a torch function that runs on the
caller's device, chunked over the frontier so its (K, N, P, 3) temporaries
stay bounded.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

N_PROS = 12          # PersSampler.h:15
INIT_NODE_STAT = 1000  # PersSampler.h:14


@dataclasses.dataclass
class PersOctree:
    """Host-side octree state (flat SoA, numpy)."""

    # node arrays, length M
    centers: np.ndarray       # (M, 3) f32
    side_lens: np.ndarray     # (M,) f32
    parents: np.ndarray       # (M,) i32
    childs: np.ndarray        # (M, 8) i32, -1 = none
    is_leaf: np.ndarray       # (M,) bool
    trans_idx: np.ndarray     # (M,) i32, -1 = invalid leaf / internal
    block_idx: np.ndarray     # (M,) i32, -1 = unassigned
    # occupancy stats (mirrors tree_weight/alpha_stats_, visit_cnt_)
    weight_stats: np.ndarray  # (M,) i64
    alpha_stats: np.ndarray   # (M,) i64
    visit_cnt: np.ndarray     # (M,) i64
    # warp (TransInfo) arrays, length T — fixed after construction
    w2xz: np.ndarray          # (T, 12, 2, 4) f32
    weight: np.ndarray        # (T, 3, 12) f32
    t_center: np.ndarray      # (T, 3) f32
    t_dis_summary: np.ndarray  # (T,) f32
    t_side_len: np.ndarray    # (T,) f32
    # edge pool for TV-loss edge samples (ConstructEdgePool)
    edge_t_idx: Optional[np.ndarray] = None    # (E, 2) i32
    edge_center: Optional[np.ndarray] = None   # (E, 3) f32
    edge_dirs: Optional[np.ndarray] = None     # (E, 2, 3) f32

    @property
    def n_nodes(self) -> int:
        return len(self.centers)

    @property
    def n_volumes(self) -> int:
        return len(self.w2xz)


def distance_summary(dis: np.ndarray) -> float:
    """Robust distance summary (PersSampler.cpp:12-26)."""
    dis = np.asarray(dis, dtype=np.float64).reshape(-1)
    if dis.size <= 0:
        return 1e8
    log_dis = np.log(dis)
    thres = np.quantile(log_dis, 0.25)
    mask = (log_dis < thres).astype(np.float64)
    if mask.sum() < 1e-3:
        return float(np.exp(log_dis.mean()))
    return float(np.exp((log_dis * mask).sum() / mask.sum()))


# ------------------------------------------------------------ visibility ----


VISI_CHUNK_ELEMS = 1 << 22   # (boxes x cameras x rays) per visibility chunk


def _make_visibility_fn(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        bounds: torch.Tensor):
    """Frontier-batched visibility test (GetVisiCams, PersSampler.cpp:45-88).

    rays_o (N, 3), rays_d (N, P, 3): a low-res ray grid per camera.  Returns
    fn(centers (K, 3), sides (K,)) -> (K, N) bool numpy visibility matrix.
    The ray-box arithmetic, including the +-1e6 ``nan_to_num`` of the slab
    distances, is the JAX package's, so the tree's shape is the same.
    """
    n, p = rays_d.shape[:2]
    o = rays_o[None, :, None, :]
    d = rays_d[None, :, :, :]
    near_b = bounds[None, :, None, 0]
    far_b = bounds[None, :, None, 1]
    per = max(1, VISI_CHUNK_ELEMS // (n * p))

    def visi(centers: torch.Tensor, sides: torch.Tensor) -> np.ndarray:
        out = []
        for k0 in range(0, centers.shape[0], per):
            c, s = centers[k0:k0 + per], sides[k0:k0 + per]
            lo = (c - s[:, None] * 0.5)[:, None, None, :]
            hi = (c + s[:, None] * 0.5)[:, None, None, :]
            a = torch.nan_to_num((lo - o) / d, nan=0.0, posinf=1e6,
                                 neginf=-1e6)
            b = torch.nan_to_num((hi - o) / d, nan=0.0, posinf=1e6,
                                 neginf=-1e6)
            near = torch.amax(torch.minimum(a, b), dim=-1)   # (k, N, P)
            far = torch.amin(torch.maximum(a, b), dim=-1)
            far = torch.minimum(far, far_b)
            near = torch.maximum(near, near_b)
            out.append((far > near).any(dim=-1))              # (k, N)
        return torch.cat(out).cpu().numpy()

    return visi


def _camera_ray_grid(c2w: np.ndarray, intri: np.ndarray, res_w: int = 128):
    """Low-res pixel ray directions for every camera (PersSampler.cpp:51-67)."""
    cx = float(intri[0, 0, 2])
    cy = float(intri[0, 1, 2])
    fx = float(intri[0, 0, 0])
    fy = float(intri[0, 1, 1])
    half_w, half_h = cx, cy
    res_h = int(round(res_w / half_w * half_h))
    i = np.linspace(0.5, half_h * 2.0 - 0.5, res_h, dtype=np.float32)
    j = np.linspace(0.5, half_w * 2.0 - 0.5, res_w, dtype=np.float32)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    cam_coords = np.stack(
        [(jj - cx) / fx, -(ii - cy) / fy, -np.ones_like(jj)], axis=-1
    )  # (P, 3)
    rays_d = np.einsum("nij,pj->npi", c2w[:, :3, :3], cam_coords)
    rays_o = c2w[:, :3, 3]
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


# -------------------------------------------------------- ConstructTrans ----


def _farthest_point_sampling(normed_pos: np.ndarray, k: int,
                             start: int) -> List[int]:
    """FPS over unit-sphere camera dirs (PersSampler.cpp:638-667), from
    camera ``start`` (the builder draws it: ``rng.integers(n)``)."""
    n = len(normed_pos)
    dis_pairs = np.linalg.norm(
        normed_pos[None, :, :] - normed_pos[:, None, :], axis=-1
    )
    good = [start]
    marks = np.zeros(n, dtype=bool)
    marks[good[0]] = True
    for _ in range(1, min(k, n)):
        cur_dis = dis_pairs[:, marks].min(axis=1)
        cur_dis[marks] = -1.0
        candi = int(np.argmax(cur_dis))
        marks[candi] = True
        good.append(candi)
    # pad by repetition when there are fewer cameras (PersSampler.cpp:670-673)
    i = 0
    while len(good) < k:
        good.append(good[i])
        i += 1
    return good


def _rotation_aligning(from_z: np.ndarray, to_z: np.ndarray) -> np.ndarray:
    """Axis-angle rotation taking from_z toward to_z (PersSampler.cpp:695-746)."""
    crossed = np.cross(from_z, to_z)
    cos_val = float(np.dot(from_z, to_z))
    sin_val = float(np.linalg.norm(crossed))
    sin_val = max(-0.999999, min(sin_val, 0.999999))
    cos_val = max(-0.999999, min(cos_val, 0.999999))
    angle = np.arcsin(sin_val)
    if cos_val < 0.0:
        angle = np.pi - angle
    axis_norm = np.linalg.norm(crossed)
    if axis_norm < 1e-12:
        return np.eye(3, dtype=np.float64)
    axis = crossed / axis_norm
    # Rodrigues
    kx, ky, kz = axis
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]], dtype=np.float64)
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def construct_trans(
    rand_pts: np.ndarray,   # (P, 3) uniform points inside the node cube
    c2w: np.ndarray,        # (V, 3, 4) visible cameras
    intri: np.ndarray,      # (3, 3) shared intrinsics
    center: np.ndarray,     # (3,)
    start: int,             # the first camera of the farthest-point pick
):
    """Build one leaf's perspective warp (ConstructTrans, PersSampler.cpp:613-831).

    Returns dict(w2xz (12,2,4), weight (3,12), center, dis_summary).
    """
    n_virt = N_PROS // 2
    cam_pos = c2w[:, :3, 3].astype(np.float64)
    cam_axes = np.linalg.inv(c2w[:, :3, :3].astype(np.float64))
    center = center.astype(np.float64)

    dis = np.linalg.norm(cam_pos - center[None], axis=-1)
    dis_sum = distance_summary(dis)
    normed = (cam_pos - center[None]) / dis[:, None]

    good = _farthest_point_sampling(normed.astype(np.float32), n_virt, start)

    cam_scale = np.clip(dis / dis_sum, 1.0, 1e9)
    rel_cam_pos = (cam_pos - center[None]) / dis[:, None] * np.clip(
        dis[:, None], dis_sum, 1e9
    )

    good = np.asarray(good)
    good_cam_pos = rel_cam_pos[good] + center[None]
    good_rel = rel_cam_pos[good]
    good_axis = cam_axes[good]
    good_scale = cam_scale[good]

    expect_z = good_rel / np.linalg.norm(good_rel, axis=-1, keepdims=True)
    rots = np.stack(
        [_rotation_aligning(good_axis[i, 2], expect_z[i]) for i in range(n_virt)]
    )
    good_axis = good_axis @ np.transpose(rots, (0, 2, 1))

    x_axis = good_axis[:, 0, :].copy()
    y_axis = good_axis[:, 1, :].copy()
    z_axis = good_axis[:, 2, :].copy()

    focal = float(intri[0, 0] / intri[0, 2])
    x_axis *= focal * good_scale[:, None]
    y_axis *= focal * good_scale[:, None]
    x_axis = np.concatenate([x_axis, y_axis], axis=0)    # (12, 3)
    z_axis = np.concatenate([z_axis, z_axis], axis=0)    # (12, 3)
    wp_cam_pos = np.concatenate([good_cam_pos, good_cam_pos], axis=0)

    frame_trans = np.zeros((N_PROS, 2, 4), dtype=np.float64)
    frame_trans[:, 0, :3] = x_axis
    frame_trans[:, 1, :3] = z_axis
    frame_trans[:, 0, 3] = -(x_axis * wp_cam_pos).sum(-1)
    frame_trans[:, 1, 3] = -(z_axis * wp_cam_pos).sum(-1)

    pts = rand_pts.astype(np.float64)
    # (P, 12, 2) projective coords
    transed = np.einsum("kij,pj->pki", frame_trans[:, :, :3], pts) + frame_trans[None, :, :, 3]
    dv_da = 1.0 / transed[:, :, 1]
    dv_db = transed[:, :, 0] / -(transed[:, :, 1] ** 2)
    dv_dab = np.stack([dv_da, dv_db], axis=-1)  # (P, 12, 2)
    # einsum("pkc,kcj->pkj", dv_dab, frame_trans[:, :, :3]), its sum written
    # out in the same order (the same bits, twice as fast)
    ft = frame_trans[:, :, :3]
    dv_dxyz = (dv_dab[..., 0, None] * ft[None, :, 0, :]
               + dv_dab[..., 1, None] * ft[None, :, 1, :])     # (P, 12, 3)

    ratio = transed[:, :, 0] / transed[:, :, 1]  # (P, 12)

    # PCA (PersSampler.cpp:592-611): top-3 eigvecs of the covariance
    mean = ratio.mean(axis=0, keepdims=True)
    moved = ratio - mean
    cov = (moved[:, :, None] * moved[:, None, :]).mean(axis=0)
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    V = evecs[:, order][:, :3].T  # (3, 12)

    jac = np.einsum("ck,pkj->pcj", V, dv_dxyz)      # (P, 3, 3)
    jac_warp2world = np.linalg.inv(jac)
    # einsum("pkj,pjc->pkc", dv_dxyz, jac_warp2world), written out as above
    jac_warp2image = (
        dv_dxyz[:, :, 0, None] * jac_warp2world[:, None, 0, :]
        + dv_dxyz[:, :, 1, None] * jac_warp2world[:, None, 1, :]
        + dv_dxyz[:, :, 2, None] * jac_warp2world[:, None, 2, :])
    jac_max = np.abs(jac_warp2image).max(axis=1)    # (P, 3)
    exp_step = 1.0 / jac_max
    mean_step = exp_step.mean(axis=0)               # (3,)
    V = V / mean_step[:, None]

    return {
        "w2xz": frame_trans.astype(np.float32),
        "weight": V.astype(np.float32),
        "center": center.astype(np.float32),
        "dis_summary": float(dis_sum),
    }


def build_octree(
    c2w: np.ndarray,       # (N, 3, 4)
    intri: np.ndarray,     # (N, 3, 3)
    bounds: np.ndarray,    # (N, 2) per-camera [near, far]
    max_depth: int = 16,
    bbox_levels: int = 10,
    split_dist_thres: float = 1.5,
    seed: int = 0,
    n_rand_pts: int = 32 * 32 * 32,
    vis_res_w: int = 128,
    device="cuda",
) -> PersOctree:
    """Construct the perspective octree from training cameras.

    BFS frontier construction; per-frontier visibility is one batched torch
    call on ``device`` (the reference does one GPU tensor pass per node,
    PersSampler.cpp:541).  The leaves draw their random points and first
    cameras from one generator in the JAX package's order; their warps
    (numpy, most of the build's time) are built on a thread pool while the
    frontiers go on.
    """
    rng = np.random.default_rng(seed)
    bbox_side_len = float(1 << (bbox_levels - 1))  # PersSampler.cpp:921

    rays_o, rays_d = _camera_ray_grid(c2w, intri, res_w=vis_res_w)
    visi_fn = _make_visibility_fn(
        torch.as_tensor(rays_o, device=device),
        torch.as_tensor(rays_d, device=device),
        torch.as_tensor(np.asarray(bounds, np.float32), device=device))
    cam_pos = c2w[:, :3, 3]

    centers: List[np.ndarray] = [np.zeros(3, dtype=np.float32)]
    side_lens: List[float] = [bbox_side_len]
    parents: List[int] = [-1]
    depth_of: List[int] = [0]
    childs: List[np.ndarray] = [np.full(8, -1, dtype=np.int32)]
    is_leaf: List[bool] = [False]
    trans_idx: List[int] = [-1]
    trans_list: List[dict] = []

    warps = []   # (node, the future of its warp), in trans_idx order
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        frontier = [0]
        while frontier:
            K = len(frontier)
            f_centers = np.stack([centers[u] for u in frontier])
            f_sides = np.array([side_lens[u] for u in frontier],
                               dtype=np.float32)
            visi = visi_fn(torch.as_tensor(f_centers, device=device),
                           torch.as_tensor(f_sides, device=device))

            next_frontier: List[int] = []
            for k in range(K):
                u = frontier[k]
                depth = depth_of[u]
                if depth > max_depth:
                    is_leaf[u] = True
                    continue
                vcams = np.where(visi[k])[0]
                vdis = np.linalg.norm(cam_pos[vcams] - centers[u][None],
                                      axis=-1)
                dis_sum = distance_summary(vdis)
                side = side_lens[u]
                unaddressed = (len(vcams) >= N_PROS // 2) and (
                    dis_sum < side * split_dist_thres
                )
                if unaddressed:
                    for st in range(8):
                        offset = np.array(
                            [((st >> 2) & 1) - 0.5, ((st >> 1) & 1) - 0.5,
                             (st & 1) - 0.5],
                            dtype=np.float32,
                        )
                        v = len(centers)
                        centers.append(centers[u] + side * 0.5 * offset)
                        side_lens.append(side * 0.5)
                        parents.append(u)
                        depth_of.append(depth + 1)
                        childs.append(np.full(8, -1, dtype=np.int32))
                        is_leaf.append(False)
                        trans_idx.append(-1)
                        childs[u][st] = v
                        next_frontier.append(v)
                elif len(vcams) < N_PROS // 2:
                    is_leaf[u] = True
                else:
                    is_leaf[u] = True
                    rand_pts = (
                        rng.random((n_rand_pts, 3)).astype(np.float32) - 0.5
                    ) * side + centers[u][None]
                    start = int(rng.integers(len(vcams)))
                    trans_idx[u] = len(warps)
                    warps.append((u, pool.submit(
                        construct_trans, rand_pts, c2w[vcams], intri[0],
                        centers[u], start)))
            frontier = next_frontier
        for u, warp in warps:
            tr = warp.result()
            tr["side_len"] = side_lens[u]
            trans_list.append(tr)

    M = len(centers)
    T = max(len(trans_list), 1)
    tree = PersOctree(
        centers=np.stack(centers).astype(np.float32),
        side_lens=np.asarray(side_lens, dtype=np.float32),
        parents=np.asarray(parents, dtype=np.int32),
        childs=np.stack(childs).astype(np.int32),
        is_leaf=np.asarray(is_leaf, dtype=bool),
        trans_idx=np.asarray(trans_idx, dtype=np.int32),
        block_idx=np.full(M, -1, dtype=np.int32),
        weight_stats=np.full(M, INIT_NODE_STAT, dtype=np.int64),
        alpha_stats=np.full(M, INIT_NODE_STAT, dtype=np.int64),
        visit_cnt=np.zeros(M, dtype=np.int64),
        w2xz=(np.stack([t["w2xz"] for t in trans_list])
              if trans_list else np.zeros((1, N_PROS, 2, 4), np.float32)),
        weight=(np.stack([t["weight"] for t in trans_list])
                if trans_list else np.zeros((1, 3, N_PROS), np.float32)),
        t_center=(np.stack([t["center"] for t in trans_list])
                  if trans_list else np.zeros((1, 3), np.float32)),
        t_dis_summary=(np.asarray([t["dis_summary"] for t in trans_list],
                                  dtype=np.float32)
                       if trans_list else np.ones((1,), np.float32)),
        t_side_len=(np.asarray([t["side_len"] for t in trans_list],
                               dtype=np.float32)
                    if trans_list else np.ones((1,), np.float32)),
    )
    return tree


def construct_edge_pool(tree: PersOctree) -> None:
    """Face-adjacency edge samples for TV loss (ConstructEdgePool,
    PersSampler.cpp:833-895). Vectorized over valid-leaf pairs."""
    valid = np.where(tree.trans_idx >= 0)[0]
    if len(valid) < 2:
        tree.edge_t_idx = np.zeros((0, 2), np.int32)
        tree.edge_center = np.zeros((0, 3), np.float32)
        tree.edge_dirs = np.zeros((0, 2, 3), np.float32)
        return
    c = tree.centers[valid]
    s = tree.side_lens[valid]
    t = tree.trans_idx[valid]
    E_idx, E_center, E_dirs = [], [], []
    # for each axis and sign, test face-center containment in the other leaf
    face_axes = [(0, (1, 2)), (1, (0, 2)), (2, (0, 1))]
    n = len(valid)
    for ax, (d0, d1) in face_axes:
        for sign in (1.0, -1.0):
            for i in range(n):
                len_u = s[i] * 0.5
                pt = c[i].copy()
                pt[ax] += sign * len_u
                # vectorized containment in all larger-or-equal leaves
                bias = np.abs(pt[None, :] - c) / s[:, None] * 2.0
                inside = (bias.max(axis=1) < 1.0 + 1e-4) & (s >= s[i])
                inside[i] = False
                for j in np.where(inside)[0]:
                    a, b = (i, j) if i < j else (j, i)
                    dirs = np.zeros((2, 3), np.float32)
                    dirs[0, d0] = len_u
                    dirs[1, d1] = len_u
                    E_idx.append((t[a], t[b]))
                    E_center.append(pt)
                    E_dirs.append(dirs)
    tree.edge_t_idx = (np.asarray(E_idx, np.int32)
                       if E_idx else np.zeros((0, 2), np.int32))
    tree.edge_center = (np.stack(E_center).astype(np.float32)
                        if E_center else np.zeros((0, 3), np.float32))
    tree.edge_dirs = (np.stack(E_dirs).astype(np.float32)
                      if E_dirs else np.zeros((0, 2, 3), np.float32))


# --------------------------------------------------- compact / subdivide ----


def proc_octree(tree: PersOctree, compact: bool, subdivide: bool,
                brute_force: bool) -> PersOctree:
    """Compact invalid leaves and/or subdivide visited valid leaves.

    Mirrors ``PersOctree::ProcOctree`` (PersSampler.cpp:154-417) minus path
    compression (see the JAX package's module docstring). Operates on host
    numpy arrays and returns a new tree.
    """
    M = tree.n_nodes
    childs = tree.childs.copy()
    is_leaf = tree.is_leaf.copy()
    trans = tree.trans_idx.copy()

    if compact:
        # remove invalid leaves from their parents; iterate upward until fixpoint
        while True:
            for u in range(M):
                if is_leaf[u] and trans[u] < 0 and tree.parents[u] >= 0:
                    p = tree.parents[u]
                    childs[p][childs[p] == u] = -1
            changed = False
            for u in range(1, M):
                if not (childs[u] >= 0).any():
                    if not is_leaf[u]:
                        changed = True
                    is_leaf[u] = True
            if not changed:
                break

    keep = (~is_leaf) | (trans >= 0)
    keep[0] = True
    new_idx = np.full(M, -1, dtype=np.int64)
    new_idx[keep] = np.arange(keep.sum())
    inv_idx = np.where(keep)[0]

    n_centers = tree.centers[keep]
    n_sides = tree.side_lens[keep]
    n_parents = tree.parents[keep]
    n_childs = childs[keep]
    n_isleaf = is_leaf[keep]
    n_trans = trans[keep]
    n_block = tree.block_idx[keep]
    n_wstat = tree.weight_stats[keep]
    n_astat = tree.alpha_stats[keep]
    # remap parent/child indices
    mask_p = n_parents >= 0
    n_parents[mask_p] = new_idx[n_parents[mask_p]].astype(np.int32)
    mask_c = n_childs >= 0
    n_childs[mask_c] = new_idx[n_childs[mask_c]].astype(np.int32)

    if subdivide:
        out = {k: [] for k in
               ("centers", "sides", "parents", "childs", "isleaf", "trans",
                "block", "wstat", "astat")}

        def push(center, side, parent, ch, leaf, tr, bl, ws, as_):
            out["centers"].append(center)
            out["sides"].append(side)
            out["parents"].append(parent)
            out["childs"].append(ch)
            out["isleaf"].append(leaf)
            out["trans"].append(tr)
            out["block"].append(bl)
            out["wstat"].append(ws)
            out["astat"].append(as_)
            return len(out["centers"]) - 1

        visit = tree.visit_cnt

        def subdiv(u, pa):
            new_u = push(n_centers[u], n_sides[u], pa, n_childs[u].copy(),
                         n_isleaf[u], n_trans[u], n_block[u], n_wstat[u],
                         n_astat[u])
            if n_isleaf[u]:
                if n_trans[u] < 0:
                    raise ValueError(f"invalid leaf {u} kept by compaction")
                if not brute_force and visit[inv_idx[u]] <= 4:
                    return new_u
                for st in range(8):
                    offset = np.array(
                        [((st >> 2) & 1) - 0.5, ((st >> 1) & 1) - 0.5,
                         (st & 1) - 0.5], dtype=np.float32)
                    v = push(
                        out["centers"][new_u]
                        + out["sides"][new_u] * 0.5 * offset,
                        out["sides"][new_u] * 0.5, new_u,
                        np.full(8, -1, np.int32), True,
                        out["trans"][new_u], out["block"][new_u],
                        out["wstat"][new_u], out["astat"][new_u])
                    out["childs"][new_u][st] = v
                out["isleaf"][new_u] = False
                out["trans"][new_u] = -1
                out["wstat"][new_u] = INIT_NODE_STAT
                out["astat"][new_u] = INIT_NODE_STAT
            else:
                for st in range(8):
                    if out["childs"][new_u][st] >= 0:
                        out["childs"][new_u][st] = subdiv(
                            out["childs"][new_u][st], new_u)
            return new_u

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 100000))
        try:
            subdiv(0, -1)
        finally:
            sys.setrecursionlimit(old_limit)
        n_centers = np.stack(out["centers"]).astype(np.float32)
        n_sides = np.asarray(out["sides"], np.float32)
        n_parents = np.asarray(out["parents"], np.int32)
        n_childs = np.stack(out["childs"]).astype(np.int32)
        n_isleaf = np.asarray(out["isleaf"], bool)
        n_trans = np.asarray(out["trans"], np.int32)
        n_block = np.asarray(out["block"], np.int32)
        n_wstat = np.asarray(out["wstat"], np.int64)
        n_astat = np.asarray(out["astat"], np.int64)

    return dataclasses.replace(
        tree,
        centers=n_centers,
        side_lens=n_sides,
        parents=n_parents.astype(np.int32),
        childs=n_childs.astype(np.int32),
        is_leaf=n_isleaf,
        trans_idx=n_trans.astype(np.int32),
        block_idx=n_block.astype(np.int32),
        weight_stats=n_wstat,
        alpha_stats=n_astat,
        visit_cnt=np.zeros(len(n_centers), dtype=np.int64),
    )


def mark_invisible_nodes(tree: PersOctree, c2w: np.ndarray, w2c: np.ndarray,
                         intri: np.ndarray, bounds: np.ndarray) -> None:
    """Invalidate nodes seen by no camera (MarkInvisibleNodesKernel,
    PersSampler_cuda.cu:680-742). Vectorized numpy; mutates trans_idx."""
    centers = tree.centers          # (M, 3)
    radius = tree.side_lens * 0.707
    # cam points: (C, M, 3)
    cam_pt = (np.einsum("cij,mj->cmi", w2c[:, :3, :3], centers)
              + w2c[:, None, :3, 3])
    z = -cam_pt[..., 2]
    vis = ~((z < bounds[:, None, 0] - radius[None]) |
            (z > bounds[:, None, 1] + radius[None]))
    near_origin = np.linalg.norm(cam_pt, axis=-1) < radius[None]
    fx = intri[:, 0, 0][:, None]
    fy = intri[:, 1, 1][:, None]
    cx = intri[:, 0, 2][:, None]
    cy = intri[:, 1, 2][:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        bias_x = radius[None] / z * fx
        bias_y = radius[None] / z * fy
        img_x = cam_pt[..., 0] / z * fx
        img_y = cam_pt[..., 1] / z * fy
    in_img = ~((img_x + bias_x < -cx) | (img_x > cx + bias_x) |
               (img_y + bias_y < -cy) | (img_y > cy + bias_y))
    visible = vis & (near_origin | in_img)
    n_vis = visible.sum(axis=0)
    tree.trans_idx[n_vis < 1] = -1


def update_block_idxs(tree: PersOctree, block_centers: np.ndarray) -> None:
    """Assign each node to the nearest block center (SetBlockIdxsNearestKernel,
    PersSampler_cuda.cu:746-798)."""
    d = np.linalg.norm(
        tree.centers[:, None, :] - block_centers[None, :, :], axis=-1)
    tree.block_idx = np.argmin(d, axis=1).astype(np.int32)
