"""Perspective octree construction (host numpy, torch visibility test).

Port of ``gfnerf_tpu/sampler/octree.py``: the numpy builder is copied as it
is, so a tree built from the same cameras and seed is identical array for
array; the jitted visibility test (``_make_visibility_fn``) becomes a torch
function that runs on the caller's device, chunked over the frontier so its
(K, N, P, 3) temporaries stay bounded.
"""

from __future__ import annotations

import dataclasses
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
                             rng: np.random.Generator) -> List[int]:
    """FPS over unit-sphere camera dirs (PersSampler.cpp:638-667)."""
    n = len(normed_pos)
    dis_pairs = np.linalg.norm(
        normed_pos[None, :, :] - normed_pos[:, None, :], axis=-1
    )
    good = [int(rng.integers(n))]
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
    rng: np.random.Generator,
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

    good = _farthest_point_sampling(normed.astype(np.float32), n_virt, rng)

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
    dv_dxyz = np.einsum("pkc,kcj->pkj", dv_dab, frame_trans[:, :, :3])  # (P, 12, 3)

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
    jac_warp2image = np.einsum("pkj,pjc->pkc", dv_dxyz, jac_warp2world)
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
    PersSampler.cpp:541).  The edge pool (``construct_edge_pool``) is not
    ported yet.
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

    frontier = [0]
    while frontier:
        K = len(frontier)
        f_centers = np.stack([centers[u] for u in frontier])
        f_sides = np.array([side_lens[u] for u in frontier], dtype=np.float32)
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
            vdis = np.linalg.norm(cam_pos[vcams] - centers[u][None], axis=-1)
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
                tr = construct_trans(
                    rand_pts, c2w[vcams], intri[0], centers[u], rng
                )
                tr["side_len"] = side
                trans_idx[u] = len(trans_list)
                trans_list.append(tr)
        frontier = next_frontier

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
