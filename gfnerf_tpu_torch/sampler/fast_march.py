"""Vectorized leaf-list ray march.

Port of ``gfnerf_tpu/sampler/fast_march.py``: a brute-force ray x valid-leaf
slab test (or, with ``coarse_hits > 0``, a slab test of the tree cut that
expands only the nearest cut nodes' leaf lists), the H nearest hits per ray,
one warp-Jacobian step per (ray, leaf) at the entry point, and samples placed
on the jittered lattice ``t_k = near + step * (k + noise_k)``.  The JAX
package's ``lax.map`` over ray chunks is a Python loop here.

The top-k keeps ``jax.lax.top_k``'s tie order (the lower leaf slot first):
the entry distance and the slot are packed into one int64 key that sorts
ties by slot, so equal entry distances pick the same leaves as the JAX march.
"""

from __future__ import annotations

import torch

from gfnerf_tpu_torch.cameras.rays import WarpedSamples
from gfnerf_tpu_torch.sampler.perssampler import (
    OctreeDevice,
    SamplerConfig,
    _jacobian_norm,
)


def _topk_nearest(key: torch.Tensor, k: int):
    """The k smallest of key (B, N) per row, ties to the lower index.

    Returns (values (B, k), indices (B, k)), ascending, as
    ``jax.lax.top_k(-key, k)`` orders them."""
    n = key.shape[1]
    bits = key.contiguous().view(torch.int32).to(torch.int64)
    # order-preserving map of float bits onto signed ints
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(n, device=key.device, dtype=torch.int64)
    packed = mono * (1 << 32) + idx
    _, pos = torch.topk(packed, k, dim=1, largest=False, sorted=True)
    return torch.gather(key, 1, pos), pos


def _slab(o, inv, centers, sides, ok, global_near):
    """AABB slab test of rays (B, 3) against boxes (N, 3) shared by all rays
    or (B, N, 3) per ray.  Returns (near, far, hit), each (B, N)."""
    lo = centers - sides[..., None] * 0.5
    hi = centers + sides[..., None] * 0.5
    if centers.dim() == 2:
        lo, hi = lo[None], hi[None]
    t0 = (lo - o[:, None]) * inv[:, None]
    t1 = (hi - o[:, None]) * inv[:, None]
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    near = torch.clamp(near, min=global_near)
    return near, far, ok & (far > near)


def get_samples_fast(
    oct: OctreeDevice,
    rays_o: torch.Tensor,   # (R, 3)
    rays_d: torch.Tensor,   # (R, 3)
    noise: torch.Tensor,    # (R, S) in [0.5, 1.5] (unscaled by fineness)
    fineness,               # float or 0-d tensor: march fineness multiplier
    cfg: SamplerConfig,
) -> WarpedSamples:
    R, S = noise.shape
    H = cfg.max_hits
    dev = rays_o.device
    fineness = torch.as_tensor(fineness, dtype=torch.float32, device=dev)
    sl_f = cfg.sample_l * fineness
    d_all = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    leaf_nodes = oct.leaf_idx.long()                      # (L,) -1 pad
    safe_leaf = leaf_nodes.clamp(min=0)
    lc = oct.centers[safe_leaf]
    ls = oct.side_lens[safe_leaf]
    ltrans = torch.where(leaf_nodes >= 0, oct.trans_idx[safe_leaf].long(), -1)
    lblock = oct.block_idx[safe_leaf].long()
    leaf_ok = (leaf_nodes >= 0) & (ltrans >= 0)
    T = oct.w2xz.shape[0]

    M = min(cfg.coarse_hits, int(oct.cut_nodes.shape[0]))
    if M > 0:
        cutn = oct.cut_nodes.long()
        safe_cut = cutn.clamp(min=0)
        cut_c = oct.centers[safe_cut]
        cut_s = oct.side_lens[safe_cut]
        cut_ok = cutn >= 0
        cut_slots = oct.cut_leaf_slots.long()

    s_idx = torch.arange(S, device=dev)[None, :]            # (1, S)

    def chunk_fn(o, d, nz):
        small = torch.where(d >= 0, 1e-10, -1e-10)
        inv = 1.0 / torch.where(d.abs() < 1e-10, small, d)
        if M > 0:
            # phase 1: slab test the tree cut, keep the nearest M
            near_c, _, hit_c = _slab(o, inv, cut_c, cut_s, cut_ok[None],
                                     cfg.global_near)
            cut_dropped = hit_c.sum(dim=1) > M
            key_c = torch.where(hit_c, near_c, torch.inf)
            near_m, cidx = _topk_nearest(key_c, M)
            got_c = torch.isfinite(near_m)
            cand = torch.where(got_c[..., None], cut_slots[cidx], -1)
            cand = cand.reshape(cand.shape[0], -1)          # (B, M*F)
            csafe = cand.clamp(min=0)
            # phase 2: slab test only the candidate leaves
            ok2 = (cand >= 0) & leaf_ok[csafe]
            near, far, hit = _slab(o, inv, lc[csafe], ls[csafe], ok2,
                                   cfg.global_near)
            sel_nodes, sel_trans, sel_block = (
                leaf_nodes[csafe], ltrans[csafe], lblock[csafe])
        else:
            near, far, hit = _slab(o, inv, lc, ls, leaf_ok[None],
                                   cfg.global_near)

        key = torch.where(hit, near, torch.inf)
        near_k, slot = _topk_nearest(key, H)               # (B, H)
        got = torch.isfinite(near_k)
        near_h = torch.where(got, near_k, 0.0)
        far_h = torch.where(got, torch.gather(far, 1, slot), 0.0)
        if M > 0:
            node_h = torch.gather(sel_nodes, 1, slot)
            trans_h = torch.where(got, torch.gather(sel_trans, 1, slot), -1)
            block_h = torch.gather(sel_block, 1, slot)
        else:
            node_h = leaf_nodes[slot]
            trans_h = torch.where(got, ltrans[slot], -1)
            block_h = lblock[slot]
        trc = trans_h.clamp(0, T - 1)

        # per-(ray, leaf) step size from the entry-point Jacobian
        p_entry = o[:, None, :] + near_h[..., None] * d[:, None, :]
        jn = _jacobian_norm(oct.w2xz_flat[trc], oct.warp_weight_flat[trc],
                            p_entry, d[:, None, :].expand_as(p_entry)) + 1e-6
        radius = torch.linalg.norm(o[:, None, :] - oct.t_center[trc],
                                   dim=-1) / oct.t_dis_summary[trc]
        radius = radius.clamp(min=1.0)
        base = sl_f / jn
        if cfg.scale_by_dis:
            base = base * radius
        base = torch.where(got & torch.isfinite(base), base, 1.0)

        # sample counts + slot assignment
        n_h = torch.where(got, torch.floor((far_h - near_h) / base), 0.0)
        n_h = n_h.clamp(0, S).to(torch.int32)
        prefix = torch.cumsum(n_h, dim=1, dtype=torch.int32) - n_h
        n_h = torch.minimum(n_h, (S - prefix).clamp(min=0))
        ends = prefix + n_h                                 # non-decreasing
        # leaf per slot: j = #{h : ends_h <= s}
        slots = s_idx.to(torch.int32).expand(ends.shape[0], S).contiguous()
        j = torch.searchsorted(ends, slots, right=True)
        got_s = s_idx < ends[:, -1:]
        j = j.clamp(max=H - 1)

        def pick(x):
            return torch.gather(x, 1, j)

        near_s, base_s, radius_s = pick(near_h), pick(base), pick(radius)
        prefix_s = pick(prefix)
        trans_s = torch.where(got_s, pick(trans_h), -1)
        node_s = torch.where(got_s, pick(node_h), -1)
        block_s = torch.where(got_s, pick(block_h), -1)

        k_rel = (s_idx - prefix_s).to(torch.float32)       # within-leaf index
        t_s = near_s + base_s * (k_rel + nz)
        world = o[:, None, :] + t_s[..., None] * d[:, None, :]
        dt_s = sl_f * nz
        if cfg.scale_by_dis:
            dt_s = dt_s * radius_s

        valid = got_s & (s_idx > 0)                         # drop slot 0
        first_oct = torch.where(got[:, 0], near_h[:, 0], 1e9)
        num_hit = hit.sum(dim=1)
        if M > 0:
            num_hit = torch.where(cut_dropped, num_hit.clamp(min=H + 1),
                                  num_hit)
        return (
            torch.where(valid[..., None], world, 0.0),
            torch.where(valid, dt_s, 0.0),
            torch.where(valid, t_s, 0.0),
            torch.where(valid, trans_s, -1),
            torch.where(valid, node_s, -1),
            torch.where(valid, block_s, -1),
            valid,
            first_oct,
            num_hit,
        )

    B = min(cfg.ray_chunk, R)
    outs = [chunk_fn(rays_o[i:i + B], d_all[i:i + B], noise[i:i + B])
            for i in range(0, R, B)]
    world, dists, ts, trans, node, block, valid, first_oct, num_hits = [
        torch.cat(xs) for xs in zip(*outs)]
    return WarpedSamples(
        world_pts=world,
        dists=dists,
        ts=ts,
        trans_idx=trans,
        oct_idx=node,
        block_idx=block,
        valid=valid,
        num_valid=valid.sum(dim=-1),
        first_oct_dis=first_oct,
        num_hits=num_hits,
    )
