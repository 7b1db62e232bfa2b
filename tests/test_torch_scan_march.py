"""The port's scan march (``gfnerf_tpu_torch/sampler/perssampler.py``
``get_samples`` with ``locate_points``, the plain version of kernel M1,
``ops/scan_march.py``) against the JAX package's on the CPU, and the model
on its samples: ``locate_points``; ``get_samples`` at S = 64 and 256,
and at kernel M1's edges (S = 1 and 33, one ray, rays that miss the root,
zero direction components);
``get_edge_samples`` with the JAX package's draws handed over;
``tv_edge_loss``; the port's fast march against its scan, as
tests/test_fast_march.py holds the JAX pair, and the two pairs' coverage
figures against each other; ``model_forward`` on scan
samples (their ``warp_pts`` read, not warped again) in the dense,
compacted and proposal branches at both stages; whole train steps with
``march="scan"``; ``make_render_fn`` and the early-termination renderer on
the scan; the config's ``march`` through ``config.json`` and a CPU run of
``python -m gfnerf_tpu_torch.train`` with it.  On a card (``cuda``): M1
against the plain scan, also at R = 1, 3 and 8193, S = 1, 33 and 1024,
on rays that miss the root and on rays whose anchor changes at most
slots.

Sizes: the tiny scene of tests/torch_parity.py (six ring views, a depth-5
tree), 64 rays.  Tolerances, and why:
- ``locate_points``: exact (comparisons and halvings of powers of two).
- ``get_samples``: the rays whose valid, trans, oct or block rows differ
  from JAX's at most 2% (measured 0 of 64 at S = 64 and at S = 256: a
  point within an ulp of a cube's centre plane may descend elsewhere,
  since XLA:CPU contracts the march's products into multiply-adds of its
  own choosing; the port forms ``o + t d``, the warp's weighted sums and
  the squared lengths as multiply-adds, which brought 95-100% of the
  points, distances and first hits to JAX's bits); every other ray's
  ts, dists, points and warped points to 1e-5 (measured 1.3e-6 absolute).
- Edge samples: 1e-6 (XLA may contract the two products into the
  centre); ``tv_edge_loss``: 1e-5 relative.
- The model on JAX's scan samples: render outputs 1e-5 (the compaction
  tests' tolerance); the proposal branch 5e-5 of the largest but on one
  ray (test_torch_proposal's: the blocked cumsum's bin edges).
- Train steps: test_torch_compaction's (losses 1e-5 relative, the MLP
  gradients 1e-3 of the group's largest, the table's 2e-2).
- M1 on the card: the rays whose rows differ at most 0.1% (bit for bit is
  expected: M1 repeats the plain version's roundings), 1e-5 relative on
  the rest; at the edge cases bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_parity import (TRAIN_S, field_pair, jax_groups, jax_samples,
                          jax_train_step, octree_pair, port_samples,
                          port_train_step, tiny_rays, to_np, train_batch)

N_RAYS = 64
SAMPLE_L = 1.0 / 64
ROW_KEYS = ("valid", "trans_idx", "oct_idx", "block_idx")
VALUE_KEYS = ("ts", "dists", "world_pts", "warp_pts")
DIFFERING_RAYS = 0.02
PROBE = dict(use_proposal=True, proposal_levels=3, proposal_rows_log2=9)


def _noise(s, fineness, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, (N_RAYS, s)) * fineness).astype(np.float32)


@functools.lru_cache(maxsize=None)
def scan_pair(s, fineness):
    """(JAX samples, port samples) of the scan march of the tiny scene's
    rays, as numpy dicts."""
    o, d = tiny_rays(n_rays=N_RAYS, seed=3)
    return _samples_pair(o, d, _noise(s, fineness), s)


def _samples_pair(o, d, noise, s):
    """(JAX samples, port samples) of the scan march of rays o, d with the
    given noise on the tiny scene's octree, as numpy dicts."""
    import jax.numpy as jnp
    from gfnerf_tpu.sampler import perssampler as J
    from gfnerf_tpu_torch.sampler import perssampler as T

    joct, toct = octree_pair()
    js = J.get_samples(joct, jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(noise),
                       J.SamplerConfig(max_samples=s, sample_l=SAMPLE_L,
                                       march="scan"))
    ts = T.get_samples(toct, torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(noise),
                       T.SamplerConfig(max_samples=s, sample_l=SAMPLE_L,
                                       march="scan"))
    keys = ROW_KEYS + VALUE_KEYS + ("num_valid", "first_oct_dis")
    return ({k: np.asarray(getattr(js, k)) for k in keys},
            {k: to_np(getattr(ts, k)) for k in keys})


def differing_rays(want, got):
    """The rays whose valid, trans, oct or block rows differ."""
    bad = np.zeros(want["valid"].shape[0], bool)
    for k in ROW_KEYS:
        bad |= (want[k] != got[k]).reshape(len(bad), -1).any(1)
    return bad


def test_locate_points_matches_jax():
    """Points inside the root cube (on random leaves' cube centres, which
    lie on their parents' centre planes, and uniform ones) and outside:
    every output equal."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.sampler import perssampler as J
    from gfnerf_tpu_torch.sampler import perssampler as T

    joct, toct = octree_pair()
    rng = np.random.default_rng(0)
    c, h = to_np(toct.centers[0]), float(toct.side_lens[0]) / 2
    n = toct.n_nodes
    pts = np.concatenate([
        rng.uniform(c - 1.2 * h, c + 1.2 * h, (400, 3)),
        to_np(toct.centers[:n])[rng.integers(0, n, 100)]]).astype(np.float32)
    want = jax.jit(J.locate_points, static_argnums=2)(joct,
                                                       jnp.asarray(pts), 24)
    got = T.locate_points(toct, torch.as_tensor(pts), 24)
    for name, w, g in zip(("node", "centre", "side", "trans", "block"),
                          want, got):
        np.testing.assert_array_equal(to_np(g), np.asarray(w), err_msg=name)
    assert (to_np(got[3]) >= 0).sum() > 50 and (to_np(got[3]) < 0).sum() > 50


@pytest.mark.parametrize("s,fineness", [(64, 1.0), (256, 8.0)])
def test_get_samples_matches_jax(s, fineness):
    """The scan march against the JAX package's on the same rays and
    noise: at most 2% of the rays differ in their rows, the rest to
    1e-5."""
    want, got = scan_pair(s, fineness)
    bad = differing_rays(want, got)
    assert bad.mean() <= DIFFERING_RAYS, bad.sum()
    ok = ~bad
    assert want["valid"][ok].sum() > 10 * N_RAYS
    for k in VALUE_KEYS + ("first_oct_dis",):
        np.testing.assert_allclose(got[k][ok], want[k][ok], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["num_valid"][ok],
                                  want["num_valid"][ok])
    # the masked slots are zero and -1, as JAX's
    assert (got["trans_idx"][~got["valid"]] == -1).all()
    assert (got["warp_pts"][~got["valid"]] == 0).all()


EDGE_CASES = ("one_slot", "33_slots", "one_ray", "miss", "zero_dir")


def _edge_inputs(case):
    """(rays_o, rays_d, noise, S) of an edge case on the tiny scene: S = 1
    or 33 (the kernel's chunks are 32 slots), one ray, half the rays
    outside the root cube pointing away from it, or rays with a zero
    direction component (x = +0 on even rays, z = -0 on odd ones: the slab
    test's inverse is then 1e10)."""
    o, d = tiny_rays(n_rays=N_RAYS, seed=3)
    s = {"one_slot": 1, "33_slots": 33}.get(case, 64)
    noise = _noise(s, 2.0)
    if case == "one_ray":
        o, d, noise = o[:1], d[:1], noise[:1]
    elif case == "miss":
        _, toct = octree_pair()
        rng = np.random.default_rng(4)
        u = rng.normal(size=(N_RAYS // 2, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        o, d = o.copy(), d.copy()
        o[::2] = (to_np(toct.centers[0])
                  + 2.0 * float(toct.side_lens[0]) * u)
        d[::2] = u
    elif case == "zero_dir":
        d = d.copy()
        d[0::2, 0] = 0.0
        d[1::2, 2] = -0.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            noise.astype(np.float32), s)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_get_samples_edges_match_jax(case):
    """The scan march against the JAX package's at the shapes and rays
    where kernel M1's chunks and lane groups have edges (``_edge_inputs``),
    with ``test_get_samples_matches_jax``'s tolerances: at most 2% of the
    rays differ in their rows, the rest to 1e-5.  At S = 1 no slot is
    emitted (a ray's first valid slot never is); rays that miss the root
    emit nothing and keep the first-hit distance 1e9."""
    o, d, noise, s = _edge_inputs(case)
    want, got = _samples_pair(o, d, noise, s)
    assert got["valid"].shape == (o.shape[0], s)
    bad = differing_rays(want, got)
    assert bad.mean() <= DIFFERING_RAYS, bad.sum()
    ok = ~bad
    for k in VALUE_KEYS + ("first_oct_dis",):
        np.testing.assert_allclose(got[k][ok], want[k][ok], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["num_valid"][ok],
                                  want["num_valid"][ok])
    assert (got["trans_idx"][~got["valid"]] == -1).all()
    assert (got["world_pts"][~got["valid"]] == 0).all()
    if case == "one_slot":
        assert not got["valid"].any() and (got["first_oct_dis"] < 1e8).any()
    elif case == "miss":
        for x in (got, want):
            assert not x["valid"][::2].any()
            assert (x["first_oct_dis"][::2] == np.float32(1e9)).all()
        assert got["valid"][1::2].sum() > N_RAYS
    else:
        assert got["valid"].sum() >= o.shape[0] * min(s, 64) // 8


def test_scan_march_wrapper_runs_plain_on_cpu():
    """``ops.scan_march`` on CPU tensors is the plain ``get_samples`` and
    launches no kernel; ``sample_rays`` hands it noise times the
    fineness."""
    from gfnerf_tpu_torch.models.gfnerf import sample_rays
    from gfnerf_tpu_torch.ops.scan_march import scan_march
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    _, toct = octree_pair()
    o, d = (torch.as_tensor(x) for x in tiny_rays(n_rays=N_RAYS, seed=3))
    noise = torch.as_tensor(_noise(256, 1.0))
    cfg = SamplerConfig(max_samples=256, sample_l=SAMPLE_L, march="scan")
    before = scan_march.launches
    via_model = sample_rays(toct, o, d, noise, 8.0, cfg)
    assert scan_march.launches == before
    want = scan_pair(256, 8.0)[1]
    for k in ROW_KEYS + VALUE_KEYS:
        np.testing.assert_array_equal(to_np(getattr(via_model, k)), want[k],
                                      err_msg=k)
    with pytest.raises(ValueError, match="unknown march"):
        sample_rays(toct, o, d, noise, 1.0,
                    dataclasses.replace(cfg, march="stack"))


def _edge_pool():
    from gfnerf_tpu.sampler.octree import construct_edge_pool
    from torch_parity import tiny_tree

    tree = dataclasses.replace(tiny_tree())
    construct_edge_pool(tree)
    assert len(tree.edge_t_idx) > 10
    return tree


def test_get_edge_samples_matches_jax():
    """The JAX package's draws (its key split into the edge indices and
    the face coordinates) handed to the port: equal anchors, points to
    1e-6; drawn from a generator: in range."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.sampler.perssampler import get_edge_samples as jax_edges
    from gfnerf_tpu_torch.sampler.perssampler import get_edge_samples

    tree = _edge_pool()
    n = 96
    key = jax.random.PRNGKey(4)
    want = jax_edges(key, jnp.asarray(tree.edge_t_idx),
                     jnp.asarray(tree.edge_center),
                     jnp.asarray(tree.edge_dirs), n)
    k1, k2 = jax.random.split(key)
    eidx = np.array(jax.random.randint(k1, (n,), 0,
                                         len(tree.edge_t_idx)))
    uv = np.array(jax.random.uniform(k2, (n, 2)))
    pool = [torch.as_tensor(x) for x in (tree.edge_t_idx, tree.edge_center,
                                          tree.edge_dirs)]
    pts, trans = get_edge_samples(*pool, n, draws=(eidx, uv))
    np.testing.assert_array_equal(to_np(trans), np.asarray(want[1]))
    np.testing.assert_allclose(to_np(pts), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    assert torch.equal(pts[:, 0], pts[:, 1])
    gen = torch.Generator().manual_seed(0)
    pts, trans = get_edge_samples(*pool, n, generator=gen)
    assert pts.shape == (n, 2, 3) and trans.shape == (n, 2)
    assert set(map(tuple, to_np(trans))) <= set(map(tuple, tree.edge_t_idx))


def test_tv_edge_loss_matches_jax():
    """The TV loss with the warp as the field: each boundary point warped
    through its two adjacent anchors; 1e-5 relative."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.model_components.losses import tv_edge_loss as jax_tv
    from gfnerf_tpu.sampler.perssampler import get_edge_samples as jax_edges
    from gfnerf_tpu.sampler.perssampler import warp_points as jax_warp
    from gfnerf_tpu_torch.model_components.losses import tv_edge_loss
    from gfnerf_tpu_torch.sampler.perssampler import warp_points

    joct, toct = octree_pair()
    tree = _edge_pool()
    pts, trans = jax_edges(jax.random.PRNGKey(1),
                           jnp.asarray(tree.edge_t_idx),
                           jnp.asarray(tree.edge_center),
                           jnp.asarray(tree.edge_dirs), 128)
    want = jax.jit(lambda p, t: jax_tv(
        lambda x, a: jax_warp(joct, a, x), p, t))(pts, trans)
    got = tv_edge_loss(lambda x, a: warp_points(toct, a.long(), x),
                       torch.as_tensor(np.array(pts)),
                       torch.as_tensor(np.array(trans)))
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_fast_march_covers_same_leaves_as_scan():
    """tests/test_fast_march.py:53 on the port: per ray, the fast march's
    sample count at least 0.6 of the scan's, their first and last t
    within 0.2 and 0.5, the first-hit distances to 1e-3."""
    from gfnerf_tpu_torch.sampler.fast_march import get_samples_fast
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig
    from gfnerf_tpu_torch.sampler.perssampler import get_samples

    _, toct = octree_pair()
    o, d = (torch.as_tensor(x) for x in tiny_rays(n_rays=N_RAYS, seed=3))
    cfg = SamplerConfig(max_samples=256, sample_l=1.0 / 32, max_hits=32,
                        ray_chunk=N_RAYS)
    noise = torch.ones((N_RAYS, cfg.max_samples))
    fast = get_samples_fast(toct, o, d, noise, 1.0, cfg)
    scan = get_samples(toct, o, d, noise, cfg)
    fv, sv = to_np(fast.valid), to_np(scan.valid)
    fts, sts = to_np(fast.ts), to_np(scan.ts)
    checked = 0
    for r in range(N_RAYS):
        if not sv[r].any():
            continue
        checked += 1
        assert fv[r].sum() >= 0.6 * sv[r].sum(), (r, fv[r].sum(), sv[r].sum())
        assert abs(fts[r][fv[r]].min() - sts[r][sv[r]].min()) < 0.2
        assert abs(fts[r][fv[r]].max() - sts[r][sv[r]].max()) < 0.5
    assert checked > N_RAYS // 2
    f_fod, s_fod = to_np(fast.first_oct_dis), to_np(scan.first_oct_dis)
    both = (f_fod < 1e8) & (s_fod < 1e8)
    np.testing.assert_allclose(f_fod[both], s_fod[both], rtol=1e-3,
                               atol=1e-3)


def test_coverage_figures_match_jax(tmp_path):
    """``tests/torch_parity.py scan-coverage`` on a case written as
    ``chip_smoke.py --coverage-case`` writes one (the tiny octree, 64
    rays, 1024 slots, eval noise): the port's plain scan and fast march
    give the JAX package's pair's figures (``chip_smoke.coverage_figures``):
    the counts and shares exactly, the median t gaps to 1e-4 (f32 sums of
    other orders)."""
    import json

    import torch_parity
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    _, toct = octree_pair()
    o, d = tiny_rays(n_rays=N_RAYS, seed=3)
    cfg = SamplerConfig(max_samples=1024, sample_l=1.0 / 32, max_hits=32,
                        ray_chunk=N_RAYS)
    tables = {f"oct_{f.name}": to_np(getattr(toct, f.name))
              if torch.is_tensor(getattr(toct, f.name))
              else np.asarray(getattr(toct, f.name))
              for f in dataclasses.fields(toct)}
    case = tmp_path / "case.npz"
    np.savez_compressed(case, rays_o=o, rays_d=d,
                        sampler_config=json.dumps(dataclasses.asdict(cfg)),
                        card=json.dumps({}), **tables)
    out = torch_parity.scan_coverage_case(case)
    jax, port = out["jax"], out["port_cpu"]
    assert jax["rays_with_samples"] > N_RAYS // 2
    for k in ("median_first_t_diff", "median_last_t_diff"):
        assert abs(port.pop(k) - jax.pop(k)) <= 1e-4, k
    assert port == jax


# ---- the model on scan samples ----


def _forward_pair(branch, stage):
    """model_forward of both packages on JAX's scan samples (S = 64, their
    warp_pts read: the JAX package's ``warp_deferred`` False; the port
    reads warp_pts where the samples have them), block 1 at the block
    stage: (JAX outputs, port outputs) as numpy."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JModel
    from gfnerf_tpu.models.gfnerf import model_forward as jax_forward
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                model_forward)

    joct, toct = octree_pair()
    x = dict(scan_pair(64, 1.0)[0])
    o, d = tiny_rays(n_rays=N_RAYS, seed=3)
    over = dict(PROBE) if branch == "proposal" else {}
    jcfg, params, statics, field = field_pair(block_scale=0.3,
                                              mlp_dtype="float32", **over)
    mkw = dict(scale_factor=1.0,
               samples_budget_per_ray=16 if branch == "compacted" else 64,
               num_proposal_resamples=16 if branch == "proposal" else 0)
    rel = np.arange(N_RAYS) % 6
    want = jax.jit(lambda p, smp: jax_forward(
        p, statics, jcfg, JModel(n_blocks=2, **mkw), smp, jnp.asarray(d),
        jnp.asarray(rel, jnp.int32), stage, 1, oct_dev=joct,
        warp_deferred=False, rays_o=jnp.asarray(o)))(params, jax_samples(x))
    with torch.no_grad():
        got = model_forward(field, GFNeRFModelConfig(**mkw), port_samples(x),
                            torch.as_tensor(d), torch.as_tensor(rel), stage,
                            toct, 1, rays_o=torch.as_tensor(o))
    return ({k: np.asarray(v) for k, v in want.items()
             if not isinstance(v, tuple)},
            {k: to_np(v) for k, v in got.items() if not isinstance(v, tuple)})


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("branch", ["dense", "compacted", "proposal"])
def test_model_forward_on_scan_samples_matches_jax(branch, stage):
    want, got = _forward_pair(branch, stage)
    assert want["accumulation"].max() > 0.3
    for k in ("rgb", "accumulation", "depth", "weights", "oct_depth"):
        assert got[k].shape == want[k].shape, k
        if branch == "proposal":
            err = np.abs(got[k] - want[k]).reshape(N_RAYS, -1).max(1)
            atol = 5e-5 * max(1.0, float(np.abs(want[k]).max()))
            assert (err > atol).sum() <= 1, (k, err.max())
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_model_forward_reads_the_scan_warp():
    """Given samples with warp_pts the field reads them: without them (the
    fast march's samples) it warps the world points to the same render,
    and with shifted warp_pts it renders otherwise."""
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                model_forward)

    _, toct = octree_pair()
    x = dict(scan_pair(64, 1.0)[1])
    _, d = tiny_rays(n_rays=N_RAYS, seed=3)
    _, _, _, field = field_pair(mlp_dtype="float32")
    mcfg = GFNeRFModelConfig(scale_factor=1.0, samples_budget_per_ray=64)
    rel = torch.arange(N_RAYS) % 6
    outs = []
    with torch.no_grad():
        for shift in (None, 0.0, 0.05):
            y = dict(x)
            if shift is None:
                del y["warp_pts"]
            else:
                y["warp_pts"] = x["warp_pts"] + shift
            outs.append(to_np(model_forward(
                field, mcfg, port_samples(y), torch.as_tensor(d), rel, 0,
                toct)["rgb"]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    assert np.abs(outs[2] - outs[1]).max() > 1e-3


def _compare_steps(jout, tout, field):
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    (jstate, jo, jm, jerr), (state, to, tm, terr) = jout, tout
    for k in ("loss", "rgb_loss", "s3im_loss", "psnr",
              "num_samples_per_ray"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-5,
                               atol=1e-5)
    inner = jstate.opt_state.inner_state.inner_states
    groups = field_param_groups(field)
    for name, tol in (("fields", 1e-3), ("base_encoding_init", 2e-2)):
        if name not in groups or not groups[name]:
            continue
        jg = [np.asarray(m) / 0.1 for m in
              jax_groups(inner[name].inner_state[0].mu[0])[name]]
        scale = max(float(np.abs(g).max()) for g in jg)
        assert scale > 0
        for i, (p, g) in enumerate(zip(groups[name], jg)):
            np.testing.assert_allclose(to_np(p.grad), g, rtol=tol,
                                       atol=tol * scale,
                                       err_msg=f"{name}[{i}] grad")
    for k in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        np.testing.assert_array_equal(to_np(getattr(to, k)),
                                      np.asarray(getattr(jo, k)), err_msg=k)


@pytest.mark.parametrize("budget", [TRAIN_S, 16])
def test_train_step_with_scan_matches_jax(budget):
    """One init-stage train step with ``march="scan"`` (dense, and
    compacted at budget 16 < S = 64) against the JAX step on the same
    batch, noise and permutations."""
    jcfg, params, statics, field = field_pair(mlp_dtype="float32")
    joct, toct = octree_pair()
    batch = train_batch(3)
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=budget)
    jout, noise, perms = jax_train_step(jcfg, params, statics, joct, batch,
                                        mkw, key_seed=5, march="scan")
    tout = port_train_step(field, toct, batch, mkw, noise, perms,
                           march="scan")
    assert float(jout[2]["num_samples_per_ray"]) > 10
    _compare_steps(jout, tout, field)


def test_render_fn_and_early_term_on_scan():
    """make_render_fn with the scan against the JAX package's at both
    stages (1e-5); the early-termination renderer at eps 0 equal to the
    single pass on the dense path."""
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JModel
    from gfnerf_tpu.models.gfnerf import make_render_fn as jax_render_fn
    from gfnerf_tpu.sampler.perssampler import SamplerConfig as JSampler
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_render_fn)
    from gfnerf_tpu_torch.models.render_early import EarlyTermRenderer
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    joct, toct = octree_pair()
    jcfg, params, statics, field = field_pair(block_scale=0.3,
                                              mlp_dtype="float32")
    o, d = tiny_rays(n_rays=N_RAYS, seed=3)
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=64)
    skw = dict(max_samples=64, sample_l=SAMPLE_L, march="scan")
    render = make_render_fn(GFNeRFModelConfig(**mkw), SamplerConfig(**skw))
    jrender = jax_render_fn(jcfg, JModel(n_blocks=2, **mkw), JSampler(**skw))
    for stage_is_block in (False, True):
        want = jrender(params, statics, joct, jnp.asarray(o),
                       jnp.asarray(d), 3, 1, stage_is_block)
        got = render(field, toct, torch.as_tensor(o), torch.as_tensor(d), 3,
                     1, stage_is_block)
        for k in ("rgb", "accumulation", "depth", "oct_depth"):
            np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(to_np(got["accumulation"]).max()) > 0.3
    early = EarlyTermRenderer(GFNeRFModelConfig(**mkw), SamplerConfig(**skw),
                              s1=16, eps=0.0)
    two = early.render_chunk(field, toct, torch.as_tensor(o),
                             torch.as_tensor(d), 3, 1, True)
    for k in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(to_np(two[k]), to_np(got[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert early.last_survivor_frac > 0.5


def test_scan_config_through_config_json_and_train(tmp_path):
    """``pipeline.sampler.march=scan`` survives config.json and reaches
    the sampler config (locate_iters = max_level + 8 and global_far
    SamplerConfig's default, as the JAX manager's); a short CPU run of gf-nerf-tiny trains with it across the
    transition and its checkpoint's march config says scan."""
    import json

    from gfnerf_tpu_torch import train
    from gfnerf_tpu_torch.configs.config_io import (apply_override,
                                                    config_from_json,
                                                    config_to_json)
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    cfg = get_method("gf-nerf-perf")
    apply_override(cfg, "pipeline.sampler.march", "scan")
    back = config_from_json(config_to_json(cfg))
    assert back == cfg
    assert back.pipeline.sampler.march == "scan"

    scene = make_synthetic_npz(tmp_path / "scene", n_train=12, n_val=2,
                               img_wh=(32, 24))
    rc = train.main([
        "gf-nerf-tiny", "--data", str(scene), "--device", "cpu",
        "--output-dir", str(tmp_path / "out"), "--experiment-name", "scan",
        "--max-num-iterations", "12",
        "pipeline.datamanager.train_num_rays_per_batch=64",
        "pipeline.model.s3im_patch_height=8",
        "pipeline.sampler.march=scan"])
    assert rc == 0
    (config,) = (tmp_path / "out").glob("scan/gf-nerf-tiny/*/config.json")
    run = config_from_json(config.read_text())
    assert run.pipeline.sampler.march == "scan"
    (meta,) = config.parent.glob("nerfstudio_models/step-*/meta.json")
    scfg = json.loads(meta.read_text())["sampler_config"]
    assert scfg["march"] == "scan"
    assert scfg["locate_iters"] == run.pipeline.sampler.max_level + 8
    assert scfg["global_far"] == SamplerConfig().global_far


# M1 on the card: (rays, slots, rays' kind), the last five the edges of
# its lane groups (8 rays a block) and chunks (32 slots)
M1_CASES = [(2048, 64, "ring"), (2048, 384, "ring"), (1, 1, "ring"),
            (3, 1024, "ring"), (8193, 33, "ring"), (2048, 64, "miss"),
            (2048, 64, "fine")]


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,rays", M1_CASES)
def test_m1_matches_plain_on_card(r, s, rays):
    """M1 against the plain scan on the card, on an octree built by the
    port on the synthetic ring (numpy only: the CUDA tests run without
    JAX): at most 0.1% of the rays differ in their rows, the rest to 1e-5
    relative; one launch a call.  The edge cases (R = 1, 3, 8193; S = 1,
    33, 1024; rays that miss the root; rays whose anchor changes at 80% of
    their emitted slots or more: a finer tree, split up to depth 8, and 16
    times the noise) must be equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.ops.scan_march import scan_march
    from gfnerf_tpu_torch.sampler.octree import build_octree
    from gfnerf_tpu_torch.sampler.perssampler import (SamplerConfig,
                                                      get_samples,
                                                      octree_to_device)
    from gfnerf_tpu_torch.utils.synthetic import ring_cameras

    c2w, fx, fy, cx, cy, w, h = ring_cameras(12, img_wh=(32, 24))
    intri = np.zeros((12, 3, 3), np.float32)
    intri[:, 0, 0], intri[:, 1, 1] = fx, fy
    intri[:, 0, 2], intri[:, 1, 2], intri[:, 2, 2] = cx, cy, 1
    bounds = np.tile(np.array([[0.01, 50.0]], np.float32), (12, 1))
    fine = dict(max_depth=8, split_dist_thres=12.0) if rays == "fine" else \
        dict(max_depth=6)
    tree = build_octree(c2w, intri, bounds, bbox_levels=4, n_rand_pts=512,
                        vis_res_w=16, seed=0, device="cuda", **fine)
    oct_dev = octree_to_device(tree, 1 << 16, device="cuda")
    rng = np.random.default_rng(2)
    o = np.repeat(c2w[:, :, 3], r // 12 + 1, axis=0)[:r]
    d = -o + rng.normal(0, 0.6, o.shape)
    if rays == "miss":
        d = rng.normal(size=o.shape)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = (to_np(oct_dev.centers[0])
             + 2.0 * float(oct_dev.side_lens[0]) * d)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    noise = rng.uniform(0.5, 1.5, (r, s)) * (16.0 if rays == "fine" else 2.0)
    o, d, noise = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
                   for x in (o, d, noise))
    cfg = SamplerConfig(max_samples=s, sample_l=1.0 / 64, march="scan")
    before = scan_march.launches
    got = scan_march(oct_dev, o, d, noise, cfg)
    torch.cuda.synchronize()
    assert scan_march.launches == before + 1
    want = get_samples(oct_dev, o, d, noise, cfg)
    if (r, s, rays) not in M1_CASES[:2]:
        for k in ROW_KEYS + VALUE_KEYS + ("num_valid", "first_oct_dis"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
        if rays == "miss":
            assert not bool(want.valid.any())
        elif rays == "fine":
            runs = [row[row >= 0] for row in want.trans_idx.cpu().numpy()]
            pairs = sum(max(len(x) - 1, 0) for x in runs)
            changes = sum(int((x[1:] != x[:-1]).sum()) for x in runs)
            assert pairs > r and changes >= 0.8 * pairs, (changes, pairs)
        return
    bad = torch.zeros(r, dtype=torch.bool, device="cuda")
    for k in ROW_KEYS:
        bad |= (getattr(got, k) != getattr(want, k)).reshape(r, -1).any(1)
    assert float(bad.float().mean()) <= 1e-3, int(bad.sum())
    ok = ~bad
    assert int(want.valid[ok].sum()) > r * 5
    for k in VALUE_KEYS:
        g, w_ = getattr(got, k)[ok], getattr(want, k)[ok]
        scale = float(w_.abs().max())
        assert float((g - w_).abs().max()) <= 1e-5 * scale, k
    assert torch.equal(got.num_valid[ok], want.num_valid[ok])
    torch.testing.assert_close(got.first_oct_dis[ok], want.first_oct_dis[ok],
                               rtol=1e-5, atol=0)
