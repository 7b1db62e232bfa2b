"""The port's stock nerfacto family against the JAX package's on the CPU:
the colliders, the contraction and the renderers; ``spaced_sample`` and
``proposal_sample``; ``init_nerfacto_params`` (and semantic-nerfw's);
``nerfacto_forward``, ``nerfacto_loss``, ``depth_nerfacto_loss`` and
``semantic_nerfw_loss`` with every table's and MLP's gradient; the vanilla
pipeline over a few steps against the JAX ``VanillaPipeline``; the method
registry, the config's round trip and a checkpoint's resume.  On a card
(``cuda``): the model's kernels (H4 and H5 at nerfacto's shapes, far points
contracted to exactly 1.0) against its plain pairs.

Sizes: tables of 2^10 (field) and 2^8 (proposals), 32 rays, proposal
samples (16, 12) and 8 field samples.  The JAX package's random draws are
handed to the port (``proposal_sample``'s key order: ``split(rng, L +
1)``).

Tolerances, and why (1e-5 relative unless said; the wider ones are filed
in ROADMAP.md queue 3):
- parameters at the start: bit for bit.  ``spaced_sample``: the edges to
  1e-5 relative and 1e-6 of the largest t (XLA fuses ``lower + (upper -
  lower) * u`` into one multiply-add; measured 9e-8 of the largest, and
  7.7e-6 relative on one edge of the jittered disparity spacing, whose
  1 / x amplifies the rounding).  The first level's bins: equal.
- the resampled bins: 5e-4 of the largest normalized spacing, the
  proposal weights 1e-3 of their largest.  XLA:CPU sums the CDF in
  another association than torch (test_torch_proposal's finding), which
  moves an edge by an ulp over the CDF step it falls in (measured 9.0e-6
  of the largest at the second level, 1.3e-4 at the final one; the second
  level's weights 3.1e-4).  With each package's own bins the outputs are held to 2e-3 of
  their largest (measured 6.8e-4, the weights); then JAX's bins are
  handed over and the outputs held to 1e-5.
- with the bins handed over: rgb and the losses to 1e-5, but
  - the interlevel loss to 2e-4 relative (measured 1.5e-5 and 5.2e-5 on
    two tables): its (inner - w)^2 / (w + 1e-7) divides by coarse weights
    near 1e-7, whose few-ulp difference (the cumulative optical depth,
    summed in another order) it magnifies; on identical inputs the two
    losses agree to 2.3e-7;
  - the geometry features to 5e-4 of their largest (measured 1.1e-4):
    at the fine levels ``p * scale + bias`` reaches ~2000, where an f32
    ulp is 1.2e-4, so one ulp of difference in a position (XLA fuses ``o
    + t d`` into a multiply-add) moves an interpolation fraction by 1e-4;
    through the densities that moves the weights, accumulation and depth,
    held to 5e-5 of their largest (measured 1.8e-5), as
    test_torch_proposal holds the proposal branch's.
- gradients, with the bins handed over: the MLPs' and the appearance's
  to 1e-3 of their largest (measured 1.0e-4); the tables' at the JAX hash
  tests' tolerance for its bf16 backward payload, 2e-2 of the largest
  (measured 2.1e-3).
- the vanilla pipeline, 6 steps: see test_vanilla_pipeline_matches_jax.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)
from torch_parity import to_np

R = 32
PROPS = (16, 12)
NERF = 8
SMALL = dict(log2_hashmap_size=10, proposal_log2_hashmap_size=8,
             num_proposal_samples=PROPS, num_nerf_samples=NERF, num_images=3)
MLP_TOL = 1e-3
TABLE_TOL = 2e-2
INTERLEVEL_RTOL = 2e-4


def rays(seed=0, n=R):
    """Rays near (0, 0, 3) in random directions, targets and appearance
    indices (numpy)."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 0.1 + [0, 0, 3]).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tgt = rng.random((n, 3)).astype(np.float32)
    rel = (np.arange(n) % 3).astype(np.int32)
    return o, d, tgt, rel


def jax_draws(key, n_rays, props=PROPS, nerf=NERF):
    """``proposal_sample``'s uniform draws from JAX key ``key``:
    ``keys = split(key, L + 1)``, one (R, n + 1) draw per level and one for
    the final resample."""
    import jax

    keys = jax.random.split(key, len(props) + 1)
    return [np.array(jax.random.uniform(k, (n_rays, n + 1)))
            for k, n in zip(keys, [*props, nerf])]


@functools.lru_cache(maxsize=None)
def model_pair(semantic=False, far=10.0, seed=0):
    """(JAX cfg, params, statics, port cfg, the port's params and statics
    as numpy) of one small model: the init's draws, then every table
    replaced in both by uniform(-1, 1) from seed 5, so renders are not
    near-constant."""
    import jax.numpy as jnp
    from gfnerf_tpu.models import nerfacto as jnf
    from gfnerf_tpu.models import semantic_nerfw as jsn
    from gfnerf_tpu_torch.models import nerfacto as tnf
    from gfnerf_tpu_torch.models import semantic_nerfw as tsn

    kw = dict(SMALL, far_plane=far)
    if semantic:
        jcfg, tcfg = jsn.SemanticNerfWConfig(**kw), tsn.SemanticNerfWConfig(
            **kw)
        jp, js = jsn.init_semantic_nerfw_params(jcfg, seed)
    else:
        jcfg, tcfg = jnf.NerfactoConfig(**kw), tnf.NerfactoConfig(**kw)
        jp, js = jnf.init_nerfacto_params(jcfg, seed)
    rng = np.random.default_rng(5)
    jp = dict(jp)
    jp["field_feat"] = jnp.asarray(rng.uniform(
        -1, 1, jp["field_feat"].shape).astype(np.float32))
    jp["prop_feats"] = [jnp.asarray(rng.uniform(-1, 1, t.shape).astype(
        np.float32)) for t in jp["prop_feats"]]
    return jcfg, jp, js, tcfg


def port_model(semantic=False, far=10.0):
    from gfnerf_tpu_torch.models.nerfacto import nerfacto_params_from_jax

    _, jp, js, tcfg = model_pair(semantic, far)
    return nerfacto_params_from_jax(jp, js, tcfg, device="cpu")


def hand_over(jout):
    """A stand-in for the port's ``pdf_sample`` that returns the JAX run's
    resampled bins, level by level, then the final ones."""
    bins = [tuple(torch.as_tensor(np.array(x)) for x in sp)
            for sp in jout["spacing_list"][1:]]
    bins.append((torch.as_tensor(np.array(jout["spacing_starts"])),
                 torch.as_tensor(np.array(jout["spacing_ends"]))))
    it = iter(bins)
    return lambda *a, **kw: next(it)


def close(got, want, rtol=1e-5, atol_rel=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, rtol=rtol,
                               atol=atol_rel * max(float(np.abs(want).max()),
                                                   1e-30), err_msg=what)


# ---- components ----


def test_components_match_jax():
    """The colliders, the contraction (far points onto |x| = 2, in the
    hash's [0, 1] at exactly 1.0) and the renderers."""
    import jax.numpy as jnp
    from gfnerf_tpu.model_components import renderers as jr
    from gfnerf_tpu.model_components import scene_colliders as jc
    from gfnerf_tpu.model_components import spatial_distortions as jd
    from gfnerf_tpu_torch.model_components import renderers as tr
    from gfnerf_tpu_torch.model_components import scene_colliders as tc
    from gfnerf_tpu_torch.model_components import spatial_distortions as td
    from gfnerf_tpu_torch.models.nerfacto import (NerfactoConfig,
                                                  normalize_positions)

    o, d, _, _ = rays()
    o[0] = [0, 0, 0.5]   # inside both
    to, tdir = torch.as_tensor(o), torch.as_tensor(d)
    jo, jd_ = jnp.asarray(o), jnp.asarray(d)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32) * 3.5
    for got, want in (
            (tc.near_far_collider(to, tdir, 0.05, 1000.0),
             jc.near_far_collider(jo, jd_, 0.05, 1000.0)),
            (tc.aabb_collider(to, tdir, torch.as_tensor(aabb), 0.1),
             jc.aabb_collider(jo, jd_, jnp.asarray(aabb), 0.1)),
            (tc.sphere_collider(to, tdir, torch.zeros(3), 2.0, 0.1),
             jc.sphere_collider(jo, jd_, jnp.zeros(3), 2.0, 0.1))):
        for g, w in zip(got, want):
            close(g, w)
    rng = np.random.default_rng(1)
    pts = (rng.standard_normal((256, 3)) * np.logspace(-1, 8, 256)[:, None]
           ).astype(np.float32)
    for order in (np.inf, 2):
        close(td.scene_contraction(torch.as_tensor(pts), order),
              jd.scene_contraction(jnp.asarray(pts), order))
    far = normalize_positions(torch.tensor([[0.0, 0.0, 1e9],
                                            [-1e9, 3.0, 0.0]]),
                              NerfactoConfig())
    assert far[0, 2] == 1.0 and far[1, 0] == 0.0
    w = rng.random((R, NERF)).astype(np.float32) / NERF
    rgbs = rng.random((R, NERF, 3)).astype(np.float32)
    ts = np.cumsum(rng.random((R, NERF)), 1).astype(np.float32)
    tw, trgb = torch.as_tensor(w), torch.as_tensor(rgbs)
    for bg in ("black", "white", "last_sample"):
        close(tr.render_rgb(tw, trgb, bg), jr.render_rgb(w, rgbs, bg))
    close(tr.render_accumulation(tw), jr.render_accumulation(w))
    close(tr.render_expected_depth(tw, torch.as_tensor(ts)),
          jr.render_expected_depth(w, ts))
    close(tr.render_weighted(tw, trgb), jr.render_weighted(w, rgbs))
    with pytest.raises(ValueError):
        tr.render_rgb(tw, trgb, "green")


@pytest.mark.parametrize("spacing", ["uniform", "lindisp", "sqrt", "log"])
def test_spaced_sample_matches_jax(spacing):
    """Even and jittered (JAX's draw handed over) bins in t and in the
    normalized spacing."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.model_components.ray_samplers import spaced_sample as js
    from gfnerf_tpu_torch.model_components.ray_samplers import spaced_sample

    nears = np.full((R, 1), 0.05, np.float32)
    fars = np.full((R, 1), 1000.0, np.float32)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (R, 97)))
    for jitter in (None, u):
        want = jax.jit(lambda a, b: js(
            key if jitter is not None else None, a, b, 96, spacing,
            train_stratified=jitter is not None))(jnp.asarray(nears),
                                                  jnp.asarray(fars))
        got = spaced_sample(torch.as_tensor(nears), torch.as_tensor(fars),
                            96, spacing,
                            None if jitter is None else torch.as_tensor(u))
        for g, w in zip(got, want):
            assert g.shape == (R, 96)
            close(g, w, rtol=1e-5, atol_rel=1e-6)


def proposal_pair(seed_key=7, far=10.0):
    """(JAX outputs, port outputs, JAX densities' inputs) of
    ``proposal_sample`` with the small model's proposal fields and JAX's
    draws."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.model_components.ray_samplers import proposal_sample as jps
    from gfnerf_tpu.models import nerfacto as jnf
    from gfnerf_tpu_torch.model_components.ray_samplers import proposal_sample
    from gfnerf_tpu_torch.models.nerfacto import proposal_density_fn

    jcfg, jp, js, _ = model_pair(far=far)
    model = port_model(far=far)
    o, d, _, _ = rays()
    key = jax.random.PRNGKey(seed_key)
    nears = np.full((R, 1), jcfg.near_plane, np.float32)
    fars = np.full((R, 1), jcfg.far_plane, np.float32)

    def jfn(level):
        def fn(pos):
            p = jnf._normalize_positions(pos, jcfg).reshape(-1, 3)
            feats = jnf.hash_encode_sorted(
                jp["prop_feats"][level], js["prop_prims"][level],
                js["prop_biases"][level], p, jnp.zeros(p.shape[0], jnp.int32))
            h = jnf.apply_mlp(jp["prop_mlps"][level], feats)
            return jnf.trunc_exp(h[..., 0]).reshape(pos.shape[:-1])
        return fn

    jout = jax.jit(lambda k: jps(
        k, jnp.asarray(nears), jnp.asarray(fars), [jfn(0), jfn(1)],
        jnp.asarray(o), jnp.asarray(d), num_proposal_samples=PROPS,
        num_nerf_samples=NERF))(key)
    draws = [torch.as_tensor(x) for x in jax_draws(key, R)]
    tout = proposal_sample(
        torch.as_tensor(nears), torch.as_tensor(fars),
        [proposal_density_fn(model, 0), proposal_density_fn(model, 1)],
        torch.as_tensor(o), torch.as_tensor(d), PROPS, NERF, draws=draws)
    return jout, tout


def test_proposal_sample_matches_jax():
    """The first level's bins equal; the resampled ones within the CDF's
    rounding; each level's weights; the final bins in t."""
    jout, tout = proposal_pair()
    for g, w in zip(tout["spacing_list"][0], jout["spacing_list"][0]):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    for (gs, ge), (ws, we) in zip(tout["spacing_list"][1:],
                                  jout["spacing_list"][1:]):
        close(gs, ws, rtol=0, atol_rel=5e-4)
        close(ge, we, rtol=0, atol_rel=5e-4)
    for key in ("spacing_starts", "spacing_ends", "bin_starts", "bin_ends"):
        close(tout[key], jout[key], rtol=0, atol_rel=5e-4, what=key)
    for g, w in zip(tout["weights_list"], jout["weights_list"]):
        assert g.requires_grad
        close(g, w, rtol=0, atol_rel=1e-3)
    with pytest.raises(ValueError, match="draws"):
        from gfnerf_tpu_torch.model_components.ray_samplers import (
            proposal_sample)
        proposal_sample(torch.zeros(2, 1), torch.ones(2, 1), [], None, None,
                        PROPS, NERF, draws=[torch.zeros(2, 17)])


@pytest.mark.parametrize("semantic", [False, True])
def test_init_params_match_jax(semantic):
    """The numpy draws in the JAX order (semantic-nerfw's heads from seed +
    7), and the round trip into the module."""
    import jax
    from gfnerf_tpu.models import nerfacto as jnf
    from gfnerf_tpu.models import semantic_nerfw as jsn
    from gfnerf_tpu_torch.models import nerfacto as tnf
    from gfnerf_tpu_torch.models import semantic_nerfw as tsn

    if semantic:
        jp, js = jsn.init_semantic_nerfw_params(
            jsn.SemanticNerfWConfig(**SMALL), seed=3)
        tp, ts = tsn.init_semantic_nerfw_params(
            tsn.SemanticNerfWConfig(**SMALL), seed=3)
    else:
        jp, js = jnf.init_nerfacto_params(jnf.NerfactoConfig(**SMALL), 3)
        tp, ts = tnf.init_nerfacto_params(tnf.NerfactoConfig(**SMALL), 3)
    for j, t in ((jp, tp), (js, ts)):
        jl, jt = jax.tree_util.tree_flatten(j)
        tl, tt = jax.tree_util.tree_flatten(t)
        assert jt == tt
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b)
    model = tnf.NerfactoModel(tnf.NerfactoConfig(**SMALL), tp, ts, "cpu")
    np.testing.assert_array_equal(to_np(model.prop_table(1)[0]),
                                  tp["prop_feats"][1])
    np.testing.assert_array_equal(to_np(model.prop_table(1)[1]),
                                  ts["prop_prims"][1].astype(np.int64))
    assert (model.mlp_semantics is not None) == semantic


def loss_pair(kind, bins_from_jax, far=10.0, key_seed=7):
    """(JAX (total, losses, outputs, grads), port (total, losses, outputs,
    model)) of one loss: "nerfacto", "depth" or "semantic"."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models import nerfacto as jnf
    from gfnerf_tpu.models import semantic_nerfw as jsn
    from gfnerf_tpu_torch.model_components import ray_samplers as trs
    from gfnerf_tpu_torch.models import nerfacto as tnf
    from gfnerf_tpu_torch.models import semantic_nerfw as tsn

    semantic = kind == "semantic"
    jcfg, jp, js, _ = model_pair(semantic, far)
    model = port_model(semantic, far)
    o, d, tgt, rel = rays()
    depth = np.full((R, 1), 0.3, np.float32)
    depth[::4] = 0.0
    labels = (np.arange(R) % 3).astype(np.int32)   # 2 clips to class 1
    key = jax.random.PRNGKey(key_seed)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(rel),
             jnp.asarray(tgt))

    def jloss(p):
        if kind == "depth":
            return jnf.depth_nerfacto_loss(p, js, jcfg, key, *jargs,
                                           depth_gt=jnp.asarray(depth))
        if semantic:
            return jsn.semantic_nerfw_loss(p, js, jcfg, key, *jargs,
                                           semantics=jnp.asarray(labels))
        return jnf.nerfacto_loss(p, js, jcfg, key, *jargs)

    (jt, (jl, jo)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    draws = [torch.as_tensor(x) for x in jax_draws(key, R)]
    targs = (model, torch.as_tensor(o), torch.as_tensor(d),
             torch.as_tensor(rel).long(), torch.as_tensor(tgt))
    pdf = trs.pdf_sample
    if bins_from_jax:
        trs.pdf_sample = hand_over(jo)
    try:
        if kind == "depth":
            tt, (tl, to) = tnf.depth_nerfacto_loss(
                *targs, depth_gt=torch.as_tensor(depth), draws=draws)
        elif semantic:
            tt, (tl, to) = tsn.semantic_nerfw_loss(
                *targs, torch.as_tensor(labels), draws=draws)
        else:
            tt, (tl, to) = tnf.nerfacto_loss(*targs, draws=draws)
    finally:
        trs.pdf_sample = pdf
    tt.backward()
    return (jt, jl, jo, jg), (tt, tl, to, model)


def check_losses(j, t, keys):
    jt, jl, _, _ = j
    tt, tl, _, _ = t
    assert set(tl) == set(jl) == set(keys)
    for k in keys:
        rtol = INTERLEVEL_RTOL if k == "interlevel_loss" else 1e-5
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(float(tt.detach()), float(jt),
                               rtol=INTERLEVEL_RTOL)


def check_grads(jg, model):
    """Every table's gradient at TABLE_TOL of its largest; every MLP's and
    the appearance's at MLP_TOL of the model's largest MLP gradient."""
    tables = [("field_feat", model.field_feat, jg["field_feat"])] + [
        (f"prop_feats[{i}]", t, jg["prop_feats"][i])
        for i, t in enumerate(model.prop_feats)]
    for name, p, want in tables:
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        close(p.grad, want, rtol=TABLE_TOL, atol_rel=TABLE_TOL, what=name)
    mlps = [("base_net", model.base_net, jg["base_net"]),
            ("mlp_head", model.mlp_head, jg["mlp_head"])] + [
        (f"prop_mlps[{i}]", m, jg["prop_mlps"][i])
        for i, m in enumerate(model.prop_mlps)]
    if model.mlp_semantics is not None:
        mlps += [("mlp_semantics", model.mlp_semantics, jg["mlp_semantics"]),
                 ("semantics_head", model.semantics_head,
                  jg["semantics_head"])]
    for name, m, want in mlps:
        for part in ("w", "b"):
            for i, (p, w) in enumerate(zip(getattr(m, part), want[part])):
                close(p.grad, w, rtol=MLP_TOL, atol_rel=MLP_TOL,
                      what=f"{name}.{part}[{i}]")
    close(model.appearance.grad, jg["appearance"], rtol=MLP_TOL,
          atol_rel=MLP_TOL, what="appearance")


@pytest.mark.parametrize("far", [10.0, 1000.0])
def test_nerfacto_forward_and_loss_match_jax(far):
    """nerfacto_loss with each package's own bins (outputs to 2e-3 of
    their largest), then with JAX's bins handed over: rgb, accumulation,
    depth, weights, geometry features, the losses and every gradient.  At
    far 1000 most proposal samples sit beyond the contraction's unit
    box."""
    keys = ("rgb_loss", "interlevel_loss", "distortion_loss")
    j, t = loss_pair("nerfacto", False, far)
    for k in ("rgb", "accumulation", "depth", "weights"):
        close(t[2][k], j[2][k], rtol=0, atol_rel=2e-3, what=k)
    j, t = loss_pair("nerfacto", True, far)
    check_losses(j, t, keys)
    close(t[2]["rgb"], j[2]["rgb"], what="rgb")
    for k in ("accumulation", "depth", "weights"):
        close(t[2][k], j[2][k], atol_rel=5e-5, what=k)
    close(t[2]["geo"], j[2]["geo"], rtol=0, atol_rel=5e-4, what="geo")
    assert float(to_np(t[2]["weights"]).max()) > 0.05
    check_grads(j[3], t[3])


@pytest.mark.parametrize("kind", ["depth", "semantic"])
def test_depth_and_semantic_losses_match_jax(kind):
    """depth_nerfacto_loss (rays of depth 0 masked) and
    semantic_nerfw_loss (labels clipped to the classes; the semantics head
    on the detached geometry features), with JAX's bins handed over: the
    losses, the rendered logits and every gradient."""
    keys = ["rgb_loss", "interlevel_loss", "distortion_loss"]
    keys.append("depth_loss" if kind == "depth" else "semantics_loss")
    j, t = loss_pair(kind, True)
    check_losses(j, t, keys)
    if kind == "semantic":
        close(t[2]["semantics"], j[2]["semantics"], what="semantics")
    check_grads(j[3], t[3])


def test_ds_nerf_depth_loss_matches_jax():
    """The DS-NeRF term and its gradient on the same inputs."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.model_components.losses import ds_nerf_depth_loss as jl
    from gfnerf_tpu_torch.model_components.losses import ds_nerf_depth_loss

    rng = np.random.default_rng(4)
    w = (rng.random((R, NERF)) / NERF).astype(np.float32)
    depth = rng.uniform(0, 0.5, (R, 1)).astype(np.float32)
    depth[::3] = 0.0
    steps = np.sort(rng.random((R, NERF)), 1).astype(np.float32)
    lengths = rng.uniform(0.01, 0.1, (R, NERF)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda w: jl(w, jnp.asarray(depth),
                                             jnp.asarray(steps),
                                             jnp.asarray(lengths)))(
        jnp.asarray(w))
    wt = torch.as_tensor(w).requires_grad_(True)
    v = ds_nerf_depth_loss(wt, torch.as_tensor(depth), torch.as_tensor(steps),
                           torch.as_tensor(lengths))
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    close(wt.grad, jg)


# ---- the vanilla pipeline ----

PIPE_STEPS = 6
PIPE_RAYS = 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A small synthetic scene (8 views at 24x16) with road masks: the
    lower half of each image is class 1."""
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("nerfacto") / "scene"
    make_synthetic_npz(path, n_train=8, n_val=2, img_wh=(24, 16))
    for split in ("train", "val"):
        d = dict(np.load(path / f"{split}.npz"))
        n, h, w = d["images"].shape[:3]
        masks = np.zeros((n, h, w), np.float32)
        masks[:, h // 2:, :] = 1.0
        d["road_masks"] = masks
        np.savez(path / f"{split}.npz", **d)
    return path


def small_pipeline(cfg, kind):
    """``cfg`` (either package's VanillaPipelineConfig) cut to the small
    model."""
    cfg.train_num_rays_per_batch = PIPE_RAYS
    cfg.eval_num_rays_per_chunk = 96
    sub = cfg.nerfacto if kind == "nerfacto" else cfg.semantic_nerfw
    for k, v in SMALL.items():
        if k != "num_images":
            setattr(sub, k, v)
    return cfg


@pytest.mark.parametrize("kind", ["nerfacto", "semantic-nerfw"])
def test_vanilla_pipeline_matches_jax(scene, tmp_path, kind):
    """PIPE_STEPS steps of the port's VanillaPipeline against the JAX
    package's on the same scene, seed and batches, each step's proposal
    draws taken from the JAX pipeline's key chain; then the eval PSNR.

    Tolerances (relative; measured over the 6 steps of both kinds): the
    rgb and semantics losses and the train PSNR 2e-4 (6.7e-5), the
    distortion loss 2e-3 (9.5e-4), the interlevel loss and the total 1e-2
    (3.4e-3), the eval PSNR 2e-4 (6.9e-5), its SSIM 1e-3.  The bins move
    by the CDF's rounding (see above), the interlevel loss magnifies that,
    and after the first update Adam moves an entry by about lr * sign(g)
    where the two gradients' signs differ (test_torch_pipeline's
    finding)."""
    import jax
    from gfnerf_tpu.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig as JaxConfig)
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig)

    jcfg = small_pipeline(JaxConfig(model_kind=kind), kind)
    jpipe = jcfg.build(MinimalDataParser(MinimalDataParserConfig(data=scene)),
                       tmp_path / "jax")
    # the JAX pipeline's key chain: rng, key = split(rng) each step
    rng, keys = jax.random.PRNGKey(jcfg.seed), []
    for _ in range(PIPE_STEPS):
        rng, key = jax.random.split(rng)
        keys.append(key)
    pcfg = small_pipeline(VanillaPipelineConfig(model_kind=kind), kind)
    pipe = pcfg.build(build_dataparser("minimal", scene), tmp_path / "port",
                      "cpu", draws=lambda step, r: jax_draws(keys[step], r))
    jm = [jpipe.get_train_loss_dict(i) for i in range(PIPE_STEPS)]
    tm = [pipe.get_train_loss_dict(i) for i in range(PIPE_STEPS)]
    assert pipe.state.step == PIPE_STEPS
    names = {"loss", "rgb_loss", "interlevel_loss", "distortion_loss",
             "psnr"} | ({"semantics_loss"} if kind != "nerfacto" else set())
    for i, (a, b) in enumerate(zip(tm, jm)):
        assert set(a) == set(b) == names
        for k in names:
            rtol = {"interlevel_loss": 1e-2, "loss": 1e-2,
                    "distortion_loss": 2e-3}.get(k, 2e-4)
            np.testing.assert_allclose(a[k], b[k], rtol=rtol,
                                       err_msg=f"step {i} {k}")
    assert tm[-1]["rgb_loss"] < tm[0]["rgb_loss"]
    want = jpipe.get_eval_image_metrics_and_images(PIPE_STEPS)[0]
    got, images = pipe.get_eval_image_metrics_and_images(PIPE_STEPS)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=2e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-3)
    assert images["img"].shape == (16, 48, 3)


def test_vanilla_pipeline_trains_resumes_and_round_trips(scene, tmp_path):
    """semantic-nerfw through the Trainer: config.json round-trips, the
    checkpoint resumes (the same next step as the uninterrupted run), and
    the GF-NeRF-only options raise: early termination, block routing, and
    overrides of the error-map and early-termination settings."""
    from gfnerf_tpu_torch.configs.config_io import (apply_override,
                                                    config_from_json,
                                                    config_to_json)
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer

    def config(out, steps):
        cfg = get_method("semantic-nerfw")
        small_pipeline(cfg.pipeline, "semantic-nerfw")
        cfg.data, cfg.device, cfg.output_dir = scene, "cpu", out
        cfg.max_num_iterations, cfg.steps_per_save = steps, 10 ** 9
        return cfg

    parser = build_dataparser("minimal", scene)
    trainer = Trainer(config(tmp_path / "a", 4), parser)
    trainer.setup()
    trainer.train()
    text = (trainer.base_dir / "config.json").read_text()
    assert config_from_json(text) == trainer.config
    assert config_to_json(config_from_json(text)) == text
    full = Trainer(config(tmp_path / "b", 5), parser)
    full.setup()
    full.train()
    cfg = config(tmp_path / "c", 5)
    cfg.load_dir = trainer.checkpoint_dir
    resumed = Trainer(cfg, parser)
    resumed.setup()
    assert resumed._start_step == 4
    p, q = resumed.pipeline, full.pipeline
    assert p.state.step == 4
    m = p.get_train_loss_dict(4)
    for a, b in zip(p.model.parameters(), q.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert np.isfinite(m["semantics_loss"])
    with pytest.raises(ValueError, match="GF-NeRF"):
        p.enable_early_term()
    with pytest.raises(ValueError, match="routing"):
        p.render_camera(p.eval_outputs.cameras, p.eval_cameras_dev, 0,
                        force_split_idx=1)
    for key in ("pipeline.use_error_sampling", "pipeline.eval_early_term"):
        with pytest.raises(AttributeError, match="no config field"):
            apply_override(cfg, key, "true")


def _fields(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


@pytest.mark.parametrize("method", ["nerfacto", "semantic-nerfw",
                                    "instant-ngp", "vanilla-nerf", "mipnerf",
                                    "tensorf", "neus", "nerfplayer-nerfacto",
                                    "nerfplayer-ngp"])
def test_methods_registered_with_jax_settings(method):
    """get_method gives the JAX package's settings, every field of the
    vanilla pipeline's config included (the nerfplayer pair's too, now
    ported); a kind the pipeline does not have raises "not ported"."""
    from gfnerf_tpu.configs.method_configs import method_configs
    from gfnerf_tpu_torch.configs.method_configs import NOT_PORTED, get_method
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        KINDS, VanillaPipelineConfig)

    got, want = _fields(get_method(method)), _fields(method_configs[method]())
    assert set(got) - set(want) == {"device"}
    for k in set(got) & set(want) - {"vis"}:
        assert got[k] == want[k], (k, got[k], want[k])
    assert sum(k.startswith("pipeline.") for k in got) > 100
    assert NOT_PORTED == ()
    assert get_method(method).pipeline.model_kind in KINDS
    with pytest.raises(NotImplementedError, match="not ported"):
        VanillaPipelineConfig(model_kind="no-such-kind").build(None, ".",
                                                               "cpu")


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("semantic", [False, True])
def test_model_kernels_match_plain_on_card(semantic):
    """One loss and backward of the small model on the card, through H4
    and H5 (three calls each: two proposal levels and the field) and
    through the plain pairs, on the same draws: losses to 1e-5 relative,
    every gradient to 1e-5 of its largest (the same f32 terms added in
    another order); H4 at far points contracted to exactly 1.0 equal to
    the plain encode bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gfnerf_tpu_torch.fields import hash_encoding as he
    from gfnerf_tpu_torch.models import nerfacto as tnf
    from gfnerf_tpu_torch.models import semantic_nerfw as tsn
    from gfnerf_tpu_torch.models.nerfacto import (NerfactoConfig,
                                                  nerfacto_params_from_jax,
                                                  normalize_positions)

    # numpy only: the CUDA tests run without JAX (--noconftest)
    kw = dict(SMALL, far_plane=1000.0)
    if semantic:
        tcfg = tsn.SemanticNerfWConfig(**kw)
        jp, js = tsn.init_semantic_nerfw_params(tcfg, 0)
    else:
        tcfg = tnf.NerfactoConfig(**kw)
        jp, js = tnf.init_nerfacto_params(tcfg, 0)
    rng = np.random.default_rng(5)
    jp["field_feat"] = rng.uniform(-1, 1, jp["field_feat"].shape)
    jp["prop_feats"] = [rng.uniform(-1, 1, t.shape) for t in jp["prop_feats"]]
    o, d, tgt, rel = rays()
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws = [torch.rand((R, n + 1), generator=gen, device="cuda")
             for n in (*PROPS, NERF)]
    runs = []
    for plain in (False, True):
        model = nerfacto_params_from_jax(jp, js, tcfg, device="cuda")
        args = (model, *(torch.as_tensor(x, device="cuda")
                         for x in (o, d, rel.astype(np.int64), tgt)))
        encode = tnf.hash_encode
        tnf.hash_encode = he.plain_hash_encode if plain else encode
        calls, bwd = he.hash_encode.calls, he.hash_encode.bwd_calls
        try:
            if semantic:
                total, (losses, _) = tsn.semantic_nerfw_loss(
                    *args, torch.as_tensor(rel, device="cuda"), draws=draws)
            else:
                total, (losses, _) = tnf.nerfacto_loss(*args, draws=draws)
            total.backward()
        finally:
            tnf.hash_encode = encode
        assert (he.hash_encode.calls - calls,
                he.hash_encode.bwd_calls - bwd) == ((0, 0) if plain
                                                    else (3, 3))
        runs.append((losses, [p.grad.clone() for p in model.parameters()]))
    (kl, kg), (pl, pg) = runs
    for k in kl:
        torch.testing.assert_close(kl[k], pl[k], rtol=1e-5, atol=0)
    for a, b in zip(kg, pg):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    far = torch.tensor([[0.0, 0.0, 1e9], [-1e9, 3.0, 0.0], [5.0, 1e7, 1e8]],
                       device="cuda")
    pts = normalize_positions(far, NerfactoConfig())
    assert pts.max().item() == 1.0 and pts.min().item() == 0.0
    table, prim, bias = model.prop_table(0)
    anc = torch.zeros(3, dtype=torch.int32, device="cuda")
    assert torch.equal(he._hash_encode_cuda(table, prim, bias, pts, anc),
                       he.hash_encode_raw(table, prim, bias, pts, anc))
