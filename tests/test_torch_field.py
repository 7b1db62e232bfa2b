"""Parity of the ported field (gfnerf_tpu_torch/fields/field.py, mlp.py,
sh_encoding.py, activations.py) with the JAX package's.

Tolerances: with ``mlp_dtype="float32"`` both packages compute the same f32
arithmetic up to summation order and multiply-add contraction, held to 1e-5.
With ``"bfloat16"`` the hidden activations are rounded to bf16 after every
layer; XLA and torch accumulate the matmuls in different orders, so an
activation can round to a neighbouring bf16 value (a relative step of
2^-8) in one package and not the other.  Such a flip moved outputs of order
1 by up to 8e-4 in trials; the bound used there, 5e-3 relative to the
output's scale, leaves a sixfold margin.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import field_kwargs, field_pair, octree_pair

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-3, atol=5e-3)}


def _flat(params, statics):
    """Every leaf of (FieldParams, FieldStatics), JAX or port, by name."""
    out = {}
    for obj in (params, statics):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, dict):
                for k in ("w", "b"):
                    for i, x in enumerate(v[k]):
                        out[f"{f.name}.{k}{i}"] = np.asarray(x)
            elif v is not None:
                out[f.name] = np.asarray(v)
    return out


@pytest.mark.parametrize("focal_mode", ["residual", "finetune"])
def test_init_field_params_bit_identical(focal_mode):
    from gfnerf_tpu.fields.field import FieldConfig as JCfg
    from gfnerf_tpu.fields.field import init_field_params as jinit
    from gfnerf_tpu_torch.fields.field import FieldConfig, init_field_params

    kw = field_kwargs(focal_mode=focal_mode)
    want = _flat(*jinit(JCfg(**kw), seed=4))
    got = _flat(*init_field_params(FieldConfig(**kw), seed=4))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_params_from_jax_round_trip():
    _, params, statics, field = field_pair(seed=1)
    want = _flat(params, statics)
    got = _flat(*field.to_numpy())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert field.global_prim.dtype == torch.int64
    n_params = sum(p.numel() for p in field.parameters())
    assert n_params == sum(v.size for k, v in want.items()
                           if "prim" not in k and "bias" not in k)


def _sample_inputs(n_volumes, r=32, s=24, seed=0):
    rng = np.random.default_rng(seed)
    warp = rng.uniform(-1.0, 1.0, (r, s, 3)).astype(np.float32)
    anc = rng.integers(0, n_volumes, (r, s)).astype(np.int32)
    anc[rng.random((r, s)) < 0.2] = -1
    dirs = rng.normal(size=(r, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(
        np.float32)
    rel = rng.integers(0, 6, r).astype(np.int32)
    return warp, anc, dirs, rel


@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
def test_field_density_and_rgb_match(mlp_dtype):
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import field as J
    from gfnerf_tpu_torch.fields import field as T

    jcfg, params, statics, field = field_pair(seed=2, mlp_dtype=mlp_dtype)
    warp, anc, dirs, rel = _sample_inputs(jcfg.n_volumes)

    @jax.jit
    def jax_fwd(params, statics, warp, anc, dirs, rel):
        dens, geo = J.field_density(params, statics, jcfg, warp, anc,
                                    J.STAGE_INIT)
        rgb = J.field_rgb_per_ray(params, jcfg, dirs, geo, rel,
                                  J.STAGE_INIT)["rgb"]
        return dens, geo, rgb

    want = jax_fwd(params, statics, *(jnp.asarray(x)
                                      for x in (warp, anc, dirs, rel)))
    with torch.no_grad():
        dens, geo = T.field_density(field, torch.as_tensor(warp),
                                    torch.as_tensor(anc))
        rgb = T.field_rgb_per_ray(field, torch.as_tensor(dirs), geo,
                                  torch.as_tensor(rel).long())["rgb"]
    for name, g, w in zip(("density", "geo", "rgb"), (dens, geo, rgb), want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(1.0, float(np.abs(w).max()))
        tol = TOL[mlp_dtype]
        np.testing.assert_allclose(g.numpy(), w, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, err_msg=name)
    assert np.all(dens.numpy()[anc < 0] == 0)


def test_trunc_exp_gradient_is_clamped():
    from gfnerf_tpu_torch.fields.activations import trunc_exp

    x = torch.tensor([-20.0, 0.5, 20.0], requires_grad=True)
    trunc_exp(x).sum().backward()
    want = torch.exp(torch.tensor([-15.0, 0.5, 15.0]))
    assert torch.allclose(x.grad, want)


def test_sh_encoding_and_mlp_match():
    import jax.numpy as jnp
    from gfnerf_tpu.fields.mlp import apply_mlp as japply
    from gfnerf_tpu.fields.sh_encoding import sh_encode_deg4 as jsh
    from gfnerf_tpu_torch.fields.mlp import MLP, apply_mlp, init_mlp
    from gfnerf_tpu_torch.fields.sh_encoding import sh_encode_deg4

    rng = np.random.default_rng(0)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(sh_encode_deg4(torch.as_tensor(d)).numpy(),
                               np.asarray(jsh(jnp.asarray(d))), rtol=1e-5,
                               atol=1e-6)
    params = init_mlp(np.random.default_rng(1), 16, 4, 32, 2)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    jp = {k: [jnp.asarray(a) for a in v] for k, v in params.items()}
    with torch.no_grad():
        got = apply_mlp(MLP(params, device="cpu"), torch.as_tensor(x),
                        "sigmoid")
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(japply(jp, jnp.asarray(x),
                                                 "sigmoid")),
                               rtol=1e-5, atol=1e-6)
