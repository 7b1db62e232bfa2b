"""``remat_chunks`` in the port's ``model_forward``: the field's evaluation
in checkpointed chunks (``torch.utils.checkpoint``) of points (compacted
branch) or of rays (dense branch), against the JAX package's
``jax.checkpoint``-ed ``lax.map`` and against the port's own straight-line
path: the four cases of tests/test_remat.py (forward, gradients, the dense
path, the focal stage with the empty-space penalty's shared branch).

Remat changes only what the backward keeps, so the port's chunked path is
held to its own straight-line path at tests/test_remat.py's tolerances
(outputs rtol 1e-5, atol 1e-6; gradients rtol 2e-4, atol 1e-6 of the
largest, 1e-5 on the dense path and the focal table), and to the JAX
package's chunked path at tests/test_torch_train.py's: outputs rtol 1e-5,
atol 1e-5; MLP gradients 1e-3 of the group's largest, the packed table's
2e-2 (the JAX backward's bf16 payload).  Densities at the block stage to
2e-4 of their scale, as in tests/test_torch_compaction.py.
"""

import numpy as np
import pytest
import torch

from torch_parity import (field_pair, jax_samples, marched_np, octree_pair,
                          port_samples, to_np)

R, S, BUDGET, CHUNKS = 8, 32, 8, 4
KEYS = ("rgb", "weights", "depth", "accumulation")


def _inputs(seed=0):
    """A march of the tiny scene (R rays, S slots; most rays hold more
    than BUDGET valid samples), the rays' directions and camera indices,
    numpy.  ``seed`` picks the rays."""
    x, dirs = marched_np(R, S, seed=3 + seed)
    assert (x["valid"].sum(1) > BUDGET).mean() > 0.5
    return x, dirs, np.zeros(R, np.int64)


class _Counted:
    """torch.utils.checkpoint, counting its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def _port(field, x, dirs, rel, budget, chunks, stage=0, penalty=0.0,
          table=None, monkeypatch=None):
    """The port's model_forward with a gradient recorded; checks that the
    chunked path ran (``chunks`` checkpointed calls)."""
    from gfnerf_tpu_torch.models import gfnerf as M

    counted = _Counted(M.checkpoint)
    monkeypatch.setattr(M, "checkpoint", counted)
    _, toct = octree_pair()
    cfg = M.GFNeRFModelConfig(scale_factor=1.0, samples_budget_per_ray=budget,
                              remat_chunks=chunks,
                              empty_space_penalty_mult=penalty)
    out = M.model_forward(field, cfg, port_samples(x), torch.as_tensor(dirs),
                          torch.as_tensor(rel), stage, toct, 0, table)
    assert counted.calls == (chunks if chunks > 1 else 0)
    return out


def _jax(params, statics, jcfg, x, dirs, rel, budget, chunks, stage=0,
         penalty=0.0, table=None):
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig, model_forward

    joct, _ = octree_pair()
    cfg = GFNeRFModelConfig(n_blocks=2, scale_factor=1.0,
                            samples_budget_per_ray=budget,
                            remat_chunks=chunks,
                            empty_space_penalty_mult=penalty)
    return model_forward(params, statics, jcfg, cfg, jax_samples(x),
                         jnp.asarray(dirs), jnp.asarray(rel, jnp.int32),
                         stage, 0, oct_dev=joct, warp_deferred=True,
                         active_table=table)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _port_grads(field, loss):
    field.zero_grad(set_to_none=True)
    loss.backward()
    return {name: to_np(p.grad) for name, p in field.named_parameters()
            if p.grad is not None}


def _jax_grads(grads):
    """A JAX FieldParams gradient as the port's parameter names."""
    out = {"global_feat": grads.global_feat,
           "appearance_embedding": grads.appearance_embedding}
    for net in ("base_net", "mlp_head"):
        for kind in ("w", "b"):
            for i, g in enumerate(getattr(grads, net)[kind]):
                out[f"{net}.{kind}.{i}"] = g
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _check_grads(got, base, want, rtol_self, atol_self):
    """The chunked path's gradients against the straight-line path's (at
    ``rtol_self``, ``atol_self`` of the largest) and the JAX package's
    chunked path's (test_torch_train.py's group tolerances)."""
    assert got.keys() == base.keys()
    assert any(np.abs(g).max() > 0 for g in got.values())
    for name, g in got.items():
        scale = float(np.abs(base[name]).max())
        np.testing.assert_allclose(g, base[name], rtol=rtol_self,
                                   atol=atol_self * scale, err_msg=name)
        tol = 2e-2 if name == "global_feat" else 1e-3
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g, want[name], rtol=tol, atol=tol * scale,
                                   err_msg=f"{name} vs JAX")


def test_remat_forward_matches_init_stage(monkeypatch):
    jcfg, params, statics, field = field_pair(mlp_dtype="float32")
    x, dirs, rel = _inputs()
    base = _port(field, x, dirs, rel, BUDGET, 0, monkeypatch=monkeypatch)
    got = _port(field, x, dirs, rel, BUDGET, CHUNKS, monkeypatch=monkeypatch)
    want = _jax(params, statics, jcfg, x, dirs, rel, BUDGET, CHUNKS)
    for k in KEYS:
        _close(got[k], to_np(base[k]), 1e-5, 1e-6, k)
        _close(got[k], want[k], 1e-5, 1e-5, f"{k} vs JAX")


def test_remat_grads_match_init_stage(monkeypatch):
    import jax
    import jax.numpy as jnp

    jcfg, params, statics, field = field_pair(mlp_dtype="float32")
    x, dirs, rel = _inputs()
    target = np.random.default_rng(3).random((R, 3)).astype(np.float32)
    tt = torch.as_tensor(target)

    def loss(chunks):
        out = _port(field, x, dirs, rel, BUDGET, chunks,
                    monkeypatch=monkeypatch)
        return torch.mean((out["rgb"] - tt) ** 2)

    def jloss(p):
        out = _jax(p, statics, jcfg, x, dirs, rel, BUDGET, CHUNKS)
        return jnp.mean((out["rgb"] - jnp.asarray(target)) ** 2)

    base = _port_grads(field, loss(0))
    got = _port_grads(field, loss(CHUNKS))
    want = _jax_grads(jax.grad(jloss)(params))
    _check_grads(got, base, want, 2e-4, 1e-6)


def test_remat_dense_path_matches(monkeypatch):
    """budget 0 (no compaction): the dense path chunks over rays."""
    import jax
    import jax.numpy as jnp

    jcfg, params, statics, field = field_pair(mlp_dtype="float32")
    x, dirs, rel = _inputs(seed=1)
    target = np.random.default_rng(7).random((R, 3)).astype(np.float32)
    tt = torch.as_tensor(target)
    base = _port(field, x, dirs, rel, 0, 0, monkeypatch=monkeypatch)
    got = _port(field, x, dirs, rel, 0, CHUNKS, monkeypatch=monkeypatch)
    want = _jax(params, statics, jcfg, x, dirs, rel, 0, CHUNKS)
    for k in KEYS:
        _close(got[k], to_np(base[k]), 2e-4, 1e-5, k)
        _close(got[k], want[k], 1e-5, 1e-5, f"{k} vs JAX")

    def jloss(p):
        out = _jax(p, statics, jcfg, x, dirs, rel, 0, CHUNKS)
        return jnp.mean((out["rgb"] - jnp.asarray(target)) ** 2)

    g0 = _port_grads(field, torch.mean((base["rgb"] - tt) ** 2))
    g1 = _port_grads(field, torch.mean((got["rgb"] - tt) ** 2))
    _check_grads(g1, g0, _jax_grads(jax.grad(jloss)(params)), 2e-4, 1e-5)


def test_remat_with_shared_focal_branch(monkeypatch):
    """The three-output chunk (density, shared density, heads) under the
    empty-space penalty at the block stage: outputs and the active
    residual table's gradient equal the straight-line path's and the JAX
    package's."""
    import jax
    import jax.numpy as jnp

    jcfg, params, statics, field = field_pair(mlp_dtype="float32",
                                              block_scale=0.3)
    x, dirs, rel = _inputs()

    def run(chunks):
        table = field.block_feats.detach()[0].clone().requires_grad_(True)
        out = _port(field, x, dirs, rel, BUDGET, chunks, stage=1,
                    penalty=0.01, table=table, monkeypatch=monkeypatch)
        pen = torch.sum(torch.relu(out["density"] - out["density_shared"]))
        (torch.mean(out["rgb"] ** 2) + 1e-3 * pen).backward()
        return out, to_np(table.grad)

    def jrun(tbl):
        p = params.replace(block_feats=params.block_feats.at[0].set(tbl))
        return _jax(p, statics, jcfg, x, dirs, rel, BUDGET, CHUNKS, stage=1,
                    penalty=0.01, table=tbl)

    def jloss(tbl):
        out = jrun(tbl)
        pen = jnp.sum(jax.nn.relu(out["density"] - out["density_shared"]))
        return jnp.mean(out["rgb"] ** 2) + 1e-3 * pen

    (base, g0), (got, g1) = run(0), run(CHUNKS)
    tbl = params.block_feats[0]
    want, jg = jrun(tbl), np.asarray(jax.grad(jloss)(tbl))
    for k in ("rgb", "density", "density_shared"):
        _close(got[k], to_np(base[k]), 2e-4, 1e-5, k)
        scale = 1.0 if k == "rgb" else float(np.abs(want[k]).max())
        tol = 1e-5 if k == "rgb" else 2e-4
        _close(got[k], want[k], tol, tol * scale, f"{k} vs JAX")
    assert np.abs(to_np(got["density"]) - to_np(got["density_shared"])
                  ).max() > 1e-4
    scale = float(np.abs(g0).max())
    assert scale > 0
    np.testing.assert_allclose(g1, g0, rtol=2e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(g1, jg, rtol=2e-2,
                               atol=2e-2 * float(np.abs(jg).max()))
