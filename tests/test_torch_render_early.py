"""The port's two-phase early-termination renderer
(``gfnerf_tpu_torch.models.render_early.EarlyTermRenderer``) against its
own single pass and the JAX package's renderer, on the tiny scene: the
three cases of tests/test_render_early.py.

- eps = 0, both stages: every ray with transmittance left survives, and
  the composed result equals the single pass (rtol 1e-4, atol 1e-5,
  tests/test_render_early.py's: the head and tail composite in other
  orders than one pass).
- a realistic eps (5e-3) on a denser field: within 2 eps of the single
  pass, and most rays terminate.
- a compaction budget (24 of 64 slots) with a block per ray.

Each is also held to the JAX package's ``EarlyTermRenderer`` on the same
field, octree and rays at tests/test_torch_render.py's f32 tolerance (rtol
1e-5, atol 1e-5), with the same share of survivors.
"""

import numpy as np
import pytest
import torch

from torch_parity import field_pair, octree_pair, tiny_rays, to_np

S = 64
KEYS = ("rgb", "accumulation", "depth")


def _scene(budget=0, density_mult=1.0, **field_over):
    """(JAX params, statics, cfg, the port's field, JAX octree, the port's
    octree, model kwargs, sampler kwargs, rays (numpy))."""
    jcfg, params, statics, field = field_pair(block_scale=0.3,
                                              mlp_dtype="float32",
                                              **field_over)
    if density_mult != 1.0:
        params = params.replace(global_feat=params.global_feat
                                * density_mult)
        with torch.no_grad():
            field.global_feat.mul_(density_mult)
    joct, toct = octree_pair()
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=budget)
    skw = dict(max_samples=S, sample_l=1.0 / 64)
    return (params, statics, jcfg, field, joct, toct, mkw, skw,
            tiny_rays(n_rays=64))


def _jax_early(scene, s1, eps, active_block, stage_is_block):
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig
    from gfnerf_tpu.models.render_early import EarlyTermRenderer
    from gfnerf_tpu.sampler.perssampler import SamplerConfig

    params, statics, jcfg, _, joct, _, mkw, skw, (o, d) = scene
    et = EarlyTermRenderer(jcfg, GFNeRFModelConfig(n_blocks=2, **mkw),
                           SamplerConfig(**skw), s1=s1, eps=eps,
                           min_bucket=16)
    out = et.render_chunk(params, statics, joct, jnp.asarray(o),
                          jnp.asarray(d), jnp.zeros((len(o),), jnp.int32),
                          jnp.asarray(active_block, jnp.int32),
                          stage_is_block)
    return out, et.last_survivor_frac


def _port(scene, s1, eps, active_block, stage_is_block):
    """(early-termination render, survivor share, single-pass render)."""
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_render_fn)
    from gfnerf_tpu_torch.models.render_early import EarlyTermRenderer
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    _, _, _, field, _, toct, mkw, skw, (o, d) = scene
    mcfg, scfg = GFNeRFModelConfig(**mkw), SamplerConfig(**skw)
    et = EarlyTermRenderer(mcfg, scfg, s1=s1, eps=eps)
    args = (field, toct, torch.as_tensor(o), torch.as_tensor(d), 0,
            active_block, stage_is_block)
    out = et.render_chunk(*args)
    ref = make_render_fn(mcfg, scfg)(*args)
    return ({k: to_np(v) for k, v in out.items()}, et.last_survivor_frac,
            {k: to_np(v) for k, v in ref.items()})


def _match_jax(got, frac, want, jfrac):
    assert frac == jfrac
    for k in KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{k} vs JAX")


@pytest.mark.parametrize("stage_is_block", [False, True])
def test_early_term_eps0_matches_single_pass(stage_is_block):
    scene = _scene()
    got, frac, ref = _port(scene, 16, 0.0, 1, stage_is_block)
    # a ray whose transmittance underflowed to exactly 0 may drop out: its
    # tail contributes exactly 0
    assert frac > 0.5
    assert ref["accumulation"].max() > 0.3
    for k in KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["oct_depth"], ref["oct_depth"])
    _match_jax(got, frac, *_jax_early(scene, 16, 0.0, 1, stage_is_block))


def test_early_term_realistic_eps_close_and_terminates():
    eps = 5e-3
    # a dense field (the global table tripled, density bias 3), so that
    # most rays saturate inside the head segment
    scene = _scene(density_mult=3.0, density_bias=3.0)
    got, frac, ref = _port(scene, 32, eps, 0, False)
    assert frac < 0.5, "few rays terminated"
    # the dropped tail of a terminated ray weighs at most eps
    for k in ("rgb", "accumulation"):
        np.testing.assert_allclose(got[k], ref[k], atol=2 * eps, err_msg=k)
    _match_jax(got, frac, *_jax_early(scene, 32, eps, 0, False))


def test_early_term_budget_and_per_ray_blocks_run():
    """Compacted phases (budget 24 of 64: phase 1's min(max(32, 6), 16) =
    16 of its 16 slots, dense; phase 2's max(32, 18) = 32 of 48) and a block
    per ray: finite, plausible, and
    equal to the JAX package's (whose survivors are padded to a bucket)."""
    scene = _scene(budget=24)
    blocks = np.arange(64) % 2
    got, frac, _ = _port(scene, 16, 1e-3, torch.as_tensor(blocks), True)
    for k in KEYS:
        assert np.isfinite(got[k]).all(), k
    assert 0.01 < got["accumulation"].max() <= 1.0 + 1e-5
    _match_jax(got, frac, *_jax_early(scene, 16, 1e-3, blocks, True))


def test_early_term_refuses_what_it_cannot_compose():
    """A background other than black, and a head segment outside (0, S)."""
    from gfnerf_tpu_torch.models.gfnerf import GFNeRFModelConfig
    from gfnerf_tpu_torch.models.render_early import EarlyTermRenderer
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    scfg = SamplerConfig(max_samples=S)
    with pytest.raises(ValueError):
        EarlyTermRenderer(GFNeRFModelConfig(background_color="white"), scfg)
    for s1 in (0, S):
        with pytest.raises(ValueError):
            EarlyTermRenderer(GFNeRFModelConfig(), scfg, s1=s1)
