"""Parity of the ported schedules and per-group Adam
(gfnerf_tpu_torch/engine/) with the JAX package's optax optimizer, fed
identical numpy gradients: learning rates over warm-up, decay and split
restarts, and six updates of every group, one of them with a NaN gradient
that must be skipped without moving the moments or the schedule's count.
Tolerance 1e-6 relative, with an atol of 1e-6 of the learning rate on the
updates: the same f32 arithmetic, bias corrections included, except that
XLA contracts the moment updates into fused multiply-adds, whose rounding
shows where two steps' gradients cancel."""

import numpy as np
import pytest
import torch

from torch_parity import field_pair, to_np

TOL = 1e-6


@pytest.mark.parametrize("warmup,ramp", [(0, "cosine"), (20, "cosine"),
                                         (20, "linear")])
def test_schedules_match_jax(warmup, ramp):
    from gfnerf_tpu.engine import schedulers as J
    from gfnerf_tpu_torch.engine import schedulers as T

    steps = [0, 1, 5, 19, 20, 21, 99, 100, 101, 149, 150, 151, 199, 200,
             250, 310, 999]
    kw = dict(lr_final=1e-4, max_steps=100, warmup_steps=warmup, ramp=ramp)
    for jf, tf, cfg_j, cfg_t in (
            (J.exponential_decay_schedule, T.exponential_decay_schedule,
             J.ExponentialDecaySchedulerConfig(**kw),
             T.ExponentialDecaySchedulerConfig(**kw)),
            (J.gfnerf_exponential_decay_schedule,
             T.gfnerf_exponential_decay_schedule,
             J.GFNerfExponentialDecaySchedulerConfig(
                 steps_perssampler_init=100, steps_per_split_dataset=50,
                 n_split_dataset=2, **kw),
             T.GFNerfExponentialDecaySchedulerConfig(
                 steps_perssampler_init=100, steps_per_split_dataset=50,
                 n_split_dataset=2, **kw))):
        js, ts = jf(cfg_j, 1e-2), tf(cfg_t, 1e-2)
        want = np.array([float(js(s)) for s in steps])
        got = np.array([float(ts(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=TOL, err_msg=jf.__name__)


def test_gfnerf_scheduler_restarts():
    """The oracle of tests/test_components.py: decay over init, restart at
    each focal split."""
    from gfnerf_tpu_torch.engine.schedulers import (
        GFNerfExponentialDecaySchedulerConfig,
        gfnerf_exponential_decay_schedule)

    sched = gfnerf_exponential_decay_schedule(
        GFNerfExponentialDecaySchedulerConfig(
            lr_final=1e-4, max_steps=100, steps_perssampler_init=100,
            steps_per_split_dataset=50, n_split_dataset=2), 1e-2)
    assert abs(float(sched(0)) - 1e-2) < 1e-6
    assert abs(float(sched(100)) - 1e-2) < 1e-6
    assert float(sched(149)) < float(sched(100))
    assert abs(float(sched(150)) - 1e-2) < 1e-6


def _jax_leaves(params_nb, table):
    return {
        "fields": [*params_nb.base_net["w"], *params_nb.base_net["b"],
                   *params_nb.mlp_head["w"], *params_nb.mlp_head["b"],
                   params_nb.appearance_embedding],
        "base_encoding_init": [params_nb.global_feat],
        "block": [table],
    }


def _jax_tree(params_nb, table, leaves):
    """(params_nb, table) with the group leaves replaced."""
    f = leaves["fields"]
    nw, nb = len(params_nb.base_net["w"]), len(params_nb.base_net["b"])
    hw = len(params_nb.mlp_head["w"])
    return (params_nb.replace(
        base_net={"w": f[:nw], "b": f[nw:nw + nb]},
        mlp_head={"w": f[nw + nb:nw + nb + hw], "b": f[nw + nb + hw:-1]},
        appearance_embedding=f[-1],
        global_feat=leaves["base_encoding_init"][0]), leaves["block"][0])


def test_per_group_adam_matches_optax():
    import jax.numpy as jnp
    import optax
    from gfnerf_tpu.engine.optimizers import OptimizersConfig as JCfg
    from gfnerf_tpu.engine.optimizers import build_optimizer as jbuild
    from gfnerf_tpu.engine.optimizers import optimizer_arg
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    apply_updates,
                                                    build_optimizer,
                                                    field_param_groups)

    kw = dict(steps_perssampler_init=3, steps_per_split_dataset=2,
              n_split_dataset=2, block_weight_decay=0.1)
    _, params, _, field = field_pair(seed=1, packed_rows_log2=6)
    rng = np.random.default_rng(0)
    table0 = rng.uniform(-1, 1, params.block_feats.shape[1:]).astype(
        np.float32)
    with torch.no_grad():
        field.block_feats[0] = torch.as_tensor(table0)
    params_nb, _ = optimizer_arg(params)
    table = jnp.asarray(table0)
    jtx = jbuild(JCfg(**kw), params)
    jstate = jtx.init((params_nb, table))
    tx = build_optimizer(OptimizersConfig(**kw))
    groups = field_param_groups(field)
    state = tx.init(groups)

    for step in range(7):
        shapes = {k: [np.shape(x) for x in v]
                  for k, v in _jax_leaves(params_nb, table).items()}
        grads = {k: [rng.standard_normal(sh).astype(np.float32) * 0.1
                     for sh in v] for k, v in shapes.items()}
        if step < 2:   # the block table outside the graph: a zero gradient
            grads["block"] = [np.zeros_like(grads["block"][0])]
        if step == 3:
            grads["fields"][1][0, 0] = np.nan
        jg = _jax_tree(params_nb, table,
                       {k: [jnp.asarray(g) for g in v]
                        for k, v in grads.items()})
        jupd, jstate = jtx.update(jg, jstate, (params_nb, table))
        params_nb, table = optax.apply_updates((params_nb, table), jupd)

        tg = {k: [torch.as_tensor(g) for g in v] for k, v in grads.items()}
        if step < 2:
            tg["block"] = [None]
        tg["camera_opt"] = []
        upd, state = tx.update(tg, state, groups)
        apply_updates(groups, upd)

        want = _jax_leaves(*jupd)
        for name in want:
            for i, (u, w) in enumerate(zip(upd[name], want[name])):
                got = np.zeros_like(np.asarray(w)) if u is None else to_np(u)
                np.testing.assert_allclose(
                    got, np.asarray(w), rtol=TOL, atol=TOL * 1e-2,
                    err_msg=f"step {step} {name}[{i}]")
        assert state.last_finite == (step != 3)
        assert state.count == step + (step < 3)
    assert state.total_notfinite == 1
    final = _jax_leaves(params_nb, table)
    for name in final:
        for p, w in zip(groups[name], final[name]):
            np.testing.assert_allclose(to_np(p), np.asarray(w), rtol=TOL,
                                       atol=1e-7)


def test_mask_frozen_grads():
    from gfnerf_tpu_torch.engine.optimizers import mask_frozen_grads
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT

    grads = {"fields": [torch.ones(3)], "base_encoding_init": [torch.ones(2)],
             "block": [torch.ones(4)], "camera_opt": [None]}
    assert mask_frozen_grads(grads, STAGE_INIT) is grads
    masked = mask_frozen_grads(grads, STAGE_BLOCK)
    assert torch.equal(masked["block"][0], torch.ones(4))
    assert not masked["fields"][0].any()
    assert not masked["base_encoding_init"][0].any()
    assert masked["camera_opt"] == [None]
