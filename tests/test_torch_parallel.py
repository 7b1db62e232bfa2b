"""Multi-card training of the port (gfnerf_tpu_torch/parallel) on the CPU:
ranks in spawned processes of one gloo group (tests/torch_dist_worker.py),
held against the JAX package's mesh steps on the conftest's 8 CPU devices.

- The rank grid against ``make_mesh``'s and ``make_multihost_mesh``'s
  device orders, and the automatic block axis.
- The data-parallel step at 4 ranks against ``make_dp_train_step`` on a
  (4, 1) mesh, from the same parameters, batch and draws, at
  tests/test_torch_train.py's tolerances (the loss and its parts 1e-5
  relative; the per-ray error 1e-5; the gradients rtol 1e-3 and 1e-3 of
  the group's largest (MLPs), 2e-2 and 2e-2 (the table); the updated
  parameters to 1e-5 where the gradient is well above its tolerance); the
  ranks bit-identical; the merged occupancy statistics exactly the
  one-process port step's, and the ranks' gradients against that step's
  to 1e-5 of each group's largest (sums taken in another order); the
  terms each reduce in their own way (semantics and the camera
  regularizer at init, the empty-space and trust terms at the focal
  stage) against the one-process port step: metrics to 1e-5 relative,
  Adam's first moments to 1e-5 of each group's largest.
- The concurrent focal step at 4 ranks (data 2 x block 2) against
  ``make_parallel_block_step`` on a (2, 2) mesh: the block tables (the
  moved table to 1e-5 where JAX's gradient is well above the table
  tolerance, the others bit for bit), the per-group losses (1e-5
  relative) and the errors (1e-5), at 2 blocks and at 10 blocks through
  all 5 phases of the rotation.
- The Trainer across the transition with ``parallel_blocks`` (no
  collective at its step boundaries without the viewer), rank 0's
  checkpoint in a one-process pipeline, and the launch flags.

Every spawned run has a deadline (``torch_dist_worker.run_ranks``), so a
hang fails in about two minutes.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as tdw
from torch_parity import IMG_WH, field_pair, octree_pair
from torch_parity import TRAIN_R as R
from torch_parity import TRAIN_S as S
from torch_parity import TRAIN_SAMPLE_L as SAMPLE_L
from torch_parity import jax_groups as _jax_groups
from torch_parity import train_batch as _batch
from torch_parity import train_cameras_np as _cameras_np

REPO = Path(__file__).resolve().parents[1]
TABLE_TOL = 2e-2
MLP_TOL = 1e-3


# ------------------------------------------------------------------ grid ----


def test_grid_matches_make_mesh():
    from gfnerf_tpu.parallel.sharding import make_mesh
    from gfnerf_tpu_torch.parallel import make_grid

    for n_data, n_block in ((4, 2), (2, 2), (8, 1), (1, 4)):
        mesh = make_mesh(n_data, n_block)
        grid = make_grid(n_data, n_block)
        ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
        np.testing.assert_array_equal(grid.layout, ids)
        for rank in range(grid.world):
            d, b = grid.coords(rank)
            assert ids[d, b] == rank
        assert grid.data_ranks(0) == list(ids[:, 0])


@pytest.mark.parametrize("n_block", [1, 2, 4])
def test_multihost_grid_on_the_conftest_devices(n_block):
    """``make_multihost_mesh`` on the conftest's 8 CPU devices (one
    process): the port's grid of 8 ranks on one host matches it."""
    from gfnerf_tpu.parallel.sharding import make_multihost_mesh
    from gfnerf_tpu_torch.parallel import multihost_grid

    mesh = make_multihost_mesh(n_block)
    ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
    assert ids.size == 8
    np.testing.assert_array_equal(multihost_grid(8, 1, n_block).layout, ids)


class _Dev:
    def __init__(self, i, per_host):
        self.id = i
        self.process_index = i // per_host


@pytest.mark.parametrize("n_hosts,per_host,n_block", [
    (1, 8, 1), (1, 8, 2), (4, 2, 2), (4, 2, 4), (2, 4, 4), (8, 1, 2),
    (3, 4, 2), (6, 2, 3), (2, 4, 1)])
def test_multihost_grid_matches_make_multihost_mesh(monkeypatch, n_hosts,
                                                    per_host, n_block):
    """The multi-host rules (sharding.py:86-96): block groups span whole
    hosts when the hosts divide among them, else the devices fill the grid
    row by row; JAX's mesh function run on stand-in devices of n_hosts hosts."""
    import gfnerf_tpu.parallel.sharding as js
    from gfnerf_tpu_torch.parallel import multihost_grid

    devs = [_Dev(i, per_host) for i in range(n_hosts * per_host)]
    monkeypatch.setattr(js.jax, "devices", lambda: devs)
    monkeypatch.setattr(js.jax, "process_count", lambda: n_hosts)
    monkeypatch.setattr(js, "Mesh", lambda d, axis_names: np.asarray(d))
    want = np.vectorize(lambda dev: dev.id)(js.make_multihost_mesh(n_block))
    got = multihost_grid(n_hosts * per_host, n_hosts, n_block)
    np.testing.assert_array_equal(got.layout, want)
    if n_block > 1 and n_hosts % n_block == 0:
        # a block group's ranks are whole hosts
        for b in range(n_block):
            hosts = {r // per_host for r in got.data_ranks(b)}
            assert len(hosts) == n_hosts // n_block


def test_block_axis_as_in_jax():
    """The automatic block axis (pipeline.py:224-231): the largest b <=
    min(world, n_blocks) dividing both; a requested one must divide
    both."""
    from gfnerf_tpu_torch.parallel import block_axis

    for world, n_blocks, want in ((4, 10, 2), (8, 10, 2), (4, 2, 2),
                                  (8, 8, 8), (3, 10, 1), (6, 9, 3),
                                  (2, 10, 2)):
        want_jax = max(b for b in range(1, min(world, n_blocks) + 1)
                       if world % b == 0 and n_blocks % b == 0)
        assert block_axis(world, n_blocks) == want == want_jax
    assert block_axis(8, 10, requested=2) == 2
    with pytest.raises(ValueError):
        block_axis(8, 10, requested=4)


# ------------------------------------------------ the data-parallel step ----

WORLD = 4


def _jax_dp_step(jcfg, params, statics, joct, batch, mkw, key_seed):
    """JAX's ``make_dp_train_step`` on a (4, 1) mesh, and its draws."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.data.dataparsers.base import CamerasHost
    from gfnerf_tpu.engine.optimizers import (OptimizersConfig,
                                              build_optimizer, optimizer_arg)
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig, TrainState
    from gfnerf_tpu.parallel.sharding import make_dp_train_step, make_mesh
    from gfnerf_tpu.sampler.perssampler import SamplerConfig

    c2w, fx, fy, cx, cy = _cameras_np()
    w, h = IMG_WH
    n = len(c2w)
    cams = CamerasHost(camera_to_worlds=c2w, fx=fx, fy=fy, cx=cx, cy=cy,
                       width=np.full(n, w, np.int32),
                       height=np.full(n, h, np.int32)).to_device()
    tx = build_optimizer(OptimizersConfig(), params)
    state = TrainState(params=params, opt_state=tx.init(optimizer_arg(params)),
                       step=jnp.asarray(0, jnp.int32))
    mcfg = GFNeRFModelConfig(n_blocks=2, **mkw)
    step = make_dp_train_step(jcfg, mcfg, SamplerConfig(
        max_samples=S, sample_l=SAMPLE_L), tx, make_mesh(WORLD, 1))
    key = jax.random.PRNGKey(key_seed)
    out = step(state, statics, joct, cams,
               {k: jnp.asarray(v) for k, v in batch.items()},
               jnp.asarray(1.0, jnp.float32), jnp.asarray(0, jnp.int32), key)
    k_noise, k_s3im, _ = jax.random.split(key, 3)
    noise = (jax.random.uniform(k_noise, (R, S)) - 0.5) + 1.0
    perms = [jax.random.permutation(k, R) for k in
             jax.random.split(k_s3im, mcfg.s3im_repeat_time - 1)]
    return out, np.array(noise), np.stack([np.asarray(p) for p in perms])


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX DP step, the 4-rank port DP step and the one-process port
    step, all from the same parameters, batch and draws."""
    from torch_parity import port_train_step

    tmp = tmp_path_factory.mktemp("dp")
    jcfg, params, statics, field = field_pair(mlp_dtype="float32")
    joct, toct = octree_pair()
    batch = _batch()
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=S)
    jax_out, noise, perms = _jax_dp_step(jcfg, params, statics, joct,
                                         batch, mkw, key_seed=5)
    before = {k: v.detach().clone() for k, v in field.state_dict().items()}
    torch.save({"field": field, "oct": toct, "batch": batch,
                "noise": noise, "perms": perms, "img_wh": IMG_WH,
                "cameras": _cameras_np(), "model": mkw,
                "sampler": dict(max_samples=S, sample_l=SAMPLE_L)},
               tmp / "case.pt")
    tdw.run_ranks(tdw.dp_step, WORLD, str(tmp / "case.pt"), str(tmp))
    ranks = tdw.load_results(tmp, WORLD)
    # the one-process port step on the whole batch, from the same state
    one_field = torch.load(tmp / "case.pt", weights_only=False)["field"]
    one = port_train_step(one_field, toct, batch, mkw, noise, perms)
    return {"jax": jax_out, "ranks": ranks, "one": one,
            "one_field": one_field, "before": before}


def test_dp_step_matches_jax_make_dp_train_step(dp_run):
    jstate, jo, jm, jerr = dp_run["jax"]
    rank0 = dp_run["ranks"][0]
    tm = rank0["metrics"]
    assert float(jm["num_samples_per_ray"]) > 20
    for k in ("loss", "rgb_loss", "s3im_loss", "psnr",
              "num_samples_per_ray", "frac_truncated_rays"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    err = torch.cat([r["err"] for r in dp_run["ranks"]]).numpy()
    np.testing.assert_allclose(err, np.asarray(jerr), rtol=1e-5, atol=1e-5)
    # the all-reduced gradients, read back from Adam's first moment
    inner = jstate.opt_state.inner_state.inner_states
    for name, tol in (("fields", MLP_TOL), ("base_encoding_init", TABLE_TOL)):
        jg = [np.asarray(m) / 0.1 for m in
              _jax_groups(inner[name].inner_state[0].mu[0])[name]]
        scale = max(float(np.abs(g).max()) for g in jg)
        jp = _jax_groups(jstate.params)[name]
        for i, (g, want_g, want_p) in enumerate(zip(rank0["grads"][name],
                                                    jg, jp)):
            np.testing.assert_allclose(g.numpy(), want_g, rtol=tol,
                                       atol=tol * scale,
                                       err_msg=f"{name}[{i}] grad")
            sure = np.abs(want_g) > 2 * tol * scale
            got = rank0["params"][name][i].numpy()
            np.testing.assert_allclose(got[sure], np.asarray(want_p)[sure],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name}[{i}] param")
    np.testing.assert_array_equal(
        dp_run["before"]["block_feats"].numpy(),
        np.asarray(jstate.params.block_feats))
    for k in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        np.testing.assert_array_equal(rank0["oct"][k].numpy(),
                                      np.asarray(getattr(jo, k)), err_msg=k)
    assert rank0["count"] == 1


def test_dp_ranks_bit_identical(dp_run):
    """Every rank holds the same parameters, gradients, metrics and
    octree after the step."""
    ranks = dp_run["ranks"]
    for other in ranks[1:]:
        for name, ps in ranks[0]["params"].items():
            for a, b in zip(ps, other["params"][name]):
                assert torch.equal(a, b), name
        for name, gs in ranks[0]["grads"].items():
            for a, b in zip(gs, other["grads"][name]):
                assert (a is None and b is None) or torch.equal(a, b), name
        assert other["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["oct"].items():
            assert torch.equal(v, other["oct"][k]), k


def test_dp_occupancy_merge_equals_one_process_step(dp_run):
    """The ranks' occupancy statistics, merged by a maximum, equal the
    one-process step's on the whole batch exactly; the summed gradients
    equal its gradients to the sum's rounding (1e-5 of each group's
    largest)."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    _, one_oct, one_m, one_err = dp_run["one"]
    rank0 = dp_run["ranks"][0]
    for k, v in rank0["oct"].items():
        assert torch.equal(v, getattr(one_oct, k)), k
    groups = field_param_groups(dp_run["one_field"])
    for name in ("fields", "base_encoding_init"):
        want = [p.grad for p in groups[name]]
        scale = max(float(g.abs().max()) for g in want)
        for g, w in zip(rank0["grads"][name], want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5 * scale)
    np.testing.assert_allclose(rank0["metrics"]["loss"],
                               float(one_m["loss"]), rtol=1e-6)
    err = torch.cat([r["err"] for r in dp_run["ranks"]])
    assert torch.equal(err, one_err)


DP_TERMS = {
    # an init step with the semantics heads' loss and the camera tangents'
    # regularizer (a term of the parameters alone: rank 0's backward)
    "semantics_camera": (dict(use_semantics=True, num_semantic_classes=3,
                              camera_opt_mode="SO3xR3"), 0.0, 0,
                         dict(use_semantics=True, semantic_loss_weight=0.5)),
    # focal steps: the empty-space term (its count the whole batch's), and
    # in finetune mode the trust region (a term of the parameters alone)
    "empty_space": ({}, 0.1, 1, dict(empty_space_penalty_mult=0.1,
                                     empty_space_tau=0.5)),
    "finetune_trust": (dict(focal_mode="finetune"), 0.1, 1,
                       dict(finetune_trust_mult=1.0)),
}


@pytest.mark.parametrize("case", sorted(DP_TERMS))
def test_dp_step_terms_equal_one_process_step(case, tmp_path):
    """The terms each data-parallel step reduces in its own way, at 4
    ranks against the one-process port step on the whole batch (itself
    held against JAX by tests/test_torch_train.py, test_torch_focal.py and
    test_torch_camera_semantics.py): every metric to 1e-5 relative, Adam's
    first moments (0.1 x the gradient) of every group to 1e-5 of the
    group's largest, the ranks bit-identical."""
    from torch_parity import port_train_step

    over, block_scale, stage, model = DP_TERMS[case]
    _, _, _, field = field_pair(mlp_dtype="float32", block_scale=block_scale,
                                **over)
    if field.camera_adjustment is not None:
        with torch.no_grad():
            field.camera_adjustment.copy_(0.05 * torch.randn(
                field.camera_adjustment.shape,
                generator=torch.Generator().manual_seed(1)))
    _, toct = octree_pair()
    batch = _batch(seed=3)
    if "semantics" in case:
        batch["semantics"] = (np.arange(R) % 3).astype(np.int32)
    rng = np.random.default_rng(4)
    noise = rng.uniform(0.5, 1.5, (R, S)).astype(np.float32)
    perms = np.stack([rng.permutation(R) for _ in range(9)])
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=S, **model)
    torch.save({"field": field, "oct": toct, "batch": batch, "noise": noise,
                "perms": perms, "img_wh": IMG_WH, "cameras": _cameras_np(),
                "model": mkw, "stage": stage, "active_block": 1,
                "sampler": dict(max_samples=S, sample_l=SAMPLE_L)},
               tmp_path / "case.pt")
    one_field = torch.load(tmp_path / "case.pt", weights_only=False)["field"]
    tdw.run_ranks(tdw.dp_step, WORLD, str(tmp_path / "case.pt"),
                  str(tmp_path))
    ranks = tdw.load_results(tmp_path, WORLD)
    state, _, metrics, _ = port_train_step(one_field, toct, batch, mkw,
                                           noise, perms, stage=stage,
                                           active_block=1)
    terms = {"semantics_camera": ("semantics_loss",
                                  "camera_opt_regularizer"),
             "empty_space": ("empty_space_loss",),
             "finetune_trust": ("trust_loss",)}[case]
    got = ranks[0]["metrics"]
    assert set(got) == set(metrics)
    for k in terms:
        assert float(metrics[k]) > 0, k
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    moved = 0
    for name, mus in state.opt_state.mu.items():
        want = [m for m in mus if m is not None]
        gots = [m for m in ranks[0]["mu"][name] if m is not None]
        assert len(gots) == len(want), name
        if not want:
            continue
        scale = max(float(m.abs().max()) for m in want)
        moved += scale > 0
        for a, b in zip(gots, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
    assert moved >= (3 if stage == 0 else 1)
    for other in ranks[1:]:
        assert other["metrics"] == got
        for name, mus in ranks[0]["mu"].items():
            for a, b in zip(mus, other["mu"][name]):
                assert (a is None and b is None) or torch.equal(a, b)


# --------------------------------------------- the concurrent focal step ----

PB_RAYS = 16 * 8       # the JAX tests' batch: 2 groups x 2 shards x 32


def _pb_setup(n_blocks, model_over=None):
    """The JAX tests' tiny setup (``__graft_entry__._tiny_setup``) in both
    packages, and their batch (tests/test_ten_blocks.py:126-141)."""
    import dataclasses

    import __graft_entry__ as ge
    from gfnerf_tpu_torch.fields.field import FieldConfig, params_from_jax
    from gfnerf_tpu_torch.sampler.perssampler import octree_to_device

    (c2w, intri, tree, oct_dev, scfg, fcfg, mcfg, params,
     statics) = ge._tiny_setup(n_blocks=n_blocks)
    if model_over:
        mcfg = dataclasses.replace(mcfg, **model_over)
    n_cams = len(c2w)
    rng = np.random.default_rng(0)
    batch = {
        "camera_indices": rng.integers(0, n_cams, PB_RAYS).astype(np.int32),
        "rel_camera_indices": rng.integers(0, n_cams,
                                           PB_RAYS).astype(np.int32),
        "coords": np.stack([rng.uniform(0, 24, PB_RAYS),
                            rng.uniform(0, 32, PB_RAYS)],
                           -1).astype(np.float32),
        "image": rng.random((PB_RAYS, 3)).astype(np.float32)}
    field = params_from_jax(params, statics, FieldConfig(
        num_images=n_cams, n_volumes=tree.n_volumes, log2_hashmap_size=8,
        n_blocks=n_blocks), device="cpu")
    port = {"field": field, "oct": octree_to_device(tree, 2048,
                                                    device="cpu"),
            "img_wh": (32, 24),
            "cameras": (c2w, intri[:, 0, 0], intri[:, 1, 1], intri[:, 0, 2],
                        intri[:, 1, 2]),
            "model": {k: getattr(mcfg, k) for k in (
                "n_blocks", "scale_factor", "s3im_patch_height",
                "use_ch_loss", "empty_space_penalty_mult",
                "finetune_trust_mult")},
            "sampler": dict(max_samples=scfg.max_samples,
                            sample_l=scfg.sample_l,
                            locate_iters=scfg.locate_iters),
            "grid": (2, 2)}
    return (c2w, intri, oct_dev, scfg, fcfg, mcfg, params, statics, batch,
            port)


def _jax_pb_run(n_blocks, phases, model_over=None, batch_fn=None):
    """``make_parallel_block_step`` on a (2, 2) mesh at each phase (key
    PRNGKey(phase)), threading the tables and the block Adam states as
    tests/test_ten_blocks.py does; with each phase's draws of a shard (the
    replicated key's split, sharding.py:233-235), and the port's case."""
    import jax
    import jax.numpy as jnp
    import optax
    from gfnerf_tpu.data.dataparsers.base import CamerasHost
    from gfnerf_tpu.parallel.sharding import (make_mesh,
                                              make_parallel_block_step,
                                              shard_params)

    (c2w, intri, oct_dev, scfg, fcfg, mcfg, params, statics, batch,
     port) = _pb_setup(n_blocks, model_over)
    if batch_fn is not None:
        batch = batch_fn(batch)
    mesh = make_mesh(2, 2)
    params, statics = shard_params(mesh, params, statics)
    tx_block = optax.chain(optax.scale_by_adam(eps=1e-15), optax.scale(-5e-3))
    ob = jax.vmap(tx_block.init)(params.block_feats)
    pb_step = make_parallel_block_step(fcfg, mcfg, scfg, tx_block, mesh)
    n = len(c2w)
    cams = CamerasHost(
        camera_to_worlds=c2w, fx=intri[:, 0, 0], fy=intri[:, 1, 1],
        cx=intri[:, 0, 2], cy=intri[:, 1, 2],
        width=np.full(n, 32, np.int32),
        height=np.full(n, 24, np.int32)).to_device()
    frozen = params.replace(block_feats=None)
    bf = params.block_feats
    out, draws = [], []
    r = PB_RAYS // 4
    for phase in range(phases):
        prev = np.asarray(bf)
        key = jax.random.PRNGKey(phase)
        bf, ob, losses, errs = pb_step(
            bf, statics.block_prims, statics.block_biases, ob, frozen,
            statics, oct_dev, cams, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
            jnp.asarray(1.0), jnp.asarray(phase, jnp.int32), key)
        k_noise, k_s3im = jax.random.split(key)
        noise = (jax.random.uniform(k_noise, (r, scfg.max_samples))
                 - 0.5) + 1.0
        perms = np.stack([np.asarray(jax.random.permutation(k, r)) for k in
                          jax.random.split(k_s3im,
                                           mcfg.s3im_repeat_time - 1)])
        # the step's gradient of each block, from Adam's first moment
        mu = np.asarray(ob[0].mu) / 0.1
        out.append({"before": prev, "after": np.asarray(bf), "grad": mu,
                    "losses": np.asarray(losses), "errs": np.asarray(errs)})
        draws.append({"batch": batch, "noise": np.array(noise),
                      "perms": perms})
    port["phases"] = draws
    return out, port, np.asarray(frozen.global_feat)


def _port_pb_run(tmp, port, generator_draws=False):
    if generator_draws:
        port = {**port, "phases": [{"batch": d["batch"]}
                                   for d in port["phases"]]}
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(port, tmp / "case.pt")
    tdw.run_ranks(tdw.block_steps, 4, str(tmp / "case.pt"), str(tmp))
    return tdw.load_results(tmp, 4)


def _check_pb_against_jax(jax_out, ranks, global_feat, n_blocks):
    bps = n_blocks // 2
    r = PB_RAYS // 4
    for phase, want in enumerate(jax_out):
        active = [g * bps + phase % bps for g in range(2)]
        moved_jax = [b for b in range(n_blocks)
                     if not np.array_equal(want["after"][b],
                                           want["before"][b])]
        assert moved_jax == active, (phase, moved_jax)
        synced = [rk["records"][phase]["synced"] for rk in ranks]
        for s in synced[1:]:   # every rank holds every table bit for bit
            assert torch.equal(s, synced[0])
        got = synced[0].numpy()
        before = ranks[0]["records"][phase]["before"].numpy()
        for b in range(n_blocks):
            if b not in active:   # bit-unchanged by the phase
                np.testing.assert_array_equal(got[b], before[b])
                continue
            g = want["grad"][b]
            scale = float(np.abs(g).max())
            assert scale > 0
            sure = np.abs(g) > 2 * TABLE_TOL * scale
            assert sure.sum() > 10
            np.testing.assert_allclose(got[b][sure], want["after"][b][sure],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"phase {phase} block {b}")
            assert not np.array_equal(got[b], want["before"][b])
        for rk in ranks:
            d, g = rk["coords"]
            rec = rk["records"][phase]
            np.testing.assert_allclose(rec["loss"], want["losses"][g],
                                       rtol=1e-5)
            lo = g * 2 * r + d * r
            np.testing.assert_allclose(rec["err"].numpy(),
                                       want["errs"][lo:lo + r], rtol=1e-5,
                                       atol=1e-5)
            assert rec["count"] == 1
            # a group's data ranks bit-identical after their update
            mate = [o for o in ranks if o["coords"] == (1 - d, g)][0]
            assert torch.equal(rec["local"][active[g]],
                               mate["records"][phase]["local"][active[g]])
    for rk in ranks:
        np.testing.assert_array_equal(rk["global_feat"].numpy(), global_feat)


@pytest.mark.parametrize("n_blocks,phases", [(2, 1), (10, 5)])
def test_parallel_block_step_matches_jax(tmp_path, n_blocks, phases):
    """4 ranks (data 2 x block 2) against ``make_parallel_block_step`` on a
    (2, 2) mesh: at 2 blocks one phase (B = 1); at 10 blocks the whole
    rotation, phase p training blocks {p, p + 5} (B = 5)."""
    jax_out, port, global_feat = _jax_pb_run(n_blocks, phases)
    ranks = _port_pb_run(tmp_path, port)
    _check_pb_against_jax(jax_out, ranks, global_feat, n_blocks)


def test_shards_draw_the_same_noise_as_in_jax(tmp_path):
    """Every shard of the JAX step splits one replicated key, so two data
    shards given the same rays render the same errors; the port's ranks
    draw from one seed and do the same (no draws injected)."""
    def twin_shards(batch):   # data shard 1 of each group = shard 0
        out = {}
        for k, v in batch.items():
            v = v.reshape(2, 2, PB_RAYS // 4, *v.shape[1:])
            out[k] = np.stack([v[:, 0], v[:, 0]], 1).reshape(
                PB_RAYS, *v.shape[3:])
        return out

    jax_out, port, _ = _jax_pb_run(2, 1, batch_fn=twin_shards)
    errs = jax_out[0]["errs"].reshape(2, 2, -1)
    np.testing.assert_array_equal(errs[:, 0], errs[:, 1])
    ranks = _port_pb_run(tmp_path, port, generator_draws=True)
    by = {rk["coords"]: rk["records"][0]["err"] for rk in ranks}
    for g in range(2):
        assert torch.equal(by[(0, g)], by[(1, g)])
        assert not torch.equal(by[(0, g)], by[(0, 1 - g)])


def test_parallel_step_ignores_loss_switches_as_in_jax(tmp_path):
    """The concurrent step is Charbonnier + S3IM with the block Adam
    whatever ``use_ch_loss``, the empty-space and trust terms say, in
    both packages: their runs with the switches set equal those without,
    bit for bit."""
    over = dict(use_ch_loss=False, empty_space_penalty_mult=1.0,
                finetune_trust_mult=1.0)
    plain, port_plain, _ = _jax_pb_run(2, 1)
    switched, port_switched, _ = _jax_pb_run(2, 1, model_over=over)
    np.testing.assert_array_equal(plain[0]["after"], switched[0]["after"])
    np.testing.assert_array_equal(plain[0]["losses"], switched[0]["losses"])
    a = _port_pb_run(tmp_path / "plain", port_plain)
    b = _port_pb_run(tmp_path / "switched", port_switched)
    assert port_switched["model"]["use_ch_loss"] is False
    for x, y in zip(a, b):
        assert torch.equal(x["records"][0]["synced"],
                           y["records"][0]["synced"])
        assert x["records"][0]["loss"] == y["records"][0]["loss"]


# ------------------------------------------------------------ the Trainer ----

TINY = ["pipeline.datamanager.train_num_rays_per_batch=128",
        "pipeline.model.s3im_patch_height=8", "steps_per_eval_batch=1000",
        "--parallel-blocks"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("scene")
    make_synthetic_npz(path, n_train=12, n_val=2, img_wh=(32, 24))
    return path


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory, scene):
    """gf-nerf-tiny over 4 ranks with ``parallel_blocks``: 10 init steps
    (data-parallel), the transition, 4 concurrent focal steps on a (2, 2)
    grid (tests/test_parallel.py:41-84)."""
    out = tmp_path_factory.mktemp("trainer")
    tdw.run_ranks(tdw.trainer_run, 4, str(scene), str(out),
                  ["--max-num-iterations", "14", *TINY])
    return tdw.load_results(out, 4)


def test_trainer_parallel_blocks_crosses_transition(trainer_run):
    rank0 = trainer_run[0]
    assert rank0["n_block_axis"] == 2
    start, end = rank0["start_blocks"], rank0["end"]["block_feats"]
    for b in range(2):   # both residual tables trained, concurrently
        assert not torch.equal(end[b], start[b]), b
    for step in range(11, 14):
        m = rank0["metrics"][step]
        assert {"block_0_loss", "block_1_loss"} <= set(m)
        assert np.isfinite(m["loss"])
        np.testing.assert_allclose(
            m["loss"], np.float32(np.mean(np.float32(
                [m["block_0_loss"], m["block_1_loss"]]))), rtol=1e-6)
    # all but the block tables frozen through the focal stage
    assert len({rank0["digests"][s]["frozen"] for s in range(9, 14)}) == 1
    assert torch.isfinite(end).all()


def test_trainer_ranks_bit_identical_every_step(trainer_run):
    """After every step the digest of the parameters but the block
    tables, the octree statistics and the error maps agrees on every rank,
    and so do the metrics and the run's directory; each block table agrees
    on its group's data ranks (ranks 0 and 2, 1 and 3), and on every rank
    after the last sync."""
    ranks = trainer_run
    assert sorted(ranks[0]["digests"]) == list(range(14))
    for step in range(14):
        digests = [rk["digests"][step] for rk in ranks]
        assert len({d["shared"] for d in digests}) == 1, step
        for mates in ((0, 2), (1, 3)):
            assert len({tuple(digests[k]["blocks"]) for k in mates}) == 1
        if step < 11:   # before the concurrent steps: every table
            assert len({tuple(d["blocks"]) for d in digests}) == 1, step
    for other in ranks[1:]:
        assert other["metrics"] == ranks[0]["metrics"]
        assert other["base_dir"] == ranks[0]["base_dir"]
        for k, v in ranks[0]["end"].items():
            assert torch.equal(v, other["end"][k]), k


def test_no_collective_at_step_boundaries_without_viewer(trainer_run):
    """Without ``--vis viewer`` a step boundary runs no collective and no
    control broadcast on any rank (with it, one broadcast a boundary:
    tests/test_torch_viewer_ranks.py)."""
    for rk in trainer_run:
        assert len(rk["boundaries"]) == 14
        assert rk["boundaries"] == [
            {"collectives": 0, "agrees": 0, "syncs": 0}] * 14


def test_rank0_checkpoint_loads_into_one_process_pipeline(trainer_run,
                                                          scene):
    """Rank 0 alone wrote the config and the checkpoint, in the one-card
    format: a one-process pipeline (``eval_setup``) loads it and holds
    rank 0's parameters, and renders an eval image."""
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup

    base = Path(trainer_run[0]["base_dir"])
    assert sorted(p.name for p in (base / "nerfstudio_models").iterdir()) \
        == ["step-000000013"]
    _, trainer = eval_setup(base / "config.json")
    pipeline = trainer.pipeline
    assert trainer._start_step == 14 and pipeline.comm is None
    for k, v in pipeline.field.state_dict().items():
        assert torch.equal(v, trainer_run[0]["end"][k]), k
    metrics, _ = pipeline.get_eval_image_metrics_and_images(13)
    assert np.isfinite(metrics["psnr"])
    # and resumes training on one process: two sequential focal steps
    losses = [pipeline.get_train_loss_dict(step)["loss"]
              for step in (14, 15)]
    assert np.all(np.isfinite(losses))
    # each rank kept its own copy of the error maps; rank 0's is the run's
    maps = sorted(p.name for p in base.glob("sample_tmp*"))
    assert maps == ["sample_tmp", "sample_tmp_rank1", "sample_tmp_rank2",
                    "sample_tmp_rank3"]


def test_checkpoint_keeps_no_block_optimizer_as_in_jax(trainer_run,
                                                       tmp_path):
    """Neither package's checkpoint holds the concurrent step's block
    Adam, so a resume starts it fresh: the port's ``state.pt`` holds the
    field, the sequential optimizer, the step and the generator; the JAX
    package's state tree its params, opt_state, step and statics."""
    import types

    import jax.numpy as jnp
    from gfnerf_tpu.pipelines.pipeline import GFNerfPipeline as JaxPipeline
    from torch_parity import tiny_tree

    base = Path(trainer_run[0]["base_dir"])
    saved = torch.load(base / "nerfstudio_models" / "step-000000013" /
                       "state.pt", weights_only=True)
    assert set(saved) == {"field", "opt_state", "step", "generator"}
    tree = tiny_tree()
    from gfnerf_tpu.sampler.perssampler import octree_to_device

    stub = types.SimpleNamespace(
        state=types.SimpleNamespace(params={"t": jnp.zeros(2)},
                                    opt_state={"m": jnp.zeros(2)},
                                    step=jnp.asarray(3)),
        statics={"s": jnp.zeros(1)}, _opt_blocks={"mu": jnp.ones(2)},
        sample_tmp_dir=None,
        sampler=types.SimpleNamespace(
            tree=tree, oct_dev=octree_to_device(tree, 4096),
            milestones=[], cameras_labels=None))
    JaxPipeline.save_checkpoint_state(stub, tmp_path, 3)
    import orbax.checkpoint as ocp

    restored = ocp.PyTreeCheckpointer().restore(
        (tmp_path / "state").absolute())
    assert set(restored) == {"params", "opt_state", "step", "statics"}


ROTATION = [f"pipeline.{part}.{key}={value}"
            for part in ("model", "datamanager", "optimizers")
            for key, value in (("steps_perssampler_init", 6),
                               ("steps_per_split_dataset", 2),
                               ("n_split_dataset", 10))] + [
    "pipeline.model.n_blocks=10", "pipeline.sampler.sub_div_milestones=3",
    "pipeline.sampler.compact_freq=1000000000",
    "pipeline.sampler.ray_march_fineness_decay_end_iter=6",
    "--max-num-iterations", "16"]


def test_trainer_rotation_through_ten_blocks_unlike_jax(tmp_path):
    """10 blocks on 2 block groups (B = 5) through the Trainer: phase p
    trains blocks {p, p + 5}, and the 5 phases train all 10.  The JAX
    pipeline stops at the first rotation: its ``after_train_iteration``
    activates the splits of the step just trained, and the next phase's
    batch draws from splits that are not active (KeyError, shown here on
    its datamanager); the port activates each step's splits before
    drawing."""
    from gfnerf_tpu.data.datamanager import (GFNerfDataManager,
                                             GFNerfDataManagerConfig)
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz
    from torch_parity import jax_minimal_parser

    scene = make_synthetic_npz(tmp_path / "scene", n_train=20, n_val=2,
                               img_wh=(32, 24))
    dm = GFNerfDataManager(GFNerfDataManagerConfig(
        train_num_rays_per_batch=64), jax_minimal_parser(scene))
    labels = np.repeat(np.arange(10), 2)
    dm.setup_train_splits_parallel(labels, [0, 5], None, 64)
    with pytest.raises(KeyError):
        dm.next_train_parallel(8, [1, 6])

    tdw.run_ranks(tdw.trainer_run, 4, str(scene), str(tmp_path),
                  [*TINY, *ROTATION])
    ranks = tdw.load_results(tmp_path, 4)
    rank0 = ranks[0]
    assert rank0["n_block_axis"] == 2
    for step in range(7, 16):   # phases 0-4: steps 7, 8-9, ..., 14-15
        p = (step - 6) // 2
        assert {f"block_{p}_loss", f"block_{p + 5}_loss"} <= \
            set(rank0["metrics"][step]), step
    start, end = rank0["start_blocks"], rank0["end"]["block_feats"]
    assert all(not torch.equal(end[b], start[b]) for b in range(10))
    for step in range(16):
        digests = [rk["digests"][step] for rk in ranks]
        assert len({d["shared"] for d in digests}) == 1, step
        for mates in ((0, 2), (1, 3)):
            assert len({tuple(digests[k]["blocks"]) for k in mates}) == 1
    # synced at the first step of each phase (before it trains: the last
    # step trained is the previous phase's) and before the checkpoint
    syncs = [rk["syncs"] for rk in ranks]
    assert [s for s, _ in syncs[0]] == [6, 7, 9, 11, 13, 15]
    for other in syncs[1:]:
        assert other == syncs[0]
    changed = [[b for b in range(10) if before[b] != after[b]]
               for (_, before), (_, after) in zip(syncs[0], syncs[0][1:])]
    assert changed == [[0, 5], [1, 6], [2, 7], [3, 8], [4, 9]], changed
    for other in ranks[1:]:
        for k, v in rank0["end"].items():
            assert torch.equal(v, other["end"][k]), k


# ---------------------------------------------------------- the launch ----


def test_train_launch_flags_two_machines(scene, tmp_path):
    """``python -m gfnerf_tpu_torch.train --device cpu`` as two "machines"
    (``--num-machines 2 --machine-rank i --dist-url``): gloo is chosen and
    printed, both ranks end with equal parameters, and only rank 0
    writes."""
    import os

    port = tdw.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gfnerf_tpu_torch.train", "gf-nerf-tiny",
         "--data", str(scene), "--device", "cpu", "--max-num-iterations",
         "4", "--output-dir", str(tmp_path / f"out{i}"),
         "--experiment-name", "launch", "--num-machines", "2",
         "--machine-rank", str(i), "--dist-url", f"tcp://127.0.0.1:{port}",
         "--dist-timeout", "60", *TINY[:2]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    digests = []
    for i, out in enumerate(outs):
        assert f"rank {i} of 2, backend gloo, device cpu" in out
        line = [x for x in out.splitlines()
                if x.startswith(f"train: rank {i} parameters ")]
        digests.append(line[0].split()[-1])
    assert digests[0] == digests[1]
    assert "training complete" in outs[0]
    assert "training complete" not in outs[1]
    assert not [f for f in (tmp_path / "out1").rglob("*") if f.is_file()]
    assert len(list((tmp_path / "out0").rglob("config.json"))) == 1
    assert len(list((tmp_path / "out0").rglob("state.pt"))) == 1


def test_failed_group_raises(tmp_path):
    """No fallback: a rank whose group never forms raises within its
    timeout; NCCL without a card per rank raises; so does NCCL on the
    CPU through the launch flags."""
    from gfnerf_tpu_torch.train import build_trainer

    code = ("import sys; from gfnerf_tpu_torch.parallel import comm\n"
            "try:\n"
            "    comm.initialize_multihost(sys.argv[1], 2, 1, 'gloo', timeout_s=3)\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__); sys.exit(3)\n"
            "try:\n"
            "    comm.initialize_multihost(sys.argv[1], 2, 1, 'nccl', timeout_s=3)\n"
            "except RuntimeError as e:\n"
            "    print('nccl raised', e)\n")
    out = subprocess.run(
        [sys.executable, "-c", code, f"tcp://127.0.0.1:{tdw.free_port()}"],
        cwd=REPO, capture_output=True, text=True, timeout=90)
    assert out.returncode == 3 and "raised" in out.stdout, out
    out = subprocess.run(
        [sys.executable, "-c", code.split("try:")[0] + "try:" +
         code.split("try:")[2], "tcp://127.0.0.1:1"],
        cwd=REPO, capture_output=True, text=True, timeout=90)
    assert "nccl raised NCCL needs a card per rank" in out.stdout, out
    with pytest.raises(ValueError, match="nccl"):
        build_trainer(["gf-nerf-tiny", "--data", str(tmp_path), "--device",
                       "cpu", "--num-machines", "2", "--dist-url",
                       "tcp://127.0.0.1:1", "--dist-backend", "nccl"])
