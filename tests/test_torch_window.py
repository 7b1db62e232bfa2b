"""K steps a dispatch in the port (``steps_per_dispatch``;
``gfnerf_tpu_torch.models.gfnerf.make_multi_train_step`` and the
pipeline's window) on the CPU, against the JAX package's, and the
optimizer state a window needs (device tensors, no host wait).

- ``_k_window_ok`` equals the JAX pipeline's at every (step, K) of
  ``gf-nerf-tiny``'s 30-step schedule, K in {2, 4, 8}, with the milestones
  that remain at each step (a milestone leaves at the single step that
  reaches it, and no window holds one).
- A window of 4 init-stage steps equals 4 single steps of the port from
  the same draws, bit for bit: the metrics, the error vectors, every
  parameter, Adam's state and the octree's statistics.  So does a window
  of ``make_multi_train_step`` at ``remat_chunks`` 2 (the field
  recomputed in the backward), which reads and moves no random state.
- The optimizer: a step with a non-finite gradient changes no parameter,
  moment or count and counts itself; the learning-rate tables equal
  ``schedules[name](c)`` at every count c and the bias corrections the
  host's ``1 - f32(b) ** (c + 1)``, bit for bit; a checkpoint written
  with the host numbers of the earlier layout loads and trains on.
- The Trainer over ``gf-nerf-tiny``'s 30 steps at K = 4 against the JAX
  pipeline at K = 4 (``tests/torch_pipeline_ref.py ... k=4``, its own
  process, its draws from the window's key chain handed to the port):
  every step's batch indices exactly (the focal batches' error-guided
  rays read maps up to 3 steps stale in both), the counts of steps in
  windows and single steps equal JAX's (20 and 10), no buffered metric
  left and the state at step 30; the losses to 1e-4 relative, as the
  pipeline parity test (``tests/test_torch_pipeline.py``) holds them.
  Over 30 steps, two splits trained, Adam's sign flips on near-zero
  gradients add up further than over that test's 16: the split's error
  maps are held to 2e-4 relative with an atol of 1e-5 (that test's
  packed-layout tolerance; measured 2.13e-4 at one entry of 4608,
  1.19e-4 at K = 1), the parameters to that test's shares (at most 10%
  of a tensor's entries apart by more than 1e-4, none by more than
  2e-2) but the block tables, which both splits train at lr 5e-3, to at
  most 15% and 3e-2 (the proposal pipeline test's bound: three steps of
  the largest learning rate; measured 11.0% and 0.0212, at K = 1 8.1%
  and 0.0199).  The same at ``remat_chunks`` 2 in both packages, at the
  same tolerances.
"""

from __future__ import annotations

import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)

RAYS = 128
PATCH_H = 8
STEPS = 30   # gf-nerf-tiny's schedule: 10 init steps, 2 splits of 10
K = 4
REMAT = 2    # remat_chunks of the remat runs
INIT_STEPS = 10   # gf-nerf-tiny's init stage


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("scene")
    make_synthetic_npz(path, n_train=12, n_val=2, img_wh=(32, 24))
    return path


def tiny_config(scene, out_dir, k=1):
    from gfnerf_tpu_torch.configs.method_configs import gf_nerf_tiny_config

    cfg = gf_nerf_tiny_config()
    cfg.output_dir = out_dir
    cfg.data = scene
    cfg.device = "cpu"
    cfg.vis = "local"
    cfg.pipeline.datamanager.train_num_rays_per_batch = RAYS
    cfg.pipeline.model.s3im_patch_height = PATCH_H
    cfg.pipeline.steps_per_dispatch = k
    return cfg


def parser_of(scene):
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)

    return MinimalDataParser(MinimalDataParserConfig(data=scene))


# ---- the window rule ----


@pytest.fixture(scope="module")
def rule_pair(scene, tmp_path_factory):
    """The port's and the JAX package's gf-nerf-tiny pipelines on the same
    scene, neither trained, each told the run's length."""
    from gfnerf_tpu.configs.method_configs import gf_nerf_tiny_config
    from torch_parity import jax_minimal_parser

    jcfg = gf_nerf_tiny_config()
    jcfg.pipeline.datamanager.train_num_rays_per_batch = RAYS
    jp = jcfg.pipeline.build(jax_minimal_parser(scene),
                             tmp_path_factory.mktemp("rule_jax"))
    out = tmp_path_factory.mktemp("rule_port")
    tp = tiny_config(scene, out).pipeline.build(parser_of(scene), out,
                                                device="cpu")
    jp.total_train_steps = STEPS
    tp.reserve_steps(STEPS)
    assert list(jp.sampler.milestones) == list(tp.sampler.milestones) \
        == [4, 8]
    return jp, tp


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("step", range(STEPS))
def test_k_window_ok_matches_jax(rule_pair, step, k):
    jp, tp = rule_pair
    left = [m for m in (4, 8) if m >= step]
    jp.sampler.milestones = list(left)
    tp.sampler.milestones = list(left)
    assert tp._k_window_ok(step, k) == jp._k_window_ok(step, k)


# ---- a window against single steps ----


def _draws(step, r, s):
    """Deterministic draws of a step: march noise, S3IM permutations."""
    rng = np.random.default_rng(1000 + step)
    return (rng.uniform(0.5, 1.5, (r, s)).astype(np.float32),
            np.stack([rng.permutation(r) for _ in range(9)]))


def _state_tensors(p) -> dict:
    out = {f"field.{k}": v.detach().clone()
           for k, v in p.field.state_dict().items()}
    opt = p.state.opt_state
    for part in ("mu", "nu"):
        for name, xs in getattr(opt, part).items():
            for i, x in enumerate(xs):
                if x is not None:
                    out[f"{part}.{name}[{i}]"] = x.clone()
    for name in ("count", "total_notfinite", "last_finite"):
        out[name] = torch.as_tensor(getattr(opt, name)).clone()
    for name in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        out[f"oct.{name}"] = getattr(p.sampler.oct_dev, name).clone()
    return out


def test_window_equals_single_steps(scene, tmp_path):
    """Steps 0-3 of gf-nerf-tiny (the init stage, before the milestone at
    4) as one window of the pipeline and as 4 single steps, from the same
    draws: bit for bit."""
    runs = {}
    for k in (K, 1):
        out = tmp_path / f"k{k}"
        p = tiny_config(scene, out, k).pipeline.build(
            parser_of(scene), out, device="cpu", draws=_draws)
        p.reserve_steps(STEPS)
        metrics = [p.get_train_loss_dict(step) for step in range(K)]
        assert p.state.step == K and not p._pending_metrics
        assert (p._k_steps_scanned, p._k_steps_fallback) == (
            (K, 0) if k == K else (0, 0))
        runs[k] = (metrics, _state_tensors(p))
    (mw, sw), (ms, ss) = runs[K], runs[1]
    assert mw == ms
    assert sorted(sw) == sorted(ss)
    for name in sw:
        assert torch.equal(sw[name], ss[name]), name


def test_multi_train_step_errors_equal_single_steps():
    """``make_multi_train_step`` itself on a field and octree of the
    parity helpers: the (K,) metrics and (K, R) errors of a window equal
    K calls of the single step, bit for bit; so does a window at
    ``remat_chunks`` 2 against single steps at 2 (the window runs its steps
    eagerly on the CPU), and against the straight window it holds
    tests/test_remat.py's tolerances: the metrics and errors rtol 1e-5,
    atol 1e-6, the parameters (after three Adam steps from gradients
    within rtol 2e-4 of each other) within one step of the largest
    learning rate (1e-2) of each other for each of the three steps."""
    from gfnerf_tpu_torch.cameras.cameras import Cameras
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer)
    from gfnerf_tpu_torch.fields.field import STAGE_INIT
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                init_train_state,
                                                make_multi_train_step,
                                                make_train_step)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig
    from torch_parity import IMG_WH
    from torch_parity import TRAIN_R as R
    from torch_parity import TRAIN_S as S
    from torch_parity import TRAIN_SAMPLE_L as SAMPLE_L
    from torch_parity import field_pair, octree_pair
    from torch_parity import train_batch as _batch
    from torch_parity import train_cameras_np as _cameras_np

    _, _, _, field = field_pair(mlp_dtype="float32")
    _, toct = octree_pair()
    cams = Cameras.from_numpy(*_cameras_np(), *IMG_WH, device="cpu")
    mcfg = GFNeRFModelConfig(scale_factor=1.0, samples_budget_per_ray=S)
    scfg = SamplerConfig(max_samples=S, sample_l=SAMPLE_L)
    tx = build_optimizer(OptimizersConfig())
    batches = [_batch(seed=s) for s in range(3)]
    rng = np.random.default_rng(5)
    noise = rng.uniform(0.5, 1.5, (3, R, S)).astype(np.float32)
    perms = np.stack([np.stack([rng.permutation(R) for _ in range(9)])
                      for _ in range(3)])
    fine = [1.0, 0.75, 0.5]

    def tensors(b):
        out = {k: torch.as_tensor(v) for k, v in b.items()}
        for key in ("camera_indices", "rel_camera_indices"):
            out[key] = out[key].long()
        return out

    stacked = {k: torch.stack([tensors(b)[k] for b in batches])
               for k in tensors(batches[0])}

    def singles_and_window(cfg):
        """(single steps' (metrics, errors), their octree, their field,
        the window's (state, octree, metrics, errors), its field)."""
        one_field, win_field = copy.deepcopy(field), copy.deepcopy(field)
        step = make_train_step(cfg, scfg, tx, STAGE_INIT)
        state, oct_dev = init_train_state(one_field, tx), copy.deepcopy(toct)
        singles = []
        for i, b in enumerate(batches):
            state, oct_dev, m, err = step(
                state, oct_dev, cams, tensors(b), fine[i],
                noise=torch.as_tensor(noise[i]),
                s3im_perms=torch.as_tensor(perms[i]).long())
            singles.append((m, err))
        multi = make_multi_train_step(cfg, scfg, tx, STAGE_INIT, 3)
        window = multi(
            init_train_state(win_field, tx), copy.deepcopy(toct), cams,
            stacked, torch.tensor(fine), draws={
                "noise": torch.as_tensor(noise),
                "s3im_perms": torch.as_tensor(perms).long()})
        return singles, oct_dev, one_field, window, win_field

    runs = {}
    for chunks in (0, 2):
        singles, oct_dev, one_field, window, win_field = \
            singles_and_window(dataclasses.replace(mcfg,
                                                   remat_chunks=chunks))
        wstate, woct, wm, werrs = window
        assert wstate.step == 3
        for i, (m, err) in enumerate(singles):
            assert torch.equal(werrs[i], err)
            for k, v in m.items():
                assert torch.equal(wm[k][i], v), (chunks, i, k)
        for a, b in zip(win_field.parameters(), one_field.parameters()):
            assert torch.equal(a, b), chunks
        for k in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
            assert torch.equal(getattr(woct, k), getattr(oct_dev, k)), k
        runs[chunks] = (wm, werrs, win_field)
    (m0, e0, f0), (m2, e2, f2) = runs[0], runs[2]
    for k, v in m0.items():
        np.testing.assert_allclose(m2[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(e2.numpy(), e0.numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(f2.parameters(), f0.parameters()):
        assert float((a - b).detach().abs().max()) <= 3 * 1e-2


def test_remat_field_moves_no_random_state(monkeypatch):
    """One train step at ``remat_chunks`` 2 from injected draws: its
    forward and backward run the field through ``torch.utils.checkpoint``
    (counted) and neither read nor set the random state (what a CUDA
    graph's capture refuses), and the generator's state is the same
    after as before."""
    from gfnerf_tpu_torch.cameras.cameras import Cameras
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer)
    from gfnerf_tpu_torch.fields.field import STAGE_INIT
    from gfnerf_tpu_torch.models import gfnerf as M
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig
    from torch_parity import IMG_WH
    from torch_parity import TRAIN_R as R
    from torch_parity import TRAIN_S as S
    from torch_parity import TRAIN_SAMPLE_L as SAMPLE_L
    from torch_parity import field_pair, octree_pair
    from torch_parity import train_batch as _batch
    from torch_parity import train_cameras_np as _cameras_np

    _, _, _, field = field_pair(mlp_dtype="float32")
    _, toct = octree_pair()
    cams = Cameras.from_numpy(*_cameras_np(), *IMG_WH, device="cpu")
    mcfg = M.GFNeRFModelConfig(scale_factor=1.0, samples_budget_per_ray=S,
                               remat_chunks=2)
    scfg = SamplerConfig(max_samples=S, sample_l=SAMPLE_L)
    tx = build_optimizer(OptimizersConfig())
    rng = np.random.default_rng(6)
    batch = {k: torch.as_tensor(v) for k, v in _batch(seed=0).items()}
    for key in ("camera_indices", "rel_camera_indices"):
        batch[key] = batch[key].long()
    noise = torch.as_tensor(rng.uniform(0.5, 1.5, (R, S)).astype(np.float32))
    perms = torch.as_tensor(np.stack([rng.permutation(R)
                                      for _ in range(9)])).long()
    calls = []
    checkpoint = M.checkpoint

    def counted(*args, **kw):
        calls.append(kw)
        return checkpoint(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("the random state was read or set")

    monkeypatch.setattr(M, "checkpoint", counted)
    step = M.make_train_step(mcfg, scfg, tx, STAGE_INIT)
    before = torch.get_rng_state().clone()
    with monkeypatch.context() as m:
        for name in ("get_rng_state", "set_rng_state"):
            m.setattr(torch, name, refused)
            m.setattr(torch.random, name, refused)
        _, _, metrics, _ = step(M.init_train_state(field, tx), toct, cams,
                                batch, 1.0, noise=noise, s3im_perms=perms)
    assert len(calls) == 2
    assert all(not kw["preserve_rng_state"] for kw in calls)
    assert np.isfinite(float(metrics["loss"]))
    assert any(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in field.parameters())
    assert torch.equal(torch.get_rng_state(), before)


# ---- the optimizer a window needs ----


def test_non_finite_update_changes_nothing_and_counts_itself():
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    PerGroupAdam,
                                                    apply_updates)

    gen = torch.Generator().manual_seed(0)
    params = {"fields": [torch.randn(4, 3, generator=gen),
                         torch.randn(5, generator=gen)],
              "block": [torch.randn(6, generator=gen)]}
    tx = PerGroupAdam(OptimizersConfig(steps_perssampler_init=5,
                                       steps_per_split_dataset=3,
                                       n_split_dataset=2))
    state = tx.init(params)
    for _ in range(2):   # moments allocated, count 2
        grads = {k: [torch.randn(p.shape, generator=gen) for p in ps]
                 for k, ps in params.items()}
        upd, state = tx.update(grads, state, params)
        apply_updates(params, upd)
    before = {k: [p.clone() for p in ps] for k, ps in params.items()}
    moments = [x.clone() for part in (state.mu, state.nu)
               for xs in part.values() for x in xs]
    grads = {k: [torch.randn(p.shape, generator=gen) for p in ps]
             for k, ps in params.items()}
    grads["block"][0][2] = float("inf")
    upd, new = tx.update(grads, state, params)
    apply_updates(params, upd)
    for k, ps in params.items():
        for a, b in zip(ps, before[k]):
            assert torch.equal(a, b), k
    for a, b in zip([x for part in (new.mu, new.nu)
                     for xs in part.values() for x in xs], moments):
        assert torch.equal(a, b)
    assert all(not bool(u.any()) for us in upd.values() for u in us)
    assert isinstance(new.count, torch.Tensor)
    assert int(new.count) == 2 and int(new.total_notfinite) == 1
    assert not bool(new.last_finite)
    # the next finite step applies and counts on
    grads["block"][0][2] = 0.0
    upd, new = tx.update(grads, new, params)
    assert int(new.count) == 3 and bool(new.last_finite)
    assert int(new.total_notfinite) == 1


@pytest.mark.parametrize("cfg_kw", [
    dict(steps_perssampler_init=10, steps_per_split_dataset=10,
         n_split_dataset=2),
    dict(steps_perssampler_init=400, steps_per_split_dataset=150,
         n_split_dataset=3, n_dataset_circles=2),
])
def test_learning_rate_tables_equal_the_schedules(cfg_kw):
    from gfnerf_tpu_torch.engine.optimizers import (GROUPS,
                                                    OptimizersConfig,
                                                    PerGroupAdam)

    tx = PerGroupAdam(OptimizersConfig(**cfg_kw))
    tx.reserve(tx.max_count + 50)   # past the schedule's end too
    for name in GROUPS:
        table = tx.table(name, "cpu")
        want = torch.stack([torch.as_tensor(tx.schedules[name](c),
                                            dtype=torch.float32)
                            for c in range(tx.max_count + 1)])
        assert torch.equal(table, want), name
    for what, b in (("bc1", tx.cfg.adam_b1), ("bc2", tx.cfg.adam_b2)):
        b32 = torch.tensor(b, dtype=torch.float32)
        want = torch.tensor([float(1.0 - b32 ** (c + 1))
                             for c in range(tx.max_count + 1)],
                            dtype=torch.float32)
        assert torch.equal(tx.table(what, "cpu"), want), what


def test_host_count_checkpoint_loads(scene, tmp_path):
    """A checkpoint whose optimizer count, skip count and last flag are
    host numbers (the earlier layout) loads; the next step counts on from it
    and trains."""
    from gfnerf_tpu_torch.pipelines.pipeline import _opt_state_dict

    out = tmp_path / "a"
    p = tiny_config(scene, out).pipeline.build(parser_of(scene), out,
                                               device="cpu", draws=_draws)
    for step in range(3):
        p.get_train_loss_dict(step)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    p.save_checkpoint_state(ckpt, 2)
    saved = torch.load(ckpt / "state.pt", weights_only=True)
    assert isinstance(saved["opt_state"]["count"], torch.Tensor)
    old = dataclasses.replace(p.state.opt_state,
                              count=int(p.state.opt_state.count),
                              total_notfinite=0, last_finite=True)
    saved["opt_state"] = _opt_state_dict(old)
    torch.save(saved, ckpt / "state.pt")

    out2 = tmp_path / "b"
    p2 = tiny_config(scene, out2).pipeline.build(
        parser_of(scene), out2, device="cpu", checkpoint=ckpt, draws=_draws)
    assert p2.load_checkpoint_state(ckpt) == 2
    assert p2.state.opt_state.count == 3
    # the next step from the same batch: the host sampler's state is not
    # in a checkpoint
    p2.datamanager = copy.deepcopy(p.datamanager)
    m = p2.get_train_loss_dict(3)
    assert np.isfinite(m["loss"])
    assert int(p2.state.opt_state.count) == 4
    m_ref = p.get_train_loss_dict(3)
    assert m == m_ref
    for a, b in zip(p.field.parameters(), p2.field.parameters()):
        assert torch.equal(a, b)


# ---- the Trainer at K = 4 against the JAX pipeline at K = 4 ----


def _jax_ref(scene, out, *extra):
    script = Path(__file__).with_name("torch_pipeline_ref.py")
    proc = subprocess.run(
        [sys.executable, str(script), str(scene), str(out), str(STEPS),
         str(RAYS), str(PATCH_H), "anchored", f"k={K}", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=900)
    assert proc.returncode == 0, proc.stdout.decode()[-4000:]
    return dict(np.load(out / "ref.npz"))


@pytest.fixture(scope="module")
def jax_ref_k(scene, tmp_path_factory):
    return _jax_ref(scene, tmp_path_factory.mktemp("jax_ref_k4"))


@pytest.fixture(scope="module")
def jax_ref_k_remat(scene, tmp_path_factory):
    return _jax_ref(scene, tmp_path_factory.mktemp("jax_ref_k4_remat"),
                    f"remat={REMAT}")


def test_trainer_k4_matches_jax_k4(scene, jax_ref_k, tmp_path):
    _check_run(_trainer_run(scene, jax_ref_k, tiny_config(
        scene, tmp_path / "outputs", K)), jax_ref_k)


def test_trainer_k4_remat_matches_jax_k4_remat(scene, jax_ref_k,
                                               jax_ref_k_remat, tmp_path):
    """The same at ``remat_chunks`` REMAT in both packages (the port's
    windows recompute the field in the backward as the JAX package's
    ``jax.checkpoint`` inside its scan does), from the same draws.  XLA:CPU
    rounds the JAX package's remat run otherwise than its straight run:
    its error maps move (3.9e-5 at most), and from step 17 on 34 of the
    focal batches' error-guided rays are drawn otherwise, which moves its
    block tables as far as the port's are from them (15.3% of entries past
    1e-4).  So against the JAX remat run the port's batches and losses are
    held as the straight test holds them up to the step at which that run
    parts from the JAX straight run (a focal step: the init stage's draws
    read no error map); and the port's remat run is held to the JAX
    straight run at every tolerance of ``test_trainer_k4_matches_jax_k4``
    (the port's remat draws the straight run's batches)."""
    ref, straight = jax_ref_k_remat, jax_ref_k
    for key in ("noise", "perms"):
        np.testing.assert_array_equal(ref[key], straight[key])
    cfg = tiny_config(scene, tmp_path / "outputs", K)
    cfg.pipeline.model.remat_chunks = REMAT
    run = _trainer_run(scene, ref, cfg)
    same = (ref["indices"] == straight["indices"]).all(axis=(1, 2))
    first = STEPS if same.all() else int(np.argmin(same))
    assert first > INIT_STEPS, first
    np.testing.assert_array_equal(run["batches"][:first],
                                  ref["indices"][:first])
    np.testing.assert_allclose(run["losses"][:first], ref["losses"][:first],
                               rtol=1e-4)
    _check_run(run, straight)


def _trainer_run(scene, ref, cfg) -> dict:
    """The Trainer over ``cfg`` with ``ref``'s draws: its pipeline, every
    step's batch indices and (loss, rgb_loss, s3im_loss)."""
    from gfnerf_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, parser_of(scene))
    trainer.setup()
    p = trainer.pipeline
    p.draws = lambda step, r, s: (ref["noise"][step], ref["perms"][step])
    batches, losses = [], {}
    next_train, get_loss = p.datamanager.next_train, p.get_train_loss_dict

    def recording_next_train(step):
        batch = next_train(step)
        batches.append(batch["indices"].copy())
        return batch

    def recording_get_loss(step):
        m = get_loss(step)
        losses[step] = [m["loss"], m["rgb_loss"], m["s3im_loss"]]
        return m

    p.datamanager.next_train = recording_next_train
    p.get_train_loss_dict = recording_get_loss
    trainer.train()
    return {"p": p, "batches": np.stack(batches),
            "losses": np.asarray([losses[s] for s in range(STEPS)])}


def _check_run(run, ref) -> None:
    """A Trainer run (``_trainer_run``) against a JAX record at K."""
    p = run["p"]
    assert (p._k_steps_scanned, p._k_steps_fallback) == (
        int(ref["k_scanned"]), int(ref["k_fallback"])) == (20, 10)
    assert p._pending_metrics == {} and int(ref["pending"]) == 0
    assert p.state.step == int(ref["final_step"]) == STEPS
    # every batch, in step order: the focal batches drawn before each
    # window read the same stale error maps in both packages
    np.testing.assert_array_equal(run["batches"], ref["indices"])
    np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-4)
    cache = p.datamanager.split_cache
    np.testing.assert_array_equal(cache.indices, ref["split_cache_indices"])
    np.testing.assert_allclose(cache.error_maps, ref["split_error_maps"],
                               rtol=2e-4, atol=1e-5)
    params, _ = p.field.to_numpy()
    got = {"global_feat": params.global_feat,
           "block_feats": params.block_feats,
           "appearance_embedding": params.appearance_embedding}
    for name in ("base_net", "mlp_head"):
        for part in ("w", "b"):
            for i, x in enumerate(getattr(params, name)[part]):
                got[f"{name}_{part}{i}"] = x
    for k, v in got.items():
        share, most = (0.15, 3e-2) if k == "block_feats" else (0.1, 2e-2)
        diff = np.abs(v - ref[k])
        assert (diff > 1e-4).mean() <= share, (k, (diff > 1e-4).mean())
        assert diff.max() <= most, (k, diff.max())
