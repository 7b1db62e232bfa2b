"""The port's instant-ngp against the JAX package's on the CPU:
``init_instant_ngp_params``, ``occupancy_lookup``, ``update_occupancy``,
``instant_ngp_forward`` and ``instant_ngp_loss`` with every gradient; the
vanilla pipeline with the occupancy updates and ``dynamic_batch`` against
the JAX ``VanillaPipeline``; the checkpoint holding the grid (which the
JAX package's does not); ``dynamic_batch``'s retarget.  On a card
(``cuda``): one loss and backward through H4 and H5 against the plain
pairs.

Sizes: grid 16, 32 samples a ray, 16 levels of 2^10 entries, 32 rays.  The
JAX package's random draws (the stratification, the occupancy jitter) are
handed to the port.  Tolerances, and why:
- the parameters at the start: bit for bit; ``occupancy_lookup`` on
  points at the cells' edges and one ulp either side: exact (XLA turns
  the division by the box's side into a multiply by its f32 reciprocal,
  and the port does the same);
- ``update_occupancy``: 1e-6 relative (measured 2.3e-7: the fine levels'
  ``p * scale + bias``);
- forward and loss: 1e-5 relative; the weights, accumulation and depth
  5e-5 of their largest (measured 1.2e-5), as test_torch_nerfacto holds
  nerfacto's: XLA contracts ``o + t d`` into multiply-adds of its own
  choosing inside the fused step, and one ulp in a position moves an
  interpolation fraction at the fine levels; gradients: the table's 2e-2
  of its largest (ROADMAP.md queue 3's H4/H5 tolerance: the bf16 table
  the forward reads, the bf16 backward payload of ``_hes_bwd``; measured
  8.3e-3), the MLPs' 1e-3 of their largest in eval (measured 2.6e-5) and
  2e-2 in training (measured 9.9e-3, the colour head's first layer): with
  the jitter, 381 of the 3072 position coordinates differ from XLA's by
  one ulp (the port reproduces the edges' multiply-adds, which match
  XLA's exactly, but not the contraction XLA:CPU picks for ``o + t d``
  inside the fused step), and the geometry features the head reads carry
  that ulp times the finest level's scale;
- the pipeline: see test_vanilla_pipeline_matches_jax.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)

R = 32
SMALL = dict(grid_resolution=16, num_samples=32, log2_hashmap_size=10)
MLP_TOL = {"eval": 1e-3, "train": 2e-2}
TABLE_TOL = 2e-2
# the pipeline's steps: the grid is updated before steps 0, 16 and 32
PIPE_STEPS = (0, 1, 2, 16, 17, 32)
PIPE_RAYS = 512
TARGET_SAMPLES = 1 << 12


def rays(seed=0, n=R):
    """Rays from near (0, 0, 3) pointing down into the box, and targets
    (numpy)."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 0.1 + [0, 0, 3]).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tgt = rng.random((n, 3)).astype(np.float32)
    return o, d, tgt


@functools.lru_cache(maxsize=None)
def model_pair(background="white"):
    """(JAX cfg, params, statics, the port's cfg and numpy params, statics,
    model state) of one small model, the table replaced in both by
    uniform(-1, 1) from seed 5 so renders are not near-constant, and a
    grid of uniform(0, 0.02) from seed 6, so the threshold culls about
    half the samples."""
    import jax.numpy as jnp
    from gfnerf_tpu.models import instant_ngp as J
    from gfnerf_tpu_torch.models import instant_ngp as T

    kw = dict(SMALL, background_color=background)
    jcfg, tcfg = J.InstantNGPConfig(**kw), T.InstantNGPConfig(**kw)
    jp, js, _ = J.init_instant_ngp_params(jcfg, 0)
    tp, ts, tm = T.init_instant_ngp_params(tcfg, 0)
    feat = np.random.default_rng(5).uniform(
        -1, 1, tp["feat"].shape).astype(np.float32)
    occ = np.random.default_rng(6).uniform(
        0, 0.02, tm["occ"].shape).astype(np.float32)
    jp = dict(jp, feat=jnp.asarray(feat))
    tp = dict(tp, feat=feat)
    return jcfg, jp, js, tcfg, tp, ts, {"occ": occ}


def port_model(background="white"):
    from gfnerf_tpu_torch.models.instant_ngp import InstantNGPModel

    *_, tcfg, tp, ts, tm = model_pair(background)
    return InstantNGPModel(tcfg, tp, ts, tm, "cpu")


def test_init_params_match_jax():
    """The registered width's parameters, primes, biases and grid equal
    the JAX package's bit for bit; ``params_from_jax`` holds
    them."""
    import jax
    from gfnerf_tpu.models import instant_ngp as J
    from gfnerf_tpu_torch.models import instant_ngp as T

    jout = J.init_instant_ngp_params(J.InstantNGPConfig(), 3)
    tout = T.init_instant_ngp_params(T.InstantNGPConfig(), 3)
    for a, b in zip(jax.tree_util.tree_leaves(jout),
                    jax.tree_util.tree_leaves(tout)):
        assert np.asarray(a).shape == np.asarray(b).shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cfg = T.InstantNGPConfig(**SMALL)
    model = T.params_from_jax(
        *J.init_instant_ngp_params(J.InstantNGPConfig(**SMALL), 3), cfg,
        device="cpu")
    want = T.init_instant_ngp_params(cfg, 3)
    np.testing.assert_array_equal(model.feat.detach().numpy(), want[0]["feat"])
    np.testing.assert_array_equal(model.occ.numpy(), want[2]["occ"])
    assert {n for n, _ in model.named_buffers()} == {"prim", "bias", "occ"}


def test_occupancy_lookup_exact_at_cell_edges():
    """Points on every cell edge of the grid and one f32 ulp either side:
    the same cell as the JAX package's jitted lookup, exactly."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models import instant_ngp as J
    from gfnerf_tpu_torch.models.instant_ngp import occupancy_lookup

    jcfg, *_, tm = model_pair()
    g = jcfg.grid_resolution
    edges = (np.arange(-1, g + 2) / g * 3.0 - 1.5).astype(np.float32)
    pts = np.stack(np.meshgrid(edges, edges, edges, indexing="ij"),
                   -1).reshape(-1, 3)
    pts = np.concatenate([pts, np.nextafter(pts, np.float32(9)),
                          np.nextafter(pts, np.float32(-9))])
    occ = np.random.default_rng(1).random((g, g, g)).astype(np.float32)
    want = np.asarray(jax.jit(lambda ms, p: J.occupancy_lookup(ms, jcfg, p))(
        {"occ": jnp.asarray(occ)}, jnp.asarray(pts)))
    model = port_model()
    model.occ.copy_(torch.from_numpy(occ))
    got = occupancy_lookup(model, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)


def test_update_occupancy_matches_jax():
    """Two EMA updates with JAX's jitter handed over: 1e-6 relative; the
    grid stays above the decayed one and moves off its start."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models import instant_ngp as J
    from gfnerf_tpu_torch.models.instant_ngp import update_occupancy

    jcfg, jp, js, _, _, _, tm = model_pair()
    g = jcfg.grid_resolution
    update = jax.jit(lambda p, ms, k: J.update_occupancy(p, js, ms, jcfg, k))
    model = port_model()
    ms = {"occ": jnp.asarray(tm["occ"])}
    for seed in (3, 4):
        key = jax.random.PRNGKey(seed)
        before = model.occ.clone()
        ms = update(jp, ms, key)
        update_occupancy(model, torch.from_numpy(np.array(
            jax.random.uniform(key, (g, g, g, 3)))))
        want = np.asarray(ms["occ"])
        np.testing.assert_allclose(model.occ.numpy(), want, rtol=1e-6,
                                   atol=0)
        assert bool((model.occ >= before * jcfg.occ_ema_decay).all())
        assert not torch.equal(model.occ, before)


def _close(got, want, what, atol_rel):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_rel * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", ["train-white", "eval-white",
                                  "train-black"])
def test_forward_loss_and_grads_match_jax(case):
    """``instant_ngp_loss`` and its gradients against the JAX package's
    jitted ``value_and_grad`` on the same rays, grid and (in training)
    draws; the grid culls part of the samples."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models import instant_ngp as J
    from gfnerf_tpu_torch.models.instant_ngp import instant_ngp_loss

    background = case.split("-")[1]
    train = case.startswith("train")
    jcfg, jp, js, *_, tm = model_pair(background)
    o, d, tgt = rays()
    key = jax.random.PRNGKey(7) if train else None
    ms = {"occ": jnp.asarray(tm["occ"])}

    def jloss(p):
        return J.instant_ngp_loss(p, js, ms, jcfg, key, o, d, tgt,
                                  train=train)

    (jtotal, (jlosses, jout)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    draws = (torch.from_numpy(np.array(jax.random.uniform(
        key, (R, jcfg.num_samples + 1)))) if train else None)
    model = port_model(background)
    total, (losses, out) = instant_ngp_loss(
        model, *(torch.from_numpy(x) for x in (o, d, tgt)), draws)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    np.testing.assert_allclose(float(losses["rgb_loss"].detach()),
                               float(jlosses["rgb_loss"]), rtol=1e-5)
    keep = float(out["keep_frac"])
    assert keep == float(jout["keep_frac"]) and 0.2 < keep < 0.8
    np.testing.assert_allclose(out["rgb"].detach().numpy(),
                               np.asarray(jout["rgb"]), rtol=1e-5, atol=1e-6)
    for k in ("weights", "accumulation", "depth"):
        _close(out[k], jout[k], k, 5e-5)
    _close(model.feat.grad, jg["feat"], "table gradient", TABLE_TOL)
    for name in ("base_net", "head"):
        mlp = getattr(model, name)
        for i, (w, b) in enumerate(zip(mlp.w, mlp.b)):
            tol = MLP_TOL["train" if train else "eval"]
            _close(w.grad, jg[name]["w"][i], f"{name} w{i}", tol)
            _close(b.grad, jg[name]["b"][i], f"{name} b{i}", tol)


# ---- the pipeline ----


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A Blender scene of RGBA PNGs (8 train, 2 val views at 24x16), the
    sky transparent."""
    from gfnerf_tpu_torch.utils.synthetic import make_blender_fixture

    return make_blender_fixture(tmp_path_factory.mktemp("ngp") / "scene", 8,
                                2, img_wh=(24, 16), rgba=True)


def small_pipeline(cfg, dynamic=True):
    """``cfg`` (either package's VanillaPipelineConfig) cut to the small
    model, with ``dynamic_batch``."""
    cfg.train_num_rays_per_batch = PIPE_RAYS
    cfg.eval_num_rays_per_chunk = 128
    cfg.dynamic_batch = dynamic
    cfg.target_num_samples = TARGET_SAMPLES
    for k, v in SMALL.items():
        setattr(cfg.instant_ngp, k, v)
    return cfg


@pytest.fixture(scope="module")
def pipelines(scene, tmp_path_factory):
    """The JAX and the port's instant-ngp pipelines after PIPE_STEPS, the
    port's draws taken from the JAX pipeline's key chain (each step ``rng,
    key = split(rng)``, then at every 16th step ``rng, okey =
    split(rng)``), and both runs' metrics."""
    import jax
    from gfnerf_tpu.data.dataparsers.blender_parser import (
        BlenderDataParser, BlenderDataParserConfig)
    from gfnerf_tpu.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig as JaxConfig)
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig)

    tmp = tmp_path_factory.mktemp("ngp_runs")
    jcfg = small_pipeline(JaxConfig(model_kind="instant-ngp"))
    jpipe = jcfg.build(BlenderDataParser(BlenderDataParserConfig(
        data=scene)), tmp / "jax")
    rng, keys, okeys = jax.random.PRNGKey(jcfg.seed), {}, {}
    for step in PIPE_STEPS:
        rng, keys[step] = jax.random.split(rng)
        if step % 16 == 0:
            rng, okeys[step] = jax.random.split(rng)
    s, g = SMALL["num_samples"], SMALL["grid_resolution"]
    pcfg = small_pipeline(VanillaPipelineConfig(model_kind="instant-ngp"))
    pipe = pcfg.build(
        build_dataparser("blender", scene), tmp / "port", "cpu",
        draws=lambda step, r: [np.array(jax.random.uniform(
            keys[step], (r, s + 1)))],
        occupancy_draws=lambda step: np.array(jax.random.uniform(
            okeys[step], (g, g, g, 3))))
    jm, tm, grids = [], [], []
    for step in PIPE_STEPS:
        jm.append(jpipe.get_train_loss_dict(step))
        tm.append(pipe.get_train_loss_dict(step))
        grids.append((pipe.model.occ.clone(),
                      np.asarray(jpipe.model_state["occ"])))
    return jpipe, pipe, jm, tm, grids, tmp


def test_vanilla_pipeline_matches_jax(pipelines):
    """instant-ngp's vanilla pipeline with ``dynamic_batch`` over steps
    PIPE_STEPS (occupancy updates before steps 0, 16 and 32) against the
    JAX package's on the same scene, seed, batches and draws: the batch
    sizes and the kept samples equal at every step; the losses and train
    PSNR to 1e-4 relative (measured 3.2e-6); the grid after the first
    update (before any Adam step) to 1e-6 relative (measured 6.3e-8),
    after the later ones to 1e-2 (measured 5.3e-3: Adam moves an entry by about lr * sign(g), and where the two
    packages' gradients of an entry near zero differ in sign the tables
    part by 2 lr, test_torch_pipeline's finding; the grid reads the table
    everywhere, the losses only where rays sample); the eval PSNR to 1e-4
    (measured 3.6e-6), SSIM to 1e-3 (2.2e-4)."""
    jpipe, pipe, jm, tm, grids, _ = pipelines
    assert pipe.state.step == len(PIPE_STEPS)
    sizes = [m["num_rays_per_batch"] for m in tm]
    assert sizes == [m["num_rays_per_batch"] for m in jm]
    assert all(n & (n - 1) == 0 and 256 <= n <= PIPE_RAYS for n in sizes)
    assert sizes[0] < PIPE_RAYS, sizes   # the batch was retargeted
    for i, (a, b) in enumerate(zip(tm, jm)):
        assert set(a) == set(b) == {"loss", "rgb_loss", "psnr",
                                    "num_samples_per_batch",
                                    "num_rays_per_batch"}
        assert a["num_samples_per_batch"] == b["num_samples_per_batch"], i
        for k in ("loss", "rgb_loss", "psnr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                       err_msg=f"step {PIPE_STEPS[i]} {k}")
    for (got, want), step in zip(grids, PIPE_STEPS):
        np.testing.assert_allclose(got.numpy(), want,
                                   rtol=1e-6 if step < 16 else 1e-2, atol=0,
                                   err_msg=f"grid after step {step}")
    assert not torch.equal(grids[-1][0], torch.ones_like(grids[-1][0]))
    assert tm[-1]["rgb_loss"] < tm[0]["rgb_loss"]
    want = jpipe.get_eval_image_metrics_and_images(PIPE_STEPS[-1])[0]
    got, images = pipe.get_eval_image_metrics_and_images(PIPE_STEPS[-1])
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-3)
    assert images["img"].shape == (16, 48, 3)


def test_checkpoint_holds_the_grid_unlike_jax(pipelines, monkeypatch):
    """A repair: the JAX package's checkpoint holds params, optimizer state
    and statics but not ``model_state`` (so a resumed or evaluated
    instant-ngp starts from an all-ones grid); the port's holds the grid
    as a buffer of the model, and a pipeline loaded from it renders the
    same eval image."""
    import orbax.checkpoint as ocp

    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig)

    jpipe, pipe, *_, tmp = pipelines
    saved = {}

    class Capture:
        def save(self, path, tree):
            saved.update(tree)

    monkeypatch.setattr(ocp, "PyTreeCheckpointer", Capture)
    (tmp / "jax_ckpt").mkdir()
    jpipe.save_checkpoint_state(tmp / "jax_ckpt", PIPE_STEPS[-1])
    assert set(saved) == {"params", "opt_state", "statics"}
    assert not bool((np.asarray(jpipe.model_state["occ"]) == 1.0).any())
    ckpt = tmp / "port_ckpt"
    ckpt.mkdir()
    pipe.save_checkpoint_state(ckpt, PIPE_STEPS[-1])
    fresh = small_pipeline(VanillaPipelineConfig(
        model_kind="instant-ngp")).build(
            build_dataparser("blender", pipe.train_outputs.image_filenames[0]
                             .parent.parent), tmp / "fresh", "cpu")
    assert bool((fresh.model.occ == 1.0).all())
    assert fresh.load_checkpoint_state(ckpt) == PIPE_STEPS[-1]
    assert torch.equal(fresh.model.occ, pipe.model.occ)
    assert (fresh.pixel_sampler.num_rays_per_batch
            == pipe.pixel_sampler.num_rays_per_batch)
    a = fresh.render_camera(fresh.eval_outputs.cameras,
                            fresh.eval_cameras_dev, 0)["rgb"]
    b = pipe.render_camera(pipe.eval_outputs.cameras, pipe.eval_cameras_dev,
                           0)["rgb"]
    np.testing.assert_array_equal(a, b)


def test_trainer_runs_on_a_blender_scene(scene, tmp_path):
    """``python -m gfnerf_tpu_torch.train instant-ngp --dataparser blender``
    on the CPU, then ``eval`` (the dataparser guessed from the scene's
    layout) and ``render`` on its checkpoint; the generator's draws; the
    grid restored into the eval pipeline."""
    import json

    from gfnerf_tpu_torch import eval as eval_entry
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch import train as train_entry
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup
    from gfnerf_tpu_torch.utils.image_io import read_png

    out = tmp_path / "out"
    assert train_entry.main([
        "instant-ngp", "--data", str(scene), "--dataparser", "blender",
        "--device", "cpu", "--max-num-iterations", "18", "--output-dir",
        str(out), "pipeline.train_num_rays_per_batch=256",
        "pipeline.instant_ngp.num_samples=32",
        "pipeline.instant_ngp.grid_resolution=16",
        "pipeline.instant_ngp.log2_hashmap_size=10",
        "pipeline.dynamic_batch=true"]) == 0
    config = next(out.rglob("config.json"))
    _, trainer = eval_setup(config)
    occ = trainer.pipeline.model.occ
    assert not bool((occ == 1.0).any())   # two updates from all ones
    assert eval_entry.main(["--load-config", str(config), "--output-path",
                            str(tmp_path / "ev.json")]) == 0
    res = json.loads((tmp_path / "ev.json").read_text())["results"]
    assert np.isfinite(res["psnr"])
    assert render_entry.main(["--load-config", str(config), "--spiral-steps",
                              "2", "--output-path", str(tmp_path / "fr"),
                              "--dataparser", "blender"]) == 0
    frames = sorted((tmp_path / "fr").glob("*.png"))
    assert [read_png(f).shape for f in frames] == [(16, 24, 3)] * 2


def test_dynamic_batch_retarget(scene, tmp_path):
    """The JAX package's test_dynamic_batch_retarget on the port: rays a
    batch follow the kept samples toward the target, as powers of two no
    larger than the configured batch; the retarget rule itself against
    hand-made sample counts."""
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig)

    cfg = small_pipeline(VanillaPipelineConfig(model_kind="instant-ngp"))
    cfg.target_num_samples = 1 << 14
    pipe = cfg.build(build_dataparser("blender", scene), tmp_path, "cpu")
    m = pipe.get_train_loss_dict(0)
    n = pipe.pixel_sampler.num_rays_per_batch
    assert m["num_rays_per_batch"] == n and n & (n - 1) == 0 and n <= 512
    for samples, want in ((1e9, 256), (1.0, 512), (1 << 14, 512),
                          (1 << 16, 256)):
        pipe.pixel_sampler.set_num_rays_per_batch(512)
        pipe._retarget_batch_size(samples)
        assert pipe.pixel_sampler.num_rays_per_batch == want, samples


# ---- on the card ----


@pytest.mark.cuda
def test_model_kernels_match_plain_on_card():
    """One loss and backward of the small model on the card through H4
    and H5 (one call each) and through the plain pairs, on the same draws
    and grid: the loss to 1e-5 relative, every gradient to 1e-5 of its
    largest; the occupancy update through H4 equal to the plain one bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gfnerf_tpu_torch.fields import hash_encoding as he
    from gfnerf_tpu_torch.models import instant_ngp as T

    # numpy only: the CUDA tests run without JAX (--noconftest)
    cfg = T.InstantNGPConfig(**SMALL)
    params, statics, state = T.init_instant_ngp_params(cfg, 0)
    params["feat"] = np.random.default_rng(5).uniform(
        -1, 1, params["feat"].shape).astype(np.float32)
    state["occ"] = np.random.default_rng(6).uniform(
        0, 0.02, state["occ"].shape).astype(np.float32)
    o, d, tgt = rays()
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws = torch.rand((R, cfg.num_samples + 1), generator=gen,
                       device="cuda")
    jitter = T.occupancy_jitter(cfg, gen, "cuda")
    runs = []
    for plain in (False, True):
        model = T.InstantNGPModel(cfg, params, statics, state, "cuda")
        encode = T.hash_encode
        T.hash_encode = he.plain_hash_encode if plain else encode
        calls, bwd = he.hash_encode.calls, he.hash_encode.bwd_calls
        try:
            total, (losses, _) = T.instant_ngp_loss(
                model, *(torch.as_tensor(x, device="cuda")
                         for x in (o, d, tgt)), draws)
            total.backward()
            T.update_occupancy(model, jitter)
        finally:
            T.hash_encode = encode
        assert (he.hash_encode.calls - calls,
                he.hash_encode.bwd_calls - bwd) == ((0, 0) if plain
                                                    else (2, 1))
        runs.append((total.detach(), [p.grad.clone()
                                      for p in model.parameters()],
                     model.occ.clone()))
    (kl, kg, ko), (pl, pg, po) = runs
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0)
    for a, b in zip(kg, pg):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    assert torch.equal(ko, po)
