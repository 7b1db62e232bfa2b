"""The port's pipeline and Trainer (gfnerf_tpu_torch.pipelines,
gfnerf_tpu_torch.engine.trainer) on the CPU.

- ``gf-nerf-tiny`` through the port's Trainer across the init -> focal
  transition, with a checkpoint, a resume and a finite eval
  (tests/test_train_smoke.py's run); the CLI does the same.
- The port's ``GFNerfPipeline`` against the JAX package's on the same
  synthetic scene for 16 steps across the transition, in either hash
  layout (``gf-nerf-tiny``'s anchored one, whose eval renders a stream per
  block, and the packed one of ``gf-nerf-perf``, whose eval routes a block
  per ray): the JAX run (tests/torch_pipeline_ref.py, one JAX CPU device,
  in a process of its own) records each step's march noise and S3IM
  permutations from its key chain, and the port's pipeline takes them as
  its ``draws``.  Both packages' parsers name each image on its own, so
  the transition writes one error map per view, and its PNG previews
  (``sample_tmp/{png,gt,pred}``), which decode pixel for pixel as the JAX
  run's files.  A third run ("clip")
  takes the anchored layout with ``max_norm`` 0.003 (between the groups'
  norms: the MLPs' about 0.2 clipped every step, the global table's
  0.002-0.005 on some, the block table's about 0.002 never) and the loss
  switches (MSE; S3IM at 0.5 with kernel 2, stride 2, 4 repeats), held to
  the same tolerances: measured 2.1e-6 on the losses, 8.2e-5 on the error
  maps, 1.1e-6 on the eval PSNR, and 4.2% of the block table's entries
  (0.70% of the global table's) off by more than 1e-4, at most 0.0192.

Tolerances of the parity run (f32 MLPs):
- exact: the calibrated ``max_hits``, every step's batch indices (the
  pixel samplers are numpy with the same seeds; the focal batches' error-
  guided 20% too, since the error maps agree), the trees after both
  milestone rebuilds, the camera labels, the block indices, the split
  index of every step;
- ``sample_l`` to 1e-6 relative (the trial march's median slot count is
  an integer);
- losses to 1e-4 relative: 16 steps of the one-step test's 1e-5, with
  Adam's updates of near-zero gradients free to differ in sign;
- the error maps rendered at the transition and the eval PSNR (before
  the transition and after the last step): renders of a field 10 and 16
  steps apart in the two packages: 1e-4 relative with an atol of 1e-5
  (measured 8.1e-5 and 2.3e-5), in the packed layout 2e-4 relative
  (measured 1.65e-4 and 3.4e-5: the first updates' sign flips below move
  a packed row that more cells share), and 1e-5 (measured 8.0e-7);
- the final parameters: Adam moves an entry by about lr * sign(g) on its
  first nonzero gradient, so where that gradient is near zero (most
  entries at step 0, whose fineness of 16 leaves under one sample a ray)
  the two packages' signs may differ and the entry stays apart by up to
  lr = 1e-2.  Measured after 16 steps: 0.65% of the global table's
  entries, 5.6% of the first base-MLP layer's and 7.6% of the trained
  block table's differ by more than 1e-4, at most by 0.0183.  The test
  allows 10% and 2e-2 (two steps of the largest learning rate).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)
from torch_pipeline_ref import CLIP_OVERRIDES, FIELD_OVERRIDES

STEPS = 16    # the transition after step 9 (gf-nerf-tiny: 10 init steps)
# the hash layouts, and the anchored one with clipping and the loss switches
LAYOUTS = {**FIELD_OVERRIDES, **CLIP_OVERRIDES}
MAP_RTOL = {"anchored": 1e-4, "packed": 2e-4, "clip": 1e-4}   # see above
PREVIEW_SHARE = 0.01   # check_previews
RAYS = 128
PATCH_H = 8
TREE_KEYS = ("centers", "side_lens", "parents", "childs", "is_leaf",
             "trans_idx", "block_idx", "weight_stats", "alpha_stats")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("scene")
    make_synthetic_npz(path, n_train=12, n_val=2, img_wh=(32, 24))
    return path


def tiny_config(scene, out_dir, iterations=16, layout="anchored"):
    """``gf-nerf-tiny`` with tests/test_train_smoke.py's overrides and the
    hash layout's field fields."""
    from gfnerf_tpu_torch.configs.method_configs import gf_nerf_tiny_config

    cfg = gf_nerf_tiny_config()
    cfg.max_num_iterations = iterations
    cfg.output_dir = out_dir
    cfg.data = scene
    cfg.device = "cpu"
    cfg.pipeline.datamanager.train_num_rays_per_batch = RAYS
    cfg.pipeline.model.s3im_patch_height = PATCH_H
    for key, value in LAYOUTS[layout].items():
        *path, leaf = key.split(".")
        obj = cfg.pipeline
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, leaf, value)
    return cfg


def parser_of(scene):
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)

    return MinimalDataParser(MinimalDataParserConfig(data=scene))


def test_trainer_crosses_transition_and_resumes(scene, tmp_path,
                                                monkeypatch):
    import gfnerf_tpu_torch.sampler.manager as manager_mod
    from gfnerf_tpu_torch.engine.trainer import Trainer

    cfg = tiny_config(scene, tmp_path / "outputs")
    cfg.steps_per_save = 15
    trainer = Trainer(cfg, parser_of(scene))
    trainer.setup()
    trainer.train()

    p = trainer.pipeline
    assert p.sampler.cameras_labels is not None
    assert p.sample_tmp_dir is not None
    assert p.datamanager.split_cache is not None
    assert p.datamanager.split_cache.error_maps is not None
    assert (trainer.base_dir / "config.json").exists()
    ckpts = sorted((trainer.base_dir / "nerfstudio_models").glob("step-*"))
    assert [c.name for c in ckpts] == ["step-000000015"]

    cfg2 = tiny_config(scene, tmp_path / "outputs2", iterations=18)
    cfg2.load_dir = trainer.base_dir / "nerfstudio_models"
    trainer2 = Trainer(cfg2, parser_of(scene))

    def no_build(*args, **kwargs):
        raise AssertionError("a resumed setup built an octree")

    # the resumed pipeline takes the checkpoint's octree and march config
    monkeypatch.setattr(manager_mod, "build_octree", no_build)
    trainer2.setup()
    assert trainer2._start_step == 16
    p2 = trainer2.pipeline
    assert p2.sampler.sampler_config == p.sampler.sampler_config
    # the loaded state is the saved one
    for (name, a), b in zip(p.field.state_dict().items(),
                            p2.field.state_dict().values()):
        assert torch.equal(a, b), name
    assert p2.state.step == p.state.step == 16
    assert p2.state.opt_state.count == p.state.opt_state.count
    for name, mus in p.state.opt_state.mu.items():
        for a, b in zip(mus, p2.state.opt_state.mu[name]):
            assert (a is None and b is None) or torch.equal(a, b), name
    np.testing.assert_array_equal(p2.sampler.cameras_labels,
                                  p.sampler.cameras_labels)
    assert p2.sampler.tree.n_nodes == p.sampler.tree.n_nodes
    assert torch.equal(p2.generator.get_state(), p.generator.get_state())
    # a resumed focal step trains the active block's table, in the stack
    active = p2.sampler.cur_split_idx(16)
    before = p2.field.block_feats.detach().clone()
    trainer2.train()
    after = p2.field.block_feats.detach()
    assert not torch.equal(after[active], before[active])
    for b in range(after.shape[0]):
        if b != active:
            assert torch.equal(after[b], before[b])

    metrics, images = p.get_eval_image_metrics_and_images(step=16, idx=0)
    for k in ("psnr", "ssim", "lpips_proxy"):
        assert np.isfinite(metrics[k]), k
    assert images["img"].shape == (24, 64, 3)   # gt | pred
    mean = p.get_average_eval_image_metrics(step=16)
    assert sorted(mean) == sorted(metrics)
    assert all(np.isfinite(v) for v in mean.values())


def test_cli_trains_and_resumes(scene, tmp_path):
    from gfnerf_tpu_torch.train import main

    args = ["gf-nerf-tiny", "--data", str(scene), "--device", "cpu",
            "--max-num-iterations", "12", f"pipeline.datamanager."
            f"train_num_rays_per_batch={RAYS // 2}",
            "--pipeline.model.s3im_patch_height", "4",
            "--experiment-name", "run"]
    assert main(args + ["--output-dir", str(tmp_path / "a")]) == 0
    ckpt = next((tmp_path / "a" / "run" / "gf-nerf-tiny").glob(
        "*/nerfstudio_models"))
    assert sorted(p.name for p in ckpt.iterdir()) == ["step-000000011"]
    assert main(args[:6] + ["14"] + args[7:] + [
        "--output-dir", str(tmp_path / "b"), "--load-dir", str(ckpt)]) == 0
    assert next((tmp_path / "b" / "run" / "gf-nerf-tiny").glob(
        "*/nerfstudio_models/step-000000013")).is_dir()


# ---- the port's pipeline against the JAX package's ----


@pytest.fixture(scope="module")
def jax_refs(scene, tmp_path_factory):
    """{layout: the JAX run's records}; the runs side by side."""
    script = Path(__file__).with_name("torch_pipeline_ref.py")
    outs, procs = {}, {}
    for layout in LAYOUTS:
        outs[layout] = tmp_path_factory.mktemp(f"jax_ref_{layout}")
        procs[layout] = subprocess.Popen(
            [sys.executable, str(script), str(scene), str(outs[layout]),
             str(STEPS), str(RAYS), str(PATCH_H), layout],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for layout, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log.decode()[-4000:]
    return {layout: {**np.load(out / "ref.npz"), "dir": out}
            for layout, out in outs.items()}


def run_port(scene, out_dir, ref, layout):
    """The port's pipeline driven as tests/torch_pipeline_ref.py drives the
    JAX one, with the JAX run's draws; the same records."""
    cfg = tiny_config(scene, out_dir, layout=layout)
    p = cfg.pipeline.build(parser_of(scene), out_dir, device="cpu",
                           draws=lambda step, r, s: (ref["noise"][step],
                                                     ref["perms"][step]))
    rec = {"sample_l": p.sampler.sampler_config.sample_l,
           "max_hits0": p.sampler.sampler_config.max_hits}
    batches = []
    next_train = p.datamanager.next_train

    def recording_next_train(step):
        batch = next_train(step)
        batches.append(batch["indices"].copy())
        return batch

    p.datamanager.next_train = recording_next_train
    losses, splits, rebuilt = [], [], []
    for step in range(STEPS):
        n_nodes = p.sampler.tree.n_nodes
        m = p.get_train_loss_dict(step)
        losses.append([m["loss"], m["rgb_loss"], m["s3im_loss"]])
        if p.sampler.tree.n_nodes != n_nodes:
            rebuilt.append(step)
            for k in TREE_KEYS:
                rec[f"tree{step}_{k}"] = getattr(p.sampler.tree, k)
        labelled = p.sampler.cameras_labels is not None
        p.after_train_iteration(step)
        if not labelled and p.sampler.cameras_labels is not None:
            rec["transition"] = step
            rec["labels"] = p.sampler.cameras_labels
            rec["block_idx"] = p.sampler.tree.block_idx
            npy = Path(p.sample_tmp_dir) / "npy"
            rec["error_map_files"] = np.stack(
                [np.load(f) for f in sorted(npy.iterdir())])
        splits.append(p.datamanager.split_idx)
        if (step + 1) % cfg.steps_per_eval_batch == 0 or step == STEPS - 1:
            rec[f"eval_psnr{step}"] = p.get_eval_loss_dict(step)["eval_psnr"]
    cache = p.datamanager.split_cache
    rec.update(indices=np.stack(batches), losses=np.asarray(losses),
               splits=np.asarray(splits), rebuilt=np.asarray(rebuilt),
               max_hits=p.sampler.sampler_config.max_hits,
               split_error_maps=cache.error_maps if cache else np.zeros(0),
               split_cache_indices=cache.indices if cache else np.zeros(0))
    params, _ = p.field.to_numpy()
    rec["global_feat"] = params.global_feat
    rec["block_feats"] = params.block_feats
    for name in ("base_net", "mlp_head"):
        for part in ("w", "b"):
            for i, x in enumerate(getattr(params, name)[part]):
                rec[f"{name}_{part}{i}"] = x
    rec["appearance_embedding"] = params.appearance_embedding
    return rec


def check_previews(port_dir: Path, jax_dir: Path, jax_errors) -> None:
    """The transition's PNG previews (``sample_tmp/{png,gt,pred}``), the
    port's against the JAX run's imageio files: the same names; the
    ground truths pixel for pixel; the port's writer given the JAX run's
    error maps (``jax_errors``, by name) writes the JAX run's error
    previews pixel for pixel; the two runs' own error and render previews
    at most one level apart, at no more than PREVIEW_SHARE of a file's
    pixels (their floats agree to about 1e-4, and a value that close to a
    level's edge truncates to either side; measured at most 0.65%, at
    the anchored layout's error previews; the render previews equal)."""
    from gfnerf_tpu_torch.pipelines.pipeline import _to8
    from gfnerf_tpu_torch.utils.image_io import encode_png, decode_png, \
        read_png

    names = sorted(p.name for p in (jax_dir / "png").iterdir())
    assert len(names) == 12 == len(jax_errors)
    for sub in ("png", "gt", "pred"):
        assert sorted(p.name for p in (port_dir / sub).iterdir()) == names
        for name in names:
            got = read_png(port_dir / sub / name)
            want = read_png(jax_dir / sub / name)
            if sub == "gt":
                np.testing.assert_array_equal(got, want, err_msg=name)
                continue
            off = got.astype(int) - want.astype(int)
            assert np.abs(off).max() <= 1, (sub, name)
            assert (off != 0).mean() <= PREVIEW_SHARE, (sub, name)
    for name, err in zip(names, jax_errors):
        again = decode_png(encode_png(_to8(err / max(err.max(), 1e-6))))
        np.testing.assert_array_equal(again, read_png(jax_dir / "png" / name),
                                      err_msg=name)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipeline_matches_jax(scene, jax_refs, tmp_path, layout):
    ref = jax_refs[layout]
    got = run_port(scene, tmp_path, ref, layout)

    # calibration
    np.testing.assert_allclose(got["sample_l"], ref["sample_l"], rtol=1e-6)
    assert got["max_hits0"] == ref["max_hits0"]
    assert got["max_hits"] == ref["max_hits"]
    # every batch, the first focal split batch included
    assert int(ref["transition"]) == 10
    np.testing.assert_array_equal(got["indices"], ref["indices"])
    first_split_batch = int(np.argmax(ref["splits"] >= 0)) + 1
    assert first_split_batch == 11
    np.testing.assert_array_equal(got["indices"][first_split_batch],
                                  ref["indices"][first_split_batch])
    # the octree after each milestone rebuild
    np.testing.assert_array_equal(got["rebuilt"], ref["rebuilt"])
    assert list(ref["rebuilt"]) == [4, 8]
    for step in ref["rebuilt"]:
        for k in TREE_KEYS:
            np.testing.assert_array_equal(got[f"tree{step}_{k}"],
                                          ref[f"tree{step}_{k}"],
                                          err_msg=f"tree at {step}: {k}")
    # the transition
    assert got["transition"] == ref["transition"]
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_array_equal(got["block_idx"], ref["block_idx"])
    assert got["error_map_files"].shape[0] == 12   # one map per view
    np.testing.assert_allclose(got["error_map_files"],
                               ref["error_map_files"], rtol=MAP_RTOL[layout],
                               atol=1e-5)
    check_previews(tmp_path / "sample_tmp", ref["dir"] / "sample_tmp",
                   ref["error_map_files"])
    np.testing.assert_array_equal(got["splits"], ref["splits"])
    np.testing.assert_array_equal(got["split_cache_indices"],
                                  ref["split_cache_indices"])
    np.testing.assert_allclose(got["split_error_maps"],
                               ref["split_error_maps"], rtol=MAP_RTOL[layout],
                               atol=1e-5)
    # losses, eval
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    for step in (9, STEPS - 1):   # the init stage's eval; the focal one's
        np.testing.assert_allclose(got[f"eval_psnr{step}"],
                                   ref[f"eval_psnr{step}"], rtol=1e-5)
    # final parameters: block 1 never trains; elsewhere first-update sign
    # flips of near-zero gradients, at most 10% of a tensor and none over
    # two steps of the largest learning rate
    np.testing.assert_array_equal(got["block_feats"][1],
                                  ref["block_feats"][1])
    for k in ("global_feat", "block_feats", "appearance_embedding",
              *[k for k in ref if k.startswith(("base_net", "mlp_head"))]):
        diff = np.abs(got[k] - ref[k])
        assert (diff > 1e-4).mean() <= 0.1, (k, (diff > 1e-4).mean())
        assert diff.max() <= 2e-2, (k, diff.max())
