"""The quality run, the mid-scale run and the trainer's torn checkpoints:
the port (``gfnerf_tpu_torch.quality_run``, ``.midscale_run``,
``utils/synthetic.render_textured_scene``, ``engine/trainer``) against
``scripts/quality_run.py``, ``scripts/midscale_run.py`` and the JAX
package on the CPU.

Tolerances:
- exact: the textured scene in its three modes (bit for bit), the quality
  scene's npz files and the trivial baselines, the configs that both
  scripts build (every field the two configs share), the mid-scale
  scene's ``transforms.json`` and decoded pixels;
- ``diag_eval`` on ``gf-nerf-tiny`` in the packed layout after 16 steps
  (the transition after step 9; block 0 trained 6 steps, block 1 none),
  the JAX pipeline run in a process of its own
  (``tests/torch_pipeline_ref.py ... packed diag``) and its draws given to
  the port's: the routing exact; each variant's mean PSNR and SSIM and each
  camera's PSNR at the renders' tolerance of
  ``tests/test_torch_pipeline.py`` in that layout, 2e-4 relative (measured
  2.5e-7 on the PSNRs, 9.1e-6 on the SSIMs; each camera's PSNR is rounded
  to 0.01 by both, so it also has an atol of 0.01); the untrained block's
  renders equal to the shared field's in each package.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (two CPU threads per worker)

REPO = Path(__file__).resolve().parent.parent
# diag_eval's renders in the packed layout, tests/test_torch_pipeline.py
DIAG_RTOL = 2e-4
DIAG_STEPS = 16
RAYS = 128
PATCH_H = 8


def jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_fields(obj, prefix=""):
    """{dotted name: value} of a nested config dataclass's leaves."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(config_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


# fields of one package's config alone: the JAX trainer's mixed precision,
# the port's device and march (tests/test_torch_data.py)
JAX_ONLY = {"mixed_precision"}
PORT_ONLY = {"device", "pipeline.sampler.march"}


def assert_configs_equal(got, want, differ=()):
    """Every field both configs share is equal, but those of ``differ``."""
    g, w = config_fields(got), config_fields(want)
    assert set(w) - set(g) == JAX_ONLY
    assert set(g) - set(w) == PORT_ONLY
    shared = sorted(set(g) & set(w) - set(differ))
    assert len(shared) > 60
    for k in shared:
        assert g[k] == w[k], (k, g[k], w[k])


class Recorded(Exception):
    pass


def recording_trainer(store):
    """A Trainer stand-in that records its config and stops the caller."""
    class Recorder:
        def __init__(self, config, dataparser):
            store.append(config)
            raise Recorded

    return Recorder


# --------------------------------------------------------- the scenes ----


@pytest.mark.parametrize("smooth,supersample", [(False, 1), (True, 1),
                                                (True, 2)],
                         ids=["default", "smooth", "smooth-supersample"])
def test_render_textured_scene_matches_jax(smooth, supersample):
    from gfnerf_tpu.utils.synthetic import \
        render_textured_scene as jax_render
    from gfnerf_tpu_torch.utils.synthetic import (render_textured_scene,
                                                  ring_cameras)

    c2w, fx, fy, cx, cy, w, h = ring_cameras(5, radius=4.5, height=1.6,
                                             img_wh=(40, 30), focal=30.0)
    got = render_textured_scene(c2w, fx, fy, cx, cy, w, h, smooth=smooth,
                                supersample=supersample)
    want = jax_render(c2w, fx, fy, cx, cy, w, h, smooth=smooth,
                      supersample=supersample)
    assert got.shape == (5, 30, 40, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0.05   # texture, ground and sky are all there


@pytest.mark.parametrize("variant", ["textured", "smooth"])
def test_build_scene_and_baselines_match_jax(tmp_path, variant):
    from gfnerf_tpu_torch import quality_run

    jq = jax_script("quality_run")
    kw = dict(n_train=10, n_val=3, img_wh=(32, 24), variant=variant)
    got = quality_run.build_scene(tmp_path / "port", **kw)
    want = jq.build_scene(tmp_path / "jax", **kw)
    np.testing.assert_array_equal(got, want)
    for split in ("train", "val"):
        a = np.load(tmp_path / "port" / f"{split}.npz")
        b = np.load(tmp_path / "jax" / f"{split}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert quality_run.trivial_baselines(got) == jq.trivial_baselines(want)


# ---------------------------------------------------------- the config ----

KNOBS = ["--block-wd", "0.01", "--block-lr", "0.002", "--block-rows-log2",
         "12", "--rows-log2", "14", "--uniform-sampling", "--mix-fraction",
         "0.25", "--empty-penalty", "0.5", "--empty-tau", "0.02",
         "--dense-levels", "2", "--remat-chunks", "4", "--hash-layout",
         "anchored", "--focal-mode", "finetune", "--trust-mult", "0.1",
         "--n-blocks", "3", "--rays-per-batch", "1024", "--max-depth", "10",
         "--init-steps", "40", "--split-steps", "20"]


@pytest.mark.parametrize("argv", [["--config", "perf"],
                                  ["--config", "parity"],
                                  ["--config", "prop"],
                                  ["--config", "perf", *KNOBS]],
                         ids=["perf", "parity", "prop", "perf-knobs"])
def test_quality_config_matches_jax(tmp_path, monkeypatch, argv):
    import gfnerf_tpu.engine.trainer as jax_trainer
    from gfnerf_tpu_torch import quality_run

    scene = tmp_path / "scene"
    quality_run.build_scene(scene, n_train=6, n_val=2, img_wh=(16, 12))
    recorded = []
    monkeypatch.setattr(jax_trainer, "Trainer", recording_trainer(recorded))
    jq = jax_script("quality_run")
    monkeypatch.setattr(sys, "argv", ["quality_run.py", *argv,
                                      "--scene-dir", str(scene)])
    with pytest.raises(Recorded):
        jq.main()
    (want,) = recorded
    got = quality_run.quality_config(
        quality_run.parse_args([*argv, "--scene-dir", str(scene)]), scene)
    # the run's directory: the JAX script's under /tmp, the port's under
    # outputs/
    assert_configs_equal(got, want, differ={"output_dir"})
    assert want.output_dir.name == got.output_dir.name == argv[1]
    assert got.device == "cuda"


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
def test_midscale_command_matches_jax(tmp_path, monkeypatch, fast):
    """The port's train command resolves to the config the JAX script's
    command resolves to (the JAX command captured at its launch)."""
    import gfnerf_tpu.engine.trainer as jax_trainer
    import gfnerf_tpu_torch.engine.trainer as port_trainer
    from gfnerf_tpu_torch import midscale_run, train

    scene = tmp_path / "scene"
    midscale_run.build_nerfstudio_scene(scene, n_cams=6, img_wh=(16, 12))
    jm = jax_script("midscale_run")
    launched = []

    class Launched(Exception):
        pass

    def popen(cmd, **kwargs):
        launched.append(cmd)
        raise Launched

    monkeypatch.setattr(subprocess, "Popen", popen)
    flags = ["--scene-dir", str(scene), "--out-dir", str(tmp_path / "out")]
    flags += ["--fast"] if fast else []
    monkeypatch.setattr(sys, "argv", ["midscale_run.py", *flags])
    with pytest.raises(Launched):
        jm.main()
    monkeypatch.undo()
    (jax_cmd,) = launched
    assert jax_cmd[1] == "scripts/train.py"

    recorded = []
    monkeypatch.setattr(jax_trainer, "Trainer", recording_trainer(recorded))
    monkeypatch.setattr(port_trainer, "Trainer", recording_trainer(recorded))
    monkeypatch.chdir(REPO)
    with pytest.raises(Recorded):
        jax_script("train").main(jax_cmd[2:])
    args = midscale_run.parse_args([*flags, "--device", "cpu"])
    cmd = midscale_run.train_command(args)
    assert cmd[1:4] == ["-m", "gfnerf_tpu_torch.train", "gf-nerf"]
    with pytest.raises(Recorded):
        train.build_trainer(cmd[3:])
    want, got = recorded
    # the JAX script writes its runs under /tmp/midscale_out
    assert_configs_equal(got, want, differ={"output_dir"})
    assert got.output_dir == args.run_dir
    sched = midscale_run.schedule(args)
    assert got.max_num_iterations == sched["total"]
    assert got.steps_per_save == sched["save_every"]
    assert got.pipeline.sampler.sub_div_milestones == (
        (25, 50, 100) if fast else (187, 375, 750))


def test_build_nerfstudio_scene_matches_jax(tmp_path):
    import imageio.v2 as imageio

    from gfnerf_tpu_torch import midscale_run

    jm = jax_script("midscale_run")
    n = midscale_run.build_nerfstudio_scene(tmp_path / "port", n_cams=6,
                                            img_wh=(20, 15))
    assert n == jm.build_nerfstudio_scene(tmp_path / "jax", n_cams=6,
                                          img_wh=(20, 15)) == 6
    assert ((tmp_path / "port" / "transforms.json").read_text()
            == (tmp_path / "jax" / "transforms.json").read_text())
    frames = json.loads((tmp_path / "jax" / "transforms.json").read_text())
    for fr in frames["frames"]:
        a = imageio.imread(tmp_path / "port" / fr["file_path"])
        b = imageio.imread(tmp_path / "jax" / fr["file_path"])
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------- diag_eval ----


@pytest.fixture(scope="module")
def diag_scene(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("diag_scene")
    make_synthetic_npz(path, n_train=12, n_val=2, img_wh=(32, 24))
    return path


def tiny_packed_config(scene, out_dir):
    """``gf-nerf-tiny`` in the packed layout (tests/torch_pipeline_ref.py's
    "packed" overrides), on the CPU."""
    from torch_pipeline_ref import FIELD_OVERRIDES

    from gfnerf_tpu_torch.configs.method_configs import gf_nerf_tiny_config

    cfg = gf_nerf_tiny_config()
    cfg.max_num_iterations = DIAG_STEPS
    cfg.output_dir = out_dir
    cfg.data = scene
    cfg.device = "cpu"
    cfg.pipeline.datamanager.train_num_rays_per_batch = RAYS
    cfg.pipeline.model.s3im_patch_height = PATCH_H
    for key, value in FIELD_OVERRIDES["packed"].items():
        setattr(cfg.pipeline, key, value)
    return cfg


def test_diag_eval_matches_jax(diag_scene, tmp_path):
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.quality_run import diag_eval

    ref_dir = tmp_path / "jax"
    ref_dir.mkdir()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).with_name(
            "torch_pipeline_ref.py")), str(diag_scene), str(ref_dir),
         str(DIAG_STEPS), str(RAYS), str(PATCH_H), "packed", "diag"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    ref = dict(np.load(ref_dir / "ref.npz"))
    want = json.loads(str(ref["diag"]))

    cfg = tiny_packed_config(diag_scene, tmp_path / "port")
    p = cfg.pipeline.build(
        MinimalDataParser(MinimalDataParserConfig(data=diag_scene)),
        tmp_path / "port", device="cpu",
        draws=lambda step, r, s: (ref["noise"][step], ref["perms"][step]))
    for step in range(DIAG_STEPS):
        p.get_train_loss_dict(step)
        p.after_train_iteration(step)
    got = diag_eval(p, DIAG_STEPS, cfg.pipeline.model.n_blocks)

    assert sorted(got) == sorted(want) == [
        "block0", "block1", "routed", "routing", "shared_only"]
    assert got["routing"] == want["routing"]
    for name in ("routed", "shared_only", "block0", "block1"):
        np.testing.assert_allclose(
            [got[name]["psnr"], got[name]["ssim"]],
            [want[name]["psnr"], want[name]["ssim"]], rtol=DIAG_RTOL,
            err_msg=name)
        np.testing.assert_allclose(got[name]["per_cam_psnr"],
                                   want[name]["per_cam_psnr"],
                                   rtol=DIAG_RTOL, atol=0.01, err_msg=name)
    # block 1 never trained: its residual is zero in both packages
    for d in (got, want):
        assert d["block1"]["psnr"] == d["shared_only"]["psnr"]
        assert d["block0"]["psnr"] != d["shared_only"]["psnr"]


# ------------------------------------------------ the runs on the CPU ----


def test_quality_run_on_the_cpu(tmp_path):
    """A tiny quality run: the JAX script's keys at each milestone, the
    diag evals' frozen shared field and untrained block, the end
    checkpoint; then a run from the transition's checkpoint
    (``--init-ckpt``) skips the init stage and reports its eval."""
    from gfnerf_tpu_torch import quality_run

    argv = ["--device", "cpu", "--diag", "--init-steps", "8",
            "--split-steps", "3", "--n-train", "10", "--n-val", "1",
            "--img-wh", "24x16", "--rays-per-batch", "128", "--rows-log2",
            "10", "--scene-dir", str(tmp_path / "scene"), "--output-dir",
            str(tmp_path / "runs"), "--init-ckpt", str(tmp_path / "ic")]
    res = quality_run.run(quality_run.parse_args(
        argv + ["--out", str(tmp_path / "a.json")]), log=lambda m: None)
    assert json.loads((tmp_path / "a.json").read_text()) == res
    assert {"config", "baselines", "init_steps", "split_steps",
            "after_init", "after_split0", "after_split0_diag", "final",
            "final_diag", "minutes", "s_per_step", "checkpoint"} == set(res)
    for m in ("after_init", "after_split0", "final"):
        assert sorted(res[m]) == ["fps", "lpips_proxy", "num_rays_per_sec",
                                  "psnr", "ssim"]
        assert math.isfinite(res[m]["psnr"])
    d = res["after_split0_diag"]
    assert d["shared_only"]["psnr"] == res["after_init"]["psnr"]
    assert d["block1"]["psnr"] == d["shared_only"]["psnr"]
    assert (Path(res["checkpoint"]) / "state.pt").exists()
    assert (tmp_path / "ic" / "after_init_eval.json").exists()

    res2 = quality_run.run(quality_run.parse_args(
        argv + ["--out", str(tmp_path / "b.json")]), log=lambda m: None)
    assert res2["after_init"] == res["after_init"]
    assert math.isfinite(res2["final"]["psnr"])


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("tiny_scene")
    make_synthetic_npz(path, n_train=8, n_val=2, img_wh=(32, 24))
    return path


def tiny_trainer(scene, out, iterations, **over):
    from gfnerf_tpu_torch.configs.method_configs import gf_nerf_tiny_config
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.engine.trainer import Trainer

    cfg = gf_nerf_tiny_config()
    cfg.max_num_iterations = iterations
    cfg.output_dir, cfg.data, cfg.device = out, scene, "cpu"
    cfg.vis = "local"
    cfg.pipeline.datamanager.train_num_rays_per_batch = 64
    cfg.pipeline.model.s3im_patch_height = 8
    for k, v in over.items():
        setattr(cfg, k, v)
    trainer = Trainer(cfg, MinimalDataParser(
        MinimalDataParserConfig(data=scene)))
    trainer.setup()
    return trainer


@pytest.mark.parametrize("tear", ["stale-tmp", "killed-save"])
def test_resume_skips_a_torn_checkpoint(tiny_scene, tmp_path, tear):
    """A save is written into step-N.tmp and renamed once whole: a run
    killed while it saves leaves the previous checkpoint as the newest
    whole one, and the resume takes that."""
    trainer = tiny_trainer(tiny_scene, tmp_path / "a", 6, steps_per_save=3)
    trainer.train()
    ckpts = trainer.checkpoint_dir
    assert sorted(c.name for c in ckpts.iterdir()) == ["step-000000005"]
    if tear == "stale-tmp":
        # a later save that never finished: a part of its files
        torn = ckpts / "step-000000008.tmp"
        torn.mkdir()
        (torn / "meta.json").write_text("{")
    else:
        p = trainer.pipeline
        save = p.save_checkpoint_state

        def killed(ckpt_dir, step):
            save(ckpt_dir, step)
            (Path(ckpt_dir) / "octree.npz").write_bytes(b"torn")
            raise KeyboardInterrupt   # the kill, mid-save

        p.save_checkpoint_state = killed
        with pytest.raises(KeyboardInterrupt):
            trainer.save_checkpoint(8)
        assert (ckpts / "step-000000008.tmp").is_dir()
    assert not (ckpts / "step-000000008").exists()
    resumed = tiny_trainer(tiny_scene, tmp_path / "b", 8, load_dir=ckpts)
    assert resumed._start_step == 6
    resumed.train()
    # the resumed run's own saves stay whole and pruned
    assert sorted(c.name for c in resumed.checkpoint_dir.iterdir()) == [
        "step-000000007"]


def test_save_replaces_a_checkpoint_of_the_same_step(tiny_scene, tmp_path):
    trainer = tiny_trainer(tiny_scene, tmp_path, 3, steps_per_save=100)
    trainer.train()
    before = (trainer.checkpoint_dir / "step-000000002" /
              "meta.json").read_text()
    trainer.save_checkpoint(2)
    assert sorted(c.name for c in trainer.checkpoint_dir.iterdir()) == [
        "step-000000002"]
    assert (trainer.checkpoint_dir / "step-000000002" /
            "meta.json").read_text() == before


def test_midscale_kill_and_resume_on_the_cpu(tmp_path):
    """midscale_run end to end on the CPU at a handful of steps on 32x24
    images: three rebuilds, the kill past kill_at, the resume at the
    checkpoint's step + 1 with no rebuild, the eval, TensorBoard files."""
    from gfnerf_tpu_torch import midscale_run
    from gfnerf_tpu_torch.utils.writer import read_events

    args = midscale_run.parse_args([
        "--device", "cpu", "--init-steps", "8", "--split-steps", "8",
        "--n-cams", "12", "--img-wh", "32x24",
        "--out-dir", str(tmp_path / "out"), "--scene-dir",
        str(tmp_path / "scene"), "--run-dir", str(tmp_path / "runs"),
        "--vis", "tensorboard", "steps_per_save=5", "steps_per_log=1",
        "pipeline.datamanager.train_num_rays_per_batch=64",
        "pipeline.model.samples_budget_per_ray=64",
        "pipeline.sampler.max_samples=64", "pipeline.model.remat_chunks=0",
        "pipeline.field_packed_rows_log2=10"])
    s = midscale_run.run(args, log=lambda m: None)
    assert json.loads((tmp_path / "out" / "summary.json").read_text()) == s
    assert s["total_steps"] == 40 and s["kill_at"] == 20
    assert s["phase1_rebuilds"] == 3 and s["phase2_rebuilds"] == 0
    assert s["killed_at_logged_step"] >= 20
    ckpt_step = int(s["resume_ckpts"][-1].split("-")[1])
    assert ckpt_step >= 19 and s["phase2_resumed_at"] == ckpt_step + 1
    assert s["phase2_rc"] == 0 and s["eval_rc"] == 0
    assert s["phase2_ckpts"] == ["step-000000039"]
    psnr = s["eval"]["results"]["psnr"]
    assert math.isfinite(psnr) and psnr > s["baselines"]["black_psnr"]
    runs = sorted((tmp_path / "runs" / "midscale" / "gf-nerf").iterdir())
    assert len(runs) == 2
    for run in runs:
        (events,) = run.glob("events.out.tfevents.*")
        tags = {v["tag"] for e in read_events(events)
                for v in e.get("values", [])}
        assert {"loss", "config/text_summary"} <= tags
