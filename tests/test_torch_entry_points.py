"""The port's entry points on the CPU: ``python -m gfnerf_tpu_torch.train``
trains ``gf-nerf-tiny`` with a budget below its march slots (16 < 64, so
the compacted branch runs at both stages) across the transition into a
temporary directory; ``gfnerf_tpu_torch.eval`` writes its metrics JSON
from the run's checkpoint; ``gfnerf_tpu_torch.render`` writes valid PNG
frames along a spiral and an interpolated trajectory, with and without
early termination, and refuses video when the JPEG codec cannot build;
the camera-path reader gives the cameras the JAX package's
``scripts/render.py`` gives for the same file.
"""

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

STEPS = 12   # 10 init steps, the transition, 2 focal steps


def _read_png(path: Path) -> np.ndarray:
    """An 8-bit RGB PNG (one IDAT, filter 0 rows, as write_png writes it)
    read back with zlib; checks its signature and chunk CRCs."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = body
        pos += 12 + n
    assert list(chunks) == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert np.all(rows[:, 0] == 0)
    return rows[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A gf-nerf-tiny run with compaction: the directory holding its
    config.json."""
    from gfnerf_tpu_torch import train
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    tmp = tmp_path_factory.mktemp("entry")
    scene = make_synthetic_npz(tmp / "scene", n_train=12, n_val=2,
                               img_wh=(32, 24))
    rc = train.main([
        "gf-nerf-tiny", "--data", str(scene), "--device", "cpu",
        "--output-dir", str(tmp / "out"), "--experiment-name", "tiny",
        "--max-num-iterations", str(STEPS),
        "pipeline.datamanager.train_num_rays_per_batch=128",
        "pipeline.model.s3im_patch_height=8",
        "pipeline.model.samples_budget_per_ray=16",
        "pipeline.model.remat_chunks=2"])
    assert rc == 0
    (config,) = (tmp / "out").glob("tiny/gf-nerf-tiny/*/config.json")
    return config.parent


def test_train_compacted_run_writes_checkpoint(run_dir):
    from gfnerf_tpu_torch.configs.config_io import config_from_json

    cfg = config_from_json((run_dir / "config.json").read_text())
    assert cfg.pipeline.model.samples_budget_per_ray == 16
    assert cfg.pipeline.sampler.max_samples == 64
    assert cfg.pipeline.model.remat_chunks == 2
    assert cfg.pipeline.eval_early_term is False
    ckpts = sorted((run_dir / "nerfstudio_models").glob("step-*"))
    assert [c.name for c in ckpts] == [f"step-{STEPS - 1:09d}"]
    assert (ckpts[0] / "state.pt").is_file()


def test_eval_writes_metrics(run_dir, tmp_path):
    from gfnerf_tpu_torch import eval as eval_entry

    out = tmp_path / "eval.json"
    assert eval_entry.main(["--load-config", str(run_dir / "config.json"),
                            "--output-path", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["method_name"] == "gf-nerf-tiny"
    assert doc["experiment_name"] == "tiny"
    assert doc["checkpoint"] == str(run_dir / "nerfstudio_models")
    res = doc["results"]
    assert set(res) == {"psnr", "ssim", "lpips_proxy", "num_rays_per_sec",
                        "fps"}
    assert all(np.isfinite(v) for v in res.values())
    assert 0 < res["psnr"] < 60 and -1 <= res["ssim"] <= 1
    # eval leaves the run's config as it was
    assert json.loads((run_dir / "config.json").read_text())[
        "load_dir"] is None


@pytest.mark.parametrize("traj,extra,frames", [
    ("spiral", ["--spiral-steps", "3"], 3),
    ("interpolate", ["--early-term", "--et-eps", "0.01"], 10),
])
def test_render_writes_png_frames(run_dir, tmp_path, traj, extra, frames):
    from gfnerf_tpu_torch import render

    out = tmp_path / traj
    assert render.main(["--load-config", str(run_dir / "config.json"),
                        "--traj", traj, "--output-path", str(out),
                        "--downscale-factor", "2",
                        "--embedding-indices", "0", "1", *extra]) == 0
    files = sorted(out.glob("*.png"))
    assert [f.name for f in files] == [f"{i:05d}.png" for i in
                                       range(frames)]
    for f in files:
        img = _read_png(f)
        assert img.shape == (12, 16, 3)
    assert _read_png(files[0]).max() > 0


def test_render_refuses_video(run_dir, tmp_path, monkeypatch):
    """Video needs the port's JPEG codec: with its build made to fail (an
    unknown compiler flag) ``--output-format video`` raises before it
    renders and writes no file.  (tests/test_torch_video.py holds the
    video that a working codec writes.)"""
    from gfnerf_tpu_torch import render
    from gfnerf_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "JPEG_LIB_PATH",
                        tmp_path / "build" / "libgfnerf_jpeg.so")
    monkeypatch.setattr(build, "CXX_FLAGS",
                        build.CXX_FLAGS + ["--no-such-flag"])
    build._load_jpeg.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="JPEG codec build failed"):
            render.main(["--load-config", str(run_dir / "config.json"),
                         "--output-format", "video", "--output-path",
                         str(tmp_path / "out")])
    finally:
        build._load_jpeg.cache_clear()
    assert not (tmp_path / "out").exists()


def test_png_writer_round_trip(tmp_path):
    """write_png's file read back by this file's reader and by render's."""
    from gfnerf_tpu_torch.render import read_png, write_png

    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(_read_png(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)


def test_camera_path_reader_matches_jax(tmp_path):
    """The same camera_path.json through the port's reader and the JAX
    package's scripts/render.py."""
    from gfnerf_tpu_torch.render import cameras_from_camera_path
    from scripts.render import cameras_from_camera_path as jax_reader

    rng = np.random.default_rng(4)
    frames = []
    for i in range(4):
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        m[:3, 3] = rng.standard_normal(3)
        frames.append({"camera_to_world": m.reshape(-1).tolist(),
                       "fov": 40.0 + 5 * i})
    path = tmp_path / "camera_path.json"
    path.write_text(json.dumps({"render_height": 24, "render_width": 32,
                                "camera_path": frames}))
    doc = json.loads(path.read_text())
    got, want = cameras_from_camera_path(doc), jax_reader(doc)
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width",
                 "height"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_trajectories_match_jax():
    """spiral_cameras and interpolate_cameras against the JAX package's
    scripts/render.py on the same host cameras."""
    from gfnerf_tpu.data.dataparsers.base import CamerasHost as JCams
    from gfnerf_tpu_torch.data.dataparsers.base import CamerasHost
    from gfnerf_tpu_torch.render import interpolate_cameras, spiral_cameras
    from gfnerf_tpu_torch.utils.synthetic import ring_cameras
    from scripts import render as J

    c2w, fx, fy, cx, cy, w, h = ring_cameras(3, img_wh=(32, 24))
    kw = dict(camera_to_worlds=c2w, fx=np.asarray(fx), fy=np.asarray(fy),
              cx=np.asarray(cx), cy=np.asarray(cy),
              width=np.full(3, w, np.int32), height=np.full(3, h, np.int32))
    for fn, jfn in ((spiral_cameras, J.spiral_cameras),
                    (interpolate_cameras, J.interpolate_cameras)):
        got, want = fn(CamerasHost(**kw)), jfn(JCams(**kw))
        for name in kw:
            np.testing.assert_allclose(getattr(got, name),
                                       np.asarray(getattr(want, name)),
                                       rtol=0, atol=0, err_msg=name)
