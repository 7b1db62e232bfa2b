"""The port's viewer (``gfnerf_tpu_torch/viewer``), the Trainer's viewer
thread and training controls, and the kernel library's lock, on the CPU.

- Every case of tests/test_viewer_path.py against the port: the
  quaternions, ``interpolate_keyframes``/``interpolate_scalars`` and
  ``build_camera_path`` within 1e-12 of the JAX package's (float32 paths:
  equal), the camera path through the port's render script's reader,
  ``TrainControl`` over the port's own HTTP server, ``/scene`` and
  ``/export``, the saved paths, and ``_render`` of a stub pipeline: the
  PNGs' pixels equal to the JAX viewer's for rgb, depth (autoscaled and
  fixed range) and accumulation.
- ``/scene`` of a GF-NeRF pipeline (cameras, the octree's nodes and
  leaves, the blocks' counts) and of a vanilla one (no octree).
- A live ``gf-nerf-tiny`` Trainer with ``vis`` "viewer" over HTTP: pause
  holds the step, resume continues it, a render while training returns a
  finite PNG and never overlaps a step, stop saves the checkpoint of the
  step before the one it stopped on; ``/status`` shows the published step
  and loss; the eval images of depth and accumulation are colormapped.
- ``python -m gfnerf_tpu_torch.viewer`` on that run.
- ``ops/build.library``: threads that ask for the library at once build
  and load it once.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import torch_parity  # noqa: F401  (two CPU threads per worker)


def _lookat_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    return np.concatenate(
        [np.stack([r, u, -f], axis=1), eye[:, None]], axis=1)


KF4 = [[4, 0, 1], [0, 4, 2], [-4, 0, 1], [0, -4, 2]]


def _close(a, b, path="doc"):
    """Nested documents equal, numbers within 1e-12."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-12, (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---- tests/test_viewer_path.py's cases ----


def test_quat_roundtrip_matches_jax():
    from gfnerf_tpu.viewer import server as J
    from gfnerf_tpu_torch.viewer import server as T

    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        m = T._mat_from_quat(q)
        np.testing.assert_allclose(m, J._mat_from_quat(q), rtol=0,
                                   atol=1e-12)
        q2 = T._quat_from_mat(m)
        np.testing.assert_allclose(q2, J._quat_from_mat(m), rtol=0,
                                   atol=1e-12)
        if np.dot(q, q2) < 0:
            q2 = -q2
        np.testing.assert_allclose(q, q2, atol=1e-9)


@pytest.mark.parametrize("n,smooth,loop", [(21, False, False),
                                           (31, True, False),
                                           (40, False, True),
                                           (33, True, True)])
def test_interpolation_matches_jax(n, smooth, loop):
    """The interpolated paths (keyframes hit, rotations rigid) and the
    scalars, against the JAX package's within 1e-12."""
    from gfnerf_tpu.viewer import server as J
    from gfnerf_tpu_torch.viewer import server as T

    k = 3 if n == 21 else 4
    kf = np.stack([_lookat_pose(e) for e in KF4[:k]]).astype(np.float32)
    got = T.interpolate_keyframes(kf, n, smooth=smooth, loop=loop)
    want = J.interpolate_keyframes(kf, n, smooth=smooth, loop=loop)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[0], kf[0], atol=1e-5)
    for m in got:
        np.testing.assert_allclose(m[:3, :3].T @ m[:3, :3], np.eye(3),
                                   atol=1e-5)
    fovs = [40.0, 60.0, 80.0, 50.0][:k]
    np.testing.assert_allclose(
        T.interpolate_scalars(fovs, n, smooth=smooth, loop=loop),
        J.interpolate_scalars(fovs, n, smooth=smooth, loop=loop), rtol=0,
        atol=1e-12)
    if n == 31:   # keyframes at 0, 10, 20, 30; the midpoints bend
        for f, i in ((0, 0), (10, 1), (20, 2), (30, 3)):
            np.testing.assert_allclose(got[f], kf[i], atol=1e-5)
        lin = T.interpolate_keyframes(kf, n)
        assert np.abs(got[5][:, 3] - lin[5][:, 3]).max() > 1e-3


@pytest.mark.parametrize("kw", [
    dict(fps=10, seconds=3.0, fovs=[40.0, 70.0, 55.0], smooth=True,
         loop=True),
    dict(fps=10, seconds=2.0),
    dict(fps=24, seconds=None, orbit_states=[{"az": 0.1}, {"az": 1.0},
                                             {"az": 2.0}])])
def test_camera_path_matches_jax(kw):
    from gfnerf_tpu.viewer import server as J
    from gfnerf_tpu_torch.viewer import server as T

    kf = np.stack([_lookat_pose(e) for e in KF4[:3]])
    got = T.build_camera_path(kf, 320, 240, fov_deg=60.0, **kw)
    _close(got, J.build_camera_path(kf, 320, 240, fov_deg=60.0, **kw))
    assert got["is_cycle"] == bool(kw.get("loop"))


def test_camera_path_reads_back_through_render():
    from gfnerf_tpu_torch.render import cameras_from_camera_path
    from gfnerf_tpu_torch.viewer.server import build_camera_path

    kf = np.stack([_lookat_pose(KF4[0]), _lookat_pose(KF4[1])])
    doc = build_camera_path(kf, width=320, height=240, fov_deg=60.0,
                            fps=24, seconds=1.0)
    assert len(doc["camera_path"]) == 24
    cams = cameras_from_camera_path(json.loads(json.dumps(doc)))
    assert cams.camera_to_worlds.shape == (24, 3, 4)
    np.testing.assert_allclose(cams.camera_to_worlds[0], kf[0], atol=1e-5)
    np.testing.assert_allclose(cams.camera_to_worlds[-1], kf[1], atol=1e-5)
    np.testing.assert_allclose(cams.fx[0], 240 / 2 / np.tan(np.pi / 6),
                               rtol=1e-5)


class _Stub:
    """A pipeline that renders fixed outputs and records its cameras'
    focal length; ``port`` selects the port's ``render_camera``
    signature."""

    def __init__(self, port: bool, h=8, w=12):
        self.port, self.h, self.w = port, h, w
        self.fx = []

    def render_camera(self, cams, *args, **kw):
        self.fx.append(float(cams.fx[0]))
        h, w = self.h, self.w
        depth = np.linspace(2, 9, h * w, dtype=np.float32).reshape(h, w, 1)
        gx, gy = np.meshgrid(np.linspace(0, 1, w), np.linspace(1, 0, h))
        return {"rgb": np.stack([gx, gy, np.full((h, w), 0.5)],
                                -1).astype(np.float32),
                "depth": depth,
                "accumulation": np.linspace(0, 1, h * w, dtype=np.float32)
                .reshape(h, w, 1)}


@pytest.mark.parametrize("req", [
    {}, {"fov": 90.0}, {"output": "depth"},
    {"output": "depth", "cmap_near": 0.0, "cmap_far": 10.0},
    {"output": "accumulation"}])
def test_render_png_matches_jax(req):
    """``_render`` of a stub pipeline: the request's fov reaches the
    camera, and the PNG's pixels equal the JAX viewer's (which imageio
    encodes)."""
    from gfnerf_tpu.viewer.server import ViewerServer as JaxViewer
    from gfnerf_tpu_torch.utils.image_io import decode_png
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    base = {"c2w": np.eye(4)[:3].tolist(), "width": 12, "height": 8}
    jstub, tstub = _Stub(False), _Stub(True)
    want = JaxViewer(jstub, port=0)._render({**base, **req})
    got = ViewerServer(tstub, port=0)._render({**base, **req})
    assert got[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(got), decode_png(want))
    fov = req.get("fov", 60.0)
    np.testing.assert_allclose(tstub.fx, [8 / 2 / np.tan(np.deg2rad(fov)
                                                         / 2)], rtol=1e-6)
    assert tstub.fx == jstub.fx


def test_fixed_depth_range_differs_from_autoscale():
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    server = ViewerServer(_Stub(True), port=0)
    req = {"c2w": np.eye(4)[:3].tolist(), "width": 12, "height": 8,
           "output": "depth"}
    assert server._render(req) != server._render({**req, "cmap_near": 0.0,
                                                  "cmap_far": 10.0})
    assert server._render(req) != server._render({**req, "output": "rgb"})


def _get(url):
    return urllib.request.urlopen(url, timeout=60).read()


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode())
    return urllib.request.urlopen(req, timeout=120).read()


def test_train_control_http_roundtrip():
    """``TrainControl`` through the port's own server on an ephemeral
    port: /status reflects published metrics; /control pause, resume and
    stop; a paused control blocks ``wait_if_paused`` until resumed."""
    from gfnerf_tpu_torch.viewer.server import TrainControl, ViewerServer

    ctl = TrainControl()
    ctl.publish(step=42, loss=0.5, psnr=21.3, rays_per_sec=1e4)
    server = ViewerServer(pipeline=None, port=0, control=ctl).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert server.port != 0
        s = json.loads(_get(base + "/status"))
        assert s["training"] and s["step"] == 42 and not s["paused"]
        assert json.loads(_post(base + "/control", {"action": "pause"}))[
            "ok"] and ctl.paused
        unblocked = []

        def waiter():
            ctl.wait_if_paused(poll_s=0.01)
            unblocked.append(True)

        w = threading.Thread(target=waiter, daemon=True)
        w.start()
        time.sleep(0.08)
        assert not unblocked
        assert json.loads(_post(base + "/control", {"action": "resume"}))[
            "ok"] and not ctl.paused
        w.join(timeout=2)
        assert unblocked
        assert json.loads(_post(base + "/control", {"action": "stop"}))[
            "ok"] and ctl.stop and not ctl.paused
        assert json.loads(_get(base + "/status"))["stopping"]
        assert not json.loads(_post(base + "/control",
                                    {"action": "bogus"}))["ok"]
        assert b"<canvas" in _get(base + "/")
    finally:
        server.shutdown()


def test_status_history_matches_jax():
    from gfnerf_tpu.viewer.server import TrainControl as JaxControl
    from gfnerf_tpu_torch.viewer.server import TrainControl, ViewerServer

    ctl, jctl = TrainControl(), JaxControl()
    for i in range(TrainControl.HISTORY_LEN + 40):
        for c in (ctl, jctl):
            c.publish(step=i, loss=1.0 / (i + 1), rays_per_sec=100.0 + i,
                      note="x" if i % 7 else None)
    assert ctl.snapshot(with_history=True) == \
        jctl.snapshot(with_history=True)
    assert "history" not in ctl.snapshot()
    body = ViewerServer(pipeline=None, port=0, control=ctl)._status(True)
    assert len(json.loads(body)["history"]) == TrainControl.HISTORY_LEN


def test_scene_and_export_endpoints(tmp_path):
    """/scene without a pipeline; /export's command for every mode: the
    port's exporter and the run's config.json (the page's "textured" is
    the exporter's "texture", which the JAX command names as it is)."""
    from gfnerf_tpu.viewer.server import ViewerServer as JaxViewer
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    server = ViewerServer(pipeline=None, port=0, save_dir=tmp_path)
    doc = json.loads(server._scene())
    assert doc == json.loads(JaxViewer(None, port=0)._scene())
    assert doc["cameras"] == [] and doc["octree"] == {}
    for mode, cli in (("pointcloud", "pointcloud"), ("mesh", "mesh"),
                      ("tsdf", "tsdf"), ("textured", "texture"),
                      ("poses", "poses")):
        r = json.loads(server._export_cmd({"mode": mode,
                                           "output_dir": "/tmp/exp"}))
        assert r["ok"], mode
        assert r["command"].startswith(
            f"python -m gfnerf_tpu_torch.export {cli} --load-config "
            f"{tmp_path / 'config.json'} --output-dir /tmp/exp"), r
        assert ("--resolution" in r["command"]) == (
            mode in ("mesh", "tsdf", "textured"))
    assert not json.loads(server._export_cmd({"mode": "nope"}))["ok"]


def test_saved_path_roundtrip_and_name_sanitization(tmp_path):
    from gfnerf_tpu.viewer.server import ViewerServer as JaxViewer
    from gfnerf_tpu.viewer.server import _safe_path_name as jax_safe
    from gfnerf_tpu_torch.viewer.server import ViewerServer, _safe_path_name

    for name in ("../../etc/passwd", "fly-through_2", None, 7, "a" * 80,
                 "x.y z"):
        assert _safe_path_name(name) == jax_safe(name)
    assert _safe_path_name("../../etc/passwd") == "etcpasswd"
    server = ViewerServer(pipeline=None, port=0, save_dir=tmp_path / "t")
    jserver = JaxViewer(pipeline=None, port=0, save_dir=tmp_path / "j")
    kf = np.stack([_lookat_pose(KF4[0]), _lookat_pose(KF4[1])])
    orbit = [{"az": 0.1, "el": 0.2, "radius": 4.0, "target": [0, 0, 0],
              "fov": 50.0},
             {"az": 1.1, "el": 0.3, "radius": 4.0, "target": [0, 0, 0],
              "fov": 70.0}]
    req = {"keyframes": kf.tolist(), "width": 320, "height": 240,
           "fovs": [50.0, 70.0], "orbit_states": orbit,
           "name": "fly/../one"}
    payload = server._camera_path(req)
    assert payload == jserver._camera_path(req)
    doc = json.loads(payload)
    assert doc["orbit_states"] == orbit and len(doc["keyframes"]) == 2
    listed = json.loads(server._camera_paths_list())
    assert listed == json.loads(jserver._camera_paths_list())
    assert listed["paths"] == ["camera_path", "flyone"]
    assert server._camera_path_get("fly/../one") == payload
    with pytest.raises(FileNotFoundError):
        server._camera_path_get("missing")


# ---- real pipelines ----


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    return make_synthetic_npz(tmp_path_factory.mktemp("viewer_scene"),
                              n_train=12, n_val=2, img_wh=(32, 24))


def test_scene_endpoint_of_both_pipeline_kinds(scene, tmp_path):
    """A GF-NeRF pipeline's /scene: its 12 cameras, the octree's nodes and
    valid leaves, and after the camera clustering the blocks' counts; a
    vanilla pipeline's: the cameras and no octree."""
    from gfnerf_tpu_torch.configs.method_configs import (
        gf_nerf_tiny_config, get_method)
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    parser = MinimalDataParser(MinimalDataParserConfig(data=scene))
    p = gf_nerf_tiny_config().pipeline.build(parser, tmp_path / "g",
                                             device="cpu")
    doc = json.loads(ViewerServer(p, port=0)._scene())
    assert "error" not in doc and len(doc["cameras"]) == 12
    assert doc["octree"] == {"n_nodes": p.sampler.tree.n_nodes,
                             "n_leaves": int(p.sampler.oct_dev.n_leaves)}
    assert doc["blocks"] == {} and doc["cameras"][3]["cluster"] is None
    p.sampler.train_cameras_clustering(2)
    doc = json.loads(ViewerServer(p, port=0)._scene())
    labels = p.sampler.cameras_labels
    assert doc["blocks"] == {str(k): int((labels == k).sum())
                             for k in range(2)}
    assert [c["cluster"] for c in doc["cameras"]] == labels.tolist()
    np.testing.assert_array_equal(
        doc["cameras"][5]["c2w"],
        p.datamanager.train_dataparser_outputs.cameras.camera_to_worlds[5])

    cfg = get_method("nerfacto")
    cfg.pipeline.nerfacto.log2_hashmap_size = 10
    v = cfg.pipeline.build(parser, tmp_path / "v", device="cpu")
    doc = json.loads(ViewerServer(v, port=0)._scene())
    assert "error" not in doc and len(doc["cameras"]) == 12
    assert doc["octree"] == {} and doc["blocks"] == {}


@pytest.fixture(scope="module")
def live_run(scene, tmp_path_factory):
    """A gf-nerf-tiny Trainer with ``vis`` "viewer" on an ephemeral port,
    trained from a thread and driven over HTTP: the records."""
    from gfnerf_tpu_torch.configs.method_configs import gf_nerf_tiny_config
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.utils.image_io import decode_png

    cfg = gf_nerf_tiny_config()
    cfg.device = "cpu"
    cfg.data = scene
    cfg.output_dir = tmp_path_factory.mktemp("live")
    cfg.max_num_iterations = 500
    cfg.vis, cfg.viewer_port = "viewer", 0
    cfg.steps_per_log = 1
    cfg.steps_per_eval_image = 3
    cfg.pipeline.datamanager.train_num_rays_per_batch = 128
    cfg.pipeline.model.s3im_patch_height = 8
    trainer = Trainer(cfg, MinimalDataParser(MinimalDataParserConfig(
        data=scene)))
    trainer.setup()
    p = trainer.pipeline
    rec = {"steps": [], "overlaps": 0, "images": {}}
    busy = {"step": False, "render": False}
    step_fn, render_fn = p.get_train_loss_dict, p.render_camera

    def step_w(step):
        busy["step"] = True
        rec["overlaps"] += busy["render"]
        try:
            return step_fn(step)
        finally:
            rec["steps"].append(step)
            busy["step"] = False

    def render_w(*a, **kw):
        busy["render"] = True
        rec["overlaps"] += busy["step"]
        try:
            return render_fn(*a, **kw)
        finally:
            busy["render"] = False

    p.get_train_loss_dict, p.render_camera = step_w, render_w
    put_image = trainer.writer.put_image
    trainer.writer.put_image = lambda name, img, step: (
        rec["images"].setdefault(name, (img, step)), put_image(name, img,
                                                               step))
    base = f"http://127.0.0.1:{trainer.viewer.port}"
    thread = threading.Thread(target=trainer.train, daemon=True)
    thread.start()

    def status():
        return json.loads(_get(base + "/status"))

    def wait_step(n, limit=120.0):
        t0 = time.time()
        while status().get("step", -1) < n:
            assert thread.is_alive() and time.time() - t0 < limit
            time.sleep(0.05)

    c2w = p.datamanager.train_dataparser_outputs.cameras.camera_to_worlds[0]
    req = {"c2w": c2w.tolist(), "width": 32, "height": 24, "downscale": 2}
    try:
        wait_step(2)
        assert json.loads(_post(base + "/control", {"action": "pause"}))[
            "ok"]
        time.sleep(0.5)   # the step in flight ends
        rec["paused_at"] = len(rec["steps"])
        rec["paused_status"] = status()
        time.sleep(1.0)
        rec["after_1s"] = len(rec["steps"])
        rec["paused_png"] = decode_png(_post(base + "/render", req))
        _post(base + "/control", {"action": "resume"})
        wait_step(rec["paused_at"] + 2)
        rec["resumed_at"] = len(rec["steps"])
        rec["live_png"] = decode_png(_post(base + "/render", {
            **req, "output": "depth"}))
        rec["live_status"] = status()
        _post(base + "/control", {"action": "stop"})
        thread.join(timeout=120)
        assert not thread.is_alive()
    finally:
        trainer.viewer.shutdown()
    rec["checkpoints"] = sorted(
        c.name for c in trainer.checkpoint_dir.glob("step-*"))
    rec["run_dir"] = trainer.base_dir
    return rec


def test_live_viewer_pause_resume_stop(live_run):
    rec = live_run
    assert rec["paused_status"]["paused"]
    assert rec["after_1s"] == rec["paused_at"]          # held for 1 s
    assert rec["resumed_at"] >= rec["paused_at"] + 2    # and continued
    # stop: saved at the step before the one it stopped on
    assert rec["steps"] == list(range(len(rec["steps"])))
    assert rec["checkpoints"] == [f"step-{rec['steps'][-1]:09d}"]
    st = rec["live_status"]
    assert st["training"] and st["step"] >= rec["paused_at"]
    assert np.isfinite(st["loss"]) and st["rays_per_sec"] > 0


def test_live_renders_and_lock(live_run):
    """Renders while paused and while training: PNGs of the request's
    size (downscale 2), never inside a train step."""
    for key in ("paused_png", "live_png"):
        img = live_run[key]
        assert img.shape == (12, 16, 3) and img.dtype == np.uint8
    assert live_run["paused_png"].std() > 0
    assert live_run["overlaps"] == 0


def test_live_eval_images_colormapped(live_run):
    from gfnerf_tpu_torch.utils.colormaps import apply_colormap

    images = live_run["images"]
    depth, _ = images["Eval Images/depth"]
    acc, _ = images["Eval Images/accumulation"]
    assert depth.shape[-1] == 3 and acc.shape[-1] == 3
    assert depth.min() >= 0 and depth.max() <= 1
    lut = apply_colormap(np.linspace(0, 1, 4096).reshape(64, 64))
    # every accumulation pixel is a colour of the map
    d = np.abs(acc.reshape(-1, 1, 3) - lut.reshape(1, -1, 3)).sum(-1)
    assert d.min(axis=1).max() < 1e-2


def test_viewer_entry_point(live_run, monkeypatch):
    """``python -m gfnerf_tpu_torch.viewer`` on the run: the server it
    would serve holds the checkpoint's pipeline, the cameras' mean radius
    and the run directory."""
    from gfnerf_tpu_torch.viewer import __main__ as main_mod
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    served = []
    monkeypatch.setattr(ViewerServer, "serve_forever",
                        lambda self: served.append(self))
    run = live_run["run_dir"]
    assert main_mod.main(["--load-config", str(run / "config.json"),
                          "--port", "0"]) == 0
    (server,) = served
    assert server.save_dir == run
    cams = server.pipeline.datamanager.train_dataparser_outputs.cameras
    np.testing.assert_allclose(
        server.default_radius,
        np.linalg.norm(cams.camera_to_worlds[:, :, 3], axis=1).mean())
    # the checkpoint of the last step run: its count of steps taken
    assert server.pipeline.state.step == live_run["steps"][-1] + 1
    assert len(json.loads(server._scene())["cameras"]) == 12


# ---- the kernel library's lock ----


def test_library_loads_once_across_threads(monkeypatch):
    from gfnerf_tpu_torch.ops import build

    builds = []

    def slow_build(verbose=False):
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return {"built": True, "seconds": 0.2, "log": ""}

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            object.__setattr__(self, name, fn)
            return fn

    monkeypatch.setattr(build, "_build_library", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    build._load.cache_clear()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(
            build.library())) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1 and len(got) == 16
        assert all(lib is got[0] for lib in got)
    finally:
        sys.setswitchinterval(switch)
        build._load.cache_clear()
