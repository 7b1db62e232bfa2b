"""The port's capture converters (``gfnerf_tpu_torch/process_data/
converters.py``) and ``python -m gfnerf_tpu_torch.process_data`` against
the JAX package's converters and ``scripts/process_data.py`` on the CPU.

- Every case of tests/test_converters.py, with PNG fixtures: the written
  ``transforms.json`` equal to the JAX one byte for byte (polycam,
  record3d, metashape with and without a component transform,
  realitycapture with the image sizes given and read from the files: PNG,
  and a cv2 JPEG whose size the port reads from its header where the JAX
  package decodes it), the summaries equal, the insta360 frame pipelines'
  PNGs equal to the JAX ones' pixels.
- Video: without ffmpeg on PATH the video paths raise and name it; with a
  stand-in ``ffmpeg`` (a script that decodes with cv2, the test side's
  decoder) the insta360 video path and the ``video`` mode give the JAX
  package's frames, pixel for pixel.
- A JPEG frame whose pixels the insta360 pipeline needs raises and names
  the file.
- The entry point in the polycam, record3d, metashape, realitycapture and
  insta360-images modes: the JAX script's files.
"""

from __future__ import annotations

import csv
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (two CPU threads per worker)

REPO = Path(__file__).resolve().parent.parent


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "process_data_script", REPO / "scripts" / "process_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _png(path, arr):
    from gfnerf_tpu_torch.utils.image_io import write_png

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png(path, np.asarray(arr, np.uint8))


def _same_transforms(a: Path, b: Path):
    assert (a / "transforms.json").read_bytes() == \
        (b / "transforms.json").read_bytes()


def _same_pngs(a: Path, b: Path, n: int):
    from gfnerf_tpu_torch.utils.image_io import read_png

    fa, fb = sorted(a.glob("*.png")), sorted(b.glob("*.png"))
    assert [f.name for f in fa] == [f.name for f in fb] and len(fa) == n
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(read_png(x), read_png(y), x.name)


def _polycam_capture(root: Path, n=3):
    cams = root / "keyframes" / "cameras"
    cams.mkdir(parents=True)
    imgs = []
    rng = np.random.default_rng(0)
    for i in range(n):
        img = root / "keyframes" / "images" / f"frame_{i}.png"
        _png(img, rng.integers(0, 255, (6, 8, 3)))
        imgs.append(img)
        j = {"fx": 600.0, "fy": 601.5, "cx": 360.0, "cy": 480.0,
             "width": 720, "height": 960,
             "blur_score": 5.0 if i == 1 else 100.0}
        for r in range(3):
            for c in range(4):
                j[f"t_{r}{c}"] = float(rng.normal())
        (cams / f"frame_{i}.json").write_text(json.dumps(j))
    return imgs, cams


def test_polycam_matches_jax(tmp_path):
    from gfnerf_tpu.process_data.converters import polycam_to_json as J
    from gfnerf_tpu_torch.process_data.converters import polycam_to_json

    imgs, cams = _polycam_capture(tmp_path / "cap")
    depth = [tmp_path / f"d{i}.png" for i in range(3)]
    for kw in ({}, {"depth_filenames": depth}):
        got = polycam_to_json(imgs, cams, tmp_path / "t", min_blur_score=25,
                              crop_border_pixels=15, **kw)
        want = J(imgs, cams, tmp_path / "j", min_blur_score=25,
                 crop_border_pixels=15, **kw)
        assert got == want and any("Skipped 1" in s for s in got)
        _same_transforms(tmp_path / "t", tmp_path / "j")
    with pytest.raises(RuntimeError, match="blur"):
        polycam_to_json(imgs[1:2], cams, tmp_path / "x")


def test_record3d_matches_jax(tmp_path):
    from gfnerf_tpu.process_data.converters import record3d_to_json as J
    from gfnerf_tpu_torch.process_data.converters import record3d_to_json

    rng = np.random.default_rng(1)
    n = 5
    q = rng.normal(size=(n, 4))
    poses = np.concatenate([q, rng.normal(size=(n, 3))], 1).tolist()
    K = np.array([[500.0, 0, 0], [0, 500, 0], [320, 240, 1]])
    meta = {"poses": poses, "K": K.reshape(-1).tolist(), "w": 640, "h": 480}
    mp = tmp_path / "metadata.json"
    mp.write_text(json.dumps(meta))
    imgs = [Path(f"images/frame_{i:05d}.png") for i in range(3)]
    idx = np.array([0, 2, 4])
    assert record3d_to_json(imgs, mp, tmp_path / "t", idx) == \
        J(imgs, mp, tmp_path / "j", idx) == 3
    _same_transforms(tmp_path / "t", tmp_path / "j")


METASHAPE = """<?xml version="1.0"?>
<document><chunk>
  <sensors>
    <sensor id="0" type="frame">
      <resolution width="100" height="80"/>
      <calibration><f>90.5</f><cx>1.5</cx><k1>0.01</k1><p2>-0.002</p2>
      </calibration>
    </sensor>
  </sensors>
  {components}
  <cameras>
    <camera label="img0" sensor_id="0" {cid}>
      <transform>1 0 0 2 0 1 0 3 0 0 1 4 0 0 0 1</transform>
    </camera>
    <camera label="img1.png" sensor_id="0" {cid}>
      <transform>0 -1 0 1 1 0 0 -2 0 0 1 0.5 0 0 0 1</transform>
    </camera>
    <camera label="img2" sensor_id="0"/>
    <camera label="absent" sensor_id="0">
      <transform>1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</transform>
    </camera>
  </cameras>
</chunk></document>"""
COMPONENT = """<components><component id="0"><transform>
  <rotation>0 -1 0 1 0 0 0 0 1</rotation>
  <translation>1 2 3</translation><scale>2.0</scale>
</transform></component></components>"""


@pytest.mark.parametrize("component", [False, True])
def test_metashape_matches_jax(tmp_path, component):
    from gfnerf_tpu.process_data.converters import metashape_to_json as J
    from gfnerf_tpu_torch.process_data.converters import metashape_to_json

    xp = tmp_path / "cameras.xml"
    xp.write_text(METASHAPE.format(
        components=COMPONENT if component else "",
        cid='component_id="0"' if component else ""))
    fmap = {f"img{i}": Path(f"images/img{i}.png") for i in range(3)}
    got = metashape_to_json(fmap, xp, tmp_path / "t")
    assert got == J(fmap, xp, tmp_path / "j")
    assert any("1 images skipped" in s for s in got)
    _same_transforms(tmp_path / "t", tmp_path / "j")


def _rc_csv(path, names):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "#name", "x", "y", "alt", "heading", "pitch", "roll", "f",
            "px", "py", "k1", "k2", "k3", "k4", "t1", "t2"])
        w.writeheader()
        for i, name in enumerate(names):
            w.writerow({"#name": name, "x": 1 + i, "y": 2, "alt": 3,
                        "heading": 10 * i, "pitch": 5, "roll": -3 * i,
                        "f": 36 + i, "px": 0.1 * i, "py": -0.2, "k1": 0.01,
                        "k2": 0, "k3": 0, "k4": 0, "t1": 0.001, "t2": 0})


@pytest.mark.parametrize("sizes", ["given", "png", "jpeg"])
def test_realitycapture_matches_jax(tmp_path, sizes):
    """The image sizes given, or read from the files: a PNG's header, and
    a JPEG's start-of-frame segment where the JAX package decodes it with
    cv2."""
    from gfnerf_tpu.process_data.converters import \
        realitycapture_to_json as J
    from gfnerf_tpu_torch.process_data.converters import \
        realitycapture_to_json

    ext = ".jpg" if sizes == "jpeg" else ".png"
    cp = tmp_path / "poses.csv"
    _rc_csv(cp, [f"a{ext}", f"b{ext}", f"missing{ext}"])
    fmap = {k: Path(f"images/{k}{ext}") for k in ("a", "b")}
    kw = {}
    for out in ("t", "j"):
        for k, (w, h) in (("a", (72, 54)), ("b", (40, 30))):
            path = tmp_path / out / "images" / f"{k}{ext}"
            img = np.random.default_rng(0).integers(0, 255, (h, w, 3))
            if sizes == "jpeg":
                cv2 = pytest.importorskip("cv2")
                path.parent.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(path), img.astype(np.uint8))
            else:
                _png(path, img)
    if sizes == "given":
        kw["image_sizes"] = {"a": (72, 54), "b": (40, 30)}
    got = realitycapture_to_json(fmap, cp, tmp_path / "t", **kw)
    assert got == J(fmap, cp, tmp_path / "j", **kw)
    assert any("Missing image data for 1" in s for s in got)
    _same_transforms(tmp_path / "t", tmp_path / "j")
    frame = json.loads((tmp_path / "t" / "transforms.json").read_text())[
        "frames"][0]
    assert (frame["w"], frame["h"]) == (72, 54)


def _frames(root: Path, n, shape, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = rng.integers(0, 255, shape)
        _png(root / f"f_{i:03d}.png", a)
        out.append(a)
    return out


@pytest.mark.parametrize("target", [8, 5, 100])
def test_insta360_two_file_frames_match_jax(tmp_path, target):
    from gfnerf_tpu.process_data.converters import \
        insta360_frames_to_images as J
    from gfnerf_tpu_torch.process_data.converters import \
        insta360_frames_to_images

    fronts = _frames(tmp_path / "front", 8, (80, 100, 3), 0)
    _frames(tmp_path / "back", 8, (80, 100, 3), 1)
    args = (sorted((tmp_path / "front").iterdir()),
            sorted((tmp_path / "back").iterdir()))
    got = insta360_frames_to_images(*args, tmp_path / "t", target)
    assert got == J(*args, tmp_path / "j", target)
    n = len(list((tmp_path / "j").glob("*.png")))
    _same_pngs(tmp_path / "t", tmp_path / "j", n)
    if target == 8:   # frames 0, 2, 4, 6 of each lens
        from gfnerf_tpu_torch.utils.image_io import read_png

        np.testing.assert_array_equal(
            read_png(tmp_path / "t" / "frame_00001.png"),
            np.rot90(fronts[0][12:68, 15:85], 1))


def test_insta360_single_file_frames_match_jax(tmp_path):
    from gfnerf_tpu.process_data.converters import \
        insta360_single_frames_to_images as J
    from gfnerf_tpu_torch.process_data.converters import \
        insta360_single_frames_to_images

    _frames(tmp_path / "src", 3, (200, 400, 3), 2)
    # grey and RGBA frames become RGB as PIL's convert("RGB") makes them
    _png(tmp_path / "src" / "f_003.png",
         np.random.default_rng(3).integers(0, 255, (200, 400)))
    _png(tmp_path / "src" / "f_004.png",
         np.random.default_rng(4).integers(0, 255, (200, 400, 4)))
    frames = sorted((tmp_path / "src").iterdir())
    got = insta360_single_frames_to_images(frames, tmp_path / "t", 10)
    assert got == J(frames, tmp_path / "j", 10)
    _same_pngs(tmp_path / "t", tmp_path / "j", 10)


def test_jpeg_frame_refused_with_its_name(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu_torch.process_data.converters import \
        insta360_single_frames_to_images

    path = tmp_path / "src" / "frame.jpg"
    path.parent.mkdir()
    cv2.imwrite(str(path), np.zeros((20, 40, 3), np.uint8))
    with pytest.raises(ValueError, match="frame.jpg.*PNG"):
        insta360_single_frames_to_images([path], tmp_path / "out", 2)


def test_tool_dependent_paths_gated(tmp_path, monkeypatch):
    """Without the hloc package, and without ffmpeg on PATH, the tool paths
    raise and name the tool (the JAX package's gates)."""
    from gfnerf_tpu_torch.process_data import __main__ as cli
    from gfnerf_tpu_torch.process_data.converters import (hloc_to_json,
                                                          insta360_to_images)

    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="hloc is not available"):
        hloc_to_json(tmp_path, tmp_path / "out")
    with pytest.raises(RuntimeError, match="ffmpeg"):
        insta360_to_images(tmp_path / "a.insv", tmp_path / "b.insv",
                           tmp_path / "images", 10)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        cli.main(["video", "--data", str(tmp_path / "v.mp4"),
                  "--output-dir", str(tmp_path / "o")])


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    """An ``ffmpeg`` on PATH that decodes every frame with cv2 into the
    output pattern (the test side's decoder; the port only calls the
    program)."""
    pytest.importorskip("cv2")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    script = bin_dir / "ffmpeg"
    script.write_text(f"""#!{sys.executable}
import sys, cv2
args = sys.argv[1:]
cap = cv2.VideoCapture(args[args.index("-i") + 1])
i = 0
while True:
    ok, frame = cap.read()
    if not ok:
        break
    i += 1
    cv2.imwrite(args[-1] % i, frame)
sys.exit(0 if i else 1)
""")
    script.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")


def _videos(tmp_path, n=6):
    import cv2

    rng = np.random.default_rng(3)
    vids = {}
    for name in ("front", "back"):
        path = str(tmp_path / f"{name}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                            (96, 80))
        assert w.isOpened(), "cv2 VideoWriter lacks mp4v support"
        for _ in range(n):
            base = rng.integers(40, 200, (1, 1, 3))
            w.write(np.tile(base, (80, 96, 1)).astype(np.uint8))
        w.release()
        vids[name] = Path(path)
    return vids


def test_insta360_video_matches_jax(tmp_path, fake_ffmpeg):
    from gfnerf_tpu.process_data.converters import insta360_to_images as J
    from gfnerf_tpu_torch.process_data.converters import insta360_to_images

    vids = _videos(tmp_path)
    for back in (vids["back"], None):
        got = insta360_to_images(vids["front"], back, tmp_path / "t", 6)
        assert got == J(vids["front"], back, tmp_path / "j", 6)
        _same_pngs(tmp_path / "t", tmp_path / "j", 6)


def test_video_mode_matches_jax(tmp_path, fake_ffmpeg):
    from gfnerf_tpu_torch.process_data import __main__ as cli

    vids = _videos(tmp_path, n=9)
    for target in (4, 30):
        args = ["video", "--data", str(vids["front"]),
                "--num-frames-target", str(target)]
        assert cli.main(args + ["--output-dir", str(tmp_path / "t")]) == 0
        _jax_script().main(args + ["--output-dir", str(tmp_path / "j")])
        n = len(list((tmp_path / "j" / "images").glob("*.png")))
        assert n == (5 if target == 4 else 9)
        _same_pngs(tmp_path / "t" / "images", tmp_path / "j" / "images", n)


@pytest.mark.parametrize("mode", ["polycam", "record3d", "metashape",
                                  "realitycapture", "insta360-images"])
def test_entry_point_matches_jax_script(tmp_path, mode):
    from gfnerf_tpu_torch.process_data import __main__ as cli

    data = tmp_path / "data"
    extra = []
    if mode == "polycam":
        _polycam_capture(data)
    elif mode == "record3d":
        _frames(data, 4, (6, 8, 3), 5)
        meta = {"poses": np.random.default_rng(6).normal(size=(4, 7))
                .tolist(), "K": [500.0, 0, 0, 0, 500, 0, 32, 24, 1],
                "w": 64, "h": 48}
        (tmp_path / "meta.json").write_text(json.dumps(meta))
        extra = ["--metadata", str(tmp_path / "meta.json")]
    elif mode == "metashape":
        for i in range(3):
            _png(data / f"img{i}.png", np.zeros((4, 4, 3)))
        (tmp_path / "cameras.xml").write_text(METASHAPE.format(
            components="", cid=""))
        extra = ["--metadata", str(tmp_path / "cameras.xml")]
    elif mode == "realitycapture":
        for k, (w, h) in (("a", (72, 54)), ("b", (40, 30))):
            _png(data / f"{k}.png", np.zeros((h, w, 3)))
        _rc_csv(tmp_path / "poses.csv", ["a.png", "b.png"])
        extra = ["--metadata", str(tmp_path / "poses.csv")]
    else:
        _frames(data / "front", 4, (40, 50, 3), 7)
        _frames(data / "back", 4, (40, 50, 3), 8)
        extra = ["--num-frames-target", "4"]
    args = [mode, "--data", str(data), *extra]
    assert cli.main(args + ["--output-dir", str(tmp_path / "t")]) == 0
    _jax_script().main(args + ["--output-dir", str(tmp_path / "j")])
    if mode == "insta360-images":
        _same_pngs(tmp_path / "t" / "images", tmp_path / "j" / "images", 4)
    else:
        _same_transforms(tmp_path / "t", tmp_path / "j")
        assert sorted(p.name for p in (tmp_path / "t" / "images").iterdir()
                      ) == sorted(p.name for p in
                                  (tmp_path / "j" / "images").iterdir())
