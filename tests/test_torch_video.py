"""``render --output-format video`` and the port's MP4 writer on the CPU.

- A tiny ``gf-nerf-tiny`` run in each package (4 steps on the synthetic
  npz scene, as tests/test_torch_entry_points.py builds runs; the JAX one
  through ``scripts/train.py`` and ``scripts/render.py`` in a process of
  its own, tests/torch_render_ref.py), each rendered along its spiral (3
  frames at half size) as a video and as PNG frames.  ``cv2.VideoCapture``
  reads both videos with the same frame count and size at 24 fps, and
  every frame of the port's video is at least as close to the port's own
  PNG frame (PSNR) as the JAX video's frame is to the JAX PNG frame.
- The port's file, box by box (``utils/video.read_mp4``): ``ftyp``,
  ``mdat``, ``moov``; an ``mp4v`` entry whose ``esds`` names JPEG (0x6C);
  24 fps; one sample a frame, each decoding through the port's codec to
  the PNG frame's size.
- ``write_mp4`` with imageio, cv2 and PIL out of reach; ``co64`` in place
  of ``stco`` past the offset limit; frames of two sizes and an empty video
  refused.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (two CPU threads per worker)

from torch_render_ref import RENDER_ARGS, TRAIN_OVERRIDES

STEPS = 4
FRAMES = 3


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse)) if mse > 0 else np.inf


def _frames(path: Path):
    """(RGB frames, fps) of a video through cv2."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    assert cap.isOpened(), path
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    assert count == len(frames), (count, len(frames))
    return frames, fps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port": dir, "jax": dir}, each with video/render.mp4 and
    images/*.png."""
    pytest.importorskip("cv2")
    from gfnerf_tpu_torch import render, train
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    tmp = tmp_path_factory.mktemp("video")
    scene = make_synthetic_npz(tmp / "scene", n_train=12, n_val=2,
                               img_wh=(32, 24))
    script = Path(__file__).with_name("torch_render_ref.py")
    jax = subprocess.Popen(
        [sys.executable, str(script), str(scene), str(tmp / "jax"),
         str(STEPS)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    port = tmp / "port"
    overrides = [a.lstrip("-") + "=" + b for a, b in
                 zip(TRAIN_OVERRIDES[::2], TRAIN_OVERRIDES[1::2])]
    assert train.main([
        "gf-nerf-tiny", "--data", str(scene), "--device", "cpu",
        "--output-dir", str(port / "run"), "--experiment-name", "tiny",
        "--max-num-iterations", str(STEPS), "--vis", "local",
        *overrides]) == 0
    (config,) = (port / "run").glob("tiny/gf-nerf-tiny/*/config.json")
    for fmt in ("video", "images"):
        assert render.main(["--load-config", str(config), "--output-format",
                            fmt, "--output-path", str(port / fmt),
                            *RENDER_ARGS]) == 0
    log, _ = jax.communicate(timeout=600)
    assert jax.returncode == 0, log.decode()[-4000:]
    return {"port": port, "jax": tmp / "jax"}


def test_render_video_matches_jax_script(runs):
    from gfnerf_tpu_torch.utils.image_io import read_png

    psnr = {}
    for pkg, root in runs.items():
        frames, fps = _frames(root / "video" / "render.mp4")
        pngs = [read_png(f) for f in sorted((root / "images").glob(
            "*.png"))]
        assert len(frames) == len(pngs) == FRAMES, pkg
        assert fps == 24.0, pkg
        assert all(f.shape == p.shape == (12, 16, 3)
                   for f, p in zip(frames, pngs)), pkg
        psnr[pkg] = [_psnr(f, p) for f, p in zip(frames, pngs)]
    assert all(p >= j for p, j in zip(psnr["port"], psnr["jax"])), psnr


def test_render_video_boxes(runs):
    from gfnerf_tpu_torch.utils.image_io import read_png
    from gfnerf_tpu_torch.utils.jpeg import decode_jpeg
    from gfnerf_tpu_torch.utils.video import read_mp4

    info = read_mp4(runs["port"] / "video" / "render.mp4")
    assert info["top"] == [b"ftyp", b"mdat", b"moov"]
    assert (info["codec"], info["object_type"]) == ("mp4v", 0x6C)
    assert (info["width"], info["height"], info["fps"]) == (16, 12, 24.0)
    assert info["deltas"] == [1000] * FRAMES
    pngs = sorted((runs["port"] / "images").glob("*.png"))
    assert len(info["samples"]) == len(pngs) == FRAMES
    for sample, png in zip(info["samples"], pngs):
        want = read_png(png)
        got = decode_jpeg(sample)
        assert got.shape == want.shape
        assert _psnr(got, want) > 30.0


def _ramp_frames(n=5, h=24, w=40):
    y, x = np.mgrid[0:h, 0:w]
    return [np.clip(np.stack([128 + 100 * np.sin(x / 6.0 + i + c)
                              * np.cos(y / 5.0) for c in range(3)], -1),
                    0, 255).astype(np.uint8) for i in range(n)]


def test_write_mp4_without_image_libraries(tmp_path, monkeypatch):
    """The writer, the reader and the codec with imageio, cv2 and PIL out
    of reach (the card's machine has none of them); cv2 reads the file
    afterwards."""
    from gfnerf_tpu_torch.utils.jpeg import decode_jpeg
    from gfnerf_tpu_torch.utils.video import read_mp4, write_mp4

    frames = _ramp_frames()
    with monkeypatch.context() as m:
        for name in ("imageio", "imageio.v2", "cv2", "PIL", "PIL.Image"):
            m.setitem(sys.modules, name, None)
        write_mp4(tmp_path / "a.mp4", frames, fps=24)
        info = read_mp4(tmp_path / "a.mp4")
        decoded = [decode_jpeg(s) for s in info["samples"]]
    assert len(decoded) == len(frames)
    assert all(_psnr(d, f) > 38.0 for d, f in zip(decoded, frames))
    pytest.importorskip("cv2")
    got, fps = _frames(tmp_path / "a.mp4")
    assert fps == 24.0 and len(got) == len(frames)
    assert all(_psnr(g, f) > 35.0 for g, f in zip(got, frames))


def test_co64_past_the_offset_limit(tmp_path, monkeypatch):
    """Chunk offsets past the limit go into ``co64``; the reader and cv2
    read that file as they read the ``stco`` one."""
    from gfnerf_tpu_torch.utils import video

    frames = _ramp_frames(3)
    video.write_mp4(tmp_path / "small.mp4", frames)
    monkeypatch.setattr(video, "STCO_LIMIT", 64)
    video.write_mp4(tmp_path / "big.mp4", frames)
    small = video.read_mp4(tmp_path / "small.mp4")
    big = video.read_mp4(tmp_path / "big.mp4")
    assert b"stco" in (tmp_path / "small.mp4").read_bytes()
    assert b"co64" in (tmp_path / "big.mp4").read_bytes()
    assert small["samples"] == big["samples"]
    pytest.importorskip("cv2")
    a, _ = _frames(tmp_path / "small.mp4")
    b, _ = _frames(tmp_path / "big.mp4")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_mp4_writer_refusals(tmp_path):
    from gfnerf_tpu_torch.utils.video import Mp4Writer

    frames = _ramp_frames(2)
    w = Mp4Writer(tmp_path / "a.mp4")
    w.add(frames[0])
    with pytest.raises(ValueError, match="frame of"):
        w.add(frames[0][:-2])
    w.close()
    with pytest.raises(ValueError, match="no frame"):
        Mp4Writer(tmp_path / "b.mp4").close()
