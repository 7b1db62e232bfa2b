"""The six capture parsers, COLMAP's readers, image sizes and the gf-nerf
knobs of the port (gradient clipping, image scale, the loss switches, the
semantic sampler) against the JAX package on the CPU.

- Parsers: scannet, sdfstudio, phototourism, sitcoms3d, arkitscenes and
  nuscenes, each on tests/test_extra_parsers.py's fixture (cv2 JPEGs,
  scannet's non-finite pose skipped, nuscenes' ``data``/``data_dir`` pair)
  and on the port's own writer (``synthetic.CAPTURE_FIXTURES``, PNGs with
  depth, normals and masks), for train and val: poses, intrinsics, sizes,
  file lists, metadata, scale and transform exactly equal; the first
  image as the JAX dataset loads it, exactly.
- ``process_data/colmap_utils``: both packages' readers give the same
  models from binary and text files, and ``colmap_to_json`` the same file.
- ``image_io.jpeg_size`` against ``cv2.imread`` on baseline, progressive,
  grey and restart-marker JPEGs and one with EXIF: exact.
- ``resize_area`` above scale 1 against ``cv2.INTER_AREA``: 1e-5 (measured
  1.2e-7).
- ``max_norm``: each group's Adam moments and updates against optax's
  ``clip_by_global_norm`` inside the JAX ``build_optimizer`` over seven
  steps, some clipped and some not: 1e-6 relative (the clipped gradients
  are read from the first moment); a NaN gradient skips the update.
- The loss switches (``use_ch_loss=False``, ``s3im_loss_mult``,
  ``s3im_kernel_size``, ``s3im_stride``, ``s3im_repeat_time``): one train
  step against the JAX step with its permutations injected: the losses to
  1e-5 relative, the MLP gradients as tests/test_torch_train.py holds
  them (rtol 1e-3, atol 1e-3 of the largest).
- ``camera_res_scale_factor=0.5``: the datamanager's images against the
  JAX datamanager's cv2 resize, 1e-5; the cameras scaled with them, unlike
  the JAX package's.
- ``semantic_sample_weights``: the focal split's batches equal to the JAX
  package's class-weighted sampler's.
"""

from __future__ import annotations

import json
import math
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)
from torch_parity import to_np

FORMATS = ("scannet", "sdfstudio", "phototourism", "sitcoms3d",
           "arkitscenes", "nuscenes")


def _jpeg(path, w=8, h=6, seed=0):
    """tests/test_extra_parsers.py's image: random colours written by cv2
    (a JPEG where the name says .jpg)."""
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    img = (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)
    cv2.imwrite(str(path), img)


def _pose(i, n=8, radius=4.0):
    """tests/test_extra_parsers.py's ring pose looking at the origin."""
    a = 2 * np.pi * i / n
    c = np.array([radius * np.cos(a), radius * np.sin(a), 1.5])
    z = c / np.linalg.norm(c)
    x = np.cross(np.array([0, 0, 1.0]), z)
    x /= np.linalg.norm(x) + 1e-9
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, c
    return m


# ---- tests/test_extra_parsers.py's fixtures (data, parser config) ----


def _scannet_jax(root):
    for i in range(6):
        _jpeg(root / "color" / f"{i}.jpg")
        _jpeg(root / "depth" / f"{i}.png")
    (root / "pose").mkdir()
    for i in range(6):
        np.savetxt(root / "pose" / f"{i}.txt", _pose(i, 6))
    np.savetxt(root / "pose" / "5.txt", np.full((4, 4), np.inf))
    (root / "intrinsic").mkdir()
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt",
               np.array([[500.0, 0, 4], [0, 500, 3], [0, 0, 1]]))
    return root, {}


def _sdfstudio_jax(root):
    frames = []
    for i in range(5):
        _jpeg(root / f"{i:06d}_rgb.png")
        frames.append({
            "rgb_path": f"{i:06d}_rgb.png",
            "intrinsics": [[400.0, 0, 4, 0], [0, 400, 3, 0], [0, 0, 1, 0],
                           [0, 0, 0, 1]],
            "camtoworld": _pose(i, 5).tolist()})
    (root / "meta_data.json").write_text(json.dumps({
        "frames": frames, "height": 6, "width": 8, "has_mono_prior": False,
        "scene_box": {"aabb": [[-1, -1, -1], [1, 1, 1]]}}))
    return root, {}


def _phototourism_jax(root):
    sparse = root / "dense" / "sparse"
    sparse.mkdir(parents=True)
    n = 5
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for cid in range(1, n + 1):
            f.write(struct.pack("<iiQQ", cid, 1, 8, 6))  # PINHOLE
            f.write(struct.pack("<4d", 400.0, 410.0, 4.0, 3.0))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for iid in range(1, n + 1):
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<4d", 1.0, 0, 0, 0))
            f.write(struct.pack("<3d", 0.1 * iid, 0.0, 1.0))
            f.write(struct.pack("<i", iid))
            f.write(f"im_{iid}.jpg".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    for iid in range(1, n + 1):
        _jpeg(root / "dense" / "images" / f"im_{iid}.jpg")
    return root, {}


def _sitcoms3d_jax(root):
    frames = []
    for i in range(4):
        name = f"f{i}.jpg"
        _jpeg(root / "images_4" / name)
        frames.append({"image_name": name,
                       "intrinsics": [[320.0, 0, 4], [0, 320, 3], [0, 0, 1]],
                       "camtoworld": _pose(i, 4).tolist()})
    (root / "cameras.json").write_text(json.dumps(
        {"frames": frames, "bbox": [[-2, -2, -1], [2, 2, 3]]}))
    (root / "panoptic_classes.json").write_text(json.dumps(
        {"thing": ["person", "chair"], "thing_colors": [[220, 20, 60],
                                                        [0, 0, 142]]}))
    return root, {"include_semantics": True}


def _arkitscenes_jax(root):
    root = root / "40753679"   # a numeric video id, as in the dataset
    vid = root.name
    frames_dir = root / f"{vid}_frames"
    n = 4
    lines = []
    for i in range(n):
        t = 1.001 + 0.1 * i
        _jpeg(frames_dir / "lowres_wide" / f"{vid}_{t:.3f}.png")
        _jpeg(frames_dir / "lowres_depth" / f"{vid}_{t:.3f}.png")
        (frames_dir / "lowres_wide_intrinsics").mkdir(parents=True,
                                                      exist_ok=True)
        np.savetxt(frames_dir / "lowres_wide_intrinsics" /
                   f"{vid}_{t:.3f}.pincam",
                   np.array([8.0, 6.0, 300.0, 300.0, 4.0, 3.0])[None])
        w2c = np.linalg.inv(_pose(i, n))
        rot = w2c[:3, :3]
        theta = np.arccos(np.clip((np.trace(rot) - 1) / 2, -1, 1))
        rvec = (np.zeros(3) if theta < 1e-8 else
                theta / (2 * np.sin(theta)) * np.array(
                    [rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0],
                     rot[1, 0] - rot[0, 1]]))
        lines.append(" ".join(map(str, [t, *rvec, *w2c[:3, 3]])))
    (frames_dir / "lowres_wide.traj").write_text("\n".join(lines) + "\n")
    return root, {}


def _nuscenes_jax(root):
    v = root / "v1.0-mini"
    v.mkdir()
    n = 4
    egos, sds = [], []
    for i in range(n):
        egos.append({"token": f"ep{i}", "rotation": [1, 0, 0, 0],
                     "translation": [i * 1.0, 0, 0]})
        fn = f"samples/CAM_FRONT/img_{i}.jpg"
        _jpeg(root / fn)
        sds.append({"token": f"sd{i}", "sample_token": f"sa{i}",
                    "calibrated_sensor_token": "cs0",
                    "ego_pose_token": f"ep{i}", "is_key_frame": True,
                    "filename": fn})
    tables = {
        "scene": [{"token": "sc0", "name": "scene-0001"}],
        "sample": [{"token": f"sa{i}", "scene_token": "sc0", "timestamp": i}
                   for i in range(n)],
        "sample_data": sds,
        "calibrated_sensor": [{
            "token": "cs0", "sensor_token": "se0", "rotation": [1, 0, 0, 0],
            "translation": [0.5, 0, 1.6],
            "camera_intrinsic": [[800.0, 0, 4], [0, 800, 3], [0, 0, 1]]}],
        "ego_pose": egos,
        "sensor": [{"token": "se0", "channel": "CAM_FRONT"}]}
    for name, rows in tables.items():
        (v / f"{name}.json").write_text(json.dumps(rows))
    return Path("scene-0001"), {"data_dir": root, "mask_dir": root}


JAX_FIXTURES = {"scannet": _scannet_jax, "sdfstudio": _sdfstudio_jax,
                "phototourism": _phototourism_jax,
                "sitcoms3d": _sitcoms3d_jax,
                "arkitscenes": _arkitscenes_jax, "nuscenes": _nuscenes_jax}


def _port_fixture(fmt, root):
    """The port's writer at 10 views of 16x12 (sdfstudio auto-oriented,
    sitcoms3d with its semantics, nuscenes with masks)."""
    from gfnerf_tpu_torch.utils.synthetic import (CAPTURE_FIXTURES,
                                                  NUSCENES_SCENE)

    data = CAPTURE_FIXTURES[fmt](root, 10, (16, 12), 14.0)
    extra = {"sdfstudio": {"auto_orient": True},
             "sitcoms3d": {"include_semantics": True},
             "nuscenes": {"data_dir": data, "mask_dir": data}}.get(fmt, {})
    if fmt == "nuscenes":
        data = Path(NUSCENES_SCENE)
    return data, extra


def _parser_pair(fmt, data, extra):
    """(the port's parser, the JAX package's) of ``fmt`` on ``data``, the
    configs' ``extra`` fields set in both."""
    from gfnerf_tpu.data.dataparsers import registry as jax_registry
    from gfnerf_tpu_torch.data.dataparsers import registry

    out = []
    for reg in (registry(), jax_registry()):
        parser_cls, cfg_cls = reg[fmt]
        out.append(parser_cls(cfg_cls(data=data, **extra)))
    return out


def assert_same_outputs(to, jo):
    """Cameras (dtype too), file lists, scene box, scale, transform and
    metadata (arrays with their dtype) exactly equal."""
    for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height",
              "distortion_params"):
        a, b = getattr(to.cameras, f), getattr(jo.cameras, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert to.cameras.camera_type == jo.cameras.camera_type
    assert [Path(p) for p in to.image_filenames] == \
        [Path(p) for p in jo.image_filenames]
    assert to.mask_filenames == jo.mask_filenames
    np.testing.assert_array_equal(to.scene_box.aabb, jo.scene_box.aabb)
    assert to.scene_box.aabb.dtype == jo.scene_box.aabb.dtype
    assert to.dataparser_scale == jo.dataparser_scale
    if jo.dataparser_transform is None:
        assert to.dataparser_transform is None
    else:
        np.testing.assert_array_equal(to.dataparser_transform,
                                      jo.dataparser_transform)
    assert sorted(to.metadata) == sorted(jo.metadata)
    for key, b in jo.metadata.items():
        a = to.metadata[key]
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


@pytest.mark.parametrize("fixture", ["jax-test", "port-writer"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_capture_parser_matches_jax(tmp_path, fmt, fixture):
    """The port's parser against the JAX package's, train and val, on the
    JAX test's fixture and on the port's writer: every output exactly
    equal; the first image as the JAX dataset loads it.  Structural facts
    of the JAX tests: the split sizes, finite poses, the auto-scaled
    parsers' poses in their box, the metadata present."""
    pytest.importorskip("cv2")
    from gfnerf_tpu.data.dataset import InputDataset as JaxDataset
    from gfnerf_tpu_torch.data.dataset import InputDataset

    make = JAX_FIXTURES[fmt] if fixture == "jax-test" else (
        lambda root: _port_fixture(fmt, root))
    data, extra = make(tmp_path)
    tp, jp = _parser_pair(fmt, data, extra)
    for split in ("train", "val"):
        to, jo = tp.get_dataparser_outputs(split), jp.get_dataparser_outputs(
            split)
        assert_same_outputs(to, jo)
        np.testing.assert_array_equal(InputDataset(to).get_image(0),
                                      JaxDataset(jo).get_image(0))
    train = tp.get_dataparser_outputs("train")
    n = {"jax-test": {"scannet": 5, "sdfstudio": 5, "phototourism": 5,
                      "sitcoms3d": 4, "arkitscenes": 4, "nuscenes": 4},
         "port-writer": dict.fromkeys(FORMATS, 10)}[fixture][fmt]
    split_n = {"sdfstudio": n, "sitcoms3d": n}.get(fmt, math.ceil(n * 0.9))
    assert len(train.image_filenames) == len(train.cameras) == split_n
    poses = train.cameras.camera_to_worlds
    assert np.isfinite(poses).all()
    bound = {"scannet": 1.0, "phototourism": 3.0, "arkitscenes": 1.0,
             "nuscenes": 1.0}.get(fmt)
    if bound is not None:
        assert np.abs(poses[:, :3, 3]).max() == pytest.approx(bound,
                                                              rel=1e-6)
    want = {"scannet": {"depth_filenames", "depth_unit_scale_factor"},
            "arkitscenes": {"depth_filenames", "depth_unit_scale_factor"},
            "sitcoms3d": {"semantics_filenames", "semantics_classes",
                          "semantics_colors", "semantics_mask_classes"}}
    assert want.get(fmt, set()) <= set(train.metadata)
    if fmt == "nuscenes":
        assert all(Path(m).name.endswith(".png")
                   for m in train.mask_filenames)
    if fixture == "port-writer":
        for key in ("depth_filenames", "normal_filenames",
                    "semantics_filenames"):
            for f in train.metadata.get(key) or []:
                assert Path(f).is_file(), f
        if fmt == "nuscenes":
            assert all(Path(m).is_file() for m in train.mask_filenames)


def test_capture_writers_give_the_ring(tmp_path):
    """Each writer's poses, parsed by the port, are the ring cameras' up to
    the similarity the parser applies: the same rotations between cameras
    (1e-6) and the distances between them in one ratio (1e-6), the
    parser's scale; the intrinsics and sizes the ring's."""
    from gfnerf_tpu_torch.utils.synthetic import ring_cameras

    n, wh, focal = 10, (16, 12), 14.0
    ring = ring_cameras(n, img_wh=wh, focal=focal)[0].astype(np.float64)
    for fmt in FORMATS:
        data, extra = _port_fixture(fmt, tmp_path / fmt)
        if fmt == "sdfstudio":
            extra = {}
        tp, _ = _parser_pair(fmt, data, extra)
        out = tp.get_dataparser_outputs("train")
        k = len(out.cameras)
        sel = (np.arange(n) if k == n
               else np.linspace(0, n - 1, k, dtype=int))
        got = out.cameras.camera_to_worlds.astype(np.float64)
        want = ring[sel]
        for i in range(k):
            np.testing.assert_allclose(got[0, :3, :3].T @ got[i, :3, :3],
                                       want[0, :3, :3].T @ want[i, :3, :3],
                                       rtol=0, atol=1e-6, err_msg=fmt)
        dg = np.linalg.norm(got[1:, :3, 3] - got[0, :3, 3], axis=1)
        dw = np.linalg.norm(want[1:, :3, 3] - want[0, :3, 3], axis=1)
        np.testing.assert_allclose(dg / dw, dg[0] / dw[0], rtol=1e-6,
                                   err_msg=fmt)
        assert np.all(out.cameras.width == wh[0]), fmt
        assert np.all(out.cameras.height == wh[1]), fmt
        np.testing.assert_allclose(out.cameras.fx, focal, rtol=1e-6)
        np.testing.assert_allclose(out.cameras.cx, wh[0] / 2, rtol=1e-6)


# ---- COLMAP's readers ----


def _colmap_model(root, binary: bool):
    """A COLMAP model of four camera models and five images (two with
    points) in COLMAP's binary or text format."""
    cams = [(1, "PINHOLE", 1, 64, 48, [60.0, 61.0, 32.0, 24.0]),
            (2, "SIMPLE_RADIAL", 2, 40, 30, [50.0, 20.0, 15.0, 0.01]),
            (3, "OPENCV", 4, 40, 30,
             [50.0, 51.0, 20.0, 15.0, 0.01, -0.02, 0.001, 0.002]),
            (4, "SIMPLE_PINHOLE", 0, 32, 24, [30.0, 16.0, 12.0])]
    rng = np.random.default_rng(4)
    imgs = []
    for iid in range(1, 6):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        imgs.append((iid, q, rng.standard_normal(3), (iid - 1) % 4 + 1,
                     f"img_{iid}.png", 3 if iid % 2 else 0))
    root.mkdir(parents=True, exist_ok=True)
    if binary:
        with open(root / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", len(cams)))
            for cid, _, model, w, h, params in cams:
                f.write(struct.pack("<iiQQ", cid, model, w, h))
                f.write(struct.pack(f"<{len(params)}d", *params))
        with open(root / "images.bin", "wb") as f:
            f.write(struct.pack("<Q", len(imgs)))
            for iid, q, t, cid, name, npts in imgs:
                f.write(struct.pack("<i", iid) + struct.pack("<4d", *q)
                        + struct.pack("<3d", *t) + struct.pack("<i", cid))
                f.write(name.encode() + b"\x00" + struct.pack("<Q", npts))
                for p in range(npts):
                    f.write(struct.pack("<ddq", 1.5 * p, 2.5, p))
    else:
        (root / "cameras.txt").write_text("# Camera list\n" + "".join(
            f"{cid} {name} {w} {h} {' '.join(map(repr, params))}\n"
            for cid, name, _, w, h, params in cams))
        lines = ["# Image list", "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
        for iid, q, t, cid, name, npts in imgs:
            lines.append(f"{iid} {' '.join(map(repr, q.tolist()))} "
                         f"{' '.join(map(repr, t.tolist()))} {cid} {name}")
            lines.append(" ".join(f"{1.5 * p} 2.5 {p}" for p in range(npts)))
        (root / "images.txt").write_text("\n".join(lines) + "\n")
    return cams, imgs


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_colmap_readers_match_jax(tmp_path, binary):
    """``read_cameras_*`` and ``read_images_*`` of both packages on the
    same model: equal dicts (the cameras' parameters and the images'
    quaternions and translations exactly); ``colmap_to_json`` of both
    the same file (the SIMPLE_PINHOLE, SIMPLE_RADIAL, PINHOLE and OPENCV
    intrinsics); ``qvec2rotmat`` equal."""
    from gfnerf_tpu.process_data import colmap_utils as J
    from gfnerf_tpu_torch.process_data import colmap_utils as T

    cams, imgs = _colmap_model(tmp_path / "sparse", binary)
    kind = "bin" if binary else "txt"
    for reader in (f"read_cameras_{kind}", f"read_images_{kind}"):
        got = getattr(T, reader)(tmp_path / "sparse" / (
            reader.split("_")[1] + f".{kind}"))
        want = getattr(J, reader)(tmp_path / "sparse" / (
            reader.split("_")[1] + f".{kind}"))
        assert sorted(got) == sorted(want) and len(got) in (4, 5)
        for key in want:
            assert sorted(got[key]) == sorted(want[key])
            for field, b in want[key].items():
                a = got[key][field]
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b, (reader, key, field)
    images = getattr(T, f"read_images_{kind}")(
        tmp_path / "sparse" / f"images.{kind}")
    for iid, q, t, cid, name, _ in imgs:
        np.testing.assert_array_equal(images[iid]["qvec"], q)
        assert images[iid]["camera_id"] == cid and images[iid]["name"] == name
        np.testing.assert_array_equal(T.qvec2rotmat(q), J.qvec2rotmat(q))
    assert T.CAMERA_MODELS == J.CAMERA_MODELS
    assert T.colmap_to_json(tmp_path / "sparse", tmp_path / "port") == 5
    assert J.colmap_to_json(tmp_path / "sparse", tmp_path / "jax") == 5
    assert (tmp_path / "port" / "transforms.json").read_text() == \
        (tmp_path / "jax" / "transforms.json").read_text()


def test_colmap_writer_round_trip(tmp_path):
    """The port's ``write_colmap_model`` read back by the JAX package's
    readers: the PINHOLE intrinsics exactly, and the camera-to-worlds
    (inverted, the camera's y and z flipped back) to 1e-6 of the ring's
    (its f32 rotations are orthonormal to about 1e-7, a quaternion's
    exactly); ``rotmat2qvec`` inverts ``qvec2rotmat`` (1e-12)."""
    from gfnerf_tpu.process_data.colmap_utils import (qvec2rotmat,
                                                      read_cameras_bin,
                                                      read_images_bin)
    from gfnerf_tpu_torch.utils.synthetic import (ring_cameras, rotmat2qvec,
                                                  write_colmap_model)

    c2w, fx, fy, cx, cy, w, h = ring_cameras(7, img_wh=(20, 14))
    c2w4 = np.tile(np.eye(4), (7, 1, 1))
    c2w4[:, :3, :4] = c2w
    names = [f"v{i}.png" for i in range(7)]
    write_colmap_model(tmp_path, c2w4, fx, fy, cx, cy, 20, 14, names)
    cams, imgs = (read_cameras_bin(tmp_path / "cameras.bin"),
                  read_images_bin(tmp_path / "images.bin"))
    for i in range(7):
        cam, img = cams[i + 1], imgs[i + 1]
        assert (cam["model"], cam["width"], cam["height"]) == (
            "PINHOLE", 20, 14)
        assert cam["params"] == [float(fx[i]), float(fy[i]), float(cx[i]),
                                 float(cy[i])]
        assert img["name"] == names[i] and img["camera_id"] == i + 1
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = qvec2rotmat(img["qvec"]), img["tvec"]
        back = np.linalg.inv(w2c)
        back[:3, 1:3] *= -1
        np.testing.assert_allclose(back, c2w4[i], rtol=0, atol=1e-6)
        rot = qvec2rotmat(img["qvec"])
        np.testing.assert_allclose(rotmat2qvec(rot), img["qvec"], atol=1e-12)


# ---- image sizes and resizes ----


@pytest.mark.parametrize("kind", ["baseline", "progressive", "grey",
                                  "restart", "exif"])
def test_jpeg_size_matches_cv2(tmp_path, kind, monkeypatch):
    """``jpeg_size`` (and ``image_size``) against ``cv2.imread``'s shape on
    JPEGs written by cv2 (baseline SOF0, progressive SOF2, grey, restart
    markers) and by PIL with an EXIF segment, with imageio out of reach;
    a file that is not a JPEG, or is cut before its frame, raises."""
    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu_torch.utils import image_io

    img = (np.random.default_rng(1).random((37, 53, 3)) * 255).astype(
        np.uint8)
    path = tmp_path / "a.jpg"
    if kind == "exif":
        from PIL import Image

        exif = Image.Exif()
        exif[0x010F] = "maker"
        Image.fromarray(img).save(path, exif=exif)
        assert b"Exif" in path.read_bytes()[:64]
    else:
        flags = {"progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                 "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}.get(kind, [])
        cv2.imwrite(str(path), img[..., 0] if kind == "grey" else img, flags)
    sof = {"progressive": b"\xff\xc2"}.get(kind, b"\xff\xc0")
    assert sof in path.read_bytes()
    h, w = cv2.imread(str(path), cv2.IMREAD_UNCHANGED).shape[:2]
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    assert image_io.jpeg_size(path) == (w, h) == (53, 37)
    assert image_io.image_size(path) == (w, h)
    data = path.read_bytes()
    (tmp_path / "cut.jpg").write_bytes(data[:data.index(sof)])
    with pytest.raises(ValueError, match="start-of-frame"):
        image_io.jpeg_size(tmp_path / "cut.jpg")
    cv2.imwrite(str(tmp_path / "a.bmp"), img)
    with pytest.raises(ValueError, match="not a JPEG"):
        image_io.jpeg_size(tmp_path / "a.bmp")
    with pytest.raises(NotImplementedError, match="imageio"):
        image_io.image_size(tmp_path / "a.bmp")


@pytest.mark.parametrize("scale", [1.5, 2.0, 3.0])
def test_resize_area_upscale_matches_cv2(scale):
    """``resize_area`` above scale 1 against ``cv2.resize(...,
    INTER_AREA)``: 1e-5, the tolerance of test_resize_area_matches_cv2; at
    an integer scale each pixel repeated, exactly."""
    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu_torch.utils.image_io import resize_area

    rng = np.random.default_rng(7)
    for shape in ((30, 40, 3), (30, 40, 4), (31, 43), (5, 7, 3)):
        img = rng.random(shape).astype(np.float32)
        want = cv2.resize(img, (int(shape[1] * scale), int(shape[0] * scale)),
                          interpolation=cv2.INTER_AREA)
        got = resize_area(img, scale)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        if scale == int(scale):
            k = int(scale)
            np.testing.assert_array_equal(
                got, np.repeat(np.repeat(img, k, 0), k, 1))


# ---- max_norm ----


def test_clip_by_global_norm_matches_optax():
    """The port's ``clip_by_global_norm`` against optax's on one group's
    gradients, below and above the limit: 1e-6 relative; a None adds
    nothing and stays None; a NaN gives a NaN norm and NaN gradients, and
    none that is finite."""
    import jax.numpy as jnp
    import optax

    from gfnerf_tpu_torch.engine.optimizers import clip_by_global_norm

    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((7, 5), (5,), (3, 4, 2))]
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in grads)))
    for max_norm in (0.5 * norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        got, got_norm = clip_by_global_norm(
            [torch.as_tensor(g) for g in grads[:2]] + [None]
            + [torch.as_tensor(grads[2])], max_norm)
        assert got[2] is None
        np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
        for a, b in zip(got[:2] + got[3:], want):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        if max_norm > norm:   # below the limit the gradients pass unchanged
            for a, g in zip(got[:2] + got[3:], grads):
                np.testing.assert_array_equal(to_np(a), g)
    assert clip_by_global_norm([None], 1.0) == ([None], None)
    bad = [torch.as_tensor(g) for g in grads]
    bad[1][2] = float("nan")
    out, n = clip_by_global_norm(bad, 1.0)
    assert torch.isnan(n)
    assert not any(bool(torch.isfinite(g).any()) for g in out)


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


def test_max_norm_matches_optax():
    """Per-group Adam with ``max_norm`` against the JAX package's
    ``build_optimizer`` (optax's ``clip_by_global_norm`` in each group's
    chain) over seven steps whose gradients are scaled so that each group
    is clipped on some steps and not on others: the clipped gradients
    (Adam's first moment after the first update, mu = (1 - b1) g), both
    moments and every update to 1e-6 relative (the moments with an atol of
    1e-6 of their largest entry: XLA contracts their updates into fused
    multiply-adds, whose rounding shows where two steps' gradients cancel;
    measured 5.8e-6 relative on an entry 1e-2 of the largest); the port's
    pre-clip norms against numpy's; a NaN step skipped in both."""
    import jax.numpy as jnp
    import optax
    from gfnerf_tpu.engine.optimizers import OptimizersConfig as JCfg
    from gfnerf_tpu.engine.optimizers import build_optimizer as jbuild
    from gfnerf_tpu.engine.optimizers import optimizer_arg
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    apply_updates,
                                                    build_optimizer,
                                                    field_param_groups)
    from torch_parity import field_pair

    max_norm = 1.0
    kw = dict(steps_perssampler_init=3, steps_per_split_dataset=2,
              n_split_dataset=2, max_norm=max_norm)
    _, params, _, field = field_pair(seed=1, packed_rows_log2=6)
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.uniform(-1, 1, params.block_feats.shape[1:])
                        .astype(np.float32))
    with torch.no_grad():
        field.block_feats[0] = torch.as_tensor(np.array(table))
    params_nb, _ = optimizer_arg(params)
    jtx = jbuild(JCfg(**kw), params)
    jstate = jtx.init((params_nb, table))
    tx = build_optimizer(OptimizersConfig(**kw))
    groups = field_param_groups(field)
    state = tx.init(groups)
    # each group's gradient norm relative to the limit, step by step
    scales = {"fields": [0.3, 4.0, 0.8, 2.0, 5.0, 0.5, 3.0],
              "base_encoding_init": [2.0, 0.4, 6.0, 0.7, 0.9, 1.5, 0.2],
              "block": [1.0, 1.0, 0.5, 3.0, 2.5, 0.6, 8.0]}
    clipped = {name: 0 for name in scales}
    for step in range(7):
        shapes = {k: [np.shape(x) for x in v]
                  for k, v in _jax_leaves(params_nb, table).items()}
        grads = {}
        for k, v in shapes.items():
            gs = [rng.standard_normal(sh).astype(np.float32) for sh in v]
            n = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in gs))
            grads[k] = [(g * (scales[k][step] * max_norm / n)).astype(
                np.float32) for g in gs]
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

        assert state.last_finite == (step != 3)
        if step == 3:
            assert tx.grad_norms == {}
        else:
            for name, gs in grads.items():
                if name == "block" and step < 2:
                    assert name not in tx.grad_norms
                    continue
                n = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                for g in gs))
                np.testing.assert_allclose(float(tx.grad_norms[name]), n,
                                           rtol=1e-6)
                clipped[name] += bool(tx.grad_norms[name] >= max_norm)
        want = _jax_leaves(*jupd)
        inner = jstate.inner_state.inner_states
        for name in want:
            adam = inner[name].inner_state[1]   # (clip, adam, ...)
            for i, (u, w) in enumerate(zip(upd[name], want[name])):
                got = np.zeros_like(np.asarray(w)) if u is None else to_np(u)
                np.testing.assert_allclose(
                    got, np.asarray(w), rtol=1e-6, atol=1e-8,
                    err_msg=f"step {step} {name}[{i}] update")
            for moment in ("mu", "nu"):
                jm = _jax_leaves(*getattr(adam, moment))[name]
                for i, (m, w) in enumerate(zip(getattr(state, moment)[name],
                                               jm)):
                    w = np.asarray(w)
                    got = np.zeros_like(w) if m is None else to_np(m)
                    np.testing.assert_allclose(
                        got, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                        err_msg=f"step {step} {name}[{i}] {moment}")
    assert state.total_notfinite == 1
    # clipped on 3, 3 and 2 of the six applied steps, passed on the rest
    assert clipped == {"fields": 3, "base_encoding_init": 3, "block": 2}


def test_max_norm_none_and_unreached_keep_the_update():
    """``max_norm`` None (every registered method's default) and a limit
    no gradient reaches give the same updates and moments bit for bit."""
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer)

    params = {"fields": [torch.zeros(6, 4), torch.zeros(4)],
              "base_encoding_init": [torch.zeros(32, 2)], "block": [],
              "camera_opt": []}
    outs = []
    for max_norm in (None, 1e30):
        tx = build_optimizer(OptimizersConfig(max_norm=max_norm))
        state = tx.init(params)
        gen = np.random.default_rng(3)
        ups = []
        for _ in range(3):
            grads = {k: [torch.as_tensor(gen.standard_normal(tuple(p.shape))
                                         .astype(np.float32)) for p in v]
                     for k, v in params.items()}
            upd, state = tx.update(grads, state, params)
            ups.append(upd)
        outs.append((ups, state, tx.grad_norms))
    (a, sa, na), (b, sb, nb) = outs
    assert na == {} and sorted(nb) == ["base_encoding_init", "fields"]
    for ua, ub in zip(a, b):
        for name in ua:
            for x, y in zip(ua[name], ub[name]):
                assert torch.equal(x, y)
    for name in sa.mu:
        for x, y in zip(sa.mu[name] + sa.nu[name], sb.mu[name] + sb.nu[name]):
            assert torch.equal(x, y)


# ---- the loss switches ----


def _jax_grads(opt_state):
    """The step's "fields" gradients, from Adam's first moment (mu = (1 -
    b1) g after one update)."""
    from torch_parity import jax_groups

    mu = opt_state.inner_state.inner_states["fields"].inner_state[0].mu[0]
    return [np.asarray(m) / 0.1 for m in jax_groups(mu)["fields"]]


@pytest.mark.parametrize("case", ["mse", "s3im-mult-kernel-stride-repeat",
                                  "no-s3im"])
def test_loss_switches_match_jax(case):
    """One init-stage train step with the loss switches against the JAX
    step (its S3IM permutations injected): the loss and its parts to 1e-5
    relative, the MLP gradients to rtol 1e-3 with an atol of 1e-3 of the
    largest (tests/test_torch_train.py's f32 tolerances); without S3IM no
    ``s3im_loss`` in either."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups
    from torch_parity import (TRAIN_S, field_pair, jax_train_step,
                              octree_pair, port_train_step, train_batch)

    mkw = dict(scale_factor=1.0, samples_budget_per_ray=TRAIN_S,
               **{"mse": dict(use_ch_loss=False),
                  "s3im-mult-kernel-stride-repeat": dict(
                      s3im_loss_mult=0.4, s3im_kernel_size=2, s3im_stride=2,
                      s3im_repeat_time=5, s3im_patch_height=16),
                  "no-s3im": dict(use_ch_loss=False,
                                  s3im_loss_mult=0.0)}[case])
    jcfg, params, statics, field = field_pair()
    joct, toct = octree_pair()
    batch = train_batch()
    (jstate, _, jm, _), noise, perms = jax_train_step(
        jcfg, params, statics, joct, batch, mkw, key_seed=7)
    assert perms.shape[0] == mkw.get("s3im_repeat_time", 10) - 1
    state, _, tm, _ = port_train_step(field, toct, batch, mkw, noise, perms)
    assert ("s3im_loss" in jm) == ("s3im_loss" in tm) == (case != "no-s3im")
    for k in ("loss", "rgb_loss", "s3im_loss", "psnr"):
        if k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    if case == "mse":
        assert float(tm["rgb_loss"]) == pytest.approx(
            10.0 ** (-float(tm["psnr"]) / 10.0), rel=1e-4)
    want = _jax_grads(jstate.opt_state)
    scale = max(float(np.abs(g).max()) for g in want)
    assert scale > 0
    for i, (p, w) in enumerate(zip(field_param_groups(field)["fields"],
                                   want)):
        np.testing.assert_allclose(to_np(p.grad), w, rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=f"fields[{i}]")


def test_train_step_draws_repeat_time_permutations(monkeypatch):
    """Without injected permutations the step draws ``s3im_repeat_time -
    1`` of them, and none without S3IM."""
    import gfnerf_tpu_torch.models.gfnerf as gm
    from torch_parity import (TRAIN_S, field_pair, octree_pair,
                              port_train_step, train_batch)

    drawn = []
    real = gm.s3im_permutations

    def spy(n, repeat_time=10, **kw):
        drawn.append(repeat_time)
        return real(n, repeat_time, **kw)

    monkeypatch.setattr(gm, "s3im_permutations", spy)
    _, _, _, field = field_pair()
    _, toct = octree_pair()
    batch = train_batch()
    rng = np.random.default_rng(0)
    noise = (rng.random((len(batch["image"]), TRAIN_S)) + 0.5).astype(
        np.float32)
    for mult, want in ((1.0, [6]), (0.0, [])):
        drawn.clear()
        mkw = dict(scale_factor=1.0, samples_budget_per_ray=TRAIN_S,
                   s3im_repeat_time=6, s3im_loss_mult=mult,
                   s3im_patch_height=16)
        _, _, m, _ = port_train_step(field, toct, batch, mkw, noise, None)
        assert drawn == want
        assert ("s3im_loss" in m) == (mult > 0)


# ---- scaled captures and the semantic sampler ----


def _datamanagers(parser_pair, **kw):
    from gfnerf_tpu.data.datamanager import GFNerfDataManager as JaxDM
    from gfnerf_tpu.data.datamanager import (
        GFNerfDataManagerConfig as JaxDMConfig)
    from gfnerf_tpu_torch.data.datamanager import (GFNerfDataManager,
                                                   GFNerfDataManagerConfig)

    tp, jp = parser_pair
    kw = dict(train_num_rays_per_batch=64, eval_num_rays_per_batch=32,
              steps_perssampler_init=2, **kw)
    return (GFNerfDataManager(GFNerfDataManagerConfig(**kw), tp, seed=4),
            JaxDM(JaxDMConfig(**kw), jp, seed=4))


def test_scaled_capture_images_match_jax(tmp_path):
    """``camera_res_scale_factor=0.5`` on a Phototourism capture of PNGs
    (the port's writer, 32x24): every dataset's images (init cache, eval
    images) against the JAX datamanager's cv2 INTER_AREA resize, 1e-5, at
    16x12; the init batches' pixels and indices equal (the same seeds)."""
    pytest.importorskip("cv2")
    from test_torch_data import assert_batches_equal

    from gfnerf_tpu_torch.utils.synthetic import make_phototourism_fixture

    data = make_phototourism_fixture(tmp_path / "s", 10, (32, 24), 28.0)
    tdm, jdm = _datamanagers(_parser_pair("phototourism", data, {}),
                             camera_res_scale_factor=0.5)
    assert tdm.init_cache.images.shape == (9, 12, 16, 3)
    np.testing.assert_allclose(tdm.init_cache.images, jdm.init_cache.images,
                               rtol=0, atol=1e-5)
    _, got = tdm.next_eval_image(0)
    _, want = jdm.next_eval_image(0)
    assert got["image"].shape == (12, 16, 3)
    np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                               atol=1e-5)
    for step in range(2):
        got, want = tdm.next_train(step), jdm.next_train(step)
        np.testing.assert_allclose(got.pop("image"), want.pop("image"),
                                   rtol=0, atol=1e-5)
        assert_batches_equal(got, want)


def test_scaled_cameras_unlike_jax(tmp_path):
    """A reference-side trait: the JAX datamanager resizes the images by
    ``camera_res_scale_factor`` but leaves the cameras at the parser's size
    (fx, fy, cx, cy, width, height), so a pixel of the small image is cast
    through the full-size intrinsics (the top-left quarter of the view at
    0.5).  The port scales the cameras with the images, as nerfstudio's
    ``rescale_output_resolution`` does: the ray through a pixel centre of
    the half-size image is the full-size camera's ray through the same
    point of the view (1e-6)."""
    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.utils.synthetic import make_phototourism_fixture

    data = make_phototourism_fixture(tmp_path / "s", 10, (32, 24), 28.0)
    pair = _parser_pair("phototourism", data, {})
    tdm, jdm = _datamanagers(pair, camera_res_scale_factor=0.5)
    full = pair[0].get_dataparser_outputs("train").cameras
    jc = jdm.train_dataparser_outputs.cameras
    tc = tdm.train_dataparser_outputs.cameras
    # the JAX package's cameras stay at full size beside half-size images
    assert jdm.init_cache.images.shape[1:3] == (12, 16)
    np.testing.assert_array_equal(jc.fx, full.fx)
    assert np.all(jc.width == 32) and np.all(jc.height == 24)
    # the port's follow the images
    assert np.all(tc.width == 16) and np.all(tc.height == 12)
    assert tc.width.dtype == full.width.dtype
    for f in ("fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(tc, f),
                                      getattr(full, f) * np.float32(0.5))
    np.testing.assert_array_equal(tc.camera_to_worlds,
                                  full.camera_to_worlds)
    assert tdm.eval_dataparser_outputs.cameras.width[0] == 16
    rng = np.random.default_rng(0)
    cam = torch.as_tensor(rng.integers(0, len(tc), 50))
    yx = np.stack([rng.integers(0, 12, 50), rng.integers(0, 16, 50)], -1)
    small = generate_rays_multi(tc.to_device("cpu"), cam,
                                torch.as_tensor(yx + 0.5, dtype=torch.float32))
    big = generate_rays_multi(full.to_device("cpu"), cam,
                              torch.as_tensor(2 * yx + 1.0,
                                              dtype=torch.float32))
    for k in ("origins", "directions"):
        np.testing.assert_allclose(to_np(small[k]), to_np(big[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_semantic_sample_weights_match_jax(tmp_path):
    """``semantic_sample_weights`` with ``patch_size`` 2: the JAX package's
    focal split draws through its class-weighted sampler, which keeps the
    weights unused and draws uniformly without patches; the port's
    uniform sampler draws the same batches; the init stage keeps its
    patches in both."""
    from test_torch_data import assert_batches_equal

    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    scene = make_synthetic_npz(tmp_path / "s", n_train=10, n_val=2,
                               img_wh=(24, 16))
    pair = (build_dataparser("minimal", scene),
            torch_parity.jax_minimal_parser(scene))
    tdm, jdm = _datamanagers(pair, semantic_sample_weights=[0.5, 2.0],
                             patch_size=2)
    assert tdm.init_pixel_sampler.patch_size == 2
    assert_batches_equal(tdm.next_train(0), jdm.next_train(0))
    labels = np.arange(10) % 2
    for dm in (tdm, jdm):
        dm.setup_train_split_oct(labels, 1, None)
    assert type(jdm.split_pixel_sampler).__name__ == "SemanticPixelSampler"
    assert jdm.split_pixel_sampler.class_weights == [0.5, 2.0]
    assert tdm.split_pixel_sampler.patch_size == 1
    for step in range(2, 5):
        assert_batches_equal(tdm.next_train(step), jdm.next_train(step))


def test_train_cli_on_a_phototourism_capture(tmp_path):
    """``python -m gfnerf_tpu_torch.train`` offers the JAX script's twelve
    parsers and ``--dataparser-scale-factor``; gf-nerf-tiny trains on the
    CPU on a Phototourism capture at half its image size, clipped, with
    MSE: the run's config holds the knobs, every step logs each group's
    pre-clip norm, the clip fires, the checkpoint is written."""
    from gfnerf_tpu.data.dataparsers import registry as jax_registry
    from gfnerf_tpu_torch import train
    from gfnerf_tpu_torch.configs.config_io import config_from_json
    from gfnerf_tpu_torch.utils.synthetic import make_phototourism_fixture

    assert sorted(train.DATAPARSERS) == sorted(jax_registry())
    data = make_phototourism_fixture(tmp_path / "s", 12, (48, 36), 40.0)
    norms = []
    trainer = train.build_trainer([
        "gf-nerf-tiny", "--data", str(data), "--dataparser", "phototourism",
        "--dataparser-scale-factor", "4.0", "--device", "cpu",
        "--output-dir", str(tmp_path / "out"), "--experiment-name", "pt",
        "--max-num-iterations", "6",
        "pipeline.datamanager.train_num_rays_per_batch=64",
        "pipeline.model.s3im_patch_height=8",
        "pipeline.datamanager.camera_res_scale_factor=0.5",
        "pipeline.optimizers.max_norm=0.05",
        "pipeline.model.use_ch_loss=false"])
    p = trainer.pipeline
    assert p.datamanager.init_cache.images.shape[1:3] == (18, 24)
    get_loss = p.get_train_loss_dict

    def recording(step):
        m = get_loss(step)
        norms.append({k: v for k, v in m.items()
                      if k.startswith("grad_norm_")})
        return m

    p.get_train_loss_dict = recording
    trainer.train()
    assert len(norms) == 6
    fired = [n["grad_norm_fields"] >= 0.05 for n in norms
             if "grad_norm_fields" in n]
    assert len(fired) == 6 and any(fired)
    (config,) = (tmp_path / "out").glob("pt/gf-nerf-tiny/*/config.json")
    run = config_from_json(config.read_text())
    assert run.pipeline.optimizers.max_norm == 0.05
    assert run.pipeline.datamanager.camera_res_scale_factor == 0.5
    assert run.pipeline.model.use_ch_loss is False
    assert list(config.parent.glob("nerfstudio_models/step-000000005"))
