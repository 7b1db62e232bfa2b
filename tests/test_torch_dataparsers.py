"""The port's image I/O, dataset, capture parsers, cameras and pixel
samplers against the JAX package's (and the readers it relies on) on the
CPU.

- PNG: ``read_png`` against ``imageio.v2.imread`` (PIL's and cv2's files
  in every colour type and bit depth, one image whose encoder split it
  into many IDAT chunks; 16-bit files, which this imageio reads as 8-bit,
  against ``cv2.imread``): exact.  ``write_png`` under each filter type,
  read back by imageio or cv2: exact.
- ``_load_image`` against the JAX package's: exact for 8-bit files; with
  a ``scale_factor``, through ``resize_area`` against ``cv2.INTER_AREA``,
  1e-5.  ``resize_area`` and ``resize_linear`` against cv2 at 1e-5.
- Parsers: the port's ``DataparserOutputs`` against the JAX package's on
  the same files: poses and intrinsics exact, file lists equal.
- Cameras: ``generate_rays_multi`` with distortion, fisheye and
  equirectangular cameras against JAX's, 1e-6.  The undistortion round
  trip, 1e-5 (the JAX test's tolerance).
- The equirectangular sampler: the JAX sampler's indices exactly, and its
  sin(theta) law as ``tests/test_components.py`` states it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)

H, W = 37, 53


def _rgb(seed=0, h=H, w=W, c=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 65536
    return rng.integers(0, hi, (h, w, c), dtype=dtype)


# ---- PNG ----


def _pil_file(tmp_path, kind):
    """(path, the pixels a reader should return) of a PNG PIL writes."""
    from PIL import Image

    rgb = _rgb()
    path = tmp_path / f"{kind}.png"
    if kind in ("L", "LA", "RGB", "RGBA"):
        arr = {"L": rgb[..., 0], "LA": rgb[..., :2], "RGB": rgb,
               "RGBA": np.concatenate([rgb, rgb[..., :1]], -1)}[kind]
        Image.fromarray(arr, kind).save(path)
    elif kind in ("P8", "P4"):
        img = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                           colors=16)
        img.save(path, bits=8 if kind == "P8" else 4)
    elif kind == "P-tRNS":
        img = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                           colors=16)
        img.save(path, transparency=bytes(range(0, 256, 16)))
        # imageio drops a palette's alpha; PIL's RGBA keeps it
        return path, np.asarray(Image.open(path).convert("RGBA"))
    elif kind == "1-bit":
        Image.fromarray(rgb[..., 0] > 128).save(path)
        import imageio.v2 as imageio

        return path, imageio.imread(path).astype(np.uint8) * 255
    elif kind == "I16":
        Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(path)
    elif kind == "multi-IDAT":
        Image.fromarray(_rgb(1, 600, 700)).save(path)
        assert path.read_bytes().count(b"IDAT") > 1
    import imageio.v2 as imageio

    return path, imageio.imread(path)


@pytest.mark.parametrize("kind", ["L", "LA", "RGB", "RGBA", "P8", "P4",
                                  "P-tRNS", "1-bit", "I16", "multi-IDAT"])
def test_read_png_matches_pil_files(tmp_path, kind):
    """PNGs PIL writes (its encoder's adaptive filters, IDAT split at 64
    KiB), read by the port and by imageio (PIL's RGBA for a palette with
    tRNS, imageio's booleans as 0/255 for 1-bit): exact."""
    from gfnerf_tpu_torch.utils.image_io import png_size, read_png

    path, want = _pil_file(tmp_path, kind)
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert png_size(path) == (want.shape[1], want.shape[0])


@pytest.mark.parametrize("kind", ["grey8", "bgr8", "grey16", "bgr16",
                                  "bgra16"])
def test_read_png_matches_cv2_files(tmp_path, kind):
    """PNGs cv2 writes (libpng's filters), read by the port and by cv2
    (its BGR order reversed): exact, 16-bit included."""
    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu_torch.utils.image_io import read_png

    dtype = np.uint16 if kind.endswith("16") else np.uint8
    c = {"grey": 1, "bgr": 3, "bgra": 4}[kind.rstrip("0123456789")]
    img = _rgb(2, c=c, dtype=dtype)
    img = img[..., 0] if c == 1 else img
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if c > 1:
        want = want[..., [2, 1, 0, 3][:c]]
    got = read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_write_png_each_filter(tmp_path, ftype):
    """``write_png`` under one filter type for every row, in each colour
    type at 8 and 16 bits, read back by imageio (8-bit), cv2 (16-bit) and
    the port: exact.  The last case mixes the five types row by row."""
    import imageio.v2 as imageio

    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu_torch.utils.image_io import read_png, write_png

    for dtype in (np.uint8, np.uint16):
        for c in (1, 2, 3, 4):
            if dtype == np.uint16 and c == 2:
                continue   # cv2 has no grey-and-alpha
            img = _rgb(3 + c, c=c, dtype=dtype)
            img = img[..., 0] if c == 1 else img
            path = tmp_path / f"{c}_{dtype.__name__}.png"
            write_png(path, img, filter_type=ftype)
            if dtype == np.uint8:
                back = imageio.imread(path)
            else:
                back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
                back = back if c == 1 else back[..., [2, 1, 0, 3][:c]]
            np.testing.assert_array_equal(back, img, err_msg=str(path))
            np.testing.assert_array_equal(read_png(path), img)
    rows = [(ftype + y) % 5 for y in range(H)]
    write_png(tmp_path / "mixed.png", _rgb(9), filter_type=rows)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "mixed.png"),
                                  _rgb(9))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_write_png_palette_and_low_depth(tmp_path, depth):
    """Palette images (with and without tRNS) and grey at ``depth`` bits,
    written by the port, read by PIL and by the port: the palette's
    colours exact; grey scaled to 0-255 as PIL scales it."""
    from PIL import Image

    from gfnerf_tpu_torch.utils.image_io import read_png, write_png

    rng = np.random.default_rng(depth)
    n = 1 << depth
    idx = rng.integers(0, n, (H, W)).astype(np.uint8)
    pal = rng.integers(0, 256, (n, 4)).astype(np.uint8)
    for cols in (3, 4):
        path = tmp_path / f"p{cols}.png"
        write_png(path, idx, palette=pal[:, :cols], bit_depth=depth,
                  filter_type=depth % 5)
        mode = "RGBA" if cols == 4 else "RGB"
        want = np.asarray(Image.open(path).convert(mode))
        np.testing.assert_array_equal(want, pal[idx][..., :cols])
        np.testing.assert_array_equal(read_png(path), want)
    path = tmp_path / "g.png"
    write_png(path, idx, bit_depth=depth)
    want = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(want, (idx.astype(np.uint16) * 255
                                         // (n - 1)).astype(np.uint8))


def test_png_repairs_and_refusals(tmp_path, monkeypatch):
    """A file whose encoder split its image data over several IDAT chunks
    reads whole through ``render.read_png`` (a repair: every chunk is
    joined, not only the last).  Adam7
    interlacing raises and names it; a JPEG goes through imageio, and
    without imageio raises and names it (its size still comes from its
    start-of-frame segment)."""
    import imageio.v2 as imageio
    from PIL import Image

    from gfnerf_tpu_torch.render import read_png as render_read_png
    from gfnerf_tpu_torch.utils import image_io

    img = _rgb(4, 400, 300)
    Image.fromarray(img).save(tmp_path / "split.png")
    assert (tmp_path / "split.png").read_bytes().count(b"IDAT") > 1
    np.testing.assert_array_equal(render_read_png(tmp_path / "split.png"),
                                  img)
    image_io.write_png(tmp_path / "i.png", _rgb())
    data = bytearray((tmp_path / "i.png").read_bytes())
    data[8 + 8 + 12] = 1          # IHDR's interlace byte
    (tmp_path / "i.png").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="Adam7"):
        image_io.read_png(tmp_path / "i.png")
    imageio.imwrite(tmp_path / "a.jpg", _rgb())
    assert image_io.read_image(tmp_path / "a.jpg").shape == (H, W, 3)
    assert image_io.image_size(tmp_path / "a.jpg") == (W, H)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(NotImplementedError, match="imageio"):
        image_io.read_image(tmp_path / "a.jpg")
    assert image_io.image_size(tmp_path / "a.jpg") == (W, H)


# ---- _load_image and the dataset ----


@pytest.mark.parametrize("case", ["rgb", "rgba-white", "rgba-black", "grey",
                                  "grey-alpha", "rgba-scale-0.5"])
def test_load_image_matches_jax(tmp_path, case):
    """The port's ``_load_image`` against the JAX package's on the same
    8-bit file: exact; with ``scale_factor`` 0.5 (the JAX package resizes
    with cv2.INTER_AREA) 1e-5."""
    import imageio.v2 as imageio

    from gfnerf_tpu.data.dataset import _load_image as jax_load
    from gfnerf_tpu_torch.data.dataset import _load_image

    rgb = _rgb(5, 24, 32)
    arr = {"rgb": rgb, "grey": rgb[..., 0], "grey-alpha": rgb[..., :2]}.get(
        case, np.concatenate([rgb, rgb[..., :1]], -1))
    path = tmp_path / "a.png"
    imageio.imwrite(path, arr)
    color = "black" if case == "rgba-black" else None
    scale = 0.5 if "scale" in case else 1.0
    if scale != 1.0:
        pytest.importorskip("cv2")
    got = _load_image(path, scale, color)
    want = jax_load(path, scale, color)
    assert got.shape == want.shape and got.dtype == np.float32
    if scale == 1.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_16bit_images_scaled_unlike_jax(tmp_path):
    """A reference-side trait: the JAX package's ``_load_image`` leaves a
    16-bit image in [0, 65535]; the port divides it by 65535."""
    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu.data.dataset import _load_image as jax_load
    from gfnerf_tpu_torch.data.dataset import _load_image

    img = _rgb(6, 12, 16, dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "a.png"), img[..., ::-1])
    got = _load_image(tmp_path / "a.png")
    np.testing.assert_array_equal(got, img.astype(np.float32) / 65535.0)
    assert got.max() <= 1.0
    # imageio reads this file as 8-bit: the JAX package's values are not in
    # [0, 1] and not the file's 16 bits either
    want = jax_load(tmp_path / "a.png")
    assert not np.array_equal(want, got)


@pytest.mark.parametrize("scale", [0.5, 0.25, 0.3])
def test_resize_area_matches_cv2(scale):
    """``resize_area`` against ``cv2.resize(..., INTER_AREA)``: 1e-5."""
    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu_torch.utils.image_io import resize_area

    rng = np.random.default_rng(7)
    for shape in ((30, 40, 3), (30, 40, 4), (31, 43)):
        img = rng.random(shape).astype(np.float32)
        want = cv2.resize(img, (int(shape[1] * scale), int(shape[0] * scale)),
                          interpolation=cv2.INTER_AREA)
        np.testing.assert_allclose(resize_area(img, scale), want, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 0.25, 0.3])
def test_resize_linear_matches_cv2(scale):
    """``resize_linear`` against ``cv2.resize(..., INTER_LINEAR)`` to and
    from a size ``scale`` times the other: 1e-5."""
    cv2 = pytest.importorskip("cv2")
    from gfnerf_tpu_torch.utils.image_io import resize_linear

    rng = np.random.default_rng(8)
    big = (40, 30)
    small = (int(big[0] * scale), int(big[1] * scale))
    for src, dst in ((big, small), (small, big)):
        img = rng.random((src[1], src[0])).astype(np.float32)
        want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(resize_linear(img, dst), want, rtol=0,
                                   atol=1e-5)


def test_dataset_side_channels_match_jax(tmp_path):
    """``InputDataset.get_data`` on a Blender scene with side channels from
    files (depth ``.npy``, a road mask PNG, an all-mask ``.npy``, an error
    map at half size), and the ``ImageCache``'s error maps resized to the
    images' size, against the JAX package's: the images and masks exact,
    the resized error maps 1e-5 (the JAX package resizes with cv2)."""
    pytest.importorskip("cv2")
    import dataclasses

    import imageio.v2 as imageio

    from gfnerf_tpu.data.dataparsers.blender_parser import (
        BlenderDataParser as JaxBlender, BlenderDataParserConfig as JaxCfg)
    from gfnerf_tpu.data.dataset import ImageCache as JaxCache
    from gfnerf_tpu.data.dataset import InputDataset as JaxDataset
    from gfnerf_tpu.utils.synthetic import make_blender_fixture
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.dataset import ImageCache, InputDataset

    path = make_blender_fixture(tmp_path / "scene", n_train=3, n_eval=1)
    rng = np.random.default_rng(9)
    side = {"depth_filenames": [], "road_mask_filenames": [],
            "all_mask_filenames": [], "error_map_filenames": []}
    for i in range(3):
        np.save(tmp_path / f"d{i}.npy", rng.random((30, 40), np.float32))
        imageio.imwrite(tmp_path / f"r{i}.png",
                        (rng.random((30, 40)) > 0.5).astype(np.uint8) * 255)
        np.save(tmp_path / f"a{i}.npy", rng.random((30, 40), np.float32))
        np.save(tmp_path / f"e{i}.npy", rng.random((15, 20), np.float32))
        for key, name in (("depth_filenames", f"d{i}.npy"),
                          ("road_mask_filenames", f"r{i}.png"),
                          ("all_mask_filenames", f"a{i}.npy"),
                          ("error_map_filenames", f"e{i}.npy")):
            side[key].append(tmp_path / name)

    def with_side(out):
        return dataclasses.replace(out, metadata={**out.metadata, **side})

    jo = with_side(JaxBlender(JaxCfg(data=path)).get_dataparser_outputs(
        "train"))
    to = with_side(build_dataparser("blender", path).get_dataparser_outputs(
        "train"))
    jd, td = JaxDataset(jo), InputDataset(to)
    for i in range(3):
        a, b = td.get_data(i), jd.get_data(i)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    tc, jc = ImageCache(td, num_workers=1), JaxCache(jd, num_workers=1)
    np.testing.assert_array_equal(tc.images, jc.images)
    np.testing.assert_array_equal(tc.road_masks, jc.road_masks)
    assert tc.error_maps.shape == (3, 30, 40)
    np.testing.assert_allclose(tc.error_maps, jc.error_maps, rtol=0,
                               atol=1e-5)


# ---- parsers ----


def _same_outputs(to, jo):
    """Poses and intrinsics exact, file lists equal, the same metadata."""
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
    assert to.dataparser_scale == jo.dataparser_scale
    if jo.dataparser_transform is None:
        assert to.dataparser_transform is None
    else:
        np.testing.assert_array_equal(to.dataparser_transform,
                                      jo.dataparser_transform)
    assert to.metadata == jo.metadata


@pytest.mark.parametrize("rgba", [False, True])
def test_blender_parser_matches_jax(tmp_path, rgba):
    """The blender parser on the JAX package's ``make_blender_fixture``
    (RGB) and on the port's RGBA fixture; the port's RGB fixture equal to
    the JAX package's file for file; the images as the JAX dataset loads
    them, exact."""
    from gfnerf_tpu.data.dataparsers.blender_parser import (
        BlenderDataParser, BlenderDataParserConfig)
    from gfnerf_tpu.data.dataset import InputDataset as JaxDataset
    from gfnerf_tpu.utils.synthetic import make_blender_fixture as jax_fixture
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.dataset import InputDataset
    from gfnerf_tpu_torch.utils.image_io import read_png
    from gfnerf_tpu_torch.utils.synthetic import make_blender_fixture

    if rgba:
        path = make_blender_fixture(tmp_path / "s", 4, 2, rgba=True)
        assert read_png(path / "train" / "r_0.png").shape == (30, 40, 4)
    else:
        path = jax_fixture(tmp_path / "s", n_train=4, n_eval=2)
        mine = make_blender_fixture(tmp_path / "mine", 4, 2)
        for f in sorted(path.rglob("*.png")):
            np.testing.assert_array_equal(
                read_png(mine / f.relative_to(path)), read_png(f))
        for split in ("train", "val", "test"):
            name = f"transforms_{split}.json"
            assert json.loads((mine / name).read_text()) == json.loads(
                (path / name).read_text())
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        jo = BlenderDataParser(BlenderDataParserConfig(
            data=path)).get_dataparser_outputs(split)
        to = build_dataparser("blender", path).get_dataparser_outputs(split)
        assert len(to.cameras) == n
        _same_outputs(to, jo)
        np.testing.assert_array_equal(InputDataset(to).get_image(0),
                                      JaxDataset(jo).get_image(0))


def _nerfstudio_scene(tmp_path, per_frame=True, camera_model=None,
                      distortion=False, images_2=False):
    from gfnerf_tpu_torch.utils.synthetic import ring_cameras

    c2w, fx, fy, cx, cy, w, h = ring_cameras(6, img_wh=(32, 24))
    rng = np.random.default_rng(10)
    frames = []
    for i in rng.permutation(6):   # the parser sorts them by path
        m = np.eye(4)
        m[:3, :4] = c2w[i]
        m[:3, 3] += rng.normal(0, 0.3, 3)
        fr = {"file_path": f"images/f_{i}.png",
              "transform_matrix": m.tolist(),
              "mask_path": f"masks/m_{i}.png",
              "depth_file_path": f"depths/d_{i}.npy"}
        if per_frame:
            fr.update({"fl_x": float(fx[i]) + i, "fl_y": float(fy[i]),
                       "cx": float(cx[i]), "cy": float(cy[i]), "w": w,
                       "h": h})
            if distortion:
                fr.update({"k1": 0.01 * i, "k2": -0.002, "p1": 0.001})
        frames.append(fr)
    meta = {"frames": frames}
    if not per_frame:
        meta.update({"fl_x": 55.0, "fl_y": 56.0, "cx": 16.0, "cy": 12.0,
                     "w": w, "h": h})
        if distortion:
            meta.update({"k1": 0.02, "k3": 0.001, "p2": -0.001})
    if camera_model:
        meta["camera_model"] = camera_model
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    if images_2:
        (tmp_path / "images_2").mkdir()
        for i in range(0, 6, 2):   # some frames have a downscaled copy
            (tmp_path / "images_2" / f"f_{i}.png").write_bytes(b"")
    return tmp_path


NERFSTUDIO_CASES = {
    "vertical": dict(orientation_method="vertical", scale_factor=10.0),
    "up": dict(orientation_method="up"),
    "pca": dict(orientation_method="pca"),
    "none": dict(orientation_method="none", auto_scale_poses=False),
    "focus": dict(center_method="focus", scene_center=(0.1, 0.2, 0.3)),
    "shared-distorted": dict(train_split_fraction=0.5),
    "images_2-fisheye": dict(downscale_factor=2),
    "equirectangular": dict(scene_scale=2.0),
}


@pytest.mark.parametrize("case", sorted(NERFSTUDIO_CASES))
def test_nerfstudio_parser_matches_jax(tmp_path, case):
    """The nerfstudio parser in each orientation and centring method, with
    auto-scale and a scene centre, per-frame and shared intrinsics with
    distortion, a train/eval split, ``images_2`` and the camera models,
    against the JAX package's: exact."""
    import dataclasses

    from gfnerf_tpu.data.dataparsers.nerfstudio_parser import (
        NerfstudioDataParser, NerfstudioDataParserConfig)
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser

    kw = NERFSTUDIO_CASES[case]
    model = {"images_2-fisheye": "OPENCV_FISHEYE",
             "equirectangular": "EQUIRECTANGULAR"}.get(case)
    data = _nerfstudio_scene(tmp_path, per_frame=case != "shared-distorted",
                             camera_model=model,
                             distortion="distorted" in case or case == "up",
                             images_2="images_2" in case)
    port = build_dataparser("nerfstudio", data)
    port.config = dataclasses.replace(port.config, **kw)
    jax_parser = NerfstudioDataParser(NerfstudioDataParserConfig(data=data,
                                                                 **kw))
    for split in ("train", "val"):
        to = port.get_dataparser_outputs(split)
        jo = jax_parser.get_dataparser_outputs(split)
        _same_outputs(to, jo)
    if case == "vertical":   # auto-scale x scale_factor: max |t| == 10
        t = port.get_dataparser_outputs("train").cameras.camera_to_worlds
        assert abs(np.abs(t[:, :, 3]).max() - 10.0) < 1e-3
        assert len(to.cameras) == 1   # the eval split falls back to frame 0
    if case == "images_2-fisheye":
        names = [p.parent.name for p in port.get_dataparser_outputs(
            "train").image_filenames]
        assert names.count("images_2") == 3


@pytest.mark.parametrize("case", ["layout", "fov", "fl", "fisheye",
                                  "json-path"])
def test_instant_ngp_parser_matches_jax(tmp_path, case):
    """The instant-ngp parser against the JAX package's on the layout of
    ``tests/test_extra_parsers.py`` (camera_angle_x, aabb_scale 4, k1), and
    with x_fov/y_fov, fl_x/fl_y, the fisheye flag and the size from the
    PNG headers, and a path to the json itself: exact."""
    from gfnerf_tpu.data.dataparsers.extra_parsers import (
        InstantNGPDataParser, InstantNGPDataParserConfig)
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.utils.image_io import write_png

    frames = []
    for i in range(8):
        fp = f"images/im_{i}.png"
        (tmp_path / "images").mkdir(exist_ok=True)
        write_png(tmp_path / fp, _rgb(i, 6, 8))
        a = 2 * np.pi * i / 8
        c = np.array([4 * np.cos(a), 4 * np.sin(a), 1.5])
        z = c / np.linalg.norm(c)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, np.cross(z, x), z, c
        frames.append({"file_path": fp if i % 2 else fp[:-4],
                       "transform_matrix": m.tolist()})
    meta = {"camera_angle_x": 0.8, "aabb_scale": 4, "w": 8, "h": 6,
            "k1": 0.01, "frames": frames}
    if case == "fov":
        meta = {"x_fov": 50.0, "y_fov": 40.0, "p1": 0.002, "frames": frames}
    elif case == "fl":
        meta.update({"fl_x": 7.0, "fl_y": 6.5, "cx": 3.9, "cy": 3.1})
    elif case == "fisheye":
        meta.update({"is_fisheye": True, "k2": -0.01, "k4": 0.001})
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    data = tmp_path / "transforms.json" if case == "json-path" else tmp_path
    for split in ("train", "val"):
        to = build_dataparser("instant-ngp", data).get_dataparser_outputs(
            split)
        jo = InstantNGPDataParser(InstantNGPDataParserConfig(
            data=data)).get_dataparser_outputs(split)
        _same_outputs(to, jo)
    if case == "layout":
        assert len(to.image_filenames) == 1   # the eval set falls back
        train = build_dataparser("instant-ngp", data).get_dataparser_outputs(
            "train")
        assert len(train.image_filenames) == math.ceil(8 * 0.9)
        np.testing.assert_allclose(train.scene_box.aabb,
                                   [[-2] * 3, [2] * 3])
    if case == "fov":
        assert (int(to.cameras.width[0]), int(to.cameras.height[0])) == (8, 6)


def test_dataparser_registry():
    """``registry`` has the JAX package's twelve names, each with a config
    class of the JAX one's fields and defaults; ``build_dataparser`` builds
    every one (``scale_factor`` where the config has one) and raises
    ValueError for an unknown name."""
    from gfnerf_tpu.data.dataparsers import registry as jax_registry
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser, registry

    reg, jreg = registry(), jax_registry()
    assert sorted(reg) == sorted(jreg) and len(reg) == 12
    for name, (parser_cls, cfg_cls) in reg.items():
        jcfg_cls = jreg[name][1]
        assert parser_cls.__name__ == jreg[name][0].__name__
        got = {f.name: f.default for f in dataclasses.fields(cfg_cls)}
        want = {f.name: f.default for f in dataclasses.fields(jcfg_cls)}
        assert got == want, name
        assert isinstance(build_dataparser(name, Path("x")), parser_cls)
    assert build_dataparser("blender", Path("x"), 0.5).config.scale_factor \
        == 0.5
    assert build_dataparser("dnerf", Path("x"), 0.5).config.scale_factor \
        == 0.5
    assert build_dataparser("phototourism", Path("x")).config.scale_factor \
        == 3.0
    with pytest.raises(ValueError, match="unknown"):
        build_dataparser("no-such-parser", Path("x"))


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


def _cv2_png(path, w=8, h=6):
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), _rgb(0, h, w))


def _same_dynamic_outputs(to, jo):
    """_same_outputs with the metadata's arrays compared exactly."""
    for key in set(to.metadata) | set(jo.metadata):
        a, b = to.metadata.get(key), jo.metadata.get(key)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key
    _same_outputs(dataclasses.replace(to, metadata={}),
                  dataclasses.replace(jo, metadata={}))


@pytest.mark.parametrize("fixture", ["jax-test", "dnerf-fixture"])
def test_dnerf_parser_matches_jax(tmp_path, fixture):
    """The D-NeRF parser on tests/test_extra_parsers.py's test_dnerf layout
    (8x6 PNGs by cv2, times i / 3) and on the port's make_dnerf_fixture
    (RGBA, a moving sphere): cameras exact, times equal, as float32; the
    images as the JAX dataset loads them, exact; the scale factor."""
    import json

    from gfnerf_tpu.data.dataparsers.extra_parsers import (
        DNeRFDataParser, DNeRFDataParserConfig)
    from gfnerf_tpu.data.dataset import InputDataset as JaxDataset
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.dataset import InputDataset
    from gfnerf_tpu_torch.utils.synthetic import make_dnerf_fixture

    if fixture == "jax-test":
        path = tmp_path
        for split in ("train", "val"):
            frames = []
            for i in range(4):
                name = f"{split}_{i}"
                _cv2_png(path / f"{name}.png")
                frames.append({"file_path": f"./{name}",
                               "transform_matrix": _pose(i, 4).tolist(),
                               "time": i / 3.0})
            (path / f"transforms_{split}.json").write_text(
                json.dumps({"camera_angle_x": 0.7, "frames": frames}))
        want = {"train": np.arange(4) / 3.0, "val": np.arange(4) / 3.0}
    else:
        path = make_dnerf_fixture(tmp_path / "s", 6, 3, img_wh=(20, 14),
                                  focal=18.0)
        want = {"train": np.arange(6) % 4 / 3.0, "val": np.arange(3) / 3.0,
                "test": np.arange(3) / 3.0}
    for split, times in want.items():
        for scale in (None, 0.5):
            jo = DNeRFDataParser(DNeRFDataParserConfig(
                data=path, scale_factor=scale or 1.0)).get_dataparser_outputs(
                split)
            to = build_dataparser("dnerf", path, scale).get_dataparser_outputs(
                split)
            _same_dynamic_outputs(to, jo)
        assert to.metadata["times"].dtype == np.float32
        np.testing.assert_allclose(to.metadata["times"], times, atol=1e-6)
        np.testing.assert_array_equal(InputDataset(to).get_image(1),
                                      JaxDataset(jo).get_image(1))


def _dycheck_scene(path, n=3, factor=1, depth=False, val=False):
    """tests/test_extra_parsers.py's test_dycheck layout (extra.json,
    scene.json, splits, a camera file a frame, rgb/{d}x PNGs by cv2), with
    the time ids 0, 2, 4, optionally depth .npy files and a val split."""
    import json

    (path / "extra.json").write_text(json.dumps(
        {"factor": factor, "fps": 30, "bbox": [[-1] * 3, [1] * 3],
         "lookat": [0, 0, 0], "up": [0, 1, 0]}))
    (path / "scene.json").write_text(json.dumps(
        {"center": [0.1, -0.2, 0.3], "scale": 0.5, "near": 0.1,
         "far": 2.0}))
    (path / "splits").mkdir()
    names = [f"0_{i:05d}" for i in range(n)]
    (path / "splits" / "train.json").write_text(json.dumps(
        {"frame_names": names, "time_ids": [2 * i for i in range(n)]}))
    if val:
        (path / "splits" / "val.json").write_text(json.dumps(
            {"frame_names": names[1:], "time_ids": [1, 3][:n - 1]}))
    (path / "camera").mkdir()
    for i, name in enumerate(names):
        pose = _pose(i, n)
        cam = {"orientation": pose[:3, :3].T.tolist(),
               "position": pose[:3, 3].tolist(),
               "focal_length": 350.0, "principal_point": [4.0, 3.0],
               "image_size": [8 * factor, 6 * factor],
               "pixel_aspect_ratio": 1.0 if i else 1.25}
        (path / "camera" / f"{name}.json").write_text(json.dumps(cam))
        _cv2_png(path / "rgb" / f"{factor}x" / f"{name}.png")
        if depth:
            (path / "depth" / f"{factor}x").mkdir(parents=True,
                                                  exist_ok=True)
            np.save(path / "depth" / f"{factor}x" / f"{name}.npy",
                    np.full((6, 8, 1), 0.5 + i, np.float32))
    return path


@pytest.mark.parametrize("case", ["jax-test", "depth-val", "factor-2"])
def test_dycheck_parser_matches_jax(tmp_path, case):
    """The DyCheck parser against the JAX package's: the cameras exact
    (OpenCV to nerfstudio, centred and scaled by the scene's scale), the
    times (time ids over the largest), the depth files, the scene scale;
    a missing val split falls back to train, the extra.json factor picks
    the rgb/{d}x directory; the depth maps as the JAX dataset loads
    them."""
    from gfnerf_tpu.data.dataparsers.extra_parsers import (
        DycheckDataParser, DycheckDataParserConfig)
    from gfnerf_tpu.data.dataset import InputDataset as JaxDataset
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.dataset import InputDataset

    path = _dycheck_scene(tmp_path, depth=case == "depth-val",
                          val=case == "depth-val",
                          factor=2 if case == "factor-2" else 1)
    for split in ("train", "val"):
        jo = DycheckDataParser(DycheckDataParserConfig(
            data=path)).get_dataparser_outputs(split)
        to = build_dataparser("dycheck", path).get_dataparser_outputs(split)
        _same_dynamic_outputs(to, jo)
        if split == "train" or case != "depth-val":
            np.testing.assert_allclose(to.metadata["times"], [0, 0.5, 1.0])
            assert len(to.image_filenames) == 3
        else:
            np.testing.assert_allclose(to.metadata["times"], [1 / 3, 1.0])
        assert to.dataparser_scale == pytest.approx(1.5 / 4 / 2.0)
        assert (to.metadata["depth_filenames"] is None) == (
            case != "depth-val")
        if case == "depth-val":
            a = InputDataset(to).get_data(0)
            b = JaxDataset(jo).get_data(0)
            np.testing.assert_array_equal(a["depth"], b["depth"])
            np.testing.assert_array_equal(a["image"], b["image"])
    if case == "factor-2":
        assert all("/2x/" in str(f) for f in to.image_filenames)
        assert int(to.cameras.width[0]) == 8


# ---- cameras ----


def _camera_pair(camera_type, distortion):
    from gfnerf_tpu.data.dataparsers.base import CamerasHost as JaxHost
    from gfnerf_tpu_torch.data.dataparsers.base import CamerasHost
    from gfnerf_tpu_torch.utils.synthetic import ring_cameras

    c2w, fx, fy, cx, cy, w, h = ring_cameras(5, img_wh=(40, 30))
    n = len(c2w)
    rng = np.random.default_rng(11)
    dist = (np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.01, 0.01, n),
                      rng.uniform(-0.001, 0.001, n),
                      rng.uniform(-0.001, 0.001, n),
                      rng.uniform(-0.002, 0.002, n),
                      rng.uniform(-0.002, 0.002, n)], -1).astype(np.float32)
            if distortion else None)
    kw = dict(camera_to_worlds=c2w, fx=fx * 0.6, fy=fy * 0.6, cx=cx, cy=cy,
              width=np.full(n, w, np.int32), height=np.full(n, h, np.int32),
              distortion_params=dist, camera_type=camera_type)
    return JaxHost(**kw), CamerasHost(**kw)


@pytest.mark.parametrize("case", ["distorted", "fisheye", "equirectangular",
                                  "pinhole"])
def test_generate_rays_multi_matches_jax(case):
    """``generate_rays_multi`` against the JAX package's on 256 random
    pixels of 5 cameras: directions, origins, pixel areas and look-at
    directions within 1e-6.  A distorted camera's rays differ from its
    pinhole rays (the undistortion ran)."""
    from gfnerf_tpu.cameras.cameras import generate_rays_multi as jax_multi
    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi

    ct = {"fisheye": 1, "equirectangular": 2}.get(case, 0)
    jh, th = _camera_pair(ct, case in ("distorted", "fisheye"))
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 5, 256).astype(np.int32)
    coords = np.stack([rng.uniform(0, 30, 256), rng.uniform(0, 40, 256)],
                      -1).astype(np.float32)
    want = jax_multi(jh.to_device(), idx, coords)
    got = generate_rays_multi(th.to_device("cpu"), torch.from_numpy(idx).long(),
                              torch.from_numpy(coords))
    for k in ("origins", "directions", "pixel_area", "lookat_directions"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    if case == "distorted":
        import dataclasses

        pin = generate_rays_multi(
            dataclasses.replace(th, distortion_params=None).to_device("cpu"),
            torch.from_numpy(idx).long(), torch.from_numpy(coords))
        assert (pin["directions"] - got["directions"]).abs().max() > 1e-4


def test_generate_rays_single_camera_does_not_undistort():
    """A reference-side trait kept in the port: ``generate_rays`` (one
    camera; eval and render) does not undistort in the JAX package, and
    the port's matches it (1e-6), so its rays equal the pinhole rays of
    the same camera while ``generate_rays_multi``'s do not."""
    from gfnerf_tpu.cameras.cameras import generate_rays as jax_rays
    from gfnerf_tpu_torch.cameras.cameras import (generate_rays,
                                                  generate_rays_multi,
                                                  get_image_coords)

    jh, th = _camera_pair(0, True)
    coords = get_image_coords(30, 40)
    want = jax_rays(jh.to_device(), 2, coords)
    cams = th.to_device("cpu")
    got = generate_rays(cams, 2, torch.from_numpy(coords))
    for k in ("origins", "directions", "pixel_area", "lookat_directions"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    flat = torch.from_numpy(coords.reshape(-1, 2))
    multi = generate_rays_multi(cams, torch.full((flat.shape[0],), 2), flat)
    assert (multi["directions"] - got["directions"].reshape(-1, 3)
            ).abs().max() > 1e-4


def test_undistortion_roundtrip():
    """Distort normalized coords with the OpenCV model, undistort with the
    port, compare (1e-5, the JAX test's tolerance); equal to the JAX
    package's undistortion to 1e-6."""
    from gfnerf_tpu.utils.camera_utils import (
        radial_and_tangential_undistort_jax)
    from gfnerf_tpu_torch.utils.camera_utils import (
        radial_and_tangential_undistort)

    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.4, 0.4, (64, 2)).astype(np.float32)
    params = np.tile(np.asarray([[0.1, -0.02, 0.003, 0.0005, 0.001, -0.002]],
                                np.float32), (64, 1))
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    k1, k2, k3, k4, p1, p2 = params.T
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    dist = np.stack([xd, yd], -1).astype(np.float32)
    und = radial_and_tangential_undistort(torch.from_numpy(dist),
                                          torch.from_numpy(params)).numpy()
    np.testing.assert_allclose(und, xy, atol=1e-5)
    np.testing.assert_allclose(
        und, np.asarray(radial_and_tangential_undistort_jax(dist, params)),
        rtol=0, atol=1e-6)


def test_auto_orient_matches_jax():
    """``auto_orient_and_center_poses`` in each method and centring, and
    ``rotation_matrix``, against the JAX package's numpy: exact."""
    from gfnerf_tpu.utils import camera_utils as jcu
    from gfnerf_tpu_torch.utils import camera_utils as tcu

    rng = np.random.default_rng(13)
    poses = np.tile(np.eye(4), (7, 1, 1))
    for i in range(7):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        poses[i, :3, :3] = q * np.sign(np.linalg.det(q))
        poses[i, :3, 3] = rng.normal(0, 2, 3)
    for method in ("pca", "up", "vertical", "none"):
        for center in ("poses", "focus", "none"):
            a = tcu.auto_orient_and_center_poses(poses.copy(), method, center)
            b = jcu.auto_orient_and_center_poses(poses.copy(), method, center)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        tcu.rotation_matrix(np.array([0.2, 0.3, 0.9]), np.array([0, 0, 1.0])),
        jcu.rotation_matrix(np.array([0.2, 0.3, 0.9]), np.array([0, 0, 1.0])))


# ---- pixel samplers ----


def test_equirect_pixel_sampler(tmp_path):
    """The equirectangular sampler's indices equal the JAX sampler's on the
    same seed; its rows follow sin(theta) (mid rows sampled more than
    twice as often as pole rows, as test_components.py's
    test_equirect_pixel_sampler states); ``set_num_rays_per_batch``."""
    from gfnerf_tpu.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu.data.dataset import ImageCache as JaxCache
    from gfnerf_tpu.data.dataset import InputDataset as JaxDataset
    from gfnerf_tpu.data.pixel_samplers import (
        EquirectangularPixelSampler as JaxSampler)
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.dataset import ImageCache, InputDataset
    from gfnerf_tpu_torch.data.pixel_samplers import (
        EquirectangularPixelSampler)
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = make_synthetic_npz(tmp_path / "scene", n_train=2, n_val=1,
                              img_wh=(64, 64))
    cache = ImageCache(InputDataset(build_dataparser(
        "minimal", path).get_dataparser_outputs("train")), seed=0)
    jcache = JaxCache(JaxDataset(MinimalDataParser(MinimalDataParserConfig(
        data=path)).get_dataparser_outputs("train")), seed=0)
    s, js = EquirectangularPixelSampler(20000, seed=0), JaxSampler(20000,
                                                                  seed=0)
    idx = s.sample_indices(cache)
    np.testing.assert_array_equal(idx, js.sample_indices(jcache))
    ys, h = idx[:, 1], 64
    pole = np.sum((ys < h // 8) | (ys >= h - h // 8))
    mid = np.sum((ys >= 3 * h // 8) & (ys < 5 * h // 8))
    assert mid > 2 * pole
    assert ys.min() >= 0 and ys.max() < h
    s.set_num_rays_per_batch(128)
    js.set_num_rays_per_batch(128)
    np.testing.assert_array_equal(s.sample(cache)["coords"],
                                  js.sample(jcache)["coords"])
