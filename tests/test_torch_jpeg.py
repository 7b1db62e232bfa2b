"""The port's JPEG codec (``gfnerf_tpu_torch/csrc/jpeg/``, wrapped by
``gfnerf_tpu_torch/utils/jpeg.py``) on the CPU, where it builds with g++.

- Decoder: every fixture, written here by Pillow and cv2 (both over
  libjpeg-turbo), decodes to exactly the pixels ``imageio.v2.imread`` gives
  (what the JAX package reads): baseline at qualities 50, 75 and 95 at
  4:4:4, 4:2:2, 4:2:0 and grey; restart intervals; optimized Huffman
  tables; Pillow's and cv2's progressive scan scripts; 4:4:0 and 4:1:1; at
  1x1, 17x9 and 53x37 (MCU padding cropped off, the edge columns and rows
  of the fancy upsampling).  No mode needed a tolerance.  The plain numpy
  version (``decode_jpeg_reference``) equals the C++ bit for bit on each,
  and both agree with the committed fixtures of ``tests/data/jpeg`` (the
  ones ``chip_smoke.py`` holds on the card).  EXIF orientation is not
  applied, as in imageio.
- Encoder: ``encode_jpeg`` equals ``encode_jpeg_reference`` byte for byte,
  its quantisation tables are Pillow's at the same quality, and Pillow
  decodes its files to what ``decode_jpeg`` decodes.
- Refusals: arithmetic coding, 12-bit samples, lossless and hierarchical
  frames and CMYK raise ``ValueError`` naming the feature, in both
  versions; a file cut short raises.
- ``read_image`` decodes a JPEG through the codec with imageio, cv2 and PIL
  out of reach, from threads at once too; with the codec's build made to
  fail it raises.
- A Phototourism capture of the port's JPEGs (quality 95, 4:2:0): the
  port's datamanager images equal the JAX datamanager's (exactly at full
  size; 1e-5 at half size, the PNG path's resize tolerance), and 6 steps
  of the port's pipeline hold against the JAX pipeline's
  (tests/torch_pipeline_ref.py with ``phototourism``, in a process of its
  own, its draws handed over) at tests/test_torch_pipeline.py's
  tolerances: batches exact, losses to 1e-4, the eval PSNR to 1e-5, and
  at most 10% of a parameter's entries off by more than 1e-4, none by
  more than 2e-2.
"""

from __future__ import annotations

import concurrent.futures
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (two CPU threads per worker)

DATA = Path(__file__).with_name("data") / "jpeg"
SIZES = [(1, 1), (9, 17), (37, 53)]          # (h, w)
SIZE_IDS = ["1x1", "17x9", "53x37"]
PIPELINE_STEPS = 6


def _image(h, w, seed=0) -> np.ndarray:
    """A smooth colour field with noise: both flat and busy blocks."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c)
                     for c in range(3)], -1)
    base += np.random.default_rng(seed).normal(0, 20, base.shape)
    return np.clip(base, 0, 255).astype(np.uint8)


def _pil(img, **kw) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", **kw)
    return out.getvalue()


def _cv2(img, flags) -> bytes:
    import cv2

    ok, enc = cv2.imencode(".jpg", img, flags)
    assert ok
    return enc.tobytes()


def _imageio(data: bytes) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(io.BytesIO(data)))


def _check(data: bytes) -> np.ndarray:
    """decode_jpeg against imageio exactly and against its plain version
    bit for bit; the decoded pixels."""
    from gfnerf_tpu_torch.utils.jpeg import (decode_jpeg,
                                             decode_jpeg_reference)

    got = decode_jpeg(data)
    want = _imageio(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_jpeg_reference(data), got)
    return got


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    for name in ("cv2", "PIL", "imageio"):
        pytest.importorskip(name)


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_baseline_matches_imageio(size, quality, sampling):
    img = _image(*size, seed=quality)
    if sampling == "grey":
        data = _pil(img[..., 0], quality=quality)
    else:
        data = _pil(img, quality=quality, subsampling=sampling)
    assert b"\xff\xc0" in data
    _check(data)


def _mode(kind, img):
    import cv2

    factor = {"440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
              "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
              "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}
    return {
        "cv2-restart": lambda: _cv2(img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
        "pil-optimize": lambda: _pil(img, quality=80, optimize=True),
        "pil-progressive": lambda: _pil(img, quality=80, progressive=True),
        "pil-progressive-444-optimize": lambda: _pil(
            img, quality=90, subsampling=0, progressive=True, optimize=True),
        "pil-progressive-grey": lambda: _pil(img[..., 0], quality=80,
                                             progressive=True),
        "cv2-progressive": lambda: _cv2(img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                              1]),
        "cv2-440": lambda: _cv2(img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      factor["440"]]),
        "cv2-411": lambda: _cv2(img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      factor["411"]]),
        "cv2-422-restart-progressive": lambda: _cv2(img, [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor["422"],
            cv2.IMWRITE_JPEG_RST_INTERVAL, 2, cv2.IMWRITE_JPEG_PROGRESSIVE,
            1]),
        "cv2-grey-restart": lambda: _cv2(img[..., 0], [
            cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
    }[kind]()


MODES = ["cv2-restart", "pil-optimize", "pil-progressive",
         "pil-progressive-444-optimize", "pil-progressive-grey",
         "cv2-progressive", "cv2-440", "cv2-411",
         "cv2-422-restart-progressive", "cv2-grey-restart"]


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("kind", MODES)
def test_modes_match_imageio(size, kind):
    data = _mode(kind, _image(*size, seed=len(kind)))
    assert (b"\xff\xc2" in data) == ("progressive" in kind)
    assert (b"\xff\xdd" in data) == ("restart" in kind)
    _check(data)


@pytest.mark.parametrize("kind", ["pil-progressive-444-optimize",
                                  "cv2-422-restart-progressive",
                                  "pil-optimize"])
def test_larger_images_match_imageio(kind):
    """160x120: many blocks a scan, long end-of-band runs and refinement
    bits on already-nonzero coefficients."""
    _check(_mode(kind, _image(120, 160, seed=3)))


def test_committed_fixtures():
    """tests/data/jpeg (written by its make_fixtures.py): each file against
    the imageio decode stored beside it, and against imageio here."""
    want = np.load(DATA / "decodes.npz")
    files = sorted(DATA.glob("*.jpg"))
    assert sorted(f.stem for f in files) == sorted(want.files)
    assert any(b"\xff\xc2" in f.read_bytes() for f in files)
    for f in files:
        np.testing.assert_array_equal(_check(f.read_bytes()), want[f.stem],
                                      err_msg=f.name)


def test_exif_orientation_not_applied(tmp_path):
    """A 40x20 image with EXIF orientation 6 (rotate 90) decodes as stored,
    (20, 40, 3), as imageio.v2.imread gives it."""
    from PIL import Image

    from gfnerf_tpu_torch.utils.image_io import read_image

    exif = Image.Exif()
    exif[0x0112] = 6
    path = tmp_path / "rot.jpg"
    Image.fromarray(_image(20, 40)).save(path, exif=exif)
    got = read_image(path)
    assert got.shape == (20, 40, 3)
    np.testing.assert_array_equal(got, _imageio(path.read_bytes()))


def _dqt(data: bytes) -> dict:
    """{table index: 64 values in zigzag order} of a JPEG's DQT
    segments."""
    out, pos = {}, 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDB:
            seg, p = data[pos + 4:pos + 2 + n], 0
            while p < len(seg):
                out[seg[p] & 15] = list(seg[p + 1:p + 65])
                p += 65
        pos += 2 + n
    return out


@pytest.mark.parametrize("size", SIZES + [(48, 64)],
                         ids=SIZE_IDS + ["64x48"])
@pytest.mark.parametrize("quality", [10, 50, 90, 100])
@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4", "grey"])
def test_encoder_matches_plain_and_pillow(size, quality, sampling):
    from PIL import Image

    from gfnerf_tpu_torch.utils.jpeg import (decode_jpeg, encode_jpeg,
                                             encode_jpeg_reference)

    img = _image(*size, seed=quality)
    src = img[..., 0] if sampling == "grey" else img
    sub = "4:2:0" if sampling == "grey" else sampling
    data = encode_jpeg(src, quality, sub)
    assert data == encode_jpeg_reference(src, quality, sub)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    assert b"\xff\xc0" in data and b"JFIF\0" in data[:20]
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(decode_jpeg(data), pil)
    assert _dqt(data) == _dqt(_pil(src, quality=quality))


def test_encoder_quality():
    """Quality 90 at both samplings on a smooth field: the round trip's
    PSNR, and 4:4:4 at least 4:2:0's."""
    from gfnerf_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    y, x = np.mgrid[0:96, 0:128]
    img = np.clip(np.stack([128 + 90 * np.sin(x / 11.0 + c) * np.cos(
        y / 9.0) for c in range(3)], -1), 0, 255).astype(np.uint8)
    psnr = {}
    for sub in ("4:2:0", "4:4:4"):
        out = decode_jpeg(encode_jpeg(img, 90, sub)).astype(np.float64)
        psnr[sub] = 10 * np.log10(255 ** 2 / np.mean((out - img) ** 2))
    assert psnr["4:2:0"] > 38.0 and psnr["4:4:4"] >= psnr["4:2:0"], psnr


def _patched(data: bytes, at: bytes, new: bytes) -> bytes:
    i = data.index(at)
    return data[:i] + new + data[i + len(new):]


@pytest.mark.parametrize("feature", ["arithmetic coding", "12-bit",
                                     "lossless", "hierarchical", "CMYK"])
def test_refused_modes_raise(feature):
    from PIL import Image

    from gfnerf_tpu_torch.utils.jpeg import (decode_jpeg,
                                             decode_jpeg_reference, jpeg_info)

    base = _pil(_image(16, 16), quality=90)
    if feature == "CMYK":
        out = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(
            out, "JPEG")
        data = out.getvalue()
    elif feature == "12-bit":
        i = base.index(b"\xff\xc0")
        data = base[:i + 4] + bytes([12]) + base[i + 5:]
    else:
        marker = {"arithmetic coding": b"\xff\xc9", "lossless": b"\xff\xc3",
                  "hierarchical": b"\xff\xc5"}[feature]
        data = _patched(base, b"\xff\xc0", marker)
    for fn in (decode_jpeg, decode_jpeg_reference, jpeg_info):
        with pytest.raises(ValueError, match=feature):
            fn(data)


@pytest.mark.parametrize("cut", ["header", "scan", "eoi"])
def test_truncated_raises(cut):
    from gfnerf_tpu_torch.utils.jpeg import (decode_jpeg,
                                             decode_jpeg_reference)

    for data in (_pil(_image(37, 53), quality=90),
                 _pil(_image(37, 53), quality=90, progressive=True)):
        end = {"header": data.index(b"\xff\xc4") + 10,
               "scan": len(data) // 2 + 40, "eoi": len(data) - 2}[cut]
        for fn in (decode_jpeg, decode_jpeg_reference):
            with pytest.raises(ValueError, match="truncated"):
                fn(data[:end])


def test_read_image_without_image_libraries(tmp_path, monkeypatch):
    """read_image and image_size of a JPEG, and encode_jpeg, with imageio,
    cv2 and PIL set to None in sys.modules (the card's machine has none of
    them); a BMP still needs imageio and says so."""
    from gfnerf_tpu_torch.utils import image_io
    from gfnerf_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    data = _pil(_image(37, 53), quality=85, progressive=True)
    (tmp_path / "a.jpg").write_bytes(data)
    want = _imageio(data)
    import cv2

    cv2.imwrite(str(tmp_path / "a.bmp"), _image(4, 4))
    with monkeypatch.context() as m:
        for name in ("imageio", "imageio.v2", "cv2", "PIL", "PIL.Image"):
            m.setitem(sys.modules, name, None)
        np.testing.assert_array_equal(image_io.read_image(tmp_path / "a.jpg"),
                                      want)
        assert image_io.image_size(tmp_path / "a.jpg") == (53, 37)
        enc = encode_jpeg(want, 90)
        np.testing.assert_array_equal(
            decode_jpeg(enc), decode_jpeg(encode_jpeg(want, 90)))
        with pytest.raises(NotImplementedError, match="imageio"):
            image_io.read_image(tmp_path / "a.bmp")
    (tmp_path / "cut.jpg").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="cut.jpg: truncated"):
        image_io.read_image(tmp_path / "cut.jpg")


def test_decode_on_threads():
    """The C entry points are reentrant and run without the GIL: a thread
    pool decodes 12 files to what one thread decodes."""
    from gfnerf_tpu_torch.utils.jpeg import decode_jpeg

    files = [_mode(kind, _image(48, 64, seed=i))
             for i, kind in enumerate(MODES + MODES[:2])]
    serial = [decode_jpeg(f) for f in files]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        pooled = list(ex.map(decode_jpeg, files))
    for a, b in zip(serial, pooled):
        np.testing.assert_array_equal(a, b)


def test_failed_codec_build_raises(tmp_path, monkeypatch):
    """With the compiler refusing the build (an unknown flag), read_image
    of a JPEG raises; nothing falls back to imageio."""
    from gfnerf_tpu_torch.ops import build
    from gfnerf_tpu_torch.utils.image_io import read_image

    (tmp_path / "a.jpg").write_bytes(_pil(_image(8, 8), quality=90))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "JPEG_LIB_PATH",
                        tmp_path / "build" / "libgfnerf_jpeg.so")
    monkeypatch.setattr(build, "CXX_FLAGS",
                        build.CXX_FLAGS + ["--no-such-flag"])
    build._load_jpeg.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="JPEG codec build failed"):
            read_image(tmp_path / "a.jpg")
    finally:
        build._load_jpeg.cache_clear()


# ---- a capture of JPEGs through both packages ----


@pytest.fixture(scope="module", autouse=True)
def capture(tmp_path_factory, _libraries):
    """A 12-view Phototourism capture of the port's JPEGs at 32x24, and
    the JAX pipeline's run on it, started in the background with the
    module's first test."""
    from gfnerf_tpu_torch.utils.synthetic import make_phototourism_fixture

    tmp = tmp_path_factory.mktemp("jpeg_capture")
    data = make_phototourism_fixture(tmp / "s", 12, (32, 24), 28.0,
                                     image_format="jpeg")
    script = Path(__file__).with_name("torch_pipeline_ref.py")
    proc = subprocess.Popen(
        [sys.executable, str(script), str(data), str(tmp),
         str(PIPELINE_STEPS), "128", "8", "anchored", "phototourism"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield data, tmp, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_jpeg_capture_images_match_jax(capture, scale):
    from test_torch_captures import _datamanagers, _parser_pair
    from test_torch_data import assert_batches_equal

    data, _, _ = capture
    files = sorted((data / "dense" / "images").iterdir())
    assert files and all(f.suffix == ".jpg" for f in files)
    tdm, jdm = _datamanagers(_parser_pair("phototourism", data, {}),
                             camera_res_scale_factor=scale)
    atol = 0 if scale == 1.0 else 1e-5
    shape = (24, 32, 3) if scale == 1.0 else (12, 16, 3)
    assert tdm.init_cache.images.shape[1:] == shape
    np.testing.assert_allclose(tdm.init_cache.images, jdm.init_cache.images,
                               rtol=0, atol=atol)
    _, got = tdm.next_eval_image(0)
    _, want = jdm.next_eval_image(0)
    np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                               atol=atol)
    for step in range(2):
        got, want = tdm.next_train(step), jdm.next_train(step)
        np.testing.assert_allclose(got.pop("image"), want.pop("image"),
                                   rtol=0, atol=atol)
        assert_batches_equal(got, want)


def test_jpeg_capture_pipeline_matches_jax(capture, tmp_path):
    from test_torch_captures import _parser_pair
    from test_torch_pipeline import tiny_config

    data, out, proc = capture
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log.decode()[-4000:]
    ref = dict(np.load(out / "ref.npz"))
    cfg = tiny_config(data, tmp_path, iterations=PIPELINE_STEPS)
    parser, _ = _parser_pair("phototourism", data, {})
    p = cfg.pipeline.build(parser, tmp_path, device="cpu",
                           draws=lambda step, r, s: (ref["noise"][step],
                                                     ref["perms"][step]))
    assert p.sampler.sampler_config.sample_l == pytest.approx(
        float(ref["sample_l"]), rel=1e-6)
    batches, losses = [], []
    next_train = p.datamanager.next_train

    def recording_next_train(step):
        batch = next_train(step)
        batches.append(batch["indices"].copy())
        return batch

    p.datamanager.next_train = recording_next_train
    psnr = {}
    for step in range(PIPELINE_STEPS):
        m = p.get_train_loss_dict(step)
        losses.append([m["loss"], m["rgb_loss"], m["s3im_loss"]])
        p.after_train_iteration(step)
        if (step + 1) % cfg.steps_per_eval_batch == 0 or \
                step == PIPELINE_STEPS - 1:
            psnr[f"eval_psnr{step}"] = p.get_eval_loss_dict(step)[
                "eval_psnr"]
    np.testing.assert_array_equal(np.stack(batches), ref["indices"])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    assert sorted(psnr) == sorted(k for k in ref if k.startswith("eval_"))
    for k, v in psnr.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-5)
    params, _ = p.field.to_numpy()
    got = {"global_feat": params.global_feat,
           "block_feats": params.block_feats,
           "appearance_embedding": params.appearance_embedding}
    for name in ("base_net", "mlp_head"):
        for part in ("w", "b"):
            for i, x in enumerate(getattr(params, name)[part]):
                got[f"{name}_{part}{i}"] = x
    for k, a in got.items():
        diff = np.abs(a - ref[k])
        assert (diff > 1e-4).mean() <= 0.1, (k, (diff > 1e-4).mean())
        assert diff.max() <= 2e-2, (k, diff.max())
