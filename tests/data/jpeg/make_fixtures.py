"""Write the JPEG fixtures of this directory and imageio's decodes of them.

  python tests/data/jpeg/make_fixtures.py

The pixels are the port's ring scene (``utils/synthetic._ring_scene``) at
160x120 with seeded noise; the files come from Pillow and cv2 (both over
libjpeg-turbo) in the modes a capture holds: baseline 4:2:0, optimized
Huffman tables, progressive (Pillow's and cv2's scan scripts), restart
intervals, 4:2:2 and grey.  ``decodes.npz`` holds ``imageio.v2.imread``'s
pixels of each file, keyed by its stem: what the JAX package reads.
``chip_smoke.py`` and ``tests/test_torch_jpeg.py`` hold the port's codec
against them.
"""

from __future__ import annotations

import io
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def pixels() -> np.ndarray:
    sys.path.insert(0, str(HERE.parents[2]))
    from gfnerf_tpu_torch.utils.synthetic import _ring_scene

    _, _, imgs = _ring_scene(4, (160, 120), 140.0, sky=True)
    noise = np.random.default_rng(20).normal(0.0, 6.0, imgs[1].shape)
    return np.clip(imgs[1].astype(np.float64) + noise, 0, 255).astype(
        np.uint8)


def main():
    import cv2
    import imageio.v2 as imageio
    from PIL import Image

    img = pixels()
    bgr = np.ascontiguousarray(img[..., ::-1])

    def pil(**kw):
        out = io.BytesIO()
        Image.fromarray(kw.pop("src", img)).save(out, "JPEG", **kw)
        return out.getvalue()

    def cv(flags, src=bgr):
        ok, enc = cv2.imencode(".jpg", src, flags)
        assert ok
        return enc.tobytes()

    files = {
        "pil_q90_420": pil(quality=90),
        "pil_q75_optimize": pil(quality=75, optimize=True),
        "pil_q85_progressive": pil(quality=85, progressive=True),
        "cv2_q90_progressive": cv([cv2.IMWRITE_JPEG_QUALITY, 90,
                                   cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
        "cv2_q80_422_restart": cv([
            cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
        "pil_q70_grey": pil(quality=70, src=img[..., 1]),
    }
    decodes = {}
    for stem, data in files.items():
        (HERE / f"{stem}.jpg").write_bytes(data)
        decodes[stem] = np.asarray(imageio.imread(io.BytesIO(data)))
    np.savez_compressed(HERE / "decodes.npz", **decodes)


if __name__ == "__main__":
    main()
