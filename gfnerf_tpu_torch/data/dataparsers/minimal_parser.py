"""Minimal .npz dataparser — the test-fixture mechanism.

Port of ``gfnerf_tpu/data/dataparsers/minimal_parser.py`` (the reference's
MinimalDataParser): a {split}.npz holding images and camera arrays, so a
run needs no image decoding.  Unlike the reference's, which names every
image after the npz (so that the error maps of all views land in one file,
each overwriting the one before), the port names image i of ``train.npz``
``train.npz#i``.

npz keys: images (N,H,W,3) uint8 or float, c2w (N,3,4), fx fy cx cy (N,),
optionally bounds (N,2) and road_masks (N,H,W) (class labels, 0 and 1 for
the reference's road masks), the semantics' labels.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import (
    CamerasHost,
    DataParser,
    DataparserOutputs,
    SceneBox,
)


@dataclasses.dataclass
class MinimalDataParserConfig:
    data: Path = Path(".")


class MinimalDataParser(DataParser):
    config: MinimalDataParserConfig

    def _generate_dataparser_outputs(self, split="train"):
        data_dir = Path(self.config.data)
        path = data_dir / f"{split}.npz"
        if not path.exists():
            path = data_dir / "train.npz"
        data = np.load(path)
        images = data["images"]
        n, h, w = images.shape[:3]
        cameras = CamerasHost(
            camera_to_worlds=data["c2w"].astype(np.float32),
            fx=data["fx"].astype(np.float32),
            fy=data["fy"].astype(np.float32),
            cx=data["cx"].astype(np.float32),
            cy=data["cy"].astype(np.float32),
            width=np.full(n, w, np.int32),
            height=np.full(n, h, np.int32),
        )
        scene_box = SceneBox(aabb=np.array([[-4.0] * 3, [4.0] * 3], np.float32))
        return DataparserOutputs(
            # the images come from the npz, not from disk; each has a name
            # of its own (``train.npz#3``), which names its error map
            image_filenames=[path.with_name(f"{path.name}#{i}")
                             for i in range(n)],
            cameras=cameras,
            scene_box=scene_box,
            metadata={
                "images_array": images,
                "road_masks_array": (data["road_masks"]
                                     if "road_masks" in data else None),
                "bounds": data["bounds"] if "bounds" in data else None,
                "global_image_indices": list(range(n)),
            },
        )
