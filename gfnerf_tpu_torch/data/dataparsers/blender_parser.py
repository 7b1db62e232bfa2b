"""Blender synthetic dataset parser.

Port of ``gfnerf_tpu/data/dataparsers/blender_parser.py`` (nerfstudio's
``blender_dataparser.py``): ``transforms_{split}.json`` with a shared
``camera_angle_x``; RGBA frames (800x800 in the published scenes)
composited over ``alpha_color`` when loaded.  The image size comes from
the first frame's PNG header (``image_io.image_size``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from gfnerf_tpu_torch.data.dataparsers.base import (
    CamerasHost,
    DataParser,
    DataparserOutputs,
    SceneBox,
)
from gfnerf_tpu_torch.utils.image_io import image_size


@dataclasses.dataclass
class BlenderDataParserConfig:
    data: Path = Path(".")
    scale_factor: float = 1.0
    alpha_color: str = "white"


class BlenderDataParser(DataParser):
    config: BlenderDataParserConfig

    def _generate_dataparser_outputs(self, split="train"):
        cfg = self.config
        data_dir = Path(cfg.data)
        if split in ("val", "test") and not (
            data_dir / f"transforms_{split}.json"
        ).exists():
            split = "val" if (data_dir / "transforms_val.json").exists() else "train"
        meta = json.loads((data_dir / f"transforms_{split}.json").read_text())

        image_filenames, poses = [], []
        for frame in meta["frames"]:
            fname = data_dir / Path(frame["file_path"].replace("./", "") + ".png")
            if not fname.exists():
                fname = data_dir / Path(frame["file_path"])
            image_filenames.append(fname)
            poses.append(np.array(frame["transform_matrix"], dtype=np.float32))
        poses = np.stack(poses)
        poses[:, :3, 3] *= cfg.scale_factor

        w, h = image_size(image_filenames[0])
        camera_angle_x = float(meta["camera_angle_x"])
        focal = 0.5 * w / np.tan(0.5 * camera_angle_x)

        n = len(image_filenames)
        cameras = CamerasHost(
            camera_to_worlds=poses[:, :3, :4],
            fx=np.full(n, focal, np.float32),
            fy=np.full(n, focal, np.float32),
            cx=np.full(n, w / 2.0, np.float32),
            cy=np.full(n, h / 2.0, np.float32),
            width=np.full(n, w, np.int32),
            height=np.full(n, h, np.int32),
        )
        scene_box = SceneBox(aabb=np.array([[-1.5] * 3, [1.5] * 3], np.float32))
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=scene_box,
            dataparser_scale=cfg.scale_factor,
            metadata={
                "alpha_color": cfg.alpha_color,
                "global_image_indices": list(range(n)),
                "depth_filenames": None, "normal_filenames": None,
                "road_mask_filenames": None, "all_mask_filenames": None,
                "depth_unit_scale_factor": 1e-3,
            },
        )
