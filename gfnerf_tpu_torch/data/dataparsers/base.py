"""Dataparser base types.

Port of ``gfnerf_tpu/data/dataparsers/base.py`` (nerfstudio's
``base_dataparser.py`` and ``scene_box.py``): a dataparser turns an on-disk
dataset into cameras, filenames and a scene box, host-side numpy only;
``CamerasHost.to_device`` builds the port's :class:`Cameras`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from gfnerf_tpu_torch.cameras.cameras import Cameras


@dataclasses.dataclass
class SceneBox:
    """Axis-aligned scene bounds. aabb: (2, 3) [min; max]."""

    aabb: np.ndarray

    def side_lengths(self) -> np.ndarray:
        return self.aabb[1] - self.aabb[0]


@dataclasses.dataclass
class CamerasHost:
    """Host (numpy) camera batch; ``to_device`` yields the port's
    :class:`Cameras` on a device."""

    camera_to_worlds: np.ndarray  # (N, 3, 4)
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: np.ndarray
    height: np.ndarray
    distortion_params: Optional[np.ndarray] = None  # (N, 6)
    camera_type: int = 0

    def __len__(self):
        return len(self.camera_to_worlds)

    def __getitem__(self, idx):
        return CamerasHost(
            camera_to_worlds=self.camera_to_worlds[idx],
            fx=self.fx[idx], fy=self.fy[idx],
            cx=self.cx[idx], cy=self.cy[idx],
            width=self.width[idx], height=self.height[idx],
            distortion_params=(self.distortion_params[idx]
                               if self.distortion_params is not None
                               else None),
            camera_type=self.camera_type)

    def intrinsics_matrices(self) -> np.ndarray:
        n = len(self)
        k = np.zeros((n, 3, 3), np.float32)
        k[:, 0, 0] = self.fx
        k[:, 1, 1] = self.fy
        k[:, 0, 2] = self.cx
        k[:, 1, 2] = self.cy
        k[:, 2, 2] = 1.0
        return k

    def to_device(self, device="cuda") -> Cameras:
        return Cameras.from_numpy(self.camera_to_worlds, self.fx, self.fy,
                                  self.cx, self.cy, self.width, self.height,
                                  device=device,
                                  distortion_params=self.distortion_params,
                                  camera_type=self.camera_type)


@dataclasses.dataclass
class DataparserOutputs:
    """What a dataparser produces (reference DataparserOutputs)."""

    image_filenames: List[Path]
    cameras: CamerasHost
    scene_box: SceneBox
    mask_filenames: Optional[List[Path]] = None
    dataparser_scale: float = 1.0
    dataparser_transform: Optional[np.ndarray] = None  # (3, 4)
    metadata: Dict = dataclasses.field(default_factory=dict)

    def select(self, indices) -> "DataparserOutputs":
        """Sub-select cameras/images (used for init/split datasets,
        base_datamanager.py:660-715)."""
        indices = list(np.asarray(indices).tolist())

        def sel_list(lst):
            return None if lst is None else [lst[i] for i in indices]

        md = dict(self.metadata)
        for key in ("depth_filenames", "normal_filenames",
                    "road_mask_filenames", "all_mask_filenames",
                    "global_image_indices", "error_map_filenames"):
            if md.get(key) is not None:
                md[key] = sel_list(md[key])
        return DataparserOutputs(
            image_filenames=sel_list(self.image_filenames),
            cameras=self.cameras[np.asarray(indices)],
            scene_box=self.scene_box,
            mask_filenames=sel_list(self.mask_filenames),
            dataparser_scale=self.dataparser_scale,
            dataparser_transform=self.dataparser_transform,
            metadata=md,
        )


class DataParser:
    """Base class; subclasses implement _generate_dataparser_outputs."""

    def __init__(self, config):
        self.config = config

    def get_dataparser_outputs(self, split: str = "train") -> DataparserOutputs:
        return self._generate_dataparser_outputs(split)

    def _generate_dataparser_outputs(self, split: str) -> DataparserOutputs:
        raise NotImplementedError
