"""Checkpoint loading for eval and render.

Port of ``gfnerf_tpu/utils/eval_utils.py`` (nerfstudio's
``eval_utils.py``): ``eval_setup`` reads a training run's ``config.json``,
rebuilds its pipeline in test mode on the checkpoint's octree and march
config (the resume path: no octree build, no calibration) and loads the
latest checkpoint; without a dataparser's name it guesses one from the
data directory (``transforms.json``: nerfstudio; ``transforms_train.json``:
dnerf where its frames carry a ``time``, else blender; ``scene.json`` with
``splits/``: dycheck; else minimal).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def eval_setup(config_path: Path, dataparser_name: Optional[str] = None):
    """(config, trainer) of the run whose ``config.json`` is
    ``config_path``, its pipeline holding the run's latest checkpoint, on
    the run's device."""
    from gfnerf_tpu_torch.configs.config_io import config_from_json
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer

    config_path = Path(config_path)
    config = config_from_json(config_path.read_text())
    base_dir = config_path.parent
    config.load_dir = base_dir / "nerfstudio_models"
    # outputs stay in the run's directory (its timestamp already fixed)
    config.output_dir = base_dir.parent.parent.parent
    config.experiment_name = base_dir.parent.parent.name
    config.timestamp = base_dir.name
    name = dataparser_name
    if name is None:
        # guessed from the data's layout
        name = guess_dataparser(Path(config.data))
    dataparser = build_dataparser(name, Path(config.data))
    trainer = Trainer(config, dataparser)
    trainer.setup(test_mode="test")
    return config, trainer


def guess_dataparser(data: Path) -> str:
    """The dataparser a data directory's layout names: the JAX package's
    guess (nerfstudio, blender, minimal) with the dynamic formats told
    apart (a Blender layout whose frames carry times is D-NeRF's)."""
    import json

    if (data / "transforms.json").exists():
        return "nerfstudio"
    if (data / "transforms_train.json").exists():
        frames = json.loads((data / "transforms_train.json").read_text())[
            "frames"]
        return "dnerf" if frames and "time" in frames[0] else "blender"
    if (data / "scene.json").exists() and (data / "splits").is_dir():
        return "dycheck"
    return "minimal"
