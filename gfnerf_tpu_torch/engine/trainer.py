"""Trainer: the outer loop, checkpoints, eval cadence, logging.

Port of ``gfnerf_tpu/engine/trainer.py`` (nerfstudio's ``trainer.py``,
:90-479): setup (pipeline, config file, writer, checkpoint),
the train loop with the pipeline's after-iteration callbacks, the periodic
eval, and checkpoints in ``step-{:09d}`` directories pruned to the latest.
The run's config is written as ``config.json``.  The pipeline is either
kind the config names: GF-NeRF's or the vanilla one (which has no eval ray
batch).  With ``vis`` "viewer" the web viewer serves renders and the
training controls (pause, resume, stop and save) from its own threads
while the loop trains; each step and each render hold one lock, because
the optimizer updates the tables in place.  Eval images of depth and
accumulation go to the writer colormapped.

In a process group of several ranks (``initialize_multihost``; the
GF-NeRF pipeline only) every rank runs the loop; rank 0 alone writes the
config, the logs, the evals and the checkpoints (in the one-card format,
which ``eval``, ``render`` and ``export`` read as they are), while the
others wait at a barrier; the run's directory is rank 0's.  The viewer
does not run over several ranks.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

from gfnerf_tpu_torch.configs.config_io import config_to_json
from gfnerf_tpu_torch.parallel import comm as parallel_comm
from gfnerf_tpu_torch.pipelines.pipeline import GFNerfPipelineConfig
from gfnerf_tpu_torch.utils.colormaps import (apply_colormap,
                                              apply_depth_colormap)
from gfnerf_tpu_torch.utils.writer import (ETA, ITER_TRAIN_TIME,
                                           TRAIN_RAYS_PER_SEC, EventWriter,
                                           TimeWriter)
from gfnerf_tpu_torch.viewer.server import TrainControl, ViewerServer


@dataclasses.dataclass
class TrainerConfig:
    method_name: str = "gf-nerf"
    experiment_name: Optional[str] = None
    timestamp: str = "{timestamp}"
    output_dir: Path = Path("outputs")
    max_num_iterations: int = 130000
    steps_per_eval_batch: int = 1000
    steps_per_eval_image: int = 5000
    steps_per_save: int = 2000
    steps_per_log: int = 10
    save_only_latest_checkpoint: bool = True
    load_dir: Optional[Path] = None
    load_step: Optional[int] = None
    vis: str = "local"           # "local" or "viewer"
    viewer_port: int = 7007
    data: Optional[Path] = None
    device: str = "cuda"
    # GFNerfPipelineConfig or VanillaPipelineConfig
    pipeline: GFNerfPipelineConfig = dataclasses.field(
        default_factory=GFNerfPipelineConfig)

    def get_base_dir(self) -> Path:
        exp = self.experiment_name or (Path(self.data).name if self.data
                                       else "unnamed")
        if self.timestamp == "{timestamp}":
            self.timestamp = time.strftime("%Y-%m-%d_%H%M%S")
        return Path(self.output_dir) / exp / self.method_name / self.timestamp


class Trainer:
    def __init__(self, config: TrainerConfig, dataparser):
        self.config = config
        self.dataparser = dataparser
        self._start_step = 0
        # the viewer's pause/stop state, and the lock that a train step and
        # a render each hold
        self.control = TrainControl()
        self.lock = threading.Lock()
        self.viewer = None
        self.comm = parallel_comm.world()
        # rank 0 writes; one card is rank 0
        self.is_main = self.comm is None or self.comm.rank == 0

    def setup(self, test_mode: str = "train"):
        """``test_mode`` other than "train" (eval and render from a run's
        checkpoint, ``utils/eval_utils.eval_setup``) leaves the run's
        ``config.json`` as it is."""
        cfg = self.config
        if self.comm is not None:
            if not isinstance(cfg.pipeline, GFNerfPipelineConfig):
                raise ValueError("training over several ranks covers the "
                                 "GF-NeRF pipeline only")
            if "viewer" in cfg.vis:
                raise ValueError("the viewer does not run over several "
                                 "ranks: train with --vis local")
            # one run directory: rank 0's timestamp
            if cfg.timestamp == "{timestamp}":
                cfg.timestamp = self.comm.broadcast_object(
                    time.strftime("%Y-%m-%d_%H%M%S"))
        self.writer = EventWriter(cfg.vis, steps_per_log=cfg.steps_per_log)
        self.base_dir = cfg.get_base_dir()
        os.makedirs(self.base_dir, exist_ok=True)
        self.checkpoint_dir = self.base_dir / "nerfstudio_models"
        if test_mode == "train" and self.is_main:
            (self.base_dir / "config.json").write_text(config_to_json(cfg))
        ckpt_dir = (self._checkpoint_to_load() if cfg.load_dir is not None
                    else None)
        # a resumed pipeline takes its octree and march config from the
        # checkpoint instead of building and calibrating them
        self.pipeline = cfg.pipeline.build(self.dataparser, self.base_dir,
                                           cfg.device, checkpoint=ckpt_dir)
        if ckpt_dir is not None:
            step = self.pipeline.load_checkpoint_state(ckpt_dir)
            self._start_step = step + 1
            print(f"[trainer] resumed from {ckpt_dir} at step "
                  f"{self._start_step}")
        if "viewer" in cfg.vis and test_mode == "train":
            self.viewer = ViewerServer(
                self.pipeline, port=cfg.viewer_port, save_dir=self.base_dir,
                control=self.control, lock=self.lock).start()
            print(f"[trainer] viewer: http://{self.viewer.host}:"
                  f"{self.viewer.port} (renders and training controls "
                  "while training)", flush=True)

    def train(self):
        cfg = self.config
        pcfg = cfg.pipeline
        num_rays = (pcfg.datamanager.train_num_rays_per_batch
                    if hasattr(pcfg, "datamanager")
                    else pcfg.train_num_rays_per_batch)
        t_start = time.perf_counter()
        for step in range(self._start_step, cfg.max_num_iterations):
            # the viewer's training controls, between steps
            self.control.wait_if_paused()
            if self.control.stop:
                print(f"[trainer] stop requested from the viewer at step "
                      f"{step}")
                self.save_checkpoint(step - 1 if step > 0 else 0)
                return
            with self.lock, TimeWriter(None, ITER_TRAIN_TIME, step) as t:
                metrics = self.pipeline.get_train_loss_dict(step)
                self.pipeline.after_train_iteration(step)
            if step % cfg.steps_per_log == 0 and self.is_main:
                self.writer.put_scalar(ITER_TRAIN_TIME, t.duration, step)
                self.writer.put_scalar(TRAIN_RAYS_PER_SEC,
                                       num_rays / t.duration, step)
                frac = (step + 1 - self._start_step) / max(
                    cfg.max_num_iterations - self._start_step, 1)
                elapsed = time.perf_counter() - t_start
                self.writer.put_scalar(ETA, elapsed / frac - elapsed, step)
                self.writer.put_dict(metrics, step)
                self.writer.flush(step)
                self.control.publish(
                    step=step, rays_per_sec=num_rays / t.duration,
                    **{k: v for k, v in metrics.items()
                       if k in ("loss", "psnr")})
            self.eval_iteration(step)
            if (step + 1) % cfg.steps_per_save == 0:
                self.save_checkpoint(step)
        last = cfg.max_num_iterations - 1
        if not (last >= self._start_step
                and (last + 1) % cfg.steps_per_save == 0):
            self.save_checkpoint(last)   # unless the loop just saved it

    def _on_main(self, fn) -> None:
        """``fn()`` on rank 0 while the other ranks wait, every rank's
        concurrent-stage tables synced first; on one card, ``fn()``."""
        if self.comm is None:
            fn()
            return
        self.pipeline.sync_block_tables()
        if self.is_main:
            fn()
        self.comm.barrier()

    def eval_iteration(self, step: int):
        cfg = self.config
        batch = ((step + 1) % cfg.steps_per_eval_batch == 0
                 and hasattr(self.pipeline, "get_eval_loss_dict"))
        image = (step + 1) % cfg.steps_per_eval_image == 0
        if batch or image:
            self._on_main(lambda: self._eval(step, batch, image))

    def _eval(self, step: int, batch: bool, image: bool):
        if batch:
            metrics = self.pipeline.get_eval_loss_dict(step)
            self.writer.put_dict(
                {f"Eval Batch/{k}": v for k, v in metrics.items()}, step)
        if image:
            metrics, images = (
                self.pipeline.get_eval_image_metrics_and_images(step))
            self.writer.put_dict(
                {f"Eval Images/{k}": v for k, v in metrics.items()}, step)
            for name, img in images.items():
                if name == "depth":
                    img = apply_depth_colormap(
                        img, images.get("accumulation"))
                elif name == "accumulation":
                    img = apply_colormap(img)
                self.writer.put_image(f"Eval Images/{name}", img, step)

    def save_checkpoint(self, step: int):
        """trainer.py:351-379: step-{:09d} dirs, pruned to the latest; by
        rank 0."""
        self._on_main(lambda: self._save_checkpoint(step))

    def _save_checkpoint(self, step: int):
        ckpt_dir = self.checkpoint_dir / f"step-{step:09d}"
        os.makedirs(ckpt_dir, exist_ok=True)
        self.pipeline.save_checkpoint_state(ckpt_dir, step)
        if self.config.save_only_latest_checkpoint:
            for other in sorted(self.checkpoint_dir.glob("step-*")):
                if other != ckpt_dir:
                    shutil.rmtree(other)

    def _checkpoint_to_load(self) -> Path:
        load_dir = Path(self.config.load_dir)
        if self.config.load_step is not None:
            return load_dir / f"step-{self.config.load_step:09d}"
        found = sorted(load_dir.glob("step-*"))
        if not found:
            raise FileNotFoundError(f"no checkpoint under {load_dir}")
        return found[-1]
