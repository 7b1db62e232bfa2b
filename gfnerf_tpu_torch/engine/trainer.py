"""Trainer: the outer loop, checkpoints, eval cadence, logging.

Port of ``gfnerf_tpu/engine/trainer.py`` (nerfstudio's ``trainer.py``,
:90-479): setup (pipeline, config file, writer, checkpoint),
the train loop with the pipeline's after-iteration callbacks, the periodic
eval, and checkpoints in ``step-{:09d}`` directories pruned to the latest
(each written as ``step-{:09d}.tmp`` and renamed once whole, which the
JAX package's trainer does not do).  The run's config is written as
``config.json``, and to the event writer's backends (``vis``: TensorBoard
by default, as in the JAX package).  The pipeline is either
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
others wait at a barrier; the run's directory is rank 0's.  With the
viewer, rank 0 alone serves it, and at each step boundary every rank
acts on rank 0's controls, agreed in one broadcast
(``TrainControl.agree``): a pause holds every rank in a poll of that
broadcast every ``TrainControl.POLL_S`` (so that no collective waits on
the pause, whatever the group's timeout), syncing the block tables at
its first poll; a render that asked for a sync (``render_outputs``)
gets it at the next boundary on every rank and is served before the next
step; a stop saves (synced tables, rank 0 writes) and every rank
returns.  A run without the viewer adds no collective.

With K steps a dispatch (``steps_per_dispatch``) the pipeline trains a
window at its first step and returns buffered metrics at the others; the
loop, its controls, evals and saves go on step by step, acting at a
window's inner boundaries on the window-end state, as the JAX package's
do.  At the end the share of steps trained in windows is printed and
written as the ``k_dispatch_coverage`` scalar.
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
    # backends by substring: "tensorboard", "wandb", "local", "viewer"
    # (the web viewer), "viewer+tensorboard"
    vis: str = "tensorboard"
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
            # one run directory: rank 0's timestamp
            if cfg.timestamp == "{timestamp}":
                cfg.timestamp = self.comm.broadcast_object(
                    time.strftime("%Y-%m-%d_%H%M%S"))
        self.base_dir = cfg.get_base_dir()
        os.makedirs(self.base_dir, exist_ok=True)
        # rank 0 alone logs: the other ranks print to the terminal only
        self.writer = EventWriter(cfg.vis if self.is_main else "local",
                                  self.base_dir,
                                  steps_per_log=cfg.steps_per_log)
        self.checkpoint_dir = self.base_dir / "nerfstudio_models"
        if test_mode == "train" and self.is_main:
            (self.base_dir / "config.json").write_text(config_to_json(cfg))
            self.writer.put_config(config_to_json(cfg))
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
        # over several ranks the controls cross ranks at every boundary
        self._agree = self.comm is not None and "viewer" in cfg.vis
        if "viewer" in cfg.vis and test_mode == "train" and self.is_main:
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
        # K-step windows do not run past the last iteration, and the
        # optimizers' learning-rate tables cover it
        self.pipeline.reserve_steps(cfg.max_num_iterations)
        for step in range(self._start_step, cfg.max_num_iterations):
            # the viewer's training controls, between steps
            if self._stop_requested():
                print(f"[trainer] stop requested from the viewer at step "
                      f"{step}")
                self.save_checkpoint(step - 1 if step > 0 else 0)
                self.control.release()
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
        # the share of steps trained in K-step windows, against the single
        # steps at the windows' boundaries (trainer.py:159-169 of the JAX
        # package)
        scanned = getattr(self.pipeline, "_k_steps_scanned", 0)
        fallback = getattr(self.pipeline, "_k_steps_fallback", 0)
        if scanned + fallback > 0:
            cov = scanned / (scanned + fallback)
            print(f"[trainer] K-dispatch coverage: {scanned} scanned + "
                  f"{fallback} single-step fallback = {cov:.1%} scanned")
            if self.is_main:
                self.writer.put_scalar("k_dispatch_coverage", cov, last)
        # the tables are synced: renders still waiting may go
        self.control.release()

    def _stop_requested(self) -> bool:
        """The viewer's controls at a step boundary: True to stop.  On one
        process (and over several ranks without the viewer, which no one
        controls) the local pause and stop.  Over several ranks with the
        viewer every rank acts on rank 0's controls, agreed in one
        broadcast a poll: a sync of the block tables where a render asked
        for one (rank 0 then lets its renders finish) and at the first poll
        of a pause; while paused, a poll every ``POLL_S``."""
        ctl = self.control
        if not self._agree:
            ctl.wait_if_paused()
            return ctl.stop
        synced = False
        while True:
            agreed = ctl.agree(self.comm)
            if agreed.stop:
                ctl.held = False
                return True
            if agreed.sync or (agreed.paused and not synced):
                with self.lock:
                    self.pipeline.sync_block_tables()
                synced = True
                ctl.served(agreed.ticket)
            ctl.held = agreed.paused
            if not agreed.paused:
                return False
            time.sleep(ctl.POLL_S)

    def _on_main(self, fn) -> None:
        """``fn()`` on rank 0 while the other ranks wait, every rank's
        concurrent-stage tables synced first (under the step lock: the
        viewer may be rendering); on one card, ``fn()``."""
        if self.comm is None:
            fn()
            return
        with self.lock:
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
        """Written into ``step-N.tmp/`` and renamed to ``step-N/`` once
        whole, so that a run killed while it saves leaves no torn
        ``step-N/`` for a resume to pick."""
        ckpt_dir = self.checkpoint_dir / f"step-{step:09d}"
        tmp_dir = ckpt_dir.with_name(ckpt_dir.name + ".tmp")
        if tmp_dir.exists():
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        self.pipeline.save_checkpoint_state(tmp_dir, step)
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        os.rename(tmp_dir, ckpt_dir)
        if self.config.save_only_latest_checkpoint:
            for other in sorted(self.checkpoint_dir.glob("step-*")):
                if other != ckpt_dir:
                    shutil.rmtree(other)

    def _checkpoint_to_load(self) -> Path:
        """The newest whole checkpoint under ``load_dir`` (``step-N.tmp``
        directories are saves that did not finish), or ``load_step``'s."""
        load_dir = Path(self.config.load_dir)
        if self.config.load_step is not None:
            return load_dir / f"step-{self.config.load_step:09d}"
        found = sorted(p for p in load_dir.glob("step-*")
                       if not p.name.endswith(".tmp"))
        if not found:
            raise FileNotFoundError(f"no checkpoint under {load_dir}")
        return found[-1]
