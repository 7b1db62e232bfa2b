"""Event writer: the terminal backend.

Port of ``gfnerf_tpu/utils/writer.py`` (nerfstudio's ``writer.py``): a
buffered event API (put_scalar / put_dict / put_image) flushed to the local
terminal printer.  TensorBoard and W&B need packages the port does not
depend on: ``vis`` other than "local" or "viewer" (the web viewer, which
the Trainer starts; events still go to the terminal) raises.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

# canonical event names (writer.py:43-54)
ITER_TRAIN_TIME = "Train Iter (time)"
TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
ETA = "ETA (time)"


class LocalWriter:
    """Terminal stats printer (writer.py:318-474, simplified)."""

    def __init__(self, steps_per_log: int = 10):
        self.steps_per_log = steps_per_log
        self._last: Dict[str, float] = {}

    def write_scalar(self, name: str, value: float, step: int):
        self._last[name] = value

    def write_image(self, name, image, step):
        pass

    def flush(self, step: int):
        if step % self.steps_per_log == 0 and self._last:
            parts = " | ".join(
                f"{k}: {v:.4g}" for k, v in sorted(self._last.items()))
            print(f"[step {step:>8d}] {parts}", flush=True)


class EventWriter:
    """Multiplexes events to the configured backends."""

    def __init__(self, vis: str = "local", steps_per_log: int = 10):
        if vis not in ("local", "viewer"):
            raise NotImplementedError(
                f"vis={vis!r} is not ported (TensorBoard and W&B); use "
                "'local' or 'viewer'")
        self.backends: List = [LocalWriter(steps_per_log)]

    def put_scalar(self, name: str, value, step: int):
        v = float(value)
        for b in self.backends:
            b.write_scalar(name, v, step)

    def put_dict(self, scalars: Dict[str, float], step: int):
        for k, v in scalars.items():
            self.put_scalar(k, v, step)

    def put_image(self, name: str, image, step: int):
        for b in self.backends:
            b.write_image(name, image, step)

    def flush(self, step: int):
        for b in self.backends:
            b.flush(step)


class TimeWriter:
    """Context timer feeding writer events (writer.py:43-54)."""

    def __init__(self, writer: Optional[EventWriter], name: str, step: int):
        self.writer = writer
        self.name = name
        self.step = step
        self.duration = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self.duration = time.perf_counter() - self.start
        if self.writer is not None:
            self.writer.put_scalar(self.name, self.duration, self.step)
