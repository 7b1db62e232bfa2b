"""Event writer: TensorBoard, local terminal and W&B backends.

Port of ``gfnerf_tpu/utils/writer.py`` (nerfstudio's ``writer.py``): a
buffered event API (put_scalar / put_dict / put_image / put_config)
flushed to the backends that ``vis`` names, by substring as the JAX
package's ``EventWriter`` reads it: "tensorboard" (also in
"viewer+tensorboard") adds the TensorBoard backend, "wandb" the W&B one,
and the terminal printer is always there.  "viewer" starts nothing here:
the Trainer serves the viewer.

The TensorBoard backend is the port's own (``tensorboardX`` is not a
dependency): ``events.out.tfevents.*`` files of TFRecords, each an
``Event`` protocol buffer encoded by hand, with the fields and values
that ``tensorboardX.SummaryWriter`` writes for ``add_scalar``,
``add_image`` (a PNG from ``image_io.encode_png``) and ``add_text``.  W&B
is imported when its backend is made; without it the writer prints a line
and keeps the other backends, as the JAX package's does.  ``read_events``
reads an event file back (each record's CRCs checked).
"""

from __future__ import annotations

import re
import socket
import struct
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

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


# ------------------------------------------------------------ TFRecords ----


def _crc32c_table() -> np.ndarray:
    poly = 0x82F63B78   # Castagnoli, reflected
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table[i] = c
    return table


_CRC32C_TABLE = [int(v) for v in _crc32c_table()]


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC-32C of ``data``."""
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: the length, its masked CRC, the data, its masked
    CRC (little-endian)."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ---------------------------------------------------- protocol buffers ----
# The few messages of tensorflow's event.proto and summary.proto the writer
# needs, encoded field by field: (field number << 3 | wire type), varints,
# little-endian fixed-width numbers, length-delimited bytes.


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_varint(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _pb_double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", x)


def _pb_float(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", x)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _pb_str(field: int, s: str) -> bytes:
    return _pb_bytes(field, s.encode("utf-8"))


def event_proto(wall_time: float, step: int = 0,
                file_version: Optional[str] = None,
                summary_values: Optional[List[bytes]] = None) -> bytes:
    """An ``Event``: wall_time (1, double), step (2, int64), file_version
    (3) or a ``Summary`` (5) of encoded ``Summary.Value`` messages."""
    out = _pb_double(1, wall_time)
    if step:
        out += _pb_varint(2, step)
    if file_version is not None:
        out += _pb_str(3, file_version)
    if summary_values is not None:
        out += _pb_bytes(5, b"".join(_pb_bytes(1, v)
                                     for v in summary_values))
    return out


def scalar_value(tag: str, value: float) -> bytes:
    """``Summary.Value``: tag (1), simple_value (2, float)."""
    return _pb_str(1, tag) + _pb_float(2, value)


def image_value(tag: str, png: bytes, height: int, width: int,
                channels: int) -> bytes:
    """``Summary.Value`` with an ``Image`` (4): height (1), width (2),
    colorspace (3), encoded_image_string (4)."""
    img = (_pb_varint(1, height) + _pb_varint(2, width)
           + _pb_varint(3, channels) + _pb_bytes(4, png))
    return _pb_str(1, tag) + _pb_bytes(4, img)


def text_value(tag: str, text: str) -> bytes:
    """``Summary.Value`` of the text plugin: tag (1), a string tensor (8)
    (dtype (1) DT_STRING = 7, tensor_shape (2) of one dim of size 1,
    string_val (8)) and metadata (9) with plugin_data (1) {plugin_name
    "text"; its content, ``TextPluginData`` version 0, encodes to no
    bytes}."""
    plugin = _pb_str(1, "text")
    metadata = _pb_bytes(1, plugin)
    shape = _pb_bytes(2, _pb_varint(1, 1))
    tensor = (_pb_varint(1, 7) + _pb_bytes(2, shape)
              + _pb_bytes(8, text.encode("utf-8")))
    return _pb_str(1, tag) + _pb_bytes(8, tensor) + _pb_bytes(9, metadata)


_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(name: str) -> str:
    """The tag TensorBoard stores: characters outside [-/\\w.] become "_",
    leading slashes go (tensorboardX's ``_clean_tag``)."""
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


def image_uint8(image) -> np.ndarray:
    """(H, W, C) uint8 as TensorBoard stores an image given (H, W), (H, W,
    1), (H, W, 3) or (H, W, 4): floats scaled by 255 and cast (no clip),
    grey repeated to RGB."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.concatenate([img, img, img], axis=-1)
    if img.dtype != np.uint8:
        img = (img * 255.0).astype(np.uint8)
    return img


def _read_varint(buf: bytes, i: int) -> tuple:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes) -> list:
    """(field number, value) of each field of an encoded message: an int
    for a varint, bytes for a length-delimited or fixed-width field."""
    out, i = [], 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unexpected wire type {wire}")
        out.append((field, v))
    return out


def read_events(path) -> list:
    """The events of a TensorBoard event file, each CRC checked (a record
    whose CRC does not check raises): dicts with ``wall_time``, ``step``
    and either ``file_version`` or ``values``, a list of dicts with
    ``tag`` and one of ``simple_value`` (float), ``image`` (height, width,
    colorspace, png bytes) or ``text`` (the strings of a string tensor)."""
    data = Path(path).read_bytes()
    events, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        body = data[i + 12:i + 12 + length]
        (body_crc,) = struct.unpack("<I", data[i + 12 + length:
                                               i + 16 + length])
        if crc != masked_crc32c(header) or body_crc != masked_crc32c(body):
            raise ValueError(f"{path}: a record at byte {i} fails its CRC")
        i += 16 + length
        ev = {"wall_time": 0.0, "step": 0}
        for field, v in _fields(body):
            if field == 1:
                ev["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2:
                ev["step"] = v
            elif field == 3:
                ev["file_version"] = v.decode()
            elif field == 5:
                ev["values"] = [_summary_value(sv) for f, sv in _fields(v)
                                if f == 1]
        events.append(ev)
    return events


def _summary_value(buf: bytes) -> dict:
    out = {}
    for field, v in _fields(buf):
        if field == 1:
            out["tag"] = v.decode()
        elif field == 2:
            out["simple_value"] = struct.unpack("<f", v)[0]
        elif field == 4:
            img = dict(_fields(v))
            out["image"] = {"height": img.get(1, 0), "width": img.get(2, 0),
                            "colorspace": img.get(3, 0),
                            "png": img.get(4, b"")}
        elif field == 8:
            out["text"] = [s.decode() for f, s in _fields(v) if f == 8]
    return out


class TensorboardWriter:
    """An event file in ``log_dir``, made at the first event (a run that
    logs nothing leaves no file); each event is appended as it comes, so
    that a killed run keeps what it logged."""

    def __init__(self, log_dir: Path):
        self.log_dir = Path(log_dir)
        self.path: Optional[Path] = None

    def _event(self, step: int, values: List[bytes]) -> None:
        records = []
        if self.path is None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            now = time.time()
            self.path = self.log_dir / (
                f"events.out.tfevents.{str(now)[:10]}."
                f"{socket.gethostname()}")
            records.append(tfrecord(event_proto(
                now, file_version="brain.Event:2")))
        records.append(tfrecord(event_proto(time.time(), int(step),
                                            summary_values=values)))
        with open(self.path, "ab") as f:
            f.write(b"".join(records))

    def write_scalar(self, name, value, step):
        self._event(step, [scalar_value(clean_tag(name), float(value))])

    def write_image(self, name, image, step):
        from gfnerf_tpu_torch.utils.image_io import encode_png

        img = image_uint8(image)
        h, w, c = img.shape
        self._event(step, [image_value(clean_tag(name), encode_png(img),
                                       h, w, c)])

    def write_text(self, name, text, step):
        self._event(step, [text_value(clean_tag(name) + "/text_summary",
                                      text)])

    def flush(self, step=None):
        pass


class WandbWriter:
    def __init__(self, log_dir: Path, project: str = "gfnerf-tpu"):
        import wandb

        wandb.init(project=project, dir=str(log_dir))
        self.wandb = wandb
        self._buf = {}

    def write_scalar(self, name, value, step):
        self._buf[name] = value

    def write_image(self, name, image, step):
        self._buf[name] = self.wandb.Image(np.asarray(image))

    def flush(self, step):
        if self._buf:
            self.wandb.log(self._buf, step=step)
            self._buf = {}


class EventWriter:
    """Multiplexes events to the configured backends."""

    def __init__(self, vis: str = "tensorboard",
                 log_dir: Optional[Path] = None,
                 steps_per_log: int = 10):
        self.backends: List = []
        log_dir = Path(log_dir or ".")
        if "tensorboard" in vis:
            self.backends.append(TensorboardWriter(log_dir))
        if "wandb" in vis:
            try:
                self.backends.append(WandbWriter(log_dir))
            except Exception as e:
                print(f"[writer] wandb unavailable: {e}")
        self.backends.append(LocalWriter(steps_per_log))

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

    def put_config(self, config_str: str, step: int = 0):
        for b in self.backends:
            if isinstance(b, TensorboardWriter):
                b.write_text("config", f"```\n{config_str}\n```", step)

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
