"""Motion-JPEG in an MP4 file, written and read without cv2 or FFmpeg.

The JAX package's ``scripts/render.py`` writes ``render.mp4`` through
``cv2.VideoWriter`` (fourcc ``mp4v``, 24 fps); the card's machine has no
cv2, so the port writes the file itself.  Each frame is a baseline JPEG
from ``utils/jpeg.encode_jpeg`` (quality 90, 4:4:4 chroma: a rendered
frame keeps its colour edges) and the container is ISO BMFF:

- ``ftyp`` (isom), then ``mdat`` with a 64-bit size holding the frames
  back to back, then ``moov`` with one video track: ``mvhd``, ``tkhd``,
  ``mdhd`` (timescale fps x 1000), ``hdlr`` (vide), ``vmhd``, ``dref``,
  and a sample table of one chunk: ``stsd``, ``stts`` (every frame 1000
  ticks), ``stsc``, ``stsz`` and ``stco`` (``co64`` when the chunk starts
  past 4 GiB);
- the sample entry is ``mp4v`` with an ``esds`` whose
  ``objectTypeIndication`` is 0x6C (ISO/IEC 10918-1, JPEG), which FFmpeg
  (and so cv2 and every player built on it) decodes as Motion-JPEG.

:class:`Mp4Writer` takes frames one at a time (``render`` encodes each as
it is rendered) and writes ``moov`` at :meth:`Mp4Writer.close`, when the
offsets are known.  :func:`write_mp4` writes a sequence; :func:`read_mp4`
walks the boxes back into the frame rate, size and samples.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np

from gfnerf_tpu_torch.utils.jpeg import encode_jpeg

QUALITY = 90
SUBSAMPLING = "4:4:4"
TICKS = 1000          # media ticks a frame
MJPEG_OTI = 0x6C      # objectTypeIndication of ISO/IEC 10918-1
STCO_LIMIT = 0xFFFFFFFF   # past this chunk offset (+ data) the table is co64
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    """An MPEG-4 descriptor with its length in the 4-byte form."""
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


class Mp4Writer:
    """Frames, one :meth:`add` each, into a Motion-JPEG MP4 at ``path``."""

    def __init__(self, path, fps: float = 24):
        self.path = Path(path)
        self.fps = float(fps)
        self.sizes: List[int] = []
        self.shape = None
        self._f = open(self.path, "wb")
        self._f.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                           b"isom", b"iso2", b"mp41"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", 16))

    def add(self, rgb: np.ndarray) -> None:
        """One (H, W, 3) uint8 frame; every frame has the first's size."""
        rgb = np.asarray(rgb)
        if self.shape is None:
            self.shape = rgb.shape
        elif rgb.shape != self.shape:
            raise ValueError(f"Mp4Writer: frame of {rgb.shape}, the video's "
                             f"frames are {self.shape}")
        data = encode_jpeg(rgb, QUALITY, SUBSAMPLING)
        self._f.write(data)
        self.sizes.append(len(data))

    def close(self) -> Path:
        if self._f.closed:
            return self.path
        try:
            if not self.sizes:
                raise ValueError("Mp4Writer: no frame was added")
            end = self._f.tell()
            self._f.seek(self._mdat + 8)
            self._f.write(struct.pack(">Q", end - self._mdat))
            self._f.seek(end)
            self._f.write(self._moov(self._mdat + 16))
        finally:
            self._f.close()
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._f.close()

    def _moov(self, offset: int) -> bytes:
        h, w = self.shape[:2]
        n = len(self.sizes)
        timescale = int(round(self.fps * TICKS))
        movie_ms = int(round(n * 1000 / self.fps))
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                                movie_ms),
                     struct.pack(">IH", 0x10000, 0x100), bytes(10), _MATRIX,
                     bytes(24), struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIII", 0, 0, 1, 0),
                     struct.pack(">I", movie_ms), bytes(8),
                     struct.pack(">HHHH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", w << 16, h << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, timescale,
                                                n * TICKS),
                     struct.pack(">HH", 0x55C4, 0))        # language "und"
        hdlr = _full(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12),
                     b"VideoHandler\0")
        vmhd = _full(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full(b"url ", 0, 1)))
        dec_config = _descriptor(0x04, bytes([MJPEG_OTI, 0x04 << 2 | 1])
                                 + struct.pack(">I", max(self.sizes))[1:]
                                 + struct.pack(">II", 0, 0))
        es = _descriptor(0x03, struct.pack(">HB", 1, 0) + dec_config
                         + _descriptor(0x06, b"\x02"))
        name = b"Motion JPEG"
        mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                    struct.pack(">HHII", w, h, 0x480000, 0x480000),
                    bytes(4), struct.pack(">H", 1),
                    bytes([len(name)]) + name + bytes(31 - len(name)),
                    struct.pack(">Hh", 0x18, -1), _full(b"esds", 0, 0, es))
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), mp4v)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, TICKS))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                     np.asarray(self.sizes, ">u4").tobytes())
        if offset + sum(self.sizes) > STCO_LIMIT:
            chunks = _full(b"co64", 0, 0, struct.pack(">IQ", 1, offset))
        else:
            chunks = _full(b"stco", 0, 0, struct.pack(">II", 1, offset))
        stbl = _box(b"stbl", stsd, stts, stsc, stsz, chunks)
        minf = _box(b"minf", vmhd, dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)


def write_mp4(path, frames: Iterable[np.ndarray], fps: float = 24) -> Path:
    """Frames ((H, W, 3) uint8, one size) as a Motion-JPEG MP4 file."""
    with Mp4Writer(path, fps) as w:
        for f in frames:
            w.add(f)
    return Path(path)


def _boxes(data: bytes, start: int, end: int):
    """(kind, payload start, payload end) of the boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            (size,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"MP4: box {kind!r} at {pos} overruns its "
                             "parent")
        yield kind, pos + head, pos + size
        pos += size


def read_mp4(path) -> Dict:
    """The first video track of an MP4 file: {"top": top-level box kinds in
    order, "codec": sample entry kind, "object_type": the esds's
    objectTypeIndication (or None), "width", "height", "fps", "samples":
    [bytes]}."""
    data = Path(path).read_bytes()
    top = list(_boxes(data, 0, len(data)))
    kinds = [k for k, _, _ in top]
    if b"moov" not in kinds:
        raise ValueError(f"{path}: no moov box")
    moov = next((s, e) for k, s, e in top if k == b"moov")

    def find(start, end, *path_kinds):
        for kind in path_kinds:
            start, end = next((s, e) for k, s, e in _boxes(data, start, end)
                              if k == kind)
        return start, end

    trak = next((s, e) for k, s, e in _boxes(data, *moov) if k == b"trak")
    mdhd = find(*trak, b"mdia", b"mdhd")
    timescale = struct.unpack(">I", data[mdhd[0] + 12:mdhd[0] + 16])[0]
    stbl = find(*trak, b"mdia", b"minf", b"stbl")
    tables = {k: (s, e) for k, s, e in _boxes(data, *stbl)}
    s = tables[b"stsd"][0] + 8
    (entry_size,) = struct.unpack(">I", data[s:s + 4])
    codec = data[s + 4:s + 8]
    entry = s + 8
    w, h = struct.unpack(">HH", data[entry + 24:entry + 28])
    oti = None
    for k, bs, be in _boxes(data, entry + 78, s + entry_size):
        if k == b"esds":
            body = data[bs + 4:be]
            p = 1
            while body[p] & 0x80:            # the ES descriptor's length
                p += 1
            p += 1 + 3                       # ES_ID and flags
            if body[p] == 0x04:
                p += 1
                while body[p] & 0x80:
                    p += 1
                oti = body[p + 1]
    st = tables[b"stts"][0]
    (n_entries,) = struct.unpack(">I", data[st + 4:st + 8])
    deltas = []
    for i in range(n_entries):
        count, delta = struct.unpack(">II", data[st + 8 + 8 * i:
                                                 st + 16 + 8 * i])
        deltas += [delta] * count
    sz = tables[b"stsz"][0]
    uniform, n = struct.unpack(">II", data[sz + 4:sz + 12])
    sizes = ([uniform] * n if uniform else
             np.frombuffer(data[sz + 12:sz + 12 + 4 * n], ">u4").tolist())
    sc = tables[b"stsc"][0]
    (n_sc,) = struct.unpack(">I", data[sc + 4:sc + 8])
    stsc = [struct.unpack(">III", data[sc + 8 + 12 * i:sc + 20 + 12 * i])
            for i in range(n_sc)]
    if b"co64" in tables:
        co = tables[b"co64"][0]
        (nc,) = struct.unpack(">I", data[co + 4:co + 8])
        offsets = np.frombuffer(data[co + 8:co + 8 + 8 * nc], ">u8").tolist()
    else:
        co = tables[b"stco"][0]
        (nc,) = struct.unpack(">I", data[co + 4:co + 8])
        offsets = np.frombuffer(data[co + 8:co + 8 + 4 * nc], ">u4").tolist()
    samples, i = [], 0
    for c, off in enumerate(offsets):
        per = next(spc for first, spc, _ in reversed(stsc) if first <= c + 1)
        for _ in range(per):
            samples.append(data[off:off + sizes[i]])
            off += sizes[i]
            i += 1
    if len(samples) != n:
        raise ValueError(f"{path}: {len(samples)} samples in the chunks, "
                         f"{n} in stsz")
    fps = timescale / deltas[0] if deltas else 0.0
    return {"top": kinds, "codec": codec.decode("latin-1"),
            "object_type": oti, "width": w, "height": h, "fps": fps,
            "deltas": deltas, "samples": samples}
