"""Image I/O on the standard library's ``zlib`` and numpy.

The JAX package reads images with ``imageio`` and resizes them with
``cv2``; the card's machine has neither, so the port carries its own:

- :func:`read_png`: a PNG decoder.  Every IDAT chunk, filter types 0-4
  (Paeth with the specification's tie order), colour types 0 (grey), 2
  (RGB), 3 (palette, with ``tRNS`` alpha), 4 (grey and alpha) and 6
  (RGBA) at bit depths 8 and 16, and grey and palette at 1, 2 and 4 bits;
  plain or Adam7-interlaced (each of the seven passes a sub-image of its
  own, unfiltered, then scattered into the full image).
- :func:`write_png`: grey, grey and alpha, RGB and RGBA at 8 or 16 bits,
  palette images and 1/2/4-bit grey, each row under a filter type the
  caller may choose.  :func:`encode_png` and :func:`decode_png` do the
  same in memory (the viewer's ``/render`` answers with PNG bytes).
- :func:`png_size`: (width, height) from the IHDR chunk;
  :func:`jpeg_size`: from a JPEG's start-of-frame segment;
  :func:`image_size`: either, else the decoded image's.
- :func:`resize_area` (``cv2.INTER_AREA``: area averaging for a
  downscale, OpenCV's area-weighted linear rule for an upscale) and
  :func:`resize_linear` (``cv2.INTER_LINEAR``, half-pixel centres).
- :func:`read_image`: a PNG through :func:`read_png`, a JPEG through the
  port's codec (``utils/jpeg.decode_jpeg``, the pixels ``imageio`` gives),
  on every device; any other format through ``imageio`` where it imports,
  else a ``NotImplementedError`` that names it.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"
# start-of-frame markers (baseline, extended, progressive, lossless, and
# their differential and arithmetic-coded forms): SOF0-SOF15 less DHT
# (C4), JPG (C8) and DAC (CC), which share the range
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# markers that stand alone, without a length: TEM, RST0-7, SOI
_JPEG_STANDALONE = frozenset([0x01, *range(0xD0, 0xD8), 0xD8])
# samples per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes (PNG specification 8.2): first column and row, steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes, path) -> list:
    """[(type, payload)] of a PNG's chunks, in file order."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    out, pos = [], 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
        if kind == b"IEND":
            break
    return out


def _ihdr(payload: bytes, path) -> tuple:
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", payload[:13])
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} "
                         "is not a valid PNG")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown compression {comp} or filter "
                         f"method {filt}")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    return w, h, depth, ctype, interlace


def _passes(w: int, h: int, interlace: int) -> list:
    """[(x0, y0, dx, dy, width, height)] of the image's passes: the whole
    image, or Adam7's seven sub-images, those that hold no pixel left
    out (they have no scanlines in the stream)."""
    if not interlace:
        return [(0, 0, 1, 1, w, h)]
    out = []
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def png_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    return struct.unpack(">II", head[16:24])


def jpeg_size(path) -> Tuple[int, int]:
    """(width, height) of a JPEG, from its start-of-frame segment: the
    segments before it are skipped by their lengths."""
    data = Path(path).read_bytes()
    if data[:2] != JPEG_SOI:
        raise ValueError(f"{path}: not a JPEG")
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: no marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:   # fill bytes
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker in _JPEG_STANDALONE:
            continue
        if marker in (0xD9, 0xDA):   # EOI, or SOS: the scan before a frame
            break
        if pos + 2 > len(data):
            break
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        if marker in _JPEG_SOF:
            if pos + 7 > len(data):
                break
            h, w = struct.unpack(">HH", data[pos + 3:pos + 7])
            return w, h
        pos += n
    raise ValueError(f"{path}: no start-of-frame segment before the scan")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 scanlines from the decompressed stream: each row's
    filter byte undone against the row above (PNG specification 9.2)."""
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            # x + a: a running sum along each byte of the pixel, mod 256
            pad = (-stride) % bpp
            cur = np.cumsum(np.concatenate([line, np.zeros(pad, np.uint8)])
                            .reshape(-1, bpp), axis=0, dtype=np.uint8
                            ).reshape(-1)[:stride]
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def _samples(lines: np.ndarray, w: int, depth: int,
             channels: int) -> np.ndarray:
    """(h, w, channels) samples of unfiltered scanlines: uint16 at depth
    16, else uint8 holding the raw values (below 8 bits, unpacked)."""
    h = lines.shape[0]
    if depth == 16:
        return lines.view(">u2").astype(np.uint16).reshape(h, w, channels)
    if depth == 8:
        return lines.reshape(h, w, channels)
    bits = np.unpackbits(lines, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits * weights).sum(-1).astype(np.uint8)
    return vals[:, :w * channels].reshape(h, w, channels)


def read_png(path) -> np.ndarray:
    """A PNG as a numpy array: (H, W) grey, (H, W, 2) grey and alpha, (H,
    W, 3) RGB or (H, W, 4) RGBA; uint16 at bit depth 16, else uint8.  Grey
    below 8 bits is scaled to 0-255; a palette image becomes RGB, or RGBA
    where a ``tRNS`` chunk gives the entries' alpha."""
    return decode_png(Path(path).read_bytes(), path)


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """:func:`read_png` of a PNG file's bytes (``path`` names it in
    errors)."""
    chunks = _chunks(data, path)
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError(f"{path}: no IHDR chunk first")
    w, h, depth, ctype, interlace = _ihdr(chunks[0][1], path)
    idat = b"".join(p for k, p in chunks if k == b"IDAT")
    if not idat:
        raise ValueError(f"{path}: no IDAT chunk")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    passes = [(*p, (p[4] * bits + 7) // 8)
              for p in _passes(w, h, interlace)]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    need = sum(ph * (stride + 1) for *_, ph, stride in passes)
    if raw.size < need:
        raise ValueError(f"{path}: image data ends early ({raw.size} of "
                         f"{need} bytes)")
    img = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph, stride in passes:
        n = ph * (stride + 1)
        lines = _unfilter(raw[pos:pos + n], ph, stride, max(1, bits // 8))
        img[y0::dy, x0::dx] = _samples(lines, pw, depth, channels)
        pos += n
    if ctype == 3:
        plte = next((p for k, p in chunks if k == b"PLTE"), None)
        if plte is None:
            raise ValueError(f"{path}: a palette image without PLTE")
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        trns = next((p for k, p in chunks if k == b"tRNS"), None)
        if trns is not None:
            alpha = np.full(len(pal), 255, np.uint8)
            t = np.frombuffer(trns, np.uint8)[:len(pal)]
            alpha[:len(t)] = t
            pal = np.concatenate([pal, alpha[:, None]], axis=1)
        return pal[img[..., 0]]
    if ctype == 0:
        img = img[..., 0]
        if depth < 8:
            img = (img.astype(np.uint16) * 255 // ((1 << depth) - 1)
                   ).astype(np.uint8)
    return img


def _filter_rows(lines: np.ndarray, bpp: int, ftypes: Sequence[int]
                 ) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines: row y under ``ftypes[y]``."""
    h, stride = lines.shape
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    out = np.empty((h, stride + 1), np.uint8)
    for y, t in enumerate(ftypes):
        out[y, 0] = t
        out[y, 1:] = ((x[y] - preds[t][y]) & 0xFF).astype(np.uint8)
    return out


def write_png(path, img: np.ndarray,
              filter_type: Union[int, Sequence[int]] = 0,
              palette: Optional[np.ndarray] = None,
              bit_depth: Optional[int] = None) -> None:
    """Write ``img`` as a PNG file (:func:`encode_png`'s bytes)."""
    Path(path).write_bytes(encode_png(img, filter_type, palette, bit_depth))


def encode_png(img: np.ndarray,
               filter_type: Union[int, Sequence[int]] = 0,
               palette: Optional[np.ndarray] = None,
               bit_depth: Optional[int] = None) -> bytes:
    """``img`` as the bytes of a PNG file.

    ``img``: (H, W) grey, (H, W, 2) grey and alpha, (H, W, 3) RGB or (H,
    W, 4) RGBA, uint8 (8 bits) or uint16 (16 bits).  With ``palette`` (N,
    3) or (N, 4) uint8 (the fourth column becomes ``tRNS``), ``img`` is
    (H, W) palette indices (colour type 3).  ``bit_depth`` 1, 2 or 4 packs
    grey or palette values below 8 bits (grey values in [0, 2^d - 1]).
    ``filter_type``: 0-4 for every row, or one per row."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[-1]
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        if img.ndim != 2 or palette.ndim != 2 or palette.shape[1] not in (
                3, 4) or len(palette) > 256:
            raise ValueError("write_png: a palette image is (H, W) indices "
                             "and an (N <= 256, 3 or 4) palette")
        ctype = 3
    else:
        if channels not in (1, 2, 3, 4):
            raise ValueError(f"write_png: (H, W[, 1-4]) expected, got "
                             f"{img.shape}")
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    if img.dtype == np.uint16 and palette is None:
        depth = 16
    elif img.dtype == np.uint8 or palette is not None:
        depth = 8
    else:
        raise ValueError(f"write_png: uint8 or uint16 expected, got "
                         f"{img.dtype}")
    if bit_depth is not None:
        if depth != 8 or bit_depth not in (1, 2, 4, 8) or ctype not in (0, 3):
            raise ValueError(f"write_png: bit depth {bit_depth} needs uint8 "
                             "grey or palette indices")
        depth = bit_depth
    if int(img.max(initial=0)) >= (1 << depth):
        raise ValueError(f"write_png: values above {(1 << depth) - 1} at "
                         f"bit depth {depth}")
    if depth == 16:
        lines = img.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        lines = img.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        vals = img.astype(np.uint8).reshape(h, w)
        vals = np.concatenate([vals, np.zeros((h, (-w) % per), np.uint8)],
                              axis=1).reshape(h, -1, per)
        shifts = (depth * np.arange(per - 1, -1, -1)).astype(np.uint8)
        lines = np.bitwise_or.reduce(vals << shifts, axis=-1).astype(
            np.uint8)
    ftypes = ([filter_type] * h if isinstance(filter_type, (int, np.integer))
              else list(filter_type))
    if len(ftypes) != h or any(t not in range(5) for t in ftypes):
        raise ValueError(f"write_png: filter types 0-4, one or one per row; "
                         f"got {filter_type}")
    bpp = max(1, channels * depth // 8)
    rows = _filter_rows(np.ascontiguousarray(lines), bpp, ftypes)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    extra = b""
    if palette is not None:
        extra = chunk(b"PLTE", palette[:, :3].tobytes())
        if palette.shape[1] == 4:
            extra += chunk(b"tRNS", palette[:, 3].tobytes())
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + extra
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_image(path) -> np.ndarray:
    """An image file as a numpy array: a PNG through :func:`read_png`, a
    JPEG through :func:`utils.jpeg.decode_jpeg` ((H, W) grey or (H, W, 3)
    uint8; a build or decode failure raises), any other format through
    ``imageio`` where it imports."""
    data = Path(path).read_bytes()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, path)
    if data[:2] == JPEG_SOI:
        from gfnerf_tpu_torch.utils.jpeg import decode_jpeg

        try:
            return decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise NotImplementedError(
            f"{path}: only PNG is decoded without imageio; install imageio "
            "to read this format") from e
    return np.asarray(imageio.imread(str(path)))


def image_size(path) -> Tuple[int, int]:
    """(width, height) of an image file: a PNG's from its header, a
    JPEG's from its start-of-frame segment, any other format's from the
    image :func:`read_image` decodes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return png_size(path)
    if head[:2] == JPEG_SOI:
        return jpeg_size(path)
    img = read_image(path)
    return img.shape[1], img.shape[0]


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of ``cv2.INTER_AREA`` along one axis for a
    downscale (``computeResizeAreaTab`` of OpenCV's resize.cpp)."""
    scale = src / dst
    m = np.zeros((dst, src), np.float64)
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s1, s2 = int(np.ceil(fs1)), int(np.floor(fs2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - fs1 > 1e-3:
            m[d, s1 - 1] = np.float32((s1 - fs1) / cell)
        for s in range(s1, s2):
            m[d, s] = np.float32(1.0 / cell)
        if fs2 - s2 > 1e-3:
            m[d, s2] = np.float32(min(min(fs2 - s2, 1.0), cell) / cell)
    return m


def _area_up_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of ``cv2.INTER_AREA`` along one axis for an
    upscale (resize.cpp's linear coefficients in area mode): output d reads
    source s = floor(d / k) and s + 1, with k = dst / src, at the weight
    fx = (d + 1) - (s + 1) k clamped at 0, its fractional part; the last
    source pixel alone at the edge."""
    inv = dst / src
    scale = 1.0 / inv
    m = np.zeros((dst, src), np.float64)
    for d in range(dst):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv)
        f = 0.0 if f <= 0 else float(f - np.floor(f))
        if s >= src - 1:
            f, s = 0.0, src - 1
        m[d, s] += np.float32(1.0 - f)
        m[d, min(s + 1, src - 1)] += f
    return m


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of ``cv2.INTER_LINEAR`` along one axis:
    half-pixel centres, the edge samples replicated."""
    scale = src / dst
    m = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = int(np.floor(f))
        f = float(f - s)
        if s < 0:
            f, s = 0.0, 0
        if s >= src - 1:
            f, s = 0.0, src - 1
        m[d, s] += 1.0 - f
        m[d, min(s + 1, src - 1)] += f
    return m


def _separable(img: np.ndarray, wy: np.ndarray, wx: np.ndarray
               ) -> np.ndarray:
    out = np.einsum("ys,sx...->yx...", wy, img.astype(np.float64))
    out = np.einsum("xs,ys...->yx...", wx, out)
    return out.astype(np.float32)


def resize_area(img: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(img, (int(w * scale), int(h * scale)),
    interpolation=cv2.INTER_AREA)`` on (H, W[, C]) float images; f32 out.
    Below 1 each output pixel averages the source area it covers; above 1
    OpenCV's area-weighted linear rule (an integer factor repeats each
    pixel)."""
    h, w = img.shape[:2]
    dw, dh = int(w * scale), int(h * scale)
    if (dw, dh) == (w, h):
        return np.asarray(img, np.float32)
    # OpenCV averages areas only where neither axis grows
    weights = (_area_weights if dw <= w and dh <= h else _area_up_weights)
    return _separable(img, weights(h, dh), weights(w, dw))


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` on (H,
    W[, C]) float images; f32 out."""
    dw, dh = size
    h, w = img.shape[:2]
    if (dw, dh) == (w, h):
        return np.asarray(img, np.float32)
    return _separable(img, _linear_weights(h, dh), _linear_weights(w, dw))
