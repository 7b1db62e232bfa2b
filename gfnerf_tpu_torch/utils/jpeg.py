"""JPEG decode and encode through the port's C++ codec, with plain versions.

The JAX package reads images with ``imageio.v2.imread`` (Pillow over
libjpeg-turbo); the card's machine has neither, so the port carries a codec
of its own (``gfnerf_tpu_torch/csrc/jpeg/``, host C++ built into
``_build/libgfnerf_jpeg.so`` by :func:`ops.build.jpeg_library` at first
use, with ``g++``; a failed build raises, nothing falls back):

- :func:`decode_jpeg`: baseline, extended and progressive Huffman JPEG,
  8-bit, grey or three components at any integral sampling (4:4:4, 4:2:2,
  4:4:0, 4:2:0, ...), restart intervals; the pixels libjpeg-turbo gives
  with its default settings (the islow IDCT, fancy upsampling, its
  fixed-point YCbCr -> RGB).  (H, W) uint8 for grey, else (H, W, 3).
  EXIF orientation is not applied (nor is it by ``imageio.v2.imread``).
  Arithmetic coding, 12-bit samples, lossless and hierarchical frames and
  CMYK/YCCK raise ``ValueError`` naming the feature; so does a stream
  that ends before its EOI marker.
- :func:`encode_jpeg`: baseline JFIF at ``quality`` 1-100 (IJG scaling of
  T.81 Annex K's tables, Annex K's Huffman tables), chroma at 4:2:0 (the
  default, as libjpeg's) or 4:4:4; grey input gives a one-component file.

The C entry points are reentrant and ``ctypes`` releases the GIL around
them, so threads decode at once (the datamanager's image cache decodes on
its thread pool).  :func:`decode_jpeg_reference` and
:func:`encode_jpeg_reference` are the plain numpy versions, bit for bit the
codec's, for the tests and ``chip_smoke.py`` at small sizes; the main path
never calls them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from gfnerf_tpu_torch.ops import build

SUBSAMPLING = {"4:4:4": 0, "4:2:0": 1}
_ERRLEN = 512
_TRUNCATED = "truncated JPEG: the data ends before the EOI marker"
_DNL = "DNL markers (height given after the scan) are not supported"


def _as_bytes(data) -> bytes:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, np.uint8).tobytes()
    return bytes(data)


def jpeg_info(data) -> Tuple[int, int, int]:
    """(width, height, channels) of the image a JPEG decodes to; raises
    ``ValueError`` where :func:`decode_jpeg` would refuse the frame."""
    lib = build.jpeg_library()
    buf = _as_bytes(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    dims = (ctypes.c_int32 * 3)()
    if lib.gfnerf_jpeg_info(buf, len(buf), dims, err, _ERRLEN):
        raise ValueError(err.value.decode(errors="replace"))
    return int(dims[0]), int(dims[1]), int(dims[2])


def decode_jpeg(data) -> np.ndarray:
    """A JPEG file's bytes as uint8 pixels: (H, W) grey or (H, W, 3)
    RGB."""
    lib = build.jpeg_library()
    buf = _as_bytes(data)
    w, h, c = jpeg_info(buf)
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.gfnerf_jpeg_decode(buf, len(buf), out.ctypes.data, out.size, err,
                              _ERRLEN):
        raise ValueError(err.value.decode(errors="replace"))
    return out


def _check_image(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(f"encode_jpeg: (H, W) or (H, W, 3) uint8 expected, "
                         f"got {img.shape} {img.dtype}")
    return np.ascontiguousarray(img)


def _check_args(quality: int, subsampling: str) -> int:
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"subsampling: one of {sorted(SUBSAMPLING)}, got "
                         f"{subsampling!r}")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"quality must be 1-100, got {quality}")
    return SUBSAMPLING[subsampling]


def encode_jpeg(rgb, quality: int = 90, subsampling: str = "4:2:0"
                ) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 pixels as a baseline JPEG file's
    bytes."""
    img = _check_image(rgb)
    s420 = _check_args(quality, subsampling)
    lib = build.jpeg_library()
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else 3
    cap = int(lib.gfnerf_jpeg_encode_bound(w, h, nc, s420))
    out = np.empty(cap, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib.gfnerf_jpeg_encode(img.ctypes.data, w, h, nc, int(quality), s420,
                               out.ctypes.data, cap, err, _ERRLEN)
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    return out[:n].tobytes()


# ------------------------------------------------------------------ plain --
# The codec again in numpy and plain Python: the same integer arithmetic
# (jidctint.c, jfdctint.c, jdsample.c, jdcolor.c, jccolor.c), one array
# operation over all blocks or rows where the C++ loops, and Huffman coding
# on strings of '0' and '1'.

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16)
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
_DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
_AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
            [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
            f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
            f2562=20995, f3072=25172)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _canonical(bits, vals):
    """(symbol, code, length) of a canonical Huffman table, in code
    order."""
    out, code, p = [], 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            out.append((vals[p], code, length))
            code += 1
            p += 1
        code <<= 1
    return out


def _wrap(v: int, bits: int) -> int:
    """``v`` as a two's-complement integer of ``bits`` bits (C's casts)."""
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def _idct_1d(v, shift_even_odd):
    """One islow IDCT pass over axis 0 of ``v`` (8, ...) int64; each output
    descaled by ``shift_even_odd``."""
    f = _FIX
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 + z3 * -f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (v[0] + v[4]) << 13
    tmp1 = (v[0] - v[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = (tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2,
                                  tmp1 - tmp2)
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0, t1, t2, t3 = (t0 * f["f0298"], t1 * f["f2053"], t2 * f["f3072"],
                      t3 * f["f1501"])
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    s = shift_even_odd
    return np.stack([_descale(tmp10 + t3, s), _descale(tmp11 + t2, s),
                     _descale(tmp12 + t1, s), _descale(tmp13 + t0, s),
                     _descale(tmp13 - t0, s), _descale(tmp12 - t1, s),
                     _descale(tmp11 - t2, s), _descale(tmp10 - t3, s)])


def _idct_blocks(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients -> (N, 8, 8) uint8 samples."""
    dq = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_1d(dq.transpose(1, 0, 2), 11)          # [row k](N, col)
    out = _idct_1d(ws.transpose(2, 1, 0), 18)         # [col](N, row)
    idx = out.transpose(1, 2, 0) & 1023                # (N, row, col)
    return np.select([idx < 128, idx < 512, idx < 896],
                     [idx + 128, 255, 0], idx - 896).astype(np.uint8)


class _PlainDecoder:
    """A JPEG file decoded marker by marker, as the C++ decoder does."""

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 2
        self.qt: Dict[int, np.ndarray] = {}
        self.dc = {t: self.table(_DC_BITS[t], range(12)) for t in (0, 1)}
        self.ac = {t: self.table(_AC_BITS[t], _AC_VALS[t]) for t in (0, 1)}
        self.comps: List[dict] = []
        self.restart = 0
        self.jfif = self.adobe = False
        self.transform = 0
        self.rgb: Optional[bool] = None
        self.progressive = False
        self.scans = 0

    @staticmethod
    def table(bits, vals) -> Dict[Tuple[int, int], int]:
        """(length, code) -> symbol."""
        return {(n, c): s for s, c, n in _canonical(bits, list(vals))}

    def next_marker(self) -> int:
        d, n = self.d, len(self.d)
        while True:
            while self.pos < n and d[self.pos] != 0xFF:
                self.pos += 1
            while self.pos < n and d[self.pos] == 0xFF:
                self.pos += 1
            if self.pos >= n:
                raise ValueError(_TRUNCATED)
            m = d[self.pos]
            self.pos += 1
            if m:
                return m

    def segment(self) -> bytes:
        if self.pos + 2 > len(self.d):
            raise ValueError(_TRUNCATED)
        n = int.from_bytes(self.d[self.pos:self.pos + 2], "big")
        if n < 2 or self.pos + n > len(self.d):
            raise ValueError(_TRUNCATED)
        seg = self.d[self.pos + 2:self.pos + n]
        self.pos += n
        return seg

    def run(self) -> np.ndarray:
        if self.d[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG: no SOI marker")
        pending = 0
        while True:
            m = pending or self.next_marker()
            pending = 0
            if m in (0xC0, 0xC1, 0xC2):
                self.sof(m, self.segment())
            elif m == 0xC3:
                raise ValueError("lossless JPEG (SOF3) is not supported")
            elif m in (0xC5, 0xC6, 0xC7):
                raise ValueError(f"hierarchical JPEG (SOF{m - 0xC0}) is "
                                 "not supported")
            elif m == 0xCC or 0xC9 <= m <= 0xCF:
                name = "DAC" if m == 0xCC else f"SOF{m - 0xC0}"
                raise ValueError(f"arithmetic coding ({name}) is not "
                                 "supported")
            elif m == 0xC4:
                self.dht(self.segment())
            elif m == 0xDB:
                self.dqt(self.segment())
            elif m == 0xDD:
                self.restart = int.from_bytes(self.segment()[:2], "big")
            elif m == 0xDA:
                if not self.comps:
                    raise ValueError("corrupt JPEG: a scan before the frame "
                                     "header")
                pending = self.scan(self.segment())
            elif m == 0xD9:
                if not self.scans:
                    raise ValueError("corrupt JPEG: no scan before EOI")
                return self.output()
            elif m == 0xDC:
                raise ValueError(_DNL)
            elif m == 0x01 or 0xD0 <= m <= 0xD7:
                pass
            elif m == 0xD8:
                raise ValueError("corrupt JPEG: a second SOI marker")
            else:
                seg = self.segment()
                if m == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
                    self.jfif = True
                if m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
                    self.adobe, self.transform = True, seg[11]

    def sof(self, m, seg):
        if self.comps:
            raise ValueError("corrupt JPEG: more than one frame header")
        prec, h, w, nc = seg[0], int.from_bytes(seg[1:3], "big"), \
            int.from_bytes(seg[3:5], "big"), seg[5]
        if prec != 8:
            raise ValueError(f"{prec}-bit samples are not supported (12-bit "
                             "JPEG): 8-bit only")
        if h == 0:
            raise ValueError(_DNL)
        if nc == 4:
            raise ValueError("4-component JPEG (CMYK/YCCK) is not supported")
        if nc not in (1, 3):
            raise ValueError(f"{nc}-component JPEG is not supported")
        comps = [dict(id=seg[6 + 3 * c], h=seg[7 + 3 * c] >> 4,
                      v=seg[7 + 3 * c] & 15, tq=seg[8 + 3 * c])
                 for c in range(nc)]
        self.w, self.h = w, h
        self.maxh = max(c["h"] for c in comps)
        self.maxv = max(c["v"] for c in comps)
        self.mcux = -(-w // (8 * self.maxh))
        self.mcuy = -(-h // (8 * self.maxv))
        for c in comps:
            if self.maxh % c["h"] or self.maxv % c["v"]:
                raise ValueError("fractional chroma sampling is not supported")
            c["width"] = -(-w * c["h"] // self.maxh)
            c["height"] = -(-h * c["v"] // self.maxv)
            c["bw"], c["bh"] = self.mcux * c["h"], self.mcuy * c["v"]
            c["coef"] = np.zeros((c["bh"], c["bw"], 64), np.int16)
            c["quant"] = None
        self.comps = comps
        self.progressive = m == 0xC2

    def dht(self, seg):
        p = 0
        while p < len(seg):
            tc, th = seg[p] >> 4, seg[p] & 15
            bits = list(seg[p + 1:p + 17])
            vals = seg[p + 17:p + 17 + sum(bits)]
            table = self.table(bits, vals)
            (self.dc if tc == 0 else self.ac)[th] = table
            p += 17 + sum(bits)

    def dqt(self, seg):
        p = 0
        while p < len(seg):
            pq, tq = seg[p] >> 4, seg[p] & 15
            if pq:
                vals = np.frombuffer(seg[p + 1:p + 129], ">u2")
            else:
                vals = np.frombuffer(seg[p + 1:p + 65], np.uint8)
            q = np.zeros(64, np.int64)
            q[_ZIGZAG[:64]] = vals
            self.qt[tq] = q
            p += 1 + 64 * (pq + 1)

    def entropy(self) -> Tuple[str, int]:
        """The bits from ``pos`` to the next marker (0xFF00 unstuffed) and
        that marker (0 at the end of the data)."""
        d, n, out = self.d, len(self.d), bytearray()
        p = self.pos
        while p < n:
            b = d[p]
            p += 1
            if b != 0xFF:
                out.append(b)
                continue
            while p < n and d[p] == 0xFF:
                p += 1
            if p >= n:
                break
            if d[p] == 0:
                out.append(0xFF)
                p += 1
                continue
            self.pos = p + 1
            return "".join(f"{x:08b}" for x in out), d[p]
        self.pos = n
        return "".join(f"{x:08b}" for x in out), 0

    def scan(self, seg) -> int:
        ns = seg[0]
        idx = []
        for i in range(ns):
            k = [c["id"] for c in self.comps].index(seg[1 + 2 * i])
            self.comps[k]["dc_tbl"] = seg[2 + 2 * i] >> 4
            self.comps[k]["ac_tbl"] = seg[2 + 2 * i] & 15
            idx.append(k)
        ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
        ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
        if self.rgb is None and len(self.comps) == 3:
            ids = [c["id"] for c in self.comps]
            self.rgb = (False if self.jfif else self.transform == 0
                        if self.adobe else ids == [82, 71, 66])
        if self.progressive and (
                (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63
                                                      or ns != 1))
                or (ah != 0 and al != ah - 1) or al > 13):
            raise ValueError("corrupt JPEG: bad progressive scan parameters")
        for k in idx:
            c = self.comps[k]
            if c["quant"] is None:
                c["quant"] = self.qt[c["tq"]].copy()
            c["last_dc"] = 0
        self.scans += 1
        mode = (0 if not self.progressive else
                (1 if ah == 0 else 2) if ss == 0 else (3 if ah == 0 else 4))
        bits, marker = self.entropy()
        state = dict(bits=bits, p=0, eobrun=0)
        if ns == 1:
            c = self.comps[idx[0]]
            nbx, nby = -(-c["width"] // 8), -(-c["height"] // 8)
            units = [[(idx[0], by, bx)] for by in range(nby)
                     for bx in range(nbx)]
        else:
            units = []
            for my in range(self.mcuy):
                for mx in range(self.mcux):
                    unit = []
                    for k in idx:
                        c = self.comps[k]
                        unit += [(k, my * c["v"] + yy, mx * c["h"] + xx)
                                 for yy in range(c["v"])
                                 for xx in range(c["h"])]
                    units.append(unit)
        rst = 0
        for u, unit in enumerate(units):
            if self.restart and u and u % self.restart == 0:
                if marker == 0:
                    marker = self.next_marker()
                if marker != 0xD0 + rst:
                    raise ValueError(f"corrupt JPEG: expected restart marker "
                              f"RST{rst}")
                rst = (rst + 1) & 7
                bits, marker = self.entropy()
                state = dict(bits=bits, p=0, eobrun=0)
                for k in idx:
                    self.comps[k]["last_dc"] = 0
            for k, by, bx in unit:
                self.block(mode, self.comps[k], self.comps[k]["coef"][by, bx],
                           state, ss, se, al)
        return marker

    @staticmethod
    def get(st, k) -> int:
        if k == 0:
            return 0
        s = st["bits"][st["p"]:st["p"] + k]
        st["p"] += k
        return int(s.ljust(k, "0"), 2)

    def decode(self, st, table) -> int:
        bits, p = st["bits"], st["p"]
        for n in range(1, 17):
            code = int(bits[p:p + n].ljust(n, "0"), 2)
            if (n, code) in table:
                st["p"] += n
                return table[(n, code)]
        st["p"] += 17
        return 0

    @staticmethod
    def extend(v, s):
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    def block(self, mode, c, blk, st, ss, se, al):
        """One block of a scan into ``blk`` (64 int16, natural order):
        sequential (0), DC first (1), DC refine (2), AC first (3), AC
        refine (4, T.81 G.1.2.3)."""
        nat, get = _ZIGZAG, self.get
        if mode in (0, 1):
            t = self.decode(st, self.dc[c["dc_tbl"]])
            diff = self.extend(get(st, t), t) if t else 0
            c["last_dc"] = _wrap(c["last_dc"] + diff, 32)
            blk[0] = _wrap(c["last_dc"] << (al if mode else 0), 16)
            if mode == 1:
                return
            act = self.ac[c["ac_tbl"]]
            k = 1
            while k < 64:
                rs = self.decode(st, act)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blk[nat[k]] = self.extend(get(st, s), s)
                elif r == 15:
                    k += 15
                else:
                    break
                k += 1
            return
        if mode == 2:
            if get(st, 1):
                blk[0] = _wrap(int(blk[0]) | (1 << al), 16)
            return
        act = self.ac[c["ac_tbl"]]
        if mode == 3:
            if st["eobrun"] > 0:
                st["eobrun"] -= 1
                return
            k = ss
            while k <= se:
                rs = self.decode(st, act)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blk[nat[k]] = _wrap(self.extend(get(st, s), s) << al, 16)
                elif r == 15:
                    k += 15
                else:
                    st["eobrun"] = (1 << r) + get(st, r) - 1
                    break
                k += 1
            return
        p1, m1 = 1 << al, -1 << al

        def refine(k):
            v = int(blk[nat[k]])
            if v != 0 and get(st, 1) and (v & p1) == 0:
                blk[nat[k]] = _wrap(v + (p1 if v >= 0 else m1), 16)

        k = ss
        if st["eobrun"] == 0:
            while k <= se:
                rs = self.decode(st, act)
                r, s = rs >> 4, rs & 15
                val = 0
                if s:
                    val = p1 if get(st, 1) else m1
                elif r != 15:
                    st["eobrun"] = (1 << r) + get(st, r)
                    break
                while True:
                    if blk[nat[k]] != 0:
                        refine(k)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > se:
                        break
                if val:
                    blk[nat[k]] = _wrap(val, 16)
                k += 1
        if st["eobrun"] > 0:
            while k <= se:
                refine(k)
                k += 1
            st["eobrun"] -= 1

    def plane(self, c) -> np.ndarray:
        coef = c["coef"].reshape(-1, 64).astype(np.int64)
        q = c["quant"] if c["quant"] is not None else self.qt.get(
            c["tq"], np.zeros(64, np.int64))
        blocks = _idct_blocks(coef, q).reshape(c["bh"], c["bw"], 8, 8)
        return blocks.transpose(0, 2, 1, 3).reshape(c["bh"] * 8,
                                                    c["bw"] * 8)

    def upsample(self, c, pl) -> np.ndarray:
        fh, fv = self.maxh // c["h"], self.maxv // c["v"]
        dw, dh = c["width"], c["height"]
        x = pl[:dh, :dw].astype(np.int64)
        if fv == 2 and (fh == 1 or (fh == 2 and dw > 2)):
            up = np.concatenate([x[:1], x[:-1]])
            down = np.concatenate([x[1:], x[-1:]])
            rows = np.empty((2 * dh, dw), np.int64)
            if fh == 1:
                rows[0::2] = (3 * x + up + 1) >> 2
                rows[1::2] = (3 * x + down + 2) >> 2
                return rows[:self.h, :self.w]
            rows[0::2] = 3 * x + up
            rows[1::2] = 3 * x + down
            left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
            right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
            out = np.empty((2 * dh, 2 * dw), np.int64)
            out[:, 0::2] = (3 * rows + left + 8) >> 4
            out[:, 1::2] = (3 * rows + right + 7) >> 4
            return out[:self.h, :self.w]
        if fh == 2 and fv == 1 and dw > 2:
            left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
            right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
            out = np.empty((dh, 2 * dw), np.int64)
            out[:, 0::2] = (3 * x + left + 1) >> 2
            out[:, 1::2] = (3 * x + right + 2) >> 2
            return out[:self.h, :self.w]
        return np.repeat(np.repeat(x, fv, 0), fh, 1)[:self.h, :self.w]

    def output(self) -> np.ndarray:
        planes = [self.upsample(c, self.plane(c)) for c in self.comps]
        if len(planes) == 1:
            return planes[0].astype(np.uint8)
        if self.rgb:
            return np.stack(planes, -1).astype(np.uint8)
        y, cb, cr = planes
        i = np.arange(256, dtype=np.int64) - 128
        fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
        cr_r = (fix(1.402) * i + 32768) >> 16
        cb_b = (fix(1.772) * i + 32768) >> 16
        cr_g = -fix(0.71414) * i
        cb_g = -fix(0.34414) * i + 32768
        rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                        y + cb_b[cb]], -1)
        return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_jpeg_reference(data) -> np.ndarray:
    """:func:`decode_jpeg` in numpy and plain Python (small images)."""
    return _PlainDecoder(_as_bytes(data)).run()


def _fdct_1d(v, pass2: bool):
    """One islow forward DCT pass over axis 0 of ``v`` (8, ...) int64."""
    f = _FIX
    tmp0, tmp7 = v[0] + v[7], v[0] - v[7]
    tmp1, tmp6 = v[1] + v[6], v[1] - v[6]
    tmp2, tmp5 = v[2] + v[5], v[2] - v[5]
    tmp3, tmp4 = v[3] + v[4], v[3] - v[4]
    tmp10, tmp13, tmp11, tmp12 = (tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2,
                                  tmp1 - tmp2)
    sh = 15 if pass2 else 11
    out = [None] * 8
    if pass2:
        out[0], out[4] = _descale(tmp10 + tmp11, 2), _descale(tmp10 - tmp11,
                                                              2)
    else:
        out[0], out[4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
    z1 = (tmp12 + tmp13) * f["f0541"]
    out[2] = _descale(z1 + tmp13 * f["f0765"], sh)
    out[6] = _descale(z1 + tmp12 * -f["f1847"], sh)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * f["f1175"]
    tmp4, tmp5 = tmp4 * f["f0298"], tmp5 * f["f2053"]
    tmp6, tmp7 = tmp6 * f["f3072"], tmp7 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    out[7] = _descale(tmp4 + z1 + z3, sh)
    out[5] = _descale(tmp5 + z2 + z4, sh)
    out[3] = _descale(tmp6 + z2 + z3, sh)
    out[1] = _descale(tmp7 + z1 + z4, sh)
    return np.stack(out)


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def encode_jpeg_reference(rgb, quality: int = 90,
                          subsampling: str = "4:2:0") -> bytes:
    """:func:`encode_jpeg` in numpy and plain Python (small images)."""
    img = _check_image(rgb)
    s420 = _check_args(quality, subsampling) and img.ndim == 3
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else 3
    mcu = 16 if s420 else 8
    ph, pw = -(-h // mcu) * mcu, -(-w // mcu) * mcu
    pix = img.reshape(h, w, nc).astype(np.int64)
    pix = np.pad(pix, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    if nc == 1:
        planes = [pix[..., 0]]
    else:
        r, g, b = pix[..., 0], pix[..., 1], pix[..., 2]
        half = (128 << 16) + 32768 - 1
        planes = [
            (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + 32768) >> 16,
            (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + half)
            >> 16,
            (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + half)
            >> 16]
    if s420:
        for c in (1, 2):
            p = planes[c]
            s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
            bias = np.where(np.arange(pw // 2) % 2 == 0, 1, 2)
            planes[c] = (s + bias) >> 2
    qts = [_quant_table(_LUMA_Q, quality), _quant_table(_CHROMA_Q, quality)]
    zz = []
    for c, p in enumerate(planes):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = (p - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        rows = _fdct_1d(blocks.transpose(3, 0, 1, 2), False)  # [col] rows
        cols = _fdct_1d(rows.transpose(3, 1, 2, 0), True)     # [row]
        coef = cols.transpose(1, 2, 0, 3).reshape(bh, bw, 64)
        d = (qts[min(c, 1)] << 3)
        q = np.where(coef < 0, -((-coef + (d >> 1)) // d),
                     (coef + (d >> 1)) // d)
        zz.append(q[..., _ZIGZAG[:64]])
    codes = [tuple({s: (c, n) for s, c, n in _canonical(b, list(v))}
                   for b, v in ((_DC_BITS[t], range(12)),
                                (_AC_BITS[t], _AC_VALS[t])))
             for t in (0, 1)]
    bits: List[str] = []

    def put(v, n):
        bits.append(format(v & ((1 << n) - 1), f"0{n}b"))

    def block(blk, t, last):
        dc, ac = codes[t]
        diff = int(blk[0]) - last
        nb = abs(diff).bit_length()
        put(*dc[nb])
        if nb:
            put(diff - 1 if diff < 0 else diff, nb)
        run = 0
        for v in blk[1:].tolist():
            if v == 0:
                run += 1
                continue
            while run > 15:
                put(*ac[0xF0])
                run -= 16
            nb = abs(v).bit_length()
            put(*ac[(run << 4) + nb])
            put(v - 1 if v < 0 else v, nb)
            run = 0
        if run:
            put(*ac[0])
        return int(blk[0])

    last = [0, 0, 0]
    for j in range(ph // mcu):
        for i in range(pw // mcu):
            if s420:
                for yy in range(2):
                    for xx in range(2):
                        last[0] = block(zz[0][2 * j + yy, 2 * i + xx], 0,
                                        last[0])
                for c in (1, 2):
                    last[c] = block(zz[c][j, i], 1, last[c])
            else:
                for c in range(nc):
                    last[c] = block(zz[c][j, i], min(c, 1), last[c])
    stream = "".join(bits)
    stream += "1" * (-len(stream) % 8)
    data = bytearray()
    for k in range(0, len(stream), 8):
        b = int(stream[k:k + 8], 2)
        data += bytes([b, 0]) if b == 0xFF else bytes([b])
    return _headers(w, h, nc, s420, qts) + bytes(data) + b"\xff\xd9"


def _headers(w, h, nc, s420, qts) -> bytes:
    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + \
            body

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    out += seg(0xDB, b"".join(bytes([t]) + bytes(qts[t][_ZIGZAG[:64]]
                                                 .tolist())
                              for t in range(1 if nc == 1 else 2)))
    comps = b"".join(bytes([c + 1, 0x22 if c == 0 and s420 else 0x11,
                            min(c, 1)]) for c in range(nc))
    out += seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
               + bytes([nc]) + comps)
    tables = [(0x00, _DC_BITS[0], bytes(range(12))),
              (0x10, _AC_BITS[0], _AC_VALS[0]),
              (0x01, _DC_BITS[1], bytes(range(12))),
              (0x11, _AC_BITS[1], _AC_VALS[1])][:2 if nc == 1 else 4]
    out += seg(0xC4, b"".join(bytes([k, *b]) + v for k, b, v in tables))
    out += seg(0xDA, bytes([nc]) + b"".join(
        bytes([c + 1, 0x11 if c else 0]) for c in range(nc)) + b"\0\x3f\0")
    return out
