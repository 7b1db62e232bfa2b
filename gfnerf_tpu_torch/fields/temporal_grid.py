"""Time-conditioned multi-resolution grid encoding (NeRFPlayer).

Port of ``gfnerf_tpu/fields/temporal_grid.py`` (the reference's CUDA
``temporal_gridencoder``).  The table stores ``level_dim + temporal_dim``
channels a grid vertex.  A time picks a window row: ``val = clip(t, 0, 1)
* max(T - 2, 1)``, ``row = min(int(val), T - 2)``, ``frac_t = val - row``.
At that row the ``level_dim`` output slots read the stored channels
``sel_pass[row]``, except the slot ``interp_pos[row]``, which reads
``(1 - frac_t) * old + frac_t * new`` with ``old = sel_old[row]`` (always
``sel_pass[row][interp_pos[row]]``) and ``new = sel_new[row]``.  Per level
a point's cell is ``floor(xyz * res)``, its 8 corners (x outermost, z
innermost) clamped to ``[0, res]`` and indexed densely or by the XOR-prime
hash modulo the level's rows (in uint32 arithmetic), and the slots are
summed over the corners with the trilinear weights ``((wx * wy) * wz)``.

:func:`make_temporal_grid` builds the table and the statics with numpy
exactly as the JAX package does (:func:`temporal_grid_statics` the statics
alone).  :func:`temporal_grid_encode_raw` is the
plain PyTorch forward: it gathers only the ``level_dim + 1`` channels a
corner uses, at ``(row) * (C + T) + channel`` of the flat table, in the
JAX package's order of every sum; :func:`temporal_backward_reference` is
the plain table gradient, every term rounded once to an int64 fixed point
at its table row's scale (:func:`row_shifts`) and summed exactly, so that
it is a function of its inputs whatever the order of the points, as the
JAX package's scatter-add is (no dense row gradient per corner, which is
what a gather's autograd would build); :func:`temporal_bwd_records`
reckons the records T2's count pass makes per level.
:func:`temporal_grid_encode` is differentiable in the table: on CPU
tensors it runs the plain pair, on CUDA tensors kernel T1
(``csrc/temporal_grid_fwd.cu``) forward and T2
(``csrc/temporal_grid_bwd.cu``) backward, or raises;
:func:`plain_temporal_grid_encode` is the plain pair on any device.
:func:`temporal_tv_loss` is the temporal TV regularizer at a window row
the caller draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from gfnerf_tpu_torch.fields.hash_encoding import _pow2, fixed_point_shifts
from gfnerf_tpu_torch.ops import temporal_grid as ops

_PRIMES = (1, 2654435761, 805459861)   # instant-NGP / torch-ngp primes
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(eq=False)
class TemporalGridStatics:
    """Fixed addressing and channel-window tables (host-built, numpy).
    Compared by identity: each keeps its own device copies."""

    offsets: np.ndarray        # (L+1,) int64 — row offset of each level
    resolutions: np.ndarray    # (L,) int32
    hashed: np.ndarray         # (L,) bool — the level hashes (else dense)
    sel_pass: np.ndarray       # (T-1, C) int32 — passthrough channel a slot
    sel_old: np.ndarray        # (T-1,) int32 — interpolation source channel
    sel_new: np.ndarray        # (T-1,) int32 — interpolation target channel
    interp_pos: np.ndarray     # (T-1,) int32 — the slot that interpolates
    level_dim: int = 2
    temporal_dim: int = 64
    _device: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_levels(self) -> int:
        return len(self.resolutions)

    @property
    def n_rows(self) -> int:
        """The window rows, ``max(T - 1, 1)``."""
        return len(self.sel_old)

    @property
    def width(self) -> int:
        """Stored channels a table row, ``C + T``."""
        return self.level_dim + self.temporal_dim

    @property
    def time_scale(self) -> float:
        return float(max(self.temporal_dim - 2, 1))

    def check_kernel_facts(self) -> None:
        """Raise unless the grid holds what T1 and T2 assume: a contiguous
        window (at row r the slots read the channels r .. r + C - 1, slot
        c the one congruent to c mod C, the interpolating slot is r mod C,
        its old channel r and its new channel r + C), at most T - 1 rows
        (so a channel of the row follows every window), hashed levels of a
        power of two of rows, and level offsets that are multiples of 8
        rows.  make_temporal_grid's grids hold all four."""
        c, r = self.level_dim, np.arange(self.n_rows)
        slots = np.arange(c)
        closed = r[:, None] + (slots[None, :] - r[:, None]) % c
        if not (np.array_equal(self.sel_pass, closed)
                and np.array_equal(self.sel_old, r)
                and np.array_equal(self.sel_new, r + c)
                and np.array_equal(self.interp_pos, r % c)):
            raise ValueError("temporal grid: the window rows are not the "
                             "contiguous channels r .. r + C")
        if self.n_rows > max(self.temporal_dim - 1, 0):
            raise ValueError(f"temporal grid: {self.n_rows} window rows at "
                             f"T = {self.temporal_dim}")
        sizes = np.diff(self.offsets)
        hashed = sizes[self.hashed]
        if (hashed & (hashed - 1)).any():
            raise ValueError(f"temporal grid: hashed levels of "
                             f"{hashed.tolist()} rows, not all powers of two")
        if (self.offsets % 8).any():
            raise ValueError(f"temporal grid: level offsets "
                             f"{self.offsets.tolist()} not multiples of 8")

    def tables(self, device) -> ops.GridTables:
        """The statics as device tensors (built once per device), after
        :meth:`check_kernel_facts`."""
        device = torch.device(device)
        if device not in self._device:
            self.check_kernel_facts()
            c = self.level_dim
            win = np.concatenate([self.sel_pass, self.sel_new[:, None],
                                  self.interp_pos[:, None]], 1)
            self._device[device] = ops.GridTables(
                window=torch.tensor(win.astype(np.int32), device=device),
                offsets=torch.tensor(self.offsets.astype(np.int64),
                                     device=device),
                resolutions=torch.tensor(self.resolutions.astype(np.int32),
                                         device=device),
                hashed=torch.tensor(self.hashed.astype(np.int32),
                                    device=device),
                level_dim=c, width=self.width, n_rows=self.n_rows,
                time_scale=self.time_scale,
                table_rows=int(self.offsets[-1]))
        return self._device[device]


def temporal_grid_statics(
    temporal_dim: int = 64,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int | None = None,
    per_level_scale: float = 2.0,
) -> TemporalGridStatics:
    """A grid's statics, as the JAX package builds them (no table)."""
    if desired_resolution is not None:
        per_level_scale = float(np.exp2(
            np.log2(desired_resolution / base_resolution)
            / max(num_levels - 1, 1)))
    cap = 1 << log2_hashmap_size
    offsets, resolutions, hashed = [0], [], []
    for l in range(num_levels):
        res = int(math.ceil(base_resolution * per_level_scale ** l))
        verts = (res + 1) ** 3
        n = int(math.ceil(min(cap, verts) / 8) * 8)
        resolutions.append(res)
        hashed.append(verts > cap)
        offsets.append(offsets[-1] + n)

    # the sliding window: row r replaces active[r % C] with the next
    # unused stored channel
    c, t = level_dim, temporal_dim
    active = list(range(c))
    sel_pass, sel_old, sel_new, interp_pos = [], [], [], []
    nxt = c
    for r in range(max(t - 1, 1)):
        pos = r % c
        sel_old.append(active[pos])
        sel_new.append(nxt)
        interp_pos.append(pos)
        sel_pass.append(list(active))
        active[pos] = nxt
        nxt += 1
    return TemporalGridStatics(
        offsets=np.asarray(offsets, np.int64),
        resolutions=np.asarray(resolutions, np.int32),
        hashed=np.asarray(hashed, bool),
        sel_pass=np.asarray(sel_pass, np.int32),
        sel_old=np.asarray(sel_old, np.int32),
        sel_new=np.asarray(sel_new, np.int32),
        interp_pos=np.asarray(interp_pos, np.int32),
        level_dim=level_dim, temporal_dim=temporal_dim)


def make_temporal_grid(
    seed: int,
    temporal_dim: int = 64,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int | None = None,
    per_level_scale: float = 2.0,
):
    """(embeddings (rows, level_dim + temporal_dim) f32 numpy, statics),
    drawn exactly as the JAX package draws them."""
    statics = temporal_grid_statics(temporal_dim, num_levels, level_dim,
                                    base_resolution, log2_hashmap_size,
                                    desired_resolution, per_level_scale)
    rng = np.random.default_rng(seed)
    emb = rng.uniform(-1e-4, 1e-4, (int(statics.offsets[-1]), statics.width)
                      ).astype(np.float32)
    return emb, statics


def time_window(statics: TemporalGridStatics, times: torch.Tensor):
    """(row (P,) int64, frac_t (P,) f32) of each time."""
    val = torch.clamp(times, 0.0, 1.0) * statics.time_scale
    row = torch.clamp(val.to(torch.int32), max=statics.n_rows - 1)
    return row.long(), val - row.to(torch.float32)


def _corners(statics: TemporalGridStatics, xyz: torch.Tensor, level: int):
    """The 8 corners of each point at one level, in the JAX order (x
    outermost, z innermost): a list of (table row (P,) int64, weight (P,)
    f32)."""
    res = int(statics.resolutions[level])
    off = int(statics.offsets[level])
    n_level = int(statics.offsets[level + 1]) - off
    pos = xyz * float(res)
    lower = torch.floor(pos)
    cell = lower.to(torch.int64)
    frac = pos - lower
    out = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cx, cy, cz = (torch.clamp(cell[:, a] + d, 0, res)
                              for a, d in enumerate((dx, dy, dz)))
                if statics.hashed[level]:
                    idx = (((cx * _PRIMES[0]) & _U32)
                           ^ ((cy * _PRIMES[1]) & _U32)
                           ^ ((cz * _PRIMES[2]) & _U32)) % n_level
                else:
                    idx = cx + (res + 1) * (cy + (res + 1) * cz)
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                out.append((off + idx, w))
    return out


def _window_channels(statics, tables, row):
    """Each point's passthrough channels (P, C) and new channel (P,), and
    its interpolating slot (P,)."""
    win = tables.window[row].long()
    c = statics.level_dim
    return win[:, :c], win[:, c], win[:, c + 1]


def temporal_grid_encode_raw(embeddings: torch.Tensor,
                             statics: TemporalGridStatics,
                             xyz: torch.Tensor,
                             times: torch.Tensor) -> torch.Tensor:
    """Plain forward: (P, L * C) f32, laid out ``out[:, level * C + c]``.
    Per corner it reads the C passthrough channels (the interpolating
    slot's is ``old``) and ``new``; ``mixed = (1 - frac_t) * old + frac_t
    * new``; ``acc = acc + w * feat``, each product and sum rounded once,
    as the JAX package's ops are."""
    c, width = statics.level_dim, statics.width
    tables = statics.tables(xyz.device)
    flat = embeddings.reshape(-1)
    row, frac_t = time_window(statics, times)
    passes, ch_new, ipos = _window_channels(statics, tables, row)
    slots = torch.arange(c, device=xyz.device)[None, :]
    is_mix = slots == ipos[:, None]
    cols = []
    for level in range(statics.n_levels):
        acc = torch.zeros((xyz.shape[0], c), dtype=torch.float32,
                          device=xyz.device)
        for rows, w in _corners(statics, xyz, level):
            base = (rows * width)[:, None]
            passed = flat[base + passes]
            old = passed.gather(1, ipos[:, None])[:, 0]
            new = flat[base[:, 0] + ch_new]
            mixed = (1.0 - frac_t) * old + frac_t * new
            feat = torch.where(is_mix, mixed[:, None], passed)
            acc = acc + w[:, None] * feat
        cols.append(acc)
    return torch.cat(cols, dim=-1)


def temporal_scatter_terms(g: torch.Tensor, statics: TemporalGridStatics,
                           xyz: torch.Tensor, times: torch.Tensor):
    """The table gradient's terms, one (flat index (P, C + 1), value (P, C
    + 1), level) triple per (level, corner), indexing the table viewed
    flat: for each slot c, ``w * g[c]`` into its passthrough channel,
    except the interpolating slot's, which adds ``(1 - frac_t) * w * g[c]``
    into ``old`` and ``frac_t * w * g[c]`` into ``new`` (the last
    column)."""
    c, width = statics.level_dim, statics.width
    p = xyz.shape[0]
    tables = statics.tables(xyz.device)
    g = g.reshape(p, statics.n_levels, c).to(torch.float32)
    row, frac_t = time_window(statics, times)
    passes, ch_new, ipos = _window_channels(statics, tables, row)
    slots = torch.arange(c, device=xyz.device)[None, :]
    is_mix = slots == ipos[:, None]
    omt = (1.0 - frac_t)[:, None]
    for level in range(statics.n_levels):
        gl = g[:, level]
        g_mix = gl.gather(1, ipos[:, None])
        for rows, w in _corners(statics, xyz, level):
            base = (rows * width)[:, None]
            gw = w[:, None] * gl
            vals = torch.cat([torch.where(is_mix, omt * gw, gw),
                              frac_t[:, None] * (w[:, None] * g_mix)], 1)
            yield (torch.cat([base + passes, base + ch_new[:, None]], 1),
                   vals, level)


def _level_terms(g, statics: TemporalGridStatics, xyz, times):
    """Per level: (flat index (P, 8 (C + 1)), f32 terms of the same shape)
    of :func:`temporal_scatter_terms`, the 8 corners side by side."""
    idx, vals = [], []
    for i, v, level in temporal_scatter_terms(g, statics, xyz, times):
        idx.append(i)
        vals.append(v)
        if len(idx) == 8:
            yield level, torch.cat(idx, 1), torch.cat(vals, 1)
            idx, vals = [], []


def row_shifts(rows: torch.Tensor, terms: torch.Tensor, n_rows: int,
               n_points: int) -> torch.Tensor:
    """(n_rows,) int64: each table row's fixed-point shift, s = 59 -
    ceil(log2 P) - E, where E is the exponent ``frexp`` gives the row's
    largest |term| (0 for a row without a nonzero term).  An entry takes
    at most 8 P terms (8 corners a point, each into a channel once), each
    below 2^E, so its sum at the scale 2^s stays below 2^62."""
    amax = torch.zeros(n_rows, dtype=torch.float32, device=terms.device)
    amax.scatter_reduce_(0, rows.reshape(-1), terms.abs().reshape(-1),
                         "amax")
    _, e = torch.frexp(amax)
    return 59 - max(n_points - 1, 0).bit_length() - e.to(torch.int64)


def temporal_backward_reference(g, statics: TemporalGridStatics, xyz, times,
                                n_rows: int) -> torch.Tensor:
    """Plain table gradient (n_rows, C + T) f32, what T2 computes, bit for
    bit, whatever the order of the points: every term of
    :func:`temporal_scatter_terms` rounded once to int64 at its table
    row's scale, q = rint(t * 2^s_row) (half to even; the product exact in
    f64; :func:`row_shifts`), the q summed exactly, each sum converted as
    RN_f32(RN_f64(sum) * 2^-s_row).  Each row's scale follows its own
    largest term, so a row of small terms keeps them as an f32 sum would.
    A level whose upstream gradient holds a NaN or an inf is NaN
    throughout."""
    if n_rows != int(statics.offsets[-1]):
        raise ValueError(f"temporal_backward_reference: {n_rows} rows, the "
                         f"grid has {int(statics.offsets[-1])}")
    width = statics.width
    _, finite = fixed_point_shifts(g, statics.n_levels, statics.level_dim)
    acc = torch.zeros(n_rows * width, dtype=torch.int64, device=xyz.device)
    shift = torch.zeros(n_rows, dtype=torch.int64, device=xyz.device)
    for level, idx, vals in _level_terms(g, statics, xyz, times):
        a, b = int(statics.offsets[level]), int(statics.offsets[level + 1])
        rows = torch.div(idx, width, rounding_mode="floor")
        shift[a:b] = row_shifts(rows - a, vals, b - a, xyz.shape[0])
        t = vals.to(torch.float64) * _pow2(shift[rows])
        t = torch.where(finite[level], t, 0.0)
        acc.index_add_(0, idx.reshape(-1),
                       torch.round(t).to(torch.int64).reshape(-1))
    out = acc.view(n_rows, width).to(torch.float64) * _pow2(-shift)[:, None]
    out = out.to(torch.float32)
    for level in range(statics.n_levels):
        a, b = int(statics.offsets[level]), int(statics.offsets[level + 1])
        out[a:b] = torch.where(finite[level], out[a:b], float("nan"))
    return out


def temporal_bwd_records(g, statics: TemporalGridStatics, xyz, times,
                         warp: int = 32) -> torch.Tensor:
    """(L,) int64: the records T2 makes per level (its count pass counts
    them).  Its warps take ``warp`` consecutive points from a multiple of
    ``warp`` on, at one level; a run of consecutive points with equal cell
    ``floor(xyz * res)`` and window row sums its corners' terms into its
    first point, which makes one record per live corner: one for which a
    point of the run has a term that is not 0.  A level whose g is not
    finite makes none."""
    p = xyz.shape[0]
    _, finite = fixed_point_shifts(g, statics.n_levels, statics.level_dim)
    row, _ = time_window(statics, times)
    first = torch.arange(p, device=xyz.device) % warp == 0
    out = []
    for level, _, vals in _level_terms(g, statics, xyz, times):
        nonzero = (vals.view(p, 8, -1) != 0).any(-1)
        cell = torch.floor(xyz * float(statics.resolutions[level])).long()
        key = torch.cat([cell, row[:, None]], 1)
        same = torch.zeros(p, dtype=torch.bool, device=xyz.device)
        same[1:] = (key[1:] == key[:-1]).all(-1)
        head = first | ~same
        run = torch.cumsum(head.long(), 0) - 1
        hits = torch.zeros((int(head.sum()), 8), dtype=torch.int64,
                           device=xyz.device)
        hits.index_add_(0, run, nonzero.long())
        out.append(torch.where(finite[level], (hits > 0).sum(), 0))
    return torch.stack(out)


def _check_inputs(embeddings, statics, xyz, times) -> None:
    p = xyz.shape[0]
    if xyz.dim() != 2 or xyz.shape[1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"temporal_grid_encode: xyz must be (P, 3) f32, "
                         f"got {tuple(xyz.shape)} {xyz.dtype}")
    if times.shape != (p,) or times.dtype != torch.float32:
        raise ValueError(f"temporal_grid_encode: times must be ({p},) f32, "
                         f"got {tuple(times.shape)} {times.dtype}")
    want = (int(statics.offsets[-1]), statics.width)
    if tuple(embeddings.shape) != want:
        raise ValueError(f"temporal_grid_encode: table {tuple(embeddings.shape)}"
                         f", the statics say {want}")
    for name, t in (("times", times), ("embeddings", embeddings)):
        if t.device != xyz.device:
            raise ValueError(f"temporal_grid_encode: {name} on {t.device}, "
                             f"xyz on {xyz.device}")


class _TemporalGridEncode(torch.autograd.Function):
    """T1 forward and T2 table gradient on CUDA tensors; the plain pair on
    CPU tensors or when ``plain`` is set.  No gradient flows to the points
    or the times (the JAX package's encode is differentiated in the table
    alone: its positions and times come from the rays and cameras)."""

    @staticmethod
    def forward(ctx, embeddings, statics, xyz, times, plain):
        ctx.save_for_backward(xyz, times)
        ctx.statics = statics
        ctx.n_rows = embeddings.shape[0]
        ctx.plain = plain or xyz.device.type == "cpu"
        if ctx.plain:
            return temporal_grid_encode_raw(embeddings, statics, xyz, times)
        return ops.temporal_grid_fwd(embeddings.detach(),
                                     statics.tables(xyz.device), xyz, times)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 5
        xyz, times = ctx.saved_tensors
        if ctx.plain:
            grad = temporal_backward_reference(g, ctx.statics, xyz, times,
                                               ctx.n_rows)
        else:
            grad = ops.temporal_grid_bwd(g, ctx.statics.tables(xyz.device),
                                         xyz, times, ctx.n_rows)
        return grad, None, None, None, None


def temporal_grid_encode(embeddings: torch.Tensor,
                         statics: TemporalGridStatics, xyz: torch.Tensor,
                         times: torch.Tensor,
                         plain: bool = False) -> torch.Tensor:
    """The encode (P, L * C) of points ``xyz`` (P, 3) in [0, 1] at times
    ``times`` (P,), differentiable in ``embeddings``: the plain pair for
    CPU tensors (or with ``plain``), T1 and T2 for CUDA tensors."""
    xyz, times = xyz.contiguous(), times.contiguous()
    _check_inputs(embeddings, statics, xyz, times)
    return _TemporalGridEncode.apply(embeddings, statics, xyz, times, plain)


def plain_temporal_grid_encode(embeddings, statics, xyz, times):
    """``temporal_grid_encode`` through the plain forward and backward on
    any device (launches no kernel)."""
    return temporal_grid_encode(embeddings, statics, xyz, times, plain=True)


def temporal_tv_loss(embeddings: torch.Tensor, statics: TemporalGridStatics,
                     row: torch.Tensor) -> torch.Tensor:
    """The temporal TV regularizer: ``mean |emb[:, old] - emb[:, new]|``
    over every table row, at window row ``row`` (a 0-d or (1,) int64
    tensor the caller draws; no host sync)."""
    tables = statics.tables(embeddings.device)
    win = tables.window[row.reshape(1).to(embeddings.device)].long()
    c = statics.level_dim
    old = win[:, :c].gather(1, win[:, c + 1:c + 2])[:, 0]
    new = win[:, c]
    diff = (embeddings.index_select(1, old)
            - embeddings.index_select(1, new))
    return diff.abs().mean()
