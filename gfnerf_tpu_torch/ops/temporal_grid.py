"""The temporal-grid encode's kernels (T1 forward, T2 table gradient) and
their wrappers.

``temporal_grid_fwd`` launches ``csrc/temporal_grid_fwd.cu`` (T1, the
JAX package's ``temporal_grid_encode``, ``gfnerf_tpu/fields/
temporal_grid.py:117``) and ``temporal_grid_bwd`` launches
``csrc/temporal_grid_bwd.cu`` (T2, the VJP XLA builds for that function's
gathers into the table).  Both take CUDA tensors only: the plain versions
(``fields/temporal_grid.py``) serve CPU tensors, and the differentiable
``temporal_grid_encode`` there picks between them.

Each warp takes 32 consecutive points at one level: T1 a thread per
(point, level), the blocks point-major; T2 the packed hash's tiles (a
block stages its points, times and upstream gradient).  A launch covers a
group of consecutive levels (``levels_per_launch``; by default
``FWD_LEVELS_PER_LAUNCH`` and ``BWD_LEVELS_PER_LAUNCH``).  T1 reads a
corner's C + 1 contiguous window channels with one or two vector loads;
T2 merges each warp's runs of equal (cell, window row) into one lane,
which makes the run's vector reductions, and zeroes each group's rows of
the gradient just before the group's launch.  Each wrapper adds the kernel
launches it made (one per group of levels) to its ``launches``.  Both rely
on the facts of the grid that ``TemporalGridStatics.tables()`` checks: a
contiguous window, and hashed levels of a power of two of rows.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gfnerf_tpu_torch.ops import build

KERNEL_CHANNELS = (1, 2, 4)   # level_dim values the kernels are built for
# levels per launch (0: all in one), timed on an H100 at 1, 2, 4, 8 and
# 16: T1 eight (1-3% faster than all 16 at the 16-level grids, the same
# as all 5 at the proposals); T2 two (proposal 0 is fastest with all 5,
# proposal 1 with 4, the field with 2, ngp's step with 1; two is within
# 0.1 ms of the best at each)
FWD_LEVELS_PER_LAUNCH = 8
BWD_LEVELS_PER_LAUNCH = 2


@dataclasses.dataclass(frozen=True)
class GridTables:
    """A temporal grid's statics on one device: the window table (rows, C
    + 2) int32, each row the C passthrough channels, the new channel and
    the interpolating slot; the level offsets (L + 1,) int64, resolutions
    and hashed flags (L,) int32; and the scalars."""

    window: torch.Tensor
    offsets: torch.Tensor
    resolutions: torch.Tensor
    hashed: torch.Tensor
    level_dim: int
    width: int
    n_rows: int
    time_scale: float


def n_launches(n_levels: int, levels_per_launch: int) -> int:
    """The kernel launches of one call over ``n_levels`` levels at
    ``levels_per_launch`` (0: all in one) with at least one point."""
    if levels_per_launch <= 0 or levels_per_launch >= n_levels:
        return 1
    return -(-n_levels // levels_per_launch)


def _check(what, tables: GridTables, xyz, times, tensors) -> None:
    dev = xyz.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if tables.level_dim not in KERNEL_CHANNELS:
        raise ValueError(f"{what}: no kernel for level_dim "
                         f"{tables.level_dim} (have {KERNEL_CHANNELS})")
    p = xyz.shape[0]
    if (xyz.shape != (p, 3) or xyz.dtype != torch.float32
            or not xyz.is_contiguous()):
        raise ValueError(f"{what}: xyz must be contiguous (P, 3) f32")
    if (times.shape != (p,) or times.dtype != torch.float32
            or not times.is_contiguous()):
        raise ValueError(f"{what}: times must be contiguous ({p},) f32")
    for name, t in (("times", times), ("offsets", tables.offsets),
                    *tensors):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, xyz on {dev}")


def _launch_args(tables: GridTables, xyz, times):
    return (xyz.data_ptr(), times.data_ptr(), tables.offsets.data_ptr(),
            tables.resolutions.data_ptr(), tables.hashed.data_ptr())


def temporal_grid_fwd(table: torch.Tensor, tables: GridTables,
                      xyz: torch.Tensor, times: torch.Tensor,
                      levels_per_launch: int | None = None) -> torch.Tensor:
    """T1: the encode (P, L * C) f32 of ``xyz`` (P, 3) at ``times`` (P,)
    from the f32 ``table`` (rows, C + T), 16-byte aligned."""
    _check("temporal_grid_fwd", tables, xyz, times, [("table", table)])
    n_levels = tables.resolutions.shape[0]
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[1] != tables.width):
        raise ValueError(f"temporal_grid_fwd: the table must be (rows, "
                         f"{tables.width}) f32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    table = table.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("temporal_grid_fwd: the table must be 16-byte "
                         "aligned (the kernel reads it in float4s)")
    if levels_per_launch is None:
        levels_per_launch = FWD_LEVELS_PER_LAUNCH
    p = xyz.shape[0]
    out = torch.empty((p, n_levels * tables.level_dim), dtype=torch.float32,
                      device=xyz.device)
    launches = ctypes.c_int(0)
    err = build.library().gfnerf_temporal_grid_fwd(
        table.data_ptr(), *_launch_args(tables, xyz, times), out.data_ptr(),
        ctypes.addressof(launches), p, n_levels, tables.level_dim,
        tables.width, tables.n_rows, tables.time_scale, levels_per_launch,
        torch.cuda.current_stream(xyz.device).cuda_stream)
    build.check(err, "gfnerf_temporal_grid_fwd")
    temporal_grid_fwd.launches += launches.value
    return out


temporal_grid_fwd.launches = 0


def temporal_grid_bwd(g: torch.Tensor, tables: GridTables, xyz: torch.Tensor,
                      times: torch.Tensor, n_rows: int,
                      red_ops: torch.Tensor | None = None,
                      levels_per_launch: int | None = None) -> torch.Tensor:
    """T2: the table gradient (n_rows, C + T) f32 of the encode, given the
    output's gradient ``g`` (P, L * C); ``n_rows`` is the table's rows
    (the grid's last level offset).  Each group of levels' rows are zeroed
    and then take the kernel's reductions.  ``red_ops``, an (L,) int64
    tensor on the card, if given, gets the number of reductions the kernel
    made per level added to it."""
    _check("temporal_grid_bwd", tables, xyz, times, [("gradient", g)])
    n_levels = tables.resolutions.shape[0]
    p = xyz.shape[0]
    if g.shape != (p, n_levels * tables.level_dim):
        raise ValueError(f"temporal_grid_bwd: gradient {tuple(g.shape)} != "
                         f"({p}, {n_levels * tables.level_dim})")
    if red_ops is not None and (red_ops.shape != (n_levels,)
                                or red_ops.dtype != torch.int64
                                or red_ops.device != xyz.device):
        raise ValueError(f"temporal_grid_bwd: red_ops must be "
                         f"({n_levels},) int64 on {xyz.device}")
    if levels_per_launch is None:
        levels_per_launch = BWD_LEVELS_PER_LAUNCH
    gc = g.to(torch.float32).contiguous()
    grad = torch.empty((n_rows, tables.width), dtype=torch.float32,
                       device=xyz.device)
    launches = ctypes.c_int(0)
    err = build.library().gfnerf_temporal_grid_bwd(
        gc.data_ptr(), *_launch_args(tables, xyz, times), grad.data_ptr(),
        None if red_ops is None else red_ops.data_ptr(),
        ctypes.addressof(launches), p, n_rows, n_levels, tables.level_dim,
        tables.width, tables.n_rows, tables.time_scale, levels_per_launch,
        torch.cuda.current_stream(xyz.device).cuda_stream)
    build.check(err, "gfnerf_temporal_grid_bwd")
    temporal_grid_bwd.launches += launches.value
    return grad


temporal_grid_bwd.launches = 0
