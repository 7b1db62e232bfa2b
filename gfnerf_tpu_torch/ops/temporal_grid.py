"""The temporal-grid encode's kernels (T1 forward, T2 table gradient) and
their wrappers.

``temporal_grid_fwd`` launches ``csrc/temporal_grid_fwd.cu`` (T1, the
JAX package's ``temporal_grid_encode``, ``gfnerf_tpu/fields/
temporal_grid.py:117``) and ``temporal_grid_bwd`` launches
``csrc/temporal_grid_bwd.cu`` (T2, the VJP XLA builds for that function's
gathers into the table).  Both take CUDA tensors only: the plain versions
(``fields/temporal_grid.py``) serve CPU tensors, and the differentiable
``temporal_grid_encode`` there picks between them.  Each launch covers
every level (one thread per point and level) and adds one to the
wrapper's ``launches``.
"""

from __future__ import annotations

import dataclasses

import torch

from gfnerf_tpu_torch.ops import build

KERNEL_CHANNELS = (1, 2, 4)   # level_dim values the kernels are built for
# the window table lives in shared memory: (rows, C + 2) int32 of at most
# the 48 KiB a block has without opting in
MAX_WINDOW_BYTES = 48 * 1024


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


def _check(what, tables: GridTables, xyz, times, tensors) -> None:
    dev = xyz.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if tables.level_dim not in KERNEL_CHANNELS:
        raise ValueError(f"{what}: no kernel for level_dim "
                         f"{tables.level_dim} (have {KERNEL_CHANNELS})")
    if tables.window.numel() * 4 > MAX_WINDOW_BYTES:
        raise ValueError(f"{what}: a window table of {tables.n_rows} rows "
                         f"does not fit the kernel's shared memory")
    p = xyz.shape[0]
    if (xyz.shape != (p, 3) or xyz.dtype != torch.float32
            or not xyz.is_contiguous()):
        raise ValueError(f"{what}: xyz must be contiguous (P, 3) f32")
    if (times.shape != (p,) or times.dtype != torch.float32
            or not times.is_contiguous()):
        raise ValueError(f"{what}: times must be contiguous ({p},) f32")
    for name, t in (("times", times), ("window", tables.window), *tensors):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, xyz on {dev}")


def _launch_args(tables: GridTables, xyz, times):
    return (xyz.data_ptr(), times.data_ptr(), tables.window.data_ptr(),
            tables.offsets.data_ptr(), tables.resolutions.data_ptr(),
            tables.hashed.data_ptr())


def temporal_grid_fwd(table: torch.Tensor, tables: GridTables,
                      xyz: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """T1: the encode (P, L * C) f32 of ``xyz`` (P, 3) at ``times`` (P,)
    from the f32 ``table`` (rows, C + T)."""
    _check("temporal_grid_fwd", tables, xyz, times, [("table", table)])
    n_levels = tables.resolutions.shape[0]
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[1] != tables.width):
        raise ValueError(f"temporal_grid_fwd: the table must be (rows, "
                         f"{tables.width}) f32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    table = table.contiguous()
    p = xyz.shape[0]
    out = torch.empty((p, n_levels * tables.level_dim), dtype=torch.float32,
                      device=xyz.device)
    err = build.library().gfnerf_temporal_grid_fwd(
        table.data_ptr(), *_launch_args(tables, xyz, times), out.data_ptr(),
        p, n_levels, tables.level_dim, tables.width, tables.n_rows,
        tables.time_scale, torch.cuda.current_stream(xyz.device).cuda_stream)
    build.check(err, "gfnerf_temporal_grid_fwd")
    temporal_grid_fwd.launches += 1
    return out


temporal_grid_fwd.launches = 0


def temporal_grid_bwd(g: torch.Tensor, tables: GridTables, xyz: torch.Tensor,
                      times: torch.Tensor, n_rows: int) -> torch.Tensor:
    """T2: the table gradient (n_rows, C + T) f32 of the encode, given the
    output's gradient ``g`` (P, L * C): zeroed, then every term added by
    the kernel's atomics."""
    _check("temporal_grid_bwd", tables, xyz, times, [("gradient", g)])
    n_levels = tables.resolutions.shape[0]
    p = xyz.shape[0]
    if g.shape != (p, n_levels * tables.level_dim):
        raise ValueError(f"temporal_grid_bwd: gradient {tuple(g.shape)} != "
                         f"({p}, {n_levels * tables.level_dim})")
    gc = g.to(torch.float32).contiguous()
    grad = torch.zeros((n_rows, tables.width), dtype=torch.float32,
                       device=xyz.device)
    err = build.library().gfnerf_temporal_grid_bwd(
        gc.data_ptr(), *_launch_args(tables, xyz, times), grad.data_ptr(),
        p, n_levels, tables.level_dim, tables.width, tables.n_rows,
        tables.time_scale, torch.cuda.current_stream(xyz.device).cuda_stream)
    build.check(err, "gfnerf_temporal_grid_bwd")
    temporal_grid_bwd.launches += 1
    return grad


temporal_grid_bwd.launches = 0
