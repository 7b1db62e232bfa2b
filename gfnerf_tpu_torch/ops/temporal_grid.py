"""The temporal-grid encode's kernels (T1 forward, T2 table gradient) and
their wrappers.

``temporal_grid_fwd`` launches ``csrc/temporal_grid_fwd.cu`` (T1, the
JAX package's ``temporal_grid_encode``, ``gfnerf_tpu/fields/
temporal_grid.py:117``) and ``temporal_grid_bwd`` launches
``csrc/temporal_grid_bwd.cu`` (T2, the VJP XLA builds for that function's
gathers into the table).  Both take CUDA tensors only: the plain versions
(``fields/temporal_grid.py``) serve CPU tensors, and the differentiable
``temporal_grid_encode`` there picks between them.

T1: a thread per (point, level), each warp 32 consecutive points at one
level, the blocks point-major, a launch per group of
``FWD_LEVELS_PER_LAUNCH`` levels; a corner's C + 1 contiguous window
channels in one or two vector loads.  T2 sums exactly, in int64 fixed
point at a scale a table row (``csrc/fixed_point.cuh``), so that the
gradient is a function of its inputs and equals the plain version bit
for bit: the level maxima of the upstream gradient (a level that is not
finite is NaN); a count (with the rows' largest terms) and a scatter over
the packed hash's tiles
(a launch each per group of ``levels_per_launch`` levels, by default
``BWD_LEVELS_PER_LAUNCH``), each warp's runs of equal (cell, window row)
merged into one lane, which makes one record per corner whose fixed-point
sums are not all 0, into the bucket of 8 table rows the corner lies in;
a scan of the buckets' counts; an owner pass, a warp a bucket, that sums
its records and writes its 8 rows once, zeros included.  Each wrapper
adds the kernel launches it made to its ``launches`` (T2 also its
zero-fills to ``memsets``).  Both rely on the facts of the grid that
``TemporalGridStatics.tables()`` checks: a contiguous window, hashed levels
of a power of two of rows, level offsets that are multiples of 8 rows.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gfnerf_tpu_torch.ops import build

KERNEL_CHANNELS = (1, 2, 4)   # level_dim values the kernels are built for
# levels per launch (0: all in one), timed on an H100 at 1, 2, 4, 8 and
# 16: T1 eight (1-3% faster than all 16 at the 16-level grids, the same
# as all 5 at the proposals); T2's count and scatter passes all in one
FWD_LEVELS_PER_LAUNCH = 8
BWD_LEVELS_PER_LAUNCH = 0
# T2's structure (csrc/temporal_grid_bwd.cu): buckets of BUCKET_ROWS table
# rows; a warp sums at most BWD_CHUNK records of a bucket (longer buckets
# are split into chunks that meet in an int64 slot); the scan takes
# BWD_SCAN_TILE counters a block (csrc/bucket_scan.cuh)
BUCKET_ROWS = 8
BWD_CHUNK = 1024
BWD_SCAN_TILE = 16384


@dataclasses.dataclass(frozen=True)
class GridTables:
    """A temporal grid's statics on one device: the window table (rows, C
    + 2) int32, each row the C passthrough channels, the new channel and
    the interpolating slot; the level offsets (L + 1,) int64, resolutions
    and hashed flags (L,) int32; and the scalars (``n_rows`` the window
    rows, ``table_rows`` the table's, the last level offset)."""

    window: torch.Tensor
    offsets: torch.Tensor
    resolutions: torch.Tensor
    hashed: torch.Tensor
    level_dim: int
    width: int
    n_rows: int
    time_scale: float
    table_rows: int


def n_launches(n_levels: int, levels_per_launch: int) -> int:
    """T1's kernel launches of one call over ``n_levels`` levels at
    ``levels_per_launch`` (0: all in one) with at least one point: one a
    group of levels."""
    if levels_per_launch <= 0 or levels_per_launch >= n_levels:
        return 1
    return -(-n_levels // levels_per_launch)


def bwd_launches(n_levels: int, levels_per_launch: int,
                 n_points: int) -> int:
    """T2's kernel launches of one call: the level maxima, a count and a
    scatter per group of levels, the scan and the owner pass (none without
    points)."""
    return 3 + 2 * n_launches(n_levels, levels_per_launch) if n_points \
        else 0


def bwd_memsets(n_points: int) -> int:
    """T2's zero-fills for one call: its counters' (without points, the
    gradient's)."""
    return 1


def _bwd_slots(n_records: int, n_keys: int) -> int:
    """T2's slots of long-bucket sums for a call: at least the buckets of
    more than BWD_CHUNK records there can be, at least one."""
    return max(1, min(n_keys, n_records // (BWD_CHUNK + 1)))


def _bwd_workspace(p, tables: GridTables, dev):
    """T2's scratch on ``dev`` (csrc/temporal_grid_bwd.cu says what each
    holds), from the caching allocator, sized for the most records there
    can be (8 a point and level): nothing is read back to the host."""
    n_levels = tables.resolutions.shape[0]
    n_keys = tables.table_rows // BUCKET_ROWS
    n_rec = p * n_levels * 8
    if n_rec >= 2 ** 31 - 1:
        raise ValueError(f"temporal_grid_bwd: {p} points x {n_levels} "
                         f"levels x 8 corners is past int32's records")
    n_scan = -(-n_keys // BWD_SCAN_TILE)
    n_slots = _bwd_slots(n_rec, n_keys)

    def empty(n, dtype):
        return torch.empty((max(1, n),), dtype=dtype, device=dev)

    return (empty(n_rec * (tables.level_dim + 2), torch.int64),  # records
            empty(n_keys + n_scan + 4 + n_levels + tables.table_rows,
                  torch.int32),                                  # ctrl
            empty(n_keys, torch.int32),                          # slot_of
            empty(2 * (n_rec // BWD_CHUNK), torch.int32),        # items
            empty(n_slots * BUCKET_ROWS * tables.width,          # slot_sums
                  torch.int64),
            empty(n_slots, torch.int32))                         # tickets


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
                      level_records: torch.Tensor | None = None,
                      levels_per_launch: int | None = None) -> torch.Tensor:
    """T2: the table gradient (n_rows, C + T) f32 of the encode, given the
    output's gradient ``g`` (P, L * C), equal to
    ``fields.temporal_grid.temporal_backward_reference`` bit for bit;
    ``n_rows`` is the table's rows (the grid's last level offset).
    ``level_records``, an (L,) int64 tensor on the card, if given, gets the
    records the kernel made per level added to it
    (``fields.temporal_grid.temporal_bwd_records`` reckons them)."""
    _check("temporal_grid_bwd", tables, xyz, times, [("gradient", g)])
    n_levels = tables.resolutions.shape[0]
    p = xyz.shape[0]
    if g.shape != (p, n_levels * tables.level_dim):
        raise ValueError(f"temporal_grid_bwd: gradient {tuple(g.shape)} != "
                         f"({p}, {n_levels * tables.level_dim})")
    if n_rows != tables.table_rows:
        raise ValueError(f"temporal_grid_bwd: {n_rows} rows, the grid has "
                         f"{tables.table_rows}")
    if level_records is not None and (
            level_records.shape != (n_levels,)
            or level_records.dtype != torch.int64
            or level_records.device != xyz.device):
        raise ValueError(f"temporal_grid_bwd: level_records must be "
                         f"({n_levels},) int64 on {xyz.device}")
    if levels_per_launch is None:
        levels_per_launch = BWD_LEVELS_PER_LAUNCH
    gc = g.to(torch.float32).contiguous()
    grad = torch.empty((n_rows, tables.width), dtype=torch.float32,
                       device=xyz.device)
    work = _bwd_workspace(p, tables, xyz.device)
    launches, memsets = ctypes.c_int(0), ctypes.c_int(0)
    err = build.library().gfnerf_temporal_grid_bwd(
        gc.data_ptr(), *_launch_args(tables, xyz, times), grad.data_ptr(),
        *(t.data_ptr() for t in work),
        None if level_records is None else level_records.data_ptr(),
        ctypes.addressof(launches), ctypes.addressof(memsets), p, n_rows,
        n_levels, tables.level_dim, tables.width, tables.n_rows,
        tables.time_scale, levels_per_launch,
        torch.cuda.current_stream(xyz.device).cuda_stream)
    build.check(err, "gfnerf_temporal_grid_bwd")
    temporal_grid_bwd.launches += launches.value
    temporal_grid_bwd.memsets += memsets.value
    return grad


temporal_grid_bwd.launches = 0
temporal_grid_bwd.memsets = 0
