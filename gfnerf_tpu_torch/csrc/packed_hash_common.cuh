// Addressing and thread mapping of the packed (supercell) anchored hash,
// shared by the forward (H1, packed_hash_fwd.cu) and the table-gradient
// backward (H2, packed_hash_bwd.cu), so that the backward scatters into
// exactly the rows and lattice entries that the forward read.
//
// Per (point, level), as gfnerf_tpu/fields/packed_hash.py computes it:
//   fma(p, scale_l, bias[level, vol]) -> supercell s, local cell l, fraction f
//   row = (sx*ux ^ sy*uy ^ sz*uz) & (rows - 1)   (uint32, packed_hash.py:154)
//         or the dense address vol*m^3 + (s mod m) . (m^2, m, 1) on the
//         first dense levels (packed_hash.py:163-199)
// The coordinate uses fmaf, as the fused XLA code does; the division by
// PACK is the shift / multiply-shift of packed_hash._div_pack.
//
// Thread mapping (TileMap): a block takes a tile of consecutive points at a
// group of levels and stages their coordinates and anchors (and, in H2,
// their upstream gradient) in shared memory.  Each warp then takes 32
// consecutive points of the tile at ONE level, one point per lane.  The
// points are ray-major and in t order, so on the coarse levels neighbouring
// lanes fall into the same cell: H1's loads of a run hit the same sectors in
// one instruction, and H2 merges each run of equal cells into one
// contributor.

#pragma once

#include <cuda_runtime.h>

namespace gfnerf {

constexpr int kWarps = 8;  // warps per block, both kernels

// floor(cell / PACK) as packed_hash._div_pack computes it (logical shift for
// powers of two, multiply-shift for 3).
template <int PACK>
__device__ __forceinline__ int div_pack(int cell) {
  if (PACK == 1) return cell;
  if (PACK == 2) return (int)((unsigned)cell >> 1);
  if (PACK == 3) return (int)(((unsigned)cell * 21846u) >> 16);
  return cell / PACK;
}

__device__ __forceinline__ int pos_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// Where one (point, level) lands in the table.
struct HashCell {
  unsigned row;   // row of the level's table
  int loc[3];     // local cell inside the supercell, per axis
  float frac[3];  // fraction inside the cell, per axis
};

// The cell of a point with anchor >= 0 (the caller skips the others).
template <int PACK>
__device__ __forceinline__ HashCell locate(
    const int* __restrict__ primes,    // (L, V, 3) uint32 bits
    const float* __restrict__ bias,    // (L, V, 3)
    const float* __restrict__ scales,  // (L,)
    const int* __restrict__ dense_m,   // (L,) 0 = hashed level
    const float pt[3], int anchor, int l, int n_volumes, int n_rows) {
  HashCell c;
  const int vol = min(anchor, n_volumes - 1);
  const int lv = (l * n_volumes + vol) * 3;
  const float scale = scales[l];
  int sup[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pk = fmaf(pt[a], scale, bias[lv + a]);
    const float cf = floorf(pk);
    c.frac[a] = pk - cf;
    const int cell = (int)cf;
    sup[a] = div_pack<PACK>(cell);
    c.loc[a] = (int)((unsigned)cell - (unsigned)sup[a] * (unsigned)PACK);
  }
  const int m = dense_m[l];
  if (m > 0) {
    const long long h = (long long)vol * m * m * m +
                        (long long)pos_mod(sup[0], m) * m * m +
                        (long long)pos_mod(sup[1], m) * m + pos_mod(sup[2], m);
    c.row = (unsigned)min(h, (long long)(n_rows - 1));
  } else {
    c.row = (((unsigned)sup[0] * (unsigned)primes[lv + 0]) ^
             ((unsigned)sup[1] * (unsigned)primes[lv + 1]) ^
             ((unsigned)sup[2] * (unsigned)primes[lv + 2])) &
            (unsigned)(n_rows - 1);
  }
  return c;
}

// Per-axis trilinear factors of the cell's two lattice positions: weight
// (1-f) at position loc and f at loc+1.  A position outside [0, E) (a cell
// the valid range never gives) gets weight 0, as in _interp_level's and
// _lattice_weights' factorized sums, and is clamped inside the row.
template <int E>
__device__ __forceinline__ void axis_factors(const HashCell& c,
                                             float wt[3][2], int q[3][2],
                                             bool inside[3][2]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int pos = c.loc[a] + u;
      inside[a][u] = pos >= 0 && pos < E;
      wt[a][u] = inside[a][u] ? (u == 0 ? 1.f - c.frac[a] : c.frac[a]) : 0.f;
      q[a][u] = min(max(pos, 0), E - 1);
    }
  }
}

// A key equal for two cells of one level exactly when they touch the same
// lattice entries with the same corners inside: the row, and per axis the
// local cell clamped to [-2, E] (below -1 or from E on, both positions of
// the axis lie outside the lattice).
template <int E>
__device__ __forceinline__ unsigned long long cell_key(const HashCell& c) {
  unsigned long long k = c.row;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    k = (k << 4) | (unsigned)(min(max(c.loc[a], -2), E) + 2);
  return k;
}

// Tiles of the kernels.  A launch covers a group of consecutive levels
// (H1: all L; H2, H4 and H5: a few, the launcher running the groups one
// after the other on the stream), and a block takes a tile of consecutive
// points at the group's levels.  Warp w of a block handles the (32-point
// slice, level) pairs w, w + warps, ...; a tile holds enough slices for
// `passes` pairs per warp.  More passes spread a block's fixed costs (the staging
// round trip, the barriers, the write-back) over more work, and cost
// shared memory.
struct TileMap {
  int group;          // levels per launch (the last may hold fewer)
  int slices;         // 32-point slices per tile
  int warps;          // warps per block
  int points;         // points per tile
  long long n_tiles;  // tiles (blocks) per launch
  __host__ __device__ TileMap(int n_levels, int group_size, int passes,
                              long long n_points) {
    group = group_size > 0 && group_size < n_levels ? group_size : n_levels;
    slices = (passes * kWarps + group - 1) / group;
    warps = slices * group < kWarps ? slices * group : kWarps;
    points = 32 * slices;
    n_tiles = (n_points + points - 1) / points;
  }
};

// This block's tile: points [p0, p0 + n_tile).
struct BlockTile {
  long long p0;
  int n_tile;
  __device__ BlockTile(const TileMap& map, long long n_points) {
    p0 = (long long)blockIdx.x * map.points;
    n_tile = (int)min((long long)map.points, n_points - p0);
  }
};

// Rows of cols floats between global memory (row stride gstride) and
// shared memory (row stride sstride), 16 bytes per global access where the
// columns and the address allow it.  The points, anchors, upstream gradient
// and output stream through once, so they move with evict-first hints
// (ld.global.cs / st.global.cs): the L2 then keeps the table (H1) or the
// gradient (H2).
__device__ __forceinline__ bool vec4_rows(const float* global, int cols,
                                          long long gstride) {
  return cols % 4 == 0 && gstride % 4 == 0 &&
         reinterpret_cast<size_t>(global) % 16 == 0;
}

__device__ __forceinline__ void load_rows(const float* __restrict__ global,
                                          float* __restrict__ shared, int n,
                                          int cols, long long gstride,
                                          int sstride) {
  if (vec4_rows(global, cols, gstride)) {
    const int q = cols / 4;
    for (int i = threadIdx.x; i < n * q; i += blockDim.x) {
      const int r = i / q;
      const int c = 4 * (i - r * q);
      const float4 v =
          __ldcs(reinterpret_cast<const float4*>(global + r * gstride + c));
      float* d = shared + r * sstride + c;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    return;
  }
  for (int i = threadIdx.x; i < n * cols; i += blockDim.x) {
    const int r = i / cols;
    shared[r * sstride + i - r * cols] =
        __ldcs(global + r * gstride + i - r * cols);
  }
}

__device__ __forceinline__ void store_rows(float* __restrict__ global,
                                           const float* __restrict__ shared,
                                           int n, int cols, long long gstride,
                                           int sstride) {
  if (vec4_rows(global, cols, gstride)) {
    const int q = cols / 4;
    for (int i = threadIdx.x; i < n * q; i += blockDim.x) {
      const int r = i / q;
      const int c = 4 * (i - r * q);
      const float* v = shared + r * sstride + c;
      __stcs(reinterpret_cast<float4*>(global + r * gstride + c),
             make_float4(v[0], v[1], v[2], v[3]));
    }
    return;
  }
  for (int i = threadIdx.x; i < n * cols; i += blockDim.x) {
    const int r = i / cols;
    __stcs(global + r * gstride + i - r * cols,
           shared[r * sstride + i - r * cols]);
  }
}

// As store_rows, with the rows of `base` (laid out as `global`) added:
// global = base + shared, one rounded f32 add per element.  `global` may be
// `base` itself: each element is read and then written by one thread, so
// neither pointer is __restrict__.
__device__ __forceinline__ void store_rows_added(
    float* global, const float* base, const float* __restrict__ shared, int n,
    int cols, long long gstride, int sstride) {
  if (vec4_rows(global, cols, gstride) &&
      reinterpret_cast<size_t>(base) % 16 == 0) {
    const int q = cols / 4;
    for (int i = threadIdx.x; i < n * q; i += blockDim.x) {
      const int r = i / q;
      const int c = 4 * (i - r * q);
      const float* v = shared + r * sstride + c;
      const float4 b =
          __ldcs(reinterpret_cast<const float4*>(base + r * gstride + c));
      __stcs(reinterpret_cast<float4*>(global + r * gstride + c),
             make_float4(__fadd_rn(b.x, v[0]), __fadd_rn(b.y, v[1]),
                         __fadd_rn(b.z, v[2]), __fadd_rn(b.w, v[3])));
    }
    return;
  }
  for (int i = threadIdx.x; i < n * cols; i += blockDim.x) {
    const int r = i / cols;
    const long long at = r * gstride + i - r * cols;
    __stcs(global + at,
           __fadd_rn(__ldcs(base + at), shared[r * sstride + i - r * cols]));
  }
}

// The launches of a kernel over groups of levels: one per group of
// map.group levels.  The table gradients (H2, H5) pass their gradient:
// each launch is then preceded by a cudaMemsetAsync of its group's
// gradient (level_floats f32 a level) on the same stream, so that the
// group's adds land in zeroed lines the L2 still holds.  The anchored
// encode (H4) passes null: nothing to zero.  launch_group(l0, n_lev)
// launches the kernel over levels [l0, l0 + n_lev); *launches counts the
// launches made.  Returns the first CUDA error, or cudaSuccess.
template <class LaunchGroup>
int launch_level_groups(const TileMap& map, int n_levels, float* grad,
                        size_t level_floats, cudaStream_t stream,
                        int* launches, LaunchGroup launch_group) {
  for (int l0 = 0; l0 < n_levels; l0 += map.group) {
    const int n_lev = map.group < n_levels - l0 ? map.group : n_levels - l0;
    cudaError_t err = cudaSuccess;
    if (grad != nullptr) {
      err = cudaMemsetAsync(grad + l0 * level_floats, 0,
                            sizeof(float) * n_lev * level_floats, stream);
      if (err != cudaSuccess) return (int)err;
    }
    if (map.n_tiles == 0) continue;
    launch_group(l0, n_lev);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return (int)cudaSuccess;
}

// Stage the tile's points (3 floats each) and anchors in shared memory,
// with evict-first loads; points past the end get anchor -1.
__device__ __forceinline__ void stage_points(
    const float* __restrict__ points, const int* __restrict__ anchors,
    long long p0, int n_tile, int tile_points, float* s_pts, int* s_anc) {
  for (int i = threadIdx.x; i < 3 * n_tile; i += blockDim.x)
    s_pts[i] = __ldcs(points + p0 * 3 + i);
  for (int i = threadIdx.x; i < tile_points; i += blockDim.x)
    s_anc[i] = i < n_tile ? __ldcs(anchors + p0 + i) : -1;
}

}  // namespace gfnerf
