// Temporal multi-resolution grid encode, table gradient (T2).
//
// Replaces the VJP XLA builds for the gathers of
// gfnerf_tpu/fields/temporal_grid.py:163-171 (a scatter-add of whole
// 66-channel rows, one per (point, level, corner)).  Per (point, level),
// with T1's addressing (temporal_grid_common.cuh: window row r, slot j
// reading channel r + j, j = 0 the interpolating slot), for each corner o,
// gw_j = w_o * g[p, level * C + ((r + j) mod C)]:
//   grad[e_o, r]     += (1 - frac) * gw_0     (the old channel)
//   grad[e_o, r + j] += gw_j                  (j = 1 .. C - 1)
//   grad[e_o, r + C] += frac * gw_0           (the new channel)
// The passthrough value at the interpolating slot gets nothing, as the JAX
// package's jnp.where drops it.
//
// Bound: the bytes.  Compulsory traffic is the upstream gradient (P, L * C)
// f32, the points and times, and the dense (rows, C + T) f32 gradient
// written once (1.6 GB at nerfplayer-nerfacto's field).  On top the L2
// applies one read-modify-write per reduction, spread over the level's
// table.  Design, to make as few reductions as possible and let the L2
// absorb them (H5's, hash_anchored_bwd.cu):
// - The packed hash's tiling (TileMap): a block stages its tile's points,
//   times and the launch's columns of the upstream gradient in shared
//   memory with coalesced reads; each warp takes 32 consecutive points at
//   one level.
// - Warp aggregation of runs (warp_runs.cuh): the points are ray-major and
//   in t order, and every sample of a ray has its camera's time, so on the
//   coarse levels neighbouring lanes share both the cell and the window
//   row.  A lane whose (cell x, y, z; row) equals its left neighbour's
//   joins its run (the four compared whole: equal cells and rows address
//   equal entries, so the merge is exact up to the order of the f32 sum).
//   A segmented shuffle scan sums each run's 8 x (C + 1) payloads (the
//   weights and the fraction differ per lane, so the payloads are summed,
//   not g) into the run's first lane, which alone reduces.  A lane past the
//   tile's end is a run of its own and adds nothing.
// - The C + 1 channels are contiguous, so a corner takes vector
//   reductions (temporal_grid_common.cuh), chosen by the level's kind.  On
//   a hashed level every lane is about a run of its own and the entries
//   are scattered: the aligned float4 form, its lanes outside the window
//   adding +0.0 (1.5 reductions a corner at C = 2).  On a dense level many
//   runs of many warps meet on the same entries: the exact form (a float2
//   for each pair from an even channel, a scalar for the rest: 2 a
//   corner), whose reductions touch only the window's channels.  Timed
//   (PERF.md): the float2 form everywhere is 3-6% slower at the field and
//   ngp's step, the float4 form everywhere 12% slower at proposal 0.  The
//   hashed modulo is a mask.
// - One launch per group of levels (levels_per_launch), each preceded on
//   the stream by a kernel that zeroes the group's rows of the gradient,
//   so that the group's adds land in zeroed lines the L2 still holds where
//   the group's slice fits it (the coarse, dense levels, and a proposal's
//   whole 40 MB table), not in a 1.6 GB gradient zeroed long before.
//   chip_smoke.py times 1, 2, 4, 8 and 16 levels per launch at
//   nerfplayer-nerfacto's field.
// With a non-null red_ops (L,) the kernel also counts the reductions it
// makes per level (one 64-bit atomic per warp and level).

#include <cuda_runtime.h>

#include "packed_hash_common.cuh"
#include "temporal_grid_common.cuh"
#include "warp_runs.cuh"

namespace {

using namespace gfnerf::temporal;
using gfnerf::TileMap;

constexpr unsigned kFull = gfnerf::kFullWarp;
// (slice, level) pairs per warp, as H5 takes
constexpr int kPasses = 2;
// The zeroing kernel: blocks of 256 threads, grid-stride over the rows
constexpr int kZeroBlocks = 1056;

// Zero the rows [offsets[l0], offsets[l1]) of the gradient (the last
// group up to its n_grad_rows) with 16-byte stores: the offsets are
// multiples of 8 rows (tables() checks them), so the range starts on 16
// bytes.
__global__ void zero_levels(float* __restrict__ grad,
                            const long long* __restrict__ offsets, int l0,
                            int l1, int n_levels, long long n_grad_rows,
                            int width) {
  const long long a = offsets[l0] * width;
  const long long e = (l1 == n_levels ? n_grad_rows : offsets[l1]) * width;
  const long long n4 = (e - a) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  float4* p = reinterpret_cast<float4*>(grad + a);
  for (long long i = i0; i < n4; i += stride)
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = a + 4 * n4 + i0; i < e; i += stride) grad[i] = 0.f;
}

// Stage the tile's points (3 floats each) and times in shared memory, with
// evict-first loads.
__device__ __forceinline__ void stage_tile(const float* __restrict__ xyz,
                                           const float* __restrict__ times,
                                           long long p0, int n_tile,
                                           float* s_pts, float* s_t) {
  for (int i = threadIdx.x; i < 3 * n_tile; i += blockDim.x)
    s_pts[i] = __ldcs(xyz + p0 * 3 + i);
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x)
    s_t[i] = __ldcs(times + p0 + i);
}

template <int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps)
    temporal_grid_bwd_kernel(const float* __restrict__ g,
                             const float* __restrict__ xyz,
                             const float* __restrict__ times,
                             const long long* __restrict__ offsets,
                             const int* __restrict__ resolutions,
                             const int* __restrict__ hashed,
                             float* __restrict__ grad,
                             unsigned long long* __restrict__ red_ops,
                             long long n_points, int n_levels, int width,
                             int n_rows, float time_scale, TileMap map,
                             int l0, int n_lev) {
  const gfnerf::BlockTile work(map, n_points);
  const int lc = n_levels * C;
  const int gc = n_lev * C;  // the launch's columns of g
  const int gs = gc + 1;     // odd stride: a warp's column reads hit 32 banks
  extern __shared__ float smem[];
  float* s_g = smem;                     // [points][gs]
  float* s_pts = s_g + map.points * gs;  // [points][3]
  float* s_t = s_pts + map.points * 3;   // [points]
  stage_tile(xyz, times, work.p0, work.n_tile, s_pts, s_t);
  gfnerf::load_rows(g + work.p0 * lc + l0 * C, s_g, work.n_tile, gc, lc, gs);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pair = warp; pair < map.slices * n_lev; pair += map.warps) {
    const int lg = pair % n_lev;  // level within the group
    const int l = l0 + lg;
    const int lp = (pair / n_lev) * 32 + lane;
    const bool valid = lp < work.n_tile;
    const Level lv(offsets, resolutions, hashed, l);
    int key[4] = {0, 0, 0, -1};  // the cell x, y, z and the window row
    float pay[8][C + 1];         // the corners' payloads, channels r .. r + C
    if (valid) {
      float frac_t, frac[3];
      key[3] = time_row(s_t[lp], time_scale, n_rows, &frac_t);
      const float keep_t = __fsub_rn(1.f, frac_t);
      level_cell(s_pts + lp * 3, lv.res, key, frac);
      float gv[C];  // g in the window's order: gv[j] is slot (r + j) mod C's
#pragma unroll
      for (int j = 0; j < C; ++j)
        gv[j] = s_g[lp * gs + lg * C + (key[3] + j) % C];
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const float w = corner_weight(frac, d);
        const float gw = __fmul_rn(w, gv[0]);
        pay[d][0] = __fmul_rn(keep_t, gw);
        pay[d][C] = __fmul_rn(frac_t, gw);
#pragma unroll
        for (int j = 1; j < C; ++j) pay[d][j] = __fmul_rn(w, gv[j]);
      }
    } else {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
#pragma unroll
        for (int k = 0; k <= C; ++k) pay[d][k] = 0.f;
      }
    }

    // runs of equal (cell, row) among consecutive lanes; a lane past the
    // end is its own run and ends its left neighbour's (every lane takes
    // part in every shuffle: no && between them)
    bool same = __shfl_up_sync(kFull, (int)valid, 1) != 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int left = __shfl_up_sync(kFull, key[a], 1);
      same = same && left == key[a];
    }
    const bool head = !valid || lane == 0 || !same;
    gfnerf::sum_runs(pay, gfnerf::find_runs(head, lane), lane);

    int n_red = 0;
    if (valid && head) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const long long b = corner_row(key, d, lv) * width + key[3];
        n_red += lv.hashed ? red_window4<C>(grad, b, pay[d])
                           : red_window<C>(grad, b, pay[d]);
      }
    }
    if (red_ops != nullptr) {
      n_red = __reduce_add_sync(kFull, n_red);
      if (lane == 0 && n_red > 0)
        atomicAdd(red_ops + l, (unsigned long long)n_red);
    }
  }
}

template <int C>
int launch(const float* g, const float* xyz, const float* times,
           const long long* offsets, const int* res, const int* hashed,
           float* grad, unsigned long long* red_ops, int* launches,
           long long n_points, long long n_grad_rows, int n_levels,
           int width, int n_rows, float time_scale, int group,
           cudaStream_t stream) {
  const TileMap map(n_levels, group, kPasses, n_points);
  const size_t smem = sizeof(float) * map.points * (map.group * C + 1 + 4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        temporal_grid_bwd_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (map.n_tiles == 0) {  // no points: the gradient is all zeros
    zero_levels<<<kZeroBlocks, 256, 0, stream>>>(grad, offsets, 0, n_levels,
                                                 n_levels, n_grad_rows, width);
    return (int)cudaGetLastError();
  }
  return launch_groups(
      n_levels, map.group, map.n_tiles, launches, [&](int l0, int n_lev) {
        zero_levels<<<kZeroBlocks, 256, 0, stream>>>(
            grad, offsets, l0, l0 + n_lev, n_levels, n_grad_rows, width);
        temporal_grid_bwd_kernel<C><<<(unsigned)map.n_tiles, 32 * map.warps,
                                      smem, stream>>>(
            g, xyz, times, offsets, res, hashed, grad, red_ops, n_points,
            n_levels, width, n_rows, time_scale, map, l0, n_lev);
      });
}

}  // namespace

// Supported channels C: 1, 2 and 4.  The grid must hold the two facts of
// temporal_grid_common.cuh and level offsets that are multiples of 8 rows
// (TemporalGridStatics.tables() checks them); the gradient (n_grad_rows >=
// offsets[L] rows of width f32) must be 16-byte aligned and need not be
// zeroed by the caller.  red_ops: null, or (L,) uint64 counters on the
// device that the kernel adds the number of reductions it made per level
// to.  launches: a host int that gets the number of kernel launches made
// added to it (one per group of levels, each after its group's zeroing
// launch, which is not counted).  levels_per_launch: the levels each
// launch covers (0 or more than L: all in one launch).
extern "C" int gfnerf_temporal_grid_bwd(
    const float* g, const float* xyz, const float* times,
    const long long* offsets, const int* res, const int* hashed, float* grad,
    unsigned long long* red_ops, int* launches, long long n_points,
    long long n_grad_rows, int n_levels, int level_dim, int width,
    int n_rows, float time_scale, int levels_per_launch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (level_dim) {
    case 1:
      return launch<1>(g, xyz, times, offsets, res, hashed, grad, red_ops,
                       launches, n_points, n_grad_rows, n_levels, width,
                       n_rows, time_scale, levels_per_launch, s);
    case 2:
      return launch<2>(g, xyz, times, offsets, res, hashed, grad, red_ops,
                       launches, n_points, n_grad_rows, n_levels, width,
                       n_rows, time_scale, levels_per_launch, s);
    case 4:
      return launch<4>(g, xyz, times, offsets, res, hashed, grad, red_ops,
                       launches, n_points, n_grad_rows, n_levels, width,
                       n_rows, time_scale, levels_per_launch, s);
  }
  return (int)cudaErrorInvalidValue;
}
