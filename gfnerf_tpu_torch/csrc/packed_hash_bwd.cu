// Packed (supercell) anchored hash encode, table gradient (H2).
//
// Replaces gfnerf_tpu/fields/packed_hash.py:490 (_phe_bwd, the custom VJP of
// packed_hash_encode), which builds the dense table gradient on the TPU from
// an XLA sort, an MXU prefix sum and a run-end difference because the TPU
// has no scatter atomics. Here it is a scatter with float reductions into
// global memory, as in the reference (Hash3DAnchored_cuda.cu:46-79). Per
// (point, level), with the addressing of packed_hash_common.cuh that the
// forward (H1) uses:
//   grad[level, row, o*C + c] += w_o * g[p, level*C + c]
// over the cell's 8 corners o = (l + {0,1}) per axis of the row's lattice,
// with w_o the trilinear weight (wx * wy) * wz as _lattice_weights forms it.
// The other lattice entries have weight exactly 0 there and are skipped;
// columns past lattice*C are never written. Points with anchor < 0 add
// nothing. The gradient is f32 (the TPU path rounds its payload to bf16).
//
// Bound: the reductions. Compulsory traffic is the upstream gradient
// (P, L*C) f32, the points and anchors, and the zero-fill of the
// (L, rows, W) f32 gradient (128 MB at 8 x 2^15 x 128, larger than the 50 MB
// L2): about 0.58 GB at P = 3.15 M, 0.17 ms at 3.35 TB/s. What the L2 has to
// apply on top is one read-modify-write per reduction into rows spread over
// the table. Design, to issue as few reductions as possible and let the L2
// absorb them:
// - Level-major warps over consecutive samples (TileMap): a block stages its
//   tile's points, anchors and the launch's columns of the upstream
//   gradient in shared memory with coalesced 16-byte reads; each warp takes
//   32 consecutive points at one level.
// - Warp aggregation of runs: consecutive samples of a ray fall into the same
//   cell on the coarse levels. Lanes whose (row, local cell) key equals their
//   left neighbour's join its run; a segmented shuffle scan sums each run's
//   8 x C corner payloads (the weights differ per lane, so the payloads, not
//   g, are summed) into the run's first lane, which alone issues the adds.
//   Equal keys touch the same addresses, so the merge is exact up to the
//   order of the f32 sum. A masked lane (anchor < 0) is a run of its own
//   and adds nothing. The scan runs only as many steps as the warp's
//   longest run needs: none on the fine levels. The run finding and the
//   scan are warp_runs.cuh's, shared with the anchored layout's H5.
// - Vector reductions: each corner's C channels are C*4 contiguous, aligned
//   bytes, added with one 16-byte reduction (C = 4; two for C = 8, one
//   8-byte reduction for C = 2) through CUDA's atomicAdd(float4*, float4)
//   and atomicAdd(float2*, float2) overloads for compute capability 9.x,
//   whose result is unused (a reduction, RED, in the SASS).
// - One launch per group of levels (8 / C: 2 levels, 32 MB of
//   gradient at the main path's shape), each preceded by a cudaMemsetAsync
//   of its group's gradient on the same stream: the adds land in zeroed
//   lines the L2 still holds, not in a 128 MB gradient zeroed long before.
//   The upstream gradient, points and anchors stream through with
//   evict-first loads, so they do not push those lines out. chip_smoke.py
//   times the train batch at 1, 2, 4 and 8 levels per launch.
// With a non-null red_ops (L,) the kernel also counts the reductions it
// issues per level (one 64-bit atomic per warp and level).

#include <cuda_runtime.h>

#include "corner_vec.cuh"
#include "packed_hash_common.cuh"
#include "warp_runs.cuh"

namespace {

constexpr unsigned kFull = gfnerf::kFullWarp;
// Levels per launch: 8 / C, so that a launch's columns of a point's
// upstream gradient are 32 bytes, one sector, and its gradient (2 levels x
// 16 MB at the main path's shape) stays in the 50 MB L2 while its adds
// land. (Slice, level) pairs per warp: one (TileMap), a tile of 128 points
// at the main path's shape.
template <int C>
constexpr int kLevelGroupOf = C >= 8 ? 1 : 8 / C;
constexpr int kPasses = 1;

using gfnerf::CornerRed;  // one corner's C channels, vector reductions

template <int E, int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps) packed_hash_bwd_kernel(
    const float* __restrict__ g,        // (P, L*C) upstream gradient
    const int* __restrict__ primes,     // (L, V, 3) uint32 bits
    const float* __restrict__ bias,     // (L, V, 3)
    const float* __restrict__ scales,   // (L,)
    const int* __restrict__ dense_m,    // (L,) 0 = hashed level
    const float* __restrict__ points,   // (P, 3)
    const int* __restrict__ anchors,    // (P,)
    float* __restrict__ grad,           // (L, rows, W), zeroed
    unsigned long long* __restrict__ red_ops,  // (L,) or null
    long long n_points, int n_levels, int n_volumes, int n_rows, int width,
    gfnerf::TileMap map, int l0, int n_lev) {  // this launch: [l0, l0 + n_lev)
  const gfnerf::BlockTile work(map, n_points);
  const int lc = n_levels * C;
  const int gc = n_lev * C;  // the launch's columns of g
  const int gs = gc + 1;     // odd stride: a warp's column reads hit 32 banks
  extern __shared__ float smem[];
  float* s_g = smem;                          // [points][gs]
  float* s_pts = s_g + map.points * gs;       // [points][3]
  int* s_anc = reinterpret_cast<int*>(s_pts + map.points * 3);

  gfnerf::stage_points(points, anchors, work.p0, work.n_tile, map.points,
                       s_pts, s_anc);
  gfnerf::load_rows(g + work.p0 * lc + l0 * C, s_g, work.n_tile, gc, lc,
                    gs);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pair = warp; pair < map.slices * n_lev; pair += map.warps) {
    const int lg = pair % n_lev;  // level within the group
    const int l = l0 + lg;
    const int lp = (pair / n_lev) * 32 + lane;
    const int anchor = s_anc[lp];
    const bool valid = anchor >= 0;

    gfnerf::HashCell cell;
    float pay[8][C];  // the 8 corners' payloads, (i, j, k) order
    bool live[8];
    unsigned long long key = ~0ull;  // no valid cell has this key
    if (valid) {
      cell = gfnerf::locate<E - 1>(primes, bias, scales, dense_m,
                                   s_pts + lp * 3, anchor, l, n_volumes,
                                   n_rows);
      key = gfnerf::cell_key<E>(cell);
      float wt[3][2];
      int q[3][2];
      bool inside[3][2];
      gfnerf::axis_factors<E>(cell, wt, q, inside);
      float gv[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) gv[ch] = s_g[lp * gs + lg * C + ch];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int i = o >> 2, j = (o >> 1) & 1, k = o & 1;
        live[o] = inside[0][i] && inside[1][j] && inside[2][k];
        const float w = live[o] ? wt[0][i] * wt[1][j] * wt[2][k] : 0.f;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) pay[o][ch] = w * gv[ch];
      }
    } else {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        live[o] = false;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) pay[o][ch] = 0.f;
      }
    }

    // runs of equal keys among consecutive lanes; a masked lane is its own
    const unsigned long long left = __shfl_up_sync(kFull, key, 1);
    const bool head = !valid || lane == 0 || left != key;
    // each run's payloads summed into its head (warp_runs.cuh)
    gfnerf::sum_runs(pay, gfnerf::find_runs(head, lane), lane);

    int issued = 0;
    if (valid && head) {
      float wt[3][2];
      int q[3][2];
      bool inside[3][2];
      gfnerf::axis_factors<E>(cell, wt, q, inside);
      float* rp = grad + ((size_t)l * n_rows + cell.row) * width;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        if (!live[o]) continue;
        const int i = o >> 2, j = (o >> 1) & 1, k = o & 1;
        CornerRed<C>::add(rp + ((q[0][i] * E + q[1][j]) * E + q[2][k]) * C,
                          pay[o]);
        issued += CornerRed<C>::kOps;
      }
    }
    if (red_ops != nullptr) {
      issued = __reduce_add_sync(kFull, issued);
      if (lane == 0 && issued > 0)
        atomicAdd(red_ops + l, (unsigned long long)issued);
    }
  }
}

template <int E, int C>
int launch(const float* g, const int* primes, const float* bias,
           const float* scales, const int* dense_m, const float* points,
           const int* anchors, float* grad, unsigned long long* red_ops,
           int* launches, long long n_points, int n_levels, int n_volumes,
           int n_rows, int width, int group, cudaStream_t stream) {
  const gfnerf::TileMap map(n_levels, group > 0 ? group : kLevelGroupOf<C>,
                            kPasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (map.group * C + 1 + 3) +
      sizeof(int) * map.points;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_hash_bwd_kernel<E, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return gfnerf::launch_level_groups(
      map, n_levels, grad, (size_t)n_rows * width, stream, launches,
      [&](int l0, int n_lev) {
        packed_hash_bwd_kernel<E, C><<<(unsigned)map.n_tiles, 32 * map.warps,
                                       smem, stream>>>(
            g, primes, bias, scales, dense_m, points, anchors, grad, red_ops,
            n_points, n_levels, n_volumes, n_rows, width, map, l0, n_lev);
      });
}

}  // namespace

// Supported (lattice edge E, channels C): (2, 8), (3, 4), (4, 2), as for the
// forward. Anything else returns cudaErrorInvalidValue without launching.
// red_ops: null, or (L,) uint64 counters on the device that the kernel adds
// the number of vector reductions it issued per level to. launches: a host
// int that gets the number of kernel launches made added to it (one per
// group of levels; each group also runs one cudaMemsetAsync).
// levels_per_launch: 0 for the kernel's own choice (kLevelGroupOf), or the
// levels each launch covers, to time other groupings.
extern "C" int gfnerf_packed_hash_bwd(
    const float* g, const int* primes, const float* bias, const float* scales,
    const int* dense_m, const float* points, const int* anchors, float* grad,
    unsigned long long* red_ops, int* launches, long long n_points,
    int n_levels, int n_volumes, int n_rows, int width, int n_channels,
    int lattice_edge, int levels_per_launch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lattice_edge == 2 && n_channels == 8)
    return launch<2, 8>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, red_ops, launches, n_points, n_levels, n_volumes,
                        n_rows, width, levels_per_launch, s);
  if (lattice_edge == 3 && n_channels == 4)
    return launch<3, 4>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, red_ops, launches, n_points, n_levels, n_volumes,
                        n_rows, width, levels_per_launch, s);
  if (lattice_edge == 4 && n_channels == 2)
    return launch<4, 2>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, red_ops, launches, n_points, n_levels, n_volumes,
                        n_rows, width, levels_per_launch, s);
  return (int)cudaErrorInvalidValue;
}
