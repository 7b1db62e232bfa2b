// Packed (supercell) anchored hash encode, table gradient (H2).
//
// Replaces gfnerf_tpu/fields/packed_hash.py:490 (_phe_bwd, the custom VJP of
// packed_hash_encode), which builds the dense table gradient on the TPU from
// an XLA sort, an MXU prefix sum and a run-end difference because the TPU
// has no scatter atomics: an order fixed by the sort, so the same inputs
// give the same bits.  Here it is a scatter with reductions into global
// memory, as in the reference (Hash3DAnchored_cuda.cu:46-79), in exact
// int64 fixed point (fixed_point.cuh), so that it too is a function of its
// inputs whatever order the warps land in.  Per (point, level), with the
// addressing of packed_hash_common.cuh that the forward (H1) uses:
//   grad[level, row, o*C + c] = sum of t = w_o * g[p, level*C + c]
// over the cell's 8 corners o = (l + {0,1}) per axis of the row's lattice,
// with w_o the trilinear weight (wx * wy) * wz as _lattice_weights forms it
// and t rounded to f32 (__fmul_rn), then to the level's fixed point.  The
// other lattice entries have weight exactly 0 there and are skipped;
// columns past lattice*C are never added to and stay 0.  Points with
// anchor < 0 add nothing.  The result equals the plain version
// (packed_hash_backward_reference) bit for bit.
//
// Bound: the reductions. Compulsory traffic is the upstream gradient
// (P, L*C) f32, the points and anchors, and the (L, rows, W) f32 gradient
// written once (128 MB at 8 x 2^15 x 128): about 0.58 GB at P = 3.15 M,
// 0.17 ms at 3.35 TB/s.  What the L2 has to apply on top is one
// read-modify-write per reduction into rows spread over the level.  Design:
// - The level maxima first (fixed_point.cuh: one pass over g), for the
//   scale of each level's fixed point.
// - One level a launch, its sums in one int64 accumulator of (rows, W)
//   (32 MB at 2^15 x 128, zeroed by a cudaMemsetAsync before each level, so
//   that its adds land in lines the 50 MB L2 holds), converted into the
//   level's f32 gradient by a pass of its own right after.
// - Level-major warps over consecutive samples (TileMap): a block stages
//   its tile's points, anchors and the level's columns of the upstream
//   gradient in shared memory; each warp takes 32 consecutive points.
// - Warp aggregation of runs: consecutive samples of a ray fall into the same
//   cell on the coarse levels. Lanes whose (row, local cell) key equals their
//   left neighbour's join its run; a segmented shuffle scan sums each run's
//   8 x C corner payloads (the weights differ per lane, so the payloads, not
//   g, are summed; in int64, exactly) into the run's first lane, which
//   alone issues the adds. A masked lane (anchor < 0) is a run of its own
//   and adds nothing. The scan runs only as many steps as the warp's
//   longest run needs: none on the fine levels. The run finding and the
//   scan are warp_runs.cuh's, shared with the anchored layout's H5.
// - Each live corner's C channels added with C scalar 64-bit reductions
//   (corner_vec.cuh's CornerRed).
// With a non-null red_ops (L,) the kernel also counts the reductions it
// issues per level (one 64-bit atomic per warp and level).

#include <cuda_runtime.h>

#include "corner_vec.cuh"
#include "fixed_point.cuh"
#include "packed_hash_common.cuh"
#include "warp_runs.cuh"

namespace {

constexpr unsigned kFull = gfnerf::kFullWarp;
// 32-point slices per warp: one (TileMap), a tile of 256 points.
constexpr int kPasses = 1;

using gfnerf::CornerRed;  // one corner's C channels, 64-bit reductions

__global__ void __launch_bounds__(gfnerf::kFixedThreads)
    packed_hash_bwd_max_kernel(const float* __restrict__ g, long long n,
                               int lc, int c, unsigned* __restrict__ gmax) {
  extern __shared__ unsigned s_max[];
  gfnerf::level_max_pass(g, n, lc, c, gmax, s_max);
}

__global__ void __launch_bounds__(gfnerf::kFixedThreads)
    packed_hash_bwd_convert_kernel(const long long* __restrict__ acc,
                                   float* __restrict__ out, long long n,
                                   const unsigned* __restrict__ gmax,
                                   int log2_points) {
  gfnerf::convert_pass(acc, out, n, *gmax, log2_points);
}

template <int E, int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps) packed_hash_bwd_kernel(
    const float* __restrict__ g,        // (P, L*C) upstream gradient
    const int* __restrict__ primes,     // (L, V, 3) uint32 bits
    const float* __restrict__ bias,     // (L, V, 3)
    const float* __restrict__ scales,   // (L,)
    const int* __restrict__ dense_m,    // (L,) 0 = hashed level
    const float* __restrict__ points,   // (P, 3)
    const int* __restrict__ anchors,    // (P,)
    long long* __restrict__ acc,        // (rows, W) sums of level l, zeroed
    const unsigned* __restrict__ gmax,  // (L,) max |g| bits per level
    unsigned long long* __restrict__ red_ops,  // (L,) or null
    long long n_points, int n_levels, int n_volumes, int n_rows, int width,
    gfnerf::TileMap map, int l, int log2_points) {
  const int shift = gfnerf::level_shift(gmax[l], log2_points);
  if (shift == gfnerf::kNonFinite) return;  // the conversion writes NaN
  const double scale = gfnerf::pow2(shift);
  const gfnerf::BlockTile work(map, n_points);
  const int lc = n_levels * C;
  constexpr int gs = C + 1;  // odd stride: a warp's column reads hit 32 banks
  extern __shared__ float smem[];
  float* s_g = smem;                          // [points][gs]
  float* s_pts = s_g + map.points * gs;       // [points][3]
  int* s_anc = reinterpret_cast<int*>(s_pts + map.points * 3);

  gfnerf::stage_points(points, anchors, work.p0, work.n_tile, map.points,
                       s_pts, s_anc);
  gfnerf::load_rows(g + work.p0 * lc + l * C, s_g, work.n_tile, C, lc, gs);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int slice = warp; slice < map.slices; slice += map.warps) {
    const int lp = slice * 32 + lane;
    const int anchor = s_anc[lp];
    const bool valid = anchor >= 0;

    gfnerf::HashCell cell;
    long long pay[8][C];  // the 8 corners' payloads, (i, j, k) order
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
      for (int ch = 0; ch < C; ++ch) gv[ch] = s_g[lp * gs + ch];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int i = o >> 2, j = (o >> 1) & 1, k = o & 1;
        live[o] = inside[0][i] && inside[1][j] && inside[2][k];
        const float w = live[o]
                            ? __fmul_rn(__fmul_rn(wt[0][i], wt[1][j]),
                                        wt[2][k])
                            : 0.f;
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          pay[o][ch] = gfnerf::quantize(__fmul_rn(w, gv[ch]), scale);
      }
    } else {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        live[o] = false;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) pay[o][ch] = 0;
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
      long long* rp = acc + (size_t)cell.row * width;
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
           const int* anchors, float* grad, long long* acc, unsigned* gmax,
           unsigned long long* red_ops, int* launches, long long n_points,
           int n_levels, int n_volumes, int n_rows, int width,
           cudaStream_t stream) {
  const gfnerf::TileMap map(1, 1, kPasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (C + 1 + 3) + sizeof(int) * map.points;
  return gfnerf::launch_fixed_point(
      g, n_points, n_levels, C, grad, acc, gmax, (long long)n_rows * width,
      stream, launches, packed_hash_bwd_max_kernel,
      packed_hash_bwd_convert_kernel, [&](int l, int log2_points) {
        packed_hash_bwd_kernel<E, C><<<(unsigned)map.n_tiles, 32 * map.warps,
                                       smem, stream>>>(
            g, primes, bias, scales, dense_m, points, anchors, acc, gmax,
            red_ops, n_points, n_levels, n_volumes, n_rows, width, map, l,
            log2_points);
      });
}

}  // namespace

// Supported (lattice edge E, channels C): (2, 8), (3, 4), (4, 2), as for the
// forward. Anything else returns cudaErrorInvalidValue without launching.
// acc: (rows, W) int64 scratch on the device (one level's sums); gmax: (L,)
// uint32 scratch (the level maxima).  red_ops: null, or (L,) uint64
// counters on the device that the kernel adds the number of 64-bit
// reductions it issued per level to (none at a level whose g is not
// finite).  launches: a host int that gets the number of kernel launches
// made added to it (1 + 2 L: the maxima, then per level the accumulation
// and the conversion; none without points).
extern "C" int gfnerf_packed_hash_bwd(
    const float* g, const int* primes, const float* bias, const float* scales,
    const int* dense_m, const float* points, const int* anchors, float* grad,
    long long* acc, unsigned* gmax, unsigned long long* red_ops,
    int* launches, long long n_points, int n_levels, int n_volumes,
    int n_rows, int width, int n_channels, int lattice_edge, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lattice_edge == 2 && n_channels == 8)
    return launch<2, 8>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, acc, gmax, red_ops, launches, n_points,
                        n_levels, n_volumes, n_rows, width, s);
  if (lattice_edge == 3 && n_channels == 4)
    return launch<3, 4>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, acc, gmax, red_ops, launches, n_points,
                        n_levels, n_volumes, n_rows, width, s);
  if (lattice_edge == 4 && n_channels == 2)
    return launch<4, 2>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, acc, gmax, red_ops, launches, n_points,
                        n_levels, n_volumes, n_rows, width, s);
  return (int)cudaErrorInvalidValue;
}
