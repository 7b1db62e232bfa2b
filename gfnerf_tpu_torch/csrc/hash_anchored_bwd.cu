// Anchored multi-resolution hash encode, table gradient (H5).
//
// Replaces gfnerf_tpu/fields/hash_encoding.py:376 (_hes_bwd, the custom VJP
// of hash_encode_sorted), which builds the dense table gradient on the TPU
// per level from a sort of the corner hashes, a prefix sum and a run-end
// difference, with a bf16 payload, because the TPU has no scatter atomics:
// an order fixed by the sort, so the same inputs give the same bits.  Here
// it is the reference's design (Hash3DAnchored_cuda.cu:141-155), a scatter
// with reductions into global memory, in exact int64 fixed point
// (fixed_point.cuh, H2's), so that it too is a function of its inputs
// whatever order the warps land in.  Per (point, level), with the
// addressing of hash_anchored_common.cuh that the forward (H4) uses:
//   grad[level, entry_o, c] = sum of t = weight_o * g[p, level*C + c]
// over the cell's 8 corners o, t rounded to f32 (__fmul_rn), then to the
// level's fixed point.  Points with anchor < 0 add nothing.  The result
// equals the plain version (hash_backward_reference) bit for bit.
//
// Bound: the reductions. Compulsory traffic is the upstream gradient
// (P, L*C) f32, the points and anchors, and the (L, local, C) f32 gradient
// written once (67 MB at 16 x 2^19 x 2); on top the L2 applies one
// read-modify-write per reduction into entries spread over a level's
// table.  Design (H2's, packed_hash_bwd.cu):
// - The level maxima first, for the scale of each level's fixed point.
// - One level a launch, its sums in one int64 accumulator of (local, C)
//   (8 MB at 2^19 x 2, 32 MB at gf-nerf's 2^21), zeroed by a
//   cudaMemsetAsync before each level and converted into the level's f32
//   gradient by a pass of its own right after.
// - The packed hash's tiling (TileMap): a block stages its tile's points,
//   anchors and the level's columns of the upstream gradient in shared
//   memory; each warp takes 32 consecutive points.
// - Warp aggregation of runs (warp_runs.cuh): on the coarse levels
//   consecutive samples of a ray fall into the same cell (the coordinates
//   are each volume's own warped ones, so a step is a third of a cell even
//   at the coarsest level: at the parity train batch runs of 6.6 points
//   there and none at the finest, 39% fewer reductions over the 16
//   levels).  A lane whose (volume, x0, y0, z0) equals its left
//   neighbour's joins its run; all four are compared, whole, since the
//   primes and biases differ per volume and a cell coordinate is any
//   uint32.  A segmented shuffle scan sums each run's 8 x C corner
//   payloads (the weights differ per lane, so the payloads, not g, are
//   summed; in int64, exactly) into the run's first lane, which alone
//   makes the adds.  A masked lane (anchor < 0) is a run of its own.
// - Each corner's C channels added with C scalar 64-bit reductions
//   (corner_vec.cuh's CornerRed).
// With a non-null red_ops (L,) the kernel also counts the reductions it
// makes per level (one 64-bit atomic per warp and level).

#include <cuda_runtime.h>

#include "corner_vec.cuh"
#include "fixed_point.cuh"
#include "hash_anchored_common.cuh"
#include "warp_runs.cuh"

namespace {

constexpr unsigned kFull = gfnerf::kFullWarp;
// 32-point slices per warp: two (TileMap), a tile of 512 points.
constexpr int kPasses = 2;

using gfnerf::CornerRed;  // one corner's C channels, 64-bit reductions

__global__ void __launch_bounds__(gfnerf::kFixedThreads)
    hash_anchored_bwd_max_kernel(const float* __restrict__ g, long long n,
                                 int lc, int c, unsigned* __restrict__ gmax) {
  extern __shared__ unsigned s_max[];
  gfnerf::level_max_pass(g, n, lc, c, gmax, s_max);
}

__global__ void __launch_bounds__(gfnerf::kFixedThreads)
    hash_anchored_bwd_convert_kernel(const long long* __restrict__ acc,
                                     float* __restrict__ out, long long n,
                                     const unsigned* __restrict__ gmax,
                                     int log2_points) {
  gfnerf::convert_pass(acc, out, n, *gmax, log2_points);
}

template <int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps) hash_anchored_bwd_kernel(
    const float* __restrict__ g,        // (P, L*C) upstream gradient
    const int* __restrict__ primes,     // (L, V, 3) uint32 bits
    const float* __restrict__ bias,     // (L, V, 3)
    const float* __restrict__ scales,   // (L,)
    const float* __restrict__ points,   // (P, 3)
    const int* __restrict__ anchors,    // (P,)
    long long* __restrict__ acc,        // (local, C) sums of level l, zeroed
    const unsigned* __restrict__ gmax,  // (L,) max |g| bits per level
    unsigned long long* __restrict__ red_ops,  // (L,) or null
    long long n_points, int n_levels, int n_volumes, int local_size,
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

  const unsigned mask = (unsigned)(local_size - 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int slice = warp; slice < map.slices; slice += map.warps) {
    const int lp = slice * 32 + lane;
    const int anchor = s_anc[lp];
    const bool valid = anchor >= 0;
    const int vol = min(anchor, n_volumes - 1);  // as locate_anchored clamps

    gfnerf::AnchoredCell cell = {};
    long long pay[8][C];  // the 8 corners' payloads, (i, j, k) order
    if (valid) {
      cell = gfnerf::locate_anchored(primes, bias, scales, s_pts + lp * 3,
                                     anchor, l, n_volumes);
      float gv[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) gv[ch] = s_g[lp * gs + ch];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float w = gfnerf::corner_weight(cell, o);
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          pay[o][ch] = gfnerf::quantize(__fmul_rn(w, gv[ch]), scale);
      }
    } else {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) pay[o][ch] = 0;
      }
    }

    // runs of equal cells among consecutive lanes: the same volume (hence
    // the same primes) and the same lower corner; a masked lane is its own
    // run and ends its left neighbour's
    // (every lane takes part in every shuffle: no && between them)
    const int left_valid = __shfl_up_sync(kFull, (int)valid, 1);
    const int left_vol = __shfl_up_sync(kFull, vol, 1);
    bool same = left_valid != 0 && left_vol == vol;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const unsigned left_x0 = __shfl_up_sync(kFull, cell.x0[a], 1);
      same = same && left_x0 == cell.x0[a];
    }
    const bool head = !valid || lane == 0 || !same;
    // each run's payloads summed into its head
    gfnerf::sum_runs(pay, gfnerf::find_runs(head, lane), lane);

    int n_red = 0;
    if (valid && head) {
#pragma unroll
      for (int o = 0; o < 8; ++o)
        CornerRed<C>::add(
            acc + (size_t)gfnerf::corner_entry(cell, o, mask) * C, pay[o]);
      n_red = 8 * CornerRed<C>::kOps;
    }
    if (red_ops != nullptr) {
      n_red = __reduce_add_sync(kFull, n_red);
      if (lane == 0 && n_red > 0)
        atomicAdd(red_ops + l, (unsigned long long)n_red);
    }
  }
}

template <int C>
int launch(const float* g, const int* primes, const float* bias,
           const float* scales, const float* points, const int* anchors,
           float* grad, long long* acc, unsigned* gmax,
           unsigned long long* red_ops, int* launches, long long n_points,
           int n_levels, int n_volumes, int local_size, cudaStream_t stream) {
  const gfnerf::TileMap map(1, 1, kPasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (C + 1 + 3) + sizeof(int) * map.points;
  return gfnerf::launch_fixed_point(
      g, n_points, n_levels, C, grad, acc, gmax, (long long)local_size * C,
      stream, launches, hash_anchored_bwd_max_kernel,
      hash_anchored_bwd_convert_kernel, [&](int l, int log2_points) {
        hash_anchored_bwd_kernel<C><<<(unsigned)map.n_tiles, 32 * map.warps,
                                      smem, stream>>>(
            g, primes, bias, scales, points, anchors, acc, gmax, red_ops,
            n_points, n_levels, n_volumes, local_size, map, l, log2_points);
      });
}

}  // namespace

// Supported channels C: 2 and 4; local_size a power of two.  Anything else
// returns cudaErrorInvalidValue without launching.  The gradient need not be
// zeroed by the caller.  acc: (local, C) int64 scratch on the device (one
// level's sums); gmax: (L,) uint32 scratch (the level maxima).  red_ops:
// null, or (L,) uint64 counters on the device that the kernel adds the
// number of 64-bit reductions it made per level to (none at a level whose
// g is not finite).  launches: a host int that gets the number of kernel
// launches made added to it (1 + 2 L: the maxima, then per level the
// accumulation and the conversion; none without points).
extern "C" int gfnerf_hash_anchored_bwd(
    const float* g, const int* primes, const float* bias, const float* scales,
    const float* points, const int* anchors, float* grad, long long* acc,
    unsigned* gmax, unsigned long long* red_ops, int* launches,
    long long n_points, int n_levels, int n_volumes, int local_size,
    int n_channels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (local_size <= 0 || (local_size & (local_size - 1)))
    return (int)cudaErrorInvalidValue;
  if (n_channels == 2)
    return launch<2>(g, primes, bias, scales, points, anchors, grad, acc,
                     gmax, red_ops, launches, n_points, n_levels, n_volumes,
                     local_size, s);
  if (n_channels == 4)
    return launch<4>(g, primes, bias, scales, points, anchors, grad, acc,
                     gmax, red_ops, launches, n_points, n_levels, n_volumes,
                     local_size, s);
  return (int)cudaErrorInvalidValue;
}
