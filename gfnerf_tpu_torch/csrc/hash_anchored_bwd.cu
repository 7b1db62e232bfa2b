// Anchored multi-resolution hash encode, table gradient (H5).
//
// Replaces gfnerf_tpu/fields/hash_encoding.py:376 (_hes_bwd, the custom VJP
// of hash_encode_sorted), which builds the dense table gradient on the TPU
// per level from a sort of the corner hashes, a prefix sum and a run-end
// difference, with a bf16 payload, because the TPU has no scatter atomics:
// an order fixed by the sort, so the same inputs give the same bits.  Here
// it is a scatter with reductions into global memory, as in the reference
// (Hash3DAnchored_cuda.cu:141-155), in exact int64 fixed point
// (fixed_point.cuh, H2's), so that it too is a function of its inputs
// whatever order the warps land in.  Per (point, level), with the
// addressing of hash_anchored_common.cuh that the forward (H4) uses:
//   grad[level, entry_o, c] = sum of t = weight_o * g[p, level*C + c]
// over the cell's 8 corners o, t rounded to f32 (__fmul_rn), then to the
// level's fixed point.  Points with anchor < 0 add nothing.  The result
// equals the plain version (hash_backward_reference) bit for bit.
//
// Each corner's C channels sit in one 16- or 32-byte piece of the level's
// int64 sums, so the design issues a corner's C reductions from C adjacent
// lanes in one instruction: the L2 then takes them as one sector's
// operations, where one lane issuing C scalar reductions sends C requests
// (2 a corner at C = 2).
// - A warp takes 32 consecutive points (ray-major, in t order) at one
//   level, one a lane, and rounds each corner's terms to the fixed point.
// - Warp aggregation of runs (warp_runs.cuh): on the coarse levels
//   consecutive samples of a ray fall into the same cell.  A lane whose
//   (volume, x0, y0, z0) equals its left neighbour's joins its run (all
//   four compared, whole: the primes and biases differ per volume and a
//   cell coordinate is any uint32); a segmented shuffle scan sums the
//   run's 8 x C corner payloads (in int64, exactly) into the run's first
//   lane.  A masked lane (anchor < 0) is a run of its own and adds
//   nothing.
// - The runs' heads stage their 8 corners' entries and sums in shared
//   memory, packed in lane order; then lane i of the warp takes item i,
//   i + 32, ... of (head, corner, channel), so that adjacent lanes add a
//   corner's adjacent channels.  A sum of 0 is skipped.
// Measured and dropped: merging a tile's corners by entry in a
// shared-memory hash table.  Along the parity batch's rays the fine levels
// step more than a cell between samples, so a tile's corners share under
// 3% of their entries there, and the table's shared 64-bit atomics on the
// coarse levels (a tile's points in few cells) took 4x the time of one
// lane's scalar reductions.
// Launches of a call: the level maxima (one pass over g), then per group of
// `group` levels (the caller's choice, hash_encoding.table_grad_group) a
// zero-fill of the group's int64 accumulator, one launch of its sums
// (level-major blocks) and one of their conversion into f32: 1 + 2
// ceil(L / group) launches and 1 + ceil(L / group) zero-fills.  A small
// call sums all its levels at once: 3 launches and 2 zero-fills.
// With a non-null red_ops (L,) the kernel also counts the global reductions
// it makes per level.

#include <cuda_runtime.h>

#include "fixed_point.cuh"
#include "hash_anchored_common.cuh"
#include "warp_runs.cuh"

namespace {

constexpr unsigned kFull = gfnerf::kFullWarp;

// Warps a block: each stages 32 heads' 8 corners, (4 + 8 C) bytes a corner
// (5 KB at C = 2, 9 KB at C = 4).
template <int C>
struct Block {
  static constexpr int kWarps = C == 2 ? 8 : 4;
};

__global__ void __launch_bounds__(gfnerf::kFixedThreads)
    hash_anchored_bwd_max_kernel(const float* __restrict__ g, long long n,
                                 int lc, int c, unsigned* __restrict__ gmax) {
  extern __shared__ unsigned s_max[];
  gfnerf::level_max_pass(g, n, lc, c, gmax, s_max);
}

__global__ void __launch_bounds__(gfnerf::kFixedThreads)
    hash_anchored_bwd_convert_kernel(const long long* __restrict__ acc,
                                     float* __restrict__ out,
                                     long long level_elems,
                                     long long level_stride,
                                     const unsigned* __restrict__ gmax,
                                     int level0, int log2_points) {
  gfnerf::convert_pass(acc, out, level_elems, level_stride, gmax, level0,
                       log2_points);
}

// Level level0 + blockIdx.y of the points of block blockIdx.x, into
// acc + level_stride * blockIdx.y (the level's (local, C) sums, zeroed).
// The blocks run level-major, so a level's lines are reduced into one
// after another (interleaving 4 levels a tile, for g's sectors, measured
// slower: 7.2 ms against 4.5 at gf-nerf's shape on an H100).
template <int C>
__global__ void __launch_bounds__(32 * Block<C>::kWarps)
    hash_anchored_bwd_kernel(
        const float* __restrict__ g,        // (P, L*C) upstream gradient
        const int* __restrict__ primes,     // (L, V, 3) uint32 bits
        const float* __restrict__ bias,     // (L, V, 3)
        const float* __restrict__ scales,   // (L,)
        const float* __restrict__ points,   // (P, 3)
        const int* __restrict__ anchors,    // (P,)
        long long* __restrict__ acc,        // the level's sums (see above)
        const unsigned* __restrict__ gmax,  // (L,) max |g| bits per level
        unsigned long long* __restrict__ red_ops,  // (L,) or null
        long long n_points, int n_levels, int n_volumes, int local_size,
        int level0, long long level_stride, int log2_points) {
  constexpr int kWarps = Block<C>::kWarps;
  __shared__ unsigned s_entry[kWarps][32 * 8];
  __shared__ long long s_sum[kWarps][32 * 8 * C];
  const int l = level0 + (int)blockIdx.y;
  const int shift = gfnerf::level_shift(gmax[l], log2_points);
  if (shift == gfnerf::kNonFinite) return;  // the conversion writes NaN
  const gfnerf::Scale32 scale = gfnerf::scale32(shift);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = ((long long)blockIdx.x * kWarps + warp) * 32 + lane;
  const int anchor = p < n_points ? __ldg(anchors + p) : -1;
  const bool valid = anchor >= 0;
  const int vol = min(anchor, n_volumes - 1);  // as locate_anchored clamps

  gfnerf::AnchoredCell cell = {};
  long long pay[8][C];  // the 8 corners' payloads, (i, j, k) order
  if (valid) {
    const float pt[3] = {__ldg(points + 3 * p), __ldg(points + 3 * p + 1),
                         __ldg(points + 3 * p + 2)};
    cell = gfnerf::locate_anchored(primes, bias, scales, pt, anchor, l,
                                   n_volumes);
    const float* gp = g + p * n_levels * C + l * C;
    float gv[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) gv[ch] = __ldg(gp + ch);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float w = gfnerf::corner_weight(cell, o);
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        pay[o][ch] = gfnerf::quantize32(__fmul_rn(w, gv[ch]), scale);
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

  // the heads' corners, packed in lane order
  const bool adds = valid && head;
  const unsigned heads = __ballot_sync(kFull, adds);
  if (adds) {
    const int first = 8 * __popc(heads & ((1u << lane) - 1u));
    const unsigned mask = (unsigned)(local_size - 1);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      s_entry[warp][first + o] = gfnerf::corner_entry(cell, o, mask);
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        s_sum[warp][(first + o) * C + ch] = pay[o][ch];
    }
  }
  __syncwarp();
  long long* lacc = acc + level_stride * blockIdx.y;
  int n_red = 0;
  for (int it = lane; it < 8 * C * __popc(heads); it += 32) {
    const long long v = s_sum[warp][it];
    if (v == 0) continue;
    atomicAdd(reinterpret_cast<unsigned long long*>(
                  lacc + (size_t)s_entry[warp][it / C] * C + it % C),
              (unsigned long long)v);
    ++n_red;
  }
  if (red_ops != nullptr) {
    n_red = __reduce_add_sync(kFull, n_red);
    if (lane == 0 && n_red > 0)
      atomicAdd(red_ops + l, (unsigned long long)n_red);
  }
}

#define GFNERF_CHECK(expr)                     \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <int C>
int launch(const float* g, const int* primes, const float* bias,
           const float* scales, const float* points, const int* anchors,
           float* grad, long long* acc, unsigned* gmax,
           unsigned long long* red_ops, int* launches, int* memsets,
           long long n_points, int n_levels, int n_volumes, int local_size,
           int group, cudaStream_t stream) {
  const long long level_elems = (long long)local_size * C;
  if (n_points == 0) {  // no points, no launch
    GFNERF_CHECK(cudaMemsetAsync(
        grad, 0, sizeof(float) * n_levels * level_elems, stream));
    ++*memsets;
    return (int)cudaSuccess;
  }
  const int lc = n_levels * C;
  const int log2_points = gfnerf::ceil_log2(n_points);
  const long long n = n_points * lc;
  unsigned blocks = gfnerf::fixed_blocks(n, 8);
  const unsigned need = (unsigned)((lc + gfnerf::kFixedThreads - 1) /
                                   gfnerf::kFixedThreads);
  blocks = blocks > need ? blocks : need;
  GFNERF_CHECK(cudaMemsetAsync(gmax, 0, sizeof(unsigned) * n_levels, stream));
  ++*memsets;
  hash_anchored_bwd_max_kernel<<<blocks, gfnerf::kFixedThreads,
                                 sizeof(unsigned) * n_levels, stream>>>(
      g, n, lc, C, gmax);
  GFNERF_CHECK(cudaGetLastError());
  ++*launches;
  constexpr int kPoints = 32 * Block<C>::kWarps;
  const unsigned tiles = (unsigned)((n_points + kPoints - 1) / kPoints);
  for (int l0 = 0; l0 < n_levels; l0 += group) {
    const int n_lev = group < n_levels - l0 ? group : n_levels - l0;
    const unsigned cblocks =
        gfnerf::fixed_blocks(level_elems, 16 / n_lev > 0 ? 16 / n_lev : 1);
    GFNERF_CHECK(cudaMemsetAsync(acc, 0,
                                 sizeof(long long) * level_elems * n_lev,
                                 stream));
    ++*memsets;
    hash_anchored_bwd_kernel<C><<<dim3(tiles, n_lev), kPoints, 0, stream>>>(
        g, primes, bias, scales, points, anchors, acc, gmax, red_ops,
        n_points, n_levels, n_volumes, local_size, l0, level_elems,
        log2_points);
    GFNERF_CHECK(cudaGetLastError());
    ++*launches;
    hash_anchored_bwd_convert_kernel<<<dim3(cblocks, n_lev),
                                       gfnerf::kFixedThreads, 0, stream>>>(
        acc, grad, level_elems, level_elems, gmax, l0, log2_points);
    GFNERF_CHECK(cudaGetLastError());
    ++*launches;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Supported channels C: 2 and 4; local_size a power of two.  Anything else
// returns cudaErrorInvalidValue without launching.  The gradient need not be
// zeroed by the caller.  group: levels a launch of the sums, at least 1;
// acc: int64 scratch on the device, (min(group, L), local, C); gmax: (L,)
// uint32 scratch (the level maxima).  red_ops: null, or (L,) uint64
// counters on the device that the kernel adds the number of 64-bit global
// reductions it made per level to (none at a level whose g is not finite).
// launches and memsets: host ints that get the kernel launches and the
// zero-fills made added to them (1 + 2 ceil(L / group) and 1 + ceil(L /
// group); without points none and 1).
extern "C" int gfnerf_hash_anchored_bwd(
    const float* g, const int* primes, const float* bias, const float* scales,
    const float* points, const int* anchors, float* grad, long long* acc,
    unsigned* gmax, unsigned long long* red_ops, int* launches, int* memsets,
    long long n_points, int n_levels, int n_volumes, int local_size,
    int n_channels, int group, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (local_size <= 0 || (local_size & (local_size - 1)) || group < 1)
    return (int)cudaErrorInvalidValue;
  if (n_channels == 2)
    return launch<2>(g, primes, bias, scales, points, anchors, grad, acc,
                     gmax, red_ops, launches, memsets, n_points, n_levels,
                     n_volumes, local_size, group, s);
  if (n_channels == 4)
    return launch<4>(g, primes, bias, scales, points, anchors, grad, acc,
                     gmax, red_ops, launches, memsets, n_points, n_levels,
                     n_volumes, local_size, group, s);
  return (int)cudaErrorInvalidValue;
}
