// Anchored multi-resolution hash encode, table gradient (H5).
//
// Replaces gfnerf_tpu/fields/hash_encoding.py:376 (_hes_bwd, the custom VJP
// of hash_encode_sorted), which builds the dense table gradient on the TPU
// per level from a sort of the corner hashes, a prefix sum and a run-end
// difference, with a bf16 payload, because the TPU has no scatter atomics.
// Here it is the reference's design (Hash3DAnchored_cuda.cu:141-155): a
// scatter with float reductions into global memory, in f32.  Per (point,
// level), with the addressing of hash_anchored_common.cuh that the forward
// (H4) uses:
//   grad[level, entry_o, c] += weight_o * g[p, level*C + c]
// over the cell's 8 corners o.  Points with anchor < 0 add nothing.
//
// Bound: the reductions. Compulsory traffic is the upstream gradient
// (P, L*C) f32, the points and anchors, and the zero-fill of the (L, local,
// C) f32 gradient (67 MB at 16 x 2^19 x 2, more than the 50 MB L2); on top
// the L2 applies one read-modify-write per reduction into entries spread
// over a level's table.  Design, to make as few reductions as possible and
// let the L2 absorb them (H2's, packed_hash_bwd.cu):
// - The packed hash's tiling (TileMap): a block stages its tile's points,
//   anchors and the launch's columns of the upstream gradient in shared
//   memory with coalesced reads; each warp takes 32 consecutive points at
//   one level.
// - Warp aggregation of runs (warp_runs.cuh): on the coarse levels
//   consecutive samples of a ray fall into the same cell (the coordinates
//   are each volume's own warped ones, so a step is a third of a cell even
//   at the coarsest level: at the parity train batch runs of 6.6 points
//   there and none at the finest, 39% fewer reductions over the 16
//   levels).  A lane whose (volume,
//   x0, y0, z0) equals its left neighbour's joins its run; all four are
//   compared, whole, since the primes and biases differ per volume and a
//   cell coordinate is any uint32.  A segmented shuffle scan sums each
//   run's 8 x C corner payloads (the weights differ per lane, so the
//   payloads, not g, are summed) into the run's first lane, which alone
//   makes the adds.  Equal cells address equal entries: exact up to the
//   order of the f32 sum.  A masked lane (anchor < 0) is a run of its own.
// - One vector reduction per corner: atomicAdd(float2*) at C = 2,
//   atomicAdd(float4*) at C = 4 (corner_vec.cuh).
// - One launch per group of levels (kLevelGroup), each preceded by a
//   cudaMemsetAsync of its group's gradient on the same stream: the adds
//   land in zeroed lines the L2 still holds (4 MB a level at 2^19 x 2),
//   not in a 67 MB gradient zeroed long before.  The upstream gradient,
//   points and anchors stream through with evict-first loads.
//   chip_smoke.py times the parity batch at 1, 2, 4, 8 and 16 levels per
//   launch.
// With a non-null red_ops (L,) the kernel also counts the reductions it
// makes per level (one 64-bit atomic per warp and level).

#include <cuda_runtime.h>

#include "corner_vec.cuh"
#include "hash_anchored_common.cuh"
#include "warp_runs.cuh"

namespace {

constexpr unsigned kFull = gfnerf::kFullWarp;
// Levels per launch: 8 / C, so that a launch's columns of a point's
// upstream gradient are 32 bytes, one sector (16 MB of gradient a launch at
// 2^19 entries a level).  (32 points, level) pairs per warp: two (TileMap), a
// tile of 128 points at 4 levels.
template <int C>
constexpr int kLevelGroup = 8 / C;
constexpr int kPasses = 2;

using gfnerf::CornerRed;  // one corner's C channels, a vector reduction

template <int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps) hash_anchored_bwd_kernel(
    const float* __restrict__ g,        // (P, L*C) upstream gradient
    const int* __restrict__ primes,     // (L, V, 3) uint32 bits
    const float* __restrict__ bias,     // (L, V, 3)
    const float* __restrict__ scales,   // (L,)
    const float* __restrict__ points,   // (P, 3)
    const int* __restrict__ anchors,    // (P,)
    float* __restrict__ grad,           // (L, local, C), zeroed
    unsigned long long* __restrict__ red_ops,  // (L,) or null
    long long n_points, int n_levels, int n_volumes, int local_size,
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

  const unsigned mask = (unsigned)(local_size - 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pair = warp; pair < map.slices * n_lev; pair += map.warps) {
    const int lg = pair % n_lev;  // level within the group
    const int l = l0 + lg;
    const int lp = (pair / n_lev) * 32 + lane;
    const int anchor = s_anc[lp];
    const bool valid = anchor >= 0;
    const int vol = min(anchor, n_volumes - 1);  // as locate_anchored clamps

    gfnerf::AnchoredCell cell = {};
    float pay[8][C];  // the 8 corners' payloads, (i, j, k) order
    if (valid) {
      cell = gfnerf::locate_anchored(primes, bias, scales, s_pts + lp * 3,
                                     anchor, l, n_volumes);
      float gv[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) gv[ch] = s_g[lp * gs + lg * C + ch];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float w = gfnerf::corner_weight(cell, o);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) pay[o][ch] = w * gv[ch];
      }
    } else {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) pay[o][ch] = 0.f;
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
      float* level = grad + (size_t)l * local_size * C;
#pragma unroll
      for (int o = 0; o < 8; ++o)
        CornerRed<C>::add(
            level + (size_t)gfnerf::corner_entry(cell, o, mask) * C, pay[o]);
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
           float* grad, unsigned long long* red_ops, int* launches,
           long long n_points, int n_levels, int n_volumes, int local_size,
           int group, cudaStream_t stream) {
  const gfnerf::TileMap map(n_levels, group > 0 ? group : kLevelGroup<C>,
                            kPasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (map.group * C + 1 + 3) +
      sizeof(int) * map.points;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hash_anchored_bwd_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return gfnerf::launch_level_groups(
      map, n_levels, grad, (size_t)local_size * C, stream, launches,
      [&](int l0, int n_lev) {
        hash_anchored_bwd_kernel<C><<<(unsigned)map.n_tiles, 32 * map.warps,
                                      smem, stream>>>(
            g, primes, bias, scales, points, anchors, grad, red_ops, n_points,
            n_levels, n_volumes, local_size, map, l0, n_lev);
      });
}

}  // namespace

// Supported channels C: 2 and 4; local_size a power of two.  Anything else
// returns cudaErrorInvalidValue without launching.  The gradient need not be
// zeroed by the caller.  red_ops: null, or (L,) uint64 counters on the
// device that the kernel adds the number of vector reductions it made per
// level to.  launches: a host int that gets the number of kernel launches
// made added to it (one per group of levels; each group also runs one
// cudaMemsetAsync).  levels_per_launch: 0 for the kernel's own choice
// (kLevelGroup), or the levels each launch covers, to time other groupings.
extern "C" int gfnerf_hash_anchored_bwd(
    const float* g, const int* primes, const float* bias, const float* scales,
    const float* points, const int* anchors, float* grad,
    unsigned long long* red_ops, int* launches, long long n_points,
    int n_levels, int n_volumes, int local_size, int n_channels,
    int levels_per_launch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (local_size <= 0 || (local_size & (local_size - 1)))
    return (int)cudaErrorInvalidValue;
  if (n_channels == 2)
    return launch<2>(g, primes, bias, scales, points, anchors, grad, red_ops,
                     launches, n_points, n_levels, n_volumes, local_size,
                     levels_per_launch, s);
  if (n_channels == 4)
    return launch<4>(g, primes, bias, scales, points, anchors, grad, red_ops,
                     launches, n_points, n_levels, n_volumes, local_size,
                     levels_per_launch, s);
  return (int)cudaErrorInvalidValue;
}
