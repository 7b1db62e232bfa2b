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
// C) f32 gradient (67 MB at 16 x 2^19 x 2); on top the L2 applies one
// read-modify-write per (point, level, corner), 201 M at the parity batch.
// Design, kept simple:
// - The packed hash's tiling (TileMap): a block stages its tile's points,
//   anchors and upstream gradient in shared memory with coalesced reads;
//   each warp takes 32 consecutive points at one level.
// - One vector reduction per corner: atomicAdd(float2*) at C = 2,
//   atomicAdd(float4*) at C = 4 (corner_vec.cuh).
// - One launch over all levels after one cudaMemsetAsync of the gradient.
// No warp aggregation of equal cells yet (H2 has it): the times stand in
// PERF.md as they are.

#include <cuda_runtime.h>

#include "corner_vec.cuh"
#include "hash_anchored_common.cuh"

namespace {

// (slice, level) pairs per warp: at 16 levels a tile of 32 points.
constexpr int kPasses = 2;

template <int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps) hash_anchored_bwd_kernel(
    const float* __restrict__ g,        // (P, L*C) upstream gradient
    const int* __restrict__ primes,     // (L, V, 3) uint32 bits
    const float* __restrict__ bias,     // (L, V, 3)
    const float* __restrict__ scales,   // (L,)
    const float* __restrict__ points,   // (P, 3)
    const int* __restrict__ anchors,    // (P,)
    float* __restrict__ grad,           // (L, local, C), zeroed
    long long n_points, int n_levels, int n_volumes, int local_size,
    gfnerf::TileMap map) {
  const gfnerf::BlockTile work(map, n_points);
  const int lc = n_levels * C;
  const int gs = lc + 1;  // odd stride: a warp's column reads hit 32 banks
  extern __shared__ float smem[];
  float* s_g = smem;                          // [points][gs]
  float* s_pts = s_g + map.points * gs;       // [points][3]
  int* s_anc = reinterpret_cast<int*>(s_pts + map.points * 3);

  gfnerf::stage_points(points, anchors, work.p0, work.n_tile, map.points,
                       s_pts, s_anc);
  gfnerf::load_rows(g + work.p0 * lc, s_g, work.n_tile, lc, lc, gs);
  __syncthreads();

  const unsigned mask = (unsigned)(local_size - 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pair = warp; pair < map.slices * n_levels; pair += map.warps) {
    const int l = pair % n_levels;
    const int lp = (pair / n_levels) * 32 + lane;
    const int anchor = s_anc[lp];
    if (anchor < 0) continue;
    const gfnerf::AnchoredCell cell = gfnerf::locate_anchored(
        primes, bias, scales, s_pts + lp * 3, anchor, l, n_volumes);
    float gv[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) gv[ch] = s_g[lp * gs + l * C + ch];
    float* level = grad + (size_t)l * local_size * C;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float w = gfnerf::corner_weight(cell, o);
      float pay[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) pay[ch] = w * gv[ch];
      gfnerf::CornerRed<C>::add(
          level + (size_t)gfnerf::corner_entry(cell, o, mask) * C, pay);
    }
  }
}

template <int C>
int launch(const float* g, const int* primes, const float* bias,
           const float* scales, const float* points, const int* anchors,
           float* grad, long long n_points, int n_levels, int n_volumes,
           int local_size, cudaStream_t stream) {
  const gfnerf::TileMap map(n_levels, n_levels, kPasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (n_levels * C + 1 + 3) +
      sizeof(int) * map.points;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hash_anchored_bwd_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaMemsetAsync(
      grad, 0, sizeof(float) * (size_t)n_levels * local_size * C, stream);
  if (err != cudaSuccess) return (int)err;
  if (map.n_tiles == 0) return (int)cudaSuccess;
  hash_anchored_bwd_kernel<C><<<(unsigned)map.n_tiles, 32 * map.warps, smem,
                                stream>>>(
      g, primes, bias, scales, points, anchors, grad, n_points, n_levels,
      n_volumes, local_size, map);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported channels C: 2 and 4; local_size a power of two.  Anything else
// returns cudaErrorInvalidValue without launching.  The gradient need not be
// zeroed by the caller.
extern "C" int gfnerf_hash_anchored_bwd(
    const float* g, const int* primes, const float* bias, const float* scales,
    const float* points, const int* anchors, float* grad, long long n_points,
    int n_levels, int n_volumes, int local_size, int n_channels,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (local_size <= 0 || (local_size & (local_size - 1)))
    return (int)cudaErrorInvalidValue;
  if (n_channels == 2)
    return launch<2>(g, primes, bias, scales, points, anchors, grad, n_points,
                     n_levels, n_volumes, local_size, s);
  if (n_channels == 4)
    return launch<4>(g, primes, bias, scales, points, anchors, grad, n_points,
                     n_levels, n_volumes, local_size, s);
  return (int)cudaErrorInvalidValue;
}
