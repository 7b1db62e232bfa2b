// Anchored multi-resolution hash encode, forward (H4).
//
// Replaces gfnerf_tpu/fields/hash_encoding.py:188 (_hash_encode_fwd) in the
// form hash_encode_sorted (:364) runs it: the table read through a bf16 copy
// (packed_table, :224-232).  The JAX package builds it from 8 XLA gathers a
// level; it is the reference's Hash3DAnchored_cuda.cu forward.  Per (point,
// level), with the addressing of hash_anchored_common.cuh:
//   out[p, level*C + c] = sum over the 8 corners, x outermost and z
//         innermost, of weight * table[level, entry, c]
// Output (P, L*C) f32, exactly 0 where the anchor is < 0.
//
// Bound: bytes. Each (point, level) reads 8 corners of C bf16 values (4
// bytes at C = 2, 8 at C = 4) from a table of L x local x C (33.5 MB in bf16
// at 16 x 2^19 x 2, inside the 50 MB L2) and writes C floats; compulsory
// traffic is the points, anchors, output and one read of the table.
// Design, kept simple:
// - The packed hash's tiling (TileMap): a block stages a tile of
//   consecutive points and their anchors in shared memory, each warp takes
//   32 of them at ONE level, so a load instruction reads one level's table
//   and consecutive samples of a ray, which share cells on the coarse
//   levels, read the same sectors.
// - One vector load per corner; masked points read nothing and write zeros.
// - The tile's (points x L*C) output is staged in shared memory and stored
//   with coalesced 16-byte evict-first stores.
// Each multiply and add is rounded on its own (__fmul_rn, __fadd_rn), in
// the plain version's order, so the output equals the plain version's bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corner_vec.cuh"
#include "hash_anchored_common.cuh"

namespace {

// (slice, level) pairs per warp: at 16 levels a tile of 64 points.
constexpr int kPasses = 4;

template <int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps) hash_anchored_fwd_kernel(
    const __nv_bfloat16* __restrict__ table,  // (L, local, C) bf16
    const int* __restrict__ primes,           // (L, V, 3) uint32 bits
    const float* __restrict__ bias,           // (L, V, 3)
    const float* __restrict__ scales,         // (L,)
    const float* __restrict__ points,         // (P, 3)
    const int* __restrict__ anchors,          // (P,)
    float* __restrict__ out,                  // (P, L*C)
    long long n_points, int n_levels, int n_volumes, int local_size,
    gfnerf::TileMap map) {
  const gfnerf::BlockTile work(map, n_points);
  const int lc = n_levels * C;
  const int os = lc + 1;  // odd stride: a warp's column stores hit 32 banks
  extern __shared__ float smem[];
  float* s_out = smem;                        // [points][os]
  float* s_pts = s_out + map.points * os;     // [points][3]
  int* s_anc = reinterpret_cast<int*>(s_pts + map.points * 3);

  gfnerf::stage_points(points, anchors, work.p0, work.n_tile, map.points,
                       s_pts, s_anc);
  __syncthreads();

  const unsigned mask = (unsigned)(local_size - 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pair = warp; pair < map.slices * n_levels; pair += map.warps) {
    const int l = pair % n_levels;
    const int lp = (pair / n_levels) * 32 + lane;
    const int anchor = s_anc[lp];
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
    if (anchor >= 0) {
      const gfnerf::AnchoredCell cell = gfnerf::locate_anchored(
          primes, bias, scales, s_pts + lp * 3, anchor, l, n_volumes);
      const __nv_bfloat16* level = table + (size_t)l * local_size * C;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        float v[C];
        gfnerf::Corner<C>::load(
            level + (size_t)gfnerf::corner_entry(cell, o, mask) * C, v);
        const float w = gfnerf::corner_weight(cell, o);
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          acc[ch] = __fadd_rn(acc[ch], __fmul_rn(w, v[ch]));
      }
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) s_out[lp * os + l * C + ch] = acc[ch];
  }
  __syncthreads();

  gfnerf::store_rows(out + work.p0 * lc, s_out, work.n_tile, lc, lc, os);
}

template <int C>
int launch(const void* table, const int* primes, const float* bias,
           const float* scales, const float* points, const int* anchors,
           float* out, long long n_points, int n_levels, int n_volumes,
           int local_size, cudaStream_t stream) {
  const gfnerf::TileMap map(n_levels, n_levels, kPasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (n_levels * C + 1 + 3) +
      sizeof(int) * map.points;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hash_anchored_fwd_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (map.n_tiles == 0) return (int)cudaSuccess;
  hash_anchored_fwd_kernel<C><<<(unsigned)map.n_tiles, 32 * map.warps, smem,
                                stream>>>(
      static_cast<const __nv_bfloat16*>(table), primes, bias, scales, points,
      anchors, out, n_points, n_levels, n_volumes, local_size, map);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported channels C: 2 and 4; local_size a power of two.  Anything else
// returns cudaErrorInvalidValue without launching.
extern "C" int gfnerf_hash_anchored_fwd(
    const void* table, const int* primes, const float* bias,
    const float* scales, const float* points, const int* anchors, float* out,
    long long n_points, int n_levels, int n_volumes, int local_size,
    int n_channels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (local_size <= 0 || (local_size & (local_size - 1)))
    return (int)cudaErrorInvalidValue;
  if (n_channels == 2)
    return launch<2>(table, primes, bias, scales, points, anchors, out,
                     n_points, n_levels, n_volumes, local_size, s);
  if (n_channels == 4)
    return launch<4>(table, primes, bias, scales, points, anchors, out,
                     n_points, n_levels, n_volumes, local_size, s);
  return (int)cudaErrorInvalidValue;
}
