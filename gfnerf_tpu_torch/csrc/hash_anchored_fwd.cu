// Anchored multi-resolution hash encode, forward (H4).
//
// Replaces gfnerf_tpu/fields/hash_encoding.py:188 (_hash_encode_fwd) in the
// form hash_encode_sorted (:364) runs it: the table read through a bf16 copy
// (packed_table, :224-232).  The JAX package builds it from 8 XLA gathers a
// level; it is the reference's Hash3DAnchored_cuda.cu forward.  Per (point,
// level), with the addressing of hash_anchored_common.cuh:
//   out[p, level*C + c] = sum over the 8 corners, x outermost and z
//         innermost, of weight * bf16(table[level, entry, c])
// Output (P, L*C) f32, exactly 0 where the anchor is < 0; with a base
// (P, L*C) f32, base + that (the focal stage's residual sum).
//
// Bound: bytes, through the L2. Compulsory traffic is the points, anchors,
// output (and base) and one read of the table (67 MB in f32 at 16 x 2^19 x
// 2); on top, each (point, level) reads 8 corners at scattered entries, one
// 32-byte sector each (8 bytes a corner at C = 2 in f32, 4 in bf16: the same
// sector count), which the L2 serves if it holds the level's table.
// Design:
// - The packed hash's tiling (TileMap): a block stages a tile of
//   consecutive points and their anchors in shared memory, each warp takes
//   32 of them at ONE level, so a load instruction reads one level's table
//   and consecutive samples of a ray, which share cells on the coarse
//   levels, read the same sectors (one request for the run).
// - One launch per group of levels (kLevelGroup, or levels_per_launch): a
//   launch's working set is its group's slice
//   of the table (16 MB at 4 levels of 2^19 x 2 f32), which the 50 MB L2
//   holds while the launch runs, where all 16 levels (67 MB) would not.
//   chip_smoke.py times 1, 2, 4, 8 and 16 levels per launch.
// - The f32 table read directly, each corner rounded to bf16 in registers
//   (corner_vec.cuh): the values of the bf16 copy the reference reads, with
//   no copy (a launch and 100 MB of traffic per call) and, at the focal
//   stage, no copy of the frozen global table at every step.  A bf16 table
//   is read as it is.
// - One vector load per corner; masked points read nothing and write zeros.
// - The tile's (points x group*C) output is staged in shared memory and
//   stored into the group's columns with coalesced 16-byte evict-first
//   stores; with a base, the write-back reads the same columns of the base
//   and stores base + result (store_rows_added: one rounded add, as the
//   separate sum rounds it), over the base when out is base.
// Each multiply and add is rounded on its own (__fmul_rn, __fadd_rn), in
// the plain version's order, so the output equals the plain version's bit
// for bit, with or without a base.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corner_vec.cuh"
#include "hash_anchored_common.cuh"

namespace {

// Levels per launch unless the caller sets them (chip_smoke.py's sweep).
constexpr int kLevelGroup = 4;
// (slice, level) pairs per warp: at 4 levels a tile of 256 points.
constexpr int kPasses = 4;

template <typename T, int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps) hash_anchored_fwd_kernel(
    const T* __restrict__ table,        // (L, local, C) f32 or bf16
    const int* __restrict__ primes,     // (L, V, 3) uint32 bits
    const float* __restrict__ bias,     // (L, V, 3)
    const float* __restrict__ scales,   // (L,)
    const float* __restrict__ points,   // (P, 3)
    const int* __restrict__ anchors,    // (P,)
    const float* base,                  // (P, L*C) or null; may be out
    float* out,                         // (P, L*C)
    long long n_points, int n_levels, int n_volumes, int local_size,
    gfnerf::TileMap map, int l0, int n_lev) {  // this launch: [l0, l0 + n_lev)
  const gfnerf::BlockTile work(map, n_points);
  const int lc = n_levels * C;
  const int gc = n_lev * C;  // the launch's columns of the output
  const int os = gc + 1;     // odd stride: a warp's column stores hit 32 banks
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
  for (int pair = warp; pair < map.slices * n_lev; pair += map.warps) {
    const int lg = pair % n_lev;  // level within the group
    const int l = l0 + lg;
    const int lp = (pair / n_lev) * 32 + lane;
    const int anchor = s_anc[lp];
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
    if (anchor >= 0) {
      const gfnerf::AnchoredCell cell = gfnerf::locate_anchored(
          primes, bias, scales, s_pts + lp * 3, anchor, l, n_volumes);
      const T* level = table + (size_t)l * local_size * C;
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
    for (int ch = 0; ch < C; ++ch) s_out[lp * os + lg * C + ch] = acc[ch];
  }
  __syncthreads();

  // the tile's rows of the group's columns, added to the base's where there
  // is one
  const long long at = work.p0 * lc + l0 * C;
  if (base != nullptr)
    gfnerf::store_rows_added(out + at, base + at, s_out, work.n_tile, gc, lc,
                             os);
  else
    gfnerf::store_rows(out + at, s_out, work.n_tile, gc, lc, os);
}

template <typename T, int C>
int launch(const void* table, const int* primes, const float* bias,
           const float* scales, const float* points, const int* anchors,
           const float* base, float* out, int* launches, long long n_points,
           int n_levels, int n_volumes, int local_size, int group,
           cudaStream_t stream) {
  const gfnerf::TileMap map(n_levels, group > 0 ? group : kLevelGroup,
                            kPasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (map.group * C + 1 + 3) +
      sizeof(int) * map.points;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hash_anchored_fwd_kernel<T, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return gfnerf::launch_level_groups(
      map, n_levels, launches, [&](int l0, int n_lev) {
        hash_anchored_fwd_kernel<T, C><<<(unsigned)map.n_tiles,
                                         32 * map.warps, smem, stream>>>(
            static_cast<const T*>(table), primes, bias, scales, points,
            anchors, base, out, n_points, n_levels, n_volumes, local_size,
            map, l0, n_lev);
      });
}

template <typename T>
int dispatch(const void* table, const int* primes, const float* bias,
             const float* scales, const float* points, const int* anchors,
             const float* base, float* out, int* launches, long long n_points,
             int n_levels, int n_volumes, int local_size, int n_channels,
             int group, cudaStream_t stream) {
  if (n_channels == 2)
    return launch<T, 2>(table, primes, bias, scales, points, anchors, base,
                        out, launches, n_points, n_levels, n_volumes,
                        local_size, group, stream);
  if (n_channels == 4)
    return launch<T, 4>(table, primes, bias, scales, points, anchors, base,
                        out, launches, n_points, n_levels, n_volumes,
                        local_size, group, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// table: (L, local, C) f32 (table_bf16 = 0, each value rounded to bf16 as
// it is read) or bf16 (table_bf16 = 1).  base: null, or (P, L*C) f32 that
// the output is added to (out = base + encode; out may be base).  launches:
// a host int that gets the number of kernel launches made added to it (one
// per group of levels).  levels_per_launch: 0 for the kernel's own choice
// (kLevelGroup), or the levels each launch covers.  Supported channels C: 2
// and 4; local_size a power of two.  Anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int gfnerf_hash_anchored_fwd(
    const void* table, int table_bf16, const int* primes, const float* bias,
    const float* scales, const float* points, const int* anchors,
    const float* base, float* out, int* launches, long long n_points,
    int n_levels, int n_volumes, int local_size, int n_channels,
    int levels_per_launch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (local_size <= 0 || (local_size & (local_size - 1)))
    return (int)cudaErrorInvalidValue;
  if (table_bf16)
    return dispatch<__nv_bfloat16>(
        table, primes, bias, scales, points, anchors, base, out, launches,
        n_points, n_levels, n_volumes, local_size, n_channels,
        levels_per_launch, s);
  return dispatch<float>(table, primes, bias, scales, points, anchors, base,
                         out, launches, n_points, n_levels, n_volumes,
                         local_size, n_channels, levels_per_launch, s);
}
