// The packed (supercell) hash encode's kernel, shared by the forward of one
// table (H1, packed_hash_fwd.cu) and the block-routed forward over stacked
// tables (H3, packed_hash_routed.cu): the interpolation of one (point,
// level), the tiled kernel, and its launcher.  ROUTED selects at compile
// time whether each point carries a block that picks its table, primes and
// biases; with ROUTED false the block pointer is never read and the code is
// H1's alone.
//
// Either form takes an optional base (P, L*C) f32, the encode of another
// table that this one is a residual of: the write-back then reads the
// tile's rows of the base with the same coalesced 16-byte accesses it
// stores with and writes base + result, each result rounded to f32 before
// the one add, so the output equals the separate sum of the two encodes bit
// for bit.  That spares the sum's own pass (two (P, L*C) reads and one
// write) and, with the output written over the base, its buffer.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corner_vec.cuh"
#include "packed_hash_common.cuh"

namespace gfnerf {

// (slice, level) pairs per warp: a tile of 128 points at 8 levels, all
// levels in one launch (TileMap).  One launch per level would keep a
// level's 8 MB table in the L2, but repeats the per-point work (staging,
// barriers, write-back) at every launch: chip_smoke.py times each level
// alone against the whole kernel.
constexpr int kEncodePasses = 4;

// a + t * (b - a), each operation rounded on its own as in _interp_level
// (no multiply-add contraction)
__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}

// The interpolated C channels of one valid (point, level).
template <int E, int C>
__device__ __forceinline__ void interpolate(const HashCell& cell,
                                            const __nv_bfloat16* rp,
                                            float* res) {
  const float* frac = cell.frac;
  if (E == 2) {
    // the 8 lattice entries are the 8 corners: _interp_level's lerp chain
    float c[8][C];
#pragma unroll
    for (int o = 0; o < 8; ++o) Corner<C>::load(rp + o * C, c[o]);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float z00 = lerp_rn(c[0][ch], c[1][ch], frac[2]);
      const float z01 = lerp_rn(c[2][ch], c[3][ch], frac[2]);
      const float z10 = lerp_rn(c[4][ch], c[5][ch], frac[2]);
      const float z11 = lerp_rn(c[6][ch], c[7][ch], frac[2]);
      res[ch] = lerp_rn(lerp_rn(z00, z01, frac[1]), lerp_rn(z10, z11, frac[1]),
                     frac[0]);
    }
    return;
  }
  // per-axis weights (1-f) at lattice position l and f at l+1; the other
  // entries of _interp_level's factorized sum have weight 0 and add exact
  // zeros.
  float wt[3][2];
  int q[3][2];
  bool inside[3][2];
  axis_factors<E>(cell, wt, q, inside);
  const float* wx = wt[0];
  const float* wy = wt[1];
  const float* wz = wt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float acc_y[C];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = (q[0][i] * E + q[1][j]) * E;
      float c0[C], c1[C];
      Corner<C>::load(rp + (o + q[2][0]) * C, c0);
      Corner<C>::load(rp + (o + q[2][1]) * C, c1);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float acc_z =
            __fadd_rn(__fmul_rn(wz[0], c0[ch]), __fmul_rn(wz[1], c1[ch]));
        acc_y[ch] = j == 0 ? __fmul_rn(wy[0], acc_z)
                           : __fadd_rn(acc_y[ch], __fmul_rn(wy[1], acc_z));
      }
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      res[ch] = i == 0 ? __fmul_rn(wx[0], acc_y[ch])
                       : __fadd_rn(res[ch], __fmul_rn(wx[1], acc_y[ch]));
  }
}

// ROUTED: table (B, L, rows, W), primes and bias (B, L, V, 3), blocks (P,);
// a point with block < 0 is masked like one with anchor < 0, and a block
// past the last is clipped to it (packed_hash.py:362-364).
template <int E, int C, bool ROUTED>
__global__ void __launch_bounds__(32 * kWarps) packed_hash_encode_kernel(
    const __nv_bfloat16* __restrict__ table,  // ([B,] L, rows, W) bf16
    const int* __restrict__ primes,           // ([B,] L, V, 3) uint32 bits
    const float* __restrict__ bias,           // ([B,] L, V, 3)
    const float* __restrict__ scales,         // (L,)
    const int* __restrict__ dense_m,          // (L,) 0 = hashed level
    const float* __restrict__ points,         // (P, 3)
    const int* __restrict__ anchors,          // (P,)
    const int* __restrict__ blocks,           // (P,), ROUTED only
    const float* base,                        // (P, L*C) or null; may be out
    float* out,                               // (P, L*C)
    long long n_points, int n_blocks, int n_levels, int n_volumes, int n_rows,
    int width, TileMap map) {
  const BlockTile work(map, n_points);
  const int lc = n_levels * C;
  const int os = lc + 1;  // odd stride: a warp's column stores hit 32 banks
  extern __shared__ float smem[];
  float* s_out = smem;                        // [points][os]
  float* s_pts = s_out + map.points * os;     // [points][3]
  int* s_anc = reinterpret_cast<int*>(s_pts + map.points * 3);
  int* s_blk = s_anc + map.points;            // [points], ROUTED only

  stage_points(points, anchors, work.p0, work.n_tile, map.points, s_pts,
               s_anc);
  if (ROUTED) {
    for (int i = threadIdx.x; i < map.points; i += blockDim.x)
      s_blk[i] = i < work.n_tile ? __ldcs(blocks + work.p0 + i) : -1;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pair = warp; pair < map.slices * n_levels; pair += map.warps) {
    const int l = pair % n_levels;
    const int lp = (pair / n_levels) * 32 + lane;
    const int anchor = s_anc[lp];
    const int block = ROUTED ? s_blk[lp] : 0;
    float res[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) res[ch] = 0.f;
    if (anchor >= 0 && block >= 0) {
      // the block's own hash state and tables
      const size_t b = ROUTED ? (size_t)min(block, n_blocks - 1) : 0;
      const size_t hash_off = b * n_levels * n_volumes * 3;
      const HashCell cell = locate<E - 1>(
          primes + hash_off, bias + hash_off, scales, dense_m, s_pts + lp * 3,
          anchor, l, n_volumes, n_rows);
      interpolate<E, C>(
          cell, table + ((b * n_levels + l) * n_rows + cell.row) * width,
          res);
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) s_out[lp * os + l * C + ch] = res[ch];
  }
  __syncthreads();

  // the tile's rows are contiguous: adjacent threads store them, added to
  // the base's where there is one
  if (base != nullptr)
    store_rows_added(out + work.p0 * lc, base + work.p0 * lc, s_out,
                     work.n_tile, lc, lc, os);
  else
    store_rows(out + work.p0 * lc, s_out, work.n_tile, lc, lc, os);
}

template <int E, int C, bool ROUTED>
int launch_encode(const void* table, const int* primes, const float* bias,
                  const float* scales, const int* dense_m,
                  const float* points, const int* anchors, const int* blocks,
                  const float* base, float* out, long long n_points,
                  int n_blocks, int n_levels, int n_volumes, int n_rows,
                  int width, cudaStream_t stream) {
  const TileMap map(n_levels, n_levels, kEncodePasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (n_levels * C + 1 + 3) +
      sizeof(int) * map.points * (ROUTED ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_hash_encode_kernel<E, C, ROUTED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (map.n_tiles == 0) return (int)cudaSuccess;
  packed_hash_encode_kernel<E, C, ROUTED>
      <<<(unsigned)map.n_tiles, 32 * map.warps, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(table), primes, bias, scales,
          dense_m, points, anchors, blocks, base, out, n_points, n_blocks,
          n_levels, n_volumes, n_rows, width, map);
  return (int)cudaGetLastError();
}

// Supported (lattice edge E, channels C): (2, 8), (3, 4), (4, 2) — the
// supercells pack_for_channels picks at row width 128. Anything else returns
// cudaErrorInvalidValue without launching.
template <bool ROUTED>
int dispatch_encode(const void* table, const int* primes, const float* bias,
                    const float* scales, const int* dense_m,
                    const float* points, const int* anchors,
                    const int* blocks, const float* base, float* out,
                    long long n_points, int n_blocks, int n_levels,
                    int n_volumes, int n_rows, int width, int n_channels,
                    int lattice_edge, cudaStream_t s) {
  if (lattice_edge == 2 && n_channels == 8)
    return launch_encode<2, 8, ROUTED>(
        table, primes, bias, scales, dense_m, points, anchors, blocks, base,
        out, n_points, n_blocks, n_levels, n_volumes, n_rows, width, s);
  if (lattice_edge == 3 && n_channels == 4)
    return launch_encode<3, 4, ROUTED>(
        table, primes, bias, scales, dense_m, points, anchors, blocks, base,
        out, n_points, n_blocks, n_levels, n_volumes, n_rows, width, s);
  if (lattice_edge == 4 && n_channels == 2)
    return launch_encode<4, 2, ROUTED>(
        table, primes, bias, scales, dense_m, points, anchors, blocks, base,
        out, n_points, n_blocks, n_levels, n_volumes, n_rows, width, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gfnerf
