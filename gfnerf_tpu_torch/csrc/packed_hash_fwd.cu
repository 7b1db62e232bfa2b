// Packed (supercell) anchored hash encode, forward (H1).
//
// Replaces gfnerf_tpu/fields/packed_hash.py:202 (packed_hash_encode_raw) and
// :262 (_interp_level), which the JAX package builds from XLA gathers; it is
// the same kernel class as the reference's Hash3DAnchored_cuda.cu. Per
// (point, level), with the addressing of packed_hash_common.cuh (supercell,
// local cell, fraction, hash or dense row):
//   out[p, level*C + c] = trilinear sum over the cell's 8 corners, read from
//         the row's [i][j][k][c] lattice at offsets (l + {0,1}) per axis.
// Output is (P, L*C) f32, exactly 0 where the anchor is < 0, as the JAX
// encode's multiply by (anchor >= 0) gives.
//
// Bound: random 32-byte sector reads of the bf16 table (8 levels x 2^15 rows
// x 128 columns = 64 MB, against a 50 MB L2), and the (P, L*C) f32 output.
// Design:
// - Level-major warps over consecutive samples (TileMap, shared with H2): a
//   block stages its tile's points and anchors in shared memory; each warp
//   takes 32 consecutive points at ONE level, so a load instruction reads
//   one level's table, and lanes of a run in the same cell read the same
//   sectors (one request instead of up to 32 rows of 8 tables).
// - A tile of 128 points at all 8 levels (kPasses pairs per warp): the
//   block's fixed costs, the staging round trip and the two barriers, are
//   spread over four times the work of one 32-point slice.
// - Each lane reads only its 8 corners' C channels (C*2 bytes each, one
//   vector load), not the whole 256-byte row.
// - Masked points (anchor < 0) issue no table read and no arithmetic, and
//   write exact zeros.
// - The tile's (points x L*C) f32 output is staged in shared memory and
//   written back with coalesced 16-byte stores (a warp per level would
//   otherwise store C floats at a stride of L*C), evict-first like the
//   points' loads, so the L2 keeps the table.
// The corner sums follow _interp_level's z -> y -> x order, each multiply
// and add rounded on its own (__fmul_rn, __fadd_rn: no multiply-add
// contraction), as the plain version's separate PyTorch operations round
// them. The skipped lattice entries have weight exactly 0 there and add
// exact zeros, so the output equals the plain version's bit for bit, and
// the MLPs downstream see the same bf16 inputs on either path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_hash_common.cuh"

namespace {

// (slice, level) pairs per warp: a tile of 128 points at 8 levels, all
// levels in one launch (TileMap).  One launch per level would keep a
// level's 8 MB table in the L2, but repeats the per-point work (staging,
// barriers, write-back) at every launch: chip_smoke.py times each level
// alone against the whole kernel.
constexpr int kPasses = 4;

template <int C>
struct Corner;  // C bf16 values, loaded with one vector access

template <>
struct Corner<2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __bfloat162float(x.x);
    v[1] = __bfloat162float(x.y);
  }
};

template <>
struct Corner<4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    v[0] = __bfloat162float(h[0].x);
    v[1] = __bfloat162float(h[0].y);
    v[2] = __bfloat162float(h[1].x);
    v[3] = __bfloat162float(h[1].y);
  }
};

template <>
struct Corner<8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __bfloat162float(h[q].x);
      v[2 * q + 1] = __bfloat162float(h[q].y);
    }
  }
};

// a + t * (b - a), each operation rounded on its own as in _interp_level
// (no multiply-add contraction)
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}

// The interpolated C channels of one valid (point, level).
template <int E, int C>
__device__ __forceinline__ void interpolate(const gfnerf::HashCell& cell,
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
      const float z00 = lerp(c[0][ch], c[1][ch], frac[2]);
      const float z01 = lerp(c[2][ch], c[3][ch], frac[2]);
      const float z10 = lerp(c[4][ch], c[5][ch], frac[2]);
      const float z11 = lerp(c[6][ch], c[7][ch], frac[2]);
      res[ch] = lerp(lerp(z00, z01, frac[1]), lerp(z10, z11, frac[1]),
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
  gfnerf::axis_factors<E>(cell, wt, q, inside);
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

template <int E, int C>
__global__ void __launch_bounds__(32 * gfnerf::kWarps) packed_hash_fwd_kernel(
    const __nv_bfloat16* __restrict__ table,  // (L, rows, W) bf16
    const int* __restrict__ primes,           // (L, V, 3) uint32 bits
    const float* __restrict__ bias,           // (L, V, 3)
    const float* __restrict__ scales,         // (L,)
    const int* __restrict__ dense_m,          // (L,) 0 = hashed level
    const float* __restrict__ points,         // (P, 3)
    const int* __restrict__ anchors,          // (P,)
    float* __restrict__ out,                  // (P, L*C)
    long long n_points, int n_levels, int n_volumes, int n_rows, int width,
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

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pair = warp; pair < map.slices * n_levels; pair += map.warps) {
    const int l = pair % n_levels;
    const int lp = (pair / n_levels) * 32 + lane;
    const int anchor = s_anc[lp];
    float res[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) res[ch] = 0.f;
    if (anchor >= 0) {
      const gfnerf::HashCell cell = gfnerf::locate<E - 1>(
          primes, bias, scales, dense_m, s_pts + lp * 3, anchor, l, n_volumes,
          n_rows);
      interpolate<E, C>(cell,
                        table + ((size_t)l * n_rows + cell.row) * width, res);
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) s_out[lp * os + l * C + ch] = res[ch];
  }
  __syncthreads();

  // the tile's rows are contiguous: adjacent threads store them
  gfnerf::store_rows(out + work.p0 * lc, s_out, work.n_tile, lc, lc, os);
}

template <int E, int C>
int launch(const void* table, const int* primes, const float* bias,
           const float* scales, const int* dense_m, const float* points,
           const int* anchors, float* out, long long n_points, int n_levels,
           int n_volumes, int n_rows, int width, cudaStream_t stream) {
  const gfnerf::TileMap map(n_levels, n_levels, kPasses, n_points);
  const size_t smem =
      sizeof(float) * map.points * (n_levels * C + 1 + 3) +
      sizeof(int) * map.points;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_hash_fwd_kernel<E, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (map.n_tiles == 0) return (int)cudaSuccess;
  packed_hash_fwd_kernel<E, C><<<(unsigned)map.n_tiles, 32 * map.warps, smem,
                                 stream>>>(
      static_cast<const __nv_bfloat16*>(table), primes, bias, scales, dense_m,
      points, anchors, out, n_points, n_levels, n_volumes, n_rows, width, map);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported (lattice edge E, channels C): (2, 8), (3, 4), (4, 2) — the
// supercells pack_for_channels picks at row width 128. Anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int gfnerf_packed_hash_fwd(
    const void* table, const int* primes, const float* bias,
    const float* scales, const int* dense_m, const float* points,
    const int* anchors, float* out, long long n_points, int n_levels,
    int n_volumes, int n_rows, int width, int n_channels, int lattice_edge,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lattice_edge == 2 && n_channels == 8)
    return launch<2, 8>(table, primes, bias, scales, dense_m, points, anchors,
                        out, n_points, n_levels, n_volumes, n_rows, width, s);
  if (lattice_edge == 3 && n_channels == 4)
    return launch<3, 4>(table, primes, bias, scales, dense_m, points, anchors,
                        out, n_points, n_levels, n_volumes, n_rows, width, s);
  if (lattice_edge == 4 && n_channels == 2)
    return launch<4, 2>(table, primes, bias, scales, dense_m, points, anchors,
                        out, n_points, n_levels, n_volumes, n_rows, width, s);
  return (int)cudaErrorInvalidValue;
}
