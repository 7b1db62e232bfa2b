// Packed (supercell) anchored hash encode, forward (H1).
//
// Replaces gfnerf_tpu/fields/packed_hash.py:202 (packed_hash_encode_raw) and
// :262 (_interp_level), which the JAX package builds from XLA gathers; it is
// the same kernel class as the reference's Hash3DAnchored_cuda.cu. Per
// (point, level), with the addressing of packed_hash_common.cuh (supercell,
// local cell, fraction, hash or dense row):
//   out[p, level*C + c] = trilinear sum over the cell's 8 corners, read from
//         the row's [i][j][k][c] lattice at offsets (l + {0,1}) per axis.
// Output is (P, L*C) f32, multiplied by (anchor >= 0) as the JAX encode does.
//
// Bound: random 32-byte sector reads of the bf16 table (8 levels x 2^15 rows
// x 128 columns = 64 MB, against a 50 MB L2). Design: one thread per
// (point, level), threads of one point adjacent so the C output floats of a
// point's levels are written contiguously; each thread reads only the 8
// corners' C channels (C*2 bytes each, one vector load) instead of the whole
// 256-byte row. The corner sums follow _interp_level's z -> y -> x order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_hash_common.cuh"

namespace {

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

template <int E, int C>
__global__ void packed_hash_fwd_kernel(
    const __nv_bfloat16* __restrict__ table,  // (L, rows, W) bf16
    const int* __restrict__ primes,           // (L, V, 3) uint32 bits
    const float* __restrict__ bias,           // (L, V, 3)
    const float* __restrict__ scales,         // (L,)
    const int* __restrict__ dense_m,          // (L,) 0 = hashed level
    const float* __restrict__ points,         // (P, 3)
    const int* __restrict__ anchors,          // (P,)
    float* __restrict__ out,                  // (P, L*C)
    long long n_points, int n_levels, int n_volumes, int n_rows, int width) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points * n_levels) return;
  const long long p = t / n_levels;
  const int l = (int)(t - p * n_levels);

  const gfnerf::HashCell cell = gfnerf::locate<E - 1>(
      primes, bias, scales, dense_m, points, anchors, p, l, n_volumes,
      n_rows);
  const float valid = cell.valid ? 1.f : 0.f;
  const float* frac = cell.frac;
  const unsigned row = cell.row;
  const __nv_bfloat16* rp = table + ((size_t)l * n_rows + row) * width;

  float res[C];
  if (E == 2) {
    // the 8 lattice entries are the 8 corners: _interp_level's lerp chain
    float c[8][C];
#pragma unroll
    for (int o = 0; o < 8; ++o) Corner<C>::load(rp + o * C, c[o]);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float z00 = c[0][ch] + frac[2] * (c[1][ch] - c[0][ch]);
      const float z01 = c[2][ch] + frac[2] * (c[3][ch] - c[2][ch]);
      const float z10 = c[4][ch] + frac[2] * (c[5][ch] - c[4][ch]);
      const float z11 = c[6][ch] + frac[2] * (c[7][ch] - c[6][ch]);
      const float y0 = z00 + frac[1] * (z01 - z00);
      const float y1 = z10 + frac[1] * (z11 - z10);
      res[ch] = y0 + frac[0] * (y1 - y0);
    }
  } else {
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
    for (int ch = 0; ch < C; ++ch) res[ch] = 0.f;
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
          const float acc_z = wz[0] * c0[ch] + wz[1] * c1[ch];
          acc_y[ch] = j == 0 ? wy[0] * acc_z : acc_y[ch] + wy[1] * acc_z;
        }
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        res[ch] = i == 0 ? wx[0] * acc_y[ch] : res[ch] + wx[1] * acc_y[ch];
    }
  }
  float* op = out + p * (long long)(n_levels * C) + l * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) op[ch] = res[ch] * valid;
}

template <int E, int C>
int launch(const void* table, const int* primes, const float* bias,
           const float* scales, const int* dense_m, const float* points,
           const int* anchors, float* out, long long n_points, int n_levels,
           int n_volumes, int n_rows, int width, cudaStream_t stream) {
  const int threads = 256;
  const long long n = n_points * n_levels;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    packed_hash_fwd_kernel<E, C><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(table), primes, bias, scales,
        dense_m, points, anchors, out, n_points, n_levels, n_volumes, n_rows,
        width);
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
