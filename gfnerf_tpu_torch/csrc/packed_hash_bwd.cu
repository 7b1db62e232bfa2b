// Packed (supercell) anchored hash encode, table gradient (H2).
//
// Replaces gfnerf_tpu/fields/packed_hash.py:490 (_phe_bwd, the custom VJP of
// packed_hash_encode), which builds the dense table gradient on the TPU from
// an XLA sort, an MXU prefix sum and a run-end difference because the TPU
// has no scatter atomics. Here it is the reference's own design
// (Hash3DAnchored_cuda.cu:46-79): a scatter with float atomics. Per
// (point, level), with the addressing of packed_hash_common.cuh that the
// forward (H1) uses:
//   grad[level, row, o*C + c] += w_o * g[p, level*C + c]
// over the cell's 8 corners o = (l + {0,1}) per axis of the row's lattice,
// with w_o the trilinear weight (wx * wy) * wz as _lattice_weights forms it.
// The other lattice entries have weight exactly 0 there and are skipped;
// columns past lattice*C are never written. Points with anchor < 0 add
// nothing. The gradient is f32 (the TPU path rounds its payload to bf16).
//
// Bound: the atomics. Compulsory traffic is the upstream gradient (P, L*C)
// f32, the points and anchors, and the zero-fill of the (L, rows, W) f32
// gradient (128 MB at 8 x 2^15 x 128, larger than the 50 MB L2): about
// 0.58 GB at P = 3.15 M, 0.17 ms at 3.35 TB/s. On top come P * L * 8 * C
// f32 atomic adds (0.8 G at that P) into random rows. Design: one thread
// per (point, level), the threads of one point adjacent so the upstream
// gradient is read coalesced; the zero-fill is a cudaMemsetAsync on the
// same stream before the launch.

#include <cuda_runtime.h>

#include "packed_hash_common.cuh"

namespace {

template <int E, int C>
__global__ void packed_hash_bwd_kernel(
    const float* __restrict__ g,        // (P, L*C) upstream gradient
    const int* __restrict__ primes,     // (L, V, 3) uint32 bits
    const float* __restrict__ bias,     // (L, V, 3)
    const float* __restrict__ scales,   // (L,)
    const int* __restrict__ dense_m,    // (L,) 0 = hashed level
    const float* __restrict__ points,   // (P, 3)
    const int* __restrict__ anchors,    // (P,)
    float* __restrict__ grad,           // (L, rows, W), zeroed
    long long n_points, int n_levels, int n_volumes, int n_rows, int width) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points * n_levels) return;
  const long long p = t / n_levels;
  const int l = (int)(t - p * n_levels);

  const gfnerf::HashCell cell = gfnerf::locate<E - 1>(
      primes, bias, scales, dense_m, points, anchors, p, l, n_volumes,
      n_rows);
  if (!cell.valid) return;
  float gv[C];
  const float* gp = g + p * (long long)(n_levels * C) + l * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) gv[ch] = gp[ch];

  float wt[3][2];
  int q[3][2];
  bool inside[3][2];
  gfnerf::axis_factors<E>(cell, wt, q, inside);
  float* rp = grad + ((size_t)l * n_rows + cell.row) * width;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!(inside[0][i] && inside[1][j] && inside[2][k])) continue;
        const float w = wt[0][i] * wt[1][j] * wt[2][k];
        const int o = (q[0][i] * E + q[1][j]) * E + q[2][k];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) atomicAdd(rp + o * C + ch, w * gv[ch]);
      }
    }
  }
}

template <int E, int C>
int launch(const float* g, const int* primes, const float* bias,
           const float* scales, const int* dense_m, const float* points,
           const int* anchors, float* grad, long long n_points, int n_levels,
           int n_volumes, int n_rows, int width, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      grad, 0, sizeof(float) * (size_t)n_levels * n_rows * width, stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long n = n_points * n_levels;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    packed_hash_bwd_kernel<E, C><<<(unsigned)blocks, threads, 0, stream>>>(
        g, primes, bias, scales, dense_m, points, anchors, grad, n_points,
        n_levels, n_volumes, n_rows, width);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported (lattice edge E, channels C): (2, 8), (3, 4), (4, 2), as for the
// forward. Anything else returns cudaErrorInvalidValue without launching.
extern "C" int gfnerf_packed_hash_bwd(
    const float* g, const int* primes, const float* bias, const float* scales,
    const int* dense_m, const float* points, const int* anchors, float* grad,
    long long n_points, int n_levels, int n_volumes, int n_rows, int width,
    int n_channels, int lattice_edge, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lattice_edge == 2 && n_channels == 8)
    return launch<2, 8>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, n_points, n_levels, n_volumes, n_rows, width, s);
  if (lattice_edge == 3 && n_channels == 4)
    return launch<3, 4>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, n_points, n_levels, n_volumes, n_rows, width, s);
  if (lattice_edge == 4 && n_channels == 2)
    return launch<4, 2>(g, primes, bias, scales, dense_m, points, anchors,
                        grad, n_points, n_levels, n_volumes, n_rows, width, s);
  return (int)cudaErrorInvalidValue;
}
