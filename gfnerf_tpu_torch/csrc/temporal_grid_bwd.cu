// Temporal multi-resolution grid encode, table gradient (T2).
//
// Replaces the VJP XLA builds for the gathers of
// gfnerf_tpu/fields/temporal_grid.py:163-171 (a scatter-add of whole
// 66-channel rows, one per (point, level, corner)).  Per (point, level),
// with T1's addressing (temporal_grid_common.cuh), for each corner o and
// slot c, gw = w_o * g[p, level * C + c]:
//   grad[e_o, pass[row][c]] += gw                  (c != ipos[row])
//   grad[e_o, pass[row][c]] += (1 - frac) * gw     (c == ipos[row]: old)
//   grad[e_o, new[row]]     += frac * gw
// The passthrough value at the interpolating slot gets nothing, as the JAX
// package's jnp.where drops it.
//
// Bound: the bytes.  Compulsory traffic is the upstream gradient (P, L * C)
// f32, the points and times, and the dense (rows, C + T) f32 gradient
// written once (the wrapper zeroes it: 1.6 GB at nerfplayer-nerfacto's
// field).  On top the L2 applies one read-modify-write per reduction, C + 1
// a corner, spread over the level's table.  This first kernel is the plain
// atomic design: one thread per (point, level), one atomicAdd per term, no
// merging of equal rows.

#include <cuda_runtime.h>

#include "temporal_grid_common.cuh"

namespace {

using namespace gfnerf::temporal;

template <int C>
__global__ void __launch_bounds__(kBlock)
    temporal_grid_bwd_kernel(const float* __restrict__ g,
                             const float* __restrict__ xyz,
                             const float* __restrict__ times,
                             const int* __restrict__ window,
                             const long long* __restrict__ offsets,
                             const int* __restrict__ resolutions,
                             const int* __restrict__ hashed,
                             float* __restrict__ grad, long long n_points,
                             int n_levels, int width, int n_rows,
                             float time_scale) {
  extern __shared__ int s_window[];
  stage_window(window, n_rows * (C + 2), s_window);
  const int level = blockIdx.y;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_points) return;

  float frac_t;
  const int row = time_row(__ldg(times + p), time_scale, n_rows, &frac_t);
  const float keep_t = __fsub_rn(1.f, frac_t);
  const int* slots = s_window + row * (C + 2);
  const int ch_new = slots[C];
  const int ipos = slots[C + 1];

  const long long off = offsets[level];
  const unsigned n_level = (unsigned)(offsets[level + 1] - off);
  const int res = resolutions[level];
  const bool is_hashed = hashed[level] != 0;
  int cell[3];
  float frac[3];
  level_cell(xyz + 3 * p, res, cell, frac);

  float gp[C];
  const float* gl = g + p * (long long)(n_levels * C) + level * C;
#pragma unroll
  for (int c = 0; c < C; ++c) gp[c] = __ldg(gl + c);
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float* e =
        grad + (off + corner_row(cell, d, res, is_hashed, n_level)) * width;
    const float w = corner_weight(frac, d);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float gw = __fmul_rn(w, gp[c]);
      if (c == ipos) {
        atomicAdd(e + slots[c], __fmul_rn(keep_t, gw));
        atomicAdd(e + ch_new, __fmul_rn(frac_t, gw));
      } else {
        atomicAdd(e + slots[c], gw);
      }
    }
  }
}

template <int C>
int launch(const float* g, const float* xyz, const float* times,
           const int* window, const long long* offsets, const int* res,
           const int* hashed, float* grad, long long n_points, int n_levels,
           int width, int n_rows, float time_scale, cudaStream_t stream) {
  if (n_points == 0) return 0;
  const dim3 grid((unsigned)((n_points + kBlock - 1) / kBlock), n_levels);
  const size_t smem = sizeof(int) * n_rows * (C + 2);
  temporal_grid_bwd_kernel<C><<<grid, kBlock, smem, stream>>>(
      g, xyz, times, window, offsets, res, hashed, grad, n_points, n_levels,
      width, n_rows, time_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gfnerf_temporal_grid_bwd(
    const float* g, const float* xyz, const float* times, const int* window,
    const long long* offsets, const int* res, const int* hashed, float* grad,
    long long n_points, int n_levels, int level_dim, int width, int n_rows,
    float time_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (level_dim) {
    case 1:
      return launch<1>(g, xyz, times, window, offsets, res, hashed, grad,
                       n_points, n_levels, width, n_rows, time_scale, s);
    case 2:
      return launch<2>(g, xyz, times, window, offsets, res, hashed, grad,
                       n_points, n_levels, width, n_rows, time_scale, s);
    case 4:
      return launch<4>(g, xyz, times, window, offsets, res, hashed, grad,
                       n_points, n_levels, width, n_rows, time_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
