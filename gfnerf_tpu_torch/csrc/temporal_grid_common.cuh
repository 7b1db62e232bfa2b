// The temporal grid's addressing, shared by T1 (temporal_grid_fwd.cu) and
// T2 (temporal_grid_bwd.cu).  Every step is the plain PyTorch version's
// (gfnerf_tpu_torch/fields/temporal_grid.py), each product and sum rounded
// once: the products and sums go through __fmul_rn / __fadd_rn, which nvcc
// never contracts into a fused multiply-add, so T1 equals the plain encode
// bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gfnerf {
namespace temporal {

// one thread per (point, level): points along x, the level along y
constexpr int kBlock = 256;

// The window row and its interpolation fraction of a time:
// val = clip(t, 0, 1) * time_scale, row = min(int(val), n_rows - 1),
// frac = val - row.
__device__ __forceinline__ int time_row(float t, float time_scale,
                                        int n_rows, float* frac) {
  const float v = __fmul_rn(fminf(fmaxf(t, 0.f), 1.f), time_scale);
  const int r = min((int)v, n_rows - 1);
  *frac = __fsub_rn(v, (float)r);
  return r;
}

// A point's cell at one level: floor(xyz * res) and the fraction.
__device__ __forceinline__ void level_cell(const float* __restrict__ p,
                                           int res, int cell[3],
                                           float frac[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fmul_rn(__ldg(p + a), (float)res);
    const float f = floorf(s);
    cell[a] = (int)f;
    frac[a] = __fsub_rn(s, f);
  }
}

// Corner d (x outermost, z innermost: d = 4 dx + 2 dy + dz): its table row
// within the level (the corner clamped to [0, res], then the uint32
// XOR-prime hash modulo the level's rows, or the dense index) and its
// trilinear weight ((wx * wy) * wz).
__device__ __forceinline__ long long corner_row(const int cell[3], int d,
                                                int res, bool hashed,
                                                unsigned n_level) {
  const int cx = min(max(cell[0] + ((d >> 2) & 1), 0), res);
  const int cy = min(max(cell[1] + ((d >> 1) & 1), 0), res);
  const int cz = min(max(cell[2] + (d & 1), 0), res);
  if (hashed) {
    const uint32_t h = ((uint32_t)cx * 1u) ^ ((uint32_t)cy * 2654435761u) ^
                       ((uint32_t)cz * 805459861u);
    return (long long)(h % n_level);
  }
  return cx + (long long)(res + 1) * (cy + (long long)(res + 1) * cz);
}

__device__ __forceinline__ float corner_weight(const float frac[3], int d) {
  const float wx = (d & 4) ? frac[0] : __fsub_rn(1.f, frac[0]);
  const float wy = (d & 2) ? frac[1] : __fsub_rn(1.f, frac[1]);
  const float wz = (d & 1) ? frac[2] : __fsub_rn(1.f, frac[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// Copy the window table (n_rows x (C + 2) int32: the C passthrough
// channels, the new channel, the interpolating slot) into shared memory.
__device__ __forceinline__ void stage_window(const int* __restrict__ window,
                                             int n, int* s_window) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_window[i] = window[i];
  __syncthreads();
}

}  // namespace temporal
}  // namespace gfnerf
