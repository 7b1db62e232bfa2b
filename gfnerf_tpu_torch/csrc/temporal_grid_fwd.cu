// Temporal multi-resolution grid encode, forward (T1).
//
// Replaces gfnerf_tpu/fields/temporal_grid.py:117 (temporal_grid_encode),
// which XLA builds from gathers of whole table rows: for every (point,
// level, corner) it reads the row's C + T = 66 channels and keeps the 3 the
// time's window uses.  The reference runs this encode as CUDA
// (temporal_gridencoder.cu).  Per (point, level):
//   row, frac = the time's window row;  cell, fraction = floor(xyz * res)
//   for the 8 corners o (x outermost): e = table[level offset + index(o)]
//     slot c: e[pass[row][c]], or at c = ipos[row]
//             (1 - frac) * e[pass[row][c]] + frac * e[new[row]]
//     acc[c] = acc[c] + w_o * slot c
//   out[p, level * C + c] = acc[c]
// in the plain version's order, each product and sum rounded once: equal
// to it bit for bit.
//
// Bound: the bytes.  Compulsory traffic is the points (P, 3) and times (P,)
// f32, the output (P, L * C) f32 and the table channels the window reads:
// C + 1 of a corner's 66, in one or two 32-byte sectors of its row.  This
// first kernel is the simple design: one thread per (point, level), the
// level along the grid's y so that a block's threads share its addressing
// (dense or hashed); the window table (at most T - 1 rows of C + 2 ints) in
// shared memory; the corners' channels read through the read-only cache.
// The gathers are scattered over the level's table; nothing is staged.

#include <cuda_runtime.h>

#include "temporal_grid_common.cuh"

namespace {

using namespace gfnerf::temporal;

template <int C>
__global__ void __launch_bounds__(kBlock)
    temporal_grid_fwd_kernel(const float* __restrict__ table,
                             const float* __restrict__ xyz,
                             const float* __restrict__ times,
                             const int* __restrict__ window,
                             const long long* __restrict__ offsets,
                             const int* __restrict__ resolutions,
                             const int* __restrict__ hashed,
                             float* __restrict__ out, long long n_points,
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

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const float* e =
        table + (off + corner_row(cell, d, res, is_hashed, n_level)) * width;
    const float w = corner_weight(frac, d);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = __ldg(e + slots[c]);
      if (c == ipos)
        v = __fadd_rn(__fmul_rn(keep_t, v), __fmul_rn(frac_t, __ldg(e + ch_new)));
      acc[c] = __fadd_rn(acc[c], __fmul_rn(w, v));
    }
  }
  float* o = out + p * (long long)(n_levels * C) + level * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = acc[c];
}

template <int C>
int launch(const float* table, const float* xyz, const float* times,
           const int* window, const long long* offsets, const int* res,
           const int* hashed, float* out, long long n_points, int n_levels,
           int width, int n_rows, float time_scale, cudaStream_t stream) {
  if (n_points == 0) return 0;
  const dim3 grid((unsigned)((n_points + kBlock - 1) / kBlock), n_levels);
  const size_t smem = sizeof(int) * n_rows * (C + 2);
  temporal_grid_fwd_kernel<C><<<grid, kBlock, smem, stream>>>(
      table, xyz, times, window, offsets, res, hashed, out, n_points,
      n_levels, width, n_rows, time_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gfnerf_temporal_grid_fwd(
    const float* table, const float* xyz, const float* times,
    const int* window, const long long* offsets, const int* res,
    const int* hashed, float* out, long long n_points, int n_levels,
    int level_dim, int width, int n_rows, float time_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (level_dim) {
    case 1:
      return launch<1>(table, xyz, times, window, offsets, res, hashed, out,
                       n_points, n_levels, width, n_rows, time_scale, s);
    case 2:
      return launch<2>(table, xyz, times, window, offsets, res, hashed, out,
                       n_points, n_levels, width, n_rows, time_scale, s);
    case 4:
      return launch<4>(table, xyz, times, window, offsets, res, hashed, out,
                       n_points, n_levels, width, n_rows, time_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
