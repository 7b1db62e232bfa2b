// Temporal multi-resolution grid encode, forward (T1).
//
// Replaces gfnerf_tpu/fields/temporal_grid.py:117 (temporal_grid_encode),
// which XLA builds from gathers of whole table rows: for every (point,
// level, corner) it reads the row's C + T = 66 channels and keeps the 3 the
// time's window uses.  The reference runs this encode as CUDA
// (temporal_gridencoder.cu).  Per (point, level), with the addressing of
// temporal_grid_common.cuh:
//   r, frac = the time's window row;  cell, fraction = floor(xyz * res)
//   for the 8 corners o (x outermost): e = table[index(o)]
//     slot c != r mod C: e[channel of r .. r + C - 1 congruent to c]
//     slot r mod C:      (1 - frac) * e[r] + frac * e[r + C]
//     acc[c] = acc[c] + w_o * slot c
//   out[p, level * C + c] = acc[c]
// in the plain version's order, each product and sum rounded once, on one
// lane: equal to it bit for bit.
//
// Bound: the bytes.  Compulsory traffic is the points (P, 3) and times (P,)
// f32, the output (P, L * C) f32 and the table channels the window reads:
// C + 1 of a corner's 66, in one or two 32-byte sectors of its row.  Each
// (point, level, corner) is a scattered read: on the fine, hashed levels
// the sectors come from device memory at random (the step's points in a
// random order take about as long as in the first kernel, which read a
// corner with three scalar loads through a window table), so the design
// cuts the instructions and the requests a corner and keeps the output's
// partial sectors in the L2.  Design (temporal_bench.py and chip_smoke.py
// time it; PERF.md has the numbers):
// - The window read directly: the C + 1 channels are contiguous, so a
//   corner takes one or two aligned vector loads (load_window: 1.5 a
//   corner at C = 2), with no window table and no branch on the slot.  The
//   slots are summed in the window's own order (slot j = the channel r +
//   j, j = 0 interpolating) and put back in the output's order at the end.
// - The hashed levels' modulo is a mask (their rows are powers of two).
// - A thread per (point, level), a block 256 consecutive points at one
//   level, so a warp's 32 consecutive samples of a ray, which share cells
//   (and, within a camera, the time) on the coarse levels, read the same
//   sectors in one instruction.  The blocks run point-major: a block of
//   points at each level of the launch in turn, so the C slots each lane
//   stores (8 bytes at C = 2, a quarter of a sector) meet the other
//   levels' in the L2 before the sector leaves it: the output (100 MB at
//   nerfplayer-ngp's step) does not fit the L2 level by level.  No shared
//   memory and no barrier: a warp retires as soon as its loads return.
// - Written as a grid-stride loop over the (points' block, level) items:
//   nvcc 12 gives it 40 registers, 6 blocks an SM.  The same body without
//   the loop took 32 registers (8 blocks an SM) and read 10% slower at
//   nerfplayer-ngp's step, 15% faster at proposal 0; fewer resident blocks
//   (4 to 6 an SM over a persistent grid) read slower at every shape.
//   Also timed and dropped: the levels one after the other (level-major:
//   the lanes' partial output sectors leave the L2 at ngp's step), and
//   the packed hash's tiles (a block stages its points and output in
//   shared memory: slower than the first kernel at proposal 1).
// - One launch per group of levels (levels_per_launch; chip_smoke.py times
//   1, 2, 4, 8 and 16 at nerfplayer-nerfacto's field).

#include <cuda_runtime.h>

#include "temporal_grid_common.cuh"

namespace {

using namespace gfnerf::temporal;

constexpr int kBlock = 256;  // points per block: 8 warps
constexpr long long kMaxGrid = 0x7fffffff;  // the grid's x limit

template <int C>
__global__ void __launch_bounds__(kBlock)
    temporal_grid_fwd_kernel(const float* __restrict__ table,
                             const float* __restrict__ xyz,
                             const float* __restrict__ times,
                             const long long* __restrict__ offsets,
                             const int* __restrict__ resolutions,
                             const int* __restrict__ hashed,
                             float* __restrict__ out, long long n_points,
                             int n_levels, int width, int n_rows,
                             float time_scale, int l0, int n_lev,
                             long long n_items) {
  // item b, point-major: the launch's level b mod n_lev of the points'
  // block b / n_lev; a block takes the items blockIdx.x, + gridDim.x, ...
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int l = l0 + (int)(item % n_lev);
    const long long p = item / n_lev * kBlock + threadIdx.x;
    if (p >= n_points) continue;
    const Level lv(offsets, resolutions, hashed, l);
    const float pt[3] = {__ldg(xyz + 3 * p), __ldg(xyz + 3 * p + 1),
                         __ldg(xyz + 3 * p + 2)};
    float frac_t;
    const int r = time_row(__ldg(times + p), time_scale, n_rows, &frac_t);
    const float keep_t = __fsub_rn(1.f, frac_t);
    int cell[3];
    float frac[3];
    level_cell(pt, lv.res, cell, frac);

    float slot[C];  // slot[j]: the output slot reading channel r + j
#pragma unroll
    for (int j = 0; j < C; ++j) slot[j] = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      float v[C + 1];
      load_window<C>(table, corner_row(cell, d, lv) * width + r, v);
      const float w = corner_weight(frac, d);
      const float mixed =
          __fadd_rn(__fmul_rn(keep_t, v[0]), __fmul_rn(frac_t, v[C]));
      slot[0] = __fadd_rn(slot[0], __fmul_rn(w, mixed));
#pragma unroll
      for (int j = 1; j < C; ++j)
        slot[j] = __fadd_rn(slot[j], __fmul_rn(w, v[j]));
    }

    // output slot c reads channel r + ((c - r) mod C)
    const int ip = r % C;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = (c - ip + C) % C;
      acc[c] = slot[0];
#pragma unroll
      for (int k = 1; k < C; ++k)
        if (k == j) acc[c] = slot[k];
    }
    float* o = out + p * (long long)(n_levels * C) + l * C;
    if (C == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[C - 1]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) o[c] = acc[c];
    }
  }
}

template <int C>
int launch(const float* table, const float* xyz, const float* times,
           const long long* offsets, const int* res, const int* hashed,
           float* out, int* launches, long long n_points, int n_levels,
           int width, int n_rows, float time_scale, int group,
           cudaStream_t stream) {
  const long long blocks = (n_points + kBlock - 1) / kBlock;
  if (group <= 0 || group > n_levels) group = n_levels;
  return launch_groups(
      n_levels, group, blocks, launches, [&](int l0, int n_lev) {
        const long long items = blocks * n_lev;
        temporal_grid_fwd_kernel<C>
            <<<(unsigned)(items < kMaxGrid ? items : kMaxGrid), kBlock, 0,
               stream>>>(table, xyz, times, offsets, res, hashed, out,
                         n_points, n_levels, width, n_rows, time_scale, l0,
                         n_lev, items);
      });
}

}  // namespace

// Supported channels C: 1, 2 and 4.  The grid must hold the two facts of
// temporal_grid_common.cuh (TemporalGridStatics.tables() checks them), and
// the table must be 16-byte aligned.  launches: a host int that gets the
// number of kernel launches made added to it.  levels_per_launch: the
// levels each launch covers (0 or more than L: all in one launch).
extern "C" int gfnerf_temporal_grid_fwd(
    const float* table, const float* xyz, const float* times,
    const long long* offsets, const int* res, const int* hashed, float* out,
    int* launches, long long n_points, int n_levels, int level_dim,
    int width, int n_rows, float time_scale, int levels_per_launch,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (level_dim) {
    case 1:
      return launch<1>(table, xyz, times, offsets, res, hashed, out, launches,
                       n_points, n_levels, width, n_rows, time_scale,
                       levels_per_launch, s);
    case 2:
      return launch<2>(table, xyz, times, offsets, res, hashed, out, launches,
                       n_points, n_levels, width, n_rows, time_scale,
                       levels_per_launch, s);
    case 4:
      return launch<4>(table, xyz, times, offsets, res, hashed, out, launches,
                       n_points, n_levels, width, n_rows, time_scale,
                       levels_per_launch, s);
  }
  return (int)cudaErrorInvalidValue;
}
