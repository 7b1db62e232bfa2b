// The temporal grid's addressing, shared by T1 (temporal_grid_fwd.cu) and
// T2 (temporal_grid_bwd.cu).  Every step is the plain PyTorch version's
// (gfnerf_tpu_torch/fields/temporal_grid.py), each product and sum rounded
// once: the products and sums go through __fmul_rn / __fadd_rn, which nvcc
// never contracts into a fused multiply-add, so T1 equals the plain encode
// bit for bit.
//
// Two facts of every grid make_temporal_grid builds, which
// TemporalGridStatics.tables() checks before a kernel sees the grid:
// - The window is contiguous.  At window row r the C output slots read
//   the stored channels r .. r + C - 1 (slot c the one congruent to c mod
//   C), the interpolating slot is r mod C, its old channel r and its new
//   channel r + C.  A corner therefore reads, and its gradient writes, the
//   C + 1 consecutive channels r .. r + C of its row, and r <= T - 2
//   leaves at least one more channel of the row after them.
// - Every hashed level holds a power of two of rows, so the hash modulo
//   the level's rows is a mask.
//
// In both kernels a warp takes 32 consecutive points at ONE level, one
// point per lane, and a launch covers a group of consecutive levels; the
// launcher runs the groups one after the other on the stream.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gfnerf {
namespace temporal {

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
__device__ __forceinline__ void level_cell(const float* p, int res,
                                           int cell[3], float frac[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fmul_rn(p[a], (float)res);
    const float f = floorf(s);
    cell[a] = (int)f;
    frac[a] = __fsub_rn(s, f);
  }
}

// One level's addressing: its first row, its rows less one (the hash's
// mask), its resolution and whether it hashes.
struct Level {
  long long off;
  unsigned mask;
  int res;
  bool hashed;
  __device__ Level(const long long* __restrict__ offsets,
                   const int* __restrict__ resolutions,
                   const int* __restrict__ hashed_flags, int l) {
    off = offsets[l];
    mask = (unsigned)(offsets[l + 1] - off - 1);
    res = resolutions[l];
    hashed = hashed_flags[l] != 0;
  }
};

// Corner d (x outermost, z innermost: d = 4 dx + 2 dy + dz): its table row
// (the corner clamped to [0, res], then the uint32 XOR-prime hash masked
// to the level's rows, or the dense index).
__device__ __forceinline__ long long corner_row(const int cell[3], int d,
                                                const Level& lv) {
  const int cx = min(max(cell[0] + ((d >> 2) & 1), 0), lv.res);
  const int cy = min(max(cell[1] + ((d >> 1) & 1), 0), lv.res);
  const int cz = min(max(cell[2] + (d & 1), 0), lv.res);
  if (lv.hashed) {
    const uint32_t h = ((uint32_t)cx * 1u) ^ ((uint32_t)cy * 2654435761u) ^
                       ((uint32_t)cz * 805459861u);
    return lv.off + (long long)(h & lv.mask);
  }
  return lv.off + cx + (long long)(lv.res + 1) *
                           (cy + (long long)(lv.res + 1) * cz);
}

// Its trilinear weight ((wx * wy) * wz).
__device__ __forceinline__ float corner_weight(const float frac[3], int d) {
  const float wx = (d & 4) ? frac[0] : __fsub_rn(1.f, frac[0]);
  const float wy = (d & 2) ? frac[1] : __fsub_rn(1.f, frac[1]);
  const float wz = (d & 1) ? frac[2] : __fsub_rn(1.f, frac[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The C + 1 channels b .. b + C of the table (b = row * width + r) with
// the fewest aligned vector loads: a float4 at q = b rounded down to 4
// floats, and a float2 or float4 at q + 4 where the window reaches it.
// Every load stays within [q, b + C + 1], which lies in the allocation: q
// >= 0 with a 16-byte aligned table, and b + C + 1 is at most the row's
// last channel since r <= T - 2.  At C = 2, 1.5 loads a corner on average
// (one where b mod 4 < 2), against 3 scalar loads.
template <int C>
__device__ __forceinline__ void load_window(const float* __restrict__ table,
                                            long long b, float (&v)[C + 1]) {
  const int o = (int)(b & 3);
  const float* q = table + (b - o);
  float w[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (o + C >= 2) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(q));
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else {
    const float2 x = __ldg(reinterpret_cast<const float2*>(q));
    w[0] = x.x, w[1] = x.y;
  }
  if (o + C >= 6) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(q + 4));
    w[4] = x.x, w[5] = x.y, w[6] = x.z, w[7] = x.w;
  } else if (o + C >= 4) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(q + 4));
    w[4] = x.x, w[5] = x.y;
  }
#pragma unroll
  for (int k = 0; k <= C; ++k)
    v[k] = o == 0 ? w[k] : o == 1 ? w[k + 1] : o == 2 ? w[k + 2] : w[k + 3];
}

// Adds v[k] to grad[b + k], k = 0 .. C, touching no other channel: a
// float2 reduction (CUDA's atomicAdd(float2*) for compute capability 9.x,
// its result unused) for each pair starting at an even channel index, a
// scalar one for the rest (rows are 8-byte aligned, 264 bytes at C + T =
// 66).  Returns the reductions made: 2 a corner at C = 2.
template <int C>
__device__ __forceinline__ int red_window(float* grad, long long b,
                                          const float (&v)[C + 1]) {
  float* p = grad + b;
  if (b & 1) {
    atomicAdd(p, v[0]);
#pragma unroll
    for (int k = 1; k + 1 <= C; k += 2)
      atomicAdd(reinterpret_cast<float2*>(p + k), make_float2(v[k], v[k + 1]));
    if (C % 2 == 1) atomicAdd(p + C, v[C]);
    return 1 + C / 2 + C % 2;
  }
#pragma unroll
  for (int k = 0; k + 1 <= C; k += 2)
    atomicAdd(reinterpret_cast<float2*>(p + k), make_float2(v[k], v[k + 1]));
  if (C % 2 == 0) atomicAdd(p + C, v[C]);
  return (C + 1) / 2 + (C % 2 == 0);
}

// Adds v[k] to grad[b + k], k = 0 .. C, as load_window reads them: a
// float4 reduction at q = b rounded down to 4 floats, and a float2 or
// float4 one at q + 4 where the window reaches it, the lanes outside the
// window adding +0.0 (exact: an entry starts at +0.0 and never becomes
// -0.0, so x + 0.0 is x).  They stay within [q, b + C + 1], in the
// allocation.  Returns the reductions made: 1.5 a corner at C = 2 on
// average, 2 at C = 4.
template <int C>
__device__ __forceinline__ int red_window4(float* grad, long long b,
                                           const float (&v)[C + 1]) {
  const int o = (int)(b & 3);
  float* q = grad + (b - o);
  float w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = 0.f;
#pragma unroll
    for (int k = 0; k <= C; ++k)
      if (i == o + k) w[i] = v[k];
  }
  int n = 1;
  if (o + C >= 2)
    atomicAdd(reinterpret_cast<float4*>(q),
              make_float4(w[0], w[1], w[2], w[3]));
  else
    atomicAdd(reinterpret_cast<float2*>(q), make_float2(w[0], w[1]));
  if (o + C >= 6) {
    atomicAdd(reinterpret_cast<float4*>(q + 4),
              make_float4(w[4], w[5], w[6], w[7]));
    ++n;
  } else if (o + C >= 4) {
    atomicAdd(reinterpret_cast<float2*>(q + 4), make_float2(w[4], w[5]));
    ++n;
  }
  return n;
}

// The launches over groups of `group` consecutive levels (the last may
// hold fewer): launch_group(l0, n_lev) launches the kernel over levels
// [l0, l0 + n_lev) of a map of n_tiles blocks; *launches counts the
// launches made.  Returns the first CUDA error, or cudaSuccess.
template <class LaunchGroup>
int launch_groups(int n_levels, int group, long long n_tiles, int* launches,
                  LaunchGroup launch_group) {
  if (n_tiles == 0) return (int)cudaSuccess;
  for (int l0 = 0; l0 < n_levels; l0 += group) {
    launch_group(l0, group < n_levels - l0 ? group : n_levels - l0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return (int)cudaSuccess;
}

}  // namespace temporal
}  // namespace gfnerf
