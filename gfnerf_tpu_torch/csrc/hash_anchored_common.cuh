// Addressing of the anchored multi-resolution hash (the reference's
// Hash3DAnchored layout), shared by its forward (H4, hash_anchored_fwd.cu)
// and its table gradient (H5, hash_anchored_bwd.cu), so that the gradient
// scatters into exactly the entries the forward read.
//
// Per (point, level), as gfnerf_tpu/fields/hash_encoding.py:242-262 computes
// it: pt = fma(p, scale_l, bias[level, vol]) per axis (XLA contracts the
// multiply-add, hence fmaf), x0 = floor(pt), f = pt - x0; corner (i, j, k)
// of the cell, x outermost and z innermost, lies at table entry
//   ((x0+i)*ux ^ (y0+j)*uy ^ (z0+k)*uz) & (local - 1)        (uint32)
// of the level's (local, C) table, with weight (wx_i * wy_j) * wz_k,
// w_0 = 1 - f and w_1 = f.
//
// Both kernels use the packed hash's thread mapping (TileMap of
// packed_hash_common.cuh): a block stages a tile of consecutive points,
// each warp takes 32 of them at one level.

#pragma once

#include <cuda_runtime.h>

#include "packed_hash_common.cuh"

namespace gfnerf {

struct AnchoredCell {
  unsigned x0[3];    // per axis, the cell's lower corner (uint32 bits)
  unsigned h[3][2];  // per axis, the two corners' coordinate times prime
  float w[3][2];     // per axis, the two corners' weights (1 - f, f)
};

// The cell of a point with anchor >= 0 (the caller skips the others).
__device__ __forceinline__ AnchoredCell locate_anchored(
    const int* __restrict__ primes,    // (L, V, 3) uint32 bits
    const float* __restrict__ bias,    // (L, V, 3)
    const float* __restrict__ scales,  // (L,)
    const float pt[3], int anchor, int l, int n_volumes) {
  AnchoredCell c;
  const int vol = min(anchor, n_volumes - 1);
  const int lv = (l * n_volumes + vol) * 3;
  const float scale = scales[l];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pk = fmaf(pt[a], scale, bias[lv + a]);
    const float cf = floorf(pk);
    const float f = pk - cf;
    const unsigned x0 = (unsigned)(int)cf;
    const unsigned u = (unsigned)primes[lv + a];
    c.x0[a] = x0;
    c.h[a][0] = x0 * u;
    c.h[a][1] = (x0 + 1u) * u;
    c.w[a][0] = 1.f - f;
    c.w[a][1] = f;
  }
  return c;
}

// Table entry and trilinear weight of corner o = i*4 + j*2 + k.
__device__ __forceinline__ unsigned corner_entry(const AnchoredCell& c, int o,
                                                 unsigned mask) {
  return (c.h[0][o >> 2] ^ c.h[1][(o >> 1) & 1] ^ c.h[2][o & 1]) & mask;
}

__device__ __forceinline__ float corner_weight(const AnchoredCell& c, int o) {
  return __fmul_rn(__fmul_rn(c.w[0][o >> 2], c.w[1][(o >> 1) & 1]),
                   c.w[2][o & 1]);
}

}  // namespace gfnerf
