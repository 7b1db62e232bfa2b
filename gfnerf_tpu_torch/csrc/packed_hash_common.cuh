// Addressing of the packed (supercell) anchored hash, shared by the forward
// (H1, packed_hash_fwd.cu) and the table-gradient backward (H2,
// packed_hash_bwd.cu), so that the backward scatters into exactly the rows
// and lattice entries that the forward read.
//
// Per (point, level), as gfnerf_tpu/fields/packed_hash.py computes it:
//   fma(p, scale_l, bias[level, vol]) -> supercell s, local cell l, fraction f
//   row = (sx*ux ^ sy*uy ^ sz*uz) & (rows - 1)   (uint32, packed_hash.py:154)
//         or the dense address vol*m^3 + (s mod m) . (m^2, m, 1) on the
//         first dense levels (packed_hash.py:163-199)
// The coordinate uses fmaf, as the fused XLA code does; the division by
// PACK is the shift / multiply-shift of packed_hash._div_pack.

#pragma once

#include <cuda_runtime.h>

namespace gfnerf {

// floor(cell / PACK) as packed_hash._div_pack computes it (logical shift for
// powers of two, multiply-shift for 3).
template <int PACK>
__device__ __forceinline__ int div_pack(int cell) {
  if (PACK == 1) return cell;
  if (PACK == 2) return (int)((unsigned)cell >> 1);
  if (PACK == 3) return (int)(((unsigned)cell * 21846u) >> 16);
  return cell / PACK;
}

__device__ __forceinline__ int pos_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// Where one (point, level) lands in the table.
struct HashCell {
  unsigned row;   // row of the level's table
  int loc[3];     // local cell inside the supercell, per axis
  float frac[3];  // fraction inside the cell, per axis
  bool valid;     // anchor >= 0 (a masked point reads row 0 of volume 0)
};

template <int PACK>
__device__ __forceinline__ HashCell locate(
    const int* __restrict__ primes,    // (L, V, 3) uint32 bits
    const float* __restrict__ bias,    // (L, V, 3)
    const float* __restrict__ scales,  // (L,)
    const int* __restrict__ dense_m,   // (L,) 0 = hashed level
    const float* __restrict__ points,  // (P, 3)
    const int* __restrict__ anchors,   // (P,)
    long long p, int l, int n_volumes, int n_rows) {
  HashCell c;
  const int anchor = anchors[p];
  c.valid = anchor >= 0;
  const int vol = min(max(anchor, 0), n_volumes - 1);
  const int lv = (l * n_volumes + vol) * 3;
  const float scale = scales[l];
  int sup[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pk = fmaf(points[p * 3 + a], scale, bias[lv + a]);
    const float cf = floorf(pk);
    c.frac[a] = pk - cf;
    const int cell = (int)cf;
    sup[a] = div_pack<PACK>(cell);
    c.loc[a] = (int)((unsigned)cell - (unsigned)sup[a] * (unsigned)PACK);
  }
  const int m = dense_m[l];
  if (m > 0) {
    const long long h = (long long)vol * m * m * m +
                        (long long)pos_mod(sup[0], m) * m * m +
                        (long long)pos_mod(sup[1], m) * m + pos_mod(sup[2], m);
    c.row = (unsigned)min(h, (long long)(n_rows - 1));
  } else {
    c.row = (((unsigned)sup[0] * (unsigned)primes[lv + 0]) ^
             ((unsigned)sup[1] * (unsigned)primes[lv + 1]) ^
             ((unsigned)sup[2] * (unsigned)primes[lv + 2])) &
            (unsigned)(n_rows - 1);
  }
  return c;
}

// Per-axis trilinear factors of the cell's two lattice positions: weight
// (1-f) at position loc and f at loc+1.  A position outside [0, E) (a cell
// the valid range never gives) gets weight 0, as in _interp_level's and
// _lattice_weights' factorized sums, and is clamped inside the row.
template <int E>
__device__ __forceinline__ void axis_factors(const HashCell& c,
                                             float wt[3][2], int q[3][2],
                                             bool inside[3][2]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int pos = c.loc[a] + u;
      inside[a][u] = pos >= 0 && pos < E;
      wt[a][u] = inside[a][u] ? (u == 0 ? 1.f - c.frac[a] : c.frac[a]) : 0.f;
      q[a][u] = min(max(pos, 0), E - 1);
    }
  }
}

}  // namespace gfnerf
