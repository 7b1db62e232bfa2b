// Exact fixed-point sums of the table gradients (H2, packed_hash_bwd.cu;
// H5, hash_anchored_bwd.cu; T2, temporal_grid_bwd.cu), so that a gradient
// is a function of its terms and not of the order in which the warps land.
//
// The kernels add, per (level, table entry, channel), the terms
// t = w_o * g[p, level*C + c] of the points' corners (T2: also (1 - frac)
// w_o g and frac w_o g, into two distinct channels of the entry): f32,
// formed as the plain versions form them, with w_o a trilinear weight (at
// most 1; a point's weights sum to 1, so a point adds at most max |g| into
// any (entry, channel)).  Each term is rounded once to a 64-bit integer
// at a scale fixed per level (H2, H5; T2 fixes one a table row, from the
// row's largest term, temporal_grid_bwd.cu's row_shift),
//   q = rint(t * 2^s),   s = 62 - ceil(log2 P) - E,
// where max|g| < 2^E over the level's columns of all P points (E the
// exponent frexp gives; 0 for a level of zeros).  Then |q| <= 2^62 / P and
// an entry's sum over at most P points stays below 2^63: the int64 sums
// are exact, and integer addition is associative, so any grouping and any
// order give the same bits.  The level's gradient is
// RN_f32(RN_f64(sum) * 2^-s): one rounding where the sum has at most 53
// bits, and within one f32 ulp of the scaled sum always.  s runs from about
// -97 to 210 (P < 2^31), past f32's range: a term is scaled by two f32
// powers of two (quantize32), the sum converted in f64.  A level whose g
// holds a NaN or an inf gets NaN in every entry (the
// optimizer's finite check then skips the step); nothing is added for it.
// A term whose q is 0 adds nothing and the kernels skip it.
//
// What the kernels share here: the level maxima (max |g| per level as f32
// bits: for |g| the unsigned order of the bits is the order of the values,
// and a NaN's bits lie above an inf's), the shift and scale of a level,
// the rounding of a term, and the conversion of int64 sums into f32.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace gfnerf {

constexpr int kNonFinite = INT_MIN;  // the shift of a level with NaN or inf
constexpr int kFixedThreads = 256;

// ceil(log2(n)) for n >= 1
__host__ __device__ inline int ceil_log2(long long n) {
  int k = 0;
  while ((1LL << k) < n) ++k;
  return k;
}

// The shift s of a level from the f32 bits of its largest |g|.
__device__ __forceinline__ int level_shift(unsigned max_bits,
                                           int log2_points) {
  if (max_bits >= 0x7f800000u) return kNonFinite;
  const unsigned biased = max_bits >> 23;
  int e;
  if (biased != 0) {
    e = (int)biased - 126;  // [2^(b-127), 2^(b-126))
  } else if (max_bits != 0) {
    e = (32 - __clz((int)max_bits)) - 149;  // a denormal m * 2^-149
  } else {
    e = 0;
  }
  return 62 - log2_points - e;
}

// 2^e as a double, for -1022 <= e <= 1023
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// A term at its level's scale, q = rint(t 2^s) rounded to nearest even,
// with one conversion.  The scale is two f32 powers of two, 2^a 2^b = 2^s
// with a <= 127 (s runs from about -97 to 210, so both are normal).
// t 2^a 2^b is exact in f32 wherever it reaches 2^-126 (and |t 2^s| <
// 2^62: no overflow); below that it rounds to a value under 2^-126, which
// rounds to 0 as the exact product does.
struct Scale32 {
  float a, b;
};

__device__ __forceinline__ Scale32 scale32(int s) {
  const int a = s < 127 ? s : 127;
  return {__int_as_float((a + 127) << 23),
          __int_as_float((s - a + 127) << 23)};
}

__device__ __forceinline__ long long quantize32(float t, Scale32 k) {
  return __float2ll_rn(__fmul_rn(__fmul_rn(t, k.a), k.b));
}

// An int64 sum of a level at shift s (not kNonFinite) as its f32 value.
__device__ __forceinline__ float fixed_to_f32(long long v, double inv) {
  return (float)(__ll2double_rn(v) * inv);
}

// |x| as the f32 bits the level maxima compare.
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// The level maxima over g (n values, rows of lc = L*C): each thread walks
// g with a stride that is a multiple of lc, so it sees one column (one
// level) throughout; the block folds its threads' maxima in shared memory
// (s_max: L u32), then into gmax (zeroed).  Threads past the last whole
// multiple of lc walk none.
__device__ __forceinline__ void level_max_pass(const float* __restrict__ g,
                                               long long n, int lc, int c,
                                               unsigned* __restrict__ gmax,
                                               unsigned* s_max) {
  const int n_levels = lc / c;
  for (int i = threadIdx.x; i < n_levels; i += blockDim.x) s_max[i] = 0u;
  __syncthreads();
  const long long total = (long long)gridDim.x * blockDim.x;
  const long long stride = total - total % lc;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < stride) {
    unsigned m = 0u;
    for (long long i = t; i < n; i += stride)
      m = max(m, abs_bits(__ldcs(g + i)));
    if (m != 0u) atomicMax(s_max + (int)(t % lc) / c, m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_levels; i += blockDim.x)
    if (s_max[i] != 0u) atomicMax(gmax + i, s_max[i]);
}

// The conversion of int64 sums into f32 gradients: level level0 +
// blockIdx.y of acc (level_elems sums a level, levels level_stride apart:
// 0 where acc holds one level) into out (level_elems a level, levels
// consecutive from level0's).
__device__ __forceinline__ void convert_pass(const long long* __restrict__ acc,
                                             float* __restrict__ out,
                                             long long level_elems,
                                             long long level_stride,
                                             const unsigned* __restrict__ gmax,
                                             int level0, int log2_points) {
  const int l = level0 + (int)blockIdx.y;
  const int s = level_shift(gmax[l], log2_points);
  const double inv = s == kNonFinite ? 0.0 : pow2(-s);
  const long long* a = acc + level_stride * blockIdx.y;
  float* o = out + level_elems * l;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < level_elems; i += stride) {
    const float v = s == kNonFinite ? __int_as_float(0x7fc00000)
                                    : fixed_to_f32(a[i], inv);
    __stcs(o + i, v);
  }
}

// Blocks of kFixedThreads for a pass over n elements, at most per_sm a
// multiprocessor of the card's 132.
inline unsigned fixed_blocks(long long n, int per_sm) {
  long long b = (n + kFixedThreads - 1) / kFixedThreads;
  const long long cap = 132LL * per_sm;
  b = b < cap ? b : cap;
  return (unsigned)(b > 0 ? b : 1);
}

}  // namespace gfnerf
