// Exact fixed-point sums of the table gradients (H2, packed_hash_bwd.cu;
// H5, hash_anchored_bwd.cu), so that a gradient is a function of its terms
// and not of the order in which the warps land.
//
// Both kernels add, per (level, table entry, channel), the terms
// t = w_o * g[p, level*C + c] of the points' corners: f32, formed as the
// plain versions form them, with w_o a trilinear weight (at most 1; a
// point's weights sum to 1).  Each term is rounded once to a 64-bit integer
// at a scale fixed per level,
//   q = rint(t * 2^s),   s = 62 - ceil(log2 P) - E,
// where max|g| < 2^E over the level's columns of all P points (E the
// exponent frexp gives; 0 for a level of zeros).  Then |q| <= 2^62 / P and
// an entry's sum over at most P points stays below 2^63: the int64 sums
// are exact, and integer addition is associative, so any order gives the
// same bits.  The level's gradient is RN_f32(RN_f64(sum) * 2^-s): one
// rounding where the sum has at most 53 bits, and within one f32 ulp of
// the scaled sum always.  The scale is a power of two applied in f64, never
// an f32 2^s: s runs from about -129 to 210.  A level whose g holds a NaN
// or an inf gets NaN in every entry (the optimizer's finite check then
// skips the step); nothing is added for it.
//
// The passes of one call, on one stream (launch_fixed_point):
// 1. the level maxima: max |g| per level as f32 bits (for |g| the unsigned
//    order of the bits is the order of the values, and a NaN's bits lie
//    above an inf's), one launch over g (P, L*C), atomicMax into (L,) u32;
// 2. per level, one after another, reusing one int64 accumulator of a
//    level (a cudaMemsetAsync before each, so the level's adds land in
//    zeroed lines the L2 holds): the kernel's accumulation, then
// 3. the conversion of that level's sums into its f32 gradient.

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

// A term at the level's scale: exact in f64, rounded to nearest even once.
__device__ __forceinline__ long long quantize(float t, double scale) {
  return __double2ll_rn((double)t * scale);
}

// Pass 1: each thread walks g (n values, rows of lc = L*C) with a stride
// that is a multiple of lc, so it sees one column (one level) throughout;
// the block folds its threads' maxima in shared memory (s_max: L u32),
// then into gmax.  Threads past the last whole multiple of lc walk none.
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
      m = max(m, __float_as_uint(__ldcs(g + i)) & 0x7fffffffu);
    if (m != 0u) atomicMax(s_max + (int)(t % lc) / c, m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_levels; i += blockDim.x)
    if (s_max[i] != 0u) atomicMax(gmax + i, s_max[i]);
}

// Pass 3: one level's n int64 sums into its f32 gradient.
__device__ __forceinline__ void convert_pass(const long long* __restrict__ acc,
                                             float* __restrict__ out,
                                             long long n, unsigned max_bits,
                                             int log2_points) {
  const int s = level_shift(max_bits, log2_points);
  const double inv = s == kNonFinite ? 0.0 : pow2(-s);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = s == kNonFinite
                        ? __int_as_float(0x7fc00000)
                        : (float)(__ll2double_rn(acc[i]) * inv);
    __stcs(out + i, v);
  }
}

// The passes of one call over levels [0, n_levels) of g (P, L*C): the level
// maxima (max_kernel<<<..>>>(g, n, lc, c, gmax), L u32 of shared memory),
// then per level a zeroed accumulator of level_elems int64, accumulate(l,
// log2_points) (the caller's launch) and convert_kernel<<<..>>>(acc, out,
// level_elems, gmax + l, log2_points) into grad's level l.  *launches
// counts the kernel launches; a call with no points launches none and
// zeroes the gradient.  Returns the first CUDA error, or cudaSuccess.
template <class MaxKernel, class ConvertKernel, class Accumulate>
int launch_fixed_point(const float* g, long long n_points, int n_levels,
                       int n_channels, float* grad, long long* acc,
                       unsigned* gmax, long long level_elems,
                       cudaStream_t stream, int* launches,
                       MaxKernel max_kernel, ConvertKernel convert_kernel,
                       Accumulate accumulate) {
  cudaError_t err;
  if (n_points == 0) {
    err = cudaMemsetAsync(grad, 0, sizeof(float) * n_levels * level_elems,
                          stream);
    return (int)err;
  }
  const int lc = n_levels * n_channels;
  const int log2_points = ceil_log2(n_points);
  const long long n = n_points * lc;
  long long blocks = (n + kFixedThreads - 1) / kFixedThreads;
  blocks = blocks < 132 * 8 ? blocks : 132 * 8;
  const long long need = (lc + kFixedThreads - 1) / kFixedThreads;
  blocks = blocks > need ? blocks : need;
  err = cudaMemsetAsync(gmax, 0, sizeof(unsigned) * n_levels, stream);
  if (err != cudaSuccess) return (int)err;
  max_kernel<<<(unsigned)blocks, kFixedThreads,
               sizeof(unsigned) * n_levels, stream>>>(g, n, lc, n_channels,
                                                      gmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  long long cblocks = (level_elems + kFixedThreads - 1) / kFixedThreads;
  cblocks = cblocks < 132 * 16 ? cblocks : 132 * 16;
  for (int l = 0; l < n_levels; ++l) {
    err = cudaMemsetAsync(acc, 0, sizeof(long long) * level_elems, stream);
    if (err != cudaSuccess) return (int)err;
    accumulate(l, log2_points);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
    convert_kernel<<<(unsigned)cblocks, kFixedThreads, 0, stream>>>(
        acc, grad + l * level_elems, level_elems, gmax + l, log2_points);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return (int)cudaSuccess;
}

}  // namespace gfnerf
