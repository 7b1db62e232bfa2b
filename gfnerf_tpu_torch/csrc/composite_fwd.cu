// Fused volume-rendering composite, forward (K1).
//
// Replaces the Pallas TPU kernel gfnerf_tpu/ops/pallas/composite.py:80
// (_kernel, launched by _composite_pallas). Per ray, over S samples:
//   alpha_i = 1 - exp(-sigma_i * dt_i)
//   T_i     = exp(-sum_{j<i} sigma_j * dt_j)        (exclusive prefix)
//   w_i     = alpha_i * T_i
//   rgb = sum w_i c_i ; acc = sum w_i ; depth = sum w_i t_i / (acc + 1e-10)
// with the reference's nan_to_num on w and depth (composite.py:63-77).
//
// Bound: memory. Each sample reads 24 bytes (sigma, dt, t, rgb) and writes 8
// (w, alpha): about 0.4 GB per 32768 x 384 chunk, 0.12 ms at the H100's
// 3.35 TB/s. Design: one warp per ray walks the samples in tiles of 32,
// neighbouring lanes on neighbouring samples (coalesced loads and stores).
// The prefix is a warp inclusive scan (__shfl_up_sync) plus a running carry
// broadcast from lane 31, so any S works: no power-of-two padding and no
// ray-count rule (the TPU kernel's layout rules, composite.py:174-181,
// 210-216). rgb/acc/depth sums stay in registers and are reduced across the
// warp once at the end.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void composite_fwd_kernel(
    const float* __restrict__ dens, const float* __restrict__ dts,
    const float* __restrict__ ts, const float* __restrict__ rgbs,
    float* __restrict__ w_out, float* __restrict__ a_out,
    float* __restrict__ rgb_out, float* __restrict__ acc_out,
    float* __restrict__ depth_out, long long n_rays, long long n_samples) {
  const long long ray =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ray >= n_rays) return;  // warp-uniform
  const size_t base = (size_t)ray * (size_t)n_samples;

  float carry = 0.f;  // sum of sigma*dt over the tiles already done
  float sr = 0.f, sg = 0.f, sb = 0.f, sw = 0.f, swt = 0.f;
  for (long long s0 = 0; s0 < n_samples; s0 += 32) {
    const long long s = s0 + lane;
    const bool in = s < n_samples;
    const size_t i = base + (size_t)s;
    const float dd = in ? dens[i] * dts[i] : 0.f;
    // inclusive warp scan of dd
    float incl = dd;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    // exclusive prefix = carry + inclusive sum of the lanes before this one
    const float before = __shfl_up_sync(kFull, incl, 1);
    const float excl = carry + (lane == 0 ? 0.f : before);
    carry += __shfl_sync(kFull, incl, 31);
    if (in) {
      const float alpha = 1.f - expf(-dd);
      float w = alpha * expf(-excl);
      if (isnan(w)) w = 0.f;
      w_out[i] = w;
      a_out[i] = alpha;
      sr += w * rgbs[3 * i + 0];
      sg += w * rgbs[3 * i + 1];
      sb += w * rgbs[3 * i + 2];
      sw += w;
      swt += w * ts[i];
    }
  }
  sr = warp_sum(sr);
  sg = warp_sum(sg);
  sb = warp_sum(sb);
  sw = warp_sum(sw);
  swt = warp_sum(swt);
  if (lane == 0) {
    rgb_out[3 * ray + 0] = sr;
    rgb_out[3 * ray + 1] = sg;
    rgb_out[3 * ray + 2] = sb;
    acc_out[ray] = sw;
    float depth = swt / (sw + 1e-10f);
    // nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
    if (isnan(depth)) depth = 0.f;
    else if (isinf(depth)) depth = copysignf(3.402823466e38f, depth);
    depth_out[ray] = depth;
  }
}

}  // namespace

// dens, dts, ts: (R, S) f32; rgbs: (R, S, 3) f32; all contiguous.
// Outputs: w, alpha (R, S); rgb (R, 3); acc, depth (R,).
extern "C" int gfnerf_composite_fwd(
    const float* dens, const float* dts, const float* ts, const float* rgbs,
    float* w, float* alpha, float* rgb, float* acc, float* depth,
    long long n_rays, long long n_samples, void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  const long long blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_fwd_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(
      dens, dts, ts, rgbs, w, alpha, rgb, acc, depth, n_rays, n_samples);
  return (int)cudaGetLastError();
}
