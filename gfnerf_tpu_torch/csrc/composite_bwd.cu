// Fused volume-rendering composite, backward (K2).
//
// Replaces the Pallas TPU kernel gfnerf_tpu/ops/pallas/composite.py:112
// (_bwd_kernel, launched by _composite_bwd_pallas). Per ray it recomputes
// the forward (K1) chain
//   alpha_i = 1 - exp(-sigma_i dt_i),  T_i = exp(-sum_{j<i} sigma_j dt_j),
//   w_i = alpha_i T_i,  acc = sum w_i,  depth = sum w_i t_i / (acc + 1e-10)
// and folds the cotangents of (w, alpha, rgb, acc, depth) into
//   gw_i    = g_w_i + g_rgb . c_i + g_acc + g_depth (t_i - depth) / a_eps
//   g_dd_i  = (g_alpha_i + gw_i T_i) exp(-dd_i) + sum_{j>i} (-w_j gw_j)
//   g_sigma = g_dd dt ; g_dt = g_dd sigma ; g_t = g_depth w / a_eps ;
//   g_c_i   = g_rgb w_i
// Absent cotangents (null pointers) count as zero, and outputs given as null
// pointers are not written; t is not read when g_depth is absent. d alpha /
// d dd is exp(-dd) itself: the TPU kernel's 1 - alpha keeps no digits of it
// once alpha is near 1.
//
// Bound: memory. With every cotangent and output, each sample reads 24 bytes
// (sigma, dt, t, rgb) plus 8 of (g_w, g_alpha) and writes 24 (g_sigma, g_dt,
// g_t, g_rgb): about 176 MB at R = 8192, S = 384, 0.05 ms at the H100's
// 3.35 TB/s. The train step gives g_rgb alone and needs g_sigma and g_rgb:
// 20 bytes read and 16 written per sample, 113 MB, 0.034 ms.
// Design: one warp per ray, as K1. Pass 1 walks S in 32-sample tiles with a
// warp shuffle scan and a carried prefix, keeps each tile's starting prefix
// in shared memory, and sums acc and sum w t. Pass 2 walks the tiles in
// reverse, recomputes each tile's w and T exactly as pass 1 did from the
// stored prefix, and carries the suffix sum of -w gw from later tiles, so
// the exclusive suffix is a sum of the later terms only: never a total
// minus a prefix, which cancels once T is small. No power-of-two padding of
// S and no ray-count rule.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Inclusive warp prefix of v over lanes 0..lane.
__device__ __forceinline__ float warp_prefix(float v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Inclusive warp suffix of v over lanes lane..31.
__device__ __forceinline__ float warp_suffix(float v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += u;
  }
  return v;
}

__global__ void composite_bwd_kernel(
    const float* __restrict__ dens, const float* __restrict__ dts,
    const float* __restrict__ ts, const float* __restrict__ rgbs,
    const float* __restrict__ gw, const float* __restrict__ ga,
    const float* __restrict__ grgb, const float* __restrict__ gacc,
    const float* __restrict__ gdepth, float* __restrict__ g_dens,
    float* __restrict__ g_dts, float* __restrict__ g_ts,
    float* __restrict__ g_rgbs, long long n_rays, long long n_samples) {
  extern __shared__ float tile_prefix[];  // (kWarpsPerBlock, n_tiles)
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  const int lane = threadIdx.x & 31;
  if (ray >= n_rays) return;  // warp-uniform
  const long long n_tiles = (n_samples + 31) / 32;
  float* prefix = tile_prefix + warp * n_tiles;
  const size_t base = (size_t)ray * (size_t)n_samples;

  // pass 1: the forward chain, as K1 computes it
  float carry = 0.f;
  float sw = 0.f, swt = 0.f;
  for (long long k = 0; k < n_tiles; ++k) {
    const long long s = k * 32 + lane;
    const bool in = s < n_samples;
    const size_t i = base + (size_t)s;
    const float dd = in ? dens[i] * dts[i] : 0.f;
    const float incl = warp_prefix(dd, lane);
    const float before = __shfl_up_sync(kFull, incl, 1);
    const float excl = carry + (lane == 0 ? 0.f : before);
    if (lane == 0) prefix[k] = carry;
    carry += __shfl_sync(kFull, incl, 31);
    if (in) {
      float w = (1.f - expf(-dd)) * expf(-excl);
      if (isnan(w)) w = 0.f;
      sw += w;
      if (gdepth) swt += w * ts[i];
    }
  }
  sw = warp_sum(sw);
  swt = warp_sum(swt);
  const float a_eps = sw + 1e-10f;
  const float depth = swt / a_eps;
  const float gr = grgb ? grgb[3 * ray + 0] : 0.f;
  const float gg = grgb ? grgb[3 * ray + 1] : 0.f;
  const float gb = grgb ? grgb[3 * ray + 2] : 0.f;
  const float g_acc = gacc ? gacc[ray] : 0.f;
  const float g_depth = gdepth ? gdepth[ray] : 0.f;
  __syncwarp();

  // pass 2: reverse tiles with a carried suffix of -w * gw
  float suffix = 0.f;
  for (long long k = n_tiles - 1; k >= 0; --k) {
    const long long s = k * 32 + lane;
    const bool in = s < n_samples;
    const size_t i = base + (size_t)s;
    const float sigma = in ? dens[i] : 0.f;
    const float dt = in ? dts[i] : 0.f;
    const float dd = in ? sigma * dt : 0.f;
    const float incl = warp_prefix(dd, lane);
    const float before = __shfl_up_sync(kFull, incl, 1);
    const float excl = prefix[k] + (lane == 0 ? 0.f : before);
    const float keep = expf(-dd);  // 1 - alpha = d alpha / d dd
    const float alpha = 1.f - keep;
    const float trans = expf(-excl);
    float w = alpha * trans;
    if (isnan(w)) w = 0.f;
    float g_excl = 0.f, g_dd = 0.f;
    if (in) {
      const float g_t_term = gdepth ? g_depth * (ts[i] - depth) / a_eps : 0.f;
      const float gw_tot = (gw ? gw[i] : 0.f) + gr * rgbs[3 * i + 0] +
                           gg * rgbs[3 * i + 1] + gb * rgbs[3 * i + 2] +
                           g_acc + g_t_term;
      const float g_alpha = (ga ? ga[i] : 0.f) + gw_tot * trans;
      g_excl = -w * gw_tot;
      g_dd = g_alpha * keep;
    }
    const float sfx = warp_suffix(g_excl, lane);
    const float after = __shfl_down_sync(kFull, sfx, 1);
    const float later = suffix + (lane == 31 ? 0.f : after);
    suffix += __shfl_sync(kFull, sfx, 0);
    if (in) {
      g_dd += later;
      if (g_dens) g_dens[i] = g_dd * dt;
      if (g_dts) g_dts[i] = g_dd * sigma;
      if (g_ts) g_ts[i] = g_depth * w / a_eps;
      if (g_rgbs) {
        g_rgbs[3 * i + 0] = gr * w;
        g_rgbs[3 * i + 1] = gg * w;
        g_rgbs[3 * i + 2] = gb * w;
      }
    }
  }
}

}  // namespace

// Inputs as the forward's: dens, dts, ts (R, S) and rgbs (R, S, 3) f32.
// Cotangents, each may be null (zero): gw, ga (R, S); grgb (R, 3); gacc,
// gdepth (R,). Outputs, each may be null (not written): g_dens, g_dts, g_ts
// (R, S); g_rgbs (R, S, 3). All contiguous f32.
extern "C" int gfnerf_composite_bwd(
    const float* dens, const float* dts, const float* ts, const float* rgbs,
    const float* gw, const float* ga, const float* grgb, const float* gacc,
    const float* gdepth, float* g_dens, float* g_dts, float* g_ts,
    float* g_rgbs, long long n_rays, long long n_samples, void* stream) {
  if (n_rays <= 0 || n_samples <= 0) return (int)cudaGetLastError();
  const long long n_tiles = (n_samples + 31) / 32;
  const size_t smem = sizeof(float) * kWarpsPerBlock * (size_t)n_tiles;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_bwd_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
                         (cudaStream_t)stream>>>(
      dens, dts, ts, rgbs, gw, ga, grgb, gacc, gdepth, g_dens, g_dts, g_ts,
      g_rgbs, n_rays, n_samples);
  return (int)cudaGetLastError();
}
