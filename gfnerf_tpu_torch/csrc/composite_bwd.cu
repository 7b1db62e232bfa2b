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
//
// Two kernels:
// - Rays of up to 512 samples (the train step's 384 and 192): the ray held
//   in registers (composite_bwd_ray_kernel). Row j is samples [32j, 32j +
//   32); lane l holds sample 32j + l of each of its warp's rows; a warp
//   holds up to 6 rows and a ray takes 1, 2 or 4 warps of one block (S =
//   192: one warp of 6 rows; S = 384: two). All of a warp's loads are
//   issued up front: each input is read from device memory once, every
//   access of the warp is 128 contiguous bytes (rgb and its gradient move
//   as each row's 96 contiguous floats, regrouped per sample with
//   shuffles), and a warp has all its bytes in flight at once. The prefix
//   of sigma dt is a warp scan per row with the earlier rows carried (the
//   ray's earlier warps' totals through shared memory), the suffix of -w gw
//   a reverse warp scan per row with the later rows carried, so the
//   exclusive suffix is a sum of the later terms only: never a total minus
//   a prefix, which cancels once T is small. The rows' scans do not depend
//   on each other and overlap. The cotangent terms that need no ray sum
//   (g_w + g_rgb . c + g_acc) are formed as rgb arrives, so rgb does not
//   stay live.
// - Longer rays (or any, on request): the tiled kernel
//   (composite_bwd_tiled_kernel), one warp per ray walking S in 32-sample
//   tiles twice, pass 1 keeping each tile's prefix in shared memory, pass 2
//   walking the tiles in reverse and recomputing each tile's w and T
//   exactly as pass 1 did. Each tile's loads wait for the previous tile's
//   scan, so little is in flight.
// With one warp a ray the two add in the same order; against the plain
// version, whose cumulative sums run in another order, both agree to f32
// rounding.

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

// A barrier of the wpr warps that hold one ray (named barrier 1 + the
// ray's slot in the block, of 32 wpr threads); none when a warp holds the
// whole ray. wpr is the same for every warp of a launch.
__device__ __forceinline__ void ray_sync(int warp, int wpr) {
  if (wpr > 1)
    asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / wpr), "r"(32 * wpr)
                 : "memory");
}

__global__ void composite_bwd_tiled_kernel(
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

// ---- the ray in registers ----

// A ray of S <= 32 K wpr samples held in the registers of wpr (1, 2 or 4)
// warps of one block, K rows of 32 samples a warp: warp q of the ray holds
// rows [qK, qK + K), row j is samples [32j, 32j + 32), and lane l holds
// sample 32j + l of each of its rows, so each load and store of a (R, S)
// array is 128 contiguous bytes a warp. rgb and its gradient, (R, S, 3),
// move as each row's 96 contiguous floats, three 128-byte accesses a row,
// regrouped per sample with shuffles. The prefix of sigma dt is a warp scan
// per row, the rows before it in the warp carried, then the totals of the
// ray's earlier warps (through shared memory); the suffix of -w gw runs the
// same way in reverse. The K rows' scans are independent, so they overlap.
// The warps of a ray meet at named barriers of their own; every one of them
// reaches each barrier (a warp past the last ray holds no samples).
template <int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    composite_bwd_ray_kernel(
        const float* __restrict__ dens, const float* __restrict__ dts,
        const float* __restrict__ ts, const float* __restrict__ rgbs,
        const float* __restrict__ gw, const float* __restrict__ ga,
        const float* __restrict__ grgb, const float* __restrict__ gacc,
        const float* __restrict__ gdepth, float* __restrict__ g_dens,
        float* __restrict__ g_dts, float* __restrict__ g_ts,
        float* __restrict__ g_rgbs, long long n_rays, int n_samples,
        int wpr) {
  __shared__ float s_dd[kWarpsPerBlock], s_sw[kWarpsPerBlock],
      s_swt[kWarpsPerBlock], s_ex[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = warp % wpr;     // this warp's part of its ray
  const int first = warp - q;   // the ray's first warp in the block
  const long long ray =
      (long long)blockIdx.x * (kWarpsPerBlock / wpr) + warp / wpr;
  const bool live = ray < n_rays;
  const int n_ray = live ? n_samples : 0;  // samples of this warp's ray
  const int s0 = 32 * K * q;               // its first sample
  const size_t base = live ? (size_t)ray * (size_t)n_samples : 0;
  const int n_flat = 3 * n_ray;  // rgb floats of the ray
  const float gr = live && grgb ? grgb[3 * ray + 0] : 0.f;
  const float gg = live && grgb ? grgb[3 * ray + 1] : 0.f;
  const float gb = live && grgb ? grgb[3 * ray + 2] : 0.f;
  const float g_acc = live && gacc ? gacc[ray] : 0.f;
  const float g_depth = live && gdepth ? gdepth[ray] : 0.f;

  // every load of the warp, up front, evict-first (each is read once)
  float sig[K], dt[K], part[K], t[K], g_al[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = s0 + 32 * j + lane;
    const bool in = s < n_ray;
    sig[j] = in ? __ldcs(dens + base + s) : 0.f;
    dt[j] = in ? __ldcs(dts + base + s) : 0.f;
    part[j] = in && gw ? __ldcs(gw + base + s) : 0.f;
    if (gdepth) t[j] = in ? __ldcs(ts + base + s) : 0.f;
    if (ga) g_al[j] = in ? __ldcs(ga + base + s) : 0.f;
  }
  if (grgb) {
    float c[K][3];  // row j's rgb floats 96j + 32k + lane
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int m = 3 * s0 + 96 * j + 32 * k + lane;
        c[j][k] = m < n_flat ? __ldcs(rgbs + 3 * base + m) : 0.f;
      }
    }
    // sample 32j + l's channel ch is row float 3l + ch: lane (3l + ch) % 32,
    // access (3l + ch) / 32. The terms of gw that need no sum over the ray,
    // in the order the tiled kernel adds them.
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float col[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int f = 3 * lane + ch;
        const float v0 = __shfl_sync(kFull, c[j][0], f & 31);
        const float v1 = __shfl_sync(kFull, c[j][1], f & 31);
        const float v2 = __shfl_sync(kFull, c[j][2], f & 31);
        col[ch] = f < 32 ? v0 : (f < 64 ? v1 : v2);
      }
      part[j] = part[j] + gr * col[0] + gg * col[1] + gb * col[2];
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) part[j] = part[j] + g_acc;

  // prefix of sigma dt: the K rows' warp scans, the warp's rows carried,
  // then the ray's earlier warps' totals
  float excl[K];
#pragma unroll
  for (int j = 0; j < K; ++j) excl[j] = sig[j] * dt[j];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float u = __shfl_up_sync(kFull, excl[j], off);
      if (lane >= off) excl[j] += u;
    }
  }
  float carry = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float incl = excl[j];
    const float before = __shfl_up_sync(kFull, incl, 1);
    excl[j] = carry + (lane == 0 ? 0.f : before);
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) s_dd[warp] = carry;
  ray_sync(warp, wpr);
  float earlier = 0.f;  // the ray's earlier warps, in order
  for (int p = first; p < warp; ++p) earlier += s_dd[p];
  float sw = 0.f, swt = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    excl[j] = earlier + excl[j];
    if (s0 + 32 * j + lane < n_ray) {
      const float dd = sig[j] * dt[j];
      float w = (1.f - expf(-dd)) * expf(-excl[j]);
      if (isnan(w)) w = 0.f;
      sw += w;
      if (gdepth) swt += w * t[j];
    }
  }
  sw = warp_sum(sw);
  swt = warp_sum(swt);
  if (lane == 0) {
    s_sw[warp] = sw;
    s_swt[warp] = swt;
  }
  ray_sync(warp, wpr);
  sw = 0.f;
  swt = 0.f;
  for (int p = first; p < first + wpr; ++p) {
    sw += s_sw[p];
    swt += s_swt[p];
  }
  const float a_eps = sw + 1e-10f;
  const float depth = swt / a_eps;

  // suffix of -w gw: the K rows' warp scans in reverse, the warp's later
  // rows carried, then the ray's later warps' totals
  float w[K], g_dd[K], sfx[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float dd = sig[j] * dt[j];
    const float keep = expf(-dd);  // 1 - alpha = d alpha / d dd
    const float trans = expf(-excl[j]);
    w[j] = (1.f - keep) * trans;
    if (isnan(w[j])) w[j] = 0.f;
    sfx[j] = 0.f;
    g_dd[j] = 0.f;
    if (s0 + 32 * j + lane < n_ray) {
      const float g_t_term =
          gdepth ? g_depth * (t[j] - depth) / a_eps : 0.f;
      const float gw_tot = part[j] + g_t_term;
      const float g_alpha = (ga ? g_al[j] : 0.f) + gw_tot * trans;
      sfx[j] = -w[j] * gw_tot;
      g_dd[j] = g_alpha * keep;
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float u = __shfl_down_sync(kFull, sfx[j], off);
      if (lane + off < 32) sfx[j] += u;
    }
  }
  float later_rows = 0.f;
  float later[K];
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const float after = __shfl_down_sync(kFull, sfx[j], 1);
    later[j] = later_rows + (lane == 31 ? 0.f : after);
    later_rows += __shfl_sync(kFull, sfx[j], 0);
  }
  if (lane == 0) s_ex[warp] = later_rows;
  ray_sync(warp, wpr);
  float after_warps = 0.f;  // the ray's later warps, from the last back
  for (int p = first + wpr - 1; p > warp; --p) after_warps += s_ex[p];
#pragma unroll
  for (int j = 0; j < K; ++j) g_dd[j] += after_warps + later[j];

  // the outputs, evict-first
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = s0 + 32 * j + lane;
    if (s < n_ray) {
      if (g_dens) __stcs(g_dens + base + s, g_dd[j] * dt[j]);
      if (g_dts) __stcs(g_dts + base + s, g_dd[j] * sig[j]);
      if (g_ts) __stcs(g_ts + base + s, g_depth * w[j] / a_eps);
    }
  }
  if (g_rgbs) {
    // row float 32k + l is channel (32k + l) % 3 of the row's sample
    // (32k + l) / 3
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int f = 32 * k + lane;
        const float wf = __shfl_sync(kFull, w[j], f / 3);
        const int m = 3 * s0 + 96 * j + f;
        const int ch = f % 3;
        if (m < n_flat)
          __stcs(g_rgbs + 3 * base + m,
                 (ch == 0 ? gr : (ch == 1 ? gg : gb)) * wf);
      }
    }
  }
}

struct Args {
  const float *dens, *dts, *ts, *rgbs, *gw, *ga, *grgb, *gacc, *gdepth;
  float *g_dens, *g_dts, *g_ts, *g_rgbs;
};

template <int K>
int launch_ray(const Args& a, long long n_rays, int n_samples, int wpr,
               cudaStream_t stream) {
  const int rays_per_block = kWarpsPerBlock / wpr;
  const long long blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  composite_bwd_ray_kernel<K><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                                stream>>>(
      a.dens, a.dts, a.ts, a.rgbs, a.gw, a.ga, a.grgb, a.gacc, a.gdepth,
      a.g_dens, a.g_dts, a.g_ts, a.g_rgbs, n_rays, n_samples, wpr);
  return (int)cudaGetLastError();
}

// Rows of 32 samples a warp holds at most. On the H100 at R = 8192, S =
// 384 in the train step's form, 3 rows in each of 4 warps ran faster than 6
// in each of 2, and those faster than 12 in one warp: a warp that holds
// fewer rows needs fewer registers, so more warps, and more bytes, are in
// flight on each SM.
constexpr int kMaxRows = 4;

// The register kernel's split of a ray of n_samples <= 512: the fewest
// warps (1, 2 or 4) that hold it at up to kMaxRows rows a warp, and the
// rows a warp holds (K: 1, 2, 3, 4 or 6).
struct RaySplit {
  int wpr, k;
};

RaySplit ray_split(long long n_samples) {
  const int ks[] = {1, 2, 3, 4, 6};
  for (int wpr = 1; wpr <= 4; wpr *= 2)
    for (int k : ks)
      if (k <= kMaxRows && 32LL * k * wpr >= n_samples) return {wpr, k};
  return {0, 0};
}

int launch_tiled(const Args& a, long long n_rays, long long n_samples,
                 cudaStream_t stream) {
  const long long n_tiles = (n_samples + 31) / 32;
  const size_t smem = sizeof(float) * kWarpsPerBlock * (size_t)n_tiles;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_bwd_tiled_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
                               stream>>>(
      a.dens, a.dts, a.ts, a.rgbs, a.gw, a.ga, a.grgb, a.gacc, a.gdepth,
      a.g_dens, a.g_dts, a.g_ts, a.g_rgbs, n_rays, n_samples);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs as the forward's: dens, dts, ts (R, S) and rgbs (R, S, 3) f32.
// Cotangents, each may be null (zero): gw, ga (R, S); grgb (R, 3); gacc,
// gdepth (R,). Outputs, each may be null (not written): g_dens, g_dts, g_ts
// (R, S); g_rgbs (R, S, 3). All contiguous f32. tiled: 0 takes the register
// kernel for S <= 512 and the tiled one above; 1 takes the tiled kernel at
// any S (to time it against the register kernel). The tiled kernel keeps
// ceil(S/32) floats per warp in shared memory: S above 49152 returns
// cudaErrorInvalidValue without launching.
extern "C" int gfnerf_composite_bwd(
    const float* dens, const float* dts, const float* ts, const float* rgbs,
    const float* gw, const float* ga, const float* grgb, const float* gacc,
    const float* gdepth, float* g_dens, float* g_dts, float* g_ts,
    float* g_rgbs, long long n_rays, long long n_samples, int tiled,
    void* stream) {
  if (n_rays <= 0 || n_samples <= 0) return (int)cudaGetLastError();
  const Args a = {dens, dts,  ts,     rgbs,  gw,   ga,    grgb,
                  gacc, gdepth, g_dens, g_dts, g_ts, g_rgbs};
  cudaStream_t s = (cudaStream_t)stream;
  const RaySplit split =
      tiled || n_samples > 512 ? RaySplit{0, 0} : ray_split(n_samples);
  const int ns = (int)n_samples;
  const int wpr = split.wpr;
  switch (split.k) {
    case 1: return launch_ray<1>(a, n_rays, ns, wpr, s);
    case 2: return launch_ray<2>(a, n_rays, ns, wpr, s);
    case 3: return launch_ray<3>(a, n_rays, ns, wpr, s);
    case 4: return launch_ray<4>(a, n_rays, ns, wpr, s);
    case 6: return launch_ray<6>(a, n_rays, ns, wpr, s);
    default: return launch_tiled(a, n_rays, n_samples, s);
  }
}
