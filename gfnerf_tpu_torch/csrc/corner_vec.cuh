// The C channels of one table corner as one vector access: a load of C bf16
// values (the encodes H1 and H3 read a bf16 copy of the table), a load of C
// f32 values each rounded to bf16 in registers (H4 reads the f32 table and
// gets the values a bf16 copy would hold), and a reduction of C f32 values
// (the table gradients H2, H5 add into f32).
// A corner's channels are contiguous and aligned to their own size in every
// table layout of the port: (L, rows, W) packed rows with C-channel lattice
// entries, and (L, local, C) anchored tables.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gfnerf {

// An f32 value rounded to bf16 (to nearest, ties to even, as PyTorch's
// .to(torch.bfloat16) rounds) and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int C>
struct Corner;  // C values, loaded with one vector access

template <>
struct Corner<2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __bfloat162float(x.x);
    v[1] = __bfloat162float(x.y);
  }
  __device__ static void load(const float* p, float* v) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = round_bf16(x.x);
    v[1] = round_bf16(x.y);
  }
};

template <>
struct Corner<4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    v[0] = __bfloat162float(h[0].x);
    v[1] = __bfloat162float(h[0].y);
    v[2] = __bfloat162float(h[1].x);
    v[3] = __bfloat162float(h[1].y);
  }
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = round_bf16(x.x);
    v[1] = round_bf16(x.y);
    v[2] = round_bf16(x.z);
    v[3] = round_bf16(x.w);
  }
};

template <>
struct Corner<8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __bfloat162float(h[q].x);
      v[2 * q + 1] = __bfloat162float(h[q].y);
    }
  }
};

// One corner's C f32 channels, added with vector reductions: CUDA's
// atomicAdd(float2*, float2) and atomicAdd(float4*, float4) overloads for
// compute capability 9.x, whose result is unused (a reduction, RED, in the
// SASS).  kOps: reductions per corner.
template <int C>
struct CornerRed;

template <>
struct CornerRed<2> {
  static constexpr int kOps = 1;
  __device__ static void add(float* p, const float* v) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  }
};

template <>
struct CornerRed<4> {
  static constexpr int kOps = 1;
  __device__ static void add(float* p, const float* v) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct CornerRed<8> {
  static constexpr int kOps = 2;
  __device__ static void add(float* p, const float* v) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
    atomicAdd(reinterpret_cast<float4*>(p + 4),
              make_float4(v[4], v[5], v[6], v[7]));
  }
};

}  // namespace gfnerf
