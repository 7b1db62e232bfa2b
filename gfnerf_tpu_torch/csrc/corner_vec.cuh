// The C channels of one table corner as one vector access: a load of C bf16
// values (the encodes H1 and H3 read a bf16 copy of the table), and a load
// of C f32 values each rounded to bf16 in registers (H4 reads the f32 table
// and gets the values a bf16 copy would hold).
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

}  // namespace gfnerf
