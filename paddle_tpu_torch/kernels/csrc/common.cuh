// Small helpers shared by the kernels of this directory.
//
// Element types are passed across the C interface as a code:
// 0 = float32, 1 = bfloat16 (kDtypeF32 / kDtypeBF16). Every kernel
// loads its inputs into f32 registers, computes in f32, and rounds once
// when it stores a result in the input's type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Load N consecutive elements at p into f32 registers with the widest
// vector loads N allows (up to 16 bytes). p must be aligned to those
// loads: N elements' bytes, capped at 16.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  constexpr int kVec = N % 8 == 0 ? 8 : (N % 4 == 0 ? 4 : (N % 2 == 0 ? 2 : 1));
#pragma unroll
  for (int i = 0; i < N / kVec; ++i) {
    if constexpr (kVec == 8) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        out[8 * i + 2 * k] = f.x;
        out[8 * i + 2 * k + 1] = f.y;
      }
    } else if constexpr (kVec == 4) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        out[4 * i + 2 * k] = f.x;
        out[4 * i + 2 * k + 1] = f.y;
      }
    } else if constexpr (kVec == 2) {
      const float2 f =
          __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    } else {
      out[i] = __bfloat162float(p[i]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread gets the total. `scratch`
// holds one float per warp. Must be reached by every thread.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < n_warps; ++i) total += scratch[i];
  __syncthreads();  // scratch may be reused by the caller
  return total;
}

}  // namespace ptt
