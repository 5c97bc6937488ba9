// Small helpers shared by the kernels of this directory: element loads
// and casts, warp and block reductions, and the building blocks of the
// bf16 tensor-core products (mma.sync m16n8k16 fragments read from shared
// memory, cp.async copies into it, the store of a warp's accumulator
// rows), which quant_matmul.cu, paged_attention.cu and flash_attention.cu
// use.
//
// Element types are passed across the C interface as a code:
// 0 = float32, 1 = bfloat16, 2 = int8 (kDtypeF32 / kDtypeBF16 /
// kDtypeI8; int8 only for quantized operands: KV pools, weights). Every
// kernel loads its inputs into f32 registers, computes in f32, and
// rounds once when it stores a result in the input's type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ptt {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeI8 = 2;

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

// int8 codes: N consecutive values as f32 (exact), with the widest
// vector loads N allows (up to 16 bytes); p aligned to those loads.
template <int N>
__device__ __forceinline__ void load_f32(const int8_t* p, float* out) {
  constexpr int kVec = N % 16 == 0 ? 16 : (N % 8 == 0 ? 8 : (N % 4 == 0 ? 4 : 1));
#pragma unroll
  for (int i = 0; i < N / kVec; ++i) {
    if constexpr (kVec == 16) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 16; ++k) out[16 * i + k] = static_cast<float>(b[k]);
    } else if constexpr (kVec == 8) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) out[8 * i + k] = static_cast<float>(b[k]);
    } else if constexpr (kVec == 4) {
      const uint32_t v = reinterpret_cast<const uint32_t*>(p)[i];
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) out[4 * i + k] = static_cast<float>(b[k]);
    } else {
      out[i] = static_cast<float>(p[i]);
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------
// bf16 tensor-core products: mma.sync m16n8k16 (bf16 in, f32 accumulate)
//
// Fragment layouts (PTX ISA, mma.m16n8k16, per lane: g = lane / 4,
// t = lane % 4): A (16 x 16, row-major) a0 = (g, 2t..2t+1), a1 = (g + 8,
// 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..); B (16 x 8) b0 = (k
// 2t..2t+1, n g), b1 = (k 2t + 8.., n g); C (16 x 8, f32) c0, c1 = (g,
// 2t..2t+1), c2, c3 = (g + 8, 2t..). Two C tiles side by side, rounded to
// bf16 and packed in pairs, are an A fragment.
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx.ftz: a result below 2^-126 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// B fragments of the n-tiles n0 and n0 + 8 with B[k][n] = s[k0 + k][n0 + n]
// (B stored row-major): ldmatrix .trans of four 8x8 matrices, lane i
// addressing row i % 8 of matrix i / 8; r0, r1 = (b0, b1) of n-tile n0,
// r2, r3 = (b0, b1) of n-tile n0 + 8.
__device__ __forceinline__ void frag_b_trans(uint32_t (&r)[4], const bf16* s,
                                             int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p =
      s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major
// tile by one ldmatrix.x4 (tile rows 16-byte aligned): lane i addresses
// row i % 8 of matrix i / 8, matrices (r0, c0), (r0 + 8, c0), (r0, c0 + 8),
// (r0 + 8, c0 + 8) giving a0..a3.
__device__ __forceinline__ void frag_a_ldm(uint32_t (&a)[4], const bf16* s,
                                           int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const bf16* p =
      s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + (lane >> 4) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Row r0 + r of a dense (S, D) slice (row stride `stride`) from a warp's
// (16 x D) accumulator: rows g and g + 8 of the warp, times mul[0 or 1].
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, int64_t stride,
                                          float (*acc)[4], int r0,
                                          const float (&mul)[2], int seq) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= seq) continue;
    bf16* out = dst + row * stride + c;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * dn) =
          __floats2bfloat162_rn(acc[dn][2 * half] * mul[half],
                                acc[dn][2 * half + 1] * mul[half]);
  }
}

// Asynchronous copies global -> shared (cp.async): bytes past `valid`
// are zero-filled, and an invalid row reads nothing (its source address
// is only a placeholder inside the tensor).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace ptt
