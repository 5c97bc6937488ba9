// Fused RMSNorm(+residual add) and RoPE apply, forward only.
//
// ---------------------------------------------------------------------
// RMSNorm + residual
// Replaces: paddle_tpu/kernels/fused_norm.py:_rmsn_fwd_kernel and
// _rmsn_fwd_kernel_nores (reached through _rmsn_fwd_pallas).
//
// Bound on this card: bytes. Per row it must read x (and the residual)
// and write y (and h = x + residual): 3 or 2 row passes of d elements
// with the weight row shared; a handful of flops per element.
//
// Design: one block per row. The block reads x (+ residual) once, rounds
// h = x + residual to the input type (the JAX op adds in that type) and
// writes it, keeps h in shared memory as f32, reduces the f32 mean
// square across the block, then writes y = h * rsqrt(ms + eps) * w
// rounded once to the input type from the shared copy, so x and the
// residual are read exactly once. No rstd output: serving needs none.
// Limit: d * 4 bytes of shared memory, d <= 12032.
//
// ---------------------------------------------------------------------
// RoPE (NeoX / Llama half-split rotation)
// Replaces: paddle_tpu/kernels/fused_norm.py:_rope_kernel (reached
// through _rope_pallas).
//
// Bound on this card: bytes of x read and written, plus the two
// (rows, d) f32 tables; two multiplies and one add per element.
//
// Design: one thread per output element of x (rows, heads, d):
// out[c] = x[c] * cos_f[c] + x[(c + d/2) % d] * sin_f[c] with the
// sign-folded sin table, f32 math rounded once to x's type. The partner
// element sits in the same head row, so the second read hits the cache
// line the neighbouring thread loaded. The products and the sum are
// rounded separately (no fused multiply-add), as the plain version
// computes them.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kNormThreads = 256;
constexpr int kMaxNormD = 12032;  // d * 4 B + scratch within 48 KB
constexpr int kRopeThreads = 256;

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kNormThreads) rms_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const T* __restrict__ w, T* __restrict__ y, T* __restrict__ h, int d,
    float eps) {
  extern __shared__ float row[];  // (d,) h as f32
  __shared__ float scratch[32];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float hv;
    if (kResidual) {
      const T hs = ptt::from_f32<T>(ptt::to_f32(x[off + c]) +
                                    ptt::to_f32(res[off + c]));
      h[off + c] = hs;
      hv = ptt::to_f32(hs);
    } else {
      hv = ptt::to_f32(x[off + c]);
    }
    row[c] = hv;
    ss += hv * hv;
  }
  ss = ptt::block_sum(ss, scratch);
  const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    y[off + c] = ptt::from_f32<T>(
        __fmul_rn(__fmul_rn(row[c], rstd), ptt::to_f32(w[c])));
}

template <typename T>
cudaError_t launch_norm(const void* x, const void* res, const void* w,
                        void* y, void* h, int n, int d, float eps,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * d;
  if (res != nullptr)
    rms_norm_kernel<T, true><<<n, kNormThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<const T*>(w), static_cast<T*>(y), static_cast<T*>(h), d,
        eps);
  else
    rms_norm_kernel<T, false><<<n, kNormThreads, smem, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<const T*>(w),
        static_cast<T*>(y), nullptr, d, eps);
  return cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kRopeThreads) rope_kernel(
    const T* __restrict__ x, const float* __restrict__ cos_f,
    const float* __restrict__ sin_f, T* __restrict__ out, int64_t total,
    int heads, int d) {
  const int half = d / 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int c = static_cast<int>(i % d);
    const int64_t n = i / d / heads;  // token row of the tables
    const int partner = c < half ? c + half : c - half;
    const float xv = ptt::to_f32(x[i]);
    const float xr = ptt::to_f32(x[i - c + partner]);
    const int64_t t = n * d + c;
    out[i] = ptt::from_f32<T>(
        __fadd_rn(__fmul_rn(xv, cos_f[t]), __fmul_rn(xr, sin_f[t])));
  }
}

}  // namespace

// y (and h when residual != null) for n rows of width d. x, residual,
// weight, y and h all have one type (dtype): the model keeps its norm
// weights in the residual stream's type.
extern "C" int ptt_rms_norm_residual(const void* x, const void* residual,
                                     const void* weight, void* y, void* h,
                                     int n, int d, float eps, int dtype,
                                     void* stream) {
  if (d <= 0 || d > kMaxNormD) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == ptt::kDtypeF32)
    err = launch_norm<float>(x, residual, weight, y, h, n, d, eps, s);
  else if (dtype == ptt::kDtypeBF16)
    err = launch_norm<__nv_bfloat16>(x, residual, weight, y, h, n, d, eps,
                                     s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// out = rope(x) for x (n, heads, d) with f32 tables cos_f, sin_f (n, d).
extern "C" int ptt_rope_apply(const void* x, const void* cos_f,
                              const void* sin_f, void* out, int n, int heads,
                              int d, int x_dtype, void* stream) {
  if (d <= 0 || d % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n) * heads * d;
  if (total == 0) return 0;
  const int64_t want = (total + kRopeThreads - 1) / kRopeThreads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(cos_f);
  auto sn = static_cast<const float*>(sin_f);
  if (x_dtype == ptt::kDtypeF32)
    rope_kernel<float><<<blocks, kRopeThreads, 0, s>>>(
        static_cast<const float*>(x), c, sn, static_cast<float*>(out), total,
        heads, d);
  else if (x_dtype == ptt::kDtypeBF16)
    rope_kernel<__nv_bfloat16><<<blocks, kRopeThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), c, sn,
        static_cast<__nv_bfloat16*>(out), total, heads, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
