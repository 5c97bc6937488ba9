// Weight-only int8 matmul (W8A16) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/quant_matmul.py:_kernel (the pallas_call of
// weight_only_int8_matmul at :85).
//
// Function, for x (M, K) bf16 or f32, qw (K, N) int8 (the JAX package's
// layout: N contiguous) and scale (N,) f32 (the per-column weight scale
// already divided by the quant bound):
//   out[m, n] = T((sum_k bf16(x[m, k]) * bf16(qw[k, n])) * scale[n])
// the products exact in f32 and summed in f32, the scale applied once
// after the sum, T the output type (bf16 or f32). f32 x is rounded to bf16
// on load (round to nearest even, as `astype(bfloat16)`); every int8 value
// is exact in bf16.
//
// Bound on this card: bytes at small M, operations at large M. A decode
// step (M = 8) reads each weight byte once and does 2 * 8 = 16 operations
// per byte, far below the ~295 at which an H100 stops being limited by
// memory, so its floor is the int8 weight bytes / 3.35 TB/s (half of the
// bf16 layer's). Prefill (M in the thousands) is above that line: 2MNK
// tensor-core operations at 989 TF/s.
//
// Design. One tile kernel: a block computes a BM x 128 tile of out over
// its range of K in k-tiles of 64, with x's and qw's tiles streamed into
// shared memory by cp.async (3 stages, 16-byte chunks: 8 bf16, 4 f32 or
// 16 int8 values). Each landed qw tile is converted once, int8 -> bf16,
// into a bf16 (64 x 128) tile in shared memory, from which the B
// fragments come through ldmatrix .trans (qw is K-major for the product);
// A fragments come through ldmatrix (bf16 x) or are packed from f32 pairs
// with round-to-nearest-even (f32 x). mma.sync m16n8k16, f32 accumulators
// in registers, 8 warps.
// - BM = 128 (warps 2 x 4, 64 x 32 each) for prefill-sized M; BM = 16
//   (warps 1 x 8, 16 x 16 each) for small M, where a 128-row tile would
//   spend 16x the tensor-core work on rows that do not exist.
// - Few output tiles (decode: N = 1024 gives 8 tiles) cannot fill 132 SMs,
//   so K is split over gridDim.z: each split writes its f32 partial tile
//   to a workspace, and a second pass sums the splits in a fixed order,
//   applies the scale and casts (no atomics: the result is deterministic).
//   One split applies the scale in the tile kernel's own epilogue.
// - Ragged edges are masked: rows past M and k-tiles past K load as zeros
//   (a whole 16-byte chunk at a time, so K % 8 == 0 and N % 16 == 0), and
//   columns past N are not stored.
// Right and simple first: no wgmma, no TMA, no warp specialisation.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using ptt::bf16;

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int BN = 128, BK = 64;
constexpr int LDB = BN + 8;  // the converted bf16 B tile's row stride

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename TX, int BM>
struct Geo {
  static constexpr bool kF32 = std::is_same<TX, float>::value;
  // x stage rows padded by 16 bytes against bank conflicts
  static constexpr int LDX = kF32 ? BK + 4 : BK + 8;
  static constexpr int kXChunk = 16 / sizeof(TX);  // elements per cp.async
  static constexpr size_t x_stage = size_t(BM) * LDX * sizeof(TX);
  static constexpr size_t w_stage = size_t(BK) * BN;  // int8
  static constexpr size_t stage = x_stage + w_stage;
  static constexpr size_t b_tile = size_t(BK) * LDB * sizeof(bf16);
  static constexpr size_t bytes = kStages * stage + b_tile;
  static constexpr int WM = BM == 16 ? 1 : 2;  // warps along M
  static constexpr int WN = 8 / WM;
  static constexpr int MT = BM / WM / 16;      // m16 tiles per warp
  static constexpr int NT = BN / WN / 8;       // n8 tiles per warp
};

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The A fragment of rows r0.., columns c0.. of an f32 tile, each pair
// rounded to bf16 (the layout of ptt::frag_a)
__device__ __forceinline__ void frag_a_f32(uint32_t (&a)[4], const float* s,
                                           int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const float* p = s + (r0 + (lane >> 2)) * ld + c0 + 2 * (lane & 3);
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  a[0] = ptt::pack_bf16(v0.x, v0.y);
  a[1] = ptt::pack_bf16(v1.x, v1.y);
  a[2] = ptt::pack_bf16(v2.x, v2.y);
  a[3] = ptt::pack_bf16(v3.x, v3.y);
}

// Tile (blockIdx.y, blockIdx.x) of out over k-tiles [z * kps, (z + 1) * kps)
// for z = blockIdx.z. splits == 1: out = T(acc * scale); else the f32
// partial acc goes to ws[z] (M x N).
template <typename TX, typename TO, int BM>
__global__ void __launch_bounds__(kThreads) w8a16_kernel(
    const TX* __restrict__ x, const int8_t* __restrict__ qw,
    const float* __restrict__ scale, TO* __restrict__ out,
    float* __restrict__ ws, int M, int K, int N, int kps) {
  using G = Geo<TX, BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bt = reinterpret_cast<bf16*>(smem + kStages * G::stage);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = cdiv(K, BK);
  const int kt0 = blockIdx.z * kps;
  const int kt1 = min(nk, kt0 + kps);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / G::WN, wn = warp % G::WN;

  auto load = [&](int kt, int stage) {
    unsigned char* st = smem + stage * G::stage;
    TX* xs = reinterpret_cast<TX*>(st);
    int8_t* wsm = reinterpret_cast<int8_t*>(st + G::x_stage);
    const int k0 = kt * BK;
    constexpr int kXPerRow = BK / G::kXChunk;
    for (int c = threadIdx.x; c < BM * kXPerRow; c += kThreads) {
      const int r = c / kXPerRow, kk = (c % kXPerRow) * G::kXChunk;
      const bool ok = m0 + r < M && k0 + kk < K;
      const TX* s = ok ? x + static_cast<int64_t>(m0 + r) * K + k0 + kk : x;
      ptt::cp_async16(xs + r * G::LDX + kk, s, ok);
    }
    constexpr int kWPerRow = BN / 16;
    for (int c = threadIdx.x; c < BK * kWPerRow; c += kThreads) {
      const int r = c / kWPerRow, nn = (c % kWPerRow) * 16;
      const bool ok = k0 + r < K && n0 + nn < N;
      const int8_t* s =
          ok ? qw + static_cast<int64_t>(k0 + r) * N + n0 + nn : qw;
      ptt::cp_async16(wsm + r * BN + nn, s, ok);
    }
  };

  float acc[G::MT][G::NT][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (kt0 + s < kt1) load(kt0 + s, s);
    ptt::cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    ptt::cp_async_wait<kStages - 2>();
    __syncthreads();  // k-tile kt landed; every warp is done with kt - 1
    if (kt + kStages - 1 < kt1)
      load(kt + kStages - 1, (i + kStages - 1) % kStages);
    ptt::cp_async_commit();
    const unsigned char* st = smem + (i % kStages) * G::stage;
    const TX* xs = reinterpret_cast<const TX*>(st);
    const int8_t* wsm = reinterpret_cast<const int8_t*>(st + G::x_stage);
    // int8 -> bf16, 16 values a chunk, into the B tile
    for (int c = threadIdx.x; c < BK * (BN / 16); c += kThreads) {
      const int r = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(wsm + r * BN + nn);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = ptt::pack_bf16(static_cast<float>(b[2 * e]),
                              static_cast<float>(b[2 * e + 1]));
      uint4* dst = reinterpret_cast<uint4*>(bt + r * LDB + nn);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
    __syncthreads();  // the B tile is whole
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        const int r0 = wm * (BM / G::WM) + 16 * mt;
        if constexpr (G::kF32)
          frag_a_f32(af[mt], xs, G::LDX, r0, kk);
        else
          ptt::frag_a_ldm(af[mt], xs, G::LDX, r0, kk);
      }
#pragma unroll
      for (int j = 0; j < G::NT / 2; ++j) {
        uint32_t bf[4];
        ptt::frag_b_trans(bf, bt, LDB, kk, wn * (BN / G::WN) + 16 * j);
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          ptt::mma_bf16(acc[mt][2 * j], af[mt], bf[0], bf[1]);
          ptt::mma_bf16(acc[mt][2 * j + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  ptt::cp_async_wait<0>();

  // epilogue: C fragment rows g, g + 8 and columns 2t, 2t + 1 of each tile
  const int g = lane >> 2, t = lane & 3;
  const bool split = gridDim.z > 1;
  float* part = split ? ws + static_cast<int64_t>(blockIdx.z) * M * N
                      : nullptr;
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
    const int col = n0 + wn * (BN / G::WN) + 8 * nt + 2 * t;
    if (col >= N) continue;  // N is even, so col + 1 < N too
    float s0 = 1.f, s1 = 1.f;
    if (!split) {
      s0 = scale[col];
      s1 = scale[col + 1];
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * (BM / G::WM) + 16 * mt + g + 8 * half;
        if (row >= M) continue;
        const float a = acc[mt][nt][2 * half], b = acc[mt][nt][2 * half + 1];
        const int64_t o = static_cast<int64_t>(row) * N + col;
        if (split)
          store2<float>(part + o, a, b);
        else
          store2<TO>(out + o, a * s0, b * s1);
      }
  }
}

// The split-K pass: out = T((sum over splits in order) * scale), two
// columns a thread.
template <typename TO>
__global__ void __launch_bounds__(kThreads) w8a16_reduce(
    const float* __restrict__ ws, const float* __restrict__ scale,
    TO* __restrict__ out, int M, int N, int splits) {
  const int64_t pairs = static_cast<int64_t>(M) * N / 2;
  const int64_t stride = static_cast<int64_t>(M) * N;
  for (int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x; i < pairs;
       i += int64_t(gridDim.x) * kThreads) {
    const int64_t o = 2 * i;
    float a = 0.f, b = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float2 v = *reinterpret_cast<const float2*>(ws + z * stride + o);
      a += v.x;
      b += v.y;
    }
    const int col = static_cast<int>(o % N);
    store2<TO>(out + o, a * scale[col], b * scale[col + 1]);
  }
}

template <typename TX, typename TO, int BM>
cudaError_t launch_bm(const void* x, const int8_t* qw, const float* scale,
                      void* out, float* ws, int M, int K, int N, int splits,
                      cudaStream_t stream) {
  using G = Geo<TX, BM>;
  auto kern = w8a16_kernel<TX, TO, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::bytes));
  if (err != cudaSuccess) return err;
  const int nk = cdiv(K, BK);
  const int kps = cdiv(nk, splits);
  const dim3 grid(cdiv(N, BN), cdiv(M, BM), splits);
  kern<<<grid, kThreads, G::bytes, stream>>>(
      static_cast<const TX*>(x), qw, scale, static_cast<TO*>(out), ws, M, K,
      N, kps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t pairs = static_cast<int64_t>(M) * N / 2;
  const int blocks = static_cast<int>(
      std::min<int64_t>((pairs + kThreads - 1) / kThreads, 132 * 8));
  w8a16_reduce<TO><<<blocks, kThreads, 0, stream>>>(
      ws, scale, static_cast<TO*>(out), M, N, splits);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const int8_t* qw, const float* scale,
                   void* out, float* ws, int M, int K, int N, int bm,
                   int splits, cudaStream_t stream) {
  if (bm == 16)
    return launch_bm<TX, TO, 16>(x, qw, scale, out, ws, M, K, N, splits,
                                 stream);
  if (bm == 128)
    return launch_bm<TX, TO, 128>(x, qw, scale, out, ws, M, K, N, splits,
                                  stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shape limits (checked again by the Python wrapper): M, K, N >= 1,
// K % 8 == 0, N % 16 == 0, bm in {16, 128}, 1 <= splits <= ceil(K / 64)
// with every split non-empty (the wrapper picks splits so), ws holding
// splits * M * N floats when splits > 1. x (M, K) and out (M, N)
// contiguous, qw (K, N) contiguous, all 16-byte aligned. Types: x f32 or
// bf16, out f32 or bf16. Returns a cudaError_t code (0 = launched).
extern "C" int ptt_w8a16_matmul(const void* x, const void* qw,
                                const void* scale, void* out, void* ws,
                                int M, int K, int N, int bm, int splits,
                                int x_dtype, int out_dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0 ||
      splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nk = cdiv(K, BK);
  if (splits > nk || cdiv(nk, cdiv(nk, splits)) != splits)
    return static_cast<int>(cudaErrorInvalidValue);
  auto q = static_cast<const int8_t*>(qw);
  auto sc = static_cast<const float*>(scale);
  auto w = static_cast<float*>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  using ptt::kDtypeBF16;
  using ptt::kDtypeF32;
  cudaError_t err;
  if (x_dtype == kDtypeBF16 && out_dtype == kDtypeBF16)
    err = launch<bf16, bf16>(x, q, sc, out, w, M, K, N, bm, splits, s);
  else if (x_dtype == kDtypeBF16 && out_dtype == kDtypeF32)
    err = launch<bf16, float>(x, q, sc, out, w, M, K, N, bm, splits, s);
  else if (x_dtype == kDtypeF32 && out_dtype == kDtypeF32)
    err = launch<float, float>(x, q, sc, out, w, M, K, N, bm, splits, s);
  else if (x_dtype == kDtypeF32 && out_dtype == kDtypeBF16)
    err = launch<float, bf16>(x, q, sc, out, w, M, K, N, bm, splits, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
