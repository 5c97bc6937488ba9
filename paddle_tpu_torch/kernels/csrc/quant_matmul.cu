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
// Two kernels, one for each side of the line at which an H100 stops being
// limited by memory (~295 operations per byte):
//
// - Small M (decode, M = 8): bytes. A step reads each weight byte once and
//   does 2 * 8 = 16 operations per byte, so its floor is the int8 weight
//   bytes / 3.35 TB/s, half the bf16 layer's. w8a16_kernel: a block
//   computes a 16 x 128 tile of out over its range of K in k-tiles of 64,
//   x's and qw's tiles streamed into shared memory by cp.async (3 stages,
//   16-byte chunks), each landed qw tile converted once to a bf16 tile,
//   mma.sync m16n8k16 over 8 warps. The 8..1002 output tiles of a decode
//   product cannot fill 132 SMs, so K is split over gridDim.z: each split
//   writes its f32 partial tile to a workspace, and w8a16_reduce sums the
//   splits in a fixed order, applies the scale and casts (no atomics). One
//   split applies the scale in the tile kernel's own epilogue. Rows past M
//   and k-tiles past K load as zeros, columns past N are not stored.
//
// - Large M (prefill, M in the thousands): operations, 2MNK at 989 TF/s,
//   reached only through wgmma. w8a16_wgmma_kernel computes out^T = qw^T x^T,
//   so that the converted weights are wgmma's A operand in registers and x its
//   B operand in shared memory (the design of CUTLASS's mixed-input kernels).
//   A block computes 256 rows x 128 columns of out, or 128 rows where 256-row
//   tiles would leave the card idle (the wrapper's plan); the tiles go in
//   groups of 8 row tiles, so the x rows and weight columns that the blocks in
//   flight share stay in L2. 384 threads: warpgroup 0 is the producer, of
//   which one thread issues TMA loads of x's 256 (or 128) x 64 bf16 tile and
//   qw's 64 x 128 int8 tile, both 128-byte swizzled, into a 5-stage ring
//   signalled by mbarriers (full: bytes landed; empty: both consumers done
//   with the stage). Warpgroups 1 and 2 are the consumers, 64 weight columns
//   each, 128 (64) f32 accumulators a thread (setmaxnreg moves registers from
//   the producer to them). The int8 -> bf16 conversion is off the k-loop's
//   critical path: a consumer issues the asynchronous m64n256k16 (m64n128k16)
//   wgmma of one k16 step from one set of A registers and, while the tensor
//   cores run it, converts the next step's fragment into the other set.
//   ldmatrix .trans of the int8 tile's byte pairs hands each lane the two
//   columns 2g, 2g + 1 at k 2t, 2t + 1, so a fragment row holds one weight
//   column (row g: column 2g, row g + 8: 2g + 1) and the epilogue stores
//   column pairs, 32 bytes a row of a warp's store. No block-wide barrier in
//   the loop: the ring advances by mbarrier phase. The conversion is exact and
//   cheap: 4 bytes biased by 128 are permuted into the mantissas of the float
//   2^23 (prmt), the bias and 2^23 subtracted, and the exact integers' upper
//   halves packed as bf16 pairs (prmt), 11 instructions for 4 values. Ragged
//   M, K and N arrive as zeros by TMA's bound fill; the epilogue masks rows
//   past M and columns past N, applies scale[n] and casts. No split-K and no
//   atomics: a repeat is bit-equal. x must be bf16 (the wrapper rounds f32 x
//   first, the same round-to-nearest-even).
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
// rounded to bf16 (the mma.sync A layout of common.cuh)
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
  return cudaErrorInvalidValue;
}

// ---- the large-M kernel: wgmma, TMA, warp-specialised --------------------

namespace wg {

// The tile is 128 columns of out (the wgmma's M: weight columns) by BM
// rows of out (its N: rows of x, 256 or 128); the product computed is
// out^T.
constexpr int BN = 128, BK = 64;
constexpr int kStages = 5;               // x and int8 ring
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr uint32_t kWBytes = BK * BN;
constexpr int kGroupM = 8;               // row tiles per raster group

template <int BM>
struct Tile {
  static constexpr uint32_t kXBytes = BM * BK * 2;
  static constexpr size_t kSmem = kStages * (kXBytes + kWBytes) +
                                  2 * kStages * sizeof(uint64_t) +
                                  1024;  // room to align the base to 1024
};

// one k16 step of a consumer warpgroup: 64 weight columns x BM x rows
template <int BM>
__device__ __forceinline__ void mma_step(float (&acc)[BM / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_x) {
  if constexpr (BM == 256)
    ptt::sm90::wgmma_m64n256k16_rs<0>(acc, a, desc_x, 1);
  else
    ptt::sm90::wgmma_m64n128k16_rs<0>(acc, a, desc_x, 1);
}

// int8 bytes (b0, b1, b2, b3) -> bf16 pairs lo = (b0, b2), hi = (b1, b3),
// exact: each byte, biased by 128, goes into the low mantissa byte of the
// float 2^23, then 2^23 + 128 is subtracted; the integers' upper halves
// are their bf16 values.
__device__ __forceinline__ void i8x4_to_bf16x2x2(uint32_t w, uint32_t& lo,
                                                 uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;       // 2^23
  const float f0 = __uint_as_float(__byte_perm(u, kMagic, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, kMagic, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, kMagic, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, kMagic, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  hi = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// The A fragment (bf16) of k16 step s16 of a landed int8 k-tile `src` for
// a warp's 16 weight columns (16-byte chunk `chunk` of the tile's 128-byte
// rows): ldmatrix .trans of byte pairs gives lane (g, t) the columns 2g,
// 2g + 1 at k 2t, 2t + 1 of each 8-row block, so fragment row g holds
// column 2g and row g + 8 column 2g + 1.
__device__ __forceinline__ void load_frag(const unsigned char* src, int s16,
                                          int chunk, int lane,
                                          uint32_t (&f)[4]) {
  const int k = 16 * s16 + (lane & 15);  // lane i: row i % 8 of matrix i / 8
  uint32_t w0, w1;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(w0), "=r"(w1)
      : "r"(ptt::sm90::smem_u32(src + k * BN + ((chunk ^ (k & 7)) << 4))));
  i8x4_to_bf16x2x2(w0, f[0], f[1]);
  i8x4_to_bf16x2x2(w1, f[2], f[3]);
}

// Out tile (m0.., n0..): see the source note at the top. tx: x (M, K)
// bf16 in boxes of BM x BK; tw: qw (K, N) int8 in boxes of BK x BN.
template <typename TO, int BM>
__global__ void __launch_bounds__(kThreads, 1) w8a16_wgmma_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw, const float* __restrict__ scale,
    TO* __restrict__ out, int M, int K, int N) {
  namespace h = ptt::sm90;
  constexpr uint32_t kXBytes = Tile<BM>::kXBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs =
      smem_raw + ((1024 - (h::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ws = xs + kStages * kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kStages * kWBytes);
  uint64_t* empty = full + kStages;

  const int m_tiles = cdiv(M, BM), n_tiles = cdiv(N, BN);
  const int per_group = kGroupM * n_tiles;
  const int first_m = static_cast<int>(blockIdx.x) / per_group * kGroupM;
  const int gm = min(m_tiles - first_m, kGroupM);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % gm) * BM;
  const int n0 = in_group / gm * BN;
  const int nk = cdiv(K, BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], 8);       // lane 0 of each consumer warp
    }
    h::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    h::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages, use = kt / kStages;
        if (use > 0) h::mbar_wait(&empty[s], (use - 1) & 1);
        h::mbar_arrive_expect_tx(&full[s], kXBytes + kWBytes);
        h::tma_load_2d(xs + s * kXBytes, &tx, &full[s], kt * BK, m0);
        h::tma_load_2d(ws + s * kWBytes, &tw, &full[s], n0, kt * BK);
      }
    }
  } else {
    h::setmaxnreg_inc<232>();
    const int ct = threadIdx.x - 128;   // 0..255
    const int cw = ct >> 7;             // consumer warpgroup: columns 64 cw..
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int chunk = 4 * cw + warp;    // the warp's 16 columns of the tile

    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    // two sets of A registers: one k16 step's product reads one while the
    // next step's fragment is converted into the other (a wgmma reads its
    // A registers late, so a set is rewritten only after a wait shows its
    // product done; 128 accumulators and 8 A registers fit the budget
    // without spills or serialised wgmmas)
    uint32_t a[2][4];
    h::mbar_wait(&full[0], 0);
    load_frag(ws, 0, chunk, lane, a[0]);
    for (int kt = 0; kt < nk; ++kt) {
      const uint32_t xb = h::smem_u32(xs + (kt % kStages) * kXBytes);
      const unsigned char* wt = ws + (kt % kStages) * kWBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int p = kk & 1;
        h::fence_operands(acc);
        h::wgmma_fence();
        mma_step<BM>(acc, a[p], h::desc_sw128(xb + 32 * kk, 16, 1024));
        h::wgmma_commit();
        h::fence_operands(acc);
        h::wgmma_wait<1>();             // the previous step's product is done
        h::fence_operands(acc);
        h::fence_operands(a[p ^ 1]);
        if (kk == 0 && kt > 0) {        // so is k-tile kt - 1's last
          __syncwarp();
          if (lane == 0) h::mbar_arrive(&empty[(kt - 1) % kStages]);
        }
        if (kk + 1 < BK / 16) {         // overlaps this step's product
          load_frag(wt, kk + 1, chunk, lane, a[p ^ 1]);
        } else if (kt + 1 < nk) {
          h::mbar_wait(&full[(kt + 1) % kStages], ((kt + 1) / kStages) & 1);
          load_frag(ws + ((kt + 1) % kStages) * kWBytes, 0, chunk, lane,
                    a[p ^ 1]);
        }
      }
    }
    h::wgmma_wait<0>();
    h::fence_operands(acc);

    // epilogue: accumulator d[4 j + 2 v + u] is (weight column 2g + v of
    // the warp's 16, x row 8 j + 2 t + u): each store writes a column pair
    const int g = lane >> 2, t = lane & 3;
    const int col = n0 + 16 * chunk + 2 * g;
    if (col < N) {                      // N is even, so col + 1 < N too
      const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = m0 + 8 * j + 2 * t + u;
          if (row < M)
            store2<TO>(out + static_cast<int64_t>(row) * N + col,
                       acc[4 * j + u] * s0, acc[4 * j + 2 + u] * s1);
        }
    }
  }
}

template <typename TO, int BM>
cudaError_t launch_wgmma_tile(const void* x, const void* qw,
                              const float* scale, void* out, int M, int K,
                              int N, cudaStream_t stream) {
  CUtensorMap tx, tw;
  cudaError_t err = ptt::encode_tmap_2d(
      &tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, uint64_t(K) * 2, BM, BK);
  if (err != cudaSuccess) return err;
  err = ptt::encode_tmap_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw, K, N, N,
                            BK, BN);
  if (err != cudaSuccess) return err;
  auto kern = w8a16_wgmma_kernel<TO, BM>;
  constexpr size_t kSmem = Tile<BM>::kSmem;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kSmem));
  if (err != cudaSuccess) return err;
  const int64_t tiles = int64_t(cdiv(M, BM)) * cdiv(N, BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(tiles), kThreads, kSmem, stream>>>(
      tx, tw, scale, static_cast<TO*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_wgmma(const void* x, const void* qw, const float* scale,
                         void* out, int M, int K, int N, int bm,
                         cudaStream_t stream) {
  if (bm == 256)
    return launch_wgmma_tile<TO, 256>(x, qw, scale, out, M, K, N, stream);
  if (bm == 128)
    return launch_wgmma_tile<TO, 128>(x, qw, scale, out, M, K, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

// Shape limits (checked again by the Python wrapper): M, K, N >= 1,
// K % 8 == 0, N % 16 == 0, bm == 16, 1 <= splits <= ceil(K / 64)
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


// The large-M kernel, bm (rows of x a tile) 256 or 128. Shape limits
// (checked again by the Python wrapper): M, K, N >= 1, K % 8 == 0 and
// N % 16 == 0 (TMA's 16-byte row strides). x (M, K) bf16 and out (M, N)
// contiguous, qw (K, N) int8 contiguous, x and qw 16-byte aligned. out
// f32 or bf16. Returns a cudaError_t code.
extern "C" int ptt_w8a16_matmul_wgmma(const void* x, const void* qw,
                                      const void* scale, void* out, int M,
                                      int K, int N, int bm, int out_dtype,
                                      void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(qw) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto sc = static_cast<const float*>(scale);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_dtype == ptt::kDtypeBF16)
    err = wg::launch_wgmma<bf16>(x, qw, sc, out, M, K, N, bm, s);
  else if (out_dtype == ptt::kDtypeF32)
    err = wg::launch_wgmma<float>(x, qw, sc, out, M, K, N, bm, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
