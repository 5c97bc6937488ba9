// Blockwise cross-entropy: the lm_head projection fused with softmax-CE,
// forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/blockwise_ce.py
//   forward  _ce_fwd_kernel (launched by _fwd_pallas at :426)
//   dx       _ce_dx_kernel  (launched by _bwd_pallas at :467)
//   dW       _ce_dw_kernel  (launched by _bwd_pallas at :485)
//
// Functions, for x (N, D), W (V, D) (the port keeps W's vocab rows dense
// along D, the transpose of the JAX package's (D, V)) and int32 labels:
//   S[i, v]   = x_i . W_v                          f32
//   lse_i     = log sum_v exp(S[i, v]);  picked_i = S[i, label_i]
//   dS[i, v]  = T((exp(S[i, v] - lse_i) - [v == label_i]) * scale_i)
//   dx        = T(sum_v dS[:, v] W_v)              f32 over all of V
//   dW        = T(dS^T x)                          f32 over all rows
// T rounds to the inputs' type (bf16 or f32), as the JAX kernels round
// dS to x's type before both products; scale_i = g / count for a row
// whose label is not ignore_index and 0 otherwise (the caller computes
// it). A label outside [0, V) picks nothing and has no one-hot.
//
// Bound on this card: operations. At the training shape (N 16384, D 2048,
// V 32000) the forward is 2NDV = 2.15e12 tensor-core operations (2.17 ms
// at 989 TF/s) against 0.2 GB of traffic; the backward's least work is
// three such products (6.5 ms).
//
// Design.
// - The f32 route (the checking path: the forward and the backward): one
//   GEMM tile kernel (ce_gemm) a product, FFMA on the CUDA cores, 64 x 64
//   tiles, no TF32 (the JAX package computes f32 products at HIGHEST
//   precision). A block computes a tile of C = A . B over the K loop,
//   then parks the f32 tile in shared memory, where an epilogue that
//   depends on the product reads it. Tiles run in groups of 16 row tiles
//   so the operands of the blocks in flight stay in L2.
// - The forward: C = S (rows x vocab, K = D); per row and vocab tile the
//   tile's max and sum of exp(S - max) go to a partial buffer (2, N,
//   ceil(V / tile)) and the label's S to picked; a second small kernel
//   (ce_fwd_combine) merges each row's partials into its lse in a fixed
//   order, so the lse has the same bits from call to call. Each partial
//   is written by exactly one thread: no atomics.
// - The backward runs per vocab super-block [v0, v0 + Vs), Vs chosen by
//   the caller so the (N, Vs) dS workspace stays within a budget (never
//   [N, V]), as three products:
//   ce_dlogits: C = S of the super-block (K = D); dS, rounded to T, into
//     the workspace, 0 in every column at or past V up to the workspace's
//     width;
//   ce_dx: C = dS . W[v0:v0+Vs] (rows x D, K = Vs), added to an f32 dx
//     accumulator; the first super-block writes it, the last casts the
//     sum to T into dx;
//   ce_dw: C = dS^T . x (Vs x D, K = N), cast to T into dW[v0:v0+Vs].
//   S is recomputed once per super-block (the TPU recomputes it in both
//   its dx and its dW kernel). dx and dW cannot come from one pass over a
//   dS tile without atomics: a 128-row tile's dx row block at D 2048 is
//   1 MB of f32, as is a vocab tile's dW block, far past an SM's 227 KB.
//   Nothing uses atomics: every result is deterministic.
// - The bf16 route (namespace wg): one persistent, warp-specialised
//   wgmma GEMM for the four products (the forward's S, dS, dx, dW),
//   min(tiles, SMs) blocks walking 128 x 256 tiles of C in groups of 16
//   row tiles (the operands of the blocks in flight stay in L2). 384
//   threads: one thread of warpgroup 0 issues TMA loads of A's 128 x 64
//   and B's 64 x 256 k-tile, 128-byte swizzled, into a 4-stage ring of
//   48 KB stages signalled by mbarriers (full: bytes landed; empty: the 8
//   consumer warps done), running on across tiles, so the next tile's
//   loads overlap this tile's epilogue. Warpgroups 1 and 2 each own 64
//   rows of the tile, m64n256k16 with both operands in shared memory, 128
//   f32 accumulators a thread; every product is issued on every step (a
//   wgmma under a branch makes ptxas serialise all of them). Operand
//   layouts: the forward and dS read x and W rows K-major (the forward's
//   W map spans all V rows, dS's its super-block); dx reads dS K-major
//   and W's rows MN-major (TransB); dW reads dS^T and x both MN-major
//   (TransA and TransB), straight from the workspace, with no transposed
//   copy. An MN-major operand's k-tile lands as 64-column boxes (one
//   1024-byte swizzle atom across, LBO between boxes). The epilogues run
//   in the consumers' registers in the accumulator's layout (rows g and
//   g + 8 of each warp's 16, column pairs 8 j + 2 t, so a row's 256
//   columns lie in the 4 threads of a quad): the forward as each row's
//   max over the tile's columns below V, combined over the quad by
//   shuffles, then the sum of exp2(S log2e - max log2e), combined the
//   same way, written by the quad's first thread, and the label's raw S
//   by the one thread that holds its column; dS as exp2(S log2e - lse
//   log2e) - onehot, times scale, one exp a value; dx as a read-add-write
//   of the f32 accumulator (the sum's order is fixed: accumulator + this
//   super-block); dW as a cast. Ragged edges: TMA fills rows and columns
//   past each map's extent with zeros (the W map starts at v0 and ends at
//   v0 + vcur, the workspace's at vcur rounded up to 8), the forward masks
//   columns at or past V to -inf, and the stores mask rows and columns
//   past the output, so a 256-wide tile past the last vocab row computes
//   zeros there and stores only what lies inside. Every global offset is
//   64-bit.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using ptt::bf16;

constexpr int kThreads = 256;
constexpr int kGroupM = 16;

// epilogues
constexpr int kFwdStats = 0, kDlogits = 1, kDx = 2, kDw = 3;

// The f32 tile kernel's geometry: (BK, 64 + 4) operand tiles stored
// k-major; LDC: the parked f32 C tile.
struct Fma {
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int LDF = BM + 4, LDC = BN + 4;
  static constexpr int kTile = BK * LDF;  // floats
  static constexpr size_t bytes =
      (2 * size_t(kTile) + size_t(BM) * LDC) * sizeof(float);
};

struct Args {
  // C (m x n) = A (m x k) . B (k x n). An operand is K-contiguous (element
  // (i, k) at p[i * ld + k]) or K-major (at p[k * ld + i]); ext is its
  // extent along i, kv along k: elements past either read as 0.
  const float* a;
  int64_t lda;
  int a_ext, a_kv;
  const float* b;
  int64_t ldb;
  int b_ext, b_kv;
  int m, n, k;
  // epilogues
  const int* labels;   // (rows,)
  const float* lse;    // (rows,)
  const float* scale;  // (rows,)
  float* part;         // forward: (2, rows, n_vtiles) max, then sums
  float* picked;       // forward: (rows,)
  int n_vtiles;
  int vocab;           // V
  int v0;              // first vocab row of the super-block
  float* out;          // dS workspace, dx, or dW's rows from v0
  int64_t ldo;
  float* acc;          // dx: f32 accumulator (rows, D)
  int first, last;     // dx: first / last super-block
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// This block's tile (mt, nt): the grid walks groups of kGroupM row tiles,
// row tiles fastest inside a group.
__device__ __forceinline__ void tile_coords(int tm, int tn, int& mt, int& nt) {
  const int pid = blockIdx.x;
  const int per_group = kGroupM * tn;
  const int group = pid / per_group;
  const int first = group * kGroupM;
  const int size = min(tm - first, kGroupM);
  const int r = pid - group * per_group;
  mt = first + r % size;
  nt = r / size;
}

// ---------------------------------------------------------------------
// f32 main loop: FFMA, each thread a 4 x 4 block of C
// ---------------------------------------------------------------------

// element (i, k) of an operand, 0 past ext or kv
template <bool KC>
__device__ __forceinline__ float elem(const float* p, int64_t ld, int i,
                                      int k, int ext, int kv) {
  if (i >= ext || k >= kv) return 0.f;
  return KC ? p[i * ld + k] : p[k * ld + i];
}

template <bool AK, bool BK>
__device__ __forceinline__ void fma_tile(const Args& a, int m0, int n0,
                                         unsigned char* smem) {
  using G = Fma;
  float* as = reinterpret_cast<float*>(smem);
  float* bs = as + G::kTile;
  float* cs = bs + G::kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.k; k0 += G::BK) {
    // tiles stored k-major: as[k][i], bs[k][j]; consecutive threads read
    // consecutive addresses of the operand as it is stored
    for (int e = threadIdx.x; e < G::BM * G::BK; e += kThreads) {
      const int i = AK ? e / G::BK : e % G::BM;
      const int kk = AK ? e % G::BK : e / G::BM;
      as[kk * G::LDF + i] =
          elem<AK>(a.a, a.lda, m0 + i, k0 + kk, a.a_ext, a.a_kv);
    }
    for (int e = threadIdx.x; e < G::BN * G::BK; e += kThreads) {
      const int j = BK ? e / G::BK : e % G::BN;
      const int kk = BK ? e % G::BK : e / G::BN;
      bs[kk * G::LDF + j] =
          elem<BK>(a.b, a.ldb, n0 + j, k0 + kk, a.b_ext, a.b_kv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < G::BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(as + kk * G::LDF +
                                                         4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(bs + kk * G::LDF +
                                                         4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[(4 * ty + i) * G::LDC + 4 * tx + j] = acc[i][j];
  __syncthreads();
}

// ---------------------------------------------------------------------
// epilogues on the parked f32 tile cs (BM x BN at (m0, n0), tile nt)
// ---------------------------------------------------------------------

template <int Kind>
__device__ __forceinline__ void epilogue(const Args& a, const float* cs,
                                         int m0, int n0, int nt) {
  using G = Fma;
  if constexpr (Kind == kFwdStats) {
    // one warp per row: the tile's max and sum of exp(S - max) over its
    // vocab columns below V, and the label's S
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < G::BM && m0 + r < a.m; r += kThreads / 32) {
      const int row = m0 + r;
      const float* cr = cs + r * G::LDC;
      const int lab = a.labels[row];
      float mx = -INFINITY;
      for (int c = lane; c < G::BN; c += 32) {
        const int v = n0 + c;
        if (v < a.n) mx = fmaxf(mx, cr[c]);
        if (v == lab && v < a.n) a.picked[row] = cr[c];
      }
      mx = ptt::warp_max(mx);
      float s = 0.f;
      for (int c = lane; c < G::BN; c += 32)
        if (n0 + c < a.n) s += expf(cr[c] - mx);
      s = ptt::warp_sum(s);
      if (lane == 0) {
        const int64_t at = static_cast<int64_t>(row) * a.n_vtiles + nt;
        a.part[at] = mx;
        a.part[static_cast<int64_t>(a.m) * a.n_vtiles + at] = s;
      }
    }
  } else {
    for (int e = threadIdx.x; e < G::BM * G::BN; e += kThreads) {
      const int r = e / G::BN, c = e - (e / G::BN) * G::BN;
      const int row = m0 + r, col = n0 + c;
      if (row >= a.m) continue;
      const float val = cs[r * G::LDC + c];
      if constexpr (Kind == kDlogits) {
        // every column of the tile is written (0 at or past V), so the
        // workspace holds whole tiles for the dx and dW products
        const int v = a.v0 + col;
        float d = 0.f;
        if (v < a.vocab) {
          d = expf(val - a.lse[row]);
          if (v == a.labels[row]) d -= 1.f;
          d *= a.scale[row];
        }
        a.out[row * a.ldo + col] = d;
      } else if constexpr (Kind == kDx) {
        if (col >= a.n) continue;
        const int64_t i = row * a.ldo + col;
        const float sum = a.first ? val : a.acc[i] + val;
        if (a.last)
          a.out[i] = sum;
        else
          a.acc[i] = sum;
      } else {  // kDw
        if (col >= a.n) continue;
        a.out[row * a.ldo + col] = val;
      }
    }
  }
}

template <bool AK, bool BK, int Kind>
__global__ void __launch_bounds__(kThreads) ce_gemm(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  int mt, nt;
  tile_coords(cdiv(a.m, Fma::BM), cdiv(a.n, Fma::BN), mt, nt);
  const int m0 = mt * Fma::BM, n0 = nt * Fma::BN;
  fma_tile<AK, BK>(a, m0, n0, smem);
  epilogue<Kind>(a, reinterpret_cast<const float*>(smem) + 2 * Fma::kTile,
                 m0, n0, nt);
}

// lse of each row from its (max, sum) partials: one warp per row, merged
// in a fixed order
__global__ void __launch_bounds__(kThreads)
    ce_fwd_combine(const float* part, int rows, int nvt, float* lse) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp
  const float* pm = part + static_cast<int64_t>(row) * nvt;
  const float* pl = pm + static_cast<int64_t>(rows) * nvt;
  float mx = -INFINITY;
  for (int j = lane; j < nvt; j += 32) mx = fmaxf(mx, pm[j]);
  mx = ptt::warp_max(mx);
  float s = 0.f;
  for (int j = lane; j < nvt; j += 32) s += pl[j] * expf(pm[j] - mx);
  s = ptt::warp_sum(s);
  if (lane == 0) lse[row] = mx + logf(s);
}

cudaError_t combine(const float* part, int n, int nvt, void* lse,
                    cudaStream_t s) {
  ce_fwd_combine<<<cdiv(n, kThreads / 32), kThreads, 0, s>>>(
      part, n, nvt, static_cast<float*>(lse));
  return cudaGetLastError();
}

template <bool AK, bool BK, int Kind>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.m <= 0 || a.n <= 0) return cudaSuccess;
  void (*kern)(const Args) = ce_gemm<AK, BK, Kind>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Fma::bytes));
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>(cdiv(a.m, Fma::BM)) * cdiv(a.n, Fma::BN);
  kern<<<static_cast<unsigned>(tiles), kThreads, Fma::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
const T* rows_from(const void* p, int64_t row, int d) {
  return static_cast<const T*>(p) + row * d;
}

// ---------------------------------------------------------------------
// the bf16 route: wgmma over TMA (see the design note at the top)
// ---------------------------------------------------------------------

namespace wg {

namespace h = ptt::sm90;

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int kStages = 4;
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kGroupM = 16;            // row tiles per raster group
constexpr uint32_t kABytes = BM * BK * 2;
constexpr uint32_t kBBytes = BN * BK * 2;
constexpr uint32_t kBox = 64 * 64 * 2;  // a 64 x 64 box: 64 rows of 128 B
constexpr size_t kSmem = kStages * size_t(kABytes + kBBytes) +
                         2 * kStages * sizeof(uint64_t) +
                         1024;  // room to align the base to 1024

// C (m x n) over K = k, and what the epilogue of each product needs
struct Epi {
  int m, n, k;
  // forward: the (max, sum) partials (2, m, nvt) and the label's S (m,)
  float* part;
  float* picked;
  int nvt;
  // dS: rows' labels (and the forward's), lse and scale; vocab rows below
  // vcur are real, v0 is the first; the workspace (n rows, ldw apart)
  const int* labels;
  const float* lse;
  const float* scale;
  int vcur, v0;
  bf16* ws;
  int64_t ldw;
  // dx: the f32 accumulator and dx (rows d apart), first / last
  // super-block; dW: its rows from v0 (d apart)
  float* acc;
  bf16* out;
  int64_t ldo;
  int first, last;
};

using ptt::ex2;
using ptt::kLog2e;

// two bf16 at p (4-byte aligned), a at the lower address
__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = ptt::pack_bf16(a, b);
}

// tile `tile` of tm x tn: groups of kGroupM row tiles, row tiles fastest
__device__ __forceinline__ void coords(int tile, int tm, int tn, int& m0,
                                       int& n0) {
  const int per_group = kGroupM * tn;
  const int first = tile / per_group * kGroupM;
  const int size = min(tm - first, kGroupM);
  const int r = tile % per_group;
  m0 = (first + r % size) * BM;
  n0 = r / size * BN;
}

// B is read K-major (W's rows, one 64 x 256 box a k-tile) by the forward
// and dS, MN-major by dx and dW.
__host__ __device__ constexpr bool b_kmajor(int kind) {
  return kind == kFwdStats || kind == kDlogits;
}

// Stage loads of k-tile k0 for tile (m0, n0). A K-major (the forward, dS,
// dx): one 64 x 128 box at (k0, m0); A MN-major (dW: the workspace read as
// dS^T): two 64 x 64 boxes at (m0 + 64 h, k0). B K-major (W rows): one
// 64 x 256 box at (k0, n0); B MN-major (dx: W rows, dW: x rows): four
// 64 x 64 boxes at (n0 + 64 q, k0).
template <int Kind>
__device__ __forceinline__ void load_stage(unsigned char* as,
                                           unsigned char* bs,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           uint64_t* bar, int m0, int n0,
                                           int k0) {
  if constexpr (Kind == kDw) {
    h::tma_load_2d(as, ta, bar, m0, k0);
    h::tma_load_2d(as + kBox, ta, bar, m0 + 64, k0);
  } else {
    h::tma_load_2d(as, ta, bar, k0, m0);
  }
  if constexpr (b_kmajor(Kind)) {
    h::tma_load_2d(bs, tb, bar, k0, n0);
  } else {
#pragma unroll
    for (int q = 0; q < BN / 64; ++q)
      h::tma_load_2d(bs + q * kBox, tb, bar, n0 + 64 * q, k0);
  }
}

// acc (64 x 256) += A (the warpgroup's 64 rows at a) . B (at b) over k16
// step kk. K-major: +32 bytes a step in the 128-byte rows, atoms of 8
// rows 1024 bytes apart; MN-major: 16 rows (2048 bytes) a step, the 64-wide
// boxes kBox apart (LBO).
template <int Kind>
__device__ __forceinline__ void mma_step(float (&acc)[128], uint32_t a,
                                         uint32_t b, int kk) {
  constexpr int kTransA = Kind == kDw, kTransB = !b_kmajor(Kind);
  const uint64_t da = kTransA ? h::desc_sw128(a + 2048 * kk, kBox, 1024)
                              : h::desc_sw128(a + 32 * kk, 16, 1024);
  const uint64_t db = kTransB ? h::desc_sw128(b + 2048 * kk, kBox, 1024)
                              : h::desc_sw128(b + 32 * kk, 16, 1024);
  h::wgmma_m64n256k16_ss<kTransB, kTransA>(acc, da, db, 1);
}

// The epilogue of a consumer thread: accumulator entry 4 j + 2 v + u is
// C's row `row0 + 8 v`, column `col0 + 8 j + u` (col0 even).
template <int Kind>
__device__ __forceinline__ void epilogue(const Epi& e, float (&acc)[128],
                                         int row0, int col0) {
  if constexpr (Kind == kFwdStats) {
    // per row: the max and sum of exp(S - max) over the tile's columns
    // below V (n), each combined over the quad that holds the row's 256
    // columns (lanes 4 g .. 4 g + 3); the raw S at the label's column,
    // written by the one thread that holds it. In the last vocab tile the
    // columns at or past V read S = 0 (TMA's zero rows of W) and are
    // masked to -inf, so they add ex2(-inf) = 0.
    const int lane = threadIdx.x & 31;
    const int tile = col0 / BN;
    const int lim = e.n - col0;         // this thread's columns 8 j + u < lim
    if (lim < BN) {                     // the same for the whole warp
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[4 * j + i] = 8 * j + (i & 1) < lim ? acc[4 * j + i] : -INFINITY;
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int row = row0 + 8 * v;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * v], acc[4 * j + 2 * v + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float nm = -mx * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          sum += ex2(fmaf(acc[4 * j + 2 * v + u], kLog2e, nm));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (row >= e.m) continue;
      const int64_t at = static_cast<int64_t>(row) * e.nvt + tile;
      if ((lane & 3) == 0) {
        e.part[at] = mx;
        e.part[static_cast<int64_t>(e.m) * e.nvt + at] = sum;
      }
      const int lab = e.labels[row];
      const int rel = lab - col0;       // the label's column, if this thread's
      if (lab < e.n && rel >= 0 && rel < BN && (rel & 7) < 2) {
        float pick = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            pick = rel == 8 * j + u ? acc[4 * j + 2 * v + u] : pick;
        e.picked[row] = pick;
      }
    }
  } else if constexpr (Kind == kDlogits) {
    // dS = (exp(S - lse) - onehot) * scale, 0 at or past vcur; stored up
    // to the workspace's width, so the dx and dW maps read zeros there
    float nl[2], sc[2];
    int lab[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int row = row0 + 8 * v;
      const bool ok = row < e.m;
      nl[v] = ok ? -e.lse[row] * kLog2e : 0.f;
      sc[v] = ok ? e.scale[row] : 0.f;
      lab[v] = ok ? e.labels[row] - e.v0 : -1;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int row = row0 + 8 * v;
        float d0 = ex2(fmaf(acc[4 * j + 2 * v], kLog2e, nl[v]));
        float d1 = ex2(fmaf(acc[4 * j + 2 * v + 1], kLog2e, nl[v]));
        d0 = (d0 - (col == lab[v] ? 1.f : 0.f)) * sc[v];
        d1 = (d1 - (col + 1 == lab[v] ? 1.f : 0.f)) * sc[v];
        d0 = col < e.vcur ? d0 : 0.f;
        d1 = col + 1 < e.vcur ? d1 : 0.f;
        if (row < e.m && col < e.ldw)
          store_bf16x2(e.ws + row * e.ldw + col, d0, d1);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int row = row0 + 8 * v;
        if (row >= e.m || col >= e.n) continue;  // n = D, a multiple of 8
        const int64_t i = row * e.ldo + col;
        float s0 = acc[4 * j + 2 * v], s1 = acc[4 * j + 2 * v + 1];
        if constexpr (Kind == kDx) {
          if (!e.first) {
            const float2 p = *reinterpret_cast<const float2*>(e.acc + i);
            s0 = p.x + s0;
            s1 = p.y + s1;
          }
          if (!e.last) {
            *reinterpret_cast<float2*>(e.acc + i) = make_float2(s0, s1);
            continue;
          }
        }
        store_bf16x2(e.out + i, s0, s1);
      }
    }
  }
}

template <int Kind>
__global__ void __launch_bounds__(kThreads, 1)
    ce_wgmma(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, const Epi e) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as =
      smem_raw + ((1024 - (h::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bs = as + kStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  const int tm = cdiv(e.m, BM), tn = cdiv(e.n, BN);
  const int tiles = tm * tn, nk = cdiv(e.k, BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], 8);       // lane 0 of each consumer warp
    }
    h::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full, across tiles
    h::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        coords(tile, tm, tn, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages, use = it / kStages;
          if (use > 0) h::mbar_wait(&empty[s], (use - 1) & 1);
          h::mbar_arrive_expect_tx(&full[s], kABytes + kBBytes);
          load_stage<Kind>(as + s * kABytes, bs + s * kBBytes, &ta, &tb,
                           &full[s], m0, n0, kt * BK);
        }
      }
    }
  } else {
    h::setmaxnreg_inc<232>();
    const int ct = threadIdx.x - 128;   // 0..255
    const int c = ct >> 7;              // consumer warpgroup: rows 64 c..
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    float acc[128];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      coords(tile, tm, tn, m0, n0);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        h::mbar_wait(&full[s], (it / kStages) & 1);
        const uint32_t a = h::smem_u32(as + s * kABytes) + c * kBox;
        const uint32_t b = h::smem_u32(bs + s * kBBytes);
        h::fence_operands(acc);
        h::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) mma_step<Kind>(acc, a, b, kk);
        h::wgmma_commit();
        h::fence_operands(acc);
        h::wgmma_wait<1>();             // k-tile kt - 1's products are done
        h::fence_operands(acc);
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) h::mbar_arrive(&empty[(it - 1) % kStages]);
        }
      }
      h::wgmma_wait<0>();
      h::fence_operands(acc);
      __syncwarp();
      if (lane == 0) h::mbar_arrive(&empty[(it - 1) % kStages]);
      epilogue<Kind>(e, acc, m0 + 64 * c + 16 * warp + (lane >> 2),
                     n0 + 2 * (lane & 3));
    }
  }
}

template <int Kind>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const Epi& e, cudaStream_t stream) {
  if (e.m <= 0 || e.n <= 0) return cudaSuccess;
  auto kern = ce_wgmma<Kind>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return err;
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tiles = int64_t(cdiv(e.m, BM)) * cdiv(e.n, BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(std::min<int64_t>(tiles, sms));
  kern<<<grid, kThreads, kSmem, stream>>>(ta, tb, e);
  return cudaGetLastError();
}

// a (rows, cols) bf16 tensor, rows `ld` elements apart, in boxes of
// (box_rows, 64), 128-byte swizzled
cudaError_t tmap(CUtensorMap* map, const void* base, int64_t rows,
                 int64_t cols, int64_t ld, int box_rows) {
  return ptt::encode_tmap_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
                             rows, cols, uint64_t(ld) * 2, box_rows, 64);
}

// The workspace's columns the products read: vcur rounded up to 8 (TMA's
// 16-byte rule; the dS kernel wrote zeros there).
int ws_cols(int vcur) { return (vcur + 7) / 8 * 8; }

// The forward's stats over all V rows of W: (max, sum) partials a row
// and 256-wide vocab tile, the label's S; then each row's lse.
cudaError_t fwd(const void* x, const void* w, const void* labels,
                void* part, void* picked, void* lse, int n, int d, int v,
                cudaStream_t s) {
  CUtensorMap ta, tb;
  cudaError_t err = tmap(&ta, x, n, d, d, BM);
  if (err == cudaSuccess) err = tmap(&tb, w, v, d, d, BN);
  if (err != cudaSuccess) return err;
  Epi e{};
  e.m = n;
  e.n = v;
  e.k = d;
  e.part = static_cast<float*>(part);
  e.picked = static_cast<float*>(picked);
  e.nvt = cdiv(v, BN);
  e.labels = static_cast<const int*>(labels);
  err = launch<kFwdStats>(ta, tb, e, s);
  if (err != cudaSuccess) return err;
  return combine(e.part, n, e.nvt, lse, s);
}

cudaError_t dlogits(const void* x, const void* w, const void* labels,
                    const void* lse, const void* scale, void* ws, int n,
                    int d, int v0, int vcur, int ldw, cudaStream_t s) {
  CUtensorMap ta, tb;
  cudaError_t err = tmap(&ta, x, n, d, d, BM);
  if (err == cudaSuccess)
    err = tmap(&tb, rows_from<bf16>(w, v0, d), vcur, d, d, BN);
  if (err != cudaSuccess) return err;
  Epi e{};
  e.m = n;
  e.n = vcur;
  e.k = d;
  e.labels = static_cast<const int*>(labels);
  e.lse = static_cast<const float*>(lse);
  e.scale = static_cast<const float*>(scale);
  e.vcur = vcur;
  e.v0 = v0;
  e.ws = static_cast<bf16*>(ws);
  e.ldw = ldw;
  return launch<kDlogits>(ta, tb, e, s);
}

cudaError_t dx(const void* ws, const void* w, void* acc, void* out, int n,
               int d, int v0, int vcur, int ldw, int first, int last,
               cudaStream_t s) {
  CUtensorMap ta, tb;
  const int k_cols = ws_cols(vcur);
  cudaError_t err = tmap(&ta, ws, n, k_cols, ldw, BM);
  if (err == cudaSuccess)
    err = tmap(&tb, rows_from<bf16>(w, v0, d), vcur, d, d, 64);
  if (err != cudaSuccess) return err;
  Epi e{};
  e.m = n;
  e.n = d;
  e.k = vcur;
  e.acc = static_cast<float*>(acc);
  e.out = static_cast<bf16*>(out);
  e.ldo = d;
  e.first = first;
  e.last = last;
  return launch<kDx>(ta, tb, e, s);
}

cudaError_t dw(const void* ws, const void* x, void* out, int n, int d,
               int v0, int vcur, int ldw, cudaStream_t s) {
  CUtensorMap ta, tb;
  cudaError_t err = tmap(&ta, ws, n, ws_cols(vcur), ldw, 64);
  if (err == cudaSuccess) err = tmap(&tb, x, n, d, d, 64);
  if (err != cudaSuccess) return err;
  Epi e{};
  e.m = vcur;
  e.n = d;
  e.k = n;
  e.out = static_cast<bf16*>(out) + static_cast<int64_t>(v0) * d;
  e.ldo = d;
  return launch<kDw>(ta, tb, e, s);
}

}  // namespace wg

// The f32 forward (the bf16 route is wg::fwd)
int run_fwd(const void* x, const void* w, const void* labels, void* part,
            void* picked, void* lse, int n, int d, int v, cudaStream_t s) {
  Args a{};
  a.a = static_cast<const float*>(x);
  a.lda = d;
  a.a_ext = n;
  a.a_kv = d;
  a.b = static_cast<const float*>(w);
  a.ldb = d;
  a.b_ext = v;
  a.b_kv = d;
  a.m = n;
  a.n = v;
  a.k = d;
  a.labels = static_cast<const int*>(labels);
  a.part = static_cast<float*>(part);
  a.picked = static_cast<float*>(picked);
  a.n_vtiles = cdiv(v, Fma::BN);
  cudaError_t err = launch<true, true, kFwdStats>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(combine(a.part, n, a.n_vtiles, lse, s));
}

// The f32 backward's products (the bf16 route is wg::)
int run_dlogits(const void* x, const void* w, const void* labels,
            const void* lse, const void* scale, void* ws, int n, int d,
            int v, int v0, int vcur, int ldw, cudaStream_t s) {
  Args a{};
  a.a = static_cast<const float*>(x);
  a.lda = d;
  a.a_ext = n;
  a.a_kv = d;
  a.b = rows_from<float>(w, v0, d);
  a.ldb = d;
  a.b_ext = vcur;
  a.b_kv = d;
  a.m = n;
  a.n = vcur;
  a.k = d;
  a.labels = static_cast<const int*>(labels);
  a.lse = static_cast<const float*>(lse);
  a.scale = static_cast<const float*>(scale);
  a.vocab = v;
  a.v0 = v0;
  a.out = static_cast<float*>(ws);
  a.ldo = ldw;
  return static_cast<int>(launch<true, true, kDlogits>(a, s));
}

int run_dx(const void* ws, const void* w, void* acc, void* out, int n, int d,
       int v0, int vcur, int ldw, int first, int last, cudaStream_t s) {
  Args a{};
  a.a = static_cast<const float*>(ws);  // (n, vcur), K-contiguous
  a.lda = ldw;
  a.a_ext = n;
  a.a_kv = (vcur + 7) / 8 * 8;  // columns up to there are written (0 past V)
  a.b = rows_from<float>(w, v0, d);  // W[v0 + k][j]: K-major
  a.ldb = d;
  a.b_ext = d;
  a.b_kv = vcur;
  a.m = n;
  a.n = d;
  a.k = vcur;
  a.out = static_cast<float*>(out);
  a.ldo = d;
  a.acc = static_cast<float*>(acc);
  a.first = first;
  a.last = last;
  return static_cast<int>(launch<true, false, kDx>(a, s));
}

int run_dw(const void* ws, const void* x, void* out, int n, int d, int v0,
       int vcur, int ldw, cudaStream_t s) {
  Args a{};
  a.a = static_cast<const float*>(ws);  // A[i][k] = ws[k][i]: K-major
  a.lda = ldw;
  a.a_ext = (vcur + 7) / 8 * 8;
  a.a_kv = n;
  a.b = static_cast<const float*>(x);  // B[k][j] = x[k][j]: K-major
  a.ldb = d;
  a.b_ext = d;
  a.b_kv = n;
  a.m = vcur;
  a.n = d;
  a.k = n;
  a.out = static_cast<float*>(out) + static_cast<int64_t>(v0) * d;
  a.ldo = d;
  return static_cast<int>(launch<false, false, kDw>(a, s));
}

bool bad_shape(int n, int d, int v, int dtype) {
  return n <= 0 || d <= 0 || v <= 0 ||
         (dtype == ptt::kDtypeBF16 && d % 8 != 0) ||
         (dtype != ptt::kDtypeBF16 && dtype != ptt::kDtypeF32);
}

// The workspace's width: the bf16 dS stores up to ldw and its readers read
// vcur rounded up to 8 columns; the f32 dS writes whole 64-wide tiles.
bool bad_block(int v, int v0, int vcur, int ldw, int dtype) {
  const int need = dtype == ptt::kDtypeBF16 ? wg::ws_cols(vcur)
                                            : cdiv(vcur, Fma::BN) * Fma::BN;
  return v0 < 0 || vcur <= 0 || v0 + vcur > v || ldw < need || ldw % 8 != 0;
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// The vocab width of one forward tile: the partial buffer of ptt_ce_fwd
// holds ceil(V / it) entries per row.
extern "C" int ptt_ce_vocab_tile(int dtype) {
  return dtype == ptt::kDtypeBF16 ? wg::BN : Fma::BN;
}

// x (n, d) and w (v, d) dense in one type; labels (n,) int32; part
// (2, n, ceil(v / ptt_ce_vocab_tile)) f32 scratch; picked (n,) f32,
// zeroed by the caller; lse (n,) f32 out. bf16: every pointer 16-byte
// aligned (TMA).
extern "C" int ptt_ce_fwd(const void* x, const void* w, const void* labels,
                          void* part, void* picked, void* lse, int n, int d,
                          int v, int dtype, void* stream) {
  if (bad_shape(n, d, v, dtype)) return kInvalid;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == ptt::kDtypeBF16
             ? static_cast<int>(wg::fwd(x, w, labels, part, picked, lse, n,
                                        d, v, s))
             : run_fwd(x, w, labels, part, picked, lse, n, d, v, s);
}

// dS of vocab rows [v0, v0 + vcur) into ws (n, ldw) in the inputs' type,
// columns from 0; lse and scale (n,) f32. bf16: every pointer 16-byte
// aligned (TMA).
extern "C" int ptt_ce_dlogits(const void* x, const void* w,
                              const void* labels, const void* lse,
                              const void* scale, void* ws, int n, int d,
                              int v, int v0, int vcur, int ldw, int dtype,
                              void* stream) {
  if (bad_shape(n, d, v, dtype) || bad_block(v, v0, vcur, ldw, dtype))
    return kInvalid;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == ptt::kDtypeBF16
             ? static_cast<int>(wg::dlogits(x, w, labels, lse, scale, ws, n,
                                            d, v0, vcur, ldw, s))
             : run_dlogits(x, w, labels, lse, scale, ws, n, d, v, v0, vcur,
                           ldw, s);
}

// dx (n, d) in the inputs' type += ws . w[v0:v0+vcur], through the f32
// accumulator acc (n, d) (unused when first and last are both set).
extern "C" int ptt_ce_dx(const void* ws, const void* w, void* acc, void* dx,
                         int n, int d, int v, int v0, int vcur, int ldw,
                         int first, int last, int dtype, void* stream) {
  if (bad_shape(n, d, v, dtype) || bad_block(v, v0, vcur, ldw, dtype))
    return kInvalid;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == ptt::kDtypeBF16
             ? static_cast<int>(wg::dx(ws, w, acc, dx, n, d, v0, vcur, ldw,
                                       first, last, s))
             : run_dx(ws, w, acc, dx, n, d, v0, vcur, ldw, first, last, s);
}

// dW rows [v0, v0 + vcur) of dw (v, d) = ws^T . x.
extern "C" int ptt_ce_dw(const void* ws, const void* x, void* dw, int n,
                         int d, int v, int v0, int vcur, int ldw, int dtype,
                         void* stream) {
  if (bad_shape(n, d, v, dtype) || bad_block(v, v0, vcur, ldw, dtype))
    return kInvalid;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == ptt::kDtypeBF16
             ? static_cast<int>(wg::dw(ws, x, dw, n, d, v0, vcur, ldw, s))
             : run_dw(ws, x, dw, n, d, v0, vcur, ldw, s);
}
