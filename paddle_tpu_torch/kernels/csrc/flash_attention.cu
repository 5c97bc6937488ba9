// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/flash_attention.py
//   forward  _fwd_kernel / _fwd_kernel_stream (launched at :529)
//   dq       _bwd_dq_kernel / _bwd_dq_kernel_stream (launched at :980, :998)
//   dk, dv   _bwd_dkv_kernel (launched at :1016)
// The TPU's fused backward _bwd_fused_kernel (:945) computes the same
// function as the dq + dk/dv pair here, which covers it.
//
// Conventions (this port's own):
// - q, k, v are (B, S, H, D) tensors read through their batch, sequence
//   and head strides (the head_dim must be dense); o, dO, dq, dk and dv
//   are dense (B, S, H, D). Self-attention: q and k/v share S.
// - Scores are s = (q . k) * scale: the products of the input type sum
//   in f32 and the scale multiplies the f32 sum (the TPU kernel folds
//   scale * log2(e) into q in q's type instead).
// - lse is the natural-log logsumexp of each row's scaled scores, f32,
//   dense (B, Hq, S). The backward recomputes p = exp(s - lse).
// - p (forward) and dS = p * (dP - delta) * scale (backward) are rounded
//   to the input type before the products that consume them, as the TPU
//   kernels round them; delta = rowsum(dO * O) comes in from the caller.
// - GQA: query head h reads kv head h / (Hq / Hk). The dk/dv kernel loops
//   over the query heads of its kv head's group, so dk and dv come out
//   per kv head without atomics and without repeated k/v.
//
// Bound on this card: operations. At the training shape (b 8, hq 32,
// s 2048, d 64, causal) the forward does 4 * b * hq * s^2 * d / 2 =
// 1.37e11 tensor-core operations (0.139 ms at 989 TF/s) against 0.1 GB
// of traffic (0.03 ms); the dq kernel does 1.5 and the dk/dv kernel 2
// times the forward's operations (each recomputes the scores).
//
// The bf16 kernels (namespace wg) run on wgmma, the only way to Hopper's
// full tensor-core rate. Their blocks are warpgroups that all compute,
// each owning 64 rows (wgmma's M):
// - forward: a persistent grid of at most one block an SM walks the work
//   items (q tile, q head, batch), the heaviest causal tiles first. An
//   item's q rows are 64 a warpgroup: three warpgroups (192 rows) at
//   d 64, where the exp pass costs as much as the products and a third
//   warp a scheduler overlaps them; two (128 rows) at d 128. k/v tiles of
//   128 keys stream through a ring (4 stages at d 64, 3 at d 128) that
//   runs on from item to item, as do the Q buffers, so the next item's
//   loads overlap this one's end. S = Q K^T (m64n128k16; Q read from
//   shared memory at d 64, held in registers as A fragments at d 128),
//   the online softmax on the S accumulators in base 2 (one FFMA and one
//   ex2 an entry; the mask, a select, only on diagonal tiles and the
//   ragged edge), P packed to bf16 A fragments in registers, O += P V
//   (m64nDk16, V read MN-major through the transpose bit). A step issues
//   S of its tile and P V of the tile before, and waits for S alone: the
//   exp pass runs under P V. Each warpgroup stops at its own diagonal.
//   o = O / l leaves from registers; lse = (m + log2 l) ln 2 with an
//   accurate log2.
// - dq, grid (Hq, B, q tiles of 128), two warpgroups: Q and dO of the block's
//   rows stay in shared memory; k/v tiles of 64 keys stream through a 4-stage
//   ring up to the diagonal. S = Q K^T and dP = dO V^T (m64n64k16), p = exp(s *
//   scale - lse) in the S accumulators, dS packed to bf16 A fragments in
//   registers, dQ += dS K (m64nDk16 with A in registers, K read MN-major
//   through the transpose bit). dq sums over the k tiles of one block, in
//   order.
// - dk/dv, grid (Hk, B, k tiles of 128), two warpgroups, the heaviest causal
//   tiles first: K and V of the block's keys are loaded once; (Q, dO, lse,
//   delta) of each (query head of the group, q tile of 64) stream through a
//   4-stage ring in a fixed order. Rows are keys: S^T = K Q^T and dP^T = V
//   dO^T, P^T and dS^T in registers (lse and delta by column), dV += P^T dO and
//   dK += dS^T Q (A in registers). A 64-wide bf16 row is one 128-byte swizzled
//   row, so each Q or dO tile is the K-major B of one product and the MN-major
//   B of another: no transposed copy. No atomics: dk and dv sum over the
//   group's heads and q tiles in order.
// A backward step issues S and dP of its tile, then the dS products of
// the step before, and waits for S alone: the exp pass runs under the
// other products. Every product is issued on every step (a tile that adds
// nothing gets zero fragments): ptxas serialises all of a kernel's
// wgmmas, each waiting for the last, when one is issued under a branch.
// At d 64 the block-fixed A operand of S and dP (Q and dO for dq, K and V
// for dk/dv) stays in registers, loaded once by ldmatrix from the
// swizzled tile, so those products read only B from shared memory; at
// d 128 the accumulators leave no room and both operands come from
// shared memory. The exp is 2^(s * scale * log2(e) - m) by ex2.approx.ftz
// (one FFMA and one MUFU an entry), branch-free: a branch per entry
// serialises each entry's load and exp.
// Operands arrive by TMA (cp.async.bulk.tensor) with the 128-byte swizzle
// that wgmma's descriptors read: q, k, v through a 4-D map (D, H, S, B)
// over the tensor's own strides (so the strided views the wrapper takes
// need no copy, and rows past S arrive as zeros), lse and delta through
// a 1-D map. TMA rather than a producer warp writing the swizzle by
// cp.async: one thread issues a whole tile, no registers or address
// arithmetic in the compute warps, and the ragged edge is the hardware's
// bound fill. Thread 0 is the producer: it refills a stage once every
// warp has arrived on the stage's `empty` mbarrier. Registers: a
// 384-thread block has at most 168 a thread (ptxas caps it there whatever
// setmaxnreg grants later), hence no separate producer warpgroup. The
// forward holds O (D / 2), S (64) and P (32) a thread, and Q (32) at
// d 128: 168 at d 64 in three warpgroups, 232 at d 128 in two; the dk/dv
// kernel dK and dV (D / 2 each) plus S^T and dP^T (32 each) and the
// fragments: over 240 at d 128, so two warpgroups.
//
// The f32 kernels are a checking path (the model trains in bf16):
// CUDA-core FMA loops over 32-row tiles with the accumulators in shared
// memory, a block of 4 warps per (q tile, q head, batch) for the forward
// and dq, per (k tile, kv head, batch) for dk/dv; the other operand's
// tiles stream through shared memory (rows padded by 16 bytes). The
// causal forward and dq stop at the diagonal tile and dk/dv start there;
// the element mask runs only on the diagonal tile and on tiles holding
// the ragged edge.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Tile geometry of the f32 kernels for element type T and head_dim D:
// 32-row tiles (the shared-memory path needs 4 bytes a value). Leading
// dimensions are in elements; k* sizes in bytes, each a multiple of 128.
template <typename T, int D>
struct Geo {
  static constexpr int BM = 32;  // rows per tile
  static constexpr int LDT = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int LDP = BM + 16 / static_cast<int>(sizeof(T));
  static constexpr int LDF = BM + 4;
  static constexpr int LDA = D + 4;
  static constexpr size_t kT = align128(size_t(BM) * LDT * sizeof(T));
  static constexpr size_t kP = align128(size_t(BM) * LDP * sizeof(T));
  static constexpr size_t kF = align128(size_t(BM) * LDF * 4);
  static constexpr size_t kA = align128(size_t(BM) * LDA * 4);
  static constexpr size_t kRow = align128(size_t(BM) * 4);
  // forward: q k v | s | p | o | m l alpha
  static constexpr size_t fwd_bytes = 3 * kT + kF + kP + kA + 3 * kRow;
  // dq: q dO k v | s dP | dS | dq | lse delta
  static constexpr size_t dq_bytes = 4 * kT + 2 * kF + kP + kA + 2 * kRow;
  // dk/dv: k v q dO | s dP | p dS | dk dv | lse delta
  static constexpr size_t dkv_bytes =
      4 * kT + 2 * kF + 2 * kP + 2 * kA + 2 * kRow;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int64_t qs[3], ks[3], vs[3];  // batch, sequence, head strides (elements)
  int seq, hq, hk;
  float scale;
  int causal;
};

struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t bytes) {
    U* r = reinterpret_cast<U*>(p);
    p += bytes;
    return r;
  }
};

using ptt::warp_max;

// Rows [r0, r0 + BM) of a (S, D) slice with row stride `stride` into a
// (BM, LDT) tile in 16-byte vectors; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          int64_t stride, int r0, int seq) {
  using G = Geo<T, D>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < G::BM * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < seq)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * G::LDT + c) = val;
  }
}

// dst row r0 + r = acc row r * mul (/ div[r] when div is given), rounded
// once to T; rows at or past S are not written.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int64_t stride,
                                           const float* acc,
                                           const float* div, float mul,
                                           int r0, int seq) {
  using G = Geo<T, D>;
  for (int i = threadIdx.x; i < G::BM * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    if (r0 + r >= seq) continue;
    float val = acc[r * G::LDA + c] * mul;
    if (div != nullptr) val = val / div[r];
    dst[(r0 + r) * stride + c] = ptt::from_f32<T>(val);
  }
}

// Per-row f32 values of a (B, H, S) tensor for rows [r0, r0 + BM); rows
// at or past S get 0 (they are masked wherever they are read).
template <int BM>
__device__ __forceinline__ void load_row_vals(float* dst, const float* src,
                                              int r0, int seq) {
  for (int r = threadIdx.x; r < BM; r += kThreads)
    dst[r] = r0 + r < seq ? src[r0 + r] : 0.f;
}

// ---------------------------------------------------------------------
// f32 tile products on shared memory: FMA loops, every output element
// owned by one thread, the same one on every call.
// ---------------------------------------------------------------------

// c (M x N) = a (M x K) . b^T, with b stored (N x K)
template <int M, int N, int K>
__device__ __forceinline__ void mm_abt(float* c, int ldc, const float* a,
                                       int lda, const float* b, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int r = i / N;
    const int col = i - r * N;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(a[r * lda + k], b[col * ldb + k], s);
    c[r * ldc + col] = s;
  }
}

// c (M x N) += a (M x K) . b, with b stored (K x N)
template <int M, int N, int K>
__device__ __forceinline__ void mm_ab_acc(float* c, int ldc, const float* a,
                                          int lda, const float* b, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int r = i / N;
    const int col = i - r * N;
    float s = c[r * ldc + col];
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(a[r * lda + k], b[k * ldb + col], s);
    c[r * ldc + col] = s;
  }
}

// c (M x N) += a^T . b, with a stored (K x M) and b stored (K x N)
template <int M, int N, int K>
__device__ __forceinline__ void mm_atb_acc(float* c, int ldc, const float* a,
                                           int lda, const float* b,
                                           int ldb) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int r = i / N;
    const int col = i - r * N;
    float s = c[r * ldc + col];
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(a[k * lda + r], b[k * ldb + col], s);
    c[r * ldc + col] = s;
  }
}

// Is score (q row r, key column c) of the tile at (q0, k0) visible?
__device__ __forceinline__ bool visible(int q0, int r, int k0, int c,
                                        int seq, int causal) {
  return q0 + r < seq && k0 + c < seq && (!causal || k0 + c <= q0 + r);
}

// Blocks start roughly in launch order. Under the causal mask the last q
// tiles (forward, dq) and the first k tiles (dk/dv) carry the most work,
// so every grid is (heads, batch, tiles) with those tiles launched first
// and the shortest blocks left for the end.
__device__ __forceinline__ int q_tile() { return gridDim.z - 1 - blockIdx.z; }

// One online-softmax step over the (BM x BM) score tile: each warp owns
// BM / 4 rows, each lane BM / 32 columns of a row. Writes p in T, the
// rescale factor of each row to alpha, and updates the running max m
// and sum l (of the f32 p, as the TPU kernel sums them).
template <int BM>
__device__ __forceinline__ void online_softmax(const float* s_s, float* p_s,
                                               float* m_s, float* l_s,
                                               float* al_s, int q0, int k0,
                                               int seq, float scale,
                                               bool masked, int causal) {
  constexpr int LDF = BM + 4, LDP = BM + 4;
  constexpr int kRows = BM / kWarps;
  constexpr int kCols = BM / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp * kRows + rr;
    float x[kCols];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      float val = s_s[r * LDF + col] * scale;
      if (masked && !visible(q0, r, k0, col, seq, causal)) val = -INFINITY;
      x[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = warp_max(mx);
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float p = __expf(x[c] - m_use);
      p_s[r * LDP + lane + 32 * c] = p;
      sum += p;
    }
    sum = ptt::warp_sum(sum);
    __syncwarp();  // every lane has read m_s[r] before lane 0 writes it
    if (lane == 0) {
      const float alpha = __expf(m_old - m_use);
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + sum;
      al_s[r] = alpha;
    }
  }
}

// p = exp(s * scale - lse) on visible elements (0 elsewhere) and
// dS = p * (dP - delta) * scale, over a (BM x BM) tile; p is written
// only when p_s is given.
template <int BM>
__device__ __forceinline__ void softmax_grad(const float* s_s,
                                             const float* dp_s, float* p_s,
                                             float* ds_s, const float* lse_s,
                                             const float* dl_s, int q0,
                                             int k0, int seq, float scale,
                                             bool masked, int causal) {
  constexpr int LDF = BM + 4, LDP = BM + 4;
  for (int i = threadIdx.x; i < BM * BM; i += kThreads) {
    const int r = i / BM;
    const int c = i - r * BM;
    float p = 0.f;
    if (!masked || visible(q0, r, k0, c, seq, causal))
      p = __expf(s_s[r * LDF + c] * scale - lse_s[r]);
    if (p_s != nullptr) p_s[r * LDP + c] = p;
    ds_s[r * LDP + c] = p * (dp_s[r * LDF + c] - dl_s[r]) * scale;
  }
}

// ---------------------------------------------------------------------
// f32 kernels (shared-memory tiles, CUDA-core products)
// ---------------------------------------------------------------------

// Forward: grid (Hq, B, q tiles)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Args a) {
  using T = float;
  using G = Geo<T, D>;
  constexpr int BM = G::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* q_s = cv.take<T>(G::kT);
  T* k_s = cv.take<T>(G::kT);
  T* v_s = cv.take<T>(G::kT);
  float* s_s = cv.take<float>(G::kF);
  T* p_s = cv.take<T>(G::kP);
  float* o_s = cv.take<float>(G::kA);
  float* m_s = cv.take<float>(G::kRow);
  float* l_s = cv.take<float>(G::kRow);
  float* al_s = cv.take<float>(G::kRow);

  const int h = blockIdx.x, b = blockIdx.y, qt = q_tile();
  const int kvh = h / (a.hq / a.hk);
  const int q0 = qt * BM;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  load_rows<T, D>(q_s, qg, a.qs[1], q0, a.seq);
  for (int i = threadIdx.x; i < BM * G::LDA; i += kThreads) o_s[i] = 0.f;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  const int n_kv = (a.seq + BM - 1) / BM;
  const int nk = a.causal ? min(qt + 1, n_kv) : n_kv;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BM;
    __syncthreads();  // the previous step is done with k_s, v_s, p_s
    load_rows<T, D>(k_s, kg, a.ks[1], k0, a.seq);
    load_rows<T, D>(v_s, vg, a.vs[1], k0, a.seq);
    __syncthreads();
    mm_abt<BM, BM, D>(s_s, G::LDF, q_s, G::LDT, k_s, G::LDT);
    __syncthreads();
    const bool masked = (a.causal && j == qt) || k0 + BM > a.seq ||
                        q0 + BM > a.seq;
    online_softmax<BM>(s_s, p_s, m_s, l_s, al_s, q0, k0, a.seq, a.scale,
                          masked, a.causal);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * D; i += kThreads) {
      const int r = i / D;
      o_s[r * G::LDA + (i - r * D)] *= al_s[r];
    }
    __syncthreads();
    mm_ab_acc<BM, D, BM>(o_s, G::LDA, p_s, G::LDP, v_s, G::LDT);
  }
  __syncthreads();
  const int64_t row = static_cast<int64_t>(a.hq) * D;
  T* og = static_cast<T*>(a.out) + static_cast<int64_t>(b) * a.seq * row +
          static_cast<int64_t>(h) * D;
  store_rows<T, D>(og, row, o_s, l_s, 1.f, q0, a.seq);
  float* lg = a.lse_out + (static_cast<int64_t>(b) * a.hq + h) * a.seq;
  for (int r = threadIdx.x; r < BM; r += kThreads)
    if (q0 + r < a.seq) lg[q0 + r] = m_s[r] + logf(l_s[r]);
}

// dq: grid (Hq, B, q tiles)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_f32(const Args a) {
  using T = float;
  using G = Geo<T, D>;
  constexpr int BM = G::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* q_s = cv.take<T>(G::kT);
  T* do_s = cv.take<T>(G::kT);
  T* k_s = cv.take<T>(G::kT);
  T* v_s = cv.take<T>(G::kT);
  float* s_s = cv.take<float>(G::kF);
  float* dp_s = cv.take<float>(G::kF);
  T* ds_s = cv.take<T>(G::kP);
  float* dq_s = cv.take<float>(G::kA);
  float* lse_s = cv.take<float>(G::kRow);
  float* dl_s = cv.take<float>(G::kRow);

  const int h = blockIdx.x, b = blockIdx.y, qt = q_tile();
  const int kvh = h / (a.hq / a.hk);
  const int q0 = qt * BM;
  const int64_t row = static_cast<int64_t>(a.hq) * D;
  const int64_t dense = static_cast<int64_t>(b) * a.seq * row +
                        static_cast<int64_t>(h) * D;
  const int64_t bh = (static_cast<int64_t>(b) * a.hq + h) * a.seq;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  load_rows<T, D>(q_s, qg, a.qs[1], q0, a.seq);
  load_rows<T, D>(do_s, static_cast<const T*>(a.dout) + dense, row, q0,
                  a.seq);
  load_row_vals<BM>(lse_s, a.lse + bh, q0, a.seq);
  load_row_vals<BM>(dl_s, a.delta + bh, q0, a.seq);
  for (int i = threadIdx.x; i < BM * G::LDA; i += kThreads) dq_s[i] = 0.f;
  const int n_kv = (a.seq + BM - 1) / BM;
  const int nk = a.causal ? min(qt + 1, n_kv) : n_kv;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BM;
    __syncthreads();
    load_rows<T, D>(k_s, kg, a.ks[1], k0, a.seq);
    load_rows<T, D>(v_s, vg, a.vs[1], k0, a.seq);
    __syncthreads();
    mm_abt<BM, BM, D>(s_s, G::LDF, q_s, G::LDT, k_s, G::LDT);
    mm_abt<BM, BM, D>(dp_s, G::LDF, do_s, G::LDT, v_s, G::LDT);
    __syncthreads();
    const bool masked = (a.causal && j == qt) || k0 + BM > a.seq ||
                        q0 + BM > a.seq;
    softmax_grad<BM>(s_s, dp_s, static_cast<float*>(nullptr), ds_s, lse_s,
                        dl_s, q0, k0, a.seq, a.scale, masked, a.causal);
    __syncthreads();
    mm_ab_acc<BM, D, BM>(dq_s, G::LDA, ds_s, G::LDP, k_s, G::LDT);
  }
  __syncthreads();
  store_rows<T, D>(static_cast<T*>(a.dq) + dense, row, dq_s, nullptr, 1.f,
                   q0, a.seq);
}

// dk, dv: grid (Hk, B, k tiles)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_f32(const Args a) {
  using T = float;
  using G = Geo<T, D>;
  constexpr int BM = G::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* k_s = cv.take<T>(G::kT);
  T* v_s = cv.take<T>(G::kT);
  T* q_s = cv.take<T>(G::kT);
  T* do_s = cv.take<T>(G::kT);
  float* s_s = cv.take<float>(G::kF);
  float* dp_s = cv.take<float>(G::kF);
  T* p_s = cv.take<T>(G::kP);
  T* ds_s = cv.take<T>(G::kP);
  float* dk_s = cv.take<float>(G::kA);
  float* dv_s = cv.take<float>(G::kA);
  float* lse_s = cv.take<float>(G::kRow);
  float* dl_s = cv.take<float>(G::kRow);

  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int group = a.hq / a.hk;
  const int k0 = kt * BM;
  load_rows<T, D>(k_s, static_cast<const T*>(a.k) + b * a.ks[0] +
                           kvh * a.ks[2], a.ks[1], k0, a.seq);
  load_rows<T, D>(v_s, static_cast<const T*>(a.v) + b * a.vs[0] +
                           kvh * a.vs[2], a.vs[1], k0, a.seq);
  for (int i = threadIdx.x; i < BM * G::LDA; i += kThreads) {
    dk_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  const int nq = (a.seq + BM - 1) / BM;
  const int64_t qrow = static_cast<int64_t>(a.hq) * D;
  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
    const T* dog = static_cast<const T*>(a.dout) +
                   static_cast<int64_t>(b) * a.seq * qrow +
                   static_cast<int64_t>(h) * D;
    const int64_t bh = (static_cast<int64_t>(b) * a.hq + h) * a.seq;
    for (int i = a.causal ? kt : 0; i < nq; ++i) {
      const int q0 = i * BM;
      __syncthreads();  // the previous step is done with q_s, dO, p, dS
      load_rows<T, D>(q_s, qg, a.qs[1], q0, a.seq);
      load_rows<T, D>(do_s, dog, qrow, q0, a.seq);
      load_row_vals<BM>(lse_s, a.lse + bh, q0, a.seq);
      load_row_vals<BM>(dl_s, a.delta + bh, q0, a.seq);
      __syncthreads();
      mm_abt<BM, BM, D>(s_s, G::LDF, q_s, G::LDT, k_s, G::LDT);
      mm_abt<BM, BM, D>(dp_s, G::LDF, do_s, G::LDT, v_s, G::LDT);
      __syncthreads();
      const bool masked = (a.causal && i == kt) || k0 + BM > a.seq ||
                          q0 + BM > a.seq;
      softmax_grad<BM>(s_s, dp_s, p_s, ds_s, lse_s, dl_s, q0, k0, a.seq,
                          a.scale, masked, a.causal);
      __syncthreads();
      mm_atb_acc<BM, D, BM>(dv_s, G::LDA, p_s, G::LDP, do_s, G::LDT);
      mm_atb_acc<BM, D, BM>(dk_s, G::LDA, ds_s, G::LDP, q_s, G::LDT);
    }
  }
  __syncthreads();
  const int64_t krow = static_cast<int64_t>(a.hk) * D;
  const int64_t dense = static_cast<int64_t>(b) * a.seq * krow +
                        static_cast<int64_t>(kvh) * D;
  store_rows<T, D>(static_cast<T*>(a.dk) + dense, krow, dk_s, nullptr, 1.f,
                   k0, a.seq);
  store_rows<T, D>(static_cast<T*>(a.dv) + dense, krow, dv_s, nullptr, 1.f,
                   k0, a.seq);
}

constexpr int kFwd = 0, kDq = 1, kDkv = 2;

// ---------------------------------------------------------------------
// bf16 kernels: wgmma on 128-byte-swizzled tiles loaded by TMA
// ---------------------------------------------------------------------

namespace wg {

namespace h = ptt::sm90;

constexpr int kThreads = 256;   // two warpgroups, both compute
constexpr int kRows = 64;       // a warpgroup's rows: wgmma's M
constexpr int kBlockRows = 2 * kRows;
constexpr int kStages = 4;      // the streamed operand's ring
constexpr int kLseBytes = kRows * 4;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tile of R rows x D bf16 columns in shared memory: D / 64 halves, each
// R rows of 128 bytes as TMA's 128-byte swizzle lays them (a 64-column
// box each), 1024-byte aligned.
template <int D>
struct Tiles {
  static constexpr int kHalves = D / 64;
  static constexpr uint32_t kStep = kRows * 128;              // one half
  static constexpr uint32_t kTile = kHalves * kStep;          // 64 rows
  static constexpr uint32_t kBlockStep = kBlockRows * 128;
  static constexpr uint32_t kBlockTile = kHalves * kBlockStep;  // 128 rows
  // dq: q, dO (128 rows) | k, v ring | barriers
  static constexpr size_t dq_bytes = 2 * kBlockTile + 2 * kStages * kTile +
                                     (1 + 2 * kStages) * 8 + 1024;
  // dk/dv: k, v (128 rows) | q, dO ring | lse, delta ring | barriers
  static constexpr size_t dkv_bytes = 2 * kBlockTile + 2 * kStages * kTile +
                                      2 * kStages * kLseBytes +
                                      (1 + 2 * kStages) * 8 + 1024;
};

// wgmma descriptors of a tile at shared address `base` whose 64-column
// halves are `step` bytes apart. K-major (the tile's columns are the
// product's K): k16 step kk is +32 bytes in the row of half kk / 4.
// MN-major (its rows are the product's K, its columns the N): k16 step kk
// is rows 16 kk.. (+2048 bytes), the halves are the N atoms (LBO).
__device__ __forceinline__ uint64_t desc_k(uint32_t base, uint32_t step,
                                           int kk) {
  return h::desc_sw128(base + (kk >> 2) * step + 32 * (kk & 3), 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mn(uint32_t base, uint32_t step,
                                            int kk) {
  return h::desc_sw128(base + 2048 * kk, step, 1024);
}

// acc (64 x 64) = A . B^T over D: A the warpgroup's 64 rows of a tile at
// `a` (halves a_step apart), B 64 rows of a tile at `b`; both K-major
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[32], uint32_t a,
                                        uint32_t a_step, uint32_t b,
                                        uint32_t b_step) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    h::wgmma_m64n64k16_ss<0>(acc, desc_k(a, a_step, kk),
                             desc_k(b, b_step, kk), kk > 0);
}

// The same with A held in registers (d 64): F the A fragments of the
// warpgroup's 64 rows over the 64 columns
__device__ __forceinline__ void mma_fbt(float (&acc)[32],
                                        const uint32_t (&f)[4][4], uint32_t b,
                                        uint32_t b_step) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    h::wgmma_m64n64k16_rs<0>(acc, f[kk], desc_k(b, b_step, kk), kk > 0);
}

// A warp's rows of a block-fixed operand as A fragments, held at d 64
// only (at d 128 they would not fit beside the accumulators)
template <int D>
struct HeldFrags {
  uint32_t f[4][4];
};
template <>
struct HeldFrags<128> {};

// The A fragments (a set of 4 registers a k16 step) of a warp's 16 rows
// row0.. of a swizzled tile at `base` over K16 * 16 columns (64-column
// halves `step` bytes apart), by ldmatrix .x4: lane L reads row row0 + L %
// 8 + 8 (L / 8 % 2), 16-byte chunk 2 (kk % 4) + L / 16 of half kk / 4,
// found at chunk ^ (row % 8) under the 128-byte swizzle.
template <int K16>
__device__ __forceinline__ void load_frags(uint32_t (&f)[K16][4],
                                           uint32_t base, int row0,
                                           uint32_t step = 0) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    const int chunk = 2 * (kk & 3) + (lane >> 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(f[kk][0]), "=r"(f[kk][1]), "=r"(f[kk][2]), "=r"(f[kk][3])
        : "r"(base + (kk >> 2) * step + r * 128 + ((chunk ^ (r & 7)) << 4)));
  }
}

// acc (64 x D) += F . B over K16 * 16: F the bf16 A fragments of a 64 x
// (K16 * 16) tile (one set a k16 step), B the (K16 * 16) x D tile at `b`
// read MN-major
template <int D, int K16>
__device__ __forceinline__ void mma_fb(float (&acc)[D / 2],
                                       const uint32_t (&f)[K16][4],
                                       uint32_t b, uint32_t b_step) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    if constexpr (D == 64)
      h::wgmma_m64n64k16_rs<1>(acc, f[kk], desc_mn(b, b_step, kk), 1);
    else
      h::wgmma_m64n128k16_rs<1>(acc, f[kk], desc_mn(b, b_step, kk), 1);
  }
}

// The layout of an m64nN accumulator: entry 4 j + 2 v + u of a thread is
// row 16 warp + g + 8 v, column 8 j + 2 t + u of the warpgroup's tile; the
// A fragment of k16 step kk takes columns 16 kk.., entry pairs (8 kk + 2 r,
// + 1) into register r. fill_frag packs one such pair.
template <int K16>
__device__ __forceinline__ void fill_frag(uint32_t (&f)[K16][4], int j,
                                          int v, float lo, float hi) {
  f[j >> 1][2 * (j & 1) + v] = ptt::pack_bf16(lo, hi);
}

using ptt::ex2;
using ptt::kLog2e;

// p = exp(s * scale - lse) in place over a warpgroup's 64 x 64 score
// tile, as 2^(s * scale2 - lse2(i)) with scale2 = scale * log2(e) and
// lse2(i) = lse * log2(e) of entry i: one FFMA and one ex2 an entry. When
// `masked`, 0 where vis(i) is false. Branch-free inside (the exp for
// every entry, then a select): a branch per entry serialises each
// entry's load and exp behind a reconvergence.
template <typename Lse, typename Vis>
__device__ __forceinline__ void exp_scores(float (&s)[32], float scale2,
                                           bool masked, Lse lse2, Vis vis) {
  if (!masked) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], scale2, -lse2(i)));
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(s[i], scale2, -lse2(i)));
      s[i] = vis(i) ? p : 0.f;
    }
  }
}


// keep fragments that an RS wgmma reads in place until its wait
template <int K16>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[K16][4]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) h::fence_operands(f[kk]);
}

constexpr float kLn2 = 0.6931471805599453f;

// The forward's geometry. An item's q rows are 64 a computing warpgroup:
// three at d 64, where the exp pass costs as much as the products and a
// third warp a scheduler overlaps them; two at d 128, where the
// accumulators leave registers for no third. Q stays in registers as A
// fragments at d 128 (kQHeld), where a second Q buffer would not fit,
// and is read from shared memory by S at d 64, where registers are
// short. Buffers: a ring of stages of one 128-key k tile and one v tile
// each, and Q buffers for every item the producer can reach running
// kStages - 2 tiles ahead (one fewer when Q is held: its buffer is free
// once read into registers): 200 KB at d 64, 224 KB at d 128 of the 227 a
// block may have.
template <int D>
struct FwdTiles {
  static constexpr int kGroups = D == 64 ? 3 : 2;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kQRows = kRows * kGroups;
  static constexpr bool kQHeld = kGroups == 2;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kQBufs = kQHeld ? kStages - 2 : kStages - 1;
  static constexpr uint32_t kQStep = kQRows * 128;   // a 64-column half
  static constexpr uint32_t kQTile = Tiles<D>::kHalves * kQStep;
  // q buffers | k ring | v ring | barriers
  static constexpr size_t bytes =
      kQBufs * size_t(kQTile) + 2 * kStages * size_t(Tiles<D>::kBlockTile) +
      (kQBufs + kStages) * 16 + 1024;
};

// S (64 x 128) = Q . K^T over D: Q the warpgroup's 64 rows, as A
// fragments in registers (qf) or read from the Q buffer at `qa`; K the
// 128 keys of the tile at `kb` (K-major)
template <int D, int K16>
__device__ __forceinline__ void mma_qk(float (&s)[64],
                                       const uint32_t (&qf)[K16][4],
                                       uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t k_desc = desc_k(kb, Tiles<D>::kBlockStep, kk);
    if constexpr (FwdTiles<D>::kQHeld)
      h::wgmma_m64n128k16_rs<0>(s, qf[kk], k_desc, kk > 0);
    else
      h::wgmma_m64n128k16_ss<0>(s, desc_k(qa, FwdTiles<D>::kQStep, kk),
                                k_desc, kk > 0);
  }
}

// Forward: a persistent grid of at most one block an SM. The work items
// are (q tile of F::kQRows, q head, batch), the heaviest causal tiles
// first; block i takes item i of each round of gridDim.x items, counted
// from the other end in odd rounds, so the blocks' loads even out.
// Warpgroup w owns query rows 64 w.. of an item; all stream its k/v
// tiles of 128 keys up to the diagonal: S = Q K^T, the online softmax on
// the S accumulators, O += P V (P in registers, V read MN-major). The k/v
// ring and the Q buffers run on from one item to the next, so the next
// item's loads overlap this one's last steps and its store.
template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Args a, int batch) {
  using T = Tiles<D>;
  using F = FwdTiles<D>;
  constexpr int kRing = F::kStages;
  constexpr int kQBufs = F::kQBufs;
  constexpr int kWarps = 4 * F::kGroups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024 - (h::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + kQBufs * F::kQTile;
  unsigned char* v_s = k_s + kRing * T::kBlockTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kRing * T::kBlockTile);
  uint64_t* empty = full + kRing;
  uint64_t* qfull = empty + kRing;
  uint64_t* qempty = qfull + kQBufs;

  const int n_qt = cdiv(a.seq, F::kQRows), n_kt = cdiv(a.seq, kBlockRows);
  const int heads = a.hq * batch;
  const int n_items = n_qt * heads;
  // the item block blockIdx.x takes in round r (past n_items: none left)
  auto item_of = [&](int r) {
    const int n = gridDim.x, i = blockIdx.x;
    return r * n + (r & 1 ? n - 1 - i : i);
  };
  struct Item {
    int q0, hq, kvh, b, nk;
  };
  auto item = [&](int it) {
    const int q0 = (n_qt - 1 - it / heads) * F::kQRows;
    const int hq = it % heads % a.hq;
    return Item{q0, hq, hq / (a.hq / a.hk), it % heads / a.hq,
                a.causal ? cdiv(min(q0 + F::kQRows, a.seq), kBlockRows)
                         : n_kt};
  };
  const int w = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // The producer, thread 0: the item it loads next (its round and
  // decoded form; none past the block's last), that item's next k/v tile,
  // and the counts of items and tiles it has begun. Tile n of the block's
  // stream goes to stage n % kRing, the Q of its item n to buffer n %
  // kQBufs.
  int p_round = 0, p_j = 0, p_items = 0, p_tiles = 0;
  bool p_live = item_of(0) < n_items;
  Item x = item(item_of(0));
  auto produce = [&]() {
    if (!p_live) return;
    if (p_j == 0) {                 // the item's Q, once the buffer is read
      const int qb = p_items % kQBufs;
      if (p_items >= kQBufs)
        h::mbar_wait(&qempty[qb], (p_items / kQBufs - 1) & 1);
      h::mbar_arrive_expect_tx(&qfull[qb], F::kQTile);
#pragma unroll
      for (int c = 0; c < T::kHalves; ++c)
        h::tma_load_4d(q_s + qb * F::kQTile + c * F::kQStep, &tq, &qfull[qb],
                       64 * c, x.hq, x.q0, x.b);
    }
    const int s = p_tiles % kRing;
    h::mbar_arrive_expect_tx(&full[s], 2 * T::kBlockTile);
#pragma unroll
    for (int c = 0; c < T::kHalves; ++c) {
      h::tma_load_4d(k_s + s * T::kBlockTile + c * T::kBlockStep, &tk,
                     &full[s], 64 * c, x.kvh, p_j * kBlockRows, x.b);
      h::tma_load_4d(v_s + s * T::kBlockTile + c * T::kBlockStep, &tv,
                     &full[s], 64 * c, x.kvh, p_j * kBlockRows, x.b);
    }
    ++p_tiles;
    if (++p_j == x.nk) {
      p_j = 0;
      ++p_items;
      p_live = item_of(++p_round) < n_items;
      x = item(item_of(p_round));
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], kWarps);  // lane 0 of every warp
    }
    for (int s = 0; s < kQBufs; ++s) {
      h::mbar_init(&qfull[s], 1);
      h::mbar_init(&qempty[s], kWarps);
    }
    h::fence_barrier_init();
  }
  __syncthreads();
  // the producer keeps kRing - 2 tiles ahead of the tile being computed
  if (threadIdx.x == 0)
    for (int i = 0; i < kRing - 2; ++i) produce();
  const float scale2 = a.scale * kLog2e;
  float o[D / 2], s[64];
  uint32_t p[8][4];                 // P of the last tile
  uint32_t qf[F::kQHeld ? D / 16 : 1][4];  // the warp's Q rows, when held
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  int step = 0;                     // the block's tile count
  for (int r = 0; item_of(r) < n_items; ++r) {
    const Item it = item(item_of(r));
    const int q0 = it.q0, qw0 = q0 + kRows * w;
    // Items taller than a k tile: this warpgroup's k tiles end at its own
    // last row's diagonal; the item's others it only releases.
    constexpr bool kSkip = F::kQRows > kBlockRows;
    const int nk = kSkip && a.causal
                       ? cdiv(min(qw0 + kRows, a.seq), kBlockRows)
                       : it.nk;
    // the last key each of the thread's two rows sees (-1 for a row past
    // the end), for the mask of the diagonal tile and the ragged edge
    int last[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int row = qw0 + 16 * warp + g + 8 * v;
      last[v] = row >= a.seq ? -1 : (a.causal ? row : a.seq - 1);
    }
    // per row: the running max of s * scale2, and this thread's share of
    // the running sum of 2^(s * scale2 - max)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[kk][e] = 0u;
    const int qb = r % kQBufs;      // item r of this block
    const uint32_t qa = h::smem_u32(q_s + qb * F::kQTile) + kRows * 128 * w;
    h::mbar_wait(&qfull[qb], (r / kQBufs) & 1);
    if constexpr (F::kQHeld) {
      load_frags(qf, h::smem_u32(q_s + qb * F::kQTile), kRows * w + 16 * warp,
                 F::kQStep);
      __syncwarp();
      if (lane == 0) h::mbar_arrive(&qempty[qb]);
    }
    // p holds P of tile j - 1 (zeros before the first), whose product step
    // j issues with that tile's v from its stage
    uint32_t prev_vb = h::smem_u32(v_s + (step % kRing) * T::kBlockTile);
    // Step j issues S of tile j and O += P V of tile j - 1, and waits for
    // S alone: the exp pass runs under the P V product. Both are issued on
    // every step: a wgmma issued under a branch makes ptxas serialise them
    // all.
    for (int j = 0; j < nk; ++j, ++step) {
      const int stage = step % kRing;
      h::mbar_wait(&full[stage], (step / kRing) & 1);
      const int k0 = j * kBlockRows;
      const uint32_t kb = h::smem_u32(k_s + stage * T::kBlockTile);
      const uint32_t vb = h::smem_u32(v_s + stage * T::kBlockTile);
      h::fence_operands(s);
      h::fence_operands(o);
      fence_frags(p);
      h::wgmma_fence();
      mma_qk<D>(s, qf, qa, kb);
      h::wgmma_commit();
      mma_fb<D>(o, p, prev_vb, T::kBlockStep);
      h::wgmma_commit();
      if (threadIdx.x == 0) {
        // tile step - 2's stage was released in the step before
        if (step >= 2)
          h::mbar_wait(&empty[(step - 2) % kRing], ((step - 2) / kRing) & 1);
        produce();
      }
      __syncwarp();
      h::wgmma_wait<1>();           // S has landed
      h::fence_operands(s);
      // keys past the warpgroup's first row, or the ragged edge
      const bool masked = (a.causal && k0 + kBlockRows > qw0 + 1) ||
                          k0 + kBlockRows > a.seq || qw0 + kRows > a.seq;
      if (masked) {                 // a select an entry: -inf past `last`
        int lim[2];
#pragma unroll
        for (int v = 0; v < 2; ++v) lim[v] = last[v] - k0 - 2 * t;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          s[i] = 8 * (i >> 2) + (i & 1) <= lim[(i >> 1) & 1] ? s[i]
                                                             : -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2], nmu[2];
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        mx[v] = fmaxf(mx[v], __shfl_xor_sync(0xffffffffu, mx[v], 1));
        mx[v] = fmaxf(mx[v], __shfl_xor_sync(0xffffffffu, mx[v], 2));
        const float m_new = fmaxf(m[v], mx[v] * scale2);
        // a row that sees no key yet keeps -inf; its exponents are taken
        // against 0, giving 0 and not NaN
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        alpha[v] = ex2(m[v] - mu);
        nmu[v] = -mu;
        m[v] = m_new;
        l[v] *= alpha[v];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = ex2(fmaf(s[i], scale2, nmu[(i >> 1) & 1]));
        l[(i >> 1) & 1] += s[i];    // this lane's columns; the quad sums
      }                             // them at the end
      h::wgmma_wait<0>();           // O += P V of tile j - 1 has landed
      h::fence_operands(o);
      fence_frags(p);
      if (j > 0) {                  // tile j - 1's k and v are read
        __syncwarp();
        if (lane == 0) h::mbar_arrive(&empty[(step - 1) % kRing]);
      }
      // rescale O when a row's max moved (a warp-wide vote: after the
      // first tiles most do not)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int i = 4 * j8 + 2 * v;
          fill_frag(p, j8, v, s[i], s[i + 1]);
        }
      prev_vb = vb;
    }
    h::fence_operands(o);
    fence_frags(p);
    h::wgmma_fence();
    mma_fb<D>(o, p, prev_vb, T::kBlockStep);
    h::wgmma_commit();
    h::wgmma_wait<0>();
    h::fence_operands(o);
    __syncwarp();                   // the item's last tile (and Q) are read
    if (lane == 0) {
      h::mbar_arrive(&empty[(step - 1) % kRing]);
      if constexpr (!F::kQHeld) h::mbar_arrive(&qempty[qb]);
    }
    // the item's tiles past this warpgroup's diagonal: released once
    // landed, in order, while thread 0 keeps producing
    if constexpr (kSkip) {
      for (int j = nk; j < it.nk; ++j, ++step) {
        h::mbar_wait(&full[step % kRing], (step / kRing) & 1);
        if (threadIdx.x == 0) {
          if (step >= 2)
            h::mbar_wait(&empty[(step - 2) % kRing],
                         ((step - 2) / kRing) & 1);
          produce();
        }
        __syncwarp();
        if (lane == 0) h::mbar_arrive(&empty[step % kRing]);
      }
    }
    float inv[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      l[v] += __shfl_xor_sync(0xffffffffu, l[v], 1);
      l[v] += __shfl_xor_sync(0xffffffffu, l[v], 2);
      inv[v] = 1.f / l[v];
    }
    const int64_t row = static_cast<int64_t>(a.hq) * D;
    ptt::store_acc<D>(static_cast<bf16*>(a.out) + static_cast<int64_t>(it.b) *
                          a.seq * row + static_cast<int64_t>(it.hq) * D,
                      row, reinterpret_cast<float(*)[4]>(o), q0, inv, a.seq);
    float* lg =
        a.lse_out + (static_cast<int64_t>(it.b) * a.hq + it.hq) * a.seq;
    if (t == 0)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int qrow = qw0 + 16 * warp + g + 8 * v;
        if (qrow < a.seq) lg[qrow] = (m[v] + log2f(l[v])) * kLn2;
      }
  }
}

// dq: grid (Hq, B, q tiles of 128). Warpgroup w owns query rows 64 w.. of
// the block; both stream the k/v tiles of 64 keys up to the diagonal:
// S = Q K^T and dP = dO V^T (SS), dS in registers, dQ += dS K (RS, K read
// MN-major).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const Args a) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024 - (h::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* do_s = q_s + T::kBlockTile;
  unsigned char* k_s = do_s + T::kBlockTile;
  unsigned char* v_s = k_s + kStages * T::kTile;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(v_s + kStages * T::kTile);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int hq = blockIdx.x, b = blockIdx.y;
  const int kvh = hq / (a.hq / a.hk);
  const int q0 = q_tile() * kBlockRows;
  const int n_kv = cdiv(a.seq, kRows);
  const int nk = a.causal ? cdiv(min(q0 + kBlockRows, a.seq), kRows) : n_kv;
  const int w = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + kRows * w;   // the warpgroup's first row

  auto load_kv = [&](int j) {       // k/v tile j into stage j % kStages
    const int s = j % kStages;
    h::mbar_arrive_expect_tx(&full[s], 2 * T::kTile);
#pragma unroll
    for (int c = 0; c < T::kHalves; ++c) {
      h::tma_load_4d(k_s + s * T::kTile + c * T::kStep, &tk, &full[s], 64 * c,
                     kvh, j * kRows, b);
      h::tma_load_4d(v_s + s * T::kTile + c * T::kStep, &tv, &full[s], 64 * c,
                     kvh, j * kRows, b);
    }
  };
  if (threadIdx.x == 0) {
    h::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], 8);   // lane 0 of every warp
    }
    h::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    h::mbar_arrive_expect_tx(qbar, 2 * T::kBlockTile);
#pragma unroll
    for (int c = 0; c < T::kHalves; ++c) {
      h::tma_load_4d(q_s + c * T::kBlockStep, &tq, qbar, 64 * c, hq, q0, b);
      h::tma_load_4d(do_s + c * T::kBlockStep, &tdo, qbar, 64 * c, hq, q0, b);
    }
    for (int j = 0; j < min(kStages, nk); ++j) load_kv(j);
  }
  const int64_t bh = (static_cast<int64_t>(b) * a.hq + hq) * a.seq;
  float lse2[2], dl_r[2];           // lse * log2(e) and delta of two rows
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int row = qw0 + 16 * warp + g + 8 * v;
    lse2[v] = row < a.seq ? a.lse[bh + row] * kLog2e : 0.f;
    dl_r[v] = row < a.seq ? a.delta[bh + row] : 0.f;
  }
  const float scale2 = a.scale * kLog2e;
  const uint32_t qa = h::smem_u32(q_s) + kRows * 128 * w;
  const uint32_t doa = h::smem_u32(do_s) + kRows * 128 * w;
  float dq[D / 2], s[32], dp[32];
  uint32_t ds[4][4] = {};           // dS of the last tile computed
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  // ds holds dS of tile j - 1 (zeros if that tile added nothing), whose
  // dQ product step j issues with the tile's k from its stage
  uint32_t prev_kb = h::smem_u32(k_s);
  h::mbar_wait(qbar, 0);
  // At d 64 the warp's rows of Q and dO stay in registers as A fragments:
  // S and dP then read only K and V from shared memory.
  HeldFrags<D> qf, dof;
  if constexpr (D == 64) {
    load_frags(qf.f, h::smem_u32(q_s), kRows * w + 16 * warp);
    load_frags(dof.f, h::smem_u32(do_s), kRows * w + 16 * warp);
  }
  // Step j issues S and dP of tile j, then dQ += dS K of tile j - 1, and
  // waits for S alone: the exp pass runs under dP and the dQ product.
  // Every product is issued on every step (a skipped tile's S and dP go
  // unused, its dS is zeros): a wgmma issued under a branch makes ptxas
  // serialise them all.
  for (int j = 0; j < nk; ++j) {
    if (threadIdx.x == 0 && j >= 2 && j + kStages - 2 < nk) {
      // both warpgroups released tile j - 2's stage in step j - 1
      h::mbar_wait(&empty[(j - 2) % kStages], ((j - 2) / kStages) & 1);
      load_kv(j + kStages - 2);
    }
    __syncwarp();
    const int stage = j % kStages;
    h::mbar_wait(&full[stage], (j / kStages) & 1);
    const int k0 = j * kRows;
    // a warpgroup whose rows are past the end, or all above the diagonal
    // of this tile, has nothing to add
    const bool live = qw0 < a.seq && (!a.causal || k0 <= qw0);
    const uint32_t kb = h::smem_u32(k_s + stage * T::kTile);
    const uint32_t vb = h::smem_u32(v_s + stage * T::kTile);
    h::fence_operands(s);
    h::fence_operands(dp);
    h::fence_operands(dq);
    fence_frags(ds);
    h::wgmma_fence();
    if constexpr (D == 64)
      mma_fbt(s, qf.f, kb, T::kStep);
    else
      mma_abt<D>(s, qa, T::kBlockStep, kb, T::kStep);
    h::wgmma_commit();
    if constexpr (D == 64)
      mma_fbt(dp, dof.f, vb, T::kStep);
    else
      mma_abt<D>(dp, doa, T::kBlockStep, vb, T::kStep);
    h::wgmma_commit();
    mma_fb<D>(dq, ds, prev_kb, T::kStep);
    h::wgmma_commit();
    h::wgmma_wait<2>();             // S has landed
    h::fence_operands(s);
    if (live) {
      const bool masked = (a.causal && k0 == qw0) || k0 + kRows > a.seq ||
                          qw0 + kRows > a.seq;
      exp_scores(
          s, scale2, masked, [&](int i) { return lse2[(i >> 1) & 1]; },
          [&](int i) {
            return visible(qw0, 16 * warp + g + 8 * ((i >> 1) & 1), k0,
                           8 * (i >> 2) + 2 * t + (i & 1), a.seq, a.causal);
          });
    }
    h::wgmma_wait<0>();             // dP, and dQ of tile j - 1, have landed
    h::fence_operands(dp);
    h::fence_operands(dq);
    fence_frags(ds);
    if (j > 0) {                    // tile j - 1's k and v are read
      __syncwarp();
      if (lane == 0) h::mbar_arrive(&empty[(j - 1) % kStages]);
    }
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = 4 * j8 + 2 * v;
        fill_frag(ds, j8, v,
                  live ? s[i] * (dp[i] - dl_r[v]) * a.scale : 0.f,
                  live ? s[i + 1] * (dp[i + 1] - dl_r[v]) * a.scale : 0.f);
      }
    prev_kb = kb;
  }
  h::fence_operands(dq);
  fence_frags(ds);
  h::wgmma_fence();
  mma_fb<D>(dq, ds, prev_kb, T::kStep);
  h::wgmma_commit();
  h::wgmma_wait<0>();
  h::fence_operands(dq);
  const int64_t row = static_cast<int64_t>(a.hq) * D;
  const float one[2] = {1.f, 1.f};
  ptt::store_acc<D>(static_cast<bf16*>(a.dq) + static_cast<int64_t>(b) * a.seq *
                   row + static_cast<int64_t>(hq) * D,
               row, reinterpret_cast<float(*)[4]>(dq), q0, one, a.seq);
}

// dk, dv: grid (Hk, B, k tiles of 128), the heaviest causal tiles first.
// Warpgroup w owns keys 64 w.. of the block, K and V loaded once; the
// block walks its (query head of the group, q tile of 64) pairs as one
// stream through a ring of (Q, dO, lse, delta) stages. Rows of the
// products are keys: S^T = K Q^T and dP^T = V dO^T (SS, Q and dO
// K-major), P^T and dS^T in registers (lse and delta by column), then
// dV += P^T dO and dK += dS^T Q (RS, dO and Q read MN-major: the same
// tiles, no transposed copy).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tlse,
    const __grid_constant__ CUtensorMap tdl, const Args a, int lse_at,
    int dl_at) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s =
      smem_raw + ((1024 - (h::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* v_s = k_s + T::kBlockTile;
  unsigned char* q_s = v_s + T::kBlockTile;
  unsigned char* do_s = q_s + kStages * T::kTile;
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * T::kTile);
  float* dl_s = lse_s + kStages * kRows;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(dl_s + kStages * kRows);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockRows;
  const int group = a.hq / a.hk;
  const int nq = cdiv(a.seq, kRows);
  const int i0 = a.causal ? k0 / kRows : 0;   // the first q tile that sees k0
  const int per_head = nq - i0;
  const int total = group * per_head;
  const int w = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + kRows * w;   // the warpgroup's first key

  auto load_q = [&](int it) {       // step `it` into stage it % kStages
    const int s = it % kStages;
    const int hq = kvh * group + it / per_head;
    const int q0 = (i0 + it % per_head) * kRows;
    const int row = (b * a.hq + hq) * a.seq + q0;
    h::mbar_arrive_expect_tx(&full[s], 2 * T::kTile + 2 * kLseBytes);
#pragma unroll
    for (int c = 0; c < T::kHalves; ++c) {
      h::tma_load_4d(q_s + s * T::kTile + c * T::kStep, &tq, &full[s],
                     64 * c, hq, q0, b);
      h::tma_load_4d(do_s + s * T::kTile + c * T::kStep, &tdo, &full[s],
                     64 * c, hq, q0, b);
    }
    h::tma_load_1d(lse_s + s * kRows, &tlse, &full[s], lse_at + row);
    h::tma_load_1d(dl_s + s * kRows, &tdl, &full[s], dl_at + row);
  };
  if (threadIdx.x == 0) {
    h::mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], 8);   // lane 0 of every warp
    }
    h::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    h::mbar_arrive_expect_tx(kvbar, 2 * T::kBlockTile);
#pragma unroll
    for (int c = 0; c < T::kHalves; ++c) {
      h::tma_load_4d(k_s + c * T::kBlockStep, &tk, kvbar, 64 * c, kvh, k0, b);
      h::tma_load_4d(v_s + c * T::kBlockStep, &tv, kvbar, 64 * c, kvh, k0, b);
    }
    for (int it = 0; it < min(kStages, total); ++it) load_q(it);
  }
  const uint32_t ka = h::smem_u32(k_s) + kRows * 128 * w;
  const uint32_t va = h::smem_u32(v_s) + kRows * 128 * w;
  const float scale2 = a.scale * kLog2e;
  float dk[D / 2], dv[D / 2], st[32], dpt[32];
  uint32_t pt[4][4] = {}, dst[4][4] = {};   // P^T, dS^T of the last step
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  // pt, dst hold P^T, dS^T of step it - 1 (zeros if that step added
  // nothing), whose products step `it` issues with the step's Q and dO
  uint32_t prev_qb = h::smem_u32(q_s), prev_dob = h::smem_u32(do_s);
  h::mbar_wait(kvbar, 0);
  HeldFrags<D> kf, vf;              // K and V as A fragments at d 64
  if constexpr (D == 64) {
    load_frags(kf.f, h::smem_u32(k_s), kRows * w + 16 * warp);
    load_frags(vf.f, h::smem_u32(v_s), kRows * w + 16 * warp);
  }
  // Step `it` issues S^T and dP^T of step it, then dV += P^T dO and dK +=
  // dS^T Q of step it - 1, and waits for S^T alone: the exp pass runs
  // under dP^T and the two products. Every product is issued on every
  // step, as in the dq kernel.
  for (int it = 0; it < total; ++it) {
    if (threadIdx.x == 0 && it >= 2 && it + kStages - 2 < total) {
      // both warpgroups released step it - 2's stage in step it - 1
      h::mbar_wait(&empty[(it - 2) % kStages], ((it - 2) / kStages) & 1);
      load_q(it + kStages - 2);
    }
    __syncwarp();
    const int s = it % kStages;
    h::mbar_wait(&full[s], (it / kStages) & 1);
    const int q0 = (i0 + it % per_head) * kRows;
    // keys past the end, or a q tile wholly above this warpgroup's keys,
    // add nothing
    const bool live = kw0 < a.seq && (!a.causal || q0 >= kw0);
    const uint32_t qb = h::smem_u32(q_s + s * T::kTile);
    const uint32_t dob = h::smem_u32(do_s + s * T::kTile);
    h::fence_operands(st);
    h::fence_operands(dpt);
    h::fence_operands(dv);
    h::fence_operands(dk);
    fence_frags(pt);
    fence_frags(dst);
    h::wgmma_fence();
    // At d 128, P^T and dS^T in flight through the exp pass would not fit
    // beside dK, dV, S^T and dP^T: there dV's product goes first and lands
    // with S^T (groups complete in order), so only dS^T stays in flight.
    if constexpr (D == 128) {
      mma_fb<D>(dv, pt, prev_dob, T::kStep);
      h::wgmma_commit();
    }
    if constexpr (D == 64)
      mma_fbt(st, kf.f, qb, T::kStep);
    else
      mma_abt<D>(st, ka, T::kBlockStep, qb, T::kStep);
    h::wgmma_commit();
    if constexpr (D == 64)
      mma_fbt(dpt, vf.f, dob, T::kStep);
    else
      mma_abt<D>(dpt, va, T::kBlockStep, dob, T::kStep);
    h::wgmma_commit();
    if constexpr (D == 64) mma_fb<D>(dv, pt, prev_dob, T::kStep);
    mma_fb<D>(dk, dst, prev_qb, T::kStep);
    h::wgmma_commit();
    const float* dl_b = dl_s + s * kRows;
    h::wgmma_wait<2>();             // S^T has landed (and dV at d 128)
    h::fence_operands(st);
    if (live) {
      const float* lse_b = lse_s + s * kRows;
      const bool masked = (a.causal && q0 == kw0) || q0 + kRows > a.seq ||
                          kw0 + kRows > a.seq;
      // lse by column, read where it is used: held in registers beside
      // the fragments in flight it would spill at d 128
      exp_scores(
          st, scale2, masked,
          [&](int i) {
            return lse_b[8 * (i >> 2) + 2 * t + (i & 1)] * kLog2e;
          },
          [&](int i) {
            return visible(q0, 8 * (i >> 2) + 2 * t + (i & 1), kw0,
                           16 * warp + g + 8 * ((i >> 1) & 1), a.seq,
                           a.causal);
          });
    }
    h::wgmma_wait<0>();             // dP^T and step it - 1's products landed
    h::fence_operands(dpt);
    h::fence_operands(dv);
    h::fence_operands(dk);
    fence_frags(pt);
    fence_frags(dst);
    if (it > 0) {                   // step it - 1's Q and dO are read
      __syncwarp();
      if (lane == 0) h::mbar_arrive(&empty[(it - 1) % kStages]);
    }
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const float2 dl = *reinterpret_cast<const float2*>(dl_b + 8 * j8 +
                                                         2 * t);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = 4 * j8 + 2 * v;
        fill_frag(pt, j8, v, live ? st[i] : 0.f, live ? st[i + 1] : 0.f);
        fill_frag(dst, j8, v,
                  live ? st[i] * (dpt[i] - dl.x) * a.scale : 0.f,
                  live ? st[i + 1] * (dpt[i + 1] - dl.y) * a.scale : 0.f);
      }
    }
    prev_qb = qb;
    prev_dob = dob;
  }
  h::fence_operands(dv);
  h::fence_operands(dk);
  fence_frags(pt);
  fence_frags(dst);
  h::wgmma_fence();
  mma_fb<D>(dv, pt, prev_dob, T::kStep);
  mma_fb<D>(dk, dst, prev_qb, T::kStep);
  h::wgmma_commit();
  h::wgmma_wait<0>();
  h::fence_operands(dv);
  h::fence_operands(dk);
  const int64_t krow = static_cast<int64_t>(a.hk) * D;
  const int64_t dense = static_cast<int64_t>(b) * a.seq * krow +
                        static_cast<int64_t>(kvh) * D;
  const float one[2] = {1.f, 1.f};
  ptt::store_acc<D>(static_cast<bf16*>(a.dk) + dense, krow,
               reinterpret_cast<float(*)[4]>(dk), k0, one, a.seq);
  ptt::store_acc<D>(static_cast<bf16*>(a.dv) + dense, krow,
               reinterpret_cast<float(*)[4]>(dv), k0, one, a.seq);
}

// A (B, S, H, D) bf16 tensor with element strides st (batch, sequence,
// head; the head dim dense) as a 4-D map (D, H, S, B) read in boxes of
// 64 columns x `rows` rows of one head. TMA takes no stride of 0; a dim
// of extent 1 is never stepped, so a 0 there becomes 16 bytes.
cudaError_t encode_bshd(CUtensorMap* map, const void* p, int batch, int seq,
                        int heads, int d, const int64_t (&st)[3],
                        int rows) {
  const uint64_t dims[4] = {uint64_t(d), uint64_t(heads), uint64_t(seq),
                            uint64_t(batch)};
  auto bytes = [](int64_t s) { return s == 0 ? uint64_t(16) : uint64_t(s) * 2; };
  const uint64_t strides[3] = {bytes(st[2]), bytes(st[1]), bytes(st[0])};
  const uint32_t box[4] = {64, 1, uint32_t(rows), 1};
  return ptt::encode_tmap(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// n f32 values at p (4-byte aligned) as a 1-D map in boxes of 64. TMA
// wants a 16-byte-aligned base: the map starts at p rounded down, and
// element i of p is coordinate *at + i.
cudaError_t encode_vals(CUtensorMap* map, const float* p, int64_t n,
                        int* at) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  *at = static_cast<int>((addr & 15) / 4);
  const uint64_t dims[1] = {uint64_t(n + *at)};
  const uint32_t box[1] = {kRows};
  return ptt::encode_tmap(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                          reinterpret_cast<const void*>(addr & ~uintptr_t(15)),
                          dims, nullptr, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int Kind, int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  using T = Tiles<D>;
  // rows a box: q (and dO) 64 in dk/dv, else the block's 128; k and v 64
  // in dq, else 128
  const int box = Kind == kDkv ? kRows
                  : (Kind == kFwd ? FwdTiles<D>::kQRows : kBlockRows);
  const int kv_box = Kind == kDq ? kRows : kBlockRows;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = encode_bshd(&tq, a.q, batch, a.seq, a.hq, D, a.qs, box)) ||
      (err = encode_bshd(&tk, a.k, batch, a.seq, a.hk, D, a.ks, kv_box)) ||
      (err = encode_bshd(&tv, a.v, batch, a.seq, a.hk, D, a.vs, kv_box)))
    return err;
  if constexpr (Kind == kFwd) {     // persistent: at most a block an SM
    int dev, sms;
    if ((err = cudaGetDevice(&dev)) ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)))
      return err;
    const int items = cdiv(a.seq, FwdTiles<D>::kQRows) * a.hq * batch;
    auto kern = flash_fwd_wgmma<D>;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(FwdTiles<D>::bytes))))
      return err;
    kern<<<items < sms ? items : sms, FwdTiles<D>::kThreads,
           FwdTiles<D>::bytes, stream>>>(
        tq, tk, tv, a, batch);
    return cudaGetLastError();
  }
  const int64_t qd[3] = {int64_t(a.seq) * a.hq * D, int64_t(a.hq) * D, D};
  if ((err = encode_bshd(&tdo, a.dout, batch, a.seq, a.hq, D, qd, box)))
    return err;
  const dim3 grid(Kind == kDq ? a.hq : a.hk, batch, cdiv(a.seq, kBlockRows));
  if constexpr (Kind == kDq) {
    auto kern = flash_dq_wgmma<D>;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(T::dq_bytes))))
      return err;
    kern<<<grid, kThreads, T::dq_bytes, stream>>>(tq, tk, tv, tdo, a);
  } else {
    const int64_t rows = int64_t(batch) * a.hq * a.seq;
    CUtensorMap tl, tdl;
    int lse_at, dl_at;
    if ((err = encode_vals(&tl, a.lse, rows, &lse_at)) ||
        (err = encode_vals(&tdl, a.delta, rows, &dl_at)))
      return err;
    auto kern = flash_dkv_wgmma<D>;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(T::dkv_bytes))))
      return err;
    kern<<<grid, kThreads, T::dkv_bytes, stream>>>(tq, tk, tv, tdo, tl, tdl,
                                                   a, lse_at, dl_at);
  }
  return cudaGetLastError();
}

}  // namespace wg


template <int Kind, typename T, int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return wg::launch<Kind, D>(a, batch, stream);
  using G = Geo<float, D>;
  const int rows = G::BM;
  const size_t bytes = Kind == kFwd ? G::fwd_bytes
                       : (Kind == kDq ? G::dq_bytes : G::dkv_bytes);
  void (*kern)(const Args) =
      Kind == kFwd ? flash_fwd_f32<D>
                   : (Kind == kDq ? flash_dq_f32<D> : flash_dkv_f32<D>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(Kind == kDkv ? a.hk : a.hq, batch,
                  (a.seq + rows - 1) / rows);
  kern<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int Kind>
int dispatch(const Args& a, int batch, int d, int dtype, void* stream) {
  if (a.hk <= 0 || a.hq % a.hk != 0 || a.seq < 0 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.seq == 0 || batch == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == ptt::kDtypeBF16 && d == 64)
    err = launch<Kind, bf16, 64>(a, batch, s);
  else if (dtype == ptt::kDtypeBF16 && d == 128)
    err = launch<Kind, bf16, 128>(a, batch, s);
  else if (dtype == ptt::kDtypeF32 && d == 64)
    err = launch<Kind, float, 64>(a, batch, s);
  else if (dtype == ptt::kDtypeF32 && d == 128)
    err = launch<Kind, float, 128>(a, batch, s);
  return static_cast<int>(err);
}

Args make_args(const void* q, const void* k, const void* v, int seq, int hq,
               int hk, const long long* strides, float scale, int causal) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
  }
  a.seq = seq;
  a.hq = hq;
  a.hk = hk;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

// The strides of q, k and v: (batch, sequence, head) each, in elements,
// in that order (9 values). out (B, S, Hq, D) dense in q's type;
// lse (B, Hq, S) f32.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int batch, int seq,
                             int hq, int hk, int d, long long qsb,
                             long long qss, long long qsh, long long ksb,
                             long long kss, long long ksh, long long vsb,
                             long long vss, long long vsh, float scale,
                             int causal, int dtype, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  Args a = make_args(q, k, v, seq, hq, hk, st, scale, causal);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return dispatch<kFwd>(a, batch, d, dtype, stream);
}

// dq (B, S, Hq, D) dense from dout (B, S, Hq, D) dense, lse and delta
// (B, Hq, S) f32.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int batch,
                                int seq, int hq, int hk, int d, long long qsb,
                                long long qss, long long qsh, long long ksb,
                                long long kss, long long ksh, long long vsb,
                                long long vss, long long vsh, float scale,
                                int causal, int dtype, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  Args a = make_args(q, k, v, seq, hq, hk, st, scale, causal);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return dispatch<kDq>(a, batch, d, dtype, stream);
}

// dk, dv (B, S, Hk, D) dense.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int batch, int seq, int hq, int hk, int d,
                                 long long qsb, long long qss, long long qsh,
                                 long long ksb, long long kss, long long ksh,
                                 long long vsb, long long vss, long long vsh,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  Args a = make_args(q, k, v, seq, hq, hk, st, scale, causal);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return dispatch<kDkv>(a, batch, d, dtype, stream);
}
