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
// Design: a block of 4 warps per (64-row q tile, q head, batch) for the
// forward and dq, per (64-row k tile, kv head, batch) for dk/dv; tiles of
// the other operand stream through shared memory (rows padded by 16
// bytes, so fragment loads do not conflict on banks). The causal forward
// and dq stop at the diagonal tile and dk/dv start there; the element mask
// runs only on the diagonal tile and on tiles holding the ragged edge.
// - bf16 (the training path): each warp owns 16 rows. The products run on
//   the tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate)
//   with every accumulator in registers, FlashAttention-2 style: the
//   scores of a tile stay in the accumulator fragments, the online
//   softmax runs on them (row max and sum by two quad shuffles), and they
//   become the A operand of the next product without touching shared
//   memory; operands read transposed come through ldmatrix .trans. dk/dv
//   work in the transposed orientation (rows are keys), so dS^T and P^T
//   are A operands too.
//   The streamed tiles are double-buffered through cp.async, so the
//   copy of the next tile runs under the products of this one.
// - f32: CUDA-core FMA loops over 32-row tiles with the accumulators in
//   shared memory (a checking path; the model trains in bf16).
// Blocks of the heaviest causal tiles launch first (see q_tile). wgmma,
// TMA and warp specialisation are later work.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Tile geometry for element type T and head_dim D: 64-row tiles in bf16,
// 32-row tiles in f32 (whose shared-memory path needs 4 bytes a value).
// Leading dimensions are in elements; k* sizes in bytes, each a multiple
// of 128; the *_bytes totals are the f32 kernels'.
template <typename T, int D>
struct Geo {
  static constexpr int BM = sizeof(T) == 2 ? 64 : 32;  // rows per tile
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

// ---------------------------------------------------------------------
// bf16 kernels: mma.sync m16n8k16 with register accumulators (the
// fragment helpers and cp.async loaders are in common.cuh)
// ---------------------------------------------------------------------

using ptt::c_to_a;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::frag_a;
using ptt::frag_b_trans;
using ptt::frag_bt;
using ptt::mma_bf16;
using ptt::store_acc;

// acc (16 x D per warp, D/8 n-tiles) += A (16 x 64, as 8 C tiles) . B, where
// B (64 x D) is a row-major tile read transposed
template <int D>
__device__ __forceinline__ void mma_c_b(float (*acc)[4], float (*c)[4],
                                        const bf16* b, int ld) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    c_to_a(a, c, kk);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t r[4];
      frag_b_trans(r, b, ld, 16 * kk, 16 * dn);
      mma_bf16(acc[2 * dn], a, r[0], r[1]);
      mma_bf16(acc[2 * dn + 1], a, r[2], r[3]);
    }
  }
}

// the shared row loaders at this file's tile geometry
template <int D>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                int64_t stride, int r0,
                                                int seq) {
  using G = Geo<bf16, D>;
  ptt::load_rows_async<G::BM, D, G::LDT, kThreads>(dst, src, stride, r0, seq);
}

template <int BM>
__device__ __forceinline__ void load_row_vals_async(float* dst,
                                                    const float* src, int r0,
                                                    int seq) {
  ptt::load_row_vals_async<BM, kThreads>(dst, src, r0, seq);
}

// bf16 tiles: 64 rows of D + 8. The streamed operand is double-buffered:
// the copy of tile j + 1 runs while tile j is computed. Forward: q, k[2],
// v[2]; dq: q, dO, k[2], v[2], lse and delta of its rows; dk/dv: k, v,
// q[2], dO[2], lse[2], delta[2].
template <int D>
struct MmaGeo : Geo<bf16, D> {
  using G = Geo<bf16, D>;
  static constexpr int kTile = static_cast<int>(G::kT / sizeof(bf16));
  static constexpr size_t fwd_bytes = 5 * G::kT;
  static constexpr size_t dq_bytes = 6 * G::kT + 2 * G::kRow;
  static constexpr size_t dkv_bytes = 6 * G::kT + 4 * G::kRow;
};

// Forward: grid (Hq, B, q tiles)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(const Args a) {
  using G = MmaGeo<D>;
  constexpr int BM = G::BM, LDT = G::LDT;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* q_s = cv.take<bf16>(G::kT);
  bf16* k_s = cv.take<bf16>(2 * G::kT);
  bf16* v_s = cv.take<bf16>(2 * G::kT);

  const int h = blockIdx.x, b = blockIdx.y, qt = q_tile();
  const int kvh = h / (a.hq / a.hk);
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {16 * warp + g, 16 * warp + g + 8};
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  load_rows<bf16, D>(q_s, qg, a.qs[1], q0, a.seq);
  load_rows_async<D>(k_s, kg, a.ks[1], 0, a.seq);
  load_rows_async<D>(v_s, vg, a.vs[1], 0, a.seq);
  cp_async_commit();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) frag_a(qf[kk], q_s, LDT, 16 * warp, 16 * kk);
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int n_kv = (a.seq + BM - 1) / BM;
  const int nk = a.causal ? min(qt + 1, n_kv) : n_kv;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BM;
    const int buf = (j & 1) * G::kTile;
    if (j + 1 < nk) {  // the other buffer was released by the last barrier
      load_rows_async<D>(k_s + G::kTile - buf, kg, a.ks[1], k0 + BM, a.seq);
      load_rows_async<D>(v_s + G::kTile - buf, vg, a.vs[1], k0 + BM, a.seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every thread
    const bf16* kb = k_s + buf;
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        frag_bt(b0, b1, kb, LDT, 8 * n, 16 * kk);
        mma_bf16(s[n], qf[kk], b0, b1);
      }
    const bool masked = (a.causal && j == qt) || k0 + BM > a.seq ||
                        q0 + BM > a.seq;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[n][e] * a.scale;
        if (masked && !visible(q0, rows[e >> 1], k0, 8 * n + 2 * t + (e & 1),
                               a.seq, a.causal))
          v = -INFINITY;
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * i] *= alpha;
        o[dn][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - mu[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;  // this lane's columns; the quad sums at the end
      }
    mma_c_b<D>(o, s, v_s + buf, LDT);
    __syncthreads();  // every warp is done with this buffer
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  const int64_t row = static_cast<int64_t>(a.hq) * D;
  store_acc<D>(static_cast<bf16*>(a.out) + static_cast<int64_t>(b) * a.seq * row +
                   static_cast<int64_t>(h) * D,
               row, o, q0, inv, a.seq);
  float* lg = a.lse_out + (static_cast<int64_t>(b) * a.hq + h) * a.seq;
  if (t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (q0 + rows[i] < a.seq) lg[q0 + rows[i]] = m[i] + logf(l[i]);
}

// dq: grid (Hq, B, q tiles)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_mma(const Args a) {
  using G = MmaGeo<D>;
  constexpr int BM = G::BM, LDT = G::LDT;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* q_s = cv.take<bf16>(G::kT);
  bf16* do_s = cv.take<bf16>(G::kT);
  bf16* k_s = cv.take<bf16>(2 * G::kT);
  bf16* v_s = cv.take<bf16>(2 * G::kT);
  float* lse_s = cv.take<float>(G::kRow);
  float* dl_s = cv.take<float>(G::kRow);

  const int h = blockIdx.x, b = blockIdx.y, qt = q_tile();
  const int kvh = h / (a.hq / a.hk);
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int rows[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};
  const int64_t row = static_cast<int64_t>(a.hq) * D;
  const int64_t dense = static_cast<int64_t>(b) * a.seq * row +
                        static_cast<int64_t>(h) * D;
  const int64_t bh = (static_cast<int64_t>(b) * a.hq + h) * a.seq;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  load_rows<bf16, D>(q_s, static_cast<const bf16*>(a.q) + b * a.qs[0] +
                              h * a.qs[2], a.qs[1], q0, a.seq);
  load_rows<bf16, D>(do_s, static_cast<const bf16*>(a.dout) + dense, row, q0,
                     a.seq);
  load_row_vals<BM>(lse_s, a.lse + bh, q0, a.seq);
  load_row_vals<BM>(dl_s, a.delta + bh, q0, a.seq);
  load_rows_async<D>(k_s, kg, a.ks[1], 0, a.seq);
  load_rows_async<D>(v_s, vg, a.vs[1], 0, a.seq);
  cp_async_commit();
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag_a(qf[kk], q_s, LDT, 16 * warp, 16 * kk);
    frag_a(dof[kk], do_s, LDT, 16 * warp, 16 * kk);
  }
  const float lse_r[2] = {lse_s[rows[0]], lse_s[rows[1]]};
  const float dl_r[2] = {dl_s[rows[0]], dl_s[rows[1]]};
  float dq[D / 8][4] = {};
  const int n_kv = (a.seq + BM - 1) / BM;
  const int nk = a.causal ? min(qt + 1, n_kv) : n_kv;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BM;
    const int buf = (j & 1) * G::kTile;
    if (j + 1 < nk) {
      load_rows_async<D>(k_s + G::kTile - buf, kg, a.ks[1], k0 + BM, a.seq);
      load_rows_async<D>(v_s + G::kTile - buf, vg, a.vs[1], k0 + BM, a.seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kb = k_s + buf;
    const bf16* vb = v_s + buf;
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        frag_bt(b0, b1, kb, LDT, 8 * n, 16 * kk);
        mma_bf16(s[n], qf[kk], b0, b1);
        frag_bt(b0, b1, vb, LDT, 8 * n, 16 * kk);
        mma_bf16(dp[n], dof[kk], b0, b1);
      }
    const bool masked = (a.causal && j == qt) || k0 + BM > a.seq ||
                        q0 + BM > a.seq;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = 0.f;
        if (!masked || visible(q0, rows[i], k0, 8 * n + 2 * t + (e & 1),
                               a.seq, a.causal))
          p = __expf(s[n][e] * a.scale - lse_r[i]);
        s[n][e] = p * (dp[n][e] - dl_r[i]) * a.scale;  // dS
      }
    mma_c_b<D>(dq, s, kb, LDT);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_acc<D>(static_cast<bf16*>(a.dq) + dense, row, dq, q0, one, a.seq);
}

// dk, dv: grid (Hk, B, k tiles). Rows of the products are keys: S^T =
// K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q. The block
// walks its (query head of the group, q tile) pairs as one stream.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_mma(const Args a) {
  using G = MmaGeo<D>;
  constexpr int BM = G::BM, LDT = G::LDT;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* k_s = cv.take<bf16>(G::kT);
  bf16* v_s = cv.take<bf16>(G::kT);
  bf16* q_s = cv.take<bf16>(2 * G::kT);
  bf16* do_s = cv.take<bf16>(2 * G::kT);
  float* lse_s = cv.take<float>(2 * G::kRow);
  float* dl_s = cv.take<float>(2 * G::kRow);

  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int group = a.hq / a.hk;
  const int k0 = kt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int keys[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};
  const int64_t qrow = static_cast<int64_t>(a.hq) * D;
  const int nq = (a.seq + BM - 1) / BM;
  const int i0 = a.causal ? kt : 0;  // the first q tile that sees k0
  const int per_head = nq - i0;
  const int total = group * per_head;
  // the copies of step `it` (query head, q tile) into buffer `buf`
  auto prefetch = [&](int it, int buf) {
    const int h = kvh * group + it / per_head;
    const int q0 = (i0 + it % per_head) * BM;
    const int64_t bh = (static_cast<int64_t>(b) * a.hq + h) * a.seq;
    load_rows_async<D>(q_s + buf * G::kTile,
                       static_cast<const bf16*>(a.q) + b * a.qs[0] +
                           h * a.qs[2],
                       a.qs[1], q0, a.seq);
    load_rows_async<D>(do_s + buf * G::kTile,
                       static_cast<const bf16*>(a.dout) +
                           static_cast<int64_t>(b) * a.seq * qrow +
                           static_cast<int64_t>(h) * D,
                       qrow, q0, a.seq);
    load_row_vals_async<BM>(lse_s + buf * BM, a.lse + bh, q0, a.seq);
    load_row_vals_async<BM>(dl_s + buf * BM, a.delta + bh, q0, a.seq);
    cp_async_commit();
  };
  load_rows<bf16, D>(k_s, static_cast<const bf16*>(a.k) + b * a.ks[0] +
                              kvh * a.ks[2], a.ks[1], k0, a.seq);
  load_rows<bf16, D>(v_s, static_cast<const bf16*>(a.v) + b * a.vs[0] +
                              kvh * a.vs[2], a.vs[1], k0, a.seq);
  prefetch(0, 0);
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {  // the other buffer was released by the barrier
      prefetch(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step's tiles (and k, v) have landed
    const int i = i0 + it % per_head;
    const int q0 = i * BM;
    const bf16* qb = q_s + buf * G::kTile;
    const bf16* dob = do_s + buf * G::kTile;
    const float* lse_b = lse_s + buf * BM;
    const float* dl_b = dl_s + buf * BM;
    float st[8][4] = {}, dpt[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4], vf[4];
      frag_a(kf, k_s, LDT, 16 * warp, 16 * kk);
      frag_a(vf, v_s, LDT, 16 * warp, 16 * kk);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        frag_bt(b0, b1, qb, LDT, 8 * n, 16 * kk);
        mma_bf16(st[n], kf, b0, b1);
        frag_bt(b0, b1, dob, LDT, 8 * n, 16 * kk);
        mma_bf16(dpt[n], vf, b0, b1);
      }
    }
    const bool masked = (a.causal && i == kt) || q0 + BM > a.seq ||
                        k0 + BM > a.seq;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = 8 * n + 2 * t + (e & 1);
        float p = 0.f;
        if (!masked || visible(q0, qr, k0, keys[e >> 1], a.seq, a.causal))
          p = __expf(st[n][e] * a.scale - lse_b[qr]);
        st[n][e] = p;                                      // P^T
        dpt[n][e] = p * (dpt[n][e] - dl_b[qr]) * a.scale;  // dS^T
      }
    mma_c_b<D>(dv, st, dob, LDT);
    mma_c_b<D>(dk, dpt, qb, LDT);
    __syncthreads();  // every warp is done with this buffer
  }
  const int64_t krow = static_cast<int64_t>(a.hk) * D;
  const int64_t dense = static_cast<int64_t>(b) * a.seq * krow +
                        static_cast<int64_t>(kvh) * D;
  const float one[2] = {1.f, 1.f};
  store_acc<D>(static_cast<bf16*>(a.dk) + dense, krow, dk, k0, one, a.seq);
  store_acc<D>(static_cast<bf16*>(a.dv) + dense, krow, dv, k0, one, a.seq);
}

constexpr int kFwd = 0, kDq = 1, kDkv = 2;

template <int Kind, typename T, int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  void (*kern)(const Args);
  size_t bytes;
  int rows;
  if constexpr (std::is_same_v<T, bf16>) {
    using G = MmaGeo<D>;
    rows = G::BM;
    bytes = Kind == kFwd ? G::fwd_bytes
                         : (Kind == kDq ? G::dq_bytes : G::dkv_bytes);
    kern = Kind == kFwd ? flash_fwd_mma<D>
                        : (Kind == kDq ? flash_dq_mma<D> : flash_dkv_mma<D>);
  } else {
    using G = Geo<float, D>;
    rows = G::BM;
    bytes = Kind == kFwd ? G::fwd_bytes
                         : (Kind == kDq ? G::dq_bytes : G::dkv_bytes);
    kern = Kind == kFwd ? flash_fwd_f32<D>
                        : (Kind == kDq ? flash_dq_f32<D> : flash_dkv_f32<D>);
  }
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
