// Fused RMSNorm(+residual add), its backward, and RoPE apply.
//
// The two RMSNorm kernels share one layout, which kernels/fused_norm.py
// `plan(n, d, dtype)` chooses and passes in: a team of threads_per_row
// threads (a power of two) holds one row, rows_per_block teams share a
// block, and thread t of a team owns the chunks t, t + tpr, t + 2 tpr, ...
// of its row, `chunks` of them at most. A chunk is one 16-byte access (8
// bf16 or 4 f32 values) in the vector instance and one element in the
// scalar instance, which runs the same design where d * sizeof(T) is not
// a multiple of 16 or a base pointer is not 16-byte aligned (a contiguous
// view at an offset). Neighbouring threads touch neighbouring chunks, so
// every access of a warp is coalesced. A team of a warp or less reduces by
// shuffles alone; a wider team adds its warps' sums in a fixed order
// through shared memory behind a barrier of its own warps (a named
// barrier), so the rows of a block never wait for each other. Sums are
// taken in one fixed order for a given plan: the same inputs give the same
// bits from call to call.
//
// ---------------------------------------------------------------------
// RMSNorm + residual, forward
// Replaces: paddle_tpu/kernels/fused_norm.py:_rmsn_fwd_kernel and
// _rmsn_fwd_kernel_nores (reached through _rmsn_fwd_pallas at :185).
//
// Bound on this card: bytes. Per row it must read x (and the residual)
// and write y (and h = x + residual): 2 or 4 row passes of d elements
// with the weight row shared; a handful of flops per element. At the
// decode shape (8 rows of 4096) there are too few bytes to fill the card,
// and the kernel's time is the latency of one load, one reduction and one
// store.
//
// Design: every load of the row (x, the residual and the weight) is
// issued first, as 16-byte accesses into registers; the row stays in
// registers, never in shared memory. h = x + residual is rounded to the
// input type (the JAX op adds in that type) and written, and the f32 sum
// of its squares reduced over the team; after the reduction nothing is
// read from device memory again: y = (h * rstd) * w in f32 (__fmul_rn, no
// contraction), rounded once, is written from the registers. The f32
// rstd of each row is written only when asked for (training keeps it for
// the backward; serving does not). The plan takes a team of up to 512
// threads a row with one or two chunks a thread when there are few rows
// (decode: the shortest chain of dependent steps), and four chunks a
// thread with several rows a block when there are many (training and
// prefill: enough bytes in flight on every SM).
//
// ---------------------------------------------------------------------
// RMSNorm backward
// Replaces: paddle_tpu/kernels/fused_norm.py:_rmsn_bwd_kernel (launched
// through _rmsn_bwd_pallas at :225).
//
// dh = rstd * (gy * w - xhat * mean(gy * w * xhat)) + gh with
// xhat = h * rstd, f32 math rounded once to the input type; dw = sum over
// rows of gy * xhat.
//
// Bound on this card: bytes. It must read h and gy (and gh) and write
// dh: 3 or 4 row passes of d elements, plus the f32 rstd per row.
//
// Design: a grid sized to the card (the plan: one 512-thread block an
// SM, two chunks a thread) walks the row groups with a stride. The
// weight row is loaded once a block into registers. Per row, h, gy (and gh) are loaded once, as
// 16-byte accesses into registers, the mean is reduced over the team, and
// dh is written from the registers: no second pass, no block-wide barrier
// a row (a wide team's exchange alternates between two sets of slots, so
// one barrier of the team's warps a row is enough). Each thread owns the
// same columns throughout and adds gy * xhat of its rows into f32
// registers; at the end the block's teams add their columns into one
// shared-memory row in team order and the block writes its (d,) f32
// partial, which the wrapper sums over the blocks in a fixed order, so dw
// is deterministic. Limit: d <= 12032 (that row within 48 KB).
//
// ---------------------------------------------------------------------
// RoPE (NeoX / Llama half-split rotation)
// Replaces: paddle_tpu/kernels/fused_norm.py:_rope_kernel (launched by
// _rope_pallas at :380; the backward, with the sin table negated, at
// :415).
//
// out = x * cos_f + roll(x, d/2) * (sign * sin_f), f32 math rounded once
// to x's type, for x (rows, heads, d) and the f32 tables cos_f, sin_f
// (rows, d) = (cat(cos, cos), cat(-sin, sin)). sign is 1 for the forward
// and -1 for the backward (the inverse rotation): negation is exact, so
// the backward needs no negated copy of the table and its result has the
// bits of a launch on -sin_f.
//
// Bound on this card: bytes: x read once and written once, plus the two
// (rows, d) f32 tables once; two multiplies and one add per element.
//
// Design: a team of threads owns one token row of the tables and walks
// all of that token's heads (at decode, with fewer tokens than the card
// has SMs to spare, a group of them, so the launch still spreads over
// the SMs). Thread p of a head slot owns the column pair (c, c + d/2) of
// kV columns, c = kV p (kV = 8 bf16 or 4 f32 values: 16 bytes), so it
// reads each x once, both halves of a head row as 16-byte loads, and
// writes both outputs as 16-byte stores; neighbouring threads touch
// neighbouring chunks. It loads its share of the token's cos_f / sin_f
// rows (both halves) into registers once, issued after its first heads'
// x so that both are in flight together, and reuses it for every head of
// its slot, two heads in flight a thread (four took 139 registers a
// thread, and ran slower), one where the launch has too few threads
// for two. A block is never narrower than a warp. The scalar
// instance (kV 1) runs the same design where d/2 is not a multiple of kV
// or a pointer is not 16-byte aligned. Index math within a row is 32-bit;
// only the row base is 64-bit. The products and the sum are rounded
// separately (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain
// version computes them, so the result is bit-equal to it; the sign
// multiplies the product, not the table, so nothing waits on the table
// before the x loads are issued.
#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxNormD = 12032;  // the backward's dw row within 48 KB
constexpr int kMaxBlock = 512;    // threads a block (and a team) at most
constexpr int kRopeThreads = 256;
constexpr int kRopeHeads = 2;         // heads in flight a thread at most
// threads an H100 SXM holds at once (132 SMs x 2048): fewer heads a
// thread until a launch has that many, where the shape allows
constexpr int64_t kRopeFill = 132 * 2048;
// blocks a small launch (decode) is spread over at least, its tokens'
// heads split into groups of their own blocks
constexpr int kRopeBlocks = 2 * 132;

// kV consecutive values of T moved by one access: 16 bytes in the vector
// instance, one element in the scalar one.
template <typename T, int kV>
struct alignas(sizeof(T) * kV) Chunk {
  T v[kV];
};

template <typename T, int kV>
__device__ __forceinline__ Chunk<T, kV> load_chunk(const T* p) {
  Chunk<T, kV> c;
  if constexpr (sizeof(c) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(&c, &u, sizeof(c));
  } else {
    c.v[0] = *p;
  }
  return c;
}

template <typename T, int kV>
__device__ __forceinline__ void store_chunk(T* p, const Chunk<T, kV>& c) {
  if constexpr (sizeof(c) == 16) {
    uint4 u;
    memcpy(&u, &c, sizeof(c));
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = c.v[0];
  }
}

__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Sum of v over the team of tpr threads (a power of two) that holds one
// row; every thread of the team gets the total. Every thread of the block
// must call it. A team of a warp or less reduces by shuffles within its
// lanes; a wider team writes one sum a warp into `slot` (one float a warp
// of the block) and adds its warps' sums in warp order after a barrier
// of its own warps (named barrier 1 + team; barrier 0 is __syncthreads).
__device__ __forceinline__ float team_sum(float v, int tpr, float* slot) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x >> 5;
  const int warps = tpr >> 5;
  const int first = warp - warp % warps;
  if ((threadIdx.x & 31) == 0) slot[warp] = v;
  team_barrier(1 + warp / warps, tpr);
  float total = 0.f;
  for (int i = 0; i < warps; ++i) total += slot[first + i];
  return total;
}

// One row a team: y (and h when kRes, and the f32 rstd when rstd_out is
// not null). kK chunks of kV values a thread at most.
template <typename T, int kV, int kK, bool kRes>
__global__ void __launch_bounds__(kMaxBlock) rmsn_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const T* __restrict__ w, T* __restrict__ y, T* __restrict__ h,
    float* __restrict__ rstd_out, int n, int d, int tpr, float eps) {
  __shared__ float slot[kMaxBlock / 32];
  const int t = threadIdx.x & (tpr - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / tpr) +
                      threadIdx.x / tpr;
  const bool live = row < n;
  const int64_t off = row * d;
  Chunk<T, kV> xc[kK], rc[kK], wc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {  // every load, before the reduction
    const int c = (k * tpr + t) * kV;
    if (live && c < d) {
      xc[k] = load_chunk<T, kV>(x + off + c);
      if constexpr (kRes) rc[k] = load_chunk<T, kV>(res + off + c);
      wc[k] = load_chunk<T, kV>(w + c);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int c = (k * tpr + t) * kV;
    if (live && c < d) {
      if constexpr (kRes) {
#pragma unroll
        for (int i = 0; i < kV; ++i)
          xc[k].v[i] = ptt::from_f32<T>(__fadd_rn(ptt::to_f32(xc[k].v[i]),
                                                  ptt::to_f32(rc[k].v[i])));
        store_chunk<T, kV>(h + off + c, xc[k]);
      }
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const float hv = ptt::to_f32(xc[k].v[i]);
        ss += hv * hv;
      }
    }
  }
  ss = team_sum(ss, tpr, slot);
  const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
  if (rstd_out != nullptr && live && t == 0) rstd_out[row] = rstd;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int c = (k * tpr + t) * kV;
    if (live && c < d) {
      Chunk<T, kV> yc;
#pragma unroll
      for (int i = 0; i < kV; ++i)
        yc.v[i] = ptt::from_f32<T>(__fmul_rn(
            __fmul_rn(ptt::to_f32(xc[k].v[i]), rstd),
            ptt::to_f32(wc[k].v[i])));
      store_chunk<T, kV>(y + off + c, yc);
    }
  }
}

// The block walks row groups blockIdx.x, blockIdx.x + gridDim.x, ...,
// one row a team each; dw_part gets the block's (d,) dw partial.
template <typename T, int kV, int kK, bool kGh>
__global__ void __launch_bounds__(kMaxBlock) rmsn_bwd_kernel(
    const T* __restrict__ h, const T* __restrict__ w,
    const float* __restrict__ rstd, const T* __restrict__ gy,
    const T* __restrict__ gh, T* __restrict__ dh,
    float* __restrict__ dw_part, int n, int d, int tpr) {
  extern __shared__ float dw_row[];  // (d,) the block's dw
  __shared__ float slots[2][kMaxBlock / 32];
  const int rows = blockDim.x / tpr;
  const int team = threadIdx.x / tpr;
  const int t = threadIdx.x & (tpr - 1);
  const float inv_d = 1.f / static_cast<float>(d);
  Chunk<T, kV> wc[kK];
  float dw[kK][kV];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int c = (k * tpr + t) * kV;
    if (c < d) wc[k] = load_chunk<T, kV>(w + c);
#pragma unroll
    for (int i = 0; i < kV; ++i) dw[k][i] = 0.f;
  }
  int parity = 0;
  for (int64_t g = blockIdx.x; g * rows < n; g += gridDim.x, parity ^= 1) {
    const int64_t row = g * rows + team;
    const bool live = row < n;
    const int64_t off = row * d;
    Chunk<T, kV> hc[kK], gc[kK], ghc[kK];
    const float rs = live ? rstd[row] : 0.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {  // the row's loads, all before the sum
      const int c = (k * tpr + t) * kV;
      if (live && c < d) {
        hc[k] = load_chunk<T, kV>(h + off + c);
        gc[k] = load_chunk<T, kV>(gy + off + c);
        if constexpr (kGh) ghc[k] = load_chunk<T, kV>(gh + off + c);
      }
    }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c = (k * tpr + t) * kV;
      if (live && c < d) {
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float xhat = ptt::to_f32(hc[k].v[i]) * rs;
          acc += ptt::to_f32(gc[k].v[i]) * ptt::to_f32(wc[k].v[i]) * xhat;
        }
      }
    }
    const float mean = team_sum(acc, tpr, slots[parity]) * inv_d;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int c = (k * tpr + t) * kV;
      if (live && c < d) {
        Chunk<T, kV> out;
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float xhat = ptt::to_f32(hc[k].v[i]) * rs;
          const float g = ptt::to_f32(gc[k].v[i]);
          float v = rs * (g * ptt::to_f32(wc[k].v[i]) - xhat * mean);
          if constexpr (kGh) v += ptt::to_f32(ghc[k].v[i]);
          out.v[i] = ptt::from_f32<T>(v);
          dw[k][i] += g * xhat;
        }
        store_chunk<T, kV>(dh + off + c, out);
      }
    }
  }
  // the block's dw: the teams add their columns in team order
  for (int j = 0; j < rows; ++j) {
    if (team == j) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const int c = (k * tpr + t) * kV;
        if (c < d) {
#pragma unroll
          for (int i = 0; i < kV; ++i)
            dw_row[c + i] = (j == 0 ? 0.f : dw_row[c + i]) + dw[k][i];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    dw_part[static_cast<int64_t>(blockIdx.x) * d + c] = dw_row[c];
}

struct NormArgs {
  const void* a;    // x (forward) or h (backward)
  const void* b;    // residual or gy
  const void* c;    // null or gh (backward)
  const void* w;
  void* out;        // y or dh
  void* h;          // h (forward, with a residual)
  float* rstd;      // written (forward, may be null) or read (backward)
  float* dw_part;   // (blocks, d) (backward)
  int n, d, tpr, rows, blocks;
  float eps;
  cudaStream_t stream;
};

template <typename T, int kV, int kK>
void launch_fwd(const NormArgs& a) {
  const dim3 grid(a.blocks), block(a.tpr * a.rows);
  if (a.b != nullptr)
    rmsn_fwd_kernel<T, kV, kK, true><<<grid, block, 0, a.stream>>>(
        static_cast<const T*>(a.a), static_cast<const T*>(a.b),
        static_cast<const T*>(a.w), static_cast<T*>(a.out),
        static_cast<T*>(a.h), a.rstd, a.n, a.d, a.tpr, a.eps);
  else
    rmsn_fwd_kernel<T, kV, kK, false><<<grid, block, 0, a.stream>>>(
        static_cast<const T*>(a.a), nullptr, static_cast<const T*>(a.w),
        static_cast<T*>(a.out), nullptr, a.rstd, a.n, a.d, a.tpr, a.eps);
}

template <typename T, int kV, int kK>
void launch_bwd(const NormArgs& a) {
  const dim3 grid(a.blocks), block(a.tpr * a.rows);
  const size_t smem = sizeof(float) * a.d;
  if (a.c != nullptr)
    rmsn_bwd_kernel<T, kV, kK, true><<<grid, block, smem, a.stream>>>(
        static_cast<const T*>(a.a), static_cast<const T*>(a.w), a.rstd,
        static_cast<const T*>(a.b), static_cast<const T*>(a.c),
        static_cast<T*>(a.out), a.dw_part, a.n, a.d, a.tpr);
  else
    rmsn_bwd_kernel<T, kV, kK, false><<<grid, block, smem, a.stream>>>(
        static_cast<const T*>(a.a), static_cast<const T*>(a.w), a.rstd,
        static_cast<const T*>(a.b), nullptr, static_cast<T*>(a.out),
        a.dw_part, a.n, a.d, a.tpr);
}

template <typename T, int kV, int kK, bool kBwd>
void launch(const NormArgs& a) {
  if constexpr (kBwd)
    launch_bwd<T, kV, kK>(a);
  else
    launch_fwd<T, kV, kK>(a);
}

// The instance for (type, vector or scalar, chunks): the vector instance
// is compiled for 1, 2, 4 and 8 chunks a thread, the scalar one also for
// 16 and 24 (a ragged row of 12032 over 512 threads).
template <typename T, int kV, bool kBwd>
cudaError_t dispatch(const NormArgs& a, int chunks) {
  if (chunks == 1)
    launch<T, kV, 1, kBwd>(a);
  else if (chunks == 2)
    launch<T, kV, 2, kBwd>(a);
  else if (chunks == 4)
    launch<T, kV, 4, kBwd>(a);
  else if (chunks == 8)
    launch<T, kV, 8, kBwd>(a);
  else if constexpr (kV == 1) {
    if (chunks == 16)
      launch<T, kV, 16, kBwd>(a);
    else if (chunks == 24)
      launch<T, kV, 24, kBwd>(a);
    else
      return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Checks the plan against the call (fused_norm.plan makes a valid one)
// and launches it.
template <bool kBwd>
int run(const NormArgs& a, int dtype, int vector, int chunks) {
  const bool is_bf16 = dtype == ptt::kDtypeBF16;
  if (!is_bf16 && dtype != ptt::kDtypeF32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = vector ? (is_bf16 ? 8 : 4) : 1;
  const int threads = a.tpr * a.rows;
  const bool pow2 = a.tpr > 0 && (a.tpr & (a.tpr - 1)) == 0;
  bool ok = a.d > 0 && a.d <= kMaxNormD && a.n >= 0 && pow2 &&
            a.rows > 0 && threads <= kMaxBlock && threads % 32 == 0 &&
            static_cast<int64_t>(chunks) * a.tpr * vec >= a.d;
  if (vector)
    ok = ok && a.d % vec == 0 && aligned16(a.a) && aligned16(a.b) &&
         aligned16(a.c) && aligned16(a.w) && aligned16(a.out) &&
         aligned16(a.h);
  const int64_t groups = (static_cast<int64_t>(a.n) + a.rows - 1) / a.rows;
  if (kBwd)  // a grid-stride walk: any grid up to one block a group
    ok = ok && a.tpr >= 32 && (a.n == 0 || (a.blocks >= 1 && a.blocks <= groups));
  else       // one row a team, every row covered
    ok = ok && a.blocks == groups;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  cudaError_t err;
  if (is_bf16)
    err = vector ? dispatch<__nv_bfloat16, 8, kBwd>(a, chunks)
                 : dispatch<__nv_bfloat16, 1, kBwd>(a, chunks);
  else
    err = vector ? dispatch<float, 4, kBwd>(a, chunks)
                 : dispatch<float, 1, kBwd>(a, chunks);
  return static_cast<int>(err);
}

// One team of `pairs_t` x `slots` threads a (token, head group): thread
// (slot, p) takes the column pairs p, p + pairs_t, ... (of `pairs`) of the
// group's heads slot, slot + slots, ... (`hpg` heads a group, `groups`
// groups a token).
template <typename T, int kV, int kHeads>
__global__ void __launch_bounds__(kRopeThreads) rope_kernel(
    const T* __restrict__ x, const float* __restrict__ cos_f,
    const float* __restrict__ sin_f, T* __restrict__ out, int n, int heads,
    int d, int pairs, int pairs_t, int slots, int groups, int hpg,
    float sign) {
  const int team = pairs_t * slots;
  const int tk = threadIdx.x / team, r = threadIdx.x - tk * team;
  // (token, group) index: n * groups < 2^31 (groups > 1 only for n <
  // kRopeBlocks)
  const int vt = blockIdx.x * (blockDim.x / team) + tk;
  const int tok = vt / groups;
  if (tok >= n) return;
  const int h_begin = (vt - tok * groups) * hpg;
  const int h_end = min(heads, h_begin + hpg);
  const int slot = r / pairs_t, p0 = r - slot * pairs_t;
  const int half = d / 2;
  const int64_t t = tok;
  const int64_t row = t * heads * d;     // the only 64-bit offsets
  const T* xr = x + row;
  T* orow = out + row;
  const float* cr = cos_f + t * d;
  const float* sr = sin_f + t * d;
  for (int p = p0; p < pairs; p += pairs_t) {
    const int c = p * kV;
    float cl[kV], ch[kV], sl[kV], sh[kV];
    bool first = true;
    for (int h0 = h_begin + slot; h0 < h_end; h0 += kHeads * slots) {
      Chunk<T, kV> lo[kHeads], hi[kHeads];
#pragma unroll
      for (int k = 0; k < kHeads; ++k) {
        const int h = h0 + k * slots;
        if (h < h_end) {
          lo[k] = load_chunk<T, kV>(xr + h * d + c);
          hi[k] = load_chunk<T, kV>(xr + h * d + c + half);
        }
      }
      // the table share after the first heads' loads, so both are in
      // flight at once
      if (first) {
        ptt::load_f32<kV>(cr + c, cl);
        ptt::load_f32<kV>(cr + c + half, ch);
        ptt::load_f32<kV>(sr + c, sl);
        ptt::load_f32<kV>(sr + c + half, sh);
        first = false;
      }
#pragma unroll
      for (int k = 0; k < kHeads; ++k) {
        const int h = h0 + k * slots;
        if (h >= h_end) continue;
        Chunk<T, kV> ol, oh;
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float a = ptt::to_f32(lo[k].v[i]);
          const float b = ptt::to_f32(hi[k].v[i]);
          // sign * (b * s) has the bits of b * (sign * s): negation is
          // exact and rounding is symmetric
          ol.v[i] = ptt::from_f32<T>(__fadd_rn(
              __fmul_rn(a, cl[i]), __fmul_rn(sign, __fmul_rn(b, sl[i]))));
          oh.v[i] = ptt::from_f32<T>(__fadd_rn(
              __fmul_rn(b, ch[i]), __fmul_rn(sign, __fmul_rn(a, sh[i]))));
        }
        store_chunk<T, kV>(orow + h * d + c, ol);
        store_chunk<T, kV>(orow + h * d + c + half, oh);
      }
    }
  }
}

// The RoPE launch: up to kRopeHeads heads a thread while the launch still
// has kRopeFill threads; a token's heads in groups of their own teams
// while there are fewer than kRopeBlocks tokens; as many teams a block as
// fit kRopeThreads while there are still kRopeBlocks blocks, and at least
// a warp's worth.
template <typename T, int kV>
cudaError_t rope_launch(const void* x, const float* cos_f,
                        const float* sin_f, void* out, int n, int heads,
                        int d, float sign, cudaStream_t s) {
  const int pairs = d / 2 / kV;
  const int pairs_t = pairs < kRopeThreads ? pairs : kRopeThreads;
  int per = kRopeHeads;
  while (per > 1 && static_cast<int64_t>(n) * ((heads + per - 1) / per) *
                            pairs_t < kRopeFill)
    per /= 2;
  const int all_slots = (heads + per - 1) / per;
  const int groups =
      n >= kRopeBlocks ? 1 : std::min(all_slots, (kRopeBlocks + n - 1) / n);
  const int hpg = (heads + groups - 1) / groups;
  const int slots = std::min((hpg + per - 1) / per, kRopeThreads / pairs_t);
  const int team = pairs_t * slots;
  const int64_t teams = static_cast<int64_t>(n) * groups;
  const int warp_teams = std::max(1, 32 / team);   // no block below a warp
  const int per_block = static_cast<int>(
      std::min<int64_t>(kRopeThreads / team,
                        std::max<int64_t>(warp_teams, teams / kRopeBlocks)));
  if (teams > 0x7fffff00) return cudaErrorInvalidValue;  // int indices
  const int64_t blocks = (teams + per_block - 1) / per_block;
  // one head a thread: the instance without the second head's registers
  // (80 against 106 in bf16), so more threads are resident
  auto kern =
      per > 1 ? rope_kernel<T, kV, kRopeHeads> : rope_kernel<T, kV, 1>;
  kern<<<static_cast<unsigned>(blocks), per_block * team, 0, s>>>(
      static_cast<const T*>(x), cos_f, sin_f, static_cast<T*>(out), n, heads,
      d, pairs, pairs_t, slots, groups, hpg, sign);
  return cudaGetLastError();
}

}  // namespace

// y (and h when residual != null, and the f32 rstd of each row when
// rstd != null) for n rows of width d. x, residual, weight, y and h all
// have one type (dtype): the model keeps its norm weights in the
// residual stream's type. (vector, threads_per_row, rows_per_block,
// chunks, blocks) is fused_norm.plan(n, d, dtype, aligned); a plan that
// does not fit the call is refused.
extern "C" int ptt_rmsn_fwd(const void* x, const void* residual,
                            const void* weight, void* y, void* h, void* rstd,
                            int n, int d, float eps, int dtype, int vector,
                            int threads_per_row, int rows_per_block,
                            int chunks, int blocks, void* stream) {
  NormArgs a{x, residual, nullptr, weight, y,
             residual != nullptr ? h : nullptr, static_cast<float*>(rstd),
             nullptr, n, d, threads_per_row, rows_per_block, blocks, eps,
             static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype, vector, chunks);
}

// dh (n, d) in the input type and the per-block dw partials (blocks, d)
// f32 from h, weight, gy (and gh when not null) in one type and the f32
// rstd (n,); the plan is fused_norm.plan(n, d, dtype, aligned,
// backward=True).
extern "C" int ptt_rmsn_bwd(const void* h, const void* weight,
                            const void* rstd, const void* gy, const void* gh,
                            void* dh, void* dw_part, int n, int d, int dtype,
                            int vector, int threads_per_row,
                            int rows_per_block, int chunks, int blocks,
                            void* stream) {
  NormArgs a{h, gy, gh, weight, dh, nullptr,
             const_cast<float*>(static_cast<const float*>(rstd)),
             static_cast<float*>(dw_part), n, d, threads_per_row,
             rows_per_block, blocks, 0.f, static_cast<cudaStream_t>(stream)};
  return run<true>(a, dtype, vector, chunks);
}

// out = rope(x) for x (n, heads, d) with f32 tables cos_f, sin_f (n, d),
// the sin table taken times sign (1: the rotation; -1: its inverse, the
// backward). Any even d; the 16-byte instance where d/2 is a multiple of
// 16 bytes of x and every pointer is 16-byte aligned, else the scalar one.
extern "C" int ptt_rope(const void* x, const void* cos_f, const void* sin_f,
                        void* out, int n, int heads, int d, float sign,
                        int x_dtype, void* stream) {
  if (d <= 0 || d % 2 != 0 || n < 0 || heads < 0 ||
      (sign != 1.f && sign != -1.f) ||
      static_cast<int64_t>(heads) * d > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || heads == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(cos_f);
  auto sn = static_cast<const float*>(sin_f);
  const bool aligned =
      aligned16(x) && aligned16(out) && aligned16(c) && aligned16(sn);
  const int half = d / 2;
  cudaError_t err;
  if (x_dtype == ptt::kDtypeF32)
    err = aligned && half % 4 == 0
              ? rope_launch<float, 4>(x, c, sn, out, n, heads, d, sign, s)
              : rope_launch<float, 1>(x, c, sn, out, n, heads, d, sign, s);
  else if (x_dtype == ptt::kDtypeBF16)
    err = aligned && half % 8 == 0
              ? rope_launch<__nv_bfloat16, 8>(x, c, sn, out, n, heads, d,
                                              sign, s)
              : rope_launch<__nv_bfloat16, 1>(x, c, sn, out, n, heads, d,
                                              sign, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
