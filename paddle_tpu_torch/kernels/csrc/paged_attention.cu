// Paged-attention decode for one query row per slot.
//
// Replaces: paddle_tpu/kernels/paged_attention.py:_decode_kernel, both
// branches (the pallas_call at :274): _decode_kernel_noquant over bf16 or
// f32 pools, and quantized=True over int8 pools with per-page-per-head
// f32 scales (the TKV = int8_t instances below).
//
// Bound on this card: the bytes of K and V it must read. A decode step
// reads every visible KV row of every slot once and does 4*d flops per
// row and query head, about 4*g flops per byte for g = hq/hk query
// heads per KV head; that is far below the ~295 flops per byte at
// which an H100 stops being limited by memory, so the floor is
// (visible KV bytes) / 3.35 TB/s.
//
// How the design meets it:
// - one block per (slot, kv_head); the block reads its own block-table
//   row and length (the TPU kernel had them as scalar prefetch);
// - only pages 0 .. lens/page_size are touched, and inside a page only
//   the rows at or before the query position are loaded;
// - the g query heads of one KV head are folded into the block (the GQA
//   fold): each K and V row is loaded once and used for all g rows, and
//   K/V are never repeated per query head;
// - the softmax is online (running max / sum per query row, base-2
//   exponentials with log2(e) folded into the score scale), in f32, so
//   the window is read once and never written out.
// Masking: the query sits at position lens[i] (its own k/v is already in
// the pool there), so column c is visible iff c <= lens[i].
//
// What bounds it in practice is latency, not bandwidth: b * hk blocks
// are few, and the slot with the longest window sets the time. So the 8
// warps of a block take the slot's pages round-robin, each warp keeping
// its own online-softmax state, and the warps' partial results are
// merged in shared memory at the end (in a fixed warp order, so the
// result does not vary from run to run). Inside a warp, 16 rows of a page
// are scored at once (two lanes per row, one half of the head dim each,
// read with 16-byte loads) and then folded into the value accumulator,
// where each lane owns d/32 adjacent columns, so a warp reads each V row
// as one contiguous run.
//
// int8 pools (KV quantized at scatter time, inference/paged.py): the
// codes are read as 16-byte vectors of 16 values and converted to f32 in
// registers, and the block reads each page's two scales,
// k_scale[phys, kvh] and v_scale[phys, kvh], straight from the
// (num_pages, hk) planes through its own block-table row (the TPU kernel
// gathers per-slot scales into SMEM outside the kernel, because its
// scalar memory is small; a block here has no such limit). As in the TPU
// kernel, the score scale multiplies each row's q.k dot and the value
// scale multiplies the chunk's p.v sum before it joins the accumulator;
// p stays f32. The dequantized window never exists: the bytes read are
// half those of bf16 pools, plus 8 bytes of scales per page and head.
//
// Right and simple first: no split of a slot over several blocks, no TMA,
// no tensor cores.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;        // query heads per KV head
constexpr int kChunk = 16;      // rows scored at once by a warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ lens, float* __restrict__ out, int hq, int hk,
    int page_size, int max_pages, float scale_log2) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kHalf = D / 2;   // head dims per lane in the score pass
  constexpr int kCols = D / 32;  // adjacent head dims per lane, value pass
  // K elements per load in the score pass: one 16-byte vector of int8 or
  // bf16 codes, two of f32 (kHalf is a whole number of them at d >= 64)
  constexpr int kVec = kQuant ? 16 : 8;
  extern __shared__ __align__(16) float smem[];
  const int g = hq / hk;
  float* q_s = smem;              // (g, D) query rows, pre-scaled
  float* o_s = q_s + g * D;       // (g, D) merged output
  float* m_s = o_s + g * D;       // (kWarps, g) per-warp running max
  float* l_s = m_s + kWarps * g;  // (kWarps, g) per-warp running sum

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = lane & (kChunk - 1);  // row of the chunk this lane scores
  const int half = lane / kChunk;       // which half of the head dim
  const int pos = lens[slot];
  const int32_t* bt = block_tables + static_cast<int64_t>(slot) * max_pages;
  const int last = min(pos / page_size, max_pages - 1);

  const TQ* qh = q + (static_cast<int64_t>(slot) * hq + kvh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) {
    q_s[i] = ptt::to_f32(qh[i]) * scale_log2;
    o_s[i] = 0.f;
  }
  __syncthreads();

  float m[kMaxG], l[kMaxG], acc[kMaxG][kCols];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[gi][cc] = 0.f;
  }

  const int64_t page_stride = static_cast<int64_t>(hk) * page_size * D;
  const int64_t head_off = static_cast<int64_t>(kvh) * page_size * D;
  for (int j = warp; j <= last; j += kWarps) {
    const int64_t base = static_cast<int64_t>(bt[j]) * page_stride + head_off;
    float ks = 1.f, vs = 1.f;  // this page's scales (int8 pools)
    if constexpr (kQuant) {
      ks = k_scale[static_cast<int64_t>(bt[j]) * hk + kvh];
      vs = v_scale[static_cast<int64_t>(bt[j]) * hk + kvh];
    }
    for (int t0 = 0; t0 < page_size; t0 += kChunk) {
      // rows t0 .. t0 + n_vis - 1 of this page are visible (n_vis >= 1)
      const int n_vis = min(min(kChunk, page_size - t0),
                            pos - (j * page_size + t0) + 1);
      if (n_vis <= 0) break;
      const bool vis = row < n_vis;

      // scores of this lane's row, over its half of the head dim
      float s[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) s[gi] = 0.f;
      if (vis) {
        const TKV* kr = k_pool + base + static_cast<int64_t>(t0 + row) * D +
                        half * kHalf;
        const float* qr = q_s + half * kHalf;
#pragma unroll
        for (int c = 0; c < kHalf; c += kVec) {
          float kv[kVec];
          ptt::load_f32<kVec>(kr + c, kv);
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) {
              float qv[kVec];
              ptt::load_f32<kVec>(qr + gi * D + c, qv);
#pragma unroll
              for (int e = 0; e < kVec; ++e) s[gi] += qv[e] * kv[e];
            }
          }
        }
      }

      // online-softmax update over the chunk's rows
      float p[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        p[gi] = 0.f;
        if (gi < g) {
          s[gi] += __shfl_xor_sync(kFull, s[gi], kChunk);
          if constexpr (kQuant) s[gi] *= ks;  // after the dot, as the TPU
          float mx = vis ? s[gi] : kNegInf;
#pragma unroll
          for (int o = kChunk / 2; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
          const float m_new = fmaxf(m[gi], mx);
          const float alpha = exp2f(m[gi] - m_new);
          p[gi] = vis ? exp2f(s[gi] - m_new) : 0.f;
          float sum = p[gi];
#pragma unroll
          for (int o = kChunk / 2; o > 0; o >>= 1)
            sum += __shfl_xor_sync(kFull, sum, o);
          l[gi] = l[gi] * alpha + sum;
          m[gi] = m_new;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) acc[gi][cc] *= alpha;
        }
      }

      // acc += p @ V over the visible rows; int8: acc += (p @ codes) * vs
      float pv[kQuant ? kMaxG : 1][kCols];
      if constexpr (kQuant) {
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) pv[gi][cc] = 0.f;
      }
      for (int t = 0; t < n_vis; ++t) {
        const TKV* vr = v_pool + base + static_cast<int64_t>(t0 + t) * D;
        float pt[kMaxG];
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
          pt[gi] = gi < g ? __shfl_sync(kFull, p[gi], t) : 0.f;
        float v[kCols];
        ptt::load_f32<kCols>(vr + lane * kCols, v);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) {
              if constexpr (kQuant)
                pv[gi][cc] += pt[gi] * v[cc];
              else
                acc[gi][cc] += pt[gi] * v[cc];
            }
          }
        }
      }
      if constexpr (kQuant) {
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            if (gi < g) acc[gi][cc] += pv[gi][cc] * vs;
      }
    }
  }

  // merge the warps' partial softmax states (fixed order: deterministic)
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        m_s[warp * g + gi] = m[gi];
        l_s[warp * g + gi] = l[gi];
      }
    }
  }
  __syncthreads();
  float scale[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    scale[gi] = 0.f;
    if (gi < g) {
      float mx = kNegInf;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * g + gi]);
      scale[gi] = exp2f(m[gi] - mx);
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            o_s[gi * D + lane * kCols + cc] += acc[gi][cc] * scale[gi];
        }
      }
    }
    __syncthreads();
  }
  float* oh = out + (static_cast<int64_t>(slot) * hq + kvh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) {
    const int gi = i / D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * g + gi]);
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w)
      total += l_s[w * g + gi] * exp2f(m_s[w * g + gi] - mx);
    oh[i] = o_s[i] / fmaxf(total, 1e-30f);
  }
}

struct Launch {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // int8 pools only
  const float* v_scale;
  const int32_t* block_tables;
  const int32_t* lens;
  float* out;
  int b, hq, hk, page_size, max_pages;
  float scale_log2;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
void launch_d(const Launch& a) {
  const int g = a.hq / a.hk;
  const size_t smem = sizeof(float) * (2 * g * D + 2 * kWarps * g);
  paged_decode_kernel<TQ, TKV, D>
      <<<dim3(a.b, a.hk), kThreads, smem, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
          static_cast<const TKV*>(a.v_pool), a.k_scale, a.v_scale,
          a.block_tables, a.lens, a.out, a.hq, a.hk, a.page_size,
          a.max_pages, a.scale_log2);
}

template <typename TQ, typename TKV>
cudaError_t launch(const Launch& a, int d) {
  switch (d) {
    case 64:
      launch_d<TQ, TKV, 64>(a);
      break;
    case 128:
      launch_d<TQ, TKV, 128>(a);
      break;
    case 256:
      launch_d<TQ, TKV, 256>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Shape limits (checked again by the Python wrapper): hq % hk == 0,
// hq / hk <= 8, head_dim d in {64, 128, 256}, page_size >= 1. Types
// (q, pools): (f32, f32), (bf16, bf16), (f32, bf16) for an f32 model
// over bf16 pools, and (f32 or bf16, int8) with k_scale / v_scale f32
// (num_pages, hk) planes (null for float pools). Returns a cudaError_t
// code (0 = launched).
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lens, void* out, int b, int hq, int hk, int d, int page_size,
    int max_pages, float sm_scale, int q_dtype, int kv_dtype, void* stream) {
  if (hk <= 0 || hq % hk != 0 || hq / hk > kMaxG || page_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = kv_dtype == ptt::kDtypeI8;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const Launch a{q, k_pool, v_pool,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(lens), static_cast<float*>(out),
                 b, hq, hk, page_size, max_pages, sm_scale * kLog2e,
                 static_cast<cudaStream_t>(stream)};
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (q_dtype == ptt::kDtypeF32 && kv_dtype == ptt::kDtypeF32)
    err = launch<float, float>(a, d);
  else if (q_dtype == ptt::kDtypeBF16 && kv_dtype == ptt::kDtypeBF16)
    err = launch<bf16, bf16>(a, d);
  else if (q_dtype == ptt::kDtypeF32 && kv_dtype == ptt::kDtypeBF16)
    err = launch<float, bf16>(a, d);
  else if (q_dtype == ptt::kDtypeF32 && quant)
    err = launch<float, int8_t>(a, d);
  else if (q_dtype == ptt::kDtypeBF16 && quant)
    err = launch<bf16, int8_t>(a, d);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
