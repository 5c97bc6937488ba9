// Paged-attention decode for one query row per slot.
//
// Replaces: paddle_tpu/kernels/paged_attention.py:_decode_kernel_noquant
// (the unquantized branch of _decode_kernel, reached through
// paged_decode_attention).
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
// Right and simple first: no split of a slot over several blocks, no TMA,
// no tensor cores.
#include <cstdint>

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
    const TKV* __restrict__ v_pool, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ lens, float* __restrict__ out, int hq, int hk,
    int page_size, int max_pages, float scale_log2) {
  constexpr int kHalf = D / 2;   // head dims per lane in the score pass
  constexpr int kCols = D / 32;  // adjacent head dims per lane, value pass
  constexpr int kVec = 8;        // K elements per load in the score pass
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

      // acc += p @ V over the visible rows
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
          for (int gi = 0; gi < kMaxG; ++gi)
            if (gi < g) acc[gi][cc] += pt[gi] * v[cc];
        }
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

template <typename TQ, typename TKV, int D>
void launch_d(const void* q, const void* k_pool, const void* v_pool,
              const int32_t* block_tables, const int32_t* lens, float* out,
              int b, int hq, int hk, int page_size, int max_pages,
              float scale_log2, cudaStream_t stream) {
  const int g = hq / hk;
  const size_t smem = sizeof(float) * (2 * g * D + 2 * kWarps * g);
  paged_decode_kernel<TQ, TKV, D><<<dim3(b, hk), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), block_tables, lens, out, hq, hk,
      page_size, max_pages, scale_log2);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int32_t* block_tables, const int32_t* lens,
                   float* out, int b, int hq, int hk, int d, int page_size,
                   int max_pages, float sm_scale, cudaStream_t stream) {
  const float scale_log2 = sm_scale * kLog2e;
  switch (d) {
    case 64:
      launch_d<TQ, TKV, 64>(q, k_pool, v_pool, block_tables, lens, out, b,
                            hq, hk, page_size, max_pages, scale_log2, stream);
      break;
    case 128:
      launch_d<TQ, TKV, 128>(q, k_pool, v_pool, block_tables, lens, out, b,
                             hq, hk, page_size, max_pages, scale_log2, stream);
      break;
    case 256:
      launch_d<TQ, TKV, 256>(q, k_pool, v_pool, block_tables, lens, out, b,
                             hq, hk, page_size, max_pages, scale_log2, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Shape limits (checked again by the Python wrapper): hq % hk == 0,
// hq / hk <= 8, head_dim d in {64, 128, 256}, page_size >= 1. Types
// (q, pools): (f32, f32), (bf16, bf16), or (f32, bf16) for an f32 model
// over bf16 pools. Returns a cudaError_t code (0 = launched).
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lens, void* out, int b, int hq,
    int hk, int d, int page_size, int max_pages, float sm_scale, int q_dtype,
    int kv_dtype, void* stream) {
  if (hk <= 0 || hq % hk != 0 || hq / hk > kMaxG || page_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  auto bt = static_cast<const int32_t*>(block_tables);
  auto ln = static_cast<const int32_t*>(lens);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (q_dtype == ptt::kDtypeF32 && kv_dtype == ptt::kDtypeF32)
    err = launch<float, float>(q, k_pool, v_pool, bt, ln, o, b, hq, hk, d,
                               page_size, max_pages, sm_scale, s);
  else if (q_dtype == ptt::kDtypeBF16 && kv_dtype == ptt::kDtypeBF16)
    err = launch<bf16, bf16>(q, k_pool, v_pool, bt, ln, o, b, hq, hk, d,
                             page_size, max_pages, sm_scale, s);
  else if (q_dtype == ptt::kDtypeF32 && kv_dtype == ptt::kDtypeBF16)
    err = launch<float, bf16>(q, k_pool, v_pool, bt, ln, o, b, hq, hk, d,
                              page_size, max_pages, sm_scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
