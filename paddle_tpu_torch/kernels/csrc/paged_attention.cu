// Paged-attention decode for one query row per slot, with each slot's KV
// window split over many blocks (split-KV) and a combine pass that merges
// the splits in a fixed order.
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
// (visible KV bytes) / 3.35 TB/s. Serving shapes are far from it for
// another reason: latency. A slot's window is a chain of pages read
// through its block table, and at a batch of 8 slots and 8 KV heads one
// block per (slot, head) gives 64 blocks for 132 SMs, the longest slot
// setting the time. So the window is split, and many loads are kept in
// flight; the arithmetic stays f32 on the CUDA cores (a call's flops
// take about a microsecond there, no tensor cores needed).
//
// How the design meets it:
// - grid (b, hk * tiles, n_split): one block per slot, KV head, tile of
//   the head's query heads, and split: a run of P consecutive logical
//   pages of the slot's window. P and n_split = ceil(max_pages / P) come
//   from static shapes (the wrapper's `plan`: 64 rows a split, from
//   max_pages and page_size), never from lens, so the launch reads
//   nothing on the host and a CUDA graph can capture it. A block whose
//   first page lies past lens[slot] / page_size writes an empty partial
//   (m = -inf, l = 0) and returns; split 0 always holds column 0. Pages
//   are clamped to max_pages - 1;
// - the GQA fold: the query heads of a KV head are folded into the
//   block, so each K and V row it reads serves all of them. A block holds
//   at most 8 (4 when g <= 4, which halves its registers); a larger g is
//   tiled by 8 through the grid, and a KV row is then read once per tile;
// - inside a block 4 warps take the split's 16-row chunks round-robin
//   (a page is one or more chunks; a chunk never crosses a page), at
//   P = 4 pages of 16 rows one chunk a warp. A warp copies the chunk's K
//   rows and then its V rows to its own shared buffers by cp.async, as
//   two groups (16-byte copies, neighbouring lanes on neighbouring
//   bytes; rows past the query zero-filled), waits for K only and scores
//   the rows (two lanes a row, alternate 16-byte vectors of the head
//   dim, K rows padded so the reads meet no bank conflict) with an online
//   softmax (base-2 exponentials, log2(e) folded into the score scale,
//   f32) while V lands, then forms p.V by columns (each lane owns d/32
//   adjacent columns): no step waits on a load per row;
// - the warps' softmax states merge in shared memory in warp order, and
//   the block writes its partial (o not yet divided by l, m, l) to an
//   f32 workspace of (b, hq, n_split) rows that the wrapper allocates;
// - a second kernel, one block per (slot, query head), merges the
//   splits in split order, reading lens on the device to stop at the
//   last non-empty split, and divides by l: the same bits every run.
// Masking: the query sits at position lens[i] (its own k/v is already in
// the pool there), so column c is visible iff c <= lens[i].
//
// int8 pools (KV quantized at scatter time, inference/paged.py): the
// codes are copied as they are and converted to f32 when read, and each
// chunk reads its page's two scales, k_scale[phys, kvh] and
// v_scale[phys, kvh], straight from the (num_pages, hk) planes through
// the block-table row (the TPU kernel gathers per-slot scales into SMEM
// outside the kernel, because its scalar memory is small). As in the TPU
// kernel, the score scale multiplies each row's q.k dot and the value
// scale multiplies the chunk's p.v sum before it joins the accumulator;
// p stays f32. The dequantized window never exists.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileG = 8;       // most query heads of one KV head a block
constexpr int kChunk = 16;      // rows scored at once by a warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename TKV, int D, int G>
constexpr size_t split_smem_bytes() {
  // per warp a K chunk (rows padded by 16 bytes) and a V chunk, then
  // (G, D) q and o, p per warp, m and l per warp
  return kWarps * kChunk * (2 * D * sizeof(TKV) + 16) +
         sizeof(float) * (2 * G * D + kWarps * G * kChunk + 2 * kWarps * G);
}

// G: query heads a block holds in registers, 4 when g <= 4 (Llama-3's
// group: half the registers of 8, so more blocks fit on an SM), else 8
template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ lens, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int hq, int hk,
    int page_size, int max_pages, int pages_per_split, float scale_log2) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kCols = D / 32;  // adjacent head dims per lane, value pass
  // K elements per read in the score pass: one 16-byte vector of int8 or
  // bf16 codes, two of f32; the two lanes of a row take alternate
  // vectors (D / 2 is a whole number of vector pairs at d >= 64)
  constexpr int kVec = kQuant ? 16 : 8;
  constexpr int kUnits = D * sizeof(TKV) / 16;  // 16-byte copies per row
  // a K row in shared memory, padded by 16 bytes: the 8 lanes of a
  // quarter warp then read 8 rows from 8 distinct groups of 4 banks
  constexpr int kKRow = D * sizeof(TKV) + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;                          // (kWarps, kChunk)
  TKV* v_s = reinterpret_cast<TKV*>(k_s + kWarps * kChunk * kKRow);
  float* q_s = reinterpret_cast<float*>(v_s + kWarps * kChunk * D);
  float* o_s = q_s + G * D;                // (G, D) merged o
  float* p_s = o_s + G * D;                // (kWarps, G, kChunk)
  float* m_s = p_s + kWarps * G * kChunk;  // (kWarps, G)
  float* l_s = m_s + kWarps * G;           // (kWarps, G)

  const int g = hq / hk;
  const int tiles = (g + G - 1) / G;
  const int slot = blockIdx.x;
  const int kvh = blockIdx.y / tiles;
  const int h0 = kvh * g + (blockIdx.y % tiles) * G;  // first q head
  const int gt = min(G, kvh * g + g - h0);            // heads here
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = lane & (kChunk - 1);  // row of the chunk this lane scores
  const int half = lane / kChunk;       // which of the row's two lanes
  const int pos = lens[slot];
  const int last = min(pos / page_size, max_pages - 1);
  const int first = split * pages_per_split;
  // this block's first (slot, query head, split) row of the workspace;
  // head h0 + gi is gi * n_split rows further
  const int64_t part =
      (static_cast<int64_t>(slot) * hq + h0) * n_split + split;
  if (first > last) {  // the split lies past the query: an empty partial
    if (tid < gt) {
      m_part[part + tid * n_split] = kNegInf;
      l_part[part + tid * n_split] = 0.f;
    }
    return;
  }
  const int cpp = (page_size + kChunk - 1) / kChunk;  // chunks per page
  const int n_chunks = (min(first + pages_per_split, last + 1) - first) * cpp;

  const int32_t* bt = block_tables + static_cast<int64_t>(slot) * max_pages;
  // the page of this warp's first chunk, read before the block waits
  int next_phys = warp < n_chunks ? bt[first + warp / cpp] : 0;
  const TQ* qh = q + (static_cast<int64_t>(slot) * hq + h0) * D;
  for (int i = tid; i < gt * D; i += kThreads) {
    q_s[i] = ptt::to_f32(qh[i]) * scale_log2;
    o_s[i] = 0.f;
  }
  __syncthreads();

  float m[G], l[G], acc[G][kCols];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[gi][cc] = 0.f;
  }

  unsigned char* k_w = k_s + warp * kChunk * kKRow;  // this warp's K chunk
  TKV* v_w = v_s + warp * kChunk * D;                // this warp's V chunk
  float* p_w = p_s + warp * G * kChunk;              // this warp's p
  const int64_t page_stride = static_cast<int64_t>(hk) * page_size * D;
  const int64_t head_off = static_cast<int64_t>(kvh) * page_size * D;
  for (int c = warp; c < n_chunks; c += kWarps) {
    const int j = first + c / cpp;
    const int t0 = (c % cpp) * kChunk;
    const int64_t phys = next_phys;
    if (c + kWarps < n_chunks) next_phys = bt[first + (c + kWarps) / cpp];
    // rows t0 .. t0 + n_vis - 1 of page j are visible
    const int n_vis = min(min(kChunk, page_size - t0),
                          pos - (j * page_size + t0) + 1);
    if (n_vis <= 0) continue;  // the page's later chunks: past the query
    const int64_t base = phys * page_stride + head_off +
                         static_cast<int64_t>(t0) * D;
    // the chunk's K rows, then its V rows, to this warp's buffers by
    // cp.async in two groups: the scores wait for K only, and V lands
    // while they are formed. Rows past n_vis are zero-filled (p is 0
    // there).
    const unsigned char* k_src =
        reinterpret_cast<const unsigned char*>(k_pool + base);
    const unsigned char* v_src =
        reinterpret_cast<const unsigned char*>(v_pool + base);
    for (int i = lane; i < kChunk * kUnits; i += 32) {
      const int r = i / kUnits;
      const bool ok = r < n_vis;
      ptt::cp_async16(k_w + r * kKRow + (i - r * kUnits) * 16,
                      k_src + (ok ? i * 16 : 0), ok);
    }
    ptt::cp_async_commit();
    for (int i = lane; i < kChunk * kUnits; i += 32) {
      const bool ok = i / kUnits < n_vis;
      ptt::cp_async16(reinterpret_cast<unsigned char*>(v_w) + i * 16,
                      v_src + (ok ? i * 16 : 0), ok);
    }
    ptt::cp_async_commit();
    float ks = 1.f, vs = 1.f;  // this page's scales (int8 pools)
    if constexpr (kQuant) {
      ks = k_scale[phys * hk + kvh];
      vs = v_scale[phys * hk + kvh];
    }
    const bool vis = row < n_vis;
    ptt::cp_async_wait<1>();  // K has landed
    __syncwarp();

    // scores of this lane's row, over its half of the head dim
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
    if (vis) {
      const TKV* kr =
          reinterpret_cast<const TKV*>(k_w + row * kKRow) + half * kVec;
      const float* qr = q_s + half * kVec;
#pragma unroll
      for (int e0 = 0; e0 < D; e0 += 2 * kVec) {
        float kv[kVec];
        ptt::load_f32<kVec>(kr + e0, kv);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          if (gi < gt) {
            float qv[kVec];
            ptt::load_f32<kVec>(qr + gi * D + e0, qv);
#pragma unroll
            for (int e = 0; e < kVec; ++e) s[gi] += qv[e] * kv[e];
          }
        }
      }
    }

    // online-softmax update over the chunk's rows; p to shared memory
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < gt) {
        s[gi] += __shfl_xor_sync(kFull, s[gi], kChunk);
        if constexpr (kQuant) s[gi] *= ks;  // after the dot, as the TPU
        float mx = vis ? s[gi] : kNegInf;
#pragma unroll
        for (int o = kChunk / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[gi], mx);
        const float alpha = exp2f(m[gi] - m_new);
        const float p = vis ? exp2f(s[gi] - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = kChunk / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(kFull, sum, o);
        l[gi] = l[gi] * alpha + sum;
        m[gi] = m_new;
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) acc[gi][cc] *= alpha;
        if (half == 0) p_w[gi * kChunk + row] = p;
      }
    }
    ptt::cp_async_wait<0>();  // V has landed
    __syncwarp();

    // acc += p @ V over the chunk's rows; int8: acc += (p @ codes) * vs
    float pv[kQuant ? G : 1][kCols];
    if constexpr (kQuant) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) pv[gi][cc] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      float v[kCols];
      ptt::load_f32<kCols>(v_w + t * D + lane * kCols, v);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < gt) {
          const float pt = p_w[gi * kChunk + t];
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            if constexpr (kQuant)
              pv[gi][cc] += pt * v[cc];
            else
              acc[gi][cc] += pt * v[cc];
          }
        }
      }
    }
    if constexpr (kQuant) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) acc[gi][cc] += pv[gi][cc] * vs;
    }
    __syncwarp();  // the buffers and p_w are refilled by the next chunk
  }

  // merge the warps' softmax states (fixed warp order: deterministic)
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      m_s[warp * G + gi] = m[gi];
      l_s[warp * G + gi] = l[gi];
    }
  }
  __syncthreads();
  float scale[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + gi]);
    scale[gi] = exp2f(m[gi] - mx);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < gt) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            o_s[gi * D + lane * kCols + cc] += acc[gi][cc] * scale[gi];
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < gt * D; i += kThreads)
    o_part[(part + (i / D) * n_split) * D + i % D] = o_s[i];
  if (tid < gt) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + tid]);
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w)
      total += l_s[w * G + tid] * exp2f(m_s[w * G + tid] - mx);
    m_part[part + tid * n_split] = mx;
    l_part[part + tid * n_split] = total;
  }
}

// One block per (slot, query head), one thread per head dim: the
// non-empty splits merged in split order, divided by their total l.
template <int D>
__global__ void __launch_bounds__(D) paged_decode_combine(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, const int32_t* __restrict__ lens,
    float* __restrict__ out, int hq, int page_size, int max_pages,
    int pages_per_split, int n_split) {
  const int slot = blockIdx.x;
  const int64_t row = static_cast<int64_t>(slot) * hq + blockIdx.y;
  const int64_t base = row * n_split;
  const int last = min(lens[slot] / page_size, max_pages - 1);
  const int used = last < 0 ? 0 : last / pages_per_split + 1;
  float mx = kNegInf;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, m_part[base + s]);
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < used; ++s) {  // in split order
    const float w = exp2f(m_part[base + s] - mx);
    den += l_part[base + s] * w;
    num += o_part[(base + s) * D + threadIdx.x] * w;
  }
  out[row * D + threadIdx.x] = num / fmaxf(den, 1e-30f);
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
  float* workspace;
  int b, hq, hk, page_size, max_pages, pages_per_split, n_split;
  float scale_log2;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int G>
cudaError_t launch_d(const Launch& a) {
  const int tiles = (a.hq / a.hk + G - 1) / G;
  const size_t smem = split_smem_bytes<TKV, D, G>();
  auto kern = paged_decode_split<TQ, TKV, D, G>;
  cudaError_t err;
  if (smem > 48 * 1024) {  // past the default: opt in (wide rows, f32)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t rows = static_cast<int64_t>(a.b) * a.hq * a.n_split;
  float* o_part = a.workspace;           // (b, hq, n_split, D)
  float* m_part = o_part + rows * D;     // (b, hq, n_split)
  float* l_part = m_part + rows;         // (b, hq, n_split)
  kern<<<dim3(a.b, a.hk * tiles, a.n_split), kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.k_scale, a.v_scale,
      a.block_tables, a.lens, o_part, m_part, l_part, a.hq, a.hk,
      a.page_size, a.max_pages, a.pages_per_split, a.scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine<D><<<dim3(a.b, a.hq), D, 0, a.stream>>>(
      o_part, m_part, l_part, a.lens, a.out, a.hq, a.page_size, a.max_pages,
      a.pages_per_split, a.n_split);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_g(const Launch& a) {
  return a.hq / a.hk <= 4 ? launch_d<TQ, TKV, D, 4>(a)
                          : launch_d<TQ, TKV, D, kTileG>(a);
}

template <typename TQ, typename TKV>
cudaError_t launch(const Launch& a, int d) {
  switch (d) {
    case 64:
      return launch_g<TQ, TKV, 64>(a);
    case 128:
      return launch_g<TQ, TKV, 128>(a);
    case 256:
      return launch_g<TQ, TKV, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shape limits (checked again by the Python wrapper): hq % hk == 0, any
// g = hq / hk, head_dim d in {64, 128, 256}, page_size >= 1,
// pages_per_split >= 1 and n_split = ceil(max_pages / pages_per_split)
// (at least 1, at most 65535). `workspace` holds b * hq * n_split * (d +
// 2) f32. Types (q, pools): (f32, f32), (bf16, bf16), (f32, bf16) for an
// f32 model over bf16 pools, and (f32 or bf16, int8) with k_scale /
// v_scale f32 (num_pages, hk) planes (null for float pools). Launches
// the split kernel and the combine on `stream`; returns a cudaError_t
// code (0 = launched).
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lens, void* out, void* workspace, int b, int hq, int hk,
    int d, int page_size, int max_pages, int pages_per_split, int n_split,
    float sm_scale, int q_dtype, int kv_dtype, void* stream) {
  if (hk <= 0 || hq % hk != 0 || page_size <= 0 || pages_per_split <= 0 ||
      max_pages < 0 || n_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int want = (max_pages + pages_per_split - 1) / pages_per_split;
  if (n_split != (want < 1 ? 1 : want))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(hk) * ((hq / hk + kTileG - 1) / kTileG) > 65535)
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
                 static_cast<float*>(workspace),
                 b, hq, hk, page_size, max_pages, pages_per_split, n_split,
                 sm_scale * kLog2e, static_cast<cudaStream_t>(stream)};
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
