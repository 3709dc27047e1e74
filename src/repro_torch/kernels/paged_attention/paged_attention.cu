// Paged decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/paged_attention.py:95 paged_attention_fwd
//   (kernel body `_kernel`, :38).
// Computes, for every lane b and query head h, single-token attention over
// the lane's resident rows, read straight from the block pool through the
// lane's block table:
//   out[b, h] = softmax(mask(softcap(q[b, h] . K^T / sqrt(hd)))) V
// with K/V rows of KV head h / (H / KV), rows at or past context_lens[b]
// masked, and with a window also rows at or below context_lens[b] - 1 - window.
//
// Bound on this card: bytes.  Each resident K/V row is used once per query
// head of its group, so the work is ~4 * G flops per byte of K/V read
// (G = H / KV = 8 for TinyLlama) against the H100's ~295 flop/byte ridge
// in bf16: decode attention is far below it and its least time is the K/V
// bytes over 3.35 TB/s.  At the serving paths' short contexts (a few
// hundred rows) those bytes take well under a microsecond, so what a
// launch costs is its latency: how many SMs work on it, and how many
// dependent trips to device memory each CTA makes.
// What the design does about it:
//   * the grid is (lane, KV head, split): the lane's resident blocks inside
//     the window are cut into at most n_split contiguous ranges of at least
//     4 G rows, one per CTA, so a decode step with few lanes still spreads
//     over the card's 132 SMs (the wrapper picks n_split from the table's
//     reach and the SM count), while the partial each split writes stays
//     small beside the rows it reads.  Each CTA serves all G query heads of
//     its KV head, so each K/V row crosses device memory once;
//   * the CTA reads its slice of block_tables[b] once into shared memory and
//     touches only its own range (the Pallas grid visits all max_blocks of
//     every lane);
//   * K/V rows arrive in shared memory by 16-byte `cp.async` copies, in the
//     input type, through two stages: the next tile loads while this one is
//     used;
//   * 256 threads, the work of a tile blocked in registers: in the scores 4
//     threads share a K row and each dots its chunks with 8 heads' q at once
//     (K rows padded so that the two rows a quarter warp reads fall on
//     distinct banks); in P V a thread owns 2 columns of up to 8 heads, so
//     its accumulators stay in registers across the tiles.  At these grid
//     sizes a CTA has its SM to itself, and 8 warps hide more of the
//     shared-memory latency than 4;
//   * scores, the online softmax (m, l) and the accumulator stay on chip in
//     f32.  With n_split > 1 each CTA writes its partial (m, l, acc) to
//     scratch, takes a ticket from a per-(lane, KV head) counter, and the
//     CTA that draws the last ticket combines the partials in the same
//     launch, eight splits' loads in flight per thread, and resets the
//     counter to 0.  A split with no rows (past the lane's context, or
//     before its window) writes m = -inf, l = 0, and the combine skips it:
//     the live splits come first.
//
// Arithmetic follows the Pallas kernel: scores and the running max/sum in
// f32, exp(s - m) rounded to the input type before the product with V, and
// out = acc / max(l, 1e-30); the combine rescales each partial by
// exp(m_s - max_s m_s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float minus_inf() {
  return __uint_as_float(0xff800000u);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The two bf16 halves of a 32-bit word as floats (bf16 is the top half of
// an f32, so the widening is exact).
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

constexpr int kRowThreads = 4;  // threads sharing one K row in the scores
constexpr int kHeadPass = 8;    // query heads a thread scores at a time
constexpr int kMaxHeads = 8;    // query heads a thread accumulates in P V

template <typename T, int HD>
struct Tile {
  static constexpr int kRowBytes = HD * int(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a row
  static constexpr int kPerChunk = 16 / int(sizeof(T));
  // K rows padded so that the two rows a quarter warp reads in the scores
  // (4 threads each) fall on distinct banks: a stride of 64 mod 128 bytes
  // (a 192-byte bf16 row of hd 96 has it unpadded), or past a short row
  static constexpr int kKStride =
      kRowBytes + (kRowBytes % 128 == 0 ? 64
                   : kRowBytes % 128 == 64 ? 0 : 16);
  // rows per stage: 64, or fewer where K and V of one stage would pass
  // 64 KB
  static constexpr int kRows =
      65536 / (2 * kRowBytes) < 64 ? 65536 / (2 * kRowBytes) : 64;
  static constexpr int kStageBytes = kRows * (kKStride + kRowBytes);
  // P V: a thread owns 2 columns of kMaxHeads heads at most, interleaved;
  // where the column pairs do not divide the threads (hd 96: 48 pairs, 5
  // head groups) the last kThreads % kColPairs threads own none
  static constexpr int kColPairs = HD / 2;
  static constexpr int kHeadGroups = kThreads / kColPairs;
  static constexpr int kMaxGroup = kHeadGroups * kMaxHeads;
};

// Shared memory: two stages of K [rows][padded row] and V [rows][row], then
// as floats q [G][HD], p [G][rows], m, l, alpha [G] and the combine's
// weights [G][n_split], then as ints the CTA's slice of its block table
// [slice] and one flag (this CTA holds the last ticket).
template <typename T, int HD>
size_t smem_bytes(int G, int n_split, int slice) {
  using TT = Tile<T, HD>;
  return 2 * size_t(TT::kStageBytes) +
         sizeof(float) * (size_t(G) * HD + size_t(G) * TT::kRows +
                          3 * size_t(G) + size_t(G) * n_split) +
         sizeof(int) * (size_t(slice) + 1);
}

// The fewest blocks a split takes: at least 4 G rows, so that the partial it
// writes (G x hd floats) stays small beside the K/V rows it reads.
__host__ __device__ __forceinline__ int min_split_blocks(int G, int bs) {
  return (4 * G + bs - 1) / bs;
}

// o += w * a, four lanes.
__device__ __forceinline__ void fma4(float4& o, float w, float4 a) {
  o.x = fmaf(w, a.x, o.x);
  o.y = fmaf(w, a.y, o.y);
  o.z = fmaf(w, a.z, o.z);
  o.w = fmaf(w, a.w, o.w);
}

// Four consecutive outputs, converted to T.
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(v.x, v.y);
  d[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Sixteen bytes of T as floats into dst (4 f32 or 8 bf16 values).
__device__ __forceinline__ void widen16(float* dst, uint4 c, const float*) {
  dst[0] = __uint_as_float(c.x);
  dst[1] = __uint_as_float(c.y);
  dst[2] = __uint_as_float(c.z);
  dst[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void widen16(float* dst, uint4 c,
                                        const __nv_bfloat16*) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = bf16_lo(w[i]);
    dst[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Two consecutive elements of T as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(bf16_lo(u), bf16_hi(u));
}

// Two consecutive outputs, converted to T.
__device__ __forceinline__ void store2(float* dst, float2 v) {
  *reinterpret_cast<float2*>(dst) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v.x, v.y);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lens, T* __restrict__ out,
                       float2* __restrict__ part_ml,
                       float* __restrict__ part_acc,
                       int32_t* __restrict__ tickets, int H, int KV, int bs,
                       int max_blocks, float scale, float softcap, int window,
                       int n_split) {
  using TT = Tile<T, HD>;
  constexpr int TR = TT::kRows;
  constexpr int kPerChunk = TT::kPerChunk;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem + 2 * TT::kStageBytes);
  float* p_s = q_s + G * HD;
  float* m_s = p_s + G * TR;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* w_s = a_s + G;
  int* pages_s = reinterpret_cast<int*>(w_s + G * n_split);
  const uint32_t stage0 = uint32_t(__cvta_generic_to_shared(smem));

  // This split's rows: the lane's resident rows inside the window, cut by
  // whole blocks into at most n_split contiguous ranges of at least
  // min_split_blocks(G, bs) blocks each.  The non-empty ranges are the
  // first n_live splits.
  const int len = lens[b];
  // rows past the table's reach do not exist in the gathered view
  const int n_rows = min(len, max_blocks * bs);
  const int first = window > 0 ? max(0, len - window) : 0;
  const int blk_first = first / bs;
  const int n_blk = max(0, (n_rows + bs - 1) / bs - blk_first);
  const int per =
      max((n_blk + n_split - 1) / n_split, min_split_blocks(G, bs));
  const int n_live = (n_blk + per - 1) / per;
  const int r_begin = max(first, (blk_first + split * per) * bs);
  const int r_end = min(n_rows, (blk_first + (split + 1) * per) * bs);
  // the pages of this split's blocks, read once
  const int blk0 = blk_first + split * per;
  const int32_t* table = tables + size_t(b) * max_blocks + blk0;
  const int n_pages = r_begin < r_end ? (r_end - 1) / bs - blk0 + 1 : 0;
  for (int i = tid; i < n_pages; i += kThreads) pages_s[i] = __ldg(table + i);
  int* last_s = pages_s + per;
  __syncthreads();

  auto load = [&](int stage, int t0) {
    const uint32_t k_dst = stage0 + stage * TT::kStageBytes;
    const uint32_t v_dst = k_dst + TR * TT::kKStride;
    for (int e = tid; e < TR * TT::kChunks; e += kThreads) {
      const int t = e / TT::kChunks, c = e % TT::kChunks;
      const int pos = t0 + t;
      const bool valid = pos < r_end;
      size_t row = 0;
      if (valid) {
        const size_t page = size_t(pages_s[pos / bs - blk0]);
        row = ((page * bs + pos % bs) * KV + kvh) * HD;
      }
      const uint8_t* k_src =
          reinterpret_cast<const uint8_t*>(k_pages + row) + c * 16;
      const uint8_t* v_src =
          reinterpret_cast<const uint8_t*>(v_pages + row) + c * 16;
      cp_async16(k_dst + t * TT::kKStride + c * 16, k_src, valid);
      cp_async16(v_dst + t * TT::kRowBytes + c * 16, v_src, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (r_begin < r_end) load(0, r_begin);

  const size_t head0 = size_t(b) * H + size_t(kvh) * G;
  const uint4* q16 = reinterpret_cast<const uint4*>(q + head0 * HD);
  for (int c = tid; c < G * HD / kPerChunk; c += kThreads)
    widen16(q_s + c * kPerChunk, __ldg(q16 + c),
            static_cast<const T*>(nullptr));
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // P V: this thread's 2 columns of heads hg, hg + kHeadGroups, ...; a
  // thread past the last whole head group (hg == kHeadGroups) owns no head
  const int cc = tid % TT::kColPairs;
  const int hg = tid / TT::kColPairs;
  const int n_own = hg < TT::kHeadGroups ? G : 0;
  float2 acc[kMaxHeads];
#pragma unroll
  for (int i = 0; i < kMaxHeads; ++i) acc[i] = make_float2(0.f, 0.f);

  for (int t0 = r_begin, it = 0; t0 < r_end; t0 += TR, ++it) {
    const int stage = it & 1;
    if (t0 + TR < r_end) {
      load(stage ^ 1, t0 + TR);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this tile has landed (and q, m, l are staged)
    const uint8_t* k_s = smem + stage * TT::kStageBytes;
    const T* v_s = reinterpret_cast<const T*>(k_s + TR * TT::kKStride);
    const int rows = min(TR, r_end - t0);

    // 1. scores: kRowThreads threads share a row, each taking every
    //    kRowThreads-th chunk of it for up to kHeadPass heads at once
    for (int t = tid / kRowThreads; t < TR; t += kThreads / kRowThreads) {
      const int sub = tid % kRowThreads;
      const uint4* kr = reinterpret_cast<const uint4*>(k_s + t * TT::kKStride);
      for (int g0 = 0; g0 < G; g0 += kHeadPass) {
        float d[kHeadPass];
#pragma unroll
        for (int i = 0; i < kHeadPass; ++i) d[i] = 0.f;
        if (t < rows) {
          for (int c = sub; c < TT::kChunks; c += kRowThreads) {
            float kf[kPerChunk];
            widen16(kf, kr[c], static_cast<const T*>(nullptr));
            // all heads' q first, then the products: the loads overlap
            float4 qv[kHeadPass][kPerChunk / 4];
#pragma unroll
            for (int i = 0; i < kHeadPass; ++i)
#pragma unroll
              for (int j = 0; j < kPerChunk / 4; ++j)
                qv[i][j] = g0 + i < G
                               ? *reinterpret_cast<const float4*>(
                                     q_s + (g0 + i) * HD + c * kPerChunk +
                                     4 * j)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int i = 0; i < kHeadPass; ++i)
#pragma unroll
              for (int j = 0; j < kPerChunk / 4; ++j) {
                d[i] = fmaf(qv[i][j].x, kf[4 * j], d[i]);
                d[i] = fmaf(qv[i][j].y, kf[4 * j + 1], d[i]);
                d[i] = fmaf(qv[i][j].z, kf[4 * j + 2], d[i]);
                d[i] = fmaf(qv[i][j].w, kf[4 * j + 3], d[i]);
              }
          }
        }
#pragma unroll
        for (int i = 0; i < kHeadPass; ++i) {
          if (g0 + i < G) {  // G is the same in every thread
            d[i] += __shfl_xor_sync(0xffffffffu, d[i], 1);
            d[i] += __shfl_xor_sync(0xffffffffu, d[i], 2);
          }
        }
        if (sub == 0) {
#pragma unroll
          for (int i = 0; i < kHeadPass; ++i) {
            if (g0 + i < G) {
              float x = d[i] * scale;
              if (softcap > 0.f) x = softcap * tanhf(x / softcap);
              p_s[(g0 + i) * TR + t] = t < rows ? x : kNegInf;
            }
          }
        }
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* prow = p_s + g * TR;
      float mx = kNegInf;
      for (int t = lane; t < TR; t += 32) mx = fmaxf(mx, prow[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float alpha = m_prev == kNegInf ? 0.f : expf(m_prev - m_new);
      if (m_new == kNegInf) alpha = 1.f;
      const float m_sub = m_new == kNegInf ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < TR; t += 32) {
        const float p = t < rows ? expf(prow[t] - m_sub) : 0.f;
        sum += p;
        prow[t] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = alpha * acc + P V on this thread's columns and heads
#pragma unroll
    for (int i = 0; i < kMaxHeads; ++i) {
      const int g = hg + i * TT::kHeadGroups;
      if (g < n_own) {
        const float a = a_s[g];
        acc[i] = make_float2(a * acc[i].x, a * acc[i].y);
      }
    }
#pragma unroll 4
    for (int t = 0; t < rows; ++t) {
      const float2 v = load2(v_s + t * HD + 2 * cc);
#pragma unroll
      for (int i = 0; i < kMaxHeads; ++i) {
        const int g = hg + i * TT::kHeadGroups;
        if (g < n_own) {
          const float p = p_s[g * TR + t];
          acc[i].x = fmaf(p, v.x, acc[i].x);
          acc[i].y = fmaf(p, v.y, acc[i].y);
        }
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }

  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < kMaxHeads; ++i) {
      const int g = hg + i * TT::kHeadGroups;
      if (g < n_own) {
        const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
        store2(out + (head0 + g) * HD + 2 * cc,
               make_float2(acc[i].x * inv, acc[i].y * inv));
      }
    }
    return;
  }

  // Partial (m, l, acc) of this split; an empty split leaves m = -inf and
  // l = 0, and the combine does not read its acc.
  const size_t part0 = (size_t(b) * KV + kvh) * n_split;
  const int n4 = G * HD / 4;
  float4* acc4 = reinterpret_cast<float4*>(part_acc) + part0 * n4;
  for (int g = tid; g < G; g += kThreads)
    part_ml[(part0 + split) * G + g] = make_float2(
        l_s[g] > 0.f ? m_s[g] : minus_inf(), l_s[g]);
  if (r_begin < r_end) {
#pragma unroll
    for (int i = 0; i < kMaxHeads; ++i) {
      const int g = hg + i * TT::kHeadGroups;
      if (g < n_own)
        reinterpret_cast<float2*>(acc4 + size_t(split) * n4)[g * HD / 2 + cc] =
            acc[i];
    }
  }
  __threadfence();
  __syncthreads();
  int32_t* ticket = tickets + size_t(b) * KV + kvh;
  if (tid == 0) *last_s = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // The last CTA of (b, kv): per head, M = max of the non-empty splits'
  // m, weights w_s = exp(m_s - M) / sum_s exp(m_s - M) l_s.
  for (int g = warp; g < G; g += kWarps) {
    float mx = minus_inf();
    for (int s = lane; s < n_live; s += 32) {
      const float2 ml = __ldcg(part_ml + (part0 + s) * G + g);
      if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      const float2 ml = __ldcg(part_ml + (part0 + s) * G + g);
      const float w = ml.y > 0.f ? expf(ml.x - mx) : 0.f;
      w_s[g * n_split + s] = w;
      sum += w * ml.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) l_s[g] = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  // sum_s w_s acc_s over the live splits, four columns a thread, eight
  // splits' loads in flight at a time
  for (int e = tid; e < n4; e += kThreads) {
    const int g = 4 * e / HD;
    const float* w = w_s + g * n_split;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    int s = 0;
    for (; s + 8 <= n_live; s += 8) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __ldcg(acc4 + size_t(s + i) * n4 + e);
#pragma unroll
      for (int i = 0; i < 8; ++i) fma4(o, w[s + i], a[i]);
    }
    for (; s < n_live; ++s) fma4(o, w[s], __ldcg(acc4 + size_t(s) * n4 + e));
    const float inv = l_s[g];
    store4(out + head0 * HD + 4 * e,
           make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* tables, const void* lens, void* out,
                   void* part_ml, void* part_acc, void* tickets, int B, int H,
                   int KV, int bs, int max_blocks, float scale, float softcap,
                   int window, int n_split, cudaStream_t stream) {
  const int G = H / KV;
  if (G > Tile<T, HD>::kMaxGroup) return cudaErrorInvalidValue;
  // the most blocks one split can take
  const int slice =
      max((max_blocks + n_split - 1) / n_split, min_split_blocks(G, bs));
  const size_t smem = smem_bytes<T, HD>(G, n_split, slice);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, KV, n_split);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lens), static_cast<T*>(out),
      static_cast<float2*>(part_ml), static_cast<float*>(part_acc),
      static_cast<int32_t*>(tickets), H, KV, bs, max_blocks, scale, softcap,
      window, n_split);
  return cudaGetLastError();
}

#define PAGED_ARGS                                                          \
  q, k_pages, v_pages, tables, lens, out, part_ml, part_acc, tickets, B, H, \
      KV, bs, max_blocks, scale, softcap, window, n_split, stream

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k_pages,
                        const void* v_pages, const void* tables,
                        const void* lens, void* out, void* part_ml,
                        void* part_acc, void* tickets, int B, int H, int KV,
                        int bs, int max_blocks, float scale, float softcap,
                        int window, int n_split, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(PAGED_ARGS);
    case 64: return launch<T, 64>(PAGED_ARGS);
    case 96: return launch<T, 96>(PAGED_ARGS);
    case 128: return launch<T, 128>(PAGED_ARGS);
    case 256: return launch<T, 256>(PAGED_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  n_split > 1 needs part_ml [B, KV,
// n_split, G] float2, part_acc [B, KV, n_split, G, hd] float and tickets
// [B * KV] int32, all zero; n_split == 1 uses none of them.  Returns the
// cudaError_t of the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lens, void* out,
                                      void* part_ml, void* part_acc,
                                      void* tickets, int B, int H, int KV,
                                      int hd, int bs, int max_blocks,
                                      float scale, float softcap, int window,
                                      int n_split, int dtype,
                                      void* stream_ptr) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || KV > 65535 || n_split < 1 ||
      n_split > 65535 || (n_split > 1 && (!part_ml || !part_acc || !tickets)))
    return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return int(dispatch_hd<float>(hd, PAGED_ARGS));
  if (dtype == 1)
    return int(dispatch_hd<__nv_bfloat16>(hd, PAGED_ARGS));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
