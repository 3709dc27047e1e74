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
// bytes over 3.35 TB/s.
// What the design does about it:
//   * one CTA per (lane, KV head) serves all G query heads of the group, so
//     each K/V row crosses device memory once (the Pallas grid walks
//     (b, h, block) and reads every row once per query head);
//   * the CTA reads block_tables[b, i] itself and stops at the lane's last
//     resident row (ceil(len / bs) blocks; the Pallas grid visits all
//     max_blocks, whose masked blocks add exact zeros), and with a window
//     starts at the first row inside it;
//   * K/V rows are staged once per tile in shared memory as f32 and reused
//     by the G heads; scores, the online softmax (m, l) and the output
//     accumulator stay on chip in f32.
// Not done yet (later work): vectorised 16-byte loads, a split over the
// context for long rows with few lanes (the grid is only B * KV CTAs),
// cp.async/TMA double buffering.
//
// Arithmetic follows the Pallas kernel: scores and the running max/sum in
// f32, exp(s - m) rounded to the input type before the product with V, and
// out = acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

// Rows of K/V staged per iteration: 64 for head dims up to 64, 32 above,
// which keeps the K and V tiles near 33 KB of shared memory up to head dim
// 128 and near 66 KB at 256 (with recurrentgemma's 10 heads per KV head
// the whole CTA takes 87.5 KB, through the dynamic shared-memory limit).
template <int HD>
struct Tile {
  static constexpr int kRows = HD <= 64 ? 64 : 32;
};

// Shared memory, in floats: q [G][HD], k [T][HD+1] (padded: lane t reads
// row t without bank conflicts), v [T][HD], p [G][T], acc [G][HD], and the
// per-head running max m, sum l and this tile's rescale factor alpha.
template <int HD>
size_t smem_bytes(int G) {
  constexpr int T = Tile<HD>::kRows;
  return sizeof(float) * (size_t(G) * HD + size_t(T) * (HD + 1) +
                          size_t(T) * HD + size_t(G) * T + size_t(G) * HD +
                          3 * size_t(G));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lens, T* __restrict__ out,
                       int H, int KV, int bs, int max_blocks, float scale,
                       float softcap, int window) {
  constexpr int TR = Tile<HD>::kRows;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * HD;
  float* v_s = k_s + TR * (HD + 1);
  float* p_s = v_s + TR * HD;
  float* acc = p_s + G * TR;
  float* m_s = acc + G * HD;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const size_t head0 = size_t(b) * H + size_t(kvh) * G;
  for (int e = tid; e < G * HD; e += kThreads) {
    q_s[e] = to_f32(q[head0 * HD + e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = lens[b];
  // rows past the table's reach do not exist in the gathered view
  const int n_rows = min(len, max_blocks * bs);
  const int first = window > 0 ? max(0, len - window) : 0;
  const int32_t* table = tables + size_t(b) * max_blocks;

  for (int t0 = first; t0 < n_rows; t0 += TR) {
    // 1. stage the tile's K/V rows; rows past the end are zero
    for (int e = tid; e < TR * HD; e += kThreads) {
      const int t = e / HD, d = e % HD;
      const int pos = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (pos < n_rows) {
        const size_t page = size_t(table[pos / bs]);
        const size_t row = ((page * bs + pos % bs) * KV + kvh) * HD;
        kx = to_f32(k_pages[row + d]);
        vx = to_f32(v_pages[row + d]);
      }
      k_s[t * (HD + 1) + d] = kx;
      v_s[t * HD + d] = vx;
    }
    __syncthreads();

    // 2. scores of every (head, row) pair of the tile
    for (int e = tid; e < G * TR; e += kThreads) {
      const int g = e / TR, t = e % TR;
      const int pos = t0 + t;
      float s = kNegInf;
      if (pos < n_rows && (window <= 0 || pos > len - 1 - window)) {
        const float* qr = q_s + g * HD;
        const float* kr = k_s + t * (HD + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      p_s[e] = s;
    }
    __syncthreads();

    // 3. online softmax, one warp per query head
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
        const int pos = t0 + t;
        const bool valid =
            pos < n_rows && (window <= 0 || pos > len - 1 - window);
        const float p = valid ? expf(prow[t] - m_sub) : 0.f;
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

    // 4. acc = alpha * acc + P V
    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD, d = e % HD;
      const float* prow = p_s + g * TR;
      float sum = 0.f;
#pragma unroll 8
      for (int t = 0; t < TR; ++t) sum = fmaf(prow[t], v_s[t * HD + d], sum);
      acc[e] = a_s[g] * acc[e] + sum;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD;
    out[head0 * HD + e] = from_f32<T>(acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* tables, const void* lens, void* out, int B,
                   int H, int KV, int bs, int max_blocks, float scale,
                   float softcap, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(H / KV);
  auto kernel = paged_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, KV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lens), static_cast<T*>(out), H, KV, bs,
      max_blocks, scale, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k_pages,
                        const void* v_pages, const void* tables,
                        const void* lens, void* out, int B, int H, int KV,
                        int bs, int max_blocks, float scale, float softcap,
                        int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k_pages, v_pages, tables, lens, out, B, H, KV,
                           bs, max_blocks, scale, softcap, window, stream);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, tables, lens, out, B, H, KV,
                           bs, max_blocks, scale, softcap, window, stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, tables, lens, out, B, H, KV,
                            bs, max_blocks, scale, softcap, window, stream);
    case 256:
      return launch<T, 256>(q, k_pages, v_pages, tables, lens, out, B, H, KV,
                            bs, max_blocks, scale, softcap, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lens, void* out, int B,
                                      int H, int KV, int hd, int bs,
                                      int max_blocks, float scale,
                                      float softcap, int window, int dtype,
                                      void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch_hd<float>(hd, q, k_pages, v_pages, tables, lens, out,
                                  B, H, KV, bs, max_blocks, scale, softcap,
                                  window, s));
  if (dtype == 1)
    return int(dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, tables,
                                          lens, out, B, H, KV, bs,
                                          max_blocks, scale, softcap, window,
                                          s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
