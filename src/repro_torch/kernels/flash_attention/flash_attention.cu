// FlashAttention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:90 flash_attention_fwd
//   (kernel body `_kernel`, :38).
// Computes out[b, i, h] = softmax_j(mask(softcap(q[b, i, h] . k[b, j, h/G]
// / sqrt(hd)))) v[b, j, h/G] with GQA (G = H / KV), masks taken from absolute
// positions: k_pos[j] >= 0 (-1 marks an empty cache slot), causal
// k_pos[j] <= q_pos[i], window k_pos[j] > q_pos[i] - window.
//
// Bound on this card: a causal prefill of S rows does about 2 * S^2 * H * hd
// flops (masked pairs excluded) on 4 * S * hd * (H + KV) bytes of bf16 q, k,
// v and out, i.e. about S * H / (2 * (H + KV)) flops per byte (0.44 * S for
// TinyLlama).  Below S of roughly 660 rows that is under the H100's ~295
// flop/byte ridge and the least time is the bytes over 3.35 TB/s; longer
// prompts are bound by the tensor cores' 989 TFLOP/s.  This first kernel
// does its products on the CUDA cores in f32 (67 TFLOP/s at most), so it
// sits far above either bound; wgmma tiles fed by TMA are the later step.
// What the design does about it:
//   * one CTA per (query tile, batch x head); the K/V sequence is walked
//     in tiles inside the CTA (the TPU's sequential kv grid axis becomes a
//     loop), so scores never leave the chip.  Tiles are 64 rows up to head
//     dim 128 and 32 rows at 256, which keeps the f32 tiles near 100 KB of
//     shared memory (two CTAs per SM) instead of 210 KB;
//   * each thread owns output columns of a few rows: at head dims up to
//     128 one column of kThreads / HD interleaved rows, at 256 two columns
//     (d and d + 128) of every row;
//   * Q, K, V and the score tile live in shared memory as f32 (K padded by
//     one column so a warp reading 32 key rows hits 32 banks); QK^T and PV
//     are computed here, not by a library;
//   * m, l in shared memory and the output accumulator in registers, f32;
//   * the ragged edges of Sq and Skv are masked inside the kernel, so every
//     shape runs here (the Pallas wrapper fell back to its oracle when the
//     shape did not tile).
//
// Arithmetic follows the Pallas kernel: f32 scores, running max and sum;
// exp(s - m) rounded to the input type before the product with V; out =
// acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Query rows per CTA and key rows per iteration.
template <int HD>
struct Tile {
  static constexpr int kBQ = HD <= 128 ? 64 : 32;
  static constexpr int kBK = kBQ;
};

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

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Shared memory: q [BQ][HD], k [BK][HD+1], v [BK][HD], s [BQ][BK+1] and
// m, l, alpha [BQ] as floats, then the q and k positions as ints.
template <int HD>
constexpr size_t smem_bytes() {
  constexpr int kBQ = Tile<HD>::kBQ;
  constexpr int kBK = Tile<HD>::kBK;
  return sizeof(float) * (size_t(kBQ) * HD + size_t(kBK) * (HD + 1) +
                          size_t(kBK) * HD + size_t(kBQ) * (kBK + 1) +
                          3 * size_t(kBQ)) +
         sizeof(int) * (kBQ + kBK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ q_pos,
                       const int32_t* __restrict__ k_pos, T* __restrict__ out,
                       int Sq, int Skv, int H, int KV, float scale, int causal,
                       int window, float softcap) {
  constexpr int kBQ = Tile<HD>::kBQ;
  constexpr int kBK = Tile<HD>::kBK;
  // kColThreads threads share a row: the thread owning columns d_own +
  // j * kColThreads (j < kCols) handles rows r0, r0 + kRowStep, ...
  constexpr int kColThreads = HD < kThreads ? HD : kThreads;
  constexpr int kCols = HD / kColThreads;
  constexpr int kRowStep = kThreads / kColThreads;
  constexpr int kAcc = kBQ / kRowStep;
  static_assert(kThreads % kColThreads == 0 && HD % kColThreads == 0 &&
                    kBQ % kRowStep == 0,
                "head dim and block must tile each other");

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d_own = tid % kColThreads;
  const int r0 = tid / kColThreads;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * HD;
  float* v_s = k_s + kBK * (HD + 1);
  float* s_s = v_s + kBK * HD;
  float* m_s = s_s + kBQ * (kBK + 1);
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  int* qp_s = reinterpret_cast<int*>(a_s + kBQ);
  int* kp_s = qp_s + kBQ;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int i = q0 + r;
    q_s[e] = i < Sq ? to_f32(q[((size_t(b) * Sq + i) * H + h) * HD + d]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    // rows past Sq are computed against position 0 and never stored
    qp_s[r] = q0 + r < Sq ? q_pos[q0 + r] : 0;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kAcc][kCols];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and q staged)
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int j = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (j < Skv) {
        const size_t row = ((size_t(b) * Skv + j) * KV + kvh) * HD;
        kx = to_f32(k[row + d]);
        vx = to_f32(v[row + d]);
      }
      k_s[c * (HD + 1) + d] = kx;
      v_s[c * HD + d] = vx;
    }
    for (int c = tid; c < kBK; c += kThreads)
      kp_s[c] = k0 + c < Skv ? k_pos[k0 + c] : -1;
    __syncthreads();

    // scores S = Q K^T over the tile, masked
    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      float s = kNegInf;
      if (visible(qp_s[r], kp_s[c], causal, window)) {
        const float* qr = q_s + r * HD;
        const float* kr = k_s + c * (HD + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      s_s[r * (kBK + 1) + c] = s;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < kBQ; r += kWarps) {
      float* srow = s_s + r * (kBK + 1);
      float mx = kNegInf;
      for (int c = lane; c < kBK; c += 32) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float alpha = m_prev == kNegInf ? 0.f : expf(m_prev - m_new);
      if (m_new == kNegInf) alpha = 1.f;
      const float m_sub = m_new == kNegInf ? 0.f : m_new;
      const int qp = qp_s[r];
      float sum = 0.f;
      for (int c = lane; c < kBK; c += 32) {
        const float p =
            visible(qp, kp_s[c], causal, window) ? expf(srow[c] - m_sub) : 0.f;
        sum += p;
        srow[c] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V for this thread's columns
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r0 + i * kRowStep;
      const float* prow = s_s + r * (kBK + 1);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int d = d_own + j * kColThreads;
        float sum = 0.f;
#pragma unroll 8
        for (int c = 0; c < kBK; ++c) sum = fmaf(prow[c], v_s[c * HD + d], sum);
        acc[i][j] = a_s[r] * acc[i][j] + sum;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = r0 + i * kRowStep;
    const int qi = q0 + r;
    if (qi < Sq) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        out[((size_t(b) * Sq + qi) * H + h) * HD + d_own + j * kColThreads] =
            from_f32<T>(acc[i][j] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* k_pos, void* out, int B,
                   int Sq, int Skv, int H, int KV, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kBQ = Tile<HD>::kBQ;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(k_pos), static_cast<T*>(out), Sq, Skv, H,
      KV, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos, void* out,
                        int B, int Sq, int Skv, int H, int KV, float scale,
                        int causal, int window, float softcap,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, q_pos, k_pos, out, B, Sq, Skv, H, KV,
                           scale, causal, window, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, k_pos, out, B, Sq, Skv, H, KV,
                           scale, causal, window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, k_pos, out, B, Sq, Skv, H, KV,
                            scale, causal, window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, q_pos, k_pos, out, B, Sq, Skv, H, KV,
                            scale, causal, window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int Sq, int Skv, int H, int KV, int hd,
                                      float scale, int causal, int window,
                                      float softcap, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 ||
      B * H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch_hd<float>(hd, q, k, v, q_pos, k_pos, out, B, Sq, Skv,
                                  H, KV, scale, causal, window, softcap, s));
  if (dtype == 1)
    return int(dispatch_hd<__nv_bfloat16>(hd, q, k, v, q_pos, k_pos, out, B,
                                          Sq, Skv, H, KV, scale, causal,
                                          window, softcap, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
