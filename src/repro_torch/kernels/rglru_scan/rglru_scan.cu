// RG-LRU linear scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan/rglru_scan.py:53 rglru_scan_fwd
//   (kernel body `_kernel`, :29).
// Computes, per (batch b, channel w), h_t = a_t * h_{t-1} + bx_t over
// t = 0 .. S-1 from h_{-1} = h0[b, w] (zeros when h0 is absent), and
// returns every h_t (hs [B, S, W]) and h_{S-1} (h_final [B, W]), all f32.
// Unlike the Pallas kernel it takes h0, so a prefill that continues a
// cached state runs here too.
//
// Bound on this card: bytes.  Each element reads a and bx and writes h
// (12 bytes) for one multiply and one add, far below the H100's flop/byte
// ridge: the least time is 12 * B * S * W bytes (plus h0 and h_final) over
// 3.35 TB/s, 1.21 us for recurrentgemma-2b's prefill of 131 rows (B 1,
// W 2560, 4.04 MB).
// What the design does about it: a walk of S steps per channel leaves the
// card idle at B = 1 (one thread per channel is 20 CTAs of 128 threads on
// 132 SMs), so the sequence is split too, and scanned in two passes in one
// launch:
//   * a CTA covers 16 channels times K chunks of `rows` rows (K from the
//     wrapper: 160 CTAs of 16 x 16 threads, 9 rows each, at B 1, W 2560,
//     S 131; at most 16 rows a chunk).  Each thread owns one (channel,
//     chunk) and loads its chunk's a and bx into registers, all loads in
//     flight together; a warp spans 16 channels of two chunks, so every load
//     and store moves whole 64-byte row segments;
//   * pass 1: each thread computes its chunk's product of a and its end
//     state from h = 0;
//   * carry: one thread per channel walks the K chunks in shared memory,
//     h_in[k] = h, h = prod_k * h + end_k, giving each chunk its incoming
//     state;
//   * pass 2: each thread re-walks its chunk from h_in, from registers, and
//     writes hs;
//   * a sequence longer than K * rows loops over super-chunks of K * rows
//     with the carry kept in a register; a ragged end pads with a = 1,
//     bx = 0 (exact no-ops) and is never stored, and a ragged channel block
//     is masked, so every S >= 1 and W >= 1 runs with no divisor rule.
//
// Rounding: every step is fl(fl(a * h) + b), the product and the sum rounded
// apart (no fused multiply-add), in the order of `ref.chunked_reference`,
// which the kernel equals bit for bit.  Against the sequential plain version
// (`ref.reference`) only each chunk's incoming state is summed in another
// order (as JAX's associative scan sums in another order again); the bars
// are 1e-4, and 1e-3 for a decay near one.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kChannels = 16;   // channels per CTA
constexpr int kMaxChunks = 32;  // chunks per CTA
constexpr int kMaxRows = 16;    // rows a thread holds per super-chunk

__global__ void __launch_bounds__(kChannels * kMaxChunks)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ h_final, int S, int W, int K,
                  int rows) {
  // per (chunk, channel): the product of a, then the end state from h = 0,
  // which the carry overwrites with the chunk's incoming state
  __shared__ float sP[kMaxChunks][kChannels];
  __shared__ float sH[kMaxChunks][kChannels];
  const int c = threadIdx.x % kChannels, k = threadIdx.x / kChannels;
  const int w = blockIdx.x * kChannels + c;
  const int b = blockIdx.y;
  const bool live = w < W;
  const size_t lane = size_t(b) * W + w;
  const size_t base = size_t(b) * S * W + w;
  float carry = (live && h0 != nullptr) ? h0[lane] : 0.f;  // used by k == 0

  for (int s0 = 0; s0 < S; s0 += K * rows) {
    const int r0 = s0 + k * rows;
    // rows of this chunk that exist: the rest pad with a = 1, bx = 0
    const int n = live ? max(0, min(rows, S - r0)) : 0;
    const size_t first = base + size_t(n ? r0 : 0) * W;
    float av[kMaxRows], bv[kMaxRows];
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t) {
      av[t] = t < n ? a[first + size_t(t) * W] : 1.f;
      bv[t] = t < n ? bx[first + size_t(t) * W] : 0.f;
    }
    float prod = 1.f, end = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t) {
      end = __fadd_rn(__fmul_rn(av[t], end), bv[t]);
      prod = __fmul_rn(prod, av[t]);
    }
    sP[k][c] = prod;
    sH[k][c] = end;
    __syncthreads();
    if (k == 0) {  // the loads do not wait on the carry: keep 8 in flight
#pragma unroll 8
      for (int j = 0; j < K; ++j) {
        const float pj = sP[j][c], ej = sH[j][c];
        sH[j][c] = carry;
        carry = __fadd_rn(__fmul_rn(pj, carry), ej);
      }
    }
    __syncthreads();
    float h = sH[k][c];
    float* out = hs + first;
#pragma unroll
    for (int t = 0; t < kMaxRows; ++t) {
      if (t < n) {
        h = __fadd_rn(__fmul_rn(av[t], h), bv[t]);
        *out = h;
        out += W;
      }
    }
    __syncthreads();  // the next super-chunk rewrites sP and sH
  }
  if (k == 0 && live) h_final[lane] = carry;
}

}  // namespace

// a, bx, hs: [B, S, W]; h0 (may be null), h_final: [B, W]; all float32.
// n_chunks: chunks of the sequence per CTA (1 .. 32), each of
// ceil(S / n_chunks) rows, at most 16, per super-chunk.  Returns the
// cudaError_t of the launch.
extern "C" int rglru_scan_launch(const void* a, const void* bx,
                                 const void* h0, void* hs, void* h_final,
                                 int B, int S, int W, int n_chunks,
                                 void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || n_chunks < 1 ||
      n_chunks > kMaxChunks)
    return int(cudaErrorInvalidValue);
  const int per = (S + n_chunks - 1) / n_chunks;
  const int rows = per < kMaxRows ? per : kMaxRows;
  const dim3 grid((W + kChannels - 1) / kChannels, B);
  rglru_scan_kernel<<<grid, kChannels * n_chunks, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(bx),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h_final), S, W, n_chunks, rows);
  return int(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
