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
// 3.35 TB/s.
// What the design does about it:
//   * one thread per (batch, channel) walks S in order with h in a
//     register, so h never leaves the chip between steps (the TPU's
//     sequential chunk axis and its VMEM carry become this loop);
//   * neighbouring threads own neighbouring channels, so each warp reads
//     and writes 128 contiguous bytes of a row per step: every load and
//     store is coalesced; the loop is unrolled so that the loads of several
//     steps, which do not depend on h, are in flight together;
//   * grid (ceil(W / 128), B): any W (the ragged channel block is masked)
//     and any S >= 1, with no divisor rule.
// Not done yet (later work): at B = 1 and W = 2560 the grid is 20 CTAs on
// 132 SMs; a chunked two-pass scan over S (chunk scans in parallel, then a
// pass that carries each chunk's state into the next) would fill the card.
//
// Rounding: h = fl(fl(a * h) + bx), the product and the sum rounded apart
// (no fused multiply-add), in the order of the plain version's sequential
// loop, so the two agree bit for bit.  JAX's associative scan rounds in
// another order; its kernel test allows 1e-4.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ h_final, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t lane = size_t(b) * W + w;
  const size_t base = size_t(b) * S * W + w;
  float h = h0 != nullptr ? h0[lane] : 0.f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const size_t i = base + size_t(t) * W;
    h = __fadd_rn(__fmul_rn(a[i], h), bx[i]);
    hs[i] = h;
  }
  h_final[lane] = h;
}

}  // namespace

// a, bx, hs: [B, S, W]; h0 (may be null), h_final: [B, W]; all float32.
// Returns the cudaError_t of the launch.
extern "C" int rglru_scan_launch(const void* a, const void* bx,
                                 const void* h0, void* hs, void* h_final,
                                 int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(bx),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h_final), S, W);
  return int(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
