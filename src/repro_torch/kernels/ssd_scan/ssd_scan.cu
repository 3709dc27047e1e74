// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:82 ssd_scan_fwd
//   (kernel body `_kernel`, :38),
// and adds what that kernel lacks: an optional initial state h0 (absent
// means zeros), so a prefill that continues from a cache runs here too.
// For each (batch b, head h) it walks the sequence in chunks of kL rows and
// carries an f32 state h [hd, ns]; per chunk, with seg = cumsum(dt * A):
//   M[i][j] = (C_i . B_j) exp(seg_i - seg_j) dt_j        for j <= i
//   y_i     = sum_j M[i][j] x_j + exp(seg_i) (C_i . h) + D x_i
//   h      <- exp(seg_L) h + sum_j exp(seg_L - seg_j) dt_j x_j (x) B_j
// B and C are shared by all heads (ngroups = 1).
//
// Bound on this card: the function reads x, B, C, dt (and h0) once and
// writes y and the final state once, all f32 except a bf16 x/B/C; at
// mamba2-370m's prefill of S rows (nh 32, hd 64, ns 128) that is about
// 16 KiB per row plus 2 MiB of state, and it does about 4 S nh hd ns f32
// flops (the C.h and state-update products; the intra-chunk part is
// smaller).  So at S = 131 it needs ~146 Mflop against ~3.8 MB: 2.2 us at
// the 67 TFLOP/s f32 rate of the CUDA cores versus ~1.1 us of HBM traffic,
// i.e. it is bound by operations.  This first kernel does all products on
// the CUDA cores from shared memory, so it sits well above that bound;
// tensor-core (wgmma, TF32 or bf16) products and TMA loads are later work.
// What the design does about it:
//   * the Pallas grid's sequential chunk axis becomes a loop inside one CTA,
//     and h never leaves shared memory between chunks;
//   * the hd axis splits cleanly (y[:, p] and h[p, :] depend only on x[:, p]
//     and h[p, :]), so the grid is (hd / HP, nh, B) with HP = 16 (8 for hd 8):
//     128 CTAs at B = 1 on the 132 SMs, each recomputing the chunk's C B^T;
//   * a fixed chunk of kL = 32 rows: one warp computes the chunk's cumsum
//     with shuffles, every tile fits in 48 KiB of shared memory at ns = 128,
//     and a prime sequence length costs one ragged chunk, not an S x S tile.
//     Rows past S load as zeros with dt = 0: they add exact zeros to y and h
//     and are never stored;
//   * B and C tiles are padded by one column so a warp reading 32 rows of
//     one column hits 32 banks.
// All arithmetic is f32; exp(seg_i - seg_j) is evaluated only for j <= i,
// where it cannot overflow (A < 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 32;  // rows per chunk: one warp's scan

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory, in floats: B and C [kL][NS+1], M [kL][kL+1], x [kL][HP],
// h [HP][NS+1], and seg, dt, w, exp(seg) [kL].
template <int HP, int NS>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * size_t(kL) * (NS + 1) + size_t(kL) * (kL + 1) +
                          size_t(kL) * HP + size_t(HP) * (NS + 1) + 4 * kL);
}

template <typename T, int HP, int NS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ state, int S, int nh, int hd) {
  constexpr int NSP = NS + 1;
  constexpr int MP = kL + 1;
  extern __shared__ float smem[];
  float* sB = smem;
  float* sC = sB + kL * NSP;
  float* sM = sC + kL * NSP;
  float* sX = sM + kL * MP;
  float* sH = sX + kL * HP;
  float* sSeg = sH + HP * NSP;
  float* sDt = sSeg + kL;
  float* sW = sDt + kL;
  float* sE = sW + kL;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * HP;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const float a = A[head];
  const float d = D[head];
  // rows p0 .. p0 + HP of state[b, head] are HP * NS consecutive floats
  const size_t h_base = ((size_t(b) * nh + head) * hd + p0) * NS;

  for (int e = tid; e < HP * NS; e += kThreads)
    sH[(e / NS) * NSP + e % NS] = h0 ? h0[h_base + e] : 0.f;

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int Lc = min(kL, S - c0);
    __syncthreads();  // the previous chunk is done with every tile
    for (int e = tid; e < kL * NS; e += kThreads) {
      const int r = e / NS, s = e % NS;
      float bv = 0.f, cv = 0.f;
      if (r < Lc) {
        const size_t g = (size_t(b) * S + c0 + r) * NS + s;
        bv = to_f32(Bm[g]);
        cv = to_f32(Cm[g]);
      }
      sB[r * NSP + s] = bv;
      sC[r * NSP + s] = cv;
    }
    for (int e = tid; e < kL * HP; e += kThreads) {
      const int r = e / HP, p = e % HP;
      sX[e] = r < Lc ? to_f32(x[((size_t(b) * S + c0 + r) * nh + head) * hd +
                                p0 + p])
                     : 0.f;
    }
    if (tid < 32) {  // warp 0: inclusive scan of dt * A over the chunk
      const float dtv =
          tid < Lc ? dt[(size_t(b) * S + c0 + tid) * nh + head] : 0.f;
      float v = dtv * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += n;
      }
      // rows past S have dt = 0, so seg is flat there and the total is
      // seg at the last real row
      const float total = __shfl_sync(0xffffffffu, v, 31);
      sSeg[tid] = v;
      sDt[tid] = dtv;
      sW[tid] = expf(total - v) * dtv;
      sE[tid] = expf(v);
    }
    __syncthreads();

    // M = (C B^T) o tril(exp(seg_i - seg_j)) o dt_j; a warp holds one row i
    for (int e = tid; e < kL * kL; e += kThreads) {
      const int i = e / kL, j = e % kL;
      float m = 0.f;
      if (j <= i && i < Lc) {
        const float* ci = sC + i * NSP;
        const float* bj = sB + j * NSP;
        float g = 0.f;
#pragma unroll 8
        for (int s = 0; s < NS; ++s) g = fmaf(ci[s], bj[s], g);
        m = g * expf(sSeg[i] - sSeg[j]) * sDt[j];
      }
      sM[i * MP + j] = m;
    }
    __syncthreads();

    // y = M x + exp(seg) (C h^T) + D x, from the state before this chunk
    for (int e = tid; e < kL * HP; e += kThreads) {
      const int i = e / HP, p = e % HP;
      if (i >= Lc) continue;
      const float* mi = sM + i * MP;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(mi[j], sX[j * HP + p], intra);
      const float* ci = sC + i * NSP;
      const float* hp = sH + p * NSP;
      float inter = 0.f;
#pragma unroll 8
      for (int s = 0; s < NS; ++s) inter = fmaf(ci[s], hp[s], inter);
      y[((size_t(b) * S + c0 + i) * nh + head) * hd + p0 + p] =
          intra + sE[i] * inter + d * sX[i * HP + p];
    }
    __syncthreads();

    // h <- exp(total) h + sum_j w_j x_j (x) B_j
    const float decay = expf(sSeg[kL - 1]);
    for (int e = tid; e < HP * NS; e += kThreads) {
      const int p = e / NS, s = e % NS;
      float acc = 0.f;
      for (int j = 0; j < Lc; ++j)
        acc = fmaf(sW[j] * sX[j * HP + p], sB[j * NSP + s], acc);
      sH[p * NSP + s] = decay * sH[p * NSP + s] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < HP * NS; e += kThreads)
    state[h_base + e] = sH[(e / NS) * NSP + e % NS];
}

template <typename T, int HP, int NS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* h0, void* y, void* state, int B, int S,
                   int nh, int hd, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HP, NS>();
  auto kernel = ssd_scan_kernel<T, HP, NS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(hd / HP, nh, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(state), S, nh, hd);
  return cudaGetLastError();
}

template <typename T, int HP>
cudaError_t dispatch_ns(int ns, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D,
                        const void* h0, void* y, void* state, int B, int S,
                        int nh, int hd, cudaStream_t s) {
  switch (ns) {
    case 8:
      return launch<T, HP, 8>(x, dt, A, Bm, Cm, D, h0, y, state, B, S, nh,
                              hd, s);
    case 16:
      return launch<T, HP, 16>(x, dt, A, Bm, Cm, D, h0, y, state, B, S, nh,
                               hd, s);
    case 32:
      return launch<T, HP, 32>(x, dt, A, Bm, Cm, D, h0, y, state, B, S, nh,
                               hd, s);
    case 128:
      return launch<T, HP, 128>(x, dt, A, Bm, Cm, D, h0, y, state, B, S, nh,
                                hd, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, int ns, const void* x, const void* dt,
                        const void* A, const void* Bm, const void* Cm,
                        const void* D, const void* h0, void* y, void* state,
                        int B, int S, int nh, cudaStream_t s) {
  switch (hd) {
    case 8:
      return dispatch_ns<T, 8>(ns, x, dt, A, Bm, Cm, D, h0, y, state, B, S,
                               nh, hd, s);
    case 16:
    case 32:
    case 64:
      return dispatch_ns<T, 16>(ns, x, dt, A, Bm, Cm, D, h0, y, state, B, S,
                                nh, hd, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, Bm, Cm: dtype 0 = float32, 1 = bfloat16; dt, A, D, h0, y, state are
// float32.  h0 may be null (zero initial state).  Returns the cudaError_t
// of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* h0, void* y, void* state, int B,
                               int S, int nh, int hd, int ns, int dtype,
                               void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || B > 65535 || nh > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch_hd<float>(hd, ns, x, dt, A, Bm, Cm, D, h0, y, state,
                                  B, S, nh, s));
  if (dtype == 1)
    return int(dispatch_hd<__nv_bfloat16>(hd, ns, x, dt, A, Bm, Cm, D, h0, y,
                                          state, B, S, nh, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
