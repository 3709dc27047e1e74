// FlashAttention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:90 flash_attention_fwd
//   (kernel body `_kernel`, :38).
// Computes out[b, i, h] = softmax_j(mask(softcap(q[b, i, h] . k[b, j, h/G]
// / sqrt(dqk)))) v[b, j, h/G] with GQA (G = H / KV), masks taken from
// absolute positions: k_pos[j] >= 0 (-1 marks an empty cache slot), causal
// k_pos[j] <= q_pos[i], window k_pos[j] > q_pos[i] - window.  Q and K rows
// are dqk wide and V and out rows dv wide: dqk == dv in 16, 64, 96, 128,
// 256, or dqk 192 with dv 128 (multi-head latent attention's prefill: 128 + 64
// RoPE columns of query and key, 128 of value).  Both bodies are templates
// on <DQK, DV>.
//
// Bound on this card: a causal prefill of S rows does about 2 * S^2 * H * hd
// flops (masked pairs excluded) on 4 * S * hd * (H + KV) bytes of bf16 q, k,
// v and out, i.e. about S * H / (2 * (H + KV)) flops per byte (0.44 * S for
// TinyLlama).  Below S of roughly 660 rows that is under the H100's ~295
// flop/byte ridge and the least time is the bytes over 3.35 TB/s; longer
// prompts are bound by the tensor cores' 989 TFLOP/s.
//
// The C entry point dispatches on the input's dtype:
//
// bfloat16 — the tensor-core body (`flash_attention_wgmma_kernel`):
//   * one warpgroup (128 threads) per 64-row query tile of one (b, h); the
//     K/V sequence is walked in 64-row tiles inside the CTA, so scores never
//     leave the chip;
//   * Q, K and V tiles sit in shared memory in the 128-byte-swizzled layout
//     that `wgmma` reads (rows of 64 bf16, 8-row atoms of 1024 B, the 16-byte
//     chunk index XORed with the row index mod 8).  K and V go through a ring
//     of two stages, so the next tile loads while this one is computed.  One
//     thread fills a stage with TMA (`cp.async.bulk.tensor`, 64 x 64 boxes
//     of one head, zero-filled past Skv, completion on an mbarrier per
//     stage), which the 128-byte swizzle of the tensor map lays out as
//     `wgmma` reads it, and the other threads spend no instructions on
//     addresses or copies.  A row wider than 64 columns is a row of 64-
//     column blocks, one box each: 3 for Q and K at dqk 192, 2 for V;
//   * S = Q K^T is `wgmma.mma_async m64n64k16` with both operands in shared
//     memory (K-major), dqk / 16 steps; the f32 accumulator fragment stays
//     in registers,
//     where the causal, window and k_pos == -1 masks, the softcap and the
//     online softmax are applied (row max and sum over the quad of threads
//     sharing a row, by shuffles; m and l in f32);
//   * P = exp(s - m) is rounded to bf16 in registers and fed, without a trip
//     through shared memory, as the register A operand of a second `wgmma`
//     against V in shared memory (MN-major, one m64n64k16 per 64 columns of
//     dv); the O accumulator is f32 in registers: 32 floats a thread per 64
//     columns of dv, 128 at dv 256;
//   * each CTA first finds the range of K tiles that any of its rows can see
//     (from the positions) and walks only that range: tiles that the causal
//     or window mask removes whole are neither loaded nor computed.  Ragged
//     Sq and Skv are masked in the kernel, so every shape runs.  Head dims 16
//     and 96 pad their shared-memory rows and their O fragments to whole
//     64-column blocks (one and two): the last box reaches past the row,
//     TMA fills the rest with 0, Q K^T runs only the dqk / 16 k16 steps of
//     real columns, and the epilogue stores only dv columns.
//
// float32 — the CUDA-core body (`flash_attention_f32_kernel`): a float32
//   `wgmma` would run in TF32, whose 10-bit mantissa cannot meet the f32
//   bar of 2e-5, so f32 keeps full-precision FMAs: Q, K, V and the score
//   tile in shared memory as f32 (K padded by one column so a warp reading
//   32 key rows hits 32 banks), m and l in shared memory, the accumulator in
//   registers; 64-row tiles up to dqk 128 and 32 rows above.
//
// Arithmetic follows the Pallas kernel in both bodies: f32 scores, running
// max and sum; exp(s - m) rounded to the input type before the product with
// V; out = acc / max(l, 1e-30).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core body
// ---------------------------------------------------------------------------

// Query rows per CTA and key rows per iteration.
template <int DQK>
struct Tile {
  static constexpr int kBQ = DQK <= 128 ? 64 : 32;
  static constexpr int kBK = kBQ;
};

// Shared memory: q [BQ][DQK], k [BK][DQK+1], v [BK][DV], s [BQ][BK+1] and
// m, l, alpha [BQ] as floats, then the q and k positions as ints.
template <int DQK, int DV>
constexpr size_t smem_bytes() {
  constexpr int kBQ = Tile<DQK>::kBQ;
  constexpr int kBK = Tile<DQK>::kBK;
  return sizeof(float) * (size_t(kBQ) * DQK + size_t(kBK) * (DQK + 1) +
                          size_t(kBK) * DV + size_t(kBQ) * (kBK + 1) +
                          3 * size_t(kBQ)) +
         sizeof(int) * (kBQ + kBK);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int32_t* __restrict__ q_pos,
                           const int32_t* __restrict__ k_pos,
                           float* __restrict__ out, int Sq, int Skv, int H,
                           int KV, float scale, int causal, int window,
                           float softcap) {
  constexpr int kBQ = Tile<DQK>::kBQ;
  constexpr int kBK = Tile<DQK>::kBK;
  // kColThreads threads share a row of out: the thread owning columns
  // d_own + j * kColThreads (j < kCols) handles rows r0, r0 + kRowStep, ...
  // A row narrower than the CTA that does not divide it (dv 96) is shared
  // by one warp, 3 columns a thread.
  constexpr int kColThreads =
      DV >= kThreads ? kThreads : (kThreads % DV == 0 ? DV : 32);
  constexpr int kCols = DV / kColThreads;
  constexpr int kRowStep = kThreads / kColThreads;
  constexpr int kAcc = kBQ / kRowStep;
  static_assert(kThreads % kColThreads == 0 && DV % kColThreads == 0 &&
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
  float* k_s = q_s + kBQ * DQK;
  float* v_s = k_s + kBK * (DQK + 1);
  float* s_s = v_s + kBK * DV;
  float* m_s = s_s + kBQ * (kBK + 1);
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  int* qp_s = reinterpret_cast<int*>(a_s + kBQ);
  int* kp_s = qp_s + kBQ;

  for (int e = tid; e < kBQ * DQK; e += kThreads) {
    const int r = e / DQK, d = e % DQK;
    const int i = q0 + r;
    q_s[e] = i < Sq ? q[((size_t(b) * Sq + i) * H + h) * DQK + d] : 0.f;
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
    for (int e = tid; e < kBK * DQK; e += kThreads) {
      const int c = e / DQK, d = e % DQK;
      const int j = k0 + c;
      k_s[c * (DQK + 1) + d] =
          j < Skv ? k[((size_t(b) * Skv + j) * KV + kvh) * DQK + d] : 0.f;
    }
    for (int e = tid; e < kBK * DV; e += kThreads) {
      const int c = e / DV, d = e % DV;
      const int j = k0 + c;
      v_s[e] = j < Skv ? v[((size_t(b) * Skv + j) * KV + kvh) * DV + d] : 0.f;
    }
    for (int c = tid; c < kBK; c += kThreads)
      kp_s[c] = k0 + c < Skv ? k_pos[k0 + c] : -1;
    __syncthreads();

    // scores S = Q K^T over the tile, masked
    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      float s = kNegInf;
      if (visible(qp_s[r], kp_s[c], causal, window)) {
        const float* qr = q_s + r * DQK;
        const float* kr = k_s + c * (DQK + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DQK; ++d) dot = fmaf(qr[d], kr[d], dot);
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
        srow[c] = p;
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
        for (int c = 0; c < kBK; ++c) sum = fmaf(prow[c], v_s[c * DV + d], sum);
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
        out[((size_t(b) * Sq + qi) * H + h) * DV + d_own + j * kColThreads] =
            acc[i][j] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <int DQK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* q_pos, const void* k_pos, void* out, int B,
                       int Sq, int Skv, int H, int KV, float scale, int causal,
                       int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DQK, DV>();
  auto kernel = flash_attention_f32_kernel<DQK, DV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kBQ = Tile<DQK>::kBQ;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(k_pos), static_cast<float*>(out), Sq, Skv,
      H, KV, scale, causal, window, softcap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core (wgmma) body
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;        // query rows per CTA = key rows per tile
constexpr int kLineBytes = 128;    // one swizzled row: 64 bf16
constexpr int kBlockBytes = kTcRows * kLineBytes;  // 64 rows x 64 columns
constexpr float kLog2e = 1.4426950408889634f;

// 64-column blocks of a row of `HD` columns, the last one padded (hd 16
// to one block, hd 96 to two: TMA reads the columns past the row as 0)
template <int HD>
struct TcRow {
  static constexpr int kBlocks = (HD + 63) / 64;
  static constexpr int kTileBytes = kBlocks * kBlockBytes;
};

template <int DQK, int DV>
struct TcTile {
  static constexpr int kBlocksQK = TcRow<DQK>::kBlocks;  // of a q or k row
  static constexpr int kBlocksV = TcRow<DV>::kBlocks;    // of a v or out row
  static constexpr int kTileQK = TcRow<DQK>::kTileBytes;
  static constexpr int kTileV = TcRow<DV>::kTileBytes;
  static constexpr int kKSteps = DQK / 16;               // k16 steps of Q K^T
  // q tile, two stages of k and v, two stages of k positions, the tile
  // range, three mbarriers (q, and k/v of each stage), and slack to align
  // the tiles to the 1024-byte swizzle atom
  static constexpr size_t kSmem = size_t(3) * kTileQK + size_t(2) * kTileV +
                                  2 * kTcRows * sizeof(int) +
                                  4 * sizeof(int) + 3 * 8 + 1024;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// mbarriers and TMA (cp.async.bulk.tensor): one thread posts the bytes a
// stage expects and issues the copies; every thread waits on the phase.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box (64 columns, 1 head, 64 rows, 1 batch) at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Matrix descriptor of a 128-byte-swizzled operand: start address, leading
// byte offset (between 64-column blocks; unused by a single n64/k16 atom),
// stride byte offset 1024 (between 8-row groups), layout type 1 = SW128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t(kBlockBytes >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue/wait pair.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WGMMA_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WGMMA_OUT32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A B, A [64 x 16] and B [16 x 64] both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A [64 x 16] bf16 from registers, B [16 x 64] from shared
// memory, MN-major (trans-b).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x; -1e30 * log2(e) and below give +0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const int32_t* __restrict__ q_pos,
                             const int32_t* __restrict__ k_pos,
                             __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                             int H, int KV, float scale, int causal,
                             int window, float softcap) {
  using TT = TcTile<DQK, DV>;
  constexpr int kBlocksQK = TT::kBlocksQK;
  constexpr int kBlocksV = TT::kBlocksV;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // row within the warp's 8-row half
  const int t4 = lane % 4;  // thread within the quad sharing a row

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = uint32_t(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  constexpr int kTilesBytes = 3 * TT::kTileQK + 2 * TT::kTileV;
  const uint32_t q_tile = base;
  const uint32_t k_tile[2] = {base + TT::kTileQK, base + 2 * TT::kTileQK};
  const uint32_t v_tile[2] = {base + 3 * TT::kTileQK,
                              base + 3 * TT::kTileQK + TT::kTileV};
  int* kp_s = reinterpret_cast<int*>(smem + kTilesBytes);  // [2][64]
  int* range_s = kp_s + 2 * kTcRows;  // qmin, qmax, first tile, last tile
  // mbarriers: the q tile, then k/v of stage 0 and of stage 1
  const uint32_t bar_q = base + kTilesBytes + 2 * kTcRows * 4 + 16;
  const uint32_t bar_kv[2] = {bar_q + 8, bar_q + 16};

  // K and V rows of tile t into a stage, and their positions
  auto load_kv = [&](int stage, int t) {
    if (tid == 0) {
      mbar_expect(bar_kv[stage], TT::kTileQK + TT::kTileV);
#pragma unroll
      for (int nb = 0; nb < kBlocksQK; ++nb)
        tma_load(k_tile[stage] + nb * kBlockBytes, &k_map, bar_kv[stage],
                 nb * 64, kvh, t * kTcRows, b);
#pragma unroll
      for (int nb = 0; nb < kBlocksV; ++nb)
        tma_load(v_tile[stage] + nb * kBlockBytes, &v_map, bar_kv[stage],
                 nb * 64, kvh, t * kTcRows, b);
    }
    if (tid < kTcRows) {
      const int j = t * kTcRows + tid;
      cp_async4(uint32_t(__cvta_generic_to_shared(kp_s + stage * kTcRows +
                                                  tid)),
                j < Skv ? k_pos + j : k_pos, j < Skv);
    }
  };

  // The Q tile starts loading at once; the positions decide the K range.
  if (tid == 0) {
    mbar_init(bar_q);
    mbar_init(bar_kv[0]);
    mbar_init(bar_kv[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_q, TT::kTileQK);
#pragma unroll
    for (int nb = 0; nb < kBlocksQK; ++nb)
      tma_load(q_tile + nb * kBlockBytes, &q_map, bar_q, nb * 64, h, q0, b);
    range_s[0] = INT32_MAX;
    range_s[1] = INT32_MIN;
    range_s[2] = INT32_MAX;
    range_s[3] = -1;
  }
  // this thread's two rows of the accumulator fragments; rows past Sq take
  // position -1 (they see nothing causal and are never stored)
  const int row0 = warp * 16 + g;
  const int qp0 = q0 + row0 < Sq ? q_pos[q0 + row0] : -1;
  const int qp1 = q0 + row0 + 8 < Sq ? q_pos[q0 + row0 + 8] : -1;
  __syncthreads();
  if (q0 + row0 < Sq) {
    atomicMin(&range_s[0], qp0);
    atomicMax(&range_s[1], qp0);
  }
  if (q0 + row0 + 8 < Sq) {
    atomicMin(&range_s[0], qp1);
    atomicMax(&range_s[1], qp1);
  }
  __syncthreads();
  // the positions of this tile's rows span [qmin, qmax]
  const int qmin = range_s[0], qmax = range_s[1];
  {
    // K tiles holding a key that some row of this tile can see
    int lo = INT32_MAX, hi = -1;
    for (int j = tid; j < Skv; j += kThreads) {
      const int kp = k_pos[j];
      if (kp >= 0 && (!causal || kp <= qmax) &&
          (window <= 0 || kp > qmin - window)) {
        lo = min(lo, j / kTcRows);
        hi = max(hi, j / kTcRows);
      }
    }
    if (hi >= 0) {
      atomicMin(&range_s[2], lo);
      atomicMax(&range_s[3], hi);
    }
  }
  __syncthreads();
  const int t_first = range_s[2];
  const int t_end = range_s[3] + 1;  // empty when no key is visible

  if (t_first < t_end) load_kv(0, t_first);
  cp_async_commit();
  mbar_wait(bar_q, 0);

  float o[kBlocksV][32];
#pragma unroll
  for (int nb = 0; nb < kBlocksV; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  // m is kept in the units of the scores as the loop sees them: softcapped
  // (already scaled) or raw; exp(scale * s) = exp2(s * log2_scale)
  const float log2_scale = softcap > 0.f ? kLog2e : scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int t = t_first; t < t_end; ++t) {
    const int stage = (t - t_first) & 1;
    __syncthreads();  // every warp is done with the other stage
    if (t + 1 < t_end) load_kv(stage ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's key positions have landed
    mbar_wait(bar_kv[stage], ((t - t_first) >> 1) & 1);
    // does any (row, key) pair of the tile need a mask?  Each of the first
    // 64 threads checks the key whose position it copied itself.
    bool partial = false;
    if (tid < kTcRows) {
      const int kp = kp_s[stage * kTcRows + tid];
      partial = t * kTcRows + tid >= Skv || kp < 0 || (causal && kp > qmin) ||
                (window > 0 && kp <= qmax - window);
    }
    const bool masked = __syncthreads_or(partial);

    // S = Q K^T on the tensor cores
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TT::kKSteps; ++kk) {
      const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(q_tile + off), sw128_desc(k_tile[stage] + off),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // softcap and masks on the fragment: s[4j + 2r + e] is row row0 + 8r,
    // column 8j + 2 t4 + e of the tile.  Without a softcap the scores stay
    // unscaled, and the scale goes into the exponent's factor.
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = softcap * tanhf(s[i] * scale / softcap);
    }
    if (masked) {
      const int* kp_t = kp_s + stage * kTcRows;
      const int j0 = t * kTcRows;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t4 + e;
          const int kp = kp_t[c];
          const bool in_seq = j0 + c < Skv;
          if (!(in_seq && visible(qp0, kp, causal, window)))
            s[4 * j + e] = kNegInf;
          if (!(in_seq && visible(qp1, kp, causal, window)))
            s[4 * j + 2 + e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    // with the -1e30 sentinel, exp2 gives alpha = 0 for a row's first
    // visible tile, 1 while nothing is visible, and p = 0 where masked
    float alpha[2], m_sub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2((m[r] - m_new) * log2_scale);
      m_sub[r] = (m_new == kNegInf ? 0.f : m_new) * log2_scale;
      m[r] = m_new;
    }
    // P = exp(s - m), summed in f32 and rounded to bf16 for P V; packed in
    // the register A layout of the next wgmma (k step kk: s[8kk .. 8kk+7])
    uint32_t p[16];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = i & 1;  // s[2i] and s[2i + 1] lie in row row0 + 8r
      float pv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pv[e] = fast_exp2(fmaf(s[2 * i + e], log2_scale, -m_sub[r]));
        sum[r] += pv[e];
      }
      p[i] = pack_bf16(pv[0], pv[1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int nb = 0; nb < kBlocksV; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[nb][i] *= alpha[(i >> 1) & 1];
    }

    // O += P V on the tensor cores
#pragma unroll
    for (int nb = 0; nb < kBlocksV; ++nb) fence_regs(o[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kBlocksV; ++nb)
        wgmma_rs(o[nb], p + 4 * kk,
                 sw128_desc(v_tile[stage] + nb * kBlockBytes +
                            kk * 16 * kLineBytes));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int nb = 0; nb < kBlocksV; ++nb) fence_regs(o[nb]);
    fence_regs(p);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* orow = out + ((size_t(b) * Sq + qi) * H + h) * DV;
#pragma unroll
    for (int nb = 0; nb < kBlocksV; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = nb * 64 + 8 * j + 2 * t4;
        if (c < DV)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o[nb][4 * j + 2 * r] * l[r],
                                    o[nb][4 * j + 2 * r + 1] * l[r]);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, found through the runtime (no link
// against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A [B, rows, heads, HD] bf16 tensor as 64-column, 64-row boxes of one head,
// 128-byte swizzled (the layout wgmma reads); rows past the end, and at
// head dims 16 and 96 the columns past the row, read 0 (the row stride,
// 2 * HD bytes, is a multiple of 16, as TMA requires).
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int rows,
                int heads, int HD) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dim[4] = {cuuint64_t(HD), cuuint64_t(heads),
                             cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t stride[3] = {cuuint64_t(HD) * 2,
                                cuuint64_t(heads) * HD * 2,
                                cuuint64_t(rows) * heads * HD * 2};
  const cuuint32_t box[4] = {64, 1, kTcRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dim, stride, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos, void* out,
                        int B, int Sq, int Skv, int H, int KV, float scale,
                        int causal, int window, float softcap,
                        cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!(tensor_map(&maps[0], q, B, Sq, H, DQK) &&
        tensor_map(&maps[1], k, B, Skv, KV, DQK) &&
        tensor_map(&maps[2], v, B, Skv, KV, DV)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = TcTile<DQK, DV>::kSmem;
  auto kernel = flash_attention_wgmma_kernel<DQK, DV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kTcRows - 1) / kTcRows, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(k_pos), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, KV, scale, causal, window, softcap);
  return cudaGetLastError();
}

#define FLASH_ARGS \
  q, k, v, q_pos, k_pos, out, B, Sq, Skv, H, KV, scale, causal, window, \
      softcap, stream

cudaError_t dispatch(int hd, int dv, int dtype, const void* q,
                     const void* k, const void* v, const void* q_pos,
                     const void* k_pos, void* out, int B, int Sq, int Skv,
                     int H, int KV, float scale, int causal, int window,
                     float softcap, cudaStream_t stream) {
  if (dv != hd) {
    if (hd == 192 && dv == 128) {
      if (dtype == 0) return launch_f32<192, 128>(FLASH_ARGS);
      if (dtype == 1) return launch_bf16<192, 128>(FLASH_ARGS);
    }
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    switch (hd) {
      case 16: return launch_f32<16, 16>(FLASH_ARGS);
      case 64: return launch_f32<64, 64>(FLASH_ARGS);
      case 96: return launch_f32<96, 96>(FLASH_ARGS);
      case 128: return launch_f32<128, 128>(FLASH_ARGS);
      case 256: return launch_f32<256, 256>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return launch_bf16<16, 16>(FLASH_ARGS);
      case 64: return launch_bf16<64, 64>(FLASH_ARGS);
      case 96: return launch_bf16<96, 96>(FLASH_ARGS);
      case 128: return launch_bf16<128, 128>(FLASH_ARGS);
      case 256: return launch_bf16<256, 256>(FLASH_ARGS);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// hd: the q/k head dim; dv: the v/out head dim.  dtype: 0 = float32
// (CUDA-core body), 1 = bfloat16 (wgmma body).  Returns the cudaError_t of
// the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int Sq, int Skv, int H, int KV, int hd,
                                      int dv, float scale, int causal,
                                      int window, float softcap, int dtype,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 ||
      B * H > 65535)
    return int(cudaErrorInvalidValue);
  return int(dispatch(hd, dv, dtype, q, k, v, q_pos, k_pos, out, B, Sq, Skv,
                      H, KV, scale, causal, window, softcap,
                      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
