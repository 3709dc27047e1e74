// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:82 ssd_scan_fwd
//   (kernel body `_kernel`, :38),
// and adds what that kernel lacks: an optional initial state h0 (absent
// means zeros), so a prefill that continues from a cache runs here too.
// For each (batch b, head h) it walks the sequence in chunks of L rows and
// carries an f32 state h [hd, ns]; per chunk, with seg = cumsum(dt * A):
//   M[i][j] = (C_i . B_j) exp(seg_i - seg_j) dt_j        for j <= i
//   y_i     = sum_j M[i][j] x_j + exp(seg_i) (C_i . h) + D x_i
//   h      <- exp(seg_L) h + sum_j exp(seg_L - seg_j) dt_j x_j (x) B_j
// B and C are shared by all heads (ngroups = 1).
//
// Bound on this card: the function reads x, B, C, dt (and h0) once and
// writes y and the final state once; at mamba2-370m's prefill of S rows
// (nh 32, hd 64, ns 128, bf16 x/B/C) that is about 16 KiB per row plus 2 MiB
// of state, for about 4 S nh hd ns flops (the C.h and state-update products;
// the intra-chunk part is smaller).  At S = 131: 3.79 MB and 147 Mflop.  On
// the bf16 tensor cores (989 TFLOP/s) the flops take 0.15 us and the bytes
// 1.13 us at 3.35 TB/s, so the bf16 body is bound by bytes; on the CUDA
// cores (67 TFLOP/s) the same flops take 2.19 us, so the f32 body is bound
// by operations.
//
// Shared by both bodies:
//   * the Pallas grid's sequential chunk axis becomes a loop inside one CTA,
//     and h never leaves the SM between chunks;
//   * the hd axis splits cleanly (y[:, p] and h[p, :] depend only on x[:, p]
//     and h[p, :]), so the grid is (hd / HP, nh, B) with HP = 16 (8 for hd 8):
//     128 CTAs at B = 1 on the 132 SMs, each computing the chunk's C B^T;
//   * a prime sequence length costs one ragged chunk, not an S x S tile: rows
//     past S load as zeros with dt = 0, add exact zeros to y and h and are
//     never stored;
//   * exp(seg_i - seg_j) is evaluated only for j <= i, where it cannot
//     overflow (A < 0).
//
// The C entry point dispatches on the dtype of x, B and C:
//
// bfloat16 — the tensor-core body (`ssd_scan_mma_kernel`), chunks of 64 rows:
//   * every product is `mma.sync.m16n8k16` in bf16 with f32 accumulators,
//     fed by `ldmatrix` from padded (conflict-free) shared-memory rows:
//     G = C B^T on the exact bf16 operands; y_intra = M x; y_inter = C h^T;
//     the state update (w x)^T B.  M, h and w x are f32, and a single bf16
//     rounding of any of them misses the 1e-4 bar by 30-60x, so each is fed
//     as two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), in two products
//     into separate f32 accumulators (about 16 bits of mantissa; a 5x
//     margin).  K is padded with zeros to 16 where ns = 8;
//   * 16 warps in three roles, two barriers a chunk.  Ten warps each build
//     one 16 x 16 block of the chunk's causal M (G's products are issued
//     before the warp's scan of dt * A, which then gives seg_i and seg_j by
//     shuffles) and store it as bf16 hi/lo rows; eight "y" warps then each
//     compute 16 rows x 8 columns of y from M, x, C and h; eight "state"
//     warps hold h in the f32 accumulators of the state update across
//     chunks (two 8-column tiles of the 16 x ns state each), split it into
//     bf16 hi/lo rows once per chunk (the B operand of the next C h^T), and
//     add (w x)^T B.  The y warps pair the causal row tiles {0, 3} and
//     {1, 2} on each SM sub-partition.  Each warp loads the fragments of
//     several k-steps before their products, and hi and lo products go to
//     separate accumulators, so that products do not wait on loads or on
//     each other (the kernel is bound by latency, not by the tensor cores);
//   * the next chunk's B, C, x (16-byte `cp.async`) and dt tiles load into
//     the other stage of a two-stage ring while this chunk computes.
//   Inputs that are not 16-byte aligned load through plain loads instead of
//   `cp.async`, so every tensor the wrapper accepts runs.  The exponentials
//   of M use the fast `__expf` (relative error about 1e-6, far inside the
//   bar once M is rounded to two bf16 terms).
//
// float32 — the CUDA-core body (`ssd_scan_f32_kernel`), chunks of 32 rows:
// a float32 tensor-core product runs in TF32, which cannot meet the 1e-4
// bar on f32 x, B and C, so every product is an f32 FMA from shared memory
// (B and C tiles padded by one column so a warp reading 32 rows of one
// column hits 32 banks), one warp computes the chunk's cumsum with
// shuffles, and h stays in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// float32: the CUDA-core body

constexpr int kL = 32;  // rows per chunk: one warp's scan

// Shared memory, in floats: B and C [kL][NS+1], M [kL][kL+1], x [kL][HP],
// h [HP][NS+1], and seg, dt, w, exp(seg) [kL].
template <int HP, int NS>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * size_t(kL) * (NS + 1) + size_t(kL) * (kL + 1) +
                          size_t(kL) * HP + size_t(HP) * (NS + 1) + 4 * kL);
}

template <int HP, int NS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ D,
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
        bv = Bm[g];
        cv = Cm[g];
      }
      sB[r * NSP + s] = bv;
      sC[r * NSP + s] = cv;
    }
    for (int e = tid; e < kL * HP; e += kThreads) {
      const int r = e / HP, p = e % HP;
      sX[e] = r < Lc ? x[((size_t(b) * S + c0 + r) * nh + head) * hd + p0 + p]
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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body

using bf16 = __nv_bfloat16;
constexpr int kTL = 64;  // rows per chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane l addresses row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two 8x8 matrices (lanes 0-15 address them), transposed.
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p)));
}

// d += a b: a 16x16 (row-major fragment), b 16x8 (column-major), f32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as two bf16 pairs, hi = bf16(v) and lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// Shared memory of the tensor-core body, in bytes.  Two stages of {C, B
// [kTL][CS], x [kTL][XS] (bf16), dt [kTL] (f32)}, then h hi/lo [16][CS],
// (w x)^T hi/lo [16][WS] and M hi/lo [kTL][WS] (bf16), then exp(seg) [kTL]
// (f32).  Row strides are odd multiples of 16 bytes, so the 8 rows of 16
// bytes an `ldmatrix` reads fall on 32 different banks; every array starts
// 16-byte aligned.
template <int HP, int NS>
struct TcLayout {
  static constexpr int NSK = NS < 16 ? 16 : NS;  // K of C B^T and C h^T
  static constexpr int CS = NSK + 8;
  static constexpr int XS = 24;
  static constexpr int WS = kTL + 8;
  static constexpr int kTileBC = kTL * CS * 2;
  static constexpr int kTileX = kTL * XS * 2;
  static constexpr int kStage = 2 * kTileBC + kTileX + kTL * 4;
  static constexpr int kH = 16 * CS * 2;
  static constexpr int kW = 16 * WS * 2;
  static constexpr int kM = kTL * WS * 2;
  static constexpr int kBytes =
      2 * kStage + 2 * kH + 2 * kW + 2 * kM + kTL * 4;
  static_assert(HP == 8 || HP == 16, "HP is one or two 8-column tiles");
  static_assert(kStage % 16 == 0 && kH % 16 == 0 && kW % 16 == 0 &&
                    kM % 16 == 0 && kBytes % 16 == 0,
                "16-byte aligned arrays");
};

constexpr int kTcThreads = 512;  // 8 warps for y, 8 for the state

// Warp w < 8 computes rows 16 * kRowTile[w] .. + 15 and columns 8 * (w & 1)
// .. + 7 of a chunk's y; warps w and w + 4 share an SM sub-partition, so the
// causal row tiles 0 and 3 (1 and 2) pair up.
__constant__ int kRowTile[8] = {0, 0, 1, 1, 3, 3, 2, 2};
// The ten 16 x 16 blocks (row tile, column tile) of a chunk's causal M, one
// per warp: warps 8 .. 15 take blocks 0 .. 7, warps 0 and 1 (row tile 0, the
// least work for y) blocks 8 and 9.
__constant__ int kBlockRow[10] = {3, 3, 3, 3, 2, 2, 2, 1, 1, 0};
__constant__ int kBlockCol[10] = {0, 1, 2, 3, 0, 1, 2, 0, 1, 0};

// seg at row r of the chunk, from the warp's scan (lane l holds rows l and
// l + 32); every lane of the warp must call it.
__device__ __forceinline__ float seg_at(float v0, float v1, int r) {
  const float lo = __shfl_sync(0xffffffffu, v0, r & 31);
  const float hi = __shfl_sync(0xffffffffu, v1, r & 31);
  return r < 32 ? lo : hi;
}

template <int HP, int NS>
__global__ void __launch_bounds__(kTcThreads)
ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ state, int S, int nh, int hd,
                    int vec) {
  using Lay = TcLayout<HP, NS>;
  constexpr int CS = Lay::CS, XS = Lay::XS, WS = Lay::WS;
  constexpr int NT = NS / 8;          // 8-column tiles of the state
  constexpr int NTW = (NT + 7) / 8;   // ... held by each state warp
  constexpr int KS = Lay::NSK / 16;   // k-steps over the state dim
  constexpr int KH = KS < 4 ? KS : 4; // ... of C h^T loaded together
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* sH = reinterpret_cast<bf16*>(tsm + 2 * Lay::kStage);  // hi, lo
  bf16* sW = sH + 2 * 16 * CS;                                  // hi, lo
  bf16* sM = sW + 2 * 16 * WS;                                  // hi, lo
  float* sE = reinterpret_cast<float*>(sM + 2 * kTL * WS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int p0 = blockIdx.x * HP, head = blockIdx.y, b = blockIdx.z;
  const float a = A[head], d = D[head];
  const size_t h_base = ((size_t(b) * nh + head) * hd + p0) * NS;
  const int u = warp - 8;  // state warps: columns 8 (u + 8 k) .. + 7
  const int n_chunks = (S + kTL - 1) / kTL;

  auto stage_c = [&](int st) {
    return reinterpret_cast<bf16*>(tsm + st * Lay::kStage);
  };

  // Padding that the products read must be zero: columns 8 .. 15 of B, C
  // and h where ns = 8, rows 8 .. 15 of w x where HP = 8.  Zero every tile
  // once; every other element a product reads is written for each chunk.
  if (NS == 8 || HP == 8) {
    for (int i = tid; i < Lay::kBytes / 16; i += kTcThreads)
      reinterpret_cast<uint4*>(tsm)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // Rows c0 .. c0 + 63 of B, C, x and dt into stage st; rows past S as 0.
  auto load_chunk = [&](int c0, int st) {
    const int Lc = min(kTL, S - c0);
    bf16* sC = stage_c(st);
    bf16* sB = sC + kTL * CS;
    bf16* sX = sB + kTL * CS;
    float* sDt = reinterpret_cast<float*>(sX + kTL * XS);
    const size_t row0 = size_t(b) * S + c0;
    if (vec) {
      constexpr int PR = NS / 8, PX = HP / 8;  // 16-byte pieces per row
      for (int e = tid; e < kTL * PR; e += kTcThreads) {
        const int r = e / PR, q = e % PR;
        const bool ok = r < Lc;
        const size_t gi = (row0 + (ok ? r : 0)) * NS + q * 8;
        cp_async16(smem_u32(sB + r * CS + q * 8), Bm + gi, ok);
        cp_async16(smem_u32(sC + r * CS + q * 8), Cm + gi, ok);
      }
      for (int e = tid; e < kTL * PX; e += kTcThreads) {
        const int r = e / PX, q = e % PX;
        const bool ok = r < Lc;
        const size_t gi =
            ((row0 + (ok ? r : 0)) * nh + head) * hd + p0 + q * 8;
        cp_async16(smem_u32(sX + r * XS + q * 8), x + gi, ok);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int e = tid; e < kTL * NS; e += kTcThreads) {
        const int r = e / NS, s = e % NS;
        const bool ok = r < Lc;
        sB[r * CS + s] = ok ? Bm[(row0 + r) * NS + s] : zero;
        sC[r * CS + s] = ok ? Cm[(row0 + r) * NS + s] : zero;
      }
      for (int e = tid; e < kTL * HP; e += kTcThreads) {
        const int r = e / HP, p = e % HP;
        sX[r * XS + p] =
            r < Lc ? x[((row0 + r) * nh + head) * hd + p0 + p] : zero;
      }
    }
    for (int r = tid; r < kTL; r += kTcThreads) {
      const bool ok = r < Lc;
      cp_async4(smem_u32(sDt + r), dt + (row0 + (ok ? r : 0)) * nh + head,
                ok);
    }
    cp_async_commit();
  };

  load_chunk(0, 0);
  // The state, in the accumulator layout of the state update (read while
  // the first chunk loads): state warp u holds columns 8 nt .. 8 nt + 7
  // (nt = u + 8 k) of rows g and g + 8.
  float hacc[NTW][4];
#pragma unroll
  for (int k = 0; k < NTW; ++k) {
    const int nt = u + 8 * k;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = g + 8 * (e >> 1), s = nt * 8 + 2 * t4 + (e & 1);
      hacc[k][e] =
          (u >= 0 && nt < NT && p < HP && h0) ? h0[h_base + p * NS + s] : 0.f;
    }
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kTL, st = c & 1, Lc = min(kTL, S - c0);
    const int row_tiles = (Lc + 15) / 16;  // tiles past them are all zero
    cp_async_wait_all();
    // this chunk's tiles are in; every warp is done with the last chunk
    __syncthreads();
    // the next chunk's tiles load while this one is computed
    if (c + 1 < n_chunks) load_chunk(c0 + kTL, st ^ 1);
    const bf16* sC = stage_c(st);
    const bf16* sB = sC + kTL * CS;
    const bf16* sX = sB + kTL * CS;
    const float* sDt = reinterpret_cast<const float*>(sX + kTL * XS);

    // One 16 x 16 block of M per warp (blocks of row tiles past the chunk's
    // last row are skipped: y reads none of them).  First G = C B^T on the
    // exact bf16 operands, the fragments of KH k-steps loaded before their
    // products and the two k-step parities in separate accumulators, so
    // that the scan below runs while the products are in flight ...
    const int bi = u >= 0 ? u : (warp < 2 ? 8 + warp : -1);
    const int bm = bi >= 0 ? kBlockRow[bi] : 0;
    const int bk = bi >= 0 ? kBlockCol[bi] : 0;
    const bool has_block = bi >= 0 && bm < row_tiles;
    float gacc[4][4];
    if (has_block) {
      const bf16* crow = sC + (bm * 16 + (lane & 15)) * CS + (lane >> 4) * 8;
      const bf16* brow = sB + (bk * 16 + (lane >> 4) * 8 + (lane & 7)) * CS +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[r][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < KS; k0 += KH) {
        uint32_t ca[KH][4], bb[KH][4];
#pragma unroll
        for (int kk = 0; kk < KH; ++kk) {
          ldsm_x4(ca[kk], crow + (k0 + kk) * 16);
          ldsm_x4(bb[kk], brow + (k0 + kk) * 16);
        }
#pragma unroll
        for (int kk = 0; kk < KH; ++kk) {
          mma_bf16(gacc[2 * (kk & 1)], ca[kk], bb[kk][0], bb[kk][1]);
          mma_bf16(gacc[2 * (kk & 1) + 1], ca[kk], bb[kk][2], bb[kk][3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gacc[0][e] += gacc[2][e];
        gacc[1][e] += gacc[3][e];
      }
    }

    // Each warp scans dt * A over the chunk (lane: rows lane, lane + 32).
    // Rows past S have dt = 0, so the total is seg at the last real row.
    const float dt0 = sDt[lane], dt1 = sDt[lane + 32];
    float v0 = dt0 * a, v1 = dt1 * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n0 = __shfl_up_sync(0xffffffffu, v0, o);
      const float n1 = __shfl_up_sync(0xffffffffu, v1, o);
      if (lane >= o) {
        v0 += n0;
        v1 += n1;
      }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    const float total = __shfl_sync(0xffffffffu, v1, 31);
    if (warp == 0) {
      sE[lane] = expf(v0);
      sE[lane + 32] = expf(v1);
    }
    // w_j x_j[p], split, as rows [p][j] (the A operand of the update)
    if (warp < HP) {
      const int p = warp;
      const float w0 = expf(total - v0) * dt0, w1 = expf(total - v1) * dt1;
      const float wx0 = w0 * __bfloat162float(sX[lane * XS + p]);
      const float wx1 = w1 * __bfloat162float(sX[(lane + 32) * XS + p]);
      const bf16 hi0 = __float2bfloat16(wx0), hi1 = __float2bfloat16(wx1);
      sW[p * WS + lane] = hi0;
      sW[p * WS + lane + 32] = hi1;
      sW[16 * WS + p * WS + lane] =
          __float2bfloat16(wx0 - __bfloat162float(hi0));
      sW[16 * WS + p * WS + lane + 32] =
          __float2bfloat16(wx1 - __bfloat162float(hi1));
    }
    if (u >= 0) {
      // h before this chunk, split, as rows [p][s] (the B operand of C h^T)
#pragma unroll
      for (int k = 0; k < NTW; ++k) {
        const int nt = u + 8 * k;
        if (nt < NT) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = g + 8 * half;
            if (p < HP) {
              uint32_t hi, lo;
              split2(hacc[k][2 * half], hacc[k][2 * half + 1], hi, lo);
              const int o = p * CS + nt * 8 + 2 * t4;
              *reinterpret_cast<uint32_t*>(sH + o) = hi;
              *reinterpret_cast<uint32_t*>(sH + 16 * CS + o) = lo;
            }
          }
        }
      }
    }

    // ... then M = G o exp(seg_i - seg_j) o dt_j (j <= i) from the scan,
    // split into hi and lo rows of shared memory
    if (has_block) {
      const int i0 = bm * 16 + g, i1 = i0 + 8;
      const float si0 = seg_at(v0, v1, i0), si1 = seg_at(v0, v1, i1);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = bk * 16 + h2 * 8 + 2 * t4;
        const float sj0 = seg_at(v0, v1, j), sj1 = seg_at(v0, v1, j + 1);
        const float dj0 = sDt[j], dj1 = sDt[j + 1];
        const float* G = gacc[h2];
        const float m0 = j <= i0 ? G[0] * __expf(si0 - sj0) * dj0 : 0.f;
        const float m1 = j + 1 <= i0 ? G[1] * __expf(si0 - sj1) * dj1 : 0.f;
        const float m2 = j <= i1 ? G[2] * __expf(si1 - sj0) * dj0 : 0.f;
        const float m3 = j + 1 <= i1 ? G[3] * __expf(si1 - sj1) * dj1 : 0.f;
        uint32_t hi, lo;
        split2(m0, m1, hi, lo);
        *reinterpret_cast<uint32_t*>(sM + i0 * WS + j) = hi;
        *reinterpret_cast<uint32_t*>(sM + kTL * WS + i0 * WS + j) = lo;
        split2(m2, m3, hi, lo);
        *reinterpret_cast<uint32_t*>(sM + i1 * WS + j) = hi;
        *reinterpret_cast<uint32_t*>(sM + kTL * WS + i1 * WS + j) = lo;
      }
    }
    __syncthreads();  // M, exp(seg), h and w x are in shared memory

    if (u < 0) {
      // y = M x + exp(seg) C h^T + D x for 16 rows and 8 columns; M and h
      // as hi + lo, each term in an accumulator of its own so that the
      // products do not wait on each other
      const int mi = kRowTile[warp], pt = warp & 1;
      if (mi < row_tiles && pt * 8 < HP) {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
#pragma unroll
        for (int kj = 0; kj < 4; ++kj) {
          if (kj <= mi) {
            uint32_t mh[4], ml[4], x0, x1;
            const bf16* mrow =
                sM + (mi * 16 + (lane & 15)) * WS + kj * 16 + (lane >> 4) * 8;
            ldsm_x4(mh, mrow);
            ldsm_x4(ml, mrow + kTL * WS);
            ldsm_x2_t(x0, x1, sX + (kj * 16 + (lane & 15)) * XS + pt * 8);
            mma_bf16(acc[0], mh, x0, x1);
            mma_bf16(acc[1], ml, x0, x1);
          }
        }
        const bf16* crow =
            sC + (mi * 16 + (lane & 15)) * CS + (lane >> 4) * 8;
        // hi and lo of one k-step per ldmatrix
        const bf16* hrow = sH + (lane >> 4) * 16 * CS +
                           (pt * 8 + (lane & 7)) * CS + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int k0 = 0; k0 < KS; k0 += KH) {
          uint32_t cf[KH][4], hf[KH][4];
#pragma unroll
          for (int kk = 0; kk < KH; ++kk) {
            ldsm_x4(cf[kk], crow + (k0 + kk) * 16);
            ldsm_x4(hf[kk], hrow + (k0 + kk) * 16);
          }
#pragma unroll
          for (int kk = 0; kk < KH; ++kk) {
            mma_bf16(acc[2], cf[kk], hf[kk][0], hf[kk][1]);
            mma_bf16(acc[3], cf[kk], hf[kk][2], hf[kk][3]);
          }
        }
        const int i0 = mi * 16 + g, i1 = i0 + 8, p = pt * 8 + 2 * t4;
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1;
          const float intra = acc[0][e] + acc[1][e];
          const float inter = acc[2][e] + acc[3][e];
          out[e] = intra + sE[i] * inter +
                   d * __bfloat162float(sX[i * XS + p + (e & 1)]);
        }
        if (i0 < Lc)
          *reinterpret_cast<float2*>(
              y + ((size_t(b) * S + c0 + i0) * nh + head) * hd + p0 + p) =
              make_float2(out[0], out[1]);
        if (i1 < Lc)
          *reinterpret_cast<float2*>(
              y + ((size_t(b) * S + c0 + i1) * nh + head) * hd + p0 + p) =
              make_float2(out[2], out[3]);
      }
    } else {
      // h <- exp(total) h + (w x)^T B, w x as hi + lo (the lo products in
      // an accumulator of their own, added last); all fragments load first
      // (at HP = 8 in two halves of the chunk's row tiles, which keeps the
      // body within its registers)
      constexpr int KJ = HP == 8 ? 2 : 4;
      const float decay = expf(total);
      float hlo[NTW][4];
#pragma unroll
      for (int k = 0; k < NTW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hacc[k][e] *= decay;
          hlo[k][e] = 0.f;
        }
#pragma unroll
      for (int j0 = 0; j0 < 4; j0 += KJ) {
        uint32_t wf[KJ][2][4], bt[KJ][NTW][2];
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          const int kj = j0 + jj;
          if (kj < row_tiles) {
            const int o = (lane & 15) * WS + kj * 16 + (lane >> 4) * 8;
            ldsm_x4(wf[jj][0], sW + o);
            ldsm_x4(wf[jj][1], sW + 16 * WS + o);
#pragma unroll
            for (int k = 0; k < NTW; ++k)
              if (u + 8 * k < NT)
                ldsm_x2_t(bt[jj][k][0], bt[jj][k][1],
                          sB + (kj * 16 + (lane & 15)) * CS + (u + 8 * k) * 8);
          }
        }
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) {
          if (j0 + jj < row_tiles) {
#pragma unroll
            for (int k = 0; k < NTW; ++k) {
              if (u + 8 * k < NT) {
                mma_bf16(hacc[k], wf[jj][0], bt[jj][k][0], bt[jj][k][1]);
                mma_bf16(hlo[k], wf[jj][1], bt[jj][k][0], bt[jj][k][1]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < NTW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[k][e] += hlo[k][e];
    }
  }

  if (u >= 0) {
#pragma unroll
    for (int k = 0; k < NTW; ++k) {
      const int nt = u + 8 * k;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = g + 8 * (e >> 1), s = nt * 8 + 2 * t4 + (e & 1);
        if (nt < NT && p < HP) state[h_base + p * NS + s] = hacc[k][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int HP, int NS>
cudaError_t launch(int dtype, const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* h0, void* y, void* state, int B, int S,
                   int nh, int hd, cudaStream_t stream) {
  const dim3 grid(hd / HP, nh, B);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  if (dtype == 0) {
    constexpr size_t smem = f32_smem_bytes<HP, NS>();
    auto kernel = ssd_scan_f32_kernel<HP, NS>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), dtf, Af, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), Df, h0f, yf, sf, S, nh, hd);
  } else {
    constexpr size_t smem = TcLayout<HP, NS>::kBytes;
    auto kernel = ssd_scan_mma_kernel<HP, NS>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    // 16-byte copies need 16-byte aligned rows: hd and ns are multiples of
    // 8, so the base pointers decide
    const int vec = ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(Bm) |
                      reinterpret_cast<uintptr_t>(Cm)) &
                     15) == 0;
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(x), dtf, Af, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), Df, h0f, yf, sf, S, nh, hd, vec);
  }
  return cudaGetLastError();
}

template <int HP>
cudaError_t dispatch_ns(int ns, int dtype, const void* x, const void* dt,
                        const void* A, const void* Bm, const void* Cm,
                        const void* D, const void* h0, void* y, void* state,
                        int B, int S, int nh, int hd, cudaStream_t s) {
  switch (ns) {
    case 8:
      return launch<HP, 8>(dtype, x, dt, A, Bm, Cm, D, h0, y, state, B, S,
                           nh, hd, s);
    case 16:
      return launch<HP, 16>(dtype, x, dt, A, Bm, Cm, D, h0, y, state, B, S,
                            nh, hd, s);
    case 32:
      return launch<HP, 32>(dtype, x, dt, A, Bm, Cm, D, h0, y, state, B, S,
                            nh, hd, s);
    case 128:
      return launch<HP, 128>(dtype, x, dt, A, Bm, Cm, D, h0, y, state, B, S,
                             nh, hd, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, Bm, Cm: dtype 0 = float32 (the CUDA-core body), 1 = bfloat16 (the
// tensor-core body); dt, A, D, h0, y, state are float32.  h0 may be null
// (zero initial state).  Returns the cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* h0, void* y, void* state, int B,
                               int S, int nh, int hd, int ns, int dtype,
                               void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || B > 65535 || nh > 65535 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8:
      return int(dispatch_ns<8>(ns, dtype, x, dt, A, Bm, Cm, D, h0, y, state,
                                B, S, nh, hd, s));
    case 16:
    case 32:
    case 64:
      return int(dispatch_ns<16>(ns, dtype, x, dt, A, Bm, Cm, D, h0, y,
                                 state, B, S, nh, hd, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
