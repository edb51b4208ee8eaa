// Mamba-2 SSD chunked scan, backward — B7's gradient.
//
// Replaces: the reference differentiates its SSD (src/repro/kernels/
// ops.py `ssd`, the Pallas `_ssd_kernel` of kernels/ssd_scan.py, or
// ref.py `ssd_ref`) with JAX's autodiff; no TPU kernel of its own. This is
// the gradient of the chunked form that ssd_scan.cu runs, read from the
// forward's scratch: each chunk's incoming state h_c (B, H, nc, N, P) and
// cl = cumsum(log a) within each chunk (B, H, S), both f32.
//
// With g_c the gradient of the state chunk c leaves (g_{nc-1} = dh_final,
// zero when unused), w = exp(cl_{T-1} - cl), L[t,s] = exp(cl_t - cl_s) for
// s <= t (else 0), M1 = L ⊙ C Bᵀ and M2 = L ⊙ dY Xᵀ:
//   (1) dstate    D_c  = Σ_t exp(cl_t) c_t ⊗ dy_t                  (N, P)
//   (2) reverse   g_{c-1} = exp(cl_{T-1}) g_c + D_c, chunks in reverse
//   (3) by step s dX = M1ᵀ dY + diag(w) B g_c,
//                 dB = M2ᵀ C + diag(w) X g_cᵀ,
//                 and per s: colsum_s(M1 ⊙ dY Xᵀ), r_s = w_s b_s·(g_c x_s)
//   (4) by step t dC = M2 B + diag(exp(cl)) dY h_cᵀ, and per t:
//                 rowsum_t(M1 ⊙ dY Xᵀ) + exp(cl_t) c_t·(h_c dy_t)
//   (5) dcl       dcl_t = (4)_t - colsum_t - r_t, plus at t = T-1
//                 Σ_s r_s + exp(cl_{T-1}) <g_c, h_c>; d log a is its
//                 reverse cumulative sum within the chunk, da = d log a / a.
// L's exponent is taken only on and below the diagonal, as in the forward:
// with Mamba-2's decays a chunk's summed -log a passes f32's overflow.
//
// What bounds it on the H100: bytes. At mamba2-370m's training shape (B 4,
// S 1,024, H 32, P 64, N 128, chunk 128) the function reads x, dy, b, c,
// a and the scratch and writes dx, db, dc (full over H) and da: ~0.35 GB,
// 0.1 ms at 3.35 TB/s; the recurrence's backward takes 15 GFLOP (0.09 ms
// at the f32-accurate tensor-core rate).
//
// What the design does about it: this is a first, simple kernel. Each step
// runs one block per (chunk, head, batch) or per 32-step slab of a chunk,
// and every product is f32 FMAs from shared memory with small register
// tiles (each thread 2 x 2 to 8 x 4 outputs; a half warp reads 16
// consecutive rows or columns, free of bank conflicts); steps (3) and (4)
// each recompute the 32 x 32 tiles of C Bᵀ and dY Xᵀ they need. The tensor
// cores are left for a later redesign. The g_c of step (2) overwrite D_c
// in place. Deterministic: no atomics, every sum in a fixed order.
#include "tf32x3.cuh"

namespace {

using meili::load1;
using meili::load4;

constexpr int kT = 128;         // chunk, at most
constexpr int kN = 128;         // state, at most (tiles are sized for it)
constexpr int kP = 64;          // head dim, at most
constexpr int kR = 32;          // steps of a slab or a streamed tile
constexpr int kThreads = 256;   // 16 x 16 threads (ty, tx)
constexpr int LN = kN + 4;      // row strides of the staged tiles
constexpr int LP = kP + 4;
constexpr int LR = kR + 4;
constexpr int kMaxDynamicSmem = 232448;
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ void store1(void* base, int bf16, int64_t idx,
                                       float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[idx] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[idx] = x;
}

// rows x cols of a strided array (row r at base + r·rstride, f32 or bf16)
// into shared memory as f32 rows of stride ld, zero-filled to
// rows_p x COLS: 4 values a load where every row's start is aligned to 4
// values (16 bytes in f32, 8 in bf16), else one.
template <int COLS>
__device__ __forceinline__ void stage(float* dst, int ld, const void* src,
                                      int bf16, int64_t base,
                                      int64_t rstride, int rows, int cols,
                                      int rows_p) {
  const bool vec = cols % 4 == 0 && rstride % 4 == 0 && base % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    for (int i = threadIdx.x; i < rows_p * COLS / 4; i += blockDim.x) {
      const int r = i / (COLS / 4), col = i % (COLS / 4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && col < cols)
        v = load4(src, bf16, base + static_cast<int64_t>(r) * rstride + col);
      *reinterpret_cast<float4*>(dst + r * ld + col) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < rows_p * COLS; i += blockDim.x) {
    const int r = i / COLS, col = i % COLS;
    dst[r * ld + col] =
        (r < rows && col < cols)
            ? load1(src, bf16, base + static_cast<int64_t>(r) * rstride + col)
            : 0.f;
  }
}

template <int R>
__device__ __forceinline__ void ldv(float (&v)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      v[i] = t.x; v[i + 1] = t.y;
    }
  }
}

// acc[i][j] += Σ_k A[i·lda + k] B[j·ldb + k]   (rows of A and B along k)
template <int RM, int RN>
__device__ __forceinline__ void mm_dot(float (&acc)[RM][RN], const float* A,
                                       int lda, const float* B, int ldb,
                                       int K) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + i * lda + k);
#pragma unroll
    for (int j = 0; j < RN; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + j * ldb + k);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][j] += Σ_k A[k·lda + i] B[k·ldb + CS·j]   (columns of A and B
// along k; B's CS apart, or consecutive)
template <int RM, int RN, int CS = 1>
__device__ __forceinline__ void mm_outer(float (&acc)[RM][RN],
                                         const float* A, int lda,
                                         const float* B, int ldb, int K) {
  constexpr int kUnroll = RM * RN >= 32 ? 1 : 32 / (RM * RN);
#pragma unroll kUnroll
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
    ldv(a, A + k * lda);
    if constexpr (CS == 1) {
      ldv(b, B + k * ldb);
    } else {
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = B[k * ldb + CS * j];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += Σ_k A[i·lda + k] B[k·ldb + j]   (rows of A, columns of B)
template <int RM, int RN>
__device__ __forceinline__ void mm_mixed(float (&acc)[RM][RN],
                                         const float* A, int lda,
                                         const float* B, int ldb, int K) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[RN];
      ldv(b, B + (k + kk) * ldb);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

// Sum of v over the 16 threads of a half warp (tx = 0 .. 15).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Geom {
  int S, H, P, N, T, nc;
};

// (1) One block per (chunk, head, batch): D_c = Σ_t exp(cl_t) c_t ⊗ dy_t
// into g (B, H, nc, N, P), the chunk streamed in tiles of kR steps. Thread
// (ty, tx) owns n = 8ty .. 8ty + 7, p = 4tx .. 4tx + 3.
constexpr size_t dstate_smem_floats() {
  return static_cast<size_t>(kR) * LN + kR * LP;
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_dstate(const void* __restrict__ dy, const void* __restrict__ cmat,
                   const float* __restrict__ cl, float* __restrict__ g,
                   Geom gm, int64_t c_sb, int64_t c_ss, int64_t c_sh,
                   int y_bf16, int c_bf16) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;
  float* dyt = ct + kR * LN;
  const int ic = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bh = static_cast<int64_t>(bi) * gm.H + hi;
  const int64_t row0 = static_cast<int64_t>(bi) * gm.S + ic * gm.T;
  float acc[8][4] = {};
  for (int t0 = 0; t0 < gm.T; t0 += kR) {
    const int rows = min(kR, gm.T - t0);
    __syncthreads();
    stage<kN>(ct, LN, cmat, c_bf16,
              bi * c_sb + static_cast<int64_t>(ic * gm.T + t0) * c_ss +
                  hi * c_sh,
              c_ss, rows, gm.N, kR);
    stage<kP>(dyt, LP, dy, y_bf16,
              ((row0 + t0) * gm.H + hi) * gm.P,
              static_cast<int64_t>(gm.H) * gm.P, rows, gm.P, kR);
    __syncthreads();
    for (int i = tid; i < rows * kN; i += kThreads) {
      const int r = i / kN;
      ct[r * LN + i % kN] *= expf(cl[bh * gm.S + ic * gm.T + t0 + r]);
    }
    __syncthreads();
    mm_outer(acc, ct + 8 * ty, LN, dyt + 4 * tx, LP, kR);
  }
  float* out = g + (bh * gm.nc + ic) * gm.N * gm.P;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * ty + i, p = 4 * tx + j;
      if (n < gm.N && p < gm.P) out[n * gm.P + p] = acc[i][j];
    }
}

// (2) Elementwise over (b, h, n, p), the chunks in reverse: g[c] holds D_c
// on entry and g_c on exit. A thread loads kBatch chunks' D_c before it
// writes any, so their DRAM latencies overlap.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reverse(float* __restrict__ g, const float* __restrict__ dh,
                    const float* __restrict__ cl, int64_t BH, int nc, int NP,
                    int S, int T) {
  constexpr int kBatch = 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= BH * NP) return;
  const int64_t bh = i / NP;
  const int64_t e = i % NP;
  float* base = g + bh * nc * NP + e;
  const float* last = cl + bh * S + T - 1;   // chunk ic's total at ic·T
  float acc = dh != nullptr ? dh[bh * NP + e] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kBatch) {
    float d[kBatch], dec[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 - k >= 0) {
        d[k] = base[static_cast<int64_t>(c0 - k) * NP];
        dec[k] = expf(last[static_cast<int64_t>(c0 - k) * T]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 - k >= 0) {
        base[static_cast<int64_t>(c0 - k) * NP] = acc;
        acc = dec[k] * acc + d[k];
      }
    }
  }
}

// (3) One block per (chunk, head, batch, slab of kR steps s): dX and dB of
// the slab's steps, and per step the column sum of M1 ⊙ dY Xᵀ and r_s. The
// slab's B and X rows and g_c stay in shared memory; C and dY stream in
// tiles of kR steps t (those with t >= the slab's first s). For each tile
// the block computes C Bᵀ and dY Xᵀ (thread: t = ty + 16i, s = tx + 16j),
// masks and decays them into M1 and M2 (stored [t][s]), then accumulates
// dX (thread: s = 2ty + i, p = 4tx + j) and dB (n = tx + 16j). A half
// warp reads 16 consecutive rows or columns, free of bank conflicts.
constexpr size_t cols_smem_floats() {
  return 2 * (static_cast<size_t>(kR) * LN + kR * LP) + 2 * kR * LR +
         static_cast<size_t>(kN) * LP + kT + 16 * kR;
}

__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_cols(const void* __restrict__ x, const void* __restrict__ b,
                 const void* __restrict__ cmat, const void* __restrict__ dy,
                 const float* __restrict__ g, const float* __restrict__ cl,
                 void* __restrict__ dx, void* __restrict__ db,
                 float* __restrict__ colq, float* __restrict__ rvec, Geom gm,
                 int64_t c_sb, int64_t c_ss, int64_t c_sh, int x_bf16,
                 int b_bf16, int c_bf16) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                 // [kR][LN] the slab's b
  float* xs = bs + kR * LN;         // [kR][LP] the slab's x
  float* ct = xs + kR * LP;         // [kR][LN] a tile's c
  float* dyt = ct + kR * LN;        // [kR][LP] a tile's dy
  float* m1 = dyt + kR * LP;        // [kR][LR] M1 of the tile, [t][s]
  float* m2 = m1 + kR * LR;         // [kR][LR] M2
  float* gs = m2 + kR * LR;         // [kN][LP] g_c
  float* clv = gs + kN * LP;        // [kT]
  float* red = clv + kT;            // [16][kR] column sums by ty
  const int nslab = (gm.T + kR - 1) / kR;
  const int ic = blockIdx.x / nslab, sl = blockIdx.x % nslab;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int s0 = sl * kR;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bh = static_cast<int64_t>(bi) * gm.H + hi;
  const int64_t row0 = static_cast<int64_t>(bi) * gm.S + ic * gm.T;
  const int64_t hn = static_cast<int64_t>(gm.H) * gm.N;
  const int64_t hp = static_cast<int64_t>(gm.H) * gm.P;
  const int srows = min(kR, gm.T - s0);

  stage<kN>(bs, LN, b, b_bf16, ((row0 + s0) * gm.H + hi) * gm.N, hn, srows,
            gm.N, kR);
  stage<kP>(xs, LP, x, x_bf16, ((row0 + s0) * gm.H + hi) * gm.P, hp, srows,
            gm.P, kR);
  stage<kP>(gs, LP, g, 0, (bh * gm.nc + ic) * gm.N * gm.P, gm.P, gm.N, gm.P,
            kN);
  for (int t = tid; t < kT; t += kThreads)
    clv[t] = t < gm.T ? cl[bh * gm.S + ic * gm.T + t] : 0.f;

  float adx[2][4] = {}, adb[2][8] = {}, aq[2] = {};
  for (int tt = sl; tt < nslab; ++tt) {
    const int t0 = tt * kR;
    const int trows = min(kR, gm.T - t0);
    __syncthreads();              // the last tile's reads are done
    stage<kN>(ct, LN, cmat, c_bf16,
              bi * c_sb + static_cast<int64_t>(ic * gm.T + t0) * c_ss +
                  hi * c_sh,
              c_ss, trows, gm.N, kR);
    stage<kP>(dyt, LP, dy, x_bf16, ((row0 + t0) * gm.H + hi) * gm.P, hp,
              trows, gm.P, kR);
    __syncthreads();
    float cb[2][2] = {}, dm[2][2] = {};
    mm_dot(cb, ct + ty * LN, 16 * LN, bs + tx * LN, 16 * LN, kN);
    mm_dot(dm, dyt + ty * LP, 16 * LP, xs + tx * LP, 16 * LP, kP);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = t0 + ty + 16 * i, s = s0 + tx + 16 * j;
        const float L =
            (s <= t && t < gm.T) ? expf(clv[t] - clv[s]) : 0.f;
        const float v1 = L * cb[i][j];
        m1[(ty + 16 * i) * LR + tx + 16 * j] = v1;
        m2[(ty + 16 * i) * LR + tx + 16 * j] = L * dm[i][j];
        aq[j] = fmaf(v1, dm[i][j], aq[j]);
      }
    __syncthreads();
    mm_outer(adx, m1 + 2 * ty, LR, dyt + 4 * tx, LP, kR);
    mm_outer<2, 8, 16>(adb, m2 + 2 * ty, LR, ct + tx, LN, kR);
  }
  // the state terms: dX += diag(w) B g_c, dB += diag(w) X g_cᵀ
  float sdx[2][4] = {}, sdb[2][8] = {};
  mm_mixed(sdx, bs + 2 * ty * LN, LN, gs + 4 * tx, LP, kN);
  mm_dot(sdb, xs + 2 * ty * LP, LP, gs + tx * LP, 16 * LP, kP);
  const float cl_last = clv[gm.T - 1];
  float r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + 2 * ty + i;
    const float w = s < gm.T ? expf(cl_last - clv[s]) : 0.f;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      part = fmaf(bs[(2 * ty + i) * LN + tx + 16 * j], sdb[i][j], part);
    r[i] = w * sum16(part);
#pragma unroll
    for (int j = 0; j < 4; ++j) adx[i][j] = fmaf(w, sdx[i][j], adx[i][j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) adb[i][j] = fmaf(w, sdb[i][j], adb[i][j]);
  }
  red[ty * kR + tx] = aq[0];
  red[ty * kR + tx + 16] = aq[1];
  __syncthreads();
  const int64_t vrow = bh * gm.S + ic * gm.T + s0;
  if (tid < srows) {
    float q = 0.f;
    for (int k = 0; k < 16; ++k) q += red[k * kR + tid];
    colq[vrow + tid] = q;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = 2 * ty + i;
    if (s >= srows) continue;
    if (tx == 0) rvec[vrow + s] = r[i];
    const int64_t at = (row0 + s0 + s) * gm.H + hi;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * tx + j < gm.P) store1(dx, x_bf16, at * gm.P + 4 * tx + j,
                                    adx[i][j]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (tx + 16 * j < gm.N) store1(db, b_bf16, at * gm.N + tx + 16 * j,
                                     adb[i][j]);
  }
}

// (4) One block per (chunk, head, batch, slab of kR steps t): dC of the
// slab's steps (all H heads written, whatever c's strides), and per step
// the row sum of M1 ⊙ dY Xᵀ plus exp(cl_t) c_t·(h_c dy_t). The slab's C
// and dY rows and h_c stay in shared memory; B and X stream in tiles of kR
// steps s <= the slab's last t. Per tile the block computes Bᵀ C and Xᵀ dY
// (thread: s = ty + 16i, t = tx + 16j) into M2ᵀ (stored [s][t]) and the
// row sums, then accumulates dC (thread: t = 2ty + i, n = tx + 16j).
constexpr size_t rows_smem_floats() { return cols_smem_floats() - kR * LR; }

__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_rows(const void* __restrict__ x, const void* __restrict__ b,
                 const void* __restrict__ cmat, const void* __restrict__ dy,
                 const float* __restrict__ states,
                 const float* __restrict__ cl, void* __restrict__ dc,
                 float* __restrict__ rowq, Geom gm, int64_t c_sb,
                 int64_t c_ss, int64_t c_sh, int x_bf16, int b_bf16,
                 int c_bf16) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                 // [kR][LN] the slab's c
  float* dys = cs + kR * LN;        // [kR][LP] the slab's dy
  float* bt = dys + kR * LP;        // [kR][LN] a tile's b
  float* xt = bt + kR * LN;         // [kR][LP] a tile's x
  float* m2t = xt + kR * LP;        // [kR][LR] M2ᵀ of the tile, [s][t]
  float* hs = m2t + kR * LR;        // [kN][LP] h_c
  float* clv = hs + kN * LP;        // [kT]
  float* red = clv + kT;            // [16][kR] row sums by ty
  const int nslab = (gm.T + kR - 1) / kR;
  const int ic = blockIdx.x / nslab, sl = blockIdx.x % nslab;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int t0 = sl * kR;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bh = static_cast<int64_t>(bi) * gm.H + hi;
  const int64_t row0 = static_cast<int64_t>(bi) * gm.S + ic * gm.T;
  const int64_t hn = static_cast<int64_t>(gm.H) * gm.N;
  const int64_t hp = static_cast<int64_t>(gm.H) * gm.P;
  const int trows = min(kR, gm.T - t0);

  stage<kN>(cs, LN, cmat, c_bf16,
            bi * c_sb + static_cast<int64_t>(ic * gm.T + t0) * c_ss +
                hi * c_sh,
            c_ss, trows, gm.N, kR);
  stage<kP>(dys, LP, dy, x_bf16, ((row0 + t0) * gm.H + hi) * gm.P, hp, trows,
            gm.P, kR);
  stage<kP>(hs, LP, states, 0, (bh * gm.nc + ic) * gm.N * gm.P, gm.P, gm.N,
            gm.P, kN);
  for (int t = tid; t < kT; t += kThreads)
    clv[t] = t < gm.T ? cl[bh * gm.S + ic * gm.T + t] : 0.f;

  float adc[2][8] = {}, aq[2] = {};
  for (int st = 0; st <= sl; ++st) {
    const int s0 = st * kR;
    const int srows = min(kR, gm.T - s0);
    __syncthreads();
    stage<kN>(bt, LN, b, b_bf16, ((row0 + s0) * gm.H + hi) * gm.N, hn, srows,
              gm.N, kR);
    stage<kP>(xt, LP, x, x_bf16, ((row0 + s0) * gm.H + hi) * gm.P, hp, srows,
              gm.P, kR);
    __syncthreads();
    float cb[2][2] = {}, dm[2][2] = {};
    mm_dot(cb, bt + ty * LN, 16 * LN, cs + tx * LN, 16 * LN, kN);
    mm_dot(dm, xt + ty * LP, 16 * LP, dys + tx * LP, 16 * LP, kP);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = s0 + ty + 16 * i, t = t0 + tx + 16 * j;
        const float L =
            (s <= t && t < gm.T) ? expf(clv[t] - clv[s]) : 0.f;
        const float v2 = L * dm[i][j];
        m2t[(ty + 16 * i) * LR + tx + 16 * j] = v2;
        aq[j] = fmaf(v2, cb[i][j], aq[j]);
      }
    __syncthreads();
    mm_outer<2, 8, 16>(adc, m2t + 2 * ty, LR, bt + tx, LN, kR);
  }
  // the state term: dC += diag(exp(cl)) dY h_cᵀ, and c_t · that
  float hd[2][8] = {};
  mm_dot(hd, dys + 2 * ty * LP, LP, hs + tx * LP, 16 * LP, kP);
  float e[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 2 * ty + i;
    const float ecl = t < gm.T ? expf(clv[t]) : 0.f;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      part = fmaf(cs[(2 * ty + i) * LN + tx + 16 * j], hd[i][j], part);
      adc[i][j] = fmaf(ecl, hd[i][j], adc[i][j]);
    }
    e[i] = ecl * sum16(part);
  }
  red[ty * kR + tx] = aq[0];
  red[ty * kR + tx + 16] = aq[1];
  __syncthreads();
  float* rq = m2t;                  // [kR], m2t is read no more
  if (tid < trows) {
    float q = 0.f;
    for (int k = 0; k < 16; ++k) q += red[k * kR + tid];
    rq[tid] = q;
  }
  __syncthreads();
  const int64_t vrow = bh * gm.S + ic * gm.T + t0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 2 * ty + i;
    if (t >= trows) continue;
    if (tx == 0) rowq[vrow + t] = rq[t] + e[i];
    const int64_t at = ((row0 + t0 + t) * gm.H + hi) * gm.N;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (tx + 16 * j < gm.N) store1(dc, c_bf16, at + tx + 16 * j,
                                     adc[i][j]);
  }
}

// (5) One block per (chunk, head, batch): <g_c, h_c>, then dcl and its
// reverse cumulative sum within the chunk, and da = d log a / a.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dcl(const float* __restrict__ a, const float* __restrict__ g,
                const float* __restrict__ states,
                const float* __restrict__ cl, const float* __restrict__ rowq,
                const float* __restrict__ colq,
                const float* __restrict__ rvec, float* __restrict__ da,
                Geom gm) {
  __shared__ float part[kThreads / 32];
  __shared__ float dcl[kT];
  const int ic = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t bh = static_cast<int64_t>(bi) * gm.H + hi;
  const int64_t off = (bh * gm.nc + ic) * gm.N * gm.P;
  float s = 0.f;
  for (int i = tid; i < gm.N * gm.P; i += kThreads)
    s = fmaf(g[off + i], states[off + i], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((tid & 31) == 0) part[tid >> 5] = s;
  const int64_t v0 = bh * gm.S + ic * gm.T;
  for (int t = tid; t < gm.T; t += kThreads)
    dcl[t] = rowq[v0 + t] - colq[v0 + t] - rvec[v0 + t];
  __syncthreads();
  if (tid == 0) {
    float gh = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) gh += part[w];
    float rsum = 0.f;
    for (int t = 0; t < gm.T; ++t) rsum += rvec[v0 + t];
    const float cl_last = cl[v0 + gm.T - 1];
    dcl[gm.T - 1] += rsum + expf(cl_last) * gh;
    float run = 0.f;
    for (int t = gm.T - 1; t >= 0; --t) {
      run += dcl[t];
      dcl[t] = run;
    }
  }
  __syncthreads();
  for (int t = tid; t < gm.T; t += kThreads) {
    const int64_t at =
        (static_cast<int64_t>(bi) * gm.S + ic * gm.T + t) * gm.H + hi;
    da[at] = dcl[t] / a[at];
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxDynamicSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > static_cast<size_t>(kStaticSmemLimit))
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
  return 0;
}

}  // namespace

// Runs (1)-(5) in order on `stream`. dy is in x's dtype (y's); dh may be
// null (zero). `g` (B, H, S / T, N, P) and `vec` (3, B, H, S) are f32
// scratch from the caller. dx, db, dc (B, S, H, N: every head, whatever
// c's strides) are written in the dtypes of x, b and c; da in f32. Returns
// the first CUDA error.
extern "C" int meili_ssd_scan_bwd(const void* x, const void* a, const void* b,
                                  const void* c, const void* dy,
                                  const void* dh, const void* states,
                                  const void* cl, void* dx, void* da,
                                  void* db, void* dc, void* g, void* vec,
                                  int B, int S, int H, int P, int N, int T,
                                  int64_t c_sb, int64_t c_ss, int64_t c_sh,
                                  int x_bf16, int b_bf16, int c_bf16,
                                  void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T <= 0 || T > kT || S % T != 0 || N <= 0 || N > kN || P <= 0 ||
      P > kP || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom gm{S, H, P, N, T, S / T};
  const int nslab = (T + kR - 1) / kR;
  const size_t smem1 = dstate_smem_floats() * sizeof(float);
  const size_t smem3 = cols_smem_floats() * sizeof(float);
  const size_t smem4 = rows_smem_floats() * sizeof(float);
  int err = set_smem((const void*)ssd_bwd_dstate, smem1);
  if (!err) err = set_smem((const void*)ssd_bwd_cols, smem3);
  if (!err) err = set_smem((const void*)ssd_bwd_rows, smem4);
  if (err) return err;
  float* gf = static_cast<float*>(g);
  const float* clf = static_cast<const float*>(cl);
  const float* stf = static_cast<const float*>(states);
  const int64_t vn = static_cast<int64_t>(B) * H * S;
  float* rowq = static_cast<float*>(vec);
  float* colq = rowq + vn;
  float* rvec = colq + vn;
  ssd_bwd_dstate<<<dim3(gm.nc, H, B), kThreads, smem1, st>>>(
      dy, c, clf, gf, gm, c_sb, c_ss, c_sh, x_bf16, c_bf16);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t BH = static_cast<int64_t>(B) * H;
  const int64_t n = BH * N * P;
  ssd_bwd_reverse<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>(gf, static_cast<const float*>(dh),
                                       clf, BH, gm.nc, N * P, S, T);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_cols<<<dim3(gm.nc * nslab, H, B), kThreads, smem3, st>>>(
      x, b, c, dy, gf, clf, dx, db, colq, rvec, gm, c_sb, c_ss, c_sh, x_bf16,
      b_bf16, c_bf16);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_rows<<<dim3(gm.nc * nslab, H, B), kThreads, smem4, st>>>(
      x, b, c, dy, stf, clf, dc, rowq, gm, c_sb, c_ss, c_sh, x_bf16, b_bf16,
      c_bf16);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_dcl<<<dim3(gm.nc, H, B), kThreads, 0, st>>>(
      static_cast<const float*>(a), gf, stf, clf, rowq, colq, rvec,
      static_cast<float*>(da), gm);
  return static_cast<int>(cudaGetLastError());
}
