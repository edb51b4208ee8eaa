// Mamba-2 SSD chunked scan — B7 of the port.
//
// Replaces: src/repro/kernels/ssd_scan.py `_ssd_kernel` / `ssd_scan`. The
// TPU kernel runs a (b·h, chunk) grid whose chunk axis is sequential, and
// carries the (N, P) state across it in VMEM scratch. Here one block owns a
// (b, h) pair and walks its chunks in a loop, with the state in shared
// memory, since blocks run in no order and carry nothing between them.
//
// Per chunk of T steps, with cl = cumsum(log a):
//   Y  = (C Bᵀ ⊙ L) X + diag(exp(cl)) C h,  L[t,s] = exp(cl_t - cl_s), s <= t
//   h' = exp(cl_{T-1}) h + (B ⊙ exp(cl_{T-1} - cl))ᵀ X
// L is zero above the diagonal and its exponent is taken only on and below
// it, where cl_t - cl_s <= 0. The Pallas body takes exp everywhere and
// masks afterwards; with Mamba-2's decays a chunk's summed -log a passes
// f32's overflow, and exp(inf) · 0 is NaN on this card.
//
// What bounds it on the H100: operations. At mamba2-370m's prefill shape
// (T 128, N 128, P 64) a (b, h, chunk) does ~7.4 MFLOP of f32 products on
// ~200 KB of inputs; the f32 peak of the CUDA cores is the bound.
//
// What the design does about it, simply: 256 threads per (b, h) block;
// each product is computed from shared memory by register tiles (4x4 for
// C Bᵀ, 4x2 for the row block of Y, 16x2 for the state update), so a
// shared-memory read feeds several FMAs, and warps read broadcast rows or
// consecutive columns (B rows padded by one float against bank
// conflicts). The chunk's X and B and the state stay in shared memory; C
// and the masked decay matrix are staged in 32-row blocks (whole f32 tiles
// would need ~256 KB, over the 227 KB a block may have), ~164 KB in all at
// the prefill shape. Column blocks of C Bᵀ past the row block's diagonal
// are skipped. x, b and c are f32 or bf16, widened on load; c is read
// through its strides, so a tensor broadcast over heads is never copied.
// wgmma, TMA and bf16 tensor-core operands are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBlock = 32;   // chunk rows per intra-chunk pass
constexpr int kMaxT = 128;      // chunk
constexpr int kMaxN = 128;      // state
constexpr int kMaxP = 64;       // head dim
constexpr int kMaxDynamicSmem = 232448;
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ float load1(const void* base, int bf16,
                                       int64_t idx) {
  if (bf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[idx]);
  return static_cast<const float*>(base)[idx];
}

__host__ __device__ inline size_t smem_floats(int T, int N, int P) {
  return static_cast<size_t>(N) * P + static_cast<size_t>(T) * P +
         static_cast<size_t>(T) * (N + 1) + kRowBlock * (N + 1) +
         kRowBlock * (T + 1) + 2 * T;
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const void* __restrict__ x, const float* __restrict__ a,
                    const void* __restrict__ b, const void* __restrict__ c,
                    void* __restrict__ y, float* __restrict__ h_out, int S,
                    int H, int P, int N, int T, int64_t c_sb, int64_t c_ss,
                    int64_t c_sh, int x_bf16, int b_bf16, int c_bf16) {
  extern __shared__ float smem[];
  const int NP = N + 1;           // padded B/C row
  const int TP = T + 1;           // padded decay-matrix row
  float* hs = smem;               // N x P   carried state
  float* xs = hs + N * P;         // T x P   chunk X
  float* bs = xs + T * P;         // T x NP  chunk B
  float* cs = bs + T * NP;        // 32 x NP row block of C
  float* ms = cs + kRowBlock * NP;  // 32 x TP row block of C Bᵀ ⊙ L
  float* cl = ms + kRowBlock * TP;  // T       cumsum(log a)
  float* wv = cl + T;             // T       exp(cl_{T-1} - cl)

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;      // 8 warps
  const int bh = blockIdx.x;
  const int bi = bh / H;
  const int hi = bh % H;
  const int nc = S / T;

  for (int i = tid; i < N * P; i += kThreads) hs[i] = 0.f;

  for (int ic = 0; ic < nc; ++ic) {
    const int s0 = ic * T;
    __syncthreads();              // the last chunk is done with xs, bs, cl
    for (int i = tid; i < T * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xs[i] = load1(x, x_bf16,
                    ((static_cast<int64_t>(bi) * S + s0 + t) * H + hi) * P + p);
    }
    for (int i = tid; i < T * N; i += kThreads) {
      const int t = i / N, n = i % N;
      bs[t * NP + n] = load1(
          b, b_bf16, ((static_cast<int64_t>(bi) * S + s0 + t) * H + hi) * N + n);
    }
    if (warp == 0) {
      // cl: lane owns R consecutive rows, then a shuffle scan of the totals
      const int R = (T + 31) / 32;
      float loc[kMaxT / 32];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT / 32; ++j) {
        const int t = lane * R + j;
        if (j < R && t < T)
          run += logf(a[(static_cast<int64_t>(bi) * S + s0 + t) * H + hi]);
        loc[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int j = 0; j < kMaxT / 32; ++j) {
        const int t = lane * R + j;
        if (j < R && t < T) cl[t] = excl + loc[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < T; i += kThreads) wv[i] = expf(cl[T - 1] - cl[i]);

    for (int t0 = 0; t0 < T; t0 += kRowBlock) {
      const int tb = min(kRowBlock, T - t0);
      const int send = t0 + tb;   // columns s < send can be on or below
      const int nj = (send + 31) / 32;
      for (int i = tid; i < tb * N; i += kThreads) {
        const int r = i / N, n = i % N;
        cs[r * NP + n] = load1(c, c_bf16,
                               bi * c_sb + (s0 + t0 + r) * c_ss + hi * c_sh + n);
      }
      __syncthreads();
      // ms[r][s] = (c_r · b_s) exp(cl_t - cl_s) for s <= t = t0 + r, else 0.
      // Thread tile: rows warp + 8i, columns lane + 32j.
      {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(warp + 8 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = lane + 32 * j;
            bv[j] = (j < nj && s < send) ? bs[s * NP + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp + 8 * i;
          const int t = t0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = lane + 32 * j;
            if (r < tb && s < send)
              ms[r * TP + s] = s <= t ? acc[i][j] * expf(cl[t] - cl[s]) : 0.f;
          }
        }
      }
      __syncthreads();
      // Y rows t0..t0+tb: rows warp + 8i, columns p = lane + 32k.
      {
        float acc[4][2], ach[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 2; ++k) acc[i][k] = ach[i][k] = 0.f;
        for (int s = 0; s < send; ++s) {
          float mv[4], xv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = ms[(warp + 8 * i) * TP + s];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int p = lane + 32 * k;
            xv[k] = p < P ? xs[s * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 2; ++k) acc[i][k] += mv[i] * xv[k];
        }
        if (ic > 0) {             // the first chunk starts from h = 0
          for (int n = 0; n < N; ++n) {
            float cv[4], hv[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = cs[(warp + 8 * i) * NP + n];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int p = lane + 32 * k;
              hv[k] = p < P ? hs[n * P + p] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int k = 0; k < 2; ++k) ach[i][k] += cv[i] * hv[k];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp + 8 * i;
          if (r >= tb) continue;
          const int t = t0 + r;
          const float dec = expf(cl[t]);
          const int64_t row =
              ((static_cast<int64_t>(bi) * S + s0 + t) * H + hi) * P;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int p = lane + 32 * k;
            if (p >= P) continue;
            const float v = acc[i][k] + dec * ach[i][k];
            if (x_bf16)
              static_cast<__nv_bfloat16*>(y)[row + p] = __float2bfloat16_rn(v);
            else
              static_cast<float*>(y)[row + p] = v;
          }
        }
      }
      __syncthreads();            // cs and ms are refilled next
    }

    // h = exp(cl_{T-1}) h + sum_s b_s w_s ⊗ x_s; thread owns n = warp + 8i,
    // p = lane + 32k, read and written by it alone.
    {
      const float dec = expf(cl[T - 1]);
      float acc[kMaxN / 8][2];
#pragma unroll
      for (int i = 0; i < kMaxN / 8; ++i) {
        const int n = warp + 8 * i;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = lane + 32 * k;
          acc[i][k] = (n < N && p < P) ? dec * hs[n * P + p] : 0.f;
        }
      }
      for (int s = 0; s < T; ++s) {
        const float ws = wv[s];
        float xv[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = lane + 32 * k;
          xv[k] = p < P ? xs[s * P + p] * ws : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kMaxN / 8; ++i) {
          const int n = warp + 8 * i;
          const float bv = n < N ? bs[s * NP + n] : 0.f;
#pragma unroll
          for (int k = 0; k < 2; ++k) acc[i][k] += bv * xv[k];
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxN / 8; ++i) {
        const int n = warp + 8 * i;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = lane + 32 * k;
          if (n < N && p < P) hs[n * P + p] = acc[i][k];
        }
      }
    }
  }
  __syncthreads();
  float* ho = h_out + static_cast<int64_t>(bh) * N * P;
  for (int i = tid; i < N * P; i += kThreads) ho[i] = hs[i];
}

}  // namespace

extern "C" int meili_ssd_scan(const void* x, const void* a, const void* b,
                              const void* c, void* y, void* h_out, int B,
                              int S, int H, int P, int N, int T, int64_t c_sb,
                              int64_t c_ss, int64_t c_sh, int x_bf16,
                              int b_bf16, int c_bf16, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T <= 0 || T > kMaxT || S % T != 0 || N <= 0 || N > kMaxN || P <= 0 ||
      P > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(T, N, P) * sizeof(float);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_scan_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(a), b, c, y, static_cast<float*>(h_out), S,
      H, P, N, T, c_sb, c_ss, c_sh, x_bf16, b_bf16, c_bf16);
  return static_cast<int>(cudaGetLastError());
}
