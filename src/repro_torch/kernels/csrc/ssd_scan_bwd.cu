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
//                 and per s: colsum_s(M1 ⊙ dY Xᵀ), r_s = w_s b_s·(g_c x_s);
//                 per t and s-block: the block's part of rowsum_t(M1 ⊙ dY Xᵀ)
//   (4) by step t dC = M2 B + diag(exp(cl)) dY h_cᵀ, and per t:
//                 rowsum_t(M1 ⊙ dY Xᵀ) + exp(cl_t) c_t·(h_c dy_t); then
//                 dcl_t = that - colsum_t - r_t, plus at t = T-1
//                 Σ_s r_s + exp(cl_{T-1}) <g_c, h_c>; d log a is its
//                 reverse cumulative sum within the chunk, da = d log a / a.
// L's exponent is taken only on and below the diagonal, as in the forward:
// with Mamba-2's decays a chunk's summed -log a passes f32's overflow.
//
// What bounds it on the H100: bytes. At mamba2-370m's training shape (B 4,
// S 1,024, H 32, P 64, N 128, chunk 128) the function reads x, dy, b, c,
// a and the scratch and writes dx, db, dc (full over H) and da: ~0.34 GB,
// 0.10 ms at 3.35 TB/s; the recurrence's backward takes 15 GFLOP (0.09 ms
// at the f32-accurate tensor-core rate). The chunked form's products are
// ~19 GFLOP at tile granularity, 0.12 ms as 3xTF32 at 495 TFLOP/s of TF32.
//
// What the design does about it:
// - Every product is f32-accurate 3xTF32 (tf32x3.cuh) on wgmma, B from
//   shared memory in the K-major no-swizzle core-matrix layout. Tiles land
//   by cp.async straight into that layout (16 bytes, one core-matrix row,
//   a copy; a warp fills four whole core matrices), two stages deep (three
//   in (1)), the next tile in flight while this one is multiplied; bf16
//   inputs widen on a synchronous load instead. A landed tile is split
//   once into hi (tf32) and lo, in the layout a product reads: as it lies,
//   or transposed where the product runs along its rows.
// - A operands are read from tiles as they landed and split as read; a
//   masked, decayed product (M1 = L ⊙ C Bᵀ, M2 = L ⊙ dY Xᵀ) stays in
//   registers as the A operand of the next product (its column 2c + u of
//   k-step j is k-slot c + 4u: the B tile it meets is transposed in that
//   slot order when it lands).
// - (1) one block per (chunk, head, batch), two warpgroups over the state
//   rows: A = (C ⊙ exp(cl))ᵀ read across the landed C tile, split as read,
//   B = dYᵀ. ~90 KB: two blocks an SM.
// - (3) `cols`: one block per (chunk, head, batch, 64-step block s), two
//   warpgroups with even work, each splitting the tiles it multiplies, so
//   one's splitting overlaps the other's products. A: C Bᵀ as (s, t) (K =
//   N, A = the block's B rows split as read), then dX += M1ᵀ dY; B: dY Xᵀ
//   as (s, t) (K = P), handed to A through shared memory (a named barrier:
//   A waits, B does not), then dB += M2ᵀ C for both 64-wide halves of n. A
//   forms Q = M1 ⊙ dY Xᵀ: its column sums in registers, its row sums per
//   warp, written per (s-block, t). The state terms stream first (g_c in
//   two 64-row slices, like tiles): B g_c and X g_cᵀ, r_s from the latter,
//   then both rows scaled by w_s. ~203 KB: one block an SM.
// - (4) `rows`: one block per (chunk, head, batch), warpgroup w over steps
//   t of 64w .. 64w + 63, A = the chunk's dY rows: dC = diag(exp(cl))
//   dY h_cᵀ first (h_c in 64-row slices) and e_t = exp(cl_t) c_t·(h_c dy_t)
//   from it, then per 32-step tile s on or below its steps dY Xᵀ as (t, s)
//   again (the only product computed twice), masked into M2, and
//   dC += M2 B. Why twice: dB sums M2 over t and dC over s, so each crosses
//   the other's blocks; a block that held a whole chunk in both orders
//   needs C, B, X, dY, g_c and h_c at once (256 KB in f32 before their lo
//   halves: past the 227 KB of shared memory), and handing M2 over
//   through DRAM moves 64 MB each way (0.04 ms), while dY Xᵀ (K = P = 64)
//   is an eighth of the triangle's products (~0.02 ms). The epilogue folds
//   dcl in: the chunk's row sums (`cols`' partials), e_t, column sums and
//   r, then one warp's reverse scan by shuffles, and da. ~122 KB and ~250
//   registers a thread: one block an SM. (A block per 64 steps, two an
//   SM, leaves too few registers: it spills.)
// - (2) elementwise over (b, h, n, p), the chunks in reverse: a thread
//   loads kBatch chunks' D_c before it writes any, so their DRAM latencies
//   overlap; the g_c overwrite D_c in place.
// What still bounds it: (3) and (4) run one block of 8 warps an SM, so
// loads, splits, products and the masks' arithmetic follow each other
// within a block instead of overlapping; the products reach a fraction of
// the tensor cores' rate.
// Deterministic: no atomics, every sum in a fixed order. x, b and c are
// f32 or bf16; c is read through its strides (a tensor broadcast over heads
// is never copied). T, N <= 128, P <= 64; tiles are zero-padded to those.
#include "tf32x3.cuh"

namespace {

using meili::core_desc;
using meili::cp_async16;
using meili::cp_async_commit;
using meili::cp_async_wait;
using meili::fence_to_async;
using meili::load1;
using meili::load4;
using meili::pin;
using meili::pin_a;
using meili::split;
using meili::store2;
using meili::wgmma;
using meili::wgmma_commit;
using meili::wgmma_fence;
using meili::wgmma_wait;

constexpr int kT = 128;         // chunk, at most
constexpr int kN = 128;         // state, at most (every tile is sized for it)
constexpr int kP = 64;          // head dim, at most
constexpr int kR = 32;          // rows of a streamed tile
constexpr int kS = 64;          // rows of a warpgroup's products (M)
constexpr int kThreads = 256;   // two warpgroups
constexpr int kStage = kR * kN + kR * kP;   // a C (or B) tile and a dY (X)
constexpr int kMaxDynamicSmem = 232448;
constexpr int kStaticSmemLimit = 48 * 1024;

// Element (r, k) of an R x K tile, K-major, in the no-swizzle core-matrix
// layout: core (r / 8, k / 4) at 32 (r / 8 · K / 4 + k / 4) floats, rows of
// cores outer; element (r % 8, k % 4) at 4 (r % 8) + k % 4 within it. A
// product's B operand at k-step kk (8 k) and row 8m is the descriptor
// (base + core_at(8m, 8kk), 128, 32 K) bytes apart along K and along rows.
template <int K>
__device__ __forceinline__ int core_at(int r, int k) {
  return ((r >> 3) * (K / 4) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

__device__ __forceinline__ void store1(void* base, int bf16, int64_t idx,
                                       float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[idx] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[idx] = x;
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// rows x cols of a strided array (row r at base + r·rstride, f32 or bf16)
// into an R x K core tile as f32, zero-filled. Thread i of 32 takes row
// 8·· + i % 8 and 4-float column 4·· + i / 8, so a warp
// writes four whole core matrices (512 contiguous bytes) and reads 64
// contiguous bytes of each of 8 rows. f32 goes by cp.async when every 16-byte chunk is
// aligned; bf16 (or unaligned) by plain loads.
template <int R, int K>
__device__ void land(float* dst, const void* src, int bf16, int64_t base,
                     int64_t rstride, int rows, int cols) {
  const int isz = bf16 ? 2 : 4;
  const bool vec =
      cols % 4 == 0 && rstride % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(src) + static_cast<uint64_t>(base) * isz) %
              (4 * isz) ==
          0;
  for (int i = threadIdx.x; i < R * K / 4; i += kThreads) {
    const int lane = i & 31, blk = i >> 5;
    const int r = blk / (K / 16) * 8 + (lane & 7);
    const int k = (blk % (K / 16) * 4 + (lane >> 3)) * 4;
    float* d = dst + core_at<K>(r, k);
    const bool in = r < rows && k < cols;
    const int64_t at = base + static_cast<int64_t>(r) * rstride + k;
    if (vec && !bf16) {
      cp_async16(d, static_cast<const float*>(src) + (in ? at : 0), in);
    } else if (vec) {
      *reinterpret_cast<float4*>(d) =
          in ? load4(src, 1, at) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = (r < rows && k + e < cols) ? load1(src, bf16, at + e) : 0.f;
    }
  }
}

// hi = tf32(x) and lo = x - hi of a landed R x K core tile `t`, into th
// and tl in the same layout (th may be t): the B operand of a product along
// K. Threads i0, i0 + nthr, ... take a core-matrix row (16 bytes) each.
template <int R, int K>
__device__ __forceinline__ void split_tile(const float* t, float* th,
                                           float* tl, int i0, int nthr) {
  for (int i = i0; i < R * K / 4; i += nthr) {
    const float4 v = reinterpret_cast<const float4*>(t)[i];
    uint4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(th)[i] = h;
    reinterpret_cast<uint4*>(tl)[i] = l;
  }
}

// Where step r of an accumulator's columns goes as a k-slot of the next
// product: 8j + 2m -> 8j + m, 8j + 2m + 1 -> 8j + 4 + m.
__device__ __forceinline__ int slot(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// hi and lo of the transpose of a landed R x K core tile: a K x R core tile
// (row k, column r, or slot(r) with kPerm), the B operand of a product
// along R. A warp reads one core matrix; its writes meet two ways in a
// bank.
template <int R, int K, bool kPerm>
__device__ __forceinline__ void split_tr(const float* t, float* th, float* tl,
                                         int i0, int nthr) {
  for (int i = i0; i < R * K; i += nthr) {
    uint32_t h, l;
    split(t[i], h, l);
    const int e = i & 31, ci = i >> 5;
    const int r = ci / (K / 4) * 8 + (e >> 2);
    const int k = ci % (K / 4) * 4 + (e & 3);
    const int at = core_at<R>(k, kPerm ? slot(r) : r);
    reinterpret_cast<uint32_t*>(th)[at] = h;
    reinterpret_cast<uint32_t*>(tl)[at] = l;
  }
}

// acc (this warpgroup's 64 rows x N) += A · B over NK k-steps of 8 (NK
// even), 3xTF32. A: the raw rows of a K-major core tile of row length KA;
// `pa` is core_at(ra, c) for this thread's row ra (ra % 8 = g); split as
// read. B: hi / lo core tiles split once when they landed, k-step k at
// bh + 64 k, `along_n` bytes between 8-row groups. Two k-steps a batch;
// the next batch's fragments are split while this one runs.
template <int N, int KA, int NK>
__device__ __forceinline__ void mma_raw(float (&acc)[N / 8][4],
                                        const float* pa, const float* bh,
                                        const float* bl, unsigned along_n) {
  constexpr int kRow8 = KA / 4 * 32;    // floats from row r to row r + 8
  uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
  for (int bt = 0; bt < NK / 2; ++bt) {
    const int set = bt & 1;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* p = pa + 64 * (2 * bt + kk);
      split(p[0], ah[set][kk][0], al[set][kk][0]);
      split(p[kRow8], ah[set][kk][1], al[set][kk][1]);
      split(p[32], ah[set][kk][2], al[set][kk][2]);
      split(p[kRow8 + 32], ah[set][kk][3], al[set][kk][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k = 2 * bt + kk;
      const uint64_t dh = core_desc(bh + 64 * k, 128, along_n);
      const uint64_t dl = core_desc(bl + 64 * k, 128, along_n);
      wgmma<N>(acc, al[set][kk], dh);
      wgmma<N>(acc, ah[set][kk], dl);
      wgmma<N>(acc, ah[set][kk], dh);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pin_a(ah[set ^ 1][kk]);
      pin_a(al[set ^ 1][kk]);
    }
  }
  wgmma_wait<0>();
  pin<N>(acc);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    pin_a(ah[0][kk]); pin_a(al[0][kk]);
    pin_a(ah[1][kk]); pin_a(al[1][kk]);
  }
}

// acc (64 x N) += M · B, M a masked 64 x 32 accumulator used as the A
// fragments of four k-steps as it lies (its column 2c + u of k-step j is
// k-slot c + 4u: the B tile holds its k in slot order), B hi / lo a K = 32
// core tile (k-step j at bh + 64 j, 1,024 bytes between 8-row groups).
template <int N>
__device__ __forceinline__ void mma_acc(float (&acc)[N / 8][4],
                                        const float (&m)[4][4],
                                        const float* bh, const float* bl) {
  uint32_t mh[4][4], ml[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(m[j][0], mh[j][0], ml[j][0]);
    split(m[j][2], mh[j][1], ml[j][1]);
    split(m[j][1], mh[j][2], ml[j][2]);
    split(m[j][3], mh[j][3], ml[j][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t dh = core_desc(bh + 64 * j, 128, 1024);
    const uint64_t dl = core_desc(bl + 64 * j, 128, 1024);
    wgmma<N>(acc, ml[j], dh);
    wgmma<N>(acc, mh[j], dl);
    wgmma<N>(acc, mh[j], dh);
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin<N>(acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pin_a(mh[j]);
    pin_a(ml[j]);
  }
}

// Sum over the four lanes of a quad (c = 0 .. 3), in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

struct Geom {
  int S, H, P, N, T, nc;
};

// (1) One block (two warpgroups) per (chunk, head, batch): D_c =
// (C ⊙ exp(cl))ᵀ dY into g (B, H, nc, N, P). Warpgroup w owns state rows
// n = 64w .. 64w + 63: A = (C ⊙ exp(cl))ᵀ read across the landed C tile,
// split as read; B = dYᵀ (transposed once a tile lands). The chunk streams
// through kDStages stages of kR steps, two tiles in flight while one is
// multiplied. ~90 KB a block: two blocks an SM.
constexpr int kDStages = 3;

constexpr size_t dstate_smem_floats() {
  return kDStages * static_cast<size_t>(kStage) + 2 * kR * kP + kT;
}

__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_dstate(const void* __restrict__ dy, const void* __restrict__ cmat,
                   const float* __restrict__ cl, float* __restrict__ gc,
                   Geom gm, int64_t c_sb, int64_t c_ss, int64_t c_sh,
                   int y_bf16, int c_bf16) {
  extern __shared__ __align__(128) float smem[];
  float* stg = smem;                  // kDStages x (C tile kR x kN, dY)
  float* yth = stg + kDStages * kStage;   // dYᵀ hi, kP x kR
  float* ytl = yth + kR * kP;
  float* ecl = ytl + kR * kP;         // kT  exp(cl), 0 past T
  const int ic = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int64_t bh = static_cast<int64_t>(bi) * gm.H + hi;
  const int64_t row0 = static_cast<int64_t>(bi) * gm.S + ic * gm.T;
  const int nt = (gm.T + kR - 1) / kR;

  auto fetch = [&](int i, int stage) {
    float* st = stg + stage * kStage;
    const int t0 = i * kR;
    const int rows = min(kR, gm.T - t0);
    land<kR, kN>(st, cmat, c_bf16,
                 bi * c_sb + static_cast<int64_t>(ic * gm.T + t0) * c_ss +
                     hi * c_sh,
                 c_ss, rows, gm.N);
    land<kR, kP>(st + kR * kN, dy, y_bf16, ((row0 + t0) * gm.H + hi) * gm.P,
                 static_cast<int64_t>(gm.H) * gm.P, rows, gm.P);
  };
  for (int i = 0; i < kDStages - 1; ++i) {
    if (i < nt) fetch(i, i);
    cp_async_commit();
  }
  for (int t = tid; t < kT; t += kThreads)
    ecl[t] = t < gm.T ? expf(cl[bh * gm.S + ic * gm.T + t]) : 0.f;

  const int n0 = 64 * wg + 16 * warp;         // rows n0 + g (+ 8)
  const bool live = 64 * wg < gm.N;           // warpgroup-uniform
  float acc[kP / 8][4];
#pragma unroll
  for (int j = 0; j < kP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();              // landed; the last tile's products done
    float* st = stg + (i % kDStages) * kStage;
    split_tr<kR, kP, false>(st + kR * kN, yth, ytl, tid, kThreads);
    fence_to_async();
    if (i + kDStages - 1 < nt)
      fetch(i + kDStages - 1, (i + kDStages - 1) % kDStages);
    cp_async_commit();
    __syncthreads();
    if (!live) continue;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int t = 8 * kk + c;
      const float e0 = ecl[i * kR + t], e1 = ecl[i * kR + t + 4];
      split(st[core_at<kN>(t, n0 + g)] * e0, ah[kk][0], al[kk][0]);
      split(st[core_at<kN>(t, n0 + g + 8)] * e0, ah[kk][1], al[kk][1]);
      split(st[core_at<kN>(t + 4, n0 + g)] * e1, ah[kk][2], al[kk][2]);
      split(st[core_at<kN>(t + 4, n0 + g + 8)] * e1, ah[kk][3], al[kk][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = core_desc(yth + 64 * kk, 128, 1024);
      const uint64_t dl = core_desc(ytl + 64 * kk, 128, 1024);
      wgmma<kP>(acc, al[kk], dh);
      wgmma<kP>(acc, ah[kk], dl);
      wgmma<kP>(acc, ah[kk], dh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<kP>(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin_a(ah[kk]);
      pin_a(al[kk]);
    }
  }
  if (!live) return;
  float* out = gc + (bh * gm.nc + ic) * gm.N * gm.P;
#pragma unroll
  for (int j = 0; j < kP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + (e >> 1) * 8, p = 8 * j + 2 * c + (e & 1);
      if (n < gm.N && p < gm.P) out[n * gm.P + p] = acc[j][e];
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

// (3) One block per (chunk, head, batch, 64-step block s): warpgroup A
// (C Bᵀ, Q's sums, dX) and warpgroup B (dY Xᵀ, dB, r) over one stream of
// items: g_c's 64-row slices (the state terms), then the tiles of kR steps
// t from the block's first step to the chunk's end (C and dY). The block's
// B and X rows stay as they landed: the A operands of C Bᵀ and dY Xᵀ, split
// as read. Each warpgroup splits what it multiplies itself, so one's
// splitting overlaps the other's products: A the C tile (C Bᵀ's B operand)
// and dYᵀ in slot order (dX's), or g_cᵀ; B the dY tile (dY Xᵀ's) and Cᵀ in
// slot order (dB's), or g_c. C Bᵀ and dY Xᵀ are (s, t) accumulators and,
// masked and decayed, the A operands of dX += M1ᵀ dY and dB += M2ᵀ C as
// they lie. B hands dY Xᵀ to A through shared memory for Q = M1 ⊙ dY Xᵀ
// (a named barrier: A waits, B does not). ~203 KB: one block an SM.
struct Cols {
  float* bs;     // kS x kN  the block's B rows, raw
  float* xs;     // kS x kP  its X rows, raw
  float* stg;    // 2 stages: C tile (kR x kN) or g_c slice (64 x kP), dY
  float* ah;     // A's: C tile hi, lo (kR x kN) or g_cᵀ slice (kP x 64)
  float* al;
  float* ayh;    // A's: dYᵀ (kP x kR, slot order) hi, lo
  float* ayl;
  float* bh;     // B's: Cᵀ (kN x kR, slot order) or g_c slice (64 x kP)
  float* bl;
  float* byh;    // B's: dY tile (kR x kP) hi, lo
  float* byl;
  float* exch;   // kS x kR  dY Xᵀ of the tile, by thread of B
  float* rsum;   // 4 x kT   Q's row sums by warp of A
  float* clv;    // kT  cl, 0 past T
  float* wv;     // kT  exp(cl_{T-1} - cl), 0 past T
};

constexpr size_t cols_smem_floats() {
  return static_cast<size_t>(kS) * (kN + kP) + 2 * kStage + 4 * kR * kN +
         4 * kR * kP + kS * kR + 4 * kT + 2 * kT;
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_cols(const void* __restrict__ x, const void* __restrict__ b,
                 const void* __restrict__ cmat, const void* __restrict__ dy,
                 const float* __restrict__ gc, const float* __restrict__ cl,
                 void* __restrict__ dx, void* __restrict__ db,
                 float* __restrict__ vec, Geom gm, int64_t c_sb,
                 int64_t c_ss, int64_t c_sh, int x_bf16, int b_bf16,
                 int c_bf16) {
  extern __shared__ __align__(128) float smem[];
  Cols sm;
  sm.bs = smem;
  sm.xs = sm.bs + kS * kN;
  sm.stg = sm.xs + kS * kP;
  sm.ah = sm.stg + 2 * kStage;
  sm.al = sm.ah + kR * kN;
  sm.ayh = sm.al + kR * kN;
  sm.ayl = sm.ayh + kR * kP;
  sm.bh = sm.ayl + kR * kP;
  sm.bl = sm.bh + kR * kN;
  sm.byh = sm.bl + kR * kN;
  sm.byl = sm.byh + kR * kP;
  sm.exch = sm.byl + kR * kP;
  sm.rsum = sm.exch + kS * kR;
  sm.clv = sm.rsum + 4 * kT;
  sm.wv = sm.clv + kT;

  const int nsb = (gm.T + kS - 1) / kS;
  const int ic = blockIdx.x / nsb, sb = blockIdx.x % nsb;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int s0 = sb * kS;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int ls = 16 * warp + g;       // this thread's rows s0 + ls (+ 8)
  const int64_t bh = static_cast<int64_t>(bi) * gm.H + hi;
  const int64_t row0 = static_cast<int64_t>(bi) * gm.S + ic * gm.T;
  const int64_t hp = static_cast<int64_t>(gm.H) * gm.P;
  const int64_t bhs = static_cast<int64_t>(gridDim.z) * gm.H * gm.S;
  const int64_t v0 = bh * gm.S + ic * gm.T;
  const int srows = min(kS, gm.T - s0);
  const int ns = (gm.N + 63) / 64;                 // g_c slices
  const int nt = (gm.T - s0 + kR - 1) / kR;        // tiles of steps t
  const int nitems = ns + nt;

  auto fetch = [&](int item, int stage) {
    float* st = sm.stg + stage * kStage;
    if (item < ns) {
      const int n0 = 64 * item;
      land<64, kP>(st, gc,
                   0, (bh * gm.nc + ic) * gm.N * gm.P +
                          static_cast<int64_t>(n0) * gm.P,
                   gm.P, min(64, gm.N - n0), gm.P);
      return;
    }
    const int t0 = s0 + (item - ns) * kR;
    const int rows = min(kR, gm.T - t0);
    land<kR, kN>(st, cmat, c_bf16,
                 bi * c_sb + static_cast<int64_t>(ic * gm.T + t0) * c_ss +
                     hi * c_sh,
                 c_ss, rows, gm.N);
    land<kR, kP>(st + kR * kN, dy, x_bf16, ((row0 + t0) * gm.H + hi) * gm.P,
                 hp, rows, gm.P);
  };

  land<kS, kN>(sm.bs, b, b_bf16, ((row0 + s0) * gm.H + hi) * gm.N,
               static_cast<int64_t>(gm.H) * gm.N, srows, gm.N);
  land<kS, kP>(sm.xs, x, x_bf16, ((row0 + s0) * gm.H + hi) * gm.P, hp,
               srows, gm.P);
  fetch(0, 0);
  cp_async_commit();
  for (int t = tid; t < kT; t += kThreads)
    sm.clv[t] = t < gm.T ? cl[v0 + t] : 0.f;
  __syncthreads();
  for (int t = tid; t < kT; t += kThreads)
    sm.wv[t] = t < gm.T ? expf(sm.clv[gm.T - 1] - sm.clv[t]) : 0.f;

  const int sa = s0 + ls, sbr = sa + 8;     // this thread's steps s
  // L ⊙ v at (s, t) of a 64 x 32 accumulator whose rows are the block's
  // steps s and columns the tile's steps t0 + ...; zero above the diagonal
  // and past T.
  auto mask = [&](float (&m)[4][4], int t0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = e < 2 ? sa : sbr;
        const int t = t0 + 8 * j + 2 * c + (e & 1);
        m[j][e] = (s <= t && t < gm.T)
                      ? m[j][e] * expf(sm.clv[t] - sm.clv[s]) : 0.f;
      }
  };
  // Scale an accumulator's rows (the block's steps s) by w_s.
  auto by_w = [&](float (&m)[8][4]) {
    const float w0 = sm.wv[sa], w1 = sm.wv[sbr];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m[j][0] *= w0; m[j][1] *= w0;
      m[j][2] *= w1; m[j][3] *= w1;
    }
  };
  // Both warpgroups: the item has landed (and the last one's products are
  // done). After its own splits and fence, each thread fetches its share of
  // the next item into the other stage.
  auto next = [&](int item) {
    if (item + 1 < nitems) fetch(item + 1, (item + 1) & 1);
    cp_async_commit();
  };
  // Rows s of an accumulator (columns 8j + 2c (+ 1) of a width-wide row of
  // out) to out, in its dtype.
  auto store_rows = [&](const float (&m)[8][4], void* out, int bf16, int q0,
                        int width) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = i == 0 ? sa : sbr;
      if (s >= gm.T) continue;
      const int64_t at = ((row0 + s) * gm.H + hi) * width;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = q0 + 8 * j + 2 * c;
        const float u0 = m[j][2 * i], u1 = m[j][2 * i + 1];
        if (q + 1 < width && width % 2 == 0) {
          store2(out, bf16, at + q, u0, u1);
        } else {
          if (q < width) store1(out, bf16, at + q, u0);
          if (q + 1 < width) store1(out, bf16, at + q + 1, u1);
        }
      }
    }
  };

  if (wg == 0) {
    // A: dX = diag(w) B g_c + M1ᵀ dY; Q = M1 ⊙ dY Xᵀ's sums
    float dxa[kP / 8][4];
#pragma unroll
    for (int j = 0; j < kP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[j][e] = 0.f;
    float qc[2] = {0.f, 0.f};
    for (int item = 0; item < nitems; ++item) {
      cp_async_wait<0>();
      __syncthreads();
      const float* st = sm.stg + (item & 1) * kStage;
      if (item < ns) {
        split_tr<64, kP, false>(st, sm.ah, sm.al, wt, 128);
        fence_to_async();
        next(item);
        named_sync(2, 128);
        // B g_c over n = 64 item .. + 63: A = B's rows, B = g_cᵀ
        mma_raw<kP, kN, 8>(dxa, sm.bs + core_at<kN>(ls, 64 * item + c),
                           sm.ah, sm.al, kP / 4 * 128);
        if (item == ns - 1) by_w(dxa);
        continue;
      }
      split_tile<kR, kN>(st, sm.ah, sm.al, wt, 128);
      split_tr<kR, kP, true>(st + kR * kN, sm.ayh, sm.ayl, wt, 128);
      fence_to_async();
      next(item);
      named_sync(2, 128);
      const int t0 = s0 + (item - ns) * kR;
      float gt[kR / 8][4];
#pragma unroll
      for (int j = 0; j < kR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gt[j][e] = 0.f;
      // C Bᵀ as (s, t): A = B's rows, B = the C tile
      if (gm.N > 64)
        mma_raw<kR, kN, 16>(gt, sm.bs + core_at<kN>(ls, c), sm.ah, sm.al,
                            kN / 4 * 128);
      else
        mma_raw<kR, kN, 8>(gt, sm.bs + core_at<kN>(ls, c), sm.ah, sm.al,
                           kN / 4 * 128);
      mask(gt, t0);
      named_sync(1, kThreads);        // B's dY Xᵀ is in exch
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float q0 = gt[j][u] * sm.exch[(4 * j + u) * 128 + wt];
          const float q1 = gt[j][2 + u] * sm.exch[(4 * j + 2 + u) * 128 + wt];
          qc[0] += q0;
          qc[1] += q1;
          float v = q0 + q1;
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          part[u] = v;
        }
        if (g == 0) {
          const int t = t0 + 8 * j + 2 * c;
          sm.rsum[warp * kT + t] = part[0];
          sm.rsum[warp * kT + t + 1] = part[1];
        }
      }
      mma_acc<kP>(dxa, gt, sm.ayh, sm.ayl);     // dX += M1ᵀ dY
    }
    store_rows(dxa, dx, x_bf16, 0, gm.P);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = i == 0 ? sa : sbr;
      const float q = quad_sum(qc[i]);
      if (c == 0 && s < gm.T) vec[2 * bhs + v0 + s] = q;   // Q's column sums
    }
  } else {
    // B: dB = diag(w) X g_cᵀ + M2ᵀ C, and r_s
    float db0[8][4], db1[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        db0[j][e] = 0.f;
        db1[j][e] = 0.f;
      }
    float rr[2] = {0.f, 0.f};
    for (int item = 0; item < nitems; ++item) {
      cp_async_wait<0>();
      __syncthreads();
      const float* st = sm.stg + (item & 1) * kStage;
      if (item < ns) {
        split_tile<64, kP>(st, sm.bh, sm.bl, wt, 128);
        fence_to_async();
        next(item);
        named_sync(3, 128);
        // X g_cᵀ for n = 64 item .. + 63: A = X's rows, B = the slice
        if (item == 0)
          mma_raw<64, kP, 8>(db0, sm.xs + core_at<kP>(ls, c), sm.bh, sm.bl,
                             kP / 4 * 128);
        else
          mma_raw<64, kP, 8>(db1, sm.xs + core_at<kP>(ls, c), sm.bh, sm.bl,
                             kP / 4 * 128);
        if (item == ns - 1) {
          // r_s = w_s Σ_n B[s][n] (X g_cᵀ)[s][n], then dB's rows by w
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = ls + 8 * i;
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int n = 8 * j + 2 * c + u;
                v = fmaf(sm.bs[core_at<kN>(r, n)], db0[j][2 * i + u], v);
                v = fmaf(sm.bs[core_at<kN>(r, 64 + n)], db1[j][2 * i + u], v);
              }
            rr[i] = sm.wv[s0 + r] * quad_sum(v);
          }
          by_w(db0);
          by_w(db1);
        }
        continue;
      }
      split_tr<kR, kN, true>(st, sm.bh, sm.bl, wt, 128);
      split_tile<kR, kP>(st + kR * kN, sm.byh, sm.byl, wt, 128);
      fence_to_async();
      next(item);
      named_sync(3, 128);
      const int t0 = s0 + (item - ns) * kR;
      float dm[kR / 8][4];
#pragma unroll
      for (int j = 0; j < kR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dm[j][e] = 0.f;
      // dY Xᵀ as (s, t): A = X's rows, B = the dY tile
      mma_raw<kR, kP, 8>(dm, sm.xs + core_at<kP>(ls, c), sm.byh, sm.byl,
                         kP / 4 * 128);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm.exch[(4 * j + e) * 128 + wt] = dm[j][e];
      named_arrive(1, kThreads);
      mask(dm, t0);
      mma_acc<64>(db0, dm, sm.bh, sm.bl);               // dB += M2ᵀ C
      if (ns > 1) mma_acc<64>(db1, dm, sm.bh + 64 * kR, sm.bl + 64 * kR);
    }
    store_rows(db0, db, b_bf16, 0, gm.N);
    store_rows(db1, db, b_bf16, 64, gm.N);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = i == 0 ? sa : sbr;
      if (c == 0 && s < gm.T) vec[3 * bhs + v0 + s] = rr[i];
    }
  }
  __syncthreads();                    // every warp's row sums are in
  for (int t = s0 + tid; t < gm.T; t += kThreads)
    vec[sb * bhs + v0 + t] = sm.rsum[t] + sm.rsum[kT + t] +
                             sm.rsum[2 * kT + t] + sm.rsum[3 * kT + t];
}

// (4) One block per (chunk, head, batch): warpgroup w owns steps t =
// 64w .. 64w + 63. The chunk's dY rows stay in shared memory as they
// landed (A operands, split as read); items stream as in (3): h_c's 64-row
// slices (split as they lie), then tiles of kR steps s: X (split as it
// lies) and B (transposed in slot order). dC = diag(exp(cl)) dY h_cᵀ
// first, e_t from it, then per tile on or below the warpgroup's steps
// dY Xᵀ as (t, s) again, masked and decayed in registers into the A
// operand of dC += M2 B. Then dcl and da in the epilogue. ~122 KB a block.
constexpr size_t rows_smem_floats() {
  return static_cast<size_t>(kT) * kP + 2 * kStage + kR * kP + 2 * kR * kN +
         3 * kT + kThreads / 32;
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_rows(const void* __restrict__ x, const float* __restrict__ a,
                 const void* __restrict__ b, const void* __restrict__ cmat,
                 const void* __restrict__ dy, const float* __restrict__ gc,
                 const float* __restrict__ hc, const float* __restrict__ cl,
                 const float* __restrict__ vec, void* __restrict__ dc,
                 float* __restrict__ da, Geom gm, int64_t c_sb, int64_t c_ss,
                 int64_t c_sh, int x_bf16, int b_bf16, int c_bf16) {
  extern __shared__ __align__(128) float smem[];
  float* ys = smem;                   // kT x kP  the chunk's dY, raw
  float* stg = ys + kT * kP;          // 2 x (X tile kR x kP, B tile kR x kN
                                      //      or h_c slice 64 x kP)
  float* xlo = stg + 2 * kStage;      // lo of the X tile (hi in place)
  float* bth = xlo + kR * kP;         // Bᵀ (kN x kR, slot order) hi, or the
                                      // h_c slice's lo (hi in place)
  float* btl = bth + kR * kN;         // Bᵀ lo
  float* clv = btl + kR * kN;         // kT  cl, 0 past T
  float* ecl = clv + kT;              // kT  exp(cl), 0 past T
  float* edcl = ecl + kT;             // kT  e_t
  float* red = edcl + kT;             // one per warp: <g_c, h_c>

  const int ic = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int ra = 64 * wg + 16 * warp + g, rb = ra + 8;   // this thread's t
  const int64_t bh = static_cast<int64_t>(bi) * gm.H + hi;
  const int64_t row0 = static_cast<int64_t>(bi) * gm.S + ic * gm.T;
  const int64_t hp = static_cast<int64_t>(gm.H) * gm.P;
  const int64_t bhs = static_cast<int64_t>(gridDim.z) * gm.H * gm.S;
  const int64_t v0 = bh * gm.S + ic * gm.T;
  const int64_t soff = (bh * gm.nc + ic) * gm.N * gm.P;   // g_c, h_c
  const int ns = (gm.N + 63) / 64;                 // h_c slices
  const int nt = (gm.T + kR - 1) / kR;             // tiles of steps s
  const int nitems = ns + nt;
  const bool live = 64 * wg < gm.T;                // warpgroup-uniform

  auto fetch = [&](int item, int stage) {
    float* st = stg + stage * kStage;
    if (item < ns) {
      const int n0 = 64 * item;
      land<64, kP>(st + kR * kP, hc, 0,
                   soff + static_cast<int64_t>(n0) * gm.P, gm.P,
                   min(64, gm.N - n0), gm.P);
      return;
    }
    const int s0 = (item - ns) * kR;
    const int rows = min(kR, gm.T - s0);
    land<kR, kP>(st, x, x_bf16, ((row0 + s0) * gm.H + hi) * gm.P, hp, rows,
                 gm.P);
    land<kR, kN>(st + kR * kP, b, b_bf16, ((row0 + s0) * gm.H + hi) * gm.N,
                 static_cast<int64_t>(gm.H) * gm.N, rows, gm.N);
  };

  land<kT, kP>(ys, dy, x_bf16, (row0 * gm.H + hi) * gm.P, hp, gm.T, gm.P);
  fetch(0, 0);
  cp_async_commit();
  for (int t = tid; t < kT; t += kThreads) {
    const float v = t < gm.T ? cl[v0 + t] : 0.f;
    clv[t] = v;
    ecl[t] = t < gm.T ? expf(v) : 0.f;
  }

  float gh = 0.f;                     // this thread's part of <g_c, h_c>
  float dc0[8][4], dc1[8][4];         // dC, n 0 .. 63 and 64 .. 127
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dc0[j][e] = 0.f;
      dc1[j][e] = 0.f;
    }
  const float* pa = ys + core_at<kP>(ra, c);
  for (int item = 0; item < nitems; ++item) {
    cp_async_wait<0>();
    __syncthreads();
    float* st = stg + (item & 1) * kStage;
    float* sb = st + kR * kP;
    if (item < ns) {
      // <g_c, h_c> over the slice as it landed (zero past N and P: g_c is
      // read at a clamped index there), then its hi and lo; each thread
      // reads the core-matrix rows it then splits in place
      const int n0 = 64 * item;
      constexpr int kEach = 64 * kP / 4 / kThreads;
      float gv[kEach][4];
#pragma unroll
      for (int q = 0; q < kEach; ++q) {
        const int i4 = tid + q * kThreads;
        const int n = n0 + (i4 >> 3) / (kP / 4) * 8 + (i4 & 7);
        const int p = (i4 >> 3) % (kP / 4) * 4;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          gv[q][u] = gc[soff + (n < gm.N && p + u < gm.P ? n * gm.P + p + u
                                                         : 0)];
      }
#pragma unroll
      for (int q = 0; q < kEach; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          gh = fmaf(gv[q][u], sb[4 * (tid + q * kThreads) + u], gh);
      split_tile<64, kP>(sb, sb, bth, tid, kThreads);
    } else {
      split_tile<kR, kP>(st, st, xlo, tid, kThreads);
      split_tr<kR, kN, true>(sb, bth, btl, tid, kThreads);
    }
    fence_to_async();
    // the next item lands in the other stage while this one is multiplied
    if (item + 1 < nitems) fetch(item + 1, (item + 1) & 1);
    cp_async_commit();
    __syncthreads();
    if (!live) continue;
    if (item < ns) {
      // dY h_cᵀ for n = 64 item .. + 63: A = dY's rows, B = the slice
      if (item == 0)
        mma_raw<64, kP, 8>(dc0, pa, sb, bth, kP / 4 * 128);
      else
        mma_raw<64, kP, 8>(dc1, pa, sb, bth, kP / 4 * 128);
      if (item == ns - 1) {
        // e_t = exp(cl_t) Σ_n C[t][n] (dY h_cᵀ)[t][n], then dC's rows by
        // exp(cl). dC is zero past N and T, where C is read at a clamped
        // index; all loads are issued before the first product.
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = i == 0 ? ra : rb;
          const int64_t cr = bi * c_sb +
                             static_cast<int64_t>(ic * gm.T +
                                                  min(t, gm.T - 1)) * c_ss +
                             hi * c_sh;
          float cv[2][8][2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u)
                cv[h2][j][u] = load1(
                    cmat, c_bf16, cr + min(64 * h2 + 8 * j + 2 * c + u,
                                           gm.N - 1));
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              v = fmaf(cv[0][j][u], dc0[j][2 * i + u], v);
              v = fmaf(cv[1][j][u], dc1[j][2 * i + u], v);
            }
          v = quad_sum(v);
          if (c == 0) edcl[t] = ecl[t] * v;
        }
        const float e0 = ecl[ra], e1 = ecl[rb];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dc0[j][0] *= e0; dc0[j][1] *= e0; dc0[j][2] *= e1; dc0[j][3] *= e1;
          dc1[j][0] *= e0; dc1[j][1] *= e0; dc1[j][2] *= e1; dc1[j][3] *= e1;
        }
      }
      continue;
    }
    const int s0 = (item - ns) * kR;
    if (s0 > 64 * wg + 63) continue;  // above this warpgroup's steps
    float m[kR / 8][4];
#pragma unroll
    for (int j = 0; j < kR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[j][e] = 0.f;
    // dY Xᵀ as (t, s): A = dY's rows, B = the X tile
    mma_raw<kR, kP, 8>(m, pa, st, xlo, kP / 4 * 128);
    // M2 = L ⊙ dY Xᵀ at (t, s): rows t, columns s0 + ...
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = e < 2 ? ra : rb;
        const int s = s0 + 8 * j + 2 * c + (e & 1);
        m[j][e] = (s <= t && t < gm.T) ? m[j][e] * expf(clv[t] - clv[s])
                                       : 0.f;
      }
    mma_acc<64>(dc0, m, bth, btl);                      // dC += M2 B
    if (ns > 1) mma_acc<64>(dc1, m, bth + 64 * kR, btl + 64 * kR);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = i == 0 ? ra : rb;
      if (t >= gm.T) continue;
      const int64_t at = ((row0 + t) * gm.H + hi) * gm.N;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = 64 * h2 + 8 * j + 2 * c;
          const float u0 = h2 ? dc1[j][2 * i] : dc0[j][2 * i];
          const float u1 = h2 ? dc1[j][2 * i + 1] : dc0[j][2 * i + 1];
          if (n + 1 < gm.N && gm.N % 2 == 0) {
            store2(dc, c_bf16, at + n, u0, u1);
          } else {
            if (n < gm.N) store1(dc, c_bf16, at + n, u0);
            if (n + 1 < gm.N) store1(dc, c_bf16, at + n + 1, u1);
          }
        }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, o);
  if (lane == 0) red[tid >> 5] = gh;
  __syncthreads();
  if (tid >= 32) return;
  // dcl_t = rowsum_t + e_t - colsum_t - r_t (+ the tail at T - 1), then
  // its reverse cumulative sum: lane l owns steps 4l .. 4l + 3.
  float ght = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) ght += red[w];
  float v[4], rs = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    v[u] = 0.f;
    if (t >= gm.T) continue;
    const float r = vec[3 * bhs + v0 + t];
    rs += r;
    float row = vec[v0 + t];
    if (t >= kS) row += vec[bhs + v0 + t];
    v[u] = row + edcl[t] - vec[2 * bhs + v0 + t] - r;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
  if (lane == (gm.T - 1) >> 2) {
    const float tail = rs + expf(clv[gm.T - 1]) * ght;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u == ((gm.T - 1) & 3)) v[u] += tail;
  }
  float run = 0.f;
#pragma unroll
  for (int u = 3; u >= 0; --u) {
    run += v[u];
    v[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += up;
  }
  const float after = incl - run;     // the lanes past this one
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    if (t >= gm.T) continue;
    const int64_t at = (row0 + t) * gm.H + hi;
    da[at] = (v[u] + after) / a[at];
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

// Runs (1)-(4) in order on `stream`. dy is in x's dtype (y's); dh may be
// null (zero). `g` (B, H, S / T, N, P) and `vec` (4, B, H, S: Q's row sums
// of s-blocks 0 and 1, its column sums, r) are f32 scratch from the caller.
// dx, db, dc (B, S, H, N: every head, whatever c's strides) are written in
// the dtypes of x, b and c; da in f32. Returns the first CUDA error.
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
  const int nsb = (T + kS - 1) / kS;
  const size_t smem1 = dstate_smem_floats() * sizeof(float);
  const size_t smem3 = cols_smem_floats() * sizeof(float);
  const size_t smem4 = rows_smem_floats() * sizeof(float);
  int err = set_smem((const void*)ssd_bwd_dstate, smem1);
  if (!err) err = set_smem((const void*)ssd_bwd_cols, smem3);
  if (!err) err = set_smem((const void*)ssd_bwd_rows, smem4);
  if (err) return err;
  float* gf = static_cast<float*>(g);
  const float* clf = static_cast<const float*>(cl);
  float* vf = static_cast<float*>(vec);
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
  ssd_bwd_cols<<<dim3(gm.nc * nsb, H, B), kThreads, smem3, st>>>(
      x, b, c, dy, gf, clf, dx, db, vf, gm, c_sb, c_ss, c_sh, x_bf16, b_bf16,
      c_bf16);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_bwd_rows<<<dim3(gm.nc, H, B), kThreads, smem4, st>>>(
      x, static_cast<const float*>(a), b, c, dy, gf,
      static_cast<const float*>(states), clf, vf, dc,
      static_cast<float*>(da), gm, c_sb, c_ss, c_sh, x_bf16, b_bf16, c_bf16);
  return static_cast<int>(cudaGetLastError());
}
