// Mamba-2 SSD chunked scan — B7 of the port.
//
// Replaces: src/repro/kernels/ssd_scan.py `_ssd_kernel` / `ssd_scan`. The
// TPU kernel runs a (b·h, chunk) grid whose chunk axis is sequential, and
// carries the (N, P) state across it in VMEM scratch. Blocks on the card
// run in no order, so the work is split as the Mamba-2 paper splits it for
// GPUs (arXiv:2405.21060 §6: chunk state, state passing, chunk scan), and
// only the light middle step walks the chunks in order.
//
// Per chunk c of T steps, with cl = cumsum(log a) over the chunk:
//   (a) chunk state   S_c  = (B ⊙ exp(cl_{T-1} - cl))ᵀ X          (N, P)
//   (b) state passing h_0 = 0,  h_{c+1} = exp(cl_{T-1}) h_c + S_c
//   (c) chunk scan    Y    = (C Bᵀ ⊙ L) X + diag(exp(cl)) C h_c
//                     L[t,s] = exp(cl_t - cl_s) for s <= t, else 0
// and h_final = h_nc. L's exponent is taken only on and below the
// diagonal: the Pallas body takes it everywhere and masks afterwards, and
// with Mamba-2's decays a chunk's summed -log a passes f32's overflow, so
// exp(inf) · 0 would be NaN.
//
// What bounds it on the H100: bytes. At mamba2-370m's prefill shape (B 4,
// S 1,024, H 32, P 64, N 128, chunk 128) the function reads and writes
// ~141 MB (0.042 ms at 3.35 TB/s); its 5.4 GFLOP take 0.033 ms at the
// f32-accurate tensor-core rate (3xTF32, tf32x3.cuh). The chunked form
// adds the scratch: chunk states (B, H, nc, N, P) f32, 33.5 MB written by
// (a), rewritten in place by (b) as each chunk's incoming state, and read
// by (c), which the L2 partly holds.
//
// What the design does about it:
// - (a) and (c) run one block per (chunk, head, batch), (c) one per half
//   chunk: 1,024 and 2,048 blocks at the path's shape, where one block per
//   (b, h) walking 8 chunks gave 128.
// - Every product (Bᵀ X, C Bᵀ, C h, (C Bᵀ ⊙ L) X) is f32-accurate 3xTF32
//   (tf32x3.cuh) on wgmma: A from registers, split as it is read (B ⊙ w,
//   C, and C Bᵀ ⊙ L, which never leaves registers: its accumulator is the
//   A fragment once the step order is permuted as in flash_attention.cu),
//   B from shared memory in the K-major core-matrix layout wgmma reads.
//   Each tile that lands is converted into that layout once (hi over the
//   landed rows, lo beside them) by the whole block.
// - (a) streams the chunk through two 32-row stages (cp.async, the next
//   while this one is multiplied), ~62 KB a block; it
//   writes cl to scratch and (c) reads it back, so both products take
//   their decays from the same bits. Tiles are loaded by warps over rows
//   and lanes over 16-byte chunks (no per-thread division).
// - (b) loads every chunk's state of its entries before it writes any, so
//   the loads' DRAM latencies overlap.
// - (c) is one warpgroup per half chunk: the half's C rows stay in shared
//   memory; the incoming state (32-row slices of n) and then B and X
//   (blocks of 32 steps, only those on or below the half's last row)
//   stream through two stages. ~111 KB a block, two blocks an SM, so one
//   block's loads overlap the other's products. C Bᵀ is masked and
//   decayed in registers; the decay's exponent is taken only on and below
//   the diagonal.
// - bf16 inputs widen on a synchronous load instead. Rows are padded so
//   the conversions' reads are free of bank conflicts at the path's widths.
// x, b and c are f32 or bf16; c is read through its strides, so a tensor
// broadcast over heads (stride 0) is never copied. T, N <= 128, P <= 64.
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
using meili::wgmma;
using meili::wgmma_commit;
using meili::wgmma_fence;
using meili::wgmma_wait;

constexpr int kThreads = 256;
constexpr int kMaxT = 128;      // chunk
constexpr int kMaxN = 128;      // state
constexpr int kMaxP = 64;       // head dim
constexpr int kMaxDynamicSmem = 232448;
constexpr int kStaticSmemLimit = 48 * 1024;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Padded extents: chunk rows to whole 16-row warp slabs, state to 32 (bank
// spread of the padded rows), head dim to whole 8-column tiles.
struct Dims {
  int Tp, Np, Pp;
  __host__ __device__ Dims(int T, int N, int P)
      : Tp(round_up(T, 16)), Np(round_up(N, 32)), Pp(round_up(P, 8)) {}
};

// rows x cols of a strided array (row r at base + r·rstride) into shared
// memory with row stride ld as f32, zero-filled out to rows_p x cols_p
// (cols_p a multiple of 4). f32 rows go by cp.async when every 4-float
// chunk is 16-byte aligned; bf16 (or unaligned) rows by plain loads. Warps
// take rows and lanes 4-float chunks, so no thread divides.
__device__ void load_rows(float* dst, int ld, const void* src, int bf16,
                          int64_t base, int64_t rstride, int rows, int cols,
                          int rows_p, int cols_p) {
  const int isz = bf16 ? 2 : 4;
  const bool vec =
      cols % 4 == 0 && rstride % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(src) + static_cast<uint64_t>(base) * isz) %
              (4 * isz) ==
          0;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows_p; r += nwarps) {
    const int64_t row = base + static_cast<int64_t>(r) * rstride;
    for (int col = lane * 4; col < cols_p; col += 128) {
      float* d = dst + r * ld + col;
      const bool in = r < rows && col < cols;
      if (vec && !bf16) {
        cp_async16(d, static_cast<const float*>(src) + (in ? row + col : 0),
                   in);
      } else if (vec) {
        *reinterpret_cast<float4*>(d) =
            in ? load4(src, 1, row + col) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = (r < rows && col + e < cols) ? load1(src, bf16, row + col + e)
                                              : 0.f;
      }
    }
  }
}

// (a) One block (two warpgroups) per (chunk, head, batch): cl to scratch,
// and the chunk's state S_c = (B ⊙ w)ᵀ X, w = exp(cl_{T-1} - cl), to
// scratch, on wgmma: warpgroup w owns state rows n = 64w .. 64w + 63, A =
// (B ⊙ w)ᵀ from registers (split as it is read), B = Xᵀ from shared
// memory. The chunk's rows stream through two stages of kSubRows rows, the
// next fetched while this one is multiplied; each landed X block is
// converted once into Xᵀ core matrices (hi over the landed rows, lo
// beside them). ~62 KB a block.
constexpr int kSubRows = 32;
constexpr int kStateThreads = 256;
constexpr int kPx = 64;           // the product's N over P (zero-padded)

__host__ __device__ inline int state_x_floats(int P) {
  const Dims d(kSubRows, 8, P);
  const int raw = kSubRows * (d.Pp + 8);
  return raw > kPx * kSubRows ? raw : kPx * kSubRows;
}

__host__ __device__ inline size_t state_stage_floats(int N, int P) {
  const Dims d(kSubRows, N, P);
  return static_cast<size_t>(kSubRows) * (d.Np + 8) + state_x_floats(P);
}

__host__ __device__ inline size_t state_smem_floats(int N, int P) {
  return 2 * state_stage_floats(N, P) + kPx * kSubRows + 2 * kMaxT;
}

__global__ void __launch_bounds__(kStateThreads, 2)
    ssd_chunk_state(const void* __restrict__ x, const float* __restrict__ a,
                    const void* __restrict__ b, float* __restrict__ states,
                    float* __restrict__ cl_out, int S, int H, int P, int N,
                    int T, int x_bf16, int b_bf16) {
  const Dims dm(T, N, P);
  const int BS = dm.Np + 8;       // B rows as they land (A reads 8c + g)
  const int XS = dm.Pp + 8;       // X rows as they land
  const int stage_floats = static_cast<int>(state_stage_floats(N, P));
  extern __shared__ __align__(128) float smem[];
  float* xlo = smem + 2 * stage_floats;  // Xᵀ lo of the current block
  float* cl = xlo + kPx * kSubRows;      // kMaxT  cumsum(log a)
  float* wv = cl + kMaxT;                // kMaxT  exp(cl_{T-1} - cl), 0 past T

  const int ic = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = ic * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int rr = lane >> 2, qq = lane & 3;
  const int64_t row0 = static_cast<int64_t>(bi) * S + s0;
  const int nsub = (T + kSubRows - 1) / kSubRows;

  // Stage: kSubRows rows of B (stride BS), then of X (stride XS).
  auto fetch = [&](int sub, int stage) {
    float* bsd = smem + stage * stage_floats;
    const int r0 = sub * kSubRows;
    const int rows = min(kSubRows, T - r0);
    load_rows(bsd + kSubRows * BS, XS, x, x_bf16, ((row0 + r0) * H + hi) * P,
              static_cast<int64_t>(H) * P, rows, P, kSubRows, dm.Pp);
    load_rows(bsd, BS, b, b_bf16, ((row0 + r0) * H + hi) * N,
              static_cast<int64_t>(H) * N, rows, N, kSubRows, dm.Np);
  };
  fetch(0, 0);
  cp_async_commit();

  if (warp == 0) {
    // cl: lane owns R consecutive rows, then a shuffle scan of the totals
    const int R = (T + 31) / 32;
    float loc[kMaxT / 32];
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT / 32; ++j) {
      const int t = lane * R + j;
      if (j < R && t < T) run += logf(a[(row0 + t) * H + hi]);
      loc[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const float excl = incl - run;
    float* clg = cl_out + (static_cast<int64_t>(bi) * H + hi) * S + s0;
#pragma unroll
    for (int j = 0; j < kMaxT / 32; ++j) {
      const int t = lane * R + j;
      if (j < R && t < T) {
        cl[t] = excl + loc[j];
        clg[t] = cl[t];
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < kMaxT; t += kStateThreads)
    wv[t] = t < T ? expf(cl[T - 1] - cl[t]) : 0.f;

  const int wg = warp >> 2;
  const int n0 = wg * 64 + (warp & 3) * 16;   // this warp's rows n0 + g (+8)
  const bool live = wg * 64 < dm.Np;          // warpgroup-uniform
  float acc[kPx / 8][4];
#pragma unroll
  for (int j = 0; j < kPx / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int sub = 0; sub < nsub; ++sub) {
    cp_async_wait<0>();
    __syncthreads();              // landed (and wv visible); the last done
    if (sub + 1 < nsub) fetch(sub + 1, (sub + 1) & 1);
    cp_async_commit();
    float* bs = smem + (sub & 1) * stage_floats;
    float* xs = bs + kSubRows * BS;
    // Xᵀ core 8·(p / 8) + k4 holds p 8·(p / 8) + rr and step 4·k4 + qq of
    // the block; p past P is zero.
    constexpr int kXCores = kPx / 8 * kSubRows / 4 / 8;   // per warp
    float xv[kXCores];
#pragma unroll
    for (int i = 0; i < kXCores; ++i) {
      const int cm = warp + 8 * i;
      const int p = 8 * (cm >> 3) + rr;
      xv[i] = p < dm.Pp ? xs[(4 * (cm & 7) + qq) * XS + p] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kXCores; ++i) {
      uint32_t h, l;
      split(xv[i], h, l);
      const int at = (warp + 8 * i) * 32 + lane;
      reinterpret_cast<uint32_t*>(xs)[at] = h;
      reinterpret_cast<uint32_t*>(xlo)[at] = l;
    }
    fence_to_async();
    __syncthreads();
    if (live) {
      // A[n][s] = B[s][n] w_s over the block's 32 steps: 4 k-steps
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int sl = 8 * kk + c;                 // step in the block
        const float w0 = wv[sub * kSubRows + sl];
        const float w1 = wv[sub * kSubRows + sl + 4];
        const float* br0 = bs + sl * BS + n0 + g;
        const float* br1 = br0 + 4 * BS;
        split(br0[0] * w0, ah[kk][0], al[kk][0]);
        split(br0[8] * w0, ah[kk][1], al[kk][1]);
        split(br1[0] * w1, ah[kk][2], al[kk][2]);
        split(br1[8] * w1, ah[kk][3], al[kk][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = core_desc(xs + 64 * kk, 128, 1024);
        const uint64_t dl = core_desc(xlo + 64 * kk, 128, 1024);
        wgmma<kPx>(acc, al[kk], dh);
        wgmma<kPx>(acc, ah[kk], dl);
        wgmma<kPx>(acc, ah[kk], dh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<kPx>(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pin_a(ah[kk]);
        pin_a(al[kk]);
      }
    }
  }
  if (!live) return;
  float* out = states +
               ((static_cast<int64_t>(bi) * H + hi) * nc + ic) * N * P;
#pragma unroll
  for (int j = 0; j < kPx / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + (e >= 2 ? 8 : 0);
      const int p = j * 8 + 2 * c + (e & 1);
      if (n < N && p < P) out[n * P + p] = acc[j][e];
    }
  }
}

// (b) Elementwise over (b, h, n, p), sequential over the chunks: overwrite
// each chunk's state with the state entering it, and write h_final. A
// thread owns W consecutive entries of one (b, h) and loads kBatch chunks'
// states before it writes any, so their DRAM latencies overlap.
template <int W>
__device__ __forceinline__ void load_w(float (&v)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = p[w];
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) p[w] = v[w];
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    ssd_state_passing(float* __restrict__ states,
                      const float* __restrict__ cl, float* __restrict__ h_out,
                      int64_t BH, int nc, int NP, int S, int T) {
  constexpr int kBatch = 8;
  const int64_t per = NP / W;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= BH * per) return;
  const int64_t bh = i / per;
  const int64_t e = (i % per) * W;
  float* base = states + bh * nc * NP + e;
  const float* dec = cl + bh * S + T - 1;   // chunk ic's total at ic·T
  float h[W];
#pragma unroll
  for (int w = 0; w < W; ++w) h[w] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float s[kBatch][W], d[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < nc) {
        load_w(s[k], base + static_cast<int64_t>(c0 + k) * NP);
        d[k] = expf(dec[static_cast<int64_t>(c0 + k) * T]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < nc) {
        store_w(base + static_cast<int64_t>(c0 + k) * NP, h);
#pragma unroll
        for (int w = 0; w < W; ++w) h[w] = d[k] * h[w] + s[k][w];
      }
    }
  }
  store_w(h_out + bh * NP + e, h);
}

// (c) One block (one warpgroup, 4 warps) per (chunk, head, batch, half of
// the chunk's rows): Y = (C Bᵀ ⊙ L) X + diag(exp(cl)) C h_c on wgmma. The
// half's C rows stay in shared memory as they landed and are split into A
// fragments as they are read. The incoming state (32-row slices of n) and
// then B and X (blocks of 32 steps s, up to the half's last row) stream
// through two stages by cp.async; each item, once landed, is converted
// once into the K-major core-matrix layout wgmma reads (hi over the landed
// rows, lo beside them): Bᵀ-blocks for C Bᵀ, Xᵀ for (C Bᵀ ⊙ L) X, hᵀ for
// C h. ~111 KB a block: two blocks an SM.
constexpr int kScanRows = 64;     // chunk rows per block (one warpgroup)
constexpr int kScanThreads = 128;
constexpr int kSlice = 32;        // rows of a streamed item
constexpr int kPw = 64;           // the products' N over P (zero-padded)

// X rows as they land, or Xᵀ's kPw x kSlice core matrices, whichever is
// larger.
__host__ __device__ inline int scan_x_floats(int P) {
  const Dims d(kSlice, 8, P);
  const int raw = kSlice * (d.Pp + 4);
  return raw > kPw * kSlice ? raw : kPw * kSlice;
}

__host__ __device__ inline int scan_stage_floats(int N, int P) {
  const Dims d(kSlice, N, P);
  const int bx = kSlice * (d.Np + 4) + scan_x_floats(P);
  const int hsl = kSlice * (d.Pp + 8);
  return bx > hsl ? bx : hsl;
}

// The converted item's lo parts: Bᵀ (32 x Np) and Xᵀ (kPw x 32), or hᵀ.
__host__ __device__ inline int scan_lo_floats(int N) {
  const Dims d(kSlice, N, 8);
  return kSlice * d.Np + kPw * kSlice;
}

__host__ __device__ inline size_t scan_smem_floats(int N, int P) {
  const Dims d(kSlice, N, P);
  return static_cast<size_t>(kScanRows) * (d.Np + 4) +
         2 * static_cast<size_t>(scan_stage_floats(N, P)) +
         scan_lo_floats(N) + 2 * kMaxT;
}

__global__ void __launch_bounds__(kScanThreads, 2)
    ssd_chunk_scan(const void* __restrict__ x, const void* __restrict__ b,
                   const void* __restrict__ cmat,
                   const float* __restrict__ states,
                   const float* __restrict__ cl_in, void* __restrict__ y,
                   int S, int H, int P, int N, int T, int64_t c_sb,
                   int64_t c_ss, int64_t c_sh, int x_bf16, int b_bf16,
                   int c_bf16) {
  const Dims dm(T, N, P);
  const int CS = dm.Np + 4;       // C and B rows as they land
  const int XS = dm.Pp + 4;       // X rows as they land
  const int HS = dm.Pp + 8;       // state rows as they land
  const int stage_floats = scan_stage_floats(N, P);
  extern __shared__ __align__(128) float smem[];
  float* cs = smem;                           // kScanRows x CS
  float* stages = cs + kScanRows * CS;        // 2 x stage_floats
  float* lo = stages + 2 * stage_floats;      // the current item's lo parts
  float* cl = lo + scan_lo_floats(N);         // kMaxT
  float* ecl = cl + kMaxT;                    // kMaxT   exp(cl)

  const int halves = (dm.Tp + kScanRows - 1) / kScanRows;
  const int ic = blockIdx.x / halves;
  const int r0 = (blockIdx.x % halves) * kScanRows;   // first row of the half
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.x / halves;
  const int s0 = ic * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int rr = lane >> 2, qq = lane & 3;    // element of a core matrix
  const int64_t row0 = static_cast<int64_t>(bi) * S + s0;
  const int64_t bh = static_cast<int64_t>(bi) * H + hi;
  const int r_end = min(r0 + kScanRows, dm.Tp);       // rows of the half

  // Streamed items: the state's n-slices (not for the first chunk), then
  // the step blocks on or below the half's last row.
  const int n_h = ic > 0 ? dm.Np / kSlice : 0;
  const int n_s = (r_end + kSlice - 1) / kSlice;
  auto fetch = [&](int item, int stage) {
    float* st = stages + stage * stage_floats;
    if (item < n_h) {
      const int n0 = item * kSlice;
      load_rows(st, HS, states, 0, ((bh * nc + ic) * N + n0) * P, P,
                min(kSlice, N - n0), P, kSlice, dm.Pp);
    } else {
      const int sb = (item - n_h) * kSlice;
      const int rows = min(kSlice, T - sb);
      load_rows(st, CS, b, b_bf16, ((row0 + sb) * H + hi) * N,
                static_cast<int64_t>(H) * N, rows, N, kSlice, dm.Np);
      load_rows(st + kSlice * CS, XS, x, x_bf16, ((row0 + sb) * H + hi) * P,
                static_cast<int64_t>(H) * P, rows, P, kSlice, dm.Pp);
    }
  };

  load_rows(cs, CS, cmat, c_bf16, bi * c_sb + (s0 + r0) * c_ss + hi * c_sh,
            c_ss, min(kScanRows, T - r0), N, kScanRows, dm.Np);
  fetch(0, 0);
  cp_async_commit();
  for (int t = tid; t < kMaxT; t += kScanThreads) {
    cl[t] = cl_in[bh * S + s0 + min(t, T - 1)];
    ecl[t] = expf(cl[t]);
  }

  const int ta = r0 + warp * 16 + g, tb = ta + 8;   // this thread's rows
  const float* ca = cs + (ta - r0) * CS + c;
  const float* cb = cs + (tb - r0) * CS + c;

  // Y: diag(exp(cl)) C h_c (its A rows pre-scaled by exp(cl)), then
  // + (C Bᵀ ⊙ L) X
  float acc[kPw / 8][4];
#pragma unroll
  for (int j = 0; j < kPw / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int item = 0; item < n_h + n_s; ++item) {
    cp_async_wait<0>();
    __syncthreads();              // item landed; the last item's products done
    if (item + 1 < n_h + n_s) fetch(item + 1, (item + 1) & 1);
    cp_async_commit();
    float* st = stages + (item & 1) * stage_floats;

    if (item < n_h) {
      // hᵀ slice: core 8·(p / 8) + k4 holds p 8·(p / 8) + rr and n
      // n0 + 4·k4 + qq; p past P is zero.
      float hv[kPw / 8 * kSlice / 4 / 4];
#pragma unroll
      for (int i = 0; i < kPw / 8 * kSlice / 4 / 4; ++i) {
        const int cm = warp + 4 * i;
        const int p = 8 * (cm >> 3) + rr;
        const int n = 4 * (cm & 7) + qq;
        hv[i] = p < dm.Pp ? st[n * HS + p] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPw / 8 * kSlice / 4 / 4; ++i) {
        uint32_t h, l;
        split(hv[i], h, l);
        const int at = (warp + 4 * i) * 32 + lane;
        reinterpret_cast<uint32_t*>(st)[at] = h;
        reinterpret_cast<uint32_t*>(lo)[at] = l;
      }
      fence_to_async();
      __syncthreads();
      // acc += diag(exp(cl)) C[:, n0 : n0 + 32] h_c[n0 : n0 + 32]: 4
      // k-steps
      const int n0 = item * kSlice;
      const float ea = ecl[ta], eb = ecl[tb];
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = n0 + 8 * kk;
        split(ca[k] * ea, ah[kk][0], al[kk][0]);
        split(cb[k] * eb, ah[kk][1], al[kk][1]);
        split(ca[k + 4] * ea, ah[kk][2], al[kk][2]);
        split(cb[k + 4] * eb, ah[kk][3], al[kk][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = core_desc(st + 64 * kk, 128, 1024);
        const uint64_t dl = core_desc(lo + 64 * kk, 128, 1024);
        wgmma<kPw>(acc, al[kk], dh);
        wgmma<kPw>(acc, ah[kk], dl);
        wgmma<kPw>(acc, ah[kk], dh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<kPw>(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pin_a(ah[kk]);
        pin_a(al[kk]);
      }
      continue;
    }

    // A block of 32 steps: Bᵀ core 4·k4 + n8 holds s 8·n8 + rr, n 4·k4 +
    // qq (Np / 4 x 4 cores); Xᵀ core 8·(p / 8) + k4 holds p 8·(p / 8) +
    // rr and step slot 4·k4 + qq, slot k' of the 8-step group j holding
    // step 8j + (k' < 4 ? 2k' : 2(k' - 4) + 1), the order of M's A columns.
    const int sb = (item - n_h) * kSlice;
    float* xst = st + kSlice * CS;
    float* blo = lo;
    float* xlo = lo + kSlice * dm.Np;
    constexpr int kBCores = kMaxN / 4;           // Bᵀ cores per warp (Np 128)
    constexpr int kXCores = kPw / 8 * 8 / 4;     // Xᵀ cores per warp
    {
      float bv[kBCores];
#pragma unroll
      for (int i = 0; i < kBCores; ++i) {
        const int cm = warp + 4 * i;             // 0 .. Np - 1
        const int n = 4 * (cm >> 2) + qq;
        bv[i] = n < dm.Np ? st[(8 * (cm & 3) + rr) * CS + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kBCores; ++i) {
        const int cm = warp + 4 * i;
        if (4 * (cm >> 2) < dm.Np) {
          uint32_t h, l;
          split(bv[i], h, l);
          reinterpret_cast<uint32_t*>(st)[cm * 32 + lane] = h;
          reinterpret_cast<uint32_t*>(blo)[cm * 32 + lane] = l;
        }
      }
    }
    {
      float xv[kXCores];               // the X rows are still as they landed
#pragma unroll
      for (int i = 0; i < kXCores; ++i) {
        const int cm = warp + 4 * i;             // 0 .. 63
        const int p = 8 * (cm >> 3) + rr;
        const int slot = 4 * (cm & 7) + qq;      // 0 .. 31
        const int w8 = slot & 7;
        const int sx = (slot & ~7) + (w8 < 4 ? 2 * w8 : 2 * (w8 - 4) + 1);
        xv[i] = p < dm.Pp ? xst[sx * XS + p] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kXCores; ++i) {
        uint32_t h, l;
        split(xv[i], h, l);
        const int at = (warp + 4 * i) * 32 + lane;
        reinterpret_cast<uint32_t*>(xst)[at] = h;
        reinterpret_cast<uint32_t*>(xlo)[at] = l;
      }
    }
    fence_to_async();
    __syncthreads();

    // G = C Bᵀ over the block's 32 steps: k over n, 2 k-steps a batch.
    float gm[kSlice / 8][4] = {};
    uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll 1
    for (int b2 = 0; b2 < dm.Np / 32; ++b2) {
#pragma unroll
      for (int set = 0; set < 2; ++set) {
        const int bt = 2 * b2 + set;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int k = 16 * bt + 8 * kk;
          split(ca[k], ah[set][kk][0], al[set][kk][0]);
          split(cb[k], ah[set][kk][1], al[set][kk][1]);
          split(ca[k + 4], ah[set][kk][2], al[set][kk][2]);
          split(cb[k + 4], ah[set][kk][3], al[set][kk][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int at = (2 * bt + kk) * 2 * 4 * 32;   // cores k4 = 2·step
          const uint64_t dh = core_desc(st + at, 512, 128);
          const uint64_t dl = core_desc(blo + at, 512, 128);
          wgmma<kSlice>(gm, al[set][kk], dh);
          wgmma<kSlice>(gm, ah[set][kk], dl);
          wgmma<kSlice>(gm, ah[set][kk], dh);
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          pin_a(ah[set ^ 1][kk]);
          pin_a(al[set ^ 1][kk]);
        }
      }
    }
    wgmma_wait<0>();
    pin<kSlice>(gm);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pin_a(ah[0][kk]); pin_a(al[0][kk]);
      pin_a(ah[1][kk]); pin_a(al[1][kk]);
    }
    // M = G ⊙ L: gm[j][e] is row e < 2 ? ta : tb, step s = sb + 8j + 2c +
    // (e & 1); the exponent only where s <= t.
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = e < 2 ? ta : tb;
        const int s = sb + j * 8 + 2 * c + (e & 1);
        gm[j][e] = s <= t ? gm[j][e] * expf(cl[t] - cl[s]) : 0.f;
      }
    }
    // acc += M X: A = M from registers (column c <-> step 2c, c + 4 <->
    // 2c + 1), B = Xᵀ.
    uint32_t mh[kSlice / 8][4], ml[kSlice / 8][4];
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
      split(gm[j][0], mh[j][0], ml[j][0]);
      split(gm[j][2], mh[j][1], ml[j][1]);
      split(gm[j][1], mh[j][2], ml[j][2]);
      split(gm[j][3], mh[j][3], ml[j][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
      const uint64_t dh = core_desc(xst + 64 * j, 128, 1024);
      const uint64_t dl = core_desc(xlo + 64 * j, 128, 1024);
      wgmma<kPw>(acc, ml[j], dh);
      wgmma<kPw>(acc, mh[j], dl);
      wgmma<kPw>(acc, mh[j], dh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<kPw>(acc);
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
      pin_a(mh[j]);
      pin_a(ml[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPw / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = e < 2 ? ta : tb;
      const int p = j * 8 + 2 * c + (e & 1);
      if (t < T && p < P) {
        const float v = acc[j][e];
        const int64_t idx = ((row0 + t) * H + hi) * P + p;
        if (x_bf16)
          static_cast<__nv_bfloat16*>(y)[idx] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(y)[idx] = v;
      }
    }
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

// Runs (a), (b) and (c) in order on `stream`. `states` (B, H, S / T, N, P)
// and `cl` (B, H, S) are f32 scratch from the caller. Returns the first
// CUDA error.
extern "C" int meili_ssd_scan(const void* x, const void* a, const void* b,
                              const void* c, void* y, void* h_out,
                              void* states, void* cl, int B, int S, int H,
                              int P, int N, int T, int64_t c_sb, int64_t c_ss,
                              int64_t c_sh, int x_bf16, int b_bf16,
                              int c_bf16, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T <= 0 || T > kMaxT || S % T != 0 || N <= 0 || N > kMaxN || P <= 0 ||
      P > kMaxP || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = S / T;
  const size_t smem_a = state_smem_floats(N, P) * sizeof(float);
  const size_t smem_c = scan_smem_floats(N, P) * sizeof(float);
  int err = set_smem((const void*)ssd_chunk_state, smem_a);
  if (err) return err;
  err = set_smem((const void*)ssd_chunk_scan, smem_c);
  if (err) return err;
  float* st_f = static_cast<float*>(states);
  float* cl_f = static_cast<float*>(cl);
  const dim3 grid(nc, H, B);
  ssd_chunk_state<<<grid, kStateThreads, smem_a, st>>>(
      x, static_cast<const float*>(a), b, st_f, cl_f, S, H, P, N, T, x_bf16,
      b_bf16);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t BH = static_cast<int64_t>(B) * H;
  if ((N * P) % 4 == 0) {
    const int64_t n = BH * N * P / 4;
    ssd_state_passing<4><<<static_cast<unsigned>((n + kThreads - 1) /
                                                 kThreads),
                           kThreads, 0, st>>>(
        st_f, cl_f, static_cast<float*>(h_out), BH, nc, N * P, S, T);
  } else {
    const int64_t n = BH * N * P;
    ssd_state_passing<1><<<static_cast<unsigned>((n + kThreads - 1) /
                                                 kThreads),
                           kThreads, 0, st>>>(
        st_f, cl_f, static_cast<float*>(h_out), BH, nc, N * P, S, T);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int halves = (Dims(T, N, P).Tp + kScanRows - 1) / kScanRows;
  ssd_chunk_scan<<<dim3(nc * halves, H, B), kScanThreads, smem_c, st>>>(
      x, b, c, st_f, cl_f, y, S, H, P, N, T, c_sb, c_ss, c_sh, x_bf16, b_bf16,
      c_bf16);
  return static_cast<int>(cudaGetLastError());
}
