// Blocked causal / sliding-window GQA attention, backward — B5's gradient.
//
// Replaces: the reference's flash-style gradient of B5, the custom VJP
// `_attention_blocked_bwd` of src/repro/kernels/ops.py (the TPU path has no
// Pallas backward: XLA runs that blocked scan). Given q, k, v, the forward's
// output o, its per-row log-sum-exp lse (flash_attention.cu) and dO:
//   delta_i = sum_d dO_id O_id
//   p_ij    = exp(scale q_i.k_j - lse_i)          (0 where masked)
//   dV_j    = sum_i p_ij dO_i
//   ds_ij   = p_ij (dO_i.v_j - delta_i) scale
//   dQ_i    = sum_j ds_ij k_j,   dK_j = sum_i ds_ij q_i
// with i over (query position, query head) rows and the G = Hq / Hkv query
// heads of a KV head summed into its dK and dV.
//
// What bounds it on the H100: operations, five products of 2·D flops per
// unmasked (row, key) pair (QKᵀ, dO Vᵀ, dV, dK, dQ), f32-accurate: 3xTF32
// on the tensor cores (tf32x3.cuh), a third of the TF32 rate, 165 TFLOP/s.
//
// What the design does about it (head dims 16, 64 and 128; D 256 keeps the
// scalar kernels below, whose tiles would not fit shared memory here):
// - Every product runs on the tensor cores as 3xTF32. Products whose A
//   operand is a tile held in shared memory by one warp (Sᵀ = K Qᵀ, dPᵀ =
//   V dOᵀ, S = Q Kᵀ, dP = dO Vᵀ) run on mma.sync m16n8k8; the products
//   that accumulate over a walk (dV += Pᵀ dO, dK += dSᵀ Q, dQ += dS K) run
//   on wgmma m64nDk8 with A from registers and B from shared memory.
// - No float atomics, so two runs are bit-equal. One kernel owns 64 keys of
//   one KV head and walks the row tiles that may see them: warpgroup 0
//   computes Sᵀ and Pᵀ and sums dV, warpgroup 1 computes dPᵀ, takes Pᵀ
//   through shared memory, and sums dK (16 keys a warp in each). A second
//   kernel owns 128 rows (two warpgroups) and walks their key tiles,
//   summing dQ. Both recompute p. A third, first, computes delta.
// - The dK/dV kernel works transposed: the keys are the M rows, so Pᵀ and
//   dSᵀ come out of mma.sync in the accumulator layout, which is the A
//   fragment of wgmma once the rows are permuted (A column c <-> row 2c,
//   c + 4 <-> 2c + 1, matched by the B tile's row slots): no transpose
//   through shared memory. The dQ kernel does the same with dS, as the
//   forward does with P.
// - wgmma's f32 accumulation cuts each sum toward zero. Over the 8,192 rows
//   a key sums at S 1,024 and G 8 that drifted dV by 1e-4 of its scale, so
//   every tile's products go into a zeroed partial sum that is added into
//   the total with ordinary (round-to-nearest) f32 adds.
// - Rows are (position, head) pairs of one KV head, position-major, so a
//   row tile covers all G heads that share the key tile's K and V.
// - Each tile is split into TF32 hi and lo once when it lands: hi in place
//   and lo beside it for mma.sync's B fragments (128-bit loads, the depth
//   index permuted within 16-column blocks as in the forward), and hi and
//   lo again in wgmma's K-major core-matrix layout. Row tiles (dK/dV) and
//   key tiles (dQ) are double buffered with cp.async: tile t + 1 lands
//   while tile t is multiplied.
// - Tiles outside the causal/window band are never fetched, a warp whose
//   keys (rows) see none of the tile skips its mma.sync products, and
//   tiles inside every pair's band skip the mask. Key tiles of the dK/dV
//   kernel launch earliest (most rows) first, row tiles of the dQ kernel
//   latest first.
// All tensors are f32 and contiguous: q, o, dO, dq (B, Sq, Hq, D); k, v,
// dk, dv (B, Sk, Hkv, D); lse, delta (B, Hq, Sq).
#include "tf32x3.cuh"

namespace {

using meili::core_desc;
using meili::cp_async16;
using meili::cp_async4;
using meili::cp_async_commit;
using meili::cp_async_wait;
using meili::fence_to_async;
using meili::mma_tf32;
using meili::pin;
using meili::pin_a;
using meili::split;
using meili::wgmma;
using meili::wgmma_commit;
using meili::wgmma_fence;
using meili::wgmma_wait;

constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB on sm_90

// ---- the scalar kernels (PR 17), kept for D 256 --------------------------

constexpr int kBR = 32;   // query rows per tile
constexpr int kBK = 32;   // keys per tile

template <int D>
struct Tile {
  static constexpr int C4 = D / 4;                 // float4 chunks of a row
  static constexpr int TPR = C4 < 8 ? C4 : 8;      // threads per summed row
  static constexpr int THREADS = 32 * TPR;         // 32 summed rows a block
  static constexpr int CPT = C4 / TPR;             // chunks a thread sums
  static constexpr int KPT = kBR * kBK / THREADS;  // (row, key) a thread
  static constexpr int KL = kBK / KPT;             // threads along the keys
  static constexpr int LD = D + 4;                 // row stride in smem
  static constexpr int LDP = kBK + 1;              // p / ds row stride
  // K, V, Q, dO tiles; p and ds; lse and delta of the rows
  static constexpr size_t SMEM_FLOATS =
      static_cast<size_t>(2 * kBK + 2 * kBR) * LD + 2 * kBR * LDP + 2 * kBR;
  static_assert(THREADS % 32 == 0 && KPT * THREADS == kBR * kBK, "tiles");
};

struct Shape {
  int Sq, Sk, Hq, Hkv, G, causal, window;
  float scale;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x += s * x.x; acc.y += s * x.y; acc.z += s * x.z; acc.w += s * x.w;
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// delta (B, Hq, Sq) = rowsum(dO · O): one warp a row.
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           float* __restrict__ delta, int64_t rows, int Sq,
                           int Hq, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += o[row * D + d] * dout[row * D + d];
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) {
    const int64_t b = row / (static_cast<int64_t>(Sq) * Hq);
    const int pos = static_cast<int>((row / Hq) % Sq);
    const int h = static_cast<int>(row % Hq);
    delta[(b * Hq + h) * Sq + pos] = acc;
  }
}

// Stage rows [R0, R0 + kBR) of q-shaped x ((position, head) rows of KV
// head hk) into x_s, zeros past the last row; and their lse and delta.
template <int D>
__device__ __forceinline__ void stage_rows(
    const float* __restrict__ x, const float* __restrict__ y, float* x_s,
    float* y_s, const float* __restrict__ lse,
    const float* __restrict__ delta, float* lse_s, float* delta_s, int b,
    int hk, int R0, const Shape& sh) {
  using T = Tile<D>;
  const int rows = sh.Sq * sh.G;
  for (int i = threadIdx.x; i < kBR * T::C4; i += T::THREADS) {
    const int r = i / T::C4, ch = i % T::C4;
    const int R = R0 + r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    if (R < rows) {
      const int64_t at =
          ((static_cast<int64_t>(b) * sh.Sq + R / sh.G) * sh.Hq + hk * sh.G +
           R % sh.G) * D + ch * 4;
      a = *reinterpret_cast<const float4*>(x + at);
      c = *reinterpret_cast<const float4*>(y + at);
    }
    *reinterpret_cast<float4*>(x_s + r * T::LD + ch * 4) = a;
    *reinterpret_cast<float4*>(y_s + r * T::LD + ch * 4) = c;
  }
  for (int r = threadIdx.x; r < kBR; r += T::THREADS) {
    const int R = R0 + r;
    float l = 1e30f, dl = 0.f;
    if (R < rows) {
      const int64_t at = (static_cast<int64_t>(b) * sh.Hq + hk * sh.G +
                          R % sh.G) * sh.Sq + R / sh.G;
      l = lse[at];
      dl = delta[at];
    }
    lse_s[r] = l;
    delta_s[r] = dl;
  }
}

// Stage keys [k0, k0 + kBK) of KV head hk of k and v, zeros past Sk.
template <int D>
__device__ __forceinline__ void stage_keys(const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           float* k_s, float* v_s, int b,
                                           int hk, int k0, const Shape& sh) {
  using T = Tile<D>;
  for (int i = threadIdx.x; i < kBK * T::C4; i += T::THREADS) {
    const int j = i / T::C4, ch = i % T::C4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    if (k0 + j < sh.Sk) {
      const int64_t at = ((static_cast<int64_t>(b) * sh.Sk + k0 + j) * sh.Hkv +
                          hk) * D + ch * 4;
      a = *reinterpret_cast<const float4*>(k + at);
      c = *reinterpret_cast<const float4*>(v + at);
    }
    *reinterpret_cast<float4*>(k_s + j * T::LD + ch * 4) = a;
    *reinterpret_cast<float4*>(v_s + j * T::LD + ch * 4) = c;
  }
}

// p and ds of the staged rows (from R0) against the staged keys (from k0)
// into p_s and ds_s. Thread t: row t / KL, keys t % KL + KL·m.
template <int D>
__device__ __forceinline__ void probs(const float* q_s, const float* do_s,
                                      const float* k_s, const float* v_s,
                                      const float* lse_s,
                                      const float* delta_s, float* p_s,
                                      float* ds_s, int R0, int k0,
                                      const Shape& sh) {
  using T = Tile<D>;
  const int r = threadIdx.x / T::KL;
  const int j0 = threadIdx.x % T::KL;
  float s[T::KPT], dp[T::KPT];
#pragma unroll
  for (int m = 0; m < T::KPT; ++m) s[m] = dp[m] = 0.f;
#pragma unroll 4
  for (int ch = 0; ch < T::C4; ++ch) {
    const float4 qa = lds4(q_s + r * T::LD + ch * 4);
    const float4 da = lds4(do_s + r * T::LD + ch * 4);
#pragma unroll
    for (int m = 0; m < T::KPT; ++m) {
      const int j = j0 + T::KL * m;
      s[m] += dot4(qa, lds4(k_s + j * T::LD + ch * 4));
      dp[m] += dot4(da, lds4(v_s + j * T::LD + ch * 4));
    }
  }
  const int R = R0 + r;
  const bool row_ok = R < sh.Sq * sh.G;
  const int qpos = R / sh.G + sh.Sk - sh.Sq;
  const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
  for (int m = 0; m < T::KPT; ++m) {
    const int j = j0 + T::KL * m;
    const int kpos = k0 + j;
    const bool ok = row_ok && kpos < sh.Sk &&
                    (!sh.causal || kpos <= qpos) &&
                    (sh.window <= 0 || kpos > qpos - sh.window);
    const float p = ok ? expf(s[m] * sh.scale - lse) : 0.f;
    p_s[r * T::LDP + j] = p;
    ds_s[r * T::LDP + j] = p * (dp[m] - delta) * sh.scale;
  }
}

// dK and dV of one tile of kBK keys of KV head blockIdx.y, batch blockIdx.z:
// every query row that may see one of the keys, in tiles of kBR rows.
// Thread t sums key t / TPR, chunks t % TPR + TPR·i.
template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Shape sh) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBK * T::LD;
  float* q_s = v_s + kBK * T::LD;
  float* do_s = q_s + kBR * T::LD;
  float* p_s = do_s + kBR * T::LD;
  float* ds_s = p_s + kBR * T::LDP;
  float* lse_s = ds_s + kBR * T::LDP;
  float* delta_s = lse_s + kBR;
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int off = sh.Sk - sh.Sq;
  stage_keys<D>(k, v, k_s, v_s, b, hk, k0, sh);

  // query positions that may see a key of [k0, k0 + kBK)
  int p_lo = 0, p_hi = sh.Sq;                    // [p_lo, p_hi)
  if (sh.causal) p_lo = max(0, k0 - off);
  if (sh.window > 0)
    p_hi = min(sh.Sq, max(0, k0 + kBK - 1 + sh.window - off));
  const int j = threadIdx.x / T::TPR;
  const int cl = threadIdx.x % T::TPR;
  float4 acc_k[T::CPT], acc_v[T::CPT];
#pragma unroll
  for (int i = 0; i < T::CPT; ++i)
    acc_k[i] = acc_v[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int R0 = p_lo * sh.G; R0 < p_hi * sh.G; R0 += kBR) {
    __syncthreads();        // the last tile's rows are read
    stage_rows<D>(q, dout, q_s, do_s, lse, delta, lse_s, delta_s, b, hk, R0,
                  sh);
    __syncthreads();
    probs<D>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, R0, k0, sh);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kBR; ++r) {
      const float p = p_s[r * T::LDP + j];
      const float ds = ds_s[r * T::LDP + j];
#pragma unroll
      for (int i = 0; i < T::CPT; ++i) {
        const int ch = cl + T::TPR * i;
        fma4(acc_v[i], p, lds4(do_s + r * T::LD + ch * 4));
        fma4(acc_k[i], ds, lds4(q_s + r * T::LD + ch * 4));
      }
    }
  }
  if (k0 + j >= sh.Sk) return;
  const int64_t at =
      ((static_cast<int64_t>(b) * sh.Sk + k0 + j) * sh.Hkv + hk) * D;
#pragma unroll
  for (int i = 0; i < T::CPT; ++i) {
    const int ch = cl + T::TPR * i;
    *reinterpret_cast<float4*>(dk + at + ch * 4) = acc_k[i];
    *reinterpret_cast<float4*>(dv + at + ch * 4) = acc_v[i];
  }
}

// dQ of one tile of kBR rows of KV head blockIdx.y, batch blockIdx.z (the
// latest rows, which see the most keys, first): every key the rows may
// see, in tiles of kBK keys. Thread t sums row t / TPR.
template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Shape sh) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBK * T::LD;
  float* q_s = v_s + kBK * T::LD;
  float* do_s = q_s + kBR * T::LD;
  float* p_s = do_s + kBR * T::LD;
  float* ds_s = p_s + kBR * T::LDP;
  float* lse_s = ds_s + kBR * T::LDP;
  float* delta_s = lse_s + kBR;
  const int R0 = (gridDim.x - 1 - blockIdx.x) * kBR;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int off = sh.Sk - sh.Sq;
  stage_rows<D>(q, dout, q_s, do_s, lse, delta, lse_s, delta_s, b, hk, R0,
                sh);
  const int rows = sh.Sq * sh.G;
  const int pos_lo = R0 / sh.G;
  const int pos_hi = (min(R0 + kBR, rows) - 1) / sh.G;
  int k_lo = 0, k_hi = sh.Sk;                    // [k_lo, k_hi)
  if (sh.causal) k_hi = min(sh.Sk, pos_hi + off + 1);
  if (sh.window > 0) k_lo = max(0, pos_lo + off - sh.window + 1);
  const int r = threadIdx.x / T::TPR;
  const int cl = threadIdx.x % T::TPR;
  float4 acc[T::CPT];
#pragma unroll
  for (int i = 0; i < T::CPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();        // the last tile's keys are read
    stage_keys<D>(k, v, k_s, v_s, b, hk, k0, sh);
    __syncthreads();
    probs<D>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, R0, k0, sh);
    __syncthreads();
#pragma unroll 4      // unrolled by 2, D 256 spilled 16 bytes
    for (int j = 0; j < kBK; ++j) {
      const float ds = ds_s[r * T::LDP + j];
#pragma unroll
      for (int i = 0; i < T::CPT; ++i)
        fma4(acc[i], ds, lds4(k_s + j * T::LD + (cl + T::TPR * i) * 4));
    }
  }
  const int R = R0 + r;
  if (R >= rows) return;
  const int64_t at = ((static_cast<int64_t>(b) * sh.Sq + R / sh.G) * sh.Hq +
                      hk * sh.G + R % sh.G) * D;
#pragma unroll
  for (int i = 0; i < T::CPT; ++i)
    *reinterpret_cast<float4*>(dq + at + (cl + T::TPR * i) * 4) = acc[i];
}


// ---- the tensor-core kernels (D 16, 64, 128) ------------------------------

constexpr int kKeys = 64;                  // keys of a dK/dV block
constexpr int kKVThreads = 256;            // two warpgroups, 16 keys a warp
constexpr int kRows = 128;                 // rows of a dQ block
constexpr int kQThreads = 256;             // two warpgroups, 16 rows a warp
constexpr int kQBK = 16;                   // keys per dQ tile

constexpr int kRowTile = 32;               // rows per dK/dV tile

// Float offset of 16-byte chunk ch of row r of a natural-layout tile (D
// floats a row). Chunks are permuted within each 8-chunk (32-float) group
// by the row: ch ^ 2·t(r), t(r) = (r / 2 + 2 (r & 1)) mod 4. Then the
// quarter-warp reading chunks 4j..4j+3 of rows 2i and 2i + 1 (mma.sync
// fragments) hits every bank once, and so does the warp reading 8
// consecutive columns of rows {0, 2, 4, 6} or {1, 3, 5, 7} (+8j) to build
// the core-matrix layout. At D 16 a row is one 16-float block and rows are
// 16 banks apart: no permutation.
template <int D>
__device__ __forceinline__ int nat_at(int r, int ch) {
  if constexpr (D < 32) {
    return r * D + (ch << 2);
  } else {
    const int t = ((r >> 1) + 2 * (r & 1)) & 3;
    return r * D + ((ch ^ (t << 1)) << 2);
  }
}

// Row (or key) of slot `slot` of a core-matrix tile: slot k' of each 8-row
// step holds row k' < 4 ? 2k' : 2(k' - 4) + 1, the order of the A
// fragment's columns made from an mma.sync accumulator.
__device__ __forceinline__ int row_of_slot(int slot) {
  const int s8 = slot & 7;
  return (slot & ~7) + (s8 < 4 ? 2 * s8 : 2 * (s8 - 4) + 1);
}

__device__ __forceinline__ uint4 ldu4(const float* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The wgmma B operand (K-major: n = d, k = the tile's RT rows in slot
// order) of an RT x D natural tile `nat`, hi and lo, in 8 x 4 core
// matrices: core matrix cm = (RT / 4)·(d / 8) + k4 holds d 8·(d / 8) + i
// and slots 4·k4 + qq at 32·cm + 4i + qq, written by lane 4i + qq of the
// warps in turn (conflict-free). `warps` warps share the work.
template <int D, int RT>
__device__ __forceinline__ void to_core(const float* nat, float* hi,
                                        float* lo, int warp, int warps,
                                        int lane) {
  constexpr int CMS = (RT / 4) * (D / 8);
  for (int cm = warp; cm < CMS; cm += warps) {
    const int d = 8 * (cm / (RT / 4)) + (lane >> 2);
    const int r = row_of_slot(4 * (cm % (RT / 4)) + (lane & 3));
    uint32_t h, l;
    split(nat[nat_at<D>(r, d >> 2) + (d & 3)], h, l);
    reinterpret_cast<uint32_t*>(hi)[cm * 32 + lane] = h;
    reinterpret_cast<uint32_t*>(lo)[cm * 32 + lane] = l;
  }
}

// Split an RT x D natural tile in place into its hi part, its lo part into
// `lo` at the same offsets.
template <int D, int RT>
__device__ __forceinline__ void split_tile(float* nat, float* lo, int tid,
                                           int threads) {
  for (int i = tid; i < RT * D / 4; i += threads) {
    const int at = nat_at<D>(i / (D / 4), i % (D / 4));
    const float4 x = *reinterpret_cast<const float4*>(nat + at);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(nat + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The two k-steps of 16-column block kb of A rows ra and rb (a warp's 16
// rows g and g + 8) from a raw natural tile, split: k-step s takes column
// c at d 16kb + 4c + 2s and column c + 4 at 4c + 2s + 1.
template <int D>
__device__ __forceinline__ void a_frags(const float* nat, int ra, int rb,
                                        int ch, uint32_t (&ah)[2][4],
                                        uint32_t (&al)[2][4]) {
  const float4 a = *reinterpret_cast<const float4*>(nat + nat_at<D>(ra, ch));
  const float4 b = *reinterpret_cast<const float4*>(nat + nat_at<D>(rb, ch));
  split(a.x, ah[0][0], al[0][0]); split(b.x, ah[0][1], al[0][1]);
  split(a.y, ah[0][2], al[0][2]); split(b.y, ah[0][3], al[0][3]);
  split(a.z, ah[1][0], al[1][0]); split(b.z, ah[1][1], al[1][1]);
  split(a.w, ah[1][2], al[1][2]); split(b.w, ah[1][3], al[1][3]);
}

// acc (16 x 8) += A (16 x 16 columns of block kb) · B, B's 8 rows n·8 + g
// of a split natural tile (hi at `bh`, lo at `bl`): lo·hi, hi·lo, hi·hi,
// each k-step into its own accumulator (acc[s]), so a warp keeps twice as
// many independent mma chains in flight; the caller adds the two.
template <int D>
__device__ __forceinline__ void mma3(float (&acc)[2][4],
                                     const uint32_t (&ah)[2][4],
                                     const uint32_t (&al)[2][4],
                                     const float* bh, const float* bl, int row,
                                     int ch) {
  const uint4 h = ldu4(bh + nat_at<D>(row, ch));
  const uint4 l = ldu4(bl + nat_at<D>(row, ch));
  mma_tf32(acc[0], al[0], h.x, h.y);
  mma_tf32(acc[1], al[1], h.z, h.w);
  mma_tf32(acc[0], ah[0], l.x, l.y);
  mma_tf32(acc[1], ah[1], l.z, l.w);
  mma_tf32(acc[0], ah[0], h.x, h.y);
  mma_tf32(acc[1], ah[1], h.z, h.w);
}

// The A fragment (hi, lo) of an 8-row k-step of wgmma from an mma.sync
// accumulator tile x (rows g, g + 8; columns 2c, 2c + 1 of the step).
__device__ __forceinline__ void acc_frag(const float (&x)[4], uint32_t (&h)[4],
                                         uint32_t (&l)[4]) {
  split(x[0], h[0], l[0]);
  split(x[2], h[1], l[1]);
  split(x[1], h[2], l[2]);
  split(x[3], h[3], l[3]);
}

template <int D>
struct KV {
  static constexpr int RT = kRowTile;
  static constexpr int NR = RT / 8;         // 8-row n-tiles of Sᵀ, k-steps
  static constexpr int TILE = RT * D;
  // The Pᵀ exchange takes Q lo's place where it fits (D >= 64), else its
  // own.
  static constexpr bool P_IN_QLO = kKeys * RT <= TILE;
  // K, V (raw); two stages of Q and dO (split in place); Q lo, dO lo; Q
  // and dO hi, lo in core layout; two stages of lse and delta; [Pᵀ].
  // 229,888 bytes at D 128.
  static constexpr size_t SMEM_FLOATS =
      2 * static_cast<size_t>(kKeys) * D + 10 * static_cast<size_t>(TILE) +
      4 * RT + (P_IN_QLO ? 0 : static_cast<size_t>(kKeys) * RT);
};

// dK and dV of kKeys keys of KV head blockIdx.y, batch blockIdx.x, key tile
// blockIdx.z (the earliest, which most rows see, first): every row tile of
// RT (position, head) rows that may see one of them. Warpgroup 0 computes
// Sᵀ, Pᵀ and dV; warpgroup 1, over the same keys, dPᵀ, then dSᵀ from the Pᵀ
// that warpgroup 0 leaves in shared memory, and dK.
//
// Summation: wgmma adds each product into its f32 accumulator with the
// sum cut (rounded toward zero) to f32, which over the 8,192 rows of a key
// at S 1,024 and G 8 moved dV by 1e-4 of its scale; so each row tile's
// products go into a zeroed partial sum, which is then added into the
// total with round-to-nearest f32 adds.
template <int D>
__global__ void __launch_bounds__(kKVThreads, 1)
    flash_bwd_dkdv_tc(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      Shape sh) {
  using T = KV<D>;
  constexpr int RT = T::RT;
  constexpr int NR = T::NR;
  constexpr int C4 = D / 4;
  constexpr int NT = D / 8;
  extern __shared__ __align__(128) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kKeys * D;
  float* st_s = v_s + kKeys * D;           // stage s: Q at 2s·TILE, dO after
  float* qlo = st_s + 4 * T::TILE;
  float* dlo = qlo + T::TILE;
  float* qth = dlo + T::TILE;
  float* qtl = qth + T::TILE;
  float* dth = qtl + T::TILE;
  float* dtl = dth + T::TILE;
  float* lse_s = dtl + T::TILE;            // [2][RT]
  float* dl_s = lse_s + 2 * RT;            // [2][RT]
  // Pᵀ, [NR·4][128] by thread, once Sᵀ has read Q lo
  float* p_s = T::P_IN_QLO ? qlo : dl_s + 2 * RT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;                // 0: Sᵀ, Pᵀ, dV; 1: dPᵀ, dSᵀ, dK
  const int g = lane >> 2;
  const int c = lane & 3;
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;
  const int off = sh.Sk - sh.Sq;
  const int rows = sh.Sq * sh.G;

  // rows that may see a key of [k0, k0 + kKeys)
  int p_lo = 0, p_hi = sh.Sq;
  if (sh.causal) p_lo = max(0, k0 - off);
  if (sh.window > 0)
    p_hi = min(sh.Sq, max(0, k0 + kKeys - 1 + sh.window - off));
  const int R_lo = p_lo * sh.G;
  const int nt = p_hi > p_lo ? (p_hi * sh.G - R_lo + RT - 1) / RT : 0;

  float acc[NT][4];                        // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  auto fetch_rows = [&](int i, int stage) {
    float* qs = st_s + 2 * stage * T::TILE;
    float* ds = qs + T::TILE;
    const int R0 = R_lo + i * RT;
    for (int j = tid; j < 2 * RT * C4; j += kKVThreads) {
      const int is_do = j / (RT * C4);
      const int r = (j % (RT * C4)) / C4;
      const int ch = j % C4;
      const int R = R0 + r;
      const bool in = R < rows;
      const int Rc = in ? R : 0;
      const int64_t at =
          ((static_cast<int64_t>(b) * sh.Sq + Rc / sh.G) * sh.Hq + hk * sh.G +
           Rc % sh.G) * D + ch * 4;
      cp_async16((is_do ? ds : qs) + nat_at<D>(r, ch),
                 (is_do ? dout : q) + at, in);
    }
    if (tid < 2 * RT) {
      const int rr = tid % RT;
      const int R = R0 + rr;
      const bool in = R < rows;
      const int Rc = in ? R : 0;
      const int64_t at = (static_cast<int64_t>(b) * sh.Hq + hk * sh.G +
                          Rc % sh.G) * sh.Sq + Rc / sh.G;
      if (tid < RT) cp_async4(lse_s + stage * RT + rr, lse + at, in);
      else cp_async4(dl_s + stage * RT + rr, delta + at, in);
    }
  };

  if (nt > 0) {
    for (int j = tid; j < 2 * kKeys * C4; j += kKVThreads) {
      const int is_v = j / (kKeys * C4);
      const int r = (j % (kKeys * C4)) / C4;
      const int ch = j % C4;
      const bool in = k0 + r < sh.Sk;
      const int64_t at = ((static_cast<int64_t>(b) * sh.Sk +
                           (in ? k0 + r : 0)) * sh.Hkv + hk) * D + ch * 4;
      cp_async16((is_v ? v_s : k_s) + nat_at<D>(r, ch), (is_v ? v : k) + at,
                 in);
    }
    fetch_rows(0, 0);
  }
  cp_async_commit();

  const int kw0 = k0 + 16 * (warp & 3);    // this warp's first key
  const int kr0 = 16 * (warp & 3) + g;     // its rows of K, V: kr0, kr0 + 8
  const int slot = (warp & 3) * 32 + lane; // its column of the Pᵀ exchange

  for (int i = 0; i < nt; ++i) {
    const int stage = i & 1;
    cp_async_wait<0>();
    __syncthreads();          // tile i landed; tile i - 1 fully consumed
    if (i + 1 < nt) fetch_rows(i + 1, stage ^ 1);
    cp_async_commit();
    float* qs = st_s + 2 * stage * T::TILE;
    float* ds = qs + T::TILE;
    to_core<D, RT>(qs, qth, qtl, warp, 8, lane);
    to_core<D, RT>(ds, dth, dtl, warp, 8, lane);
    __syncthreads();          // raw tiles read: split them in place
    split_tile<D, RT>(qs, qlo, tid, kKVThreads);
    split_tile<D, RT>(ds, dlo, tid, kKVThreads);
    fence_to_async();
    __syncthreads();

    const int R0 = R_lo + i * RT;
    const int pos_lo = R0 / sh.G;
    const int pos_hi = (min(R0 + RT, rows) - 1) / sh.G;
    bool skip = kw0 >= sh.Sk;
    if (sh.causal && kw0 > pos_hi + off) skip = true;
    if (sh.window > 0 && kw0 + 15 <= pos_lo + off - sh.window) skip = true;
    const bool all_in = R0 + RT <= rows && kw0 + 16 <= sh.Sk &&
                        (!sh.causal || kw0 + 15 <= pos_lo + off) &&
                        (sh.window <= 0 || kw0 > pos_hi + off - sh.window);
    // Sᵀ (keys x rows) on warpgroup 0, dPᵀ on warpgroup 1; x[n][e] is key
    // kw0 + g + 8 (e >> 1), tile row 8n + 2c + (e & 1)
    float x[NR][4];
    {
      float x2[NR][2][4];
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x2[n][0][e] = x2[n][1][e] = 0.f;
      if (!skip) {
        const float* a_s = wg ? v_s : k_s;
        const float* bh = wg ? ds : qs;
        const float* bl = wg ? dlo : qlo;
#pragma unroll 2
        for (int kb = 0; kb < D / 16; ++kb) {
          const int ch = kb * 4 + c;
          uint32_t ah[2][4], al[2][4];
          a_frags<D>(a_s, kr0, kr0 + 8, ch, ah, al);
#pragma unroll
          for (int n = 0; n < NR; ++n)
            mma3<D>(x2[n], ah, al, bh, bl, 8 * n + g, ch);
        }
      }
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[n][e] = x2[n][0][e] + x2[n][1][e];
    }
    if (wg == 0) {            // Pᵀ, to registers and to the exchange
      // every warp of warpgroup 0 has read Q lo: it takes Pᵀ now
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = 8 * n + 2 * c + h;
          const int R = R0 + rr;
          const int qpos = R / sh.G + off;
          const float l = lse_s[stage * RT + rr];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int e = 2 * e2 + h;
            const int key = kw0 + g + 8 * e2;
            const bool ok =
                !skip && (all_in || (R < rows && key < sh.Sk &&
                                     (!sh.causal || key <= qpos) &&
                                     (sh.window <= 0 ||
                                      key > qpos - sh.window)));
            x[n][e] = ok ? __expf(x[n][e] * sh.scale - l) : 0.f;
            p_s[(4 * n + e) * 128 + slot] = x[n][e];
          }
        }
    }
    __syncthreads();          // Pᵀ exchanged
    if (wg == 1) {            // dSᵀ = Pᵀ (dPᵀ - delta) scale
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dl = dl_s[stage * RT + 8 * n + 2 * c + (e & 1)];
          x[n][e] = p_s[(4 * n + e) * 128 + slot] * (x[n][e] - dl) *
                    sh.scale;
        }
    }

    // this tile's dV += Pᵀ dO (warpgroup 0) or dK += dSᵀ Q (1), on the
    // warpgroup: A from registers, B (dO or Q in core layout) from shared
    // memory, into a zeroed partial sum
    uint32_t xh[NR][4], xl[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j) acc_frag(x[j], xh[j], xl[j]);
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    const float* b_hi = wg ? qth : dth;
    const float* b_lo = wg ? qtl : dtl;
    pin<D>(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const uint64_t dh = core_desc(b_hi + 64 * j, 128, RT * 32);
      const uint64_t dlo_ = core_desc(b_lo + 64 * j, 128, RT * 32);
      wgmma<D>(part, xl[j], dh);
      wgmma<D>(part, xh[j], dlo_);
      wgmma<D>(part, xh[j], dh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<D>(part);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      pin_a(xh[j]); pin_a(xl[j]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
  cp_async_wait<0>();

  // acc[n][e]: key kr0 + 8 (e >> 1) of the block, d 8n + 2c + (e & 1)
  float* out = wg ? dk : dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr0 + 8 * h;
    if (key >= sh.Sk) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * sh.Sk + key) * sh.Hkv + hk) * D + 2 * c;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(out + at + 8 * n) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <int D>
struct QT {
  static constexpr int KT = kQBK * D;       // floats of a K or V tile
  // Q, dO (raw); two stages of a K and a V tile (split in place); K lo,
  // V lo; K hi, lo in core layout
  static constexpr size_t SMEM_FLOATS =
      2 * static_cast<size_t>(kRows) * D + 8 * static_cast<size_t>(KT);
};

// dQ of 128 rows (as the forward's blocks: Gb heads of KV head hk at
// PB = 128 / Gb positions) of batch blockIdx.x, head group blockIdx.y,
// query tile gridDim.z - 1 - blockIdx.z (the latest, which see the most
// keys, first): every key tile of kQBK keys the rows may see.
template <int D>
__global__ void __launch_bounds__(kQThreads, 1)
    flash_bwd_dq_tc(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Shape sh, int Gb) {
  using T = QT<D>;
  constexpr int C4 = D / 4;
  constexpr int NT = D / 8;
  extern __shared__ __align__(128) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kRows * D;
  float* kv_s = do_s + kRows * D;          // stage s: K at 2s·KT, V after
  float* klo = kv_s + 4 * T::KT;
  float* vlo = klo + T::KT;
  float* kth = vlo + T::KT;
  float* ktl = kth + T::KT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int PB = kRows / Gb;
  const int p0 = (static_cast<int>(gridDim.z) - 1 -
                  static_cast<int>(blockIdx.z)) * PB;
  const int groups = (sh.G + Gb - 1) / Gb;
  const int hk = blockIdx.y / groups;
  const int hg0 = (blockIdx.y % groups) * Gb;
  const int b = blockIdx.x;
  const int off = sh.Sk - sh.Sq;
  const int64_t q_row = static_cast<int64_t>(sh.Hq) * D;
  const int64_t kv_row = static_cast<int64_t>(sh.Hkv) * D;
  const int64_t kv_base = static_cast<int64_t>(b) * sh.Sk * kv_row +
                          static_cast<int64_t>(hk) * D;

  auto row_ok = [&](int r) {
    return r < PB * Gb && hg0 + r % Gb < sh.G && p0 + r / Gb < sh.Sq;
  };
  auto row_offset = [&](int r) {
    return (static_cast<int64_t>(b) * sh.Sq + p0 + r / Gb) * q_row +
           static_cast<int64_t>(hk * sh.G + hg0 + r % Gb) * D;
  };
  auto row_stat = [&](int r) {
    return (static_cast<int64_t>(b) * sh.Hq + hk * sh.G + hg0 + r % Gb) *
               sh.Sq + p0 + r / Gb;
  };

  // key tiles the rows may see
  const int p_last = min(p0 + PB, sh.Sq) - 1;
  int k_lo = 0, k_hi = sh.Sk;
  if (sh.causal) k_hi = min(sh.Sk, p_last + off + 1);
  if (sh.window > 0) k_lo = max(0, p0 + off - sh.window + 1);
  const int t_lo = k_lo / kQBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kQBK - 1) / kQBK : t_lo;

  auto fetch = [&](int t, int stage) {
    float* ks = kv_s + 2 * stage * T::KT;
    const int kt0 = t * kQBK;
    for (int j = tid; j < 2 * kQBK * C4; j += kQThreads) {
      const int is_v = j / (kQBK * C4);
      const int r = (j % (kQBK * C4)) / C4;
      const int ch = j % C4;
      const bool in = kt0 + r < sh.Sk;
      const int64_t at =
          kv_base + static_cast<int64_t>(in ? kt0 + r : 0) * kv_row + ch * 4;
      cp_async16((is_v ? ks + T::KT : ks) + nat_at<D>(r, ch),
                 (is_v ? v : k) + at, in);
    }
  };

  for (int j = tid; j < 2 * kRows * C4; j += kQThreads) {
    const int is_do = j / (kRows * C4);
    const int r = (j % (kRows * C4)) / C4;
    const int ch = j % C4;
    const bool in = row_ok(r);
    cp_async16((is_do ? do_s : q_s) + nat_at<D>(r, ch),
               (is_do ? dout : q) + (in ? row_offset(r) : 0) + ch * 4, in);
  }
  if (t_lo < t_hi) fetch(t_lo, 0);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const bool ok0 = row_ok(r0);
  const bool ok1 = row_ok(r1);
  const float lse0 = ok0 ? lse[row_stat(r0)] : 1e30f;
  const float lse1 = ok1 ? lse[row_stat(r1)] : 1e30f;
  const float dl0 = ok0 ? delta[row_stat(r0)] : 0.f;
  const float dl1 = ok1 ? delta[row_stat(r1)] : 0.f;
  const int qp0 = p0 + r0 / Gb + off;
  const int qp1 = p0 + r1 / Gb + off;
  const bool warp_live = __any_sync(0xffffffffu, ok0 || ok1);
  const bool warp_full = __all_sync(0xffffffffu, ok0 && ok1);
  const int wq_lo = p0 + (warp * 16) / Gb + off;
  const int wq_hi = min(p0 + (warp * 16 + 15) / Gb, sh.Sq - 1) + off;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < t_hi) fetch(t + 1, stage ^ 1);
    cp_async_commit();
    float* ks = kv_s + 2 * stage * T::KT;
    float* vs = ks + T::KT;
    to_core<D, kQBK>(ks, kth, ktl, warp, kQThreads / 32, lane);
    __syncthreads();
    split_tile<D, kQBK>(ks, klo, tid, kQThreads);
    split_tile<D, kQBK>(vs, vlo, tid, kQThreads);
    fence_to_async();
    __syncthreads();

    const int kt0 = t * kQBK;
    const bool all_in = warp_full && kt0 + kQBK <= sh.Sk &&
                        (!sh.causal || kt0 + kQBK - 1 <= wq_lo) &&
                        (sh.window <= 0 || kt0 > wq_hi - sh.window);
    bool skip = !warp_live;
    if (sh.causal && kt0 > wq_hi) skip = true;
    if (sh.window > 0 && kt0 + kQBK - 1 <= wq_lo - sh.window) skip = true;
    // S (rows x keys) and dP, then dS in S's place
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if (!skip) {
      float s2[2][2][4], dp2[2][2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s2[n][0][e] = s2[n][1][e] = dp2[n][0][e] = dp2[n][1][e] = 0.f;
#pragma unroll 2
      for (int kb = 0; kb < D / 16; ++kb) {
        const int ch = kb * 4 + c;
        uint32_t ah[2][4], al[2][4];
        a_frags<D>(q_s, r0, r1, ch, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma3<D>(s2[n], ah, al, ks, klo, 8 * n + g, ch);
        a_frags<D>(do_s, r0, r1, ch, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma3<D>(dp2[n], ah, al, vs, vlo, 8 * n + g, ch);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = s2[n][0][e] + s2[n][1][e];
          dp[n][e] = dp2[n][0][e] + dp2[n][1][e];
        }
      // s[n][e]: row e < 2 ? r0 : r1, key kt0 + 8n + 2c + (e & 1)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kt0 + n * 8 + 2 * c + (e & 1);
          const int qpos = e < 2 ? qp0 : qp1;
          const bool ok = all_in || ((e < 2 ? ok0 : ok1) && kpos < sh.Sk &&
                                     (!sh.causal || kpos <= qpos) &&
                                     (sh.window <= 0 ||
                                      kpos > qpos - sh.window));
          const float p =
              ok ? __expf(s[n][e] * sh.scale - (e < 2 ? lse0 : lse1)) : 0.f;
          s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * sh.scale;
        }
    }

    // dQ += dS K on the warpgroup: dS from registers, K (core layout) from
    // shared memory
    uint32_t dh[2][4], dl[2][4];
    acc_frag(s[0], dh[0], dl[0]);
    acc_frag(s[1], dh[1], dl[1]);
    float part[NT][4];        // this tile's, summed as in the dK/dV kernel
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    pin<D>(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint64_t kh = core_desc(kth + 64 * j, 128, kQBK * 32);
      const uint64_t kl = core_desc(ktl + 64 * j, 128, kQBK * 32);
      wgmma<D>(part, dl[j], kh);
      wgmma<D>(part, dh[j], kl);
      wgmma<D>(part, dh[j], kh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<D>(part);
    pin_a(dh[0]); pin_a(dh[1]); pin_a(dl[0]); pin_a(dl[1]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
  cp_async_wait<0>();

  // acc[n][e]: row e < 2 ? r0 : r1, d 8n + 2c + (e & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!(h ? ok1 : ok0)) continue;
    const int64_t at = row_offset(h ? r1 : r0) + 2 * c;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dq + at + 8 * n) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t launch_delta(const float* o, const float* dout, float* delta,
                         int B, const Shape& sh, int D, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * sh.Sq * sh.Hq;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                           stream>>>(o, dout, delta, rows, sh.Sq, sh.Hq, D);
  return cudaGetLastError();
}

// D 256: the scalar kernels.
template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* delta, float* dq, float* dk, float* dv, int B,
               const Shape& sh, cudaStream_t stream) {
  using T = Tile<D>;
  const size_t smem = T::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, smem);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err == cudaSuccess) err = launch_delta(o, dout, delta, B, sh, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sh.Sk > 0) {
    const dim3 grid_k((sh.Sk + kBK - 1) / kBK, sh.Hkv, B);
    flash_bwd_dkdv_kernel<D><<<grid_k, T::THREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_q((sh.Sq * sh.G + kBR - 1) / kBR, sh.Hkv, B);
  flash_bwd_dq_kernel<D><<<grid_q, T::THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, sh);
  return static_cast<int>(cudaGetLastError());
}

// D 16, 64, 128: the tensor-core kernels.
template <int D>
int launch_tc(const float* q, const float* k, const float* v,
              const float* o, const float* dout, const float* lse,
              float* delta, float* dq, float* dk, float* dv, int B,
              const Shape& sh, cudaStream_t stream) {
  const size_t smem_kv = KV<D>::SMEM_FLOATS * sizeof(float);
  const size_t smem_q = QT<D>::SMEM_FLOATS * sizeof(float);
  const int Gb = sh.G < kRows ? sh.G : kRows;
  const int groups = (sh.G + Gb - 1) / Gb;
  const int nq = (sh.Sq + kRows / Gb - 1) / (kRows / Gb);
  const int nk = (sh.Sk + kKeys - 1) / kKeys;
  if (smem_kv > kMaxDynamicSmem || smem_q > kMaxDynamicSmem ||
      static_cast<int64_t>(sh.Hkv) * groups > 65535 || nq > 65535 ||
      nk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_bwd_dkdv_tc<D>, smem_kv);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_tc<D>, smem_q);
  if (err == cudaSuccess) err = launch_delta(o, dout, delta, B, sh, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nk > 0) {
    flash_bwd_dkdv_tc<D><<<dim3(B, sh.Hkv, nk), kKVThreads, smem_kv,
                           stream>>>(q, k, v, dout, lse, delta, dk, dv, sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_bwd_dq_tc<D><<<dim3(B, sh.Hkv * groups, nq), kQThreads, smem_q,
                       stream>>>(q, k, v, dout, lse, delta, dq, sh, Gb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// delta: (B, Hq, Sq) f32 scratch from the caller. window 0: none.
extern "C" int meili_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
    int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{Sq, Sk, Hq, Hkv, Hq / Hkv, causal, window, scale};
  if (static_cast<int64_t>(Sq) * sh.G > 0x7fffffffLL - kBR)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(o);
  const float* fd = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float* fdl = static_cast<float*>(delta);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  switch (D) {
    case 16:
      return launch_tc<16>(fq, fk, fv, fo, fd, fl, fdl, gq, gk, gv, B, sh, s);
    case 64:
      return launch_tc<64>(fq, fk, fv, fo, fd, fl, fdl, gq, gk, gv, B, sh, s);
    case 128:
      return launch_tc<128>(fq, fk, fv, fo, fd, fl, fdl, gq, gk, gv, B, sh,
                            s);
    case 256:
      return launch_bwd<256>(fq, fk, fv, fo, fd, fl, fdl, gq, gk, gv, B, sh,
                             s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
