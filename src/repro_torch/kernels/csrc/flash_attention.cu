// Blocked causal / sliding-window GQA attention, forward — B5 of the port.
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel` /
// `flash_attention`. The TPU kernel walks a sequential (bh, q-block,
// kv-block) grid and carries the running (max, sum, acc) in VMEM scratch
// from one kv step to the next. Here one block owns 128 query rows and
// walks its key tiles in a loop, keeping the running triple in registers;
// nothing carries between blocks.
//
// What bounds it on the H100: operations. At the prefill shapes (B 4,
// S 1,024, 4 query heads over 1 KV head, D 256) a layer moves ~13 MB but
// does 4·D flops per unmasked query-key pair (6.4-8.6 GFLOP). f32-accurate
// products run on the tensor cores as 3xTF32 (tf32x3.cuh), so the bound is
// a third of the TF32 rate, 165 TFLOP/s.
//
// What the design does about it:
// - Every product is f32-accurate 3xTF32 (tf32x3.cuh): each f32 operand is
//   split into TF32 hi and lo parts and hi·hi + hi·lo + lo·hi is summed in
//   f32. QKᵀ runs on mma.sync (m16n8k8, a warp's 16 rows); PV runs on
//   wgmma (m64nDk8, a warpgroup's 64 rows), with P from registers and Vᵀ
//   from shared memory, so V is neither loaded nor split by every warp.
// - A block's 128 rows are (query position, query head) pairs of ONE KV
//   head: the G query heads that share it are folded into the rows (G 4:
//   32 positions x 4 heads), so each K/V tile is read once for all of them.
//   8 warps, 2 warpgroups, own 16 rows each.
// - Q (pre-scaled) stays in shared memory; 16-key K and V tiles are double
//   buffered and fetched with cp.async (16 B per thread), so tile t + 1
//   arrives while tile t is multiplied. One barrier both publishes tile t
//   and frees tile t - 1's stage for the next fetch. Once a tile has
//   landed, the block splits it once: K in place into its hi part plus a
//   lo tile; V into Vᵀ hi (over the landed rows) and lo in the K-major
//   8 x 4 core matrices that wgmma reads. At D 256: Q 128 KB, two stages
//   65 KB, the lo tiles 32 KB; 229,888 B in all.
// - QKᵀ's fragment reads are 128-bit loads free of bank conflicts: the
//   depth index is permuted within each 16-column block (A column c of
//   k-step s <-> d = 4c + 2s, column c + 4 <-> 4c + 2s + 1, K alike), and
//   Q and K rows swap 16-byte chunk halves on odd rows. mma.sync has a
//   latency of tens of cycles and a warp issues in order, so QKᵀ spreads
//   its sums over eight accumulators (hi·hi apart from the cross terms,
//   each k-step of a 16-column block apart) and issues pass by pass.
// - P never leaves registers: the accumulator of QKᵀ holds keys 2c and
//   2c + 1 of rows g and g + 8, and the A operand of PV wants columns c and
//   c + 4. PV's key order is permuted instead (A column c <-> key 2c,
//   column c + 4 <-> key 2c + 1, and Vᵀ's key slots likewise), so the
//   accumulator IS the A fragment, with no shuffle and no staging.
// - Key tiles outside the block's causal/window band are never fetched, a
//   warp whose rows see none of a tile's keys skips its QKᵀ, and tiles
//   inside every row of a warp's band skip the mask. The query
//   tiles launch longest first; when the longest would set the time (the
//   causal grid), the wrapper cuts their key ranges over several blocks
//   (kmax tiles at most) and a second kernel combines the parts.
// Masked probabilities are multiplied by 0 as the Pallas kernel does, so a
// row with no valid key yields 0, never exp(NEG_INF - NEG_INF) = 1. For
// training the caller may ask for each row's log-sum-exp of its scaled
// logits, lse (B, Hq, Sq) f32, 1e30 for a row with no valid key as in the
// reference's `_attention_blocked_fwd`; the backward (flash_attention_bwd.cu)
// recomputes the probabilities from it. Ragged
// Sq and Sk tails are masked (keys past Sk are zero-filled).
//
// Two instances. The bf16 one (`flash_fwd_bf16_kernel`, below) serves q, k
// and v all bf16 at D 128, every bf16 config's pairing: its products are
// exact bf16 wgmma, its tiles 64 keys. The f32 one (`flash_fwd_kernel`)
// serves every other pairing, f32 at any head dim, f32 q over bf16 k/v and
// bf16 at D 16, 64 and 256: there K and V are f32 (the wrapper widens bf16
// ones, exactly) and Q f32 or bf16.
#include "wgmma_bf16.cuh"

namespace {

using meili::core_desc;
using meili::cp_async16;
using meili::cp_async_commit;
using meili::cp_async_wait;
using meili::fence_to_async;
using meili::load4;
using meili::mma_tf32;
using meili::pin;
using meili::pin_a;
using meili::split;
using meili::split_bf16;
using meili::wgmma;
using meili::wgmma_bf16_n128_mn;
using meili::wgmma_bf16_n32_ss;
using meili::wgmma_commit;
using meili::wgmma_fence;
using meili::wgmma_wait;

constexpr int kRows = 128;      // (position, head) rows per block
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 16;         // keys per tile
constexpr int kQKSplit = 2;     // QKᵀ accumulator sets (see below)
constexpr float kNegInf = -1e30f;
constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB on sm_90

// Q rows; two stages of a K tile and a V tile (rows of D + 4 floats); the
// current tile's K lo and Vᵀ lo.
template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kRows) * D +
         2 * (static_cast<size_t>(kBK) * D + kBK * (D + 4)) +
         2 * static_cast<size_t>(kBK) * D;
}

// Float offset of 16-byte chunk q of row r of Q or K (read as rows g and
// g + 1 by 4 lanes each): odd rows swap chunk halves. At D 16 a row is one
// 16-column block, and rows of 64 bytes already put rows g and g + 1 on
// different banks: no swap.
template <int D>
__device__ __forceinline__ int qk_at(int r, int q) {
  if constexpr (D < 32) return r * D + (q << 2);
  else return r * D + ((q ^ ((r & 1) << 2)) << 2);
}

// Key tiles [t_lo, t_hi) of BK keys that query positions [p0, p0 + PB)
// may see.
template <int BK = kBK>
__device__ inline void key_tiles(int p0, int PB, int Sq, int Sk,
                                 int causal, int window, int& t_lo,
                                 int& t_hi) {
  const int off = Sk - Sq;
  const int p_last = min(p0 + PB, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, p_last + off + 1);
  if (window > 0) k_lo = max(0, p0 + off - window + 1);
  t_lo = k_lo / BK;
  t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;
}

// A query tile whose key tiles exceed kmax is split over
// ceil(tiles / kmax) blocks of near-equal key ranges.
__device__ inline int key_parts(int tiles, int kmax) {
  return tiles > kmax ? (tiles + kmax - 1) / kmax : 1;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint4 ldu4(const float* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const void* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, void* __restrict__ out,
                     int Sq, int Sk, int Hq, int Hkv, int G, int Gb,
                     int causal, int window, float scale, int q_bf16,
                     int kmax, int max_parts, float* __restrict__ o_part,
                     float* __restrict__ ml_part, float* __restrict__ lse) {
  constexpr int NT = D / 8;     // output n-tiles of a warp
  constexpr int C4 = D / 4;     // 16-byte chunks of a row
  constexpr int TILE = kBK * D; // floats of a K tile
  constexpr int LDV = D + 4;    // V row stride as it lands
  constexpr int STAGE = TILE + kBK * LDV;
  constexpr int CM = D / 16;    // Vᵀ core matrices a warp converts
  extern __shared__ __align__(128) float smem[];
  float* q_s = smem;
  float* kv_s = q_s + kRows * D;          // stage s: K, then V
  float* klo_s = kv_s + 2 * STAGE;        // K lo of the current tile
  float* vlo_s = klo_s + TILE;            // Vᵀ lo of the current tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int PB = kRows / Gb;                  // query positions per block
  // z walks the query tiles heaviest (latest) first, x the batch: blocks
  // launch in x, y, z order, so every batch's long tiles start first.
  const int nq = gridDim.z / max_parts;
  const int p0 = (nq - 1 - static_cast<int>(blockIdx.z) / max_parts) * PB;
  const int part = blockIdx.z % max_parts;
  const int groups = (G + Gb - 1) / Gb;
  const int hk = blockIdx.y / groups;
  const int hg0 = (blockIdx.y % groups) * Gb;
  const int b = blockIdx.x;
  const int off = Sk - Sq;
  const int64_t q_row = static_cast<int64_t>(Hq) * D;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * D;
  const int64_t q_base = static_cast<int64_t>(b) * Sq * q_row;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_row +
                          static_cast<int64_t>(hk) * D;

  // Row r is query position p0 + r / Gb of head hk·G + hg0 + r % Gb.
  auto row_ok = [&](int r) {
    return r < PB * Gb && hg0 + r % Gb < G && p0 + r / Gb < Sq;
  };
  auto row_offset = [&](int r) {
    return q_base + static_cast<int64_t>(p0 + r / Gb) * q_row +
           static_cast<int64_t>(hk * G + hg0 + r % Gb) * D;
  };

  // Keys the block's rows may see; tiles wholly outside are never fetched.
  // A long range is split over `parts` blocks; this one takes part `part`.
  int t_lo, t_hi;
  key_tiles(p0, PB, Sq, Sk, causal, window, t_lo, t_hi);
  const int parts = key_parts(t_hi - t_lo, kmax);
  if (part >= parts) return;
  if (parts > 1) {
    const int len = (t_hi - t_lo + parts - 1) / parts;
    t_lo += part * len;
    t_hi = min(t_hi, t_lo + len);
  }

  // 16-byte copies of a K and a V tile: whole rounds of the block's
  // threads, but for D 16 (half a round).
  constexpr int FETCH = 2 * kBK * C4;
  auto fetch = [&](int t, int stage) {
    float* ks = kv_s + stage * STAGE;
    const int k0 = t * kBK;
#pragma unroll
    for (int it = 0; it < (FETCH + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      if (FETCH % kThreads != 0 && i >= FETCH) break;
      const int is_v = i / (kBK * C4);
      const int r = (i % (kBK * C4)) / C4;
      const int ch = i % C4;
      const bool in = k0 + r < Sk;
      const int64_t idx =
          kv_base + static_cast<int64_t>(in ? k0 + r : 0) * kv_row + ch * 4;
      float* dst = is_v ? ks + TILE + r * LDV + ch * 4 : ks + qk_at<D>(r, ch);
      cp_async16(dst, (is_v ? v : k) + idx, in);
    }
  };

  if (t_lo < t_hi) fetch(t_lo, 0);
  cp_async_commit();

  // Q, pre-scaled, while the first tile is in flight.
  for (int i = tid; i < kRows * C4; i += kThreads) {
    const int r = i / C4;
    const int ch = i % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok(r)) x = load4(q, q_bf16, row_offset(r) + ch * 4);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(&q_s[qk_at<D>(r, ch)]) = x;
  }

  // This thread's rows r0 = 16·warp + g and r1 = r0 + 8.
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const bool ok0 = row_ok(r0);
  const bool ok1 = row_ok(r1);
  const int qp0 = p0 + r0 / Gb + off;
  const int qp1 = p0 + r1 / Gb + off;
  const bool warp_live = __any_sync(0xffffffffu, ok0 || ok1);
  const bool warp_full = __all_sync(0xffffffffu, ok0 && ok1);
  const int wq_lo = p0 + (warp * 16) / Gb + off;
  const int wq_hi = min(p0 + (warp * 16 + 15) / Gb, Sq - 1) + off;

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    cp_async_wait<0>();   // tile t has landed (this thread's copies)
    __syncthreads();      // ... and everyone's, and tile t - 1 is done with
    if (t + 1 < t_hi) fetch(t + 1, stage ^ 1);
    cp_async_commit();

    // Split the tile once. K: hi in place, lo beside it. V: into Vᵀ, the
    // wgmma B operand (K-major: d rows, keys along K) in 8 x 4 core
    // matrices, hi over the landed tile and lo beside it. Core matrix cm =
    // 4·(d / 8) + k4 holds d 8·(d / 8) + r and key slots 4·k4 + qq at
    // 32·cm + 4r + qq (lane 4r + qq writes it, conflict-free); slot k' of
    // 8-key step j holds key 8j + (k' < 4 ? 2k' : 2(k' - 4) + 1), the order
    // of P's A columns.
    float* ks = kv_s + stage * STAGE;
    float* vs = ks + TILE;
#pragma unroll
    for (int it = 0; it < (TILE / 4 + kThreads - 1) / kThreads; ++it) {
      if ((TILE / 4) % kThreads != 0 && tid + it * kThreads >= TILE / 4)
        break;
      const int i = (tid + it * kThreads) * 4;
      const float4 x = lds4(ks + i);
      uint32_t h[4], l[4];
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(ks + i) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(klo_s + i) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
    float vx[CM];
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      const int cm = warp * CM + i;
      const int slot = 4 * (cm & 3) + (lane & 3);     // key slot 0..15
      const int w8 = slot & 7;
      const int key = (slot & 8) + (w8 < 4 ? 2 * w8 : 2 * (w8 - 4) + 1);
      vx[i] = vs[key * LDV + 8 * (cm >> 2) + (lane >> 2)];
    }
    __syncthreads();              // the landed V is read: overwrite it
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      uint32_t h, l;
      split(vx[i], h, l);
      const int at = (warp * CM + i) * 32 + lane;
      reinterpret_cast<uint32_t*>(vs)[at] = h;
      reinterpret_cast<uint32_t*>(vlo_s)[at] = l;
    }
    fence_to_async();             // read next by wgmma
    __syncthreads();

    const int k0 = t * kBK;
    // every key of the tile valid for every row of the warp: no mask
    const bool all_in = warp_full && k0 + kBK <= Sk &&
                        (!causal || k0 + kBK - 1 <= wq_lo) &&
                        (window <= 0 || k0 > wq_hi - window);
    bool skip = !warp_live;
    if (causal && k0 > wq_hi) skip = true;
    if (window > 0 && k0 + kBK - 1 <= wq_lo - window) skip = true;
    // P of this tile: zero for a warp whose rows see none of its keys (the
    // warpgroup's PV product below needs all four warps)
    float s[2][4] = {};
    float alpha0 = 1.f, alpha1 = 1.f;
    if (!skip) {

      // S = Q Kᵀ over 16-column blocks of d: two k-steps, two n-tiles.
      // hi·hi and the two cross terms in separate accumulators, and each
      // of the 16-column block's two k-steps in its own (kQKSplit 2): eight
      // independent mma chains a warp.
      float sm[kQKSplit][2][4], sc[kQKSplit][2][4];
#pragma unroll
      for (int h = 0; h < kQKSplit; ++h)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sm[h][n][e] = sc[h][n][e] = 0.f;
#pragma unroll 2
      for (int kb = 0; kb < D / 16; ++kb) {
        const int ch = kb * 4 + c;
        const float4 qa = lds4(q_s + qk_at<D>(r0, ch));
        const float4 qb = lds4(q_s + qk_at<D>(r1, ch));
        // k-step s: a0 = row r0 at d 4c + 2s, a2 at 4c + 2s + 1; a1, a3
        // the same of row r1.
        uint32_t ah[2][4], al[2][4];
        split(qa.x, ah[0][0], al[0][0]); split(qb.x, ah[0][1], al[0][1]);
        split(qa.y, ah[0][2], al[0][2]); split(qb.y, ah[0][3], al[0][3]);
        split(qa.z, ah[1][0], al[1][0]); split(qb.z, ah[1][1], al[1][1]);
        split(qa.w, ah[1][2], al[1][2]); split(qb.w, ah[1][3], al[1][3]);
        uint32_t kh[2][4], kl[2][4];   // [n]: b0, b1 of k-step 0, then 1
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int at = qk_at<D>(n * 8 + g, ch);
          const uint4 h = ldu4(ks + at);
          const uint4 l = ldu4(klo_s + at);
          kh[n][0] = h.x; kh[n][1] = h.y; kh[n][2] = h.z; kh[n][3] = h.w;
          kl[n][0] = l.x; kl[n][1] = l.y; kl[n][2] = l.z; kl[n][3] = l.w;
        }
        // pass by pass, so consecutive mma are independent
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const int h = st % kQKSplit;
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_tf32(sc[h][n], al[st], kh[n][2 * st], kh[n][2 * st + 1]);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_tf32(sm[h][n], ah[st], kh[n][2 * st], kh[n][2 * st + 1]);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_tf32(sc[h][n], ah[st], kl[n][2 * st], kl[n][2 * st + 1]);
        }
      }
#pragma unroll
      for (int h = 1; h < kQKSplit; ++h)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sm[0][n][e] += sm[h][n][e];
            sc[0][n][e] += sc[h][n][e];
          }

      // Mask, then the online softmax. s[n][e]: row e < 2 ? r0 : r1, key
      // k0 + 8n + 2c + (e & 1).
      bool val[2][4];
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * c + (e & 1);
          const int qpos = e < 2 ? qp0 : qp1;
          val[n][e] = all_in || ((e < 2 ? ok0 : ok1) && kpos < Sk &&
                                 (!causal || kpos <= qpos) &&
                                 (window <= 0 || kpos > qpos - window));
          s[n][e] = val[n][e] ? sm[0][n][e] + sc[0][n][e] : kNegInf;
          if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
          else mx1 = fmaxf(mx1, s[n][e]);
        }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // __expf (ex2.approx of x·log2 e): the exponents are <= 0, and where
      // a weight is near 1 its relative error is a few 2^-24; __expf(0) is
      // exactly 1, so an unchanged max skips the rescale below.
      alpha0 = __expf(m0 - mn0);
      alpha1 = __expf(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              val[n][e] ? __expf(s[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          s[n][e] = p;
          if (e < 2) rs0 += p;
          else rs1 += p;
        }
      // Row sums stay per thread (their 4 key columns of each row) and
      // reduce over the row's 4 lanes at the end: alpha is the same there.
      l0 = alpha0 * l0 + rs0;
      l1 = alpha1 * l1 + rs1;
      m0 = mn0;
      m1 = mn1;
    }
    if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha0; o[n][1] *= alpha0;
        o[n][2] *= alpha1; o[n][3] *= alpha1;
      }
    }

    // O += P V on the warpgroup (64 rows): wgmma with P from registers and
    // Vᵀ from shared memory. Keys permuted: A column c <-> key 2c, c + 4
    // <-> 2c + 1 (P's accumulator layout as it is), matched by Vᵀ's slots.
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      split(s[j][0], ph[j][0], pl[j][0]);
      split(s[j][2], ph[j][1], pl[j][1]);
      split(s[j][1], ph[j][2], pl[j][2]);
      split(s[j][3], ph[j][3], pl[j][3]);
    }
    pin<D>(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // step j: key slots 8j .. 8j + 7, core matrices k4 = 2j, 2j + 1
      const uint64_t dh = core_desc(vs + 64 * j, 128, 512);
      const uint64_t dl = core_desc(vlo_s + 64 * j, 128, 512);
      wgmma<D>(o, pl[j], dh);
      wgmma<D>(o, ph[j], dl);
      wgmma<D>(o, ph[j], dh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<D>(o);
    pin_a(ph[0]); pin_a(ph[1]); pin_a(pl[0]); pin_a(pl[1]);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  if (parts > 1) {
    // Unnormalized O and this part's (max, sum) of each row, for the
    // combine kernel; rows are indexed as the output's.
    const int64_t rows = static_cast<int64_t>(gridDim.x) * Sq * Hq;
    float* op = o_part + part * rows * D;
    float* mp = ml_part + part * rows * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? ok1 : ok0)) continue;
      const int64_t at = row_offset(half ? r1 : r0);
      if (c == 0) {
        mp[at / D * 2] = half ? m1 : m0;
        mp[at / D * 2 + 1] = half ? l1 : l0;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(op + at + 8 * n + 2 * c) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
    }
    return;
  }
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  // o[n][e]: row e < 2 ? r0 : r1, column 8n + 2c + (e & 1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok1 : ok0)) continue;
    const float den = half ? safe1 : safe0;
    if (lse != nullptr && c == 0) {
      const int r = half ? r1 : r0;
      const float l = half ? l1 : l0;
      lse[(static_cast<int64_t>(b) * Hq + hk * G + hg0 + r % Gb) * Sq + p0 +
          r / Gb] = l > 0.f ? (half ? m1 : m0) + logf(l) : 1e30f;
    }
    const int64_t base = row_offset(half ? r1 : r0) + 2 * c;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      meili::store2(out, q_bf16, base + 8 * n, o[n][2 * half] / den,
                    o[n][2 * half + 1] / den);
  }
}

// Rows of split query tiles: out = sum_p w_p O_p / sum_p w_p l_p with
// w_p = exp(m_p - max m). A row no part saw a key of gives 0. One thread
// per 4 output columns.
template <int D, int BK = kBK>
__global__ void __launch_bounds__(256)
    flash_combine_kernel(const float* __restrict__ o_part,
                         const float* __restrict__ ml_part,
                         void* __restrict__ out, int B, int Sq, int Sk,
                         int Hq, int Gb, int causal, int window, int kmax,
                         int q_bf16, float* __restrict__ lse) {
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= rows * (D / 4)) return;
  const int64_t row = i / (D / 4);
  const int col = static_cast<int>(i % (D / 4)) * 4;
  const int pos = static_cast<int>((row / Hq) % Sq);
  const int PB = kRows / Gb;
  int t_lo, t_hi;
  key_tiles<BK>(pos / PB * PB, PB, Sq, Sk, causal, window, t_lo, t_hi);
  const int parts = key_parts(t_hi - t_lo, kmax);
  if (parts == 1) return;
  float m = kNegInf;
  for (int p = 0; p < parts; ++p) m = fmaxf(m, ml_part[(p * rows + row) * 2]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < parts; ++p) {
    const float w = expf(ml_part[(p * rows + row) * 2] - m);
    l += w * ml_part[(p * rows + row) * 2 + 1];
    const float4 x = *reinterpret_cast<const float4*>(
        o_part + (p * rows + row) * D + col);
    acc.x += w * x.x; acc.y += w * x.y; acc.z += w * x.z; acc.w += w * x.w;
  }
  const float safe = l == 0.f ? 1.f : l;
  if (lse != nullptr && col == 0)
    lse[(row / (static_cast<int64_t>(Sq) * Hq) * Hq + row % Hq) * Sq + pos] =
        l > 0.f ? m + logf(l) : 1e30f;
  const int64_t at = row * D + col;
  meili::store2(out, q_bf16, at, acc.x / safe, acc.y / safe);
  meili::store2(out, q_bf16, at + 2, acc.z / safe, acc.w / safe);
}

// ---- The bf16 instance (K1): q, k and v all bf16, D 128 ----------------
//
// A product of two bf16 values is exact in f32, so the f32 math of the
// reference needs no 3xTF32 here:
// - S = Q Kᵀ is one bf16 wgmma (m64n32k16, f32 accumulator) per 16 columns
//   of d and 32 keys: Q and K from shared memory in the K-major
//   core-matrix layout (Q landed once, as it is). The scale is applied to
//   the f32 logits. A tile's 64 keys go through QKᵀ, the softmax and P·V
//   in two halves, so the logits of 32 keys are live at a time.
// - O += P V takes P as p_hi = bf16(p) and p_lo = bf16(p - p_hi), two bf16
//   wgmma (m64n128k16) from registers against V: P keeps 16 bits (relative
//   error <= 2^-17, far under the bf16 output's 2^-9). The accumulator of
//   S is the A fragment of P as it is (16-bit A layout), and V is read
//   MN-major through wgmma's transpose bit, so neither is moved or split.
// - K and V land by cp.async straight in the core-matrix layout: the tile's
//   64 keys x 128 d as 16-byte rows of 8 d, core matrix (key block kb, d
//   block db) at byte 128 (8 db + kb). That is K-major for K (QKᵀ's B:
//   N = keys) and MN-major for V (PV's B: N = d). Two stages of a K and a
//   V tile of 64 keys, and Q's 128 rows the same way (core matrix (row
//   block rb, d block db) at byte 128 (16 db + rb)): 96 KB a block, and at
//   most 128 registers a thread, so two blocks share an SM and one's
//   softmax overlaps the other's products.
// - A block's 128 rows and the key-range split are as in the f32 instance;
//   a warpgroup whose 64 rows see none of a tile's keys skips it.
constexpr int kBKb = 64;                    // keys per tile
constexpr int kBH = 32;                     // keys per softmax step
constexpr int kDb = 128;                    // head dim
constexpr int kTileBytes = kBKb * kDb * 2;  // a K or a V tile
constexpr int kQBytes = kRows * kDb * 2;    // the block's Q rows
constexpr size_t kSmemBf16 = kQBytes + 2 * 2 * kTileBytes;

__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          void* __restrict__ out, int Sq, int Sk, int Hq,
                          int Hkv, int G, int Gb, int causal, int window,
                          float scale, int kmax, int max_parts,
                          float* __restrict__ o_part,
                          float* __restrict__ ml_part,
                          float* __restrict__ lse) {
  constexpr int D = kDb;
  constexpr int NT = D / 8;       // output n-tiles of a warp
  constexpr int ST = kBH / 8;     // logit n-tiles of a warp
  extern __shared__ __align__(128) unsigned char smem_b[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int PB = kRows / Gb;
  const int nq = gridDim.z / max_parts;
  const int p0 = (nq - 1 - static_cast<int>(blockIdx.z) / max_parts) * PB;
  const int part = blockIdx.z % max_parts;
  const int groups = (G + Gb - 1) / Gb;
  const int hk = blockIdx.y / groups;
  const int hg0 = (blockIdx.y % groups) * Gb;
  const int b = blockIdx.x;
  const int off = Sk - Sq;
  const int64_t q_row = static_cast<int64_t>(Hq) * D;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * D;
  const int64_t q_base = static_cast<int64_t>(b) * Sq * q_row;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_row +
                          static_cast<int64_t>(hk) * D;

  auto row_ok = [&](int r) {
    return r < PB * Gb && hg0 + r % Gb < G && p0 + r / Gb < Sq;
  };
  auto row_offset = [&](int r) {
    return q_base + static_cast<int64_t>(p0 + r / Gb) * q_row +
           static_cast<int64_t>(hk * G + hg0 + r % Gb) * D;
  };

  int t_lo, t_hi;
  key_tiles<kBKb>(p0, PB, Sq, Sk, causal, window, t_lo, t_hi);
  const int parts = key_parts(t_hi - t_lo, kmax);
  if (part >= parts) return;
  if (parts > 1) {
    const int len = (t_hi - t_lo + parts - 1) / parts;
    t_lo += part * len;
    t_hi = min(t_hi, t_lo + len);
  }

  // 16-byte copy i of a stage: K (i < 1,024), then V. Lanes take 8 keys of
  // one 8-d column block, so a warp writes 4 whole core matrices.
  auto fetch = [&](int t, int stage) {
    unsigned char* ks = smem_b + kQBytes + stage * 2 * kTileBytes;
    const int k0 = t * kBKb;
#pragma unroll
    for (int it = 0; it < 2 * kBKb * D / 8 / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int is_v = i >> 10;
      const int kr = i & 7;
      const int db = (i >> 3) & 15;
      const int kb = (i >> 7) & 7;
      const int key = kb * 8 + kr;
      const bool in = k0 + key < Sk;
      const int64_t idx =
          kv_base + static_cast<int64_t>(in ? k0 + key : 0) * kv_row + db * 8;
      cp_async16(ks + is_v * kTileBytes + (db * 8 + kb) * 128 + kr * 16,
                 (is_v ? v : k) + idx, in);
    }
  };

  if (t_lo < t_hi) fetch(t_lo, 0);
  // Q's rows with the first tile (zero for a row out of range): 16-byte
  // copy i takes row 8·((i >> 7) & 15) + (i & 7), d block (i >> 3) & 15.
#pragma unroll
  for (int it = 0; it < kRows * D / 8 / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int rb = (i >> 7) & 15;
    const int db = (i >> 3) & 15;
    const int r = rb * 8 + (i & 7);
    const bool in = row_ok(r);
    cp_async16(smem_b + (db * 16 + rb) * 128 + (i & 7) * 16,
               q + (in ? row_offset(r) + db * 8 : 0), in);
  }
  cp_async_commit();

  // This thread's rows r0 = 16·warp + g and r1 = r0 + 8.
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const bool ok0 = row_ok(r0);
  const bool ok1 = row_ok(r1);
  const int qp0 = p0 + r0 / Gb + off;
  const int qp1 = p0 + r1 / Gb + off;
  const bool warp_full = __all_sync(0xffffffffu, ok0 && ok1);
  const int wq_lo = p0 + (warp * 16) / Gb + off;
  const int wq_hi = min(p0 + (warp * 16 + 15) / Gb, Sq - 1) + off;
  // the warpgroup's 64 rows: whether any is in range, and their positions
  const int wg_r = (warp >> 2) * 64;
  const bool wg_live = wg_r < PB * Gb && p0 + wg_r / Gb < Sq;
  const int gq_lo = p0 + wg_r / Gb + off;
  const int gq_hi = min(p0 + (wg_r + 63) / Gb, Sq - 1) + off;

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    cp_async_wait<0>();   // tile t has landed (this thread's copies)
    fence_to_async();     // ... visible to wgmma
    __syncthreads();      // ... everyone's, and tile t - 1 is done with
    if (t + 1 < t_hi) fetch(t + 1, stage ^ 1);
    cp_async_commit();

    const unsigned char* ks = smem_b + kQBytes + stage * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
    // The tile in halves of kBH keys, each QKᵀ, softmax and P·V in turn
    // (the logits of half a tile keep the registers under 128).
#pragma unroll 1
    for (int h = 0; h < kBKb / kBH; ++h) {
      const int k0 = t * kBKb + h * kBH;
      if (!wg_live || (causal && k0 > gq_hi) ||
          (window > 0 && k0 + kBH - 1 <= gq_lo - window))
        continue;         // warpgroup-uniform: no row sees these keys

      // S = Q Kᵀ: k-step kk reads d blocks 2kk, 2kk + 1 of the
      // warpgroup's Q rows (2,048 B apart, row blocks 128 B) and of the
      // half's K rows (1,024 B apart, key blocks 128 B).
      float s[ST][4] = {};
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_n32_ss(
            s,
            core_desc(reinterpret_cast<const float*>(
                          smem_b + (32 * kk + (warp >> 2) * 8) * 128),
                      2048, 128),
            core_desc(reinterpret_cast<const float*>(
                          ks + kk * 2048 + h * (kBH / 8) * 128),
                      1024, 128));
      wgmma_commit();
      wgmma_wait<0>();
      pin<kBH>(s);

      // Scale and mask, then the online softmax. s[n][e]: row e < 2 ? r0
      // : r1, key k0 + 8n + 2c + (e & 1).
      const bool all_in = warp_full && k0 + kBH <= Sk &&
                          (!causal || k0 + kBH - 1 <= wq_lo) &&
                          (window <= 0 || k0 > wq_hi - window);
      uint32_t val = 0;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * c + (e & 1);
          const int qpos = e < 2 ? qp0 : qp1;
          const bool ok = all_in || ((e < 2 ? ok0 : ok1) && kpos < Sk &&
                                     (!causal || kpos <= qpos) &&
                                     (window <= 0 || kpos > qpos - window));
          val |= static_cast<uint32_t>(ok) << (4 * n + e);
          s[n][e] = ok ? s[n][e] * scale : kNegInf;
          if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
          else mx1 = fmaxf(mx1, s[n][e]);
        }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = __expf(m0 - mn0);
      const float alpha1 = __expf(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (val >> (4 * n + e)) & 1u
                              ? __expf(s[n][e] - (e < 2 ? mn0 : mn1))
                              : 0.f;
          s[n][e] = p;
          if (e < 2) rs0 += p;
          else rs1 += p;
        }
      l0 = alpha0 * l0 + rs0;
      l1 = alpha1 * l1 + rs1;
      m0 = mn0;
      m1 = mn1;
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][0] *= alpha0; o[n][1] *= alpha0;
          o[n][2] *= alpha1; o[n][3] *= alpha1;
        }
      }

      // O += P V: k-step kk takes keys 16kk .. 16kk + 15 of the half,
      // n-tiles 2kk and 2kk + 1 of S, as A (16-bit layout); V's key blocks
      // are 128 B apart, its d blocks 1,024 B.
      uint32_t ph[kBH / 16][4], pl[kBH / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBH / 16; ++kk) {
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2],
                   pl[kk][2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3],
                   pl[kk][3]);
      }
      pin<D>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBH / 16; ++kk) {
        const uint64_t dv = core_desc(
            reinterpret_cast<const float*>(vs + (h * kBH / 16 + kk) * 256),
            128, 1024);
        wgmma_bf16_n128_mn(o, pl[kk], dv);
        wgmma_bf16_n128_mn(o, ph[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<D>(o);
#pragma unroll
      for (int kk = 0; kk < kBH / 16; ++kk) {
        pin_a(ph[kk]);
        pin_a(pl[kk]);
      }
    }
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  if (parts > 1) {
    const int64_t rows = static_cast<int64_t>(gridDim.x) * Sq * Hq;
    float* op = o_part + part * rows * D;
    float* mp = ml_part + part * rows * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? ok1 : ok0)) continue;
      const int64_t at = row_offset(half ? r1 : r0);
      if (c == 0) {
        mp[at / D * 2] = half ? m1 : m0;
        mp[at / D * 2 + 1] = half ? l1 : l0;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(op + at + 8 * n + 2 * c) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
    }
    return;
  }
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok1 : ok0)) continue;
    const float den = half ? safe1 : safe0;
    if (lse != nullptr && c == 0) {
      const int r = half ? r1 : r0;
      const float l = half ? l1 : l0;
      lse[(static_cast<int64_t>(b) * Hq + hk * G + hg0 + r % Gb) * Sq + p0 +
          r / Gb] = l > 0.f ? (half ? m1 : m0) + logf(l) : 1e30f;
    }
    const int64_t base = row_offset(half ? r1 : r0) + 2 * c;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      meili::store2(out, 1, base + 8 * n, o[n][2 * half] / den,
                    o[n][2 * half + 1] / den);
  }
}

int launch_flash_bf16(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                      int window, float scale, int kmax, int max_parts,
                      float* o_part, float* ml_part, float* lse,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBf16));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = Hq / Hkv;
  const int Gb = G < kRows ? G : kRows;
  const int PB = kRows / Gb;
  const int groups = (G + Gb - 1) / Gb;
  const int64_t nz = static_cast<int64_t>((Sq + PB - 1) / PB) * max_parts;
  if (static_cast<int64_t>(Hkv) * groups > 65535 || nz > 65535 ||
      kmax < 1 || max_parts < 1 || (max_parts > 1 && !(o_part && ml_part)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, Hkv * groups, static_cast<unsigned>(nz));
  flash_fwd_bf16_kernel<<<grid, kThreads, kSmemBf16, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, Sq, Sk, Hq, Hkv, G, Gb,
      causal, window, scale, kmax, max_parts, o_part, ml_part, lse);
  err = cudaGetLastError();
  if (err != cudaSuccess || max_parts == 1) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(B) * Sq * Hq * (kDb / 4);
  flash_combine_kernel<kDb, kBKb>
      <<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
          o_part, ml_part, out, B, Sq, Sk, Hq, Gb, causal, window, kmax, 1,
          lse);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                 int window, float scale, int q_bf16, int kmax,
                 int max_parts, float* o_part, float* ml_part, float* lse,
                 cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int G = Hq / Hkv;
  const int Gb = G < kRows ? G : kRows;     // query heads per block
  const int PB = kRows / Gb;
  const int groups = (G + Gb - 1) / Gb;
  const int64_t nz = static_cast<int64_t>((Sq + PB - 1) / PB) * max_parts;
  if (static_cast<int64_t>(Hkv) * groups > 65535 || nz > 65535 ||
      kmax < 1 || max_parts < 1 || (max_parts > 1 && !(o_part && ml_part)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, Hkv * groups, static_cast<unsigned>(nz));
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const float*>(k), static_cast<const float*>(v), out, Sq,
      Sk, Hq, Hkv, G, Gb, causal, window, scale, q_bf16, kmax, max_parts,
      o_part, ml_part, lse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || max_parts == 1) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(B) * Sq * Hq * (D / 4);
  flash_combine_kernel<D><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                            stream>>>(o_part, ml_part, out, B, Sq, Sk, Hq,
                                      Gb, causal, window, kmax, q_bf16, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `kmax` key tiles at most per block (16 keys a tile in the f32 instance,
// 64 in the bf16 one): a query tile with more is split over blocks and
// combined, with f32 scratch o_part (max_parts, B, Sq, Hq, D) and ml_part
// (max_parts, B, Sq, Hq, 2) from the caller (unused, may be null, when
// max_parts is 1). `lse` (B, Hq, Sq) f32 is written when not null.
// `kv_bf16` selects the bf16 instance (q, k and v bf16, D 128); otherwise
// k and v are f32 and q f32 or bf16 (`q_bf16`).
extern "C" int meili_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int Hq, int Hkv, int D,
                                     int causal, int window, float scale,
                                     int q_bf16, int kv_bf16, int kmax,
                                     int max_parts, void* o_part,
                                     void* ml_part, void* lse, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bf16) {        // the bf16 instance: q, k and v bf16 at D 128
    if (!q_bf16 || D != kDb) return static_cast<int>(cudaErrorInvalidValue);
    return launch_flash_bf16(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                             window, scale, kmax, max_parts,
                             static_cast<float*>(o_part),
                             static_cast<float*>(ml_part),
                             static_cast<float*>(lse), s);
  }
  switch (D) {
    case 16:
      return launch_flash<16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                              window, scale, q_bf16, kmax,
                              max_parts, static_cast<float*>(o_part),
                              static_cast<float*>(ml_part),
                              static_cast<float*>(lse), s);
    case 64:
      return launch_flash<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                              window, scale, q_bf16, kmax,
                              max_parts, static_cast<float*>(o_part),
                              static_cast<float*>(ml_part),
                              static_cast<float*>(lse), s);
    case 128:
      return launch_flash<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                               window, scale, q_bf16, kmax,
                               max_parts, static_cast<float*>(o_part),
                               static_cast<float*>(ml_part),
                               static_cast<float*>(lse), s);
    case 256:
      return launch_flash<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                               window, scale, q_bf16, kmax,
                               max_parts, static_cast<float*>(o_part),
                               static_cast<float*>(ml_part),
                               static_cast<float*>(lse), s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
