// Single-token decode attention over a KV cache — B6 of the port.
//
// Replaces: src/repro/kernels/decode_attention.py `_decode_kernel` /
// `decode_attention`. The TPU kernel runs a sequential (b, kv-head,
// kv-block) grid, carrying (max, sum, acc) for the kv-head's G query heads
// across kv blocks in VMEM. With one block per (b, kv-head) the H100 would
// run B·Hkv blocks on 132 SMs (4-8 for gemma3-1b's single KV head), so the
// cache is split over S instead ("flash-decoding"), and the splits are
// merged in the same launch.
//
// What bounds it on the H100: bytes. Each valid cache row is read once
// (2·D values per kv-head) for 4·G·D flops, far below the card's
// flops-per-byte line, so the bound is the valid cache bytes over HBM
// bandwidth. At the path's shapes that is 1-4 MB, a microsecond or two, so
// what counts is having every byte in flight at once, and one launch.
//
// What the design does about it:
// - Short splits. The wrapper cuts the cache into splits of at most 32
//   keys (8 a warp), in as few clusters of 8 splits as that allows,
//   without reading kv_len on the host: 192 blocks over gemma3-1b's
//   prefilled cache, 64 over the engine's. A cluster past kv_len[b] exits
//   at once, and keys at or past kv_len[b] (or S) are never read.
// - Staged loads. Each of a block's 4 warps takes a contiguous slice of the
//   split's keys and copies its K and V rows into its own shared memory
//   with 16-byte cp.async, all of them (up to `kt` keys a stage, two stages
//   when a slice is longer) before its first dot product; V lands while
//   the warp computes logits.
// - Many keys per warp. Lanes hold D/32 dims of a row (16-byte shared
//   loads for bf16 at D 256); a warp takes its keys in batches, reduces each
//   batch's logits with shuffles (all in flight at once: no branch between
//   them) and keeps its own running max, sum and p·v accumulator over all
//   G heads in registers, in base 2. The block merges its warps once, at
//   the end. Below D 64 a lane keeps 2 dims, so a row takes D/2 lanes and
//   the warp walks 64/D keys a step side by side (4 at D 16): the logit
//   shuffles stay within a row's lanes, the batch max and sum are reduced
//   over the rows, and the rows' accumulators are summed once, at the end.
// - One launch. The splits form clusters of 8 blocks: the 8 block partials
//   are merged through distributed shared memory, each block merging one
//   eighth of the G·D outputs. Where a (b, kv-head) has more than one
//   cluster with keys, each block writes its eighth of the cluster partial
//   and bumps an arrival counter of (b, kv-head, eighth); the last to
//   arrive merges that eighth over the clusters, writes the output and sets
//   the counter back to 0 (counters are zeroed once, when the wrapper first
//   allocates them). A head with no valid key yields 0.
// - Optional lse. Where the caller passes `lse`, the last merge also writes
//   each head's log-sum-exp of its scaled logits, in natural log ((max +
//   log2 sum) · ln 2: the merges run in base 2), 1e30 for a head with no
//   valid key: a rank that holds one block of a cache split over ranks
//   returns (out, lse), and the ranks' partials merge by log-sum-exp.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kMaxKeysPerStage = 8;
constexpr int kMaxOut = 2048;             // G·D
constexpr float kNegInf = -1e30f;
constexpr float kLseEmpty = 1e30f;        // lse of a row with no valid key
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kStaticSmemLimit = 48 * 1024;

// N consecutive elements of a row, as f32: one 4-, 8- or 16-byte load.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  static_assert(N == 2 || N == 4, "f32 vector of 2 or 4");
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}

// N f32 values as 8- or 16-byte loads (N = 8: two 16-byte loads).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N == 8) {
    float a[4], b[4];
    load_vec<4>(p, a);
    load_vec<4>(p + 4, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = a[i];
      x[4 + i] = b[i];
    }
  } else {
    load_vec<N>(p, x);
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "bf16 vector of 2, 4 or 8");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 2^x in one MUFU op (ex2.approx, relative error 2^-22): the kernel's
// logits and running maxima are kept in base 2 (q is scaled by log2 e).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lanes a cache row takes: all 32 from D 64 on (D/32 dims each), else D/2
// (2 dims each), and then 32 / lanes rows are walked side by side.
template <int D>
__host__ __device__ constexpr int row_lanes() {
  return D >= 64 ? 32 : D / 2;
}

// One batch of nb <= KB·RPW keys (rows kb0.. of a warp's stage) against
// the G heads of q: logits reduced over a row's lanes, the running (max,
// sum, acc) rescaled once, then p·v. Step jj takes rows kb0 + jj·RPW + sub
// (sub = lane / LPR, one row per LPR lanes). Branch-free: rows past nb
// repeat the last row and get probability 0, so every shuffle of the batch
// is issued at once.
template <int KB, int D, typename T, int GM, int NCH, int EPC>
__device__ __forceinline__ void attend(const T* ks, const T* vs, int kb0,
                                       int nb, int lane,
                                       float (&qv)[GM][NCH][EPC],
                                       float (&acc)[GM][NCH][EPC],
                                       float (&m)[GM], float (&l)[GM]) {
  constexpr int LPR = row_lanes<D>();
  constexpr int RPW = 32 / LPR;                    // rows a step
  const int sub = lane / LPR;
  const int dl = lane % LPR;                       // the lane within its row
  float s[KB][GM];
#pragma unroll
  for (int jj = 0; jj < KB; ++jj) {
    const int row = kb0 + min(jj * RPW + sub, nb - 1);
    float x[NCH][EPC];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      load_vec<EPC>(ks + row * D + c * (D / NCH) + dl * EPC, x[c]);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      s[jj][g] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < EPC; ++e) s[jj][g] += qv[g][c][e] * x[c][e];
    }
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
    for (int jj = 0; jj < KB; ++jj)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        s[jj][g] += __shfl_xor_sync(0xffffffffu, s[jj][g], o);
  // online softmax over the batch (base 2); s becomes the probabilities
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float mx = m[g];
#pragma unroll
    for (int jj = 0; jj < KB; ++jj) mx = fmaxf(mx, s[jj][g]);  // dups: same
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)           // over the rows of a step
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float alpha = fast_exp2(m[g] - mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KB; ++jj) {
      s[jj][g] = jj * RPW + sub < nb ? fast_exp2(s[jj][g] - mx) : 0.f;
      sum += s[jj][g];
    }
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l[g] = alpha * l[g] + sum;
    m[g] = mx;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[g][c][e] *= alpha;
  }
#pragma unroll
  for (int jj = 0; jj < KB; ++jj) {
    const int row = kb0 + min(jj * RPW + sub, nb - 1);
    float x[NCH][EPC];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      load_vec<EPC>(vs + row * D + c * (D / NCH) + dl * EPC, x[c]);
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[g][c][e] += s[jj][g] * x[c][e];
  }
}

// Head dim D, cache element type T, G rounded up to a power of two GM.
template <int D, typename T, int GM>
__global__ void __launch_bounds__(kThreads, 1)
    decode_attention_kernel(const void* __restrict__ q,
                            const T* __restrict__ k, const T* __restrict__ v,
                            const int32_t* __restrict__ kv_len,
                            void* __restrict__ out,
                            float* __restrict__ lse,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml,
                            int32_t* __restrict__ counters, int S, int Hkv,
                            int G, int chunk, int kt, int stages, float scale,
                            int q_bf16) {
  constexpr int LPR = row_lanes<D>();                 // lanes a row
  constexpr int RPW = 32 / LPR;                       // rows a step
  constexpr int EPL = D / LPR;                        // dims per lane
  constexpr int NCH = EPL * sizeof(T) > 16 ? 2 : 1;   // 16-byte pieces
  constexpr int EPC = EPL / NCH;                      // dims per piece
  constexpr int RB = D * sizeof(T);                   // row bytes
  constexpr int CPR = RB / 16;                        // 16-byte copies a row
  constexpr int KEYS = GM >= 8 ? 32 / GM : 8;         // keys per batch
  constexpr int KB = KEYS / RPW > 0 ? KEYS / RPW : 1; // steps per batch
  constexpr int KT2 = KB * RPW < 2 ? KB : 2 / RPW > 0 ? 2 / RPW : 1;
                                                      // steps of a short tail
  constexpr int PER_T = (kMaxOut / kCluster + kThreads - 1) / kThreads;

  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int dl = lane % LPR;
  const int sp = blockIdx.x;
  const int nsplit = gridDim.x;
  const int ncl = nsplit / kCluster;
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int hk = bh % Hkv;
  const int Hq = Hkv * G;
  const int GD = G * D;
  const int64_t out_base = (static_cast<int64_t>(b) * Hq + hk * G) * D;
  // the query heads of this kv head, scaled by scale·log2 e, loaded before
  // anything waits on kv_len; lane's dims c*(D/NCH) + dl*EPC + e
  float qv[GM][NCH][EPC];
  const float scale_log2 = scale * 1.4426950408889634f;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int64_t at = out_base + g * D + c * (D / NCH) + dl * EPC;
      if (g < G) {
        if (q_bf16)
          load_vec<EPC>(static_cast<const __nv_bfloat16*>(q) + at, qv[g][c]);
        else
          load_f32<EPC>(static_cast<const float*>(q) + at, qv[g][c]);
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        qv[g][c][e] = g < G ? qv[g][c][e] * scale_log2 : 0.f;
    }
  const int len = max(0, min(kv_len[b], S));

  if (len == 0) {             // no valid key: every head of (b, hk) is 0
    if (sp == 0) {
      for (int i = tid; i < GD; i += kThreads) {
        if (q_bf16)
          static_cast<__nv_bfloat16*>(out)[out_base + i] =
              __float2bfloat16_rn(0.f);
        else
          static_cast<float*>(out)[out_base + i] = 0.f;
      }
      if (lse != nullptr && tid < G) lse[out_base / D + tid] = kLseEmpty;
    }
    return;
  }
  const int nvalid = (len + chunk - 1) / chunk;
  const int nvc = (nvalid + kCluster - 1) / kCluster;   // clusters with keys
  const int cl = sp / kCluster;
  if (cl >= nvc) return;      // the whole cluster exits together
  const int rank = static_cast<int>(cluster.block_rank());

  // shared memory: per-warp stages, warp partials, block partial
  T* stage_base = reinterpret_cast<T*>(smem_raw) +
                  static_cast<size_t>(warp) * stages * kt * 2 * D;
  float* wacc = reinterpret_cast<float*>(
      smem_raw + static_cast<size_t>(kWarps) * stages * kt * 2 * RB);
  float* wml = wacc + kWarps * GD;            // [warp][g][m, l]
  float* bacc = wml + kWarps * G * 2;          // block partial, G·D
  float* bml = bacc + GD;                      // [g][m, l]
  float* wgt = bml + 2 * G;                    // [warp][g] merge weights

  // this warp's keys
  const int s0 = sp * chunk;
  const int s1 = min(s0 + chunk, len);
  const int kpw = (chunk + kWarps - 1) / kWarps;
  const int w0 = s0 + warp * kpw;
  const int w1 = min(w0 + kpw, s1);
  const int nkeys = max(0, w1 - w0);
  const int ntiles = (nkeys + kt - 1) / kt;
  const int64_t row_stride = static_cast<int64_t>(Hkv) * D;
  const T* kb = k + (static_cast<int64_t>(b) * S * Hkv + hk) * D;
  const T* vb = v + (static_cast<int64_t>(b) * S * Hkv + hk) * D;

  auto issue = [&](int t) {
    if (t < ntiles) {
      const int j0 = w0 + t * kt;
      const int n = min(kt, w1 - j0);
      T* ks = stage_base + static_cast<size_t>(t % stages) * kt * 2 * D;
      T* vs = ks + kt * D;
      for (int c = lane; c < n * CPR; c += 32) {
        const int r = c / CPR, col = (c % CPR) * (16 / sizeof(T));
        cp_async16(ks + r * D + col, kb + (j0 + r) * row_stride + col);
        cp_async16(vs + r * D + col, vb + (j0 + r) * row_stride + col);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  float acc[GM][NCH][EPC];
  float m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[g][c][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int n = min(kt, w1 - (w0 + t * kt));
    const T* ks = stage_base + static_cast<size_t>(t % stages) * kt * 2 * D;
    const T* vs = ks + kt * D;
    cp_async_wait<1>();       // K and V of tile t have landed
    __syncwarp();
    for (int kb0 = 0; kb0 < n;) {
      if (n - kb0 > 2) {
        attend<KB, D>(ks, vs, kb0, min(KB * RPW, n - kb0), lane, qv, acc, m,
                      l);
        kb0 += KB * RPW;
      } else {
        attend<KT2, D>(ks, vs, kb0, min(KT2 * RPW, n - kb0), lane, qv, acc,
                       m, l);
        kb0 += KT2 * RPW;
      }
    }
    __syncwarp();             // every lane is done with this stage
    issue(t + 2);
  }
  cp_async_wait<0>();
  // the rows walked side by side share (max, sum): add their accumulators
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          acc[g][c][e] += __shfl_xor_sync(0xffffffffu, acc[g][c][e], o);

  // warp partials -> shared memory
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G && lane < LPR) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          wacc[warp * GD + g * D + c * (D / NCH) + dl * EPC + e] =
              acc[g][c][e];
      if (lane == 0) {
        wml[(warp * G + g) * 2] = m[g];
        wml[(warp * G + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();
  // block partial: merge the warps, with each (warp, head)'s weight taken
  // once
  if (tid < G) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[(w * G + tid) * 2]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = fast_exp2(wml[(w * G + tid) * 2] - mx);
      wgt[w * G + tid] = f;
      sum += f * wml[(w * G + tid) * 2 + 1];
    }
    bml[2 * tid] = mx;
    bml[2 * tid + 1] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < (GM * D + kThreads - 1) / kThreads; ++u) {
    const int i = tid + u * kThreads;
    if (i < GD) {
      const int g = i / D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += wgt[w * G + g] * wacc[w * GD + i];
      bacc[i] = a;
    }
  }
  cluster.sync();

  // cluster partial: this block merges its eighth of G·D over the cluster
  const int slice = (GD + kCluster - 1) / kCluster;
  const int lo = rank * slice;
  const int hi = min(lo + slice, GD);
  float res_a[PER_T], res_m[PER_T], res_l[PER_T];
#pragma unroll
  for (int u = 0; u < PER_T; ++u) {
    const int i = lo + tid + u * kThreads;
    res_a[u] = 0.f;
    res_m[u] = kNegInf;
    res_l[u] = 0.f;
    if (i < hi) {
      const int g = i / D;
      float mj[kCluster], lj[kCluster], aj[kCluster];
#pragma unroll
      for (int j = 0; j < kCluster; ++j) {    // every remote load at once
        const float* ml = cluster.map_shared_rank(bml, j);
        mj[j] = ml[2 * g];
        lj[j] = ml[2 * g + 1];
        aj[j] = cluster.map_shared_rank(bacc, j)[i];
      }
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCluster; ++j) mx = fmaxf(mx, mj[j]);
      float sum = 0.f, a = 0.f;
#pragma unroll
      for (int j = 0; j < kCluster; ++j) {
        const float f = fast_exp2(mj[j] - mx);
        sum += f * lj[j];
        a += f * aj[j];
      }
      res_a[u] = a;
      res_m[u] = mx;
      res_l[u] = sum;
    }
  }
  cluster.sync();             // no block leaves while others read it

  auto store = [&](int i, float a, float sum, float mx) {
    const float r = a / (sum == 0.f ? 1.f : sum);
    if (q_bf16)
      static_cast<__nv_bfloat16*>(out)[out_base + i] = __float2bfloat16_rn(r);
    else
      static_cast<float*>(out)[out_base + i] = r;
    if (lse != nullptr && i % D == 0)     // one thread a head
      lse[out_base / D + i / D] =
          sum == 0.f ? kLseEmpty : (mx + log2f(sum)) * kLn2;
  };
  if (nvc == 1) {
#pragma unroll
    for (int u = 0; u < PER_T; ++u) {
      const int i = lo + tid + u * kThreads;
      if (i < hi) store(i, res_a[u], res_l[u], res_m[u]);
    }
    return;
  }
  // more than one cluster: the last block of this eighth to arrive merges
  const int64_t pa = (static_cast<int64_t>(bh) * ncl + cl) * GD;
  const int64_t pm = ((static_cast<int64_t>(bh) * ncl + cl) * kCluster +
                      rank) * G * 2;
#pragma unroll
  for (int u = 0; u < PER_T; ++u) {
    const int i = lo + tid + u * kThreads;
    if (i < hi) {
      part_acc[pa + i] = res_a[u];
      if (i == lo || i % D == 0) {
        part_ml[pm + 2 * (i / D)] = res_m[u];
        part_ml[pm + 2 * (i / D) + 1] = res_l[u];
      }
    }
  }
  // every thread's writes, then one release by thread 0 (as a grid sync)
  __syncthreads();
  __shared__ int last;
  int32_t* counter = counters + bh * kCluster + rank;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == nvc - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int u = 0; u < PER_T; ++u) {
    const int i = lo + tid + u * kThreads;
    if (i < hi) {
      const int g = i / D;
      // the clusters 8 at a time: their loads issued together (a row past
      // nvc repeats the last one and is weighed 0)
      float mx = kNegInf, sum = 0.f, a = 0.f;
      for (int c0 = 0; c0 < nvc; c0 += 8) {
        float mc[8], lc[8], ac[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = min(c0 + j, nvc - 1);
          const int64_t at = (static_cast<int64_t>(bh) * ncl + c) * kCluster +
                             rank;
          mc[j] = __ldcg(part_ml + at * G * 2 + 2 * g);
          lc[j] = __ldcg(part_ml + at * G * 2 + 2 * g + 1);
          ac[j] = __ldcg(part_acc + (static_cast<int64_t>(bh) * ncl + c) * GD +
                         i);
        }
        float mn = mx;
#pragma unroll
        for (int j = 0; j < 8; ++j) mn = fmaxf(mn, mc[j]);
        const float f_old = fast_exp2(mx - mn);
        sum *= f_old;
        a *= f_old;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = c0 + j < nvc ? fast_exp2(mc[j] - mn) : 0.f;
          sum += f * lc[j];
          a += f * ac[j];
        }
        mx = mn;
      }
      store(i, a, sum, mx);
    }
  }
  if (tid == 0) *counter = 0;
}

template <int D, typename T, int GM>
int launch(const void* q, const void* k, const void* v,
           const int32_t* kv_len, void* out, float* lse, float* part_acc,
           float* part_ml, int32_t* counters, int B, int S, int Hq, int Hkv,
           int nsplit, int chunk, int kt, int stages, float scale,
           int q_bf16, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      static_cast<size_t>(kWarps) * stages * kt * 2 * D * sizeof(T) +
      (static_cast<size_t>(kWarps) * (G * D + 3 * G) + G * D + 2 * G) *
          sizeof(float);
  auto kernel = decode_attention_kernel<D, T, GM>;
  if (smem > kStaticSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, B * Hkv, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, q, static_cast<const T*>(k), static_cast<const T*>(v),
      kv_len, out, lse, part_acc, part_ml, counters, S, Hkv, G, chunk, kt,
      stages,
      scale, q_bf16));
}

template <int D, typename T>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const int32_t* kv_len, void* out, float* lse,
               float* part_acc, float* part_ml, int32_t* counters, int B,
               int S, int Hq, int Hkv, int nsplit, int chunk, int kt,
               int stages, float scale, int q_bf16, cudaStream_t s) {
#define MEILI_DECODE_G(GM)                                                  \
  if (G <= GM)                                                              \
    return launch<D, T, GM>(                                                \
        q, k, v, kv_len, out, lse, part_acc, part_ml, counters, B, S, Hq,   \
        Hkv, nsplit, chunk, kt, stages, scale, q_bf16, s);
  MEILI_DECODE_G(1)
  MEILI_DECODE_G(2)
  MEILI_DECODE_G(4)
  MEILI_DECODE_G(8)
  if constexpr (D <= 128) { MEILI_DECODE_G(16) }
  // at D 16 a warp's 4 rows a step take more registers: G 32 would spill
  if constexpr (D == 64) { MEILI_DECODE_G(32) }
#undef MEILI_DECODE_G
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_d(int D, int G, const void* q, const void* k, const void* v,
               const int32_t* kv_len, void* out, float* lse,
               float* part_acc, float* part_ml, int32_t* counters, int B,
               int S, int Hq, int Hkv, int nsplit, int chunk, int kt,
               int stages, float scale, int q_bf16, cudaStream_t s) {
  switch (D) {
    case 16:
      return dispatch_g<16, T>(G, q, k, v, kv_len, out, lse, part_acc,
                               part_ml, counters, B, S, Hq, Hkv, nsplit,
                               chunk, kt, stages, scale, q_bf16, s);
    case 64:
      return dispatch_g<64, T>(G, q, k, v, kv_len, out, lse, part_acc,
                               part_ml, counters, B, S, Hq, Hkv, nsplit,
                               chunk, kt, stages, scale, q_bf16, s);
    case 128:
      return dispatch_g<128, T>(G, q, k, v, kv_len, out, lse, part_acc,
                                part_ml, counters, B, S, Hq, Hkv, nsplit,
                                chunk, kt, stages, scale, q_bf16, s);
    case 256:
      return dispatch_g<256, T>(G, q, k, v, kv_len, out, lse, part_acc,
                                part_ml, counters, B, S, Hq, Hkv, nsplit,
                                chunk, kt, stages, scale, q_bf16, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int meili_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* lse, void* part_acc, void* part_ml, void* counters,
    int B, int S, int Hq, int Hkv, int D, int nsplit, int chunk, int kt,
    int stages, float scale, int q_bf16, int kv_bf16, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * D > kMaxOut || nsplit <= 0 ||
      nsplit % kCluster != 0 || chunk <= 0 || kt <= 0 ||
      kt > kMaxKeysPerStage || stages < 1 || stages > 2 ||
      B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(kv_len);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int32_t* cnt = static_cast<int32_t*>(counters);
  float* ls = static_cast<float*>(lse);
  const int G = Hq / Hkv;
  if (kv_bf16)
    return dispatch_d<__nv_bfloat16>(D, G, q, k, v, len, out, ls, pa, pm,
                                     cnt, B, S, Hq, Hkv, nsplit, chunk, kt,
                                     stages, scale, q_bf16, s);
  return dispatch_d<float>(D, G, q, k, v, len, out, ls, pa, pm, cnt, B, S,
                           Hq, Hkv, nsplit, chunk, kt, stages, scale, q_bf16,
                           s);
}
