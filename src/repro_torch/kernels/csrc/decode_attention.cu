// Single-token decode attention over a KV cache — B6 of the port.
//
// Replaces: src/repro/kernels/decode_attention.py `_decode_kernel` /
// `decode_attention`. The TPU kernel runs a sequential (b, kv-head,
// kv-block) grid, carrying (max, sum, acc) for the kv-head's G query heads
// across kv blocks in VMEM. With one block per (b, kv-head) the H100 would
// run B·Hkv blocks on 132 SMs (4-8 for gemma3-1b's single KV head), so the
// cache is split over S instead ("flash-decoding"): a split kernel computes
// a partial (max, sum, acc) per (split, b, kv-head, g), and a combine kernel
// rescales and sums the partials into the output.
//
// What bounds it on the H100: bytes. Each valid cache row is read once
// (2·D values per kv-head) for 4·G·D flops, far below the card's
// flops-per-byte line, so the bound is the valid cache bytes over HBM
// bandwidth.
//
// What the design does about it, simply: one block of 256 threads per
// (64-key chunk group, b, kv-head) handles all G query heads, so K and V
// are read once per group. Keys at or past kv_len[b] (or S) are never read:
// splits that start past kv_len exit after writing an empty partial. Each
// warp dots whole K rows (lanes over D, coalesced) against the G scaled
// queries held in shared memory and reduces with shuffles; one warp per
// head updates that head's running max and sum over the 64 logits; then
// each thread owns one column d of V for G·D/256 heads and accumulates
// p·v. Masked keys get probability 0 (a head with no valid key yields 0).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // keys per inner tile
constexpr int kMaxOut = 8;      // outputs (g, d) per thread: G·D <= 2048
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load1(const void* base, bool bf16,
                                       int64_t idx) {
  if (bf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[idx]);
  return static_cast<const float*>(base)[idx];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const void* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v,
                        const int32_t* __restrict__ kv_len,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int S, int Hkv, int G,
                        int chunk, float scale, int q_bf16, int k_bf16,
                        int v_bf16) {
  constexpr int DPL = D / 32;          // K values per lane of a row
  constexpr int GSTEP = kThreads / D;  // heads between a thread's outputs
  extern __shared__ float smem[];
  float* q_s = smem;               // G x D, scaled
  float* lg = q_s + G * D;         // G x kTile: logits, then probabilities
  float* st = lg + G * kTile;      // G x 3: running max, sum, rescale

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = blockIdx.x;
  const int nsplit = gridDim.x;
  const int bh = blockIdx.y;       // b * Hkv + kv head
  const int b = bh / Hkv;
  const int hk = bh % Hkv;
  const int Hq = Hkv * G;
  const int len = max(0, min(kv_len[b], S));
  const int s_begin = sp * chunk;
  const int s_end = min(s_begin + chunk, len);
  const int64_t kv_row = static_cast<int64_t>(Hkv) * D;
  const int64_t kv_base = static_cast<int64_t>(b) * S * kv_row +
                          static_cast<int64_t>(hk) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * Hq + hk * G) * D;

  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = load1(q, q_bf16, q_base + i) * scale;
  for (int g = tid; g < G; g += kThreads) {
    st[3 * g] = kNegInf;
    st[3 * g + 1] = 0.f;
  }
  const int d_t = tid % D;
  const int g_t = tid / D;
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    const int n = min(kTile, s_end - t0);
    // Logits: warp w dots keys t0 + w + 8 i against every head.
    for (int kk = warp; kk < kTile; kk += kWarps) {
      if (kk < n) {
        float kr[DPL];
        const int64_t row = kv_base + (t0 + kk) * kv_row;
#pragma unroll
        for (int c = 0; c < DPL; ++c) kr[c] = load1(k, k_bf16, row + lane + 32 * c);
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < DPL; ++c) dot += q_s[g * D + lane + 32 * c] * kr[c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (lane == 0) lg[g * kTile + kk] = dot;
        }
      } else if (lane == 0) {
        for (int g = 0; g < G; ++g) lg[g * kTile + kk] = kNegInf;
      }
    }
    __syncthreads();
    // Online softmax: warp g updates head g's max and sum over the tile.
    for (int g = warp; g < G; g += kWarps) {
      const float x0 = lg[g * kTile + lane];
      const float x1 = lg[g * kTile + lane + 32];
      const bool v0 = lane < n;
      const bool v1 = lane + 32 < n;
      float mx = fmaxf(v0 ? x0 : kNegInf, v1 ? x1 : kNegInf);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = st[3 * g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = v0 ? expf(x0 - m_new) : 0.f;
      const float p1 = v1 ? expf(x1 - m_new) : 0.f;
      lg[g * kTile + lane] = p0;
      lg[g * kTile + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        st[3 * g] = m_new;
        st[3 * g + 1] = alpha * st[3 * g + 1] + sum;
        st[3 * g + 2] = alpha;
      }
    }
    __syncthreads();
    // acc[g, d] = alpha_g acc[g, d] + sum_k p[g, k] v[k, d].
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int g = g_t + GSTEP * j;
      if (g < G) acc[j] *= st[3 * g + 2];
    }
    for (int kk = 0; kk < n; ++kk) {
      const float vv = load1(v, v_bf16, kv_base + (t0 + kk) * kv_row + d_t);
#pragma unroll
      for (int j = 0; j < kMaxOut; ++j) {
        const int g = g_t + GSTEP * j;
        if (g < G) acc[j] += lg[g * kTile + kk] * vv;
      }
    }
    __syncthreads();
  }

  // Partials, indexed (b * Hq + hk * G + g, split).
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int g = g_t + GSTEP * j;
    if (g < G) {
      const int64_t slot =
          (static_cast<int64_t>(b) * Hq + hk * G + g) * nsplit + sp;
      part_acc[slot * D + d_t] = acc[j];
      if (d_t == 0) {
        part_ml[2 * slot] = st[3 * g];
        part_ml[2 * slot + 1] = st[3 * g + 1];
      }
    }
  }
}

template <int D>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      void* __restrict__ out, int nsplit,
                                      int out_bf16) {
  const int64_t bhg = blockIdx.x;  // b * Hq + h
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * bhg * nsplit;
  float m = kNegInf;
  for (int i = 0; i < nsplit; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, o = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float w = expf(ml[2 * i] - m);
    l += w * ml[2 * i + 1];
    o += w * part_acc[(bhg * nsplit + i) * D + d];
  }
  const float r = o / (l == 0.f ? 1.f : l);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[bhg * D + d] = __float2bfloat16_rn(r);
  else
    static_cast<float*>(out)[bhg * D + d] = r;
}

template <int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const int32_t* kv_len, void* out, float* part_acc,
                  float* part_ml, int B, int S, int Hq, int Hkv, int nsplit,
                  int chunk, float scale, int q_bf16, int k_bf16, int v_bf16,
                  cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G * D > kMaxOut * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(G) * D + G * kTile + 3 * G) *
                      sizeof(float);
  const dim3 grid(nsplit, B * Hkv);
  decode_split_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_len, part_acc, part_ml, S, Hkv, G, chunk, scale, q_bf16,
      k_bf16, v_bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<D><<<B * Hq, D, 0, stream>>>(part_acc, part_ml, out,
                                                     nsplit, q_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int meili_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kv_len,
                                      void* out, void* part_acc,
                                      void* part_ml, int B, int S, int Hq,
                                      int Hkv, int D, int nsplit, int chunk,
                                      float scale, int q_bf16, int k_bf16,
                                      int v_bf16, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || nsplit <= 0 || chunk <= 0 ||
      B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(kv_len);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  switch (D) {
    case 64:
      return launch_decode<64>(q, k, v, len, out, pa, pm, B, S, Hq, Hkv,
                               nsplit, chunk, scale, q_bf16, k_bf16, v_bf16, s);
    case 128:
      return launch_decode<128>(q, k, v, len, out, pa, pm, B, S, Hq, Hkv,
                                nsplit, chunk, scale, q_bf16, k_bf16, v_bf16,
                                s);
    case 256:
      return launch_decode<256>(q, k, v, len, out, pa, pm, B, S, Hq, Hkv,
                                nsplit, chunk, scale, q_bf16, k_bf16, v_bf16,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
