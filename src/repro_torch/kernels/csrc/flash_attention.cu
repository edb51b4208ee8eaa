// Blocked causal / sliding-window GQA attention, forward — B5 of the port.
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel` /
// `flash_attention`. The TPU kernel walks a sequential (bh, q-block,
// kv-block) grid and carries the running (max, sum, acc) in VMEM scratch
// from one kv step to the next. Here one block owns one (batch, query head,
// 64-row query tile) and walks its key tiles in a loop, keeping the running
// triple in registers; nothing carries between blocks.
//
// What bounds it on the H100: operations. At the prefill shapes (B 4,
// S 1,024, 4 query heads over 1 KV head, D 256) a layer moves ~13 MB but
// does 4·D flops per unmasked query-key pair (~4.3-6.4 GFLOP), so the bound
// is the f32 rate of the CUDA cores (67 TFLOP/s) for f32 operands and the
// tensor cores' rate for bf16 ones.
//
// What the design does about it, simply (no wgmma or TMA yet): 256 threads,
// Q (pre-scaled), K and V tiles staged in shared memory as f32, whatever
// their dtype in memory; each thread holds a 4 x 4 block of QK^T and a
// 4 x (D/16) block of the output accumulator in registers, so each shared
// load feeds 4-16 FMAs; row max and row sum reduce over the 16 lanes that
// share a row with warp shuffles. Q and K rows are padded by 4 floats so
// the float4 reads of 8 lanes hit 32 distinct banks. Key tiles wholly
// outside the causal/window band are never visited (the main saving on the
// windowed layers), and masked probabilities are multiplied by 0 as the
// Pallas kernel does, so a row with no valid key yields 0, never
// exp(NEG_INF - NEG_INF) = 1. Ragged Sq and Sk tails are masked. At D = 256
// the tiles take 215,296 B of dynamic shared memory: one block per SM.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB on sm_90

// Four consecutive elements (index a multiple of 4) of an f32 or bf16
// array, as floats.
__device__ __forceinline__ float4 load4(const void* base, bool bf16,
                                        int64_t idx) {
  if (bf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + idx);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(base) +
                                          idx);
}

__device__ __forceinline__ void store4(void* base, bool bf16, int64_t idx,
                                       float4 x) {
  if (bf16) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + idx) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + idx) = x;
  }
}

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (D + 4) + static_cast<size_t>(kBK) * (D + 4) +
         static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const void* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, void* __restrict__ out,
                     int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                     float scale, int q_bf16, int k_bf16, int v_bf16) {
  constexpr int QS = D + 4;   // padded row stride of the Q and K tiles
  constexpr int PS = kBK + 1;  // row stride of the probability tile
  constexpr int NC = D / 64;   // float4 column groups per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * QS;
  float* v_s = k_s + kBK * QS;
  float* p_s = v_s + kBK * D;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Sk - Sq;
  const int64_t q_row = static_cast<int64_t>(Hq) * D;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * D;
  const int64_t q_base = static_cast<int64_t>(b) * Sq * q_row +
                         static_cast<int64_t>(h) * D;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_row +
                          static_cast<int64_t>(hk) * D;

  for (int i = tid; i < kBQ * (D / 4); i += kThreads) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = load4(q, q_bf16, q_base + (q0 + r) * q_row + c);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(&q_s[r * QS + c]) = x;
  }

  // Thread (rg, cg): score rows rg + 16 i and columns cg + 16 j (i, j < 4);
  // output rows rg + 16 i and columns 4 cg + 64 n .. + 3 (n < D / 64).
  const int rg = tid / 16;
  const int cg = tid % 16;
  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  // Keys the tile's rows may see; tiles wholly outside are skipped.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_last + off + 1);
  if (window > 0) k_lo = max(0, q0 + off - window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * (D / 4); i += kThreads) {
      const int r = i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < Sk) {
        const int64_t idx = kv_base + (k0 + r) * kv_row + c;
        kx = load4(k, k_bf16, idx);
        vx = load4(v, v_bf16, idx);
      }
      *reinterpret_cast<float4*>(&k_s[r * QS + c]) = kx;
      *reinterpret_cast<float4*>(&v_s[r * D + c]) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(rg + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&k_s[(cg + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
      const int qpos = row + off;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        valid[j] = row < Sq && kpos < Sk && (!causal || kpos <= qpos) &&
                   (window <= 0 || kpos > qpos - window);
        s[i][j] = valid[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(rg + 16 * i) * PS + cg + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(rg + 16 * i) * PS + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&v_s[kk * D + 4 * cg + 64 * n]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][n][0] += p[i] * vv.x;
          acc[i][n][1] += p[i] * vv.y;
          acc[i][n][2] += p[i] * vv.z;
          acc[i][n][3] += p[i] * vv.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= Sq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float4 o = make_float4(acc[i][n][0] / safe, acc[i][n][1] / safe,
                                   acc[i][n][2] / safe, acc[i][n][3] / safe);
      store4(out, q_bf16, q_base + row * q_row + 4 * cg + 64 * n, o);
    }
  }
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                 int window, float scale, int q_bf16, int k_bf16, int v_bf16,
                 cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, Sq, Sk, Hq, Hkv, causal, window, scale, q_bf16, k_bf16,
      v_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int meili_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int Hq, int Hkv, int D,
                                     int causal, int window, float scale,
                                     int q_bf16, int k_bf16, int v_bf16,
                                     void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_flash<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                              window, scale, q_bf16, k_bf16, v_bf16, s);
    case 128:
      return launch_flash<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                               window, scale, q_bf16, k_bf16, v_bf16, s);
    case 256:
      return launch_flash<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                               window, scale, q_bf16, k_bf16, v_bf16, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
