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
// unmasked (row, key) pair (QKᵀ and dO Vᵀ twice, once per kernel below, and
// dV, dK, dQ). This first version is simple and exact rather than fast:
// every product is a plain f32 FMA on the CUDA cores, from tiles staged in
// shared memory, far from the 3xTF32 tensor-core rate its bound is taken
// at.
//
// What the design does about the rest:
// - No float atomics, so a run is bit-reproducible. One kernel owns a tile
//   of 32 keys of one KV head and walks every query row that may see it,
//   summing dK and dV in registers; a second owns a tile of 32 query rows
//   and walks the keys they may see, summing dQ. Both recompute p and ds.
//   A third, first, computes delta.
// - Rows are (position, head) pairs of one KV head, position-major, so a
//   tile of rows covers all G heads that share the key tile's K and V.
// - Tiles outside the causal/window band are never visited; inside, the
//   mask is applied per entry. Keys past Sk and rows past Sq are
//   zero-filled and masked.
// - Shared-memory rows are padded by 4 floats and read as float4, so the
//   eight lanes of a quarter-warp read eight different bank groups.
// All tensors are f32 and contiguous: q, o, dO, dq (B, Sq, Hq, D); k, v,
// dk, dv (B, Sk, Hkv, D); lse, delta (B, Hq, Sq).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBR = 32;   // query rows per tile
constexpr int kBK = 32;   // keys per tile
constexpr size_t kStaticSmemLimit = 48 * 1024;

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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* delta, float* dq, float* dk, float* dv, int B,
               const Shape& sh, cudaStream_t stream) {
  using T = Tile<D>;
  const size_t smem = T::SMEM_FLOATS * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, smem);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(B) * sh.Sq * sh.Hq;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                           stream>>>(o, dout, delta, rows, sh.Sq, sh.Hq, D);
  err = cudaGetLastError();
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
      return launch_bwd<16>(fq, fk, fv, fo, fd, fl, fdl, gq, gk, gv, B, sh, s);
    case 64:
      return launch_bwd<64>(fq, fk, fv, fo, fd, fl, fdl, gq, gk, gv, B, sh, s);
    case 128:
      return launch_bwd<128>(fq, fk, fv, fo, fd, fl, fdl, gq, gk, gv, B, sh,
                             s);
    case 256:
      return launch_bwd<256>(fq, fk, fv, fo, fd, fl, fdl, gq, gk, gv, B, sh,
                             s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
