// ARX cipher and keyed fold digest — B3 and B4 of the port (the AES and SHA
// accelerator analogs).
//
// Replaces: src/repro/kernels/crypto.py `_cipher_kernel` / `arx_cipher` (B3)
// and `_hash_kernel` / `keyed_hash` (B4), whose bodies are the jnp oracles
// `ref.arx_cipher` / `ref.keyed_hash` run over VMEM tiles of (block_b, W)
// words.
//
// What bounds them on the H100:
//   * B3 is elementwise: 8 rounds of ~12 integer ops per 32-bit word, so
//     ~25 ops per byte moved against the card's ~20 int32 ops per byte of
//     HBM bandwidth. Reading and writing B·W words (2 × 24.6 MB at 16,384 ×
//     375) is the bound.
//   * B4 is a serial chain over the W words of each row: every step needs
//     the previous step's four-word state. The only parallelism is over
//     rows, B threads in all (16,384 at the main path's shapes, ~124 per
//     SM), so latency, not bandwidth, limits it; the bytes (24.6 MB in,
//     256 KB out) bound it from below.
//
// What the design does about it: B3 runs one thread per word over a flat
// grid-stride loop, so a warp reads and writes 128 contiguous bytes and the
// key words stay in registers; each word's column index is its lane, as in
// the reference. B4 runs one thread per row, walking its row in order so
// each 128-byte line it pulls into L1 serves 32 steps. All arithmetic is
// uint32_t, which wraps as the numpy/XLA versions do.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kRounds = 8;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

__global__ void arx_cipher_kernel(const uint32_t* __restrict__ words,
                                  int64_t n_words, int64_t width,
                                  const uint32_t* __restrict__ key,
                                  uint32_t* __restrict__ out) {
  uint32_t rk[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    rk[r] = key[r & 3] + static_cast<uint32_t>(r) * kGolden;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_words; i += stride) {
    const uint32_t lane = static_cast<uint32_t>(i % width);
    uint32_t x = words[i];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      x += rk[r];
      x = rotl(x, 5) ^ (x + lane);
      x = (x ^ rotl(x, 13)) + rotl(x, 7);
    }
    out[i] = x;
  }
}

__global__ void keyed_hash_kernel(const uint32_t* __restrict__ words,
                                  int64_t n_rows, int64_t width,
                                  const uint32_t* __restrict__ key,
                                  uint32_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  uint32_t h0 = key[0], h1 = key[1], h2 = key[2], h3 = key[3];
  const uint32_t* w = words + row * width;
  for (int64_t j = 0; j < width; ++j) {
    const uint32_t n0 = h0 + w[j];
    const uint32_t n1 = h1 ^ rotl(n0, 11);
    const uint32_t n2 = h2 + rotl(n1, 7);
    const uint32_t n3 = h3 ^ (n2 + kGolden);
    h0 = n1;
    h1 = n2;
    h2 = n3;
    h3 = n0;
  }
  uint32_t* o = out + row * 4;
  o[0] = h0;
  o[1] = h1;
  o[2] = h2;
  o[3] = h3;
}

}  // namespace

extern "C" int meili_arx_cipher(const void* words, long long n_rows,
                                long long width, const void* key, void* out,
                                void* stream) {
  const long long n = n_rows * width;
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride past this
  arx_cipher_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, width,
      static_cast<const uint32_t*>(key), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meili_keyed_hash(const void* words, long long n_rows,
                                long long width, const void* key, void* out,
                                void* stream) {
  if (n_rows <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n_rows + threads - 1) / threads;
  keyed_hash_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_rows, width,
      static_cast<const uint32_t*>(key), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
