// ARX cipher and keyed fold digest — B3 and B4 of the port (the AES and SHA
// accelerator analogs).
//
// Replaces: src/repro/kernels/crypto.py `_cipher_kernel` / `arx_cipher` (B3)
// and `_hash_kernel` / `keyed_hash` (B4), whose bodies are the jnp oracles
// `ref.arx_cipher` / `ref.keyed_hash` run over VMEM tiles of (block_b, W)
// words.
//
// What bounds them on the H100:
//   * B3 is elementwise: 8 rounds of ~8 integer ops per 32-bit word. Reading
//     and writing B·W words (2 × 49.2 MB at 32,768 × 375) is the bound,
//     with the integer work close behind it (the card has half as many
//     32-bit integer lanes as f32 ones).
//   * B4 is a serial chain over the W words of each row: every step needs
//     the previous step's four-word state, and the fold mixes adds and xors,
//     so it is not associative and cannot be split. The only parallelism is
//     over rows (B threads in all, ~248 an SM at 32,768 rows), and each
//     row's chain is ~375 × 4 dependent ALU ops, a few microseconds. The
//     bytes (49.2 MB in) bound it from below.
//
// What the design does about it:
// - B3: each thread takes 16 bytes, 4 words, with one vector load and one
//   vector store (grid-stride over the aligned body; the few words before
//   the first 16-byte boundary and after the last are taken one by one).
//   A word's column (its lane in the reference) is kept incrementally in
//   32-bit: no division in the loop. The 8 round keys stay in registers.
// - B4: a block of kHashRows rows (one thread each) walks its rows in
//   column stages of kHashChunks 16-byte chunks, staged into shared memory
//   with cp.async kHashStages - 1 stages ahead, so the copy of the next
//   stages overlaps the walk of this one and no step waits on device memory.
//   Each row's stages are aligned in its own chunk space: chunk c of row r
//   is the 16-byte chunk c of the row counted from the one that holds its
//   first word, so a row of any length at any 4-byte alignment is read in
//   whole aligned chunks (words of the neighbouring rows in its first and
//   last chunk are skipped). A row's slot in a stage is kHashChunks + 1
//   chunks wide, an odd number, so the block's 16-byte reads of a stage,
//   one row a thread, fall on distinct bank groups.
// All arithmetic is uint32_t, which wraps as the numpy/XLA versions do.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kRounds = 8;

constexpr int kCipherThreads = 256;
constexpr int kCipherBlocksPerSM = 8;   // 2,048 threads: a full SM

// (on the H100 fewer, wider stages were faster: 16 chunks in 2 stages beat
// 8 in 4, and 4 in 8 was slower still)
constexpr int kHashRows = 64;           // rows (threads) a block
constexpr int kHashChunks = 16;         // 16-byte chunks a row a stage
constexpr int kHashStages = 2;          // stages in flight, this one included
constexpr int kHashSlot = (kHashChunks + 1) * 4;   // words a row a stage

__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

__device__ __forceinline__ uint32_t cipher(uint32_t x, uint32_t lane,
                                           const uint32_t (&rk)[kRounds]) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    x += rk[r];
    x = rotl(x, 5) ^ (x + lane);
    x = (x ^ rotl(x, 13)) + rotl(x, 7);
  }
  return x;
}

// words/out: n words of rows of `width`; `head` words (0-3) lie before the
// first 16-byte boundary of both, n_vec 16-byte vectors follow, then
// `tail` words (0-3), the first of them in column `tail_col`. Column of
// word i: i % width.
__global__ void __launch_bounds__(kCipherThreads)
    arx_cipher_kernel(const uint32_t* __restrict__ words, uint32_t n_vec,
                      uint32_t head, uint32_t tail, uint32_t tail_col,
                      uint32_t width, const uint32_t* __restrict__ key,
                      uint32_t* __restrict__ out) {
  uint32_t rk[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    rk[r] = key[r & 3] + static_cast<uint32_t>(r) * kGolden;
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t threads = gridDim.x * blockDim.x;
  // the head and the tail, one word a thread (at most 6 words)
  if (tid < head + tail) {
    const bool in_head = tid < head;
    const uint64_t i = in_head ? tid : head + 4ull * n_vec + (tid - head);
    const uint32_t c =
        in_head ? tid % width : (tail_col + tid - head) % width;
    out[i] = cipher(words[i], c, rk);
  }
  const uint4* src = reinterpret_cast<const uint4*>(words + head);
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  // column of the first word of vector v = tid, advanced by `step` a round
  uint32_t col = (head + 4u * tid) % width;
  const uint32_t step = (4u * threads) % width;
  for (uint32_t v = tid; v < n_vec; v += threads) {
    const uint4 x = src[v];
    uint32_t c[4];
    c[0] = col;
#pragma unroll
    for (int e = 1; e < 4; ++e)
      c[e] = c[e - 1] + 1 == width ? 0 : c[e - 1] + 1;
    dst[v] = make_uint4(cipher(x.x, c[0], rk), cipher(x.y, c[1], rk),
                        cipher(x.z, c[2], rk), cipher(x.w, c[3], rk));
    col += step;
    if (col >= width) col -= width;
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void hash_step(uint32_t w, uint32_t& h0,
                                          uint32_t& h1, uint32_t& h2,
                                          uint32_t& h3) {
  const uint32_t n0 = h0 + w;
  const uint32_t n1 = h1 ^ rotl(n0, 11);
  const uint32_t n2 = h2 + rotl(n1, 7);
  const uint32_t n3 = h3 ^ (n2 + kGolden);
  h0 = n1;
  h1 = n2;
  h2 = n3;
  h3 = n0;
}

// One block: rows row0 .. row0 + kHashRows - 1, thread t on row row0 + t.
// Row r's words start `off` words into the 16-byte chunk that holds its
// first word (chunk 0 of its chunk space); its n_chunks chunks cover
// off + width words.
__global__ void __launch_bounds__(kHashRows)
    keyed_hash_kernel(const uint32_t* __restrict__ words, int64_t n_rows,
                      int32_t width, const uint32_t* __restrict__ key,
                      uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t stage[kHashStages][kHashRows][kHashSlot];
  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kHashRows;
  const int rows = n_rows - row0 < kHashRows
                       ? static_cast<int>(n_rows - row0) : kHashRows;
  // every row of the block spans at most this many chunks
  const int32_t n_chunks = (width + 3 + 3) / 4;
  const int32_t n_stages = (n_chunks + kHashChunks - 1) / kHashChunks;

  // copy stage s of every row: chunk k of stage s of row r is chunk
  // s·kHashChunks + k of its chunk space, if the row has it
  auto issue = [&](int32_t s) {
    if (s < n_stages) {
      for (int i = t; i < rows * kHashChunks; i += kHashRows) {
        const int r = i / kHashChunks;
        const int k = i % kHashChunks;
        const uintptr_t first = reinterpret_cast<uintptr_t>(
            words + (row0 + r) * static_cast<int64_t>(width));
        const uintptr_t chunk0 = first & ~static_cast<uintptr_t>(15);
        const int32_t have = static_cast<int32_t>(
            ((first & 15) / 4 + width + 3) / 4);
        const int32_t c = s * kHashChunks + k;
        if (c < have)
          cp_async16(&stage[s % kHashStages][r][k * 4],
                     reinterpret_cast<const void*>(chunk0 + 16 * c));
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kHashStages - 1; ++s) issue(s);

  uint32_t h0 = key[0], h1 = key[1], h2 = key[2], h3 = key[3];
  const bool live = t < rows;
  const int32_t off = live ? static_cast<int32_t>(
      (reinterpret_cast<uintptr_t>(words + (row0 + t) *
                                   static_cast<int64_t>(width)) & 15) / 4)
                           : 0;
  const int32_t end = off + width;    // the row's words: [off, end)
  for (int32_t s = 0; s < n_stages; ++s) {
    cp_async_wait<kHashStages - 2>();   // this thread's copies of stage s
    __syncthreads();                    // ... and everyone's; s - 1 is free
    issue(s + kHashStages - 1);
    if (live) {
      const uint4* slot =
          reinterpret_cast<const uint4*>(&stage[s % kHashStages][t][0]);
      const int32_t w0 = s * kHashChunks * 4;   // word of the stage's start
      if (w0 >= off && w0 + kHashChunks * 4 <= end) {
#pragma unroll
        for (int k = 0; k < kHashChunks; ++k) {
          const uint4 x = slot[k];
          hash_step(x.x, h0, h1, h2, h3);
          hash_step(x.y, h0, h1, h2, h3);
          hash_step(x.z, h0, h1, h2, h3);
          hash_step(x.w, h0, h1, h2, h3);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kHashChunks; ++k) {
          const uint4 x = slot[k];
          const uint32_t v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int32_t p = w0 + 4 * k + e;
            if (p >= off && p < end) hash_step(v[e], h0, h1, h2, h3);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (live)
    reinterpret_cast<uint4*>(out)[row0 + t] = make_uint4(h0, h1, h2, h3);
}

}  // namespace

extern "C" int meili_arx_cipher(const void* words, long long n_rows,
                                long long width, const void* key, void* out,
                                void* stream) {
  const long long n = n_rows * width;
  if (n <= 0) return 0;
  const uintptr_t in_at = reinterpret_cast<uintptr_t>(words);
  const uintptr_t out_at = reinterpret_cast<uintptr_t>(out);
  // both must sit at the same place within a 16-byte chunk
  if (in_at % 4 || (in_at - out_at) % 16 || width >= (1LL << 31) ||
      n / 4 >= (1LL << 32) - 132LL * kCipherBlocksPerSM * kCipherThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  long long head = ((16 - in_at % 16) % 16) / 4;
  if (head > n) head = n;
  const long long n_vec = (n - head) / 4;
  const long long tail = n - head - 4 * n_vec;
  const long long tail_col = (head + 4 * n_vec) % width;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n_vec + kCipherThreads - 1) / kCipherThreads;
  if (blocks > static_cast<long long>(sms) * kCipherBlocksPerSM)
    blocks = static_cast<long long>(sms) * kCipherBlocksPerSM;
  if (blocks < 1) blocks = 1;
  arx_cipher_kernel<<<static_cast<unsigned>(blocks), kCipherThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t>(n_vec),
      static_cast<uint32_t>(head), static_cast<uint32_t>(tail),
      static_cast<uint32_t>(tail_col), static_cast<uint32_t>(width),
      static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `out` must be 16-byte aligned (one 16-byte digest a row).
extern "C" int meili_keyed_hash(const void* words, long long n_rows,
                                long long width, const void* key, void* out,
                                void* stream) {
  if (n_rows <= 0) return 0;
  if (width <= 0 || width > (1LL << 30) ||
      reinterpret_cast<uintptr_t>(words) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_rows + kHashRows - 1) / kHashRows;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  keyed_hash_kernel<<<static_cast<unsigned>(blocks), kHashRows, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_rows,
      static_cast<int32_t>(width), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
