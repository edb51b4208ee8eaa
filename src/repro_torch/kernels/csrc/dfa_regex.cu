// Aho-Corasick dense-DFA scan — B2 of the port (the regex accelerator).
//
// Replaces: src/repro/kernels/dfa_regex.py `_dfa_kernel` / `dfa_regex`. The
// TPU kernel has no 2-D gather, so it steps a vector of packet states with
// a one-hot times the transposed table; here `table[state][byte]` is one
// shared-memory load.
//
// What bounds it on the H100: the dependent chain. Each packet is a serial
// walk over min(length, L) bytes (~1,500 at the main path's shapes): every
// step's table row depends on the previous step's state, so a thread does
// ~1,500 shared-memory lookups back to back plus one `out_count` lookup
// each. The payload bytes are read once (B·L bytes, 24.6 MB at 16,384 ×
// 1,500), but across a warp the reads are strided by L bytes.
//
// What the design does about it: one thread per packet, the whole
// transition table and `out_count` in shared memory (S·256·4 + S·4 bytes;
// 44,204 B for the SNORT_RULES DFA with S = 43), loaded once per block.
// Tables above 48 KB opt in to dynamic shared memory with
// cudaFuncSetAttribute; above 227 KB the launch is refused. When rows are
// 4-byte aligned each thread reads its payload one 32-bit word at a time,
// so a warp's strided reads are 4x fewer and each 128-byte line it pulls
// into L1 serves 32 of its steps. `length` is clamped to [0, L], so pad
// rows holding stale ring data are safe.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB on sm_90

__device__ __forceinline__ void dfa_step(uint32_t byte, int32_t& state,
                                         int32_t& matches,
                                         const int32_t* table,
                                         const int32_t* out_count) {
  state = table[state * 256 + static_cast<int32_t>(byte)];
  matches += out_count[state];
}

__global__ void dfa_regex_kernel(const uint8_t* __restrict__ payload,
                                 int64_t n_rows, int64_t row_len,
                                 const int32_t* __restrict__ length,
                                 const int32_t* __restrict__ table_g,
                                 const int32_t* __restrict__ out_count_g,
                                 int32_t n_states, bool word_aligned,
                                 int32_t* __restrict__ matches_out) {
  extern __shared__ int32_t smem[];
  int32_t* table = smem;
  int32_t* out_count = smem + n_states * 256;
  for (int32_t i = threadIdx.x; i < n_states * 256; i += blockDim.x)
    table[i] = table_g[i];
  for (int32_t i = threadIdx.x; i < n_states; i += blockDim.x)
    out_count[i] = out_count_g[i];
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  int64_t n = length[row];
  n = n < 0 ? 0 : (n > row_len ? row_len : n);
  const uint8_t* p = payload + row * row_len;
  int32_t state = 0;
  int32_t matches = 0;
  int64_t j = 0;
  if (word_aligned) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
    for (; j + 4 <= n; j += 4) {
      const uint32_t w = pw[j >> 2];
      dfa_step(w & 0xFFu, state, matches, table, out_count);
      dfa_step((w >> 8) & 0xFFu, state, matches, table, out_count);
      dfa_step((w >> 16) & 0xFFu, state, matches, table, out_count);
      dfa_step(w >> 24, state, matches, table, out_count);
    }
  }
  for (; j < n; ++j) dfa_step(p[j], state, matches, table, out_count);
  matches_out[row] = matches;
}

}  // namespace

extern "C" int meili_dfa_regex(const void* payload, long long n_rows,
                               long long row_len, const void* length,
                               const void* table, const void* out_count,
                               int n_states, void* matches_out, void* stream) {
  if (n_rows <= 0) return 0;
  const size_t smem = (static_cast<size_t>(n_states) * 256 + n_states) *
                      sizeof(int32_t);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        dfa_regex_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool word_aligned =
      (row_len % 4 == 0) && (reinterpret_cast<uintptr_t>(payload) % 4 == 0);
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  dfa_regex_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), n_rows, row_len,
      static_cast<const int32_t*>(length), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(out_count), n_states, word_aligned,
      static_cast<int32_t*>(matches_out));
  return static_cast<int>(cudaGetLastError());
}
