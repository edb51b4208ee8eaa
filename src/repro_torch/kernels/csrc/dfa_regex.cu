// Aho-Corasick dense-DFA scan — B2 of the port (the regex accelerator).
//
// Replaces: src/repro/kernels/dfa_regex.py `_dfa_kernel` / `dfa_regex`. The
// TPU kernel has no 2-D gather, so it steps a vector of packet states with
// a one-hot times the transposed table; here `table[state][byte]` is one
// shared-memory load.
//
// What bounds it on the H100: the dependent chain of table lookups. Each
// packet is a serial walk over min(length, L) bytes (~1,500 at the main
// path's shapes), and every step's table row depends on the previous
// step's state. The payload bytes are read once (B·L bytes, 49 MB at
// 32,768 × 1,500), which is the bound by bytes, 0.0148 ms.
//
// What the design does about it:
// - One lookup a step. The wrapper packs each entry as
//   `next | out_count[next] << 16` once per rule set; the block keeps it in
//   shared memory as `next << 8 | count << 16`, so the next row's index is
//   `entry & 0xFFFF | byte` and the count is `entry >> 16` (S <= 227, the
//   most a block's shared memory holds, counts below 2^16).
// - Every other table the reference takes is wide: 16-bit next states
//   (512 B a state; 32-bit past 65,536 states) beside a per-state int32
//   count, so a step is one lookup on the chain and one beside it. Up to
//   ~390 states it lives in shared memory with the payload stages (~450
//   without them); past that the walk reads it from device memory, where
//   L2 keeps it (1,000 states are ~0.5 MB).
// - Many walks in flight. A packet is cut into `segs` segments walked by
//   neighbouring lanes; segment i > 0 starts at state 0, `depth` bytes
//   before its first byte (the table's synchronisation depth: after any
//   `depth` bytes the state no longer depends on where the walk began), and
//   counts from its first byte, so the lanes' counts, summed by shuffles,
//   equal the serial walk's bit for bit. At 32,768 packets, 4 segments give
//   each SM a block of 1,024 walks, 32 warps. The walk is bound by the
//   shared-memory lookups (a warp's 32 lookups land on random banks), so
//   more segments only add warm-up steps (on the H100, 8 segments in two
//   blocks an SM took longer than 4 in one).
// - The payload through shared memory. Each thread streams its own bytes
//   in 16-byte chunks, each copied with cp.async while the walk takes the
//   one before it, into a slot of its own ([stage][thread], so a warp's
//   16-byte reads of its slots are conflict-free): no step waits on device
//   memory.
//   The chunks are 16-byte aligned in memory, so a walk's first chunk may
//   start up to 15 bytes before its first byte: those steps are skipped. A
//   chunk at the end of the payload copies only the bytes that exist.
// - A payload that does not start 16-byte aligned (a view with an offset),
//   or a table that leaves no shared memory for the stages, takes the same
//   walk with its chunks read byte by byte from device memory.
// `length` is clamped to [0, L], so pad rows holding stale ring data are
// safe.
#include <cstdint>
#include <cuda_runtime.h>

// The block's dynamic shared memory: the table (where it lives there), then
// the payload stages. Named at file scope so every access to it compiles
// to a shared-memory load.
extern __shared__ __align__(16) unsigned char dfa_smem[];

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 16;
constexpr int kStages = 2;
constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB on sm_90

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The table forms. `setup` puts the table where the walk reads it (copied
// into shared memory by the whole block, or left in device memory);
// `step` moves the state over one byte and returns the count of the state
// it enters. `smem_bytes` is the shared memory the table takes, from the
// start of dfa_smem.
__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Packed: `next << 8 | count << 16` in shared memory; the state is kept as
// its row offset, next << 8.
struct PackedTable {
  __host__ __device__ static size_t smem_bytes(int32_t S) {
    return static_cast<size_t>(S) * 256 * sizeof(uint32_t);
  }
  __device__ void setup(const void* entries, const int32_t*, int32_t S) {
    const uint32_t* packed = static_cast<const uint32_t*>(entries);
    uint32_t* t = reinterpret_cast<uint32_t*>(dfa_smem);
    for (int32_t i = threadIdx.x; i < S * 256; i += kThreads) {
      const uint32_t e = packed[i];
      t[i] = ((e & 0xFFFFu) << 8) | (e & 0xFFFF0000u);
    }
  }
  __device__ __forceinline__ uint32_t step(uint32_t& state,
                                           uint32_t byte) const {
    const uint32_t e =
        reinterpret_cast<const uint32_t*>(dfa_smem)[state | byte];
    state = e & 0xFFFFu;
    return e >> 16;
  }
};

// Wide: next states of type E and int32 counts, in shared memory (SHARED)
// or read from device memory through the read-only path.
template <typename E, bool SHARED>
struct WideTable {
  const E* next;               // device memory (SHARED false)
  const uint32_t* count;
  uint32_t count_at;           // byte offset of the counts in dfa_smem
  __host__ __device__ static size_t smem_bytes(int32_t S) {
    return SHARED ? align16(static_cast<size_t>(S) * 256 * sizeof(E)) +
                        align16(static_cast<size_t>(S) * sizeof(uint32_t))
                  : 0;
  }
  __device__ void setup(const void* entries, const int32_t* counts,
                        int32_t S) {
    if constexpr (SHARED) {
      // S·256·sizeof(E) is a multiple of 16: whole 16-byte copies
      const uint4* src = static_cast<const uint4*>(entries);
      uint4* dst = reinterpret_cast<uint4*>(dfa_smem);
      const int32_t n16 = S * 256 * static_cast<int32_t>(sizeof(E)) / 16;
      for (int32_t i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
      count_at = static_cast<uint32_t>(
          align16(static_cast<size_t>(S) * 256 * sizeof(E)));
      uint32_t* c = reinterpret_cast<uint32_t*>(dfa_smem + count_at);
      for (int32_t i = threadIdx.x; i < S; i += kThreads)
        c[i] = static_cast<uint32_t>(counts[i]);
    } else {
      next = static_cast<const E*>(entries);
      count = reinterpret_cast<const uint32_t*>(counts);
    }
  }
  __device__ __forceinline__ uint32_t step(uint32_t& state,
                                           uint32_t byte) const {
    if constexpr (SHARED) {
      state = reinterpret_cast<const E*>(dfa_smem)[(state << 8) | byte];
      return reinterpret_cast<const uint32_t*>(dfa_smem + count_at)[state];
    } else {
      state = __ldg(next + ((state << 8) | byte));
      return __ldg(count + state);
    }
  }
};

// One walk's position: row-relative byte offsets. Steps at p < warm are
// skipped, steps at p >= end are skipped, and a step's count is kept from
// p >= first on.
struct Walk {
  int32_t warm, first, end;
};

// Step over the 16 bytes of `w`, the first at row offset p0.
template <class Table>
__device__ __forceinline__ void walk16(const uint4& w, int32_t p0,
                                       const Walk& r, const Table& tbl,
                                       uint32_t& state, uint32_t& matches) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  if (p0 >= r.first && p0 + kChunk <= r.end) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int s = 0; s < 32; s += 8)
        matches += tbl.step(state, (words[i] >> s) & 0xFFu);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int32_t p = p0 + 4 * i + s;
      if (p >= r.warm && p < r.end) {
        const uint32_t c = tbl.step(state, (words[i] >> (8 * s)) & 0xFFu);
        if (p >= r.first) matches += c;
      }
    }
  }
}

// CH == 1: 16-byte chunks staged through shared memory, one a stage, two
// stages; CH == 0: chunks read byte by byte from device memory. Table: one
// of the forms above.
template <int CH, class Table>
__global__ void __launch_bounds__(kThreads, 1)
    dfa_regex_kernel(const uint8_t* __restrict__ payload, int64_t n_rows,
                     int32_t row_len, const int32_t* __restrict__ length,
                     const void* __restrict__ entries,
                     const int32_t* __restrict__ counts, int32_t n_states,
                     int32_t depth, int32_t segs,
                     int32_t* __restrict__ matches_out) {
  Table tbl;
  tbl.setup(entries, counts, n_states);
  __syncthreads();

  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t row = gid / segs;
  const int32_t seg = static_cast<int32_t>(gid % segs);
  uint32_t state = 0, matches = 0;
  Walk r{0, 0, 0};
  if (row < n_rows) {
    const int32_t n = max(0, min(length[row], row_len));
    const int32_t span = (row_len + segs - 1) / segs;
    r.first = seg * span;
    r.warm = seg == 0 ? 0 : max(0, r.first - depth);
    r.end = min(r.first + span, n);
  }
  if (r.first < r.end) {
    const uint8_t* row_ptr = payload + row * row_len;
    // chunk k holds row offsets [p_base + 16 k, p_base + 16 k + 16)
    const int32_t p_base =
        r.warm - static_cast<int32_t>(
                     (reinterpret_cast<uintptr_t>(row_ptr) + r.warm) % kChunk);
    const int32_t n_chunks = (r.end - p_base + kChunk - 1) / kChunk;
    if constexpr (CH > 0) {
      const uint8_t* src = row_ptr + p_base;                // 16-byte aligned
      // bytes the payload still holds from the last chunk on
      const int64_t left = n_rows * row_len -
                           (row * row_len + p_base + (n_chunks - 1) * kChunk);
      const int tail = left < kChunk ? static_cast<int>(left) : kChunk;
      uint4* mine = reinterpret_cast<uint4*>(
                        dfa_smem + Table::smem_bytes(n_states)) +
                    threadIdx.x;                 // [stage][chunk][thread]
      const int32_t n_stages = (n_chunks + CH - 1) / CH;
      auto issue = [&](int32_t s) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int32_t k = s * CH + c;
          if (k < n_chunks)
            cp_async16(mine + ((s % kStages) * CH + c) * kThreads,
                       src + k * kChunk, k == n_chunks - 1 ? tail : kChunk);
        }
        cp_async_commit();
      };
      issue(0);
      issue(1);
      for (int32_t s = 0; s < n_stages; ++s) {
        cp_async_wait_one();
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int32_t k = s * CH + c;
          if (k < n_chunks)
            walk16(mine[((s % kStages) * CH + c) * kThreads],
                   p_base + k * kChunk, r, tbl, state, matches);
        }
        issue(s + 2);
      }
    } else {
      for (int32_t k = 0; k < n_chunks; ++k) {
        const int32_t p0 = p_base + k * kChunk;
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int b = 0; b < kChunk; ++b) {
          const int32_t p = p0 + b;
          if (p >= r.warm && p < r.end)
            w[b / 4] |= static_cast<uint32_t>(row_ptr[p]) << (8 * (b % 4));
        }
        walk16(make_uint4(w[0], w[1], w[2], w[3]), p0, r, tbl, state,
               matches);
      }
    }
  }
  // the segments of a packet are neighbouring lanes: sum their counts
  for (int o = segs / 2; o > 0; o >>= 1)
    matches += __shfl_xor_sync(0xffffffffu, matches, o);
  if (row < n_rows && seg == 0)
    matches_out[row] = static_cast<int32_t>(matches);
}

template <int CH, class Table>
int launch(const void* payload, long long n_rows, long long row_len,
           const void* length, const void* entries, const void* counts,
           int n_states, int depth, int segs, void* matches_out,
           cudaStream_t stream) {
  const size_t smem = Table::smem_bytes(n_states) +
                      static_cast<size_t>(kStages) * CH * kChunk * kThreads;
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        dfa_regex_kernel<CH, Table>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_rows * segs + kThreads - 1) / kThreads;
  dfa_regex_kernel<CH, Table><<<static_cast<unsigned>(blocks), kThreads, smem,
                                stream>>>(
      static_cast<const uint8_t*>(payload), n_rows,
      static_cast<int32_t>(row_len), static_cast<const int32_t*>(length),
      entries, static_cast<const int32_t*>(counts), n_states,
      depth < 0 ? 0 : depth, segs, static_cast<int32_t*>(matches_out));
  return static_cast<int>(cudaGetLastError());
}

// A payload that does not start 16-byte aligned is read byte by byte.
template <class Table>
int dispatch(const void* payload, long long n_rows, long long row_len,
             const void* length, const void* entries, const void* counts,
             int n_states, int depth, int segs, int chunks,
             void* matches_out, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(payload) % kChunk || chunks == 0)
    return launch<0, Table>(payload, n_rows, row_len, length, entries, counts,
                            n_states, depth, segs, matches_out, s);
  return launch<1, Table>(payload, n_rows, row_len, length, entries, counts,
                          n_states, depth, segs, matches_out, s);
}

}  // namespace

// `form`: 0 the packed table (in shared memory; `counts` unused), 2 the wide
// table with 16-bit next states, 4 with 32-bit ones; `shared`: whether the
// wide table goes to shared memory or is read from device memory.
extern "C" int meili_dfa_regex(const void* payload, long long n_rows,
                               long long row_len, const void* length,
                               const void* entries, const void* counts,
                               int n_states, int form, int shared, int depth,
                               int segs, int chunks, void* matches_out,
                               void* stream) {
  if (n_rows <= 0) return 0;
  if (n_states <= 0 || segs <= 0 || segs > 32 || (segs & (segs - 1)) != 0 ||
      (depth < 0 && segs != 1) || chunks < 0 || chunks > 1 || row_len < 0 ||
      row_len > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0 && shared && n_states <= 256)
    return dispatch<PackedTable>(payload, n_rows, row_len, length, entries,
                                 counts, n_states, depth, segs, chunks,
                                 matches_out, s);
  if (form == 2 && counts && n_states <= 65536)
    return shared ? dispatch<WideTable<uint16_t, true>>(
                        payload, n_rows, row_len, length, entries, counts,
                        n_states, depth, segs, chunks, matches_out, s)
                  : dispatch<WideTable<uint16_t, false>>(
                        payload, n_rows, row_len, length, entries, counts,
                        n_states, depth, segs, chunks, matches_out, s);
  if (form == 4 && counts && !shared && n_states < (1 << 24))
    return dispatch<WideTable<uint32_t, false>>(
        payload, n_rows, row_len, length, entries, counts, n_states, depth,
        segs, chunks, matches_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
