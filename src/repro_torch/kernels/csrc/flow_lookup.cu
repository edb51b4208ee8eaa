// Megaflow exact-match probe — B1 of the port.
//
// Replaces: src/repro/kernels/flow_lookup.py `_lookup_kernel` / `lookup_pallas`
// (the TPU kernel keeps the four table planes in VMEM and gathers rows of a
// (C, 1) plane, the only gather shape its lowering handles well).
//
// What bounds it on the H100: memory latency, not bandwidth or arithmetic.
// Each query hashes two words (a handful of integer ops), then reads up to
// W = 8 consecutive slots from four planes. At C = 2^17 the planes are
// 2 MiB in all: far too large for one block's shared memory, but resident
// in the 50 MB L2 after the first touch. At F = 8192 queries the useful
// traffic is ~1 MiB of window slots plus ~140 KB of queries and outputs.
//
// What the design does about it: one thread per query, the window read
// straight from global memory (L2 hits after the first batch) in slot
// order, stopping at the first live key match exactly as the reference's
// argmax does. Neighbouring queries hash to unrelated buckets, so nothing
// coalesces; the kernel leans on many threads in flight to hide the L2
// latency instead. The hash is computed in uint32_t so it wraps as the
// numpy/XLA/Mosaic versions do.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM1 = 0x9E3779B1u;
constexpr uint32_t kM2 = 0x85EBCA77u;
constexpr uint32_t kM3 = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t bucket_hash(uint32_t lo, uint32_t hi) {
  uint32_t h = (lo * kM1) ^ (hi * kM2);
  h = (h ^ (h >> 15)) * kM3;
  return h ^ (h >> 13);
}

__global__ void flow_lookup_kernel(const uint32_t* __restrict__ key_lo,
                                   const uint32_t* __restrict__ key_hi,
                                   const int32_t* __restrict__ pid,
                                   const int32_t* __restrict__ epoch,
                                   uint32_t mask,
                                   const uint32_t* __restrict__ q_lo,
                                   const uint32_t* __restrict__ q_hi,
                                   int64_t n_queries, int32_t cur_epoch,
                                   int32_t window,
                                   int32_t* __restrict__ slot_out,
                                   int32_t* __restrict__ pid_out,
                                   bool* __restrict__ fresh_out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_queries) return;
  const uint32_t lo = q_lo[i];
  const uint32_t hi = q_hi[i];
  const uint32_t base = bucket_hash(lo, hi) & mask;
  int32_t slot = -1;
  int32_t out_pid = -1;
  bool fresh = false;
  for (int32_t w = 0; w < window; ++w) {
    const uint32_t s = (base + static_cast<uint32_t>(w)) & mask;
    const int32_t p = pid[s];
    if (p >= 0 && key_lo[s] == lo && key_hi[s] == hi) {
      slot = static_cast<int32_t>(s);
      fresh = epoch[s] == cur_epoch;
      out_pid = fresh ? p : -1;
      break;
    }
  }
  slot_out[i] = slot;
  pid_out[i] = out_pid;
  fresh_out[i] = fresh;
}

}  // namespace

extern "C" int meili_flow_lookup(const void* key_lo, const void* key_hi,
                                 const void* pid, const void* epoch,
                                 long long capacity, const void* q_lo,
                                 const void* q_hi, long long n_queries,
                                 int cur_epoch, int window, void* slot_out,
                                 void* pid_out, void* fresh_out,
                                 void* stream) {
  if (n_queries <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n_queries + threads - 1) / threads;
  flow_lookup_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(epoch),
      static_cast<uint32_t>(capacity - 1), static_cast<const uint32_t*>(q_lo),
      static_cast<const uint32_t*>(q_hi), n_queries, cur_epoch, window,
      static_cast<int32_t*>(slot_out), static_cast<int32_t*>(pid_out),
      static_cast<bool*>(fresh_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* meili_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
