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
// traffic is ~1 MiB of window slots plus ~130 KB of queries and outputs,
// a few hundred nanoseconds at the memory rate; the time is the launch and
// the chain of dependent round trips each query makes.
//
// What the design does about it: a group of GW lanes (W rounded up to a
// power of two, at most a warp) takes one query. Every lane hashes the
// query and loads its own slot's key_lo, key_hi and pid, so the window's
// loads are all in flight at once (one round trip, where walking the slots
// one after another took up to W), and the W consecutive slots of a plane
// fall in one or two 32-byte sectors. A ballot over the group finds the
// live matches and __ffs takes the lowest, the reference's argmax of the
// first match; only that slot's epoch is read, by the lane that holds it.
// A window wider than the group is walked GW slots a round, stopping at
// the first round with a match. Slot indices wrap past C - 1 as
// (base + w) & (C - 1). The three results go to one (3, F) int32 buffer
// (slot, pid, fresh), so the caller moves them to the host in one copy.
// The hash is computed in uint32_t so it wraps as the numpy/XLA/Mosaic
// versions do.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM1 = 0x9E3779B1u;
constexpr uint32_t kM2 = 0x85EBCA77u;
constexpr uint32_t kM3 = 0xC2B2AE3Du;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t bucket_hash(uint32_t lo, uint32_t hi) {
  uint32_t h = (lo * kM1) ^ (hi * kM2);
  h = (h ^ (h >> 15)) * kM3;
  return h ^ (h >> 13);
}

// gw: lanes per query (a power of two, 1..32). Every lane of a warp runs
// the same number of rounds, so the ballots see the whole warp.
__global__ void __launch_bounds__(kThreads)
    flow_lookup_kernel(const uint32_t* __restrict__ key_lo,
                       const uint32_t* __restrict__ key_hi,
                       const int32_t* __restrict__ pid,
                       const int32_t* __restrict__ epoch, uint32_t mask,
                       const uint32_t* __restrict__ q_lo,
                       const uint32_t* __restrict__ q_hi, int64_t n_queries,
                       int32_t cur_epoch, int32_t window, int gw,
                       int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (gw - 1);              // lane within the group
  const int first_lane = lane - sub;
  const uint32_t group_bits =
      gw == 32 ? 0xffffffffu : ((1u << gw) - 1u) << first_lane;
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x) / gw;
  const bool live = i < n_queries;
  uint32_t lo = 0, hi = 0;
  if (live) {
    lo = q_lo[i];
    hi = q_hi[i];
  }
  const uint32_t base = bucket_hash(lo, hi) & mask;
  int32_t slot = -1, out_pid = -1, fresh = 0;
  bool found = false;
  for (int32_t w0 = 0; w0 < window; w0 += gw) {
    const int32_t w = w0 + sub;
    const uint32_t s = (base + static_cast<uint32_t>(w)) & mask;
    bool match = false;
    int32_t p = -1;
    if (live && !found && w < window) {
      p = pid[s];
      const uint32_t klo = key_lo[s];
      const uint32_t khi = key_hi[s];
      match = p >= 0 && klo == lo && khi == hi;
    }
    const uint32_t hits = __ballot_sync(0xffffffffu, match) & group_bits;
    if (hits != 0 && !found) {
      const int win = __ffs(hits) - 1;          // the lowest matching lane
      found = true;
      if (lane == win) {
        slot = static_cast<int32_t>(s);
        fresh = epoch[s] == cur_epoch;
        out_pid = fresh ? p : -1;
      }
      slot = __shfl_sync(group_bits, slot, win);
      out_pid = __shfl_sync(group_bits, out_pid, win);
      fresh = __shfl_sync(group_bits, fresh, win);
    }
    if (__all_sync(0xffffffffu, found || !live)) break;
  }
  if (live && sub == 0) {
    out[i] = slot;
    out[n_queries + i] = out_pid;
    out[2 * n_queries + i] = fresh;
  }
}

}  // namespace

// out: (3, n_queries) int32 rows slot, pid, fresh (0 or 1).
extern "C" int meili_flow_lookup(const void* key_lo, const void* key_hi,
                                 const void* pid, const void* epoch,
                                 long long capacity, const void* q_lo,
                                 const void* q_hi, long long n_queries,
                                 int cur_epoch, int window, void* out,
                                 void* stream) {
  if (n_queries <= 0) return 0;
  if (window < 1 || capacity < 1 || (capacity & (capacity - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int gw = 1;
  while (gw < window && gw < 32) gw <<= 1;
  const long long blocks = (n_queries * gw + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flow_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(epoch),
      static_cast<uint32_t>(capacity - 1), static_cast<const uint32_t*>(q_lo),
      static_cast<const uint32_t*>(q_hi), n_queries, cur_epoch, window, gw,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* meili_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
