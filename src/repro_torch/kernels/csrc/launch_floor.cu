// Floors under the port's kernel times, timed the way the kernels are.
//
// launch_floor_kernel does nothing: one block of one thread. It gives the
// least device time any launch takes on the card, the floor under the small
// kernels' times.
//
// read_floor_kernel reads a buffer once, 16 bytes a thread in a grid-stride
// loop over 16 blocks an SM, every warp's loads on 512 contiguous bytes,
// and writes nothing (but for a word no input produces): the least time a
// kernel that must read those bytes takes under the same timing, the floor
// under the byte-bound kernels' times.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

__global__ void read_floor_kernel(const uint4* __restrict__ p, int64_t n16,
                                  uint32_t* __restrict__ sink) {
  uint32_t acc = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n16; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint4 x = p[i];
    acc ^= x.x ^ x.y ^ x.z ^ x.w;
  }
  if (acc == 0x9E3779B9u && sink) *sink = acc;   // keeps the loads
}

}  // namespace

extern "C" int meili_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// `p` 16-byte aligned, n16 16-byte pieces; `sink` one word, or null.
extern "C" int meili_read_floor(const void* p, long long n16, void* sink,
                                void* stream) {
  if (n16 <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(p) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  read_floor_kernel<<<sms * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), n16, static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
