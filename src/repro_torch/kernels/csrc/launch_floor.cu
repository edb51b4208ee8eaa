// A kernel that does nothing: one block of one thread. Timed the way the
// port's kernels are timed, it gives the least device time any launch
// takes on the card, the floor under the small kernels' times.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int meili_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
