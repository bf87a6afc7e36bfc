// An empty kernel for Hopper (sm_90a): one block of 32 threads that does
// nothing.  Its time on the card is the floor under any launch, which
// chip_smoke.py prints beside the port's kernels so that a kernel's time
// can be told apart from the cost of launching it.  It replaces no TPU
// kernel and no path of the port launches it.
//
// Interface: a plain C entry point, loaded with ctypes; it launches on the
// given stream, does not synchronise and returns the cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
