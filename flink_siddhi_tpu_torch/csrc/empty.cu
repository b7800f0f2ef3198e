// An empty kernel: one block of 256 threads that does nothing.
//
// Replaces no TPU kernel. chip_smoke.py times it the way it times the
// others (a profiler trace over 25 calls after warm-up) as the floor that
// one launch puts under any kernel's device time on this card: a kernel
// whose bound lies under this floor is judged against the floor.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch on `stream`; returns a cudaError_t.
extern "C" int fst_empty(void* stream) {
  empty_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
