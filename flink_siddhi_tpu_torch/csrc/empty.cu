// An empty kernel: one block of 256 threads that does nothing; and a
// kernel of empty block barrier rounds.
//
// Replaces no TPU kernel. chip_smoke.py times the empty kernel the way it
// times the others (a profiler trace over 25 calls after warm-up) as the
// floor that one launch puts under any kernel's device time on this card:
// a kernel whose bound lies under this floor is judged against the floor.
// The barrier kernel is the serial floor of the slot NFA scan
// (slot_nfa.cu), which walks its events one after another in one block
// with at least one __syncthreads a event: n rounds of a barrier and
// nothing else, in one block of the scan's width.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void barrier_kernel(int n, int* sink) {
  int x = 0;
  for (int i = 0; i < n; ++i) {
    x += threadIdx.x ^ i;
    __syncthreads();
  }
  if (x == -1) *sink = x;  // keeps the loop; never true for n < 2^20
}

}  // namespace

// One launch on `stream`; returns a cudaError_t.
extern "C" int fst_empty(void* stream) {
  empty_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// n (at most 2^20) empty barrier rounds in one block of `threads` threads
// on `stream`; returns a cudaError_t.
extern "C" int fst_barrier_rounds(int n, int threads, void* stream) {
  if (n < 0 || n > (1 << 20) || threads < 1 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  barrier_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, nullptr);
  return static_cast<int>(cudaGetLastError());
}
