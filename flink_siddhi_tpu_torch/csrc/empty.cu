// An empty kernel: one block of 256 threads that does nothing; a kernel of
// empty block barrier rounds; and a kernel of empty warp rounds.
//
// Replaces no TPU kernel. chip_smoke.py times the empty kernel the way it
// times the others (a profiler trace over 25 calls after warm-up) as the
// floor that one launch puts under any kernel's device time on this card:
// a kernel whose bound lies under this floor is judged against the floor.
// The barrier kernel is the serial floor of the slot NFA scan
// (slot_nfa.cu), which walks its events one after another in one block
// with at least one __syncthreads a event: n rounds of a barrier and
// nothing else, in one block of the scan's width. The warp kernel is the
// serial floor of the scan's one-warp pools (S <= 64): n rounds of a
// __syncwarp and a __shfl_sync whose result the next round's depends on,
// in one warp. The float probe reports what the build's -ftz=true does to
// the intrinsics the program interpreter (program.cuh) uses, without its
// explicit flush: chip_smoke.py prints it beside the interpreter's check.
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

__global__ void warp_kernel(int n, int* sink) {
  int x = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    __syncwarp();
    x = __shfl_sync(0xffffffffu, x, (x + i) & 31) + 1;
  }
  if (x == -1) *sink = x;  // keeps the loop; never true for n < 2^20
}

// per pair k: out[6 k ..] = a + b, a * b, a / b (__fadd_rn, __fmul_rn,
// __fdiv_rn), a < b, a == b, fmodf(a, b), with no explicit flush
__global__ void ftz_probe_kernel(const float* a, const float* b, float* out,
                                 int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  out[6 * k] = __fadd_rn(a[k], b[k]);
  out[6 * k + 1] = __fmul_rn(a[k], b[k]);
  out[6 * k + 2] = __fdiv_rn(a[k], b[k]);
  out[6 * k + 3] = a[k] < b[k] ? 1.f : 0.f;
  out[6 * k + 4] = a[k] == b[k] ? 1.f : 0.f;
  out[6 * k + 5] = fmodf(a[k], b[k]);
}

}  // namespace

// The float probe over n pairs on `stream`; returns a cudaError_t.
extern "C" int fst_ftz_probe(const float* a, const float* b, float* out,
                             int n, void* stream) {
  ftz_probe_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

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

// n (at most 2^20) empty warp rounds in one warp on `stream`; returns a
// cudaError_t.
extern "C" int fst_warp_rounds(int n, void* stream) {
  if (n < 0 || n > (1 << 20)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  warp_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(n, nullptr);
  return static_cast<int>(cudaGetLastError());
}
