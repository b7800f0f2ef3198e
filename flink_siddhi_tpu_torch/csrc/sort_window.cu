// K9: `#window.sort(n, key[, 'asc'|'desc'])` with aggregates over one
// micro-batch: each event's insertion into its partition's top-n buffer,
// and its aggregate row over the buffer.
//
// Replaces no Pallas kernel: the reference runs this loop as a `lax.scan`,
// flink_siddhi_tpu/compiler/scan_windows.py `ScanWindowArtifact.step`,
// `body_sort` (:246-271, the scan :305). In torch ops that scan would be a
// Python loop an event, which no CUDA graph can hold.
//
// The function: for each masked event t in order, of partition p, with
// key k (negated for 'desc' by the wrapper):
//   pos = the count of valid slots of p whose key is < k (a NaN key counts
//         nothing and lands at 0, as in the reference);
//   if pos < C: the slots pos .. C - 2 shift down one (the last falls
//         out), slot pos takes the event (valid, key, values);
//   row[t] = every aggregate over p's valid slots (warp_rows.cuh).
//
// What bounds it on an H100: each event reads the buffer the one before
// wrote, so a partition's events are a serial chain; the floor is the
// longest partition's chain of warp rounds, not its bytes (E x (8 + 4A)
// read, S x E x 4 written: a few microseconds at 524,288 events).
//
// Design. One warp walks one partition's events in order (one warp in all
// when the window is not partitioned): the wrapper groups the masked events
// by partition with a stable sort and gives each partition's range. The
// partition's buffer lives in shared memory (in device memory when it does
// not fit), as rows of 32-bit words: valid, key, then each value column;
// lane i takes slots i, i + 32, ... The warp stages 32 events at a time
// into shared memory (coalesced loads), then for each: counts `pos` with a
// warp sum, shifts the tail one 32-slot chunk at a time from the top, and
// reduces the row (warp_rows::row).
#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct SortArgs {
  const long long* order;   // [E] event indices grouped by partition
  const long long* starts;  // [P + 1] each partition's range of `order`
  const float* keys;        // [E] float32 sort keys (negated for 'desc')
  const unsigned* vals;     // [A, E] value words (int32 columns by bits)
  const int* plan;          // warp_rows' slot plan: kind[S], arg[S], arg_int[A]
  unsigned* buf;            // [P, 2 + A, C] words: valid, key bits, values
  float* rows;              // [S, E] out
  int E, P, C, A, S;
  int in_shared;            // 1: the partition's buffer is staged in shared memory
};

__global__ void __launch_bounds__(32) sort_window_kernel(const SortArgs p) {
  extern __shared__ unsigned smem[];
  const int part = blockIdx.x;
  const int lane = threadIdx.x;
  const long long lo = p.starts[part], hi = p.starts[part + 1];
  if (lo >= hi) return;
  const int C = p.C, A = p.A, W = 2 + A;
  const long long E = p.E;
  // staging: [W][32] words (event index, key, values)
  unsigned* st = smem;
  unsigned* gbuf = p.buf + static_cast<long long>(part) * W * C;
  unsigned* buf = p.in_shared ? smem + 32 * W : gbuf;
  if (p.in_shared) {
    for (int i = lane; i < W * C; i += 32) buf[i] = gbuf[i];
    __syncwarp();
  }
  auto member = [&](int i) { return buf[i] != 0u; };
  auto word = [&](int a, int i) { return buf[(2 + a) * C + i]; };
  for (long long base = lo; base < hi; base += 32) {
    const int n = static_cast<int>(min(32LL, hi - base));
    if (lane < n) {
      const long long t = p.order[base + lane];
      st[lane] = static_cast<unsigned>(t);
      st[32 + lane] = __float_as_uint(p.keys[t]);
      for (int a = 0; a < A; ++a) st[(2 + a) * 32 + lane] = p.vals[a * E + t];
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const long long t = st[j];
      const float key = __uint_as_float(st[32 + j]);
      int lt = 0;
      for (int i = lane; i < C; i += 32) {
        lt += (buf[i] != 0u && __uint_as_float(buf[C + i]) < key) ? 1 : 0;
      }
      const int pos = __reduce_add_sync(kFull, lt);
      if (pos < C) {
        // from the top chunk down, so a chunk reads its neighbour below
        // before that one is written
        for (int cb = ((C - 1) / 32) * 32; cb >= 0 && cb + 31 >= pos; cb -= 32) {
          const int i = cb + lane;
          const bool wr = i < C && i >= pos;
          for (int col = 0; col < W; ++col) {
            unsigned w = 0;
            if (wr) w = i == pos ? (col == 0 ? 1u : st[col * 32 + j]) : buf[col * C + i - 1];
            __syncwarp();
            if (wr) buf[col * C + i] = w;
            __syncwarp();
          }
        }
      }
      warp_rows::row(C, member, word, p.plan, p.S, p.rows, E, t);
    }
    __syncwarp();
  }
  if (p.in_shared) {
    for (int i = lane; i < W * C; i += 32) gbuf[i] = buf[i];
  }
}

}  // namespace

// Shared-memory bytes a block of this shape takes, with the buffer in
// shared memory (in_shared = 1) or not.
extern "C" long long fst_sort_window_smem(int C, int A, int in_shared) {
  const long long W = 2 + A;
  return 4 * W * (32 + (in_shared ? C : 0));
}

// Launch on `stream`, one warp a partition; the wrapper has laid the state
// out in `buf` (updated in place) and zeroed `rows`. Returns a cudaError_t.
extern "C" int fst_sort_window(const void* args, void* stream) {
  const SortArgs p = *static_cast<const SortArgs*>(args);
  if (p.P < 1 || p.C < 1 || p.E < 1 || p.A < 0 || p.S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = fst_sort_window_smem(p.C, p.A, p.in_shared);
  static long long smem_set = 48 * 1024;
  if (smem > smem_set) {  // raised once for each larger size (before a capture)
    const cudaError_t err = cudaFuncSetAttribute(
        sort_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  sort_window_kernel<<<p.P, 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
