// One warp's aggregate row over a small table: shared by K8
// (frequency_scan.cu) and K9 (sort_window.cu).
//
// The row of one event is every aggregate slot over the table's members:
//   count                 the members, as float32;
//   sum, avg              the members' values summed in fp64 (an int32
//                         column's values cast to float32 first, as the
//                         reference casts them), then float32; avg divides
//                         by max(count, 1);
//   min, max              float32 with NaN propagating (identity -+inf),
//                         or exact int32 for an int32 column (identity
//                         INT_MAX / INT_MIN), written by bit pattern.
// The slot plan is a device array: kind[S], arg[S], then arg_int[A].
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace warp_rows {

constexpr unsigned kFull = 0xffffffffu;
enum { kCount = 0, kSum = 1, kAvg = 2, kMin = 3, kMax = 4 };

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Every slot of the row of event t over slots [0, n) of a table, for the
// whole warp (each lane takes slots lane, lane + 32, ...): member(i) says
// whether slot i counts, word(a, i) is column a's 32-bit word at slot i.
// Lane 0 writes rows[s * E + t].
template <class Member, class Word>
__device__ __forceinline__ void row(int n, const Member& member, const Word& word,
                                    const int* plan, int S, float* rows, long long E,
                                    long long t) {
  const int lane = threadIdx.x & 31;
  const int* kind = plan;
  const int* arg = plan + S;
  const int* arg_int = plan + 2 * S;
  int c = 0;
  for (int i = lane; i < n; i += 32) c += member(i) ? 1 : 0;
  const float cnt = static_cast<float>(__reduce_add_sync(kFull, c));
  for (int s = 0; s < S; ++s) {
    const int k = kind[s];
    const int a = arg[s];
    unsigned out;
    if (k == kCount) {
      out = __float_as_uint(cnt);
    } else if (k == kSum || k == kAvg) {
      const bool is_int = arg_int[a] != 0;
      double acc = 0.0;
      for (int i = lane; i < n; i += 32) {
        if (!member(i)) continue;
        const unsigned w = word(a, i);
        acc += is_int ? static_cast<double>(__int2float_rn(static_cast<int>(w)))
                      : static_cast<double>(__uint_as_float(w));
      }
      float r = static_cast<float>(warp_sum(acc));
      if (k == kAvg) r = __fdiv_rn(r, fmaxf(cnt, 1.0f));
      out = __float_as_uint(r);
    } else if (arg_int[a] != 0) {
      const bool mx = k == kMax;
      int m = mx ? static_cast<int>(0x80000000u) : 0x7fffffff;
      for (int i = lane; i < n; i += 32) {
        if (!member(i)) continue;
        const int v = static_cast<int>(word(a, i));
        m = mx ? max(m, v) : min(m, v);
      }
      out = static_cast<unsigned>(mx ? __reduce_max_sync(kFull, m) : __reduce_min_sync(kFull, m));
    } else {
      const bool mx = k == kMax;
      bool nan = false;
      float m = mx ? -INFINITY : INFINITY;
      for (int i = lane; i < n; i += 32) {
        if (!member(i)) continue;
        const float v = __uint_as_float(word(a, i));
        nan |= v != v;
        m = mx ? fmaxf(m, v) : fminf(m, v);
      }
      nan = __any_sync(kFull, nan);
      m = mx ? warp_max(m) : warp_min(m);
      out = nan ? 0x7fc00000u : __float_as_uint(m);
    }
    if (lane == 0) reinterpret_cast<unsigned*>(rows)[s * E + t] = out;
  }
}

}  // namespace warp_rows
