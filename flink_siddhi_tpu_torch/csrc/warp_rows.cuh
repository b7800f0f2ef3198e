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
//
// What bounds a row on an H100: it sits on the kernels' serial chain (K8
// computes one for each emitting event, K9 for each insertion), so its
// cost is latency: one shuffle reduction a slot. The design keeps the
// plan out of device memory (`load_plan` stages kind[S], arg[S] and
// arg_int[A] into shared memory once a block) and, where a table has one
// slot a lane (K8 and K9 at C <= 32, `row_lanes`), reduces over the next
// power of two at or above C lanes only.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace warp_rows {

constexpr unsigned kFull = 0xffffffffu;
enum { kCount = 0, kSum = 1, kAvg = 2, kMin = 3, kMax = 4 };

// Words of the plan in shared memory: kind[S], arg[S], arg_int[A].
__host__ __device__ inline int plan_words(int S, int A) { return 2 * S + A; }

// The plan from device memory into shared memory, by the warp.
__device__ __forceinline__ void load_plan(const int* plan, int S, int A, int* splan) {
  for (int i = threadIdx.x & 31; i < plan_words(S, A); i += 32) splan[i] = plan[i];
  __syncwarp();
}

// x reduced over groups of `width` lanes (a power of two): the group's sum.
__device__ __forceinline__ double group_sum(double x, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float group_min(float x, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float group_max(float x, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The smallest power of two at or above n (n in [1, 32]).
__device__ __forceinline__ int lanes_for(int n) {
  int w = 1;
  while (w < n) w <<= 1;
  return w;
}

__device__ __forceinline__ double as_sum_term(unsigned w, bool is_int) {
  return is_int ? static_cast<double>(__int2float_rn(static_cast<int>(w)))
                : static_cast<double>(__uint_as_float(w));
}

// Every slot of the row over a table of one slot a lane: lane i < n holds
// slot i, a member when `member`, its column a's word in vcol[a * 32 + i].
// Calls store(s, word) in every lane with slot s's value (equal in the
// lanes [0, width), width the power of two at or above n).
template <class Store>
__device__ __forceinline__ void row_lanes(bool member, const unsigned* vcol, const int* splan,
                                          int S, int n, const Store& store) {
  const int lane = threadIdx.x & 31;
  const int* kind = splan;
  const int* arg = splan + S;
  const int* arg_int = splan + 2 * S;
  const int width = lanes_for(n);
  const float cnt = static_cast<float>(__popc(__ballot_sync(kFull, member)));
  for (int s = 0; s < S; ++s) {
    const int k = kind[s];
    unsigned out;
    if (k == kCount) {
      out = __float_as_uint(cnt);
    } else {
      const int a = arg[s];
      const bool is_int = arg_int[a] != 0;
      const unsigned w = vcol[a * 32 + lane];
      if (k == kSum || k == kAvg) {
        float r = static_cast<float>(group_sum(member ? as_sum_term(w, is_int) : 0.0, width));
        if (k == kAvg) r = __fdiv_rn(r, fmaxf(cnt, 1.0f));
        out = __float_as_uint(r);
      } else if (is_int) {
        const int v = static_cast<int>(w);
        out = static_cast<unsigned>(
            k == kMax ? __reduce_max_sync(kFull, member ? v : static_cast<int>(0x80000000u))
                      : __reduce_min_sync(kFull, member ? v : 0x7fffffff));
      } else {
        const float v = __uint_as_float(w);
        const bool nan = __any_sync(kFull, member && v != v);
        const float m = k == kMax ? group_max(member ? v : -INFINITY, width)
                                  : group_min(member ? v : INFINITY, width);
        out = nan ? 0x7fc00000u : __float_as_uint(m);
      }
    }
    store(s, out);
  }
}

// Every slot of the row over slots [0, n) of a table, for the whole warp
// (each lane takes slots lane, lane + 32, ...): member(i) says whether
// slot i counts, word(a, i) is column a's 32-bit word at slot i. Calls
// store(s, word) in every lane with slot s's value.
template <class Member, class Word, class Store>
__device__ __forceinline__ void row(int n, const Member& member, const Word& word,
                                    const int* splan, int S, const Store& store) {
  const int lane = threadIdx.x & 31;
  const int* kind = splan;
  const int* arg = splan + S;
  const int* arg_int = splan + 2 * S;
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
        if (member(i)) acc += as_sum_term(word(a, i), is_int);
      }
      float r = static_cast<float>(group_sum(acc, 32));
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
      m = mx ? group_max(m, 32) : group_min(m, 32);
      out = nan ? 0x7fc00000u : __float_as_uint(m);
    }
    store(s, out);
  }
}

}  // namespace warp_rows
