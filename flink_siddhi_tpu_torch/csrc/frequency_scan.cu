// K8: `#window.frequent(count[, attrs])` (Misra-Gries) and
// `#window.lossyFrequent(support[, error][, attrs])` (lossy counting) over
// one micro-batch: the counted-key table advanced event by event, and the
// aggregate row of each event that emits.
//
// Replaces no Pallas kernel: the reference runs this loop as a `lax.scan`,
// flink_siddhi_tpu/compiler/scan_windows.py `FrequencyWindowArtifact.step`
// (:962, the body :985-1083, the scan :1086). In torch ops that scan would
// be a Python loop an event, which no CUDA graph can hold.
//
// The function, for each masked event t in order (key code c, n = the
// events seen so far, this one included, int32 across batches):
//   hit = a valid slot holds c (the lowest such slot);
//   slot_free = the lowest invalid slot.
//   frequent: admitted = hit || a slot is free; an admitted event sets
//     freq = hit ? freq + 1 : 1 and writes its code and values; otherwise
//     every slot's freq = max(freq - 1, 0) and slots at 0 turn invalid.
//     Emits when admitted; the members are the valid slots.
//   lossyFrequent: bucket = int32(ceil(float32(n) / width)); the slot is
//     the hit, else the lowest free one, else the victim argmin(freq +
//     delta) (ties to the lowest index); freq = hit ? freq + 1 : 1, a new
//     entry's delta = bucket - 1; every `width` events the valid slots with
//     freq + delta <= bucket turn invalid; thresh = float32(support -
//     error) * float32(n); emits when the slot is still valid and
//     float32(freq) >= thresh; the members are the valid slots with
//     float32(freq) >= thresh.
//   row[t] (emitting events only) = every aggregate over the members
//   (warp_rows.cuh).
//
// What bounds it on an H100: the table is global to the stream and a full
// `frequent` table changes every counter, so the events are one serial
// chain: the floor is E dependent steps, not the bytes (E x (5 + 4A) read,
// the emitting rows written: a few microseconds at 524,288 events).
//
// Design. One warp walks the whole batch in tape order, the table (valid,
// code, freq, delta, values: rows of 32-bit words) in shared memory when it
// fits (else in device memory), lane i taking slots i, i + 32, ... It
// stages 32 tape positions at a time (coalesced loads, a ballot of the
// masked ones). The code -> slot lookup is a map built at the start of the
// call from the carried table (`map[code]`, the lowest valid slot,
// INT_MAX for none) and kept as slots are written and evicted; a code past
// the map (the encoder grew after a CUDA graph was captured) is looked up
// by a ballot scan of the table. `hi` bounds the slots that can be valid
// (every slot from `hi` up is free), so the free-slot search, the prune and
// the rows cover [0, hi) only.
#include <cuda_runtime.h>
#include <math.h>

#include "warp_rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;
// table rows of 32-bit words
enum { kValid = 0, kCode = 1, kFreq = 2, kDelta = 3, kVals = 4 };

struct FreqArgs {
  const unsigned char* mask;  // [E]
  const int* codes;           // [E]
  const unsigned* vals;       // [A, E] value words (int32 columns by bits)
  const int* plan;            // warp_rows' slot plan
  unsigned* table;            // [4 + A, C] words, updated in place
  int* seen;                  // [1] events seen, updated in place
  int* map;                   // [K] code -> slot (kNone), filled by the wrapper
  unsigned char* emit;        // [E] out
  float* rows;                // [S, E] out
  int E, C, A, S, K;
  int lossy, width;
  float thresh_factor;        // float32(support - error)
  int in_shared;
};

__global__ void __launch_bounds__(32) frequency_scan_kernel(const FreqArgs p) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x;
  const int C = p.C, A = p.A, W = kVals + A, K = p.K;
  const long long E = p.E;
  unsigned* st = smem;  // staging: [1 + A][32] (code, values)
  unsigned* tb = p.in_shared ? smem + 32 * (1 + A) : p.table;
  if (p.in_shared) {
    for (int i = lane; i < W * C; i += 32) tb[i] = p.table[i];
    __syncwarp();
  }
  auto at = [&](int row, int i) -> unsigned& { return tb[row * C + i]; };
  auto valid = [&](int i) { return at(kValid, i) != 0u; };
  auto code_of = [&](int i) { return static_cast<int>(at(kCode, i)); };
  auto freq_of = [&](int i) { return static_cast<int>(at(kFreq, i)); };
  auto unmap = [&](int i) {  // slot i leaves the map
    const int oc = code_of(i);
    if (oc >= 0 && oc < K && p.map[oc] == i) p.map[oc] = kNone;
  };
  // the map and hi from the carried table
  int hi = 0;
  for (int i = lane; i < C; i += 32) {
    if (!valid(i)) continue;
    hi = i + 1;
    const int c = code_of(i);
    if (c >= 0 && c < K) atomicMin(&p.map[c], i);
  }
  hi = __reduce_max_sync(kFull, hi);
  __syncwarp();
  const bool lossy = p.lossy != 0;
  int seen = *p.seen;
  for (long long base = 0; base < E; base += 32) {
    const long long tl = base + lane;
    const bool act = tl < E && p.mask[tl] != 0;
    if (act) {
      st[lane] = static_cast<unsigned>(p.codes[tl]);
      for (int a = 0; a < A; ++a) st[(1 + a) * 32 + lane] = p.vals[a * E + tl];
    }
    unsigned bits = __ballot_sync(kFull, act);
    __syncwarp();
    while (bits) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1;
      const long long t = base + j;
      const int c = static_cast<int>(st[j]);
      const int n = seen + 1;
      seen = n;
      // the slot holding c
      int slot_hit = -1;
      if (c >= 0 && c < K) {
        const int m = p.map[c];
        slot_hit = m < C ? m : -1;
      } else {
        for (int ib = 0; ib < hi; ib += 32) {
          const int i = ib + lane;
          const unsigned b = __ballot_sync(kFull, i < hi && valid(i) && code_of(i) == c);
          if (b) {
            slot_hit = ib + __ffs(b) - 1;
            break;
          }
        }
      }
      const bool hit = slot_hit >= 0;
      int slot = slot_hit;
      if (!hit) {  // the lowest free slot
        for (int ib = 0; ib < hi && slot < 0; ib += 32) {
          const int i = ib + lane;
          const unsigned b = __ballot_sync(kFull, i < hi && !valid(i));
          if (b) slot = ib + __ffs(b) - 1;
        }
        if (slot < 0 && hi < C) slot = hi;
      }
      int bucket = 0;
      if (lossy) {
        bucket = static_cast<int>(
            ceilf(__fdiv_rn(__int2float_rn(n), static_cast<float>(p.width))));
        if (slot < 0) {  // full table: the victim, argmin(freq + delta)
          int best = kNone, best_i = C;
          for (int i = lane; i < C; i += 32) {
            const int v = valid(i) ? static_cast<int>(static_cast<unsigned>(freq_of(i)) +
                                                      at(kDelta, i))
                                   : kNone;
            if (v < best || (v == best && i < best_i)) {  // argmin: first index
              best = v;
              best_i = i;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const int ob = __shfl_xor_sync(kFull, best, o);
            const int oi = __shfl_xor_sync(kFull, best_i, o);
            if (ob < best || (ob == best && oi < best_i)) {
              best = ob;
              best_i = oi;
            }
          }
          slot = best_i;
        }
      }
      const bool admitted = slot >= 0;  // always for lossyFrequent
      if (admitted) {
        if (lane == 0) {
          if (!hit) {
            if (valid(slot)) unmap(slot);  // a replaced victim
            if (c >= 0 && c < K) p.map[c] = slot;
          }
          at(kFreq, slot) = static_cast<unsigned>(hit ? freq_of(slot) + 1 : 1);
          if (lossy && !hit) at(kDelta, slot) = static_cast<unsigned>(bucket - 1);
          at(kValid, slot) = 1u;
          at(kCode, slot) = static_cast<unsigned>(c);
          for (int a = 0; a < A; ++a) at(kVals + a, slot) = st[(1 + a) * 32 + j];
        }
        hi = max(hi, slot + 1);
        __syncwarp();
        if (lossy && n % p.width == 0) {  // bucket boundary: prune
          for (int i = lane; i < hi; i += 32) {
            if (valid(i) && !(static_cast<int>(static_cast<unsigned>(freq_of(i)) +
                                               at(kDelta, i)) > bucket)) {
              at(kValid, i) = 0u;
              unmap(i);
            }
          }
          __syncwarp();
        }
      } else {  // frequent, full table, unseen key: decrement every counter
        for (int i = lane; i < C; i += 32) {
          const int f = max(freq_of(i) - 1, 0);
          at(kFreq, i) = static_cast<unsigned>(f);
          if (valid(i) && f <= 0) {
            at(kValid, i) = 0u;
            unmap(i);
          }
        }
        __syncwarp();
      }
      float thresh = 0.0f;
      bool emit = admitted;
      if (lossy) {
        thresh = __fmul_rn(p.thresh_factor, __int2float_rn(n));
        emit = valid(slot) && __int2float_rn(freq_of(slot)) >= thresh;
      }
      if (emit) {
        auto member = [&](int i) {
          return valid(i) && (!lossy || __int2float_rn(freq_of(i)) >= thresh);
        };
        auto word = [&](int a, int i) { return at(kVals + a, i); };
        warp_rows::row(hi, member, word, p.plan, p.S, p.rows, E, t);
        if (lane == 0) p.emit[t] = 1;
      }
      __syncwarp();
    }
    __syncwarp();
  }
  if (lane == 0) *p.seen = seen;
  if (p.in_shared) {
    for (int i = lane; i < W * C; i += 32) p.table[i] = tb[i];
  }
}

}  // namespace

// Shared-memory bytes of the block, with the table in shared memory
// (in_shared = 1) or not.
extern "C" long long fst_frequency_smem(int C, int A, int in_shared) {
  return 4LL * (32 * (1 + A) + (in_shared ? static_cast<long long>(kVals + A) * C : 0));
}

// Launch on `stream`, one warp; the wrapper has laid the state out in
// `table` and `seen` (updated in place), filled `map` with INT_MAX and
// zeroed `emit` and `rows`. Returns a cudaError_t.
extern "C" int fst_frequency_scan(const void* args, void* stream) {
  const FreqArgs p = *static_cast<const FreqArgs*>(args);
  if (p.C < 1 || p.E < 1 || p.A < 0 || p.S < 1 || p.K < 1 ||
      (p.lossy && p.width < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = fst_frequency_smem(p.C, p.A, p.in_shared);
  static long long smem_set = 48 * 1024;
  if (smem > smem_set) {  // raised once for each larger size (before a capture)
    const cudaError_t err = cudaFuncSetAttribute(
        frequency_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  frequency_scan_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
