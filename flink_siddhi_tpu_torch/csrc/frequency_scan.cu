// K8: `#window.frequent(count[, attrs])` (Misra-Gries) and
// `#window.lossyFrequent(support[, error][, attrs])` (lossy counting) over
// one micro-batch: the counted-key table advanced event by event, and the
// aggregate row of each event that emits.
//
// Replaces no Pallas kernel: the reference runs this loop as a `lax.scan`,
// flink_siddhi_tpu/compiler/scan_windows.py `FrequencyWindowArtifact.step`
// (:962, the body :985-1083, the scan :1086). In torch ops that scan would
// be a Python loop an event, which no CUDA graph can hold. It replaces the
// port's first K8 (the table in shared memory, its code -> slot map in
// device memory, a round trip through the map for every event and every
// evicted slot: 0.9-1.2 us an event).
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
// chain: the floor is E dependent warp rounds (10 ms at 524,288 events),
// not the bytes (E x (5 + 4A) read, the emitting rows written: a few
// microseconds). The design takes each event's step toward one round: on
// the chain stay only the table's own ballots and updates.
//
// Design. One warp walks the whole batch in tape order, 32 tape positions a
// round: a coalesced load of the round's masks, codes and values (the
// values staged in shared memory), a ballot of the masked ones, and, in
// each lane for its own position, the event's n, bucket, prune flag and
// threshold (a division and a modulo no longer on the chain); the walk
// takes them and the code by shuffle.
// - The fast table: slots [0, 32 R) in registers, lane i holding slot
//   r * 32 + i's valid flag, code, freq and delta in tier r (R = 1 for C
//   <= 32, R = 2 above). The hit is one ballot a tier of `valid && code ==
//   c`, the free slot one ballot a tier of `!valid` (issued together), the
//   `frequent` decrement and the lossy prune one predicated step a lane,
//   the victim a `__reduce_min_sync` and a ballot. An event's chain ends
//   with its members' ballot: the rows wait for the round's end, where
//   lane j folds event j's row from its member masks in parallel (a
//   slot's value at event j: the round's last write to it at or before j,
//   from the staged values, else its value at the round's start), and
//   writes it coalesced. No map, no device-memory traffic an event.
// - The wide table, when a new key needs slot 32 R (R = 0: the fast
//   table would not fit in shared memory): the table (valid, code, freq,
//   delta, values: rows of 32-bit words) in shared memory when it fits
//   (else in device memory), lane i owning slots i, i + 32, ...: only a
//   slot's owner reads or writes it, so no barrier guards a write, and a
//   value another lane needs travels by shuffle. The code -> slot lookup
//   is a map (`map[code]`, the lowest valid slot, INT_MAX for none) built
//   from the table when the walk enters this mode, in shared memory when
//   the key encoder's size fits beside the table, else in device memory;
//   lane 0 reads and keeps it, owners clear it for the slots a prune or a
//   decrement evicts. A code past the map (the encoder grew after a CUDA
//   graph was captured) is looked up by a ballot scan of the table. `hi`
//   bounds the slots that can be valid (every slot from `hi` up is free),
//   so the free-slot search, the prune and the rows cover [0, hi) only;
//   rows are folded at once, by the warp (warp_rows.cuh).
// The slot plan is read once, into shared memory.
#include <cuda_runtime.h>
#include <math.h>

#include "warp_rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;
// table rows of 32-bit words
enum { kValid = 0, kCode = 1, kFreq = 2, kDelta = 3, kVals = 4 };
enum { kCount = warp_rows::kCount, kSum = warp_rows::kSum, kAvg = warp_rows::kAvg,
       kMax = warp_rows::kMax };

struct FreqArgs {
  const unsigned char* mask;  // [E]
  const int* codes;           // [E]
  const unsigned* vals;       // [A, E] value words (int32 columns by bits)
  const int* plan;            // warp_rows' slot plan
  unsigned* table;            // [4 + A, C] words, updated in place
  int* seen;                  // [1] events seen, updated in place
  int* map;                   // [K] code -> slot (kNone): filled by the wrapper unless map_shared
  unsigned char* emit;        // [E] out
  float* rows;                // [S, E] out
  int E, C, A, S, K;
  int lossy, width;
  float thresh_factor;        // float32(support - error)
  int in_shared;              // the wide table in shared memory
  int map_shared;             // the map in shared memory
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Shared words: the plan, the staged values [A][32], the fast table's
// value columns [R][A][32] and its round's writers [R][32]; then, when a
// walk can reach the wide table (C > 32 R), that table and the map.
__host__ __device__ inline long long freq_smem_words(int C, int A, int S, int K, int R,
                                                     int in_shared, int map_shared) {
  long long w = warp_rows::plan_words(S, A) + 32LL * A + 32LL * R * (A + 1);
  if (C > 32 * R) {
    w += (in_shared ? static_cast<long long>(kVals + A) * C : 0) + (map_shared ? K : 0);
  }
  return w;
}

// Event j's row (lane j, for the round's events up to and including j):
// the members are the set bits of mem[r] over tier r's slots; a slot's
// value is the staged value of the round's last write to it at or before
// j (writers wm[r * 32 + i]), else col, its value at the round's start.
template <int R>
__device__ void fold_row(const FreqArgs& p, const unsigned (&mem)[R > 0 ? R : 1],
                         const unsigned* wm, const unsigned* st, const unsigned* col,
                         const int* splan, long long t) {
  const int lane = threadIdx.x;
  const int S = p.S, A = p.A;
  const long long E = p.E;
  const int* kind = splan;
  const int* arg = splan + S;
  const int* arg_int = splan + 2 * S;
  const unsigned upto = (2u << lane) - 1u;
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) cnt += __popc(mem[r]);
  const float cntf = static_cast<float>(cnt);
  auto word = [&](int r, int i, int a) {
    const unsigned w = wm[r * 32 + i] & upto;
    return w ? st[a * 32 + 31 - __clz(w)] : col[(r * A + a) * 32 + i];
  };
  for (int s = 0; s < S; ++s) {
    const int k = kind[s];
    unsigned out;
    if (k == kCount) {
      out = __float_as_uint(cntf);
    } else {
      const int a = arg[s];
      const bool is_int = arg_int[a] != 0;
      if (k == kSum || k == kAvg) {
        double acc = 0.0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          for (unsigned b = mem[r]; b; b &= b - 1) {
            acc += warp_rows::as_sum_term(word(r, __ffs(b) - 1, a), is_int);
          }
        }
        float v = static_cast<float>(acc);
        if (k == kAvg) v = __fdiv_rn(v, fmaxf(cntf, 1.0f));
        out = __float_as_uint(v);
      } else if (is_int) {
        int m = k == kMax ? static_cast<int>(0x80000000u) : 0x7fffffff;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          for (unsigned b = mem[r]; b; b &= b - 1) {
            const int v = static_cast<int>(word(r, __ffs(b) - 1, a));
            m = k == kMax ? max(m, v) : min(m, v);
          }
        }
        out = static_cast<unsigned>(m);
      } else {
        bool nan = false;
        float m = k == kMax ? -INFINITY : INFINITY;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          for (unsigned b = mem[r]; b; b &= b - 1) {
            const float v = __uint_as_float(word(r, __ffs(b) - 1, a));
            nan |= v != v;
            m = k == kMax ? fmaxf(m, v) : fminf(m, v);
          }
        }
        out = nan ? 0x7fc00000u : __float_as_uint(m);
      }
    }
    reinterpret_cast<unsigned*>(p.rows)[s * E + t] = out;
  }
  p.emit[t] = 1;
}

// R: the fast table's tiers (0: the wide table only).
template <int R>
__global__ void __launch_bounds__(32) frequency_scan_kernel(const FreqArgs p) {
  constexpr int RT = R > 0 ? R : 1;  // register arrays' size
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x;
  const int C = p.C, A = p.A, S = p.S, K = p.K, W = kVals + A;
  const long long E = p.E;
  const bool lossy = p.lossy != 0;
  const bool wide_ok = C > 32 * R;  // a walk can reach the wide table
  int* splan = reinterpret_cast<int*>(smem);
  unsigned* st = smem + warp_rows::plan_words(S, A);  // staged values [A][32]
  unsigned* col = st + 32 * A;                        // fast values [R][A][32]
  unsigned* wm = col + 32 * R * A;                    // fast writers [R][32]
  unsigned* tb = wide_ok && p.in_shared ? wm + 32 * R : p.table;
  int* map = p.map_shared ? reinterpret_cast<int*>(
                                wm + 32 * R + (p.in_shared ? static_cast<long long>(W) * C : 0))
                          : p.map;
  warp_rows::load_plan(p.plan, S, A, splan);
  if (wide_ok && p.in_shared) {
    for (int i = lane; i < W * C; i += 32) tb[i] = p.table[i];
  }
  __syncwarp();
  auto at = [&](int row, int i) -> unsigned& { return tb[row * C + i]; };
  auto valid = [&](int i) { return at(kValid, i) != 0u; };
  auto code_of = [&](int i) { return static_cast<int>(at(kCode, i)); };
  auto freq_of = [&](int i) { return static_cast<int>(at(kFreq, i)); };
  auto in_map = [&](int c) { return c >= 0 && c < K; };
  auto unmap = [&](int i) {  // the owner of slot i, as it turns invalid
    const int oc = code_of(i);
    if (in_map(oc) && map[oc] == i) map[oc] = kNone;
  };
  int hi = 0;  // every slot from hi up is free
  for (int i = lane; i < C; i += 32) {
    if (tb[kValid * C + i] != 0u) hi = i + 1;
  }
  hi = __reduce_max_sync(kFull, hi);
  // the fast table
  bool fast = R > 0 && hi <= 32 * R;
  bool own[RT], v[RT];
  int code[RT], freq[RT], delta[RT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    own[r] = i < C;
    v[r] = fast && own[r] && tb[kValid * C + i] != 0u;
    code[r] = own[r] ? static_cast<int>(tb[kCode * C + i]) : 0;
    freq[r] = own[r] ? static_cast<int>(tb[kFreq * C + i]) : 0;
    delta[r] = own[r] ? static_cast<int>(tb[kDelta * C + i]) : 0;
    for (int a = 0; a < A; ++a) col[(r * A + a) * 32 + lane] = own[r] ? tb[(kVals + a) * C + i] : 0u;
  }
  auto enter_wide = [&]() {  // the map from the table, for the wide walk
    if (p.map_shared) {
      for (int i = lane; i < K; i += 32) map[i] = kNone;
      __syncwarp();
    }
    for (int i = lane; i < hi; i += 32) {
      if (!valid(i)) continue;
      const int c = code_of(i);
      if (in_map(c)) atomicMin(&map[c], i);
    }
    __syncwarp();
  };
  if (!fast) enter_wide();
  int seen = *p.seen;
  for (long long base = 0; base < E; base += 32) {
    const long long tl = base + lane;
    const bool act = tl < E && p.mask[tl] != 0;
    int mycode = 0;
    __syncwarp();  // the last round's staged values are read
    if (act) {
      mycode = p.codes[tl];
      for (int a = 0; a < A; ++a) st[a * 32 + lane] = p.vals[a * E + tl];
    }
    const unsigned bits = __ballot_sync(kFull, act);
    // this lane's event: n, bucket, prune, threshold
    const int my_n = wrap_add(seen, __popc(bits & ((1u << lane) - 1u)) + 1);
    int my_bucket = 0, my_prune = 0;
    float my_thresh = 0.0f;
    if (lossy) {
      my_bucket = static_cast<int>(
          ceilf(__fdiv_rn(__int2float_rn(my_n), static_cast<float>(p.width))));
      my_prune = my_n % p.width == 0;
      my_thresh = __fmul_rn(p.thresh_factor, __int2float_rn(my_n));
    }
    __syncwarp();
    unsigned todo = bits;
    if constexpr (R > 0) {
      if (fast) {
        unsigned wmask[RT], mem[RT];
#pragma unroll
        for (int r = 0; r < R; ++r) wmask[r] = mem[r] = 0u;
        unsigned emit_bits = 0u;
        while (todo) {
          const int j = __ffs(todo) - 1;
          const int c = __shfl_sync(kFull, mycode, j);
          const int bucket = __shfl_sync(kFull, my_bucket, j);
          const int prune = __shfl_sync(kFull, my_prune, j);
          const float thresh = __shfl_sync(kFull, my_thresh, j);
          unsigned hb[RT], fb[RT];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            hb[r] = __ballot_sync(kFull, v[r] && code[r] == c);
            fb[r] = __ballot_sync(kFull, own[r] && !v[r]);
          }
          int sh = -1, sf = -1;
#pragma unroll
          for (int r = R - 1; r >= 0; --r) {
            if (hb[r]) sh = r * 32 + __ffs(hb[r]) - 1;
            if (fb[r]) sf = r * 32 + __ffs(fb[r]) - 1;
          }
          const bool hit = sh >= 0;
          int slot = hit ? sh : sf;
          if (slot < 0 && wide_ok) break;  // a new key for slot 32 R: the wide walk
          if (slot < 0 && lossy) {  // full table: the victim, argmin(freq + delta), lowest index
            int key[RT], best = kNone;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              key[r] = v[r] ? wrap_add(freq[r], delta[r]) : kNone;
              best = min(best, __reduce_min_sync(kFull, key[r]));
            }
#pragma unroll
            for (int r = R - 1; r >= 0; --r) {
              const unsigned b = __ballot_sync(kFull, own[r] && key[r] == best);
              if (b) slot = r * 32 + __ffs(b) - 1;
            }
          }
          const bool admitted = slot >= 0;  // always for lossyFrequent
          unsigned m[RT];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (admitted) {
              if (slot == r * 32 + lane) {
                freq[r] = hit ? wrap_add(freq[r], 1) : 1;
                if (lossy && !hit) delta[r] = bucket - 1;
                v[r] = true;
                code[r] = c;
                wmask[r] |= 1u << j;
              }
              if (prune) v[r] = v[r] && wrap_add(freq[r], delta[r]) > bucket;
            } else if (own[r]) {  // frequent, full table, unseen key: every counter down
              freq[r] = max(wrap_add(freq[r], -1), 0);
              v[r] = v[r] && freq[r] > 0;
            }
            m[r] = __ballot_sync(kFull, v[r] && (!lossy || __int2float_rn(freq[r]) >= thresh));
            if (lane == j) mem[r] = m[r];
          }
          bool emit = admitted;
          if (lossy) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if ((slot >> 5) == r) emit = (m[r] >> (slot & 31)) & 1u;
            }
          }
          emit_bits |= static_cast<unsigned>(emit) << j;
          todo &= todo - 1;
        }
        // the rows of the round's events, then its writes into the values
#pragma unroll
        for (int r = 0; r < R; ++r) wm[r * 32 + lane] = wmask[r];
        __syncwarp();
        if ((emit_bits >> lane) & 1u) fold_row<R>(p, mem, wm, st, col, splan, tl);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (wmask[r]) {
            const int k = 31 - __clz(wmask[r]);
            for (int a = 0; a < A; ++a) col[(r * A + a) * 32 + lane] = st[a * 32 + k];
          }
        }
        if (todo) {  // into the wide table, from this event on
          hi = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int i = r * 32 + lane;
            if (!own[r]) continue;
            if (v[r]) hi = i + 1;
            tb[kValid * C + i] = v[r];
            tb[kCode * C + i] = static_cast<unsigned>(code[r]);
            tb[kFreq * C + i] = static_cast<unsigned>(freq[r]);
            tb[kDelta * C + i] = static_cast<unsigned>(delta[r]);
            for (int a = 0; a < A; ++a) tb[(kVals + a) * C + i] = col[(r * A + a) * 32 + lane];
          }
          hi = __reduce_max_sync(kFull, hi);
          __syncwarp();
          fast = false;
          enter_wide();
        }
      }
    }
    while (todo) {  // the wide walk
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long t = base + j;
      const int c = __shfl_sync(kFull, mycode, j);
      const int bucket = __shfl_sync(kFull, my_bucket, j);
      const int prune = __shfl_sync(kFull, my_prune, j);
      const float thresh = __shfl_sync(kFull, my_thresh, j);
      // the slot holding c
      int slot_hit = -1;
      if (in_map(c)) {
        const int m = __shfl_sync(kFull, lane == 0 ? map[c] : 0, 0);
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
      if (lossy && slot < 0) {  // full table: the victim, argmin(freq + delta), lowest index
        int best = kNone, best_i = C;
        for (int i = lane; i < C; i += 32) {
          const int w = valid(i) ? wrap_add(freq_of(i), static_cast<int>(at(kDelta, i))) : kNone;
          if (i == lane || w < best) {  // a lane's slots rise: its first minimum
            best = w;
            best_i = i;
          }
        }
        const int low = __reduce_min_sync(kFull, best);
        slot = __reduce_min_sync(kFull, best == low ? best_i : C);
      }
      const bool admitted = slot >= 0;  // always for lossyFrequent
      bool vs = admitted;
      int fs = 0;
      if (admitted) {
        const int owner = slot & 31;
        if (!hit) {  // a replaced victim leaves the map, c enters it
          int oc = 0, ov = 0;
          if (lane == owner) {
            ov = valid(slot);
            oc = code_of(slot);
          }
          ov = __shfl_sync(kFull, ov, owner);
          oc = __shfl_sync(kFull, oc, owner);
          if (lane == 0) {
            if (ov && in_map(oc) && map[oc] == slot) map[oc] = kNone;
            if (in_map(c)) map[c] = slot;
          }
          __syncwarp();  // a prune below may clear the entry
        }
        if (lane == owner) {
          fs = hit ? wrap_add(freq_of(slot), 1) : 1;
          at(kFreq, slot) = static_cast<unsigned>(fs);
          if (lossy && !hit) at(kDelta, slot) = static_cast<unsigned>(bucket - 1);
          at(kValid, slot) = 1u;
          at(kCode, slot) = static_cast<unsigned>(c);
          for (int a = 0; a < A; ++a) at(kVals + a, slot) = st[a * 32 + j];
        }
        hi = max(hi, slot + 1);
        if (prune) {  // bucket boundary (lossy): prune
          for (int i = lane; i < hi; i += 32) {
            if (valid(i) && !(wrap_add(freq_of(i), static_cast<int>(at(kDelta, i))) > bucket)) {
              at(kValid, i) = 0u;
              unmap(i);
            }
          }
          __syncwarp();
        }
        if (lossy) {
          vs = __shfl_sync(kFull, lane == owner ? static_cast<int>(valid(slot)) : 0, owner) != 0;
          fs = __shfl_sync(kFull, fs, owner);
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
      const bool emit = lossy ? vs && __int2float_rn(fs) >= thresh : admitted;
      if (emit) {
        auto member = [&](int i) {
          return valid(i) && (!lossy || __int2float_rn(freq_of(i)) >= thresh);
        };
        auto word = [&](int a, int i) { return at(kVals + a, i); };
        warp_rows::row(hi, member, word, splan, S, [&](int s, unsigned w) {
          if (lane == 0) reinterpret_cast<unsigned*>(p.rows)[s * E + t] = w;
        });
        if (lane == 0) p.emit[t] = 1;
      }
    }
    seen = wrap_add(seen, __popc(bits));
  }
  if (lane == 0) *p.seen = seen;
  if (fast) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * 32 + lane;
      if (!own[r]) continue;
      p.table[kValid * C + i] = v[r];
      p.table[kCode * C + i] = static_cast<unsigned>(code[r]);
      p.table[kFreq * C + i] = static_cast<unsigned>(freq[r]);
      p.table[kDelta * C + i] = static_cast<unsigned>(delta[r]);
      for (int a = 0; a < A; ++a) p.table[(kVals + a) * C + i] = col[(r * A + a) * 32 + lane];
    }
  } else if (wide_ok && p.in_shared) {
    __syncwarp();
    for (int i = lane; i < W * C; i += 32) p.table[i] = tb[i];
  }
}

template <class Kern>
cudaError_t raise_smem(Kern kernel, long long bytes, long long* set) {
  if (bytes <= *set) return cudaSuccess;  // raised once for each larger size (before a capture)
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *set = bytes;
  return err;
}

template <int R>
int launch(const FreqArgs& p, cudaStream_t s) {
  static long long set = 48 * 1024;
  const long long smem =
      4 * freq_smem_words(p.C, p.A, p.S, p.K, R, p.in_shared, p.map_shared);
  const cudaError_t err = raise_smem(frequency_scan_kernel<R>, smem, &set);
  if (err != cudaSuccess) return static_cast<int>(err);
  frequency_scan_kernel<R><<<1, 32, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes of the block: R fast tiers (0, 1 or 2), the wide
// table and the map in shared memory or not.
extern "C" long long fst_frequency_smem(int C, int A, int S, int K, int R, int in_shared,
                                        int map_shared) {
  return 4 * freq_smem_words(C, A, S, K, R, in_shared, map_shared);
}

// Launch on `stream`, one warp with R fast tiers (R <= 1 for C <= 32);
// the wrapper has laid the state out in `table` and `seen` (updated in
// place), filled a device-memory `map` with INT_MAX and zeroed `emit` and
// `rows`. Returns a cudaError_t.
extern "C" int fst_frequency_scan(const void* args, int R, void* stream) {
  const FreqArgs p = *static_cast<const FreqArgs*>(args);
  if (p.C < 1 || p.E < 1 || p.A < 0 || p.S < 1 || p.K < 1 || (p.lossy && p.width < 1) ||
      R < 0 || R > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return R == 0 ? launch<0>(p, s) : R == 1 ? launch<1>(p, s) : launch<2>(p, s);
}
