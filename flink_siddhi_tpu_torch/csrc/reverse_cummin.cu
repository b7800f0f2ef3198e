// Multi-channel reverse cumulative minimum (suffix min) over int32 rows.
//
// Replaces: flink_siddhi_tpu/compiler/pallas_ops.py, the Pallas kernel built
// by `_build` and called through `multi_reverse_cummin` (one fused pass over
// up to 8 channels; the chain matcher's next-match tables, nfa.py
// `_chain_core`).
//
// out[c, e] = min(x[c, e], x[c, e + 1], ..., x[c, E - 1]) for c < C, e < E;
// with a pad, out has a row stride ld >= E + 1 (the wrapper takes E + 1
// rounded up to 4 ints, so every row starts on a 16-byte boundary) and
// out[c, E] = pad: column E reads "no match", written by the same launch.
//
// What bounds it on an H100: bytes. The function reads C * E int32 and
// writes C * (E + 1) int32, one integer min per element, far below the
// card's integer rate: at the chain matcher's compacted shape (C = 2,
// E = 65,536) the 1 MiB it moves takes 0.31 us at 3.35 TB/s, under the
// device time of one empty launch (chip_smoke.py phase 7 measures that
// floor, about 0.75 us). So one launch and one pass over memory is all the
// design spends; at that shape the rest of its time is latency: the ticket
// atomic, the tile's loads, one round trip through L2 for the look-back,
// the stores.
//
// Design: a single-pass suffix scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016), run right to left. The Pallas kernel threads a running minimum
// through a sequential grid; Hopper blocks run in no order, so:
//   - each block draws a ticket (atomicAdd) and takes tile
//     n_tiles - 1 - ticket: a block waits only on tiles that blocks which
//     started before it hold, so the scan progresses at any grid size;
//   - one block covers its tile for all C channels, kGroup channels at a
//     time held in registers; it loads and stores 16-byte vectors where the
//     row is aligned (a scalar edge for the ragged end and misaligned rows);
//   - inside the tile: each thread's consecutive events suffix-min'ed in
//     registers, a warp-shuffle suffix scan across lanes, warp totals
//     through shared memory;
//   - each (channel, tile) publishes its aggregate at once, then warp g
//     looks back over the tiles to its right for channel g, 32 tiles at a
//     time, until it meets a tile whose inclusive prefix is published, and
//     publishes its own prefix. A state is one 64-bit word (tag, value),
//     so device-scope relaxed loads and stores are enough (acquire/release
//     would order other data, and there is none; timed during development,
//     they cost more than the whole look-back). The tag holds the status
//     and the call's epoch, so the scratch needs no clearing launch: a word
//     of an earlier call reads "not ready". The epoch lives in device
//     memory, in the high half of the ticket word: each block's ticket
//     atomic returns it with the ticket, and the block that draws the last
//     ticket resets the ticket and stores this call's epoch for the next
//     call. So no launch argument changes from call to call, and a CUDA
//     graph that replays the launch gets a new epoch every time (a host
//     epoch baked into a captured launch would make the look-back read
//     the last replay's prefixes as published). Stream order serialises
//     calls on one scratch; the host zeroes it before the 30-bit epoch
//     would wrap (cuda_ops.py, ScratchBuffer).
// The identity is INT_MAX, so every int32 value is exact.
//
// Tile: 2,048 events and 256 threads (8 events a thread and channel, 4
// channels in registers at once), fixed at compile time. Measured on an
// H100 against 1,024 and 4,096 at the chain matcher's compacted shape
// (C = 2, E = 65,536) and at full width (E = 524,288), PERF.md §6: 1,024
// doubles the tiles, so the look-back walks twice as many states and more
// blocks spin on it; 4,096 leaves 16 blocks at E = 65,536, so 16 of the
// 132 SMs carry all the loads. 2,048 was fastest at both shapes.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;    // events a block scans
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAggregate = 1u;  // the tile's own minimum
constexpr unsigned kPrefix = 2u;     // the minimum of the tile and all to its right

// The look-back states are single 64-bit words holding their status and
// value together, so relaxed (single-copy atomic) accesses at device scope
// suffice: no other data is published with them.
__device__ __forceinline__ unsigned long long ld_state(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_state(unsigned long long* p,
                                         unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned status, int v) {
  return (static_cast<unsigned long long>((epoch << 2) | status) << 32) |
         static_cast<unsigned>(v);
}

// The status of a state word in this call: 0 (not ready, or an earlier
// call's word), kAggregate or kPrefix.
__device__ __forceinline__ unsigned status_of(unsigned long long w,
                                              unsigned epoch) {
  const unsigned tag = static_cast<unsigned>(w >> 32);
  return (tag >> 2) == epoch ? (tag & 3u) : 0u;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = min(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// Warp-wide: the minimum over the tiles right of `tile` (the exclusive
// carry), read from their published states, 32 tiles a round, until the
// nearest published prefix.
__device__ int look_back(const unsigned long long* st, int tile, int n_tiles,
                         unsigned epoch, int lane) {
  int carry = INT_MAX;
  for (int j = tile + 1;; j += 32) {
    const int i = j + lane;
    unsigned status = kPrefix;  // past the last tile: the identity
    int val = INT_MAX;
    if (i < n_tiles) {
      unsigned long long w;
      do {
        w = ld_state(st + i);
        status = status_of(w, epoch);
      } while (status == 0);
      val = static_cast<int>(static_cast<unsigned>(w));
    }
    const unsigned prefixes = __ballot_sync(kFull, status == kPrefix);
    // lanes up to the nearest published prefix contribute
    const int last = prefixes ? __ffs(prefixes) - 1 : 31;
    carry = min(carry, warp_min(lane <= last ? val : INT_MAX));
    if (prefixes) return carry;
  }
}

template <int kPer>
__device__ __forceinline__ void load_run(const int* __restrict__ row,
                                         long long e0, int E, int* v) {
  const int* p = row + e0;
  if (e0 + kPer <= E && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p) + q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = e0 + k < E ? __ldg(p + k) : INT_MAX;
  }
}

template <int kPer>
__device__ __forceinline__ void store_run(int* __restrict__ row, long long e0,
                                          int E, const int* v) {
  int* p = row + e0;
  if (e0 + kPer <= E && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      reinterpret_cast<int4*>(p)[q] =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (e0 + k < E) p[k] = v[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
suffix_min_kernel(const int* __restrict__ x, int* __restrict__ out, int C,
                  int E, long long ld, int n_tiles, int has_pad, int pad,
                  unsigned long long* states, unsigned long long* ticket) {
  constexpr int kPer = kTile / kThreads;  // events per thread and channel
  constexpr int kWarps = kThreads / 32;
  constexpr int kGroup = 32 / kPer < kWarps ? 32 / kPer : kWarps;
  static_assert(kPer % 4 == 0 && kGroup >= 1, "tile");
  __shared__ int s_tile;
  __shared__ unsigned s_epoch;
  __shared__ int warp_tot[kGroup][kWarps];
  __shared__ int carry[kGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    // the ticket word: the last call's epoch in the high half, this
    // call's ticket count in the low half
    const unsigned long long w = atomicAdd(ticket, 1ull);
    const unsigned t = static_cast<unsigned>(w);
    const unsigned epoch = static_cast<unsigned>(w >> 32) + 1u;
    if (t == static_cast<unsigned>(n_tiles - 1)) {
      // every other block drew its ticket (and read the epoch) already
      atomicExch(ticket, static_cast<unsigned long long>(epoch) << 32);
    }
    s_tile = n_tiles - 1 - static_cast<int>(t);
    s_epoch = epoch;
  }
  __syncthreads();
  const int tile = s_tile;
  const unsigned epoch = s_epoch;
  const long long e0 =
      static_cast<long long>(tile) * kTile + threadIdx.x * kPer;

  for (int c0 = 0; c0 < C; c0 += kGroup) {
    int v[kGroup][kPer];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (c0 + g < C) {
        load_run<kPer>(x + static_cast<size_t>(c0 + g) * E, e0, E, v[g]);
      }
    }
    int s[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (c0 + g >= C) continue;
#pragma unroll
      for (int k = kPer - 2; k >= 0; --k) v[g][k] = min(v[g][k], v[g][k + 1]);
      // inclusive suffix min across lanes: over lanes >= this one
      int m = v[g][0];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_down_sync(kFull, m, off);
        if (lane + off < 32) m = min(m, o);
      }
      s[g] = m;
      if (lane == 0) warp_tot[g][warp] = m;
    }
    __syncthreads();
    // warp g publishes channel c0 + g's aggregate, looks back, publishes
    // its prefix
    if (warp < kGroup && c0 + warp < C) {
      int agg = INT_MAX;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) agg = min(agg, warp_tot[warp][w]);
      unsigned long long* st =
          states + static_cast<size_t>(c0 + warp) * n_tiles;
      int ex = INT_MAX;
      if (tile == n_tiles - 1) {
        if (lane == 0) st_state(st + tile, pack(epoch, kPrefix, agg));
      } else {
        if (lane == 0) st_state(st + tile, pack(epoch, kAggregate, agg));
        ex = look_back(st, tile, n_tiles, epoch, lane);
        if (lane == 0) st_state(st + tile, pack(epoch, kPrefix, min(ex, agg)));
      }
      if (lane == 0) carry[warp] = ex;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (c0 + g >= C) continue;
      int right = carry[g];
      for (int w = warp + 1; w < kWarps; ++w) right = min(right, warp_tot[g][w]);
      const int later = __shfl_down_sync(kFull, s[g], 1);
      if (lane < 31) right = min(right, later);
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[g][k] = min(v[g][k], right);
      store_run<kPer>(out + static_cast<size_t>(c0 + g) * ld, e0, E, v[g]);
    }
    if (c0 + kGroup < C) __syncthreads();  // warp_tot and carry are reused
  }

  // the pad column E of every row, from the block of the last tile
  if (has_pad && tile == n_tiles - 1) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      out[static_cast<size_t>(c) * ld + E] = pad;
    }
  }
}

}  // namespace

// x: int32 [C, E] row-major; out: int32 rows of stride ld (ld == E without
// a pad; with one, ld >= E + 1, and column E holds the pad); states:
// 1 + C * ceil(E / 2048) 64-bit words (at least one tile; word 0 the
// ticket word: the epoch of the last call in its high half, which the
// call advances), zeroed when allocated and again by the host before the
// epoch would pass 2^30 - 1 calls. One launch on `stream`, with the same
// arguments from call to call; returns a cudaError_t.
extern "C" int fst_reverse_cummin(const int* x, int* out, void* states,
                                  int C, int E, long long ld, int has_pad,
                                  int pad, void* stream) {
  if (C < 1 || E < 0 || (!has_pad && ld != E) ||
      (has_pad && ld < static_cast<long long>(E) + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = E > 0 ? (E + kTile - 1) / kTile : 1;
  // word 0 holds the ticket word at every shape; the states follow
  unsigned long long* st = static_cast<unsigned long long*>(states);
  suffix_min_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, C, E, ld, n_tiles, has_pad, pad, st + 1, st);
  return static_cast<int>(cudaGetLastError());
}
