// The pair step of a windowed two-stream join: every (arriving event,
// window entry) pair of one micro-batch, in the reference's order.
//
// Replaces: no Pallas kernel. The reference builds, per direction and per
// micro-batch, a dense (E, C + E) pair mask and compacts it with a sort
// (flink_siddhi_tpu/compiler/join.py:335-403, `JoinArtifact._direction`,
// and the `argsort` at :310). Its plain version here is
// `cuda_ops.join_pairs_plain`, the same dense formulation in torch, and the
// specification this kernel is held to exactly.
//
// Semantics (per direction a -> b, l -> r then r -> l): tape position i
// of an arriving a-event (its mask) meets entry j of b's combined buffer
// (the ring of C entries carried from earlier batches, then this batch's
// b-events compacted in tape order) when the entry is valid, arrived
// before it (its ordinal below the b-count at i), is not the same event
// (a self-join), lies in b's window (the last n ordinals of a length
// window; ts above ts_i - span for a time window), within `within` of it,
// and passes the `on` program (program.cuh: a-side columns are its event
// loads, b-side columns its other load kind). Pairs are ranked direction
// first, then i, then j, each direction's unmatched outer rows after its
// pairs: four segments (l -> r pairs, l outer, r -> l pairs, r outer).
// Ranks below `cap` are written as (i, j, segment); `n` is the count
// before the cut.
//
// Design: running max, count, scan, write (six launches, no host read).
// - running max (time windows only, three launches): each 4,096-entry
//   tile's max of the valid b_ts, an exclusive max-scan of the tile
//   maxima, and each tile's running max from its carry, into `tsmax`.
// - count: one thread per (direction, i) walks its candidates and writes
//   its pair count and outer flag; each block adds its tiles' sums.
// - scan: one block turns the 4 x nb tile sums into exclusive offsets in
//   segment order, and writes n.
// - write: each thread scans its block's counts, adds its tile's offset,
//   and walks again, writing ranks below cap.
// Tile sums, offsets and the total are 64-bit: a batch's pairs may pass
// 2^31 (a wide window with no selective `on`). `n` saturates at 2^31 - 1;
// ranks below cap (< 2^31) are exact.
// A length window walks only its band of n ordinals (ordinals are
// contiguous in the combined buffer: entry j is ordinal seen - C + j). A
// time window binary-searches the first entry whose running maximum of
// valid ts (`tsmax`, non-decreasing by construction) exceeds ts_i - span:
// every valid entry before it has ts <= ts_i - span, so the walk starts
// there and checks each ts. On an in-order stream the walk is the window;
// disorder adds only the entries that fall out of the window yet arrived
// after a later-stamped one.
// What bounds it: the walks (candidates visited x the program), then the
// second walk of count-then-write.
#include <cuda_runtime.h>

#include "program.cuh"

namespace {

using namespace fst_program;

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxThreads = 1024;  // the running max's blocks
constexpr int kMaxItems = 4;       // entries a thread
constexpr int kMaxTile = kMaxThreads * kMaxItems;
constexpr int kLow = -2147483647 - 1;  // the max's identity

// One direction, as cuda_ops.JoinPairs packs it (ctypes `_JoinDir`).
struct DirArgs {
  const unsigned char* a_mask;   // [E] the arriving side's events
  const int* a_cols;             // [a_n, E] its program columns (words)
  const int* b_ts;               // [Nb] the other side's combined buffer
  const unsigned char* b_valid;  // [Nb]
  const int* b_posid;            // [Nb] tape position, -1 for ring entries
  const int* b_cum;              // [E] b-count up to and including i
  const int* b_seen;             // [1] b-events before this batch
  const int* b_cols;             // [b_n, Nb]
  int* tsmax;                     // [Nb] scratch: running max of valid b_ts
  int* tmax;                      // [nt] scratch: tile maxima, then carries
  const int* prog;               // the `on` program of this direction
  int a_n, b_n, Nb, Cb, mode_time, n, span, outer, prog_len, pad;
};

struct JoinArgs {
  DirArgs d[2];
  const int* ts;        // [E] the tape's timestamps
  int* cnt;             // [4E] scratch: per segment and i
  long long* tile;      // [4 nb] scratch: per segment and block
  int* out_i;           // [cap]
  int* out_j;           // [cap]
  int* out_seg;         // [cap]
  int* n_out;           // [1]
  long long* visits;    // [1] candidates walked by the count pass, or null
  int E, cap, self_join, has_within, within, depth;
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(u32(a) - u32(b));
}

// i's candidates [lo, hi) in b's combined buffer.
__device__ __forceinline__ void band(const JoinArgs& p, const DirArgs& d,
                                     int i, int tlo, int& lo, int& hi) {
  const int base = *d.b_seen - d.Cb;  // ordinal of entry 0
  const int cum = d.b_cum[i];
  hi = min(cum - base, d.Nb);
  lo = 0;
  if (!d.mode_time) {
    lo = max(cum - d.n - base, 0);
  } else {
    int a = 0, b = max(hi, 0);  // first j with tsmax[j] > tlo
    while (a < b) {
      const int m = (a + b) >> 1;
      if (d.tsmax[m] > tlo) b = m; else a = m + 1;
    }
    lo = a;
  }
}

// Walks i's candidates: counts them, or writes them from rank `out0`.
template <bool kWrite>
__device__ int walk(const JoinArgs& p, const DirArgs& d, int dir, int i,
                    int* st, int out0, int* visited) {
  const int ts_i = p.ts[i];
  const int tlo = wrap_sub(ts_i, d.span);
  int lo, hi;
  band(p, d, i, tlo, lo, hi);
  if (visited) *visited = max(hi - lo, 0);
  int c = 0;
  for (int j = lo; j < hi; ++j) {
    if (!d.b_valid[j]) continue;
    if (p.self_join && d.b_posid[j] == i) continue;
    const int tj = d.b_ts[j];
    if (d.mode_time && !(tj > tlo)) continue;
    if (p.has_within) {
      const int dd = wrap_sub(ts_i, tj);
      const int ad = dd < 0 ? wrap_sub(0, dd) : dd;
      if (ad > p.within) continue;
    }
    if (d.prog_len &&
        !run_program(
            d.prog, d.prog_len,
            [&](int a) { return d.a_cols[static_cast<size_t>(a) * p.E + i]; },
            [&](int a) { return d.b_cols[static_cast<size_t>(a) * d.Nb + j]; },
            st, kThreads))
      continue;
    if (kWrite) {
      if (c >= p.cap - out0) break;  // out0 < cap: no overflow
      const int r = out0 + c;
      p.out_i[r] = i;
      p.out_j[r] = j;
      p.out_seg[r] = 2 * dir;
    }
    ++c;
  }
  return c;
}

// Block-wide exclusive max-scan of one value a thread (kMaxThreads
// threads); `total` is the block's max.
__device__ __forceinline__ int block_max_excl(int v, int* warp_tot,
                                              int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = warp_tot[lane];  // kMaxThreads / 32 == 32 warps
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = max(t, y);
    }
    warp_tot[lane] = t;  // inclusive
  }
  __syncthreads();
  int before = w ? warp_tot[w - 1] : kLow;
  const int up = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane) before = max(before, up);
  total = warp_tot[31];
  __syncthreads();
  return before;
}

// The running max, 1 of 3: each tile's max of the valid b_ts.
__global__ void __launch_bounds__(kMaxThreads)
join_tile_max_kernel(JoinArgs p) {
  __shared__ int warp_tot[32];
  const DirArgs& d = p.d[blockIdx.y];
  const int base = blockIdx.x * kMaxTile;
  if (!d.mode_time || base >= d.Nb) return;
  int m = kLow;
  for (int k = 0; k < kMaxItems; ++k) {
    const int j = base + k * kMaxThreads + threadIdx.x;
    if (j < d.Nb && d.b_valid[j]) m = max(m, d.b_ts[j]);
  }
  int total;
  block_max_excl(m, warp_tot, total);
  if (threadIdx.x == 0) d.tmax[blockIdx.x] = total;
}

// 2 of 3: the tile maxima -> exclusive prefix maxima (one block a side).
__global__ void __launch_bounds__(kMaxThreads)
join_tile_carry_kernel(JoinArgs p) {
  __shared__ int warp_tot[32];
  const DirArgs& d = p.d[blockIdx.y];
  if (!d.mode_time) return;
  const int nt = (d.Nb + kMaxTile - 1) / kMaxTile;
  const int per = (nt + kMaxThreads - 1) / kMaxThreads;
  const int a = threadIdx.x * per, b = min(a + per, nt);
  int m = kLow;
  for (int k = a; k < b; ++k) m = max(m, d.tmax[k]);
  int total;
  int run = block_max_excl(m, warp_tot, total);
  for (int k = a; k < b; ++k) {
    const int v = d.tmax[k];
    d.tmax[k] = run;
    run = max(run, v);
  }
}

// 3 of 3: each tile's running max from its carry (kMaxItems contiguous
// entries a thread).
__global__ void __launch_bounds__(kMaxThreads)
join_run_max_kernel(JoinArgs p) {
  __shared__ int warp_tot[32];
  const DirArgs& d = p.d[blockIdx.y];
  const int base = blockIdx.x * kMaxTile;
  if (!d.mode_time || base >= d.Nb) return;
  const int j0 = base + threadIdx.x * kMaxItems;
  int v[kMaxItems];
  int m = kLow;
  for (int k = 0; k < kMaxItems; ++k) {
    const int j = j0 + k;
    v[k] = j < d.Nb && d.b_valid[j] ? d.b_ts[j] : kLow;
    m = max(m, v[k]);
  }
  int total;
  int run = max(d.tmax[blockIdx.x], block_max_excl(m, warp_tot, total));
  for (int k = 0; k < kMaxItems; ++k) {
    run = max(run, v[k]);
    if (j0 + k < d.Nb) d.tsmax[j0 + k] = run;
  }
}

// Block-wide exclusive scan of one value a thread (kThreads threads),
// in 64 bits.
__device__ __forceinline__ long long block_excl(long long v,
                                                long long* warp_tot,
                                                long long& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    long long t = lane < kThreads / 32 ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kThreads / 32) warp_tot[lane] = t;  // inclusive
  }
  __syncthreads();
  const long long before = w ? warp_tot[w - 1] : 0;
  total = warp_tot[kThreads / 32 - 1];
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
join_count_kernel(JoinArgs p, int nb) {
  extern __shared__ int stack[];
  __shared__ long long warp_tot[kThreads / 32];
  const int dir = blockIdx.y;
  const DirArgs& d = p.d[dir];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int c = 0, o = 0, visited = 0;
  if (i < p.E && d.a_mask[i]) {
    c = walk<false>(p, d, dir, i, stack + threadIdx.x, 0,
                    p.visits ? &visited : nullptr);
    o = d.outer && c == 0;
  }
  if (i < p.E) {
    p.cnt[(2 * dir) * p.E + i] = c;
    p.cnt[(2 * dir + 1) * p.E + i] = o;
  }
  long long tc, to;
  block_excl(c, warp_tot, tc);
  block_excl(o, warp_tot, to);
  if (p.visits) {
    long long tv;
    block_excl(visited, warp_tot, tv);
    if (threadIdx.x == 0 && tv)
      atomicAdd(reinterpret_cast<unsigned long long*>(p.visits),
                static_cast<unsigned long long>(tv));
  }
  if (threadIdx.x == 0) {
    p.tile[(2 * dir) * nb + blockIdx.x] = tc;
    p.tile[(2 * dir + 1) * nb + blockIdx.x] = to;
  }
}

// The tile sums (segment-major) -> exclusive offsets, and their total
// (saturated to int32).
__global__ void __launch_bounds__(kScanThreads)
join_scan_kernel(long long* tile, int m, int* n_out) {
  __shared__ long long warp_tot[kScanThreads / 32];
  const int per = (m + kScanThreads - 1) / kScanThreads;
  const int a = threadIdx.x * per, b = min(a + per, m);
  long long s = 0;
  for (int k = a; k < b; ++k) s += tile[k];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long x = s;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    long long t = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  long long run = (w ? warp_tot[w - 1] : 0) + x - s;
  for (int k = a; k < b; ++k) {
    const long long v = tile[k];
    tile[k] = run;
    run += v;
  }
  if (threadIdx.x == kScanThreads - 1)
    *n_out = static_cast<int>(min(warp_tot[31], 2147483647LL));
}

__global__ void __launch_bounds__(kThreads)
join_write_kernel(JoinArgs p, int nb) {
  extern __shared__ int stack[];
  __shared__ long long warp_tot[kThreads / 32];
  const int dir = blockIdx.y;
  const DirArgs& d = p.d[dir];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < p.E;
  const int c = in ? p.cnt[(2 * dir) * p.E + i] : 0;
  const int o = in ? p.cnt[(2 * dir + 1) * p.E + i] : 0;
  long long tc, to;
  const long long ec = block_excl(c, warp_tot, tc);
  const long long eo = block_excl(o, warp_tot, to);
  const long long pc = p.tile[(2 * dir) * nb + blockIdx.x] + ec;
  const long long po = p.tile[(2 * dir + 1) * nb + blockIdx.x] + eo;
  if (c > 0 && pc < p.cap)
    walk<true>(p, d, dir, i, stack + threadIdx.x, static_cast<int>(pc),
               nullptr);
  if (o && po < p.cap) {
    p.out_i[static_cast<int>(po)] = i;
    p.out_j[static_cast<int>(po)] = 0;
    p.out_seg[static_cast<int>(po)] = 2 * dir + 1;
  }
}

}  // namespace

// `args` points at a JoinArgs (cuda_ops._JoinArgs); returns a cudaError_t.
extern "C" int fst_join_pairs(const void* args, void* stream) {
  const JoinArgs p = *static_cast<const JoinArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (p.E + kThreads - 1) / kThreads;
  if (p.d[0].mode_time || p.d[1].mode_time) {
    const int nt = (max(p.d[0].Nb, p.d[1].Nb) + kMaxTile - 1) / kMaxTile;
    join_tile_max_kernel<<<dim3(nt, 2), kMaxThreads, 0, s>>>(p);
    join_tile_carry_kernel<<<dim3(1, 2), kMaxThreads, 0, s>>>(p);
    join_run_max_kernel<<<dim3(nt, 2), kMaxThreads, 0, s>>>(p);
  }
  const size_t smem = static_cast<size_t>(p.depth) * kThreads * sizeof(int);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(join_count_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaFuncSetAttribute(join_write_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  join_count_kernel<<<dim3(nb, 2), kThreads, smem, s>>>(p, nb);
  join_scan_kernel<<<1, kScanThreads, 0, s>>>(p.tile, 4 * nb, p.n_out);
  join_write_kernel<<<dim3(nb, 2), kThreads, smem, s>>>(p, nb);
  return static_cast<int>(cudaGetLastError());
}
