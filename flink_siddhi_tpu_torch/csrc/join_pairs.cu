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
// before the cut, saturated at 2^31 - 1.
//
// What bounds it on an H100: the walk's issue slots and latency. Every
// candidate (an arriving event's band: about 100 on a join of 100-event
// windows) costs a few shared-memory loads and the window, `within` and
// key checks; every candidate that passes them, the `on` program's
// interpreter. The bytes the function must move (each input once, each
// pair once) take about 0.01 ms at 3.35 TB/s. The first port (one thread
// a tape position, a count walk and a write walk) lost to dependent
// global loads: each lane walked its own band alone, half the lanes of a
// warp held no arriving event, every candidate ran the interpreter, and
// every candidate was walked twice.
//
// Design: walk, scan, write (plus a time window's running max, three
// short launches), with no host read.
// - walk: a block takes a tile of 256 tape positions of one direction,
//   one thread a position for its band [lo, hi): a length window's
//   ordinals, or a time window's binary search for the first entry whose
//   running maximum of valid ts (`tsmax`, non-decreasing) exceeds
//   ts_i - span. The union of the tile's bands [min lo, max hi) (lo need
//   not be monotone in i on a disordered stream) goes to shared memory
//   with cp.async: ts, a key word (-2 for an invalid entry, else the tape
//   position for a self-join, else -1) and the program's b-columns.
//   Warp w takes the arriving events among positions 32w..32w+31 in tape
//   order (a ballot over the mask: no lane holds a masked-out position)
//   and walks one event at a time with its 32 lanes over 32 consecutive
//   candidates; the event's ts, band and key word are warp-uniform. The
//   window's checks and the program's key equality (cuda_ops.
//   join_key_hint: its first top-level conjunct `a.x == b.y` over int
//   columns, a necessary condition) queue the candidates that pass, in
//   (i, j) order; each 32 queued run the program through the interpreter
//   (program.cuh) as one full warp, and a ballot and a popc rank the
//   pairs, which are staged in the warp's shared memory (128 pairs). The
//   tile then reserves room for its pairs in a pool (one atomicAdd) and
//   copies them there, coalesced, and writes its (pairs, outer) sums.
//   No block waits on another (a single pass with look-back made every
//   tile wait for the slowest earlier one: a third of a tile's time).
// - scan: one block turns the tiles' sums, in segment order, into
//   exclusive offsets (64-bit), and writes n saturated at 2^31 - 1.
// - write: each tile's outer rows at their ranks; its staged pairs
//   copied from the pool to their ranks, coalesced. A tile whose warps'
//   pairs overflowed their staging, whose union passed one shared-memory
//   chunk (a window holding every earlier event: the union streams
//   through the buffer in chunks, counted in the walk), or which found
//   the pool full (its pool holds `cap` pairs: only ranks below cap are
//   written), walks again here, each pair at its event's offset from the
//   counts the walk kept: correct and slower, and counted (`rewalks`).
// - Sums, offsets and the total are 64-bit: a batch's pairs may pass
//   2^31 (a wide window with no selective `on`); ranks below cap (< 2^31)
//   are exact.
// The program's stack lives in local memory (a thread's private array,
// cached in L1), so a deep program does not take the union's room. A
// program deeper than that array (kLocalDepth) takes a global stack of
// depth x threads words that the wrapper allocates (cuda_ops.JoinPairs):
// the walk and the write then run `stack_x` blocks a direction, each
// taking its tiles in turn, so that the stack stays within
// cuda_ops.STACK_WORDS.
#include <climits>
#include <cuda_runtime.h>

#include "program.cuh"

namespace {

using namespace fst_program;

constexpr int kThreads = 256;   // tape positions a tile, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;   // the walk's blocks an SM (64 registers)
constexpr int kStage = 128;     // pairs a warp stages
constexpr int kQueue = 64;      // candidates a warp queues for its program
constexpr int kRounds = 2;      // rounds of 32 candidates an iteration
constexpr int kLocalDepth = 227;  // cuda_ops.STACK_LOCAL_DEPTH
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;   // tile sums a scan thread holds
constexpr int kMaxThreads = 1024;  // the running max's blocks
constexpr int kMaxItems = 4;       // entries a thread
constexpr int kMaxTile = kMaxThreads * kMaxItems;
constexpr int kLow = -2147483647 - 1;  // the max's identity
constexpr int kInvalid = -2;           // the key of an invalid entry
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper

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
  int a_n, b_n, Nb, Cb, mode_time, n, span, outer, prog_len;
  int key_a, key_b;  // the program's key equality a_cols[key_a] ==
                     // b_cols[key_b], or -1
};

// S = ndirs * nt tiles, direction 0's then direction 1's (a stream-table
// join has one direction).
struct JoinArgs {
  DirArgs d[2];
  const int* ts;                 // [E] the tape's timestamps
  long long* tile;               // [2 S] each tile's pairs and outer rows,
                                 // segment-major; then their offsets
  long long* meta;               // [2 S] each tile's pool offset (-1: walk
                                 // again), then its pairs
  unsigned long long* pool_ctr;  // [1] the pool's used pairs (zeroed)
  int2* pool;                    // [pool_cap] staged (i, j)
  int* cnt;                      // [S * kThreads] each event's pairs, for
                                 // a tile that walks again
  unsigned* omask;               // [S * kWarps] each warp's outer events
  int* out_i;                    // [cap]
  int* out_j;                    // [cap]
  int* out_seg;                  // [cap]
  int* n_out;                    // [1]
  long long* visits;             // [1] candidates in the bands, or null
  long long* rewalks;            // [1] tiles walked again, or null
  int* stack;                    // a deep program's [depth][threads] stack
  int E, cap, self_join, has_within, within, depth, ucap, nt, pool_cap;
  int ndirs;                     // 1 or 2
  int stack_x;                   // a deep program's blocks a direction
};

// The `on` program's stack of this thread: its local array, or (kDeep)
// its column of the global stack; `T` is the column's stride.
template <bool kDeep>
struct Stack {
  int local[kDeep ? 1 : kLocalDepth];
  int* at;
  int T;
  __device__ __forceinline__ Stack(const JoinArgs& p) {
    if (kDeep) {
      T = gridDim.x * gridDim.y * blockDim.x;
      at = p.stack + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * blockDim.x + threadIdx.x;
    } else {
      T = 1;
      at = local;
    }
  }
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(u32(a) - u32(b));
}

// -- the tile's shared memory ----------------------------------------------

struct Tile {
  int* lo;      // [kThreads] each position's band
  int* hi;
  int* tsi;     // [kThreads] each position's ts
  int* aw;      // [kThreads] each position's key word (a_cols[key_a])
  int* stage;   // [kWarps][2][kStage] staged (i, j)
  int* queue;   // [kWarps][2][kQueue] queued candidates (k, j)
  int* evx;     // [kWarps][32] each event's pairs (a write: written)
  int* u_ts;    // [ucap] the union chunk: ts
  int* u_key;   // [ucap] -2 invalid, else posid (self-join) or -1
  int* u_cols;  // [b_n][ucap] the program's b-columns
};

// The dynamic shared memory's words (the host sizes it the same way).
__host__ __device__ constexpr size_t tile_words(int ucap, int bn) {
  return 5 * static_cast<size_t>(kThreads) +
         2 * static_cast<size_t>(kWarps) * (kStage + kQueue) +
         static_cast<size_t>(ucap) * (2 + bn);
}

__device__ __forceinline__ Tile tile_layout(int* smem, int ucap) {
  Tile t;
  t.lo = smem;
  t.hi = t.lo + kThreads;
  t.tsi = t.hi + kThreads;
  t.aw = t.tsi + kThreads;
  t.stage = t.aw + kThreads;
  t.queue = t.stage + kWarps * 2 * kStage;
  t.evx = t.queue + kWarps * 2 * kQueue;
  t.u_ts = t.evx + kThreads;
  t.u_key = t.u_ts + ucap;
  t.u_cols = t.u_key + ucap;
  return t;
}

// The tile's union of bands [u0, u1), in `nch` chunks of the buffer.
struct Union {
  int u0, u1, nch;
};

// Every thread: its position's band [lo, hi) into the tile (a length
// window's ordinals; a time window's first entry whose running maximum of
// valid ts exceeds ts_i - span), each warp's arriving positions into
// `amask`, the union of the tile's non-empty bands, and in `vis` the
// candidates in them.
__device__ __forceinline__ Union tile_bands(const JoinArgs& p,
                                            const DirArgs& d, const Tile& t,
                                            int t0, unsigned* amask,
                                            long long& vis) {
  __shared__ int s_umin[kWarps], s_umax[kWarps];
  __shared__ long long s_vis[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int i = t0 + tid;
  const bool arr = i < p.E && d.a_mask[i];
  int lo = 0, hi = 0;
  if (arr) {
    const int ts_i = p.ts[i];
    const int base = *d.b_seen - d.Cb;  // ordinal of entry 0
    const int cum = d.b_cum[i];
    hi = min(cum - base, d.Nb);
    if (!d.mode_time) {
      lo = max(cum - d.n - base, 0);
    } else {
      const int tlo = wrap_sub(ts_i, d.span);
      int a = 0, b = max(hi, 0);  // first j with tsmax[j] > tlo
      while (a < b) {
        const int m = (a + b) >> 1;
        if (d.tsmax[m] > tlo) b = m; else a = m + 1;
      }
      lo = a;
    }
    t.tsi[tid] = ts_i;
    if (d.key_b >= 0) {
      t.aw[tid] = __ldg(d.a_cols + static_cast<size_t>(d.key_a) * p.E + i);
    }
  }
  t.lo[tid] = lo;
  t.hi[tid] = hi;
  const unsigned am = __ballot_sync(kFull, arr);
  const bool some = arr && hi > lo;
  int umin = some ? lo : INT_MAX, umax = some ? hi : 0;
  long long v = some ? hi - lo : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    umin = min(umin, __shfl_xor_sync(kFull, umin, o));
    umax = max(umax, __shfl_xor_sync(kFull, umax, o));
    v += __shfl_xor_sync(kFull, v, o);
  }
  if (lane == 0) {
    amask[w] = am;
    s_umin[w] = umin;
    s_umax[w] = umax;
    s_vis[w] = v;
  }
  __syncthreads();
  Union u = {INT_MAX, 0, 0};
  vis = 0;
  for (int k = 0; k < kWarps; ++k) {
    u.u0 = min(u.u0, s_umin[k]);
    u.u1 = max(u.u1, s_umax[k]);
    vis += s_vis[k];
  }
  u.nch = u.u0 < u.u1 ? (u.u1 - u.u0 + p.ucap - 1) / p.ucap : 0;
  return u;
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(src)
               : "memory");
}

// Entries [c0, c1) of b's buffer into the union chunk (every thread).
__device__ void load_chunk(const JoinArgs& p, const DirArgs& d,
                           const Tile& t, int c0, int c1) {
  __syncthreads();  // the last chunk's readers are done
  for (int k = threadIdx.x; k < c1 - c0; k += kThreads) {
    const int j = c0 + k;
    cp_async4(t.u_ts + k, d.b_ts + j);
    for (int r = 0; r < d.b_n; ++r) {
      cp_async4(t.u_cols + r * p.ucap + k,
                d.b_cols + static_cast<size_t>(r) * d.Nb + j);
    }
    t.u_key[k] = !d.b_valid[j] ? kInvalid
                               : (p.self_join ? d.b_posid[j] : -1);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

enum Mode { kStageMode, kCountMode, kWriteMode };

// One batch of a warp's queue (its first `m` entries, m <= 32: event k,
// candidate j; in (i, j) order) through the `on` program, a lane an
// entry. The passing pairs are staged (kStageMode: from rank `total`,
// while the staging has room), counted (kCountMode) or written at their
// ranks (kWriteMode: event k's first rank is `ev_base` of lane k plus
// `evx[k]`, its pairs written before); `evx[k]` (the warp's event counts,
// or in kWriteMode its written counts) and `total` grow by the passing
// pairs.
template <Mode kMode, bool kDeep>
__device__ __forceinline__ void run_batch(const JoinArgs& p,
                                          const DirArgs& d, int dir,
                                          const Tile& t, int w, int lane,
                                          int t0, int c0, int m,
                                          long long ev_base,
                                          long long& total) {
  Stack<kDeep> stk(p);
  const int* qk = t.queue + w * 2 * kQueue;
  const int* qj = qk + kQueue;
  int* evx = t.evx + w * 32;
  const bool has = lane < m;
  const int k = has ? qk[lane] : 0;
  const int j = has ? qj[lane] : 0;
  const int i = t0 + w * 32 + k;
  bool ok = has;
  if (ok && d.prog_len) {
    const int u = j - c0, ucap = p.ucap;
    ok = run_program(
             d.prog, d.prog_len,
             [&](int a) {
               return __ldg(d.a_cols + static_cast<size_t>(a) * p.E + i);
             },
             [&](int a) { return t.u_cols[a * ucap + u]; }, stk.at,
             stk.T) != 0;
  }
  const unsigned okm = __ballot_sync(kFull, ok);
  // the lanes of one event (a lane without an entry is a group alone)
  const unsigned grp = __match_any_sync(kFull, has ? k : 32 + lane);
  const unsigned lt = (1u << lane) - 1u;
  if (kMode == kStageMode) {
    const long long r = total + __popc(okm & lt);
    if (ok && r < kStage) {
      int* st_i = t.stage + w * 2 * kStage;
      st_i[r] = i;
      st_i[kStage + r] = j;
    }
  } else if (kMode == kWriteMode) {
    const long long r = __shfl_sync(kFull, ev_base, k) + evx[k] +
                        __popc(grp & okm & lt);
    if (ok && r < p.cap) {
      p.out_i[r] = i;
      p.out_j[r] = j;
      p.out_seg[r] = 2 * dir;
    }
  }
  __syncwarp();
  if (has && (grp & lt) == 0) evx[k] += __popc(grp & okm);
  __syncwarp();
  total += __popc(okm);
}

// Warp w walks its arriving events against the chunk [c0, c1) of b's
// buffer, one event at a time with its lanes over 32 candidates a round
// (kRounds rounds an iteration):
// the window's checks, and the `on` program's key equality where it has
// one (`key_a`, `key_b`: a necessary condition, so the program confirms
// every pair), queue the candidates that pass in (i, j) order; each 32
// queued run the program as one batch (`run_batch`). Returns the warp's
// pairs.
template <Mode kMode, bool kDeep>
__device__ __forceinline__ long long walk(const JoinArgs& p,
                                          const DirArgs& d, int dir,
                                          const Tile& t, unsigned amask,
                                          int w, int lane, int t0, int c0,
                                          int c1, long long ev_base) {
  const int ucap = p.ucap, span = d.span, within = p.within;
  const bool self_join = p.self_join, has_within = p.has_within;
  const bool mode_time = d.mode_time;
  const int key_b = d.key_b;
  int* qk = t.queue + w * 2 * kQueue;
  int* qj = qk + kQueue;
  const unsigned lt = (1u << lane) - 1u;
  long long total = 0;
  int qn = 0;  // queued, warp-uniform
  while (amask) {
    const int k = __ffs(amask) - 1;
    amask &= amask - 1;
    const int q = w * 32 + k;
    const int jlo = max(t.lo[q], c0), jhi = min(t.hi[q], c1);
    if (jlo >= jhi) continue;
    if (kMode == kWriteMode && __shfl_sync(kFull, ev_base, k) >= p.cap) {
      continue;  // every later rank of the warp too
    }
    const int i = t0 + q;
    const int ts_i = t.tsi[q];
    const int tlo = wrap_sub(ts_i, span);
    const int aw = t.aw[q];
    // candidate j against the window's checks and the key
    auto passes = [&](int j) {
      if (j >= jhi) return false;
      const int u = j - c0;
      const int key = t.u_key[u];
      const int tj = t.u_ts[u];
      bool ok = key != kInvalid && !(self_join && key == i);
      if (ok && mode_time) ok = tj > tlo;
      if (ok && has_within) {
        const int dd = wrap_sub(ts_i, tj);
        const int ad = dd < 0 ? wrap_sub(0, dd) : dd;
        ok = !(ad > within);
      }
      if (ok && key_b >= 0) ok = t.u_cols[key_b * ucap + u] == aw;
      return ok;
    };
    // a round's passing candidates to the queue; 32 queued run as a batch
    auto push = [&](unsigned b, bool ok, int j) {
      if (ok) {
        const int at = qn + __popc(b & lt);
        qk[at] = k;
        qj[at] = j;
      }
      qn += __popc(b);
      if (qn >= 32) {
        __syncwarp();
        run_batch<kMode, kDeep>(p, d, dir, t, w, lane, t0, c0, 32, ev_base,
                                total);
        // the rest (at most 31) to the front
        const int rest = qn - 32;
        const int rk = lane < rest ? qk[32 + lane] : 0;
        const int rj = lane < rest ? qj[32 + lane] : 0;
        __syncwarp();
        if (lane < rest) {
          qk[lane] = rk;
          qj[lane] = rj;
        }
        __syncwarp();
        qn = rest;
      }
    };
    // kRounds rounds an iteration: their loads and checks overlap
    for (int j0 = jlo; j0 < jhi; j0 += 32 * kRounds) {
      bool ok[kRounds];
      unsigned b[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) ok[r] = passes(j0 + 32 * r + lane);
#pragma unroll
      for (int r = 0; r < kRounds; ++r) b[r] = __ballot_sync(kFull, ok[r]);
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (b[r]) push(b[r], ok[r], j0 + 32 * r + lane);
      }
    }
  }
  if (qn > 0) {
    __syncwarp();
    run_batch<kMode, kDeep>(p, d, dir, t, w, lane, t0, c0, qn, ev_base, total);
  }
  return total;
}

// -- the running max of a time window's valid ts ---------------------------

// Block-wide exclusive max-scan of one value a thread (kMaxThreads
// threads); `total` is the block's max.
__device__ __forceinline__ int block_max_excl(int v, int* warp_tot,
                                              int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = warp_tot[lane];  // kMaxThreads / 32 == 32 warps
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t = max(t, y);
    }
    warp_tot[lane] = t;  // inclusive
  }
  __syncthreads();
  int before = w ? warp_tot[w - 1] : kLow;
  const int up = __shfl_up_sync(kFull, x, 1);
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

// -- the pair step -----------------------------------------------------------

// 1 of 3: each tile walks its candidates once, stages its pairs and
// copies them to the pool, or (its pairs past the staging, its union in
// several chunks, or no room left in the pool) keeps each event's count
// for the write's walk.
// A block walks tile `bx` of direction blockIdx.y.
template <bool kDeep>
__device__ __forceinline__ void walk_tile(const JoinArgs& p, int bx) {
  extern __shared__ int smem[];
  __shared__ unsigned s_amask[kWarps];
  __shared__ long long s_wcnt[kWarps];  // each warp's pairs
  __shared__ int s_wout[kWarps];        // each warp's outer rows
  __shared__ long long s_pool;          // the tile's pool offset, or -1
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int dir = blockIdx.y;
  const DirArgs& d = p.d[dir];
  const int seq = dir * p.nt + bx;
  const int t0 = bx * kThreads;
  const Tile t = tile_layout(smem, p.ucap);
  long long vis;
  const Union u = tile_bands(p, d, t, t0, s_amask, vis);
  if (p.visits && tid == 0 && vis) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p.visits),
              static_cast<unsigned long long>(vis));
  }
  const unsigned my = s_amask[w];
  t.evx[tid] = 0;
  long long wcount = 0;
  if (u.nch == 1) {
    load_chunk(p, d, t, u.u0, u.u1);
    wcount = walk<kStageMode, kDeep>(p, d, dir, t, my, w, lane, t0, u.u0,
                                     u.u1, 0);
  } else {
    for (int c = 0; c < u.nch; ++c) {
      const int c0 = u.u0 + c * p.ucap, c1 = min(c0 + p.ucap, u.u1);
      load_chunk(p, d, t, c0, c1);
      wcount += walk<kCountMode, kDeep>(p, d, dir, t, my, w, lane, t0, c0,
                                        c1, 0);
    }
  }
  __syncwarp();
  const int ev_cnt = t.evx[tid];
  const unsigned om =
      d.outer ? __ballot_sync(kFull, ((my >> lane) & 1u) && ev_cnt == 0)
              : 0u;
  if (lane == 0) {
    s_wcnt[w] = wcount;
    s_wout[w] = __popc(om);
    p.omask[seq * kWarps + w] = om;
  }
  __syncthreads();
  if (tid == 0) {
    long long tp = 0, to = 0;
    bool over = false;
    for (int k = 0; k < kWarps; ++k) {
      tp += s_wcnt[k];
      to += s_wout[k];
      over |= s_wcnt[k] > 0 && (u.nch > 1 || s_wcnt[k] > kStage);
    }
    long long po = tp == 0 ? 0 : -1;
    if (tp > 0 && !over) {
      const unsigned long long o =
          atomicAdd(p.pool_ctr, static_cast<unsigned long long>(tp));
      if (o + tp <= static_cast<unsigned long long>(p.pool_cap)) {
        po = static_cast<long long>(o);
      }
    }
    s_pool = po;
    p.tile[(2 * dir) * p.nt + bx] = tp;
    p.tile[(2 * dir + 1) * p.nt + bx] = to;
    p.meta[seq] = po;
    p.meta[p.ndirs * p.nt + seq] = tp;
  }
  __syncthreads();
  const long long po = s_pool;
  if (po >= 0) {
    long long at = po;
    for (int k = 0; k < w; ++k) at += s_wcnt[k];
    const int* st_i = t.stage + w * 2 * kStage;
    const int* st_j = st_i + kStage;
    for (int k = lane; k < wcount; k += 32) {
      p.pool[at + k] = make_int2(st_i[k], st_j[k]);
    }
  } else {
    p.cnt[static_cast<size_t>(seq) * kThreads + tid] = ev_cnt;
  }
}

template <bool kDeep>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
join_walk_kernel(JoinArgs p) {
  if (!kDeep) {  // one tile a block
    walk_tile<kDeep>(p, blockIdx.x);
    return;
  }
  for (int bx = blockIdx.x; bx < p.nt; bx += gridDim.x) {
    if (bx != blockIdx.x) __syncthreads();  // the last tile is done
    walk_tile<kDeep>(p, bx);
  }
}

// 2 of 3: the tile sums (segment-major) -> exclusive offsets, and their
// total (saturated to int32): one block, kScanItems sums a thread in
// registers, a carry from one round of the block to the next.
__global__ void __launch_bounds__(kScanThreads)
join_scan_kernel(long long* tile, int m, int* n_out) {
  __shared__ long long warp_tot[kScanThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long carry = 0;
  for (int base = 0; base < m; base += kScanThreads * kScanItems) {
    const int a = base + threadIdx.x * kScanItems;
    long long v[kScanItems];
    long long s = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = a + k < m ? tile[a + k] : 0;
      s += v[k];
    }
    long long x = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[w] = x;
    __syncthreads();
    if (w == 0) {
      long long t = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, t, o);
        if (lane >= o) t += y;
      }
      warp_tot[lane] = t;
    }
    __syncthreads();
    long long run = carry + (w ? warp_tot[w - 1] : 0) + x - s;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (a + k < m) tile[a + k] = run;
      run += v[k];
    }
    carry += warp_tot[31];
    __syncthreads();  // warp_tot is reused
  }
  if (threadIdx.x == 0) *n_out = static_cast<int>(min(carry, 2147483647LL));
}

// 3 of 3: each tile's outer rows at their ranks; its staged pairs copied
// from the pool, coalesced, or its candidates walked again and each pair
// written at its event's offset (ranks below cap).
// A block writes tile `bx` of direction blockIdx.y.
template <bool kDeep>
__device__ __forceinline__ void write_tile(const JoinArgs& p, int bx) {
  extern __shared__ int smem[];
  __shared__ unsigned s_amask[kWarps];
  __shared__ long long s_wcnt[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int dir = blockIdx.y;
  const DirArgs& d = p.d[dir];
  const int seq = dir * p.nt + bx;
  const int t0 = bx * kThreads;
  if (d.outer) {
    const unsigned* om = p.omask + seq * kWarps;
    const unsigned mine = om[w];
    if ((mine >> lane) & 1u) {
      long long r = p.tile[(2 * dir + 1) * p.nt + bx] +
                    __popc(mine & ((1u << lane) - 1u));
      for (int k = 0; k < w; ++k) r += __popc(om[k]);
      if (r < p.cap) {
        p.out_i[r] = t0 + tid;
        p.out_j[r] = 0;
        p.out_seg[r] = 2 * dir + 1;
      }
    }
  }
  const long long off = p.tile[(2 * dir) * p.nt + bx];
  const long long po = p.meta[seq], tp = p.meta[p.ndirs * p.nt + seq];
  if (tp == 0 || off >= p.cap) return;
  if (po >= 0) {
    const long long m = tp < p.cap - off ? tp : p.cap - off;
    for (long long k = tid; k < m; k += kThreads) {
      const int2 v = p.pool[po + k];
      p.out_i[off + k] = v.x;
      p.out_j[off + k] = v.y;
      p.out_seg[off + k] = 2 * dir;
    }
    return;
  }
  if (p.rewalks && tid == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p.rewalks), 1ull);
  }
  const Tile t = tile_layout(smem, p.ucap);
  long long vis;
  const Union u = tile_bands(p, d, t, t0, s_amask, vis);
  // lane k's event starts at the warp's offset plus the counts before it
  const int ev_cnt = p.cnt[static_cast<size_t>(seq) * kThreads + tid];
  long long x = ev_cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_wcnt[w] = x;
  __syncthreads();
  long long wbase = off;
  for (int k = 0; k < w; ++k) wbase += s_wcnt[k];
  const long long ev_base = wbase + x - ev_cnt;
  const bool again = s_wcnt[w] > 0 && wbase < p.cap;
  const unsigned my = s_amask[w];
  t.evx[tid] = 0;
  for (int c = 0; c < u.nch; ++c) {
    const int c0 = u.u0 + c * p.ucap, c1 = min(c0 + p.ucap, u.u1);
    load_chunk(p, d, t, c0, c1);
    if (again) {
      walk<kWriteMode, kDeep>(p, d, dir, t, my, w, lane, t0, c0, c1,
                              ev_base);
    }
  }
}

template <bool kDeep>
__global__ void __launch_bounds__(kThreads)
join_write_kernel(JoinArgs p) {
  if (!kDeep) {  // one tile a block
    write_tile<kDeep>(p, blockIdx.x);
    return;
  }
  for (int bx = blockIdx.x; bx < p.nt; bx += gridDim.x) {
    if (bx != blockIdx.x) __syncthreads();  // the last tile is done
    write_tile<kDeep>(p, bx);
  }
}

}  // namespace

// Walk, scan, write with `nx` walk and write blocks a direction.
template <bool kDeep>
void launch_pairs(const JoinArgs& p, size_t smem, int nx, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(join_walk_kernel<kDeep>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaFuncSetAttribute(join_write_kernel<kDeep>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  join_walk_kernel<kDeep><<<dim3(nx, p.ndirs), kThreads, smem, s>>>(p);
  join_scan_kernel<<<1, kScanThreads, 0, s>>>(p.tile, 2 * p.ndirs * p.nt,
                                              p.n_out);
  join_write_kernel<kDeep><<<dim3(nx, p.ndirs), kThreads, smem, s>>>(p);
}

// `args` points at a JoinArgs (cuda_ops._JoinArgs; `pool_ctr` zeroed;
// `stack` sized depth x the walk's threads when the program is deeper
// than kLocalDepth); returns a cudaError_t.
extern "C" int fst_join_pairs(const void* args, void* stream) {
  const JoinArgs p = *static_cast<const JoinArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.ndirs < 1 || p.ndirs > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int bn = 0, nb = 0, mode_time = 0;
  for (int k = 0; k < p.ndirs; ++k) {
    bn = max(bn, p.d[k].b_n);
    nb = max(nb, p.d[k].Nb);
    mode_time |= p.d[k].mode_time;
  }
  const size_t smem = sizeof(int) * tile_words(p.ucap, bn);
  const bool deep = p.depth > kLocalDepth;
  if (p.E < 1 || p.nt != (p.E + kThreads - 1) / kThreads || p.ucap < 32 ||
      smem > kMaxSmem - 1024 ||
      (deep && (p.stack == nullptr || p.stack_x < 1 || p.stack_x > p.nt))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode_time) {
    const int nt = (nb + kMaxTile - 1) / kMaxTile;
    join_tile_max_kernel<<<dim3(nt, p.ndirs), kMaxThreads, 0, s>>>(p);
    join_tile_carry_kernel<<<dim3(1, p.ndirs), kMaxThreads, 0, s>>>(p);
    join_run_max_kernel<<<dim3(nt, p.ndirs), kMaxThreads, 0, s>>>(p);
  }
  if (deep) {
    launch_pairs<true>(p, smem, p.stack_x, s);
  } else {
    launch_pairs<false>(p, smem, p.nt, s);
  }
  return static_cast<int>(cudaGetLastError());
}
