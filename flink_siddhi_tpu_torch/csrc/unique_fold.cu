// In-order fold of one micro-batch into a `#window.unique` slot table, with
// the per-event aggregate rows, as a pipeline of data-parallel kernels.
//
// Replaces: flink_siddhi_tpu/compiler/pallas_ops.py, the Pallas kernel built
// by `_build_fold` and called through `unique_window_fold` (the slot table
// kept in VMEM across a blocked walk of the event axis; its caller is
// scan_windows.py `ScanWindowArtifact._fused_unique`).
//
// The function: for each event t in order, if mask[t], slot
// c = clip(code[t], 0, C - 1) becomes valid and takes the event's A values;
// then every aggregate slot s is computed over the valid slots of the table:
//   count, sum of where(valid, v, 0), avg = sum / max(count, 1),
//   min with identity +inf, max with identity -inf      -> rows[s, t].
// Outputs: rows float32 [S, E], the new valid [C] and the new bufs [A, C].
//
// Integer columns (INT and LONG are int32 on the device): a column flagged
// in the plan holds int32 values in the same 32-bit words (vals and bufs
// by bit pattern; moved, never computed on as floats). Its sum is the fp64
// scan of float32(v), as the reference sums where(valid, v, 0) cast to
// float32; its min and max are exact int32 (identities INT_MAX and
// INT_MIN), written into rows by bit pattern; it has no NaN or inf counts.
//
// What bounds it on an H100: the function must read E x (1 + 4 + 4A) bytes
// of events and both tables and write S x E x 4 bytes of rows — a few
// microseconds at 3.35 TB/s for a 524,288-event batch.
//
// Design. Every row is a function of "the latest value of each slot at
// event t", and that has a parallel form, so no stage walks the event axis
// on one SM (every grid covers ceil(E / 1024) or ceil(C / 256) blocks):
//
// 1. Same-slot neighbours: a stable LSD radix sort of the event indices by
//    slot (unmasked events take the key C and sort last), 8 bits a pass
//    (2 passes at C = 16,384). A pass is a per-block digit histogram, a
//    device-wide exclusive scan of the digit-major histograms, and a
//    scatter with block-local stable ranks (cub::BlockRadixSort on the
//    digit, inside the block). Sorted neighbours with the same slot give
//    prev(t) and next(t); the ends of each slot's run give first(c) and
//    last(c).
// 2. Table out, over C: valid0 | written, and each slot's last value.
// 3. Scanned columns, one int32 or fp64 delta per event: the count (+1 for
//    a slot that becomes valid), and per value column read by a statistic
//    its NaN count and, when a sum reads it, its +inf and -inf counts and
//    its fp64 sum of finite values (new value in, old value out). One
//    device-wide reduce-then-scan takes every column in one pass, seeded
//    with the carried table's own count, non-finite counts and fp64 sum
//    (so a NaN lasts only while a slot holds it, and inf + -inf gives NaN,
//    as in the per-event fold; fp64 keeps ~1e10 sums of 5x10^5 deltas far
//    inside rtol 1e-4 of the float32 reference).
// 4. Min and max: an interval-stabbing tree over the event axis per
//    min/max statistic. Event t holds its value on [t, next(t)); a slot
//    valid at batch start holds its value on [0, first(c)). Each interval
//    applies atomicMin / atomicMax of its order-preserving uint32 key to
//    its canonical nodes; the top 2,047 nodes are pre-reduced in shared
//    memory per block (every long interval hits them). Leaf t takes the
//    min or max of its ancestors. Exact in any order: deterministic.
// 5. Rows, over E: each slot's value from the scanned columns and the
//    trees, written coalesced.
//
// Every launch goes on the caller's stream; nothing synchronises the host;
// the scratch comes from the caller (fst_unique_fold_scratch says how
// many bytes). The aggregate plan travels by value as a kernel argument.
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // events per scan / sort block
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;  // one digit per thread
static_assert(kDigits == kThreads, "one digit counter per thread");
constexpr int kTopNodes = 2048;  // tree nodes pre-reduced in shared memory
constexpr int kMaxSlots = 64;
constexpr int kMaxStats = 65;  // the count and up to 64 (op, column) pairs
constexpr int kMaxArgs = 64;
constexpr int kMaxInts = 1 + 3 * kMaxArgs;  // scanned int32 columns

// slot kinds (the wrapper's codes)
enum { kCount = 0, kSum = 1, kAvg = 2, kMin = 3, kMax = 4 };
// statistic ops; statistic 0 is always the count
enum { kOpCount = 0, kOpSum = 1, kOpMin = 2, kOpMax = 3 };
// what an int32 column counts (its code is u * 4 + kind, u the value column)
enum { kColCount = 0, kColNan = 1, kColPinf = 2, kColNinf = 3 };

// The aggregate plan and the layout of the scanned columns and trees it
// implies, passed by value to every kernel.
struct Fold {
  int n_slots, n_cols, n_int, n_dbl, n_trees;
  signed char slot_kind[kMaxSlots];
  unsigned char slot_stat[kMaxSlots];
  signed char stat_op[kMaxStats];
  signed char stat_col[kMaxStats];   // value column index u (-1: the count)
  signed char stat_tree[kMaxStats];  // tree of a min/max statistic, else -1
  signed char col_arg[kMaxArgs];     // u -> row of vals / bufs
  short col_nan[kMaxArgs];           // u -> its int32 columns (-1: none)
  short col_pinf[kMaxArgs];
  short col_ninf[kMaxArgs];
  signed char col_sum[kMaxArgs];     // u -> its fp64 column (-1: none)
  short int_code[kMaxInts];          // int32 column -> u * 4 + kind
  signed char dbl_col[kMaxArgs];     // fp64 column -> u
  signed char tree_arg[kMaxStats];   // tree -> row of vals / bufs
  signed char tree_max[kMaxStats];   // tree -> 1 for max, 0 for min
  signed char col_int[kMaxArgs];     // u -> 1 for an int32 column
  signed char tree_int[kMaxStats];   // tree -> 1 over an int32 column
};

// Floats to uint32 keys in the same order (no NaN ever goes in).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float order_val(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A column's 32-bit word as stored (no float arithmetic touches it).
__device__ __forceinline__ unsigned word_at(const float* p, long long i) {
  return reinterpret_cast<const unsigned*>(p)[i];
}

// The value a sum adds: a float's finite part, an int32's float32 value.
__device__ __forceinline__ double summand(unsigned w, bool is_int) {
  if (is_int) return static_cast<double>(__int2float_rn(static_cast<int>(w)));
  const float x = __uint_as_float(w);
  return isfinite(x) ? static_cast<double>(x) : 0.0;
}

__device__ __forceinline__ int clip_slot(int code, int C) {
  return min(max(code, 0), C - 1);
}

// -- set-up --------------------------------------------------------------

// Sort keys (the slot, or C for an unmasked event) and indices; the
// neighbour tables' defaults; every tree at its identity.
__global__ void __launch_bounds__(kThreads)
init_kernel(const unsigned char* __restrict__ mask,
            const int* __restrict__ codes, unsigned* __restrict__ keys,
            int* __restrict__ idx, int* __restrict__ first,
            int* __restrict__ last, unsigned* __restrict__ trees, int E,
            int C, long long tree_nodes, const Fold f) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = i0; i < E; i += stride) {
    keys[i] = mask[i] ? clip_slot(codes[i], C) : C;
    idx[i] = static_cast<int>(i);
  }
  for (long long i = i0; i < C; i += stride) {
    first[i] = E;
    last[i] = -1;
  }
  const long long total = tree_nodes * f.n_trees;
  for (long long i = i0; i < total; i += stride) {
    trees[i] = f.tree_max[i / tree_nodes] ? 0u : ~0u;
  }
}

// -- the device-wide scan (reduce, scan of block partials, apply) --------

template <class T>
__device__ __forceinline__ void load_blocked(const T* col, long long n,
                                             long long base, T (&x)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long t = base + threadIdx.x * kItems + i;
    x[i] = t < n ? col[t] : T(0);
  }
}

// Per block and column: the sum of the block's tile -> p[j * nb + block].
__global__ void __launch_bounds__(kThreads)
scan_reduce(const int* __restrict__ I, int n_int, const double* __restrict__ D,
            int n_dbl, long long n, int nb, int* __restrict__ pI,
            double* __restrict__ pD) {
  __shared__ union {
    cub::BlockReduce<int, kThreads>::TempStorage i;
    cub::BlockReduce<double, kThreads>::TempStorage d;
  } tmp;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int j = 0; j < n_int; ++j) {
    int x[kItems];
    load_blocked(I + j * n, n, base, x);
    const int tot = cub::BlockReduce<int, kThreads>(tmp.i).Sum(x);
    if (threadIdx.x == 0) pI[static_cast<long long>(j) * nb + blockIdx.x] = tot;
    __syncthreads();
  }
  for (int j = 0; j < n_dbl; ++j) {
    double x[kItems];
    load_blocked(D + j * n, n, base, x);
    const double tot = cub::BlockReduce<double, kThreads>(tmp.d).Sum(x);
    if (threadIdx.x == 0) pD[static_cast<long long>(j) * nb + blockIdx.x] = tot;
    __syncthreads();
  }
}

// One column's block partials -> exclusive prefixes, seeded with the sum of
// its seed partials (the carried table's share).
template <class T>
__device__ void scan_partials(T* p, int nb, const T* seeds, int n_seeds) {
  __shared__ union {
    typename cub::BlockReduce<T, kThreads>::TempStorage r;
    typename cub::BlockScan<T, kThreads>::TempStorage s;
  } tmp;
  __shared__ T carry;
  T s = T(0);
  for (int i = threadIdx.x; i < n_seeds; i += kThreads) s += seeds[i];
  const T seed = cub::BlockReduce<T, kThreads>(tmp.r).Sum(s);
  if (threadIdx.x == 0) carry = seed;
  __syncthreads();
  for (int base = 0; base < nb; base += kTile) {
    T x[kItems];
    load_blocked(p, nb, base, x);
    T agg;
    cub::BlockScan<T, kThreads>(tmp.s).ExclusiveSum(x, x, agg);
    const T c = carry;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int t = base + threadIdx.x * kItems + i;
      if (t < nb) p[t] = c + x[i];
    }
    __syncthreads();
    if (threadIdx.x == 0) carry = c + agg;
    __syncthreads();
  }
}

// One block per column.
__global__ void __launch_bounds__(kThreads)
scan_mid(int* __restrict__ pI, int n_int, double* __restrict__ pD, int n_dbl,
         int nb, const int* __restrict__ sI, const double* __restrict__ sD,
         int n_seeds) {
  const int j = blockIdx.x;
  if (j < n_int) {
    scan_partials<int>(pI + static_cast<long long>(j) * nb, nb,
                       sI + static_cast<long long>(j) * n_seeds, n_seeds);
  } else if (j - n_int < n_dbl) {
    const int k = j - n_int;
    scan_partials<double>(pD + static_cast<long long>(k) * nb, nb,
                          sD + static_cast<long long>(k) * n_seeds, n_seeds);
  }
}

template <class T>
__device__ void scan_tile(T* col, long long n, T prefix, bool inclusive) {
  __shared__ typename cub::BlockScan<T, kThreads>::TempStorage tmp;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  T x[kItems];
  load_blocked(col, n, base, x);
  if (inclusive) {
    cub::BlockScan<T, kThreads>(tmp).InclusiveSum(x, x);
  } else {
    cub::BlockScan<T, kThreads>(tmp).ExclusiveSum(x, x);
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long t = base + threadIdx.x * kItems + i;
    if (t < n) col[t] = prefix + x[i];
  }
  __syncthreads();
}

// Every column's tile scanned in place from its block prefix.
__global__ void __launch_bounds__(kThreads)
scan_apply(int* __restrict__ I, int n_int, double* __restrict__ D, int n_dbl,
           long long n, int nb, const int* __restrict__ pI,
           const double* __restrict__ pD, int inclusive) {
  for (int j = 0; j < n_int; ++j) {
    scan_tile<int>(I + j * n, n, pI[static_cast<long long>(j) * nb + blockIdx.x],
                   inclusive != 0);
  }
  for (int j = 0; j < n_dbl; ++j) {
    scan_tile<double>(D + j * n, n,
                      pD[static_cast<long long>(j) * nb + blockIdx.x],
                      inclusive != 0);
  }
}

// -- 1. the radix sort by slot, and the neighbours ------------------------

// Digit counts of one tile -> hist[digit * nb + block] (digit-major, so an
// exclusive scan of the whole array gives every block's scatter offsets).
__global__ void __launch_bounds__(kThreads)
radix_hist(const unsigned* __restrict__ keys, int E, int shift,
           int* __restrict__ hist, int nb) {
  __shared__ int cnt[kDigits];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long t = base + i * kThreads + threadIdx.x;
    if (t < E) atomicAdd(&cnt[(keys[t] >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[static_cast<long long>(threadIdx.x) * nb + blockIdx.x] = cnt[threadIdx.x];
}

// Stable scatter of one tile: the tile sorted by digit inside the block
// (ties keep their order), each element's rank among its digit in the
// tile added to the block's offset for that digit.
__global__ void __launch_bounds__(kThreads)
radix_scatter(const unsigned* __restrict__ keys_in,
              const int* __restrict__ idx_in, unsigned* __restrict__ keys_out,
              int* __restrict__ idx_out, int E, int shift,
              const int* __restrict__ offsets, int nb) {
  using Sort = cub::BlockRadixSort<unsigned, kThreads, kItems, int>;
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ int cnt[kDigits];
  __shared__ int start[kDigits];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  unsigned d[kItems];
  int at[kItems];  // position in the input, -1 past its end
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long t = base + threadIdx.x * kItems + i;
    if (t < E) {
      d[i] = (keys_in[t] >> shift) & (kDigits - 1);
      at[i] = static_cast<int>(t);
      atomicAdd(&cnt[d[i]], 1);
    } else {
      d[i] = kDigits - 1;  // after every real element of the last digit
      at[i] = -1;
    }
  }
  __syncthreads();
  int first_of_digit;
  Scan(tmp.scan).ExclusiveSum(cnt[threadIdx.x], first_of_digit);
  start[threadIdx.x] = first_of_digit;
  __syncthreads();
  Sort(tmp.sort).Sort(d, at, 0, kDigitBits);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (at[i] >= 0) {
      const int rank = threadIdx.x * kItems + i - start[d[i]];
      const int dest = offsets[static_cast<long long>(d[i]) * nb + blockIdx.x] + rank;
      keys_out[dest] = keys_in[at[i]];
      idx_out[dest] = idx_in[at[i]];
    }
  }
}

// prev / next of every masked event from its sorted neighbours (an
// unmasked event gets prev -1 and the empty interval next = t), and each
// written slot's first and last writer.
__global__ void __launch_bounds__(kThreads)
neighbours(const unsigned* __restrict__ keys, const int* __restrict__ idx,
           int E, int C, int* __restrict__ prev, int* __restrict__ next,
           int* __restrict__ first, int* __restrict__ last) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= E) return;
  const unsigned c = keys[i];
  const int t = idx[i];
  if (c >= static_cast<unsigned>(C)) {
    prev[t] = -1;
    next[t] = t;
    return;
  }
  const int p = (i > 0 && keys[i - 1] == c) ? idx[i - 1] : -1;
  const int q = (i + 1 < E && keys[i + 1] == c) ? idx[i + 1] : E;
  prev[t] = p;
  next[t] = q;
  if (p < 0) first[c] = t;
  if (q == E) last[c] = t;
}

// -- 2. the table out, and the carried table's seeds -----------------------

__device__ __forceinline__ int int_indicator(int kind, float x) {
  return kind == kColNan ? (x != x)
                         : (kind == kColPinf ? (x == INFINITY) : (x == -INFINITY));
}

__global__ void __launch_bounds__(kThreads)
table_kernel(const unsigned char* __restrict__ valid0,
             const float* __restrict__ bufs0, const float* __restrict__ vals,
             const int* __restrict__ first, const int* __restrict__ last,
             unsigned char* __restrict__ valid_out,
             float* __restrict__ bufs_out, int E, int C, int A,
             int* __restrict__ sI, double* __restrict__ sD, int n_seeds,
             const Fold f) {
  __shared__ union {
    cub::BlockReduce<int, kThreads>::TempStorage i;
    cub::BlockReduce<double, kThreads>::TempStorage d;
  } tmp;
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool in = c < C;
  const bool v0 = in && valid0[c];
  if (in) {
    valid_out[c] = (v0 || first[c] < E) ? 1 : 0;
    const int w = last[c];
    for (int a = 0; a < A; ++a) {
      bufs_out[static_cast<long long>(a) * C + c] =
          w >= 0 ? vals[static_cast<long long>(a) * E + w]
                 : bufs0[static_cast<long long>(a) * C + c];
    }
  }
  for (int j = 0; j < f.n_int; ++j) {
    const int code = f.int_code[j];
    int x = 0;
    if (v0) {
      x = (code & 3) == kColCount
              ? 1
              : int_indicator(code & 3,
                              bufs0[static_cast<long long>(f.col_arg[code >> 2]) * C + c]);
    }
    const int tot = cub::BlockReduce<int, kThreads>(tmp.i).Sum(x);
    if (threadIdx.x == 0) sI[static_cast<long long>(j) * n_seeds + blockIdx.x] = tot;
    __syncthreads();
  }
  for (int j = 0; j < f.n_dbl; ++j) {
    const int u = f.dbl_col[j];
    const double x =
        v0 ? summand(word_at(bufs0, static_cast<long long>(f.col_arg[u]) * C + c),
                     f.col_int[u] != 0)
           : 0.0;
    const double tot = cub::BlockReduce<double, kThreads>(tmp.d).Sum(x);
    if (threadIdx.x == 0) sD[static_cast<long long>(j) * n_seeds + blockIdx.x] = tot;
    __syncthreads();
  }
}

// -- 3. per-event deltas of the scanned columns ---------------------------

__global__ void __launch_bounds__(kThreads)
delta_kernel(const unsigned char* __restrict__ mask,
             const int* __restrict__ codes, const float* __restrict__ vals,
             const unsigned char* __restrict__ valid0,
             const float* __restrict__ bufs0, const int* __restrict__ prev,
             int E, int C, int* __restrict__ I, double* __restrict__ D,
             const Fold f) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= E) return;
  const bool m = mask[t];
  const int c = m ? clip_slot(codes[t], C) : 0;
  const int p = m ? prev[t] : -1;
  const bool carried = m && p < 0 && valid0[c];
  const bool has_old = p >= 0 || carried;
  // the value a column held in slot c before event t, and event t's value
  auto old_of = [&](int a) {
    return p >= 0 ? vals[static_cast<long long>(a) * E + p]
                  : (carried ? bufs0[static_cast<long long>(a) * C + c] : 0.0f);
  };
  for (int j = 0; j < f.n_int; ++j) {
    const int code = f.int_code[j];
    int x = 0;
    if (m) {
      if ((code & 3) == kColCount) {
        x = has_old ? 0 : 1;
      } else {
        const int a = f.col_arg[code >> 2];
        x = int_indicator(code & 3, vals[static_cast<long long>(a) * E + t]) -
            (has_old ? int_indicator(code & 3, old_of(a)) : 0);
      }
    }
    I[static_cast<long long>(j) * E + t] = x;
  }
  for (int j = 0; j < f.n_dbl; ++j) {
    double x = 0.0;
    if (m) {
      const int u = f.dbl_col[j];
      const int a = f.col_arg[u];
      const bool is_int = f.col_int[u] != 0;
      x = summand(word_at(vals, static_cast<long long>(a) * E + t), is_int) -
          (has_old ? summand(__float_as_uint(old_of(a)), is_int) : 0.0);
    }
    D[static_cast<long long>(j) * E + t] = x;
  }
}

// -- 4. min / max: interval stabbing over the event axis ------------------

// blockIdx.y: the tree. Threads 0 .. E - 1 carry the events' intervals,
// E .. E + C - 1 the carried slots'.
__global__ void __launch_bounds__(kThreads)
interval_kernel(const float* __restrict__ vals, const float* __restrict__ bufs0,
                const unsigned char* __restrict__ valid0,
                const int* __restrict__ next, const int* __restrict__ first,
                int E, int C, int Ep, unsigned* __restrict__ trees,
                const Fold f) {
  __shared__ unsigned top[kTopNodes];
  const int k = blockIdx.y;
  const int a = f.tree_arg[k];
  const bool is_max = f.tree_max[k] != 0;
  const bool is_int = f.tree_int[k] != 0;
  const unsigned ident = is_max ? 0u : ~0u;
  unsigned* tr = trees + static_cast<long long>(k) * 2 * Ep;
  const int n_top = min(kTopNodes, 2 * Ep);
  for (int i = threadIdx.x; i < n_top; i += kThreads) top[i] = ident;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int lo = 0, hi = 0;
  unsigned w = 0;
  if (i < E) {
    const int q = next[i];
    if (q > i) {
      w = word_at(vals, static_cast<long long>(a) * E + i);
      lo = static_cast<int>(i);
      hi = q;
    }
  } else if (i < static_cast<long long>(E) + C) {
    const long long c = i - E;
    if (valid0[c] && first[c] > 0) {
      w = word_at(bufs0, static_cast<long long>(a) * C + c);
      hi = first[c];
    }
  }
  // an int32's key flips its sign bit; a float's is order_key (no NaN)
  const bool ok = is_int || (w & 0x7fffffffu) <= 0x7f800000u;
  if (hi > lo && ok) {
    const unsigned key = is_int ? (w ^ 0x80000000u) : order_key(__uint_as_float(w));
    unsigned l = static_cast<unsigned>(lo + Ep), r = static_cast<unsigned>(hi + Ep);
    while (l < r) {
      unsigned nodes[2];
      int n = 0;
      if (l & 1) nodes[n++] = l++;
      if (r & 1) nodes[n++] = --r;
      for (int j = 0; j < n; ++j) {
        const unsigned nd = nodes[j];
        if (nd < static_cast<unsigned>(n_top)) {
          if (is_max) atomicMax(&top[nd], key); else atomicMin(&top[nd], key);
        } else {
          if (is_max) atomicMax(&tr[nd], key); else atomicMin(&tr[nd], key);
        }
      }
      l >>= 1;
      r >>= 1;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_top; j += kThreads) {
    const unsigned v = top[j];
    if (v != ident) {
      if (is_max) atomicMax(&tr[j], v); else atomicMin(&tr[j], v);
    }
  }
}

// -- 5. the rows -----------------------------------------------------------

// The min or max over leaf t's ancestors, as the row's 32-bit word: a
// float's bits, or an int32's (identity INT_MIN / INT_MAX).
__device__ __forceinline__ unsigned stab(const unsigned* __restrict__ tr, int Ep,
                                         int t, bool is_max, bool is_int) {
  const unsigned ident = is_max ? 0u : ~0u;
  unsigned acc = ident;
  for (unsigned nd = static_cast<unsigned>(Ep + t); nd >= 1; nd >>= 1) {
    const unsigned v = tr[nd];
    acc = is_max ? max(acc, v) : min(acc, v);
  }
  if (is_int) return acc ^ 0x80000000u;  // the identity maps to INT_MIN / INT_MAX
  if (acc == ident) return __float_as_uint(is_max ? -INFINITY : INFINITY);
  return __float_as_uint(order_val(acc));
}

__global__ void __launch_bounds__(kThreads)
rows_kernel(const int* __restrict__ I, const double* __restrict__ D,
            const unsigned* __restrict__ trees, int E, int Ep,
            float* __restrict__ rows, const Fold f) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= E) return;
  const float qnan = __int_as_float(0x7fc00000);
  const float cnt = static_cast<float>(I[t]);  // int column 0: the count
  for (int s = 0; s < f.n_slots; ++s) {
    const int kind = f.slot_kind[s];
    const int j = f.slot_stat[s];
    float r = cnt;
    if (kind != kCount) {
      const int u = f.stat_col[j];
      // an int32 column has no NaN or inf counts
      const bool nan =
          f.col_nan[u] >= 0 && I[static_cast<long long>(f.col_nan[u]) * E + t] > 0;
      if (kind == kSum || kind == kAvg) {
        const bool pinf =
            f.col_pinf[u] >= 0 && I[static_cast<long long>(f.col_pinf[u]) * E + t] > 0;
        const bool ninf =
            f.col_ninf[u] >= 0 && I[static_cast<long long>(f.col_ninf[u]) * E + t] > 0;
        r = (nan || (pinf && ninf))
                ? qnan
                : (pinf ? INFINITY
                        : (ninf ? -INFINITY
                                : static_cast<float>(
                                      D[static_cast<long long>(f.col_sum[u]) * E + t])));
        if (kind == kAvg) r = r / fmaxf(cnt, 1.0f);
      } else {
        const int k = f.stat_tree[j];
        r = nan ? qnan
                : __uint_as_float(stab(trees + static_cast<long long>(k) * 2 * Ep, Ep,
                                       static_cast<int>(t), kind == kMax,
                                       f.tree_int[k] != 0));
      }
    }
    rows[static_cast<long long>(s) * E + t] = r;
  }
}

// -- host side -------------------------------------------------------------

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// The plan -> Fold; cudaErrorInvalidValue for a malformed plan.
int parse_plan(const int* plan, int plan_len, int A, Fold* f) {
  *f = Fold{};
  if (plan_len < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int S = plan[0], K = plan[1];
  if (S < 1 || S > kMaxSlots || K < 1 || K > kMaxStats || A < 0 || A > kMaxArgs ||
      plan_len != 2 + 2 * S + 2 * K + A) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* arg_int = plan + 2 + 2 * S + 2 * K;  // per value column: 1 = int32
  for (int a = 0; a < A; ++a) {
    if (arg_int[a] != 0 && arg_int[a] != 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  f->n_slots = S;
  for (int s = 0; s < S; ++s) {
    const int kind = plan[2 + s], j = plan[2 + S + s];
    if (kind < kCount || kind > kMax || j < 0 || j >= K) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    f->slot_kind[s] = static_cast<signed char>(kind);
    f->slot_stat[s] = static_cast<unsigned char>(j);
  }
  bool needs_sum[kMaxArgs] = {};
  int col_of_arg[kMaxArgs];
  for (int a = 0; a < kMaxArgs; ++a) col_of_arg[a] = -1;
  for (int j = 0; j < K; ++j) {
    const int op = plan[2 + 2 * S + j], a = plan[2 + 2 * S + K + j];
    if ((j == 0) != (op == kOpCount) || op < kOpCount || op > kOpMax ||
        (op == kOpCount ? a != -1 : (a < 0 || a >= A))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    f->stat_op[j] = static_cast<signed char>(op);
    f->stat_col[j] = -1;
    f->stat_tree[j] = -1;
    if (op == kOpCount) continue;
    if (col_of_arg[a] < 0) {
      col_of_arg[a] = f->n_cols;
      f->col_int[f->n_cols] = static_cast<signed char>(arg_int[a]);
      f->col_arg[f->n_cols++] = static_cast<signed char>(a);
    }
    const int u = col_of_arg[a];
    f->stat_col[j] = static_cast<signed char>(u);
    if (op == kOpSum) {
      needs_sum[u] = true;
    } else {
      f->stat_tree[j] = static_cast<signed char>(f->n_trees);
      f->tree_arg[f->n_trees] = static_cast<signed char>(a);
      f->tree_max[f->n_trees] = op == kOpMax ? 1 : 0;
      f->tree_int[f->n_trees] = static_cast<signed char>(arg_int[a]);
      ++f->n_trees;
    }
  }
  for (int s = 0; s < S; ++s) {  // a slot reads a statistic of its own kind
    const int op = f->stat_op[f->slot_stat[s]], kind = f->slot_kind[s];
    const int want = kind == kCount ? kOpCount
                     : (kind == kMin ? kOpMin : (kind == kMax ? kOpMax : kOpSum));
    if (op != want) return static_cast<int>(cudaErrorInvalidValue);
  }
  f->int_code[f->n_int++] = kColCount;
  for (int u = 0; u < f->n_cols; ++u) {
    const bool is_float = f->col_int[u] == 0;
    f->col_nan[u] = f->col_pinf[u] = f->col_ninf[u] = -1;
    f->col_sum[u] = -1;
    if (is_float) {
      f->col_nan[u] = static_cast<short>(f->n_int);
      f->int_code[f->n_int++] = static_cast<short>(u * 4 + kColNan);
    }
    if (needs_sum[u]) {
      if (is_float) {
        f->col_pinf[u] = static_cast<short>(f->n_int);
        f->int_code[f->n_int++] = static_cast<short>(u * 4 + kColPinf);
        f->col_ninf[u] = static_cast<short>(f->n_int);
        f->int_code[f->n_int++] = static_cast<short>(u * 4 + kColNinf);
      }
      f->col_sum[u] = static_cast<signed char>(f->n_dbl);
      f->dbl_col[f->n_dbl++] = static_cast<signed char>(u);
    }
  }
  return 0;
}

// Where each array of the scratch lies (byte offsets, 256-aligned).
struct Scratch {
  size_t keys[2], idx[2], hist, hist_p, prev, next, first, last, I, D, pI,
      pD, sI, sD, trees, bytes;
  int nb, nb_hist, nb_table, Ep, passes;
};

Scratch carve(int E, int C, const Fold& f) {
  Scratch s{};
  size_t off = 0;
  auto take = [&](size_t n) {
    off = (off + 255) & ~static_cast<size_t>(255);
    const size_t at = off;
    off += n;
    return at;
  };
  s.nb = ceil_div(E, kTile);
  s.nb_hist = ceil_div(static_cast<long long>(kDigits) * s.nb, kTile);
  s.nb_table = ceil_div(C, kThreads);
  s.Ep = 1;
  while (s.Ep < E) s.Ep *= 2;
  int bits = 0;
  while (bits < 31 && (static_cast<long long>(1) << bits) <= C) ++bits;  // holds C
  s.passes = (bits + kDigitBits - 1) / kDigitBits;
  const size_t e4 = static_cast<size_t>(E) * 4;
  for (int i = 0; i < 2; ++i) {
    s.keys[i] = take(e4);
    s.idx[i] = take(e4);
  }
  s.hist = take(static_cast<size_t>(kDigits) * s.nb * 4);
  s.hist_p = take(static_cast<size_t>(s.nb_hist) * 4);
  s.prev = take(e4);
  s.next = take(e4);
  s.first = take(static_cast<size_t>(C) * 4);
  s.last = take(static_cast<size_t>(C) * 4);
  s.I = take(e4 * f.n_int);
  s.D = take(e4 * 2 * f.n_dbl);
  s.pI = take(static_cast<size_t>(s.nb) * 4 * f.n_int);
  s.pD = take(static_cast<size_t>(s.nb) * 8 * f.n_dbl);
  s.sI = take(static_cast<size_t>(s.nb_table) * 4 * f.n_int);
  s.sD = take(static_cast<size_t>(s.nb_table) * 8 * f.n_dbl);
  s.trees = take(static_cast<size_t>(2) * s.Ep * 4 * f.n_trees);
  s.bytes = off;
  return s;
}

bool sizes_ok(long long E, long long C) {
  return E >= 1 && E <= (1 << 29) && C >= 1 && C <= (1 << 30);
}

}  // namespace

// Scratch bytes of one fold (host only, no device work):
// cudaErrorInvalidValue for a malformed plan or size.
extern "C" int fst_unique_fold_scratch(long long E, long long C, int A,
                                       const int* plan_host, int plan_len,
                                       long long* bytes) {
  Fold f;
  const int err = parse_plan(plan_host, plan_len, A, &f);
  if (err != 0) return err;
  if (!sizes_ok(E, C)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(static_cast<int>(E), static_cast<int>(C), f);
  *bytes = static_cast<long long>(s.bytes);
  return 0;
}

// mask: bool [E]; codes: int32 [E]; vals: float32 [A, E]; valid0: bool [C];
// bufs0: float32 [A, C]; outputs valid_out bool [C], bufs_out float32
// [A, C] and rows float32 [S, E]; scratch: scratch_bytes of device memory
// (fst_unique_fold_scratch's count). plan_host (host memory): [n_slots,
// n_stats, slot_kind x n_slots, slot_stat x n_slots, stat_op x n_stats,
// stat_arg x n_stats, is_int x A], statistic 0 the count; an int32 column's
// words in vals and bufs are int32 bit patterns, and its min / max rows too. Launches the pipeline on
// `stream` and counts its kernel launches in *launches; returns a
// cudaError_t (the first failed launch's, or cudaErrorInvalidValue for a
// malformed plan, size or scratch).
extern "C" int fst_unique_fold(const void* mask, const int* codes,
                               const float* vals, const void* valid0,
                               const float* bufs0, void* valid_out,
                               float* bufs_out, float* rows, void* scratch,
                               long long scratch_bytes, int E, int C, int A,
                               const int* plan_host, int plan_len,
                               int* launches, void* stream) {
  *launches = 0;
  Fold f;
  int err = parse_plan(plan_host, plan_len, A, &f);
  if (err != 0) return err;
  if (!sizes_ok(E, C)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(E, C, f);
  if (scratch_bytes < static_cast<long long>(s.bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  char* base = static_cast<char*>(scratch);
  auto at = [&](size_t off) { return static_cast<void*>(base + off); };
  unsigned* keys[2] = {static_cast<unsigned*>(at(s.keys[0])),
                       static_cast<unsigned*>(at(s.keys[1]))};
  int* idx[2] = {static_cast<int*>(at(s.idx[0])), static_cast<int*>(at(s.idx[1]))};
  int* hist = static_cast<int*>(at(s.hist));
  int* hist_p = static_cast<int*>(at(s.hist_p));
  int* prev = static_cast<int*>(at(s.prev));
  int* next = static_cast<int*>(at(s.next));
  int* first = static_cast<int*>(at(s.first));
  int* last = static_cast<int*>(at(s.last));
  int* I = static_cast<int*>(at(s.I));
  double* D = static_cast<double*>(at(s.D));
  int* pI = static_cast<int*>(at(s.pI));
  double* pD = static_cast<double*>(at(s.pD));
  int* sI = static_cast<int*>(at(s.sI));
  double* sD = static_cast<double*>(at(s.sD));
  unsigned* trees = static_cast<unsigned*>(at(s.trees));
  const auto* m8 = static_cast<const unsigned char*>(mask);
  const auto* v8 = static_cast<const unsigned char*>(valid0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // after each group of launches: count them, report a refused launch
  auto launched = [launches](int n) {
    *launches += n;
    return static_cast<int>(cudaGetLastError());
  };

  const long long tree_nodes = 2LL * s.Ep;
  const long long init_n = std::max<long long>(
      std::max<long long>(E, C), tree_nodes * f.n_trees);
  // a grid-stride fill: 16 blocks an SM cover the card
  int dev = 0, sms = 0;
  if ((err = static_cast<int>(cudaGetDevice(&dev))) != 0) return err;
  err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  const int init_blocks = std::min(ceil_div(init_n, kThreads), 16 * sms);
  init_kernel<<<init_blocks, kThreads, 0, st>>>(m8, codes, keys[0], idx[0], first,
                                                last, trees, E, C, tree_nodes, f);
  if ((err = launched(1)) != 0) return err;

  // 1. sort by slot, 8 bits a pass; the digit-major histograms scanned
  // exclusive (one int32 column of kDigits x nb)
  const long long hist_n = static_cast<long long>(kDigits) * s.nb;
  for (int p = 0; p < s.passes; ++p) {
    const int shift = p * kDigitBits;
    const int src = p & 1, dst = src ^ 1;
    radix_hist<<<s.nb, kThreads, 0, st>>>(keys[src], E, shift, hist, s.nb);
    scan_reduce<<<s.nb_hist, kThreads, 0, st>>>(hist, 1, nullptr, 0, hist_n,
                                                s.nb_hist, hist_p, nullptr);
    scan_mid<<<1, kThreads, 0, st>>>(hist_p, 1, nullptr, 0, s.nb_hist, nullptr,
                                     nullptr, 0);
    scan_apply<<<s.nb_hist, kThreads, 0, st>>>(hist, 1, nullptr, 0, hist_n,
                                               s.nb_hist, hist_p, nullptr, 0);
    radix_scatter<<<s.nb, kThreads, 0, st>>>(keys[src], idx[src], keys[dst],
                                             idx[dst], E, shift, hist, s.nb);
    if ((err = launched(5)) != 0) return err;
  }
  const int sorted = s.passes & 1;
  const int nb_e = ceil_div(E, kThreads);
  neighbours<<<nb_e, kThreads, 0, st>>>(keys[sorted], idx[sorted], E, C, prev,
                                        next, first, last);

  // 2. the table out, and the carried table's seeds of every column
  table_kernel<<<s.nb_table, kThreads, 0, st>>>(
      v8, bufs0, vals, first, last, static_cast<unsigned char*>(valid_out),
      bufs_out, E, C, A, sI, sD, s.nb_table, f);

  // 3. the scanned columns: deltas, then one inclusive scan of them all
  delta_kernel<<<nb_e, kThreads, 0, st>>>(m8, codes, vals, v8, bufs0, prev, E,
                                          C, I, D, f);
  scan_reduce<<<s.nb, kThreads, 0, st>>>(I, f.n_int, D, f.n_dbl, E, s.nb, pI, pD);
  scan_mid<<<f.n_int + f.n_dbl, kThreads, 0, st>>>(pI, f.n_int, pD, f.n_dbl,
                                                   s.nb, sI, sD, s.nb_table);
  scan_apply<<<s.nb, kThreads, 0, st>>>(I, f.n_int, D, f.n_dbl, E, s.nb, pI, pD,
                                        1);
  if ((err = launched(6)) != 0) return err;

  // 4. min / max trees
  if (f.n_trees > 0) {
    dim3 grid(ceil_div(static_cast<long long>(E) + C, kThreads), f.n_trees);
    interval_kernel<<<grid, kThreads, 0, st>>>(vals, bufs0, v8, next, first, E,
                                               C, s.Ep, trees, f);
    if ((err = launched(1)) != 0) return err;
  }

  // 5. the rows
  rows_kernel<<<nb_e, kThreads, 0, st>>>(I, D, trees, E, s.Ep, rows, f);
  return launched(1);
}
