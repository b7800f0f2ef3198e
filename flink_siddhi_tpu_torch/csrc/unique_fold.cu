// In-order fold of one micro-batch into a `#window.unique` slot table, with
// the per-event aggregate rows.
//
// Replaces: flink_siddhi_tpu/compiler/pallas_ops.py, the Pallas kernel built
// by `_build_fold` and called through `unique_window_fold` (the slot table
// kept in VMEM across a blocked walk of the event axis; its caller is
// scan_windows.py `ScanWindowArtifact._fused_unique`).
//
// For each event t in order: if mask[t], slot clip(code[t], 0, C - 1)
// becomes valid and takes the event's A values; then every aggregate slot s
// is computed over the valid slots of the table:
//   count, sum of where(valid, v, 0), avg = sum / max(count, 1),
//   min with identity +inf, max with identity -inf      -> rows[s, t].
// Outputs: rows float32 [S, E], the new valid [C] and the new bufs [A, C].
//
// What bounds it on an H100: the function must read E x (1 + 4 + 4A) bytes
// of events and both tables and write S x E x 4 bytes of rows — a few
// microseconds at 3.35 TB/s for a 524,288-event batch. This first kernel is
// far from that: it walks the events one after another on one SM, and each
// event costs a chain of dependent shared-memory steps. It is the simple
// exact design; a scan formulation that spreads the event axis over the
// card is the later redesign.
//
// Design: one warp owns the table and walks the events in order. The table
// (C one-byte valid flags and A x C floats) sits in dynamic shared memory
// when it fits (227 KB a block; C = 16,384 slots with A = 2 take 144 KiB);
// otherwise it stays in global memory (the output arrays, read through
// L1/L2) and the same code runs on it. Each statistic the aggregates need —
// the count, and the sum/min/max of a value column — has a segment tree
// over the table: a leaf per tile of 32 slots, internal nodes up to the
// root, which is the statistic over the whole table. An event that writes a
// slot makes lane j, which owns statistic j, recompute its leaf for that
// slot's tile from the 32 slots and then the log2(C / 32) nodes above it
// (each level's sibling loaded one level ahead); the roots give the event's
// row. Each lane keeps its statistics' op and column in registers. Every node is recomputed from its children, never kept as a
// running sum, so a sum's error stays that of
// one reduction over C values; left and right children are combined in that
// order, so the result does not depend on which one changed. The combine is
// branch-free, so lanes owning a sum, a min and a max do not diverge. An
// event that writes nothing leaves the row as it was. Events are staged 32
// at a time (one coalesced load a lane), and the rows of those 32 events go
// out row by row, coalesced. The aggregate plan — each slot's kind and
// statistic, each statistic's op and column — travels by value as a kernel
// argument: no device copy and no host sync per call. Any E is taken (the
// Pallas kernel needed a multiple of 1024), any C >= 1 and any A <= 64.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;
constexpr int kTile = 32;  // slots under one tree leaf
constexpr int kMaxSlots = 64;
constexpr int kMaxStats = 65;  // the count and up to 64 (op, column) pairs
constexpr int kMaxArgs = 64;
constexpr int kLaneStats = (kMaxStats + kLanes - 1) / kLanes;  // per lane
constexpr unsigned kFull = 0xffffffffu;

// slot kinds (the wrapper's codes)
enum { kCount = 0, kSum = 1, kAvg = 2, kMin = 3, kMax = 4 };
// statistic ops; statistic 0 is always the count
enum { kOpCount = 0, kOpSum = 1, kOpMin = 2, kOpMax = 3 };

struct FoldPlan {
  int n_slots;
  int n_stats;
  int slot_kind[kMaxSlots];
  int slot_stat[kMaxSlots];  // the statistic slot s reads
  int stat_op[kMaxStats];
  int stat_arg[kMaxStats];  // value column of the statistic (-1: count)
};

__device__ __forceinline__ float ident(int op) {
  return op == kOpMin ? INFINITY : (op == kOpMax ? -INFINITY : 0.0f);
}

// Branch-free: count/sum add, min/max select. min / max propagate NaN as
// jnp.min / jnp.max and torch.amin / amax do.
__device__ __forceinline__ float combine(int op, float a, float b) {
  const float s = a + b;
  const float lo = (b < a || b != b) ? b : a;
  const float hi = (b > a || b != b) ? b : a;
  return op == kOpMin ? lo : (op == kOpMax ? hi : s);
}

// A statistic over slots [lo, lo + 32) of the table, in slot order.
__device__ __forceinline__ float tile_leaf(int op, const float* col,
                                           const unsigned char* tvalid,
                                           int lo, int hi) {
  const float id = ident(op);
  float acc = id;
#pragma unroll 8
  for (int c = lo; c < hi; ++c) {
    const float x = col != nullptr ? col[c] : 1.0f;
    acc = combine(op, acc, tvalid[c] ? x : id);
  }
  return acc;
}

// Set leaf w of a statistic's tree and recompute every node above it. Each
// level's sibling is loaded one level ahead, before the store of the level
// below (no node on the path is a sibling of another).
__device__ __forceinline__ void update_path(int op, float* tr, int T, int w,
                                            float leaf) {
  int nd = T + w;
  tr[nd] = leaf;
  float cur = leaf;
  float sib = nd > 1 ? tr[nd ^ 1] : 0.0f;
  while (nd > 1) {
    const int up = nd >> 1;
    const float next_sib = up > 1 ? tr[up ^ 1] : 0.0f;
    cur = (nd & 1) ? combine(op, sib, cur) : combine(op, cur, sib);
    tr[up] = cur;
    nd = up;
    sib = next_sib;
  }
}

// Every slot's value from the roots -> slotval[s].
__device__ __forceinline__ void slot_values(const FoldPlan& plan,
                                            const float* tree, int T,
                                            float* slotval) {
  const float cnt = tree[1];  // statistic 0's root
  for (int s = threadIdx.x; s < plan.n_slots; s += kLanes) {
    const float v = tree[static_cast<size_t>(plan.slot_stat[s]) * 2 * T + 1];
    slotval[s] = plan.slot_kind[s] == kAvg ? v / fmaxf(cnt, 1.0f) : v;
  }
}

__global__ void __launch_bounds__(kLanes)
unique_fold_kernel(const unsigned char* __restrict__ mask,
                   const int* __restrict__ codes,
                   const float* __restrict__ vals,
                   const unsigned char* __restrict__ valid0,
                   const float* __restrict__ bufs0,
                   unsigned char* __restrict__ valid_out,
                   float* __restrict__ bufs_out, float* __restrict__ rows,
                   float* __restrict__ tree_scratch, int E, int C, int A,
                   int T, int placement, const FoldPlan plan) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int S = plan.n_slots;
  const int K = plan.n_stats;
  float* slotval = smem;                      // [S]
  float* out_stage = slotval + S;             // [S][32] rows of 32 events
  float* val_stage = out_stage + S * kLanes;  // [A][32] values of 32 events
  float* next = val_stage + A * kLanes;
  float* tree;  // [K][2T] heaps: node 1 the root, leaves T .. 2T - 1
  if (placement >= 1) {
    tree = next;
    next += static_cast<size_t>(K) * 2 * T;
  } else {
    tree = tree_scratch;
  }
  float* tbufs;  // [A][C]
  unsigned char* tvalid;  // [C]
  if (placement == 2) {
    tbufs = next;
    tvalid = reinterpret_cast<unsigned char*>(tbufs + static_cast<size_t>(A) * C);
  } else {
    tbufs = bufs_out;
    tvalid = valid_out;
  }
  const size_t AC = static_cast<size_t>(A) * C;
  for (int c = lane; c < C; c += kLanes) tvalid[c] = valid0[c] ? 1 : 0;
  for (size_t i = lane; i < AC; i += kLanes) tbufs[i] = bufs0[i];
  __syncwarp();

  // lane j owns statistics j, j + 32, ...: their op, column and tree
  int my_op[kLaneStats];
  const float* my_col[kLaneStats];
  float* my_tree[kLaneStats];
#pragma unroll
  for (int k = 0; k < kLaneStats; ++k) {
    const int j = lane + kLanes * k;
    my_op[k] = j < K ? plan.stat_op[j] : kOpSum;
    const int a = j < K ? plan.stat_arg[j] : -1;
    my_col[k] = a >= 0 ? tbufs + static_cast<size_t>(a) * C : nullptr;
    my_tree[k] = tree + static_cast<size_t>(j < K ? j : 0) * 2 * T;
  }

  // build every tree: leaves from their tiles, then the nodes above
  const int n_leaves = (C + kTile - 1) / kTile;
#pragma unroll
  for (int k = 0; k < kLaneStats; ++k) {
    if (lane + kLanes * k < K) {
      float* tr = my_tree[k];
      for (int w = 0; w < T; ++w) {
        tr[T + w] = w < n_leaves
                        ? tile_leaf(my_op[k], my_col[k], tvalid, w * kTile,
                                    min(C, (w + 1) * kTile))
                        : ident(my_op[k]);
      }
      for (int node = T - 1; node >= 1; --node) {
        tr[node] = combine(my_op[k], tr[2 * node], tr[2 * node + 1]);
      }
    }
  }
  __syncwarp();
  slot_values(plan, tree, T, slotval);

  for (int base = 0; base < E; base += kLanes) {
    const int n = min(kLanes, E - base);
    const int t = base + lane;
    const int m = lane < n ? mask[t] : 0;
    const int code = lane < n ? codes[t] : 0;
    for (int a = 0; a < A; ++a) {
      val_stage[a * kLanes + lane] =
          lane < n ? vals[static_cast<size_t>(a) * E + t] : 0.0f;
    }
    __syncwarp();
    for (int i = 0; i < n; ++i) {
      const int mi = __shfl_sync(kFull, m, i);
      const int ci = __shfl_sync(kFull, code, i);
      if (mi) {
        const int slot = min(max(ci, 0), C - 1);
        for (int a = lane; a < A; a += kLanes) {
          tbufs[static_cast<size_t>(a) * C + slot] = val_stage[a * kLanes + i];
        }
        if (lane == 0) tvalid[slot] = 1;
        __syncwarp();
        const int w = slot / kTile;
        const int lo = w * kTile;
        const int hi = min(C, lo + kTile);
#pragma unroll
        for (int k = 0; k < kLaneStats; ++k) {
          if (lane + kLanes * k < K) {
            update_path(my_op[k], my_tree[k], T, w,
                        tile_leaf(my_op[k], my_col[k], tvalid, lo, hi));
          }
        }
        __syncwarp();
        slot_values(plan, tree, T, slotval);
      }
      // slotval[s] was written by this same lane: no barrier needed
      for (int s = lane; s < S; s += kLanes) out_stage[s * kLanes + i] = slotval[s];
    }
    __syncwarp();
    for (int s = 0; s < S; ++s) {
      if (lane < n) rows[static_cast<size_t>(s) * E + t] = out_stage[s * kLanes + lane];
    }
    __syncwarp();
  }

  if (placement == 2) {
    for (int c = lane; c < C; c += kLanes) valid_out[c] = tvalid[c];
    for (size_t i = lane; i < AC; i += kLanes) bufs_out[i] = tbufs[i];
  }
}

}  // namespace

// mask: bool [E]; codes: int32 [E]; vals: float32 [A, E]; valid0: bool [C];
// bufs0: float32 [A, C]; outputs valid_out bool [C], bufs_out float32 [A, C]
// and rows float32 [S, E]; tree_scratch: float32 [n_stats * 2T], T the
// power of two >= ceil(C / 32) (used when the trees do not fit shared
// memory). plan_host (host memory): [n_slots, n_stats, slot_kind x n_slots,
// slot_stat x n_slots, stat_op x n_stats, stat_arg x n_stats], statistic 0
// the count. Launches one block of one warp on `stream`; returns a
// cudaError_t (the launch's, or cudaErrorInvalidValue for a malformed plan).
// *placement reports what shared memory holds: 2 the trees and the table,
// 1 the trees only, 0 neither.
extern "C" int fst_unique_fold(const void* mask, const int* codes,
                               const float* vals, const void* valid0,
                               const float* bufs0, void* valid_out,
                               float* bufs_out, float* rows,
                               float* tree_scratch, long long scratch_floats,
                               int E, int C, int A, const int* plan_host,
                               int plan_len, int* placement, void* stream) {
  if (plan_len < 2 || E < 0 || C < 1 || A < 0 || A > kMaxArgs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FoldPlan plan = {};
  plan.n_slots = plan_host[0];
  plan.n_stats = plan_host[1];
  const int S = plan.n_slots, K = plan.n_stats;
  if (S < 1 || S > kMaxSlots || K < 1 || K > kMaxStats ||
      plan_len != 2 + 2 * S + 2 * K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < S; ++s) {
    plan.slot_kind[s] = plan_host[2 + s];
    plan.slot_stat[s] = plan_host[2 + S + s];
    if (plan.slot_kind[s] < kCount || plan.slot_kind[s] > kMax ||
        plan.slot_stat[s] < 0 || plan.slot_stat[s] >= K) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int j = 0; j < K; ++j) {
    plan.stat_op[j] = plan_host[2 + 2 * S + j];
    plan.stat_arg[j] = plan_host[2 + 2 * S + K + j];
    const bool is_count = plan.stat_op[j] == kOpCount;
    if (plan.stat_op[j] < kOpCount || plan.stat_op[j] > kOpMax ||
        (is_count ? plan.stat_arg[j] != -1
                  : (plan.stat_arg[j] < 0 || plan.stat_arg[j] >= A))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (plan.stat_op[0] != kOpCount) return static_cast<int>(cudaErrorInvalidValue);
  int T = 1;
  while (T < (C + kTile - 1) / kTile) T *= 2;
  const long long tree_floats = static_cast<long long>(K) * 2 * T;
  if (scratch_floats < tree_floats) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t small =
      sizeof(float) * (static_cast<size_t>(S) + static_cast<size_t>(S) * kLanes +
                       static_cast<size_t>(A) * kLanes);
  const size_t tree = sizeof(float) * static_cast<size_t>(tree_floats);
  const size_t table = sizeof(float) * static_cast<size_t>(A) * C + C;
  const size_t cap = static_cast<size_t>(optin);
  const int place = small + tree + table <= cap ? 2 : (small + tree <= cap ? 1 : 0);
  const size_t bytes = small + (place >= 1 ? tree : 0) + (place == 2 ? table : 0);
  *placement = place;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(unique_fold_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unique_fold_kernel<<<1, kLanes, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), codes, vals,
      static_cast<const unsigned char*>(valid0), bufs0,
      static_cast<unsigned char*>(valid_out), bufs_out, rows, tree_scratch, E,
      C, A, T, place, plan);
  return static_cast<int>(cudaGetLastError());
}
