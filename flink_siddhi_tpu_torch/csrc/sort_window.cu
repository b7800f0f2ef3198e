// K9: `#window.sort(n, key[, 'asc'|'desc'])` with aggregates over one
// micro-batch: each event's insertion into its partition's top-n buffer,
// and its aggregate row over the buffer.
//
// Replaces no Pallas kernel: the reference runs this loop as a `lax.scan`,
// flink_siddhi_tpu/compiler/scan_windows.py `ScanWindowArtifact.step`,
// `body_sort` (:246-271, the scan :305). In torch ops that scan would be a
// Python loop an event, which no CUDA graph can hold. It replaces the
// port's first K9 (one warp walking a partition's whole chain, every
// event counted, shifted and reduced: 1.58 us an event on one buffer).
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
// wrote, so taken event by event a partition is a serial chain of warp
// rounds (10 ms for one buffer over 524,288 events), while its bytes
// (E x (8 + 4A) read, S x E x 4 written) take a few microseconds. The
// design shortens the chain:
//
// 1. The skip. A full buffer with no NaN key changes only for an event
//    whose key is not above every slot's key (an equal key inserts and
//    evicts; a NaN key inserts at 0). That threshold only falls, so one
//    ballot of 32 staged events against it finds the next inserting
//    event exactly; every event before it gets the row kept from the last
//    insertion, written one lane an event. Exact for any buffer.
// 2. Registers (C <= 32): lane i holds slot i's valid flag and key (its
//    value words in a shared-memory column only lane i touches), `pos` is
//    one ballot, the shift one `__shfl_up_sync` a column, and the slot
//    plan is read once a block.
// 3. Chunks with an exact carry (C <= 32). Without NaN keys, a buffer
//    after any prefix of a partition's events is the C least of (carried
//    buffer + the prefix) under (key ascending, arrival descending): a
//    later equal key goes first, and among carried slots a lower slot is
//    a later arrival. That merge is associative, so the grouped `order`
//    is cut into chunks of L positions (a chunk holds pieces of one or
//    more partitions) and three launches walk them in parallel:
//    (a) `sort_chunk_summary_kernel`, a warp a chunk: the C least of the
//        chunk's last piece when its partition goes on past the chunk (a
//        walk from an empty buffer); a flag per partition whose events
//        hold a NaN key or whose carried buffer is not a sorted prefix of
//        valid slots without NaN;
//    (b) `sort_chunk_carry_kernel`, one warp: each chunk's carry-in, the
//        carried buffer merged with the summaries of the chunks before
//        (ranked by a count of the other list's smaller keys, scattered
//        through shared memory; a carried buffer's invalid slots ride
//        along behind, as the shifts move them);
//    (c) `sort_window_kernel<true>`, a warp a chunk: each piece walked
//        from its carry-in (or its partition's carried buffer) with 1-2,
//        its rows written, the last piece of a partition writing the new
//        buffer. A flagged partition is walked whole, from its carried
//        buffer, by the warp of the chunk holding its first event: the
//        device picks that branch, no host reads a flag.
//    The grid is ceil(E / L) blocks, sized from E alone: the masked
//    count is device data (the call stays capturable in a CUDA graph).
// C > 32 keeps one warp a partition (`sort_window_kernel<false>`), the
// buffer in shared memory (in device memory when it does not fit) as rows
// of 32-bit words (valid, key, then each value column; lane i takes slots
// i, i + 32, ...), with the skip and the plan read once.
#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// a chunk's record (int32 words): the summary's valid, key bits and tag,
// the carry-in's valid, key bits and tag (32 words each), then the
// chunk's first and last partition and whether each reaches past it.
// A tag is an event index t >= 0, or -1 - s for the carried buffer's slot s.
enum {
  kSumValid = 0, kSumKey = 32, kSumTag = 64,
  kCarryValid = 96, kCarryKey = 128, kCarryTag = 160,
  kHead = 192, kTail = 193, kHeadOn = 194, kTailOn = 195, kChunkWords = 196
};

struct SortArgs {
  const long long* order;   // [E] event indices grouped by partition
  const long long* starts;  // [P + 1] each partition's range of `order`
  const int* part;          // [E] each event's partition
  const float* keys;        // [E] float32 sort keys (negated for 'desc')
  const unsigned* vals;     // [A, E] value words (int32 columns by bits)
  const int* plan;          // warp_rows' slot plan: kind[S], arg[S], arg_int[A]
  const unsigned* buf_in;   // [P, 2 + A, C] carried words: valid, key bits, values
  unsigned* buf;            // [P, 2 + A, C] out, a copy of buf_in on entry
  float* rows;              // [S, E] out
  int* chunks;              // [ceil(E / L), kChunkWords] (chunked path)
  int* flags;               // [P] zero on entry (chunked path)
  int E, P, C, A, S;
  int L;                    // positions a chunk; 0: the C > 32 path
  int in_shared;            // C > 32: the buffer is staged in shared memory
};

// -- C <= 32: one slot a lane ------------------------------------------------

// A warp's buffer: lane i < C holds slot i (lanes from C on stay invalid).
struct Slots {
  bool v;
  float k;
  int tag;        // chunk summaries and carries only
  unsigned* col;  // [A][32] shared words: slot lane's values, lane's own column
};

// Shared words of a block of pass (c): the plan, the row kept from the
// last insertion and the value columns.
__host__ __device__ inline long long regs_smem_words(int A, int S) {
  return warp_rows::plan_words(S, A) + S + 32LL * A;
}

// Walk positions [q, qe) of `order` from the buffer in `b` (steps 1-2).
// kRows: keep the value columns and write each event's row; else keep the
// tags. Returns whether an event's key was NaN.
template <bool kRows>
__device__ bool walk(const SortArgs& p, long long q, long long qe, Slots& b, const int* splan,
                     unsigned* rowc) {
  const int lane = threadIdx.x;
  const int C = p.C, A = p.A, S = p.S;
  const long long E = p.E;
  bool skip_ok = false;
  float thr = 0.0f;
  auto derive = [&]() {  // full, no NaN key: then the threshold holds
    const int cnt = __popc(__ballot_sync(kFull, b.v));
    const bool nan = __any_sync(kFull, b.v && b.k != b.k);
    thr = warp_rows::group_max(b.v ? b.k : -INFINITY, 32);
    skip_ok = cnt == C && !nan;
  };
  auto keep_row = [&]() {  // the buffer's row into rowc
    __syncwarp();
    warp_rows::row_lanes(b.v, b.col, splan, S, C, [&](int s, unsigned w) {
      if (lane == 0) rowc[s] = w;
    });
    __syncwarp();
  };
  derive();
  bool row_ok = false, saw_nan = false;
  for (long long base = q; base < qe; base += 32) {
    const int n = static_cast<int>(min(32LL, qe - base));
    long long t = 0;
    float key = 0.0f;
    if (lane < n) {
      t = p.order[base + lane];
      key = p.keys[t];
    }
    saw_nan |= __any_sync(kFull, lane < n && key != key);
    unsigned done = n == 32 ? 0u : (kFull << n);
    while (done != kFull) {
      const bool mine = !((done >> lane) & 1u);
      const unsigned ins = __ballot_sync(kFull, mine && !(skip_ok && key > thr));
      // the events before the next insertion change nothing
      const unsigned keep = (ins ? (1u << (__ffs(ins) - 1)) - 1u : kFull) & ~done;
      if constexpr (kRows) {
        if (keep) {
          if (!row_ok) {
            keep_row();
            row_ok = true;
          }
          if ((keep >> lane) & 1u) {
            for (int s = 0; s < S; ++s) reinterpret_cast<unsigned*>(p.rows)[s * E + t] = rowc[s];
          }
        }
      }
      done |= keep;
      if (!ins) break;
      const int f = __ffs(ins) - 1;
      const float kf = __shfl_sync(kFull, key, f);
      const long long tf = __shfl_sync(kFull, t, f);
      const int pos = __popc(__ballot_sync(kFull, b.v && b.k < kf));
      const float kn = __shfl_up_sync(kFull, b.k, 1);
      const bool vn = __shfl_up_sync(kFull, static_cast<int>(b.v), 1) != 0;
      const int tn = __shfl_up_sync(kFull, b.tag, 1);
      const bool at = pos < C && lane == pos, below = pos < C && lane > pos && lane < C;
      if (at) {
        b.k = kf;
        b.v = true;
        b.tag = static_cast<int>(tf);
      } else if (below) {
        b.k = kn;
        b.v = vn;
        b.tag = tn;
      }
      if constexpr (kRows) {
        for (int a = 0; a < A; ++a) {
          const unsigned w = __shfl_up_sync(kFull, b.col[a * 32 + lane], 1);
          if (at) b.col[a * 32 + lane] = p.vals[a * E + tf];
          else if (below) b.col[a * 32 + lane] = w;
        }
      }
      derive();
      if constexpr (kRows) {
        keep_row();
        row_ok = true;
        if (lane == f) {
          for (int s = 0; s < S; ++s) reinterpret_cast<unsigned*>(p.rows)[s * E + t] = rowc[s];
        }
      }
      done |= 1u << f;
    }
  }
  return saw_nan;
}

// Partition pi's carried buffer into `b` (tags: its slots).
template <bool kVals>
__device__ void load_carried(const SortArgs& p, int pi, Slots& b) {
  const int lane = threadIdx.x, C = p.C;
  const unsigned* src = p.buf_in + static_cast<long long>(pi) * (2 + p.A) * C;
  b.v = lane < C && src[lane] != 0u;
  b.k = lane < C ? __uint_as_float(src[C + lane]) : 0.0f;
  b.tag = -1 - lane;
  if constexpr (kVals) {
    for (int a = 0; a < p.A; ++a) b.col[a * 32 + lane] = lane < C ? src[(2 + a) * C + lane] : 0u;
  }
}

// Whether a carried buffer can start a chunked walk: its valid slots a
// prefix, their keys ascending, none NaN.
__device__ bool chunkable(const Slots& b, int C) {
  const int lane = threadIdx.x;
  const unsigned vb = __ballot_sync(kFull, b.v);
  const int cnt = __popc(vb);
  const float prev = __shfl_up_sync(kFull, b.k, 1);
  const bool bad = __any_sync(kFull, b.v && (b.k != b.k || (lane > 0 && !(prev <= b.k))));
  return !bad && vb == (cnt == 32 ? kFull : (1u << cnt) - 1u) && cnt <= C;
}

// (a) a warp a chunk: the summary of its last piece, the NaN flags
__global__ void __launch_bounds__(32) sort_chunk_summary_kernel(const SortArgs p) {
  const int lane = threadIdx.x;
  const long long m = p.starts[p.P];
  const long long b0 = static_cast<long long>(blockIdx.x) * p.L;
  if (b0 >= m) return;
  const long long e0 = min(b0 + p.L, m);
  int* rec = p.chunks + static_cast<long long>(blockIdx.x) * kChunkWords;
  int head = -1, tail = -1;
  bool tail_on = false;
  Slots b{false, 0.0f, 0, nullptr};
  for (long long q = b0; q < e0;) {
    const int pi = p.part[p.order[q]];
    const long long ps = p.starts[pi], pa = p.starts[pi + 1];
    const long long pe = min(pa, e0);
    bool bad = false;
    if (ps >= b0) {  // the partition starts here: check its carried buffer
      load_carried<false>(p, pi, b);
      bad = !chunkable(b, p.C);
    }
    tail_on = pe == e0 && pa > e0;
    b.v = false;
    b.tag = 0;
    if (tail_on) {
      bad |= walk<false>(p, q, pe, b, nullptr, nullptr);
      rec[kSumValid + lane] = b.v;
      rec[kSumKey + lane] = __float_as_int(b.k);
      rec[kSumTag + lane] = b.tag;
    } else {
      for (long long base = q; base < pe; base += 32) {
        const long long i = base + lane;
        bad |= __any_sync(kFull, i < pe && p.keys[p.order[i]] != p.keys[p.order[i]]);
      }
    }
    if (bad && lane == 0) p.flags[pi] = 1;
    if (head < 0) head = pi;
    tail = pi;
    q = pe;
  }
  if (lane == 0) {
    rec[kHead] = head;
    rec[kTail] = tail;
    rec[kHeadOn] = p.starts[head] < b0;
    rec[kTailOn] = tail_on;
  }
}

// R (older) merged with a chunk's summary (newer): the C least under (key
// ascending, arrival descending), R's invalid slots behind.
__device__ void merge(Slots& r, const int* rec, int C, unsigned* scratch) {
  const int lane = threadIdx.x;
  const bool sv = rec[kSumValid + lane] != 0;
  const float sk = __int_as_float(rec[kSumKey + lane]);
  const int st = rec[kSumTag + lane];
  const int ns = __popc(__ballot_sync(kFull, sv));
  const int nr = __popc(__ballot_sync(kFull, r.v));
  int cr = 0, cs = 0;
  for (int o = 0; o < 32; ++o) {
    const float ok_s = __shfl_sync(kFull, sk, o);
    const float ok_r = __shfl_sync(kFull, r.k, o);
    cr += (o < ns && ok_s <= r.k) ? 1 : 0;  // a newer equal key goes first
    cs += (o < nr && ok_r < sk) ? 1 : 0;
  }
  const int rank_r = lane + (r.v ? cr : ns);
  const int rank_s = lane + cs;
  if (lane < C && rank_r < C) {
    scratch[rank_r] = r.v;
    scratch[32 + rank_r] = __float_as_uint(r.k);
    scratch[64 + rank_r] = static_cast<unsigned>(r.tag);
  }
  if (lane < ns && rank_s < C) {
    scratch[rank_s] = 1u;
    scratch[32 + rank_s] = __float_as_uint(sk);
    scratch[64 + rank_s] = static_cast<unsigned>(st);
  }
  __syncwarp();
  if (lane < C) {
    r.v = scratch[lane] != 0u;
    r.k = __uint_as_float(scratch[32 + lane]);
    r.tag = static_cast<int>(scratch[64 + lane]);
  }
  __syncwarp();
}

// (b) one warp: each chunk's carry-in, in chunk order
__global__ void __launch_bounds__(32) sort_chunk_carry_kernel(const SortArgs p) {
  __shared__ unsigned scratch[96];
  const int lane = threadIdx.x;
  const long long m = p.starts[p.P];
  const long long G = (m + p.L - 1) / p.L;
  Slots r{false, 0.0f, 0, nullptr};
  for (long long g0 = 0; g0 < G; g0 += 32) {
    int head = 0, tail = 0, head_on = 0, tail_on = 0, head_fl = 1, tail_fl = 1;
    if (g0 + lane < G) {
      const int* info = p.chunks + (g0 + lane) * kChunkWords;
      head = info[kHead];
      tail = info[kTail];
      head_on = info[kHeadOn];
      tail_on = info[kTailOn];
      head_fl = p.flags[head];
      tail_fl = p.flags[tail];
    }
    const int n = static_cast<int>(min(32LL, G - g0));
    for (int j = 0; j < n; ++j) {
      int* rec = p.chunks + (g0 + j) * kChunkWords;
      const int hd = __shfl_sync(kFull, head, j), tl = __shfl_sync(kFull, tail, j);
      const int ho = __shfl_sync(kFull, head_on, j), hf = __shfl_sync(kFull, head_fl, j);
      const int to = __shfl_sync(kFull, tail_on, j), tf = __shfl_sync(kFull, tail_fl, j);
      const bool hon = ho && !hf, ton = to && !tf;
      if (hon) {  // r holds the head partition after the chunk before
        rec[kCarryValid + lane] = r.v;
        rec[kCarryKey + lane] = __float_as_int(r.k);
        rec[kCarryTag + lane] = r.tag;
      }
      if (ton) {
        if (!(hon && hd == tl)) load_carried<false>(p, tl, r);
        merge(r, rec, p.C, scratch);
      }
    }
  }
}

// (c) a warp a chunk: each piece's rows from its carry-in
__device__ void chunk_rows(const SortArgs& p) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x;
  const long long m = p.starts[p.P];
  const long long b0 = static_cast<long long>(blockIdx.x) * p.L;
  if (b0 >= m) return;
  const long long e0 = min(b0 + p.L, m);
  const int* rec = p.chunks + static_cast<long long>(blockIdx.x) * kChunkWords;
  int* splan = reinterpret_cast<int*>(smem);
  unsigned* rowc = smem + warp_rows::plan_words(p.S, p.A);
  Slots b{false, 0.0f, 0, rowc + p.S};
  warp_rows::load_plan(p.plan, p.S, p.A, splan);
  const int C = p.C, A = p.A;
  auto store = [&](int pi) {  // the partition's new buffer
    unsigned* dst = p.buf + static_cast<long long>(pi) * (2 + A) * C;
    if (lane < C) {
      dst[lane] = b.v;
      dst[C + lane] = __float_as_uint(b.k);
      for (int a = 0; a < A; ++a) dst[(2 + a) * C + lane] = b.col[a * 32 + lane];
    }
  };
  for (long long q = b0; q < e0;) {
    const int pi = p.part[p.order[q]];
    const long long ps = p.starts[pi], pa = p.starts[pi + 1];
    const long long pe = min(pa, e0);
    if (p.flags[pi]) {  // walked whole, in series, from its first chunk
      if (ps >= b0) {
        load_carried<true>(p, pi, b);
        walk<true>(p, ps, pa, b, splan, rowc);
        store(pi);
      }
      q = pe;
      continue;
    }
    if (ps >= b0) {
      load_carried<true>(p, pi, b);
    } else {
      const unsigned* src = p.buf_in + static_cast<long long>(pi) * (2 + A) * C;
      b.v = rec[kCarryValid + lane] != 0;
      b.k = __int_as_float(rec[kCarryKey + lane]);
      const int tag = rec[kCarryTag + lane];
      for (int a = 0; a < A; ++a) {
        b.col[a * 32 + lane] = lane >= C ? 0u
                               : tag >= 0 ? p.vals[a * static_cast<long long>(p.E) + tag]
                                          : src[(2 + a) * C + (-1 - tag)];
      }
    }
    walk<true>(p, q, pe, b, splan, rowc);
    if (pe == pa) store(pi);
    q = pe;
  }
}

// -- C > 32: one warp a partition --------------------------------------------

__host__ __device__ inline long long wide_smem_words(int C, int A, int S, int in_shared) {
  return warp_rows::plan_words(S, A) + S + 32LL * (2 + A) + (in_shared ? (2LL + A) * C : 0);
}

__device__ void wide_rows(const SortArgs& p) {
  extern __shared__ unsigned smem[];
  const int part = blockIdx.x;
  const int lane = threadIdx.x;
  const long long lo = p.starts[part], hi = p.starts[part + 1];
  if (lo >= hi) return;
  const int C = p.C, A = p.A, S = p.S, W = 2 + A;
  const long long E = p.E;
  int* splan = reinterpret_cast<int*>(smem);
  unsigned* rowc = smem + warp_rows::plan_words(S, A);
  unsigned* st = rowc + S;  // staging: [W][32] words (row 0 unused, key, values)
  unsigned* gbuf = p.buf + static_cast<long long>(part) * W * C;
  unsigned* buf = p.in_shared ? st + 32 * W : gbuf;
  warp_rows::load_plan(p.plan, S, A, splan);
  if (p.in_shared) {
    for (int i = lane; i < W * C; i += 32) buf[i] = gbuf[i];
    __syncwarp();
  }
  auto member = [&](int i) { return buf[i] != 0u; };
  auto word = [&](int a, int i) { return buf[(2 + a) * C + i]; };
  bool skip_ok = false;
  float thr = 0.0f;
  auto derive = [&]() {
    int cnt = 0;
    bool nan = false;
    float mx = -INFINITY;
    for (int i = lane; i < C; i += 32) {
      if (!member(i)) continue;
      const float k = __uint_as_float(buf[C + i]);
      ++cnt;
      nan |= k != k;
      mx = fmaxf(mx, k);
    }
    cnt = __reduce_add_sync(kFull, cnt);
    nan = __any_sync(kFull, nan);
    thr = warp_rows::group_max(mx, 32);
    skip_ok = cnt == C && !nan;
  };
  auto keep_row = [&]() {
    __syncwarp();
    warp_rows::row(C, member, word, splan, S, [&](int s, unsigned w) {
      if (lane == 0) rowc[s] = w;
    });
    __syncwarp();
  };
  derive();
  bool row_ok = false;
  for (long long base = lo; base < hi; base += 32) {
    const int n = static_cast<int>(min(32LL, hi - base));
    long long t = 0;
    float key = 0.0f;
    if (lane < n) {
      t = p.order[base + lane];
      key = p.keys[t];
      st[32 + lane] = __float_as_uint(key);
      for (int a = 0; a < A; ++a) st[(2 + a) * 32 + lane] = p.vals[a * E + t];
    }
    __syncwarp();
    unsigned done = n == 32 ? 0u : (kFull << n);
    while (done != kFull) {
      const bool mine = !((done >> lane) & 1u);
      const unsigned ins = __ballot_sync(kFull, mine && !(skip_ok && key > thr));
      const unsigned keep = (ins ? (1u << (__ffs(ins) - 1)) - 1u : kFull) & ~done;
      if (keep) {
        if (!row_ok) {
          keep_row();
          row_ok = true;
        }
        if ((keep >> lane) & 1u) {
          for (int s = 0; s < S; ++s) reinterpret_cast<unsigned*>(p.rows)[s * E + t] = rowc[s];
        }
      }
      done |= keep;
      if (!ins) break;
      const int j = __ffs(ins) - 1;
      const float kj = __uint_as_float(st[32 + j]);
      int lt = 0;
      for (int i = lane; i < C; i += 32) lt += (member(i) && __uint_as_float(buf[C + i]) < kj) ? 1 : 0;
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
      derive();
      keep_row();
      row_ok = true;
      if (lane == j) {
        for (int s = 0; s < S; ++s) reinterpret_cast<unsigned*>(p.rows)[s * E + t] = rowc[s];
      }
      done |= 1u << j;
    }
    __syncwarp();
  }
  if (p.in_shared) {
    for (int i = lane; i < W * C; i += 32) gbuf[i] = buf[i];
  }
}

// The kernel each call launches once: (c) of the chunked path, or the
// C > 32 walk.
template <bool kChunked>
__global__ void __launch_bounds__(32) sort_window_kernel(const SortArgs p) {
  if constexpr (kChunked) {
    chunk_rows(p);
  } else {
    wide_rows(p);
  }
}

template <class K>
cudaError_t raise_smem(K kernel, long long bytes, long long* set) {
  if (bytes <= *set) return cudaSuccess;  // raised once for each larger size (before a capture)
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *set = bytes;
  return err;
}

}  // namespace

// Shared-memory bytes a block takes: chunked (C <= 32, one slot a lane),
// or the C > 32 walk with the buffer in shared memory (in_shared = 1) or
// not.
extern "C" long long fst_sort_window_smem(int C, int A, int S, int chunked, int in_shared) {
  return 4 * (chunked ? regs_smem_words(A, S) : wide_smem_words(C, A, S, in_shared));
}

// Words of one chunk's record in the wrapper's `chunks` scratch.
extern "C" long long fst_sort_window_chunk_words() { return kChunkWords; }

// Launch on `stream`: with L > 0 (C <= 32) passes (a)-(c) over ceil(E / L)
// chunks, else one warp a partition. The wrapper has laid the carried
// state out in `buf_in`, copied it to `buf`, zeroed `rows` and `flags`.
// Returns a cudaError_t.
extern "C" int fst_sort_window(const void* args, void* stream) {
  const SortArgs p = *static_cast<const SortArgs*>(args);
  if (p.P < 1 || p.C < 1 || p.E < 1 || p.A < 0 || p.S < 1 || p.L < 0 ||
      (p.L > 0 && p.C > 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.L > 0) {
    static long long set_c = 48 * 1024;
    const long long smem = fst_sort_window_smem(p.C, p.A, p.S, 1, 0);
    if ((err = raise_smem(sort_window_kernel<true>, smem, &set_c)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    const int G = static_cast<int>((static_cast<long long>(p.E) + p.L - 1) / p.L);
    sort_chunk_summary_kernel<<<G, 32, 0, s>>>(p);
    sort_chunk_carry_kernel<<<1, 32, 0, s>>>(p);
    sort_window_kernel<true><<<G, 32, smem, s>>>(p);
  } else {
    static long long set_w = 48 * 1024;
    const long long smem = fst_sort_window_smem(p.C, p.A, p.S, 0, p.in_shared);
    if ((err = raise_smem(sort_window_kernel<false>, smem, &set_w)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    sort_window_kernel<false><<<p.P, 32, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
