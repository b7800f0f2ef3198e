// The slot NFA's walk over one micro-batch, every partial-match slot
// advanced at each event.
//
// Replaces: no Pallas kernel. The reference runs this loop as `lax.scan`
// over the tape (flink_siddhi_tpu/compiler/nfa.py:3107-3537, the body of
// `SlotNFAArtifact.step`), one XLA dispatch a batch. In the port the loop
// is this kernel; its plain version, `cuda_ops.slot_nfa_scan_plain`, is the
// same body in torch, looped over the events in Python, and the
// specification it is held to exactly.
//
// Semantics (per event, in order, as the reference): `within` expiry; per
// slot the cross-element filters (postfix programs, slot_program.py), the
// group masks, greedy absorb before advance, the advance target over
// skippable optional groups (min-count prefix sums), sequence breaks (an
// emission at the previous event's ts when every later group is
// optional), the member that fired (the lowest matching, for 'and' groups
// the lowest still unmatched), first/last/indexed captures with their
// validity bits; emissions in slot order after the n0 rows already
// written, dropped past M = E + S; mid-chain `-> every` forks (the advanced
// instance goes to the lowest free slots in rank order, the prefix slot
// reverts; forks past the free slots count as overflow); arming into the
// lowest free slot under the `every` / grouped `every` / single-match
// rules. int32 arithmetic wraps (unsigned), float32 arithmetic rounds each
// operation (__fadd_rn etc.: no fused multiply-add), as torch's.
//
// Design: one block of S threads (S = the pattern's slot pool, at most
// 1,024), thread s owning slot s. Its scalar state (active, step, count,
// start, last, matched, indexed-capture validity) lives in registers, its
// captures in shared memory ([word][slot], so that a warp's accesses fall
// in distinct banks), the plan (groups, bounds, capture layout, programs)
// in shared memory, copied once a launch. Every thread reads the event's
// words itself (ts, valid, the element masks as bits of one int32, the
// entry-guarded masks likewise): the same address across the block, one
// event ahead. The block-wide parts (the emission ranks, any active slot,
// the lowest free slot, the fork ranks) come from warp ballots written to
// shared memory (double-buffered by event parity) with one __syncthreads a
// event, and two more at an event that forks. An event with no active
// slot and no first-group bit changes nothing but a flag every thread
// knows: it is skipped without a barrier. Programs short-circuit `and` and
// `or`. With relevance
// compaction the event list is `idx[0, *cnt)`: the count is read on the
// device, so the launch needs no host read and a CUDA graph captures it.
//
// What bounds it on an H100: the chain of events, not bytes. Event i + 1
// depends on event i's slot state, so the block walks the events one after
// another on one SM; each event costs a block barrier round plus the
// dependent arithmetic. The bytes (the event's 17 bytes, the emitted rows)
// are tiny beside that. A faster design stages tiles of events in shared
// memory and, for sequences, skips runs of events that no slot can use
// (ROADMAP.md Queue 2, K4).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 1024;
constexpr int kMaxWarps = kMaxSlots / 32;
constexpr int kMaxElems = 32;
constexpr int kMaxPairs = 32;
constexpr int kMaxIdx = 16;
constexpr int kMaxCapRows = 64;
constexpr int kMaxCols = 64;
constexpr int kMaxCode = 1024;
constexpr int kMaxStack = 16;
constexpr int kFixedRows = 7;  // active, step, count, start, last, matched, idxv
constexpr int kStageWords = 6;  // a fork's staged scalar state
// an H100 block's shared memory (232,448 bytes) less this kernel's static
// arrays
constexpr int kMaxShared = 232448 - 1024;

// cuda_ops.SlotScanPlan.words(): header, then fixed-size tables
struct SlotPlan {
  int K, G, S, seq, every, grouped, has_within, within;
  int marked, P, I, n_cols, n_rows, mbits, has_cross, n_code;
  int gmask[kMaxElems];   // per group: its member elements' bits
  int gand[kMaxElems];    // per group: an 'and' group
  int mins[kMaxElems];
  int maxs[kMaxElems];
  int pre[kMaxElems + 1];  // min-count prefix sums
  int cross_off[kMaxElems];  // per element: its program in code, or -1
  int cross_len[kMaxElems];
  int cross_ref[kMaxElems];  // matched bits the filter needs
  int cross_idx[kMaxElems];  // indexed-capture validity bits it needs
  int pair_elem[kMaxPairs];
  int pair_col[kMaxPairs];
  int pair_group[kMaxPairs];
  int pair_single[kMaxPairs];
  int elem_pairs[kMaxElems];  // per element: its capture pairs' bits
  int elem_idx[kMaxElems];    // per element: its indexed captures' bits
  int idx_elem[kMaxIdx];
  int idx_pair[kMaxIdx];
  int idx_k[kMaxIdx];
  int cap_kind[kMaxCapRows];   // 0 first, 1 last, 2 indexed
  int cap_index[kMaxCapRows];  // pair, or indexed capture
  int code[kMaxCode];
};
constexpr int kPlanWords = sizeof(SlotPlan) / 4;

// slot_program.py's opcodes
enum Op {
  kLit = 1, kEvt, kCap, kI2F,
  kAddI, kSubI, kMulI, kNegI,
  kAddF, kSubF, kMulF, kNegF,
  kEqI, kNeI, kLtI, kLeI, kGtI, kGeI,
  kEqF, kNeF, kLtF, kLeF, kGtF, kGeF,
  kAnd, kOr, kNot, kAndJ, kOrJ,
};

__device__ __forceinline__ float f32(int w) { return __int_as_float(w); }
__device__ __forceinline__ int w32(float f) { return __float_as_int(f); }
__device__ __forceinline__ unsigned u32(int w) {
  return static_cast<unsigned>(w);
}

// One program for slot s at event e: 0 or 1. The top of the stack lives
// in a register, the values under it in `st`.
__device__ int run_program(const int* code, int len,
                           const int* __restrict__ cols, long long E, int e,
                           const int* caps, int S, int s) {
  int st[kMaxStack];
  int sp = 0;
  int top = 0;
  for (int pc = 0; pc < len; ++pc) {
    const int w = code[pc];
    const int op = w & 0xff;
    const int arg = w >> 8;
    if (op <= kCap) {  // a load: push
      st[sp++] = top;
      top = op == kLit ? code[++pc]
            : op == kEvt ? __ldg(cols + arg * E + e)
                         : caps[arg * S + s];
    } else if (op == kI2F) {
      top = w32(__int2float_rn(top));
    } else if (op == kNegI) {
      top = static_cast<int>(0u - u32(top));
    } else if (op == kNegF) {
      top = w32(-f32(top));
    } else if (op == kNot) {
      top ^= 1;
    } else if (op == kAndJ || op == kOrJ) {
      // the left operand decides: skip the right one and its and/or
      if (top == (op == kOrJ ? 1 : 0)) pc += arg;
    } else {
      const int a = st[--sp];
      const int b = top;
      switch (op) {
        case kAddI: top = static_cast<int>(u32(a) + u32(b)); break;
        case kSubI: top = static_cast<int>(u32(a) - u32(b)); break;
        case kMulI: top = static_cast<int>(u32(a) * u32(b)); break;
        case kAddF: top = w32(__fadd_rn(f32(a), f32(b))); break;
        case kSubF: top = w32(__fsub_rn(f32(a), f32(b))); break;
        case kMulF: top = w32(__fmul_rn(f32(a), f32(b))); break;
        case kEqI: top = a == b; break;
        case kNeI: top = a != b; break;
        case kLtI: top = a < b; break;
        case kLeI: top = a <= b; break;
        case kGtI: top = a > b; break;
        case kGeI: top = a >= b; break;
        case kEqF: top = f32(a) == f32(b); break;
        case kNeF: top = f32(a) != f32(b); break;
        case kLtF: top = f32(a) < f32(b); break;
        case kLeF: top = f32(a) <= f32(b); break;
        case kGtF: top = f32(a) > f32(b); break;
        case kGeF: top = f32(a) >= f32(b); break;
        case kAnd: top = a & b; break;
        case kOr: top = a | b; break;
        default: top = 0;
      }
    }
  }
  return top;
}

// The slot holding the k-th (0-based) set bit of the warp masks m[0..nw).
__device__ __forceinline__ int nth_slot(const unsigned* m, int nw, int k) {
  for (int w = 0; w < nw; ++w) {
    const int c = __popc(m[w]);
    if (k < c) {
      unsigned x = m[w];
      for (int j = 0; j < k; ++j) x &= x - 1;  // drop the k lowest bits
      return w * 32 + __ffs(x) - 1;
    }
    k -= c;
  }
  return -1;
}

struct Event {
  int e, ts, m, me;
  bool valid;
};

__device__ __forceinline__ Event load_event(
    int e, const int* __restrict__ ts, const unsigned char* __restrict__ valid,
    const int* __restrict__ mword, const int* __restrict__ eword) {
  Event ev;
  ev.e = e;
  ev.ts = __ldg(ts + e);
  ev.valid = __ldg(valid + e) != 0;
  ev.m = __ldg(mword + e);
  ev.me = __ldg(eword + e);
  return ev;
}

__global__ void __launch_bounds__(kMaxSlots)
slot_nfa_kernel(const int* __restrict__ plan_g,
                const int* __restrict__ state_in,
                const int* __restrict__ scal_in, const int* __restrict__ ts,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ mword, const int* __restrict__ eword,
                const int* __restrict__ cols, const int* __restrict__ idx,
                const int* __restrict__ cnt, int E,
                int* __restrict__ state_out, int* __restrict__ scal_out,
                int* __restrict__ buf) {
  extern __shared__ int smem[];
  __shared__ unsigned s_emit[2][kMaxWarps];
  __shared__ unsigned s_free[2][kMaxWarps];
  __shared__ unsigned s_alloc[2][kMaxWarps];
  const SlotPlan& pl = *reinterpret_cast<const SlotPlan*>(smem);
  const int S = blockDim.x;
  const int s = threadIdx.x;
  for (int i = s; i < kPlanWords; i += S) smem[i] = __ldg(plan_g + i);
  __syncthreads();
  // the plan's scalars, read once
  const int K = pl.K, G = pl.G, P = pl.P, I = pl.I;
  const int ncw = 2 * P + I;
  const bool seq = pl.seq, every = pl.every, grouped = pl.grouped;
  const bool has_within = pl.has_within, has_cross = pl.has_cross;
  const bool mbits = pl.mbits;
  const int within = pl.within, marked = pl.marked, n_cols = pl.n_cols;
  const int n_rows = pl.n_rows, gmask0 = pl.gmask[0];
  const int max_last = pl.maxs[G - 1], min_last = pl.mins[G - 1];
  const int pre_end = pl.pre[G];
  int* caps = smem + kPlanWords;  // [ncw][S]
  int* stage = caps + ncw * S;    // [kStageWords][S], forks only
  const long long M = static_cast<long long>(E) + S;
  const long long LE = E;

  bool act = state_in[s] != 0;
  int step = state_in[S + s];
  int cnt_ = state_in[2 * S + s];
  int start = state_in[3 * S + s];
  int last = state_in[4 * S + s];
  int matched = state_in[5 * S + s];
  int idxv = state_in[6 * S + s];
  for (int w = 0; w < ncw; ++w) {
    caps[w * S + s] = state_in[(kFixedRows + w) * S + s];
  }
  bool done = scal_in[0] != 0;
  bool started = scal_in[1] != 0;
  unsigned overflow = u32(scal_in[2]);
  long long n0 = 0;

  const int warp = s >> 5;
  const int lane = s & 31;
  const int nw = (S + 31) >> 5;
  const unsigned lanes =
      (warp == nw - 1 && (S & 31)) ? ((1u << (S & 31)) - 1) : 0xffffffffu;
  const unsigned lt_mask = (1u << lane) - 1;
  const int n_ev = idx != nullptr ? min(max(__ldg(cnt), 0), E) : E;

  // one event ahead: its words; two ahead: its index
  int e1 = 0;
  Event cur = {};
  if (n_ev > 0) {
    cur = load_event(idx != nullptr ? __ldg(idx) : 0, ts, valid, mword,
                     eword);
    e1 = n_ev > 1 ? (idx != nullptr ? __ldg(idx + 1) : 1) : 0;
  }
  // whether any slot is active (known to every thread: the ballots)
  bool any_active = __syncthreads_or(act) != 0;
  int par = 0;  // the ballot buffers' parity, flipped by each event that
                // uses them (a skipped event uses none)
  for (int i = 0; i < n_ev; ++i) {
    const int e2 = i + 2 < n_ev ? (idx != nullptr ? __ldg(idx + i + 2) : i + 2)
                                : 0;
    const Event nxt = i + 1 < n_ev ? load_event(e1, ts, valid, mword, eword)
                                   : cur;
    if (s < n_cols && i + 1 < n_ev) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(cols + s * LE + e1));
    }
    const int e = cur.e;
    const int ts_e = cur.ts;
    const bool v_e = cur.valid;
    if (!any_active && (cur.m & gmask0) == 0) {
      // no slot to advance and nothing to arm: the event changes only
      // `started` (a non-every pattern's, no partial alive) — the same
      // for every thread, so no barrier
      started = started && done;
      cur = nxt;
      e1 = e2;
      continue;
    }

    // -- this slot's transition -------------------------------------------
    bool absorb = false, advance = false, eob = false, killed = false;
    bool alf = false, mtl = false;
    int adv_t = G, fire_e = -1, eff = cur.m;
    int new_step = step, new_cnt = cnt_, new_last = last;
    int new_matched = matched, new_idxv = idxv, new_start = start;
    if (act) {
      int effe = cur.me;
      if (has_cross) {
        int clear = 0;
        for (int k = 0; k < K; ++k) {
          if (pl.cross_off[k] < 0) continue;
          bool ok = run_program(pl.code + pl.cross_off[k], pl.cross_len[k],
                                cols, LE, e, caps, S, s) != 0;
          const int ref = pl.cross_ref[k], iref = pl.cross_idx[k];
          ok = ok && (matched & ref) == ref && (idxv & iref) == iref;
          if (!ok) clear |= 1 << k;
        }
        eff &= ~clear;
        effe &= ~clear;
      }
      if (has_within && v_e) {
        const int span = static_cast<int>(u32(ts_e) - u32(start));
        if (span > within) act = false;
      }
      if (act) {
        const int sc = min(max(step, 0), G - 1);
        const int gm = pl.gmask[sc];
        const bool m_at =
            (pl.gand[sc] ? (eff & ~matched & gm) : (eff & gm)) != 0;
        absorb = v_e && m_at && cnt_ < pl.maxs[sc];
        const bool can_leave = cnt_ >= pl.mins[sc];
        const int from = pl.pre[min(max(step + 1, 0), G)];
        if (v_e && can_leave) {
          // smallest t > step whose entry mask matches, every group in
          // between optional
          for (int t = max(step + 1, 1); t < G && pl.pre[t] == from; ++t) {
            if (effe & pl.gmask[t]) {
              adv_t = t;
              break;
            }
          }
        }
        advance = !absorb && adv_t < G;
        const int cnt_a = cnt_ + (absorb ? 1 : 0);
        alf = step == G - 1 && cnt_a >= max_last && cnt_a >= min_last;
        mtl = advance && adv_t == G - 1 && max_last == 1;
        if (seq && v_e && !absorb && !advance) {
          killed = true;
          eob = can_leave && pre_end == from;
        }
        if (absorb) new_cnt = cnt_ + 1;
        if (advance) {
          new_step = adv_t;
          new_cnt = 1;
        }
        if (absorb || advance) {
          new_last = ts_e;
          const int fg = absorb ? step : adv_t;
          int cand = eff & pl.gmask[fg];
          if (pl.gand[fg]) cand &= ~matched;
          if (cand) {
            fire_e = __ffs(cand) - 1;
            new_matched |= 1 << fire_e;
          }
          if (fire_e >= 0) {
            for (unsigned mk = pl.elem_idx[fire_e]; mk; mk &= mk - 1) {
              const int j = __ffs(mk) - 1;
              if (new_cnt == pl.idx_k[j] + 1) new_idxv |= 1 << j;
            }
          }
        }
      }
    }
    const bool emit = eob || alf || mtl;
    const bool fork = advance && ((marked >> adv_t) & 1);
    bool act2 = act && !((emit && !fork) || killed);
    const bool alloc = fork && !mtl;

    // the new value of capture word w of this slot
    auto cap_new = [&](int w) -> int {
      const int old = caps[w * S + s];
      if (fire_e < 0) return old;
      if (w < 2 * P) {
        const int p = w >> 1;
        if (pl.pair_elem[p] != fire_e) return old;
        if ((w & 1) == 0 && pl.pair_single[p] &&
            !((advance && adv_t == pl.pair_group[p]) || cnt_ == 0)) {
          return old;
        }
        return __ldg(cols + pl.pair_col[p] * LE + e);
      }
      const int j = w - 2 * P;
      if (pl.idx_elem[j] != fire_e || new_cnt != pl.idx_k[j] + 1) return old;
      return __ldg(cols + pl.pair_col[pl.idx_pair[j]] * LE + e);
    };

    const unsigned b_emit = __ballot_sync(lanes, emit);
    const unsigned b_free = __ballot_sync(lanes, !act2);
    const unsigned b_alloc = __ballot_sync(lanes, alloc);
    if (lane == 0) {
      s_emit[par][warp] = b_emit;
      s_free[par][warp] = b_free;
      s_alloc[par][warp] = b_alloc;
    }
    __syncthreads();
    int n_emit = 0, emit_before = 0, n_free = 0, free_before = 0;
    int n_alloc = 0, alloc_before = 0;
    for (int w = 0; w < nw; ++w) {
      const int ce = __popc(s_emit[par][w]);
      const int cf = __popc(s_free[par][w]);
      const int ca = __popc(s_alloc[par][w]);
      if (w < warp) {
        emit_before += ce;
        free_before += cf;
        alloc_before += ca;
      }
      n_emit += ce;
      n_free += cf;
      n_alloc += ca;
    }
    emit_before += __popc(b_emit & lt_mask);
    free_before += __popc(b_free & lt_mask);
    alloc_before += __popc(b_alloc & lt_mask);

    // -- emissions, in slot order -----------------------------------------
    if (emit) {
      const long long pos = n0 + emit_before;
      if (pos < M) {
        buf[pos] = eob ? last : ts_e;
        int r = 1;
        if (mbits) {
          buf[M + pos] = new_matched | (new_idxv << K);
          r = 2;
        }
        for (int c = 0; c < n_rows - r; ++c) {
          const int j = pl.cap_index[c];
          const int w = pl.cap_kind[c] == 2 ? 2 * P + j
                                            : 2 * j + pl.cap_kind[c];
          buf[(r + c) * M + pos] = cap_new(w);
        }
      }
    }
    n0 = min(n0 + n_emit, M);

    // -- captures, and the forks' placement ---------------------------------
    // a slot that fired takes its new captures (a fork's prefix keeps its
    // old ones); then, at an event that forks, each placed fork copies its
    // advanced instance into its free slot, overwriting that slot's
    // captures — after every slot's own update and emission (a barrier
    // between them: the free slot may have just emitted or fired)
    // the fired element's capture words of this slot, written to slot t
    auto take_caps = [&](int t) {
      for (unsigned mk = pl.elem_pairs[fire_e]; mk; mk &= mk - 1) {
        const int p = __ffs(mk) - 1;
        const int v = __ldg(cols + pl.pair_col[p] * LE + e);
        if (!pl.pair_single[p] || (advance && adv_t == pl.pair_group[p]) ||
            cnt_ == 0) {
          caps[2 * p * S + t] = v;
        }
        caps[(2 * p + 1) * S + t] = v;
      }
      for (unsigned mk = pl.elem_idx[fire_e]; mk; mk &= mk - 1) {
        const int j = __ffs(mk) - 1;
        if (new_cnt == pl.idx_k[j] + 1) {
          caps[(2 * P + j) * S + t] =
              __ldg(cols + pl.pair_col[pl.idx_pair[j]] * LE + e);
        }
      }
    };
    if (!fork && fire_e >= 0) take_caps(s);
    int placed = 0;
    if (n_alloc > 0) {
      placed = min(n_alloc, n_free);
      __syncthreads();
      if (alloc && alloc_before < n_free) {
        const int t = nth_slot(s_free[par], nw, alloc_before);
        stage[t] = new_step;
        stage[S + t] = new_cnt;
        stage[2 * S + t] = start;
        stage[3 * S + t] = new_last;
        stage[4 * S + t] = new_matched;
        stage[5 * S + t] = new_idxv;
        for (int w = 0; w < ncw; ++w) caps[w * S + t] = caps[w * S + s];
        if (fire_e >= 0) take_caps(t);
      }
      __syncthreads();
      if (!act2 && free_before < placed) {
        act2 = true;
        new_step = stage[s];
        new_cnt = stage[S + s];
        new_start = stage[2 * S + s];
        new_last = stage[3 * S + s];
        new_matched = stage[4 * S + s];
        new_idxv = stage[5 * S + s];
      }
    }
    if (fork) {  // the prefix slot reverts and stays armed
      new_step = step;
      new_cnt = cnt_;
      new_last = last;
      new_matched = matched;
    }

    // -- arming into the lowest free slot ----------------------------------
    const bool any_act2 = S - n_free + placed > 0;
    const bool started_now = started && (any_act2 || done);
    const int m0 = cur.m & gmask0;
    bool want, any_done;
    if (every) {
      any_done = done;
      want = m0 != 0 && v_e;
      if (grouped) want = want && !any_act2 && n_emit == 0;
    } else {
      any_done = done || n_emit > 0;
      want = m0 != 0 && v_e && !started_now && !any_done;
    }
    const bool has_free = placed < n_free;
    if (want && has_free && s == nth_slot(s_free[par], nw, placed)) {
      const int arm_e = __ffs(m0) - 1;
      act2 = true;
      new_step = 0;
      new_cnt = 1;
      new_start = ts_e;
      new_last = ts_e;
      new_matched = 1 << arm_e;
      new_idxv = 0;
      for (int p = 0; p < P; ++p) {
        if (pl.pair_elem[p] == arm_e) {
          const int v = __ldg(cols + pl.pair_col[p] * LE + e);
          caps[2 * p * S + s] = v;
          caps[(2 * p + 1) * S + s] = v;
        }
      }
    }
    overflow += (want && !has_free ? 1u : 0u) + u32(n_alloc - placed);
    any_active = any_act2 || (want && has_free);
    par ^= 1;
    started = started_now || want;
    done = any_done;
    act = act2;
    step = new_step;
    cnt_ = new_cnt;
    start = new_start;
    last = new_last;
    matched = new_matched;
    idxv = new_idxv;
    cur = nxt;
    e1 = e2;
  }

  state_out[s] = act ? 1 : 0;
  state_out[S + s] = step;
  state_out[2 * S + s] = cnt_;
  state_out[3 * S + s] = start;
  state_out[4 * S + s] = last;
  state_out[5 * S + s] = matched;
  state_out[6 * S + s] = idxv;
  for (int w = 0; w < ncw; ++w) {
    state_out[(kFixedRows + w) * S + s] = caps[w * S + s];
  }
  if (s == 0) {
    scal_out[0] = done ? 1 : 0;
    scal_out[1] = started ? 1 : 0;
    scal_out[2] = static_cast<int>(overflow);
    scal_out[3] = static_cast<int>(n0);
  }
}

}  // namespace

// One micro-batch of the slot NFA. plan_host / plan_dev: the same
// SlotPlan words (plan_len of them) in host and device memory; the host
// copy is validated and sizes the launch, the kernel reads the device copy.
// state: int32 [W, S] (W = 7 + 2P + I), scal: int32 [3] (done, started,
// overflow); ts, mword, eword: int32 [E]; valid: bool [E]; cols: int32
// [n_cols, E]; idx: int32 [E] and cnt: int32 [1] on the device (the scan
// visits idx[0, *cnt)), or both null (every event). Outputs: state_out
// [W, S], scal_out [4] (done, started, overflow, n), buf int32 [R, E + S]
// (R = 1 + mbits + capture rows), which the caller zeroes. One launch on
// `stream`; returns a cudaError_t.
extern "C" int fst_slot_nfa_scan(const int* plan_host, int plan_len,
                                 const int* plan_dev, const int* state,
                                 const int* scal, const int* ts,
                                 const void* valid, const int* mword,
                                 const int* eword, const int* cols,
                                 const int* idx, const int* cnt, int E, int S,
                                 int* state_out, int* scal_out, int* buf,
                                 int W, int R, void* stream) {
  static size_t shared_set = 48 * 1024;  // the default dynamic limit
  if (plan_len != kPlanWords || E < 0 || S < 1 || S > kMaxSlots ||
      (idx == nullptr) != (cnt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SlotPlan& pl = *reinterpret_cast<const SlotPlan*>(plan_host);
  if (pl.S != S || pl.K < 1 || pl.K > 31 || pl.G < 1 || pl.G > pl.K ||
      pl.P < 0 || pl.P > kMaxPairs || pl.I < 0 || pl.I > kMaxIdx ||
      pl.K + pl.I > 31 || pl.n_cols < 0 || pl.n_cols > kMaxCols ||
      pl.n_code < 0 || pl.n_code > kMaxCode ||
      W != kFixedRows + 2 * pl.P + pl.I ||
      R != pl.n_rows || R < 1 + pl.mbits || R - 1 - pl.mbits > kMaxCapRows ||
      (pl.n_cols > 0 && cols == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < pl.K; ++k) {
    if (pl.cross_off[k] >= 0 &&
        (pl.cross_len[k] < 1 || pl.cross_off[k] + pl.cross_len[k] > pl.n_code)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const size_t shared =
      sizeof(SlotPlan) +
      sizeof(int) * static_cast<size_t>(S) *
          (2 * pl.P + pl.I + (pl.marked ? kStageWords : 0));
  if (shared > static_cast<size_t>(kMaxShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shared > shared_set) {  // raised once, at the first such launch
    const cudaError_t err = cudaFuncSetAttribute(
        slot_nfa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    shared_set = shared;
  }
  slot_nfa_kernel<<<1, S, shared, static_cast<cudaStream_t>(stream)>>>(
      plan_dev, state, scal, ts, static_cast<const unsigned char*>(valid),
      mword, eword, cols, idx, cnt, E, state_out, scal_out, buf);
  return static_cast<int>(cudaGetLastError());
}
