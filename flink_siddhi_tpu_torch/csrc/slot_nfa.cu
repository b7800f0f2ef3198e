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
// rules. The cross filters run in the interpreter shared with K5
// (program.cuh): int32 arithmetic wraps, float32 rounds each operation and
// flushes subnormals as the reference's CPU does; `/` and `%` follow
// jnp.floor_divide, jnp.divide and jnp.mod.
//
// What bounds it on an H100: the chain of events, not bytes. Event i + 1
// depends on event i's slot state, so the pool walks the events one after
// another on one SM; each event costs the dependent arithmetic of a slot's
// transition plus the pool-wide ranks (emission order, lowest free slot,
// fork targets). The bytes (an event's 17 bytes and its columns, the
// emitted rows) are tiny beside that.
//
// Design, against that bound:
// - One warp per pool at S <= 64 (R = ceil(S / 32) slots a lane, slot
//   r * 32 + lane, so that slot order is register-major, lane-minor). The
//   pool-wide ranks are popcounts of R `__ballot_sync` words held in every
//   lane's registers: no shared-memory round trip and no block barrier. A
//   fork's scalar state moves between lanes by `__shfl_sync`; the capture
//   words ([word][slot] in shared memory) are ordered by `__syncwarp`.
//   Larger pools take as many warps as they need (R = 2 up to 2,048
//   slots, more a thread above), with the ballot words in shared memory
//   and one block barrier an event (three at a fork). One templated kernel
//   over (multi-warp, R): the barrier code compiles out at one warp.
// - Event tiles: each warp loads 32 events' words (the index entry two
//   tiles ahead, then ts, valid, the masks one tile ahead) with one
//   coalesced load a lane and hands each event to every lane with
//   `__shfl_sync`. The columns of a tile's events (captures and programs
//   read them) are staged in shared memory one tile ahead with `cp.async`,
//   so a firing slot reads shared memory, not a dependent global gather.
// - With no active slot, one ballot over the tile finds the next event
//   with a first-group bit: idle runs are skipped 32 events at a time.
// - Each slot keeps its current group's tables (members, bounds, the
//   groups an advance can reach, the next group's members) in registers
//   while its step stays; a capture pair is one packed descriptor.
// - Programs run from a device buffer of their own length through the
//   read-only cache, with a per-thread stack in shared memory as deep as
//   the plan's deepest program; they short-circuit `and` and `or`, and
//   run only for the elements a slot can take at the event. A cross
//   filter's event-only conjuncts never reach the kernel: they are the
//   element's mask (compiler/nfa.py).
// What is left of the bound: per slot, the transition, the captures and
// the arming are chains of divergent branches and dependent shared-memory
// reads, with one warp and nothing to hide them (PERF.md §6).
// With relevance compaction the event list is `idx[0, *cnt)`: the count is
// read on the device, so the launch needs no host read and a CUDA graph
// captures it.
#include <cuda_runtime.h>

#include "program.cuh"

namespace {

using namespace fst_program;

constexpr int kMaxElems = 32;
constexpr int kMaxPairs = 32;
constexpr int kMaxIdx = 32;
constexpr int kFixedRows = 7;  // active, step, count, start, last, matched, idxv
constexpr int kStageWords = 6;  // a fork's staged scalar state (multi-warp)
constexpr int kTile = 32;       // events a tile
constexpr int kHeader = 20;
// an H100 block's shared memory (232,448 bytes); the kernel has no static
// shared arrays
constexpr int kMaxShared = 232448;

// cuda_ops.SlotScanPlan.words(): header, then fixed-size tables. The
// capture rows' words and the programs follow in a buffer of their own
// (`aux`).
struct SlotPlan {
  int K, G, S, seq, every, grouped, has_within, within;
  int marked, P, I, n_cols, n_rows, mbits, cross_mask, n_aux;
  int depth, n_cap_rows, pad0, pad1;
  int gmask[kMaxElems];   // per group: its member elements' bits
  int gand[kMaxElems];    // per group: an 'and' group
  int mins[kMaxElems];
  int maxs[kMaxElems];
  int pre[kMaxElems + 1];  // min-count prefix sums
  // per group: the members of every group an advance from it can reach
  // (the next group and the optional ones after it)
  int reach[kMaxElems];
  int cross_off[kMaxElems];  // per element: its program in aux
  int cross_len[kMaxElems];
  int cross_ref[kMaxElems];  // matched bits the filter needs
  int cross_idx[kMaxElems];  // indexed-capture validity bits it needs
  int pair_elem[kMaxPairs];
  // per pair: its column | single-member group << 20 | its group << 21
  int pair_desc[kMaxPairs];
  int elem_pairs[kMaxElems];  // per element: its capture pairs' bits
  int elem_idx[kMaxElems];    // per element: its indexed captures' bits
  int idx_elem[kMaxIdx];
  int idx_k[kMaxIdx];
  int idx_col[kMaxIdx];  // per indexed capture: its column
};
constexpr int kPlanWords = sizeof(SlotPlan) / 4;
static_assert(kPlanWords == kHeader + 17 * 32 + 1, "SlotPlan layout");
constexpr int kColMask = (1 << 20) - 1;
constexpr int kRowRegs = 8;  // emission capture rows whose words stay in
                             // registers

// The position of the k-th (0-based) set bit of x (k < popc(x)).
__device__ __forceinline__ int nth_bit(unsigned x, int k) {
  for (int j = 0; j < k; ++j) x &= x - 1;  // drop the k lowest bits
  return __ffs(x) - 1;
}

// The slot holding the k-th (0-based) set bit of the slot-ordered words
// m[0..n) in shared memory; -1 past the last.
__device__ __forceinline__ int nth_slot(const unsigned* m, int n, int k) {
  for (int q = 0; q < n; ++q) {
    const int c = __popc(m[q]);
    if (k < c) return q * 32 + nth_bit(m[q], k);
    k -= c;
  }
  return -1;
}

// The same over R words in registers (one warp's pool).
template <int R>
__device__ __forceinline__ int nth_slot_reg(const unsigned (&m)[R], int k) {
  int out = -1;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int c = __popc(m[q]);
    if (out < 0) {
      if (k < c) {
        out = q * 32 + nth_bit(m[q], k);
      } else {
        k -= c;
      }
    }
  }
  return out;
}

struct SlotState {
  int act, step, cnt, start, last, matched, idxv;
};

// A slot's current group's tables, kept in registers while its step
// stays: its members, 'and' (as a mask: -1 or 0), count bounds, min-count
// prefix, the members an advance can reach, and the next group's members
// and 'and'
struct StepInfo {
  int gm, andm, min, max, from, reach, ngm, nandm;
};

// One slot's move at one event, before the pool-wide ranks.
struct Move {
  int absorb, advance, eob, killed, mtl, emit, fork, alloc, act2;
  int adv_t, fire_e, step, cnt, start, last, matched, idxv;
};

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <bool kMulti>
__device__ __forceinline__ void pool_sync() {
  if (kMulti) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kValidBit = static_cast<int>(0x80000000u);

template <bool kMulti, int R>
__global__ void __launch_bounds__(kMulti ? 1024 : 32)
slot_nfa_kernel(const int* __restrict__ plan_g, const int* __restrict__ aux,
                const int* __restrict__ state_in,
                const int* __restrict__ scal_in, const int* __restrict__ ts,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ mword, const int* __restrict__ eword,
                const int* __restrict__ cols, const int* __restrict__ idx,
                const int* __restrict__ cnt, int E,
                int* __restrict__ state_out, int* __restrict__ scal_out,
                int* __restrict__ buf) {
  extern __shared__ int smem[];
  const SlotPlan& pl = *reinterpret_cast<const SlotPlan*>(smem);
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NQ = (T >> 5) * R;  // ballot words, slot order
  for (int i = tid; i < kPlanWords; i += T) smem[i] = __ldg(plan_g + i);
  __syncthreads();
  // the plan's scalars, read once
  const int S = pl.S;
  const int K = pl.K, G = pl.G, P = pl.P, I = pl.I;
  const int ncw = 2 * P + I;
  const bool seq = pl.seq, every = pl.every, grouped = pl.grouped;
  const bool has_within = pl.has_within;
  const bool mbits = pl.mbits;
  const int within = pl.within, marked = pl.marked, n_cols = pl.n_cols;
  const int gmask0 = pl.gmask[0];
  const int cross_mask = pl.cross_mask;
  const int max_last = pl.maxs[G - 1], min_last = pl.mins[G - 1];
  const int pre_end = pl.pre[G];
  int* cap_word = smem + kPlanWords;    // per emission capture row: its word
  int* caps = cap_word + pl.n_cap_rows;  // [ncw][S]
  int* stack = caps + ncw * S;          // [depth][T]
  int* colt = stack + pl.depth * T;     // [2][n_cols][kTile]
  int* stage = colt + 2 * n_cols * kTile;  // [kStageWords][S]: multi, forks
  unsigned* bal = reinterpret_cast<unsigned*>(
      stage + (kMulti && marked ? kStageWords * S : 0));  // [2][3][NQ]
  int* my_stack = stack + tid;
  const int* prog = aux;  // the programs (their offsets count from aux)
  const long long M = static_cast<long long>(E) + S;
  const long long LE = E;
  const unsigned lt_mask = (1u << lane) - 1;

  for (int i = tid; i < pl.n_cap_rows; i += T) cap_word[i] = __ldg(aux + i);
  // the first kRowRegs capture rows' words, in registers
  const int n_cap_rows = pl.n_cap_rows;
  int cwr[kRowRegs];
#pragma unroll
  for (int i = 0; i < kRowRegs; ++i) {
    cwr[i] = i < n_cap_rows ? __ldg(aux + i) : 0;
  }
  auto step_info = [&](int step) -> StepInfo {
    const int sc = min(max(step, 0), G - 1);
    const int nx = min(max(step + 1, 1), G - 1);
    const bool has_next = max(step + 1, 1) < G;
    return StepInfo{pl.gmask[sc], pl.gand[sc] ? -1 : 0, pl.mins[sc],
                    pl.maxs[sc], pl.pre[min(max(step + 1, 0), G)],
                    pl.reach[sc], has_next ? pl.gmask[nx] : 0,
                    has_next && pl.gand[nx] ? -1 : 0};
  };
  // the fired element's capture words of a slot that moved by `o` (its
  // count before the event: old_cnt), written to slot t
  auto take_caps = [&](const Move& o, int old_cnt, const int* ev, int t) {
    const int fe = o.fire_e;
    for (unsigned mk = pl.elem_pairs[fe]; mk; mk &= mk - 1) {
      const int p = __ffs(mk) - 1;
      const int d = pl.pair_desc[p];
      const int v = ev[(d & kColMask) * kTile];
      if (!((d >> 20) & 1) || (o.advance && o.adv_t == (d >> 21)) ||
          old_cnt == 0) {
        caps[2 * p * S + t] = v;
      }
      caps[(2 * p + 1) * S + t] = v;
    }
    if (I) {
      for (unsigned mk = pl.elem_idx[fe]; mk; mk &= mk - 1) {
        const int jj = __ffs(mk) - 1;
        if (o.cnt == pl.idx_k[jj] + 1) {
          caps[(2 * P + jj) * S + t] = ev[pl.idx_col[jj] * kTile];
        }
      }
    }
  };
  // capture word w of slot s as it would be after take_caps (for a fork
  // that emits: its prefix keeps the old words)
  auto cap_new = [&](const Move& o, int old_cnt, const int* ev, int s,
                     int w) -> int {
    const int old = caps[w * S + s];
    const int fe = o.fire_e;
    if (fe < 0) return old;
    if (w < 2 * P) {
      const int p = w >> 1;
      if (pl.pair_elem[p] != fe) return old;
      const int d = pl.pair_desc[p];
      if ((w & 1) == 0 && ((d >> 20) & 1) &&
          !((o.advance && o.adv_t == (d >> 21)) || old_cnt == 0)) {
        return old;
      }
      return ev[(d & kColMask) * kTile];
    }
    const int jj = w - 2 * P;
    if (pl.idx_elem[jj] != fe || o.cnt != pl.idx_k[jj] + 1) return old;
    return ev[pl.idx_col[jj] * kTile];
  };

  SlotState sl[R];
  StepInfo si[R];
  bool exists[R];
  unsigned vmask[R];  // the existing slots of each of this warp's words
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = (warp * R + r) * 32 + lane;
    exists[r] = s < S;
    vmask[r] = __ballot_sync(kFull, exists[r]);
    if (exists[r]) {
      sl[r].act = state_in[s] != 0;
      sl[r].step = state_in[S + s];
      sl[r].cnt = state_in[2 * S + s];
      sl[r].start = state_in[3 * S + s];
      sl[r].last = state_in[4 * S + s];
      sl[r].matched = state_in[5 * S + s];
      sl[r].idxv = state_in[6 * S + s];
      for (int w = 0; w < ncw; ++w) {
        caps[w * S + s] = state_in[(kFixedRows + w) * S + s];
      }
    } else {
      sl[r] = SlotState{0, 0, 0, 0, 0, 0, 0};
    }
    si[r] = step_info(sl[r].step);
  }
  int par = 0;  // the ballot words' buffer (multi-warp), flipped by each
                // event that uses it
  bool done = scal_in[0] != 0;
  bool started = scal_in[1] != 0;
  unsigned overflow = u32(scal_in[2]);
  long long n0 = 0;
  const int n_ev = idx != nullptr ? min(max(__ldg(cnt), 0), E) : E;

  // whether any slot is active (every thread knows it)
  bool any_active;
  {
    bool mine = false;
#pragma unroll
    for (int r = 0; r < R; ++r) mine = mine || sl[r].act;
    any_active = kMulti ? __syncthreads_or(mine) != 0
                        : __any_sync(kFull, mine);
  }

  auto ev_index = [&](int i) -> int {
    return i < n_ev ? (idx != nullptr ? __ldg(idx + i) : i) : 0;
  };
  // a tile's columns into colt[b]: lane j's event's, this warp's columns
  auto stage_cols = [&](int b, int base, int e) {
    if (base + lane < n_ev) {
      for (int c = kMulti ? warp : 0; c < n_cols; c += T >> 5) {
        cp_async4(colt + (b * n_cols + c) * kTile + lane, cols + c * LE + e);
      }
    }
    cp_async_commit();
  };

  // this lane's event of the current tile and of the next; the index
  // entry two tiles ahead
  int te = ev_index(lane);
  int te1 = ev_index(kTile + lane);
  int tts = 0, tmv = 0, tme = 0;
  if (lane < n_ev) {
    tts = __ldg(ts + te);
    tmv = __ldg(mword + te) | (__ldg(valid + te) ? kValidBit : 0);
    tme = __ldg(eword + te);
  }
  stage_cols(0, 0, te);

  for (int base = 0; base < n_ev; base += kTile) {
    const int cb = (base / kTile) & 1;
    const int nb = base + kTile;
    // the next tile's words, used at the next tile
    const int ne = te1;
    te1 = ev_index(nb + kTile + lane);
    int nts = 0, nmv = 0, nme = 0;
    if (nb + lane < n_ev) {
      nts = __ldg(ts + ne);
      nmv = __ldg(mword + ne) | (__ldg(valid + ne) ? kValidBit : 0);
      nme = __ldg(eword + ne);
    }
    // the next tile's columns, into the buffer the previous tile read
    pool_sync<kMulti>();
    stage_cols(cb ^ 1, nb, ne);
    cp_async_wait1();  // this tile's columns have landed
    pool_sync<kMulti>();
    const int* ct = colt + cb * n_cols * kTile;
    const int nin = min(kTile, n_ev - base);

    for (int j = 0; j < nin; ++j) {
      if (!any_active) {
        // no slot to advance: the next event with a first-group bit; the
        // events before it change only `started` (a non-every pattern's,
        // no partial alive), the same for every thread
        const unsigned arm =
            __ballot_sync(kFull, (tmv & gmask0) != 0 && lane >= j &&
                                     lane < nin);
        if (arm == 0) {
          started = started && done;
          break;
        }
        const int jn = __ffs(arm) - 1;
        if (jn > j) started = started && done;
        j = jn;
      }
      const int ts_e = __shfl_sync(kFull, tts, j);
      const int mv = __shfl_sync(kFull, tmv, j);
      const int me = __shfl_sync(kFull, tme, j);
      const bool v_e = mv < 0;
      const int m = mv & 0x7fffffff;
      const int* ev = ct + j;  // column c of the event: ev[c * kTile]

      // -- each slot's transition ---------------------------------------
      Move mv_[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = (warp * R + r) * 32 + lane;
        const SlotState& x = sl[r];
        const StepInfo& c = si[r];
        Move& o = mv_[r];
        o.absorb = o.advance = o.eob = o.killed = o.mtl = 0;
        o.adv_t = G;
        o.fire_e = -1;
        o.step = x.step;
        o.cnt = x.cnt;
        o.start = x.start;
        o.last = x.last;
        o.matched = x.matched;
        o.idxv = x.idxv;
        bool act = x.act;
        if (act && has_within && v_e) {
          const int span = static_cast<int>(u32(ts_e) - u32(x.start));
          if (span > within) act = false;
        }
        int alf = 0;
        // (a register whose lanes are all idle skips the whole move: a
        // warp-uniform branch, no divergence)
        if (__any_sync(kFull, act) && act) {
          int eff = m, effe = me;
          // the cross filters of the elements this slot can take at this
          // event (absorb at its group, advance into a reachable one):
          // another element's filter cannot change the slot's move
          unsigned need = u32(m & (c.gm | c.reach) & cross_mask);
          if (need) {
            int clear = 0;
            for (; need; need &= need - 1) {
              const int k = __ffs(need) - 1;
              const int ref = pl.cross_ref[k], iref = pl.cross_idx[k];
              bool ok = (x.matched & ref) == ref && (x.idxv & iref) == iref;
              ok = ok && run_program(
                             prog + pl.cross_off[k], pl.cross_len[k],
                             [&](int arg) { return ev[arg * kTile]; },
                             [&](int arg) { return caps[arg * S + s]; },
                             my_stack, T) != 0;
              if (!ok) clear |= 1 << k;
            }
            eff &= ~clear;
            effe &= ~clear;
          }
          const bool m_at = (eff & c.gm & ~(x.matched & c.andm)) != 0;
          o.absorb = v_e && m_at && x.cnt < c.max;
          const bool can_leave = x.cnt >= c.min;
          if (v_e && can_leave && (effe & c.reach)) {
            // smallest t > step whose entry mask matches, every group in
            // between optional (the next group's, most often)
            if (effe & c.ngm) {
              o.adv_t = max(x.step + 1, 1);
            } else {
              for (int t = max(x.step + 2, 2); t < G && pl.pre[t] == c.from;
                   ++t) {
                if (effe & pl.gmask[t]) {
                  o.adv_t = t;
                  break;
                }
              }
            }
          }
          o.advance = !o.absorb && o.adv_t < G;
          const int cnt_a = x.cnt + (o.absorb ? 1 : 0);
          alf = x.step == G - 1 && cnt_a >= max_last && cnt_a >= min_last;
          o.mtl = o.advance && o.adv_t == G - 1 && max_last == 1;
          if (seq && v_e && !o.absorb && !o.advance) {
            o.killed = 1;
            o.eob = can_leave && pre_end == c.from;
          }
          if (o.absorb) o.cnt = x.cnt + 1;
          if (o.advance) {
            o.step = o.adv_t;
            o.cnt = 1;
          }
          if (o.absorb || o.advance) {
            o.last = ts_e;
            int cand;
            if (o.absorb) {
              cand = eff & c.gm & ~(x.matched & c.andm);
            } else if (o.adv_t == max(x.step + 1, 1)) {
              cand = eff & c.ngm & ~(x.matched & c.nandm);
            } else {
              cand = eff & pl.gmask[o.adv_t];
              if (pl.gand[o.adv_t]) cand &= ~x.matched;
            }
            if (cand) {
              o.fire_e = __ffs(cand) - 1;
              o.matched |= 1 << o.fire_e;
              if (I) {
                for (unsigned mk = pl.elem_idx[o.fire_e]; mk; mk &= mk - 1) {
                  const int jj = __ffs(mk) - 1;
                  if (o.cnt == pl.idx_k[jj] + 1) o.idxv |= 1 << jj;
                }
              }
            }
          }
        }
        o.emit = o.eob || alf || o.mtl;
        o.fork = o.advance && ((marked >> o.adv_t) & 1);
        o.act2 = act && !((o.emit && !o.fork) || o.killed);
        o.alloc = o.fork && !o.mtl;
      }

      // -- the pool-wide ranks, in slot order --------------------------------
      unsigned be[R], bf[R], ba[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        be[r] = __ballot_sync(kFull, mv_[r].emit);
        bf[r] = __ballot_sync(kFull, !mv_[r].act2) & vmask[r];
        ba[r] = __ballot_sync(kFull, mv_[r].alloc);
      }
      int n_emit = 0, n_free = 0, n_alloc = 0;
      int e_base = 0, f_base = 0, a_base = 0;  // words before this warp's
      unsigned* wb = bal + par * 3 * NQ;
      par ^= 1;
      // the slot holding the k-th free slot, slot order
      auto nth_free = [&](int k) -> int {
        if constexpr (kMulti) {
          return nth_slot(wb + NQ, NQ, k);
        } else {
          return nth_slot_reg<R>(bf, k);
        }
      };
      if constexpr (kMulti) {
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            wb[warp * R + r] = be[r];
            wb[NQ + warp * R + r] = bf[r];
            wb[2 * NQ + warp * R + r] = ba[r];
          }
        }
        __syncthreads();
        for (int q = 0; q < NQ; ++q) {
          const int ce = __popc(wb[q]);
          const int cf = __popc(wb[NQ + q]);
          const int ca = __popc(wb[2 * NQ + q]);
          if (q < warp * R) {
            e_base += ce;
            f_base += cf;
            a_base += ca;
          }
          n_emit += ce;
          n_free += cf;
          n_alloc += ca;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          n_emit += __popc(be[r]);
          n_free += __popc(bf[r]);
          n_alloc += __popc(ba[r]);
        }
      }
      int emit_before[R], free_before[R], alloc_before[R];
      {
        int ce = e_base, cf = f_base, ca = a_base;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          emit_before[r] = ce + __popc(be[r] & lt_mask);
          free_before[r] = cf + __popc(bf[r] & lt_mask);
          alloc_before[r] = ca + __popc(ba[r] & lt_mask);
          ce += __popc(be[r]);
          cf += __popc(bf[r]);
          ca += __popc(ba[r]);
        }
      }

      // -- each slot's own captures, then emissions in slot order ------------
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = (warp * R + r) * 32 + lane;
        const Move& o = mv_[r];
        const int fe = o.fire_e;
        // a slot that fired takes its new captures (a fork's prefix keeps
        // its old ones; its advanced instance takes them below)
        const bool takes = !o.fork && fe >= 0;
        if (__any_sync(kFull, takes) && takes) {
          take_caps(o, sl[r].cnt, ev, s);
        }
        if (be[r] && o.emit) {
          const long long pos = n0 + emit_before[r];
          if (pos < M) {
            buf[pos] = o.eob ? sl[r].last : ts_e;
            int rr = 1;
            if (mbits) {
              buf[M + pos] = o.matched | (o.idxv << K);
              rr = 2;
            }
            if (o.fork) {
              // a fork that emits (it completes the pattern) kept its
              // old captures: its row takes the fired ones here
              for (int cr = 0; cr < n_cap_rows; ++cr) {
                buf[(rr + cr) * M + pos] =
                    cap_new(o, sl[r].cnt, ev, s, cap_word[cr]);
              }
            } else {
#pragma unroll
              for (int cr = 0; cr < kRowRegs; ++cr) {
                if (cr < n_cap_rows) {
                  buf[(rr + cr) * M + pos] = caps[cwr[cr] * S + s];
                }
              }
              for (int cr = kRowRegs; cr < n_cap_rows; ++cr) {
                buf[(rr + cr) * M + pos] = caps[cap_word[cr] * S + s];
              }
            }
          }
        }
      }
      n0 = min(n0 + n_emit, M);

      // -- forks: each placed advanced instance into its free slot ------------
      // after every slot's own update and emission (the free slot may have
      // just emitted or fired), hence the first sync; the second orders the
      // copies before any later read
      int placed = 0;
      if (n_alloc > 0) {
        placed = min(n_alloc, n_free);
        pool_sync<kMulti>();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const Move& o = mv_[r];
          if (!(o.alloc && alloc_before[r] < n_free)) continue;
          const int s = (warp * R + r) * 32 + lane;
          const int t = nth_free(alloc_before[r]);
          if constexpr (kMulti) {
            stage[t] = o.step;
            stage[S + t] = o.cnt;
            stage[2 * S + t] = sl[r].start;
            stage[3 * S + t] = o.last;
            stage[4 * S + t] = o.matched;
            stage[5 * S + t] = o.idxv;
          }
          for (int w = 0; w < ncw; ++w) caps[w * S + t] = caps[w * S + s];
          if (o.fire_e >= 0) take_caps(o, sl[r].cnt, ev, t);
        }
        pool_sync<kMulti>();
        if constexpr (kMulti) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            Move& o = mv_[r];
            if (!o.act2 && exists[r] && free_before[r] < placed) {
              const int s = (warp * R + r) * 32 + lane;
              o.act2 = 1;
              o.step = stage[s];
              o.cnt = stage[S + s];
              o.start = stage[2 * S + s];
              o.last = stage[3 * S + s];
              o.matched = stage[4 * S + s];
              o.idxv = stage[5 * S + s];
            }
          }
        } else {
          // the source of each receiving slot: the (free rank)-th fork in
          // slot order; its scalar state moves by shuffles
          int src_lane[R], src_r[R];
          bool recv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            recv[r] = !mv_[r].act2 && exists[r] && free_before[r] < placed;
            const int src = recv[r] ? nth_slot_reg<R>(ba, free_before[r]) : 0;
            src_lane[r] = src & 31;
            src_r[r] = src >> 5;
          }
          SlotState got[R];
#pragma unroll
          for (int r = 0; r < R; ++r) got[r] = SlotState{0, 0, 0, 0, 0, 0, 0};
#pragma unroll
          for (int rs = 0; rs < R; ++rs) {
            const Move& o = mv_[rs];
            const int start_rs = sl[rs].start;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int sl_ = src_lane[r];
              const int v0 = __shfl_sync(kFull, o.step, sl_);
              const int v1 = __shfl_sync(kFull, o.cnt, sl_);
              const int v2 = __shfl_sync(kFull, start_rs, sl_);
              const int v3 = __shfl_sync(kFull, o.last, sl_);
              const int v4 = __shfl_sync(kFull, o.matched, sl_);
              const int v5 = __shfl_sync(kFull, o.idxv, sl_);
              if (recv[r] && src_r[r] == rs) {
                got[r] = SlotState{1, v0, v1, v2, v3, v4, v5};
              }
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (recv[r]) {
              Move& o = mv_[r];
              o.act2 = 1;
              o.step = got[r].step;
              o.cnt = got[r].cnt;
              o.start = got[r].start;
              o.last = got[r].last;
              o.matched = got[r].matched;
              o.idxv = got[r].idxv;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Move& o = mv_[r];
        if (o.fork) {  // the prefix slot reverts and stays armed
          o.step = sl[r].step;
          o.cnt = sl[r].cnt;
          o.last = sl[r].last;
          o.matched = sl[r].matched;
        }
      }

      // -- arming into the lowest free slot ----------------------------------
      const bool any_act2 = S - n_free + placed > 0;
      const bool started_now = started && (any_act2 || done);
      const int m0 = m & gmask0;
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
      if (want && has_free) {
        const int t = nth_free(placed);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int s = (warp * R + r) * 32 + lane;
          if (s != t) continue;
          const int arm_e = __ffs(m0) - 1;
          Move& o = mv_[r];
          o.act2 = 1;
          o.step = 0;
          o.cnt = 1;
          o.start = ts_e;
          o.last = ts_e;
          o.matched = 1 << arm_e;
          o.idxv = 0;
          for (unsigned mk = pl.elem_pairs[arm_e]; mk; mk &= mk - 1) {
            const int p = __ffs(mk) - 1;
            const int v = ev[(pl.pair_desc[p] & kColMask) * kTile];
            caps[2 * p * S + s] = v;
            caps[(2 * p + 1) * S + s] = v;
          }
        }
      }
      overflow += (want && !has_free ? 1u : 0u) + u32(n_alloc - placed);
      any_active = any_act2 || (want && has_free);
      started = started_now || want;
      done = any_done;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const Move& o = mv_[r];
        const bool moved = o.step != sl[r].step;
        if (__any_sync(kFull, moved) && moved) si[r] = step_info(o.step);
        sl[r] = SlotState{o.act2, o.step, o.cnt, o.start, o.last, o.matched,
                          o.idxv};
      }
    }
    tts = nts;
    tmv = nmv;
    tme = nme;
  }

  asm volatile("cp.async.wait_all;\n" ::);
  pool_sync<kMulti>();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!exists[r]) continue;
    const int s = (warp * R + r) * 32 + lane;
    state_out[s] = sl[r].act ? 1 : 0;
    state_out[S + s] = sl[r].step;
    state_out[2 * S + s] = sl[r].cnt;
    state_out[3 * S + s] = sl[r].start;
    state_out[4 * S + s] = sl[r].last;
    state_out[5 * S + s] = sl[r].matched;
    state_out[6 * S + s] = sl[r].idxv;
    for (int w = 0; w < ncw; ++w) {
      state_out[(kFixedRows + w) * S + s] = caps[w * S + s];
    }
  }
  if (tid == 0) {
    scal_out[0] = done ? 1 : 0;
    scal_out[1] = started ? 1 : 0;
    scal_out[2] = static_cast<int>(overflow);
    scal_out[3] = static_cast<int>(n0);
  }
}

typedef void (*KernelFn)(const int*, const int*, const int*, const int*,
                         const int*, const unsigned char*, const int*,
                         const int*, const int*, const int*, const int*, int,
                         int*, int*, int*);

// The launch shape of a pool of S slots (cuda_ops.slot_launch_shape):
// one warp at S <= 64, else as many warps of R slots a thread as needed.
// 0 when the pool is past 1,024 threads x 16 slots.
int launch_shape(int S, bool* multi, int* R) {
  if (S <= 32) {
    *multi = false;
    *R = 1;
    return 32;
  }
  if (S <= 64) {
    *multi = false;
    *R = 2;
    return 32;
  }
  *multi = true;
  for (int r = 2; r <= 16; r *= 2) {
    const int warps = (S + 32 * r - 1) / (32 * r);
    if (warps <= 32) {
      *R = r;
      return warps * 32;
    }
  }
  return 0;
}

KernelFn kernel_of(bool multi, int R) {
  if (!multi) {
    return R == 1 ? slot_nfa_kernel<false, 1> : slot_nfa_kernel<false, 2>;
  }
  switch (R) {
    case 2: return slot_nfa_kernel<true, 2>;
    case 4: return slot_nfa_kernel<true, 4>;
    case 8: return slot_nfa_kernel<true, 8>;
    default: return slot_nfa_kernel<true, 16>;
  }
}

}  // namespace

// One micro-batch of the slot NFA. plan_host / plan_dev: the same
// SlotPlan words (plan_len of them) in host and device memory; the host
// copy is validated and sizes the launch, the kernel reads the device copy.
// aux: the capture rows' words and the programs (aux_len words) on the
// device. state: int32 [W, S] (W = 7 + 2P + I), scal: int32 [3] (done,
// started, overflow); ts, mword, eword: int32 [E]; valid: bool [E]; cols:
// int32 [n_cols, E]; idx: int32 [E] and cnt: int32 [1] on the device (the
// scan visits idx[0, *cnt)), or both null (every event). Outputs:
// state_out [W, S], scal_out [4] (done, started, overflow, n), buf int32
// [R, E + S] (R = 1 + mbits + capture rows), which the caller zeroes. One
// launch on `stream`; returns a cudaError_t.
extern "C" int fst_slot_nfa_scan(const int* plan_host, int plan_len,
                                 const int* plan_dev, const int* aux,
                                 int aux_len, const int* state,
                                 const int* scal, const int* ts,
                                 const void* valid, const int* mword,
                                 const int* eword, const int* cols,
                                 const int* idx, const int* cnt, int E, int S,
                                 int* state_out, int* scal_out, int* buf,
                                 int W, int R, void* stream) {
  static size_t shared_set[6] = {48 * 1024, 48 * 1024, 48 * 1024,
                                 48 * 1024, 48 * 1024, 48 * 1024};
  if (plan_len != kPlanWords || E < 0 || S < 1 || aux_len < 0 ||
      (idx == nullptr) != (cnt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SlotPlan& pl = *reinterpret_cast<const SlotPlan*>(plan_host);
  if (pl.S != S || pl.K < 1 || pl.K > 31 || pl.G < 1 || pl.G > pl.K ||
      pl.P < 0 || pl.P > kMaxPairs || pl.I < 0 || pl.K + pl.I > 31 ||
      pl.n_cols < 0 || pl.depth < 0 || pl.n_aux != aux_len ||
      pl.n_cap_rows < 0 || pl.n_cap_rows > aux_len ||
      (aux_len > 0 && aux == nullptr) ||
      W != kFixedRows + 2 * pl.P + pl.I || R != pl.n_rows ||
      R != 1 + pl.mbits + pl.n_cap_rows ||
      (pl.n_cols > 0 && cols == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < pl.K; ++k) {
    if (((pl.cross_mask >> k) & 1) &&
        (pl.cross_len[k] < 1 || pl.cross_off[k] < pl.n_cap_rows ||
         pl.cross_off[k] + pl.cross_len[k] > aux_len)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  bool multi = false;
  int Rs = 1;
  const int T = launch_shape(S, &multi, &Rs);
  if (T == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t words =
      static_cast<size_t>(kPlanWords) + pl.n_cap_rows +
      static_cast<size_t>(S) * (2 * pl.P + pl.I) +
      static_cast<size_t>(pl.depth) * T + 2 * pl.n_cols * kTile +
      (multi && pl.marked ? static_cast<size_t>(kStageWords) * S : 0) +
      (multi ? static_cast<size_t>(6) * (T / 32) * Rs : 0);
  const size_t shared = 4 * words;
  if (shared > static_cast<size_t>(kMaxShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KernelFn fn = kernel_of(multi, Rs);
  const int which = multi ? 1 + (Rs == 2 ? 0 : Rs == 4 ? 1 : Rs == 8 ? 2 : 3)
                          : (Rs == 1 ? 0 : 5);
  if (shared > shared_set[which]) {  // raised once, at the first such launch
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    shared_set[which] = shared;
  }
  fn<<<1, T, shared, static_cast<cudaStream_t>(stream)>>>(
      plan_dev, aux, state, scal, ts, static_cast<const unsigned char*>(valid),
      mword, eword, cols, idx, cnt, E, state_out, scal_out, buf);
  return static_cast<int>(cudaGetLastError());
}
