// Fused slot-free NFA advance of the chain pattern matcher.
//
// Replaces: flink_siddhi_tpu/compiler/pallas_ops.py, the Pallas kernel built
// by `_build_chain` and called through `chain_advance` (nfa.py `_chain_core`,
// the advance of every candidate partial match through the pattern's
// remaining positive steps). The numpy oracle `_ref_chain_advance` in the
// same file is the specification, followed exactly: `jg <= j` kills on an
// absence guard at or before the step's match, and `ts[j] - start <= within`
// (int32, wrapping) keeps a completion.
//
// One thread per candidate v < V (V = carried pool + tape positions). For
// each positive step k = 1..K-1 a candidate at step k gathers
// j = nxt[pos_row[k], pos] (next match at or after its search position),
// gathers each guard row of step k at the same position, and gathers ts[j]
// for `within`; then it advances (step = k + 1, pos = j + 1) or dies.
// jmat[q, k - 1, v] is j where the candidate advanced at step k, else E.
//
// What bounds it on an H100: the latency of dependent gathers, not
// bandwidth. The streamed bytes are small (act 1 B, step/pos/start 12 B in,
// 9 B out, 4 B of jmat per step and candidate), but every live candidate
// runs a chain: nxt[row][pos], then ts[j], and the next step's position is
// j + 1, one access after another with nothing to hide them. The table
// (2 rows x (E + 1) x 4 B = 512 KiB for the headline pattern after
// relevance compaction, E = 65,536; 4 MiB at the full 524,288-event width)
// is over a block's 227 KB of shared memory and stays resident in the
// 50 MB L2.
//
// Design: candidates not at step k skip every gather of step k (their
// outcome is fixed: jmat = E, no state change), so the gathers issued are
// what the batch's live candidates need. The gathers are local: a fresh
// start at tape position e searches from e + 1, and a block holds 256
// consecutive candidates, so after the first miss of a neighbourhood the
// read-only (__ldg) gathers of its neighbours can be served by the SM's L1. A per-block window of the table copied
// into shared memory (cp.async, from the block's smallest search position)
// served every gather of the headline's step and was still slower on the
// card: it puts a block barrier on the candidates' own loads and a copy
// round trip in front of the chain, to save L1 hits (PERF.md §6).
//
// The table's row stride ld is passed by value: the chain matcher's table
// comes from the reverse cummin's padded output, whose rows start on
// 16-byte boundaries (ld = E + 1 rounded up to 4). The per-pattern row
// layout (which table row each positive step and guard reads) is a small
// struct passed by value as a kernel argument: no device copy and no host
// sync per call. Unlike the Pallas kernel, which declined tables over its
// 8 MiB VMEM budget, this one takes every R and E.
//
// Query axis: a stack of Q chain queries with one pattern shape (nfa.py
// `StackedChainArtifact`, which the reference runs under `jax.vmap` without
// Pallas) advances in the same launch, blockIdx.y = query. Query q reads its
// own rows of the table (the reverse cummin's [Q * rows, E + 1] output, the
// rows of each query together), its own ts row (each query's relevance-
// compacted tape differs), its own candidates and its own `within` (an
// int32 [Q] device array the caller uploads once). Q = 1 is the single
// query's launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSteps = 32;
constexpr int kMaxGuards = 64;

struct ChainPlan {
  int n_steps;                 // K - 1
  int has_within;
  int pos_row[kMaxSteps];      // table row of positive step k (k = 1..K-1)
  int g_begin[kMaxSteps + 1];  // step k's guards: g_row[g_begin[k-1], g_begin[k])
  int g_row[kMaxGuards];
};

// kQueryAxis: blockIdx.y picks the query. The single query's launch
// (Q = 1, one `within` by value) is compiled without the query offsets:
// on the card they cost its call about 5% (PERF.md §6).
template <bool kQueryAxis>
__global__ void __launch_bounds__(kThreads)
chain_advance_kernel(const int* __restrict__ nxt, long long ld,
                     long long q_table, int E,
                     const int* __restrict__ ts_pad,
                     const bool* __restrict__ act_in,
                     const int* __restrict__ step_in,
                     const int* __restrict__ pos_in,
                     const int* __restrict__ start,
                     bool* __restrict__ act_out, int* __restrict__ step_out,
                     int* __restrict__ pos_out, int* __restrict__ jmat, int V,
                     const ChainPlan plan, int within,
                     const int* __restrict__ within_q) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  if (kQueryAxis) {
    // query q (uniform over the block): its own table rows, ts row,
    // candidates, jmat rows and within
    const int q = blockIdx.y;
    const size_t qv = static_cast<size_t>(q) * V;
    nxt += q * q_table;
    ts_pad += static_cast<size_t>(q) * (E + 1);
    act_in += qv;
    step_in += qv;
    pos_in += qv;
    start += qv;
    act_out += qv;
    step_out += qv;
    pos_out += qv;
    jmat += qv * plan.n_steps;
    if (within_q != nullptr) within = __ldg(within_q + q);
  }
  bool act = act_in[v];
  int step = step_in[v];
  int pos = pos_in[v];
  const int st = start[v];
  for (int k = 1; k <= plan.n_steps; ++k) {
    int jk = E;
    if (act && step == k) {
      const int idx = min(max(pos, 0), E);
      const int j = __ldg(nxt + plan.pos_row[k - 1] * ld + idx);
      bool found = j < E;
      for (int g = plan.g_begin[k - 1]; g < plan.g_begin[k]; ++g) {
        const int jg = __ldg(nxt + plan.g_row[g] * ld + idx);
        if (jg <= j && jg < E) {
          act = false;
          found = false;
        }
      }
      if (found && plan.has_within) {
        const int ts_j = __ldg(ts_pad + j);
        const int span = static_cast<int>(static_cast<unsigned>(ts_j) -
                                          static_cast<unsigned>(st));
        if (span > within) {
          act = false;
          found = false;
        }
      }
      if (found) {
        jk = j;
        step = k + 1;
        pos = j + 1;
      }
    }
    jmat[static_cast<size_t>(k - 1) * V + v] = jk;
  }
  act_out[v] = act;
  step_out[v] = step;
  pos_out[v] = pos;
}

}  // namespace

// Q queries, each with its own table, ts row, candidates and within:
// nxt: int32 [Q * rows, E + 1] with row stride ld >= E + 1 (query q's rows
// start at q * q_table = q * rows * ld); ts_pad: int32 [Q, E + 1]; act
// (bool), step, pos, start: [Q, V]; outputs act/step/pos [Q, V] and jmat
// int32 [Q, K - 1, V]. within_q: int32 [Q] on the device, or null for one
// `within` for every query (by value). Q = 1 is the single-query call.
// plan_host: [n_steps, has_within, pos_row x n_steps,
// g_begin x (n_steps + 1), g_row x n_guards] in host memory. One launch on
// `stream` (none when V == 0); returns a cudaError_t.
extern "C" int fst_chain_advance(const int* nxt, long long ld,
                                 long long q_table, int E,
                                 const int* ts_pad,
                                 const void* act_in, const int* step_in,
                                 const int* pos_in, const int* start,
                                 void* act_out, int* step_out, int* pos_out,
                                 int* jmat, int V, int Q,
                                 const int* plan_host, int plan_len,
                                 int within, const int* within_q,
                                 void* stream) {
  if (plan_len < 3 || E < 0 || V < 0 || Q < 1 || Q > 65535 ||
      ld < static_cast<long long>(E) + 1 || q_table < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChainPlan plan = {};
  plan.n_steps = plan_host[0];
  plan.has_within = plan_host[1];
  const int n = plan.n_steps;
  if (n < 1 || n > kMaxSteps || plan_len < 2 + 2 * n + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < n; ++k) plan.pos_row[k] = plan_host[2 + k];
  for (int k = 0; k <= n; ++k) plan.g_begin[k] = plan_host[2 + n + k];
  const int n_guards = plan.g_begin[n];
  if (plan.g_begin[0] != 0 || n_guards < 0 || n_guards > kMaxGuards ||
      plan_len != 2 + 2 * n + 1 + n_guards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int g = 0; g < n_guards; ++g) plan.g_row[g] = plan_host[3 + 2 * n + g];
  if (V == 0) return 0;
  const dim3 grid((V + kThreads - 1) / kThreads, Q);
  auto* kernel = Q == 1 && within_q == nullptr ? chain_advance_kernel<false>
                                               : chain_advance_kernel<true>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nxt, ld, q_table, E, ts_pad, static_cast<const bool*>(act_in), step_in,
      pos_in, start, static_cast<bool*>(act_out), step_out, pos_out, jmat, V,
      plan, within, within_q);
  return static_cast<int>(cudaGetLastError());
}
