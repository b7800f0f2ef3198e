// The match of an event table's update or delete: each table row's last
// matching tape position of one micro-batch.
//
// Replaces: no Pallas kernel. The reference builds a dense (E, C) match
// matrix `mask[i] & valid[j] & on(i, j)` and takes, per row, an `argmax`
// over the reversed matrix (flink_siddhi_tpu/compiler/table.py:362-408,
// `TableMutateArtifact.step_tables`). Its plain version here is
// `cuda_ops.table_mutate_plain`, the same dense formulation in torch, and
// the specification this kernel is held to exactly.
//
// Semantics: row j's candidate i matches when the event is the query's
// (`mask[i]`), the row is valid and the `on` program (program.cuh, the
// interpreter K4 and K5 share: event loads are the stream columns and the
// select outputs at i, the other load kind the table's columns at j) is
// true. `last[j]` is the largest matching i, or -1 (the wrapper fills it
// with -1 before the launch). The caller applies it: a delete clears the
// rows with `last >= 0`, an update gathers each written output at `last`.
//
// What bounds it on an H100: the walk over candidates, not bytes. The
// bytes the function must move (the mask, the program's event columns,
// the table's columns and `last`) take about 0.002 ms at 3.35 TB/s for a
// 524,288-event tape, while E x C candidates is 537 M at C = 1,024. A row
// needs only the candidates after its last match, so each row walks its
// events from the tape's end and stops at its first match.
//
// Design (simple; its speed is for later work): a block takes 256 table
// rows (one a thread) and a chunk of 2,048 tape positions. Chunks run
// from the tape's end first (blockIdx.y 0 is the last chunk), and a row
// already matched at or after a chunk's start (`last`, written by a later
// chunk's block) skips the chunk; a block with no row left returns. The
// block compacts its chunk's masked events into shared memory in tape
// order (a ballot per warp, the warps' counts summed in shared memory),
// with each event's key word when the program has one (cuda_ops.
// join_key_hint: its first top-level conjunct `evt.x == tbl.y` over int
// columns, a necessary condition). Each thread then walks the compacted
// events from the end: the key screen first, the interpreter only for a
// candidate that passes it, and stops at its first match; all lanes read
// the same event's words at each step (a broadcast). The match goes into
// `last[j]` by atomicMax (chunks of one row may finish in any order).
//
// The program's stack: a thread's local array of kLocalDepth words for a
// program up to that deep; a deeper one takes a global stack of depth x
// threads words that the wrapper allocates (cuda_ops.TableMutate), its
// grid cut to `stack_y` chunk rows (each block walks its chunks from the
// end in turn) so that the stack stays within cuda_ops.STACK_WORDS.
#include <cuda_runtime.h>

#include "program.cuh"

namespace {

using namespace fst_program;

constexpr int kRows = 256;      // table rows a block, one a thread
constexpr int kWarps = kRows / 32;
constexpr int kChunk = 2048;    // tape positions a block
constexpr int kPer = kChunk / kRows;
constexpr int kLocalDepth = 227;  // cuda_ops.STACK_LOCAL_DEPTH
constexpr unsigned kFull = 0xffffffffu;

// cuda_ops.TableMutate packs it (ctypes `_MutateArgs`).
struct MutateArgs {
  const unsigned char* mask;   // [E] the query's events
  const int* a_cols;           // [a_n, E] the program's event columns
  const unsigned char* valid;  // [C] the table's valid rows
  const int* b_cols;           // [b_n, C] the program's table columns
  const int* prog;             // the `on` program
  int* last;                   // [C] filled with -1: the last match
  long long* visits;           // [1] candidates walked, or null
  int* stack;                  // a deep program's [depth][threads] stack
  int E, C, a_n, b_n, prog_len;
  int key_a, key_b;  // the program's key equality a_cols[key_a] ==
                     // b_cols[key_b], or -1
  int depth;         // the program's stack depth
  int stack_y;       // a deep program's chunk rows in the grid
};

// The block's table rows against chunk `ch` of the tape; adds the
// candidates the thread walked to `walked`. `stk` is the program's stack
// (a column of stride `T`).
__device__ __forceinline__ void mutate_chunk(const MutateArgs& p, int ch,
                                             int* stk, int T,
                                             long long& walked) {
  __shared__ int s_idx[kChunk];  // the chunk's masked events, in tape order
  __shared__ int s_key[kChunk];  // ... and their key words
  __shared__ int s_cnt[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c0 = ch * kChunk, c1 = min(c0 + kChunk, p.E);
  const int j = blockIdx.x * kRows + tid;
  const bool keyed = p.key_b >= 0;
  bool live = j < p.C && p.valid[j];
  // a match at or after c0 came from a later chunk: none here beats it
  if (live) live = *reinterpret_cast<volatile int*>(p.last + j) < c0;
  if (!__syncthreads_or(live)) return;

  // the chunk's masked events, compacted in tape order
  int n = 0;
  for (int r = 0; r < kPer; ++r) {
    const int i = c0 + r * kRows + tid;
    const bool m = i < c1 && p.mask[i];
    const unsigned b = __ballot_sync(kFull, m);
    if (lane == 0) s_cnt[w] = __popc(b);
    __syncthreads();
    int before = n, total = 0;
    for (int k = 0; k < kWarps; ++k) {
      if (k < w) before += s_cnt[k];
      total += s_cnt[k];
    }
    if (m) {
      const int at = before + __popc(b & ((1u << lane) - 1u));
      s_idx[at] = i;
      if (keyed) {
        s_key[at] = __ldg(p.a_cols + static_cast<size_t>(p.key_a) * p.E + i);
      }
    }
    n += total;
    __syncthreads();  // s_cnt is reused
  }
  if (n == 0) return;

  // each row walks the events from the end to its first match
  int found = -1;
  if (live) {
    const int bkey =
        keyed ? __ldg(p.b_cols + static_cast<size_t>(p.key_b) * p.C + j) : 0;
    for (int k = n - 1; k >= 0; --k) {
      ++walked;
      if (keyed && s_key[k] != bkey) continue;
      const int i = s_idx[k];
      bool ok = true;
      if (p.prog_len) {
        ok = run_program(
                 p.prog, p.prog_len,
                 [&](int a) {
                   return __ldg(p.a_cols + static_cast<size_t>(a) * p.E + i);
                 },
                 [&](int a) {
                   return __ldg(p.b_cols + static_cast<size_t>(a) * p.C + j);
                 },
                 stk, T) != 0;
      }
      if (ok) {
        found = i;
        break;
      }
    }
  }
  if (found >= 0) atomicMax(p.last + j, found);
}

// kDeep: the program's stack is the thread's column of `p.stack`, and the
// grid may hold fewer chunk rows than the tape has chunks (each block then
// takes its chunks in turn, the tape's end first); else a local array and
// one chunk a block (blockIdx.y 0 the last chunk).
template <bool kDeep>
__global__ void __launch_bounds__(kRows) table_mutate_kernel(MutateArgs p) {
  const int nch = (p.E + kChunk - 1) / kChunk;
  long long walked = 0;
  if (!kDeep) {
    int stk[kLocalDepth];
    mutate_chunk(p, nch - 1 - blockIdx.y, stk, 1, walked);
  } else {
    int* stk = p.stack + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                          blockIdx.x) * kRows + threadIdx.x;
    const int T = gridDim.x * gridDim.y * kRows;
    for (int y = blockIdx.y; y < nch; y += gridDim.y) {
      if (y != blockIdx.y) __syncthreads();  // the last chunk is done
      mutate_chunk(p, nch - 1 - y, stk, T, walked);
    }
  }
  if (p.visits) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) walked += __shfl_xor_sync(kFull, walked, o);
    if ((threadIdx.x & 31) == 0 && walked) {
      atomicAdd(reinterpret_cast<unsigned long long*>(p.visits),
                static_cast<unsigned long long>(walked));
    }
  }
}

}  // namespace

// `args` points at a MutateArgs (cuda_ops._MutateArgs; `last` filled with
// -1; `stack` sized depth x the grid's threads when the program is deeper
// than kLocalDepth); returns a cudaError_t.
extern "C" int fst_table_mutate(const void* args, void* stream) {
  const MutateArgs p = *static_cast<const MutateArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (static_cast<long long>(p.E) + kChunk - 1) / kChunk;
  const bool deep = p.prog_len > 0 && p.depth > kLocalDepth;
  if (p.E < 1 || p.C < 1 || chunks > 65535 ||
      (p.key_b >= 0 && (p.key_a < 0 || p.key_a >= p.a_n || p.key_b >= p.b_n)) ||
      (deep && (p.stack == nullptr || p.stack_y < 1 || p.stack_y > chunks))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned gx = (p.C + kRows - 1) / kRows;
  if (deep) {
    table_mutate_kernel<true><<<dim3(gx, p.stack_y), kRows, 0, s>>>(p);
  } else {
    table_mutate_kernel<false>
        <<<dim3(gx, static_cast<unsigned>(chunks)), kRows, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
