// Multi-channel reverse cumulative minimum (suffix min) over int32 rows.
//
// Replaces: flink_siddhi_tpu/compiler/pallas_ops.py, the Pallas kernel built
// by `_build` and called through `multi_reverse_cummin` (one fused pass over
// up to 8 channels; the chain matcher's next-match tables, nfa.py
// `_chain_core`).
//
// out[c, e] = min(x[c, e], x[c, e + 1], ..., x[c, E - 1]) for c < C, e < E.
//
// What bounds it on an H100: memory. The function must read C * E int32 and
// write C * E int32; it does one integer min per element, far below the
// card's integer rate. At the chain matcher's shapes (C = 2, E = 65,536
// after relevance compaction) the 1 MiB it moves takes well under a
// microsecond at 3.35 TB/s, so two kernel launches dominate its time.
//
// Design: the Pallas kernel walks its grid right to left and threads a
// running minimum through a carry; Hopper blocks run in parallel and in no
// order, so that carry cannot exist. Two passes instead:
//   1. tile_min_kernel: one block per (1024-event tile, channel) writes the
//      tile's minimum (a C x n_tiles scratch array).
//   2. suffix_min_kernel: each block reduces the tile minima to its right
//      into a carry, then runs an in-tile suffix scan — 4 consecutive events
//      per thread, a warp-shuffle suffix scan across lanes, and the per-warp
//      minima through shared memory — seeded with that carry.
// The input is read twice (the second read mostly from L2); any E >= 1 and
// any 1 <= C <= 65,535 are taken, with no padding channels. The identity is
// INT_MAX, so every int32 value is exact.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // events per block

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Block-wide minimum, returned to every thread.
__device__ __forceinline__ int block_min(int v, int* smem) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r = min(r, smem[w]);
  return r;
}

__global__ void __launch_bounds__(kThreads)
tile_min_kernel(const int* __restrict__ x, int E, int n_tiles,
                int* __restrict__ tile_min) {
  __shared__ int smem[kWarps];
  const int c = blockIdx.y;
  const int t = blockIdx.x;
  const int* row = x + static_cast<size_t>(c) * E;
  const long long base = static_cast<long long>(t) * kTile;
  int m = INT_MAX;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long e = base + i;
    if (e < E) m = min(m, row[e]);
  }
  m = block_min(m, smem);
  if (threadIdx.x == 0) tile_min[static_cast<size_t>(c) * n_tiles + t] = m;
}

__global__ void __launch_bounds__(kThreads)
suffix_min_kernel(const int* __restrict__ x, int E, int n_tiles,
                  const int* __restrict__ tile_min, int* __restrict__ out) {
  __shared__ int smem[kWarps];
  __shared__ int warp_total[kWarps];
  const int c = blockIdx.y;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* row = x + static_cast<size_t>(c) * E;
  int* orow = out + static_cast<size_t>(c) * E;
  const int* tmin = tile_min + static_cast<size_t>(c) * n_tiles;

  // carry: the minimum of every tile to the right of this one
  int carry = INT_MAX;
  for (int j = t + 1 + threadIdx.x; j < n_tiles; j += kThreads) {
    carry = min(carry, tmin[j]);
  }
  carry = block_min(carry, smem);

  // this thread's kPerThread consecutive events, suffix-min'ed locally
  const long long base =
      static_cast<long long>(t) * kTile + threadIdx.x * kPerThread;
  int v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = base + k;
    v[k] = e < E ? row[e] : INT_MAX;
  }
#pragma unroll
  for (int k = kPerThread - 2; k >= 0; --k) v[k] = min(v[k], v[k + 1]);

  // inclusive suffix min across lanes: s = min over lanes >= this lane
  int s = v[0];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(0xffffffffu, s, off);
    if (lane + off < 32) s = min(s, o);
  }
  if (lane == 0) warp_total[warp] = s;
  __syncthreads();
  int right = carry;
  for (int w = warp + 1; w < kWarps; ++w) right = min(right, warp_total[w]);
  const int later_lanes = __shfl_down_sync(0xffffffffu, s, 1);
  if (lane < 31) right = min(right, later_lanes);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = base + k;
    if (e < E) orow[e] = min(v[k], right);
  }
}

}  // namespace

// x, out: int32 [C, E] row-major; tile_min: int32 scratch of
// C * ceil(E / 1024). Launches on `stream`; returns a cudaError_t.
extern "C" int fst_reverse_cummin(const int* x, int* out, int* tile_min,
                                  int C, int E, void* stream) {
  if (C < 1 || C > 65535 || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (E + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, C);
  tile_min_kernel<<<grid, kThreads, 0, s>>>(x, E, n_tiles, tile_min);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  suffix_min_kernel<<<grid, kThreads, 0, s>>>(x, E, n_tiles, tile_min, out);
  return static_cast<int>(cudaGetLastError());
}
