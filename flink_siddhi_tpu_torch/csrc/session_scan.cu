// K7: the session window's scan over one micro-batch, per key.
//
// Replaces no Pallas kernel: the reference runs this loop as a `lax.scan`,
// flink_siddhi_tpu/compiler/scan_windows.py `SessionWindowArtifact.step`
// (:684, the body :706-766, the scan :769). In torch ops that scan would be
// a Python loop an event, which no CUDA graph can hold.
//
// The function: for each masked event t in order, of key c = codes[t]:
//   closes = open[c] && ts[t] - last[c] > gap          (int32, wrapping)
//   if closes: the closed session's last, count, sums, minima and maxima
//              (the values before this event) are written at position t;
//   fresh = closes || !open[c];
//   open[c] = 1; last[c] = max(last[c], ts[t])          (never rewinds)
//   cnt[c] = (fresh ? 0 : cnt[c]) + 1
//   s[a][c] = (fresh ? 0 : s[a][c]) + v                  (float32, in order)
//   mn / mx: (fresh ? identity : mn) min / max v, NaN-propagating for a
//   float column; an int32 column takes v -> int32 as the reference's
//   astype does (toward zero, saturating, NaN -> 0), min / max in int32.
// Every argument v arrives as float32 (the reference casts each to
// float32 first, :698-703).
//
// What bounds it on an H100: a key's events are a serial chain (each reads
// the state the one before wrote), so the floor is the longest key's chain,
// not the bytes (E x (12 + 4A) read, the closed rows written): a few
// microseconds of bytes at 524,288 events against a walk of E / keys
// dependent steps.
//
// Design. Sessions of different keys never touch each other, so the scan
// splits by key: the wrapper groups the masked events by key with a stable
// sort (tape order kept within a key) and gives each key's range of the
// sorted order; one thread walks one key's events in order, its session in
// registers (the sums and extremes in the state arrays, which only that
// thread touches). The float32 sums add in the reference's own order, so
// they are bit-equal. An unkeyed session (every code 0) is one long walk on
// one thread: the known weakness, timed by chip_smoke.py.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

// float32 -> int32 as XLA's convert does: toward zero, saturating, NaN -> 0
__device__ __forceinline__ int to_i32(float v) { return __float2int_rz(v); }

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct SessionArgs {
  const long long* order;   // [E] event indices, grouped by key (masked first)
  const long long* starts;  // [G + 1] each key's range of `order`
  const int* ts;            // [E]
  const float* vals;        // [A, E]
  const int* arg_int;       // [A] 1: an int32 column's min / max
  unsigned char* open;      // [G] state, updated in place
  int* last;                // [G]
  int* cnt;                 // [G]
  float* s;                 // [A, G]
  unsigned* mn;             // [A, G] 32-bit words (float or int32 bits)
  unsigned* mx;             // [A, G]
  unsigned char* closes;    // [E] out: the event closed its key's session
  int* c_last;              // [E] out: the closed session's last ts
  int* c_cnt;               // [E]
  float* c_s;               // [A, E]
  unsigned* c_mn;           // [A, E]
  unsigned* c_mx;           // [A, E]
  int E, G, A, gap;
};

__global__ void __launch_bounds__(kThreads) session_scan_kernel(const SessionArgs p) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= p.G) return;
  const long long lo = p.starts[c], hi = p.starts[c + 1];
  if (lo >= hi) return;
  bool op = p.open[c] != 0;
  int la = p.last[c];
  int cn = p.cnt[c];
  const long long E = p.E, G = p.G;
  long long t_next = p.order[lo];
  for (long long i = lo; i < hi; ++i) {
    const long long t = t_next;
    if (i + 1 < hi) t_next = p.order[i + 1];
    const int tt = p.ts[t];
    const int since = static_cast<int>(static_cast<unsigned>(tt) - static_cast<unsigned>(la));
    const bool closes = op && since > p.gap;
    if (closes) {
      p.closes[t] = 1;
      p.c_last[t] = la;
      p.c_cnt[t] = cn;
      for (int a = 0; a < p.A; ++a) {
        p.c_s[a * E + t] = p.s[a * G + c];
        p.c_mn[a * E + t] = p.mn[a * G + c];
        p.c_mx[a * E + t] = p.mx[a * G + c];
      }
    }
    const bool fresh = closes || !op;
    op = true;
    la = max(la, tt);
    cn = (fresh ? 0 : cn) + 1;
    for (int a = 0; a < p.A; ++a) {
      const float v = p.vals[a * E + t];
      p.s[a * G + c] = __fadd_rn(fresh ? 0.0f : p.s[a * G + c], v);
      unsigned& mn = p.mn[a * G + c];
      unsigned& mx = p.mx[a * G + c];
      if (p.arg_int[a]) {
        const int iv = to_i32(v);
        const int m0 = fresh ? 0x7fffffff : static_cast<int>(mn);
        const int x0 = fresh ? static_cast<int>(0x80000000u) : static_cast<int>(mx);
        mn = static_cast<unsigned>(min(m0, iv));
        mx = static_cast<unsigned>(max(x0, iv));
      } else {
        const float m0 = fresh ? INFINITY : __uint_as_float(mn);
        const float x0 = fresh ? -INFINITY : __uint_as_float(mx);
        mn = __float_as_uint(nan_min(m0, v));
        mx = __float_as_uint(nan_max(x0, v));
      }
    }
  }
  p.open[c] = 1;
  p.last[c] = la;
  p.cnt[c] = cn;
}

}  // namespace

// Launch on `stream`; the wrapper has copied the state into the output
// arrays (updated in place) and zeroed the per-event outputs. Returns a
// cudaError_t.
extern "C" int fst_session_scan(const void* args, void* stream) {
  const SessionArgs p = *static_cast<const SessionArgs*>(args);
  if (p.G < 1 || p.E < 1 || p.A < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.G + kThreads - 1) / kThreads;
  session_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
