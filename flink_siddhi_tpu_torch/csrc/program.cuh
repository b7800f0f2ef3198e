// The postfix program interpreter shared by the slot NFA scan (K4,
// slot_nfa.cu) and the join pair step (K5, join_pairs.cu).
//
// A program is compiled by compiler/slot_program.py: int32 words, an opcode
// in the low 8 bits and an argument above them (`kLit` is followed by its
// literal word). Every stack value is a 32-bit word: int32 by value, float32
// by its bit pattern, a boolean as 0 or 1. Two load kinds: `kEvt` reads a
// column of the event at hand, `kCap` a word of the other operand (K4: the
// slot's captures; K5: the other side's combined entry); the caller passes
// both as functors.
//
// int32 arithmetic wraps (unsigned); float32 arithmetic rounds each
// operation (__fadd_rn etc.: no fused multiply-add) and flushes as the
// reference's CPU does (XLA runs float32 with FTZ and DAZ): a subnormal
// operand or result is a zero of its sign, made explicitly with integer
// operations (`ftz`), so the result does not depend on the build's -ftz;
// comparisons flush their operands; unary minus is a sign flip and keeps
// a subnormal. `/` and `%` follow jnp.floor_divide, jnp.divide and
// jnp.mod (XLA's integer division by zero and INT_MIN / -1 included).
#pragma once

namespace fst_program {

// slot_program.py's opcodes
enum Op {
  kLit = 1, kEvt, kCap, kI2F,
  kAddI, kSubI, kMulI, kNegI,
  kAddF, kSubF, kMulF, kNegF,
  kEqI, kNeI, kLtI, kLeI, kGtI, kGeI,
  kEqF, kNeF, kLtF, kLeF, kGtF, kGeF,
  kAnd, kOr, kNot, kAndJ, kOrJ,
  kDivI, kModI, kDivF, kModF,
};

__device__ __forceinline__ float f32(int w) { return __int_as_float(w); }
__device__ __forceinline__ int w32(float f) { return __float_as_int(f); }
__device__ __forceinline__ unsigned u32(int w) {
  return static_cast<unsigned>(w);
}
__device__ __forceinline__ int sgn(int x) { return (x > 0) - (x < 0); }

// A subnormal float32 (zero exponent bits) as a zero of its sign.
__device__ __forceinline__ int ftz_w(int w) {
  return (w & 0x7f800000) == 0 ? (w & static_cast<int>(0x80000000u)) : w;
}
__device__ __forceinline__ float ftz(float x) { return f32(ftz_w(w32(x))); }

// XLA's integer division and remainder: x / 0 = -1, x % 0 = x,
// INT_MIN / -1 = INT_MIN, INT_MIN % -1 = 0 (C++ leaves them undefined)
__device__ __forceinline__ int xla_div(int a, int b) {
  if (b == 0) return -1;
  if (b == -1) return static_cast<int>(0u - u32(a));
  return a / b;
}
__device__ __forceinline__ int xla_rem(int a, int b) {
  if (b == 0) return a;
  if (b == -1) return 0;
  return a % b;
}
// jnp.floor_divide on int32
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = xla_div(a, b);
  const bool adj = sgn(a) != sgn(b) && xla_rem(a, b) != 0;
  return adj ? static_cast<int>(u32(q) - 1u) : q;
}
// jnp.mod on int32 (a zero divisor becomes 1: the result is 0)
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int d = b == 0 ? 1 : b;
  const int t = xla_rem(a, d);
  const bool plus = ((t < 0) != (d < 0)) && t != 0;
  return plus ? static_cast<int>(u32(t) + u32(d)) : t;
}
// C's fmodf, exact whatever the build's -ftz: an operand smaller than the
// divisor is the remainder as it is (a subnormal one included); a
// remainder can be subnormal only when |b| < 2^-102 (it is a multiple of
// b's last mantissa bit), where fmodf under -ftz=true returns 0 (measured
// on the H100): there the remainder is taken in double (exact) and its
// float bits are made with integer operations.
__device__ __forceinline__ float fmod_exact(float a, float b) {
  if (fabsf(a) < fabsf(b)) return a;
  if (fabsf(b) >= 1.9721522630525295e-31f) return fmodf(a, b);  // 2^-102
  const double r = fmod(static_cast<double>(a), static_cast<double>(b));
  const double m = fabs(r);
  // a normal remainder, or NaN (a zero divisor, an infinite operand)
  if (!(m < 1.1754943508222875e-38)) return static_cast<float>(r);
  const int bits = static_cast<int>(m * 7.1362384635297994e+44);  // 2^149
  return __int_as_float(bits | (signbit(r) ? static_cast<int>(0x80000000u)
                                           : 0));
}

// jnp.mod on float32 as the reference's CPU computes it: C's fmodf of the
// operand over the flushed divisor (the remainder exact, not flushed),
// then the divisor added when the flushed remainder's sign differs from it
__device__ __forceinline__ float fmod_floor(float a, float b) {
  const float fb = ftz(b);
  const float t = fmod_exact(a, fb);
  const float tz = ftz(t);
  const bool plus = ((tz < 0.f) != (fb < 0.f)) && tz != 0.f;
  return plus ? ftz(__fadd_rn(tz, fb)) : t;
}

// One program: 0 or 1 (or the word of a literal-only program). `evt(arg)`
// and `cap(arg)` are the two load kinds. The top of the stack lives in a
// register, the values under it in `st` (this thread's column of a
// [depth][T] array).
template <class Evt, class Cap>
__device__ __forceinline__ int run_program(const int* __restrict__ code,
                                           int len, Evt evt, Cap cap,
                                           int* st, int T) {
  int sp = 0;
  int top = 0;
  for (int pc = 0; pc < len; ++pc) {
    const int w = __ldg(code + pc);
    const int op = w & 0xff;
    const int arg = w >> 8;
    if (op <= kCap) {  // a load: push
      st[sp * T] = top;
      ++sp;
      top = op == kLit ? __ldg(code + ++pc) : op == kEvt ? evt(arg)
                                                         : cap(arg);
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
      --sp;
      const int a = st[sp * T];
      const int b = top;
      const float fa = f32(ftz_w(a)), fb = f32(ftz_w(b));
      switch (op) {
        case kAddI: top = static_cast<int>(u32(a) + u32(b)); break;
        case kSubI: top = static_cast<int>(u32(a) - u32(b)); break;
        case kMulI: top = static_cast<int>(u32(a) * u32(b)); break;
        case kAddF: top = ftz_w(w32(__fadd_rn(fa, fb))); break;
        case kSubF: top = ftz_w(w32(__fsub_rn(fa, fb))); break;
        case kMulF: top = ftz_w(w32(__fmul_rn(fa, fb))); break;
        case kDivI: top = floor_div(a, b); break;
        case kModI: top = floor_mod(a, b); break;
        case kDivF: top = ftz_w(w32(__fdiv_rn(fa, fb))); break;
        case kModF: top = w32(fmod_floor(f32(a), f32(b))); break;
        case kEqI: top = a == b; break;
        case kNeI: top = a != b; break;
        case kLtI: top = a < b; break;
        case kLeI: top = a <= b; break;
        case kGtI: top = a > b; break;
        case kGeI: top = a >= b; break;
        case kEqF: top = fa == fb; break;
        case kNeF: top = fa != fb; break;
        case kLtF: top = fa < fb; break;
        case kLeF: top = fa <= fb; break;
        case kGtF: top = fa > fb; break;
        case kGeF: top = fa >= fb; break;
        case kAnd: top = a & b; break;
        case kOr: top = a | b; break;
        default: top = 0;
      }
    }
  }
  return top;
}

}  // namespace fst_program
