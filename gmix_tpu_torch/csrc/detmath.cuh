// Deterministic float32 math for the codec's kernels: device versions of
// gmix_tpu_torch/ops/sigmoid.py, op for op.
//
// Every function is built from operations that IEEE 754 rounds exactly
// (+, -, *, /, round-half-even, compares, integer bit operations), so the
// bits equal those of the torch versions on the CPU and on a GPU. Each float
// op goes through an intrinsic that the compiler never contracts into a
// fused multiply-add and never replaces by an approximation, whatever the
// build flags. Constants are written as the torch code has them: a double
// literal (or a double expression) rounded once to float.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gmix {

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, lo, hi) for finite x (fminf/fmaxf drop a NaN, torch keeps it)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

constexpr float kLogitEps = static_cast<float>(1e-4);
constexpr float kLogitHi = static_cast<float>(1.0 - 1e-4);
constexpr float kLog2e = static_cast<float>(1.4426950408889634);
constexpr float kLn2 = static_cast<float>(0.6931471805599453);
constexpr float kSqrt2 = static_cast<float>(1.4142135623730951);
// Cody-Waite split of ln2: hi exact in f32, hi + lo = ln2 to ~1e-11
constexpr float kLn2Hi = static_cast<float>(0.693359375);
constexpr float kLn2Lo = static_cast<float>(-2.12194440e-4);

// e**u * 2**n for |u| <= ln2/2 and integer-valued n in [-126, 126]:
// degree-7 Taylor + exact exponent-field scaling
__device__ __forceinline__ float exp_scaled(float u, float n) {
  float p = fadd(fmul(u, static_cast<float>(1.0 / 5040.0)), static_cast<float>(1.0 / 720.0));
  p = fadd(fmul(p, u), static_cast<float>(1.0 / 120));
  p = fadd(fmul(p, u), static_cast<float>(1.0 / 24));
  p = fadd(fmul(p, u), static_cast<float>(1.0 / 6));
  p = fadd(fmul(p, u), 0.5f);
  p = fadd(fmul(p, u), 1.0f);
  p = fadd(fmul(p, u), 1.0f);
  const int32_t bits = (static_cast<int32_t>(n) + 127) << 23;
  return fmul(p, __int_as_float(bits));
}

// 2**t for t in [-126, 126]
__device__ __forceinline__ float exp2_det(float t) {
  t = clampf(t, -126.0f, 126.0f);
  const float n = rintf(t);  // round half to even, as torch.round
  return exp_scaled(fmul(fsub(t, n), kLn2), n);
}

// e**x with a Cody-Waite reduction
__device__ __forceinline__ float exp_det(float x) {
  x = clampf(x, -87.0f, 87.0f);
  const float n = rintf(fmul(x, kLog2e));
  const float u = fsub(fsub(x, fmul(n, kLn2Hi)), fmul(n, kLn2Lo));
  return exp_scaled(u, n);
}

// log2(x) for finite x > 0: mantissa/exponent split by integer bit ops,
// ln(m) for m in [1/sqrt2, sqrt2) via the atanh series, degree 7
__device__ __forceinline__ float log2_det(float x) {
  const int32_t xb = __float_as_int(x);
  int32_t e = ((xb >> 23) & 0xFF) - 127;
  float m = __int_as_float((xb & 0x007FFFFF) | 0x3F800000);  // [1, 2)
  const bool big = m > kSqrt2;
  m = big ? fmul(m, 0.5f) : m;
  e += big ? 1 : 0;
  const float z = fdiv(fsub(m, 1.0f), fadd(m, 1.0f));
  const float z2 = fmul(z, z);
  float p = fadd(fmul(z2, static_cast<float>(2.0 / 7.0)), static_cast<float>(2.0 / 5.0));
  p = fadd(fmul(p, z2), static_cast<float>(2.0 / 3.0));
  p = fadd(fmul(p, z2), 2.0f);
  const float lnm = fmul(p, z);
  return fadd(static_cast<float>(e), fmul(lnm, kLog2e));
}

__device__ __forceinline__ float log_det(float x) { return fmul(log2_det(x), kLn2); }

// x**a for x > 0
__device__ __forceinline__ float pow_det(float x, float a) { return exp2_det(fmul(log2_det(x), a)); }

__device__ __forceinline__ float logistic(float x) { return fdiv(1.0f, fadd(1.0f, exp_det(-x))); }

// tanh(x) as 1 - 2/(e**2x + 1)
__device__ __forceinline__ float tanh_det(float x) {
  return fsub(1.0f, fdiv(2.0f, fadd(exp_det(fadd(x, x)), 1.0f)));
}

// the correctly rounded float32 square root: the float64 root rounded once
__device__ __forceinline__ float sqrt_det(float x) {
  return __double2float_rn(__dsqrt_rn(static_cast<double>(x)));
}

__device__ __forceinline__ float clamp_prob(float p) { return clampf(p, kLogitEps, kLogitHi); }

__device__ __forceinline__ float logit(float p) {
  p = clamp_prob(p);
  return log_det(fdiv(p, fsub(1.0f, p)));
}

}  // namespace gmix
