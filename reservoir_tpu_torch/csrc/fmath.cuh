// float32 log / exp / log1p, bit-identical to XLA CPU's and to
// reservoir_tpu_torch/ops/fmath.py.
//
// Every step is one IEEE operation spelled as an intrinsic (__fmaf_rn,
// __fmul_rn, __fadd_rn, __fdiv_rn), so no compiler contraction can change a
// rounding; the library is also built with --fmad=false.  XLA CPU runs with
// denormals flushed to zero, so the same flushes are written out here: a
// denormal log or log1p input becomes a signed zero and a denormal exp
// result becomes 0.  A NaN result is XLA's all-ones NaN.
#pragma once

#include <cstdint>

namespace algl {

__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }

#define ALGL_FLT_MIN f32(0x00800000u)
#define ALGL_INF f32(0x7F800000u)
#define ALGL_NAN f32(0xFFFFFFFFu)  // XLA CPU's NaN

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < ALGL_FLT_MIN ? __fmul_rn(x, 0.0f) : x;
}

// XLA's log polynomial of a normal, positive, finite float: xla_log
// without its flush, clamp and special cases, which such an x never takes.
__device__ __forceinline__ float log_normal(float xc) {
  const uint32_t b = __float_as_uint(xc);
  float e = __fadd_rn(static_cast<float>(static_cast<int>(b >> 23) - 127), 1.0f);
  const float m = __uint_as_float((b & 0x807FFFFFu) | 0x3F000000u);
  float xm;
  if (m < f32(0x3F3504F3u)) {  // sqrt(1/2)
    e = __fadd_rn(e, -1.0f);
    xm = __fadd_rn(__fadd_rn(m, -1.0f), m);
  } else {
    xm = __fadd_rn(m, -1.0f);
  }
  const float x2 = __fmul_rn(xm, xm);
  const float x3 = __fmul_rn(x2, xm);
  float y = __fmaf_rn(xm, f32(0x3D9021BBu), f32(0xBDEBD1B8u));
  float y1 = __fmaf_rn(xm, f32(0xBDFE5D4Fu), f32(0x3E11E9BFu));
  float y2 = __fmaf_rn(xm, f32(0x3E4CCEACu), f32(0xBE7FFFFCu));
  y = __fmaf_rn(y, xm, f32(0x3DEF251Au));
  y1 = __fmaf_rn(y1, xm, f32(0xBE2AAE50u));
  y2 = __fmaf_rn(y2, xm, f32(0x3EAAAAAAu));
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(f32(0xB95E8083u), e));
  float r = __fmaf_rn(-0.5f, x2, xm);
  r = __fadd_rn(r, y);
  return __fmaf_rn(f32(0x3F318000u), e, r);
}

__device__ __forceinline__ float xla_log(float x) {
  x = flush(x);
  float r = log_normal(x > ALGL_FLT_MIN ? x : ALGL_FLT_MIN);
  if (x < ALGL_FLT_MIN) r = -ALGL_INF;  // zeros
  if (x == ALGL_INF) r = ALGL_INF;
  if (x < 0.0f || isnan(x)) r = ALGL_NAN;
  return r;
}

__device__ __forceinline__ float xla_exp(float x) {
  const float lo = f32(0xC2AF999Au), hi = f32(0x42B1999Au);
  x = x < lo ? lo : (x > hi ? hi : x);  // NaN passes through
  float n = floorf(__fmaf_rn(x, f32(0x3FB8AA3Bu), 0.5f));
  n = n < -127.0f ? -127.0f : (n > 127.0f ? 127.0f : n);
  float r = __fmaf_rn(-f32(0x3F318000u), n, x);
  r = __fmaf_rn(-f32(0xB95E8083u), n, r);
  float y = __fmaf_rn(r, f32(0x39506967u), f32(0x3AB743CEu));
  y = __fmaf_rn(y, r, f32(0x3C088908u));
  y = __fmaf_rn(y, r, f32(0x3D2AA9C1u));
  y = __fmaf_rn(y, r, f32(0x3E2AAAAAu));
  y = __fmaf_rn(y, r, 0.5f);
  y = __fmaf_rn(y, __fmul_rn(r, r), r);
  y = __fadd_rn(y, 1.0f);
  const float scale = __int_as_float((static_cast<int>(n) + 127) << 23);
  return flush(__fmul_rn(y, scale));
}

__device__ __forceinline__ float xla_log1p(float x) {
  x = flush(x);
  const float z = __fmul_rn(x, 0.0f);
  float q = __fadd_rn(z, 1.0f);
  q = __fmaf_rn(q, x, f32(0x417101ADu));
  q = __fmaf_rn(q, x, f32(0x42A6185Bu));
  q = __fmaf_rn(q, x, f32(0x435DC32Du));
  q = __fmaf_rn(q, x, f32(0x439A8CA3u));
  q = __fmaf_rn(q, x, f32(0x43586D8Au));
  q = __fmaf_rn(q, x, f32(0x42707982u));
  float p = __fadd_rn(z, f32(0x383DE04Bu));
  p = __fmaf_rn(p, x, f32(0x3EFF40C5u));
  p = __fmaf_rn(p, x, f32(0x40D284FAu));
  p = __fmaf_rn(p, x, f32(0x41EF4B9Cu));
  p = __fmaf_rn(p, x, f32(0x4273CC76u));
  p = __fmaf_rn(p, x, f32(0x426473ADu));
  p = __fmaf_rn(p, x, f32(0x41A05101u));
  if (fabsf(x) < f32(0x3ED413CDu)) {
    const float x2 = __fmul_rn(x, x);
    const float t = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q));
    return __fadd_rn(x, __fmaf_rn(-0.5f, x2, t));
  }
  return xla_log(__fadd_rn(x, 1.0f));
}

}  // namespace algl
