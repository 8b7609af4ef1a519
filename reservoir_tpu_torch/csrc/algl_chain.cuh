// The Algorithm-L skip chain: one acceptance's draws and the update of
// log W and nxt (the port of ops/algorithm_l.py:_advance_words, and of
// _advance_pair for WIDE counters).
//
// One copy for every caller: the tile update and the gated update of
// algorithm_l.cu, and the skip gate's host replica
// (_native/skip_gate.cc), which compiles this header for the CPU through
// a shim of the intrinsics (each one IEEE operation there too, with
// -ffp-contract=off), so the host and the card walk the same chain bit for
// bit.
#pragma once

#include <cstdint>

#include "fmath.cuh"
#include "threefry.cuh"

namespace algl {

constexpr int32_t kInt32Max = 2147483647;

// a % d for every uint32 a, given m = 2^64 / d rounded up (Lemire, Kaser and
// Kurz, "Faster remainder by direct computation", 2019)
__device__ __forceinline__ uint32_t fastmod(uint32_t a, uint64_t m, uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(m * a, d));
}

// One acceptance's draws w: returns the slot, advances log_w, and returns
// floor(log(u2) / log(1 - W)) as a float, unclamped.
__device__ __forceinline__ float skip_draw(float& log_w, const uint32_t w[3], uint32_t k,
                                           uint64_t kmod, float inv_k, int32_t& slot) {
  const float u1 = uniform_from_word(w[0]);
  const float u2 = uniform_from_word(w[1]);
  slot = static_cast<int32_t>(fastmod(w[2], kmod, k));
  // XLA folds log(u1) / k into fma(log(u1), 1/k, log_w), 1/k in float32.
  // u1 and u2 lie in [2^-24, 1] (rng.uniform_from_bits), where xla_log takes
  // none of its special cases: log_normal is xla_log there.
  log_w = __fmaf_rn(log_normal(u1), inv_k, log_w);
  const float wv = xla_exp(log_w);
  return floorf(__fdiv_rn(log_normal(u2), xla_log1p(-wv)));
}

// One acceptance at absolute index nxt: returns the slot, advances log_w
// and nxt (the port of ops/algorithm_l.py:_advance_words).
__device__ __forceinline__ int32_t advance(float& log_w, int32_t& nxt, uint32_t k1, uint32_t k2,
                                           uint32_t k, uint64_t kmod, float inv_k) {
  uint32_t w[3];
  accept_words(k1, k2, static_cast<uint32_t>(nxt), w);
  int32_t slot;
  float skip_f = skip_draw(log_w, w, k, kmod, inv_k, slot);
  // min(skip_f, 2^30) that keeps NaN, as jnp.minimum and torch.minimum do
  if (skip_f > 1073741824.0f) skip_f = 1073741824.0f;
  // float -> int32 as XLA converts: NaN gives 0
  const int32_t skip = isnan(skip_f) ? 0 : static_cast<int32_t>(skip_f);
  const int32_t headroom = kInt32Max - skip - 1;
  nxt = nxt > headroom ? kInt32Max : nxt + skip + 1;
  return slot;
}

// float -> uint32 as XLA converts: NaN gives 0, out-of-range values
// saturate (a C++ cast of either is undefined)
__device__ __forceinline__ uint32_t f32_to_u32(float x) {
  if (!(x > 0.0f)) return 0u;  // NaN, zeros and negatives
  if (x >= 4294967296.0f) return 0xFFFFFFFFu;
  return static_cast<uint32_t>(x);
}

// a + floor(f) for a float f < 2^63 (the port of u64e.add_f32): max(f, 0)
// keeping NaN, then the exact float32 split of f into hi * 2^32 + rem
__device__ __forceinline__ uint64_t add_f32(uint64_t a, float f) {
  if (f < 0.0f) f = 0.0f;
  const float hi_f = floorf(__fmul_rn(f, 2.3283064365386963e-10f));  // f * 2^-32
  const float rem = __fadd_rn(f, -__fmul_rn(hi_f, 4294967296.0f));
  const uint32_t a_lo = static_cast<uint32_t>(a);
  const uint32_t lo = a_lo + f32_to_u32(rem);
  const uint32_t hi = static_cast<uint32_t>(a >> 32) + f32_to_u32(hi_f) + (lo < a_lo ? 1u : 0u);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// advance for a WIDE (64-bit) nxt (the port of _advance_pair): the draws
// keyed on the index block (hi, lo), the skip clamped at 2^62 and added
// exactly, so nxt never saturates.
__device__ __forceinline__ int32_t advance_wide(float& log_w, uint64_t& nxt, uint32_t k1,
                                                uint32_t k2, uint32_t k, uint64_t kmod,
                                                float inv_k) {
  uint32_t w[3];
  accept_words_pair(k1, k2, static_cast<uint32_t>(nxt >> 32), static_cast<uint32_t>(nxt), w);
  int32_t slot;
  float skip_f = skip_draw(log_w, w, k, kmod, inv_k, slot);
  // min(skip_f, 2^62) that keeps NaN
  if (skip_f > 4611686018427387904.0f) skip_f = 4611686018427387904.0f;
  nxt = add_f32(nxt + 1u, skip_f);
  return slot;
}

// The multiplier of fastmod for the divisor k (>= 1).
inline uint64_t fastmod_multiplier(uint32_t k) { return ~uint64_t{0} / k + 1u; }

}  // namespace algl
