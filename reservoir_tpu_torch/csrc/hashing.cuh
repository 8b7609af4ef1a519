// The salted 64-bit scramble of distinct mode, on uint32 words.
//
// The same function as reservoir_tpu_torch/ops/hashing.py (and the JAX
// package's ops/hashing.py): a 6-round Feistel permutation of (hi, lo) with
// murmur3's fmix32 as the round function, the salt r0 xored in before the
// first round and r1 before the fourth.  All arithmetic is modular uint32.

#pragma once

#include <cstdint>

namespace dhash {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// one Feistel round: (hi, lo) -> (lo, hi ^ fmix32(lo + c))
__device__ __forceinline__ void feistel(uint32_t& hi, uint32_t& lo, uint32_t c) {
  const uint32_t t = hi ^ fmix32(lo + c);
  hi = lo;
  lo = t;
}

__device__ __forceinline__ void scramble64(uint32_t& hi, uint32_t& lo, uint32_t r0_hi,
                                           uint32_t r0_lo, uint32_t r1_hi, uint32_t r1_lo) {
  hi ^= r0_hi;
  lo ^= r0_lo;
  feistel(hi, lo, 0x9E3779B9u);
  feistel(hi, lo, 0x85EBCA6Bu);
  feistel(hi, lo, 0xC2B2AE35u);
  hi ^= r1_hi;
  lo ^= r1_lo;
  feistel(hi, lo, 0x27D4EB2Fu);
  feistel(hi, lo, 0x165667B1u);
  feistel(hi, lo, 0x9E3779B1u);
}

}  // namespace dhash
