// Threefry-2x32 (20 rounds), the cipher behind jax.random's threefry keys.
// Word for word the same as reservoir_tpu_torch/ops/threefry.py.
#pragma once

#include <cstdint>

namespace algl {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Hash the block (x0, x1) under the key (k1, k2).
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& out0, uint32_t& out1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[group % 2][i]) ^ x0;
    }
    x0 += ks[(group + 1) % 3];
    x1 += ks[(group + 2) % 3] + static_cast<uint32_t>(group + 1);
  }
  out0 = x0;
  out1 = x1;
}

// Word j of the bits of the folded key (f1, f2): xor of threefry(f, (0, j)).
__device__ __forceinline__ uint32_t bits_word(uint32_t f1, uint32_t f2, uint32_t j) {
  uint32_t b0, b1;
  threefry2x32(f1, f2, 0u, j, b0, b1);
  return b0 ^ b1;
}

// The three words drawn for the acceptance at the absolute 64-bit index
// (idx_hi, idx_lo): key' = threefry(key, (idx_hi, idx_lo)), then word j =
// xor of threefry(key', (0, j)).
__device__ __forceinline__ void accept_words_pair(uint32_t k1, uint32_t k2, uint32_t idx_hi,
                                                  uint32_t idx_lo, uint32_t w[3]) {
  uint32_t f1, f2;
  threefry2x32(k1, k2, idx_hi, idx_lo, f1, f2);
#pragma unroll
  for (uint32_t j = 0; j < 3; ++j) w[j] = bits_word(f1, f2, j);
}

// The three words drawn for the acceptance at absolute index idx (< 2^32).
__device__ __forceinline__ void accept_words(uint32_t k1, uint32_t k2,
                                             uint32_t idx, uint32_t w[3]) {
  accept_words_pair(k1, k2, 0u, idx, w);
}

// (0, 1] uniform of a word, exactly as rng.uniform_from_bits: (w >> 8 + 1) * 2^-24.
__device__ __forceinline__ float uniform_from_word(uint32_t w) {
  return __fmul_rn(__fadd_rn(static_cast<float>(static_cast<int32_t>(w >> 8)), 1.0f),
                   5.9604644775390625e-08f);
}

}  // namespace algl
