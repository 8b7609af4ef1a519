// The draws of the uniform merge for R rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes these draws in XLA, as one
// lax.scan (reservoir_tpu/ops/algorithm_l.py:567, its step :547-565, with
// _randint_exact :631) and the uniforms of _masked_perm (:718), inside
// merge_samples.  The port's plain version is
// reservoir_tpu_torch/ops/algorithm_l.py:merge_draws, whose scan is k
// lockstep steps of small launches with a host sync each; this kernel draws
// the same words in one launch.  Per row r of a merge of [R, k] samples,
// with the row's key (k1, k2) and counts c_a, c_b:
// - the hypergeometric scan: m = min((c_a + c_b) mod 2^32, k) steps; step
//   t hashes fold_in(key, t), draws an exact uniform integer x in
//   [0, denom) with denom = max((rem_a + rem_b) mod 2^32, 1) by rejection
//   (attempt a is b0 ^ b1 of Threefry block (1, a), accepted below the
//   largest multiple of denom in the word space), and takes from A iff
//   x < rem_a; j_a is the number taken from A.  All of it is uint32
//   arithmetic, so a total past 2^32 wraps as the reference's does;
// - the permutation keys: word j of bits(fold_in(key, k)) (A) and of
//   bits(fold_in(key, k + 1)) (B), each mapped to (w >> 9) * 2^-23, +inf at
//   or past the side's size min(count, k), the count read as int32 where
//   the row's signed flag for the side is set (an int32 count past
//   2^31 - 1 is negative and masks every slot), as uint32 elsewhere.
// The stable argsort of the keys and the gather of the samples stay torch
// (ops/algorithm_l.py:merge_from_draws), as the reference leaves them to
// XLA's sort.
//
// Bound.  Operations: a Threefry block's 20 rounds each rotate and xor,
// 40 operations that only the INT32 pipe issues (its ~32 adds may also
// issue to the FMA pipe, as IMAD); per row, each active step hashes the
// fold and one block an attempt (each rejected attempt counted), and each
// of the 2k key words one block, with the side's fold.  At R = 65,536,
// k = 128 that is ~1.4e9 such operations, ~0.08 ms at 64 INT32 lanes x 132
// SMs x 1.98 GHz; the adds are left out, so this is a floor.
// chip_smoke.merge_bound_ms adds each step's remainders, counted on the
// build's SASS (chip_smoke.remainder_ops).  Bytes: the counts, flags and
// keys (17 a row) read, j_a and the 2 R k keys (8 k a row) written: ~67 MB,
// ~0.02 ms.  chip_smoke.py reports the measured time beside the bound it
// computes from the run's own draws.
//
// Design.  One launch, two kinds of block.  The scan's randomness does not
// depend on its carry: every active step takes exactly one element, from A
// or from B, so rem_a + rem_b falls by exactly 1 a step (mod 2^32, or 2^64
// for WIDE counts) whichever side is taken and whether or not a side
// wrapped.  So step t's denominator is total - t (>= 1 for t < m <= total),
// and its fold, its rejection attempts and its draw x_t are all fixed
// before the scan starts; only take_t = x_t < rem_a, rem_a -= take_t, is
// serial.  The first ceil(R / kRows) blocks each take kRows rows: all
// kThreads threads draw the x_t of every (row, step) of a chunk of kSteps
// steps into shared memory, in parallel (a warp a step, a lane a row), and
// then the first warp walks the compare chain, a lane a row, over the
// chunk; a longer scan takes further chunks.  The other blocks write the
// 2 R k key words fully parallel: a thread hashes one fold and kWords
// consecutive words of one row and side, and stores them as 16-byte words
// where k is a multiple of 4.  The scan blocks come first in the grid.
// The operations are the one-thread-a-row scan's, and on an H100 the
// integer pipe, not the scan's critical path, sets the pace: a Threefry
// round is an add, a rotation and an xor, and the compiler issues most
// adds there too.  So the blocks here add on the FMA pipe (block(),
// add_on_fma), and a key thread hashes 16 words a fold, not 8.  A warp a
// row, with the chain walked by ballots, ran slower (PERF.md, Findings), as
// did the earlier design, one thread a row walking its m steps alone.
//
// WIDE counts (algl_merge_draws_wide).  The same kernel instantiated for
// 64-bit counts (ops/u64e.py's [R, 2] uint32 (lo, hi) words, read in place
// as little-endian uint64), the port of the reference's one_wide step
// (reservoir_tpu/ops/algorithm_l.py:573-603) with _randint_exact_u64e
// (:680-715), which the reference also computes in XLA: the remainders,
// their sum and the denominator are uint64 (wrapping mod 2^64), m =
// min(total, k) unsigned; an attempt draws the 64-bit word (b0 << 32) | b1
// of block (1, a) (u64e.make(b1, b0)), accepted below 2^64 - (2^64 mod
// denom), and both remainders are the native 64-bit %, which equals
// u64e.mod64's restoring division; a side's size is min(count, k),
// unsigned (no signed flags).  The permutation keys are the narrow ones,
// and the chain compares and subtracts 64-bit words (x_t is kept as one).
// Bound: as the narrow kernel's, with 8-byte counts (R(28 + 8k) bytes) and
// two 64-bit remainders a step in place of three 32-bit ones.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (see reservoir_tpu_torch/_build.py).  Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "kinfo.cuh"
#include "threefry.cuh"

namespace algl_merge {

constexpr int kThreads = 256;
constexpr int kRows = 32;     // rows a scan block: a lane each
constexpr int kSteps = 128;   // steps of a chunk: the draws a scan block keeps in shared memory
constexpr int kWords = 16;    // key words a thread of a key block writes
static_assert(kRows == 32 && kThreads % kRows == 0, "a warp draws one step of every row of its block");

// a * one + b as one multiply-add (IMAD, on the FMA pipe); one is 1, but
// the compiler cannot know it, so it cannot turn this back into an add
__device__ __forceinline__ uint32_t add_on_fma(uint32_t a, uint32_t b, uint32_t one) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
  return d;
}

// Threefry-2x32, word for word algl::threefry2x32, with each round's add
// issued as a multiply-add by `one` (add_on_fma): the rotations and xors
// alone keep the integer pipe busy, and the adds go beside them to the FMA
// pipe, which this kernel leaves idle otherwise.
__device__ __forceinline__ void block(uint32_t k1, uint32_t k2, uint32_t x0, uint32_t x1, uint32_t& out0,
                                      uint32_t& out1, uint32_t one) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 = add_on_fma(x1, x0, one);
      x1 = algl::rotl32(x1, rot[group % 2][i]) ^ x0;
    }
    x0 += ks[(group + 1) % 3];
    x1 += ks[(group + 2) % 3] + static_cast<uint32_t>(group + 1);
  }
  out0 = x0;
  out1 = x1;
}

// The exact uniform integer in [0, denom) of the folded key (f1, f2) (the
// port of _randint_exact); denom >= 1.
__device__ __forceinline__ uint32_t randint_exact(uint32_t f1, uint32_t f2, uint32_t denom, uint32_t one) {
  // 2^32 mod denom; 0 when denom divides 2^32, which accepts every word
  const uint32_t space_mod = (0xFFFFFFFFu % denom + 1u) % denom;
  const uint32_t thresh = 0u - space_mod;
  uint32_t bits;
  for (uint32_t a = 0;; ++a) {
    uint32_t b0, b1;
    block(f1, f2, 1u, a, b0, b1, one);
    bits = b0 ^ b1;
    if (space_mod == 0u || bits < thresh) break;
  }
  return bits % denom;
}

// The exact uniform integer in [0, denom) for a 64-bit denom >= 1 (the port
// of _randint_exact_u64e): attempt a is the word (b0 << 32) | b1.
__device__ __forceinline__ uint64_t randint_exact(uint32_t f1, uint32_t f2, uint64_t denom, uint32_t one) {
  // 2^64 mod denom, as (2^64 - denom) mod denom
  const uint64_t space_mod = (0ull - denom) % denom;
  const uint64_t thresh = 0ull - space_mod;
  uint64_t bits;
  for (uint32_t a = 0;; ++a) {
    uint32_t b0, b1;
    block(f1, f2, 1u, a, b0, b1, one);
    bits = (static_cast<uint64_t>(b0) << 32) | b1;
    if (space_mod == 0u || bits < thresh) break;
  }
  return bits % denom;
}

// A row's counts: uint32 words, or uint64 for WIDE counts.
template <bool kWide>
using Count = typename std::conditional<kWide, uint64_t, uint32_t>::type;

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
draws_kernel(const Count<kWide>* __restrict__ count_a, const Count<kWide>* __restrict__ count_b,
             const uint8_t* __restrict__ signed_rows, const uint32_t* __restrict__ key,
             int32_t* __restrict__ j_a, float* __restrict__ u_a, float* __restrict__ u_b, int R, int k,
             int scan_blocks, int vec) {
  using C = Count<kWide>;
  const uint32_t one = blockDim.x / kThreads;  // 1, unknown to the compiler (add_on_fma)
  if (static_cast<int>(blockIdx.x) < scan_blocks) {
    __shared__ C draws[kSteps][kRows];  // x_t of step t0 + i of row `lane`: draws[i][lane]
    __shared__ uint32_t longest;        // the block's most steps
    const int lane = threadIdx.x % kRows;
    const int warp = threadIdx.x / kRows;
    const int r = blockIdx.x * kRows + lane;
    C c_a = 0, c_b = 0;
    uint32_t k1 = 0, k2 = 0;
    if (r < R) {
      c_a = count_a[r];
      c_b = count_b[r];
      k1 = key[2 * r];
      k2 = key[2 * r + 1];
    }
    const C total = c_a + c_b;  // wraps as the reference's uint32 (or u64e) sum
    const uint32_t m = total < static_cast<C>(k) ? static_cast<uint32_t>(total) : static_cast<uint32_t>(k);
    if (warp == 0) {
      uint32_t most = m;
#pragma unroll
      for (int off = kRows / 2; off > 0; off /= 2) most = max(most, __shfl_xor_sync(0xFFFFFFFFu, most, off));
      if (lane == 0) longest = most;
    }
    __syncthreads();
    const uint32_t steps = longest;
    C rem_a = c_a;  // the chain's carry, in the first warp
    int32_t taken = 0;
    for (uint32_t t0 = 0; t0 < steps; t0 += kSteps) {
      // draw: warp w takes steps t0 + w, t0 + w + kThreads / kRows, ...
      for (int i = warp; i < kSteps; i += kThreads / kRows) {
        const uint32_t t = t0 + i;
        if (t < m) {
          uint32_t f1, f2;
          block(k1, k2, 0u, t, f1, f2, one);  // fold_in(key, t)
          const C denom = total - static_cast<C>(t);   // rem_a + rem_b at step t, >= 1
          draws[i][lane] = randint_exact(f1, f2, denom == 0u ? C{1} : denom, one);
        }
      }
      __syncthreads();
      // walk: take from A iff x_t < rem_a
      if (warp == 0 && m > t0) {
        const uint32_t n = min(m - t0, static_cast<uint32_t>(kSteps));
#pragma unroll 8
        for (uint32_t i = 0; i < n; ++i) {
          const bool take = draws[i][lane] < rem_a;
          rem_a -= static_cast<C>(take);
          taken += take;
        }
      }
      __syncthreads();
    }
    if (warp == 0 && r < R) j_a[r] = taken;
    return;
  }
  // a key block: thread i writes words c * kWords .. of row r, side s
  const int chunks = (k + kWords - 1) / kWords;
  const int64_t i = static_cast<int64_t>(blockIdx.x - scan_blocks) * kThreads + threadIdx.x;
  if (i >= 2 * static_cast<int64_t>(R) * chunks) return;
  const int side = static_cast<int>(i / (static_cast<int64_t>(R) * chunks));
  const int64_t rc = i - static_cast<int64_t>(side) * R * chunks;
  const int r = static_cast<int>(rc / chunks);
  const int j0 = static_cast<int>(rc - static_cast<int64_t>(r) * chunks) * kWords;
  const C c = (side == 0 ? count_a : count_b)[r];
  // the side's size, its count read as the row's flag says: a negative
  // int32 masks every slot; a WIDE count is unsigned
  int64_t size;
  if constexpr (kWide)
    size = c < static_cast<C>(k) ? static_cast<int64_t>(c) : k;
  else
    size = ((signed_rows[r] >> side) & 1) ? static_cast<int64_t>(static_cast<int32_t>(c))
                                          : static_cast<int64_t>(c);
  uint32_t f1, f2;
  block(key[2 * r], key[2 * r + 1], 0u, static_cast<uint32_t>(k + side), f1, f2, one);
  float u[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int j = j0 + q;
    uint32_t b0, b1;
    block(f1, f2, 0u, static_cast<uint32_t>(j), b0, b1, one);  // word j of bits(f)
    const uint32_t w = b0 ^ b1;
    u[q] = j < size ? __fmul_rn(static_cast<float>(w >> 9), 1.1920928955078125e-07f)
                    : __int_as_float(0x7F800000);
  }
  float* out = (side == 0 ? u_a : u_b) + static_cast<size_t>(r) * k + j0;
  if (vec && j0 + kWords <= k) {
#pragma unroll
    for (int q = 0; q < kWords; q += 4)
      *reinterpret_cast<float4*>(out + q) = make_float4(u[q], u[q + 1], u[q + 2], u[q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      if (j0 + q < k) out[q] = u[q];
  }
}

inline int n_scan_blocks(int R) { return (R + kRows - 1) / kRows; }

inline int64_t key_blocks(int R, int k) {
  const int64_t threads = 2 * static_cast<int64_t>(R) * ((k + kWords - 1) / kWords);
  return (threads + kThreads - 1) / kThreads;
}

template <bool kWide>
int launch_draws(const Count<kWide>* count_a, const Count<kWide>* count_b,
                 const uint8_t* signed_rows, const uint32_t* key, int32_t* j_a, float* u_a,
                 float* u_b, int R, int k, cudaStream_t stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = n_scan_blocks(R) + key_blocks(R, k);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; };
  if (kWide && !(aligned(count_a, 8) && aligned(count_b, 8)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int vec = k % 4 == 0 && aligned(u_a, 16) && aligned(u_b, 16);
  draws_kernel<kWide><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      count_a, count_b, signed_rows, key, j_a, u_a, u_b, R, k, n_scan_blocks(R), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace algl_merge

extern "C" {

// The draws of a merge of [R, k] samples: j_a [R] int32, u_a and u_b
// [R, k] float32, from the counts [R] (uint32 words), the rows' signed
// flags [R] (bit 0 reads count_a as int32, bit 1 count_b) and the row keys
// [R, 2] (uint32 words).  Returns cudaGetLastError() after the launch.
int algl_merge_draws(const uint32_t* count_a, const uint32_t* count_b, const uint8_t* signed_rows,
                     const uint32_t* key, int32_t* j_a, float* u_a, float* u_b, int R, int k,
                     cudaStream_t stream) {
  return algl_merge::launch_draws<false>(count_a, count_b, signed_rows, key, j_a, u_a, u_b, R, k,
                                         stream);
}

// algl_merge_draws for WIDE counts: count_a and count_b are [R] uint64 (the
// [R, 2] uint32 (lo, hi) words in place, 8-byte aligned); no signed flags.
int algl_merge_draws_wide(const uint64_t* count_a, const uint64_t* count_b, const uint32_t* key,
                          int32_t* j_a, float* u_a, float* u_b, int R, int k, cudaStream_t stream) {
  return algl_merge::launch_draws<true>(count_a, count_b, nullptr, key, j_a, u_a, u_b, R, k, stream);
}

// kinfo::query's five numbers of the draws kernel.
int algl_merge_kernel_info(int* out) {
  return kinfo::query(algl_merge::draws_kernel<false>, algl_merge::kThreads, 0, out);
}

// kinfo::query's five numbers of the WIDE draws kernel.
int algl_merge_wide_kernel_info(int* out) {
  return kinfo::query(algl_merge::draws_kernel<true>, algl_merge::kThreads, 0, out);
}

}  // extern "C"
