// Distinct-value (salted bottom-k) tile merge for R lockstep reservoirs, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel reservoir_tpu/ops/distinct_pallas.py:_kernel (entry
// point update_pallas).  It computes the same function as the plain version,
// reservoir_tpu_torch/ops/distinct.py:update: row r keeps the k distinct
// values with the smallest scrambled hashes, sorted by (hash_hi, hash_lo,
// value_hi, value_lo), padding (MAX, MAX)/0 past size.  A lane is a candidate
// when its hash is strictly below the row's last entry (so a hash of exactly
// (MAX, MAX) is never taken); a candidate already held is skipped, any other
// is inserted at its lexicographic rank and the last entry drops.  Because
// the scramble is a permutation of the 64-bit value, distinct values never
// share a hash, and the result is a function of the set of values seen: the
// order in which candidates are taken does not change it.  Unlike the TPU
// kernel it takes a per-row valid count, so ragged tiles run here too.
//
// Design.  One warp per reservoir row, up to four rows a block.  The warp
// walks the row's lanes 32 at a time: it loads each lane's value words (a
// narrow key's high word is the sign extension of its low word; a wide tile
// is read as the two stride-2 words of each int64, or as two planes),
// scrambles them under the row's salts, compares against the threshold and
// ballots.  The candidates of a chunk are taken in ballot order: each is
// broadcast, every lane of the chunk carrying the same (hash, value) is
// retired with it, and the warp counts the held entries below it and looks
// for an equal one (lane l reads entries l, l + 32, ...), then shifts the
// block up by one from the rank, 32 entries at a time, and writes the new
// entry.  The row's block (hash_hi, hash_lo, value_lo and, wide, value_hi)
// moves into shared memory at the row's first candidate and back at the end,
// so a row with no candidate reads only its last entry and a few words.
//
// Bound.  Every tile word must be read once (4 or 8 bytes a lane); per lane
// the scramble is ~64 integer operations (6 rounds of fmix32, an add and the
// Feistel xor, the salt xors) and the compare a few more.  A steady tile of
// the distinct benchmark (R = 4,096, B = 1,024, k = 256, Zipf keys) has few
// candidates, so it is bound by those operations, not by its 16 MiB of
// keys.  A tile from empty inserts about B entries a row, each a k-wide
// count and shift in shared memory: that tile is bound by the inserts.
// chip_smoke.py computes the bound from each run's counts (PERF.md).  What
// this simple design leaves on the table: a chunk's candidates are taken one
// at a time, each with a pass over the row's entries.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (see reservoir_tpu_torch/_build.py).  Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashing.cuh"

namespace dst {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 4;
constexpr int kMaxSmem = 232448;  // shared memory a block can use on sm_90

__device__ __forceinline__ bool lt64(uint32_t ah, uint32_t al, uint32_t bh, uint32_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

__device__ __forceinline__ uint32_t sign_hi(uint32_t lo) {
  return static_cast<uint32_t>(static_cast<int32_t>(lo) >> 31);
}

template <bool WIDE>
__global__ void __launch_bounds__(kMaxWarps * 32)
update_kernel(uint32_t* __restrict__ values, uint32_t* __restrict__ value_hi,
              uint32_t* __restrict__ hash_hi, uint32_t* __restrict__ hash_lo,
              int32_t* __restrict__ size, int32_t* __restrict__ count,
              const uint32_t* __restrict__ salts, const uint32_t* __restrict__ tile_lo,
              const uint32_t* __restrict__ tile_hi, int stride,
              const int32_t* __restrict__ valid, int R, int k, int B) {
  extern __shared__ uint32_t smem[];
  constexpr int kPlanes = WIDE ? 4 : 3;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= R) return;  // whole warps only: R rows, one warp each
  uint32_t* s_hh = smem + static_cast<size_t>(w) * kPlanes * k;
  uint32_t* s_hl = s_hh + k;
  uint32_t* s_vl = s_hl + k;
  uint32_t* s_vh = s_vl + k;  // used only for wide keys
  const size_t row = static_cast<size_t>(r) * k;
  const uint32_t r0h = salts[4 * r], r0l = salts[4 * r + 1];
  const uint32_t r1h = salts[4 * r + 2], r1l = salts[4 * r + 3];
  const int v = valid != nullptr ? valid[r] : B;
  int sz = size[r];
  // the threshold: the last entry, (MAX, MAX) while the row is not full
  uint32_t th = hash_hi[row + k - 1], tl = hash_lo[row + k - 1];
  bool held = false;  // the row's block is in shared memory
  const size_t base = static_cast<size_t>(r) * B;

  for (int off = 0; off < v; off += 32) {
    const int p = off + lane;
    const bool active = p < v;
    uint32_t lo = 0, hi = 0;
    if (active) {
      const size_t at = (base + p) * static_cast<size_t>(stride);
      lo = tile_lo[at];
      hi = WIDE ? tile_hi[at] : sign_hi(lo);
    }
    uint32_t sh = hi, sl = lo;
    dhash::scramble64(sh, sl, r0h, r0l, r1h, r1l);
    unsigned mask = __ballot_sync(kFull, active && lt64(sh, sl, th, tl));
    while (mask) {
      const int src = __ffs(mask) - 1;
      const uint32_t ch = __shfl_sync(kFull, sh, src), cl = __shfl_sync(kFull, sl, src);
      const uint32_t cvh = __shfl_sync(kFull, hi, src), cvl = __shfl_sync(kFull, lo, src);
      // the candidate and every lane of the chunk carrying the same key
      mask &= ~__ballot_sync(kFull, sh == ch && sl == cl && hi == cvh && lo == cvl);
      if (!lt64(ch, cl, th, tl)) continue;  // the threshold has tightened
      if (!held) {
        for (int i = lane; i < k; i += 32) {
          s_hh[i] = hash_hi[row + i];
          s_hl[i] = hash_lo[row + i];
          s_vl[i] = values[row + i];
          if (WIDE) s_vh[i] = value_hi[row + i];
        }
        __syncwarp();
        held = true;
      }
      // dedup and rank over the held entries (padding is never below a
      // candidate nor equal to it)
      int below = 0;
      bool same = false;
      for (int i = lane; i < sz; i += 32) {
        const uint32_t eh = s_hh[i], el = s_hl[i], evl = s_vl[i];
        const uint32_t evh = WIDE ? s_vh[i] : sign_hi(evl);
        const bool hash_eq = eh == ch && el == cl;
        same |= hash_eq && evh == cvh && evl == cvl;
        below += (lt64(eh, el, ch, cl) || (hash_eq && lt64(evh, evl, cvh, cvl))) ? 1 : 0;
      }
      if (__any_sync(kFull, same)) continue;
      const int pos = __reduce_add_sync(kFull, below);
      // entries pos .. last - 1 move up one; the entry at k - 1 drops when full
      const int last = sz < k ? sz : k - 1;
      for (int top = last; top > pos; top -= 32) {
        const int i = top - lane;
        const bool mv = i > pos;
        uint32_t a = 0, b = 0, c = 0, d = 0;
        if (mv) {
          a = s_hh[i - 1];
          b = s_hl[i - 1];
          c = s_vl[i - 1];
          if (WIDE) d = s_vh[i - 1];
        }
        __syncwarp();
        if (mv) {
          s_hh[i] = a;
          s_hl[i] = b;
          s_vl[i] = c;
          if (WIDE) s_vh[i] = d;
        }
        __syncwarp();
      }
      if (lane == 0) {
        s_hh[pos] = ch;
        s_hl[pos] = cl;
        s_vl[pos] = cvl;
        if (WIDE) s_vh[pos] = cvh;
      }
      __syncwarp();
      sz = sz < k ? sz + 1 : k;
      th = s_hh[k - 1];
      tl = s_hl[k - 1];
    }
  }
  if (held) {
    for (int i = lane; i < k; i += 32) {
      hash_hi[row + i] = s_hh[i];
      hash_lo[row + i] = s_hl[i];
      values[row + i] = s_vl[i];
      if (WIDE) value_hi[row + i] = s_vh[i];
    }
  }
  if (lane == 0) {
    size[r] = sz;
    count[r] = static_cast<int32_t>(static_cast<uint32_t>(count[r]) + static_cast<uint32_t>(v));
  }
}

template <bool WIDE>
int launch(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi, uint32_t* hash_lo,
           int32_t* size, int32_t* count, const uint32_t* salts, const uint32_t* tile_lo,
           const uint32_t* tile_hi, int stride, const int32_t* valid, int R, int k, int B,
           cudaStream_t stream) {
  const size_t per_warp = static_cast<size_t>(WIDE ? 4 : 3) * k * sizeof(uint32_t);
  if (per_warp > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  int warps = static_cast<int>(kMaxSmem / per_warp);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        update_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (R + warps - 1) / warps;
  update_kernel<WIDE><<<blocks, warps * 32, smem, stream>>>(
      values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo, tile_hi, stride, valid, R,
      k, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dst

extern "C" {

// One distinct tile merge, in place.  value_hi and tile_hi are null for
// narrow keys.  Lane p of row r is word (r * B + p) * stride of tile_lo (and
// tile_hi).  valid may be null (every row takes B).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue when a row's
// block does not fit in shared memory.
int distinct_update(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi, uint32_t* hash_lo,
                    int32_t* size, int32_t* count, const uint32_t* salts,
                    const uint32_t* tile_lo, const uint32_t* tile_hi, int stride,
                    const int32_t* valid, int R, int k, int B, cudaStream_t stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (value_hi != nullptr)
    return dst::launch<true>(values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo,
                             tile_hi, stride, valid, R, k, B, stream);
  return dst::launch<false>(values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo,
                            tile_hi, stride, valid, R, k, B, stream);
}

const char* distinct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
