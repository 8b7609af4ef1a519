// Distinct-value (salted bottom-k) tile merge for R lockstep reservoirs, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel reservoir_tpu/ops/distinct_pallas.py:_kernel (entry
// point update_pallas).  It computes the same function as the plain version,
// reservoir_tpu_torch/ops/distinct.py:update: row r keeps the k distinct
// values with the smallest scrambled hashes, sorted by (hash_hi, hash_lo,
// value_hi, value_lo), padding (MAX, MAX)/0 past size.  A lane is a candidate
// when its hash is strictly below the row's last entry (so a hash of exactly
// (MAX, MAX) is never taken).  Because the scramble is a permutation of the
// 64-bit value, distinct values never share a hash: the hash alone orders
// and identifies the entries, and the result is a function of the set of
// values seen, so candidates may be taken in any order and many at a time.
// Unlike the TPU kernel it takes a per-row valid count, so ragged tiles run
// here too.
//
// The pre-hashed instantiation (PRE, the reference's hash_fn hook, which
// reservoir_tpu/ops/distinct.py:_update_one scrambles in place of the
// value's words) reads a separate pair of [R, B] pre-scramble hash planes
// and scrambles those; it still reads the value planes, for what it stores
// and for the order.  A user hash may give two values one hash, so there
// an entry is identified and ordered by (hash_hi, hash_lo, value_hi,
// value_lo), 128 bits, in every compare, equality and match below.  It
// follows the reference's XLA sort-merge, which is what the reference runs
// under a user hash: while a row is not full every lane is a candidate, a
// scrambled hash of (MAX, MAX) included; a full row's threshold is its last
// entry's 128-bit key.  Its plain version is
// reservoir_tpu_torch/ops/distinct.py:update_prehashed with hash planes.
//
// Bound.  Every tile word must be read once (4 or 8 bytes a lane); per lane
// the scramble is ~64 integer operations (6 rounds of fmix32, an add and the
// Feistel xor, the salt xors).  A steady tile of the distinct benchmark
// (R = 4,096, B = 1,024, k = 256, Zipf keys) has few candidates, so the
// scramble's operations bound it, not its 16 MiB of keys; a tile from empty
// also pays for some 600 inserts a row into a sorted block.  One warp a row
// gives only ~31 warps an SM at R = 4,096, a single wave, so the design's
// aim is instruction-level parallelism inside each warp and few serial
// steps per candidate.  chip_smoke.py computes the bound from each run's
// counts (PERF.md).
//
// Design.  One warp per reservoir row, up to four rows a block.
// - Loads in flight: the warp walks the row in chunks of 128 keys, four a
//   lane, read with 16-byte loads (a narrow key is one word, its high word
//   the sign extension; a wide tile as two planes, or as int64 pairs read
//   two keys a load); the next chunk is loaded before the current one is
//   scrambled and merged.  Rows whose width is not a multiple of 4, or
//   tiles not 16-byte aligned, take the same path with 4-byte loads.
// - The four scrambles of a lane are independent chains; a chunk's
//   candidates (below the threshold) are found by four ballots.
// - Candidates in rounds of 32: a chunk's candidates are compacted into
//   lanes (the n-th set bit of the ballots) and wait there, one a lane,
//   across chunks; a round runs when all 32 lanes hold one, and once more
//   at the row's end.  A steady Zipf row (~10 candidates a chunk, most of
//   them repeats of held keys) so takes ~3 rounds instead of 8.
// - A round: each lane rechecks its key against the threshold (which may
//   have tightened) and binary-searches the row's sorted block in shared
//   memory for its rank and an equal entry (log2 k steps, all lanes at
//   once).  A key already held goes; keys repeated inside the round keep
//   their lowest lane (__match_any_sync); survivors are ranked among
//   themselves and moved to lanes 0..n-1 in hash order (ballots over the
//   rank's bits and a shuffle).  Then one merge pass, from the top down,
//   moves each held entry up by the number of new keys below it (a binary
//   search over the survivors' ranks by shuffles) and drops what falls past
//   k, and each survivor lands at its rank in the block plus its rank among
//   the new.  The threshold is read once a round.
// - The row's block (hash pairs, value_lo and, wide, value_hi) is copied
//   into shared memory with cp.async at the row's first candidate, while
//   the row's next chunks are scrambled, and goes back at the end if it
//   changed, so a row with no candidate reads only its last entry.
// - Beyond shared memory: when one row's block does not fit in a block's
//   232,448 bytes (k > 19,370 narrow, k > 14,528 wide; the kernel holds no
//   static shared memory, so the dynamic block is all of it), the same
//   kernel, instantiated with ON_CHIP false, searches and merges the row's
//   block in place in the state's own arrays, four rows a block.  The
//   rounds' __syncwarp orders those global reads and writes as it orders
//   the shared ones, and nothing is copied in or written back.
//
// Launch geometry.  Rows a block (warps, one a row) is a launch choice from
// 1 to kMaxWarps; the kernel reads it from blockDim, so one instantiation
// runs them all.  shape_for is the one place that decides a launch's
// placement: as many warps as asked for (kMaxWarps for distinct_update and
// distinct_update_hashed, another for distinct_update_rows, from the
// autotune cache: ops/autotune.py) whose row blocks fit on chip, or all
// of them in global memory where one row's block does not fit.  A warp's
// row does not depend on the block it runs in.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (see reservoir_tpu_torch/_build.py).  Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "hashing.cuh"
#include "kinfo.cuh"

namespace dst {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 4;
constexpr int kMaxSmem = 232448;  // shared memory a block can use on sm_90
constexpr int kPer = 4;            // keys a lane holds of a chunk
constexpr int kChunk = 32 * kPer;  // keys a chunk

__device__ __forceinline__ bool lt64(uint32_t ah, uint32_t al, uint32_t bh, uint32_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

__device__ __forceinline__ uint32_t sign_hi(uint32_t lo) {
  return static_cast<uint32_t>(static_cast<int32_t>(lo) >> 31);
}

// An entry's key: its scrambled hash and its value words.  The default
// instantiation orders and identifies entries by the hash alone (the
// scramble is a permutation of the value); the pre-hashed one by all four
// words.
struct Key {
  uint32_t h, l, vh, vl;
};

template <bool PRE>
__device__ __forceinline__ bool before(const Key& a, const Key& b) {
  if (!PRE || a.h != b.h || a.l != b.l) return lt64(a.h, a.l, b.h, b.l);
  return lt64(a.vh, a.vl, b.vh, b.vl);
}

template <bool PRE>
__device__ __forceinline__ bool same_key(const Key& a, const Key& b) {
  return a.h == b.h && a.l == b.l && (!PRE || (a.vh == b.vh && a.vl == b.vl));
}

// Whether a lane's key is a candidate against the row's threshold: below
// the last entry (whose hash is (MAX, MAX) while the row is not full); the
// pre-hashed rule takes every lane of a row that is not full.
template <bool PRE>
__device__ __forceinline__ bool below(const Key& c, const Key& thr, bool full) {
  return (PRE && !full) || before<PRE>(c, thr);
}

// The position of the n-th (0-based) set bit of m; n < popc(m).
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const unsigned low = m & ((1u << width) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= width;
      pos += width;
    } else {
      m = low;
    }
  }
  return pos;
}

// 4 bytes from global to shared memory without waiting (cp.async), and the
// wait for every such copy of this thread.
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// One warp's row block: on chip, hash pairs, value_lo and value_hi in
// shared memory; else the state's own hash_hi, hash_lo, values and value_hi
// rows in global memory.  Entry i is read and written through hash/set.
template <bool ON_CHIP>
struct Block;

template <>
struct Block<true> {
  uint2* h;
  uint32_t* vl;
  uint32_t* vh;  // wide keys only
  __device__ __forceinline__ uint2 hash(int i) const { return h[i]; }
  __device__ __forceinline__ void set_hash(int i, uint2 x) const { h[i] = x; }
};

template <>
struct Block<false> {
  uint32_t* hh;
  uint32_t* hl;
  uint32_t* vl;
  uint32_t* vh;  // wide keys only
  __device__ __forceinline__ uint2 hash(int i) const { return make_uint2(hh[i], hl[i]); }
  __device__ __forceinline__ void set_hash(int i, uint2 x) const {
    hh[i] = x.x;
    hl[i] = x.y;
  }
};

// Words first .. first + 3 of one plane's row (those below v).
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ row, bool vec, int first,
                                           int v, uint32_t (&w)[kPer]) {
  if (first >= v) return;
  if (vec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + first));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (first + e < v) w[e] = __ldg(row + first + e);
  }
}

// Entry i of a row block as a Key; its value words are read only where the
// order needs them (PRE).
template <bool WIDE, bool PRE, bool ON_CHIP>
__device__ __forceinline__ Key entry(const Block<ON_CHIP>& blk, int i) {
  const uint2 e = blk.hash(i);
  Key key{e.x, e.y, 0u, 0u};
  if (PRE) {
    key.vl = blk.vl[i];
    key.vh = WIDE ? blk.vh[i] : sign_hi(key.vl);
  }
  return key;
}

// Keys first .. first + 3 of the row (those below v) into lo/hi words.
template <bool WIDE>
__device__ __forceinline__ void load_keys(const uint32_t* __restrict__ lo_row,
                                          const uint32_t* __restrict__ hi_row, int stride,
                                          bool vec, int first, int v, uint32_t (&lo)[kPer],
                                          uint32_t (&hi)[kPer]) {
  if (first >= v) return;
  if (vec) {  // the row's width is a multiple of 4: all four keys lie in the row
    if (WIDE && stride == 2) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(lo_row + 2 * first));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(lo_row + 2 * first + 4));
      lo[0] = a.x; hi[0] = a.y; lo[1] = a.z; hi[1] = a.w;
      lo[2] = b.x; hi[2] = b.y; lo[3] = b.z; hi[3] = b.w;
    } else {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(lo_row + first));
      lo[0] = a.x; lo[1] = a.y; lo[2] = a.z; lo[3] = a.w;
      if (WIDE) {
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(hi_row + first));
        hi[0] = b.x; hi[1] = b.y; hi[2] = b.z; hi[3] = b.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int p = first + e;
      if (p < v) {
        lo[e] = __ldg(lo_row + static_cast<size_t>(p) * stride);
        if (WIDE) hi[e] = __ldg(hi_row + static_cast<size_t>(p) * stride);
      }
    }
  }
  if (!WIDE) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) hi[e] = sign_hi(lo[e]);
  }
}

// One round: each lane with c set offers the key cand (its hash and value
// words).  Keys already held or repeated in the round go; the rest are
// merged into the sorted block in one pass.  Updates sz, the threshold,
// full and dirty.
template <bool WIDE, bool ON_CHIP, bool PRE>
__device__ __forceinline__ void take_round(const Block<ON_CHIP>& blk, int k, int lane, bool c,
                                           const Key& cand, int& sz, Key& thr, bool& full,
                                           bool& dirty) {
  const uint32_t ch = cand.h, cl = cand.l, cvh = cand.vh, cvl = cand.vl;
  // rank in the block (entries below) and an equal entry, by binary search
  int p = 0;
  if (sz > 0) {
    for (int step = 1 << (31 - __clz(sz)); step > 0; step >>= 1) {
      const int probe = p + step - 1;
      if (probe < sz && before<PRE>(entry<WIDE, PRE>(blk, probe), cand)) p += step;
    }
  }
  bool s = c;
  if (s && p < sz) s = !same_key<PRE>(entry<WIDE, PRE>(blk, p), cand);
  const unsigned sm = __ballot_sync(kFull, s);
  if (sm == 0) return;
  // a key repeated in the round keeps its lowest lane
  bool keep = false;
  if (s) {
    unsigned eq = __match_any_sync(sm, (static_cast<unsigned long long>(ch) << 32) | cl);
    if (PRE) eq &= __match_any_sync(sm, (static_cast<unsigned long long>(cvh) << 32) | cvl);
    keep = (eq & ((1u << lane) - 1u)) == 0;
  }
  const unsigned km = __ballot_sync(kFull, keep);
  const int n = __popc(km);
  // rank among the new keys
  int rank = 0;
  for (unsigned m = km; m; m &= m - 1u) {
    const int src = __ffs(m) - 1;
    Key other{__shfl_sync(kFull, ch, src), __shfl_sync(kFull, cl, src), 0u, 0u};
    if (PRE) {
      other.vh = __shfl_sync(kFull, cvh, src);
      other.vl = __shfl_sync(kFull, cvl, src);
    }
    rank += before<PRE>(other, cand) ? 1 : 0;
  }
  // lane r < n takes the new key of rank r
  unsigned sel = km;
  const int bits = n > 1 ? 32 - __clz(n - 1) : 0;
  for (int b = 0; b < bits; ++b) {
    const unsigned bb = __ballot_sync(kFull, keep && ((rank >> b) & 1));
    sel &= ((lane >> b) & 1) ? bb : ~bb;
  }
  const int src = (lane < n && sel) ? __ffs(sel) - 1 : 0;
  const uint32_t nh = __shfl_sync(kFull, ch, src), nl = __shfl_sync(kFull, cl, src);
  const uint32_t nvl = __shfl_sync(kFull, cvl, src);
  const uint32_t nvh = WIDE ? __shfl_sync(kFull, cvh, src) : 0u;
  const int np = __shfl_sync(kFull, p, src);  // non-decreasing over lanes 0..n-1
  const int pmin = __shfl_sync(kFull, np, 0);
  // the merge pass: held entry i moves up by the new keys at or below it
  const int hp = 1 << (31 - __clz(n));
  for (int top = sz - 1; top >= pmin; top -= 32) {
    const int i = top - lane;
    const bool mv = i >= pmin;
    int shift = 0;
    for (int step = hp; step > 0; step >>= 1) {
      const int probe = shift + step - 1;
      const int pv = __shfl_sync(kFull, np, probe & 31);
      if (probe < n && pv <= i) shift += step;
    }
    uint2 h = make_uint2(0u, 0u);
    uint32_t a = 0u, b = 0u;
    if (mv) {
      h = blk.hash(i);
      a = blk.vl[i];
      if (WIDE) b = blk.vh[i];
    }
    __syncwarp();
    if (mv && i + shift < k) {
      blk.set_hash(i + shift, h);
      blk.vl[i + shift] = a;
      if (WIDE) blk.vh[i + shift] = b;
    }
    __syncwarp();
  }
  if (lane < n && np + lane < k) {
    const int d = np + lane;
    blk.set_hash(d, make_uint2(nh, nl));
    blk.vl[d] = nvl;
    if (WIDE) blk.vh[d] = nvh;
  }
  __syncwarp();
  sz = sz + n < k ? sz + n : k;
  if (sz == k) {
    thr = entry<WIDE, PRE>(blk, k - 1);
    full = true;
  }
  dirty = true;
}

template <bool WIDE, bool ON_CHIP, bool PRE>
__global__ void __launch_bounds__(kMaxWarps * 32, 8)
update_kernel(uint32_t* __restrict__ values, uint32_t* __restrict__ value_hi,
              uint32_t* __restrict__ hash_hi, uint32_t* __restrict__ hash_lo,
              int32_t* __restrict__ size, int32_t* __restrict__ count,
              const uint32_t* __restrict__ salts, const uint32_t* __restrict__ tile_lo,
              const uint32_t* __restrict__ tile_hi, int stride, int vec,
              const uint32_t* __restrict__ pre_hi, const uint32_t* __restrict__ pre_lo,
              const int32_t* __restrict__ valid, int R, int k, int B, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= R) return;  // whole warps only: R rows, one warp each
  const size_t row = static_cast<size_t>(r) * k;
  Block<ON_CHIP> blk;
  if constexpr (ON_CHIP) {
    blk.h = reinterpret_cast<uint2*>(smem + static_cast<size_t>(w) * warp_bytes);
    blk.vl = reinterpret_cast<uint32_t*>(blk.h + k);
    blk.vh = blk.vl + k;
  } else {
    blk.hh = hash_hi + row;
    blk.hl = hash_lo + row;
    blk.vl = values + row;
    blk.vh = WIDE ? value_hi + row : nullptr;
  }
  const uint32_t r0h = salts[4 * r], r0l = salts[4 * r + 1];
  const uint32_t r1h = salts[4 * r + 2], r1l = salts[4 * r + 3];
  const int v = valid != nullptr ? valid[r] : B;
  const int vt = v < 0 ? 0 : (v > B ? B : v);
  int sz = size[r];
  // the threshold: the last entry, (MAX, MAX) while the row is not full
  // (the pre-hashed rule reads the last entry's value words too, and only
  // once the row is full)
  bool full = sz >= k;
  Key thr{hash_hi[row + k - 1], hash_lo[row + k - 1], 0u, 0u};
  if (PRE && full) {
    thr.vl = values[row + k - 1];
    thr.vh = WIDE ? value_hi[row + k - 1] : sign_hi(thr.vl);
  }
  bool held = false;   // the row's block is in shared memory
  bool dirty = false;  // and differs from the one in memory
  const size_t base = static_cast<size_t>(r) * B * stride;
  const uint32_t* lo_row = tile_lo + base;
  const uint32_t* hi_row = WIDE ? tile_hi + base : nullptr;
  const uint32_t* ph_row = PRE ? pre_hi + static_cast<size_t>(r) * B : nullptr;
  const uint32_t* pl_row = PRE ? pre_lo + static_cast<size_t>(r) * B : nullptr;

  // candidates wait in lanes, one a lane, until 32 are pending or the row
  // ends; the threshold may have tightened since their chunk's ballots
  Key pend{0u, 0u, 0u, 0u};
  int npend = 0;
  bool ready = !ON_CHIP;  // the block's copy has landed
  auto flush = [&]() {
    if (!ready) {
      wait_async();
      __syncwarp();
      ready = true;
    }
    const bool c = lane < npend && below<PRE>(pend, thr, full);
    take_round<WIDE, ON_CHIP, PRE>(blk, k, lane, c, pend, sz, thr, full, dirty);
  };

  uint32_t nlo[kPer] = {0u, 0u, 0u, 0u}, nhi[kPer] = {0u, 0u, 0u, 0u};
  uint32_t nph[kPer] = {0u, 0u, 0u, 0u}, npl[kPer] = {0u, 0u, 0u, 0u};
  load_keys<WIDE>(lo_row, hi_row, stride, vec != 0, kPer * lane, vt, nlo, nhi);
  if (PRE) {
    load_words(ph_row, vec != 0, kPer * lane, vt, nph);
    load_words(pl_row, vec != 0, kPer * lane, vt, npl);
  }
  for (int off = 0; off < vt; off += kChunk) {
    uint32_t lo[kPer], hi[kPer];
    uint32_t sh[kPer], sl[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      lo[e] = nlo[e];
      hi[e] = nhi[e];
      sh[e] = PRE ? nph[e] : hi[e];
      sl[e] = PRE ? npl[e] : lo[e];
    }
    const int first = off + kPer * lane;
    if (off + kChunk < vt) {
      load_keys<WIDE>(lo_row, hi_row, stride, vec != 0, first + kChunk, vt, nlo, nhi);
      if (PRE) {
        load_words(ph_row, vec != 0, first + kChunk, vt, nph);
        load_words(pl_row, vec != 0, first + kChunk, vt, npl);
      }
    }
    unsigned bal[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) dhash::scramble64(sh[e], sl[e], r0h, r0l, r1h, r1l);
    int pre[kPer];
    int total = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const Key key{sh[e], sl[e], hi[e], lo[e]};
      bal[e] = __ballot_sync(kFull, first + e < vt && below<PRE>(key, thr, full));
      pre[e] = total;
      total += __popc(bal[e]);
    }
    if (total == 0) continue;
    if constexpr (ON_CHIP) {
      if (!held) {  // the row's block, copied while the row goes on
#pragma unroll 4
        for (int i = lane; i < k; i += 32) {
          copy4_async(&blk.h[i].x, hash_hi + row + i);
          copy4_async(&blk.h[i].y, hash_lo + row + i);
          copy4_async(blk.vl + i, values + row + i);
          if (WIDE) copy4_async(blk.vh + i, value_hi + row + i);
        }
        held = true;
      }
    }
    // the chunk's candidates in slot-then-lane order join the pending ones,
    // lanes npend.. taking the next; a round runs when all 32 lanes hold one
    for (int done = 0; done < total;) {
      const int take = 32 - npend < total - done ? 32 - npend : total - done;
      const int g = done + lane - npend;  // the candidate this lane receives
      const bool recv = lane >= npend && lane < npend + take;
      int es = 0, from = 0;
      unsigned mask = bal[0];
#pragma unroll
      for (int e = 1; e < kPer; ++e) {
        if (g >= pre[e]) {
          es = e;
          from = pre[e];
          mask = bal[e];
        }
      }
      const int src = recv ? nth_set(mask, g - from) : 0;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (bal[e] == 0u) continue;  // warp-uniform
        const uint32_t a = __shfl_sync(kFull, sh[e], src), b = __shfl_sync(kFull, sl[e], src);
        const uint32_t x = __shfl_sync(kFull, lo[e], src);
        const uint32_t y = WIDE ? __shfl_sync(kFull, hi[e], src) : 0u;
        if (recv && es == e) pend = Key{a, b, WIDE ? y : sign_hi(x), x};
      }
      npend += take;
      done += take;
      if (npend == 32) {
        flush();
        npend = 0;
      }
    }
  }
  if (npend > 0) flush();
  if constexpr (ON_CHIP) {
    if (dirty) {
#pragma unroll 4
      for (int i = lane; i < k; i += 32) {
        const uint2 h = blk.h[i];
        hash_hi[row + i] = h.x;
        hash_lo[row + i] = h.y;
        values[row + i] = blk.vl[i];
        if (WIDE) value_hi[row + i] = blk.vh[i];
      }
    }
  }
  if (lane == 0) {
    size[r] = sz;
    count[r] = static_cast<int32_t>(static_cast<uint32_t>(count[r]) + static_cast<uint32_t>(v));
  }
}

// Shared memory a warp takes for its row's block (16-byte aligned), and the
// warps a block runs on chip; 0 warps when one row's block does not fit
// (the kernel's static shared memory, none, is counted: kStaticSmem).
constexpr size_t kStaticSmem = 0;

__host__ inline size_t warp_bytes(bool wide, int k) {
  return (static_cast<size_t>(k) * (wide ? 16 : 12) + 15) / 16 * 16;
}

__host__ inline int warps_for(bool wide, int k, int cap = kMaxWarps) {
  const size_t room = static_cast<size_t>(kMaxSmem) - kStaticSmem;
  const size_t per_warp = warp_bytes(wide, k);
  if (per_warp > room) return 0;
  const int warps = static_cast<int>(room / per_warp);
  return warps < cap ? warps : cap;
}

// The launch shape at k for at most cap warps a block: warps a block,
// dynamic shared memory a block, and whether the row's block is kept on
// chip.
struct Shape {
  int warps;
  size_t smem;
  bool on_chip;
};

__host__ inline Shape shape_for(bool wide, int k, int cap = kMaxWarps) {
  const int warps = warps_for(wide, k, cap);
  if (warps == 0) return {cap, 0, false};
  return {warps, warps * warp_bytes(wide, k), true};
}

template <bool WIDE, bool ON_CHIP, bool PRE>
int launch(const Shape& sh, uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
           uint32_t* hash_lo, int32_t* size, int32_t* count, const uint32_t* salts,
           const uint32_t* tile_lo, const uint32_t* tile_hi, int stride, const uint32_t* pre_hi,
           const uint32_t* pre_lo, const int32_t* valid, int R, int k, int B,
           cudaStream_t stream) {
  if (sh.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(update_kernel<WIDE, ON_CHIP, PRE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(sh.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const int vec = B % 4 == 0 && aligned(tile_lo) &&
                  (!WIDE || stride == 2 || aligned(tile_hi)) &&
                  (!PRE || (aligned(pre_hi) && aligned(pre_lo)));
  const int blocks = (R + sh.warps - 1) / sh.warps;
  update_kernel<WIDE, ON_CHIP, PRE><<<blocks, sh.warps * 32, sh.smem, stream>>>(
      values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo, tile_hi, stride, vec,
      pre_hi, pre_lo, valid, R, k, B, static_cast<int>(warp_bytes(WIDE, k)));
  return static_cast<int>(cudaGetLastError());
}

template <bool WIDE, bool PRE>
int launch_at(const Shape& sh, uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
              uint32_t* hash_lo, int32_t* size, int32_t* count, const uint32_t* salts,
              const uint32_t* tile_lo, const uint32_t* tile_hi, int stride,
              const uint32_t* pre_hi, const uint32_t* pre_lo, const int32_t* valid, int R, int k,
              int B, cudaStream_t stream) {
  return sh.on_chip
             ? launch<WIDE, true, PRE>(sh, values, value_hi, hash_hi, hash_lo, size, count, salts,
                                       tile_lo, tile_hi, stride, pre_hi, pre_lo, valid, R, k, B,
                                       stream)
             : launch<WIDE, false, PRE>(sh, values, value_hi, hash_hi, hash_lo, size, count,
                                        salts, tile_lo, tile_hi, stride, pre_hi, pre_lo, valid, R,
                                        k, B, stream);
}

template <bool PRE>
int info(const Shape& sh, bool wide, int* out) {
  const int threads = sh.warps * 32;
  if (wide)
    return sh.on_chip ? kinfo::query(update_kernel<true, true, PRE>, threads, sh.smem, out)
                      : kinfo::query(update_kernel<true, false, PRE>, threads, 0, out);
  return sh.on_chip ? kinfo::query(update_kernel<false, true, PRE>, threads, sh.smem, out)
                    : kinfo::query(update_kernel<false, false, PRE>, threads, 0, out);
}

// The merge at launch shape sh, default or pre-hashed by pre_hi/pre_lo.
int launch_shape(const Shape& sh, uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
                 uint32_t* hash_lo, int32_t* size, int32_t* count, const uint32_t* salts,
                 const uint32_t* tile_lo, const uint32_t* tile_hi, int stride,
                 const uint32_t* pre_hi, const uint32_t* pre_lo, const int32_t* valid, int R,
                 int k, int B, cudaStream_t stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if ((pre_hi == nullptr) != (pre_lo == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = value_hi != nullptr;
  if (pre_hi != nullptr)
    return wide ? launch_at<true, true>(sh, values, value_hi, hash_hi, hash_lo, size, count, salts,
                                        tile_lo, tile_hi, stride, pre_hi, pre_lo, valid, R, k, B,
                                        stream)
                : launch_at<false, true>(sh, values, value_hi, hash_hi, hash_lo, size, count,
                                         salts, tile_lo, tile_hi, stride, pre_hi, pre_lo, valid, R,
                                         k, B, stream);
  return wide ? launch_at<true, false>(sh, values, value_hi, hash_hi, hash_lo, size, count, salts,
                                       tile_lo, tile_hi, stride, nullptr, nullptr, valid, R, k, B,
                                       stream)
              : launch_at<false, false>(sh, values, value_hi, hash_hi, hash_lo, size, count, salts,
                                        tile_lo, tile_hi, stride, nullptr, nullptr, valid, R, k, B,
                                        stream);
}

}  // namespace dst

extern "C" {

// One distinct tile merge, in place, at the default geometry (warps_for(k)
// rows a block).  value_hi and tile_hi are null for narrow keys.  Lane p
// of row r is word (r * B + p) * stride of tile_lo (and tile_hi); stride 2
// is an int64 tile read in place (tile_hi = tile_lo + 1).  pre_hi and
// pre_lo, both null or both not, are the [R, B] pre-scramble hash planes
// of the pre-hashed instantiation (lane p of row r is word r * B + p);
// null hashes the keys' own words.  valid may be null (every row takes B).
// Returns cudaGetLastError() after the launch.
int distinct_update_hashed(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
                           uint32_t* hash_lo, int32_t* size, int32_t* count,
                           const uint32_t* salts, const uint32_t* tile_lo,
                           const uint32_t* tile_hi, int stride, const uint32_t* pre_hi,
                           const uint32_t* pre_lo, const int32_t* valid, int R, int k, int B,
                           cudaStream_t stream) {
  return dst::launch_shape(dst::shape_for(value_hi != nullptr, k), values, value_hi, hash_hi,
                           hash_lo, size, count, salts, tile_lo, tile_hi, stride, pre_hi, pre_lo,
                           valid, R, k, B, stream);
}

// distinct_update_hashed at up to warps rows a block (1 to 4; shape_for).
int distinct_update_rows(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
                         uint32_t* hash_lo, int32_t* size, int32_t* count, const uint32_t* salts,
                         const uint32_t* tile_lo, const uint32_t* tile_hi, int stride,
                         const uint32_t* pre_hi, const uint32_t* pre_lo, const int32_t* valid,
                         int R, int k, int B, int warps, cudaStream_t stream) {
  if (warps < 1 || warps > dst::kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  return dst::launch_shape(dst::shape_for(value_hi != nullptr, k, warps), values, value_hi,
                           hash_hi, hash_lo, size, count, salts, tile_lo, tile_hi, stride, pre_hi,
                           pre_lo, valid, R, k, B, stream);
}

// distinct_update_hashed with the keys' own words hashed (the entry point
// of builds that predate the pre-hashed instantiation, which kernel_ab.py
// still loads).
int distinct_update(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi, uint32_t* hash_lo,
                    int32_t* size, int32_t* count, const uint32_t* salts,
                    const uint32_t* tile_lo, const uint32_t* tile_hi, int stride,
                    const int32_t* valid, int R, int k, int B, cudaStream_t stream) {
  return distinct_update_hashed(values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo,
                                tile_hi, stride, nullptr, nullptr, valid, R, k, B, stream);
}

// The build's registers, spills, shared memory and resident warps an SM of
// the kernel a launch at k runs (kinfo::query's five numbers in out); its
// dynamic shared memory is 0 where the row's block stays in global memory.
int distinct_kernel_info(int wide, int k, int* out) {
  return dst::info<false>(dst::shape_for(wide != 0, k), wide != 0, out);
}

// distinct_kernel_info of the pre-hashed instantiation.
int distinct_prehashed_kernel_info(int wide, int k, int* out) {
  return dst::info<true>(dst::shape_for(wide != 0, k), wide != 0, out);
}

// distinct_kernel_info (prehashed = 0) or distinct_prehashed_kernel_info
// (1) of a launch at warps rows a block.
int distinct_rows_kernel_info(int wide, int prehashed, int k, int warps, int* out) {
  if (warps < 1 || warps > dst::kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const dst::Shape sh = dst::shape_for(wide != 0, k, warps);
  return prehashed ? dst::info<true>(sh, wide != 0, out) : dst::info<false>(sh, wide != 0, out);
}

const char* distinct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
