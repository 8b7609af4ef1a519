// Distinct-value (salted bottom-k) tile merge for R lockstep reservoirs, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel reservoir_tpu/ops/distinct_pallas.py:_kernel (entry
// point update_pallas).  It computes the same function as the plain version,
// reservoir_tpu_torch/ops/distinct.py:update: row r keeps the k distinct
// values with the smallest scrambled hashes, sorted by (hash_hi, hash_lo,
// value_hi, value_lo), padding (MAX, MAX)/0 past size.  Because the scramble
// is a permutation of the 64-bit value, distinct values never share a hash:
// the hash alone orders and identifies the entries, and the result is a
// function of the set of values seen, so candidates may be taken in any
// order and many at a time.  Unlike the TPU kernel it takes a per-row valid
// count, so ragged tiles run here too.
//
// Three rules, one instantiation each, as the reference's engine routes a
// tile (reservoir_tpu/engine.py:_pallas_fallback_reason):
// - the default (distinct_update), the Pallas kernel's rule, for a full
//   tile with no hook: a lane is a candidate when its hash is strictly below
//   the row's last entry, so a hash of exactly (MAX, MAX) is never taken;
// - keep-max (KEEP, distinct_update_keepmax), the XLA sort-merge's rule,
//   which the reference runs on a ragged tile (valid given) and on mapped
//   keys without a hash_fn: while a row is not full every lane is a
//   candidate, a scrambled hash of (MAX, MAX) included.  Nothing else
//   differs: the keys' own words, the 64-bit hash order, no hash planes;
//   the rule is a per-row limit taken inclusively (limit), so the chunk
//   loop's compare is the default's;
// - pre-hashed (hashed_kernel, distinct_update_hashed), for a hash_fn: below.
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
// The pre-hashed kernel (the reference's hash_fn hook, which
// reservoir_tpu/ops/distinct.py:_update_one scrambles in place of the
// value's words; the reference runs it on XLA, so it follows the keep-max
// rule) reads a pair of [R, B] pre-scramble hash planes and scrambles those.
// A user hash may give two keys one hash, so an entry is ordered and
// identified by (hash_hi, hash_lo, value_hi, value_lo).  Its plain version
// is reservoir_tpu_torch/ops/distinct.py:update_prehashed with hash planes.
// It shares the rounds' structure and the block above, and differs where
// the 128-bit key would cost registers or steps:
// - The chunk loop holds no value words.  The lanes load and scramble the
//   hash planes only (loaded where they are used; the chunks two ahead are
//   asked into L2 with prefetch.global.L2, which takes no registers), and a
//   candidate joins the pending lanes as its hash and its value words,
//   gathered from the tile by its lane as it joins.
// - The 64-bit hash orders; value words are read only where a hash ties.
//   A full row's threshold is the last entry's hash alone: a lane whose
//   hash equals it is a candidate, and the round's order places it, past k
//   if its value words are above.  In a round, each lane searches the block
//   by hash; a lane that meets an entry of its own hash compares the value
//   words there (the same key goes), and where such a lane holds another
//   key of that hash (a warp-uniform vote) it searches again in 128 bits.
//   Repeats in the round match on the hash; a lane then compares its value
//   words with its hash group's first lane's (two shuffles), and only in a
//   round where one differs (a tie, by a vote) do the value words take part
//   in the match and in the ranks of the new keys.
// - One warp a row at __launch_bounds__(128, 8), so R = 4,096 stays one
//   wave, without spilling.
//
// Launch geometry.  Rows a block (warps, one a row) is a launch choice from
// 1 to kMaxWarps; the kernels read it from blockDim, so one instantiation
// runs them all.  shape_for is the one place that decides a launch's
// placement: as many warps as asked for (kMaxWarps by default, another
// from the autotune cache: ops/autotune.py) whose row blocks fit on chip,
// or all of them in global
// memory where one row's block does not fit.  A warp's row does not depend
// on the block it runs in.
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

// The instantiations: the Pallas rule, keep-max and pre-hashed.
enum Rule : int { kDefault = 0, kHashed = 1, kKeepMax = 2 };

__device__ __forceinline__ bool lt64(uint32_t ah, uint32_t al, uint32_t bh, uint32_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

__device__ __forceinline__ uint32_t sign_hi(uint32_t lo) {
  return static_cast<uint32_t>(static_cast<int32_t>(lo) >> 31);
}

__device__ __forceinline__ unsigned long long pack(uint32_t hi, uint32_t lo) {
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// A candidate: its scrambled hash and its value words.
struct Key {
  uint32_t h, l, vh, vl;
};

// The row's limit under the default or keep-max rule, from the hash thr of
// its last entry ((MAX, MAX) padding while the row is not full).  The
// default's is thr itself, taken strictly (below).  Keep-max's is taken
// inclusively: (MAX, MAX) while the row is not full, so every lane is a
// candidate, else the hash just below thr; a full row's hash (0, 0) is held,
// so a lane of that hash is the held key, which the round drops.
template <bool KEEP>
__device__ __forceinline__ uint2 limit(uint2 thr, bool full) {
  if (!KEEP) return thr;
  if (!full) return make_uint2(kFull, kFull);
  if (thr.y != 0u) return make_uint2(thr.x, thr.y - 1u);
  return thr.x != 0u ? make_uint2(thr.x - 1u, kFull) : thr;
}

// Whether a lane's key is a candidate against the row's limit lim: strictly
// below it (the default), at most it (keep-max).  One compare either way.
template <bool KEEP>
__device__ __forceinline__ bool below(uint32_t h, uint32_t l, uint2 lim) {
  return KEEP ? !lt64(lim.x, lim.y, h, l) : lt64(h, l, lim.x, lim.y);
}

// The pre-hashed rule: every lane of a row that is not full, else a hash at
// most the last entry's (a tie is ordered in the round).
__device__ __forceinline__ bool below_hashed(uint32_t h, uint32_t l, uint2 thr, bool full) {
  return !full || !lt64(thr.x, thr.y, h, l);
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

// Ask the L2 cache for the line holding p, taking no register for the data.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

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

// The value words (hi, lo) of entry i.
template <bool WIDE, bool ON_CHIP>
__device__ __forceinline__ uint2 value_of(const Block<ON_CHIP>& blk, int i) {
  const uint32_t lo = blk.vl[i];
  return make_uint2(WIDE ? blk.vh[i] : sign_hi(lo), lo);
}

// Row r's block: shared memory at the warp's slice, or the state's rows.
template <bool ON_CHIP>
__device__ __forceinline__ Block<ON_CHIP> row_block(unsigned char* smem, int w, int warp_bytes, int k,
                                                    size_t row, uint32_t* values, uint32_t* value_hi,
                                                    uint32_t* hash_hi, uint32_t* hash_lo, bool wide) {
  Block<ON_CHIP> blk;
  if constexpr (ON_CHIP) {
    blk.h = reinterpret_cast<uint2*>(smem + static_cast<size_t>(w) * warp_bytes);
    blk.vl = reinterpret_cast<uint32_t*>(blk.h + k);
    blk.vh = blk.vl + k;
  } else {
    blk.hh = hash_hi + row;
    blk.hl = hash_lo + row;
    blk.vl = values + row;
    blk.vh = wide ? value_hi + row : nullptr;
  }
  return blk;
}

// The row's block copied into shared memory (cp.async, waited on later).
template <bool WIDE>
__device__ __forceinline__ void copy_in(const Block<true>& blk, int lane, int k, size_t row,
                                        const uint32_t* values, const uint32_t* value_hi,
                                        const uint32_t* hash_hi, const uint32_t* hash_lo) {
#pragma unroll 4
  for (int i = lane; i < k; i += 32) {
    copy4_async(&blk.h[i].x, hash_hi + row + i);
    copy4_async(&blk.h[i].y, hash_lo + row + i);
    copy4_async(blk.vl + i, values + row + i);
    if (WIDE) copy4_async(blk.vh + i, value_hi + row + i);
  }
}

// The row's block written back from shared memory.
template <bool WIDE>
__device__ __forceinline__ void write_back(const Block<true>& blk, int lane, int k, size_t row,
                                           uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
                                           uint32_t* hash_lo) {
#pragma unroll 4
  for (int i = lane; i < k; i += 32) {
    const uint2 h = blk.h[i];
    hash_hi[row + i] = h.x;
    hash_lo[row + i] = h.y;
    values[row + i] = blk.vl[i];
    if (WIDE) value_hi[row + i] = blk.vh[i];
  }
}

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

// Entries of the block's first sz with a hash below (h, l), by binary search.
template <bool ON_CHIP>
__device__ __forceinline__ int rank_by_hash(const Block<ON_CHIP>& blk, int sz, uint32_t h, uint32_t l) {
  int p = 0;
  if (sz > 0) {
    for (int step = 1 << (31 - __clz(sz)); step > 0; step >>= 1) {
      const int probe = p + step - 1;
      if (probe < sz) {
        const uint2 e = blk.hash(probe);
        if (lt64(e.x, e.y, h, l)) p += step;
      }
    }
  }
  return p;
}

// The second half of a round: lanes with keep set hold the round's n new
// keys (km their lanes), each of rank `rank` among them and `p` entries of
// the block below it.  Ranks move the new keys to lanes 0..n-1 in order,
// then one merge pass, from the top down, moves each held entry up by the
// new keys at or below it and drops what falls past k, and each new key
// lands at p plus its rank.  Updates sz.
template <bool WIDE, bool ON_CHIP>
__device__ __forceinline__ void merge_new(const Block<ON_CHIP>& blk, int k, int lane, bool keep,
                                          unsigned km, int rank, const Key& cand, int p, int& sz) {
  const int n = __popc(km);
  // lane r < n takes the new key of rank r
  unsigned sel = km;
  const int bits = n > 1 ? 32 - __clz(n - 1) : 0;
  for (int b = 0; b < bits; ++b) {
    const unsigned bb = __ballot_sync(kFull, keep && ((rank >> b) & 1));
    sel &= ((lane >> b) & 1) ? bb : ~bb;
  }
  const int src = (lane < n && sel) ? __ffs(sel) - 1 : 0;
  const uint32_t nh = __shfl_sync(kFull, cand.h, src), nl = __shfl_sync(kFull, cand.l, src);
  const uint32_t nvl = __shfl_sync(kFull, cand.vl, src);
  const uint32_t nvh = WIDE ? __shfl_sync(kFull, cand.vh, src) : 0u;
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
}

// One round of the default and keep-max kernels: each lane with c set
// offers the key cand.  Keys already held or repeated in the round go; the
// rest are merged into the sorted block in one pass.  Updates sz, the
// row's limit and dirty.
template <bool WIDE, bool ON_CHIP, bool KEEP>
__device__ __forceinline__ void take_round(const Block<ON_CHIP>& blk, int k, int lane, bool c,
                                           const Key& cand, int& sz, uint2& lim, bool& dirty) {
  // rank in the block (entries below) and an equal entry, by binary search
  const int p = rank_by_hash(blk, sz, cand.h, cand.l);
  bool s = c;
  if (s && p < sz) {
    const uint2 e = blk.hash(p);
    s = e.x != cand.h || e.y != cand.l;
  }
  const unsigned sm = __ballot_sync(kFull, s);
  if (sm == 0) return;
  // a key repeated in the round keeps its lowest lane
  bool keep = false;
  if (s) keep = (__match_any_sync(sm, pack(cand.h, cand.l)) & ((1u << lane) - 1u)) == 0;
  const unsigned km = __ballot_sync(kFull, keep);
  // rank among the new keys
  int rank = 0;
  for (unsigned m = km; m; m &= m - 1u) {
    const int src = __ffs(m) - 1;
    const uint32_t oh = __shfl_sync(kFull, cand.h, src), ol = __shfl_sync(kFull, cand.l, src);
    rank += lt64(oh, ol, cand.h, cand.l) ? 1 : 0;
  }
  merge_new<WIDE, ON_CHIP>(blk, k, lane, keep, km, rank, cand, p, sz);
  if (sz == k) lim = limit<KEEP>(blk.hash(k - 1), true);
  dirty = true;
}

// One round of the pre-hashed kernel: take_round with entries ordered and
// identified by (hash, value words), the value words read only where a
// hash ties.
template <bool WIDE, bool ON_CHIP>
__device__ __forceinline__ void hashed_round(const Block<ON_CHIP>& blk, int k, int lane, bool c,
                                             const Key& cand, int& sz, uint2& thr, bool& full,
                                             bool& dirty) {
  int p = rank_by_hash(blk, sz, cand.h, cand.l);
  // an entry of the candidate's hash at p: the same key, or another key of
  // that hash, which the value words place
  bool dup = false, tie = false;
  if (c && p < sz) {
    const uint2 e = blk.hash(p);
    if (e.x == cand.h && e.y == cand.l) {
      const uint2 v = value_of<WIDE>(blk, p);
      dup = v.x == cand.vh && v.y == cand.vl;
      tie = !dup;
    }
  }
  if (__any_sync(kFull, tie) && tie) {
    // the key among the entries of its hash, which its value words order
    int lo = p, hi = sz;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const uint2 e = blk.hash(mid);
      const uint2 v = value_of<WIDE>(blk, mid);
      if (e.x == cand.h && e.y == cand.l && lt64(v.x, v.y, cand.vh, cand.vl))
        lo = mid + 1;
      else
        hi = mid;
    }
    p = lo;
    if (p < sz) {
      const uint2 e = blk.hash(p);
      const uint2 v = value_of<WIDE>(blk, p);
      dup = e.x == cand.h && e.y == cand.l && v.x == cand.vh && v.y == cand.vl;
    }
  }
  const bool s = c && !dup;
  const unsigned sm = __ballot_sync(kFull, s);
  if (sm == 0) return;
  // a key repeated in the round keeps its lowest lane.  Lanes of one hash
  // are one key unless their value words differ: in a round where a hash
  // is on two lanes or more (a warp-uniform vote), each lane compares its
  // value words with its hash group's lowest lane's, and only in a round
  // where one differs (another vote: a tie) are the value words matched
  // too, and do they order the new keys
  unsigned same = 0u;
  if (s) same = __match_any_sync(sm, pack(cand.h, cand.l));
  bool tied = false;
  if (__any_sync(kFull, (same & (same - 1u)) != 0u)) {  // a hash on two lanes or more
    const int lead = s ? __ffs(same) - 1 : lane;
    const uint32_t lvl = __shfl_sync(kFull, cand.vl, lead);
    const uint32_t lvh = WIDE ? __shfl_sync(kFull, cand.vh, lead) : sign_hi(lvl);
    tied = __any_sync(kFull, s && (lvh != cand.vh || lvl != cand.vl));
    if (tied && s) same &= __match_any_sync(sm, pack(cand.vh, cand.vl));
  }
  const bool keep = s && (same & ((1u << lane) - 1u)) == 0;
  const unsigned km = __ballot_sync(kFull, keep);
  // rank among the new keys: by hash, and by value words in a tied round
  // (two loops, so the common one carries no test of the rare case)
  int rank = 0;
  if (!tied) {
    for (unsigned m = km; m; m &= m - 1u) {
      const int src = __ffs(m) - 1;
      const uint32_t oh = __shfl_sync(kFull, cand.h, src), ol = __shfl_sync(kFull, cand.l, src);
      rank += lt64(oh, ol, cand.h, cand.l) ? 1 : 0;
    }
  } else {
    for (unsigned m = km; m; m &= m - 1u) {
      const int src = __ffs(m) - 1;
      const uint32_t oh = __shfl_sync(kFull, cand.h, src), ol = __shfl_sync(kFull, cand.l, src);
      const uint32_t ovh = __shfl_sync(kFull, cand.vh, src), ovl = __shfl_sync(kFull, cand.vl, src);
      const bool lt = lt64(oh, ol, cand.h, cand.l) ||
                      (oh == cand.h && ol == cand.l && lt64(ovh, ovl, cand.vh, cand.vl));
      rank += lt ? 1 : 0;
    }
  }
  merge_new<WIDE, ON_CHIP>(blk, k, lane, keep, km, rank, cand, p, sz);
  if (sz == k) {
    thr = blk.hash(k - 1);
    full = true;
  }
  dirty = true;
}

template <bool WIDE, bool ON_CHIP, bool KEEP>
__global__ void __launch_bounds__(kMaxWarps * 32, 8)
update_kernel(uint32_t* __restrict__ values, uint32_t* __restrict__ value_hi,
              uint32_t* __restrict__ hash_hi, uint32_t* __restrict__ hash_lo,
              int32_t* __restrict__ size, int32_t* __restrict__ count,
              const uint32_t* __restrict__ salts, const uint32_t* __restrict__ tile_lo,
              const uint32_t* __restrict__ tile_hi, int stride, int vec,
              const int32_t* __restrict__ valid, int R, int k, int B, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= R) return;  // whole warps only: R rows, one warp each
  const size_t row = static_cast<size_t>(r) * k;
  const Block<ON_CHIP> blk =
      row_block<ON_CHIP>(smem, w, warp_bytes, k, row, values, value_hi, hash_hi, hash_lo, WIDE);
  const uint32_t r0h = salts[4 * r], r0l = salts[4 * r + 1];
  const uint32_t r1h = salts[4 * r + 2], r1l = salts[4 * r + 3];
  const int v = valid != nullptr ? valid[r] : B;
  const int vt = v < 0 ? 0 : (v > B ? B : v);
  int sz = size[r];
  // the row's limit, from its last entry ((MAX, MAX) while it is not full)
  uint2 lim = limit<KEEP>(make_uint2(hash_hi[row + k - 1], hash_lo[row + k - 1]), sz >= k);
  bool held = false;   // the row's block is in shared memory
  bool dirty = false;  // and differs from the one in memory
  const size_t base = static_cast<size_t>(r) * B * stride;
  const uint32_t* lo_row = tile_lo + base;
  const uint32_t* hi_row = WIDE ? tile_hi + base : nullptr;

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
    const bool c = lane < npend && below<KEEP>(pend.h, pend.l, lim);
    take_round<WIDE, ON_CHIP, KEEP>(blk, k, lane, c, pend, sz, lim, dirty);
  };

  uint32_t nlo[kPer] = {0u, 0u, 0u, 0u}, nhi[kPer] = {0u, 0u, 0u, 0u};
  load_keys<WIDE>(lo_row, hi_row, stride, vec != 0, kPer * lane, vt, nlo, nhi);
  for (int off = 0; off < vt; off += kChunk) {
    uint32_t lo[kPer], hi[kPer];
    uint32_t sh[kPer], sl[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      lo[e] = nlo[e];
      hi[e] = nhi[e];
      sh[e] = hi[e];
      sl[e] = lo[e];
    }
    const int first = off + kPer * lane;
    if (off + kChunk < vt)
      load_keys<WIDE>(lo_row, hi_row, stride, vec != 0, first + kChunk, vt, nlo, nhi);
    unsigned bal[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) dhash::scramble64(sh[e], sl[e], r0h, r0l, r1h, r1l);
    int pre[kPer];
    int total = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      bal[e] = __ballot_sync(kFull, first + e < vt && below<KEEP>(sh[e], sl[e], lim));
      pre[e] = total;
      total += __popc(bal[e]);
    }
    if (total == 0) continue;
    if constexpr (ON_CHIP) {
      if (!held) {  // the row's block, copied while the row goes on
        copy_in<WIDE>(blk, lane, k, row, values, value_hi, hash_hi, hash_lo);
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
    if (dirty) write_back<WIDE>(blk, lane, k, row, values, value_hi, hash_hi, hash_lo);
  }
  if (lane == 0) {
    size[r] = sz;
    count[r] = static_cast<int32_t>(static_cast<uint32_t>(count[r]) + static_cast<uint32_t>(v));
  }
}

template <bool WIDE, bool ON_CHIP>
__global__ void __launch_bounds__(kMaxWarps * 32, 8)
hashed_kernel(uint32_t* __restrict__ values, uint32_t* __restrict__ value_hi,
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
  const Block<ON_CHIP> blk =
      row_block<ON_CHIP>(smem, w, warp_bytes, k, row, values, value_hi, hash_hi, hash_lo, WIDE);
  const uint32_t r0h = salts[4 * r], r0l = salts[4 * r + 1];
  const uint32_t r1h = salts[4 * r + 2], r1l = salts[4 * r + 3];
  const int v = valid != nullptr ? valid[r] : B;
  const int vt = v < 0 ? 0 : (v > B ? B : v);
  int sz = size[r];
  bool full = sz >= k;
  uint2 thr = make_uint2(hash_hi[row + k - 1], hash_lo[row + k - 1]);
  bool held = false;
  bool dirty = false;
  const uint32_t* ph_row = pre_hi + static_cast<size_t>(r) * B;
  const uint32_t* pl_row = pre_lo + static_cast<size_t>(r) * B;
  const size_t base = static_cast<size_t>(r) * B * stride;

  Key pend{0u, 0u, 0u, 0u};
  int npend = 0;
  bool ready = !ON_CHIP;
  auto flush = [&]() {
    if (!ready) {
      wait_async();
      __syncwarp();
      ready = true;
    }
    const bool c = lane < npend && below_hashed(pend.h, pend.l, thr, full);
    hashed_round<WIDE, ON_CHIP>(blk, k, lane, c, pend, sz, thr, full, dirty);
  };

  // the hash planes' chunks ahead into L2: lanes 0, 8, 16 and 24 a line
  // of each plane (32 words)
  const bool fetcher = (lane & 7) == 0;
  if (fetcher && kPer * lane + kChunk < vt) {
    prefetch_l2(ph_row + kPer * lane + kChunk);
    prefetch_l2(pl_row + kPer * lane + kChunk);
  }
  for (int off = 0; off < vt; off += kChunk) {
    const int first = off + kPer * lane;
    if (fetcher && first + 2 * kChunk < vt) {
      prefetch_l2(ph_row + first + 2 * kChunk);
      prefetch_l2(pl_row + first + 2 * kChunk);
    }
    uint32_t sh[kPer] = {0u, 0u, 0u, 0u}, sl[kPer] = {0u, 0u, 0u, 0u};
    load_words(ph_row, vec != 0, first, vt, sh);
    load_words(pl_row, vec != 0, first, vt, sl);
    unsigned bal[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) dhash::scramble64(sh[e], sl[e], r0h, r0l, r1h, r1l);
    int pre[kPer];
    int total = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      bal[e] = __ballot_sync(kFull, first + e < vt && below_hashed(sh[e], sl[e], thr, full));
      pre[e] = total;
      total += __popc(bal[e]);
    }
    if (total == 0) continue;
    if constexpr (ON_CHIP) {
      if (!held) {
        copy_in<WIDE>(blk, lane, k, row, values, value_hi, hash_hi, hash_lo);
        held = true;
      }
    }
    for (int done = 0; done < total;) {
      const int take = 32 - npend < total - done ? 32 - npend : total - done;
      const int g = done + lane - npend;
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
      uint32_t a = 0u, b = 0u;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (bal[e] == 0u) continue;  // warp-uniform
        const uint32_t x = __shfl_sync(kFull, sh[e], src), y = __shfl_sync(kFull, sl[e], src);
        if (es == e) {
          a = x;
          b = y;
        }
      }
      if (recv) {  // the value words, from the tile at the candidate's lane
        const size_t at = base + static_cast<size_t>(off + kPer * src + es) * stride;
        const uint32_t x = __ldg(tile_lo + at);
        pend = Key{a, b, WIDE ? __ldg(tile_hi + at) : sign_hi(x), x};
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
    if (dirty) write_back<WIDE>(blk, lane, k, row, values, value_hi, hash_hi, hash_lo);
  }
  if (lane == 0) {
    size[r] = sz;
    count[r] = static_cast<int32_t>(static_cast<uint32_t>(count[r]) + static_cast<uint32_t>(v));
  }
}

// Shared memory a warp takes for its row's block (16-byte aligned), and the
// warps a block runs on chip; 0 warps when one row's block does not fit
// (the kernels' static shared memory, none, is counted: kStaticSmem).
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

// A launch's arguments, as the C entry points take them.
struct Args {
  uint32_t* values;
  uint32_t* value_hi;  // null for narrow keys
  uint32_t* hash_hi;
  uint32_t* hash_lo;
  int32_t* size;
  int32_t* count;
  const uint32_t* salts;
  const uint32_t* tile_lo;
  const uint32_t* tile_hi;
  int stride;
  const uint32_t* pre_hi;  // the pre-hashed kernel's planes, else null
  const uint32_t* pre_lo;
  const int32_t* valid;
  int R, k, B;
};

template <typename Kernel>
int allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return static_cast<int>(cudaSuccess);
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

inline bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <bool WIDE, bool ON_CHIP, int RULE>
int launch(const Shape& sh, const Args& a, cudaStream_t stream) {
  const int blocks = (a.R + sh.warps - 1) / sh.warps;
  const int wb = static_cast<int>(warp_bytes(WIDE, a.k));
  if constexpr (RULE == kHashed) {
    const int e = allow_smem(hashed_kernel<WIDE, ON_CHIP>, sh.smem);
    if (e != 0) return e;
    // the kernel loads the hash planes by chunk; the value words are gathered
    const int vec = a.B % 4 == 0 && aligned(a.pre_hi) && aligned(a.pre_lo);
    hashed_kernel<WIDE, ON_CHIP><<<blocks, sh.warps * 32, sh.smem, stream>>>(
        a.values, a.value_hi, a.hash_hi, a.hash_lo, a.size, a.count, a.salts, a.tile_lo, a.tile_hi,
        a.stride, vec, a.pre_hi, a.pre_lo, a.valid, a.R, a.k, a.B, wb);
  } else {
    const int e = allow_smem(update_kernel<WIDE, ON_CHIP, RULE == kKeepMax>, sh.smem);
    if (e != 0) return e;
    const int vec = a.B % 4 == 0 && aligned(a.tile_lo) && (!WIDE || a.stride == 2 || aligned(a.tile_hi));
    update_kernel<WIDE, ON_CHIP, RULE == kKeepMax><<<blocks, sh.warps * 32, sh.smem, stream>>>(
        a.values, a.value_hi, a.hash_hi, a.hash_lo, a.size, a.count, a.salts, a.tile_lo, a.tile_hi,
        a.stride, vec, a.valid, a.R, a.k, a.B, wb);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int RULE>
int launch_rule(const Shape& sh, const Args& a, cudaStream_t stream) {
  if (a.value_hi != nullptr)
    return sh.on_chip ? launch<true, true, RULE>(sh, a, stream) : launch<true, false, RULE>(sh, a, stream);
  return sh.on_chip ? launch<false, true, RULE>(sh, a, stream) : launch<false, false, RULE>(sh, a, stream);
}

// The merge of rule `rule` at launch shape sh.
int launch_shape(const Shape& sh, int rule, const Args& a, cudaStream_t stream) {
  if (a.R <= 0) return static_cast<int>(cudaSuccess);
  const bool planes = a.pre_hi != nullptr && a.pre_lo != nullptr;
  if ((a.pre_hi == nullptr) != (a.pre_lo == nullptr) || (rule == kHashed) != planes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rule == kHashed) return launch_rule<kHashed>(sh, a, stream);
  if (rule == kKeepMax) return launch_rule<kKeepMax>(sh, a, stream);
  if (rule == kDefault) return launch_rule<kDefault>(sh, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool WIDE, bool ON_CHIP>
int query(int rule, int threads, size_t smem, int* out) {
  if (rule == kHashed) return kinfo::query(hashed_kernel<WIDE, ON_CHIP>, threads, smem, out);
  if (rule == kKeepMax) return kinfo::query(update_kernel<WIDE, ON_CHIP, true>, threads, smem, out);
  if (rule == kDefault) return kinfo::query(update_kernel<WIDE, ON_CHIP, false>, threads, smem, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

int info(const Shape& sh, int rule, bool wide, int* out) {
  const int threads = sh.warps * 32;
  if (wide)
    return sh.on_chip ? query<true, true>(rule, threads, sh.smem, out)
                      : query<true, false>(rule, threads, 0, out);
  return sh.on_chip ? query<false, true>(rule, threads, sh.smem, out)
                    : query<false, false>(rule, threads, 0, out);
}

}  // namespace dst

extern "C" {

// One distinct tile merge in place of rule (0 default, the Pallas kernel's;
// 1 pre-hashed; 2 keep-max, the XLA sort-merge's: every lane of a row that
// is not full is a candidate) at up to warps rows a block (1 to 4;
// shape_for): the wrapper's one launcher.  value_hi and tile_hi are null
// for narrow keys.  Lane p of row r is word (r * B + p) * stride of tile_lo
// (and tile_hi); stride 2 is an int64 tile read in place (tile_hi = tile_lo
// + 1).  pre_hi and pre_lo, the [R, B] pre-scramble hash planes (lane p of
// row r is word r * B + p), are given for the pre-hashed rule only.  valid
// may be null (every row takes B).  Returns cudaGetLastError() after the
// launch.
int distinct_update_rows(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
                         uint32_t* hash_lo, int32_t* size, int32_t* count, const uint32_t* salts,
                         const uint32_t* tile_lo, const uint32_t* tile_hi, int stride,
                         const uint32_t* pre_hi, const uint32_t* pre_lo, const int32_t* valid,
                         int R, int k, int B, int warps, int rule, cudaStream_t stream) {
  if (warps < 1 || warps > dst::kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const dst::Args a{values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo, tile_hi,
                    stride, pre_hi, pre_lo, valid, R, k, B};
  return dst::launch_shape(dst::shape_for(value_hi != nullptr, k, warps), rule, a, stream);
}

// Each rule at the default geometry under its own name, as older builds
// have them (kernel_ab.py launches a build of another tree by these).
int distinct_update(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi, uint32_t* hash_lo,
                    int32_t* size, int32_t* count, const uint32_t* salts,
                    const uint32_t* tile_lo, const uint32_t* tile_hi, int stride,
                    const int32_t* valid, int R, int k, int B, cudaStream_t stream) {
  return distinct_update_rows(values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo, tile_hi,
                              stride, nullptr, nullptr, valid, R, k, B, dst::kMaxWarps, dst::kDefault,
                              stream);
}

int distinct_update_keepmax(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
                            uint32_t* hash_lo, int32_t* size, int32_t* count,
                            const uint32_t* salts, const uint32_t* tile_lo,
                            const uint32_t* tile_hi, int stride, const int32_t* valid, int R,
                            int k, int B, cudaStream_t stream) {
  return distinct_update_rows(values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo, tile_hi,
                              stride, nullptr, nullptr, valid, R, k, B, dst::kMaxWarps, dst::kKeepMax,
                              stream);
}

int distinct_update_hashed(uint32_t* values, uint32_t* value_hi, uint32_t* hash_hi,
                           uint32_t* hash_lo, int32_t* size, int32_t* count,
                           const uint32_t* salts, const uint32_t* tile_lo,
                           const uint32_t* tile_hi, int stride, const uint32_t* pre_hi,
                           const uint32_t* pre_lo, const int32_t* valid, int R, int k, int B,
                           cudaStream_t stream) {
  return distinct_update_rows(values, value_hi, hash_hi, hash_lo, size, count, salts, tile_lo, tile_hi,
                              stride, pre_hi, pre_lo, valid, R, k, B, dst::kMaxWarps, dst::kHashed,
                              stream);
}

// The build's registers, spills, shared memory and resident warps an SM of
// the kernel of rule (0 default, 1 pre-hashed, 2 keep-max) that a launch at
// k and up to warps rows a block runs (kinfo::query's five numbers in out);
// its dynamic shared memory is 0 where the row's block stays in global
// memory.
int distinct_rows_kernel_info(int wide, int rule, int k, int warps, int* out) {
  if (warps < 1 || warps > dst::kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  return dst::info(dst::shape_for(wide != 0, k, warps), rule, wide != 0, out);
}

const char* distinct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
