// Native bulk path for host distinct-value (bottom-k) sampling, a copy of
// the JAX package's.
//
// The per-element host path pays interpreter cost for the scramble +
// threshold compare on EVERY element even though almost none are accepted
// once the reservoir is warm (the same observation the reference exploits
// in its hot loop, Sampler.scala:403-408).  Here the whole scan is a tight
// C loop: scramble (the exact Feistel/fmix32 permutation of
// ops/hashing.py::scramble64, integer-identical), one compare against the
// current threshold, and — only for the rare below-threshold candidates —
// a binary search + insert into the sorted bottom-k kept inline.
//
// Semantics match BottomKOracle per-element processing exactly, except
// ordering among *distinct values with identical 64-bit scrambled hashes*
// (probability ~2^-64 per pair; the documented shared bias source), where
// eviction tie-breaking differs.  Dedup is by (hash, value-bits), same as
// the device kernel.
//
// Exposed as a plain C ABI for ctypes (no pybind11).

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// ops/hashing.py::_ROUND_CONSTS
constexpr uint32_t kRound[6] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u,
                                0x27D4EB2Fu, 0x165667B1u, 0x9E3779B1u};

inline uint64_t scramble64(uint64_t v, uint64_t r0, uint64_t r1) {
  uint32_t hi = static_cast<uint32_t>(v >> 32) ^ static_cast<uint32_t>(r0 >> 32);
  uint32_t lo = static_cast<uint32_t>(v) ^ static_cast<uint32_t>(r0);
  for (int i = 0; i < 3; ++i) {
    uint32_t t = hi ^ fmix32(lo + kRound[i]);
    hi = lo;
    lo = t;
  }
  hi ^= static_cast<uint32_t>(r1 >> 32);
  lo ^= static_cast<uint32_t>(r1);
  for (int i = 3; i < 6; ++i) {
    uint32_t t = hi ^ fmix32(lo + kRound[i]);
    hi = lo;
    lo = t;
  }
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// First index in entry_hash[0..size) with hash >= h (lower bound).
inline int32_t lower_bound_hash(const uint64_t* entry_hash, int32_t size,
                                uint64_t h) {
  int32_t lo = 0, hi = size;
  while (lo < hi) {
    int32_t mid = lo + (hi - lo) / 2;
    if (entry_hash[mid] < h) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Is (h, v) already present?  Scan the equal-hash run from its lower bound.
inline bool contains(const uint64_t* entry_hash, const int64_t* entry_val,
                     int32_t size, int32_t pos, uint64_t h, int64_t v) {
  for (int32_t i = pos; i < size && entry_hash[i] == h; ++i) {
    if (entry_val[i] == v) return true;
  }
  return false;
}

}  // namespace

extern "C" {

// Scan n 64-bit values through the salted bottom-k.  entry_hash/entry_val
// hold the current entries sorted by hash ascending (size_io entries);
// updated in place.  Returns the number of insertions/evictions performed
// (>= 0), or -1 on invalid arguments.
int64_t rsv_bottomk_scan(const int64_t* values, int64_t n, uint64_t r0,
                         uint64_t r1, uint64_t* entry_hash,
                         int64_t* entry_val, int32_t* size_io, int32_t k) {
  if (!values || !entry_hash || !entry_val || !size_io || k <= 0 || n < 0 ||
      *size_io < 0 || *size_io > k) {
    return -1;
  }
  int32_t size = *size_io;
  uint64_t threshold =
      size == k ? entry_hash[k - 1] : ~static_cast<uint64_t>(0);
  int64_t edits = 0;
  // Block-wise two-pass structure: the scramble loop has no cross-lane
  // dependencies or branches, so the compiler vectorizes it (VPU-style);
  // the candidate pass is a predictable almost-never-taken branch.
  constexpr int64_t kBlock = 4096;
  uint64_t hbuf[kBlock];
  for (int64_t base = 0; base < n; base += kBlock) {
    const int64_t m = (n - base < kBlock) ? n - base : kBlock;
    const int64_t* vblk = values + base;
    for (int64_t j = 0; j < m; ++j) {
      hbuf[j] = scramble64(static_cast<uint64_t>(vblk[j]), r0, r1);
    }
    for (int64_t j = 0; j < m; ++j) {
      const uint64_t h = hbuf[j];
      if (h >= threshold) continue;  // the hot path: one compare
      const int64_t v = vblk[j];
      int32_t pos = lower_bound_hash(entry_hash, size, h);
      if (contains(entry_hash, entry_val, size, pos, h, v)) continue;
      if (size == k) {
        // insert at pos, evict the max (last) entry
        std::memmove(entry_hash + pos + 1, entry_hash + pos,
                     sizeof(uint64_t) * (k - pos - 1));
        std::memmove(entry_val + pos + 1, entry_val + pos,
                     sizeof(int64_t) * (k - pos - 1));
        entry_hash[pos] = h;
        entry_val[pos] = v;
        threshold = entry_hash[k - 1];
      } else {
        std::memmove(entry_hash + pos + 1, entry_hash + pos,
                     sizeof(uint64_t) * (size - pos));
        std::memmove(entry_val + pos + 1, entry_val + pos,
                     sizeof(int64_t) * (size - pos));
        entry_hash[pos] = h;
        entry_val[pos] = v;
        ++size;
        if (size == k) threshold = entry_hash[k - 1];
      }
      ++edits;
    }
  }
  *size_io = size;
  return edits;
}

}  // extern "C"
