// Algorithm-L tile update for R lockstep reservoirs, for Hopper (sm_90a).
//
// Replaces the TPU kernel reservoir_tpu/ops/algorithm_l_pallas.py:_kernel
// (entry points update_pallas and update_steady_pallas).  It computes the
// same function: an optional fill-phase copy (the element with absolute
// index i <= k goes to slot i-1), then, per reservoir, every acceptance
// inside the tile: gather batch[r, nxt-count-1], draw the Threefry words
// keyed on the absolute index nxt, update log W and the skip with XLA's
// float32 log/exp/log1p, and overwrite a uniform slot.
//
// Bound.  Per tile with A accepts over all rows: bytes R*28 of state, one
// 32-byte sector gathered per accept (no more than the tile) and one written
// (no more than the samples); per accept ~170 operations that only the
// INT32 pipe issues (4 Threefry blocks' 40 rotations and xors each, and the
// draw words' xors, shifts, compares and selects; the adds may issue as
// IMAD on the FMA pipe) and ~130 float ops.  At R = 65,536, k = 128,
// B = 2,048 a steady tile from count 14,336 has ~1.1 M accepts, bound by
// its bytes (~21 us), and a fill tile from count 0 ~23 M, bound by its
// operations (~0.23 ms).
// What the byte count does not see: each steady gather is a random read of
// HBM, which an H100 serves at ~20 G a second, not at its streaming rate,
// so ~1.1 M of them take ~57 us on their own (PERF.md, Findings).
// chip_smoke.py reports the measured times beside the bounds.
//
// What held the first design back (one thread a row gathering and writing
// each accept inside its chain; PERF.md, Findings): with the gather and the
// write removed, a steady tile took 44% of its time and a fill tile 58%;
// the per-thread fill copy took 12% of the fill; the slot's Threefry block
// cost nothing measurable; equal accept counts in every row saved 4-12%.
// The chain itself is bound by the integer pipe: 287 of its 536
// instructions an accept (the Threefry rounds' SHF and LOP3 among them)
// issue at half rate, ~16 warps an SM.
//
// Design.  Blocks of 128 threads over R; a thread walks its row's chain and
// never waits on memory inside it.
// - Each accept starts its gather at once, as a cp.async of the 4-byte
//   element into a per-thread ring in shared memory (kList entries, its
//   slot beside it), and the chain goes on.  When the ring is full, the
//   oldest kList - kLag accepts, whose gathers have had kLag accepts' time
//   to land, are written to their slots; the rest when the row is done.
//   One thread writes a row, in acceptance order, so a later accept to a
//   slot wins by program order.  A small ring leaves L1 room for the fill
//   tile's dense gathers (32 entries a thread ran 43% slower there).
// - L2 policies: the tile's words are gathered evict_first (read once), the
//   samples written evict_last; on a fill tile that keeps the samples the
//   fill copy wrote in L2 (without them the fill tile took 67% longer).
// - A full row that expects many accepts (count <= kPrefetchSpan * valid)
//   has its samples brought into L2 by one bulk prefetch before its chain
//   starts, so its scattered writes do not each wait on a random read of
//   HBM.  A row expects ~k * v / c accepts; the span (~k / 11 of them at
//   k = 128) is where a prefetched row and its writes into cold sectors
//   cost about the same on an H100, read from memory-only variants of this
//   kernel.  Prefetching every full row instead made a tile deep in the
//   stream ~9% slower (PERF.md, Findings).
// - The fill copy is coalesced: a warp copies its rows' prefixes a row at a
//   time, 32 lanes wide, four rows' loads in flight, with 16-byte words
//   where the row, the slots and the pointers are 4-word aligned; it comes
//   before any accept's write (__syncwarp).
// - Per-row constants are hoisted: f32(1/k) once, w2 % k by Lemire's
//   multiply-high remainder (exact for every uint32 and every k >= 1), and
//   the two logs of uniform draws skip xla_log's special cases, which a
//   draw in [2^-24, 1] never takes.
// State is updated in place (count += valid included).  Samples and batch
// move as 32-bit words and are never touched as floats, which keeps -0.0
// and NaN payloads.
//
// The gated update of the skip gate (algl_update_gated, below) walks the
// same chain (algl_chain.cuh) over the candidates the gate shipped.
//
// WIDE counters (algl_update_wide).  The same kernel, instantiated for a
// 64-bit count and nxt (ops/u64e.py's [R, 2] uint32 (lo, hi) words, read in
// place as little-endian uint64).  The reference has no TPU kernel for
// them: algorithm_l_pallas.supports() declines WIDE states
// (reservoir_tpu/ops/algorithm_l_pallas.py:103), so its WIDE updates run
// XLA's _accept_loop (reservoir_tpu/ops/algorithm_l.py:211-256).  The port
// gives them this kernel rather than a lockstep loop of small launches on
// the card.  The chain is advance_wide (algl_chain.cuh): the draws keyed on
// the index block (hi, lo), the skip added exactly, no saturation.  A fill
// exists only while count < k; the tile-local position is the low words'
// difference.  Bound: as the int32 kernel's, with 8-byte count and nxt
// (R*44 bytes of state); a zero high word walks the int32 chain bit for bit.
//
// Launch geometry.  Rows a block (threads, one a row) is a launch choice
// from {32, 64, 128, 256}, each a template instantiation with its own
// __launch_bounds__ (a thread's ring takes 128 bytes of static shared
// memory: 32 KiB at 256 threads, under the 48 KiB static limit).  The
// default, kThreads = 128, is what algl_update, algl_update_wide and
// algl_update_gated launch; the *_rows entry points take another from the
// autotune cache (ops/autotune.py).  A row's result does
// not depend on the block it runs in: the fill copy goes by whole warps,
// and the gated kernel only reorders the rows of a block among its warps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (see reservoir_tpu_torch/_build.py).  Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "algl_chain.cuh"
#include "kinfo.cuh"

namespace algl {

constexpr int kThreads = 128;
constexpr int kList = 16;     // accepts a thread holds recorded and not yet written
constexpr int kLag = 4;       // of which the newest, whose gathers may be in flight
constexpr int kFillRows = 4;  // rows whose fill loads a warp keeps in flight
constexpr int kPrefetchSpan = 12;  // a full row's samples are prefetched while c <= 12 v
static_assert((kList & (kList - 1)) == 0 && kLag < kList, "a ring of 2^n entries");
constexpr unsigned kFull = 0xFFFFFFFFu;

// L2 policies: evict_first for the tile's gathered words, which are read
// once, and evict_last for the samples, which take many scattered writes.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// A 4-byte load of read-only data under an L2 policy.
__device__ __forceinline__ uint32_t load4(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

// 4 bytes from global to shared memory without waiting (cp.async) under an
// L2 policy, as a group of its own; and the wait until at most N of this
// thread's most recent such groups are still in flight.
__device__ __forceinline__ void copy4_async(void* dst, const void* src, uint64_t policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, 4, %2;\n"
      "cp.async.commit_group;\n" ::"r"(d),
      "l"(src), "l"(policy)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wait_async_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The n bytes at p (16-byte aligned, n a multiple of 16) into L2 under a
// policy, without waiting (one bulk prefetch).
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t n, uint64_t policy) {
  asm volatile("cp.async.bulk.prefetch.L2.global.L2::cache_hint [%0], %1, %2;" ::"l"(p), "r"(n),
               "l"(policy)
               : "memory");
}

// A 4-byte store under an L2 policy.
__device__ __forceinline__ void store4(uint32_t* p, uint32_t v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(p), "r"(v), "l"(policy)
               : "memory");
}

// The warp's fill copy, W words a lane (1, or 4 as one 16-byte word): row
// j of the warp (row0 + j) copies its elements s_j + i to slots d_j + i for
// i < m_j.  Lane l holds s, d and m of row l; rows with nothing to copy
// (rows past R among them) hold m = 0.
template <int W>
__device__ __forceinline__ void fill_rows(uint32_t* __restrict__ samples,
                                          const uint32_t* __restrict__ batch, int row0, int s,
                                          int d, int m, int k, int B, int lane) {
  using V = typename std::conditional<W == 4, uint4, uint32_t>::type;
  for (int j0 = 0; j0 < 32; j0 += kFillRows) {
    const uint32_t* src[kFillRows];
    uint32_t* dst[kFillRows];
    int mj[kFillRows], most = 0;
#pragma unroll
    for (int q = 0; q < kFillRows; ++q) {
      const int j = row0 + j0 + q;
      src[q] = batch + static_cast<size_t>(j) * B + __shfl_sync(kFull, s, j0 + q);
      dst[q] = samples + static_cast<size_t>(j) * k + __shfl_sync(kFull, d, j0 + q);
      mj[q] = __shfl_sync(kFull, m, j0 + q);
      most = mj[q] > most ? mj[q] : most;
    }
    for (int i = lane * W; i < most; i += 32 * W) {
      V x[kFillRows];
#pragma unroll
      for (int q = 0; q < kFillRows; ++q)
        if (i < mj[q]) x[q] = __ldg(reinterpret_cast<const V*>(src[q] + i));
#pragma unroll
      for (int q = 0; q < kFillRows; ++q)
        if (i < mj[q]) *reinterpret_cast<V*>(dst[q] + i) = x[q];
    }
  }
}

// A row's count and nxt: int32, or uint64 for WIDE counters.
template <bool kWide>
using Counter = typename std::conditional<kWide, uint64_t, int32_t>::type;

template <bool kWide, int kT>
__global__ void __launch_bounds__(kT)
update_kernel(uint32_t* __restrict__ samples, Counter<kWide>* __restrict__ count,
              Counter<kWide>* __restrict__ nxt, float* __restrict__ log_w,
              const uint32_t* __restrict__ key, const uint32_t* __restrict__ batch,
              const int32_t* __restrict__ valid, int R, int k, int B, int fill, int vec,
              uint64_t kmod) {
  using C = Counter<kWide>;
  // the thread's recorded accepts: the gathered element (copied in by
  // cp.async while the chain goes on) and the slot, entry d of thread t at
  // [d][t], so a warp's lanes touch 32 banks whatever their d
  __shared__ uint32_t lelem[kList][kT];
  __shared__ int32_t lslot[kList][kT];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int r = blockIdx.x * kT + t;
  const bool live = r < R;  // rows past R ride along, whole warps only
  C c = 0, n = 1;
  int32_t v = 0;
  float lw = 0.0f;
  uint32_t k1 = 0u, k2 = 0u;
  if (live) {
    c = count[r];
    v = valid != nullptr ? valid[r] : B;
    n = nxt[r];
    lw = log_w[r];
    k1 = key[2 * r];
    k2 = key[2 * r + 1];
  }
  const uint32_t* row = batch + static_cast<size_t>(r) * B;
  uint32_t* out = samples + static_cast<size_t>(r) * k;

  if (fill) {
    // elements j < min(v, k - c) go to slot c + j; as the Pallas kernel,
    // a slot below 0 (an int32 count past int32 max) takes nothing
    int64_t lo = 0, hi = 0;
    if (live && c < static_cast<C>(k)) {
      const int64_t c64 = static_cast<int64_t>(c);  // in [0, k) when WIDE
      lo = c64 < 0 ? -c64 : 0;
      hi = min(static_cast<int64_t>(v), static_cast<int64_t>(k) - c64);
    }
    const int m = hi > lo ? static_cast<int>(hi - lo) : 0;
    const int s = m > 0 ? static_cast<int>(lo) : 0;
    const int d = m > 0 ? static_cast<int>(c + lo) : 0;
    if (__any_sync(kFull, m > 0)) {
      // 16-byte words only where every row the warp copies is aligned:
      // whole words from element 0 to a slot that is a multiple of 4
      const bool ok = m == 0 || (s == 0 && (d & 3) == 0 && (m & 3) == 0);
      if (vec && __all_sync(kFull, ok))
        fill_rows<4>(samples, batch, r - lane, s, d, m, k, B, lane);
      else
        fill_rows<1>(samples, batch, r - lane, s, d, m, k, B, lane);
    }
    __syncwarp();  // the copy's writes, by any lane, before the accepts' below
  }

  // int32 wraparound as in the reference's count + valid (WIDE: mod 2^64)
  const C end = kWide ? static_cast<C>(static_cast<uint64_t>(c) + static_cast<uint32_t>(v))
                      : static_cast<C>(static_cast<uint32_t>(c) + static_cast<uint32_t>(v));
  const float inv_k = __fdiv_rn(1.0f, __int2float_rn(k));
  const uint64_t once = evict_first(), kept = evict_last();
  // a full row expecting about k * v / c accepts: when that many random
  // 32-byte writes cost more than streaming its 4k bytes of samples, the
  // row is brought into L2 now, while the chain runs (see the note above)
  if (live && n <= end && c >= static_cast<C>(k) &&
      static_cast<uint64_t>(c) <= kPrefetchSpan * static_cast<uint64_t>(v)) {
    const uint64_t bytes = 4ull * static_cast<uint32_t>(k);
    if (((reinterpret_cast<uintptr_t>(out) | bytes) & 15u) == 0 && bytes < (1ull << 31))
      prefetch_l2(out, static_cast<uint32_t>(bytes), kept);
    else
      for (int i = 0; i < k; i += 8) asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(out + i));
  }
  // the ring of recorded accepts: head counts those recorded, tail those
  // written; entry i lives at i % kList
  uint32_t head = 0, tail = 0;
  bool more = live && n <= end;
  while (more) {
    if (head - tail == kList) {
      // full: write the oldest, whose gathers were started kLag accepts ago
      wait_async_but<kLag>();
      for (; tail != head - kLag; ++tail)
        store4(out + lslot[tail % kList][t], lelem[tail % kList][t], kept);
    }
    // the reference's gather index rule: wrap a negative index, then clamp;
    // WIDE: the low words' difference less 1, in int32 (u64e.diff_small)
    int64_t pos = kWide ? static_cast<int64_t>(static_cast<int32_t>(
                              static_cast<uint32_t>(n) - 1u - static_cast<uint32_t>(c)))
                        : static_cast<int64_t>(n) - static_cast<int64_t>(c) - 1;
    if (pos < 0) pos += B;
    pos = pos < 0 ? 0 : (pos >= B ? B - 1 : pos);
    copy4_async(&lelem[head % kList][t], row + pos, once);
    if constexpr (kWide)
      lslot[head % kList][t] = advance_wide(lw, n, k1, k2, static_cast<uint32_t>(k), kmod, inv_k);
    else
      lslot[head % kList][t] = advance(lw, n, k1, k2, static_cast<uint32_t>(k), kmod, inv_k);
    ++head;
    more = n <= end;
  }
  // the rest, once every gather of the thread has landed
  wait_async_but<0>();
  for (; tail != head; ++tail) store4(out + lslot[tail % kList][t], lelem[tail % kList][t], kept);
  if (live) {
    nxt[r] = n;
    log_w[r] = lw;
    count[r] = end;
  }
}

// The gated update (algl_update_gated): one thread a row.  Row r took
// advance[r] logical elements, of which the nvalid[r] candidates in
// tile[r, :nvalid[r]] were shipped by the skip gate: the first
// f = clip(k - count, 0, advance) are the fill prefix, copied to slots
// count.., and each later one is the acceptance at absolute index nxt,
// written to the slot its draws pick.  No tile element but a candidate is
// read, and none is skipped: the gate proved that.  The reference is XLA
// (reservoir_tpu/ops/algorithm_l.py:_update_gated_one), not Pallas.
// Bound: the state (R*36 bytes with nvalid and advance), each candidate
// read once and each written sample's sector; ~170 INT32-pipe and ~134
// float operations an acceptance, as in the tile update.
//
// What held the first design back (a thread walking its row's candidates
// in order, the block's rows in row order; PERF.md, Findings), on the
// skip gate's steady candidate tile (R = 65,536, k = 128, ~24 accepts a
// row): the slot writes, random 4-byte writes into cold samples, 39% of
// its time; unequal rows in a warp 11%; the strided candidate reads 3%.
// With all memory taken out the chain took 58% of it: with ~16 warps an SM
// (one thread a row), the chain waits on its own latency.
//
// Design.  A thread still walks one row's candidates in order, so a later
// accept to a slot wins by program order.
// - The block's 128 rows are ranked by their accept candidates, most
//   first, and thread t walks the rank-t row: a warp's rows are of near
//   length, so a warp waits less on its longest row.
// - A row with many accepts ((nvalid - f) * 11 > k, the span rule of
//   algl_update above) has its samples brought into L2 by one bulk prefetch
//   under evict_last before its chain starts, so its scattered writes find
//   their sectors in L2; every row reads its candidates evict_first and
//   writes its slots evict_last, as algl_update does.  On the steady tile
//   this cut the kernel's time by about a quarter; the deep tile (~5
//   accepts a row) stayed within its noise (PERF.md, Findings).  Staging
//   the rows' samples in shared memory does not fit: 512 bytes a row at
//   k = 128 for ~16 resident warps an SM is more than an SM holds.
template <int kT>
__global__ void __launch_bounds__(kT)
gated_kernel(uint32_t* __restrict__ samples, int32_t* __restrict__ count,
             int32_t* __restrict__ nxt, float* __restrict__ log_w,
             const uint32_t* __restrict__ key, const uint32_t* __restrict__ tile,
             const int32_t* __restrict__ nvalid, const int32_t* __restrict__ steps, int R,
             int k, int Bg, uint64_t kmod) {
  __shared__ int32_t accepts[kT];
  __shared__ int32_t order[kT];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kT;
  // clip(k - count, 0, advance), k - count wrapping in int32 as XLA's does
  auto fill_of = [k](int32_t c, int32_t adv) {
    int32_t f = static_cast<int32_t>(static_cast<uint32_t>(k) - static_cast<uint32_t>(c));
    f = f < 0 ? 0 : f;
    return f > adv ? adv : f;
  };
  {
    int32_t mine = -1;  // rows past R rank last
    if (r0 + t < R) {
      const int32_t nv = nvalid[r0 + t], f = fill_of(count[r0 + t], steps[r0 + t]);
      mine = nv > f ? nv - f : 0;
    }
    accepts[t] = mine;
    __syncthreads();
    int rank = 0;
    for (int j = 0; j < kT; ++j) {
      const int32_t other = accepts[j];
      rank += other > mine || (other == mine && j < t);
    }
    order[rank] = t;
    __syncthreads();
  }
  const int r = r0 + order[t];
  if (r >= R) return;
  const int32_t c = count[r];
  const int32_t adv = steps[r];
  const int32_t nv = nvalid[r];
  const int32_t f = fill_of(c, adv);
  const uint32_t* row = tile + static_cast<size_t>(r) * Bg;
  uint32_t* out = samples + static_cast<size_t>(r) * k;
  const uint64_t bytes = 4ull * static_cast<uint32_t>(k);
  const bool span = static_cast<int64_t>(nv - f) * 11 > k && bytes < (1ull << 31) &&
                    ((reinterpret_cast<uintptr_t>(out) | bytes) & 15u) == 0;
  const uint64_t once = evict_first(), kept = evict_last();
  if (span) prefetch_l2(out, static_cast<uint32_t>(bytes), kept);
  const int nf = f < Bg ? f : Bg;
  for (int j = 0; j < nf; ++j) {
    const int64_t d = static_cast<int64_t>(c) + j;
    if (d >= 0 && d < k) out[d] = __ldg(row + j);
  }
  int32_t n = nxt[r];
  float lw = log_w[r];
  const uint32_t k1 = key[2 * r], k2 = key[2 * r + 1];
  const float inv_k = __fdiv_rn(1.0f, __int2float_rn(k));
  for (int j = f; j < nv; ++j) {
    const uint32_t e = load4(row + j, once);
    store4(out + advance(lw, n, k1, k2, static_cast<uint32_t>(k), kmod, inv_k), e, kept);
  }
  nxt[r] = n;
  log_w[r] = lw;
  count[r] = static_cast<int32_t>(static_cast<uint32_t>(c) + static_cast<uint32_t>(adv));
}

__global__ void fmath_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
                             int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  y[i] = which == 0 ? xla_log(x[i]) : (which == 1 ? xla_exp(x[i]) : xla_log1p(x[i]));
}

}  // namespace algl

namespace algl {

// Calls f with the instantiation's block size as a compile-time constant:
// f(std::integral_constant<int, T>{}) for threads T in {32, 64, 128, 256};
// any other count is cudaErrorInvalidValue.
template <typename F>
int with_threads(int threads, F&& f) {
  switch (threads) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One tile update of either counter width, in place, threads rows a block.
template <bool kWide>
int launch_update(uint32_t* samples, Counter<kWide>* count, Counter<kWide>* nxt, float* log_w,
                  const uint32_t* key, const uint32_t* batch, const int32_t* valid, int R, int k,
                  int B, int fill, int threads, cudaStream_t stream) {
  if (R <= 0 || B <= 0) return static_cast<int>(cudaSuccess);  // an empty tile changes nothing
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; };
  if (kWide && !(aligned(count, 8) && aligned(nxt, 8))) return static_cast<int>(cudaErrorMisalignedAddress);
  const int vec = B % 4 == 0 && k % 4 == 0 && aligned(samples, 16) && aligned(batch, 16);
  const uint64_t kmod = fastmod_multiplier(static_cast<uint32_t>(k));
  return with_threads(threads, [&](auto t) {
    constexpr int kT = decltype(t)::value;
    update_kernel<kWide, kT><<<(R + kT - 1) / kT, kT, 0, stream>>>(
        samples, count, nxt, log_w, key, batch, valid, R, k, B, fill, vec, kmod);
    return static_cast<int>(cudaGetLastError());
  });
}

// One gated update, in place, threads rows a block.
int launch_gated(uint32_t* samples, int32_t* count, int32_t* nxt, float* log_w,
                 const uint32_t* key, const uint32_t* tile, const int32_t* nvalid,
                 const int32_t* advance, int R, int k, int Bg, int threads, cudaStream_t stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1 || Bg < 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t kmod = fastmod_multiplier(static_cast<uint32_t>(k));
  return with_threads(threads, [&](auto t) {
    constexpr int kT = decltype(t)::value;
    gated_kernel<kT><<<(R + kT - 1) / kT, kT, 0, stream>>>(samples, count, nxt, log_w, key, tile,
                                                           nvalid, advance, R, k, Bg, kmod);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace algl

extern "C" {

// One tile update, in place, at the default geometry (kThreads rows a
// block).  valid may be null (every row takes B).  Returns
// cudaGetLastError() after the launch.
int algl_update(uint32_t* samples, int32_t* count, int32_t* nxt, float* log_w,
                const uint32_t* key, const uint32_t* batch, const int32_t* valid, int R,
                int k, int B, int fill, cudaStream_t stream) {
  return algl::launch_update<false>(samples, count, nxt, log_w, key, batch, valid, R, k, B, fill,
                                    algl::kThreads, stream);
}

// algl_update at threads rows a block (32, 64, 128 or 256).
int algl_update_rows(uint32_t* samples, int32_t* count, int32_t* nxt, float* log_w,
                     const uint32_t* key, const uint32_t* batch, const int32_t* valid, int R,
                     int k, int B, int fill, int threads, cudaStream_t stream) {
  return algl::launch_update<false>(samples, count, nxt, log_w, key, batch, valid, R, k, B, fill,
                                    threads, stream);
}

// algl_update for WIDE counters: count and nxt are [R] uint64 (the [R, 2]
// uint32 (lo, hi) words in place, 8-byte aligned).
int algl_update_wide(uint32_t* samples, uint64_t* count, uint64_t* nxt, float* log_w,
                     const uint32_t* key, const uint32_t* batch, const int32_t* valid, int R,
                     int k, int B, int fill, cudaStream_t stream) {
  return algl::launch_update<true>(samples, count, nxt, log_w, key, batch, valid, R, k, B, fill,
                                   algl::kThreads, stream);
}

// algl_update_wide at threads rows a block.
int algl_update_wide_rows(uint32_t* samples, uint64_t* count, uint64_t* nxt, float* log_w,
                          const uint32_t* key, const uint32_t* batch, const int32_t* valid, int R,
                          int k, int B, int fill, int threads, cudaStream_t stream) {
  return algl::launch_update<true>(samples, count, nxt, log_w, key, batch, valid, R, k, B, fill,
                                   threads, stream);
}

// One gated update, in place: tile is [R, Bg], nvalid and advance [R]
// (nvalid in [0, Bg], advance >= 0).  Returns cudaGetLastError() after the
// launch.
int algl_update_gated(uint32_t* samples, int32_t* count, int32_t* nxt, float* log_w,
                      const uint32_t* key, const uint32_t* tile, const int32_t* nvalid,
                      const int32_t* advance, int R, int k, int Bg, cudaStream_t stream) {
  return algl::launch_gated(samples, count, nxt, log_w, key, tile, nvalid, advance, R, k, Bg,
                            algl::kThreads, stream);
}

// algl_update_gated at threads rows a block.
int algl_update_gated_rows(uint32_t* samples, int32_t* count, int32_t* nxt, float* log_w,
                           const uint32_t* key, const uint32_t* tile, const int32_t* nvalid,
                           const int32_t* advance, int R, int k, int Bg, int threads,
                           cudaStream_t stream) {
  return algl::launch_gated(samples, count, nxt, log_w, key, tile, nvalid, advance, R, k, Bg,
                            threads, stream);
}

// The kernel's log (which = 0), exp (1) or log1p (2) over n floats, for
// holding the device math against ops/fmath.py.
int algl_fmath(const float* x, float* y, int n, int which, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  algl::fmath_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(x, y, n, which);
  return static_cast<int>(cudaGetLastError());
}

// The build's registers, spills, shared memory and resident warps an SM of
// the update kernel (kinfo::query's five numbers in out).
int algl_kernel_info(int* out) {
  return kinfo::query(algl::update_kernel<false, algl::kThreads>, algl::kThreads, 0, out);
}

// kinfo::query's five numbers of the WIDE update kernel.
int algl_wide_kernel_info(int* out) {
  return kinfo::query(algl::update_kernel<true, algl::kThreads>, algl::kThreads, 0, out);
}

// kinfo::query's five numbers of the gated kernel.
int algl_gated_kernel_info(int* out) {
  return kinfo::query(algl::gated_kernel<algl::kThreads>, algl::kThreads, 0, out);
}

// kinfo::query's five numbers of the instantiation at threads rows a block:
// which = 0 the update kernel, 1 its WIDE instantiation, 2 the gated one.
int algl_rows_kernel_info(int which, int threads, int* out) {
  return algl::with_threads(threads, [&](auto t) {
    constexpr int kT = decltype(t)::value;
    if (which == 0) return kinfo::query(algl::update_kernel<false, kT>, kT, 0, out);
    if (which == 1) return kinfo::query(algl::update_kernel<true, kT>, kT, 0, out);
    return kinfo::query(algl::gated_kernel<kT>, kT, 0, out);
  });
}

const char* algl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
