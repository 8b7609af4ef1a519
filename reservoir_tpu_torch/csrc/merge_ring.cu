// All-gather of per-rank part blocks for the reservoir merge, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel reservoir_tpu/ops/merge_pallas.py:_ring_kernel
// (entry points ring_all_gather and gather_parts).  It computes the same
// function: each of d ranks holds, for every state leaf, a block of n
// 32-bit words; afterwards every rank holds, for every leaf, the d blocks
// in rank order ([d, n] words).  Data movement only: no word is touched as
// a value, so -0.0 and NaN payloads survive.
//
// Design: direct reads, not a forwarding ring.  The TPU kernel forwards
// each block d - 1 hops because its interconnect links neighbours only; an
// H100 host is all to all over NVLink, and ranks that share one card are
// trivially so.  So a card reads each peer's block from its owner through
// a peer pointer, once.  The kernel does not care on which card a pointer
// lives: the same code serves d ranks on one card and d cards.  The TPU
// version first packs the leaves of a row into one [b, W] matrix so that a
// hop is one DMA; here one launch walks every leaf in place, which saves
// the pack and unpack passes and moves the same words.
//
// One launch a card: blockIdx.x runs over the card's ranks and blockIdx.y
// over a rank's blocks of threads.  Ranks that share a card share their
// reads: the card's blocks together walk every source block once and store
// each word into the slot of every rank on the card.  So d ranks on one
// card read each input once and write each output once, which is the
// bound below; d cards read each peer's block once over NVLink.  On the
// card, a block's first thread moves the source blocks with the bulk copy
// engine (TMA): each 8 KB tile of a source block comes once into a ring of
// four shared-memory stages (cp.async.bulk, completing on the stage's
// mbarrier) and goes out to each local rank's slot from there, one bulk
// store a rank, so no register carries a word and the threads issue one
// instruction a tile and rank; the card's blocks share the tiles out.  A
// block that is not 16-byte aligned at its source or at any slot, and the
// last few bytes of one that is, go through the threads, 16 bytes a thread
// where aligned, 4 elsewhere (neighbouring threads on neighbouring
// addresses), as do the other cards' blocks: a bulk copy through a peer
// pointer is not used.  Each source block's mode is fixed by the host per
// call.  Per launch: (a) each rank's first block announces that the rank
// has entered, and the blocks copy the source blocks that live on this
// card (its own ranks'); (b) every block waits until each rank has entered
// this call (its inputs exist: the handshake of the TPU kernel's barrier
// semaphore); (c) the blocks copy the other cards' source blocks from their
// owners; (d) a rank's last block to finish tells every rank that this rank
// is done reading, and the rank's first block stays until all d ranks have
// said so, so no input is freed or overwritten under a peer's reads.
//
// The flags are four words of device memory a rank, on the rank's card:
// {entered, done, status, arrivals}.  entered and done count calls (the
// call number "epoch" and epoch * d), so a second call needs no reset and
// cannot see the first call's signal.  Signals are system-scope release
// stores or reductions after a __threadfence_system(); waits are
// system-scope acquire loads; peer data is loaded past L1 (__ldcg) and the
// outputs are stored as streaming data (__stcs).  Every wait is bounded by
// kTimeoutNs on the global timer: a rank that times out writes 1 (peer
// never entered), 2 (peers never finished) or 3 (a bulk tile never
// arrived) into its status word and leaves; the wrapper's caller reads it
// when it next synchronises and raises.
//
// Ranks wait on each other inside the kernel, so all of a card's blocks
// must be resident at once: the launch is cooperative (refused, not hung,
// when the grid does not fit), and the wrapper sizes the grid from
// merge_ring_max_blocks().  With ranks fastest in the grid, every rank's
// first block is scheduled before any rank's second.  A launch that is
// refused on one card leaves the other cards' ranks to time out.
//
// Bound: bytes only.  Every input word is read once and every output word
// written once: (d + d * d) * n * 4 bytes for a leaf, at 3.35 TB/s when
// the ranks share one card; across cards (d - 1) * n * 4 bytes come into
// each card at 450 GB/s.  chip_smoke.py reports the measured time beside
// the bound (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (see
// reservoir_tpu_torch/_build.py).  Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "kinfo.cuh"

namespace ring {

constexpr int kMaxRanks = 16;
constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;
constexpr int kStages = 4;     // the bulk copy's ring of shared-memory tiles
constexpr int kTile = 8192;    // bytes a stage
constexpr unsigned long long kTimeoutNs = 2000000000ULL;  // 2 s a wait

enum Flag { kEntered = 0, kDone = 1, kStatus = 2, kArrivals = 3 };
// how a source block of a leaf is copied: by the threads, 4 or 16 bytes an
// access, or by the bulk engine (its tail of under 16 bytes by the threads)
enum Mode : unsigned char { kWords4 = 0, kWords16 = 1, kBulk = 2 };

struct Params {
  const uint32_t* src[kMaxLeaves][kMaxRanks];  // src[l][q]: rank q's block of leaf l
  uint32_t* out[kMaxLeaves][kMaxRanks];        // out[l][j]: the j-th local rank's [d, n[l]] output
  long long n[kMaxLeaves];                     // words in one block of leaf l
  unsigned* flags[kMaxRanks];                  // flags[r]: rank r's four flag words
  int local[kMaxRanks];                        // the ranks this launch runs
  unsigned char here[kMaxRanks];               // whether source q lives on this card
  unsigned char mode[kMaxLeaves][kMaxRanks];   // Mode of source q's block of leaf l
  int d, n_leaves;
  unsigned epoch;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Spins until *p has reached target (counts wrap: compared as a signed
// difference); false after kTimeoutNs.
__device__ bool wait_reached(const unsigned* p, unsigned target) {
  const unsigned long long t0 = now_ns();
  while (static_cast<int>(load_acquire(p) - target) < 0) {
    if (now_ns() - t0 > kTimeoutNs) return false;
    __nanosleep(100);
  }
  return true;
}

// Words [from, n) of source q's block of leaf l into slot q of each of the
// m local outputs, by the card's threads (tid of stride): 16-byte accesses
// where the mode says every address is 16-byte aligned (from is a multiple
// of 4), 4-byte ones elsewhere.
__device__ __forceinline__ void copy_words(const Params& p, int l, int q, int m, long long from, bool vec,
                                           long long tid, long long stride) {
  const uint32_t* __restrict__ src = p.src[l][q];
  const long long n = p.n[l], base = static_cast<long long>(q) * n;
  const long long nv = vec ? (n - from) / 4 : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + from);
  auto store4 = [&](long long i, uint4 v) {
    for (int j = 0; j < m; ++j)  // streamed: not read again here
      __stcs(reinterpret_cast<uint4*>(p.out[l][j] + base + from) + i, v);
  };
  long long i = tid;
  // four independent loads in flight a thread
  for (; i + 3 * stride < nv; i += 4 * stride) {
    const uint4 v0 = __ldcg(s4 + i);
    const uint4 v1 = __ldcg(s4 + i + stride);
    const uint4 v2 = __ldcg(s4 + i + 2 * stride);
    const uint4 v3 = __ldcg(s4 + i + 3 * stride);
    store4(i, v0);
    store4(i + stride, v1);
    store4(i + 2 * stride, v2);
    store4(i + 3 * stride, v3);
  }
  for (; i < nv; i += stride) store4(i, __ldcg(s4 + i));
  for (long long w = from + 4 * nv + tid; w < n; w += stride) {
    const uint32_t v = __ldcg(src + w);
    for (int j = 0; j < m; ++j) p.out[l][j][base + w] = v;
  }
}

// The bytes of source q's block of leaf l that the bulk engine copies: the
// whole 16-byte words (none unless its mode is kBulk).
__device__ __forceinline__ long long bulk_bytes(const Params& p, int l, int q) {
  return p.mode[l][q] == kBulk ? (p.n[l] * 4) & ~15LL : 0;
}

// Walks the card's bulk tiles in order (source, then leaf, then offset),
// for tile numbers that only grow.
struct TileWalk {
  int pair = 0;
  long long first = 0;  // the number of the pair's first tile
  int l = 0, q = 0;
  long long off = 0;
  unsigned bytes = 0;

  // Moves to tile g; false past the last.
  __device__ bool at(const Params& p, long long g) {
    for (; pair < p.d * p.n_leaves; ++pair) {
      q = pair / p.n_leaves;
      l = pair - q * p.n_leaves;
      const long long total = bulk_bytes(p, l, q);
      const long long tiles = (total + kTile - 1) / kTile;
      if (g < first + tiles) {
        off = (g - first) * kTile;
        bytes = static_cast<unsigned>(min(static_cast<long long>(kTile), total - off));
        return true;
      }
      first += tiles;
    }
    return false;
  }
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits until the mbarrier at bar has completed the phase of this parity;
// false after kTimeoutNs.
__device__ bool wait_tile(uint32_t bar, uint32_t parity) {
  const unsigned long long t0 = now_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return true;
    if (now_ns() - t0 > kTimeoutNs) return false;
  }
}

// One thread's bulk copy of the tiles block, block + blocks, ...: each tile
// comes once into a stage of shared memory (cp.async.bulk, completing on
// the stage's mbarrier) and goes out to the m local outputs from there
// (cp.async.bulk stores, one bulk group a tile).  A stage is filled again
// once the stores of its tile have read it; kStages - 1 loads stay in
// flight.  Returns when every store has completed, or writes 3 into
// *status when a tile did not arrive within kTimeoutNs.
__device__ void bulk_copy(const Params& p, int m, long long block, long long blocks,
                          unsigned char (*stage)[kTile], unsigned long long* full, unsigned* status) {
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(full + s)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  TileWalk loads, stores;
  long long loaded = 0;
  auto load = [&](int s) {
    if (!loads.at(p, block + loaded * blocks)) return false;
    const uint32_t bar = smem(full + s);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(loads.bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem(stage[s])),
        "l"(reinterpret_cast<const unsigned char*>(p.src[loads.l][loads.q]) + loads.off), "r"(loads.bytes),
        "r"(bar)
        : "memory");
    ++loaded;
    return true;
  };
  for (int s = 0; s < kStages && load(s); ++s) {
  }
  for (long long i = 0; i < loaded; ++i) {
    const int s = static_cast<int>(i % kStages);
    const uint32_t bar = smem(full + s), parity = static_cast<uint32_t>((i / kStages) & 1);
    if (!wait_tile(bar, parity)) {
      atomicCAS(status, 0u, 3u);
      break;
    }
    stores.at(p, block + i * blocks);
    const long long at = static_cast<long long>(stores.q) * p.n[stores.l] * 4 + stores.off;
    for (int j = 0; j < m; ++j)
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                       reinterpret_cast<unsigned char*>(p.out[stores.l][j]) + at),
                   "r"(smem(stage[s])), "r"(stores.bytes)
                   : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (i >= 1 && loaded == i - 1 + kStages) {
      // the stores of tile i - 1 have read their stage: fill it again
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(static_cast<int>((i - 1) % kStages));
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) gather_kernel(const __grid_constant__ Params p) {
  const int r = p.local[blockIdx.x];
  const int m = gridDim.x;  // ranks on this card
  const long long block = static_cast<long long>(blockIdx.y) * m + blockIdx.x;
  const long long tid = block * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.y) * m * kThreads;
  unsigned* mine = p.flags[r];
  __shared__ int peers_entered;
  __shared__ alignas(128) unsigned char stage[kStages][kTile];
  __shared__ alignas(8) unsigned long long full[kStages];

  // Source rank q goes to slot q of every local rank's output; `here` says
  // whether q's blocks live on this card.  The threads copy what the bulk
  // engine does not.
  auto copy_sources = [&](bool here) {
    for (int s = 0; s < p.d; ++s) {
      const int q = (r + s) % p.d;  // start at home: ranks spread over the owners
      if (static_cast<bool>(p.here[q]) != here) continue;
      for (int l = 0; l < p.n_leaves; ++l) {
        const int mode = p.mode[l][q];
        if (mode == kBulk)
          copy_words(p, l, q, m, bulk_bytes(p, l, q) / 4, false, tid, stride);  // the tail
        else
          copy_words(p, l, q, m, 0, mode == kWords16, tid, stride);
      }
    }
  };

  // (a) this rank has entered; the blocks of this card's own ranks, the
  // bulk tiles shared out over all of the card's blocks
  if (blockIdx.y == 0 && threadIdx.x == 0) store_release(mine + kEntered, p.epoch);
  copy_sources(true);
  if (threadIdx.x == 0)
    bulk_copy(p, m, block, static_cast<long long>(gridDim.y) * m, stage, full, mine + kStatus);

  // (b) every rank has entered this call: its inputs exist
  if (threadIdx.x == 0) {
    int ok = 1;
    for (int s = 1; s < p.d && ok; ++s)
      ok = wait_reached(p.flags[(r + s) % p.d] + kEntered, p.epoch);
    if (!ok) atomicCAS(mine + kStatus, 0u, 1u);  // the first cause stays
    peers_entered = ok;
  }
  __syncthreads();

  // (c) the other cards' blocks, from their owners
  if (peers_entered) copy_sources(false);

  // (d) this rank is done reading once its last block is; it leaves when
  // every rank is done
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (atomicAdd(mine + kArrivals, 1u) + 1 == gridDim.y) {
      atomicExch(mine + kArrivals, 0u);
      for (int q = 0; q < p.d; ++q) add_release(p.flags[q] + kDone, 1u);
    }
    if (blockIdx.y == 0 && !wait_reached(mine + kDone, p.epoch * static_cast<unsigned>(p.d)))
      atomicCAS(mine + kStatus, 0u, 2u);
  }
}

// Runs fn with `device` current and restores the caller's device.
template <typename F>
int on_device(int device, F fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int code = fn();
  if (prev != device) cudaSetDevice(prev);
  return code;
}

}  // namespace ring

extern "C" {

// The most blocks of gather_kernel that are resident at once on `device`.
int merge_ring_max_blocks(int device, int* out) {
  return ring::on_device(device, [&]() {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring::gather_kernel, ring::kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    *out = per_sm * sms;
    return static_cast<int>(err);
  });
}

// Peer access between every ordered pair of the n distinct cards in devs;
// already enabled is fine.
int merge_ring_enable_peers(const int* devs, int n) {
  for (int i = 0; i < n; ++i) {
    const int code = ring::on_device(devs[i], [&]() {
      for (int j = 0; j < n; ++j) {
        if (j == i) continue;
        int can = 0;
        cudaError_t err = cudaDeviceCanAccessPeer(&can, devs[i], devs[j]);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
        err = cudaDeviceEnablePeerAccess(devs[j], 0);
        if (err == cudaErrorPeerAccessAlreadyEnabled) {
          cudaGetLastError();  // clear it
        } else if (err != cudaSuccess) {
          return static_cast<int>(err);
        }
      }
      return static_cast<int>(cudaSuccess);
    });
    if (code != 0) return code;
  }
  return static_cast<int>(cudaSuccess);
}

// One card's launch of call number `epoch`: the n_local ranks in `local`
// (all on `device`) gather from all d ranks.  src and dst hold n_leaves * d
// pointers, leaf-major (src[l * d + q], dst[l * d + r]); n the words of one
// block of each leaf; flags one pointer a rank.  blocks_y blocks a rank;
// n_local * blocks_y must not exceed merge_ring_max_blocks().  Returns the
// launch's error code.
int merge_ring_gather(const void* const* src, void* const* dst, const long long* n,
                      void* const* flags, const int* local, int n_local, int d, int n_leaves,
                      unsigned epoch, int device, int blocks_y, cudaStream_t stream) {
  if (d < 1 || d > ring::kMaxRanks || n_leaves < 1 || n_leaves > ring::kMaxLeaves ||
      n_local < 1 || n_local > d || blocks_y < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ring::Params p = {};
  for (int i = 0; i < n_local; ++i) {
    if (local[i] < 0 || local[i] >= d) return static_cast<int>(cudaErrorInvalidValue);
    p.local[i] = local[i];
    p.here[local[i]] = 1;
  }
  auto aligned16 = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  for (int l = 0; l < n_leaves; ++l) {
    p.n[l] = n[l];
    for (int j = 0; j < n_local; ++j) p.out[l][j] = static_cast<uint32_t*>(dst[l * d + local[j]]);
    for (int q = 0; q < d; ++q) {
      p.src[l][q] = static_cast<const uint32_t*>(src[l * d + q]);
      bool vec = aligned16(p.src[l][q]);
      for (int j = 0; j < n_local; ++j) vec = vec && aligned16(p.out[l][j] + q * n[l]);
      p.mode[l][q] = !vec ? ring::kWords4 : p.here[q] && n[l] >= 4 ? ring::kBulk : ring::kWords16;
    }
  }
  for (int q = 0; q < d; ++q) p.flags[q] = static_cast<unsigned*>(flags[q]);
  p.d = d;
  p.n_leaves = n_leaves;
  p.epoch = epoch;
  return ring::on_device(device, [&]() {
    void* args[] = {&p};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(ring::gather_kernel), dim3(n_local, blocks_y),
        dim3(ring::kThreads), args, 0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  });
}

// kinfo::query's five numbers of the gather kernel (on the current card).
int merge_ring_kernel_info(int* out) { return kinfo::query(ring::gather_kernel, ring::kThreads, 0, out); }

const char* merge_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
