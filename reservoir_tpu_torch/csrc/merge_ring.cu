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
// reads: the card's blocks together walk every source block once, 16 bytes
// a thread (neighbouring threads on neighbouring addresses, 4-byte accesses
// only where a block's start is not 16-byte aligned), and store each word
// into the slot of every rank on the card.  So d ranks on one card read each
// input once and write each output once, which is the bound below; d cards
// read each peer's block once over NVLink.  Per launch: (a) each rank's
// first block announces that the rank has entered, and the blocks copy the
// source blocks that live on this card (its own ranks'); (b) every block
// waits until each rank has entered this call (its inputs exist: the
// handshake of the TPU kernel's barrier semaphore); (c) the blocks copy the
// other cards' source blocks from their owners; (d) a rank's last block to
// finish tells every rank that this rank is done reading, and the rank's
// first block stays until all d ranks have said so, so no input is freed or
// overwritten under a peer's reads.
//
// The flags are four words of device memory a rank, on the rank's card:
// {entered, done, status, arrivals}.  entered and done count calls (the
// call number "epoch" and epoch * d), so a second call needs no reset and
// cannot see the first call's signal.  Signals are system-scope release
// stores or reductions after a __threadfence_system(); waits are
// system-scope acquire loads; peer data is loaded past L1 (__ldcg) and the
// outputs are stored as streaming data (__stcs).  Every wait is bounded by
// kTimeoutNs on the global timer: a rank that times out writes 1 (peer
// never entered) or 2 (peers never finished) into its status word and
// leaves; the wrapper's caller reads it when it next synchronises and
// raises.
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

namespace ring {

constexpr int kMaxRanks = 16;
constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;
constexpr unsigned long long kTimeoutNs = 2000000000ULL;  // 2 s a wait

enum Flag { kEntered = 0, kDone = 1, kStatus = 2, kArrivals = 3 };

struct Params {
  const uint32_t* src[kMaxLeaves][kMaxRanks];  // src[l][q]: rank q's block of leaf l
  uint32_t* dst[kMaxLeaves][kMaxRanks];        // dst[l][r]: rank r's [d, n[l]] output
  long long n[kMaxLeaves];                     // words in one block of leaf l
  unsigned* flags[kMaxRanks];                  // flags[r]: rank r's four flag words
  int local[kMaxRanks];                        // the ranks this launch runs
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

// One source block of n words into slot `slot` of each of the m outputs in
// dst, by the card's threads (tid of stride).  16-byte loads where src is
// aligned, 16-byte stores where every destination is too.
__device__ void copy_words(const uint32_t* __restrict__ src, uint32_t* const* dst, int m,
                           long long slot, long long n, long long tid, long long stride) {
  bool dst16 = true;
  for (int j = 0; j < m; ++j) dst16 &= (reinterpret_cast<uintptr_t>(dst[j] + slot * n) & 15) == 0;
  const bool src16 = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const long long nv = src16 ? n / 4 : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  auto store4 = [&](long long i, uint4 v) {
    for (int j = 0; j < m; ++j) {
      uint32_t* out = dst[j] + slot * n + 4 * i;
      if (dst16) {
        __stcs(reinterpret_cast<uint4*>(out), v);  // streamed: not read again here
      } else {
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
      }
    }
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
  for (long long j = 4 * nv + tid; j < n; j += stride) {
    const uint32_t v = __ldcg(src + j);
    for (int t = 0; t < m; ++t) dst[t][slot * n + j] = v;
  }
}

__global__ void __launch_bounds__(kThreads) gather_kernel(const Params p) {
  const int r = p.local[blockIdx.x];
  const int m = gridDim.x;  // ranks on this card
  const long long block = static_cast<long long>(blockIdx.y) * m + blockIdx.x;
  const long long tid = block * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.y) * m * kThreads;
  unsigned* mine = p.flags[r];
  __shared__ int peers_entered;

  // Source rank q goes to slot q of every local rank's output; `here` says
  // whether q's blocks live on this card.
  auto copy_sources = [&](bool here) {
    for (int s = 0; s < p.d; ++s) {
      const int q = (r + s) % p.d;  // start at home: ranks spread over the owners
      bool local = false;
      for (int j = 0; j < m; ++j) local |= p.local[j] == q;
      if (local != here) continue;
      for (int l = 0; l < p.n_leaves; ++l) {
        uint32_t* dst[kMaxRanks];
        for (int j = 0; j < m; ++j) dst[j] = p.dst[l][p.local[j]];
        copy_words(p.src[l][q], dst, m, q, p.n[l], tid, stride);
      }
    }
  };

  // (a) this rank has entered; the blocks of this card's own ranks
  if (blockIdx.y == 0 && threadIdx.x == 0) store_release(mine + kEntered, p.epoch);
  copy_sources(true);

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
  for (int l = 0; l < n_leaves; ++l) {
    p.n[l] = n[l];
    for (int q = 0; q < d; ++q) {
      p.src[l][q] = static_cast<const uint32_t*>(src[l * d + q]);
      p.dst[l][q] = static_cast<uint32_t*>(dst[l * d + q]);
    }
  }
  for (int q = 0; q < d; ++q) p.flags[q] = static_cast<unsigned*>(flags[q]);
  for (int i = 0; i < n_local; ++i) p.local[i] = local[i];
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

const char* merge_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
