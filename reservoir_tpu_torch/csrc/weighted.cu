// Weighted (A-ExpJ) tile update for R lockstep reservoirs, for Hopper (sm_90a).
//
// Replaces the TPU kernel reservoir_tpu/ops/weighted_pallas.py:_kernel (entry
// point update_pallas).  It computes the same function as the plain version,
// reservoir_tpu_torch/ops/weighted.py:update: positive-weight items fill the
// empty slots in arrival order with the key log(u0)/w; the fill completing in
// the tile draws the first jump, keyed on index k; then, over the blocked
// prefix sum cw of the row's weights, every positive item whose prefix weight
// reaches base + xw replaces the minimum key (first minimum) with
// log(fma(u1, 1 - t, t))/w, t = exp(w * lt), and redraws xw = log(u2)/lt; the
// unused jump is rebased at the tile's end.  Unlike the TPU kernel it takes a
// per-row valid count, so ragged tiles run here too.
//
// Design.  One warp per reservoir row, four rows a block.  The TPU kernel
// streamed [block_r, chunk_b] chunks through VMEM and did its gathers and
// scatters as one-hot reductions; none of that is the algorithm.  Here a warp
// walks its row in 128-lane blocks, the association block of ops/prefix.py:
// lane l holds positions 32i + l (i = 0..3) in registers, the log-step adds
// for d < 32 are __shfl_sync with the neighbouring register, d = 32 and
// d = 64 are register adds, lanes with no source add +0.0, and the carry
// from the previous block is added after the block's scan, exactly as the
// plain version associates the sum.  Positive ranks come from __ballot_sync
// and __popc; the fill is lane-parallel; each acceptance is found with four
// ballots (first positive lane >= cur with cw >= base + xw) and then runs on
// the whole warp: every lane computes the same draws, the minimum key and
// its first slot are a warp reduction over per-lane partial minima (lane l
// owns slots l, l + 32, ...), and only the owning lane writes the slot and
// rescans its own keys.  Elements are read only when filled or accepted, and
// samples are written only for those slots, as 32-bit words, so -0.0 and NaN
// payloads survive.
//
// Float steps mirror the plain version one IEEE operation at a time:
// xla_log/xla_exp from fmath.cuh, __fdiv_rn, __fmul_rn, __fadd_rn and
// __fmaf_rn(u1, 1 - t, t) for the contraction XLA makes.  XLA CPU runs with
// denormals read as zero and flushed on output, so weights are flushed when
// loaded (a subnormal weight is a zero weight) and every add, product and
// quotient that can underflow is flushed, as in the plain version.
//
// Bound.  Every weight must be read once: at R = 16,384, B = 1,024 that is
// 64 MiB, ~20 us at 3.35 TB/s, plus the lkeys (R*k*4 bytes) and per-row state,
// plus for each filled or accepted element one 32-byte sector gathered (at
// most the element tile) and one sector each of samples and lkeys written (at
// most the R*k*8 bytes of the two arrays: rewrites stay in L2).  Operations: ~16 float ops per weight for the scan, and per
// acceptance three Threefry-2x32 blocks (~260 integer ops) and ~90 float ops
// (log twice, exp, two divisions); per fill two blocks and a log.  A steady
// tile (count 7B, ~140 K acceptances) is bound by the bytes; a fill tile from
// empty (~1 M fills and ~3 M acceptances) by the integer work.  chip_smoke.py
// computes both from each run's counts and reports the measured time beside
// them (PERF.md).  The weights stream as coalesced 128-byte rows; what this
// simple design leaves on the table is the acceptance chain, which is serial
// per warp and latency-bound, and a row block waits for its slowest row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (see reservoir_tpu_torch/_build.py).  Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "fmath.cuh"
#include "threefry.cuh"

namespace wtd {

using algl::bits_word;
using algl::flush;
using algl::threefry2x32;
using algl::uniform_from_word;
using algl::xla_exp;
using algl::xla_log;

constexpr int kWarps = 4;
constexpr int kBlock = 128;  // prefix.CUMSUM_BLOCK
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float f32_min() { return __uint_as_float(0xFF7FFFFFu); }
__device__ __forceinline__ float pos_inf() { return __uint_as_float(0x7F800000u); }
__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xFF800000u); }

__device__ __forceinline__ float add_ftz(float a, float b) { return flush(__fadd_rn(a, b)); }
__device__ __forceinline__ float max_f32_min(float x) {
  // jnp.maximum(x, finfo.min), which keeps NaN
  return x < f32_min() ? f32_min() : x;
}

// xw = log(u) / lt, or +inf when the threshold key is 1 or more
__device__ __forceinline__ float draw_xw(float u, float lt) {
  return lt >= 0.0f ? pos_inf() : flush(__fdiv_rn(xla_log(u), lt));
}

// (b, ib) before (a, ia) in argmin order: NaN first, then smaller, then the
// lower index (jnp.argmin and torch.argmin take the first minimum)
__device__ __forceinline__ bool before(float b, int ib, float a, int ia) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return nb && (!na || ib < ia);
  return b < a || (b == a && ib < ia);
}

// The first minimum of the lane's own slots l, l + 32, ... (value, slot).
__device__ __forceinline__ void lane_min(const float* lk, int k, int lane, float& v, int& s) {
  v = pos_inf();
  s = 0x7FFFFFFF;
  for (int i = lane; i < k; i += 32) {
    const float x = lk[i];
    if (before(x, i, v, s)) {
      v = x;
      s = i;
    }
  }
}

// The row's first minimum over every lane's partial minimum.
__device__ __forceinline__ void warp_min(float& v, int& s) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, d);
    const int os = __shfl_xor_sync(kFull, s, d);
    if (before(ov, os, v, s)) {
      v = ov;
      s = os;
    }
  }
}

__device__ __forceinline__ float pick(const float (&x)[4], int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : (i == 2 ? x[2] : x[3]));
}

__global__ void __launch_bounds__(kWarps * 32)
update_kernel(uint32_t* __restrict__ samples, float* __restrict__ lkeys,
              int32_t* __restrict__ count, float* __restrict__ xw_out,
              const uint32_t* __restrict__ key, const uint32_t* __restrict__ elems,
              const float* __restrict__ weights, const int32_t* __restrict__ valid, int R,
              int k, int B) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warps only: R rows, one warp each
  const int32_t c = count[r];
  const int v = valid != nullptr ? valid[r] : B;
  const uint32_t k1 = key[2 * r], k2 = key[2 * r + 1];
  float xw = xw_out[r];
  uint32_t* smp = samples + static_cast<size_t>(r) * k;
  float* lk = lkeys + static_cast<size_t>(r) * k;
  const uint32_t* row_e = elems + static_cast<size_t>(r) * B;
  const float* row_w = weights + static_cast<size_t>(r) * B;

  // filled slots form a prefix; -inf marks an empty one
  int nf = 0;
  for (int i = lane; i < k; i += 32) nf += lk[i] > neg_inf() ? 1 : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) nf += __shfl_xor_sync(kFull, nf, d);
  const int need = k - nf > 0 ? k - nf : 0;

  bool filling = need > 0;
  float base = 0.0f;  // prefix weight at the last acceptance
  int cur = 0;        // acceptances are searched from here on
  float pmin = 0.0f;  // this lane's first minimum key and its slot
  int pslot = 0;
  float mn = 0.0f;    // the row's first minimum key and its slot
  int ms = 0;
  if (!filling) {
    lane_min(lk, k, lane, pmin, pslot);
    mn = pmin;
    ms = pslot;
    warp_min(mn, ms);
  }
  int rank = 0;       // positive items before this block
  float carry = 0.0f; // cw at the previous block's last lane

  for (int off = 0; off < B; off += kBlock) {
    const int width = B - off < kBlock ? B - off : kBlock;
    float w[4], x[4];
    bool pos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 32 * i + lane;
      const int p = off + q;
      float wv = 0.0f;
      if (q < width && p < v) wv = flush(row_w[p]);  // w_masked; denormals read as zero
      w[i] = wv;
      x[i] = wv;
      pos[i] = q < width && p < v && wv > 0.0f;
    }
    // the block's log-step scan: every step reads the previous step's x
    for (int d = 1; d < width; d <<= 1) {
      float nx[4];
      if (d < 32) {
        float s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = __shfl_sync(kFull, x[i], (lane - d) & 31);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float src = lane >= d ? s[i] : (i > 0 ? s[i - 1] : 0.0f);
          nx[i] = add_ftz(x[i], src);
        }
      } else {
        const int di = d >> 5;  // 1 or 2 registers back
#pragma unroll
        for (int i = 0; i < 4; ++i) nx[i] = add_ftz(x[i], i >= di ? pick(x, i - di) : 0.0f);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = nx[i];
    }
    if (off > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = add_ftz(x[i], carry);
    }
    carry = __shfl_sync(kFull, pick(x, (width - 1) >> 5), (width - 1) & 31);

    // positive ranks (1-based, inclusive) from the ballots
    unsigned bal[4];
    int prank[4];
    int before_i = rank;
    const unsigned le = lane == 31 ? kFull : ((2u << lane) - 1u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bal[i] = __ballot_sync(kFull, pos[i]);
      prank[i] = before_i + __popc(bal[i] & le);
      before_i += __popc(bal[i]);
    }
    rank = before_i;

    if (filling) {
      // positive items take the free slots in arrival order
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pos[i] && prank[i] <= need) {
          const int p = off + 32 * i + lane;
          const int dest = nf + prank[i] - 1;
          const uint32_t idx = static_cast<uint32_t>(c) + static_cast<uint32_t>(p) + 1u;
          uint32_t f1, f2;
          threefry2x32(k1, k2, 0u, idx, f1, f2);
          const float u0 = uniform_from_word(bits_word(f1, f2, 0u));
          smp[dest] = row_e[p];
          lk[dest] = max_f32_min(flush(__fdiv_rn(xla_log(u0), w[i])));
        }
      }
      if (rank >= need) {
        // the need-th positive item of the tile is in this block: the fill
        // is complete, and acceptances start right after it
        int j0 = -1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned hit = __ballot_sync(kFull, pos[i] && prank[i] == need);
          if (j0 < 0 && hit) j0 = 32 * i + __ffs(hit) - 1;
        }
        __syncwarp();  // the fill's writes, by any lane, before the scan below
        lane_min(lk, k, lane, pmin, pslot);
        mn = pmin;
        ms = pslot;
        warp_min(mn, ms);
        uint32_t f1, f2;
        threefry2x32(k1, k2, 0u, static_cast<uint32_t>(k), f1, f2);
        xw = draw_xw(uniform_from_word(bits_word(f1, f2, 2u)), mn);
        base = __shfl_sync(kFull, pick(x, j0 >> 5), j0 & 31);
        cur = off + j0 + 1;
        filling = false;
      }
    }
    if (filling) continue;

    // acceptances in this block, one at a time
    while (true) {
      const float target = add_ftz(base, xw);
      int q = -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned hit =
            __ballot_sync(kFull, pos[i] && x[i] >= target && off + 32 * i + lane >= cur);
        if (q < 0 && hit) q = 32 * i + __ffs(hit) - 1;
      }
      if (q < 0) break;
      const int p = off + q;
      const float wc = __shfl_sync(kFull, pick(w, q >> 5), q & 31);
      const uint32_t idx = static_cast<uint32_t>(c) + 1u + static_cast<uint32_t>(p);
      uint32_t f1, f2;
      threefry2x32(k1, k2, 0u, idx, f1, f2);
      const float u1 = uniform_from_word(bits_word(f1, f2, 1u));
      const float u2 = uniform_from_word(bits_word(f1, f2, 2u));
      // (mn, ms): the minimum key t is conditioned on, and the slot it leaves
      const float t = xla_exp(flush(__fmul_rn(wc, mn)));
      const float r2 = __fmaf_rn(u1, __fsub_rn(1.0f, t), t);  // XLA's contraction
      const float lk_new = max_f32_min(flush(__fdiv_rn(xla_log(r2), wc)));
      if ((ms & 31) == lane) {
        smp[ms] = row_e[p];
        lk[ms] = lk_new;
        lane_min(lk, k, lane, pmin, pslot);
      }
      mn = pmin;
      ms = pslot;
      warp_min(mn, ms);
      xw = draw_xw(u2, mn);
      base = __shfl_sync(kFull, pick(x, q >> 5), q & 31);
      cur = p + 1;
    }
  }
  // an unfinished fill leaves base at cw[B - 1]; then rebase the jump
  if (filling) base = carry;
  const float total_w = v > 0 ? carry : 0.0f;
  if (lane == 0) {
    xw_out[r] = flush(__fsub_rn(xw, flush(__fsub_rn(total_w, base))));
    count[r] = static_cast<int32_t>(static_cast<uint32_t>(c) + static_cast<uint32_t>(v));
  }
}

}  // namespace wtd

extern "C" {

// One weighted tile update, in place.  valid may be null (every row takes B).
// Returns cudaGetLastError() after the launch.
int weighted_update(uint32_t* samples, float* lkeys, int32_t* count, float* xw,
                    const uint32_t* key, const uint32_t* elems, const float* weights,
                    const int32_t* valid, int R, int k, int B, cudaStream_t stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + wtd::kWarps - 1) / wtd::kWarps;
  wtd::update_kernel<<<blocks, wtd::kWarps * 32, 0, stream>>>(samples, lkeys, count, xw, key,
                                                              elems, weights, valid, R, k, B);
  return static_cast<int>(cudaGetLastError());
}

const char* weighted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
