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
// Bound.  Every weight must be read once: at R = 16,384, B = 1,024 that is
// 64 MiB, ~20 us at 3.35 TB/s, plus the lkeys (R*k*4 bytes) and per-row state,
// plus for each filled or accepted element one 32-byte sector gathered and
// one sector each of samples and lkeys written.  Operations: ~16 float ops
// per weight for the scan, and per acceptance three Threefry-2x32 blocks and
// ~90 float ops (log twice, exp, two divisions); per fill two blocks and a
// log.  The acceptance chain is sequential by definition (each acceptance
// conditions on the new minimum key), and a warp runs one row, so on this
// card each acceptance costs its whole instruction count in issue slots and
// its whole dependent chain in latency.  A steady tile (count 7B, ~7
// acceptances a row) is bound by the bytes and the scan; a fill tile from
// empty (~171 acceptances a row) by the acceptances' issue slots.
// chip_smoke.py computes the bound from each run's counts (PERF.md).
//
// Design.  One warp per reservoir row, four rows a block.  A warp walks its
// row in 128-lane blocks, the association block of ops/prefix.py: lane l
// holds positions 32i + l (i = 0..3) in registers.
// - The scan overlaps the loads: the next block's weights are loaded into
//   registers before the current block is scanned and searched.  The
//   log-step adds for d < 32 are __shfl_sync with the neighbouring register,
//   d = 32 and d = 64 are register adds, lanes with no source add +0.0, and
//   the carry from the previous block is added after the block's scan,
//   exactly as the plain version associates the sum; each add is one
//   add.rn.ftz (its inputs are never subnormal, so flushing the rounded sum
//   is flushing the result, as XLA CPU does).
// - Keys on chip: the row's lkeys live in shared memory for the launch and
//   go back once at the end, with the element position that last took each
//   slot; the samples are gathered and written once a slot at the end.  The
//   row's first minimum is kept as a per-lane partial minimum (lane l owns
//   slots l, l + 32, ...) over a 32-bit order key (NaN first, -0.0 equal to
//   0.0), reduced across the warp by two __reduce_min_sync (key, then the
//   lowest slot holding it); after an acceptance only the owning lane
//   rescans its slots.  When 4 rows' keys and positions do not fit in
//   shared memory beside the lane-parallel draws' static 4 KiB (k > 7,136),
//   the same kernel keeps them in the state's global arrays and writes each
//   sample as it is taken.
// - A shorter chain: an acceptance's three Threefry blocks run as two,
//   lanes 0 and 1 computing the two draw words in the same instructions.
//   In a block that has already taken 8 acceptances, or follows a block
//   that did, or completes the fill, the draws u1 and log(u2) of every
//   remaining positive lane depend only on its position and are computed
//   lane-parallel once, into shared memory, where each acceptance reads
//   them.  A steady block (about one acceptance) never pays for that.
// - Small code: the steady path (scan, search, about one acceptance a
//   block) ran several times slower on the card while the kernel also held
//   the lane-parallel draws and the fill unrolled four times (PERF.md,
//   Findings).  So the loops that hold Threefry blocks (fill, draws) stay
//   rolled.
// - Positive ranks come from __ballot_sync and __popc; the fill is
//   lane-parallel.
//
// Float steps mirror the plain version one IEEE operation at a time:
// xla_log/xla_exp from fmath.cuh, __fdiv_rn, __fmul_rn, __fadd_rn and
// __fmaf_rn(u1, 1 - t, t) for the contraction XLA makes.  XLA CPU runs with
// denormals read as zero and flushed on output, so weights are flushed when
// loaded (a subnormal weight is a zero weight) and every add, product and
// quotient that can underflow is flushed, as in the plain version.
//
// Launch geometry.  Rows a block (warps, one a row) is a launch choice from
// {1, 2, 4, 8}, each a template instantiation whose __launch_bounds__ keeps
// 1,024 threads an SM resident (32 / kW blocks), so every instantiation
// gets the default's register budget.  The default, kWarps = 4, is what
// weighted_update launches; weighted_update_rows takes another from the
// autotune cache (ops/autotune.py).  smem_bytes is the one place that
// decides a launch's placement: its rows' keys on chip where they and the
// draws of kW warps fit, else in global memory.  A warp's row does not
// depend on the block it runs in, nor on where its keys are kept.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (see reservoir_tpu_torch/_build.py).  Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "fmath.cuh"
#include "kinfo.cuh"
#include "threefry.cuh"

namespace wtd {

using algl::bits_word;
using algl::flush;
using algl::threefry2x32;
using algl::uniform_from_word;
using algl::xla_exp;
using algl::xla_log;

constexpr int kWarps = 4;  // the default rows a block
constexpr int kBlock = 128;  // prefix.CUMSUM_BLOCK
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxSmem = 232448;  // shared memory a block can use on sm_90
// the lane-parallel draws' static buffer of kW warps (draws, below), which
// counts against kMaxSmem with the dynamic keys and positions
__host__ __device__ constexpr size_t draw_bytes(int kW) { return sizeof(float) * kW * 2 * kBlock; }
// acceptances in a block after which the rest of its draws (and the next
// block's) are made lane-parallel
constexpr int kDense = 8;

__device__ __forceinline__ float f32_min() { return __uint_as_float(0xFF7FFFFFu); }
__device__ __forceinline__ float pos_inf() { return __uint_as_float(0x7F800000u); }
__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xFF800000u); }

// flush(a + b) for inputs that are never subnormal: the hardware's FTZ add
__device__ __forceinline__ float add_ftz(float a, float b) {
  float d;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_f32_min(float x) {
  // jnp.maximum(x, finfo.min), which keeps NaN
  return x < f32_min() ? f32_min() : x;
}

// The argmin order as a 32-bit key: NaN first, then smaller, -0.0 equal to
// 0.0 (jnp.argmin and torch.argmin take the first minimum; the slot breaks
// ties).  Every non-NaN key lies in [0x00800000, 0xFF800001].
__device__ __forceinline__ uint32_t order_key(float x) {
  if (isnan(x)) return 0u;
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return ((b & 0x80000000u) ? ~b : (b | 0x80000000u)) + 1u;
}

// The first minimum of the lane's own slots l, l + 32, ...: (key, slot, value).
__device__ __forceinline__ void lane_min(const float* lk, int k, int lane, uint32_t& pkey,
                                         int& pslot, float& pval) {
  pkey = 0xFFFFFFFFu;
  pslot = 0x7FFFFFFF;
  pval = pos_inf();
  for (int i = lane; i < k; i += 32) {
    const float x = lk[i];
    const uint32_t o = order_key(x);
    if (o < pkey) {
      pkey = o;
      pslot = i;
      pval = x;
    }
  }
}

// The row's first minimum over every lane's partial minimum: its slot and key.
__device__ __forceinline__ void row_min(uint32_t pkey, int pslot, float pval, int& ms, float& mn) {
  const uint32_t mk = __reduce_min_sync(kFull, pkey);
  ms = static_cast<int>(__reduce_min_sync(kFull, pkey == mk ? static_cast<uint32_t>(pslot) : kFull));
  mn = __shfl_sync(kFull, pval, ms & 31);
}

template <typename T>
__device__ __forceinline__ T pick(const T (&x)[4], int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : (i == 2 ? x[2] : x[3]));
}

// Weights of block positions off + 32i + lane, 0 at or past vt.
__device__ __forceinline__ void load_weights(const float* __restrict__ row_w, int off, int vt,
                                             int lane, float (&wr)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = off + 32 * i + lane;
    wr[i] = p < vt ? __ldg(row_w + p) : 0.0f;
  }
}

// One log-step of the block's scan: every lane adds the previous step's x
// at distance D (a compile-time constant, so x stays in registers).
template <int D>
__device__ __forceinline__ void scan_step(float (&x)[4], int lane) {
  float nx[4];
  if (D < 32) {
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = __shfl_sync(kFull, x[i], (lane - D) & 31);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float src = lane >= D ? s[i] : (i > 0 ? s[i - 1] : 0.0f);
      nx[i] = add_ftz(x[i], src);
    }
  } else {
    constexpr int di = D / 32;  // 1 or 2 registers back
#pragma unroll
    for (int i = 0; i < 4; ++i) nx[i] = add_ftz(x[i], i >= di ? pick(x, i - di) : 0.0f);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = nx[i];
}

// The block's log-step scan in place, for d = 1, 2, 4, ... below width.
__device__ __forceinline__ void block_scan(float (&x)[4], int width, int lane) {
  if (width > 1) scan_step<1>(x, lane);
  if (width > 2) scan_step<2>(x, lane);
  if (width > 4) scan_step<4>(x, lane);
  if (width > 8) scan_step<8>(x, lane);
  if (width > 16) scan_step<16>(x, lane);
  if (width > 32) scan_step<32>(x, lane);
  if (width > 64) scan_step<64>(x, lane);
}

// The draws of the acceptance at absolute index idx: u1 and log(u2).
__device__ __forceinline__ void accept_draws(uint32_t k1, uint32_t k2, uint32_t idx, float& u1,
                                             float& lu2) {
  uint32_t f1, f2;
  threefry2x32(k1, k2, 0u, idx, f1, f2);
  u1 = uniform_from_word(bits_word(f1, f2, 1u));
  lu2 = xla_log(uniform_from_word(bits_word(f1, f2, 2u)));
}

template <bool ON_CHIP, int kW>
__global__ void __launch_bounds__(kW * 32, 32 / kW)
update_kernel(uint32_t* __restrict__ samples, float* __restrict__ lkeys,
              int32_t* __restrict__ count, float* __restrict__ xw_out,
              const uint32_t* __restrict__ key, const uint32_t* __restrict__ elems,
              const float* __restrict__ weights, const int32_t* __restrict__ valid, int R,
              int k, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const int r = blockIdx.x * kW + wi;
  if (r >= R) return;  // whole warps only: R rows, one warp each
  const int32_t c = count[r];
  const int v = valid != nullptr ? valid[r] : B;
  const int vt = v < 0 ? 0 : (v > B ? B : v);
  const uint32_t k1 = key[2 * r], k2 = key[2 * r + 1];
  float xw = xw_out[r];
  uint32_t* smp = samples + static_cast<size_t>(r) * k;
  float* glk = lkeys + static_cast<size_t>(r) * k;
  const uint32_t* row_e = elems + static_cast<size_t>(r) * B;
  const float* row_w = weights + static_cast<size_t>(r) * B;
  // the row's keys, and the element position that last took each slot
  float* lk = ON_CHIP ? reinterpret_cast<float*>(smem + static_cast<size_t>(wi) * 8 * k) : glk;
  int32_t* spos = reinterpret_cast<int32_t*>(lk + k);  // on chip only
  // the lane-parallel draws u1 and log(u2) of the block's positions
  __shared__ float draws[kW][2][kBlock];
  static_assert(sizeof(draws) == draw_bytes(kW), "smem_bytes counts the draws");
  float* du1 = draws[wi][0];
  float* dlu2 = draws[wi][1];

  // filled slots form a prefix; -inf marks an empty one
  uint32_t pkey = 0xFFFFFFFFu;  // this lane's first minimum key, slot, value
  int pslot = 0x7FFFFFFF;
  float pval = pos_inf();
  int nf = 0;
  for (int i = lane; i < k; i += 32) {
    const float x = glk[i];
    if (ON_CHIP) {
      lk[i] = x;
      spos[i] = -1;
    }
    nf += x > neg_inf() ? 1 : 0;
    const uint32_t o = order_key(x);
    if (o < pkey) {
      pkey = o;
      pslot = i;
      pval = x;
    }
  }
  nf = static_cast<int>(__reduce_add_sync(kFull, static_cast<uint32_t>(nf)));
  const int need = k - nf > 0 ? k - nf : 0;

  bool filling = need > 0;
  bool touched = false;  // a slot was filled or replaced
  bool dense = false;    // draws are made lane-parallel in this block
  float base = 0.0f;     // prefix weight at the last acceptance
  int cur = 0;           // acceptances are searched from here on
  int ms = 0;            // the row's first minimum key's slot, and the key
  float mn = 0.0f;
  if (!filling) row_min(pkey, pslot, pval, ms, mn);
  int rank = 0;          // positive items before this block
  float carry = 0.0f;    // cw at the previous block's last lane

  // a slot takes the element at position p with key kv
  auto put = [&](int slot, int p, float kv) {
    lk[slot] = kv;
    if (ON_CHIP)
      spos[slot] = p;
    else
      smp[slot] = row_e[p];
  };

  float wn[4];
  load_weights(row_w, 0, vt, lane, wn);
  for (int off = 0; off < B; off += kBlock) {
    const int width = B - off < kBlock ? B - off : kBlock;
    float w[4], x[4];
    bool pos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = flush(wn[i]);  // w_masked; denormals read as zero
      x[i] = w[i];
      pos[i] = w[i] > 0.0f;  // a lane at or past vt holds 0
    }
    if (off + kBlock < B) load_weights(row_w, off + kBlock, vt, lane, wn);
    block_scan(x, width, lane);
    if (off > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = add_ftz(x[i], carry);
    }
    carry = __shfl_sync(kFull, pick(x, (width - 1) >> 5), (width - 1) & 31);

    if (filling) {
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
      touched |= before_i > rank;
      rank = before_i;
      // positive items take the free slots in arrival order (a loop kept
      // rolled: the kernel's code is kept small, see the note at the top)
#pragma unroll 1
      for (int i = 0; i < 4; ++i) {
        const int pr = pick(prank, i);
        if (pick(pos, i) && pr <= need) {
          const int p = off + 32 * i + lane;
          const uint32_t idx = static_cast<uint32_t>(c) + static_cast<uint32_t>(p) + 1u;
          uint32_t f1, f2;
          threefry2x32(k1, k2, 0u, idx, f1, f2);
          const float u0 = uniform_from_word(bits_word(f1, f2, 0u));
          put(nf + pr - 1, p, max_f32_min(flush(__fdiv_rn(xla_log(u0), pick(w, i)))));
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
        lane_min(lk, k, lane, pkey, pslot, pval);
        row_min(pkey, pslot, pval, ms, mn);
        uint32_t f1, f2;
        threefry2x32(k1, k2, 0u, static_cast<uint32_t>(k), f1, f2);
        const float u3 = uniform_from_word(bits_word(f1, f2, 2u));
        xw = mn >= 0.0f ? pos_inf() : flush(__fdiv_rn(xla_log(u3), mn));
        base = __shfl_sync(kFull, pick(x, j0 >> 5), j0 & 31);
        cur = off + j0 + 1;
        filling = false;
        dense = true;  // acceptances follow the fill closely
      }
    }
    if (filling) continue;

    // acceptances in this block, one at a time
    int taken = 0;
    bool drawn = false;  // the lane-parallel draws of this block are made
    while (true) {
      if (dense && !drawn) {
        // the draws of every positive lane from cur on, into shared memory
#pragma unroll 1
        for (int i = 0; i < 4; ++i) {
          const int q = 32 * i + lane;
          if (__any_sync(kFull, pick(pos, i) && off + q >= cur))
            accept_draws(k1, k2, static_cast<uint32_t>(c) + 1u + static_cast<uint32_t>(off + q),
                         du1[q], dlu2[q]);
        }
        __syncwarp();
        drawn = true;
      }
      const float target = flush(__fadd_rn(base, xw));
      int q = -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned hit =
            __ballot_sync(kFull, pos[i] && x[i] >= target && off + 32 * i + lane >= cur);
        if (q < 0 && hit) q = 32 * i + __ffs(hit) - 1;
      }
      if (q < 0) break;
      const int p = off + q;
      const int qi = q >> 5, ql = q & 31;
      const float wc = __shfl_sync(kFull, pick(w, qi), ql);
      float u1, lu2;
      if (dense) {
        u1 = du1[q];
        lu2 = dlu2[q];
      } else {
        // lanes 0 and 1 draw the two words of the same folded key at once
        const uint32_t idx = static_cast<uint32_t>(c) + 1u + static_cast<uint32_t>(p);
        uint32_t f1, f2;
        threefry2x32(k1, k2, 0u, idx, f1, f2);
        const uint32_t word = bits_word(f1, f2, 1u + static_cast<uint32_t>(lane & 1));
        u1 = uniform_from_word(__shfl_sync(kFull, word, 0));
        lu2 = xla_log(uniform_from_word(__shfl_sync(kFull, word, 1)));
      }
      // (mn, ms): the minimum key t is conditioned on, and the slot it leaves
      const float t = xla_exp(flush(__fmul_rn(wc, mn)));
      const float r2 = __fmaf_rn(u1, __fsub_rn(1.0f, t), t);  // XLA's contraction
      const float lk_new = max_f32_min(flush(__fdiv_rn(xla_log(r2), wc)));
      if ((ms & 31) == lane) {
        put(ms, p, lk_new);
        lane_min(lk, k, lane, pkey, pslot, pval);
      }
      row_min(pkey, pslot, pval, ms, mn);
      xw = mn >= 0.0f ? pos_inf() : flush(__fdiv_rn(lu2, mn));
      base = __shfl_sync(kFull, pick(x, qi), ql);
      cur = p + 1;
      touched = true;
      dense |= ++taken >= kDense;
    }
    dense = taken >= kDense;
  }
  // an unfinished fill leaves base at cw[B - 1]; then rebase the jump
  if (filling) base = carry;
  const float total_w = v > 0 ? carry : 0.0f;
  if (lane == 0) {
    xw_out[r] = flush(__fsub_rn(xw, flush(__fsub_rn(total_w, base))));
    count[r] = static_cast<int32_t>(static_cast<uint32_t>(c) + static_cast<uint32_t>(v));
  }
  if (ON_CHIP && touched) {
    __syncwarp();  // every lane's slot writes, before any lane reads them
    for (int i = lane; i < k; i += 32) {
      glk[i] = lk[i];
      const int p = spos[i];
      if (p >= 0) smp[i] = row_e[p];
    }
  }
}

// Dynamic shared memory a block of warps rows takes on chip (keys and
// positions of its rows), or 0 when they and the static draws do not fit
// together and the keys stay in global memory.
__host__ inline size_t smem_bytes(int k, int warps = kWarps) {
  const size_t bytes = static_cast<size_t>(warps) * 8 * k;
  return bytes + draw_bytes(warps) <= static_cast<size_t>(kMaxSmem) ? bytes : 0;
}

// Calls f with the instantiation's warps a block as a compile-time
// constant: f(std::integral_constant<int, W>{}) for W in {1, 2, 4, 8}; any
// other count is cudaErrorInvalidValue.
template <typename F>
int with_warps(int warps, F&& f) {
  switch (warps) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(uint32_t* samples, float* lkeys, int32_t* count, float* xw, const uint32_t* key,
           const uint32_t* elems, const float* weights, const int32_t* valid, int R, int k, int B,
           int warps, cudaStream_t stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  return with_warps(warps, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    const int blocks = (R + kW - 1) / kW;
    const size_t smem = smem_bytes(k, kW);
    if (smem == 0) {
      update_kernel<false, kW><<<blocks, kW * 32, 0, stream>>>(samples, lkeys, count, xw, key,
                                                                elems, weights, valid, R, k, B);
      return static_cast<int>(cudaGetLastError());
    }
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          update_kernel<true, kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    update_kernel<true, kW><<<blocks, kW * 32, smem, stream>>>(samples, lkeys, count, xw, key,
                                                               elems, weights, valid, R, k, B);
    return static_cast<int>(cudaGetLastError());
  });
}

int info(int k, int warps, int* out) {
  return with_warps(warps, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    const size_t smem = smem_bytes(k, kW);
    return smem == 0 ? kinfo::query(update_kernel<false, kW>, kW * 32, 0, out)
                     : kinfo::query(update_kernel<true, kW>, kW * 32, smem, out);
  });
}

}  // namespace wtd

extern "C" {

// One weighted tile update, in place, at the default geometry (kWarps rows
// a block).  valid may be null (every row takes B).  Returns
// cudaGetLastError() after the launch.
int weighted_update(uint32_t* samples, float* lkeys, int32_t* count, float* xw,
                    const uint32_t* key, const uint32_t* elems, const float* weights,
                    const int32_t* valid, int R, int k, int B, cudaStream_t stream) {
  return wtd::launch(samples, lkeys, count, xw, key, elems, weights, valid, R, k, B, wtd::kWarps,
                     stream);
}

// weighted_update at warps rows a block (1, 2, 4 or 8).
int weighted_update_rows(uint32_t* samples, float* lkeys, int32_t* count, float* xw,
                         const uint32_t* key, const uint32_t* elems, const float* weights,
                         const int32_t* valid, int R, int k, int B, int warps,
                         cudaStream_t stream) {
  return wtd::launch(samples, lkeys, count, xw, key, elems, weights, valid, R, k, B, warps, stream);
}

// The build's registers, spills, shared memory and resident warps an SM of
// the kernel at k (kinfo::query's five numbers in out).
int weighted_kernel_info(int k, int* out) { return wtd::info(k, wtd::kWarps, out); }

// weighted_kernel_info of the instantiation at warps rows a block.
int weighted_rows_kernel_info(int k, int warps, int* out) { return wtd::info(k, warps, out); }

const char* weighted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
