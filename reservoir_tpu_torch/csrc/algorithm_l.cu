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
// Design.  One thread per reservoir row; blocks of 128 threads over R.
// The TPU kernel kept each row block resident in VMEM and gathered with a
// one-hot reduction over the whole chunk; here a thread reads only the
// elements it accepts, so a tile costs R * 28 bytes of state traffic plus
// one 32-byte sector for each accepted element's gather and one for its
// slot write.  State is updated in place (count += valid included).
// Samples and batch move as 32-bit words and are never touched as floats,
// which keeps -0.0 and NaN payloads.
//
// Bound.  Per steady tile with A accepts over all rows: bytes ~ R*28 + A*64,
// integer work ~ A * (4 Threefry blocks * ~100 ops) and ~60 float ops per
// accept.  At R = 65,536, k = 128, B = 2,048 a steady tile from count
// 14,336 has ~1.1 M accepts, and both bounds are ~22 microseconds; a
// fill tile from count 0 has ~23 M accepts and is bound by bytes
// (~0.46 ms).  chip_smoke.py reports the measured times beside them
// (PERF.md).  This simple design is latency-bound: ~16 warps per SM, each
// thread a long dependent Threefry/log chain, and a warp's loop runs as
// long as its row with the most accepts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (see reservoir_tpu_torch/_build.py).  Plain C interface for ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "fmath.cuh"
#include "threefry.cuh"

namespace algl {

constexpr int kThreads = 128;
constexpr int32_t kInt32Max = 2147483647;

// One acceptance at absolute index nxt: returns the slot, advances log_w
// and nxt (the port of ops/algorithm_l.py:_advance_words).
__device__ __forceinline__ int32_t advance(float& log_w, int32_t& nxt,
                                           uint32_t k1, uint32_t k2, int k) {
  uint32_t w[3];
  accept_words(k1, k2, static_cast<uint32_t>(nxt), w);
  const float u1 = uniform_from_word(w[0]);
  const float u2 = uniform_from_word(w[1]);
  const int32_t slot = static_cast<int32_t>(w[2] % static_cast<uint32_t>(k));
  // XLA folds log(u1) / k into fma(log(u1), 1/k, log_w), 1/k in float32
  log_w = __fmaf_rn(xla_log(u1), __fdiv_rn(1.0f, __int2float_rn(k)), log_w);
  const float wv = xla_exp(log_w);
  float skip_f = floorf(__fdiv_rn(xla_log(u2), xla_log1p(-wv)));
  // min(skip_f, 2^30) that keeps NaN, as jnp.minimum and torch.minimum do
  if (skip_f > 1073741824.0f) skip_f = 1073741824.0f;
  // float -> int32 as XLA converts: NaN gives 0
  const int32_t skip = isnan(skip_f) ? 0 : static_cast<int32_t>(skip_f);
  const int32_t headroom = kInt32Max - skip - 1;
  nxt = nxt > headroom ? kInt32Max : nxt + skip + 1;
  return slot;
}

__global__ void __launch_bounds__(kThreads)
update_kernel(uint32_t* __restrict__ samples, int32_t* __restrict__ count,
              int32_t* __restrict__ nxt, float* __restrict__ log_w,
              const uint32_t* __restrict__ key, const uint32_t* __restrict__ batch,
              const int32_t* __restrict__ valid, int R, int k, int B, int fill) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int32_t c = count[r];
  const int32_t v = valid != nullptr ? valid[r] : B;
  const uint32_t* row = batch + static_cast<size_t>(r) * B;
  uint32_t* out = samples + static_cast<size_t>(r) * k;
  if (fill && c < k) {
    const int m = min(v, k - c);
    for (int j = 0; j < m; ++j) out[c + j] = row[j];
  }
  // int32 wraparound as in the reference's count + valid
  const int32_t end = static_cast<int32_t>(static_cast<uint32_t>(c) + static_cast<uint32_t>(v));
  const uint32_t k1 = key[2 * r], k2 = key[2 * r + 1];
  int32_t n = nxt[r];
  float lw = log_w[r];
  while (n <= end) {
    // the reference's gather index rule: wrap a negative index, then clamp
    int64_t pos = static_cast<int64_t>(n) - c - 1;
    if (pos < 0) pos += B;
    pos = pos < 0 ? 0 : (pos >= B ? B - 1 : pos);
    const uint32_t elem = row[pos];
    const int32_t slot = advance(lw, n, k1, k2, k);
    out[slot] = elem;
  }
  nxt[r] = n;
  log_w[r] = lw;
  count[r] = end;
}

__global__ void fmath_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
                             int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  y[i] = which == 0 ? xla_log(x[i]) : (which == 1 ? xla_exp(x[i]) : xla_log1p(x[i]));
}

}  // namespace algl

extern "C" {

// One tile update, in place.  valid may be null (every row takes B).
// Returns cudaGetLastError() after the launch.
int algl_update(uint32_t* samples, int32_t* count, int32_t* nxt, float* log_w,
                const uint32_t* key, const uint32_t* batch, const int32_t* valid, int R,
                int k, int B, int fill, cudaStream_t stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + algl::kThreads - 1) / algl::kThreads;
  algl::update_kernel<<<blocks, algl::kThreads, 0, stream>>>(samples, count, nxt, log_w, key,
                                                              batch, valid, R, k, B, fill);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's log (which = 0), exp (1) or log1p (2) over n floats, for
// holding the device math against ops/fmath.py.
int algl_fmath(const float* x, float* y, int n, int which, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  algl::fmath_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(x, y, n, which);
  return static_cast<int>(cudaGetLastError());
}

const char* algl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
