// Host replica of the skip gate (reservoir_tpu_torch/stream/gate.py).
//
// The gate decides, for each row of a chunk, which elements the card's
// Algorithm-L chain would touch: the fill prefix and every acceptance.  It
// must walk exactly the chain the card walks, or one ulp of a log flips a
// floor and the replica's nxt forks from the card's.  So this file does not
// write the chain again: it compiles the kernels' own header
// (csrc/algl_chain.cuh, over csrc/fmath.cuh and csrc/threefry.cuh) for the
// CPU, through the shim below.  Every step there is one IEEE operation
// spelled as an intrinsic; here each intrinsic is that operation (fmaf for
// __fmaf_rn, the plain operators for the rest), built with
// -ffp-contract=off and without -ffast-math or -march=native, so no
// contraction, reassociation or flush changes a rounding.  The card's
// build runs with --fmad=false and without flushing denormals, like this
// one.  The JAX package's replica is one jitted XLA-CPU computation
// (reservoir_tpu/stream/gate.py:_build_eval); this one is scalar C++, a
// row a call or the rows split over threads.
//
// Exposed as a plain C ABI for ctypes.  A handle holds pointers to the
// replica's arrays (owned by the caller, which keeps them alive and in
// place); evaluations read them and write their verdicts to the caller's
// output arrays, never to the replica.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

// ---- the CUDA intrinsics the chain spells, as the host's IEEE operations
#define __device__
#define __forceinline__ inline __attribute__((always_inline))

static inline float __uint_as_float(uint32_t b) {
  float f;
  std::memcpy(&f, &b, sizeof f);
  return f;
}
static inline uint32_t __float_as_uint(float f) {
  uint32_t b;
  std::memcpy(&b, &f, sizeof b);
  return b;
}
static inline float __int_as_float(int32_t b) {
  float f;
  std::memcpy(&f, &b, sizeof f);
  return f;
}
static inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
}
using std::isnan;

// the headers' `#pragma unroll` is nvcc's, and means nothing here
#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wunknown-pragmas"
#include "algl_chain.cuh"
#pragma GCC diagnostic pop

namespace {

struct Gate {
  int32_t num_rows;
  int32_t k;
  int32_t cap;
  const int32_t* count;
  const int32_t* nxt;
  const float* log_w;
  const uint32_t* k1;
  const uint32_t* k2;
  uint64_t kmod;
  float inv_k;
};

// One row over m elements (the port of _build_eval's `one`): the accept
// positions (chunk-relative, the (cap-1)-th entry overwritten past cap, the
// rest 0), the fill prefix's length, the accept count and the state after
// the chunk.  int32 arithmetic wraps, as XLA's does.
void eval_row(const Gate& g, int32_t r, int32_t m, int32_t* pos, int32_t* fill, int32_t* n_acc,
              int32_t* count_out, int32_t* nxt_out, float* log_w_out) {
  const int32_t c = g.count[r];
  int32_t n = g.nxt[r];
  float lw = g.log_w[r];
  const uint32_t k1 = g.k1[r], k2 = g.k2[r];
  const int32_t end = static_cast<int32_t>(static_cast<uint32_t>(c) + static_cast<uint32_t>(m));
  std::memset(pos, 0, sizeof(int32_t) * static_cast<size_t>(g.cap));
  int32_t acc = 0;
  while (n <= end) {
    pos[acc < g.cap - 1 ? acc : g.cap - 1] =
        static_cast<int32_t>(static_cast<uint32_t>(n) - static_cast<uint32_t>(c) - 1u);
    const int32_t before = n;
    algl::advance(lw, n, k1, k2, static_cast<uint32_t>(g.k), g.kmod, g.inv_k);
    ++acc;
    if (n == before) break;  // saturated at int32 max: the chain cannot move on
  }
  int32_t f = static_cast<int32_t>(static_cast<uint32_t>(g.k) - static_cast<uint32_t>(c));
  f = f < 0 ? 0 : f;
  *fill = f > m ? m : f;
  *n_acc = acc;
  *count_out = end;
  *nxt_out = n;
  *log_w_out = lw;
}

// Threads a whole evaluation uses: the core count up to 16; 1 evaluates on
// the calling thread.
int planned_threads() {
  const unsigned hc = std::thread::hardware_concurrency();
  return hc == 0 ? 1 : (hc > 16 ? 16 : static_cast<int>(hc));
}

// Rows a thread takes at least: below it the threads cost more than they save.
constexpr int32_t kRowsPerThread = 1024;

}  // namespace

extern "C" {

// A replica over the caller's arrays ([S] each; k1/k2 the key words).
// Returns null on bad arguments or allocation failure.
void* rsv_gate_create(int32_t num_rows, int32_t k, int32_t cap, const int32_t* count,
                      const int32_t* nxt, const float* log_w, const uint32_t* k1,
                      const uint32_t* k2) {
  if (num_rows < 0 || k < 1 || cap < 1 || !count || !nxt || !log_w || !k1 || !k2) return nullptr;
  Gate* g = new (std::nothrow) Gate;
  if (g == nullptr) return nullptr;
  *g = Gate{num_rows, k, cap, count, nxt, log_w, k1, k2,
            algl::fastmod_multiplier(static_cast<uint32_t>(k)),
            1.0f / static_cast<float>(k)};
  return g;
}

void rsv_gate_destroy(void* handle) { delete static_cast<Gate*>(handle); }

// Row `row` over m elements: out[0] fill, out[1] accepts, out[2] count after,
// out[3] nxt after, out[4 .. 4 + cap) the accept positions; *log_w_out the
// log W after.  Costs that row's accepts only.  Returns 0, or -1 on bad
// arguments.
int32_t rsv_gate_eval_row(void* handle, int32_t row, int32_t m, int32_t* out, float* log_w_out) {
  const Gate* g = static_cast<const Gate*>(handle);
  if (g == nullptr || row < 0 || row >= g->num_rows || m < 0 || !out || !log_w_out) return -1;
  eval_row(*g, row, m, out + 4, out, out + 1, out + 2, out + 3, log_w_out);
  return 0;
}

// Every row r over m[r] elements (m[r] = 0 leaves it as it is): pos is
// [S, cap], the rest [S].  Rows are split over threads by range.  Returns
// the threads used, or -1 on bad arguments.
int32_t rsv_gate_eval(void* handle, const int32_t* m, int32_t* pos, int32_t* fill, int32_t* n_acc,
                      int32_t* count_out, int32_t* nxt_out, float* log_w_out) {
  const Gate* g = static_cast<const Gate*>(handle);
  if (g == nullptr || !m || !pos || !fill || !n_acc || !count_out || !nxt_out || !log_w_out)
    return -1;
  for (int32_t r = 0; r < g->num_rows; ++r)
    if (m[r] < 0) return -1;
  auto range = [&](int32_t lo, int32_t hi) {
    for (int32_t r = lo; r < hi; ++r)
      eval_row(*g, r, m[r], pos + static_cast<size_t>(r) * g->cap, fill + r, n_acc + r,
               count_out + r, nxt_out + r, log_w_out + r);
  };
  int32_t threads = planned_threads();
  const int32_t most = g->num_rows / kRowsPerThread;
  if (threads > most) threads = most < 1 ? 1 : most;
  if (threads == 1) {
    range(0, g->num_rows);
    return 1;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  const int32_t per = (g->num_rows + threads - 1) / threads;
  for (int32_t t = 1; t < threads; ++t) {
    const int32_t lo = t * per;
    const int32_t hi = lo + per < g->num_rows ? lo + per : g->num_rows;
    pool.emplace_back(range, lo, hi);
  }
  range(0, per < g->num_rows ? per : g->num_rows);
  for (auto& th : pool) th.join();
  return threads;
}

// The threads a whole evaluation of many rows uses.
int32_t rsv_gate_threads() { return planned_threads(); }

}  // extern "C"
