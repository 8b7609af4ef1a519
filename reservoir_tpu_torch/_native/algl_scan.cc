// Native bulk path for the host Algorithm-L oracle (duplicates mode), a
// copy of the JAX package's.
//
// The Python skip-jump path (oracle/algorithm_l.py::_sample_indexed)
// already touches only accepted elements, but each acceptance pays the
// interpreter for three Generator calls and the float math.  This scan is
// the identical loop in C, drawing from the SAME numpy bit stream: the
// caller passes the BitGenerator's next_double function pointer + state
// (numpy's documented ctypes interface), so native and Python paths
// produce bit-identical reservoirs under one seed.
//
// Draw order per acceptance (the oracle's documented contract):
//   slot = floor(next_double * k); u1 = 1 - next_double; u2 = 1 - next_double
// matching AlgorithmLOracle._evict / _advance exactly.
//
// Exposed as a plain C ABI for ctypes (no pybind11).

#include <cmath>
#include <cstdint>

extern "C" {

typedef double (*next_double_fn)(void*);

// Scan elems[0..n) in steady state (reservoir full, count >= k).  Returns
// the new count; samples/log_w/next_acc are updated in place.
int64_t reservoir_algl_scan(void* next_double_ptr, void* rng_state,
                            const int64_t* elems, int64_t n, int64_t k,
                            int64_t* samples, int64_t count, int64_t next_acc,
                            double log_w, double* log_w_out,
                            int64_t* next_out) {
  next_double_fn next_double =
      reinterpret_cast<next_double_fn>(next_double_ptr);
  int64_t i = 0;
  while (true) {
    // absolute stream index of elems[i] is count + i + 1; the next
    // acceptance (absolute index next_acc) sits at offset:
    int64_t target = i + (next_acc - count) - 1;
    if (target >= n) {
      count += n - i;
      break;
    }
    count += target - i + 1;
    i = target + 1;
    // evict: overwrite a uniform slot, then redraw W / next (Algorithm L,
    // Sampler.scala:243-246 / :228-236 semantics)
    int64_t slot = static_cast<int64_t>(next_double(rng_state) * (double)k);
    samples[slot] = elems[target];
    double u1 = 1.0 - next_double(rng_state);
    double u2 = 1.0 - next_double(rng_state);
    log_w += std::log(u1) / static_cast<double>(k);
    double w = std::exp(log_w);
    int64_t skip;
    if (w < 1.0) {
      skip = static_cast<int64_t>(std::floor(std::log(u2) / std::log1p(-w)));
    } else {
      skip = 0;  // log1p(-1) = -inf -> immediate re-accept
    }
    next_acc += skip + 1;
  }
  *log_w_out = log_w;
  *next_out = next_acc;
  return count;
}

}  // extern "C"
