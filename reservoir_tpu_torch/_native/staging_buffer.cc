// Host-side staging buffer for the device stream bridge.
//
// The reference's stream stage touches one element per actor callback
// (SampleImpl.scala:27-31, single-threaded per stage); feeding a TPU takes
// tile-granular flushes instead, and the expensive host-side step is the
// *demux*: an interleaved feed of (stream_id, element) pairs must be
// scattered into per-stream rows of the [S, B] staging tile.  In Python
// that is an interpreter-speed loop; here it is a tight pointer walk.
//
// Concurrency contract: one staging buffer is single-producer/
// single-consumer — push_* and drain may run on different threads (ctypes
// releases the GIL during calls), guarded by a mutex.  Multiple producers
// need their own serialization, matching the sampler thread-safety contract
// of the reference (Sampler.scala:19).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace {

struct StagingBuffer {
  int32_t num_streams;
  int32_t tile_width;
  int32_t elem_size;   // bytes per element
  int32_t value_arrays;  // 1 (elements only) or 2 (elements + weights)
  // backing store per value array: internally owned by default, or
  // caller-owned after rsv_staging_attach (the zero-copy flush mode — the
  // demux scatters straight into the flush tile, so "drain" degenerates
  // to reading the fill counts)
  uint8_t* base[2];
  uint8_t* owned;      // the internal allocation (kept for destroy)
  int32_t* fill;       // [S]
  int32_t* scratch;    // [S] fill simulation for the parallel pre-pass
  std::mutex mu;

  uint8_t* row(int arr, int32_t s) {
    return base[arr] +
           static_cast<size_t>(s) * tile_width * elem_size;
  }
};

// ----------------------------------------------------------------- demux pool
//
// The single-threaded interleaved scatter tops out around ~9e7 pairs/s
// (DRAM-latency-bound dependent random accesses into a tile that at
// config-5 scale is a ~100 MB working set) — a hard ceiling below the
// 1e9 north star for a per-element feed.  The scatter parallelizes by
// STREAM-ROW RANGE: the tile and the fill array are row-partitioned, so
// T workers each scanning the whole pair batch but scattering only their
// own contiguous row range touch disjoint memory — no locks, no atomics,
// per-stream arrival order preserved (each worker walks pairs in index
// order).  Contiguous ranges (not s % T) keep workers' fill[] entries on
// disjoint cache lines.  The shared scan of the pair array is a cheap
// sequential read; the expensive random writes split T ways.
//
// Worker count: RESERVOIR_STAGING_THREADS (default: hardware_concurrency,
// capped at 16; <=1 disables).  The pool is process-lifetime (detached
// threads, leaked singleton — destroying a condvar with waiters at exit
// is UB).  A forked child (no inherited threads) is detected by pid and
// served by the calling thread running every range itself — same result,
// just serial.
// The worker count the pool WOULD use — readable without constructing
// the pool, so small-batch-only processes never spawn idle threads.
int planned_workers() {
  static const int n = [] {
    const char* env = std::getenv("RESERVOIR_STAGING_THREADS");
    int v;
    if (env) {
      v = std::atoi(env);
      if (v < 1) v = 1;  // explicit 0/negative = force the serial demux
    } else {
      unsigned hc = std::thread::hardware_concurrency();
      v = hc ? static_cast<int>(hc) : 1;
      if (v > 16) v = 16;
    }
    if (v > 64) v = 64;
    return v;
  }();
  return n;
}

class DemuxPool {
 public:
  static DemuxPool& instance() {
    static DemuxPool* p = new DemuxPool;  // leaked: see class comment
    return *p;
  }

  int workers() const { return nworkers_; }

  // False in a forked child (threads not inherited): callers take the
  // plain serial demux instead of run()'s all-ranges fallback, which
  // would scan the batch T times for identical output.
  bool usable() const { return nworkers_ > 1 && getpid() == owner_pid_; }

  // Run fn(t) for t in [0, workers()); blocks until all complete.  The
  // calling thread serves range 0.  Serialized across callers (one
  // task-broadcast slot) — concurrent StagingBuffers queue up here.
  void run(const std::function<void(int)>& fn) {
    if (nworkers_ <= 1 || getpid() != owner_pid_) {
      for (int t = 0; t < nworkers_; ++t) fn(t);
      return;
    }
    std::lock_guard<std::mutex> run_lock(run_mu_);
    {
      std::lock_guard<std::mutex> lk(mu_);
      fn_ = &fn;
      pending_ = nworkers_ - 1;
      ++gen_;
    }
    cv_.notify_all();
    fn(0);
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
    fn_ = nullptr;
  }

 private:
  DemuxPool() : owner_pid_(getpid()) {
    const int n = planned_workers();
    nworkers_ = n;
    for (int t = 1; t < n; ++t) {
      std::thread([this, t] {
        uint64_t seen = 0;
        std::unique_lock<std::mutex> lk(mu_);
        for (;;) {
          cv_.wait(lk, [&] { return gen_ != seen; });
          seen = gen_;
          const std::function<void(int)>* fn = fn_;
          lk.unlock();
          (*fn)(t);
          lk.lock();
          if (--pending_ == 0) done_cv_.notify_one();
        }
      }).detach();
    }
  }

  std::mutex run_mu_;  // one broadcast at a time
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int)>* fn_ = nullptr;
  uint64_t gen_ = 0;
  int pending_ = 0;
  int nworkers_ = 1;
  pid_t owner_pid_;
};

// below this batch size the broadcast overhead beats the split's win
constexpr int64_t kParallelMin = 8192;

// Sequential-contract pre-pass: the index of the first pair the serial
// demux would REJECT (bad id, or its row full at processing time), i.e.
// the exact count the caller may treat as consumed.  Runs on a fill-
// simulation scratch so the real counters stay untouched; one dependent
// L2 access per pair — cheap next to the tile scatter it unblocks.
int64_t demux_prefix(StagingBuffer* sb, const int32_t* streams, int64_t n) {
  const uint32_t S = static_cast<uint32_t>(sb->num_streams);
  const int32_t width = sb->tile_width;
  if (n >= sb->num_streams) {
    // batch at least as long as the fill array: the O(S) snapshot
    // amortizes over the walk
    std::memcpy(sb->scratch, sb->fill,
                sizeof(int32_t) * static_cast<size_t>(sb->num_streams));
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t s = static_cast<uint32_t>(streams[i]);
      if (s >= S) return i;
      if (sb->scratch[s] >= width) return i;
      ++sb->scratch[s];
    }
    return n;
  }
  // batch much shorter than the fill array (huge S, near-threshold n):
  // an O(S) copy would rival the scatter itself, so simulate against
  // fill[] directly and rewind by replaying the consumed prefix — the
  // caller holds sb->mu, so the transient mutation is unobservable
  int64_t stop = n;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t s = static_cast<uint32_t>(streams[i]);
    if (s >= S || sb->fill[s] >= width) {
      stop = i;
      break;
    }
    ++sb->fill[s];
  }
  for (int64_t i = 0; i < stop; ++i) --sb->fill[streams[i]];
  return stop;
}

// One worker's share of the parallel scatter: pairs [0, n) whose stream
// falls in [lo, hi).  Bounds and overflow were resolved by demux_prefix,
// so the walk is branch-light; rows outside the range are untouched —
// the disjointness that makes the split lock-free.
template <typename E>
void demux_range(StagingBuffer* sb, const int32_t* streams, const void* elems,
                 const void* weights, int64_t n, uint32_t lo, uint32_t hi) {
  const auto* esrc = static_cast<const E*>(elems);
  const auto* wsrc = static_cast<const uint32_t*>(weights);
  auto* tile = reinterpret_cast<E*>(sb->base[0]);
  auto* wtile = reinterpret_cast<uint32_t*>(sb->base[1]);
  const int32_t width = sb->tile_width;
  const uint32_t span = hi - lo;
  int32_t* fill = sb->fill;
  constexpr int64_t kPrefetch = 16;
  for (int64_t i = 0; i < n; ++i) {
    if (i + kPrefetch < n) {
      const uint32_t ps = static_cast<uint32_t>(streams[i + kPrefetch]);
      if (ps - lo < span) {
        __builtin_prefetch(&fill[ps], 1, 1);
        __builtin_prefetch(
            &tile[static_cast<size_t>(ps) * width + fill[ps]], 1, 0);
        if (wsrc) {
          __builtin_prefetch(
              &wtile[static_cast<size_t>(ps) * width + fill[ps]], 1, 0);
        }
      }
    }
    const uint32_t s = static_cast<uint32_t>(streams[i]);
    if (s - lo >= span) continue;  // another worker's row
    const int32_t f = fill[s];
    const size_t at = static_cast<size_t>(s) * width + f;
    tile[at] = esrc[i];
    if (wsrc) wtile[at] = wsrc[i];
    fill[s] = f + 1;
  }
}

// Demux inner loop, specialized on the element width: the generic
// per-pair memcpy(elem_size) cannot be inlined (runtime size) and its
// call overhead dominates the walk; typed loads/stores cut the per-pair
// cost to the unavoidable scatter.  Weights, when present, are always
// 4 bytes (the staging layer enforces 4-byte elements for weighted mode).
template <typename E>
int64_t demux_typed(StagingBuffer* sb, const int32_t* streams,
                    const void* elems, const void* weights, int64_t n) {
  const auto* esrc = static_cast<const E*>(elems);
  const auto* wsrc = static_cast<const uint32_t*>(weights);
  auto* tile = reinterpret_cast<E*>(sb->base[0]);
  auto* wtile = reinterpret_cast<uint32_t*>(sb->base[1]);
  const int32_t width = sb->tile_width;
  const uint32_t S = static_cast<uint32_t>(sb->num_streams);
  int32_t* fill = sb->fill;
  // The scatter is DRAM-latency-bound at config-5 scale (the [S, B] tile
  // is a ~100 MB working set; each pair's slot is a dependent random
  // access).  Prefetch the fill counter and the approximate target slot a
  // few pairs ahead — the slot address is exact when the stream does not
  // repeat within the window, and a one-slot miss still pulls the right
  // cache line for B >= 16.
  constexpr int64_t kPrefetch = 16;
  int64_t i = 0;
  for (; i < n; ++i) {
    if (i + kPrefetch < n) {
      const uint32_t ps = static_cast<uint32_t>(streams[i + kPrefetch]);
      if (ps < S) {
        __builtin_prefetch(&fill[ps], 1, 1);
        __builtin_prefetch(
            &tile[static_cast<size_t>(ps) * width + fill[ps]], 1, 0);
        if (wsrc) {
          __builtin_prefetch(
              &wtile[static_cast<size_t>(ps) * width + fill[ps]], 1, 0);
        }
      }
    }
    const uint32_t s = static_cast<uint32_t>(streams[i]);
    if (s >= S) break;  // bad id (incl. negative): stop before it
    const int32_t f = fill[s];
    if (f >= width) break;  // row full: hand control back for a drain
    const size_t at = static_cast<size_t>(s) * width + f;
    tile[at] = esrc[i];
    if (wsrc) wtile[at] = wsrc[i];
    fill[s] = f + 1;
  }
  return i;
}

}  // namespace

extern "C" {

// Create a buffer for S streams x B elements of elem_size bytes each.
// value_arrays=2 keeps a parallel tile (e.g. weights) routed identically.
void* rsv_staging_create(int32_t num_streams, int32_t tile_width,
                         int32_t elem_size, int32_t value_arrays) {
  if (num_streams <= 0 || tile_width <= 0 || elem_size <= 0 ||
      value_arrays < 1 || value_arrays > 2) {
    return nullptr;
  }
  auto* sb = new (std::nothrow) StagingBuffer;
  if (!sb) return nullptr;
  sb->num_streams = num_streams;
  sb->tile_width = tile_width;
  sb->elem_size = elem_size;
  sb->value_arrays = value_arrays;
  size_t plane = static_cast<size_t>(num_streams) * tile_width * elem_size;
  size_t bytes = static_cast<size_t>(value_arrays) * plane;
  // value-initialized: drained rows include never-written slots (whole-row
  // memcpy), and downstream float consumers must never see heap garbage
  // (NaN weight bits would defeat the bridge's positivity clamp)
  sb->owned = new (std::nothrow) uint8_t[bytes]();
  sb->fill = new (std::nothrow) int32_t[num_streams]();
  sb->scratch = new (std::nothrow) int32_t[num_streams]();
  if (!sb->owned || !sb->fill || !sb->scratch) {
    delete[] sb->owned;
    delete[] sb->fill;
    delete[] sb->scratch;
    delete sb;
    return nullptr;
  }
  sb->base[0] = sb->owned;
  sb->base[1] = value_arrays == 2 ? sb->owned + plane : nullptr;
  return sb;
}

void rsv_staging_destroy(void* handle) {
  auto* sb = static_cast<StagingBuffer*>(handle);
  if (!sb) return;
  delete[] sb->owned;
  delete[] sb->fill;
  delete[] sb->scratch;
  delete sb;
}

// Zero-copy flush mode: scatter future pushes straight into caller-owned
// tile storage ([S][B][elem_size]; weights iff value_arrays == 2).  The
// caller guarantees the buffers outlive the attachment and are not read
// concurrently with pushes (the bridge's single-producer contract).
// Passing null tile re-attaches the internal buffer.
int32_t rsv_staging_attach(void* handle, void* tile, void* weights) {
  auto* sb = static_cast<StagingBuffer*>(handle);
  if (!sb) return -1;
  std::lock_guard<std::mutex> lock(sb->mu);
  if (!tile) {
    size_t plane =
        static_cast<size_t>(sb->num_streams) * sb->tile_width * sb->elem_size;
    sb->base[0] = sb->owned;
    sb->base[1] = sb->value_arrays == 2 ? sb->owned + plane : nullptr;
    return 0;
  }
  if ((sb->value_arrays == 2) != (weights != nullptr)) return -1;
  sb->base[0] = static_cast<uint8_t*>(tile);
  sb->base[1] = static_cast<uint8_t*>(weights);
  return 0;
}

// The zero-copy "drain": hand back the per-row fill counts and reset them.
// Tile data needs no copy — it is already in the attached buffer.  Returns
// the total staged element count.
int64_t rsv_staging_take(void* handle, int32_t* out_valid) {
  auto* sb = static_cast<StagingBuffer*>(handle);
  if (!sb || !out_valid) return -1;
  std::lock_guard<std::mutex> lock(sb->mu);
  int64_t total = 0;
  for (int32_t s = 0; s < sb->num_streams; ++s) {
    out_valid[s] = sb->fill[s];
    total += sb->fill[s];
    sb->fill[s] = 0;
  }
  return total;
}

// Append a contiguous chunk to one stream's row.  Returns the number of
// elements consumed (< n iff the row filled mid-chunk; caller drains and
// retries from the returned offset).
int64_t rsv_staging_push_chunk(void* handle, int32_t stream,
                               const void* elems, const void* weights,
                               int64_t n) {
  auto* sb = static_cast<StagingBuffer*>(handle);
  if (!sb || stream < 0 || stream >= sb->num_streams || n < 0) return -1;
  if ((sb->value_arrays == 2) != (weights != nullptr)) return -1;
  std::lock_guard<std::mutex> lock(sb->mu);
  int32_t fill = sb->fill[stream];
  int64_t take = sb->tile_width - fill;
  if (take > n) take = n;
  if (take > 0) {
    std::memcpy(sb->row(0, stream) + static_cast<size_t>(fill) * sb->elem_size,
                elems, static_cast<size_t>(take) * sb->elem_size);
    if (weights) {
      std::memcpy(
          sb->row(1, stream) + static_cast<size_t>(fill) * sb->elem_size,
          weights, static_cast<size_t>(take) * sb->elem_size);
    }
    sb->fill[stream] = fill + static_cast<int32_t>(take);
  }
  return take;
}

// Demux interleaved (stream_id, element[, weight]) pairs into the staging
// rows — the hot call.  Returns pairs consumed; < n iff some row filled
// (caller drains, then resumes from the offset).  A bad stream id stops
// consumption at that pair and returns the count before it (callers detect
// it by checking streams[consumed] themselves; -1 signals invalid args).
int64_t rsv_staging_push_interleaved(void* handle, const int32_t* streams,
                                     const void* elems, const void* weights,
                                     int64_t n) {
  auto* sb = static_cast<StagingBuffer*>(handle);
  if (!sb || !streams || !elems || n < 0) return -1;
  if ((sb->value_arrays == 2) != (weights != nullptr)) return -1;
  std::lock_guard<std::mutex> lock(sb->mu);
  const bool typed =
      sb->elem_size == 4 || (sb->elem_size == 8 && !weights);
  // planned_workers() gates WITHOUT constructing the pool: a process
  // that only ever pushes small batches never spawns idle threads, and
  // a forked child (pool not usable) falls through to the serial demux
  // rather than run()'s T-scan fallback.
  if (typed && n >= kParallelMin && planned_workers() > 1 &&
      DemuxPool::instance().usable()) {
    // parallel scatter: resolve the sequential stop point first (the
    // serial contract — consume a prefix, stop at a full row or bad id),
    // then split the guaranteed-safe prefix across row-range workers.
    // A SMALL prefix (hot row nearly full: n pairs requested, few
    // consumable) falls through to the serial scatter — a pool
    // broadcast for a few hundred pairs costs more than it saves.
    const int64_t n_eff = demux_prefix(sb, streams, n);
    if (n_eff >= kParallelMin) {
      DemuxPool& pool = DemuxPool::instance();
      const int T = pool.workers();
      const uint64_t S = static_cast<uint64_t>(sb->num_streams);
      if (sb->elem_size == 4) {
        pool.run([&](int t) {
          demux_range<uint32_t>(sb, streams, elems, weights, n_eff,
                                static_cast<uint32_t>(S * t / T),
                                static_cast<uint32_t>(S * (t + 1) / T));
        });
      } else {
        pool.run([&](int t) {
          demux_range<uint64_t>(sb, streams, elems, weights, n_eff,
                                static_cast<uint32_t>(S * t / T),
                                static_cast<uint32_t>(S * (t + 1) / T));
        });
      }
      return n_eff;
    }
  }
  switch (sb->elem_size) {
    case 4:
      return demux_typed<uint32_t>(sb, streams, elems, weights, n);
    case 8:
      // weighted 8-byte staging keeps the generic path (its parallel
      // array is elem_size-wide by the historical layout; the Python
      // layer only builds weighted staging with 4-byte elements)
      if (!weights) return demux_typed<uint64_t>(sb, streams, elems, weights, n);
      break;
    default:
      break;
  }
  // generic fallback for exotic element widths
  const auto* esrc = static_cast<const uint8_t*>(elems);
  const auto* wsrc = static_cast<const uint8_t*>(weights);
  const int32_t esize = sb->elem_size;
  const int32_t width = sb->tile_width;
  int64_t i = 0;
  for (; i < n; ++i) {
    int32_t s = streams[i];
    if (s < 0 || s >= sb->num_streams) break;
    int32_t fill = sb->fill[s];
    if (fill >= width) break;  // row full: hand control back for a drain
    std::memcpy(sb->row(0, s) + static_cast<size_t>(fill) * esize,
                esrc + static_cast<size_t>(i) * esize, esize);
    if (wsrc) {
      std::memcpy(sb->row(1, s) + static_cast<size_t>(fill) * esize,
                  wsrc + static_cast<size_t>(i) * esize, esize);
    }
    sb->fill[s] = fill + 1;
  }
  return i;
}

// The demux worker count this process would use (env/core-count derived;
// 1 = serial).  Telemetry for the bridge's stage table — a capture on a
// multi-core host records how parallel its demux actually was.
int32_t rsv_staging_threads() { return planned_workers(); }

// Current fill of one row — O(1) flush-due check for single-stream pushes.
int32_t rsv_staging_fill(void* handle, int32_t stream) {
  auto* sb = static_cast<StagingBuffer*>(handle);
  if (!sb || stream < 0 || stream >= sb->num_streams) return -1;
  std::lock_guard<std::mutex> lock(sb->mu);
  return sb->fill[stream];
}

// True iff any row is at tile width (a flush is due).
int32_t rsv_staging_any_full(void* handle) {
  auto* sb = static_cast<StagingBuffer*>(handle);
  if (!sb) return 0;
  std::lock_guard<std::mutex> lock(sb->mu);
  for (int32_t s = 0; s < sb->num_streams; ++s) {
    if (sb->fill[s] >= sb->tile_width) return 1;
  }
  return 0;
}

// Copy the staged tile(s) + per-row fill counts out and reset the buffer.
// out_tile is [S][B][elem_size]; out_weights may be null when
// value_arrays == 1.  Returns the total staged element count.
int64_t rsv_staging_drain(void* handle, void* out_tile, void* out_weights,
                          int32_t* out_valid) {
  auto* sb = static_cast<StagingBuffer*>(handle);
  if (!sb || !out_tile || !out_valid) return -1;
  if ((sb->value_arrays == 2) != (out_weights != nullptr)) return -1;
  std::lock_guard<std::mutex> lock(sb->mu);
  size_t row_bytes = static_cast<size_t>(sb->tile_width) * sb->elem_size;
  int64_t total = 0;
  for (int32_t s = 0; s < sb->num_streams; ++s) {
    int32_t fill = sb->fill[s];
    // copy whole rows: the valid mask excludes stale bytes downstream
    std::memcpy(static_cast<uint8_t*>(out_tile) + s * row_bytes,
                sb->row(0, s), row_bytes);
    if (out_weights) {
      std::memcpy(static_cast<uint8_t*>(out_weights) + s * row_bytes,
                  sb->row(1, s), row_bytes);
    }
    out_valid[s] = fill;
    total += fill;
    sb->fill[s] = 0;
  }
  return total;
}

}  // extern "C"
