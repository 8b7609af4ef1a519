"""Smoke test of the torch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's paths on ``"cuda"`` — the uniform engine,
``ReservoirEngine(SamplerConfig(k=128, R=65536, tile_size=2048), key=0)``,
the weighted engine, ``ReservoirEngine(SamplerConfig(k=64, R=16384,
tile_size=1024, weighted=True), key=0)``, and the distinct engine,
``ReservoirEngine(SamplerConfig(k=256, R=4096, tile_size=1024,
distinct=True, element_dtype=...), key=0)`` with int32 and int64 keys, and
the merge path, four shard engines of each of those configurations combined
by ``parallel.merge``'s stream mergers through the all-gather kernel, and
the stream bridge at the uniform configuration, with and without its skip
gate, and the reference's public surface: the pass-through operator
``Sample.device`` and the interop ``SampleServer`` with card samplers, at
BASELINE.md config 1's size, and the serving plane: the engine's row
operations and ``ReservoirService`` at bench.py's serve and traffic
shapes, the hot standby and its failover at the ha shape, and the sharded
cluster at the shards / merge shape, WIDE counters, the reference's
``map_fn`` / ``hash_fn`` hooks and fused stream in each mode, and the
sharded engine (``mesh_axis``) over 8 ranks of the card, the parity
selftest in its child process, a mesh over two processes, the open-loop
load tool and the tile kernels' launch geometry with its autotune cache —
and holds each CUDA kernel against its plain torch version.  Phases, each of
which fails the run with a non-zero exit:

1. device: require a CUDA card; print its name and power limit;
2. build: compile ``reservoir_tpu_torch/csrc`` with nvcc, print the seconds;
   then count, in the SASS of a probe built with the same flags
   (``cuobjdump``), the instructions of a 32-bit and a 64-bit ``%`` by pipe,
   which the merge kernels' bounds (phases 19 and 38) count a scan step;
3. kernel vs plain version on the card at R=65536, k=128, B=2048, for
   int32 and float32 tiles (with -0.0 and NaN bit patterns planted), and
   for int32 at k=100: a partial fill tile of width 64, a tile across the
   fill boundary, two steady tiles and a ragged tile — samples, count, nxt
   and log_w must be bit-identical;
4. the kernel's log over all 2^24 points of the uniform grid, and its exp
   and log1p over the ranges the chain visits, must equal the torch recipe
   bit for bit;
5. the plain version on the CPU for rows 0..1023 must equal the kernel's
   rows bit for bit (queued, and run after phase 48 in child processes, as
   the CPU references of phases 9, 13, 36 and 39 are, so that no timed
   phase shares the host with them; their lines come after phase 48's);
6. engine path: 8 device-resident tiles then 2 numpy tiles (pinned host
   copies), then ``result_arrays()``: every size is k, every sample lies in
   its row's stream with no repeats, the kernel was launched once per tile,
   and the sampled positions pass the one-sample KS gate;
7. timings (CUDA events around 10 back-to-back launches, median of 11
   such runs): the kernel per fill tile and per steady tile beside the
   plain version and the bound, and per steady tile deep in the stream
   (count 24 B) beside the bound, with the kernel's build (registers a
   thread, local memory for spills, shared memory a block, resident warps
   an SM), the engine's
   elements/s fed from the device and from the host, a host tile's
   snapshot into pinned memory and copy to the card, and the engine fed
   from the host once its pinned buffers are warm;
8. weighted kernel vs plain version on the card at R=16384, k=64, B=1024,
   for int32 and float32 tiles (with -0.0 and NaN bit patterns planted): a
   partial fill tile of width 32 from empty, a tile across the fill's end
   with ~30% zero weights, two steady tiles with the benchmark's weights
   ``1 + 0.5 cos^2(elem * 1e-3)``, a ragged tile, and a tile with subnormal
   and lognormal weights — samples, lkeys, count and xw must be
   bit-identical;
9. the plain weighted version on the CPU for rows 0..1023 must equal the
   kernel's rows bit for bit;
10. weighted engine path: 8 device-resident tiles then 2 numpy tiles, each
   with weight ``pos % 3`` for the element ``row * N + pos``: every size is
   k, no zero-weight element is sampled, every sample lies in its row's
   stream with no repeats, the kernel was launched once per tile, the share
   of weight-2 samples is within 0.005 of 2/3, and the positions sampled
   within the weight-1 class pass the KS gate;
11. weighted timings as in 7: the kernel per fill tile (from empty) and per
   steady tile (from count 7 B) beside the plain version, the bound and the
   build, and the steady tile again with every weight 0 (the scan without
   acceptances) beside its bytes bound;
12. distinct kernel vs plain version on the card at R=4096, k=256, B=1024,
   for int32, uint32 and int64 keys, from a state whose salts send a
   planted key to the hash (MAX, MAX) in every 97th row: a partial tile of
   width 64 from empty (the planted key in every row), a tile across the
   fill's end, three Zipf tiles (bench.py's recipe), a tile of one value,
   a tile of values already held, a tile of negative keys and a ragged tile
   (keep-max, on full rows) — values, value_hi, hash_hi, hash_lo, size and
   count must be bit-identical, and no planted row may hold the planted
   key (the Pallas rule); a ragged tile of width 64 from empty (valid
   6..64, int32 and int64) through keep-max, bit-identical, every planted
   row (none full) holding the planted key (the XLA rule); then, at
   R=8, k=19371 (int32) and k=14529 (int64), the first k whose row block
   passes shared memory, two tiles that fill the rows and evict;
13. the plain distinct version on the CPU for rows 0..1023 must equal the
   kernel's rows bit for bit;
14. distinct engine path, int32 and int64 keys: 8 device-resident Zipf
   tiles, 2 numpy tiles and a tail of 640 keys a row (``valid`` given),
   then ``result_arrays()``: the default kernel was launched once per full
   tile and keep-max once for the tail, every row equals an exact host
   oracle (the k
   smallest scrambled hashes among the row's distinct keys, in numpy with
   the port's own hashing), every size is min(k, #distinct), and the share
   of sampled keys seen at least 10 times in their row is within 0.01 of
   that share among all the row's distinct keys (uniform over distinct
   values, not weighted by frequency);
15. distinct timings as in 7: the kernel on a Zipf tile from empty, on a
   steady Zipf tile (after 8) and on a steady tile of fresh random keys
   (int32), and on a steady Zipf tile and a Zipf tile from empty with int64
   keys, each beside the plain version, the bound and the build; keep-max
   on the steady Zipf tile with every lane given as ``valid`` and with a
   ragged count, each beside the default on the full tile, the plain
   version, the bound and the build; ``torch.sort`` of the ``[R, k + B]``
   packed hashes as context (not the same function);
16. the all-gather kernel vs its plain version, bit for bit on every rank's
   copy: ``ring_all_gather`` for d in {2, 3, 4, 8} ranks on the card, b in
   {1, 5, 64, 4096}, W in {1, 8, 129} and int32, uint32 and float32 words
   (NaN payloads and -0.0 planted), each twice back to back on one
   communicator (the flags count epochs); ``gather_parts`` on mixed leaves
   and at the main path's shape (4 ranks of ``[65536, 128]`` samples and
   ``[65536]`` counts); with two or more cards, the same with the ranks on
   distinct cards, else a line that says the cross-card path was not run;
17. the merge tree on the card equals the same on the CPU: uniform,
   weighted and distinct ``merge_samples_device`` over P in {2, 3, 5, 8}
   parts with partial fills (4 ranks on the card against the host tree),
   and the three stream mergers over 5 shards of 256 rows; then the merge
   kernel ``algl_merge_draws`` against its plain version ``merge_draws``
   on the card, bit for bit (j_a and both sides' keys), at k in {1, 5, 128,
   1000} over 2,048 rows of counts 0, partial, one side empty, totals past
   2^31, totals wrapping past 2^32 and denominators just past 2^31 (about
   every second draw rejected), A's counts uint32 and B's int32 (negative
   past 2^31 - 1) and, but at k = 1000, the other way round, one launch a
   call, and the merge through it
   (``merge_samples_keyed``) equal to the plain merge for int32, uint32
   and float32 words with NaN payloads, with no host sync (sync debug mode
   "error"); at [65536, 128] against the plain version on the card (timed
   once) and rows 0..1023 against the plain version on the CPU;
18. the merge path at full width, the launch counts set to 0 before it:
   four uniform shard engines (R=65536, k=128, B=2048, their own seeds) fed
   streams of 1000, 4096, 6144 and 8192 elements a row, merged by
   ``uniform_stream_merger``: every merged size is k, every count the
   total, no position twice in a row, the KS gate over the union stream,
   and each shard's share of the samples within 5 sigma of its share of the
   stream; four distinct shard engines (R=4096, k=256, one seed, so shared
   salts) fed 1, 2, 3 and 4 Zipf tiles, merged by
   ``distinct_stream_merger``: equal, entry for entry, to one engine run
   over all 10 tiles, and on rows 0..1023 to the exact oracle; four
   weighted shard engines (R=16384, k=64, their own seeds) fed 1, 2, 3 and
   4 tiles with weight ``pos % 3``, merged by ``weighted_stream_merger``:
   no zero-weight sample, the weight-2 share within 0.005 of 2/3; one
   gather launch a merger, and one merge kernel launch a level of the
   uniform merger's tree (2); and beside each merger, ``gather_parts`` on its four shards' own
   leaves (its launch shape) against the plain version, every rank's copy
   bit for bit, in a launch that the path's count leaves out;
19. merge timings as in 7: the all-gather at phase 18's uniform shape
   (``gather_times``: the wrapper's calls back to back, the bare launch
   with its arguments and outputs made beforehand, one call between the
   events, the host's time a call, and the build) beside its bytes bound,
   its plain version and ``torch.stack`` of the packed blocks once a rank (the library yardstick; over NCCL only where
   there is more than one card); the merge kernel at [65536, 128] beside
   its bound (from the draws of phase 17's plain run), its plain version
   and the torch argsort and gather that follow it; and one batched
   pairwise merge of each mode at its configuration's shape (host clock,
   synchronised);
20. bridge build: the host staging library built with g++ and loaded
   (``NativeStaging(...).available()``), with ``os.cpu_count()`` and the
   demux's thread count;
21. the stream bridge at full width, ``DeviceStreamBridge(SamplerConfig(
   k=128, R=65536, tile_size=2048), key=0)``: R x B x 3 random (stream,
   element) pairs through ``push_interleaved``, pipelined and serial, the
   launch count set to 0 before the pipelined run: both states
   bit-identical, each flush where the staging contract puts it (from the
   pairs' ranks in their rows), one ``algl_update`` a flush, equal to the
   card engine fed the same per-row streams in tiles of 1536, and rows
   0..1023 equal to the plain version on the CPU; ``algl_update`` timed on
   the second flush's ragged tile beside the same tile full; the weighted
   (R=16384, k=64, B=1024) and distinct (R=4096, k=256, B=1024, int32 and
   int64 Zipf keys) bridges journal their flushes, and the card engine fed
   the journaled tiles must reach the same state; ``DeviceSampler`` (R=1,
   B=2048, k=128) equals the engine on the same stream;
22. bridge timings at full width (host clock around a window that ends in
   ``drain_barrier()`` and ``torch.cuda.synchronize()``, after a warm
   pass): elem/s for (a) the random pairs, (b) a lockstep interleave, one
   full tile a step, (c) ``push_tile`` of host tiles, each with its stage
   table (demux, take, copy by CUDA events, dispatch, wait in reserve);
   the engine's rates from phase 7; the wire's ceiling, 4RB bytes over
   the copy's ms; and, from one ``torch.profiler`` window over feed (b),
   how much of the tile copies' time overlaps the demux of the next tile;
23. bridge recovery on the card: R=4096, B=1024, ``checkpoint_every=2``,
   dropped halfway; ``recover()`` and the rest of the stream from the
   durable watermark give the uninterrupted run's samples, bit for bit;
24. the gated kernel ``algl_update_gated`` vs its plain version at R=65536,
   k=128, gate tile 64, int32 and float32 (-0.0 and NaN planted), on
   candidate tiles the port's own replica builds from card states: across
   the fill's end (count k - 20), past the fill with few candidates (count
   k - 3), steady (count 4 B) and deep (count 24 B), every 7th row with
   nvalid 0 and advance 0 — samples, count, nxt and log_w bit-identical to
   the plain version on the card and to ``algl_update`` over the whole
   tile, rows 0..1023 to the plain version on the CPU; the native replica
   over all 65,536 rows of each int32 state (its rows split over threads;
   a replica never reads the samples) equal to the torch replica on every
   256th row;
25. the gated bridge at full width, ``DeviceStreamBridge(SamplerConfig(
   k=128, R=65536, tile_size=2048), key=0, gated=True)``, every launch
   count set to 0 first: (a) a lockstep ``push_interleaved`` of 12 tiles,
   then (b) 3 rounds of ``push(row, chunk)`` of 8,192 elements
   ``row * N + pos`` a row, round-robin, made at each push; after each,
   the state equals the card engine fed the same row streams in
   ``[R, B]`` tiles, with one ``algl_update_gated`` launch a gated
   dispatch and one ``algl_update`` a fallback flush; the skip fraction;
   then a gated journaling bridge (R=4096, B=1024, ``checkpoint_every=2``)
   dropped from halfway on at the first tile after which its journal
   holds a gated frame, ``recover()`` replaying the ``RTJG`` frames
   through the kernel, and the rest of the stream: the uninterrupted
   run's samples;
26. gate timings (host clock around a window that ends in
   ``drain_barrier()`` and ``torch.cuda.synchronize()``, after a warm
   pass): logical elem/s of feeds (a) and (b) gated and through an
   ungated bridge fed the same pushes, with each window's stage table
   (demux, take, copy, dispatch, reserve, gate eval, bytes shipped and
   elided); the replica's ``evaluate`` over 65536 rows and
   ``evaluate_row``, native and torch; ``algl_update_gated`` a dispatch
   beside its bound and its plain version, with its build.

27. the pass-through operator on the card at BASELINE.md config 1's size,
   the launch counts set to 0 before each flow:
   ``Sample.device(128, key=0, tile_size=1024)`` drained over a stream of
   1,048,876 elements (``range``): 1,025 ``algl_update`` launches (1,024
   full tiles and the ragged 300), the sample equal to the same flow with
   ``device="cpu"`` and to a card ``DeviceSampler`` fed the stream as one
   array, bit for bit; ``run_async`` over an async generator of the same
   stream: the same launches and sample; ``Sample.device(256,
   distinct=True, element_dtype="int64", key=0)`` over 1,048,576 Zipf keys
   (``min(u^-10, 1e7)``, numpy seed 27): 1,024 ``distinct_update_keepmax``
   launches (a sampler's flushes pass ``valid``), the sample equal to
   phase 14's exact oracle under the
   engine's salts; a graceful ``cancel()`` after 500,000 elements delivers
   the sample of a ``DeviceSampler`` fed those, ``cancel(cause)`` fails
   the future with the cause, a dropped operator with
   ``AbruptStreamTermination``; the KS gate over the sampled positions of
   512 materializations (keys 0-511) of an 8,192-element stream;
28. ``SampleServer`` on 127.0.0.1 with a factory of card ``DeviceSampler``s
   (``tile_size=1024``, key 0; int32 for mode 0, int64 distinct keys for
   mode 1): 8 concurrent mode-0 connections (k = 128), each a different
   stream of 524,288 int64 values below 2^31 in 8 ``B`` frames of
   65,536, then ``C``: 4,096 ``algl_update`` launches, each reply equal to
   a card ``DeviceSampler`` fed that stream; one mode-1 connection (k =
   256, phase 27's Zipf keys): 1,024 ``distinct_update_keepmax`` launches, the
   reply equal to the exact oracle; an ``F`` connection answered ``A``,
   the server serving after an abrupt disconnect, a frame over
   ``MAX_FRAME_ELEMS`` refused;
29. operator timings: on the host clock, elements/s of the host
   ``Sample(128)`` drained over config 1's 1,048,576-element ``range``,
   ``api.sampler(128).sample_all`` of the ``range`` and of an int64 array
   (both through the C scan) and with ``native=False``,
   ``api.distinct(256).sample_all`` of the Zipf keys (C scan and
   ``native=False``), ``Sample.device(128)`` draining the stream (split
   into the flushes' host time, their launches included, and the
   per-element path), a card ``DeviceSampler.sample_all`` of one array,
   a ``[1, 1024]`` host tile's ``engine.sample`` with and without
   ``valid``, and the wire for 1 and 8 connections with the host and the
   device factory, each with the client's Nagle algorithm on and off
   (``TCP_NODELAY``), 5 runs of one connection and 2 of eight (median,
   least, most); with CUDA events, ``algl_update`` and
   ``distinct_update_keepmax`` (``valid`` given, as a flush passes it) on
   this path's steady ``[1, 1024]`` tiles (after 8 tiles) beside their
   bounds (both shorter than their wrappers' host time, so ``event_ms``
   reads host time there);
30. row operations on the card, in each mode at its configuration above,
   the update kernel's launch count set to 0 first: three engines (key 0)
   take 4 tiles; one resets 4,096 rows (R / 4 for the weighted and
   distinct configurations) of a permuted set with one row twice, whose
   rows must equal the compiled plain ``init`` on the CPU (the last
   occurrence of the repeated row winning); 1,024 rows of it are exported
   and adopted by the second; 4 more tiles, the second engine's adopted
   rows fed what the first's source rows are fed: the rows no operation
   touched equal the third engine's (which never reset), 1,024 reset rows
   (1,023 at the distinct configuration: all it resets) equal a
   ``device="cpu"`` engine given the same calls, the adopted rows
   equal their source rows, and the update kernel ran once a tile (24)
   and never for a row operation; then a uniform engine at k = 6 resets
   4,096 rows, whose ``log_w`` must equal the compiled plain ``init`` (the
   eager one would differ in some);
31. ``ReservoirService`` on the card, each launch count set to 0 before
   each part: (a) bench.py's serve shape (2,048 sessions, k = 32, four
   rounds of 256 int32 elements a session, ``coalesce_bytes`` 1 MiB) in
   the plain, weighted and distinct modes, one update launch a flush
   (``distinct_update_keepmax`` in distinct mode: a flush passes ``valid``);
   (d) the plain feed through ``gated=True``: every snapshot equals the
   ungated service's, one ``algl_update_gated`` a gated dispatch;
   (b) bench.py's traffic shape: 8,704 sessions opened in a seeded order
   on 8,192 rows (k = 8, a tile of 4 x 64), so 512 evictions recycle
   rows through ``reset_rows``; (c) a service with ``checkpoint_dir``
   killed after round 3, with 64 sessions recycled since its last
   checkpoint, brought back by ``ReservoirService.recover`` and fed round
   4: every snapshot equals a live service's; the snapshots and counters
   of (a) and (b) must equal the same services with ``device="cpu"``,
   which run in a child process on the CPU while the card works;
32. serving timings (host clock after ``torch.cuda.synchronize()``):
   sessions/s through bench.py's serve lifecycle (open, four rounds,
   sync, a snapshot each, close; best of 3 after a warm pass) with the
   registry's ``serve.snapshot_s`` and ``serve.ingest_s`` p50 and p99, the
   service's flushes' host time beside their ``engine.sample`` time, and
   ``reset_rows`` of 1, 64 and 4,096 rows, ``export_rows`` and
   ``adopt_rows`` of 1,024 rows at the uniform configuration (median of
   7).

33. hot standby and failover on the card at bench.py's ha shape (1,024
   sessions, k = 32, B = 256, four rounds, ``coalesce_bytes`` 1 MiB,
   ``checkpoint_every`` 2^30), in the plain, weighted and distinct modes
   and plain with ``gated=True``, every launch count set to 0 first: a
   checkpointing ``ReservoirService`` and a ``StandbyReplica`` on the card
   polling after every round, the standby's state equal to its primary's
   bit for bit after each poll and its update launches (counted around
   each poll) equal to the primary's flushes (gated dispatches and
   fallbacks apart); the primary shut down, a ``FailoverController`` under
   an injected clock promotes on the stale heartbeat, the old primary's
   flush and checkpoint raise ``FencedError`` with the journal unchanged,
   and the promoted primary takes a fifth round;
34. the cluster on the card at bench.py's shards / merge shape: a
   ``ShardedReservoirService`` of 4 shards of 512 rows, all on the one
   card, a standby a shard, 1,024 sessions, four rounds: one
   ``algl_update`` a primary flush and a standby tile; 8
   ``merged_snapshot`` groups of 8 keys, the default (over the shards'
   devices) and ``device="cuda"`` each equal to ``device="host"``, one
   ``merge_ring_gather`` launch and one ``algl_merge_draws`` launch a tree
   level (3) a card merge; 24
   migrations, the synced snapshot before each move equal to the first
   read after it; ``kill_shard(3)``, shards 0-2 taking a round meanwhile,
   ``promote_shard(3)``: shard 3's sessions read as before; a sixth round;
   ``ShardedReservoirService.recover`` of the directory gives the same
   snapshots; phases 33 and 34 must equal the same calls with
   ``device="cpu"``, which run in three child processes on the CPU after
   the card's work (so phase 35's host timings do not share the cores);
35. HA timings, from the registry enabled over phases 33-34: failover time
   (``ha.promote_s``, best and median of the 5 promotions), replication lag
   at each of phase 33's polls (the flushes not yet applied when the poll
   starts, and the poll's time to apply them), beside the replica's own
   ``replica.lag_seq_dist`` max and ``replica.lag_s_dist`` p50 (0 by
   construction in that lockstep loop, as they are read after the poll),
   each shard's ingest elem/s timed alone over phase 34's rounds and the
   cluster's rate, ``cluster.merge_s`` (the host tree) and
   ``cluster.merge_device_s`` (the default and ``"cuda"`` merges) p50/p99,
   ``cluster.migrate_s`` p50/p99.

36. the WIDE kernel ``algl_update_wide`` (``count_dtype="wide"``: ``[R, 2]``
   uint32 count and nxt) against its plain version on the card at R=65536,
   B=2048 for k in {128, 100, 6}: fill tiles of 64 and 128 from empty, six
   steady tiles (the last checked), all with a zero high word and equal to
   the int32 kernel on the same tiles; then the state lifted to 2^31 - 300,
   2^32 - 300 and 2^33 + 12,345 with imminent accepts (nxt = count + 1 +
   U[0, 3B)), three steady tiles each, the last ragged, every row passing
   its boundary — samples, count, nxt and log_w bit-identical; rows
   0..1023 of every run equal to the plain version on the CPU;
37. the WIDE path end to end, every launch count set to 0 before each part:
   (a) ``ReservoirEngine(SamplerConfig(k=128, R=65536, tile_size=2048,
   count_dtype="wide"), key=0)`` fed one tile, its rows moved up to
   2^32 - 5B + (r mod 9) B, saved and restored (the checkpoint's counts
   straddle 2^32), then 8 device tiles and 2 host tiles: 10
   ``algl_update_wide`` launches and none of the int32 kernels, every
   count past 2^32, every size k, every sample in its row's stream with no
   repeats, the KS gate, rows 0..1023 equal to a ``device="cpu"`` engine
   given the same rows and tiles; (b) a ``DeviceStreamBridge`` (R=4096,
   B=1024) that adopts rows lifted just below 2^32 (a WIDE ``RTJA`` frame)
   and takes 8 tiles, one launch a tile; dropped halfway and
   ``recover()``-ed from its journal, then the rest: the uninterrupted
   run's samples; with ``gated=True`` inert with the reference's reason and
   the same samples; rows 0..1023 equal to ``device="cpu"``; (c) a WIDE
   ``ReservoirService`` at bench.py's serve shape (2,048 sessions, k = 32,
   B = 256, four rounds), then 64 more sessions, each recycling a row
   through ``reset_rows``: one launch a flush, every snapshot and the state
   equal to ``device="cpu"``;
38. WIDE merges: (a) ``merge_samples_keyed`` of two WIDE ``[65536, 128]``
   states with counts up to 2^40, straddling 2^32 and 2^63: one
   ``algl_merge_draws_wide`` launch, the draws and the merge equal to the
   plain version on the card and, rows 0..1023, on the CPU, the counts the
   exact 64-bit totals; (b) ``uniform_stream_merger`` of 4 WIDE shards
   (counts 2^31..2^38): one ``merge_ring_gather`` and two
   ``algl_merge_draws_wide`` launches, exact totals, rows 0..1023 equal to
   the plain merger on CPU ranks; then timings as in 7:
   ``algl_update_wide`` on phase 7's fill, steady and deep tiles (a zero
   high word, and on the steady tiles the same chain past 2^32) beside the
   int32 kernel and
   the bound with 8-byte counters, ``algl_merge_draws_wide`` on phase 19's
   counts beside the narrow kernel and on (a)'s counts beside its bound
   and plain version, each with its build, and the WIDE engine's elem/s
   fed from the device;
39. the map hook (``map_fn``), each launch count set to 0 before each part:
   engines with an exact elementwise map at config 5 (int32 elements to
   float32 samples, and with WIDE counters), at the weighted configuration
   and at the distinct one with Zipf keys, 4 tiles each: 4 launches of the
   mode's kernel and none of another, rows 0..1023 equal to
   ``device="cpu"`` (the plain versions, map on accept); the map pass over
   a ``[65536, 2048]`` tile timed beside the steady kernel on the mapped
   tile, with its bytes bound; a mapped distinct tile launches the
   keep-max instantiation on the mapped keys (the reference runs a map on
   XLA): its map pass and the kernel timed beside the default kernel on
   the same mapped keys; then ``DeviceStreamBridge``s with a
   map (R=4096, B=1024, 4 lockstep rounds of 2,048 a row through
   ``push_interleaved``): gated with an int32 map, gated and ungated with
   an int32 to float32 map, each launching its flushes
   (``algl_update_gated`` its gated dispatches), its state equal to the
   ungated card engine with the map and, rows 0..1023, to
   ``device="cpu"``;
40. the hash hook (``hash_fn``): the pre-hashed instantiation of
   ``distinct_update`` against ``update_prehashed`` at R=4096, k=256,
   B=1024 with int32 and int64 keys (random from empty, Zipf, ragged Zipf,
   Zipf; an int64 tile as its planes) and beyond shared memory (k=19371
   int32, 14529 int64, R=8), bit for bit; an engine with a ``hash_fn`` fed
   8 device and 2 host Zipf tiles per key width: 10 pre-hashed launches
   and no other, rows 0..1023 equal to an exact host oracle of the k
   smallest (scrambled user hash, key) pairs; timings as in 15 of a steady Zipf
   tile and a tile from empty beside the default-hash kernel on the same
   keys, with the hash pass (and the user's ``hash_fn`` apart from the
   planes it is made into), the plain version, the bound and the build; a
   mapped distinct tile (``map_fn`` alone) through ``update_cuda``: one
   ``distinct_update_keepmax`` launch and no other, equal to the plain
   version, the call, its map pass and the launch timed;
41. the fused stream: ``sample_stream(fused=True)`` of a host stream of n
   full tiles and a tail of 17 at config 5 (n=4, int32 and WIDE
   counters), the weighted and the distinct (int64 keys) configurations
   and the distinct one with ``map_fn`` and ``hash_fn`` (n=8): n + 1
   launches of the mode's kernel (the distinct tail, ragged, through
   keep-max), the state equal to the per-tile path's
   bit for bit (the port feeds a fused stream tile by tile); elements/s
   fed from the host, on the second (warm) run.

42. meshed engines over 8 ranks of the card (``mesh=make_mesh(devices=
   ["cuda"] * 8)``, ``mesh_axis="res"``), each launch count set to 0
   first: config 5 (R=65536, k=128, B=2048: 8,192 rows a rank, as on
   the reference's v5e-8), the same with WIDE counters, the weighted
   configuration and the distinct one with Zipf int64 keys, each fed 10
   device and 2 host tiles: 8 launches a tile of the mode's kernel and no
   other, the state equal to the unmeshed card engine's bit for bit and,
   rows 0..1023, to a meshed ``device="cpu"`` engine's (2 CPU ranks, in a
   child process while the card works); elements/s fed from the device
   and from the host beside the unmeshed engine's, after a warm-up tile;
43. ``sharded_result`` of config 5's meshed state: one
   ``merge_ring_gather`` launch, every rank's samples and sizes equal to
   ``gather_parts_plain``'s, the total equal to the host's sum with its
   int32 wrap; the gather timed (one call between the events, and
   ``gather_times``' other three readings: the kernel's own time apart
   from the wrapper's host work) beside its bytes bound, (d + d^2) n 4 at
   3.35 TB/s, and the library call (the ``torch.cat`` of per-rank
   ``.to()`` copies onto every rank), and the whole call;
44. a meshed bridge (R=4096, B=1024, 8 ranks of the card) with
   ``gated=True``, inert with the reference's reason, over 8 lockstep
   ``push_interleaved`` tiles: 8 ``algl_update`` launches a flush, the
   samples equal to a meshed ``device="cpu"`` bridge's (2 CPU ranks, in a
   child process); then a journaling
   meshed bridge (``checkpoint_every=3``) dropped after 5 tiles,
   ``recover(mesh=)`` replaying its journaled flush through 8 launches,
   and the rest of the stream: the same samples.

45. the parity selftest, ``device_selftest_subprocess(timeout_s=300)``
   (``reservoir_tpu_torch/utils/selftest.py``, after its liveness probe):
   its dict and seconds on a line of their own; every kernel check
   (``algl``, ``algl_fill``, ``algl_wide``, ``algl_gated``, ``weighted``,
   ``distinct``, ``distinct_hashed``, ``distinct_keepmax``, ``merge_ring``,
   ``merge_draws``: the ten kernels against their plain versions, bit for
   bit, at R = 64, B =
   256), ``kernel_parity``, ``gated_parity``, ``merge_parity`` and the
   three KS gates true, nothing ``partial``, every kernel launched;
46. two processes joined over gloo, four ranks of the card each
   (``make_mesh(devices=["cuda"] * 4)`` in each: one 8-rank mesh) at
   config 5 (8,192 rows a rank, as phase 42): 10 device and 2 host tiles,
   4 ``algl_update`` launches a tile in each process, every row each
   process reads back (``engine.state``, a collective) equal to the
   unmeshed card engine fed the same tiles, ``sharded_result`` on every
   rank equal to the rows, one ``merge_ring_gather`` launch a process;
   elements/s fed from the device and the host beside phase 42's;
47. ``reservoir_tpu_torch.tools.loadgen.run_load`` against the card
   service for 3 s on the load tool's defaults (2,000 arrivals/s, 1,000
   sessions over 800 rows, Zipf 1.1, chunks of 64, churn 0.01, a snapshot
   every 13, the sample-quality auditor on): offered and served, no error,
   the ``sample_quality`` objective ``ok``, ``loadgen.wait_s`` p50/p99 and
   sessions/s beside phase 32's; then a short schedule (300 arrivals/s for
   1 s, 100 sessions over 48 rows, churn 0.05) under an injected clock:
   the counts, the service's counters and the engine's state equal to a
   ``device="cpu"`` service's (in a child process, started at phase 45);
48. the launch-geometry sweep (``reservoir_tpu_torch.tools.block_sweep``,
   its variants in one child process with a hard timeout) into a
   temporary autotune cache: ``algl_update`` at config 5 and at the serve
   shape (R = 2,048, k = 32, B = 256) at 32, 64, 128 and 256 threads a
   block, ``weighted_update`` at config 4 at 1, 2, 4 and 8 warps,
   ``distinct_update`` at the distinct shape at 1, 2 and 4 warps (each on
   its steady tile, every variant's state equal to the default geometry's
   bit for bit, then the bare launch timed in four turns), and three gate
   pairs (``gate_tile:gate_push_chunk`` 64:1Mi, 128:1Mi, 64:256Ki) on the
   gated bridge at the gate's A/B shape, a pass a turn; each variant's
   time with the card's name and power limit, and the cache holding a
   variant only where it beat the default in every turn past the spread;
   then engines at config 5 and at the serve shape that read a
   non-default entry (the fastest non-default variant, from a second
   temporary cache in ``RESERVOIR_ALGL_AUTOTUNE_CACHE``): their
   ``_geometry_by_key``, ``algl_update_rows`` launches, and rows 0..1023
   equal to a ``device="cpu"`` engine's.

Depth cut for the time limit: feed (b) follows feed (a) on the same
bridge, so its rows are past the early stream, where a row's 8,192
elements have more candidates than the gate tile and go through the
staging, one whole-tile flush per 2,048 (feed (a) keeps its 12 tiles: after
8, most of (b)'s pushes have more candidates than the gate tile and go
through the staging, which multiplied the phase's time); the windows of
(a) are its tiles 5-8 on both bridges (the gated one then takes tiles 9-12
outside the window) and of (b) its rounds 2-3; the ungated bridge's (b)
window is 32 pushes of round 1 (each push of 8,192 elements to one row
flushes the whole 512 MiB tile four times); phase 24 compares the two
replicas on the int32 states only; a mode-0 wire connection streams 8
frames of 65,536 in phase 28 and 4 in phase 29's timed runs, which run 5
times with one connection and twice with eight, and the host samplers'
rates are the median of 3 runs (2 for the slowest); phase 24's torch
replica runs on every 256th row, not every 64th; phase 39's mapped
bridges take 4 lockstep rounds, not 8; phase 31
(b) opens 8,704 sessions, so 512 rows recycle, not bench.py's 2,048 (each
recycle is a row reset of ~30 ms on the card).

A phase's line ends with the seconds since the script started.

The line before the last is ``{"kernels": [...]}``, before it
``{"geometry": {...}}`` (phase 48), ``{"selftest": {...}}`` (phases 45-47), ``{"sharded": {...}}`` (phases 42-44), ``{"hooks": {...}}`` (phases 39-41), ``{"wide": {...}}`` (phases 36-38), ``{"ha": {...}}`` (phases 33-35), ``{"serve": {...}}`` (phases 30-32), ``{"operator": {...}}`` (phases 27-29), ``{"gate": {...}}`` (phases
24-26) and ``{"bridge": {...}}`` (phases 20-23); the last line is
``{"ok": true, "device": {...}}``.  Without a card, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

R, K, B = 65536, 128, 2048
# the weighted path: bench.py's weighted configuration (BASELINE.md config 4)
WR, WK, WB = 16384, 64, 1024
ROWS_CPU = 1024
REPS = 11
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor float32
# FLOP/s; int32 ALU ops/s from the SM layout (64 INT32 lanes per SM x 132
# SMs x 1.98 GHz)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_INT32 = 64 * 132 * 1.98e9
# the IMAD pipe (64 lanes an SM) and the conversion and special-function
# unit (16 lanes an SM: MUFU, I2F, F2I)
PEAK_IMAD = 64 * 132 * 1.98e9
PEAK_SFU = 16 * 132 * 1.98e9
# a Threefry-2x32 block's operations that only the INT32 pipe issues: its
# 20 rounds' rotations and xors (its ~32 adds may issue to the FMA pipe as
# IMAD, so they are left out); every integer bound below counts a block so
THREEFRY_INT32_OPS = 40
# work per acceptance, counted from csrc/: four Threefry-2x32 blocks plus
# ~10 more INT32-pipe ops (the draw words' xors, the shifts of the
# uniforms, the skip's compares and selects; the slot's fastmod is IMAD);
# log (x2), exp, log1p and the skip arithmetic in float32 (an FMA counted
# as 2)
INT_OPS_PER_ACCEPT = 4 * THREEFRY_INT32_OPS + 10
FLOPS_PER_ACCEPT = 134
# state bytes per row and tile (count, nxt, log_w read and written, key
# read); per acceptance one 32-byte sector gathered, but no more than the
# tile, and one written, but each sample reaches memory once (rewrites stay
# in L2); a fill element is 4 bytes read and 4 written under the same caps
STATE_BYTES_PER_ROW = 28
SECTOR_BYTES = 32
# the weighted kernel, counted from csrc/weighted.cu: per weight lane the
# scan's adds and flushes and the ballots; per acceptance three Threefry
# blocks and 83 ops of the search ballots and the warp minimum, log twice,
# exp and two divisions; per filled slot two Threefry blocks and 17 ops, a
# log and a division
W_INT_OPS_PER_LANE = 4
W_FLOPS_PER_LANE = 16
W_INT_OPS_PER_ACCEPT = 3 * THREEFRY_INT32_OPS + 83
W_FLOPS_PER_ACCEPT = 90
W_INT_OPS_PER_FILL = 2 * THREEFRY_INT32_OPS + 17
W_FLOPS_PER_FILL = 28
# bytes: every weight read once (4 per lane), per row the lkeys read (4 k),
# count and xw read and written and the key read (24); one 32-byte sector
# of elements gathered per filled or accepted element, but no more than the
# element tile; one sector of samples and one of lkeys written per filled or
# accepted slot, but each slot reaches memory once (rewrites stay in L2)
W_STATE_BYTES_PER_ROW = 24
# the distinct path: bench.py's distinct configuration (BASELINE.md config 3)
DR, DK, DB = 4096, 256, 1024
# the bridge's recovery phase: tiles small enough that the journal costs
# seconds
RR, RB = 4096, 1024
# the skip gate's phases: the gate tile, feed (a)'s lockstep tiles, feed
# (b)'s rounds and chunk a row, and the ungated bridge's window of (b)
GATE_CAP = 64
# phase 24: the torch replica runs on every REPLICA_STRIDE-th row (32 rows
# in each of the native replica's 8 threads' ranges)
REPLICA_STRIDE = 256
FEED_A_TILES = 12
FEED_A_WINDOW = 4
FEED_B_ROUNDS = 3
FEED_B_CHUNK = 8192
UNGATED_B_PUSHES = 32
# the merge kernel's sample sizes in its cases
MERGE_KS = (1, 5, 128, 1000)
MERGE_ROWS = 2048
# the distinct kernel, counted from csrc/distinct.cu and csrc/hashing.cuh:
# per lane the scramble (4 salt xors, 6 rounds of an add, fmix32's 3 shifts,
# 3 xors and 2 multiplies, and the Feistel xor) and the compare and ballot;
# per insertion a binary search (8 integer ops a step) and the shift of
# half the block on average (one move per word)
D_OPS_PER_LANE = 68
D_OPS_PER_SEARCH_STEP = 8
# bytes per row: the threshold entry read (8), size and count read and
# written (16), the salts read (16); a row that inserts reads and writes its
# block (12 bytes an entry narrow, 16 wide)
D_STATE_BYTES_PER_ROW = 40
# phase 14: the engine's tail tile, D_TAIL keys a row (valid given)
D_TAIL = 640


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's line (it opens with ``[``) ends with the
    seconds since the script started, so the log shows where the run's
    time goes."""
    if msg.startswith("["):
        msg = f"{msg} | t+{time.perf_counter() - T_START:.1f} s"
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


# the compared fields of each state: words compared as integers, and floats
FIELDS = {
    "ReservoirState": (("samples", "count", "nxt"), ("log_w",)),
    "WeightedState": (("samples", "count"), ("lkeys", "xw")),
    "DistinctState": (("values", "value_hi", "hash_hi", "hash_lo", "size", "count"), ()),
    "MergeDraws": (("j_a",), ("u_a", "u_b")),
}


def same(a, b) -> bool:
    words, floats = FIELDS[type(a).__name__]
    for f in words + floats:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not torch.equal(bits(x), bits(y))):
            return False
    return True


def max_abs_err(a, b) -> float:
    """Largest difference over the compared fields, as values (int fields
    and sample words as int64, float fields as float64); 0 when
    bit-identical."""
    words, floats = FIELDS[type(a).__name__]
    err = 0.0
    for f in words:
        if getattr(a, f) is None:
            continue
        x, y = bits(getattr(a, f)).long(), bits(getattr(b, f)).long()
        err = max(err, float((x - y).abs().max().item()))
    for f in floats:
        x, y = getattr(a, f).double(), getattr(b, f).double()
        both = torch.isfinite(x) & torch.isfinite(y)
        if both.any():
            err = max(err, float((x[both] - y[both]).abs().max().item()))
        if not torch.equal(bits(getattr(a, f))[~both], bits(getattr(b, f))[~both]):
            err = float("inf")
    return err


def clone(state, rows=None, device=None):
    sl = slice(None) if rows is None else slice(0, rows)
    return type(state)(*(None if t is None else t[sl].clone().to(device or t.device) for t in state))


# The CPU references of phases 5, 9, 13, 36 and 39 (rows 0..ROWS_CPU - 1
# through the plain versions) are queued as their phases run and run after
# the last timed phase, in parallel child processes (B.11): no host-timed
# window shares the host with them.  collect_cpu_references() holds each
# against its card state and logs each phase's line then.
CPU_REFERENCES: list = []


def _cpu_child_init(threads: int) -> None:
    torch.set_num_threads(threads)


def check_on_cpu(label: str, want, fn, *args) -> None:
    """Queue ``fn(*args)`` (a module-level function returning a state on
    the CPU); ``collect_cpu_references`` runs it in a child process and
    holds its result against ``want`` under ``label``."""
    CPU_REFERENCES.append((label, want, fn, args))


def cpu_replay(module: str, state, fed: list):
    """In the child: ``state`` fed each ``(function name, args)`` of ``fed``
    through the plain version in ``module``."""
    import importlib

    ops = importlib.import_module(module)
    for name, args in fed:
        state = getattr(ops, name)(state, *args)
    return state


def cpu_map_engine(kw: dict, map_fn, tiles: list, weights: list):
    """In the child: a ``device="cpu"`` engine with ``map_fn`` fed
    ``tiles`` (and ``weights``); its state."""
    import reservoir_tpu_torch as rtt

    eng = rtt.ReservoirEngine(rtt.SamplerConfig(**kw), key=0, map_fn=map_fn, device="cpu")
    for tile, w in zip(tiles, weights):
        eng.sample(tile, weights=w)
    return eng.state


def collect_cpu_references() -> None:
    """Run every queued CPU reference in child processes, a core or more
    each, and hold each against its card state; fails on the first that
    differs."""
    import concurrent.futures
    import multiprocessing

    cores = os.cpu_count() or 2
    workers = max(1, min(len(CPU_REFERENCES), cores - 2, 6))
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                                initializer=_cpu_child_init,
                                                initargs=(max(1, cores // workers),)) as pool:
        futures = [(label, want, pool.submit(fn, *args)) for label, want, fn, args in CPU_REFERENCES]
        for label, want, future in futures:
            if not same(future.result(), want):
                fail(f"{label}: the plain version on the CPU != the card on rows 0..{ROWS_CPU - 1}")
            log(f"{label}: rows 0..{ROWS_CPU - 1} bit-identical (the plain version on the CPU, in a child "
                "process after the timed phases)")
    log(f"[CPU references] {len(futures)} runs in {workers} child processes after phase 48: "
        f"{time.perf_counter() - t0:.1f} s")
    CPU_REFERENCES.clear()


def event_ms(fn, reps: int = REPS, setup=None, batch: int = 1) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``batch``
    back-to-back calls, each on its own ``setup()`` argument made before
    the first event, divided by ``batch``; the median over ``reps`` such
    runs after one warm-up.  Back-to-back launches keep the host's launch
    overhead out of a short kernel's time."""
    times = []
    for i in range(reps + 1):
        args = [setup() if setup is not None else None for _ in range(batch)]
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for arg in args:
            fn(arg)
        e1.record()
        torch.cuda.synchronize()
        if i:
            times.append(e0.elapsed_time(e1) / batch)
        del args
    return statistics.median(times)


def build_text(info: dict) -> str:
    """A kernel's build as its timing line shows it."""
    return (f"{info['registers']} registers, {info['local_bytes']} bytes local (spills), "
            f"{info['static_smem'] + info['dynamic_smem']} bytes shared a block, "
            f"{info['warps_per_sm']} resident warps an SM")


def bound_ms(accepts: int, fill_elems: int, rows: int = R, width: int = B, k: int = K,
             state_bytes: int = STATE_BYTES_PER_ROW) -> tuple:
    """The uniform kernel's bound for a ``[rows, width]`` tile with
    ``accepts`` acceptances and ``fill_elems`` elements copied by the fill
    over all rows (the main path's shape unless given), with
    ``state_bytes`` of state a row (a WIDE row's are more)."""
    moved = SECTOR_BYTES * accepts + 4 * fill_elems
    nbytes = rows * state_bytes + min(moved, 4 * rows * width) + min(moved, 4 * rows * k)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(accepts * INT_OPS_PER_ACCEPT / PEAK_INT32, accepts * FLOPS_PER_ACCEPT / PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def weighted_bound_ms(accepts: int, fills: int, lanes: int) -> tuple:
    """The weighted kernel's bound for a tile of ``lanes`` weights with
    ``accepts`` acceptances and ``fills`` filled slots over all rows."""
    moved = accepts + fills
    gathered = min(SECTOR_BYTES * moved, 4 * lanes)
    written = min(2 * SECTOR_BYTES * moved, 8 * WR * WK)
    nbytes = 4 * lanes + WR * (4 * WK + W_STATE_BYTES_PER_ROW) + gathered + written
    t_bytes = nbytes / PEAK_BYTES
    int_ops = W_INT_OPS_PER_LANE * lanes + W_INT_OPS_PER_ACCEPT * accepts + W_INT_OPS_PER_FILL * fills
    flops = W_FLOPS_PER_LANE * lanes + W_FLOPS_PER_ACCEPT * accepts + W_FLOPS_PER_FILL * fills
    t_ops = max(int_ops / PEAK_INT32, flops / PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bench_weights(elems: torch.Tensor) -> torch.Tensor:
    """bench.py's weighted tile weights, ``1 + 0.5 cos^2(elem * 1e-3)``."""
    return (1.0 + 0.5 * torch.cos(elems.float() * 1e-3) ** 2).contiguous()


def weight_tile(gen, rows: int, width: int, kind: str, dev) -> torch.Tensor:
    w = torch.exp(torch.randn((rows, width), generator=gen, device=dev))
    if kind == "zeros":
        w = torch.where(torch.rand((rows, width), generator=gen, device=dev) < 0.3, 0.0, w)
    elif kind == "subnormal":
        u = torch.rand((rows, width), generator=gen, device=dev)
        w = torch.where(u < 0.2, 1e-40, torch.where(u < 0.25, 1.4e-45, w))
    return w.float().contiguous()


def weighted_tile(gen, t: int, width: int, kind: str, dtype, dev):
    """Tile t of the weighted plan: elements ``t * WB + lane`` (as
    bench.py feeds them) for the benchmark's weights, random words
    otherwise; float32 samples get -0.0 and NaN payloads planted."""
    if kind == "bench":
        elems = t * WB + torch.arange(width, dtype=torch.int32, device=dev)[None, :].expand(WR, width)
        elems = elems.contiguous()
        weights = bench_weights(elems)
    else:
        elems = torch.randint(-(2**31), 2**31 - 1, (WR, width), dtype=torch.int32, device=dev,
                              generator=gen)
        weights = weight_tile(gen, WR, width, kind, dev)
    return (plant_bits(elems) if dtype == torch.float32 else elems), weights


def plant_bits(t: torch.Tensor) -> torch.Tensor:
    """An int32 tile, with -0.0 and NaN payloads planted in place (they must
    travel as bits), viewed as float32."""
    width = t.shape[1]
    t[::7, 0] = -(2**31)            # -0.0
    t[1::7, 1 % width] = 0x7FC00001  # quiet NaN with a payload
    t[2::7, 2 % width] = -1          # 0xFFFFFFFF, negative NaN
    t[3::11, width - 1] = 0x7F800001  # signalling NaN
    return t.view(torch.float32)


def random_tile(gen, width: int, dtype, dev) -> torch.Tensor:
    t = torch.randint(-(2**31), 2**31 - 1, (R, width), dtype=torch.int32, device=dev, generator=gen)
    return plant_bits(t) if dtype == torch.float32 else t


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "reservoir_tpu_torch", "csrc")):
        fail("run chip_smoke.py from a checkout of the repository (reservoir_tpu_torch/ is missing)")
    sys.path.insert(0, here)
    import reservoir_tpu_torch as rtt

    if not os.path.abspath(rtt.__file__).startswith(here + os.sep):
        fail(f"reservoir_tpu_torch was imported from {rtt.__file__}, not from this checkout")
    for name in list(sys.modules):
        if name == "jax" or name.startswith("jax.") or name == "reservoir_tpu" or name.startswith("reservoir_tpu."):
            fail(f"{name} was imported")
    from reservoir_tpu_torch import _build
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import fmath
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed
    from reservoir_tpu_torch.utils.stats import KS_GATE, ks_one_sample_uniform

    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    kern._library()
    wkern._library()
    dkern._library()
    mkern._library()
    kern._merge_library()
    log(f"[2 build] csrc built and loaded in {time.perf_counter() - t0:.2f} s")
    REMAINDER_OPS.update(remainder_ops(os.path.join(here, "build", "chip_smoke")))
    log(f"[2 build] the merge scan's remainders on sm_90 (SASS, by pipe): "
        + (f"32-bit % {REMAINDER_OPS['rem32']}, 64-bit % {REMAINDER_OPS['rem64']} (through a subroutine: "
           f"{REMAINDER_OPS['subroutine']})" if REMAINDER_OPS else "cuobjdump missing: left out of the bounds"))

    # 3. kernel vs plain version, full width
    gen = torch.Generator(device=dev)
    cpu_checks = []
    worst_err = 0.0
    plan = [(64, False, True), (B, False, True), (B, False, False), (B, False, False), (B, True, False)]
    # k = 100 as well: with a k that is not a power of two, dividing by k
    # and multiplying by its float32 reciprocal round differently
    for dtype, k in ((torch.int32, K), (torch.float32, K), (torch.int32, 100)):
        gen.manual_seed(11)
        state_k = plain.init(key_from_seed(7), R, k, sample_dtype=dtype, device=dev)
        start_cpu = clone(state_k, ROWS_CPU, "cpu")
        fed = []
        for width, ragged, fill in plan:
            tile = random_tile(gen, width, dtype, dev)
            valid = (
                torch.randint(0, width + 1, (R,), dtype=torch.int32, device=dev, generator=gen)
                if ragged else None
            )
            before = clone(state_k)
            ref = (plain.update if fill else plain.update_steady)(before, tile, valid)
            state_k = (kern.update_cuda if fill else kern.update_steady_cuda)(state_k, tile, valid)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(state_k, ref))
            if not same(state_k, ref):
                fail(f"kernel != plain version ({dtype}, k {k}, width {width}, ragged {ragged}, "
                     f"fill {fill})")
            fed.append((tile[:ROWS_CPU].cpu(), None if valid is None else valid[:ROWS_CPU].cpu(), fill))
            del ref, before
        log(f"[3 kernel vs plain] {dtype}, k {k}: {len(plan)} tiles (partial fill, fill crossing, "
            "2 steady, ragged) bit-identical")
        cpu_checks.append((f"{dtype}, k {k}", start_cpu, fed, clone(state_k, ROWS_CPU, "cpu")))

    # 4. fmath on the card
    grid = (torch.arange(1, 2**24 + 1, dtype=torch.float64, device=dev) * 2.0**-24).float()
    ranges = {
        "log": grid,
        "exp": torch.cat([
            -30.0 * torch.rand(2**22, generator=gen, device=dev),
            -86.5 - 2.0 * torch.rand(2**20, generator=gen, device=dev),
        ]),
        "log1p": torch.cat([
            -torch.rand(2**22, generator=gen, device=dev),
            -torch.exp(-100.0 * torch.rand(2**20, generator=gen, device=dev)),
        ]),
    }
    for name, x in ranges.items():
        got = kern.fmath_cuda(x, name)
        want = getattr(fmath, name)(x)
        bad = int((bits(got) != bits(want)).sum().item())
        if bad:
            fail(f"kernel {name} differs from the torch recipe on {bad} of {x.numel()} inputs")
        log(f"[4 fmath] kernel {name} == torch recipe on {x.numel()} inputs")
    del grid, ranges

    # 5. card vs CPU (queued: run after the timed phases)
    for case, state_c, fed, want in cpu_checks:
        check_on_cpu(f"[5 card vs CPU] {case}", want, cpu_replay, "reservoir_tpu_torch.ops.algorithm_l", state_c,
                     [("update" if fill else "update_steady", (tile, valid)) for tile, valid, fill in fed])
    del cpu_checks

    # 6. the engine path
    N = 10 * B
    rows = torch.arange(R, dtype=torch.int32, device=dev)[:, None] * N
    cols = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    dev_tiles = [rows + (t * B) + cols for t in range(8)]
    host_rows = np.arange(R, dtype=np.int32)[:, None] * N
    host_cols = np.arange(B, dtype=np.int32)[None, :]
    host_tiles = [host_rows + (t * B) + host_cols for t in (8, 9)]
    torch.cuda.synchronize()
    kern.launches = 0
    wkern.launches = 0
    engine = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B), key=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tile in dev_tiles:
        engine.sample(tile)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    for tile in host_tiles:
        engine.sample(tile)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    samples, sizes = engine.result_arrays()
    main_launches = kern.launches
    if main_launches != 10 or wkern.launches != 0:
        fail(f"the engine launched algl_update {main_launches} times and weighted_update "
             f"{wkern.launches} times for 10 uniform tiles")
    if not (sizes == K).all():
        fail("not every reservoir holds k samples")
    row_of = samples // N
    pos = samples % N
    if not (row_of == np.arange(R)[:, None]).all():
        fail("a sample lies outside its row's stream")
    srt = np.sort(pos, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        fail("a row sampled one position twice")
    ks = ks_one_sample_uniform(pos.ravel(), N)
    if not ks < KS_GATE:
        fail(f"KS distance {ks} of sampled positions is not below {KS_GATE}")
    dev_eps = 8 * R * B / t_dev
    host_eps = 2 * R * B / t_host
    log(f"[6 engine] 10 tiles, launches {main_launches}, sizes all {K}, KS {ks:.6f} < {KS_GATE}; "
        f"{dev_eps:.6e} elem/s fed from the device, {host_eps:.6e} elem/s fed from the host")
    del dev_tiles, host_tiles, engine

    # 7. timings at the main path's shapes
    (_, s0, fill_tile, _), (_, state, steady_tile, _), (deep_label, deep, deep_tile, _) = \
        uniform_timing_cases(gen, dev)
    fill_ms = event_ms(lambda s: kern.update_cuda(s, fill_tile), setup=lambda: clone(s0), batch=10)
    t0 = time.perf_counter()
    ref, fill_accepts = plain.update_accepts(clone(s0), fill_tile, fill=True)
    torch.cuda.synchronize()
    fill_plain_ms = 1e3 * (time.perf_counter() - t0)
    fill_bound, fill_by = bound_ms(fill_accepts, R * K)
    del ref, fill_tile, s0
    steady_ms = event_ms(lambda s: kern.update_steady_cuda(s, steady_tile), setup=lambda: clone(state),
                         batch=10)
    plain_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, steady_accepts = plain.update_accepts(clone(state), steady_tile, fill=False)
        torch.cuda.synchronize()
        plain_times.append(1e3 * (time.perf_counter() - t0))
    steady_plain_ms = statistics.median(plain_times)
    steady_bound, steady_by = bound_ms(steady_accepts, 0)
    deep_ms = event_ms(lambda s: kern.update_steady_cuda(s, deep_tile), setup=lambda: clone(deep), batch=10)
    _, deep_accepts = plain.update_accepts(clone(deep), deep_tile, fill=False)
    deep_bound, deep_by = bound_ms(deep_accepts, 0)
    del steady_tile, state, deep_tile, deep
    # where a host-fed tile's time goes: the engine's snapshot into pinned
    # memory (host clock), then the non-blocking copy to the card (events)
    host_tile = np.arange(R * B, dtype=np.int32).reshape(R, B)
    pinned = torch.empty((R, B), dtype=torch.int32, pin_memory=True)
    snap_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pinned.numpy()[...] = host_tile
        snap_times.append(1e3 * (time.perf_counter() - t0))
    snapshot_ms = statistics.median(snap_times)
    h2d_ms = event_ms(lambda _: pinned.to(dev, non_blocking=True))
    del pinned
    # the engine fed from the host once its pinned buffers are allocated
    warm = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B), key=1)
    warm.sample(host_tile)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        warm.sample(host_tile)
    torch.cuda.synchronize()
    warm_host_eps = 4 * R * B / (time.perf_counter() - t0)
    del host_tile, warm
    card = card_line()
    build = kern.kernel_info()
    log(f"[7 timings] {card} | fill tile (count 0 -> {B}): kernel {fill_ms:.4f} ms, plain "
        f"{fill_plain_ms:.1f} ms, bound {fill_bound:.4f} ms ({fill_by}), accepts {fill_accepts}; "
        f"build {build_text(build)}")
    log(f"[7 timings] {card} | steady tile (count {7 * B} -> {8 * B}): kernel {steady_ms:.4f} ms, "
        f"plain {steady_plain_ms:.1f} ms, bound {steady_bound:.4f} ms ({steady_by}), "
        f"accepts {steady_accepts}")
    log(f"[7 timings] {card} | {deep_label}: kernel {deep_ms:.4f} ms, bound {deep_bound:.4f} ms "
        f"({deep_by}), accepts {deep_accepts}")
    log(f"[7 timings] {card} | engine: {dev_eps:.6e} elem/s fed from the device, "
        f"{host_eps:.6e} elem/s fed from the host")
    log(f"[7 timings] {card} | host tile of {4 * R * B} bytes: snapshot into pinned memory "
        f"{snapshot_ms:.2f} ms, copy to the card {h2d_ms:.2f} ms "
        f"({4 * R * B / h2d_ms / 1e6:.2f} GB/s); engine fed 4 more host tiles after a warm-up: "
        f"{warm_host_eps:.6e} elem/s")

    weighted = weighted_phases(gen, dev)
    distinct, keepmax_entry = distinct_phases(gen, dev)
    merge, merge_entry = merge_phases(gen, dev)
    bridge = bridge_phases(gen, dev, here, {"device_fed": dev_eps, "host_fed": host_eps,
                                            "host_fed_warm": warm_host_eps})
    gate, gated_entry = gate_phases(gen, dev, here)
    operator, algl_extra, keepmax_extra = operator_phases(dev)
    keepmax_entry.update(keepmax_extra)
    serve, serve_launches = serve_phases(gen, dev, here)
    algl_extra["serve_launches"] = serve_launches["algl_update"]
    weighted["serve_launches"] = serve_launches["weighted_update"]
    keepmax_entry["serve_launches"] = serve_launches["distinct_update_keepmax"]
    gated_entry["serve_launches"] = serve_launches["algl_update_gated"]
    ha, ha_launches = ha_phases(here)
    algl_extra["ha_launches"] = ha_launches["algl_update"]
    weighted["ha_launches"] = ha_launches["weighted_update"]
    keepmax_entry["ha_launches"] = ha_launches["distinct_update_keepmax"]
    gated_entry["ha_launches"] = ha_launches["algl_update_gated"]
    merge["ha_launches"] = ha_launches["merge_ring_gather"]
    merge_entry["ha_launches"] = ha_launches["algl_merge_draws"]
    wide, wide_entry, wide_merge_entry = wide_phases(
        gen, dev, here, {"fill_tile": fill_accepts, "steady_tile": steady_accepts, "deep_steady_tile": deep_accepts})
    hooks, hook_extra, prehashed_entry = hook_phases(gen, dev, here)
    sharded, sharded_extra = sharded_phases(gen, dev, here)
    selftest, selftest_extra = selftest_phases(dev, here, sharded, serve)
    geometry, geometry_extra = geometry_phase(dev, here)
    collect_cpu_references()

    card = card_line()
    log(card)
    log(json.dumps({"bridge": bridge}))
    log(json.dumps({"gate": gate}))
    log(json.dumps({"operator": operator}))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"ha": ha}))
    log(json.dumps({"wide": wide}))
    log(json.dumps({"hooks": hooks}))
    log(json.dumps({"sharded": sharded}))
    log(json.dumps({"selftest": selftest}))
    log(json.dumps({"geometry": geometry}))
    entries = [{
        "name": "algl_update",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/algorithm_l.cu",
        "replaces": "reservoir_tpu/ops/algorithm_l_pallas.py:110",
        "launches": main_launches,
        "bridge_launches": bridge["launches"],
        "max_abs_err": worst_err,
        "ms": steady_ms,
        "plain_ms": steady_plain_ms,
        "bound_ms": steady_bound,
        "bound_by": steady_by,
        "library_ms": None,
        "fill_tile": {"ms": fill_ms, "plain_ms": fill_plain_ms, "bound_ms": fill_bound,
                      "bound_by": fill_by, "accepts": fill_accepts},
        "steady_accepts": steady_accepts,
        "deep_steady_tile": {"ms": deep_ms, "bound_ms": deep_bound, "bound_by": deep_by,
                             "accepts": deep_accepts},
        "engine_elem_per_s": {"device_fed": dev_eps, "host_fed": host_eps},
        "host_tile_ms": {"snapshot": snapshot_ms, "h2d": h2d_ms},
        "warm_host_fed_elem_per_s": warm_host_eps,
        "build": build,
        "bridge_ragged_flush": bridge["ragged_flush"],
        "gated_bridge_fallback_launches": gate["fallback_launches"],
        **algl_extra,
    }, weighted, distinct, merge, gated_entry, merge_entry, wide_entry, wide_merge_entry, prehashed_entry,
        keepmax_entry]
    for entry in entries:
        entry.update(hook_extra.get(entry["name"], {}))
        entry.update(sharded_extra.get(entry["name"], {}))
        entry.update(selftest_extra.get(entry["name"], {}))
        entry.update(geometry_extra.get(entry["name"], {}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


def uniform_timing_cases(gen, dev) -> list:
    """Phase 7's tiles, each ``(label, state, tile, fill)``: random int32
    tiles at the main path's shape as the fill tile from count 0, the
    steady tile from count 7 B and a steady tile deep in the stream, from
    count 24 B, where a row expects ~5 accepts (``kernel_ab.py`` times the
    same)."""
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    gen.manual_seed(23)
    s0 = plain.init(key_from_seed(0), R, K, device=dev)
    fill_tile = random_tile(gen, B, torch.int32, dev)
    state = kern.update_cuda(clone(s0), fill_tile)
    for _ in range(6):  # steady tiles 2..7: count reaches 7 * B
        kern.update_steady_cuda(state, random_tile(gen, B, torch.int32, dev))
    steady_tile = random_tile(gen, B, torch.int32, dev)
    deep = clone(state)
    for _ in range(17):  # tiles 8..24: count reaches 24 * B
        kern.update_steady_cuda(deep, random_tile(gen, B, torch.int32, dev))
    deep_tile = random_tile(gen, B, torch.int32, dev)
    return [(f"fill tile (count 0 -> {B})", s0, fill_tile, True),
            (f"steady tile (count {7 * B} -> {8 * B})", state, steady_tile, False),
            (f"steady tile deep in the stream (count {24 * B} -> {25 * B})", deep, deep_tile, False)]


def weighted_timing_cases(dev) -> list:
    """Phase 11's tiles, each ``(label, state, elems, weights)``: bench.py's
    tiles (elements ``t * WB + lane``, weights ``1 + 0.5 cos^2(elem *
    1e-3)``) as the fill tile from empty, the steady tile from count 7 B,
    and that tile with every weight 0 (``kernel_ab.py`` times the same)."""
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    def bench_tile(t):
        elems = (t * WB + torch.arange(WB, dtype=torch.int32, device=dev))[None, :].expand(WR, WB)
        elems = elems.contiguous()
        return elems, bench_weights(elems)

    s0 = wplain.init(key_from_seed(0), WR, WK, device=dev)
    fill_e, fill_w = bench_tile(0)
    state = wkern.update_cuda(clone(s0), fill_e, fill_w)
    for t in range(1, 7):  # tiles 1..6: count reaches 7 * B
        wkern.update_cuda(state, *bench_tile(t))
    steady_e, steady_w = bench_tile(7)
    return [("fill tile from empty", s0, fill_e, fill_w), ("steady tile (count 7B)", state, steady_e, steady_w),
            ("steady tile with every weight 0", state, steady_e, torch.zeros_like(steady_w))]


def weighted_phases(gen, dev) -> dict:
    """Phases 8-11, the weighted path; returns its ``kernels`` entry."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed
    from reservoir_tpu_torch.utils.stats import KS_GATE, ks_one_sample_uniform

    # 8. weighted kernel vs plain version, full width
    plan = [(32, False, "lognormal"), (WB, False, "zeros"), (WB, False, "bench"),
            (WB, False, "bench"), (WB, True, "lognormal"), (WB, False, "subnormal")]
    worst_err = 0.0
    cpu_checks = []
    for dtype in (torch.int32, torch.float32):
        gen.manual_seed(31)
        state = wplain.init(key_from_seed(3), WR, WK, sample_dtype=dtype, device=dev)
        start_cpu = clone(state, ROWS_CPU, "cpu")
        fed = []
        for t, (width, ragged, kind) in enumerate(plan):
            elems, weights = weighted_tile(gen, t, width, kind, dtype, dev)
            valid = (torch.randint(0, width + 1, (WR,), dtype=torch.int32, device=dev, generator=gen)
                     if ragged else None)
            ref = wplain.update(clone(state), elems, weights, valid)
            state = wkern.update_cuda(state, elems, weights, valid)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(state, ref))
            if not same(state, ref):
                fail(f"weighted kernel != plain version ({dtype}, tile {t}: width {width}, {kind}, "
                     f"ragged {ragged})")
            fed.append((elems[:ROWS_CPU].cpu(), weights[:ROWS_CPU].cpu(),
                        None if valid is None else valid[:ROWS_CPU].cpu()))
            del ref
        filled = int((state.lkeys > float("-inf")).sum(1).min().item())
        if filled != WK:
            fail(f"a weighted reservoir holds {filled} < k keys after {len(plan)} tiles")
        log(f"[8 weighted kernel vs plain] {dtype}: {len(plan)} tiles (partial fill, fill end with "
            "zero weights, 2 steady with bench weights, ragged, subnormal) bit-identical")
        cpu_checks.append((f"{dtype}", start_cpu, fed, clone(state, ROWS_CPU, "cpu")))
        del state

    # 9. card vs CPU (queued: run after the timed phases)
    for case, state_c, fed, want in cpu_checks:
        check_on_cpu(f"[9 weighted card vs CPU] {case}", want, cpu_replay, "reservoir_tpu_torch.ops.weighted",
                     state_c, [("update", args) for args in fed])
    del cpu_checks

    # 10. the weighted engine path: element row * N + pos with weight pos % 3
    N = 10 * WB
    rows = torch.arange(WR, dtype=torch.int32, device=dev)[:, None] * N
    cols = torch.arange(WB, dtype=torch.int32, device=dev)[None, :]
    dev_tiles = [(rows + t * WB + cols, ((t * WB + cols) % 3).float().expand(WR, WB).contiguous())
                 for t in range(8)]
    host_rows = np.arange(WR, dtype=np.int32)[:, None] * N
    host_cols = np.arange(WB, dtype=np.int32)[None, :]
    host_tiles = [(host_rows + t * WB + host_cols,
                   np.broadcast_to(((t * WB + host_cols) % 3).astype(np.float32), (WR, WB)).copy())
                  for t in (8, 9)]
    torch.cuda.synchronize()
    kern.launches = 0
    wkern.launches = 0
    engine = rtt.ReservoirEngine(
        rtt.SamplerConfig(max_sample_size=WK, num_reservoirs=WR, tile_size=WB, weighted=True), key=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tile, weights in dev_tiles:
        engine.sample(tile, weights=weights)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    for tile, weights in host_tiles:
        engine.sample(tile, weights=weights)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    samples, sizes = engine.result_arrays()
    launches = wkern.launches
    if launches != 10 or kern.launches != 0:
        fail(f"the weighted engine launched weighted_update {launches} times and algl_update "
             f"{kern.launches} times for 10 tiles")
    if not (sizes == WK).all():
        fail("not every weighted reservoir holds k samples")
    row_of = samples // N
    pos = samples % N
    if not (row_of == np.arange(WR)[:, None]).all():
        fail("a weighted sample lies outside its row's stream")
    srt = np.sort(pos, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        fail("a weighted row sampled one position twice")
    cls = pos % 3
    if (cls == 0).any():
        fail(f"{int((cls == 0).sum())} zero-weight elements were sampled")
    share2 = float((cls == 2).mean())
    if abs(share2 - 2.0 / 3.0) > 0.005:
        fail(f"weight-2 share {share2:.6f} is not within 0.005 of 2/3")
    ks = ks_one_sample_uniform((pos[cls == 1] - 1) // 3, N // 3)
    if not ks < KS_GATE:
        fail(f"KS distance {ks} of weight-1 positions is not below {KS_GATE}")
    dev_eps = 8 * WR * WB / t_dev
    host_eps = 2 * WR * WB / t_host
    log(f"[10 weighted engine] 10 tiles, launches {launches}, sizes all {WK}, no zero-weight "
        f"sample, weight-2 share {share2:.6f} (2/3 +- 0.005), weight-1 KS {ks:.6f} < {KS_GATE}; "
        f"{dev_eps:.6e} elem/s fed from the device, {host_eps:.6e} elem/s fed from the host")
    del dev_tiles, host_tiles, engine

    # 11. timings at the weighted path's shapes (bench tiles)
    (_, s0, fill_e, fill_w), (_, state, steady_e, steady_w), (_, _, _, zero_w) = weighted_timing_cases(dev)
    fill_ms = event_ms(lambda s: wkern.update_cuda(s, fill_e, fill_w), setup=lambda: clone(s0),
                       batch=10)
    t0 = time.perf_counter()
    ref, fill_accepts = wplain.update_accepts(clone(s0), fill_e, fill_w)
    torch.cuda.synchronize()
    fill_plain_ms = 1e3 * (time.perf_counter() - t0)
    fills = int((ref.lkeys > float("-inf")).sum().item())
    fill_bound, fill_by = weighted_bound_ms(fill_accepts, fills, WR * WB)
    del ref, fill_e, fill_w
    steady_ms = event_ms(lambda s: wkern.update_cuda(s, steady_e, steady_w),
                         setup=lambda: clone(state), batch=10)
    plain_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, steady_accepts = wplain.update_accepts(clone(state), steady_e, steady_w)
        torch.cuda.synchronize()
        plain_times.append(1e3 * (time.perf_counter() - t0))
    steady_plain_ms = statistics.median(plain_times)
    steady_bound, steady_by = weighted_bound_ms(steady_accepts, 0, WR * WB)
    # the same tile with every weight 0: the scan and state traffic alone,
    # with no acceptance
    scan_ms = event_ms(lambda s: wkern.update_cuda(s, steady_e, zero_w), setup=lambda: clone(state),
                       batch=10)
    scan_bound, _ = weighted_bound_ms(0, 0, WR * WB)
    del state, steady_e, steady_w, zero_w
    build = wkern.kernel_info(WK)
    card = card_line()
    log(f"[11 weighted timings] {card} | fill tile (count 0 -> {WB}): kernel {fill_ms:.4f} ms, "
        f"plain {fill_plain_ms:.1f} ms, bound {fill_bound:.4f} ms ({fill_by}), accepts "
        f"{fill_accepts}, fills {fills}")
    log(f"[11 weighted timings] {card} | steady tile (count {7 * WB} -> {8 * WB}): kernel "
        f"{steady_ms:.4f} ms, plain {steady_plain_ms:.1f} ms, bound {steady_bound:.4f} ms "
        f"({steady_by}), accepts {steady_accepts}; the same tile with zero weights (no "
        f"acceptance) {scan_ms:.4f} ms, bound {scan_bound:.4f} ms (bytes); build {build_text(build)}")
    log(f"[11 weighted timings] {card} | engine: {dev_eps:.6e} elem/s fed from the device, "
        f"{host_eps:.6e} elem/s fed from the host")
    return {
        "name": "weighted_update",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/weighted.cu",
        "replaces": "reservoir_tpu/ops/weighted_pallas.py:95",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": steady_ms,
        "plain_ms": steady_plain_ms,
        "bound_ms": steady_bound,
        "bound_by": steady_by,
        "library_ms": None,
        "fill_tile": {"ms": fill_ms, "plain_ms": fill_plain_ms, "bound_ms": fill_bound,
                      "bound_by": fill_by, "accepts": fill_accepts, "fills": fills},
        "steady_accepts": steady_accepts,
        "steady_tile_zero_weights_ms": scan_ms,
        "steady_tile_zero_weights_bound_ms": scan_bound,
        "build": build,
        "engine_elem_per_s": {"device_fed": dev_eps, "host_fed": host_eps},
    }


def distinct_bound_ms(lanes: int, wide: bool, inserts: int, rows_inserting: int,
                      rows: int = DR, k: int = DK, prehashed: bool = False) -> tuple:
    """The distinct kernel's bound for a tile of ``lanes`` keys over
    ``rows`` rows (DR unless given), with ``inserts`` entries new to the
    state over ``rows_inserting`` rows (the least inserts any order of
    candidates needs); ``prehashed`` reads the two hash words of every lane
    and the value words of only the keys it inserts."""
    planes = 4 if wide else 3
    key_bytes = 8 if wide else 4
    tile_bytes = 8 * lanes + key_bytes * inserts if prehashed else key_bytes * lanes
    nbytes = tile_bytes + rows * D_STATE_BYTES_PER_ROW + rows_inserting * 2 * k * 4 * planes
    t_bytes = nbytes / PEAK_BYTES
    per_insert = D_OPS_PER_SEARCH_STEP * (k.bit_length() - 1) + planes * k // 2
    t_ops = (D_OPS_PER_LANE * lanes + per_insert * inserts) / PEAK_INT32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _hash_key(state) -> torch.Tensor:
    """A state's hashes as int64 in unsigned order (padding is the largest)."""
    hi = state.hash_hi.long() & 0xFFFFFFFF
    lo = state.hash_lo.long() & 0xFFFFFFFF
    return (hi - 2**31) * 2**32 + lo


def net_inserts(before, after) -> tuple:
    """``(entries of after not in before, rows with any)``: hashes identify
    keys, since the scramble is a permutation."""
    both = torch.sort(torch.cat([_hash_key(before), _hash_key(after)], 1), dim=1).values
    common = ((both[:, 1:] == both[:, :-1]) & (both[:, 1:] != 2**63 - 1)).sum(1)
    new = after.size.long() - common
    return int(new.sum().item()), int((new > 0).sum().item())


def zipf_keys(gen, rows: int, width: int, dtype, dev) -> torch.Tensor:
    """bench.py's distinct keys (``min(u ** -10, 1e7)``, u uniform on
    [1e-6, 1)); 8-byte keys are those times an odd 64-bit constant, which
    keeps which keys are equal and spreads them over both words."""
    u = torch.rand((rows, width), generator=gen, device=dev) * (1.0 - 1e-6) + 1e-6
    t = torch.clamp(u ** -10.0, max=1e7).to(torch.int64)
    return wide_or_narrow(t, dtype)


def wide_or_narrow(t: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int64:
        return (t * (0x9E3779B97F4A7C15 - 2**64)).contiguous()
    return t.to(torch.int32).view(dtype).contiguous()


def held_keys(state) -> torch.Tensor:
    """The state's keys as int64 (wide) or int32 words (narrow)."""
    lo = state.values.view(torch.int32)
    if state.value_hi is None:
        return lo
    return (state.value_hi.long() << 32) | (lo.long() & 0xFFFFFFFF)


def distinct_oracle(tiles, salts, samples, sizes) -> tuple:
    """Phase 14's exact host oracle, in numpy with the port's hashing: each
    row's k smallest scrambled hashes among its distinct keys (a hash of
    (MAX, MAX) is never taken).  Returns ``(ok, message, share of sampled
    keys seen >= 10 times, that share among all distinct keys)``."""
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import hashing

    def scrambled(keys):
        if keys.dtype.itemsize == 8:
            hi, lo = dplain.split_values_host(keys)
        else:
            hi, lo = hashing.default_hash64(keys)
        sh, sl = hashing.scramble64(hi, lo, salts[:, 0:1], salts[:, 1:2], salts[:, 2:3], salts[:, 3:4])
        return (sh.astype(np.uint64) << np.uint64(32)) | sl.astype(np.uint64)

    top = np.uint64(2**64 - 1)
    h = scrambled(np.concatenate(tiles, axis=1))
    h.sort(axis=1)
    rows, n = h.shape
    first = np.ones(h.shape, bool)
    first[:, 1:] = h[:, 1:] != h[:, :-1]
    first &= h != top
    rank = np.cumsum(first, axis=1)
    want_size = np.minimum(DK, rank[:, -1])
    if not (sizes == want_size).all():
        bad = int(np.flatnonzero(sizes != want_size)[0])
        return False, f"row {bad} holds {sizes[bad]} keys, min(k, #distinct) is {want_size[bad]}", 0, 0
    sel = first & (rank <= DK)
    want = np.full((rows, DK), top, np.uint64)
    r_idx, c_idx = np.nonzero(sel)
    want[r_idx, rank[r_idx, c_idx] - 1] = h[r_idx, c_idx]
    got = scrambled(samples)
    got[np.arange(DK)[None, :] >= sizes[:, None]] = top
    if not (got == want).all():
        bad = int(np.flatnonzero((got != want).any(1))[0])
        return False, f"row {bad} differs from the k smallest hashes of its distinct keys", 0, 0
    starts = np.flatnonzero(first.ravel())
    ends = np.append(starts[1:], rows * n)
    # a run ends where the next distinct key starts, or at its row's end
    ends = np.minimum(ends, (starts // n + 1) * n)
    heavy = (ends - starts) >= 10
    sampled = sel.ravel()[starts]
    return True, "", float(heavy[sampled].mean()), float(heavy.mean())


def distinct_timing_cases(gen, dev) -> list:
    """Phase 15's tiles in its order, each ``(label, state, tile, wide)``:
    Zipf tiles from empty and after 8 Zipf tiles, and fresh random keys
    after 8, with int32 and int64 keys (``kernel_ab.py`` times the same)."""
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    gen.manual_seed(47)
    s0 = dplain.init(key_from_seed(0), DR, DK, device=dev)
    cases = [("Zipf tile from empty (int32)", s0, zipf_keys(gen, DR, DB, torch.int32, dev), False)]
    state = clone(s0)
    for _ in range(8):
        state = dkern.update_cuda(state, zipf_keys(gen, DR, DB, torch.int32, dev))
    cases.append(("steady Zipf tile after 8 (int32)", state, zipf_keys(gen, DR, DB, torch.int32, dev), False))
    cases.append(("steady tile of fresh random keys after 8 Zipf (int32)", state,
                  torch.randint(-(2**31), 2**31 - 1, (DR, DB), dtype=torch.int32, device=dev, generator=gen),
                  False))
    ws0 = dplain.init(key_from_seed(0), DR, DK, sample_dtype=torch.int64, device=dev)
    ws = clone(ws0)
    for _ in range(8):
        ws = dkern.update_cuda(ws, zipf_keys(gen, DR, DB, torch.int64, dev))
    cases.append(("steady Zipf tile after 8 (int64)", ws, zipf_keys(gen, DR, DB, torch.int64, dev), True))
    cases.append(("Zipf tile from empty (int64)", ws0, zipf_keys(gen, DR, DB, torch.int64, dev), True))
    return cases


def distinct_phases(gen, dev) -> tuple:
    """Phases 12-15, the distinct path; returns its ``kernels`` entries:
    ``distinct_update``'s and ``distinct_update_keepmax``'s."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.convert import distinct_state_from_numpy, distinct_state_to_numpy
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.hashing import salt_for_target
    from reservoir_tpu_torch.ops.rng import key_from_seed

    # 12. distinct kernel vs plain version, full width
    plant_rows = torch.arange(0, DR, 97)
    worst_err = keepmax_err = 0.0
    cpu_checks = []
    plan = [("partial", 64, False), ("fill end", DB, False), ("zipf", DB, False), ("zipf", DB, False),
            ("zipf", DB, False), ("one value", DB, False), ("held", DB, False), ("negative", DB, False),
            ("ragged", DB, True)]
    def planted(dtype):
        """An empty state whose salts send the planted key to (MAX, MAX) in
        every 97th row, and the key (its 32-bit word, narrow)."""
        wide = dtype == torch.int64
        plant = (0x01234567, 0x89ABCDEF) if wide else (0, 123456789)
        host = distinct_state_to_numpy(dplain.init(key_from_seed(4), DR, DK, sample_dtype=dtype))
        salts = host["salts"].copy()
        for r in plant_rows.tolist():
            salts[r, 2:] = salt_for_target(plant, (0xFFFFFFFF, 0xFFFFFFFF), tuple(int(x) for x in salts[r, :2]))
        host["salts"] = salts
        return distinct_state_from_numpy(**host, device=dev), (plant[0] << 32) | plant[1] if wide else plant[1]

    for dtype in (torch.int32, torch.uint32, torch.int64):
        gen.manual_seed(41)
        wide = dtype == torch.int64
        state, plant_key = planted(dtype)
        start_cpu = clone(state, ROWS_CPU, "cpu")
        fed = []
        for t, (kind, width, ragged) in enumerate(plan):
            if kind in ("partial", "fill end"):
                tile = wide_or_narrow(torch.randint(-(2**62), 2**62, (DR, width), generator=gen, device=dev),
                                      dtype)
            elif kind == "one value":
                tile = wide_or_narrow(torch.full((DR, width), -77777, dtype=torch.int64, device=dev), dtype)
            elif kind == "held":
                tile = held_keys(state).repeat(1, DB // DK).contiguous()
                tile = tile.view(dtype) if not wide else tile
            elif kind == "negative":
                tile = -torch.randint(1, 2**62 if wide else 2**31, (DR, width), generator=gen, device=dev)
                tile = tile if wide else tile.to(torch.int32).view(dtype).contiguous()
            else:
                tile = zipf_keys(gen, DR, width, dtype, dev)
            if kind in ("partial", "ragged"):
                tile.view(torch.int64 if wide else torch.int32)[:, 5] = plant_key
            valid = None
            if ragged:
                valid = torch.randint(0, width + 1, (DR,), dtype=torch.int32, device=dev, generator=gen)
                valid[:2] = torch.tensor([0, width], dtype=torch.int32, device=dev)
            batch = tile
            if wide and kind == "fill end":  # an 8-byte tile as its (hi, lo) planes
                w = tile.view(torch.int32).view(DR, width, 2)
                batch = (w[..., 1].contiguous(), w[..., 0].contiguous())
            ref = dplain.update(clone(state), tile, valid)
            state = dkern.update_cuda(state, batch, valid)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(state, ref))
            if not same(state, ref):
                fail(f"distinct kernel != plain version ({dtype}, tile {t}: {kind}, width {width})")
            fed.append((tile[:ROWS_CPU].cpu(), None if valid is None else valid[:ROWS_CPU].cpu()))
            del ref
        held = held_keys(state)
        if (held[plant_rows] == plant_key).any().item():
            fail(f"a row whose salts send the planted key to (MAX, MAX) holds it ({dtype})")
        elsewhere = int((held == plant_key).any(1).sum().item())
        if int(state.size.min().item()) != DK:
            fail(f"a distinct reservoir holds fewer than k keys after {len(plan)} tiles ({dtype})")
        log(f"[12 distinct kernel vs plain] {dtype}: {len(plan)} tiles (partial, fill end, 3 Zipf, one "
            f"value, held, negative, ragged) bit-identical; the planted key is held by no planted row "
            f"and by {elsewhere} of the others")
        cpu_checks.append((f"{dtype}", start_cpu, fed, clone(state, ROWS_CPU, "cpu")))
        del state
    # a ragged tile from empty carries the planted key into rows that are
    # not full: keep-max keeps it there, as the reference's XLA rule does
    for dtype in (torch.int32, torch.int64):
        state, plant_key = planted(dtype)
        tile = wide_or_narrow(torch.randint(-(2**62), 2**62, (DR, 64), generator=gen, device=dev), dtype)
        tile.view(torch.int64 if dtype == torch.int64 else torch.int32)[:, 5] = plant_key
        valid = torch.randint(6, 65, (DR,), dtype=torch.int32, device=dev, generator=gen)
        ref = dplain.update(clone(state), tile, valid)
        state = dkern.update_cuda(state, tile, valid)
        torch.cuda.synchronize()
        keepmax_err = max(keepmax_err, max_abs_err(state, ref))
        if not same(state, ref):
            fail(f"distinct keep-max kernel != plain version on a ragged planted tile ({dtype})")
        held = held_keys(state)
        if not (held[plant_rows] == plant_key).any(1).all().item():
            fail(f"a row that is not full lost the planted key of hash (MAX, MAX) on a ragged tile ({dtype})")
        log(f"[12 distinct kernel vs plain] {dtype}: a ragged tile of 64 from empty (valid 6..64) through "
            f"keep-max, bit-identical; every planted row, none full, holds the planted key (the XLA rule)")
        del state, ref
    # beyond shared memory: the first k whose row block passes a block's
    # shared memory runs the instantiation that keeps it in global memory
    for dtype, k_big in ((torch.int32, 19371), (torch.int64, 14529)):
        wide = dtype == torch.int64
        if dkern.kernel_info(k_big, wide)["dynamic_smem"] != 0:
            fail(f"the distinct kernel at k {k_big} ({dtype}) reports a block in shared memory")
        state = dplain.init(key_from_seed(5), 8, k_big, sample_dtype=dtype, device=dev)
        for t in range(2):
            tile = wide_or_narrow(torch.randint(-(2**62), 2**62, (8, 12288), generator=gen, device=dev), dtype)
            ref = dplain.update(clone(state), tile)
            state = dkern.update_cuda(state, tile)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(state, ref))
            if not same(state, ref):
                fail(f"distinct kernel != plain version beyond shared memory ({dtype}, k {k_big}, tile {t})")
        if int(state.size.min().item()) != k_big:
            fail(f"a distinct reservoir at k {k_big} ({dtype}) holds fewer than k keys after 2 tiles")
        log(f"[12 distinct kernel vs plain] {dtype}, k {k_big} (beyond shared memory, R 8): 2 tiles "
            "(fill, evict) bit-identical")
        del state, ref

    # 13. card vs CPU (queued: run after the timed phases)
    for case, state_c, fed, want in cpu_checks:
        check_on_cpu(f"[13 distinct card vs CPU] {case}", want, cpu_replay, "reservoir_tpu_torch.ops.distinct",
                     state_c, [("update", args) for args in fed])
    del cpu_checks

    # 14. the distinct engine path, 4-byte and 8-byte keys: 10 full tiles
    # (the default kernel) and a tail of D_TAIL keys a row (valid given:
    # keep-max)
    rates = {}
    main_launches = keepmax_launches = 0
    for name, dtype in (("int32", torch.int32), ("int64", torch.int64)):
        gen.manual_seed(43)
        dev_tiles = [zipf_keys(gen, DR, DB, dtype, dev) for _ in range(8)]
        host_tiles = [zipf_keys(gen, DR, DB, dtype, dev).cpu().numpy() for _ in range(2)]
        tail = zipf_keys(gen, DR, DB, dtype, dev)
        torch.cuda.synchronize()
        kern.launches = 0
        wkern.launches = 0
        dkern.launches = dkern.keepmax_launches = dkern.prehashed_launches = 0
        engine = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=DK, num_reservoirs=DR, tile_size=DB,
                                                       distinct=True, element_dtype=name), key=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tile in dev_tiles:
            engine.sample(tile)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        for tile in host_tiles:
            engine.sample(tile)
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
        engine.sample(tail, valid=np.full(DR, D_TAIL, np.int32))
        salts = distinct_state_to_numpy(engine.state)["salts"]
        samples, sizes = engine.result_arrays()
        launches = dkern.launches
        if (launches != 10 or dkern.keepmax_launches != 1 or dkern.prehashed_launches or kern.launches
                or wkern.launches):
            fail(f"the distinct engine ({name}) launched distinct_update {launches} times, "
                 f"distinct_update_keepmax {dkern.keepmax_launches}, the pre-hashed kernel "
                 f"{dkern.prehashed_launches}, algl_update {kern.launches} and weighted_update "
                 f"{wkern.launches} times for 10 tiles and a tail")
        main_launches += launches
        keepmax_launches += dkern.keepmax_launches
        tiles = [t.cpu().numpy() for t in dev_tiles] + host_tiles + [tail[:, :D_TAIL].cpu().numpy()]
        ok, msg, share_sampled, share_all = distinct_oracle(tiles, salts, samples, sizes)
        if not ok:
            fail(f"distinct engine ({name}): {msg}")
        if abs(share_sampled - share_all) > 0.01:
            fail(f"distinct engine ({name}): the share of sampled keys seen >= 10 times, "
                 f"{share_sampled:.6f}, is not within 0.01 of their share of distinct keys, {share_all:.6f}")
        rates[name] = {"device_fed": 8 * DR * DB / t_dev, "host_fed": 2 * DR * DB / t_host}
        log(f"[14 distinct engine] {name}: 10 tiles and a tail of {D_TAIL}, launches {launches} and "
            f"{dkern.keepmax_launches} keep-max, every row equals the exact "
            f"oracle, sizes {int(sizes.min())}..{int(sizes.max())}; keys seen >= 10 times: "
            f"{share_sampled:.6f} of the sample, {share_all:.6f} of the distinct keys; "
            f"{rates[name]['device_fed']:.6e} elem/s fed from the device, "
            f"{rates[name]['host_fed']:.6e} elem/s fed from the host")
        del dev_tiles, host_tiles, tiles, engine, tail

    # 15. timings at the distinct path's shapes
    def timed(state, tile, wide=False) -> dict:
        ms = event_ms(lambda s: dkern.update_cuda(s, tile), setup=lambda: clone(state), batch=10)
        plain_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ref = dplain.update(state, tile)
            torch.cuda.synchronize()
            plain_times.append(1e3 * (time.perf_counter() - t0))
        inserts, rows_in = net_inserts(state, ref)
        bound, by = distinct_bound_ms(tile.shape[0] * tile.shape[1], wide, inserts, rows_in)
        return {"ms": ms, "plain_ms": statistics.median(plain_times), "bound_ms": bound, "bound_by": by,
                "net_inserts": inserts, "rows_inserting": rows_in}

    cases = distinct_timing_cases(gen, dev)
    timings = {label: timed(state, tile, wide) for label, state, tile, wide in cases}
    fill, steady, fresh, steady_wide, fill_wide = (timings[label] for label, *_ in cases)
    # keep-max on the steady Zipf tile: every lane given as valid (the
    # default's work, under the other rule) and a ragged valid count
    _, steady_state, steady_tile, _ = cases[1]
    keepmax = {}
    for label, valid in (("steady Zipf tile, valid B", torch.full((DR,), DB, dtype=torch.int32, device=dev)),
                         ("steady Zipf tile, ragged valid",
                          torch.randint(DB // 2, DB + 1, (DR,), dtype=torch.int32, device=dev, generator=gen))):
        ms = event_ms(lambda s, v=valid: dkern.update_cuda(s, steady_tile, v), setup=lambda: clone(steady_state),
                      batch=10)
        plain_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ref = dplain.update(steady_state, steady_tile, valid)
            torch.cuda.synchronize()
            plain_times.append(1e3 * (time.perf_counter() - t0))
        got = dkern.update_cuda(clone(steady_state), steady_tile, valid)
        keepmax_err = max(keepmax_err, max_abs_err(got, ref))
        if not same(got, ref):
            fail(f"distinct keep-max kernel != plain version on the {label}")
        inserts, rows_in = net_inserts(steady_state, ref)
        bound, by = distinct_bound_ms(int(valid.sum().item()), False, inserts, rows_in)
        keepmax[label] = {"ms": ms, "plain_ms": statistics.median(plain_times), "bound_ms": bound,
                          "bound_by": by, "net_inserts": inserts, "rows_inserting": rows_in,
                          "lanes": int(valid.sum().item())}
        del ref, got
    # context only: a sort of the [R, k + B] packed hashes, not the same function
    packed = torch.randint(-(2**62), 2**62, (DR, DK + DB), device=dev, generator=gen)
    sort_ms = event_ms(lambda _: torch.sort(packed, dim=1), batch=10)
    del cases, packed
    card = card_line()
    builds = {"int32": dkern.kernel_info(DK, False), "int64": dkern.kernel_info(DK, True)}
    for label, t in timings.items():
        log(f"[15 distinct timings] {card} | {label}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), net inserts {t['net_inserts']} over "
            f"{t['rows_inserting']} rows; build {build_text(builds['int64' if 'int64' in label else 'int32'])}")
    keepmax_build = {"int32": dkern.kernel_info(DK, False, rule=dkern.KEEPMAX),
                     "int64": dkern.kernel_info(DK, True, rule=dkern.KEEPMAX)}
    for label, t in keepmax.items():
        log(f"[15 distinct timings] {card} | keep-max, {label}: kernel {t['ms']:.4f} ms (the default on the "
            f"full tile {steady['ms']:.4f} ms), plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), {t['lanes']} lanes, net inserts {t['net_inserts']}; build "
            f"{build_text(keepmax_build['int32'])}")
    log(f"[15 distinct timings] {card} | context, not the same function: torch.sort of [{DR}, {DK + DB}] "
        f"int64 {sort_ms:.4f} ms")
    log(f"[15 distinct timings] {card} | engine: int32 {rates['int32']['device_fed']:.6e} / "
        f"{rates['int32']['host_fed']:.6e} elem/s, int64 {rates['int64']['device_fed']:.6e} / "
        f"{rates['int64']['host_fed']:.6e} elem/s (fed from the device / the host)")
    given = keepmax["steady Zipf tile, valid B"]
    keepmax_entry = {
        "name": "distinct_update_keepmax",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/distinct.cu",
        "replaces": "reservoir_tpu/ops/distinct_pallas.py:129",
        "replaces_note": "the keep-max instantiation of distinct_update; the reference runs a ragged or "
                         "mapped tile on XLA (reservoir_tpu/engine.py:386-387, reservoir_tpu/ops/distinct.py:214)",
        "launches": keepmax_launches,
        "max_abs_err": keepmax_err,
        "ms": given["ms"],
        "plain_ms": given["plain_ms"],
        "bound_ms": given["bound_ms"],
        "bound_by": given["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a deduplicating bottom-k merge",
        "default_ms_same_tile": steady["ms"],
        "ragged_tile": keepmax["steady Zipf tile, ragged valid"],
        "build": keepmax_build,
    }
    return {
        "name": "distinct_update",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/distinct.cu",
        "replaces": "reservoir_tpu/ops/distinct_pallas.py:129",
        "launches": main_launches,
        "max_abs_err": worst_err,
        "ms": steady["ms"],
        "plain_ms": steady["plain_ms"],
        "bound_ms": steady["bound_ms"],
        "bound_by": steady["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a deduplicating bottom-k merge",
        "sort_context_ms": sort_ms,
        "steady_zipf_tile": steady,
        "fill_tile": fill,
        "steady_fresh_tile": fresh,
        "steady_zipf_tile_int64": steady_wide,
        "fill_tile_int64": fill_wide,
        "build": builds,
        "engine_elem_per_s": rates,
    }, keepmax_entry


def word_blocks(gen, d: int, b: int, w: int, dtype, dev) -> list:
    """d ``[b, w]`` blocks of random 32-bit words of ``dtype``, with -0.0 and
    NaN payloads planted."""
    blocks = []
    for _ in range(d):
        t = torch.randint(-(2**31), 2**31 - 1, (b, w), dtype=torch.int32, device=dev, generator=gen)
        t[0, 0] = -(2**31)              # -0.0
        t[b // 2, w // 2] = 0x7FC00001  # quiet NaN with a payload
        t[-1, -1] = 0x7F800001          # signalling NaN
        blocks.append(t.view(dtype))
    return blocks


def words_err(got, want) -> float:
    """Largest difference between two nests of tensors, word for word as
    integers; 0 when bit-identical."""
    err = 0.0
    for g_rank, w_rank in zip(got, want):
        for g, w in zip(g_rank, w_rank):
            if g.shape != w.shape or g.dtype != w.dtype:
                return float("inf")
            err = max(err, float((bits(g).long() - bits(w).long()).abs().max().item()))
    return err


def gather_times(leaves, comm) -> dict:
    """The all-gather over ``comm`` of ``leaves``, timed four ways:
    ``launch_ms`` the bare launch (every argument but the stream made
    beforehand, into outputs allocated beforehand: the kernel's own time,
    10 launches back to back), ``call_ms`` the wrapper call
    (``gather_parts``: checks, outputs, arguments and the launch) 10 calls
    back to back, ``call_1_ms`` one wrapper call between the events (the
    host's work before the launch inside them), and ``host_ms`` the host's
    time a wrapper call (10 calls on the host's clock, no sync between)."""
    from reservoir_tpu_torch.ops import merge_cuda as mkern

    launch = mkern.launcher(leaves, mkern._outputs(leaves, comm), comm)
    out = {"launch_ms": event_ms(lambda _: launch(), batch=10),
           "call_ms": event_ms(lambda _: mkern.gather_parts(leaves, comm), batch=10),
           "call_1_ms": event_ms(lambda _: mkern.gather_parts(leaves, comm))}
    host = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            mkern.gather_parts(leaves, comm)
        host.append(1e3 * (time.perf_counter() - t0) / 10)
        torch.cuda.synchronize()
    out["host_ms"] = statistics.median(host)
    comm.check()
    return out


def wide_planes(x: np.ndarray, dev) -> torch.Tensor:
    """uint64 values as ``[..., 2]`` uint32 (lo, hi) planes on ``dev``."""
    from reservoir_tpu_torch.ops import u64e

    return u64e.to_u32(u64e.make(torch.from_numpy((x & np.uint64(0xFFFFFFFF)).astype(np.int64)),
                                 torch.from_numpy((x >> np.uint64(32)).astype(np.int64)))).to(dev)


def wide_merge_counts(rng) -> tuple:
    """Phase 38's WIDE counts past 2^32 as uint64 ``[R]`` arrays: A's in
    [2^32, 2^40), B's in [0, 2^40), the first rows at the edges (2^32 and
    2^63, give or take a little); ``rng`` is ``default_rng(38)``."""
    ca_h = rng.integers(2**32, 2**40, R).astype(np.uint64)
    cb_h = rng.integers(0, 2**40, R).astype(np.uint64)
    ca_h[:6] = [2**32 - 1, 2**32 + 1, 2**33 + 12345, 0, 2**63, 5]
    cb_h[:6] = [1, 2**32 - 3, 7, 0, 2**63 - 1, 2**31]
    return ca_h, cb_h


def merge_bound_ms(steps: int, draws: int, rows: int, k: int, row_bytes: int = 21, wide: bool = False) -> tuple:
    """The merge kernel's bound for ``rows`` rows of sample size ``k``
    whose scans ran ``steps`` steps and drew ``draws`` words in all (each
    rejected attempt counted): per step a fold and each word drawn one
    Threefry block; per row two folds and 2k key words; and per step the
    scan's remainders, three 32-bit ``%`` (``randint_exact``: 2^32 mod
    denom, then the draw mod denom) or, with WIDE counts, two 64-bit ``%``,
    each the SASS instructions :func:`remainder_ops` counted on its pipe.
    The operations' time is the busiest pipe's: the INT32 pipe (the blocks'
    and the remainders' integer ops), the IMAD pipe and the conversion and
    special-function unit (``PEAK_SFU``); bytes the counts, flags and keys
    read (17 a row), j_a and the keys written (4 + 8k a row):
    ``row_bytes`` + 8k a row (WIDE counts, 8 bytes each and no flags:
    28)."""
    blocks = steps + draws + 2 * rows * (k + 1)
    rem = REMAINDER_OPS.get("rem64" if wide else "rem32") or {}
    n_rem = (2 if wide else 3) * steps
    t_int = (THREEFRY_INT32_OPS * blocks + n_rem * rem.get("integer", 0)) / PEAK_INT32
    t_ops = max(t_int, n_rem * rem.get("fma", 0) / PEAK_IMAD, n_rem * rem.get("convert/special", 0) / PEAK_SFU)
    t_bytes = rows * (row_bytes + 8 * k) / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


#: a probe of one remainder a thread, 32- and 64-bit, beside kernels that
#: load and store the same words: the difference is the remainder's code
REMAINDER_PROBE = r"""
#include <cstdint>
extern "C" __global__ void probe_base32(const uint32_t* a, const uint32_t* b, uint32_t* o) {
  const int i = threadIdx.x; o[i] = a[i] ^ b[i]; }
extern "C" __global__ void probe_rem32(const uint32_t* a, const uint32_t* b, uint32_t* o) {
  const int i = threadIdx.x; o[i] = a[i] % b[i]; }
extern "C" __global__ void probe_base64(const uint64_t* a, const uint64_t* b, uint64_t* o) {
  const int i = threadIdx.x; o[i] = a[i] ^ b[i]; }
extern "C" __global__ void probe_rem64(const uint64_t* a, const uint64_t* b, uint64_t* o) {
  const int i = threadIdx.x; o[i] = a[i] % b[i]; }
"""
#: the SASS instructions of a 32-bit and a 64-bit ``%`` by pipe (set by
#: :func:`remainder_ops`; empty where ``cuobjdump`` is missing)
REMAINDER_OPS: dict = {}


def remainder_ops(work: str) -> dict:
    """The SASS instructions a 32-bit and a 64-bit unsigned ``%`` take on
    sm_90, by the pipe that issues them (``kernel_ab.PIPES``): the probe
    built with the port's nvcc flags, ``cuobjdump -sass`` of it, each
    remainder kernel less its load-and-store twin.  The 64-bit ``%`` tests
    whether both operands fit 32 bits and takes a 32-bit path when they
    do, which no remainder of the WIDE scan does (2^64 mod denom and a
    64-bit draw): its count leaves out a 32-bit ``%``'s instructions where
    it branches (inline, or through a subroutine, whose instructions are
    added), so that the count is no more than the path the scan runs.
    Returns ``{}`` where ``cuobjdump`` is missing."""
    import re

    from kernel_ab import PIPES
    from reservoir_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return {}
    os.makedirs(work, exist_ok=True)
    src, cubin = os.path.join(work, "rem_probe.cu"), os.path.join(work, "rem_probe.cubin")
    with open(src, "w") as fh:
        fh.write(REMAINDER_PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", cubin, src], check=True, capture_output=True,
                   timeout=300)
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(.*?);", ln)
        if name is not None and m:
            words = m.group(1).split()
            funcs[name].append((words[1] if words[0].startswith("@") else words[0]).split(".")[0])

    def by_pipe(ops) -> dict:
        counts = {pipe: 0 for pipe in PIPES} | {"other": 0}
        for op in ops:
            counts[next((p for p, names in PIPES.items() if op in names), "other")] += 1
        return counts

    def minus(a: dict, b: dict) -> dict:
        return {p: max(0, a[p] - b[p]) for p in a}

    pipes = {n: by_pipe(ops) for n, ops in funcs.items()}
    rem32 = minus(pipes["probe_rem32"], pipes["probe_base32"])
    callee = {p: sum(c[p] for n, c in pipes.items() if not n.startswith("probe_")) for p in rem32}
    rem64 = minus(pipes["probe_rem64"], pipes["probe_base64"])
    if rem64["control"] or any(callee.values()):
        rem64 = {p: v + callee[p] for p, v in minus(rem64, rem32).items()}
    return {"rem32": rem32, "rem64": rem64,
            "instructions": {"rem32": sum(rem32.values()), "rem64": sum(rem64.values())},
            "subroutine": any(callee.values())}


def merge_steps(count_a: torch.Tensor, count_b: torch.Tensor, k: int) -> int:
    """The scan steps of a merge: min(total mod 2^32, k) summed over rows."""
    total = (count_a.view(torch.int32).long() + count_b.view(torch.int32).long()) % 2**32
    return int(torch.clamp(total, max=k).sum().item())


def merge_case_counts(rng, rows: int, k: int) -> np.ndarray:
    """``[2, rows]`` uint32 counts, a case to a block of rows: both 0;
    partial (below k); one side empty; totals past 2^31; totals that wrap
    past 2^32 (an int32 view of these is negative); denominators just past
    2^31, where about every second attempt is rejected; and a mix of all."""
    cases = [
        lambda n: np.zeros((2, n)),
        lambda n: rng.integers(0, k, (2, n)),
        lambda n: np.stack([np.zeros(n), rng.integers(1, 4 * k, n)])[rng.permutation(2)],
        lambda n: rng.integers(2**30, 2**31, (2, n)),
        lambda n: rng.integers(2**31, 2**32, (2, n)),
        lambda n: (lambda a: np.stack([a, 2**31 + k + 1 + rng.integers(0, k + 1, n) - a]))(
            rng.integers(0, 2**31, n)),
    ]
    pool = np.array([0, 1, k - 1, k, k + 1, 3 * k, 2**31 - 1, 2**31 + 1, 2**32 - 1], np.int64)
    cases.append(lambda n: rng.choice(pool, (2, n)))
    per = -(-rows // len(cases))
    counts = np.concatenate([np.asarray(c(per), np.int64) for c in cases], axis=1)[:, :rows]
    return counts.astype(np.uint32)


def merge_timing_case(gen, dev) -> tuple:
    """Phase 19's uniform pair at the main path's shape, ``(samples_a,
    count_a, samples_b, count_b, row_keys)``: random int32 samples, int32
    counts below 4k (every row draws k times) and the rows' keys split from
    seed 1 (``kernel_ab.py`` times the same)."""
    from reservoir_tpu_torch.ops.rng import key_from_seed, split_keys

    gen.manual_seed(89)
    sa, sb = random_tile(gen, K, torch.int32, dev), random_tile(gen, K, torch.int32, dev)
    ca, cb = (torch.randint(0, 4 * K, (R,), dtype=torch.int32, device=dev, generator=gen) for _ in range(2))
    return sa, ca, sb, cb, split_keys(key_from_seed(1, device=dev), R)


def draws_err(got, want) -> float:
    """Largest difference between two ``MergeDraws``: j_a as integers, the
    keys as floats where both are finite, inf where a non-finite key's bits
    differ; 0 when bit-identical."""
    err = float((got.j_a.long() - want.j_a.long()).abs().max().item()) if got.j_a.numel() else 0.0
    for g, w in ((got.u_a, want.u_a), (got.u_b, want.u_b)):
        both = torch.isfinite(g) & torch.isfinite(w)
        if both.any():
            err = max(err, float((g[both].double() - w[both].double()).abs().max().item()))
        if not torch.equal(bits(g)[~both], bits(w)[~both]):
            err = float("inf")
    return err


def merge_phases(gen, dev) -> tuple:
    """Phases 16-19, the merge path; returns the ``kernels`` entries of the
    all-gather and of the merge kernel."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.convert import distinct_state_to_numpy, state_parts
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed
    from reservoir_tpu_torch.parallel import merge as pmerge
    from reservoir_tpu_torch.utils.stats import KS_GATE, ks_one_sample_uniform

    # 16. the all-gather kernel vs its plain version
    worst_err = 0.0

    def held(got, want, what: str) -> None:
        nonlocal worst_err
        err = words_err(got, want)
        worst_err = max(worst_err, err)
        if err != 0.0:
            fail(f"all-gather kernel != plain version ({what})")

    def gather_cases(ranks_of, where: str) -> None:
        gen.manual_seed(61)
        cases = 0
        for d in (2, 3, 4, 8):
            comm = mkern.RingCommunicator(ranks_of(d))
            before = mkern.launches
            calls = 0
            for b in (1, 5, 64, 4096):
                for w in (1, 8, 129):
                    for dtype in (torch.int32, torch.uint32, torch.float32):
                        for _ in range(2):  # back to back on one communicator
                            blocks = [blk.to(rank) for blk, rank in
                                      zip(word_blocks(gen, d, b, w, dtype, dev), comm.ranks)]
                            got = mkern.ring_all_gather(blocks, comm)
                            want = mkern.ring_all_gather_plain(blocks, comm)
                            if any(g.shape != (d, b, w) for g in got):
                                fail(f"ring_all_gather gave a wrong shape (d {d}, b {b}, W {w})")
                            held([got], [want], f"{where}, d {d}, b {b}, W {w}, {dtype}")
                            calls += 1
            # mixed leaves of one part state: float rows, int counts, uint salts
            rank_leaves = [
                (word_blocks(gen, 1, 7, 5, torch.float32, dev)[0].to(rank),
                 torch.randint(0, 99, (7,), dtype=torch.int32, device=dev, generator=gen).to(rank),
                 word_blocks(gen, 1, 7, 4, torch.uint32, dev)[0].to(rank))
                for rank in comm.ranks
            ]
            held(mkern.gather_parts(rank_leaves, comm), mkern.gather_parts_plain(rank_leaves, comm),
                 f"{where}, gather_parts, d {d}")
            calls += 1
            torch.cuda.synchronize()
            comm.check()
            per_call = len({r.index for r in comm.ranks})
            if mkern.launches - before != calls * per_call:
                fail(f"{calls} all-gathers over {per_call} cards counted {mkern.launches - before} launches")
            cases += calls
        log(f"[16 all-gather vs plain] {where}: d 2/3/4/8 x b 1/5/64/4096 x W 1/8/129 x int32/uint32/"
            f"float32, twice each on one communicator, and gather_parts on mixed leaves: {cases} calls, "
            "every rank's copy bit-identical")

    gather_cases(lambda d: [dev] * d, "ranks on one card")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        gather_cases(lambda d: [torch.device("cuda", i % n_cards) for i in range(d)],
                     f"ranks over {n_cards} cards")
    else:
        log("[16 all-gather vs plain] this machine has one card: every rank above is on it; the "
            "path with ranks on distinct cards (peer access over NVLink) was not run")
    # the main path's shape: 4 ranks of uniform state
    D = 4
    gen.manual_seed(67)
    full_leaves = [(random_tile(gen, K, torch.int32, dev),
                    torch.randint(0, 2**31 - 1, (R,), dtype=torch.int32, device=dev, generator=gen))
                   for _ in range(D)]
    full_comm = mkern.RingCommunicator([dev] * D)
    held(mkern.gather_parts(full_leaves, full_comm), mkern.gather_parts_plain(full_leaves, full_comm),
         "the main path's shape")
    full_comm.check()
    log(f"[16 all-gather vs plain] gather_parts at the main path's shape ({D} ranks of [{R}, {K}] "
        f"samples and [{R}] counts): every rank's copy bit-identical")

    # 17. the merge tree on the card == the same on the CPU
    k17 = 16
    rng = np.random.default_rng(71)
    for n_parts in (2, 3, 5, 8):
        uniform_parts = []
        for p in range(n_parts):
            n = int(rng.integers(1, k17)) if p % 2 else int(rng.integers(k17, 4 * k17))
            uniform_parts.append((rng.integers(0, 1 << 30, min(n, k17)).astype(np.int32), n))
        by_mode = {"uniform": uniform_parts}
        for mode in ("weighted", "distinct"):
            cfg = rtt.SamplerConfig(max_sample_size=k17, num_reservoirs=n_parts, tile_size=64,
                                    weighted=mode == "weighted", distinct=mode == "distinct")
            eng = rtt.ReservoirEngine(cfg, key=2, device="cpu")
            tile = rng.integers(0, 60, (n_parts, 64)).astype(np.int32)
            valid = rng.integers(1, 65, n_parts).astype(np.int32)  # some rows stay short of k
            if mode == "weighted":
                eng.sample(tile, valid, weights=rng.uniform(0.0, 2.0, (n_parts, 64)).astype(np.float32))
            else:
                eng.sample(tile, valid)
            parts = state_parts(eng.state)
            if mode == "distinct":  # shards of one logical stream share salts
                parts = [part[:5] + (parts[0][5],) for part in parts]
            by_mode[mode] = parts
        for mode, parts in by_mode.items():
            want = pmerge.merge_samples_device(parts, 9, max_sample_size=k17, mode=mode, impl="host")
            got = pmerge.merge_samples_device(parts, 9, max_sample_size=k17, mode=mode, impl="cuda",
                                              devices=[dev] * 4)
            for g, w in zip(got, want):
                # arrays word for word (NaN-safe), totals and sizes as ints
                g, w = np.atleast_1d(g), np.atleast_1d(w)
                if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
                    fail(f"merge tree on the card != on the CPU ({mode}, {n_parts} parts)")
    log("[17 merge tree card vs CPU] merge_samples_device, uniform/weighted/distinct x 2/3/5/8 parts "
        "with partial fills: 4 ranks on the card equal the host tree")
    shards, rows17 = 5, 256
    gen.manual_seed(73)
    u_s = [torch.randint(0, 2**31 - 1, (rows17, k17), dtype=torch.int32, device=dev, generator=gen)
           for _ in range(shards)]
    u_c = [torch.randint(0, 3 * k17, (rows17,), dtype=torch.int32, device=dev, generator=gen)
           for _ in range(shards)]
    w_states, d_states = [], []
    for s in range(shards):
        elems = torch.randint(0, 200, (rows17, 64), dtype=torch.int32, device=dev, generator=gen)
        weights = torch.rand((rows17, 64), device=dev, generator=gen)
        valid = torch.randint(1, 65, (rows17,), dtype=torch.int32, device=dev, generator=gen)
        w_states.append(wkern.update_cuda(wplain.init(key_from_seed(s), rows17, k17, device=dev),
                                          elems, weights, valid))
        d_states.append(dkern.update_cuda(dplain.init(key_from_seed(0), rows17, k17, device=dev),
                                          elems, valid))

    def on_cpu(leaves):
        return [[t.cpu() for t in leaf] for leaf in leaves]

    w_leaves = [[st.samples for st in w_states], [st.lkeys for st in w_states],
                [st.count for st in w_states]]
    d_leaves = [[getattr(st, f) for st in d_states]
                for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts")]
    for mode, fn, leaves in (
        ("uniform", lambda lv: pmerge.uniform_stream_merger(lv[0], lv[1], 11), [u_s, u_c]),
        ("weighted", lambda lv: pmerge.weighted_stream_merger(*lv), w_leaves),
        ("distinct", lambda lv: pmerge.distinct_stream_merger(*lv), d_leaves),
    ):
        got = fn(leaves)
        want = fn(on_cpu(leaves))
        if words_err([[g.cpu() for g in got]], [want]) != 0.0:
            fail(f"{mode}_stream_merger on the card != on the CPU ({shards} shards of {rows17} rows)")
    log(f"[17 merge tree card vs CPU] the three stream mergers over {shards} shards of {rows17} rows: "
        "the card's rows equal the CPU's")
    del u_s, u_c, w_states, d_states, w_leaves, d_leaves

    # 17. the merge kernel against its plain version
    merge_err = 0.0
    rng17 = np.random.default_rng(17)
    cases17 = 0
    for k in MERGE_KS:
        # both sign cases at each k but the largest, whose plain version
        # runs k lockstep steps of host-launched tensor code (~10 ms each)
        combos = ((torch.uint32, torch.int32), (torch.int32, torch.uint32))
        for dtypes in combos[:1] if k == max(MERGE_KS) else combos:
            counts = torch.from_numpy(merge_case_counts(rng17, MERGE_ROWS, k).view(np.int32)).to(dev)
            ca, cb = (counts[i].contiguous().view(dt) for i, dt in enumerate(dtypes))
            keys = torch.randint(0, 2**32, (MERGE_ROWS, 2), dtype=torch.int64, device=dev, generator=gen)
            want = plain.merge_draws(ca, cb, keys, k)
            before = kern.merge_launches
            got = kern.merge_draws_cuda(ca, cb, keys, k)
            torch.cuda.synchronize()
            if kern.merge_launches - before != 1:
                fail(f"merge_draws_cuda counted {kern.merge_launches - before} launches for one call")
            merge_err = max(merge_err, draws_err(got, want))
            if merge_err != 0.0:
                fail(f"merge kernel != plain version (k {k}, counts {dtypes}): j_a, u_a or u_b differ")
            for dtype in (torch.int32, torch.uint32, torch.float32):
                sa, sb = word_blocks(gen, 2, MERGE_ROWS, k, dtype, dev)
                want_s, want_c = plain.merge_from_draws(sa, ca, sb, cb, want)
                before = kern.merge_launches
                got_s, got_c = plain.merge_samples_keyed(sa, ca, sb, cb, keys)
                if kern.merge_launches - before != 1:
                    fail(f"merge_samples_keyed launched the merge kernel {kern.merge_launches - before} "
                         "times for one merge")
                err = words_err([[got_s, got_c]], [[want_s, want_c]])
                merge_err = max(merge_err, err)
                if err != 0.0:
                    fail(f"the merge through the kernel != the plain merge (k {k}, counts {dtypes}, {dtype})")
                cases17 += 1
    # no host sync on the kernel's path
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plain.merge_samples_keyed(sa, ca, sb, cb, keys)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[17 merge kernel vs plain] k 1/5/128/1000 x {MERGE_ROWS} rows (counts 0, partial, one side empty, "
        "totals past 2^31, totals wrapping past 2^32, denominators just past 2^31) x uint32/int32 counts "
        "(at k 1000 A's uint32 and B's int32 only): "
        "j_a, u_a, u_b bit-identical, one launch a call; merged samples and counts bit-identical for "
        f"int32/uint32/float32 words (NaN payloads, -0.0): {cases17} merges; merge_samples_keyed made no "
        "host sync (sync debug mode 'error')")
    # at the main path's shape: against the plain version on the card, timed
    # once (host-launched, about a second), and rows 0..ROWS_CPU-1 on the CPU
    sa, ca, sb, cb, keys = merge_timing_case(gen, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    j_a, n_draws = plain.merge_scan(ca, cb, keys, K)
    plain_draws = plain.MergeDraws(j_a, *plain.merge_keys(ca, cb, keys, K))
    torch.cuda.synchronize()
    merge_plain_ms = 1e3 * (time.perf_counter() - t0)
    got = kern.merge_draws_cuda(ca, cb, keys, K)
    merge_err = max(merge_err, draws_err(got, plain_draws))
    got_s, got_c = plain.merge_samples_keyed(sa, ca, sb, cb, keys)
    want_s, want_c = plain.merge_from_draws(sa, ca, sb, cb, plain_draws)
    merge_err = max(merge_err, words_err([[got_s, got_c]], [[want_s, want_c]]))
    if merge_err != 0.0:
        fail(f"merge kernel != plain version at [{R}, {K}]")
    cpu = plain.merge_samples_keyed(*(t[:ROWS_CPU].cpu() for t in (sa, ca, sb, cb, keys)))
    if words_err([cpu], [[got_s[:ROWS_CPU].cpu(), got_c[:ROWS_CPU].cpu()]]) != 0.0:
        fail(f"the plain merge on the CPU != the card's rows 0..{ROWS_CPU - 1}")
    u = torch.sort(plain_draws.u_a, dim=1).values
    tied = int(((u[:, 1:] == u[:, :-1]) & torch.isfinite(u[:, 1:])).any(dim=1).sum().item())
    merge_steps_full = merge_steps(ca, cb, K)
    log(f"[17 merge kernel vs plain] [{R}, {K}]: j_a, keys, merged samples and counts bit-identical to the "
        f"plain version on the card ({merge_steps_full} scan steps, {n_draws} words drawn, {tied} rows with "
        f"tied keys in A), rows 0..{ROWS_CPU - 1} to the plain version on the CPU")
    merge_case = (sa, ca, sb, cb, keys, plain_draws, n_draws, merge_steps_full)
    del got, got_s, got_c, want_s, want_c, cpu, u

    # 18. the merge path at full width
    def hold_path_gather(stacked, what: str) -> None:
        """The all-gather as a merger launches it, on the shards' own leaves
        (``stacked[i][r]`` is leaf i of rank r): every rank's copy of the
        kernel's result against the plain version's, bit for bit.  This
        comparison's launch is not the path's: the count is put back."""
        counted = mkern.launches
        rank_leaves = [tuple(leaf[r].contiguous() for leaf in stacked) for r in range(len(stacked[0]))]
        comm = mkern.RingCommunicator([dev] * len(rank_leaves))
        got = mkern.gather_parts(rank_leaves, comm)
        comm.check()
        if mkern.launches != counted + 1:
            fail(f"gather_parts counted {mkern.launches - counted} launches for one call ({what})")
        held(got, mkern.gather_parts_plain(rank_leaves, comm), what)
        mkern.launches = counted

    for mod in (kern, wkern, dkern, mkern):
        mod.launches = 0
    kern.merge_launches = dkern.keepmax_launches = dkern.prehashed_launches = 0
    # uniform: four shards of unequal streams; an element is its position in
    # the union stream of its row
    lengths = [1000, 2 * B, 3 * B, 4 * B]
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    N = int(offsets[-1])
    cols = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    zero_rows = torch.zeros((R, 1), dtype=torch.int32, device=dev)
    engines = []
    t0 = time.perf_counter()
    for s, length in enumerate(lengths):
        eng = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B),
                                  key=100 + s, reusable=True)
        for start in range(0, length, B):
            width = min(B, length - start)
            tile = (zero_rows + int(offsets[s]) + start + cols).contiguous()
            eng.sample(tile, None if width == B else np.full((R,), width, np.int32))
        engines.append(eng)
    states = [eng.state for eng in engines]
    torch.cuda.synchronize()
    t_feed = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_samples, m_count = pmerge.uniform_stream_merger(
        [st.samples for st in states], [st.count for st in states], 5)
    torch.cuda.synchronize()
    t_merge_uniform = time.perf_counter() - t0
    tiles_fed = sum(-(-length // B) for length in lengths)
    if kern.launches != tiles_fed or mkern.launches != 1:
        fail(f"the uniform merge path launched algl_update {kern.launches} times for {tiles_fed} tiles "
             f"and merge_ring_gather {mkern.launches} times for one merge")
    merge_path_launches = kern.merge_launches
    if merge_path_launches != 2:
        fail(f"the uniform merger over 4 shards launched algl_merge_draws {merge_path_launches} times, "
             "not once a tree level (2)")
    pos = m_samples.cpu().numpy()
    count = m_count.cpu().numpy()
    if count.dtype != np.uint32 or not (count == N).all():
        fail(f"a merged count is not the union stream's length {N}")
    if pos.min() < 0 or pos.max() >= N:
        fail("a merged sample lies outside the union stream")
    srt = np.sort(pos, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        fail("a merged row holds one position twice")
    ks = ks_one_sample_uniform(pos.ravel(), N)
    if not ks < KS_GATE:
        fail(f"KS distance {ks} of the merged positions is not below {KS_GATE}")
    shares = []
    for s, length in enumerate(lengths):
        share = float(((pos >= offsets[s]) & (pos < offsets[s + 1])).mean())
        p = length / N
        sigma = (p * (1 - p) / pos.size) ** 0.5
        if abs(share - p) > 5 * sigma:
            fail(f"shard {s} holds {share:.6f} of the merged samples, its stream share is {p:.6f} "
                 f"(5 sigma = {5 * sigma:.6f})")
        shares.append(f"{share:.6f} of {p:.6f}")
    log(f"[18 merge path] uniform: 4 shards of {lengths} elements a row, {kern.launches} tile launches, "
        f"{mkern.launches} gather launch and {merge_path_launches} merge kernel launches (one a tree level); "
        f"every merged size {K}, every count {N}, KS {ks:.6f} < {KS_GATE}, "
        f"shard shares {', '.join(shares)} (each within 5 sigma); fed in {t_feed:.3f} s, merged in "
        f"{t_merge_uniform:.3f} s")
    uniform_launches = mkern.launches
    hold_path_gather([[st.samples for st in states], [st.count for st in states]],
                     "the uniform merger's shards")
    del engines, states, m_samples, m_count, pos, srt

    # distinct: four shards with shared salts == one engine over the whole stream
    gen.manual_seed(79)
    tiles = [zipf_keys(gen, DR, DB, torch.int32, dev) for _ in range(10)]
    dcfg = rtt.SamplerConfig(max_sample_size=DK, num_reservoirs=DR, tile_size=DB, distinct=True,
                             element_dtype="int32")
    whole = rtt.ReservoirEngine(dcfg, key=0, reusable=True)
    for tile in tiles:
        whole.sample(tile)
    shard_states = []
    nxt = 0
    for n_tiles in (1, 2, 3, 4):
        eng = rtt.ReservoirEngine(dcfg, key=0, reusable=True)
        for tile in tiles[nxt:nxt + n_tiles]:
            eng.sample(tile)
        nxt += n_tiles
        shard_states.append(eng.state)
    d_stacked = [[getattr(st, f) for st in shard_states]
                 for f in ("values", "hash_hi", "hash_lo", "size", "count", "salts")]
    t0 = time.perf_counter()
    merged = pmerge.distinct_stream_merger(*d_stacked)
    torch.cuda.synchronize()
    t_merge_distinct = time.perf_counter() - t0
    if (dkern.launches != 20 or dkern.keepmax_launches or dkern.prehashed_launches
            or mkern.launches != uniform_launches + 1 or kern.merge_launches != 2):
        fail(f"the distinct merge path launched distinct_update {dkern.launches} times for 20 tiles and "
             f"merge_ring_gather {mkern.launches - uniform_launches} times for one merge")
    hold_path_gather(d_stacked, "the distinct merger's shards")
    want = whole.state
    for name, got in zip(("values", "hash_hi", "hash_lo", "size", "count"), merged):
        if not torch.equal(bits(got), bits(getattr(want, name))):
            fail(f"the merge of four distinct shards differs from one engine over the stream in {name}")
    salts = distinct_state_to_numpy(want)["salts"]
    # the oracle over rows 0..ROWS_CPU-1 (phase 14 holds the engine to it on
    # every row, and every merged row equals that engine's above)
    ok, msg, _, _ = distinct_oracle([t[:ROWS_CPU].cpu().numpy() for t in tiles], salts[:ROWS_CPU],
                                    merged[0][:ROWS_CPU].cpu().numpy(), merged[3][:ROWS_CPU].cpu().numpy())
    if not ok:
        fail(f"merged distinct shards: {msg}")
    log(f"[18 merge path] distinct: 4 shards of 1/2/3/4 Zipf tiles with shared salts, merged in "
        f"{t_merge_distinct:.3f} s: equal entry for entry to one engine over all 10 tiles, and on rows "
        f"0..{ROWS_CPU - 1} to the exact oracle; sizes {int(merged[3].min())}..{int(merged[3].max())}")
    del tiles, whole, shard_states, d_stacked, merged, want

    # weighted: element = position in the union stream, weight = position % 3
    wlengths = [WB, 2 * WB, 3 * WB, 4 * WB]
    woffsets = np.concatenate([[0], np.cumsum(wlengths)])
    wcols = torch.arange(WB, dtype=torch.int32, device=dev)[None, :]
    wzero = torch.zeros((WR, 1), dtype=torch.int32, device=dev)
    w_states = []
    for s, length in enumerate(wlengths):
        eng = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=WK, num_reservoirs=WR, tile_size=WB,
                                                    weighted=True), key=200 + s, reusable=True)
        for start in range(0, length, WB):
            tile = (wzero + int(woffsets[s]) + start + wcols).contiguous()
            eng.sample(tile, weights=(tile % 3).float())
        w_states.append(eng.state)
    w_stacked = [[st.samples for st in w_states], [st.lkeys for st in w_states],
                 [st.count for st in w_states]]
    t0 = time.perf_counter()
    w_samples, w_lkeys, w_count = pmerge.weighted_stream_merger(*w_stacked)
    torch.cuda.synchronize()
    t_merge_weighted = time.perf_counter() - t0
    if wkern.launches != 10 or mkern.launches != uniform_launches + 2:
        fail(f"the weighted merge path launched weighted_update {wkern.launches} times for 10 tiles and "
             f"merge_ring_gather {mkern.launches - uniform_launches - 1} times for one merge")
    main_launches = mkern.launches
    hold_path_gather(w_stacked, "the weighted merger's shards")
    wpos = w_samples.cpu().numpy()
    if not bool((w_lkeys > float("-inf")).all().item()) or not bool((w_count == int(woffsets[-1])).all().item()):
        fail("a merged weighted reservoir is not full, or its count is not the union stream's length")
    if (wpos % 3 == 0).any():
        fail(f"{int((wpos % 3 == 0).sum())} zero-weight elements are in the merged weighted sample")
    share2 = float((wpos % 3 == 2).mean())
    if abs(share2 - 2.0 / 3.0) > 0.005:
        fail(f"merged weight-2 share {share2:.6f} is not within 0.005 of 2/3")
    log(f"[18 merge path] weighted: 4 shards of 1/2/3/4 tiles, merged in {t_merge_weighted:.3f} s: every "
        f"reservoir full, no zero-weight sample, weight-2 share {share2:.6f} (2/3 +- 0.005); "
        f"{main_launches} gather launches for the three mergers")
    log(f"[18 merge path] the all-gather at each merger's launch shape, on its four shards' own leaves "
        f"(uniform [{R}, {K}] + [{R}]; distinct 3 x [{DR}, {DK}] + 2 x [{DR}] + [{DR}, 4]; weighted "
        f"2 x [{WR}, {WK}] + [{WR}]): every rank's copy bit-identical to the plain version's")
    del w_states, w_stacked, w_samples, w_lkeys, w_count

    # 19. timings at the uniform merge's shape
    def gather_bound_ms(d: int, words: int) -> float:
        """Every input word read once, every output word written once."""
        return 1e3 * (d + d * d) * words * 4 / PEAK_BYTES

    words = R * K + R
    gather_t = gather_times(full_leaves, full_comm)
    gather_ms = gather_t["call_ms"]
    gather_build = mkern.kernel_info()
    plain_ms = event_ms(lambda _: mkern.gather_parts_plain(full_leaves, full_comm), batch=10)
    packed = [torch.cat([s, c[:, None]], 1) for s, c in full_leaves]
    library_ms = event_ms(lambda _: [torch.stack(packed) for _ in range(D)], batch=10)
    bound = gather_bound_ms(D, words)
    del packed

    def host_ms(fn, runs: int = 3) -> float:
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    # the uniform pair: the merge kernel's draws, the torch sort and gather
    # that follow them, and the whole pairwise merge
    sa, ca, sb, cb, keys, plain_draws, n_draws, steps = merge_case
    merge_ms = event_ms(lambda _: kern.merge_draws_cuda(ca, cb, keys, K), batch=10)
    sort_gather_ms = event_ms(lambda _: plain.merge_from_draws(sa, ca, sb, cb, plain_draws), batch=10)
    merge_bound, merge_by = merge_bound_ms(steps, n_draws, R, K)
    pair_uniform_ms = host_ms(lambda: plain.merge_samples(sa, ca, sb, cb, key_from_seed(1, device=dev)))
    del merge_case, plain_draws
    lk = [-torch.rand((WR, WK), device=dev, generator=gen) for _ in range(2)]
    ws = [torch.randint(0, 2**31 - 1, (WR, WK), dtype=torch.int32, device=dev, generator=gen) for _ in range(2)]
    wc = torch.full((WR,), 4 * WK, dtype=torch.int32, device=dev)
    pair_weighted_ms = host_ms(lambda: wplain.merge_parts(ws[0], lk[0], wc, ws[1], lk[1], wc))
    dstates = []
    for _ in range(2):
        st = dplain.init(key_from_seed(0), DR, DK, device=dev)
        dstates.append(dkern.update_cuda(st, zipf_keys(gen, DR, DB, torch.int32, dev)))
    pair_distinct_ms = host_ms(lambda: dplain.merge(dstates[0], dstates[1]))
    del full_leaves, lk, ws, dstates
    card = card_line()
    log(f"[19 merge timings] {card} | all-gather of {D} ranks x ([{R}, {K}] + [{R}]) words "
        f"({4 * words / 1e6:.1f} MB a rank in, {4 * D * words / 1e6:.1f} MB a rank out): kernel "
        f"{gather_ms:.4f} ms (gather_parts, 10 calls back to back; the bare launch {gather_t['launch_ms']:.4f} ms, "
        f"one call between the events {gather_t['call_1_ms']:.4f} ms, the host {gather_t['host_ms']:.4f} ms a "
        f"call), plain {plain_ms:.4f} ms, torch.stack of the packed blocks once a rank "
        f"{library_ms:.4f} ms, bound {bound:.4f} ms (bytes); build {build_text(gather_build)}")
    merge_build = kern.merge_kernel_info()
    log(f"[19 merge timings] {card} | merge kernel (algl_merge_draws) at [{R}, {K}] ({steps} scan steps, "
        f"{n_draws} words drawn): {merge_ms:.4f} ms, plain {merge_plain_ms:.1f} ms, bound {merge_bound:.4f} ms "
        f"({merge_by}); the torch argsort and gather after it {sort_gather_ms:.4f} ms; build "
        f"{build_text(merge_build)}")
    log(f"[19 merge timings] {card} | one batched pairwise merge: uniform [{R}, {K}] {pair_uniform_ms:.2f} ms, "
        f"weighted [{WR}, {WK}] {pair_weighted_ms:.2f} ms, distinct [{DR}, {DK}] {pair_distinct_ms:.2f} ms; "
        f"whole mergers over 4 shards: uniform {1e3 * t_merge_uniform:.1f} ms, distinct "
        f"{1e3 * t_merge_distinct:.1f} ms, weighted {1e3 * t_merge_weighted:.1f} ms (first calls)")
    stream_ms = {"uniform": 1e3 * t_merge_uniform, "distinct": 1e3 * t_merge_distinct,
                 "weighted": 1e3 * t_merge_weighted}
    pair_ms = {"uniform": pair_uniform_ms, "weighted": pair_weighted_ms, "distinct": pair_distinct_ms}
    merge_entry = {
        "name": "algl_merge_draws",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/algl_merge.cu",
        "replaces": "reservoir_tpu/ops/algorithm_l.py:567",
        "replaces_note": "no TPU kernel: the reference's merge scan (lax.scan) and _masked_perm's "
                         "uniforms (:718) are XLA",
        "launches": merge_path_launches,
        "max_abs_err": merge_err,
        "ms": merge_ms,
        "plain_ms": merge_plain_ms,
        "bound_ms": merge_bound,
        "bound_by": merge_by,
        "library_ms": None,
        "sort_gather_ms": sort_gather_ms,
        "scan_steps": steps,
        "words_drawn": n_draws,
        "cases": cases17,
        "pairwise_merge_ms": pair_uniform_ms,
        "stream_merger_ms": 1e3 * t_merge_uniform,
        "build": merge_build,
    }
    return {
        "name": "merge_ring_gather",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/merge_ring.cu",
        "replaces": "reservoir_tpu/ops/merge_pallas.py:59",
        "launches": main_launches,
        "max_abs_err": worst_err,
        "ms": gather_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "library_note": f"torch.stack of the {D} packed [{R}, {K + 1}] blocks, once a rank, on one card",
        "ms_note": "gather_parts, 10 calls back to back",
        **{k: v for k, v in gather_t.items() if k != "call_ms"},
        "build": gather_build,
        "cards": n_cards,
        "pairwise_merge_ms": pair_ms,
        "stream_merger_ms": stream_ms,
    }, merge_entry


def flush_plan(streams: torch.Tensor, rank: torch.Tensor, rows: int, width: int) -> list:
    """Where the bridge must flush a feed of pair ``streams`` whose ranks in
    their rows are ``rank``: the staging takes pairs in order and stops at
    the first whose row already holds ``width`` since the last flush.
    Returns each flush's per-row base (elements of the row flushed before
    it); the last flush is the remainder, at ``flush()``."""
    bases = [torch.zeros(rows, dtype=torch.int64, device=streams.device)]
    start = 0
    while True:
        base = bases[-1]
        full = (rank[start:] - base[streams[start:].long()]) >= width
        if not bool(full.any()):
            return bases
        stop = start + int(torch.argmax(full.to(torch.uint8)))
        bases.append(base + torch.bincount(streams[start:stop], minlength=rows))
        start = stop


def copies_overlapping_demux(trace_path: str) -> list:
    """From a ``torch.profiler`` Chrome trace: for each tile copy to the
    card (1 ms or more), in order, the share of its time during a demux
    range; empty when the trace holds no device copies."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = lambda keep: [(e["ts"], e["ts"] + e["dur"]) for e in events  # noqa: E731
                          if e.get("ph") == "X" and "dur" in e and keep(e)]
    copies = spans(lambda e: e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")
                   and e["dur"] >= 1000)
    demux = spans(lambda e: e.get("name") == "reservoir_bridge_demux" and e.get("cat") != "gpu_user_annotation")
    return [sum(max(0.0, min(b, d1) - max(a, d0)) for d0, d1 in demux) / (b - a)
            for a, b in sorted(copies)]


def bridge_phases(gen, dev, here: str, engine_eps: dict) -> dict:
    """Phases 20-23, the stream bridge; returns the ``bridge`` line."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch import native
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.stream.bridge import _FlushJournal
    from reservoir_tpu_torch.utils.tracing import profile_capture

    work = os.path.join(here, "build", "chip_smoke")  # gitignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # 20. the host staging library
    t0 = time.perf_counter()
    staging = native.NativeStaging(R, B, np.int32)
    if not staging.available():
        fail("the native staging library is not in use")
    threads = staging.threads()
    del staging
    log(f"[20 bridge build] g++ staging library built and loaded in {time.perf_counter() - t0:.2f} s; "
        f"os.cpu_count() {os.cpu_count()}, demux threads {threads}")

    # 21. the bridge at full width: random pairs, pipelined and serial
    cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B)
    N = 3 * R * B
    gen.manual_seed(31)
    streams_d = torch.randint(0, R, (N,), generator=gen, device=dev, dtype=torch.int32)
    elems_d = torch.randint(-(2**31), 2**31 - 1, (N,), generator=gen, device=dev, dtype=torch.int32)
    streams_h = streams_d.cpu().numpy()
    elems_h = elems_d.cpu().numpy()
    # each row's own stream, in order: [R, L] with the row counts
    order = torch.sort(streams_d, stable=True).indices
    sorted_s = streams_d[order].long()
    counts = torch.bincount(streams_d, minlength=R)
    rank_sorted = torch.arange(N, device=dev) - (torch.cumsum(counts, 0) - counts)[sorted_s]
    L = int(counts.max())
    rows_m = torch.zeros((R, L), dtype=torch.int32, device=dev)
    rows_m[sorted_s, rank_sorted] = elems_d[order]
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    del order, sorted_s, rank_sorted, elems_d
    bases = flush_plan(streams_d, rank, R, B)
    del rank, streams_d
    states = {}
    for pipelined in (True, False):
        bridge = rtt.DeviceStreamBridge(cfg, key=0, pipelined=pipelined)
        torch.cuda.synchronize()
        kern.launches = 0
        bridge.push_interleaved(streams_h, elems_h)
        bridge.flush()
        bridge.drain_barrier()
        launches = kern.launches
        if pipelined:
            bridge_launches = launches
        if bridge.metrics.flushes != len(bases) or launches != len(bases):
            fail(f"the bridge (pipelined {pipelined}) made {bridge.metrics.flushes} flushes and "
                 f"{launches} launches where the staging contract puts {len(bases)}")
        if bridge.metrics.flushed_elements != N:
            fail(f"the bridge flushed {bridge.metrics.flushed_elements} of {N} elements")
        states[pipelined] = clone(bridge.engine._state)
        del bridge
        gc.collect()
    if not same(states[True], states[False]):
        fail("the pipelined bridge's state != the serial bridge's")
    engine = rtt.ReservoirEngine(cfg, key=0)
    start_cpu = clone(engine._state, ROWS_CPU, "cpu")
    s0 = clone(engine._state)
    W2 = 1536
    for c0 in range(0, L, W2):
        width = min(W2, L - c0)
        valid = torch.clamp(counts - c0, 0, width).to(torch.int32)
        engine.sample(rows_m[:, c0 : c0 + width].contiguous(), valid=valid.cpu().numpy())
    torch.cuda.synchronize()
    if not same(engine._state, states[True]):
        fail(f"the bridge's state != the card engine fed the same row streams in tiles of {W2}")
    del engine
    st = start_cpu
    rows_cpu, counts_cpu = rows_m[:ROWS_CPU].cpu(), counts[:ROWS_CPU].cpu()
    for c0 in range(0, L, B):
        width = min(B, L - c0)
        st = plain.update(st, rows_cpu[:, c0 : c0 + width].contiguous(),
                          torch.clamp(counts_cpu - c0, 0, width).to(torch.int32))
    if not same(st, clone(states[True], ROWS_CPU, "cpu")):
        fail(f"the bridge's rows 0..{ROWS_CPU - 1} != the plain version on the CPU")
    log(f"[21 bridge vs engine] {N} random pairs, R {R}, k {K}, B {B}: {len(bases)} ragged flushes "
        f"where the staging contract puts them, {bridge_launches} launches; pipelined == serial == "
        f"card engine in tiles of {W2} == plain version on rows 0..{ROWS_CPU - 1}, bit for bit")

    # algl_update on the second flush's ragged tile, and on the same tile full
    def flush_tile(j):
        hi = bases[j + 1] if j + 1 < len(bases) else counts
        idx = torch.clamp(bases[j][:, None] + torch.arange(B, device=dev)[None, :], max=L - 1)
        return torch.gather(rows_m, 1, idx).contiguous(), (hi - bases[j]).to(torch.int32)

    if len(bases) < 2:
        fail("the random feed made a single flush")
    t1, v1 = flush_tile(0)
    s1 = kern.update_cuda(clone(s0), t1, v1)
    t2, v2 = flush_tile(1)
    fill2 = int(v1.min()) < K
    upd = kern.update_cuda if fill2 else kern.update_steady_cuda
    ragged_ms = event_ms(lambda s: upd(s, t2, v2), setup=lambda: clone(s1), batch=10)
    full_ms = event_ms(lambda s: upd(s, t2), setup=lambda: clone(s1), batch=10)
    _, ragged_accepts = plain.update_accepts(clone(s1), t2, v2, fill=fill2)
    ragged_bound, ragged_by = bound_ms(ragged_accepts, 0)
    ragged = {"ms": ragged_ms, "full_tile_ms": full_ms, "bound_ms": ragged_bound, "bound_by": ragged_by,
              "accepts": ragged_accepts, "elements": int(v2.sum()), "fill_kernel": fill2,
              "count_before": [int(v1.min()), int(v1.max())]}
    del rows_m, t1, t2, s0, s1, states
    card = card_line()
    log(f"[21 bridge vs engine] {card} | algl_update on flush 2's ragged tile ({int(v2.sum())} of {R * B} "
        f"elements, counts {int(v1.min())}..{int(v1.max())} before): {ragged_ms:.4f} ms, the same tile full "
        f"{full_ms:.4f} ms, bound {ragged_bound:.4f} ms ({ragged_by}), accepts {ragged_accepts}")

    # the weighted and distinct bridges: the card engine fed the journaled
    # flushes reaches the bridge's state; count() reads the launches of the
    # kernel a flush takes (keep-max in distinct mode: a flush passes valid)
    def journaled(name, cfg_x, streams, elems, weights, count):
        ckdir = os.path.join(work, name)
        bridge = rtt.DeviceStreamBridge(cfg_x, key=0, checkpoint_dir=ckdir, checkpoint_every=1 << 30)
        before = count()
        bridge.push_interleaved(streams, elems, weights=weights)
        bridge.flush()
        bridge.drain_barrier()
        flushes, launches = bridge.metrics.flushes, count() - before
        state = clone(bridge.engine._state)
        del bridge
        gc.collect()
        engine = rtt.ReservoirEngine(cfg_x, key=0)
        replayed = 0
        for _, tile, valid, wtile, _ in _FlushJournal.replay(
            os.path.join(ckdir, "journal.bin"), cfg_x.num_reservoirs, cfg_x.tile_size,
            np.dtype(cfg_x.element_dtype), cfg_x.weighted,
        ):
            engine.sample(tile, valid=valid, weights=wtile)
            replayed += 1
        torch.cuda.synchronize()
        shutil.rmtree(ckdir)
        if replayed != flushes or launches != flushes or flushes < 2:
            fail(f"{name}: {flushes} flushes, {launches} launches, {replayed} journaled")
        if not same(engine._state, state):
            fail(f"the {name} bridge's state != the card engine fed its journaled flushes")
        return flushes

    n_w = 2 * WR * WB
    w_streams = torch.randint(0, WR, (n_w,), generator=gen, device=dev, dtype=torch.int32).cpu().numpy()
    w_elems = torch.randint(-(2**31), 2**31 - 1, (n_w,), generator=gen, device=dev,
                            dtype=torch.int32).cpu().numpy()
    w_weights = weight_tile(gen, 1, n_w, "zeros", dev)[0].cpu().numpy()
    wcfg = rtt.SamplerConfig(max_sample_size=WK, num_reservoirs=WR, tile_size=WB, weighted=True)
    w_flushes = journaled("weighted", wcfg, w_streams, w_elems, w_weights, lambda: wkern.launches)
    del w_streams, w_elems, w_weights
    d_flushes = {}
    for dtype in (torch.int32, torch.int64):
        n_d = 3 * DR * DB
        d_streams = torch.randint(0, DR, (n_d,), generator=gen, device=dev, dtype=torch.int32).cpu().numpy()
        d_keys = zipf_keys(gen, 1, n_d, dtype, dev)[0].cpu().numpy()
        name = str(dtype).replace("torch.", "")
        dcfg = rtt.SamplerConfig(max_sample_size=DK, num_reservoirs=DR, tile_size=DB, distinct=True,
                                 element_dtype=name)
        d_flushes[name] = journaled(f"distinct {name}", dcfg, d_streams, d_keys, None,
                                    lambda: dkern.keepmax_launches)
    scfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=1, tile_size=B)
    one = torch.randint(-(2**31), 2**31 - 1, (5 * B + 77,), generator=gen, device=dev,
                        dtype=torch.int32).cpu().numpy()
    sampler = rtt.DeviceSampler(scfg, key=0)
    sampler.sample_all(one)
    ref = rtt.ReservoirEngine(scfg, key=0)
    ref.sample_stream(one[None, :])
    if not np.array_equal(sampler.result(), ref.result()[0]):
        fail("DeviceSampler != the engine on the same stream")
    log(f"[21 bridge vs engine] weighted bridge ({w_flushes} flushes of [{WR}, {WB}]), distinct bridges "
        f"int32 ({d_flushes['int32']}) and int64 ({d_flushes['int64']}) of [{DR}, {DB}]: each == the card "
        f"engine fed its journaled flushes; DeviceSampler (R 1, B {B}, k {K}) == the engine")

    # 22. timings of three feeds at full width
    gen.manual_seed(37)
    lock = torch.randint(-(2**31), 2**31 - 1, (3, B, R), generator=gen, device=dev, dtype=torch.int32)
    lock_streams = np.tile(np.arange(R, dtype=np.int32), B)
    lock_chunks = [lock[t].reshape(-1).cpu().numpy() for t in range(3)]
    host_tiles = [lock[t].T.contiguous().cpu().numpy() for t in range(3)]
    del lock

    def interleaved(bridge):
        bridge.push_interleaved(streams_h, elems_h)

    def lockstep(bridge):
        for chunk in lock_chunks:
            bridge.push_interleaved(lock_streams, chunk)

    def tiles(bridge):
        for tile in host_tiles:
            bridge.push_tile(tile)

    def window(bridge, feed) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed(bridge)
        bridge.flush()
        bridge.drain_barrier()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    feeds = {}
    overlap = []
    for name, feed, n in (("interleaved", interleaved, N), ("lockstep", lockstep, 3 * R * B),
                          ("push_tile", tiles, 3 * R * B)):
        bridge = rtt.DeviceStreamBridge(cfg, key=0)
        window(bridge, feed)  # warm
        m = bridge.metrics
        for f in ("demux_s", "drain_s", "dispatch_s", "copy_s", "reserve_s"):
            setattr(m, f, 0.0)
        m.flushes = m.elements = m.flushed_elements = 0
        dt = window(bridge, feed)
        feeds[name] = {
            "elem_per_s": n / dt, "seconds": dt, "flushes": m.flushes, "demux_s": m.demux_s,
            "take_s": m.drain_s, "copy_ms": 1e3 * m.copy_s / max(1, m.flushes), "dispatch_s": m.dispatch_s,
            "reserve_s": m.reserve_s,
        }
        if name == "lockstep":
            # one more pass in a profiler window: do the copies overlap
            # the demux of the next tile?
            try:
                with profile_capture(os.path.join(work, "profile")):
                    window(bridge, feed)
                overlap = copies_overlapping_demux(os.path.join(work, "profile", "trace.json"))
            except RuntimeError as e:
                log(f"[22 bridge timings] the profiler failed ({e}); overlap not measured")
        del bridge
        gc.collect()
    copy_ms = feeds["lockstep"]["copy_ms"]
    wire_eps = R * B / (copy_ms / 1e3) if copy_ms > 0 else None
    card = card_line()
    for name, f in feeds.items():
        log(f"[22 bridge timings] {card} | {name}: {f['elem_per_s']:.6e} elem/s ({f['seconds']:.3f} s, "
            f"{f['flushes']} flushes); demux {f['demux_s']:.3f} s, take {f['take_s']:.4f} s, copy "
            f"{f['copy_ms']:.2f} ms a flush, dispatch {f['dispatch_s']:.3f} s, waiting in reserve "
            f"{f['reserve_s']:.3f} s")
    log(f"[22 bridge timings] {card} | engine fed from the device {engine_eps['device_fed']:.6e}, from the "
        f"host {engine_eps['host_fed']:.6e} elem/s (phase 7); the wire's ceiling {4 * R * B} bytes / "
        f"{copy_ms:.2f} ms = {wire_eps or 0:.6e} elem/s; demux threads {threads} of {os.cpu_count()} cores; "
        + (f"profile: {len(overlap)} tile copies, each's share of its time during a demux range "
           + ", ".join(f"{share:.3f}" for share in overlap) + " (the last flush has no next tile)"
           if overlap else "profile: no device copies in the trace (overlap not measured)"))
    del lock_chunks, host_tiles, lock_streams, streams_h, elems_h

    # 23. recovery on the card
    rr, rb = RR, RB
    rcfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=rr, tile_size=rb)
    n_r = 8 * rr * rb
    r_streams = torch.randint(0, rr, (n_r,), generator=gen, device=dev, dtype=torch.int32).cpu().numpy()
    r_elems = torch.randint(-(2**31), 2**31 - 1, (n_r,), generator=gen, device=dev,
                            dtype=torch.int32).cpu().numpy()
    whole = rtt.DeviceStreamBridge(rcfg, key=0)
    whole.push_interleaved(r_streams, r_elems)
    want = whole.complete()
    del whole
    ckdir = os.path.join(work, "recovery")
    dropped = rtt.DeviceStreamBridge(rcfg, key=0, checkpoint_dir=ckdir, checkpoint_every=2)
    dropped.push_interleaved(r_streams[: n_r // 2], r_elems[: n_r // 2])
    dropped.drain_barrier()
    seq, durable, checkpoints = dropped.flushed_seq, dropped.metrics.flushed_elements, dropped.metrics.checkpoints
    del dropped  # the crash: no complete(), the staged remainder is lost
    gc.collect()
    t0 = time.perf_counter()
    recovered = rtt.DeviceStreamBridge.recover(ckdir)
    recover_s = time.perf_counter() - t0
    if recovered.flushed_seq != seq or recovered.metrics.flushed_elements != durable:
        fail(f"recover() came back at flush {recovered.flushed_seq} ({recovered.metrics.flushed_elements} "
             f"elements), the drop was at {seq} ({durable})")
    # resume from the durable watermark: the flushes took a prefix of the pairs
    recovered.push_interleaved(r_streams[durable:], r_elems[durable:])
    got = recovered.complete()
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail("the recovered bridge's samples != the uninterrupted run's")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[23 bridge recovery] R {rr}, B {rb}, checkpoint_every 2: dropped after flush {seq} "
        f"({checkpoints} checkpoints, {durable} of {n_r // 2} pushed elements durable); recover() on the "
        f"card in {recover_s:.2f} s, then the rest of the stream: samples == the uninterrupted run")
    return {
        "card": card,
        "config": {"R": R, "k": K, "B": B, "element_dtype": "int32", "pairs": N},
        "cpu_count": os.cpu_count(),
        "demux_threads": threads,
        "launches": bridge_launches,
        "flushes": len(bases),
        "feeds": feeds,
        "engine_elem_per_s": engine_eps,
        "wire_elem_per_s": wire_eps,
        "copy_time_share_during_demux": overlap,
        "ragged_flush": ragged,
        "weighted_flushes": w_flushes,
        "distinct_flushes": d_flushes,
        "recovery": {"flushes_before_drop": seq, "checkpoints": checkpoints, "recover_s": recover_s},
    }


class _EngineView:
    """What the skip gate's ``resync`` reads of an engine: its state."""

    def __init__(self, state):
        self._state = state
        self.reset_epochs = 0


def gated_candidates(state, tile: torch.Tensor, m: np.ndarray, cap: int):
    """The skip gate's candidate tile for ``tile[r, :m[r]]`` from the card
    ``state``, built by the port's own replica (native): rows whose
    candidates would overflow ``cap`` take nothing.  Returns ``(gtile,
    nvalid, advance)`` on the card and the fill and accept counts (the
    kernel's data-dependent work)."""
    from reservoir_tpu_torch.stream.gate import SkipGate

    rows, width = tile.shape
    gate = SkipGate(rows, state.k, width, np.int32, cap=cap)
    gate.resync(_EngineView(state))
    m = np.asarray(m, np.int32).copy()
    ev = gate.evaluate(m)
    m[ev.n_cand > cap] = 0
    ev = gate.evaluate(m)
    gate.append(tile.view(torch.int32).cpu().numpy(), m, ev)
    gtile, nvalid, advance, _ = gate.take()
    dev = tile.device
    fills, accepts = int(ev.fill.sum()), int(ev.n_acc.sum())
    return ((torch.from_numpy(gtile).to(dev).view(tile.dtype), torch.from_numpy(nvalid).to(dev),
             torch.from_numpy(advance).to(dev)), fills, accepts)


def gated_states(gen, dtype, dev) -> list:
    """Phase 24's states for one sample dtype, each ``(label, state, hi)``
    (``hi`` bounds the elements a row's candidates are drawn from, see
    :func:`gated_draw`): across the fill's end (count k - 20), past the fill
    (count k - 3), steady (count 4 B) and deep (count 24 B)."""
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    gen.manual_seed(41)
    s0 = plain.init(key_from_seed(3), R, K, sample_dtype=dtype, device=dev)
    near = kern.update_cuda(clone(s0), random_tile(gen, B, dtype, dev),
                            torch.full((R,), K - 20, dtype=torch.int32, device=dev))
    edge = kern.update_cuda(clone(s0), random_tile(gen, B, dtype, dev),
                            torch.full((R,), K - 3, dtype=torch.int32, device=dev))
    steady = kern.update_cuda(clone(s0), random_tile(gen, B, dtype, dev))
    for _ in range(3):  # count 4 B
        kern.update_steady_cuda(steady, random_tile(gen, B, dtype, dev))
    deep = clone(steady)
    for _ in range(20):  # count 24 B
        kern.update_steady_cuda(deep, random_tile(gen, B, dtype, dev))
    return [("across the fill's end (count k - 20)", near, 60),
            ("past the fill with few candidates (count k - 3)", edge, 14),
            (f"steady (count {4 * B})", steady, B + 1), (f"deep (count {24 * B})", deep, B + 1)]


def gated_draw(gen, rng, hi: int, dtype, dev) -> tuple:
    """A random ``[R, B]`` tile and each row's element count ``m`` for a
    state of :func:`gated_states`: below ``hi``, within 40 of it where
    ``hi`` passes B; every 7th row takes nothing."""
    tile = random_tile(gen, B, dtype, dev)
    m = rng.integers(max(0, hi - 40), hi, R).astype(np.int32) if hi > B else \
        rng.integers(0, hi, R).astype(np.int32)
    m[::7] = 0  # nvalid 0 and advance 0
    return tile, m


def gated_timing_cases(gen, dev) -> list:
    """Phase 24's int32 candidate tiles on its steady and deep states, each
    ``(label, state, (gtile, nvalid, advance), fills, accepts)``: phase 26
    times the steady one (``kernel_ab.py`` times both)."""
    rng = np.random.default_rng(24)
    out = []
    for label, state, hi in gated_states(gen, torch.int32, dev):
        tile, m = gated_draw(gen, rng, hi, torch.int32, dev)
        if label.startswith(("steady", "deep")):
            out.append((label, state, *gated_candidates(state, tile, m, GATE_CAP)))
    return out


def gated_bound_ms(fills: int, accepts: int, rows: int) -> tuple:
    """The gated kernel's bound: per row the state (28 bytes) with nvalid
    and advance (8), each candidate read once (4 bytes), one 32-byte
    sector written per filled or accepted slot (each sample once at most);
    an acceptance's operations as in :func:`bound_ms`."""
    moved = fills + accepts
    nbytes = rows * (STATE_BYTES_PER_ROW + 8) + 4 * moved + min(SECTOR_BYTES * moved, 4 * rows * K)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(accepts * INT_OPS_PER_ACCEPT / PEAK_INT32, accepts * FLOPS_PER_ACCEPT / PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wrap32(x: int) -> int:
    return ((x + 2**31) % 2**32) - 2**31


def stage_row(m, before: dict) -> dict:
    """A window's stage table from the bridge's metrics, less ``before``."""
    keys = ("elements", "flushes", "gated_dispatches", "demux_s", "drain_s", "dispatch_s", "copy_s",
            "reserve_s", "gate_eval_s", "gate_bytes_shipped", "gate_bytes_elided")
    return {key: getattr(m, key) - before.get(key, 0) for key in keys}


def snap(m) -> dict:
    return stage_row(m, {})


def gate_phases(gen, dev, here: str) -> tuple:
    """Phases 24-26, the skip gate; returns the ``gate`` line and the gated
    kernel's ``kernels`` entry."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch import native
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.stream.bridge import _FlushJournal
    from reservoir_tpu_torch.stream.gate import SkipGate

    work = os.path.join(here, "build", "chip_smoke")  # gitignored
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cap = GATE_CAP
    t0 = time.perf_counter()
    native.load_gate_library()
    log(f"[24 gate build] g++ skip-gate library (csrc/algl_chain.cuh for the CPU) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    # 24. the gated kernel against its plain version at full width
    worst_err = 0.0
    rng = np.random.default_rng(24)
    timing_case = None
    cases = 0
    for dtype in (torch.int32, torch.float32):
        plan = gated_states(gen, dtype, dev)
        for label, state, hi in plan:
            tile, m = gated_draw(gen, rng, hi, dtype, dev)
            (gtile, nvalid, advance), fills, accepts = gated_candidates(state, tile, m, cap)
            ref = plain.update_gated(clone(state), gtile, nvalid, advance)
            got = kern.update_gated_cuda(clone(state), gtile, nvalid, advance)
            full = kern.update_cuda(clone(state), tile, advance)
            torch.cuda.synchronize()
            worst_err = max(worst_err, max_abs_err(got, ref))
            if not same(got, ref):
                fail(f"algl_update_gated != its plain version ({dtype}, {label})")
            if not same(got, full):
                fail(f"algl_update_gated != algl_update over the whole tile ({dtype}, {label})")
            # rows 0..ROWS_CPU-1 on the CPU
            cpu = plain.update_gated(clone(state, ROWS_CPU, "cpu"), gtile[:ROWS_CPU].cpu(),
                                     nvalid[:ROWS_CPU].cpu(), advance[:ROWS_CPU].cpu())
            if not same(cpu, clone(got, ROWS_CPU, "cpu")):
                fail(f"the plain version on the CPU != the kernel's rows 0..{ROWS_CPU - 1} ({dtype}, {label})")
            cases += 1
            if dtype == torch.int32 and label.startswith("steady"):
                timing_case = (state, (gtile, nvalid, advance), fills, accepts)
            log(f"[24 gated kernel vs plain] {dtype}, {label}: {int(nvalid.sum())} candidates "
                f"({fills} fill, {accepts} accepts) of {int(advance.sum())} elements: kernel == plain "
                f"version on the card == algl_update of the whole tile; rows 0..{ROWS_CPU - 1} == the "
                "plain version on the CPU")
            del ref, got, full, tile
        # the two replicas on each of these states: the native one over all
        # R rows (split over its threads), the torch one over every
        # (R // ROWS_CPU)-th row, a sample that falls in every thread's range.
        # A replica reads count, nxt, log_w and key, never the samples, so
        # the int32 states' chains stand for the float32 ones (a depth cut)
        if dtype != torch.int32:
            del plan, state
            continue
        idx = torch.arange(0, R, REPLICA_STRIDE, device=dev)
        idx_np = idx.cpu().numpy()
        threads = 0
        for label, state, hi in plan:
            m = rng.integers(0, 2 * hi, R).astype(np.int32)
            row, extra = 5, 3000
            full_gate = SkipGate(R, K, B, np.int32, cap=cap)
            full_gate.resync(_EngineView(state))
            threads = min(full_gate.threads(), R // 1024)
            full_n = full_gate.evaluate(m)
            row_n = full_gate.evaluate_row(int(idx_np[row]), int(m[idx_np[row]]) + extra)
            sub_gate = SkipGate(idx.numel(), K, B, np.int32, cap=cap, native=False)
            sub_gate.resync(_EngineView(type(state)(*(None if t is None else t[idx].cpu() for t in state))))
            full_t = sub_gate.evaluate(m[idx_np])
            row_t = sub_gate.evaluate_row(row, int(m[idx_np[row]]) + extra)
            pairs = [(np.asarray(x)[idx_np], y) for x, y in zip((full_n.pos, full_n.fill, full_n.n_acc)
                                                                + full_n.state,
                                                                (full_t.pos, full_t.fill, full_t.n_acc)
                                                                + full_t.state)]
            pairs += list(zip((row_n.pos, row_n.fill, row_n.n_acc) + row_n.state,
                              (row_t.pos, row_t.fill, row_t.n_acc) + row_t.state))
            for x, y in pairs:
                if not np.array_equal(np.asarray(x).view(np.int32), np.asarray(y).view(np.int32)):
                    fail(f"the native replica != the torch replica ({dtype}, {label})")
        log(f"[24 replicas] {dtype}: native replica over all {R} rows ({threads} threads) == torch "
            f"replica on every {REPLICA_STRIDE}th row of the four states (evaluate and evaluate_row: "
            "pos, fill, n_acc, count, nxt, log_w)")
        del plan, state

    # 25. the gated bridge at full width
    cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B)
    TILES_A, ROUNDS_B, CHUNK_B = FEED_A_TILES, FEED_B_ROUNDS, FEED_B_CHUNK
    N = TILES_A * B + ROUNDS_B * CHUNK_B  # each row's stream
    gen.manual_seed(43)
    lock_tiles = [torch.randint(-(2**31), 2**31 - 1, (R, B), generator=gen, device=dev, dtype=torch.int32)
                  for _ in range(TILES_A)]
    lock_streams = np.tile(np.arange(R, dtype=np.int32), B)
    lock_chunks = [t.T.contiguous().reshape(-1).cpu().numpy() for t in lock_tiles]
    ramp = np.arange(CHUNK_B, dtype=np.int32)

    def feed_a(bridge, tiles):
        for t in tiles:
            bridge.push_interleaved(lock_streams, lock_chunks[t])

    def feed_b(bridge, rounds, rows=None):
        """Per-row pushes of CHUNK_B elements ``row * N + pos`` (int32),
        made at each push, round-robin over the rows."""
        for rnd in rounds:
            pos0 = TILES_A * B + rnd * CHUNK_B
            for row in (range(R) if rows is None else rows):
                bridge.push(row, ramp + np.int32(wrap32(row * N + pos0)))

    def b_tile(j: int) -> torch.Tensor:
        """The [R, B] tile j of feed (b)'s part of every row's stream."""
        pos = TILES_A * B + j * B + torch.arange(B, device=dev, dtype=torch.int64)
        x = torch.arange(R, device=dev, dtype=torch.int64)[:, None] * N + pos[None, :]
        return (((x + 2**31) % 2**32) - 2**31).to(torch.int32).contiguous()

    def window(bridge, feed) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed()
        bridge.flush()
        bridge.drain_barrier()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    for mod in (kern, wkern, dkern, mkern):
        mod.launches = 0
    kern.gated_launches = dkern.keepmax_launches = dkern.prehashed_launches = 0
    bridge = rtt.DeviceStreamBridge(cfg, key=0, gated=True)
    if not (bridge.gate_active and bridge._gate.native and bridge._gate.cap == cap):
        fail("the gated bridge's gate is not active with the native replica")
    warm_a, win_a = 4, FEED_A_WINDOW
    window(bridge, lambda: feed_a(bridge, range(warm_a)))  # the fill: fallback flushes
    before = snap(bridge.metrics)
    dt_a = window(bridge, lambda: feed_a(bridge, range(warm_a, warm_a + win_a)))
    gated_a = stage_row(bridge.metrics, before)
    # the rest of (a), past the window: (b) starts where it ends
    window(bridge, lambda: feed_a(bridge, range(warm_a + win_a, TILES_A)))
    m = bridge.metrics
    launches_a = (kern.launches, kern.gated_launches)
    if kern.gated_launches != m.gated_dispatches or kern.launches != m.flushes - m.gated_dispatches:
        fail(f"feed (a): {kern.launches} algl_update and {kern.gated_launches} algl_update_gated launches "
             f"for {m.flushes} flushes, {m.gated_dispatches} of them gated")
    if m.gated_dispatches < 1 or m.flushes == m.gated_dispatches:
        fail(f"feed (a) made {m.gated_dispatches} gated dispatches of {m.flushes} flushes: "
             "both kinds were expected")
    # the reference engine's launches are a comparison's: the count skips them
    counted = kern.launches
    engine = rtt.ReservoirEngine(cfg, key=0)
    for t in lock_tiles:
        engine.sample(t)
    torch.cuda.synchronize()
    kern.launches = counted
    if not same(bridge.engine._state, engine._state):
        fail("feed (a): the gated bridge's state != the card engine fed the same row streams")
    state_a = clone(bridge.engine._state)
    log(f"[25 gated bridge] feed (a), {TILES_A} lockstep tiles of [{R}, {B}] through push_interleaved: "
        f"{m.flushes} flushes, {m.gated_dispatches} gated; {launches_a[0]} algl_update and "
        f"{launches_a[1]} algl_update_gated launches; state == the card engine fed the same row streams")
    feed_b(bridge, range(1))  # warm: round 1
    before = snap(bridge.metrics)
    dt_b = window(bridge, lambda: feed_b(bridge, range(1, ROUNDS_B)))
    gated_b = stage_row(bridge.metrics, before)
    m = bridge.metrics
    if kern.gated_launches != m.gated_dispatches or kern.launches != m.flushes - m.gated_dispatches:
        fail(f"feed (b): {kern.launches} algl_update and {kern.gated_launches} algl_update_gated launches "
             f"for {m.flushes} flushes, {m.gated_dispatches} of them gated")
    main_gated = kern.gated_launches
    main_fallback = kern.launches
    if wkern.launches or dkern.launches or dkern.keepmax_launches or dkern.prehashed_launches or mkern.launches:
        fail("the gated bridge launched a weighted, distinct or merge kernel")
    for j in range(ROUNDS_B * CHUNK_B // B):
        engine.sample(b_tile(j))
    torch.cuda.synchronize()
    kern.launches = main_fallback
    if not same(bridge.engine._state, engine._state):
        fail("feed (b): the gated bridge's state != the card engine fed the same row streams")
    shipped, elided = m.gate_bytes_shipped, m.gate_bytes_elided
    skip = elided / (elided + shipped)
    log(f"[25 gated bridge] feed (b), {ROUNDS_B} rounds of push(row, {CHUNK_B} elements) over {R} rows: "
        f"state == the card engine fed the same row streams in [{R}, {B}] tiles; in all "
        f"{m.flushes} flushes, {m.gated_dispatches} gated ({main_gated} algl_update_gated launches), "
        f"{main_fallback} fallback algl_update launches; bytes shipped {shipped}, elided {elided}: "
        f"skip fraction {skip:.6f}")
    del bridge, engine
    gc.collect()

    # the gated journal: dropped halfway, recovered on the card
    rr, rb, rtiles = RR, RB, 24
    rcfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=rr, tile_size=rb)
    rdata = torch.randint(-(2**31), 2**31 - 1, (rr, rtiles * rb), generator=gen, device=dev,
                          dtype=torch.int32).cpu().numpy()
    r_streams = np.tile(np.arange(rr, dtype=np.int32), rb)

    def r_feed(bridge, tiles):
        for t in tiles:
            bridge.push_interleaved(r_streams, np.ascontiguousarray(rdata[:, t * rb:(t + 1) * rb].T).ravel())

    whole = rtt.DeviceStreamBridge(rcfg, key=0, gated=True)
    r_feed(whole, range(rtiles))
    want = whole.complete()
    del whole
    ckdir = os.path.join(work, "gated_recovery")
    journal = os.path.join(ckdir, "journal.bin")
    dropped = rtt.DeviceStreamBridge(rcfg, key=0, gated=True, checkpoint_dir=ckdir, checkpoint_every=2)
    # from halfway on, drop at the first tile after which the journal (the
    # frames since the last checkpoint) holds a gated frame
    frames = []
    for t in range(rtiles - 1):
        r_feed(dropped, [t])
        if t + 1 >= rtiles // 2:
            dropped.drain_barrier()
            frames = [rec[5] is not None for rec in _FlushJournal.read_records(journal, rr, rb, np.int32, False)]
            if any(frames):
                break
    dropped_at = t + 1
    seq, dispatches = dropped.flushed_seq, dropped.metrics.gated_dispatches
    del dropped  # the crash: the staged rows and the gate's buffer are lost
    gc.collect()
    before = kern.gated_launches
    t0 = time.perf_counter()
    recovered = rtt.DeviceStreamBridge.recover(ckdir)
    recover_s = time.perf_counter() - t0
    replayed = kern.gated_launches - before
    if not any(frames) or replayed != sum(frames) or recovered.flushed_seq != seq:
        fail(f"gated recovery: {sum(frames)} RTJG frames of {len(frames)} in the journal, {replayed} "
             f"algl_update_gated launches in the replay, back at flush {recovered.flushed_seq} of {seq}")
    # lockstep tiles leave every row at one durable count, a whole tile
    counts = recovered.engine.state.count.cpu().numpy()
    if (counts != counts[0]).any() or counts[0] % rb:
        fail(f"the recovered rows' durable counts are not one whole tile: {counts.min()}..{counts.max()}")
    r_feed(recovered, range(int(counts[0]) // rb, rtiles))
    got = recovered.complete()
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail("the recovered gated bridge's samples != the uninterrupted run's")
    del recovered
    gc.collect()
    log(f"[25 gated recovery] R {rr}, B {rb}, checkpoint_every 2, {rtiles} lockstep tiles: dropped after "
        f"tile {dropped_at}, flush {seq} ({dispatches} gated dispatches); recover() replayed {len(frames)} frames, {sum(frames)} "
        f"of them RTJG through {replayed} algl_update_gated launches, in {recover_s:.2f} s; the rows resumed "
        f"from their durable count {int(counts[0])}: samples == the uninterrupted run")

    # 26. timings: the same feeds through an ungated bridge
    ungated = rtt.DeviceStreamBridge(cfg, key=0)
    window(ungated, lambda: feed_a(ungated, range(warm_a)))
    before = snap(ungated.metrics)
    dt_ua = window(ungated, lambda: feed_a(ungated, range(warm_a, warm_a + win_a)))
    ungated_a = stage_row(ungated.metrics, before)
    # feed (b) ungated: every push of CHUNK_B > B elements to one row fills
    # it CHUNK_B / B times, and each fill flushes the whole [R, B] tile,
    # so the window is the first pushes of round 1 only
    warm_rows, win_rows = 8, UNGATED_B_PUSHES
    feed_b(ungated, range(1), rows=range(warm_rows))
    before = snap(ungated.metrics)
    dt_ub = window(ungated, lambda: feed_b(ungated, range(1), rows=range(warm_rows, warm_rows + win_rows)))
    ungated_b = stage_row(ungated.metrics, before)
    del ungated, lock_chunks, lock_tiles
    gc.collect()
    rates = {
        "a": {"gated": win_a * R * B / dt_a, "ungated": win_a * R * B / dt_ua},
        "b": {"gated": (ROUNDS_B - 1) * R * CHUNK_B / dt_b, "ungated": win_rows * CHUNK_B / dt_ub},
    }
    # the replica's evaluation, native and plain, from the state after feed (a)
    view = _EngineView(state_a)
    times = {}
    for native in (True, False):
        gate = SkipGate(R, K, B, np.int32, cap=cap, native=native)
        gate.resync(view)
        full_t, row_t = [], []
        for _ in range(5 if native else 1):
            t0 = time.perf_counter()
            ev = gate.evaluate(np.full(R, B, np.int32))
            full_t.append(1e3 * (time.perf_counter() - t0))
        for row in range(200 if native else 1):
            t0 = time.perf_counter()
            gate.evaluate_row(row, CHUNK_B)
            row_t.append(1e3 * (time.perf_counter() - t0))
        times["native" if native else "torch"] = {
            "evaluate_ms": statistics.median(full_t), "evaluate_row_ms": statistics.median(row_t),
            "accepts": int(ev.n_acc.sum()), "threads": gate.threads()}
        del gate
    # the gated kernel on phase 24's steady candidate tile
    state, (gtile, nvalid, advance), fills, accepts = timing_case
    gated_ms = event_ms(lambda s: kern.update_gated_cuda(s, gtile, nvalid, advance),
                        setup=lambda: clone(state), batch=10)
    plain_t = []
    for _ in range(3):
        t0 = time.perf_counter()
        plain.update_gated(clone(state), gtile, nvalid, advance)
        torch.cuda.synchronize()
        plain_t.append(1e3 * (time.perf_counter() - t0))
    gated_plain_ms = statistics.median(plain_t)
    gated_bound, gated_by = gated_bound_ms(fills, accepts, R)
    build = kern.gated_kernel_info()
    card = card_line()
    for feed in ("a", "b"):
        g, u = rates[feed]["gated"], rates[feed]["ungated"]
        log(f"[26 gate timings] {card} | feed ({feed}): gated {g:.6e} elem/s, ungated {u:.6e} elem/s "
            f"({g / u:.3f}x)")
    for name, row in (("gated (a)", gated_a), ("ungated (a)", ungated_a), ("gated (b)", gated_b),
                      ("ungated (b)", ungated_b)):
        log(f"[26 gate timings] {card} | {name}: {row['elements']} elements, {row['flushes']} flushes "
            f"({row['gated_dispatches']} gated); demux {row['demux_s']:.3f} s, take {row['drain_s']:.4f} s, "
            f"copy {row['copy_s']:.4f} s, dispatch {row['dispatch_s']:.3f} s, reserve {row['reserve_s']:.3f} s, "
            f"gate eval {row['gate_eval_s']:.3f} s; shipped {row['gate_bytes_shipped']} B, elided "
            f"{row['gate_bytes_elided']} B")
    for name, t in times.items():
        log(f"[26 gate timings] {card} | {name} replica at R {R}: evaluate of a {B}-element chunk a row "
            f"{t['evaluate_ms']:.3f} ms ({t['accepts']} accepts, {t['threads']} threads), evaluate_row of "
            f"{CHUNK_B} elements {t['evaluate_row_ms']:.4f} ms")
    log(f"[26 gate timings] {card} | algl_update_gated on phase 24's steady candidate tile ({int(nvalid.sum())} "
        f"candidates: {fills} fill, {accepts} accepts): {gated_ms:.4f} ms, plain {gated_plain_ms:.1f} ms, "
        f"bound {gated_bound:.4f} ms ({gated_by}); build {build_text(build)}")
    shutil.rmtree(work, ignore_errors=True)
    gate_line = {
        "card": card,
        "config": {"R": R, "k": K, "B": B, "gate_tile": cap, "feed_a_tiles": TILES_A,
                   "feed_b_rounds": ROUNDS_B, "feed_b_chunk": CHUNK_B},
        "kernel_cases": cases,
        "elem_per_s": rates,
        "stages": {"gated_a": gated_a, "ungated_a": ungated_a, "gated_b": gated_b, "ungated_b": ungated_b},
        "skip_frac": skip,
        "bytes": {"shipped": shipped, "elided": elided},
        "fallback_launches": main_fallback,
        "replica_ms": times,
        "recovery": {"frames": len(frames), "gated_frames": sum(frames), "replayed_launches": replayed,
                     "recover_s": recover_s},
    }
    entry = {
        "name": "algl_update_gated",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/algorithm_l.cu",
        "replaces": "reservoir_tpu/ops/algorithm_l.py:427",
        "replaces_note": "no TPU kernel: the reference's update_gated is XLA",
        "launches": main_gated,
        "max_abs_err": worst_err,
        "ms": gated_ms,
        "plain_ms": gated_plain_ms,
        "bound_ms": gated_bound,
        "bound_by": gated_by,
        "library_ms": None,
        "candidates": int(nvalid.sum()),
        "accepts": accepts,
        "build": build,
    }
    return gate_line, entry



# the operator's phases: BASELINE.md config 1 (k = 128 over a 1M-element
# stream), its stream with a ragged tail, the distinct flow's Zipf keys, the
# graceful cancel's prefix, the KS gate's runs, the wire's connections (the
# distinct flow's k is phase 14's, whose oracle it reuses)
OP_K, OP_DK, OP_B = 128, DK, 1024
OP_N = 1_048_876  # 1,024 full tiles and a ragged 300
OP_DN = 1 << 20
OP_CANCEL = 500_000
OP_KS_RUNS, OP_KS_N = 512, 8192
WIRE_CONNS, WIRE_FRAME, WIRE_REPS = 8, 65_536, 5
# a mode-0 wire connection's stream: 8 frames (a depth cut, see the
# docstring), and the timed runs of 8 connections at once
WIRE_N = 8 * WIRE_FRAME
WIRE_CONC_REPS = 2
# the frames a connection streams in phase 29's timed runs
WIRE_TIMED_FRAMES = 4


def op_zipf(seed: int, n: int) -> np.ndarray:
    """bench.py's distinct keys (``min(u ** -10, 1e7)``) as int64, from a
    numpy seed."""
    u = np.random.default_rng(seed).random(n) * (1.0 - 1e-6) + 1e-6
    return np.minimum(u ** -10.0, 1e7).astype(np.int64)


def same_result(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())


def distinct_reply_ok(keys: np.ndarray, salts: np.ndarray, got: np.ndarray) -> tuple:
    """Phase 14's exact oracle on one row of ``OP_DK`` keys: ``got`` (the
    row's sample) padded to the oracle's ``[1, k]`` layout."""
    samples = np.zeros((1, OP_DK), np.int64)
    samples[0, : got.size] = got
    ok, msg, _, _ = distinct_oracle([keys[None, :]], salts, samples, np.array([got.size]))
    return ok, msg


def wire_frames(values: np.ndarray) -> list:
    """A stream as the shim stage sends it: ``B`` frames of WIRE_FRAME
    big-endian int64 values."""
    import struct

    out = []
    for off in range(0, values.size, WIRE_FRAME):
        arr = values[off : off + WIRE_FRAME].astype(">i8")
        out.append(b"B" + struct.pack(">I", arr.size) + arr.tobytes())
    return out


def wire_recv(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the server closed the connection")
        buf += chunk
    return bytes(buf)


def wire_session(addr, mode: int, k: int, frames: list, nodelay: bool = False) -> np.ndarray:
    """One materialization over the wire: handshake, the frames, ``C``;
    returns the reply's values.  ``nodelay`` sets ``TCP_NODELAY`` on the
    client's socket (Nagle's algorithm off)."""
    import socket
    import struct

    with socket.create_connection(addr, timeout=300) as sock:
        if nodelay:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(b"RSV1" + bytes([mode]) + struct.pack(">I", k))
        for f in frames:
            sock.sendall(f)
        sock.sendall(b"C")
        head = wire_recv(sock, 5)
        if head[:1] != b"R":
            raise ConnectionError(f"reply tag {head[:1]!r}")
        (size,) = struct.unpack(">I", head[1:])
        return np.frombuffer(wire_recv(sock, 8 * size), ">i8").astype(np.int64)


def wire_concurrent(addr, mode: int, k: int, streams: list, nodelay: bool = False) -> tuple:
    """``len(streams)`` connections at once, one thread each; returns
    ``(replies, seconds from the first connect to the last reply)``."""
    import threading

    replies, errors = [None] * len(streams), []

    def client(i, frames):
        try:
            replies[i] = wire_session(addr, mode, k, frames, nodelay)
        except BaseException as e:  # reported on the main thread
            errors.append(f"connection {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i, f)) for i, f in enumerate(streams)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    seconds = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"wire connections failed: {errors or 'a client did not finish'}")
    return replies, seconds


def operator_phases(dev) -> tuple:
    """Phases 27-29, the pass-through operator and the interop server on
    the card; returns the ``operator`` line and the phases' additions to
    the ``algl_update`` and ``distinct_update_keepmax`` entries."""
    import asyncio
    import socket
    import struct

    from reservoir_tpu_torch import DeviceSampler, Sample, SamplerConfig, api
    from reservoir_tpu_torch.convert import distinct_state_to_numpy
    from reservoir_tpu_torch.errors import AbruptStreamTermination
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops.rng import key_from_seed
    from reservoir_tpu_torch.stream.interop import MAX_FRAME_ELEMS, SampleServer
    from reservoir_tpu_torch.utils.stats import KS_GATE, ks_one_sample_uniform

    from reservoir_tpu_torch import ReservoirEngine as rtt_engine

    ucfg = SamplerConfig(OP_K, 1, tile_size=OP_B)
    dcfg = SamplerConfig(OP_DK, 1, tile_size=OP_B, distinct=True, element_dtype="int64")
    flow = Sample.device(OP_K, key=0, tile_size=OP_B)
    line = {}

    # 27. the operator on the card: the main path of this phase
    torch.cuda.synchronize()
    kern.launches = 0
    dkern.launches = dkern.keepmax_launches = dkern.prehashed_launches = 0
    t0 = time.perf_counter()
    card = flow.run(range(OP_N)).drain()
    op_s = time.perf_counter() - t0
    u_launches, u_other = kern.launches, dkern.launches + dkern.keepmax_launches + dkern.prehashed_launches
    if u_launches != OP_N // OP_B + 1 or u_other:
        fail(f"Sample.device over {OP_N} elements launched algl_update {u_launches} times and "
             f"distinct_update {u_other} times, not {OP_N // OP_B + 1} and 0")
    if card.shape != (OP_K,) or np.unique(card).size != OP_K or card.min() < 0 or card.max() >= OP_N:
        fail(f"Sample.device's sample is not {OP_K} distinct positions of the stream")
    cpu = Sample.device(OP_K, key=0, tile_size=OP_B, device="cpu").run(range(OP_N)).drain()
    if not same_result(card, cpu):
        fail("Sample.device on the card != the same flow with device='cpu'")
    direct = DeviceSampler(ucfg, key=0)
    direct.sample_all(np.arange(OP_N, dtype=np.int32))
    if not same_result(card, direct.result()):
        fail("Sample.device on the card != a card DeviceSampler fed the stream as one array")

    async def agen(n):
        for i in range(n):
            yield i

    async def adrain():
        return await flow.run_async(agen(OP_N)).drain()

    kern.launches = 0
    t0 = time.perf_counter()
    acard = asyncio.run(adrain())
    aop_s = time.perf_counter() - t0
    a_launches = kern.launches
    if a_launches != OP_N // OP_B + 1 or not same_result(acard, card):
        fail(f"run_async on the card: {a_launches} launches, sample equal to the sync run: "
             f"{same_result(acard, card)}")
    log(f"[27 operator] uniform: Sample.device({OP_K}, tile_size={OP_B}) over {OP_N} elements: "
        f"{u_launches} algl_update launches ({OP_N // OP_B} full tiles and a ragged {OP_N % OP_B}), "
        f"sample == "
        f"device='cpu' == a card DeviceSampler fed one array; run_async: {a_launches} launches, "
        f"the same sample")

    keys = op_zipf(27, OP_DN)
    dflow = Sample.device(OP_DK, distinct=True, element_dtype="int64", key=0, tile_size=OP_B)
    kern.launches = 0
    dkern.launches = dkern.keepmax_launches = dkern.prehashed_launches = 0
    dres = dflow.run(iter(keys)).drain()
    # a sampler's flushes pass valid, so they take keep-max (the reference's XLA rule)
    d_launches, d_other = dkern.keepmax_launches, kern.launches + dkern.launches + dkern.prehashed_launches
    if d_launches != OP_DN // OP_B or d_other:
        fail(f"the distinct flow launched distinct_update_keepmax {d_launches} times and other update "
             f"kernels {d_other} times, not {OP_DN // OP_B} and 0")
    salts = distinct_state_to_numpy(DeviceSampler(dcfg, key=0).engine.state)["salts"]
    ok, msg = distinct_reply_ok(keys, salts, np.asarray(dres))
    if not ok:
        fail(f"the distinct flow's sample != the exact oracle: {msg}")
    log(f"[27 operator] distinct: Sample.device({OP_DK}, distinct=True, int64) over {OP_DN} Zipf "
        f"keys: {d_launches} distinct_update_keepmax launches, {dres.size} keys, equal to the exact oracle")

    # the completion protocol on the card
    kern.launches = 0
    run = flow.run(range(OP_N))
    for _ in range(OP_CANCEL):
        next(run)
    run.cancel()
    partial = run.sample.result(timeout=120)
    c_launches = kern.launches
    ref = DeviceSampler(ucfg, key=0)
    ref.sample_all(np.arange(OP_CANCEL, dtype=np.int32))
    if not same_result(partial, ref.result()) or c_launches != -(-OP_CANCEL // OP_B):
        fail(f"a graceful cancel after {OP_CANCEL} elements: {c_launches} launches, sample equal to "
             f"a DeviceSampler fed them: {same_result(partial, ref.result())}")
    cause = RuntimeError("downstream gave up")
    run = flow.run(range(OP_N))
    for _ in range(2 * OP_B + 10):
        next(run)
    run.cancel(cause)
    if run.sample.exception(timeout=60) is not cause:
        fail("cancel(cause) did not fail the future with the cause")
    run = flow.run(range(OP_N))
    for _ in range(OP_B + 7):
        next(run)
    fut = run.sample
    del run
    gc.collect()
    if not isinstance(fut.exception(timeout=60), AbruptStreamTermination):
        fail("a dropped operator did not fail its future with AbruptStreamTermination")
    log(f"[27 operator] protocol: graceful cancel after {OP_CANCEL} elements ({c_launches} launches) "
        f"== a DeviceSampler fed them; cancel(cause) fails the future with the cause; a dropped "
        f"operator fails it with AbruptStreamTermination")

    positions = []
    for key in range(OP_KS_RUNS):
        res = Sample.device(OP_K, key=key, tile_size=OP_B).run(range(OP_KS_N)).drain()
        if np.unique(res).size != OP_K:
            fail(f"materialization {key} sampled a position twice")
        positions.append(res)
    ks = ks_one_sample_uniform(np.concatenate(positions), OP_KS_N)
    if not ks < KS_GATE:
        fail(f"KS distance {ks} over {OP_KS_RUNS} materializations is not below {KS_GATE}")
    log(f"[27 operator] KS over the sampled positions of {OP_KS_RUNS} materializations (keys "
        f"0..{OP_KS_RUNS - 1}) of a {OP_KS_N}-element stream: {ks:.6f} < {KS_GATE}")
    line["flow"] = {"uniform_launches": u_launches, "async_launches": a_launches,
                    "distinct_launches": d_launches, "cancel_launches": c_launches, "ks": ks,
                    "distinct_size": int(dres.size)}

    # 28. SampleServer on the card
    def factory(mode, k):
        cfg = SamplerConfig(k, 1, tile_size=OP_B, distinct=mode == 1,
                            element_dtype="int64" if mode == 1 else "int32")
        return DeviceSampler(cfg, key=0)

    streams = [np.random.default_rng(280 + i).integers(0, 2**31, WIRE_N) for i in range(WIRE_CONNS)]
    frames = [wire_frames(v) for v in streams]
    with SampleServer(sampler_factory=factory) as srv:
        torch.cuda.synchronize()
        kern.launches = 0
        dkern.launches = dkern.keepmax_launches = dkern.prehashed_launches = 0
        replies, wire_s = wire_concurrent(srv.address, 0, OP_K, frames)
        w_launches = kern.launches
        if (w_launches != WIRE_CONNS * (WIRE_N // OP_B)
                or dkern.launches + dkern.keepmax_launches + dkern.prehashed_launches):
            fail(f"{WIRE_CONNS} connections launched algl_update {w_launches} times, not "
                 f"{WIRE_CONNS * (WIRE_N // OP_B)}")
        for i, (v, got) in enumerate(zip(streams, replies)):
            ref = DeviceSampler(ucfg, key=0)
            ref.sample_all(v)
            if not same_result(got, ref.result().astype(np.int64)):
                fail(f"connection {i}'s reply != a card DeviceSampler fed its stream")
        (dreply,), _ = wire_concurrent(srv.address, 1, OP_DK, [wire_frames(keys)])
        wd_launches = dkern.keepmax_launches
        ok, msg = distinct_reply_ok(keys, salts, dreply)
        if not ok or wd_launches != OP_DN // OP_B or dkern.launches or dkern.prehashed_launches:
            fail(f"the mode-1 connection: {wd_launches} launches; reply: {msg or 'equal'}")
        # failure paths
        with socket.create_connection(srv.address, timeout=60) as sock:
            sock.sendall(b"RSV1" + bytes([0]) + struct.pack(">I", OP_K))
            sock.sendall(frames[0][0])
            sock.sendall(b"F")
            if wire_recv(sock, 1) != b"A":
                fail("an F connection was not answered A")
        sock = socket.create_connection(srv.address, timeout=60)
        sock.sendall(b"RSV1" + bytes([0]) + struct.pack(">I", OP_K))
        sock.sendall(frames[0][0])
        sock.close()
        if wire_session(srv.address, 0, 4, [wire_frames(np.arange(3))[0]]).tolist() != [0, 1, 2]:
            fail("the server did not serve after an abrupt disconnect")
        with socket.create_connection(srv.address, timeout=60) as sock:
            sock.sendall(b"RSV1" + bytes([0]) + struct.pack(">I", OP_K))
            sock.sendall(b"B" + struct.pack(">I", MAX_FRAME_ELEMS + 1))
            sock.sendall(b"C")
            try:
                refused = sock.recv(1) == b""
            except OSError:
                refused = True
            if not refused:
                fail("a frame over MAX_FRAME_ELEMS was not refused")
    log(f"[28 server] {WIRE_CONNS} concurrent mode-0 connections of {WIRE_N} values in "
        f"{WIRE_N // WIRE_FRAME} frames: {w_launches} algl_update launches, every reply == a card "
        f"DeviceSampler fed its stream; mode 1 (k {OP_DK}, Zipf int64): {wd_launches} "
        f"distinct_update_keepmax launches, reply == the exact oracle; F answered A, served after an "
        f"abrupt disconnect, a frame over MAX_FRAME_ELEMS refused")
    line["server"] = {"connections": WIRE_CONNS, "launches": w_launches,
                      "distinct_launches": wd_launches}

    # 29. timings
    n = OP_DN
    rng_arr = np.arange(n, dtype=np.int64)
    host = {}

    def host_rate(fn, reps=3) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return n / statistics.median(times)

    host["Sample_drain_range"] = host_rate(lambda: Sample(OP_K, rng=0).run(range(n)).drain(), reps=2)
    host["sampler_range_c_scan"] = host_rate(lambda: api.sampler(OP_K, rng=0).sample_all(range(n)))
    host["sampler_int64_c_scan"] = host_rate(lambda: api.sampler(OP_K, rng=0).sample_all(rng_arr))
    host["sampler_int64_native_false"] = host_rate(
        lambda: api.sampler(OP_K, rng=0, native=False).sample_all(rng_arr))
    host["sampler_range_native_false"] = host_rate(
        lambda: api.sampler(OP_K, rng=0, native=False).sample_all(range(n)))
    host["distinct_zipf_c_scan"] = host_rate(lambda: api.distinct(OP_DK, rng=0).sample_all(keys))
    host["distinct_zipf_native_false"] = host_rate(
        lambda: api.distinct(OP_DK, rng=0, native=False).sample_all(keys), reps=2)

    flush_s = [0.0]

    def timed_factory():
        s = DeviceSampler(ucfg, key=0)
        sample = s.engine.sample

        def timed(*a, **kw):
            t = time.perf_counter()
            sample(*a, **kw)
            flush_s[0] += time.perf_counter() - t

        s.engine.sample = timed
        return s

    tflow = Sample.from_factory(timed_factory)
    tflow.run(range(OP_B * 4)).drain()  # warm: pinned buffers, the library
    flush_s[0] = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tflow.run(range(n)).drain()
    drain_s = time.perf_counter() - t0
    device = {"Sample_device_drain": n / drain_s, "drain_s": drain_s, "flush_s": flush_s[0],
              "host_s": drain_s - flush_s[0], "launches": n // OP_B}
    arr32 = np.arange(n, dtype=np.int32)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = DeviceSampler(ucfg, key=0)
        s.sample_all(arr32)
        s.result()
        times.append(time.perf_counter() - t0)
    device["DeviceSampler_sample_all"] = n / statistics.median(times)

    # where a flush's host time goes: the engine fed [1, 1024] host tiles
    # as DeviceSampler feeds it (with valid) and without valid
    eng = rtt_engine(ucfg)
    tile = np.arange(OP_B, dtype=np.int32)[None, :]
    full = np.array([OP_B], np.int32)
    for _ in range(OP_K // OP_B + 8):
        eng.sample(tile, valid=full)  # warm, and past the fill
    for label, kw in (("flush_with_valid", {"valid": full}), ("flush_without_valid", {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_B):
            eng.sample(tile, **kw)
        torch.cuda.synchronize()
        device[f"{label}_ms"] = 1e3 * (time.perf_counter() - t0) / OP_B
    del eng

    # the wire's rate varies from run to run by more than 10x, so each
    # case runs WIRE_REPS times (one connection) or WIRE_CONC_REPS times
    # (8 at once), each connection streaming WIRE_N values
    wire = {}
    timed = [f[:WIRE_TIMED_FRAMES] for f in frames]
    timed_n = WIRE_TIMED_FRAMES * WIRE_FRAME
    for name, kw in (("host", {}), ("device", {"sampler_factory": factory})):
        with SampleServer(**kw) as srv:
            wire_concurrent(srv.address, 0, OP_K, timed[:1])  # warm
            for nodelay in (False, True):
                for conns in (1, WIRE_CONNS):
                    rates = [conns * timed_n / wire_concurrent(srv.address, 0, OP_K, timed[:conns], nodelay)[1]
                             for _ in range(WIRE_REPS if conns == 1 else WIRE_CONC_REPS)]
                    wire[f"{name}_{conns}{'_nodelay' if nodelay else ''}"] = {
                        "median": statistics.median(rates), "min": min(rates), "max": max(rates),
                        "runs": rates}

    # CUDA events: the kernels on this path's [1, 1024] tiles, steady
    tiles = [torch.from_numpy(np.arange(t * OP_B, (t + 1) * OP_B, dtype=np.int32)[None, :]).to(dev)
             for t in range(9)]
    ustate = plain.init(key_from_seed(0), 1, OP_K, device=dev)
    for t in tiles[:8]:
        ustate = kern.update_cuda(ustate, t)
    u_ms = event_ms(lambda st: kern.update_steady_cuda(st, tiles[8]), setup=lambda: clone(ustate), batch=10)
    _, u_acc = plain.update_accepts(clone(ustate), tiles[8], fill=False)
    u_bound, u_by = bound_ms(u_acc, 0, rows=1, width=OP_B, k=OP_K)
    dtiles = [dplain.split_values(keys[t * OP_B : (t + 1) * OP_B][None, :], device=dev) for t in range(9)]
    dstate = dplain.init(key_from_seed(0), 1, OP_DK, sample_dtype=torch.int64, device=dev)
    full = torch.full((1,), OP_B, dtype=torch.int32, device=dev)  # a DeviceSampler flush passes valid
    for t in dtiles[:8]:
        dstate = dkern.update_cuda(dstate, t, full)
    d_ms = event_ms(lambda st: dkern.update_cuda(st, dtiles[8], full), setup=lambda: clone(dstate), batch=10)
    d_ins, d_rows = net_inserts(dstate, dplain.update(clone(dstate), dtiles[8], full))
    d_bound, d_by = distinct_bound_ms(OP_B, True, d_ins, d_rows, rows=1, k=OP_DK)
    card = card_line()
    for name, rate in host.items():
        log(f"[29 operator timings] {card} | host {name}: {rate:.6e} elem/s")
    log(f"[29 operator timings] {card} | Sample.device({OP_K}) drain of {n}: {device['Sample_device_drain']:.6e} "
        f"elem/s ({drain_s:.3f} s: flushes {flush_s[0]:.3f} s over {n // OP_B} launches, the per-element "
        f"host path {device['host_s']:.3f} s); card DeviceSampler.sample_all of one array "
        f"{device['DeviceSampler_sample_all']:.6e} elem/s")
    log(f"[29 operator timings] {card} | a [1, {OP_B}] host tile's engine.sample (host clock, "
        f"{OP_B} back to back): {device['flush_with_valid_ms']:.4f} ms with valid (as DeviceSampler "
        f"flushes), {device['flush_without_valid_ms']:.4f} ms without")
    for name, rate in wire.items():
        factory_name, conns, *nodelay = name.split("_")
        log(f"[29 operator timings] {card} | wire, {factory_name} factory, {conns} connection(s)"
            f"{', client TCP_NODELAY' if nodelay else ''}: median {rate['median']:.6e} elem/s over "
            f"{len(rate['runs'])} runs ({rate['min']:.6e} to {rate['max']:.6e})")
    log(f"[29 operator timings] {card} | algl_update on a steady [1, {OP_B}] tile (count {8 * OP_B}): "
        f"{u_ms:.4f} ms, bound {u_bound:.3e} ms ({u_by}), accepts {u_acc}; distinct_update_keepmax on a "
        f"steady [1, {OP_B}] int64 Zipf tile (after 8): {d_ms:.4f} ms, bound {d_bound:.3e} ms ({d_by}), net "
        f"inserts {d_ins}; both shorter than their wrappers' host time, so event_ms reads host time")
    line["elem_per_s"] = {"host": host, "device": device, "wire": wire}
    line["tile_1x1024"] = {
        "algl_update": {"ms": u_ms, "bound_ms": u_bound, "bound_by": u_by, "accepts": u_acc},
        "distinct_update_keepmax": {"ms": d_ms, "bound_ms": d_bound, "bound_by": d_by, "net_inserts": d_ins},
        "note": "event_ms reads host time for a call shorter than its wrapper's",
    }
    line["card"] = card
    algl_extra = {"operator_launches": u_launches, "server_launches": w_launches,
                  "operator_tile_1x1024": line["tile_1x1024"]["algl_update"]}
    keepmax_extra = {"operator_launches": d_launches, "server_launches": wd_launches,
                     "operator_tile_1x1024": line["tile_1x1024"]["distinct_update_keepmax"]}
    return line, algl_extra, keepmax_extra


# the serving phases: bench.py's serve shape (2,048 sessions, k = 32, four
# rounds of B = 256 int32 elements a session, coalesce_bytes 1 MiB) and its
# traffic shape (a table of 8,192 rows, k = 8, chunks of 64 in a tile of
# 4 x 64; 8,704 sessions, so 512 evictions recycle rows: a depth cut, see
# the docstring)
SV_S, SV_K, SV_B, SV_ROUNDS = 2048, 32, 256, 4
SV_COALESCE = 1 << 20
TR_R, TR_K, TR_B = 8192, 8, 64
TR_SESSIONS = TR_R + TR_R // 16
# phase 31 (c): sessions closed and reopened between rounds 1 and 2
SV_CHURN = 64
SERVE_MODES = ("plain", "weighted", "distinct")
#: the kernel a bridge's flushes launch in each mode (they pass valid, so
#: a distinct flush takes keep-max)
KERNEL_OF = {"plain": "algl_update", "weighted": "weighted_update", "distinct": "distinct_update_keepmax"}


def serve_config(mode: str):
    from reservoir_tpu_torch import SamplerConfig

    return SamplerConfig(max_sample_size=SV_K, num_reservoirs=SV_S, tile_size=SV_B,
                         weighted=mode == "weighted", distinct=mode == "distinct")


def serve_feed(mode: str) -> tuple:
    """Phase 31 (a)'s chunks ``[round, session, B]`` (and weights) for one
    mode, from numpy seed 31; distinct keys are taken mod 4096, so rows see
    repeats."""
    rng = np.random.default_rng(31 + SERVE_MODES.index(mode))
    chunks = rng.integers(0, 1 << 31, (SV_ROUNDS, SV_S, SV_B), dtype=np.int64).astype(np.int32)
    if mode == "distinct":
        chunks %= 4096
    weights = (rng.uniform(0.1, 2.0, (SV_ROUNDS, SV_S, SV_B)).astype(np.float32)
               if mode == "weighted" else None)
    return chunks, weights


def serve_round(svc, feed, r: int, keys) -> None:
    """Round ``r``: chunk ``j`` of the round to session ``keys[j]``."""
    chunks, weights = feed
    for j, key in enumerate(keys):
        svc.ingest(key, chunks[r, j], None if weights is None else weights[r, j])


def serve_flow(mode: str, device, **kw):
    """Phase 31 (a) for one mode: open 2,048 sessions, four rounds, sync;
    returns the service and every session's snapshot."""
    from reservoir_tpu_torch import ReservoirService

    feed = serve_feed(mode)
    svc = ReservoirService(serve_config(mode), key=1, coalesce_bytes=SV_COALESCE, device=device, **kw)
    keys = [f"u{i}" for i in range(SV_S)]
    for key in keys:
        svc.open_session(key)
    for r in range(SV_ROUNDS):
        serve_round(svc, feed, r, keys)
    svc.sync()
    return svc, [svc.snapshot(key, sync=False) for key in keys]


def traffic_flow(device):
    """Phase 31 (b): 8,704 sessions opened in a seeded order on a table of
    8,192 rows: 8,192 sessions open and take a chunk each, then 512 more
    open, each evicting the least recently used and recycling its row
    through ``reset_rows``, then every live session takes another chunk.
    Returns the service and each live session's snapshot."""
    from reservoir_tpu_torch import ReservoirService, SamplerConfig

    cfg = SamplerConfig(max_sample_size=TR_K, num_reservoirs=TR_R, tile_size=4 * TR_B)
    rng = np.random.default_rng(32)
    order = rng.permutation(TR_SESSIONS)
    data = rng.integers(0, 1 << 31, (2, TR_SESSIONS, TR_B), dtype=np.int64).astype(np.int32)
    svc = ReservoirService(cfg, key=2, coalesce_bytes=SV_COALESCE, device=device)
    for i in order[:TR_R]:
        svc.open_session(f"u{i}")
    for i in order[:TR_R]:
        svc.ingest(f"u{i}", data[0, i])
    for i in order[TR_R:]:
        svc.open_session(f"u{i}")
    for s in svc.table.sessions():
        svc.ingest(s.key, data[1, int(s.key[1:])])
    svc.sync()
    return svc, {s.key: svc.snapshot(s.key, sync=False) for s in svc.table.sessions()}


def serve_cpu_references() -> dict:
    """Phase 31's plain versions: (a) in each mode and (b), with
    ``device="cpu"``.  Run in a child process while the card works."""
    torch.set_num_threads(4)
    out = {}
    for mode in SERVE_MODES:
        svc, snaps = serve_flow(mode, "cpu")
        out[mode] = (snaps, svc.metrics.snapshot())
    svc, snaps = traffic_flow("cpu")
    out["traffic"] = (snaps, svc.metrics.snapshot(), svc.bridge.engine.reset_epochs)
    return out


def same_snapshots(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x.view(np.uint8), y.view(np.uint8))
        for x, y in zip(a, b))


def same_all(a, b) -> bool:
    """Every field of two states (keys included) bit for bit."""
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        if x is not None and not torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)):
            return False
    return True


def state_rows(state, rows: torch.Tensor):
    return type(state)(*(None if t is None else t.index_select(0, rows) for t in state))


def last_positions(rows: np.ndarray) -> tuple:
    """``(unique rows, the position of each one's last occurrence)``."""
    uniq, first_rev = np.unique(rows[::-1], return_index=True)
    return uniq, rows.size - 1 - first_rev


def row_ops_mode(mode: str, gen, dev) -> dict:
    """Phase 30 for one mode at its configuration: the row operations on
    the card against an engine that never reset and a ``device="cpu"``
    engine."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted as wplain
    from reservoir_tpu_torch.ops import weighted_cuda as wkern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    rows_n, k, width = {"plain": (R, K, B), "weighted": (WR, WK, WB), "distinct": (DR, DK, DB)}[mode]
    n_reset = 4096 if mode == "plain" else rows_n // 4
    cfg = rtt.SamplerConfig(max_sample_size=k, num_reservoirs=rows_n, tile_size=width,
                            weighted=mode == "weighted", distinct=mode == "distinct")
    counter = {"plain": kern, "weighted": wkern, "distinct": dkern}[mode]
    ops = {"plain": plain, "weighted": wplain, "distinct": dplain}[mode]

    def tile_pair():
        if mode == "distinct":
            return zipf_keys(gen, rows_n, width, torch.int32, dev), None
        t = torch.randint(-(2**31), 2**31 - 1, (rows_n, width), dtype=torch.int32, device=dev, generator=gen)
        return t, (weight_tile(gen, rows_n, width, "lognormal", dev) if mode == "weighted" else None)

    def feed(eng, t, w):
        if w is None:
            eng.sample(t)
        else:
            eng.sample(t, weights=w)

    torch.cuda.synchronize()
    counter.launches = 0
    eng1, eng2, ref = (rtt.ReservoirEngine(cfg, key=0, reusable=True) for _ in range(3))
    for _ in range(4):
        t, w = tile_pair()
        for eng in (eng1, eng2, ref):
            feed(eng, t, w)
    rng = np.random.default_rng(30 + SERVE_MODES.index(mode))
    perm = rng.permutation(rows_n)
    reset = perm[: n_reset - 1].astype(np.int32)
    reset = np.insert(reset, n_reset // 2, reset[7])  # row reset[7] twice: its last occurrence wins
    src, dst = perm[:1024], rng.permutation(rows_n)[:1024]
    before = counter.launches
    eng1.reset_rows(reset, 123)
    part = eng1.export_rows(src)
    eng2.adopt_rows(dst, part)
    torch.cuda.synchronize()
    if counter.launches != before:
        fail(f"[30 rows] {mode}: a row operation launched the update kernel")
    if (eng1.reset_epochs, eng2.reset_epochs, eng1._min_count, eng2._min_count) != (1, 1, 0, 0):
        fail(f"[30 rows] {mode}: reset_epochs or the fill bound were not updated")
    # the reset rows equal the plain init on the CPU (compiled, as the
    # reference's reset), the last occurrence of the repeated row winning
    uniq, last = last_positions(reset)
    extra = {"compiled": True} if mode == "plain" else {}
    want = ops.init(key_from_seed(123), reset.size, k, sample_dtype=eng1._dtype, device="cpu", **extra)
    want = state_rows(want, torch.from_numpy(last))
    uniq_d = torch.from_numpy(uniq.astype(np.int64)).to(dev)
    if not same_all(state_rows(eng1._state, uniq_d), type(want)(*(None if t is None else t.to(dev)
                                                                   for t in want))):
        fail(f"[30 rows] {mode}: the reset rows differ from the plain init on the CPU")
    # 4 more tiles; eng2's rows dst take what eng1's rows src take
    n_cpu = min(ROWS_CPU, uniq.size)
    sub = torch.from_numpy(uniq[:n_cpu].astype(np.int64))
    cpu_cfg = rtt.SamplerConfig(max_sample_size=k, num_reservoirs=n_cpu, tile_size=width,
                                weighted=mode == "weighted", distinct=mode == "distinct")
    cpu = rtt.ReservoirEngine(cpu_cfg, reusable=True, device="cpu",
                              _initial_state=state_rows(want, torch.arange(n_cpu)))
    src_d = torch.from_numpy(src.astype(np.int64)).to(dev)
    dst_d = torch.from_numpy(dst.astype(np.int64)).to(dev)
    for _ in range(4):
        t, w = tile_pair()
        feed(eng1, t, w)
        feed(ref, t, w)
        t2 = t.clone()
        t2[dst_d] = t[src_d]
        w2 = None
        if w is not None:
            w2 = w.clone()
            w2[dst_d] = w[src_d]
        feed(eng2, t2, w2)
        feed(cpu, t[sub.to(dev)].cpu(), None if w is None else w[sub.to(dev)].cpu())
    torch.cuda.synchronize()
    launches = counter.launches
    if launches != 3 * 8:
        fail(f"[30 rows] {mode}: {launches} update launches for 24 tiles")
    keep1 = torch.ones(rows_n, dtype=torch.bool, device=dev)
    keep1[uniq_d] = False
    keep2 = torch.ones(rows_n, dtype=torch.bool, device=dev)
    keep2[dst_d] = False
    idx1, idx2 = keep1.nonzero().squeeze(1), keep2.nonzero().squeeze(1)
    if not same_all(state_rows(eng1._state, idx1), state_rows(ref._state, idx1)):
        fail(f"[30 rows] {mode}: rows the reset did not touch differ from an engine that never reset")
    if not same_all(state_rows(eng2._state, idx2), state_rows(ref._state, idx2)):
        fail(f"[30 rows] {mode}: rows the adoption did not touch differ from an engine that never adopted")
    if not same_all(state_rows(eng2._state, dst_d), state_rows(eng1._state, src_d)):
        fail(f"[30 rows] {mode}: the adopted rows did not continue as their source rows")
    got_cpu = type(cpu._state)(*(None if t is None else t.cpu() for t in state_rows(eng1._state, sub.to(dev))))
    if not same_all(got_cpu, cpu._state):
        fail(f"[30 rows] {mode}: {n_cpu} reset rows differ from the CPU engine")
    log(f"[30 rows] {mode} R={rows_n} k={k} B={width}: reset_rows of {reset.size} rows (one twice) equals the "
        f"compiled plain init; 8 tiles, 3 engines: {launches} update launches (none for a row operation); "
        f"untouched rows == an engine that never reset, {n_cpu} reset rows == device='cpu' over 4 tiles, "
        f"export_rows/adopt_rows of 1024 rows continue as the source")
    return {"rows_reset": int(reset.size), "rows_adopted": 1024, "launches": launches}


def compiled_init_case(gen, dev) -> dict:
    """Phase 30's uniform case at k = 6: the reset rows' log_w equal the
    compiled plain init (fma with 1/k), and the eager init would differ."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops.rng import key_from_seed

    k = 6
    eng = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=k, num_reservoirs=R, tile_size=B), key=0,
                              reusable=True)
    eng.sample(torch.randint(0, 2**31 - 1, (R, B), dtype=torch.int32, device=dev, generator=gen))
    rng = np.random.default_rng(36)
    reset = rng.permutation(R)[:4096].astype(np.int32)
    reset[-1] = reset[0]
    eng.reset_rows(reset, 123)
    uniq, last = last_positions(reset)
    got = eng._state.log_w[torch.from_numpy(uniq.astype(np.int64)).to(dev)].cpu()
    lastt = torch.from_numpy(last)
    compiled = plain.init(key_from_seed(123), reset.size, k, compiled=True).log_w[lastt]
    eager = plain.init(key_from_seed(123), reset.size, k).log_w[lastt]
    if not torch.equal(bits(got), bits(compiled)):
        fail("[30 rows] k=6: the reset's log_w differs from the compiled plain init")
    differ = int((bits(eager) != bits(compiled)).sum())
    log(f"[30 rows] plain k={k}: the reset's log_w of {uniq.size} rows equals the compiled init "
        f"(fma with 1/k); the eager init would differ in {differ} of them")
    return {"k": k, "rows": int(uniq.size), "eager_init_would_differ": differ}


def serve_phases(gen, dev, here: str) -> tuple:
    """Phases 30-32, row operations and the serving plane; returns the
    ``serve`` line and each update kernel's launches on the serving path."""
    import concurrent.futures
    import multiprocessing

    from reservoir_tpu_torch import ReservoirService
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern

    line = {"rows": {}, "service": {}}
    counts = {"plain": lambda: kern.launches, "weighted": lambda: wkern.launches,
              "distinct": lambda: dkern.keepmax_launches}
    # the plain versions of phase 31 run in a child process on the CPU
    # while the card works
    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_future = pool.submit(serve_cpu_references)

        # 30. row operations on the card
        for mode in SERVE_MODES:
            line["rows"][mode] = row_ops_mode(mode, gen, dev)
        line["rows"]["plain_k6"] = compiled_init_case(gen, dev)
        gc.collect()
        torch.cuda.empty_cache()

        # 31. the service on the card: (a) bench.py's serve shape
        card = {}
        serve_launches = {}
        for mode in SERVE_MODES:
            torch.cuda.synchronize()
            kern.launches = wkern.launches = kern.gated_launches = 0
            dkern.launches = dkern.keepmax_launches = dkern.prehashed_launches = 0
            svc, snaps = serve_flow(mode, None)
            torch.cuda.synchronize()
            n = counts[mode]()
            others = (sum(c() for m, c in counts.items() if m != mode) + kern.gated_launches + dkern.launches
                      + dkern.prehashed_launches)
            flushes = svc.bridge.metrics.flushes
            if n != flushes or others:
                fail(f"[31 service] (a) {mode}: {n} update launches for {flushes} flushes ({others} others)")
            card[mode] = (svc, snaps)
            serve_launches[mode] = n
            log(f"[31 service] (a) {mode}: {SV_S} sessions x {SV_ROUNDS} rounds of {SV_B}: {flushes} flushes, "
                f"{n} {KERNEL_OF[mode]} launches")
        # (d) the same feed through the gate
        torch.cuda.synchronize()
        kern.launches = kern.gated_launches = 0
        gsvc, gsnaps = serve_flow("plain", None, gated=True)
        torch.cuda.synchronize()
        m = gsvc.bridge.metrics
        if not gsvc.bridge.gate_active or not same_snapshots(gsnaps, card["plain"][1]):
            fail("[31 service] (d) the gated service's snapshots differ from the ungated one's")
        if kern.gated_launches != m.gated_dispatches or kern.launches != m.flushes - m.gated_dispatches:
            fail(f"[31 service] (d) {kern.gated_launches} gated and {kern.launches} ungated launches for "
                 f"{m.gated_dispatches} gated dispatches in {m.flushes} flushes")
        gated_launches = (kern.gated_launches, kern.launches)
        log(f"[31 service] (d) gated: every snapshot equals the ungated service's; {kern.gated_launches} "
            f"algl_update_gated and {kern.launches} algl_update launches ({m.flushes} flushes)")
        del gsvc, gsnaps
        # (b) recycling at bench.py's traffic shape
        torch.cuda.synchronize()
        kern.launches = 0
        t0 = time.perf_counter()
        tsvc, tsnaps = traffic_flow(None)
        torch.cuda.synchronize()
        traffic_s = time.perf_counter() - t0
        tm = tsvc.metrics
        if tm.recycles != TR_SESSIONS - TR_R or tsvc.bridge.engine.reset_epochs != tm.recycles:
            fail(f"[31 service] (b) {tm.recycles} recycles, {tsvc.bridge.engine.reset_epochs} resets")
        if kern.launches != tsvc.bridge.metrics.flushes:
            fail(f"[31 service] (b) {kern.launches} launches for {tsvc.bridge.metrics.flushes} flushes")
        traffic_launches = kern.launches
        log(f"[31 service] (b) traffic: {TR_SESSIONS} sessions on {TR_R} rows, {tm.recycles} recycles through "
            f"reset_rows, {tsvc.bridge.metrics.flushes} flushes, {kern.launches} algl_update launches, "
            f"{traffic_s:.1f} s")
        # (c) a checkpointing service killed after round 3, recovered
        work = os.path.join(here, "build", "chip_smoke", "serve")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        feed = serve_feed("plain")
        keys0 = [f"u{i}" for i in range(SV_S)]
        keys1 = keys0[SV_CHURN:] + [f"w{i}" for i in range(SV_CHURN)]
        services = [ReservoirService(serve_config("plain"), key=1, coalesce_bytes=SV_COALESCE, **kw)
                    for kw in ({}, {"checkpoint_dir": work})]
        for svc in services:
            for key in keys0:
                svc.open_session(key)
            serve_round(svc, feed, 0, keys0)
            serve_round(svc, feed, 1, keys0)
            for key in keys0[:SV_CHURN]:
                svc.close_session(key)
            for key in keys1[-SV_CHURN:]:
                svc.open_session(key)  # recycles: resets between journaled flushes
            serve_round(svc, feed, 2, keys1)
            svc.sync()
        live, dead = services
        seq = dead.flushed_seq
        del services, dead, svc
        gc.collect()
        torch.cuda.synchronize()
        kern.launches = 0
        t0 = time.perf_counter()
        rec = ReservoirService.recover(work)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        replay_launches = kern.launches
        if rec.flushed_seq != seq or rec.bridge.engine.reset_epochs != SV_CHURN:
            fail(f"[31 service] (c) recovered at seq {rec.flushed_seq} (want {seq}) with "
                 f"{rec.bridge.engine.reset_epochs} resets replayed")
        for svc in (live, rec):
            serve_round(svc, feed, 3, keys1)
            svc.sync()
        if not same_snapshots([rec.snapshot(key) for key in keys1], [live.snapshot(key) for key in keys1]):
            fail("[31 service] (c) the recovered service's snapshots differ from the live service's")
        log(f"[31 service] (c) recovery: killed at seq {seq} after round 3 ({SV_CHURN} recycles since the "
            f"checkpoint), recovered in {recover_s:.2f} s ({replay_launches} algl_update launches replayed, "
            f"{SV_CHURN} resets re-applied between them); after round 4 every snapshot equals the live service's")
        shutil.rmtree(work, ignore_errors=True)
        del live, rec

        # the plain versions on the CPU
        t0 = time.perf_counter()
        refs = cpu_future.result(timeout=900)
        wait_s = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for mode in SERVE_MODES:
        svc, snaps = card[mode]
        want, metrics = refs[mode]
        if not same_snapshots(snaps, want) or metrics != svc.metrics.snapshot():
            fail(f"[31 service] (a) {mode}: the card's snapshots or metrics differ from device='cpu'")
    want, metrics, resets = refs["traffic"]
    if (sorted(want) != sorted(tsnaps) or not same_snapshots([tsnaps[k] for k in sorted(want)],
                                                            [want[k] for k in sorted(want)])
            or metrics != tsvc.metrics.snapshot() or resets != tsvc.bridge.engine.reset_epochs):
        fail("[31 service] (b) the card's snapshots or metrics differ from device='cpu'")
    log(f"[31 service] (a), (b): every snapshot ({3 * SV_S} + {TR_R}) and every counter equal the "
        f"device='cpu' services' (the CPU references ran beside the card; {wait_s:.1f} s waited for them)")
    line["service"] = {
        "serve_shape": {"sessions": SV_S, "k": SV_K, "B": SV_B, "rounds": SV_ROUNDS,
                        "coalesce_bytes": SV_COALESCE, "launches": serve_launches,
                        "flushes": {m: card[m][0].bridge.metrics.flushes for m in SERVE_MODES},
                        "gated_launches": {"algl_update_gated": gated_launches[0],
                                           "algl_update": gated_launches[1]}},
        "traffic_shape": {"rows": TR_R, "k": TR_K, "tile": 4 * TR_B, "sessions": TR_SESSIONS,
                          "recycles": tm.recycles, "launches": traffic_launches, "seconds": traffic_s},
        "recovery": {"seq": seq, "replay_launches": replay_launches, "seconds": recover_s},
    }
    del card, tsvc, tsnaps, refs
    gc.collect()

    # 32. timings
    line["timings"] = serve_timings(dev)
    line["card"] = card_line()
    launches = {
        "algl_update": serve_launches["plain"] + traffic_launches + replay_launches + gated_launches[1],
        "weighted_update": serve_launches["weighted"],
        "distinct_update_keepmax": serve_launches["distinct"],
        "algl_update_gated": gated_launches[0],
    }
    return line, launches


def serve_timings(dev) -> dict:
    """Phase 32: the service's lifecycle at bench.py's serve shape, its
    latency quantiles from the registry, its flushes beside their
    ``engine.sample``, and the row operations, on the host clock after
    ``torch.cuda.synchronize()``."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch import ReservoirService
    from reservoir_tpu_torch.obs import registry as obs

    cfg = serve_config("plain")
    chunks = serve_feed("plain")[0]
    keys = [f"u{i}" for i in range(SV_S)]
    sample_s = [0.0, 0]

    def one_pass(r: int, timed: bool):
        svc = ReservoirService(cfg, key=r, coalesce_bytes=SV_COALESCE)
        if timed:
            eng = svc.bridge.engine
            inner = eng.sample

            def sample(*a, **kw):
                t0 = time.perf_counter()
                inner(*a, **kw)
                sample_s[0] += time.perf_counter() - t0
                sample_s[1] += 1

            eng.sample = sample
        for key in keys:
            svc.open_session(key)
        for s in range(SV_ROUNDS):
            for i, key in enumerate(keys):
                svc.ingest(key, chunks[s][i])
        svc.sync()
        for key in keys:
            svc.snapshot(key, sync=False)
        for key in keys:
            svc.close_session(key)
        torch.cuda.synchronize()
        return svc

    one_pass(0, False)  # warm
    reg = obs.enable(obs.Registry())
    try:
        times, flush_s, flushes = [], 0.0, 0
        for r in range(1, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc = one_pass(r, True)
            times.append(time.perf_counter() - t0)
            flush_s += svc.bridge.metrics.dispatch_s
            flushes += svc.bridge.metrics.flushes
        snap = reg.histogram("serve.snapshot_s").percentiles()
        ingest = reg.histogram("serve.ingest_s").percentiles()
    finally:
        obs.disable()
    out = {
        "sessions_per_s": SV_S / min(times),
        "lifecycle_s": times,
        "snapshot_p50_ms": snap[0] * 1e3, "snapshot_p99_ms": snap[1] * 1e3,
        "ingest_p50_ms": ingest[0] * 1e3, "ingest_p99_ms": ingest[1] * 1e3,
        "flush_host_ms": 1e3 * flush_s / flushes, "flush_engine_sample_ms": 1e3 * sample_s[0] / sample_s[1],
        "flushes": flushes,
    }
    card = card_line()
    log(f"[32 serve timings] {card} | lifecycle of {SV_S} sessions (open, {SV_ROUNDS} rounds of {SV_B}, sync, "
        f"snapshot, close), best of 3: {out['sessions_per_s']:.6e} sessions/s; snapshot p50 "
        f"{out['snapshot_p50_ms']:.4f} ms p99 {out['snapshot_p99_ms']:.4f} ms; ingest p50 "
        f"{out['ingest_p50_ms']:.4f} ms p99 {out['ingest_p99_ms']:.4f} ms (registry histograms)")
    log(f"[32 serve timings] {card} | a flush of the service ([{SV_S}, {SV_B}] tile): {out['flush_host_ms']:.4f} ms "
        f"host (dispatch) over {flushes} flushes, of which engine.sample {out['flush_engine_sample_ms']:.4f} ms")
    # the row operations at the uniform configuration
    eng = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B), key=0,
                              reusable=True)
    eng.sample(torch.randint(0, 2**31 - 1, (R, B), dtype=torch.int32, device=dev))
    rng = np.random.default_rng(37)
    rows_ms = {}

    def host_ms(fn, reps: int = 7) -> float:
        ts = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts[1:])

    for n in (1, 64, 4096):
        rows = rng.permutation(R)[:n]
        rows_ms[f"reset_rows_{n}"] = host_ms(lambda: eng.reset_rows(rows, 5))
    rows, dst = rng.permutation(R)[:1024], rng.permutation(R)[:1024]
    part = eng.export_rows(rows)
    rows_ms["export_rows_1024"] = host_ms(lambda: eng.export_rows(rows))
    rows_ms["adopt_rows_1024"] = host_ms(lambda: eng.adopt_rows(dst, part))
    out["rows_ms"] = rows_ms
    log(f"[32 serve timings] {card} | R={R} k={K}: reset_rows of 1 / 64 / 4096 rows "
        f"{rows_ms['reset_rows_1']:.4f} / {rows_ms['reset_rows_64']:.4f} / {rows_ms['reset_rows_4096']:.4f} ms; "
        f"export_rows of 1024 {rows_ms['export_rows_1024']:.4f} ms, adopt_rows of 1024 "
        f"{rows_ms['adopt_rows_1024']:.4f} ms (host clock, synchronized, median of 7)")
    return out



# the HA and cluster phases: bench.py's ha shape (1,024 sessions, k = 32,
# B = 256, four rounds, coalesce_bytes 1 MiB, checkpoint_every 2^30) and its
# shards / merge shape (4 shards of 512 rows each on the one card, k = 32,
# B = 256, 1,024 sessions, four rounds, a standby a shard)
HA_S, HA_K, HA_B, HA_ROUNDS = 1024, 32, 256, 4
HA_MODES = ("plain", "weighted", "distinct", "gated")
HA_CKPT_EVERY = 1 << 30
CL_SHARDS, CL_R, CL_SESSIONS = 4, 512, 1024
CL_GROUPS, CL_GROUP, CL_MIGRATIONS, CL_VICTIM = 8, 8, 24, 3
UPDATE_KERNELS = ("algl_update", "algl_update_gated", "weighted_update", "distinct_update",
                  "distinct_update_keepmax", "distinct_update_prehashed")


def update_launches() -> dict:
    """The update kernels' launch counts (all 0 for the plain versions)."""
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern

    return {"algl_update": kern.launches, "algl_update_gated": kern.gated_launches,
            "weighted_update": wkern.launches, "distinct_update": dkern.launches,
            "distinct_update_keepmax": dkern.keepmax_launches, "distinct_update_prehashed": dkern.prehashed_launches}


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def tree_levels(n: int) -> int:
    """The levels of the merge tree over ``n`` parts (a batched pairwise
    merge each, so one ``algl_merge_draws`` launch each)."""
    levels = 0
    while n > 1:
        n = n // 2 + n % 2
        levels += 1
    return levels


def ha_feed(mode: str) -> tuple:
    """Phase 33's chunks ``[round, session, B]`` (and weights), five rounds
    (the fifth for the promoted primary), from numpy seed 33; distinct keys
    mod 4096."""
    rng = np.random.default_rng(33 + HA_MODES.index(mode))
    chunks = rng.integers(0, 1 << 31, (HA_ROUNDS + 1, HA_S, HA_B), dtype=np.int64).astype(np.int32)
    if mode == "distinct":
        chunks %= 4096
    weights = (rng.uniform(0.1, 2.0, (HA_ROUNDS + 1, HA_S, HA_B)).astype(np.float32)
               if mode == "weighted" else None)
    return chunks, weights


def ha_flow(mode: str, device, work: str) -> dict:
    """Phase 33 for one mode: a checkpointing primary at bench.py's ha
    shape and a ``StandbyReplica`` polling after every round, bit for bit
    equal to it after each poll, with one update launch a flush; then the
    primary is shut down, a ``FailoverController`` under an injected clock
    promotes on the stale heartbeat, the old primary's durable writes raise
    ``FencedError`` with its journal unchanged, and the promoted primary
    takes a fifth round.  Returns the primary's state after each round and
    every session's snapshot after the fifth."""
    from reservoir_tpu_torch import SamplerConfig
    from reservoir_tpu_torch.errors import FencedError
    from reservoir_tpu_torch.serve import FailoverController, HeartbeatWriter, ReservoirService, StandbyReplica

    cfg = SamplerConfig(max_sample_size=HA_K, num_reservoirs=HA_S, tile_size=HA_B,
                        weighted=mode == "weighted", distinct=mode == "distinct")
    feed = ha_feed(mode)
    ck = os.path.join(work, mode)
    shutil.rmtree(ck, ignore_errors=True)
    svc = ReservoirService(cfg, key=3, checkpoint_dir=ck, checkpoint_every=HA_CKPT_EVERY,
                           coalesce_bytes=SV_COALESCE, gated=mode == "gated", device=device)
    keys = [f"u{i}" for i in range(HA_S)]
    for key in keys:
        svc.open_session(key)
    svc.sync()
    standby = StandbyReplica(ck, device=device)
    clock = [1000.0]
    beacon = HeartbeatWriter(ck, service=svc, clock=lambda: clock[0])
    ctl = FailoverController(standby, heartbeat_timeout_s=5.0, clock=lambda: clock[0])
    out = {"rounds": [], "standby_launches": dict.fromkeys(UPDATE_KERNELS, 0), "backlog_seq": [],
           "catch_up_s": []}
    for r in range(HA_ROUNDS):
        serve_round(svc, feed, r, keys)
        svc.sync()
        beacon.beat()
        # the lag this lockstep loop can show: the flushes the standby has
        # yet to apply when its poll starts, and how long the poll takes to
        # apply them (its launches synchronised)
        out["backlog_seq"].append(svc.flushed_seq - standby.applied_seq)
        before = update_launches()
        t0 = time.perf_counter()
        standby.poll()
        if device is None:
            torch.cuda.synchronize()
        out["catch_up_s"].append(time.perf_counter() - t0)
        for k, n in launch_delta(before, update_launches()).items():
            out["standby_launches"][k] += n
        standby.lag()  # 0 here by construction: it counts records seen but not applied
        prim = svc.bridge.engine.peek_arrays()
        stb = standby.service.bridge.engine.peek_arrays()
        if standby.applied_seq != svc.flushed_seq or not same_snapshots(prim, stb):
            fail(f"[33 ha] {mode}: after round {r + 1} the standby (seq {standby.applied_seq}) differs from "
                 f"its primary (seq {svc.flushed_seq})")
        out["rounds"].append(prim)
    m = svc.bridge.metrics
    out["flushes"], out["gated_dispatches"] = m.flushes, m.gated_dispatches
    if not ctl.health().healthy:
        fail(f"[33 ha] {mode}: the controller judged a beating primary unhealthy")
    svc.shutdown()
    clock[0] += 10.0
    report = ctl.health()
    if not report.should_promote or report.triggers != ["staleness"]:
        fail(f"[33 ha] {mode}: a stale heartbeat gave {report}")
    promoted = ctl.maybe_promote()
    if promoted is None or standby.metrics.promotions != 1:
        fail(f"[33 ha] {mode}: the controller did not promote")
    journal = os.path.join(ck, "journal.bin")
    journal_before = open(journal, "rb").read()
    if mode != "gated":  # (a gated zombie may elide the chunk: nothing to write)
        try:
            svc.ingest(keys[0], feed[0][0, 0], None if feed[1] is None else feed[1][0, 0])
            svc.sync()
            fail(f"[33 ha] {mode}: the old primary's flush was not fenced")
        except FencedError:
            pass
    try:
        svc.bridge._save_snapshot()
        fail(f"[33 ha] {mode}: the old primary's checkpoint was not fenced")
    except FencedError:
        pass
    if open(journal, "rb").read() != journal_before:
        fail(f"[33 ha] {mode}: the fenced primary changed the journal")
    serve_round(promoted, feed, HA_ROUNDS, keys)
    promoted.sync()
    out["final"] = [promoted.snapshot(key, sync=False) for key in keys]
    out["promoted_seq"] = promoted.flushed_seq
    promoted.shutdown()
    shutil.rmtree(ck, ignore_errors=True)
    return out


def cluster_flow(device, work: str, card: bool = False) -> dict:
    """Phase 34: a ``ShardedReservoirService`` at bench.py's shards / merge
    shape with a standby a shard: four rounds (each shard's ingest timed
    alone), the merged snapshots of eight groups of eight keys (the host
    tree against the default, and on the card ``"cuda"``, with their
    launch counts), 24 migrations with no stale read, ``kill_shard(3)`` and
    ``promote_shard(3)`` with shards 0-2 serving throughout, a sixth round,
    and ``ShardedReservoirService.recover`` of the directory.  Returns what
    the ``device="cpu"`` run must equal."""
    from reservoir_tpu_torch import SamplerConfig
    from reservoir_tpu_torch.errors import FencedError, ShardUnavailable
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.serve import ShardedReservoirService

    cfg = SamplerConfig(max_sample_size=HA_K, num_reservoirs=CL_R, tile_size=HA_B)
    devices = None if device is None else [device] * CL_SHARDS
    rng = np.random.default_rng(34)
    keys = [f"u{i}" for i in range(CL_SESSIONS)]
    chunks = rng.integers(0, 1 << 31, (HA_ROUNDS + 2, CL_SESSIONS, HA_B), dtype=np.int64).astype(np.int32)
    groups = [[keys[int(j)] for j in rng.integers(0, CL_SESSIONS, CL_GROUP)] for _ in range(CL_GROUPS)]
    movers = [keys[int(j)] for j in rng.permutation(CL_SESSIONS)[:CL_MIGRATIONS]]
    cl_dir = os.path.join(work, "cluster")
    shutil.rmtree(cl_dir, ignore_errors=True)
    cl = ShardedReservoirService(cfg, CL_SHARDS, cl_dir, key=5, checkpoint_every=HA_CKPT_EVERY,
                                 coalesce_bytes=SV_COALESCE, devices=devices)
    out = {}
    for key in keys:
        cl.open_session(key)
    cl.sync()
    # each shard's own ingest (its keys in order, then its sync) timed
    # alone; the standbys poll after every round
    own = {u.shard_id: [(i, key) for i, key in enumerate(keys) if cl.shard_of(key) == u.shard_id]
           for u in cl.units}
    shard_s = dict.fromkeys(own, 0.0)
    before = update_launches()
    t0 = time.perf_counter()
    for r in range(HA_ROUNDS):
        for u in cl.units:
            ts = time.perf_counter()
            for i, key in own[u.shard_id]:
                cl.ingest(key, chunks[r, i])
            u.service.sync()
            if card:
                torch.cuda.synchronize()
            shard_s[u.shard_id] += time.perf_counter() - ts
        cl.sync()
        cl.poll()
    wall = time.perf_counter() - t0
    flushes = sum(u.service.bridge.metrics.flushes for u in cl.units)
    applied = sum(u.standby.metrics.applied_tiles for u in cl.units)
    launched = launch_delta(before, update_launches())
    if card and (launched["algl_update"] != flushes + applied or sum(launched.values()) != launched["algl_update"]):
        fail(f"[34 cluster] {launched} update launches for {flushes} primary flushes and {applied} standby tiles")
    out["round_launches"] = {"algl_update": launched["algl_update"], "primary_flushes": flushes,
                             "standby_tiles": applied}
    out["per_shard_elem_per_s"] = {str(u.shard_id): u.service.metrics.ingested_elements / shard_s[u.shard_id]
                                   for u in cl.units}
    out["cluster_elem_per_s"] = sum(u.service.metrics.ingested_elements for u in cl.units) / wall
    out["shard_sessions"] = {str(u.shard_id): len(u.table) for u in cl.units}
    # merged snapshots: the default over the shards' devices as ranks (the
    # kernels on the card), "cuda" (the same, card ranks only) and the
    # plain "host" tree, all equal
    merged = []
    ring0, draws0 = mkern.launches, kern.merge_launches
    for g in groups:
        host = cl.merged_snapshot(g, merge_key=7, device="host")
        for impl in (None, "cuda") if card else (None,):
            if not same_snapshots([host], [cl.merged_snapshot(g, merge_key=7, device=impl)]):
                fail(f"[34 cluster] merged_snapshot(device={impl!r}) differs from the host merge for {g}")
        merged.append(host)
    out["merged"] = merged
    out["merge_launches"] = {"merge_ring_gather": mkern.launches - ring0,
                             "algl_merge_draws": kern.merge_launches - draws0}
    want = {"merge_ring_gather": 2 * CL_GROUPS, "algl_merge_draws": 2 * CL_GROUPS * tree_levels(CL_GROUP)}
    if card and out["merge_launches"] != want:
        fail(f"[34 cluster] merge launches {out['merge_launches']}, want {want}")
    # live migrations: the synced snapshot before a move is the first read
    # after it, the destination holds the lease, the source refuses it
    moved = {}
    for i, key in enumerate(movers):
        before_move = cl.snapshot(key)
        src = cl.shard_of(key)
        dst = (src + 1 + i % (CL_SHARDS - 1)) % CL_SHARDS
        cl.migrate(key, dst)
        after = cl.snapshot(key)
        if cl.shard_of(key) != dst or key in cl.unit(src).table or not same_snapshots([before_move], [after]):
            fail(f"[34 cluster] a stale read or a lost lease migrating {key} from shard {src} to {dst}")
        moved[key] = after
    out["moved"] = moved
    # kill shard 3: the others keep serving; its standby takes over
    cl.sync()
    cl.poll()
    snaps = {key: cl.snapshot(key) for key in keys}
    zombie = cl.kill_shard(CL_VICTIM)
    victims = [k for k in keys if cl.shard_of(k) == CL_VICTIM]
    others = [k for k in keys if cl.shard_of(k) != CL_VICTIM]
    for key in victims[:8]:
        try:
            cl.ingest(key, chunks[HA_ROUNDS, 0])
            fail(f"[34 cluster] {key} on the killed shard took an ingest")
        except ShardUnavailable:
            pass
    for key in others:
        cl.ingest(key, chunks[HA_ROUNDS, keys.index(key)])
    if sorted(cl.sync()) != [u for u in range(CL_SHARDS) if u != CL_VICTIM]:
        fail("[34 cluster] the live shards did not all sync while shard 3 was down")
    during = {key: cl.snapshot(key) for key in others}
    cl.promote_shard(CL_VICTIM, reason="chip smoke kill")
    try:
        zombie.bridge._save_snapshot()
        fail("[34 cluster] the killed primary's checkpoint was not fenced")
    except FencedError:
        pass
    if not same_snapshots([cl.snapshot(k) for k in victims], [snaps[k] for k in victims]):
        fail("[34 cluster] shard 3's sessions read differently after the promotion")
    out["during_kill"] = during
    for i, key in enumerate(keys):
        cl.ingest(key, chunks[HA_ROUNDS + 1, i])
    cl.sync()
    cl.poll()
    final = {key: cl.snapshot(key) for key in keys}
    out["final"] = final
    out["victims"] = len(victims)
    cl.shutdown()
    del zombie
    rec = ShardedReservoirService.recover(cl_dir, devices=devices)
    if not same_snapshots([rec.snapshot(k) for k in keys], [final[k] for k in keys]):
        fail("[34 cluster] the recovered cluster's snapshots differ")
    rec.shutdown()
    del rec, cl
    shutil.rmtree(cl_dir, ignore_errors=True)
    return out


def ha_cpu_reference(part: str, work: str) -> dict:
    """One part of phases 33 and 34 with ``device="cpu"``: a mode of phase
    33, or ``"cluster"``.  Run in child processes while the card works."""
    torch.set_num_threads(2)
    return cluster_flow("cpu", work) if part == "cluster" else ha_flow(part, "cpu", work)


def ha_phases(here: str) -> tuple:
    """Phases 33-35, hot standby, failover and the cluster on the card;
    returns the ``ha`` line and each kernel's launches on this path."""
    import concurrent.futures
    import multiprocessing

    from reservoir_tpu_torch.obs import registry as obs
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern

    work = os.path.join(here, "build", "chip_smoke", "ha")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    line = {"ha": {}, "cluster": {}}
    reg = obs.enable(obs.Registry())
    try:
        torch.cuda.synchronize()
        kern.launches = kern.gated_launches = kern.merge_launches = 0
        wkern.launches = dkern.launches = dkern.keepmax_launches = dkern.prehashed_launches = mkern.launches = 0
        # 33. hot standby and failover on the card
        card = {}
        for mode in HA_MODES:
            t0 = time.perf_counter()
            res = ha_flow(mode, None, os.path.join(work, "card"))
            torch.cuda.synchronize()
            sl = res["standby_launches"]
            kernel = "algl_update" if mode == "gated" else KERNEL_OF[mode]
            want = {k: 0 for k in UPDATE_KERNELS}
            if mode == "gated":
                want["algl_update_gated"] = res["gated_dispatches"]
                want["algl_update"] = res["flushes"] - res["gated_dispatches"]
            else:
                want[kernel] = res["flushes"]
            if sl != want or sum(sl.values()) != res["flushes"]:
                fail(f"[33 ha] {mode}: the standby launched {sl} for the primary's {res['flushes']} "
                     f"flushes ({res['gated_dispatches']} gated)")
            card[mode] = res
            log(f"[33 ha] {mode}: {HA_S} sessions x {HA_ROUNDS} rounds of {HA_B}, the standby equal to "
                f"its primary after every poll; standby launches {sl} = the primary's {res['flushes']} "
                f"flushes; stale heartbeat -> promoted, the old primary fenced (journal unchanged), "
                f"a fifth round on the promoted primary (seq {res['promoted_seq']}); "
                f"{time.perf_counter() - t0:.1f} s")
        ha_counts = update_launches()
        # 34. the cluster on the card
        t0 = time.perf_counter()
        cres = cluster_flow(None, os.path.join(work, "card"), card=True)
        torch.cuda.synchronize()
        launches = update_launches()
        launches["merge_ring_gather"] = mkern.launches
        launches["algl_merge_draws"] = kern.merge_launches
        log(f"[34 cluster] {CL_SHARDS} shards x {CL_R} rows on the card, {CL_SESSIONS} sessions "
            f"({cres['shard_sessions']}), {HA_ROUNDS} rounds: {cres['round_launches']['algl_update']} "
            f"algl_update launches = {cres['round_launches']['primary_flushes']} primary flushes + "
            f"{cres['round_launches']['standby_tiles']} standby tiles; {CL_GROUPS} merged snapshots of "
            f"{CL_GROUP} keys, the default and 'cuda' merges equal the host tree, {cres['merge_launches']}; {CL_MIGRATIONS} migrations, "
            f"no stale read; shard {CL_VICTIM} killed ({cres['victims']} sessions) and promoted, shards "
            f"0-2 serving throughout; recover() equal; {time.perf_counter() - t0:.1f} s")
        # 35. timings, from the registry
        promote = reg.histogram("ha.promote_s")
        timings = {
            "failover_ms_best": promote.min * 1e3,
            "failover_ms_median": promote.quantile(0.5) * 1e3,
            "promotions": promote.count,
            "lag_seq_max": reg.histogram("replica.lag_seq_dist").max,
            "lag_s_p50": reg.histogram("replica.lag_s_dist").quantile(0.5),
            "poll_backlog_seq_max": max(max(card[m]["backlog_seq"]) for m in HA_MODES),
            "poll_catch_up_ms_p50": float(np.median([t for m in HA_MODES for t in card[m]["catch_up_s"]])) * 1e3,
            "poll_catch_up_ms_max": max(t for m in HA_MODES for t in card[m]["catch_up_s"]) * 1e3,
            "per_shard_elem_per_s": cres["per_shard_elem_per_s"],
            "cluster_elem_per_s": cres["cluster_elem_per_s"],
        }
        for name in ("cluster.merge_s", "cluster.merge_device_s", "cluster.migrate_s"):
            h = reg.histogram(name)
            timings[name.split(".")[1] + "_p50_ms"] = h.quantile(0.5) * 1e3
            timings[name.split(".")[1] + "_p99_ms"] = h.quantile(0.99) * 1e3
            timings[name.split(".")[1] + "_count"] = h.count
    finally:
        obs.disable()
    # the device="cpu" references: three child processes (the cluster in
    # one, two modes each in the others), started after the card's work so
    # that phase 35's host-clock timings had the cores to themselves
    t0 = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_futures = {part: pool.submit(ha_cpu_reference, part, os.path.join(work, "cpu"))
                       for part in ("cluster",) + HA_MODES}
        refs = {part: f.result(timeout=900) for part, f in cpu_futures.items()}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    cpu_s = time.perf_counter() - t0
    for mode in HA_MODES:
        got, want = card[mode], refs[mode]
        if (len(got["rounds"]) != len(want["rounds"])
                or not all(same_snapshots(a, b) for a, b in zip(got["rounds"], want["rounds"]))
                or not same_snapshots(got["final"], want["final"])):
            fail(f"[33 ha] {mode}: the card's states or snapshots differ from device='cpu'")
    want = refs["cluster"]
    if not same_snapshots(cres["merged"], want["merged"]):
        fail("[34 cluster] the card's merged snapshots differ from device='cpu'")
    for part in ("moved", "during_kill", "final"):
        if sorted(cres[part]) != sorted(want[part]) or not same_snapshots(
                [cres[part][k] for k in sorted(want[part])], [want[part][k] for k in sorted(want[part])]):
            fail(f"[34 cluster] the card's {part} snapshots differ from device='cpu'")
    log(f"[33-34] every state and snapshot equals the device='cpu' runs' (the CPU references ran after the "
        f"card's work, in three child processes, in {cpu_s:.1f} s)")
    card_name = card_line()
    log(f"[35 ha timings] {card_name} | failover (ha.promote_s over {timings['promotions']} promotions): best "
        f"{timings['failover_ms_best']:.4f} ms, median {timings['failover_ms_median']:.4f} ms; replication lag at "
        f"each poll over {HA_ROUNDS * len(HA_MODES)} polls: backlog max {timings['poll_backlog_seq_max']} flushes, "
        f"catch-up p50 {timings['poll_catch_up_ms_p50']:.4f} ms max {timings['poll_catch_up_ms_max']:.4f} ms; "
        f"the replica's own lag_seq max {timings['lag_seq_max']:g}, lag_s p50 {timings['lag_s_p50']:.6f} s "
        f"(0 by construction in this lockstep loop: read after the poll)")
    log(f"[35 ha timings] {card_name} | ingest elem/s, each shard timed alone (its ingests and sync): "
        + ", ".join(f"{k}: {v:.6e}" for k, v in timings["per_shard_elem_per_s"].items())
        + f"; the cluster, rounds and standby polls included: {timings['cluster_elem_per_s']:.6e}"
        + f"; cluster.merge_s p50 {timings['merge_s_p50_ms']:.4f} ms p99 {timings['merge_s_p99_ms']:.4f} ms; "
        f"cluster.merge_device_s p50 {timings['merge_device_s_p50_ms']:.4f} ms p99 "
        f"{timings['merge_device_s_p99_ms']:.4f} ms; cluster.migrate_s p50 {timings['migrate_s_p50_ms']:.4f} ms "
        f"p99 {timings['migrate_s_p99_ms']:.4f} ms (registry histograms)")
    line["ha"] = {
        "shape": {"sessions": HA_S, "k": HA_K, "B": HA_B, "rounds": HA_ROUNDS, "coalesce_bytes": SV_COALESCE,
                  "checkpoint_every": HA_CKPT_EVERY},
        "flushes": {m: card[m]["flushes"] for m in HA_MODES},
        "standby_launches": {m: card[m]["standby_launches"] for m in HA_MODES},
        "launches": ha_counts,
    }
    line["cluster"] = {
        "shape": {"shards": CL_SHARDS, "rows": CL_R, "sessions": CL_SESSIONS, "k": HA_K, "B": HA_B,
                  "rounds": HA_ROUNDS, "merge_groups": CL_GROUPS, "group": CL_GROUP,
                  "migrations": CL_MIGRATIONS, "victim": CL_VICTIM},
        "round_launches": cres["round_launches"],
        "merge_launches": cres["merge_launches"],
        "shard_sessions": cres["shard_sessions"],
    }
    line["timings"] = timings
    line["card"] = card_name
    shutil.rmtree(work, ignore_errors=True)
    return line, launches

# ------------------------------------------------------- WIDE counters (L3)

# phase 36: the shifts WIDE states are lifted by, the sample sizes, and the
# kernel-only steady tiles that take a state deeper before it is lifted
WIDE_SHIFTS = ((1 << 31) - 300, (1 << 32) - 300, (1 << 33) + 12345)
WIDE_KS = (K, 100, 6)
WIDE_DEEPEN = 6
# a WIDE row's state bytes: those of an int32 row (STATE_BYTES_PER_ROW) and
# 4 more for each of count and nxt, read and written
WIDE_STATE_BYTES_PER_ROW = 44
# phase 37: tiles before the engine's checkpoint and after it, the
# checkpoint's offset below 2^32 (rows spread over 9 tiles above it), the
# bridge's tiles and the service's recycles
WIDE_SHIFT = (1 << 32) - 5 * B
WIDE_BRIDGE_TILES = 8
WIDE_RECYCLES = 64


def wide_lift(state, target: int, gen, width: int):
    """A copy of a WIDE ``state`` lifted as ``tests/test_wide_count.py``
    lifts one: every row's count set to ``target`` with an imminent accept
    at nxt = count + 1 + U[0, 3 width); samples, log_w and keys as they
    are (copies: the kernel updates a state in place)."""
    from reservoir_tpu_torch.ops import u64e

    rows = state.count.shape[0]
    count = u64e.from_int(target, (rows,), state.count.device)
    off = 1 + torch.randint(0, 3 * width, (rows,), dtype=torch.int64, device=count.device, generator=gen)
    return clone(state)._replace(count=u64e.to_u32(count), nxt=u64e.to_u32(u64e.add_u32(count, off)))


def wide_rebase(state, shift: torch.Tensor):
    """A WIDE state with each row's count and nxt moved up by its
    ``shift`` (int64 ``[R]``, below 2^63): its chain as it was, at other
    absolute indices."""
    from reservoir_tpu_torch.ops import u64e

    up = u64e.make(shift & 0xFFFFFFFF, shift >> 32)
    return state._replace(count=u64e.to_u32(u64e.add64(state.count, up)),
                          nxt=u64e.to_u32(u64e.add64(state.nxt, up)))


def to_wide(state):
    """An int32-counter state (counts below 2^31) as a WIDE one, hi = 0."""
    from reservoir_tpu_torch.ops import u64e

    zero = torch.zeros_like(state.count, dtype=torch.int64)
    return state._replace(count=u64e.to_u32(u64e.make(state.count.long(), zero)),
                          nxt=u64e.to_u32(u64e.make(state.nxt.long(), zero)))


def u64_host(words) -> np.ndarray:
    """``[..., 2]`` WIDE words as host uint64 values."""
    from reservoir_tpu_torch.ops import u64e

    w = u64e.words(words.cpu()).numpy().astype(np.uint64)
    return (w[..., 1] << np.uint64(32)) | w[..., 0]


def same_hi0(wide, narrow) -> bool:
    """A WIDE state with a zero high word equals an int32 one."""
    from reservoir_tpu_torch.ops import u64e

    c, n = u64e.words(wide.count), u64e.words(wide.nxt)
    return (torch.equal(bits(wide.samples), bits(narrow.samples)) and torch.equal(bits(wide.log_w), bits(narrow.log_w))
            and not bool(c[:, 1].any()) and not bool(n[:, 1].any())
            and torch.equal(c[:, 0], narrow.count.long()) and torch.equal(n[:, 0], narrow.nxt.long()))


def wide_kernel_phase(gen, dev) -> tuple:
    """Phase 36: ``algl_update_wide`` against its plain version; returns
    ``(worst error, tiles checked)``."""
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops.rng import key_from_seed

    worst, checked, cpu_checks = 0.0, 0, []

    def step(state, tile, valid, fill, what):
        nonlocal worst, checked
        ref = (plain.update if fill else plain.update_steady)(clone(state), tile, valid)
        state = (kern.update_cuda if fill else kern.update_steady_cuda)(state, tile, valid)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(state, ref))
        if not same(state, ref):
            fail(f"[36 wide kernel] {what}: algl_update_wide != its plain version")
        checked += 1
        return state

    for k in WIDE_KS:
        gen.manual_seed(36)
        s = plain.init(key_from_seed(7), R, k, device=dev, count_dtype="wide")
        s32 = plain.init(key_from_seed(7), R, k, device=dev)
        start_cpu, fed = clone(s, ROWS_CPU, "cpu"), []
        # a fill tile from empty and a tile across the fill's end (k <= 192),
        # each against the plain version and, hi = 0, the int32 kernel
        for width in (64, 128):
            tile = random_tile(gen, width, torch.int32, dev)
            s = step(s, tile, None, True, f"k {k}, fill tile of width {width}")
            s32 = kern.update_cuda(s32, tile)
            if not same_hi0(s, s32):
                fail(f"[36 wide kernel] k {k}, fill tile of width {width}: hi = 0 != the int32 kernel")
            fed.append((tile[:ROWS_CPU].cpu(), None, True))
        cpu_checks.append((f"k {k} from empty", start_cpu, fed, clone(s, ROWS_CPU, "cpu")))
        # deeper by steady tiles, the last against the plain version
        for j in range(WIDE_DEEPEN):
            tile = random_tile(gen, B, torch.int32, dev)
            s = (step(s, tile, None, False, f"k {k}, steady tile") if j == WIDE_DEEPEN - 1
                 else kern.update_steady_cuda(s, tile))
            s32 = kern.update_steady_cuda(s32, tile)
        torch.cuda.synchronize()
        if not same_hi0(s, s32):
            fail(f"[36 wide kernel] k {k}: after {WIDE_DEEPEN} steady tiles, hi = 0 != the int32 kernel")
        # lifted across each boundary: three steady tiles, the last ragged
        for target in WIDE_SHIFTS:
            t = wide_lift(s, target, gen, B)
            lifted_cpu, fed_l = clone(t, ROWS_CPU, "cpu"), []
            for j in range(3):
                tile = random_tile(gen, B, torch.int32, dev)
                valid = (torch.randint(0, B + 1, (R,), dtype=torch.int32, device=dev, generator=gen)
                         if j == 2 else None)
                t = step(t, tile, valid, False, f"k {k}, lifted to {target}, tile {j}")
                fed_l.append((tile[:ROWS_CPU].cpu(), None if valid is None else valid[:ROWS_CPU].cpu(), False))
            # every row passed its boundary (2^31, 2^32) and took an accept there
            if int(u64_host(t.count).min()) < target + 2 * B or torch.equal(t.samples, s.samples):
                fail(f"[36 wide kernel] k {k}, lifted to {target}: the rows did not stream past it")
            cpu_checks.append((f"k {k} lifted to {target}", lifted_cpu, fed_l, clone(t, ROWS_CPU, "cpu")))
        log(f"[36 wide kernel] k {k}: fill tiles of 64 and 128 from empty and {WIDE_DEEPEN} steady tiles "
            f"(hi = 0, equal to the int32 kernel), then lifted to {', '.join(map(str, WIDE_SHIFTS))} with "
            "imminent accepts, three steady tiles each (the last ragged): bit-identical to the plain version")
        del s, s32
    # the plain version on the CPU, queued: run after the timed phases
    for case, state_c, fed, want in cpu_checks:
        check_on_cpu(f"[36 wide kernel] card vs CPU, {case}", want, cpu_replay,
                     "reservoir_tpu_torch.ops.algorithm_l", state_c,
                     [("update" if fill else "update_steady", (tile, valid)) for tile, valid, fill in fed])
    return worst, checked


def wide_serve_flow(device):
    """Phase 37 (c): a WIDE service at bench.py's serve shape: 2,048
    sessions, four rounds, a snapshot each; then 64 more sessions open,
    each evicting one and recycling its row through ``reset_rows``, and
    take a chunk.  Returns the service and every live session's snapshot."""
    from reservoir_tpu_torch import ReservoirService, SamplerConfig

    cfg = SamplerConfig(max_sample_size=SV_K, num_reservoirs=SV_S, tile_size=SV_B, count_dtype="wide")
    feed = serve_feed("plain")
    svc = ReservoirService(cfg, key=1, coalesce_bytes=SV_COALESCE, device=device)
    keys = [f"u{i}" for i in range(SV_S)]
    for key in keys:
        svc.open_session(key)
    for r in range(SV_ROUNDS):
        serve_round(svc, feed, r, keys)
    for j in range(WIDE_RECYCLES):
        svc.open_session(f"w{j}")
        svc.ingest(f"w{j}", feed[0][0, j])
    svc.sync()
    return svc, {s.key: svc.snapshot(s.key, sync=False) for s in svc.table.sessions()}


def wide_serve_cpu_reference() -> tuple:
    """Phase 37 (c) with ``device="cpu"``: every live session's snapshot and
    the engine's state as numpy.  Run in a child process while the card
    works."""
    from reservoir_tpu_torch import convert

    torch.set_num_threads(4)
    svc, snaps = wide_serve_flow("cpu")
    return snaps, convert.state_to_numpy(svc.bridge.engine.state)


def wide_merge_steps(count_a: torch.Tensor, count_b: torch.Tensor) -> int:
    """A WIDE merge's scan steps: min(total, k) summed over rows."""
    from reservoir_tpu_torch.ops import u64e

    total = u64e.add64(count_a, count_b)
    return int(torch.where((total[:, 1] > 0) | (total[:, 0] >= K), K, total[:, 0]).sum().item())


def wide_phases(gen, dev, here: str, accepts: dict) -> tuple:
    """Phases 36-38: WIDE counters on the card.  ``accepts`` holds phase
    7's accept counts of its fill, steady and deep tiles, which the WIDE
    kernel's timings take again with a zero high word (the same chain, bit
    for bit, as phase 36 holds).  Returns the ``wide`` line and the kernels
    line's entries of ``algl_update_wide`` and ``algl_merge_draws_wide``."""
    import concurrent.futures
    import multiprocessing

    # the plain version of phase 37 (c) runs in a child process on the CPU
    # while the card works
    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        return _wide_phases(gen, dev, here, accepts, pool.submit(wide_serve_cpu_reference))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _wide_phases(gen, dev, here: str, accepts: dict, cpu_future) -> tuple:
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch import convert
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.ops import u64e
    from reservoir_tpu_torch.ops.rng import key_from_seed, split_keys
    from reservoir_tpu_torch.parallel.merge import uniform_stream_merger
    from reservoir_tpu_torch.utils.stats import KS_GATE, ks_one_sample_uniform

    # 36. the kernel against its plain version
    worst, checked = wide_kernel_phase(gen, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # 37. the WIDE path end to end: (a) the engine, restored from a
    # checkpoint whose counts straddle 2^32
    work = os.path.join(here, "build", "chip_smoke", "wide")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B, count_dtype="wide")
    N = 11 * B  # one tile before the checkpoint, ten after
    rows_d = torch.arange(R, dtype=torch.int32, device=dev)[:, None] * N
    cols_d = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    eng = rtt.ReservoirEngine(cfg, key=0, reusable=True, device=dev)
    eng.sample(rows_d + cols_d)
    # row r moves up by 2^32 - 5B + (r mod 9) B: at the checkpoint rows with
    # r mod 9 >= 4 are past 2^32, the others cross it within the ten tiles
    shift = WIDE_SHIFT + (torch.arange(R, dtype=torch.int64, device=dev) % 9) * B
    lifted = wide_rebase(eng.state, shift)
    eng.adopt_rows(np.arange(R), lifted)
    path = os.path.join(work, "engine.npz")
    eng.save(path)
    del eng
    restored = rtt.ReservoirEngine.restore(path, device=dev)
    counts0 = u64_host(restored.state.count)
    if not (counts0.min() < 2**32 <= counts0.max()):
        fail(f"[37 wide path] the checkpoint's counts {counts0.min()}..{counts0.max()} do not straddle 2^32")
    dev_tiles = [rows_d + t * B + cols_d for t in range(1, 9)]
    host_tiles = [np.arange(R, dtype=np.int32)[:, None] * N + t * B + np.arange(B, dtype=np.int32)[None, :]
                  for t in (9, 10)]
    torch.cuda.synchronize()
    kern.launches = kern.wide_launches = kern.gated_launches = 0
    t0 = time.perf_counter()
    for tile in dev_tiles:
        restored.sample(tile)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    for tile in host_tiles:
        restored.sample(tile)
    torch.cuda.synchronize()
    engine_launches = (kern.wide_launches, kern.launches + kern.gated_launches)
    if engine_launches != (10, 0):
        fail(f"[37 wide path] the engine launched algl_update_wide {engine_launches[0]} times and the int32 "
             f"kernels {engine_launches[1]} times for 10 WIDE tiles")
    wide_dev_eps = 8 * R * B / t_dev
    counts1 = u64_host(restored.state.count)
    if not (counts1 == counts0 + np.uint64(10 * B)).all() or counts1.min() <= 2**32:
        fail("[37 wide path] the engine's counts did not all stream past 2^32")
    samples, sizes = restored.result_arrays()
    if not (sizes == K).all():
        fail("[37 wide path] not every reservoir holds k samples")
    row_of, pos = samples // N, samples % N
    srt = np.sort(pos, axis=1)
    if not (row_of == np.arange(R)[:, None]).all() or (srt[:, 1:] == srt[:, :-1]).any():
        fail("[37 wide path] a sample lies outside its row's stream, or a row sampled one position twice")
    ks = ks_one_sample_uniform(pos.ravel(), N)
    if not ks < KS_GATE:
        fail(f"[37 wide path] KS distance {ks} of the sampled positions is not below {KS_GATE}")
    # device="cpu": the same config on rows 0..1023 (a row's key does not
    # depend on R), the same lifted rows adopted, the same tiles
    cpu_cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=ROWS_CPU, tile_size=B, count_dtype="wide")
    cpu = rtt.ReservoirEngine(cpu_cfg, key=0, reusable=True, device="cpu")
    cpu.adopt_rows(np.arange(ROWS_CPU), clone(lifted, ROWS_CPU, "cpu"))
    for tile in dev_tiles + host_tiles:
        cpu.sample(tile[:ROWS_CPU].cpu() if isinstance(tile, torch.Tensor) else tile[:ROWS_CPU])
    if not same(cpu.state, clone(restored.state, ROWS_CPU, "cpu")):
        fail(f"[37 wide path] device=\"cpu\" != the card engine on rows 0..{ROWS_CPU - 1}")
    log(f"[37 wide path] (a) engine R {R}, k {K}, B {B}, count_dtype wide, restored from a checkpoint with "
        f"counts {counts0.min()}..{counts0.max()}: 10 tiles (8 device, 2 host), {engine_launches[0]} "
        f"algl_update_wide launches, counts now {counts1.min()}..{counts1.max()}, sizes all {K}, KS {ks:.6f} "
        f"< {KS_GATE}; rows 0..{ROWS_CPU - 1} == device=\"cpu\"; {wide_dev_eps:.6e} elem/s fed from the device")
    del restored, cpu, dev_tiles, host_tiles, samples
    gc.collect()

    # (b) the bridge over it: an adopt of lifted rows (its RTJA frame holds
    # WIDE counts), tiles across 2^32, a drop and recover() from the journal
    rr, rb = RR, RB
    bcfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=rr, tile_size=rb, count_dtype="wide")
    btiles = torch.randint(-(2**31), 2**31 - 1, (WIDE_BRIDGE_TILES + 1, rr, rb), generator=gen, device=dev,
                           dtype=torch.int32).cpu().numpy()
    seed_eng = rtt.ReservoirEngine(bcfg, key=3, reusable=True, device=dev)
    seed_eng.sample(btiles[0])
    blifted = wide_rebase(seed_eng.state, torch.full((rr,), (1 << 32) - 3 * rb, dtype=torch.int64, device=dev))
    del seed_eng

    def b_run(bridge, tiles):
        for t in tiles:
            bridge.push_tile(btiles[t])

    kern.wide_launches = kern.launches = kern.gated_launches = 0
    whole = rtt.DeviceStreamBridge(bcfg, key=3, device=dev)
    whole.adopt_rows(np.arange(rr), blifted)
    b_run(whole, range(1, WIDE_BRIDGE_TILES + 1))
    want = whole.complete()
    bridge_launches = (kern.wide_launches, kern.launches + kern.gated_launches)
    if bridge_launches != (WIDE_BRIDGE_TILES, 0):
        fail(f"[37 wide path] (b) the bridge launched algl_update_wide {bridge_launches[0]} times and the int32 "
             f"kernels {bridge_launches[1]} times for {WIDE_BRIDGE_TILES} tiles")
    del whole
    ckdir = os.path.join(work, "bridge")
    dropped = rtt.DeviceStreamBridge(bcfg, key=3, device=dev, checkpoint_dir=ckdir, checkpoint_every=2)
    dropped.adopt_rows(np.arange(rr), blifted)
    b_run(dropped, range(1, WIDE_BRIDGE_TILES // 2 + 2))
    dropped.drain_barrier()
    seq = dropped.flushed_seq
    del dropped  # the crash
    gc.collect()
    recovered = rtt.DeviceStreamBridge.recover(ckdir, device=dev)
    done = int(u64_host(recovered.engine.state.count)[0] - u64_host(blifted.count)[0])
    if recovered.flushed_seq != seq or done % rb or done // rb < 1:
        fail(f"[37 wide path] (b) recover() came back at flush {recovered.flushed_seq} of {seq}, {done} elements")
    b_run(recovered, range(1 + done // rb, WIDE_BRIDGE_TILES + 1))
    got = recovered.complete()
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail("[37 wide path] (b) the recovered WIDE bridge's samples != the uninterrupted run's")
    del recovered
    # gated=True is inert for WIDE counters, with the reference's reason
    kern.wide_launches = kern.launches = kern.gated_launches = 0
    gated = rtt.DeviceStreamBridge(bcfg, key=3, device=dev, gated=True)
    reason = gated.gate_inert_reason
    gated.adopt_rows(np.arange(rr), blifted)
    b_run(gated, range(1, WIDE_BRIDGE_TILES + 1))
    ggot = gated.complete()
    if gated.gate_active or reason != "WIDE counters (gate replica is int32-narrow)" or not all(
            np.array_equal(a, b) for a, b in zip(ggot, want)):
        fail(f"[37 wide path] (b) gated=True: active {gated.gate_active}, reason {reason!r}, or its samples "
             "differ from the ungated bridge's")
    if (kern.wide_launches, kern.gated_launches) != (WIDE_BRIDGE_TILES, 0):
        fail(f"[37 wide path] (b) the inert gated bridge launched algl_update_wide {kern.wide_launches} and "
             f"algl_update_gated {kern.gated_launches} times")
    del gated
    cpu_b = rtt.DeviceStreamBridge(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=ROWS_CPU, tile_size=rb,
                                                     count_dtype="wide"), key=3, device="cpu")
    cpu_b.adopt_rows(np.arange(ROWS_CPU), clone(blifted, ROWS_CPU, "cpu"))
    for t in range(1, WIDE_BRIDGE_TILES + 1):
        cpu_b.push_tile(btiles[t][:ROWS_CPU])
    if not all(np.array_equal(a, b) for a, b in zip(cpu_b.complete(), want[:ROWS_CPU])):
        fail(f"[37 wide path] (b) device=\"cpu\" != the card bridge on rows 0..{ROWS_CPU - 1}")
    log(f"[37 wide path] (b) bridge R {rr}, B {rb}: an adopt of rows lifted below 2^32, {WIDE_BRIDGE_TILES} "
        f"tiles, {bridge_launches[0]} algl_update_wide launches; dropped after flush {seq}, recover() from the "
        f"journal, then the rest: == the uninterrupted run; gated=True inert ({reason}) with the same samples; "
        f"rows 0..{ROWS_CPU - 1} == device=\"cpu\"")
    del cpu_b, btiles

    # (c) the service at bench.py's serve shape, with recycles
    torch.cuda.synchronize()
    kern.wide_launches = kern.launches = kern.gated_launches = 0
    svc, snaps = wide_serve_flow(dev)
    torch.cuda.synchronize()
    flushes, recycles = svc.bridge.metrics.flushes, svc.metrics.recycles
    serve_launches = kern.wide_launches
    if (serve_launches, kern.launches + kern.gated_launches) != (flushes, 0) or recycles != WIDE_RECYCLES:
        fail(f"[37 wide path] (c) {serve_launches} algl_update_wide launches for {flushes} flushes, "
             f"{kern.launches + kern.gated_launches} int32 ones, {recycles} recycles")
    t0 = time.perf_counter()
    csnaps, cstate = cpu_future.result()
    waited = time.perf_counter() - t0
    if snaps.keys() != csnaps.keys() or not all(same_snapshots([snaps[x]], [csnaps[x]]) for x in snaps):
        fail("[37 wide path] (c) the WIDE service's snapshots differ from device=\"cpu\"'s")
    state_host = convert.state_to_numpy(svc.bridge.engine.state)
    if not all(np.array_equal(v, cstate[name]) for name, v in state_host.items()):
        fail("[37 wide path] (c) the WIDE service's engine state differs from device=\"cpu\"'s")
    log(f"[37 wide path] (c) service: {SV_S} sessions x {SV_ROUNDS} rounds of {SV_B}, then {recycles} recycles "
        f"through reset_rows: {flushes} flushes, {serve_launches} algl_update_wide launches; every snapshot "
        f"and the state == device=\"cpu\" (run beside the card; {waited:.1f} s waited for it)")
    del svc, snaps, csnaps, cstate
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 38. WIDE merges: (a) a pairwise merge at the main path's shape
    rng = np.random.default_rng(38)
    ca_h, cb_h = wide_merge_counts(rng)
    ca, cb = wide_planes(ca_h, dev), wide_planes(cb_h, dev)
    sa, sb = random_tile(gen, K, torch.int32, dev), random_tile(gen, K, torch.int32, dev)
    row_keys = split_keys(key_from_seed(38, device=dev), R)
    torch.cuda.synchronize()
    kern.wide_merge_launches = kern.merge_launches = 0
    m_s, m_c = plain.merge_samples_keyed(sa, ca, sb, cb, row_keys)
    torch.cuda.synchronize()
    if (kern.wide_merge_launches, kern.merge_launches) != (1, 0):
        fail(f"[38 wide merge] (a) {kern.wide_merge_launches} algl_merge_draws_wide and {kern.merge_launches} "
             "algl_merge_draws launches for one WIDE merge")
    t0 = time.perf_counter()
    j_a, draws_past = plain.merge_scan(ca, cb, row_keys, K)
    want_draws = plain.MergeDraws(j_a, *plain.merge_keys(ca, cb, row_keys, K))
    torch.cuda.synchronize()
    merge_plain_ms = 1e3 * (time.perf_counter() - t0)
    got_draws = kern.merge_draws_cuda(ca, cb, row_keys, K)
    merge_err = draws_err(got_draws, want_draws)
    w_s, w_c = plain.merge_from_draws(sa, ca, sb, cb, want_draws)
    if not same(got_draws, want_draws) or not torch.equal(m_s, w_s) or not torch.equal(bits(m_c), bits(w_c)):
        fail("[38 wide merge] (a) the merge through algl_merge_draws_wide != its plain version")
    if not (u64_host(m_c) == ca_h + cb_h).all():
        fail("[38 wide merge] (a) the merged counts are not the exact 64-bit totals")
    c_s, c_c = plain.merge_samples_keyed(sa[:ROWS_CPU].cpu(), ca[:ROWS_CPU].cpu(), sb[:ROWS_CPU].cpu(),
                                         cb[:ROWS_CPU].cpu(), row_keys[:ROWS_CPU].cpu())
    if not torch.equal(c_s, m_s[:ROWS_CPU].cpu()) or not torch.equal(bits(c_c), bits(m_c[:ROWS_CPU].cpu())):
        fail(f"[38 wide merge] (a) the plain merge on the CPU != the card on rows 0..{ROWS_CPU - 1}")
    log(f"[38 wide merge] (a) merge_samples_keyed of two WIDE [{R}, {K}] states, counts up to 2^40 and "
        "straddling 2^32 and 2^63: one algl_merge_draws_wide launch, == the plain version on the card "
        f"(j_a and both sides' keys) and on the CPU (rows 0..{ROWS_CPU - 1}); totals exact")
    # (b) a 4-shard WIDE stream merger
    shards = 4
    s_st = torch.randint(-(2**31), 2**31 - 1, (shards, R, K), dtype=torch.int32, device=dev, generator=gen)
    c_host = rng.integers(2**31, 2**38, (shards, R)).astype(np.uint64)
    c_st = torch.stack([wide_planes(c, dev) for c in c_host])
    torch.cuda.synchronize()
    kern.wide_merge_launches = kern.merge_launches = mkern.launches = 0
    t0 = time.perf_counter()
    ms, mc = uniform_stream_merger(s_st, c_st, 38)
    torch.cuda.synchronize()
    merger_ms = 1e3 * (time.perf_counter() - t0)
    merger_launches = (mkern.launches, kern.wide_merge_launches, kern.merge_launches)
    if merger_launches != (1, 2, 0):
        fail(f"[38 wide merge] (b) {merger_launches} merge_ring_gather / algl_merge_draws_wide / "
             "algl_merge_draws launches for a 4-shard WIDE merger (want 1, 2, 0)")
    if not (u64_host(mc) == c_host.sum(axis=0)).all() or mc.shape != (R, 2):
        fail("[38 wide merge] (b) the merged counts are not the exact 64-bit totals")
    ps, pc = uniform_stream_merger([s[:ROWS_CPU].cpu() for s in s_st], [c[:ROWS_CPU].cpu() for c in c_st], 38)
    if not torch.equal(ps, ms[:ROWS_CPU].cpu()) or not torch.equal(bits(pc), bits(mc[:ROWS_CPU].cpu())):
        fail(f"[38 wide merge] (b) the plain merger on CPU ranks != the card's on rows 0..{ROWS_CPU - 1}")
    log(f"[38 wide merge] (b) uniform_stream_merger of {shards} WIDE shards [{R}, {K}] (counts 2^31..2^38): "
        f"1 merge_ring_gather and 2 algl_merge_draws_wide launches, exact totals, rows 0..{ROWS_CPU - 1} == "
        f"the plain merger on CPU ranks; {merger_ms:.2f} ms")
    del s_st, c_st, ms, mc

    # timings: algl_update_wide beside the int32 kernel on phase 7's tiles
    card = card_line()
    (_, s0, fill_tile, _), (_, state, steady_tile, _), (deep_label, deep, deep_tile, _) = \
        uniform_timing_cases(gen, dev)
    timing = {}
    for name, st, tile, fill in (("fill_tile", s0, fill_tile, True), ("steady_tile", state, steady_tile, False),
                                 ("deep_steady_tile", deep, deep_tile, False)):
        fn = kern.update_cuda if fill else kern.update_steady_cuda
        wst = to_wide(st)
        wide_ms = event_ms(lambda x: fn(x, tile), setup=lambda: clone(wst), batch=10)
        int32_ms = event_ms(lambda x: fn(x, tile), setup=lambda: clone(st), batch=10)
        bound, by = bound_ms(accepts[name], R * K if fill else 0, state_bytes=WIDE_STATE_BYTES_PER_ROW)
        timing[name] = {"ms": wide_ms, "int32_ms": int32_ms, "bound_ms": bound, "bound_by": by,
                        "accepts": accepts[name]}
        past = ""
        if not fill:
            # the same chain moved past 2^32 (a fill needs a count below k):
            # its count now says the row expects few accepts, so the
            # kernel's L2 prefetch of a row's samples no longer runs
            moved = wide_rebase(wst, torch.full((R,), 1 << 32, dtype=torch.int64, device=dev))
            timing[name]["past_2_32_ms"] = event_ms(lambda x: fn(x, tile), setup=lambda: clone(moved), batch=10)
            past = f" (the same chain past 2^32 {timing[name]['past_2_32_ms']:.4f} ms)"
        if name == "steady_tile":
            t0 = time.perf_counter()
            plain.update_steady(clone(wst), tile)
            torch.cuda.synchronize()
            timing[name]["plain_ms"] = 1e3 * (time.perf_counter() - t0)
        log(f"[38 wide timings] {card} | algl_update_wide, {name.replace('_', ' ')}: {wide_ms:.4f} ms{past}, "
            f"the int32 kernel {int32_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"accepts {accepts[name]}" + (f", plain {timing[name]['plain_ms']:.1f} ms"
                                          if "plain_ms" in timing[name] else ""))
    del s0, fill_tile, state, steady_tile, deep, deep_tile
    # algl_merge_draws_wide beside the narrow kernel: phase 19's pair, its
    # counts as WIDE words too, and (a)'s counts past 2^32
    na, nca, nb, ncb, nkeys = merge_timing_case(gen, dev)
    wca, wcb = (u64e.to_u32(u64e.make(c.long(), torch.zeros_like(c, dtype=torch.int64))) for c in (nca, ncb))
    narrow_ms = event_ms(lambda _: kern.merge_draws_cuda(nca, ncb, nkeys, K), batch=10)
    same_ms = event_ms(lambda _: kern.merge_draws_cuda(wca, wcb, nkeys, K), batch=10)
    past_ms = event_ms(lambda _: kern.merge_draws_cuda(ca, cb, row_keys, K), batch=10)
    draws_same = plain.merge_scan(wca, wcb, nkeys, K)[1]
    same_bound, same_by = merge_bound_ms(wide_merge_steps(wca, wcb), draws_same, R, K, row_bytes=28, wide=True)
    past_bound, past_by = merge_bound_ms(wide_merge_steps(ca, cb), draws_past, R, K, row_bytes=28, wide=True)
    log(f"[38 wide timings] {card} | algl_merge_draws_wide at [{R}, {K}]: phase 19's counts {same_ms:.4f} ms "
        f"(the narrow kernel {narrow_ms:.4f} ms), bound {same_bound:.4f} ms ({same_by}), {draws_same} words drawn; "
        f"counts past 2^32 {past_ms:.4f} ms, bound {past_bound:.4f} ms ({past_by}), {draws_past} words drawn; "
        f"plain {merge_plain_ms:.1f} ms; build {build_text(kern.merge_kernel_info(wide=True))}")
    log(f"[38 wide timings] {card} | the WIDE engine: {wide_dev_eps:.6e} elem/s fed from the device; "
        f"algl_update_wide build {build_text(kern.kernel_info(wide=True))}")
    line = {
        "card": card,
        "kernel_cases": checked,
        "engine": {"launches": engine_launches[0], "device_fed_elem_per_s": wide_dev_eps, "ks": ks,
                   "counts_before": [int(counts0.min()), int(counts0.max())],
                   "counts_after": [int(counts1.min()), int(counts1.max())]},
        "bridge": {"launches": bridge_launches[0], "flushes_before_drop": seq, "gate_inert_reason": reason},
        "service": {"flushes": flushes, "launches": serve_launches, "recycles": recycles},
        "merge": {"pairwise_launches": 1, "stream_merger_launches": list(merger_launches),
                  "stream_merger_ms": merger_ms},
    }
    update_entry = {
        "name": "algl_update_wide",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/algorithm_l.cu",
        "replaces": "reservoir_tpu/ops/algorithm_l.py:211",
        "replaces_note": "no TPU kernel: the reference's WIDE _accept_loop is XLA "
                         "(algorithm_l_pallas.supports() declines WIDE states, :103)",
        "launches": engine_launches[0],
        "bridge_launches": bridge_launches[0],
        "serve_launches": serve_launches,
        "max_abs_err": worst,
        "ms": timing["steady_tile"]["ms"],
        "plain_ms": timing["steady_tile"]["plain_ms"],
        "bound_ms": timing["steady_tile"]["bound_ms"],
        "bound_by": timing["steady_tile"]["bound_by"],
        "library_ms": None,
        **timing,
        "engine_elem_per_s": {"device_fed": wide_dev_eps},
        "build": kern.kernel_info(wide=True),
    }
    merge_entry = {
        "name": "algl_merge_draws_wide",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/algl_merge.cu",
        "replaces": "reservoir_tpu/ops/algorithm_l.py:573",
        "replaces_note": "no TPU kernel: the reference's WIDE merge scan (one_wide, :573-603, with "
                         "_randint_exact_u64e :680) is XLA",
        "launches": merger_launches[1],
        "max_abs_err": merge_err,
        "ms": past_ms,
        "plain_ms": merge_plain_ms,
        "bound_ms": past_bound,
        "bound_by": past_by,
        "library_ms": None,
        "words_drawn": draws_past,
        "phase_19_counts": {"ms": same_ms, "narrow_kernel_ms": narrow_ms, "bound_ms": same_bound,
                            "bound_by": same_by, "words_drawn": draws_same},
        "pairwise_launches": 1,
        "build": kern.merge_kernel_info(wide=True),
    }
    return line, update_entry, merge_entry



# ------------------------------------------- the hooks (L5) and the fused stream (L7)

# phase 39: the tiles each mapped engine takes (a fill tile, then steady
# ones), and the gated bridge's rounds and chunk a row
HOOK_TILES = 4
HOOK_ROUNDS, HOOK_CHUNK = 4, 2048
# phase 40: tiles of the pre-hashed engine path (device, then host)
HASH_DEV_TILES, HASH_HOST_TILES = 8, 2
# phase 41: full tiles of each fused stream, and its ragged tail
FUSED_TILES = {"uniform": 4, "wide": 4, "weighted": 8, "distinct": 8, "distinct_hooked": 8}
FUSED_TAIL = 17


def map_half(x):
    """int32 elements to float32 samples, exactly: ``(x >> 8) / 2``."""
    return (x >> 8).to(torch.float32) * 0.5


def map_affine(x):
    """``3 x + 7``, wrapping as int32 (or int64) arithmetic does."""
    return x * 3 + 7


def map_halve(x):
    """``x >> 1``: pairs of keys become one."""
    return x >> 1


def hash_narrow(v):
    """A user hash of 4-byte keys (torch or numpy): ``(v >> 16, 31 v)``."""
    return v >> 16, v * 31


def hash_wide(x):
    """A user hash of 8-byte keys (torch or numpy)."""
    return (x >> 32) ^ x, x * 0x9E37


def hook_launches() -> dict:
    """Every update kernel's launch count."""
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern

    return {"algl_update": kern.launches, "algl_update_wide": kern.wide_launches,
            "algl_update_gated": kern.gated_launches, "weighted_update": wkern.launches,
            "distinct_update": dkern.launches, "distinct_update_keepmax": dkern.keepmax_launches,
            "distinct_update_prehashed": dkern.prehashed_launches}


def zero_launches() -> None:
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops import weighted_cuda as wkern

    kern.launches = kern.wide_launches = kern.gated_launches = 0
    wkern.launches = dkern.launches = dkern.keepmax_launches = dkern.prehashed_launches = 0


def only(name: str, n: int) -> dict:
    """:func:`hook_launches` of a run that launched ``name`` n times and no
    other update kernel."""
    return {k: (n if k == name else 0) for k in hook_launches()}


def held_value_keys(state) -> torch.Tensor:
    """A distinct state's keys as int64 (narrow ones sign-extended), slots
    past ``size`` as INT64_MAX, sorted a row: keys identify entries under
    any hash."""
    keys = held_keys(state).long()
    slot = torch.arange(keys.shape[1], device=keys.device)[None, :]
    return torch.sort(torch.where(slot < state.size[:, None].long(), keys, 2**63 - 1), dim=1).values


def net_inserts_by_key(before, after) -> tuple:
    """:func:`net_inserts` for states under a user hash, where two keys may
    share a hash: entries are told apart by their keys."""
    b, a = held_value_keys(before), held_value_keys(after)
    idx = torch.searchsorted(b, a).clamp(max=b.shape[1] - 1)
    new = ((b.gather(1, idx) != a) & (a != 2**63 - 1)).sum(1)
    return int(new.sum().item()), int((new > 0).sum().item())


def user_hash_oracle(tiles, salts, hash_fn, samples, sizes, k: int) -> tuple:
    """Phase 40's exact host oracle, in numpy with the port's hashing:
    each row's k smallest (scrambled user hash, key) pairs among its
    distinct keys, in that order; a scrambled hash of (MAX, MAX) counts as
    any other (the reference's XLA rule under a user hash).  Returns
    ``(ok, message)``."""
    from reservoir_tpu_torch.ops import hashing

    keys = np.concatenate(tiles, axis=1)
    hi, lo = hash_fn(keys)
    hi = (np.asarray(hi).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    lo = (np.asarray(lo).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    sh, sl = hashing.scramble64(hi, lo, salts[:, 0:1], salts[:, 1:2], salts[:, 2:3], salts[:, 3:4])
    h = (sh.astype(np.uint64) << np.uint64(32)) | sl.astype(np.uint64)
    val = keys.astype(np.int64).view(np.uint64)  # (sign-extended) value words, in their order
    order = np.lexsort((val, h), axis=1)
    h, val, keys = (np.take_along_axis(x, order, 1) for x in (h, val, keys))
    first = np.ones(h.shape, bool)
    first[:, 1:] = (h[:, 1:] != h[:, :-1]) | (val[:, 1:] != val[:, :-1])
    rank = np.cumsum(first, axis=1)
    want_size = np.minimum(k, rank[:, -1])
    if not (sizes == want_size).all():
        bad = int(np.flatnonzero(sizes != want_size)[0])
        return False, f"row {bad} holds {sizes[bad]} keys, min(k, #distinct) is {want_size[bad]}"
    sel = first & (rank <= k)
    want = np.zeros((keys.shape[0], k), keys.dtype)
    r_idx, c_idx = np.nonzero(sel)
    want[r_idx, rank[r_idx, c_idx] - 1] = keys[r_idx, c_idx]
    got = np.where(np.arange(k)[None, :] < sizes[:, None], samples, 0)
    if not (got == want).all():
        bad = int(np.flatnonzero((got != want).any(1))[0])
        return False, f"row {bad} differs from the k smallest (hash, key) pairs of its distinct keys"
    return True, ""


def prehashed_timing_cases(gen, dev) -> list:
    """Phase 40's timed tiles in its order, each ``(label, state of the
    pre-hashed kernel, state of the default one, tile, hash planes)``: a
    steady Zipf tile after 8 Zipf tiles and a Zipf tile from empty, int32
    keys under :func:`hash_narrow` (``kernel_ab.py`` times the same)."""
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops.hooks import hash_planes
    from reservoir_tpu_torch.ops.rng import key_from_seed

    gen.manual_seed(43)
    s0 = dplain.init(key_from_seed(0), DR, DK, device=dev)
    pre_state, def_state = clone(s0), clone(s0)
    for _ in range(8):
        tile = zipf_keys(gen, DR, DB, torch.int32, dev)
        pre_state = dkern.update_prehashed_cuda(pre_state, tile, hash_planes(hash_narrow, tile))
        def_state = dkern.update_prehashed_cuda(def_state, tile, None)
    cases = []
    for label, pre_s, def_s in (("steady Zipf tile after 8", pre_state, def_state),
                                ("Zipf tile from empty", s0, s0)):
        tile = zipf_keys(gen, DR, DB, torch.int32, dev)
        cases.append((label, pre_s, def_s, tile, hash_planes(hash_narrow, tile)))
    return cases


def hook_phases(gen, dev, here: str) -> tuple:
    """Phases 39-41: the map and hash hooks and the fused stream on the
    card.  Returns the ``hooks`` line, the additions to earlier kernels'
    entries (by name) and the ``kernels`` entry of the pre-hashed
    ``distinct_update``."""
    line, extra = {}, {}
    line["map"] = map_phase(gen, dev, extra)
    gc.collect()
    torch.cuda.empty_cache()
    line["hash"], entry = hash_phase(gen, dev)
    gc.collect()
    torch.cuda.empty_cache()
    line["fused"] = fused_phase(gen, dev, extra)
    gc.collect()
    torch.cuda.empty_cache()
    return line, extra, entry


def map_phase(gen, dev, extra: dict) -> dict:
    """Phase 39: engines with a map at full width (config 5 with int32 and
    WIDE counters, weighted config 4, the distinct configuration) and a
    gated bridge with a map, each against ``device="cpu"`` (map on accept)
    on rows 0..1023, one launch a tile; the map pass timed beside the
    kernel."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops.hooks import map_values

    out = {}
    cases = [
        ("uniform int32 -> float32", "algl_update", dict(max_sample_size=K, num_reservoirs=R, tile_size=B,
                                                          sample_dtype="float32"), map_half),
        ("uniform, WIDE counters", "algl_update_wide", dict(max_sample_size=K, num_reservoirs=R, tile_size=B,
                                                             count_dtype="wide"), map_affine),
        ("weighted", "weighted_update", dict(max_sample_size=WK, num_reservoirs=WR, tile_size=WB,
                                             weighted=True), map_affine),
        ("distinct, Zipf keys", "distinct_update_keepmax", dict(max_sample_size=DK, num_reservoirs=DR,
                                                                tile_size=DB, distinct=True), map_halve),
    ]
    for label, name, kw, fn in cases:
        rows = kw["num_reservoirs"]
        width = kw["tile_size"]
        gen.manual_seed(39)
        if kw.get("distinct"):
            tiles = [zipf_keys(gen, rows, width, torch.int32, dev) for _ in range(HOOK_TILES)]
        else:
            tiles = [torch.randint(-(2**31), 2**31 - 1, (rows, width), dtype=torch.int32, device=dev,
                                   generator=gen) for _ in range(HOOK_TILES)]
        weights = ([weight_tile(gen, rows, width, "zeros", dev) for _ in range(HOOK_TILES)]
                   if kw.get("weighted") else [None] * HOOK_TILES)
        torch.cuda.synchronize()
        zero_launches()
        eng = rtt.ReservoirEngine(rtt.SamplerConfig(**kw), key=0, map_fn=fn)
        for tile, w in zip(tiles, weights):
            eng.sample(tile, weights=w)
        torch.cuda.synchronize()
        got = hook_launches()
        if got != only(name, HOOK_TILES):
            fail(f"[39 map] {label}: launches {got} for {HOOK_TILES} tiles, not {HOOK_TILES} of {name} alone")
        extra.setdefault(name, {})["mapped_launches"] = got[name]
        # device="cpu" (map on accept) on rows 0..1023, queued: run after the timed phases
        check_on_cpu(f"[39 map] {label}, card engine vs device=\"cpu\"", clone(eng.state, ROWS_CPU, "cpu"),
                     cpu_map_engine, {**kw, "num_reservoirs": ROWS_CPU}, fn,
                     [t[:ROWS_CPU].cpu() for t in tiles], [None if w is None else w[:ROWS_CPU].cpu() for w in weights])
        sizes = eng.peek_arrays()[1]
        case = {"launches": got[name], "min_size": int(sizes.min())}
        if name.startswith("algl"):
            # the map pass beside the kernel it feeds, on the last (steady) tile
            tile, state = tiles[-1], eng.state
            mapped = map_values(fn, tile, eng._dtype)
            map_ms = event_ms(lambda _: map_values(fn, tile, eng._dtype), batch=10)
            kernel_ms = event_ms(lambda st: kern.update_steady_cuda(st, mapped), setup=lambda: clone(state),
                                 batch=10)
            nbytes = tile.numel() * (tile.element_size() + mapped.element_size())
            case.update({"map_ms": map_ms, "kernel_ms": kernel_ms,
                         "map_bound_ms": 1e3 * nbytes / PEAK_BYTES, "map_bytes": nbytes})
            extra[name]["map_pass"] = {k: case[k] for k in ("map_ms", "kernel_ms", "map_bound_ms")}
        elif kw.get("distinct"):
            # a mapped distinct tile: the map pass, then one keep-max launch
            # on the mapped keys (no hash planes), beside the default kernel
            # on the same mapped keys
            tile, state = tiles[-1], eng.state
            mapped = dplain.map_keys(state, tile, fn)
            case.update({
                "map_ms": event_ms(lambda _: dplain.map_keys(state, tile, fn), batch=10),
                "kernel_ms": event_ms(lambda st: dkern.launch(st, mapped, None, None, None, dkern.KEEPMAX),
                                      setup=lambda: clone(state), batch=10),
                "default_kernel_ms": event_ms(lambda st: dkern.update_prehashed_cuda(st, mapped, None),
                                              setup=lambda: clone(state), batch=10),
            })
            extra[name]["map_pass"] = {k: case[k] for k in ("map_ms", "kernel_ms", "default_kernel_ms")}
        out[label] = case
        log(f"[39 map] {card_line()} | {label}: {HOOK_TILES} tiles, {got[name]} {name} launches, sizes >= "
            f"{case['min_size']}; rows 0..{ROWS_CPU - 1} held against device=\"cpu\" (map on accept) after "
            "phase 48"
            + (f"; map pass {case['map_ms']:.4f} ms (bound {case['map_bound_ms']:.4f} ms, bytes) beside the "
               f"steady kernel on the mapped tile {case['kernel_ms']:.4f} ms" if "map_bound_ms" in case else "")
            + (f"; map pass {case['map_ms']:.4f} ms, then one keep-max launch on the mapped keys "
               f"{case['kernel_ms']:.4f} ms (the default kernel {case['default_kernel_ms']:.4f} ms)"
               if "default_kernel_ms" in case else ""))
        del eng, tiles, weights
        gc.collect()
        torch.cuda.empty_cache()

    # bridges with a map: lockstep rounds through push_interleaved, each
    # against the ungated card engine and device="cpu" fed the same rows in
    # tiles.  A card flush ships the demux's element bytes, so a map that
    # changes the dtype runs both bridges' flush paths on other words
    total = HOOK_ROUNDS * HOOK_CHUNK
    streams = ((np.arange(RR, dtype=np.int64)[:, None] * 1_000_003 + np.arange(total, dtype=np.int64)[None, :])
               % 2**32 - 2**31).astype(np.int32)
    ids = np.tile(np.arange(RR, dtype=np.int32), HOOK_CHUNK)
    bridges = [("gated bridge", True, map_affine, {}),
               ("gated bridge, int32 -> float32", True, map_half, {"sample_dtype": "float32"}),
               ("ungated bridge, int32 -> float32", False, map_half, {"sample_dtype": "float32"})]
    refs = {}
    for label, gated, fn, kw in bridges:
        cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=RR, tile_size=RB, **kw)
        zero_launches()
        bridge = rtt.DeviceStreamBridge(cfg, key=0, map_fn=fn, gated=gated)
        for rnd in range(HOOK_ROUNDS):
            bridge.push_interleaved(ids, streams[:, rnd * HOOK_CHUNK:(rnd + 1) * HOOK_CHUNK].T.ravel())
        bridge.flush()
        bridge.drain_barrier()
        torch.cuda.synchronize()
        m = bridge.metrics
        got = hook_launches()
        if (got["algl_update_gated"] != m.gated_dispatches or got["algl_update"] != m.flushes - m.gated_dispatches
                or sum(got.values()) != m.flushes or (m.gated_dispatches >= 1) != gated):
            fail(f"[39 map] {label}: launches {got} for {m.flushes} flushes, {m.gated_dispatches} gated")
        if gated and "algl_update_gated" not in extra:
            extra["algl_update_gated"] = {"mapped_launches": got["algl_update_gated"]}
        counted = dict(got)
        if fn not in refs:  # the references, once a map
            engine = rtt.ReservoirEngine(cfg, key=0, map_fn=fn)
            cpu = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=ROWS_CPU,
                                                        tile_size=RB, **kw), key=0, map_fn=fn, device="cpu")
            for t in range(total // RB):
                tile = streams[:, t * RB:(t + 1) * RB]
                engine.sample(tile)
                cpu.sample(tile[:ROWS_CPU])
            torch.cuda.synchronize()
            if not same(cpu.state, clone(engine._state, ROWS_CPU, "cpu")):
                fail(f"[39 map] the card engine with {fn.__name__} != device=\"cpu\" (map on accept) on rows "
                     f"0..{ROWS_CPU - 1}")
            refs[fn] = engine
        if not same(bridge.engine._state, refs[fn]._state):
            fail(f"[39 map] the {label}'s state != the ungated card engine with the same map")
        out[label] = {"flushes": m.flushes, "gated_dispatches": m.gated_dispatches, "launches": counted}
        log(f"[39 map] {label} R {RR}, k {K}, B {RB}, {HOOK_ROUNDS} lockstep rounds of {HOOK_CHUNK} a row: "
            f"{m.flushes} flushes, {m.gated_dispatches} gated ({counted['algl_update_gated']} algl_update_gated "
            f"and {counted['algl_update']} algl_update launches); == the ungated card engine, rows "
            f"0..{ROWS_CPU - 1} == device=\"cpu\"")
        del bridge
    del refs
    return out


def hash_phase(gen, dev) -> tuple:
    """Phase 40: the pre-hashed ``distinct_update`` against its plain
    version (narrow and int64 keys, on chip and beyond shared memory), the
    hooked engine against an exact oracle with one launch a tile, and its
    timings beside the default-hash kernel on the same keys."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.convert import distinct_state_to_numpy
    from reservoir_tpu_torch.ops import distinct as dplain
    from reservoir_tpu_torch.ops import distinct_cuda as dkern
    from reservoir_tpu_torch.ops.hooks import hash_planes
    from reservoir_tpu_torch.ops.rng import key_from_seed

    def planes(tile, fn):
        return hash_planes(fn, tile)

    worst, checked = 0.0, 0
    for dtype, fn in ((torch.int32, hash_narrow), (torch.int64, hash_wide)):
        gen.manual_seed(40)
        s = dplain.init(key_from_seed(40), DR, DK, sample_dtype=dtype, device=dev)
        for t, kind in enumerate(("random", "zipf", "zipf", "zipf")):
            tile = (wide_or_narrow(torch.randint(-(2**62), 2**62, (DR, DB), generator=gen, device=dev), dtype)
                    if kind == "random" else zipf_keys(gen, DR, DB, dtype, dev))
            valid = (torch.randint(0, DB + 1, (DR,), dtype=torch.int32, device=dev, generator=gen)
                     if t == 2 else None)
            hashes = planes(tile, fn)
            batch = tile
            if dtype == torch.int64 and t == 1:  # an 8-byte tile as its (hi, lo) planes
                w = tile.view(torch.int32).view(DR, DB, 2)
                batch = (w[..., 1].contiguous(), w[..., 0].contiguous())
            ref = dplain.update_prehashed(clone(s), tile, hashes, valid)
            s = dkern.update_prehashed_cuda(s, batch, hashes, valid)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_err(s, ref))
            checked += 1
            if not same(s, ref):
                fail(f"[40 hash] pre-hashed distinct_update != update_prehashed ({dtype}, tile {t}: {kind})")
        log(f"[40 hash] pre-hashed kernel vs plain, {dtype}, R {DR}, k {DK}: 4 tiles (random from empty, Zipf, "
            "ragged Zipf, Zipf) bit-identical")
        del s, ref
    for dtype, fn, k_big in ((torch.int32, hash_narrow, 19371), (torch.int64, hash_wide, 14529)):
        wide = dtype == torch.int64
        if dkern.kernel_info(k_big, wide, rule=dkern.HASHED)["dynamic_smem"] != 0:
            fail(f"[40 hash] the pre-hashed kernel at k {k_big} ({dtype}) reports a block in shared memory")
        s = dplain.init(key_from_seed(41), 8, k_big, sample_dtype=dtype, device=dev)
        for t in range(2):
            tile = wide_or_narrow(torch.randint(-(2**62), 2**62, (8, 12288), generator=gen, device=dev), dtype)
            hashes = planes(tile, fn)
            ref = dplain.update_prehashed(clone(s), tile, hashes)
            s = dkern.update_prehashed_cuda(s, tile, hashes)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_err(s, ref))
            checked += 1
            if not same(s, ref):
                fail(f"[40 hash] pre-hashed kernel != plain beyond shared memory ({dtype}, k {k_big}, tile {t})")
        if int(s.size.min().item()) != k_big:
            fail(f"[40 hash] a row at k {k_big} ({dtype}) holds fewer than k keys")
        log(f"[40 hash] pre-hashed kernel vs plain, {dtype}, k {k_big} (beyond shared memory, R 8): 2 tiles "
            "bit-identical")
        del s, ref

    # the engine path with a hash_fn, 4- and 8-byte keys, against an oracle
    main_launches, rates = 0, {}
    for name, dtype, fn in (("int32", torch.int32, hash_narrow), ("int64", torch.int64, hash_wide)):
        gen.manual_seed(42)
        dev_tiles = [zipf_keys(gen, DR, DB, dtype, dev) for _ in range(HASH_DEV_TILES)]
        host_tiles = [zipf_keys(gen, DR, DB, dtype, dev).cpu().numpy() for _ in range(HASH_HOST_TILES)]
        torch.cuda.synchronize()
        zero_launches()
        eng = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=DK, num_reservoirs=DR, tile_size=DB,
                                                    distinct=True, element_dtype=name), key=0, hash_fn=fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tile in dev_tiles:
            eng.sample(tile)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        for tile in host_tiles:
            eng.sample(tile)
        torch.cuda.synchronize()
        n = HASH_DEV_TILES + HASH_HOST_TILES
        got = hook_launches()
        if got != only("distinct_update_prehashed", n):
            fail(f"[40 hash] the hooked distinct engine ({name}) launched {got} for {n} tiles")
        main_launches += got["distinct_update_prehashed"]
        salts = distinct_state_to_numpy(eng.state)["salts"][:ROWS_CPU]
        samples, sizes = eng.result_arrays()
        # the oracle on rows 0..1023 (numpy over all 4,096 would take ~15 s a width)
        ok, msg = user_hash_oracle([t[:ROWS_CPU].cpu().numpy() for t in dev_tiles]
                                   + [t[:ROWS_CPU] for t in host_tiles], salts, fn, samples[:ROWS_CPU],
                                   sizes[:ROWS_CPU], DK)
        if not ok:
            fail(f"[40 hash] hooked distinct engine ({name}): {msg}")
        rates[name] = HASH_DEV_TILES * DR * DB / t_dev
        log(f"[40 hash] engine with hash_fn, {name} Zipf keys: {n} tiles, {got['distinct_update_prehashed']} "
            f"pre-hashed launches, rows 0..{ROWS_CPU - 1} equal the exact (hash, key) oracle, sizes {int(sizes.min())}.."
            f"{int(sizes.max())}; {rates[name]:.6e} elem/s fed from the device")
        del eng, dev_tiles, host_tiles

    # timings: a steady Zipf tile and a tile from empty, the pre-hashed
    # kernel beside the default-hash kernel on the same keys
    timings = {}
    steady_default = None
    for label, pre_s, def_s, tile, hashes in prehashed_timing_cases(gen, dev):
        if steady_default is None:
            steady_default = (def_s, tile)
        ms = event_ms(lambda st: dkern.update_prehashed_cuda(st, tile, hashes), setup=lambda: clone(pre_s),
                      batch=10)
        default_ms = event_ms(lambda st: dkern.update_prehashed_cuda(st, tile, None), setup=lambda: clone(def_s),
                              batch=10)
        # the hash pass apart: the user's hash_fn alone, then with its
        # words made the kernel's int32 planes (a view for 32-bit words)
        user_hash_ms = event_ms(lambda _: hash_narrow(tile), batch=10)
        hash_ms = event_ms(lambda _: planes(tile, hash_narrow), batch=10)
        plain_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ref = dplain.update_prehashed(pre_s, tile, hashes)
            torch.cuda.synchronize()
            plain_times.append(1e3 * (time.perf_counter() - t0))
        inserts, rows_in = net_inserts_by_key(pre_s, ref)
        bound, by = distinct_bound_ms(DR * DB, False, inserts, rows_in, prehashed=True)
        timings[label] = {"ms": ms, "default_hash_ms": default_ms, "hash_pass_ms": hash_ms,
                          "user_hash_ms": user_hash_ms,
                          "plain_ms": statistics.median(plain_times), "bound_ms": bound, "bound_by": by,
                          "net_inserts": inserts, "rows_inserting": rows_in}
        del ref
    # a mapped distinct tile (map_fn alone) is one keep-max launch after
    # the map pass, with no hash planes; exact launch counts
    mstate, mtile = steady_default
    zero_launches()
    got = dkern.update_cuda(clone(mstate), mtile, map_fn=map_halve)
    torch.cuda.synchronize()
    counted = hook_launches()
    if counted != only("distinct_update_keepmax", 1):
        fail(f"[40 hash] a mapped distinct tile launched {counted}, not one distinct_update_keepmax")
    ref = dplain.update(clone(mstate), mtile, map_fn=map_halve)
    if not same(got, ref):
        fail("[40 hash] a mapped distinct tile through keep-max != the plain version")
    mapped = dplain.map_keys(mstate, mtile, map_halve)
    mapped_tile = {
        "launches": counted["distinct_update_keepmax"],
        "one_call_ms": event_ms(lambda st: dkern.update_cuda(st, mtile, map_fn=map_halve),
                                setup=lambda: clone(mstate), batch=10),
        "map_ms": event_ms(lambda _: dplain.map_keys(mstate, mtile, map_halve), batch=10),
        "keepmax_ms": event_ms(lambda st: dkern.launch(st, mapped, None, None, None, dkern.KEEPMAX),
                               setup=lambda: clone(mstate), batch=10),
        "default_ms": event_ms(lambda st: dkern.update_prehashed_cuda(st, mapped, None),
                               setup=lambda: clone(mstate), batch=10),
    }
    del got, ref, mapped
    card = card_line()
    log(f"[40 hash] {card} | a mapped distinct tile (map_fn alone, steady Zipf after 8): "
        f"{mapped_tile['launches']} distinct_update_keepmax launch and no other, == the plain version; one "
        f"call {mapped_tile['one_call_ms']:.4f} ms = the map pass {mapped_tile['map_ms']:.4f} ms and the "
        f"keep-max launch {mapped_tile['keepmax_ms']:.4f} ms (the default kernel on the mapped keys "
        f"{mapped_tile['default_ms']:.4f} ms)")
    build = dkern.kernel_info(DK, False, rule=dkern.HASHED)
    for label, t in timings.items():
        log(f"[40 hash timings] {card} | {label}: pre-hashed kernel {t['ms']:.4f} ms (default-hash kernel "
            f"{t['default_hash_ms']:.4f} ms on the same keys), plain {t['plain_ms']:.1f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), net inserts {t['net_inserts']} over "
            f"{t['rows_inserting']} rows; the hash pass {t['hash_pass_ms']:.4f} ms (the user's hash_fn alone "
            f"{t['user_hash_ms']:.4f} ms); build {build_text(build)}")
    steady = timings["steady Zipf tile after 8"]
    entry = {
        "name": "distinct_update_prehashed",
        "route": "cuda",
        "source": "reservoir_tpu_torch/csrc/distinct.cu",
        "replaces": "reservoir_tpu/ops/distinct_pallas.py:129",
        "replaces_note": "the pre-hashed instantiation of distinct_update; under a hash_fn the reference "
                         "declines its Pallas kernel and runs XLA (reservoir_tpu/ops/distinct.py:232)",
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": steady["ms"],
        "plain_ms": steady["plain_ms"],
        "bound_ms": steady["bound_ms"],
        "bound_by": steady["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a deduplicating bottom-k merge",
        "steady_zipf_tile": steady,
        "fill_tile": timings["Zipf tile from empty"],
        "tiles_checked": checked,
        "engine_elem_per_s": rates,
        "build": {"int32": build, "int64": dkern.kernel_info(DK, True, rule=dkern.HASHED)},
    }
    return {"tiles_checked": checked, "engine_launches": main_launches, "timings": timings,
            "mapped_tile": mapped_tile}, entry


def fused_phase(gen, dev, extra: dict) -> dict:
    """Phase 41: ``sample_stream(fused=True)`` at full width in the three
    modes, with WIDE counters and with hooks, each against the per-tile
    path bit for bit, one launch a tile; elements/s fed from the host."""
    import reservoir_tpu_torch as rtt

    out = {}
    modes = {
        "uniform": ("algl_update", dict(max_sample_size=K, num_reservoirs=R, tile_size=B), {}),
        "wide": ("algl_update_wide", dict(max_sample_size=K, num_reservoirs=R, tile_size=B, count_dtype="wide"),
                 {}),
        "weighted": ("weighted_update", dict(max_sample_size=WK, num_reservoirs=WR, tile_size=WB, weighted=True),
                     {}),
        "distinct": ("distinct_update", dict(max_sample_size=DK, num_reservoirs=DR, tile_size=DB, distinct=True,
                                             element_dtype="int64"), {}),
        "distinct_hooked": ("distinct_update_prehashed", dict(max_sample_size=DK, num_reservoirs=DR,
                                                              tile_size=DB, distinct=True),
                            dict(map_fn=map_halve, hash_fn=hash_narrow)),
    }
    for mode, (name, kw, hooks) in modes.items():
        n = FUSED_TILES[mode]
        rows, width = kw["num_reservoirs"], kw["tile_size"]
        N = n * width + FUSED_TAIL
        gen.manual_seed(41)
        if kw.get("distinct"):
            dtype = torch.int64 if kw.get("element_dtype") == "int64" else torch.int32
            stream = zipf_keys(gen, rows, N, dtype, dev).cpu().numpy()
        else:
            stream = torch.randint(-(2**31), 2**31 - 1, (rows, N), dtype=torch.int32, device=dev,
                                   generator=gen).cpu().numpy()
        w = weight_tile(gen, rows, N, "zeros", dev).cpu().numpy() if kw.get("weighted") else None
        cfg = rtt.SamplerConfig(**kw)
        fused = rtt.ReservoirEngine(cfg, key=0, reusable=True, **hooks)
        tiled = rtt.ReservoirEngine(cfg, key=0, reusable=True, **hooks)
        launches = {}
        for turn, eng in (("per_tile", tiled), ("fused", fused)):
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            eng.sample_stream(stream, weights=w, fused=turn == "fused")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[turn] = hook_launches()
        want = only(name, n + 1)
        if mode == "distinct":  # the ragged tail passes valid: keep-max
            want = {**only(name, n), "distinct_update_keepmax": 1}
        if launches["fused"] != want or launches["per_tile"] != want:
            fail(f"[41 fused] {mode}: launches fused {launches['fused']}, per tile {launches['per_tile']} for "
                 f"{n} full tiles and a ragged tail")
        if not same(fused._state, tiled._state):
            fail(f"[41 fused] {mode}: the fused stream != the per-tile path")
        eps = rows * N / seconds  # the second run, warm
        out[mode] = {"tiles": n, "tail": FUSED_TAIL, "launches": launches["fused"][name],
                     "host_fed_elem_per_s": eps, "seconds": seconds}
        extra.setdefault(name, {})["fused_launches"] = launches["fused"][name]
        extra[name]["fused_host_fed_elem_per_s"] = eps
        log(f"[41 fused] {card_line()} | {mode}, [{rows}, {N}] host stream ({n} full tiles of {width} and a tail "
            f"of {FUSED_TAIL}){' with map_fn and hash_fn' if hooks else ''}: {launches['fused'][name]} {name} "
            f"launches, == the per-tile path; fed from the host {eps:.6e} elem/s (warm)")
        del fused, tiled, stream, w
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- the sharded engine (L4)

# phase 42: ranks of the meshes (all on the one card), and each engine's
# tiles from the device and from the host; the ranks of the device="cpu"
# references (2: meshed, at a quarter of 8 ranks' cost, since the plain
# versions' time goes by launch, not by row)
MESH_RANKS = 8
MESH_DEV_TILES, MESH_HOST_TILES = 10, 2
MESH_CPU_RANKS = 2
# phase 44: the meshed bridge's lockstep tiles (phase 23's bridge shape)
MESH_BRIDGE_TILES = 8
#: phase 42's configurations: (label, kernel, config)
MESH_CASES = (
    ("config 5", "algl_update", dict(max_sample_size=K, num_reservoirs=R, tile_size=B)),
    ("config 5, WIDE counters", "algl_update_wide", dict(max_sample_size=K, num_reservoirs=R, tile_size=B,
                                                         count_dtype="wide")),
    ("weighted config 4", "weighted_update", dict(max_sample_size=WK, num_reservoirs=WR, tile_size=WB,
                                                  weighted=True)),
    ("distinct, Zipf int64 keys", "distinct_update", dict(max_sample_size=DK, num_reservoirs=DR, tile_size=DB,
                                                          distinct=True, element_dtype="int64")),
)


def mesh_cpu_engine(kw: dict, path: str) -> dict:
    """Phase 42's reference, in a child process: a meshed ``device="cpu"``
    engine (``MESH_CPU_RANKS`` ranks) of ``ROWS_CPU`` rows fed rows
    0..ROWS_CPU-1 of every tile (``path``: ``t{i}``, ``w{i}``); its state
    as numpy."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch import convert
    from reservoir_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    eng = rtt.ReservoirEngine(rtt.SamplerConfig(**{**kw, "num_reservoirs": ROWS_CPU}, mesh_axis="res"), key=0,
                              mesh=make_mesh(devices=["cpu"] * MESH_CPU_RANKS))
    with np.load(path) as data:
        for i in range(MESH_DEV_TILES + MESH_HOST_TILES):
            eng.sample(data[f"t{i}"], weights=data[f"w{i}"] if f"w{i}" in data.files else None)
    return convert.state_to_numpy(eng.state)


def mesh_bridge_data() -> np.ndarray:
    """Phase 44's streams, ``[RR, MESH_BRIDGE_TILES * RB]`` int32 from a
    numpy seed (the parent and the child make the same)."""
    return np.random.default_rng(44).integers(-(2**31), 2**31 - 1, (RR, MESH_BRIDGE_TILES * RB),
                                              dtype=np.int32)


def mesh_bridge_feed(bridge, data: np.ndarray, tiles) -> None:
    """Lockstep tiles of phase 44's streams through ``push_interleaved``."""
    streams = np.tile(np.arange(RR, dtype=np.int32), RB)
    for t in tiles:
        bridge.push_interleaved(streams, np.ascontiguousarray(data[:, t * RB:(t + 1) * RB].T).ravel())


def mesh_bridge_cpu() -> list:
    """Phase 44's reference, in a child process: a meshed ``device="cpu"``
    bridge fed every tile; its samples."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=RR, tile_size=RB, mesh_axis="res")
    bridge = rtt.DeviceStreamBridge(cfg, key=0, mesh=make_mesh(devices=["cpu"] * MESH_CPU_RANKS))
    mesh_bridge_feed(bridge, mesh_bridge_data(), range(MESH_BRIDGE_TILES))
    return bridge.complete()


def same_host(a: dict, b: dict) -> bool:
    """Two states as numpy field dicts, every field's bytes equal."""
    return a.keys() == b.keys() and all(
        (a[f] is None) == (b[f] is None) and (a[f] is None or np.array_equal(a[f].view(np.uint8),
                                                                            b[f].view(np.uint8)))
        for f in a)


def sharded_phases(gen, dev, here: str) -> tuple:
    """Phases 42-44: meshed engines over 8 ranks of the one card against
    the unmeshed card engine and a meshed ``device="cpu"`` engine,
    ``sharded_result`` at config 5 against the plain gather, and a meshed
    bridge with its recovery; the ``device="cpu"`` references run in
    child processes while the card works.  Returns the ``sharded`` line
    and the additions to the update and gather kernels' entries (by
    name)."""
    import concurrent.futures
    import multiprocessing

    work = os.path.join(here, "build", "chip_smoke")  # gitignored
    os.makedirs(work, exist_ok=True)
    line, extra = {}, {}
    pool = concurrent.futures.ProcessPoolExecutor(len(MESH_CASES) + 1,
                                                  mp_context=multiprocessing.get_context("spawn"))
    try:
        bridge_ref = pool.submit(mesh_bridge_cpu)
        line["engines"], shards, cpu_refs = mesh_engine_phase(gen, dev, extra, pool, work)
        gc.collect()
        torch.cuda.empty_cache()
        line["result"] = sharded_result_phase(dev, shards, extra)
        del shards
        gc.collect()
        torch.cuda.empty_cache()
        line["bridge"] = mesh_bridge_phase(dev, work, extra, bridge_ref)
        t0 = time.perf_counter()
        for label, (future, got) in cpu_refs.items():
            if not same_host(future.result(timeout=900), got):
                fail(f"[42 meshed engine] {label}: the card's meshed engine != a meshed device=\"cpu\" engine "
                     f"on rows 0..{ROWS_CPU - 1}")
        waited = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    line["cpu_reference_wait_s"] = waited
    log(f"[42 meshed engine] every configuration's rows 0..{ROWS_CPU - 1} == a meshed device=\"cpu\" engine "
        f"({MESH_CPU_RANKS} CPU ranks, in child processes; {waited:.1f} s waited after phase 44)")
    gc.collect()
    torch.cuda.empty_cache()
    return line, extra


def mesh_engine_phase(gen, dev, extra: dict, pool, work: str) -> tuple:
    """Phase 42: each configuration's meshed engine (8 ranks of the card)
    fed 10 device and 2 host tiles: 8 launches a tile of the mode's kernel
    and no other, its state equal to the unmeshed card engine's bit for
    bit; elem/s fed from the device and from the host beside the unmeshed
    engine's, each engine warmed by one tile first.  Submits each
    ``device="cpu"`` reference to ``pool``.  Returns the phase's record,
    config 5's meshed shards, and by configuration the reference's future
    beside the card's rows 0..1023 as numpy."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch import convert
    from reservoir_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=[dev] * MESH_RANKS)
    out, kept, refs = {}, None, {}
    n = MESH_DEV_TILES + MESH_HOST_TILES
    for i, (label, name, kw) in enumerate(MESH_CASES):
        rows, width = kw["num_reservoirs"], kw["tile_size"]
        gen.manual_seed(42)
        if kw.get("distinct"):
            tiles = [zipf_keys(gen, rows, width, torch.int64, dev) for _ in range(n)]
        else:
            tiles = [torch.randint(-(2**31), 2**31 - 1, (rows, width), dtype=torch.int32, device=dev,
                                   generator=gen) for _ in range(n)]
        weights = ([weight_tile(gen, rows, width, "zeros", dev) for _ in range(n)]
                   if kw.get("weighted") else [None] * n)
        path = os.path.join(work, f"mesh_rows_{i}.npz")
        cpu_rows = {f"t{j}": t[:ROWS_CPU].cpu().numpy() for j, t in enumerate(tiles)}
        cpu_rows.update({f"w{j}": w[:ROWS_CPU].cpu().numpy() for j, w in enumerate(weights) if w is not None})
        np.savez(path, **cpu_rows)
        del cpu_rows
        future = pool.submit(mesh_cpu_engine, kw, path)
        host = [(t.cpu().numpy(), None if w is None else w.cpu().numpy())
                for t, w in zip(tiles[MESH_DEV_TILES:], weights[MESH_DEV_TILES:])]
        rates, engines = {}, {}
        for which, ekw in (("meshed", dict(mesh=mesh)), ("unmeshed", dict(device=dev))):
            cfg = rtt.SamplerConfig(**kw, mesh_axis="res" if which == "meshed" else None)
            warm = rtt.ReservoirEngine(cfg, key=1, **ekw)
            warm.sample(tiles[0], weights=weights[0])
            warm.sample(*host[0][:1], weights=host[0][1])
            del warm
            torch.cuda.synchronize()
            zero_launches()
            eng = rtt.ReservoirEngine(cfg, key=0, **ekw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for tile, w in zip(tiles[:MESH_DEV_TILES], weights[:MESH_DEV_TILES]):
                eng.sample(tile, weights=w)
            torch.cuda.synchronize()
            t_dev = time.perf_counter() - t0
            t0 = time.perf_counter()
            for tile, w in host:
                eng.sample(tile, weights=w)
            torch.cuda.synchronize()
            t_host = time.perf_counter() - t0
            got = hook_launches()
            per = MESH_RANKS if which == "meshed" else 1
            if got != only(name, per * n):
                fail(f"[42 meshed engine] {label}, {which}: launches {got} for {n} tiles, not {per * n} of "
                     f"{name} alone")
            if which == "meshed":
                extra.setdefault(name, {})["meshed_launches"] = got[name]
            rates[which] = {"device_fed": MESH_DEV_TILES * rows * width / t_dev,
                            "host_fed": MESH_HOST_TILES * rows * width / t_host}
            engines[which] = eng
        meshed, single = engines["meshed"], engines["unmeshed"]
        if len(meshed._shards) != MESH_RANKS or not same(meshed.state, single.state):
            fail(f"[42 meshed engine] {label}: the meshed engine != the unmeshed card engine")
        refs[label] = (future, convert.state_to_numpy(clone(meshed.state, ROWS_CPU, "cpu")))
        sizes = meshed.peek_arrays()[1]
        out[label] = {"launches": got[name], "ranks": MESH_RANKS, "rows_a_rank": rows // MESH_RANKS,
                      "elem_per_s": rates, "min_size": int(sizes.min())}
        extra[name]["meshed_elem_per_s"] = rates
        log(f"[42 meshed engine] {card_line()} | {label}, {MESH_RANKS} ranks of the card ({rows // MESH_RANKS} "
            f"rows a rank): {n} tiles, {got[name]} {name} launches; state == the unmeshed card engine; elem/s "
            f"fed from the device {rates['meshed']['device_fed']:.6e} (unmeshed "
            f"{rates['unmeshed']['device_fed']:.6e}), from the host {rates['meshed']['host_fed']:.6e} (unmeshed "
            f"{rates['unmeshed']['host_fed']:.6e})")
        if name == "algl_update":
            kept = meshed._shards
        del engines, meshed, single, tiles, weights, host
        gc.collect()
        torch.cuda.empty_cache()
    return out, kept, refs


def sharded_result_phase(dev, shards, extra: dict) -> dict:
    """Phase 43: ``sharded_result`` of config 5's meshed state: one
    ``merge_ring_gather`` launch, every rank's words equal to
    ``gather_parts_plain``'s, the total the host's sum with its int32
    wrap; the gather timed beside its bytes bound and the library call
    (the ``torch.cat`` of per-rank ``.to()`` copies onto every rank,
    ``gather_parts_plain``), and the whole call."""
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.parallel import make_mesh, sharded_result

    mesh = make_mesh(devices=[dev] * MESH_RANKS)
    call = sharded_result(mesh)
    torch.cuda.synchronize()
    mkern.launches = 0
    samples, sizes, totals = call(shards)
    torch.cuda.synchronize()
    launches = mkern.launches
    if launches != 1:
        fail(f"[43 sharded_result] {launches} merge_ring_gather launches, not 1")
    comm = mkern.RingCommunicator(mesh.devices)
    leaves = [(*plain.result(s), s.count) for s in shards]
    want = mkern.gather_parts_plain(leaves, comm)
    total = int(sum(int(s.count.long().sum().item()) for s in shards))
    wrapped = (total + 2**31) % 2**32 - 2**31
    for r, (s, z, t, w) in enumerate(zip(samples, sizes, totals, want)):
        if not (torch.equal(bits(s), bits(w[0])) and torch.equal(z, w[1])) or int(t.item()) != wrapped:
            fail(f"[43 sharded_result] rank {r}'s samples, sizes or total != the plain gather's and the host sum")
    del samples, sizes, totals, want
    d = MESH_RANKS
    words = sum(t.numel() for t in leaves[0])
    times = gather_times(leaves, comm)
    gather_ms = times["call_1_ms"]
    library_ms = event_ms(lambda _: mkern.gather_parts_plain(leaves, comm))
    call_ms = event_ms(lambda _: call(shards))
    nbytes = (d + d * d) * words * 4
    bound = 1e3 * nbytes / PEAK_BYTES
    mkern.launches = launches
    rec = {"launches": launches, "ranks": d, "words_a_rank": words, "total": wrapped, "gather_ms": gather_ms,
           "gather_ms_note": "one gather_parts call between the events", **times,
           "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms, "sharded_result_ms": call_ms}
    extra.setdefault("merge_ring_gather", {}).update({"meshed_launches": launches, "sharded_result": rec})
    log(f"[43 sharded_result] {card_line()} | config 5 over {d} ranks of the card: {launches} merge_ring_gather "
        f"launch, every rank's samples, sizes == gather_parts_plain, total {wrapped} == the host sum (int32 "
        f"wrap); the gather of {words} words a rank {gather_ms:.4f} ms (one gather_parts call between the "
        f"events; 10 back to back {times['call_ms']:.4f} ms a call, the bare launch {times['launch_ms']:.4f} ms, "
        f"the host {times['host_ms']:.4f} ms a call), bound {bound:.4f} ms (bytes, "
        f"(d + d^2) n 4), the library call (torch.cat of per-rank .to() onto every rank) {library_ms:.4f} ms; "
        f"the whole sharded_result {call_ms:.4f} ms")
    return rec


def mesh_bridge_phase(dev, work: str, extra: dict, reference) -> dict:
    """Phase 44: a meshed bridge (R 4,096, B 1,024, 8 ranks of the card)
    with ``gated=True`` (inert, with the reference's reason) over lockstep
    ``push_interleaved`` tiles: 8 kernels a flush, its samples equal to a
    meshed ``device="cpu"`` bridge's (``reference``, a child's future);
    then a journaling meshed bridge dropped after 5 tiles and
    ``recover()``-ed onto the mesh, the rest fed: the same samples."""
    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=[dev] * MESH_RANKS)
    cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=RR, tile_size=RB, mesh_axis="res")
    n = MESH_BRIDGE_TILES
    data = mesh_bridge_data()
    torch.cuda.synchronize()
    zero_launches()
    live = rtt.DeviceStreamBridge(cfg, key=0, mesh=mesh, gated=True)
    reason = live.gate_inert_reason
    if live.gate_active or reason != "meshed engine (gated dispatch is single-device)":
        fail(f"[44 meshed bridge] gated=True is not inert with the reference's reason: {reason!r}")
    t0 = time.perf_counter()
    mesh_bridge_feed(live, data, range(n))
    live.flush()
    live.drain_barrier()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    flushes = live.metrics.flushes
    got = live.complete()
    launches = hook_launches()
    if launches != only("algl_update", MESH_RANKS * flushes):
        fail(f"[44 meshed bridge] launches {launches} for {flushes} flushes, not {MESH_RANKS} a flush")
    extra.setdefault("algl_update", {})["meshed_bridge_launches"] = launches["algl_update"]
    del live
    ckdir = os.path.join(work, "meshed_recovery")
    shutil.rmtree(ckdir, ignore_errors=True)
    dropped = rtt.DeviceStreamBridge(cfg, key=0, mesh=mesh, checkpoint_dir=ckdir, checkpoint_every=3)
    mesh_bridge_feed(dropped, data, range(n // 2 + 1))
    dropped.drain_barrier()
    seq = dropped.flushed_seq
    del dropped  # the crash: the staged rows are lost
    gc.collect()
    before = kern.launches
    t0 = time.perf_counter()
    recovered = rtt.DeviceStreamBridge.recover(ckdir, mesh=mesh)
    recover_s = time.perf_counter() - t0
    replayed = kern.launches - before
    counts = recovered.engine.state.count.cpu().numpy()
    # the flushes journaled since the last checkpoint replay, 8 launches each
    if (recovered.flushed_seq != seq or len(recovered.engine._shards) != MESH_RANKS
            or replayed != MESH_RANKS * (seq % 3) or not replayed):
        fail(f"[44 meshed bridge] recovered at flush {recovered.flushed_seq} of {seq}, over "
             f"{len(recovered.engine._shards)} ranks, {replayed} launches replayed")
    if (counts != counts[0]).any() or counts[0] % RB:
        fail(f"[44 meshed bridge] the recovered rows' durable counts are not one whole tile: "
             f"{counts.min()}..{counts.max()}")
    mesh_bridge_feed(recovered, data, range(int(counts[0]) // RB, n))
    resumed = recovered.complete()
    shutil.rmtree(ckdir, ignore_errors=True)
    want = reference.result(timeout=900)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail("[44 meshed bridge] the card's meshed bridge != the meshed device=\"cpu\" bridge")
    if not all(np.array_equal(a, b) for a, b in zip(resumed, want)):
        fail("[44 meshed bridge] the recovered meshed bridge's samples != the meshed device=\"cpu\" bridge's")
    rec = {"tiles": n, "flushes": flushes, "launches": launches["algl_update"], "gate_inert_reason": reason,
           "host_fed_elem_per_s": n * RR * RB / seconds, "recovered_at_flush": seq,
           "replayed_launches": replayed, "recover_s": recover_s}
    log(f"[44 meshed bridge] {card_line()} | R {RR}, B {RB}, {MESH_RANKS} ranks of the card, gated=True inert "
        f"({reason}): {n} lockstep tiles through push_interleaved, {flushes} flushes, {launches['algl_update']} "
        f"algl_update launches; samples == a meshed device=\"cpu\" bridge; {rec['host_fed_elem_per_s']:.6e} "
        f"elem/s fed from the host; a journaling meshed bridge dropped at flush {seq}, recover(mesh=) in "
        f"{recover_s:.2f} s ({replayed} launches replayed), the rest fed: samples == device=\"cpu\"")
    return rec


# ------------------------------------------- the selftest, the mesh over processes, the load tools

# phase 46: two processes, each 4 ranks of the card, joined over gloo
MESH2_PROCESSES, MESH2_RANKS = 2, 4
# phase 47: the open-loop run on the card (the load tool's defaults, 3 s),
# and the short schedule held against device="cpu" under an injected clock
LOAD_SPEC = dict(duration_s=3.0, rate=2000.0, sessions=1000, zipf_s=1.1, chunk=64, churn=0.01,
                 snapshot_every=13, seed=47)
LOAD_K, LOAD_TILE = 8, 64
LOAD_CAPACITY = LOAD_SPEC["sessions"] * 4 // 5
LOAD_CHECK_SPEC = dict(duration_s=1.0, rate=300.0, sessions=100, zipf_s=0.6, chunk=64, churn=0.05,
                       snapshot_every=7, seed=48)
LOAD_CHECK_CAPACITY = 48
#: the phase's services' knobs: the builtin defaults (``DEFAULT_KNOBS``),
#: passed explicitly so no knob cache is read
LOAD_KNOBS = dict(coalesce_bytes=1 << 16, max_inflight_bytes=1 << 24, checkpoint_every=64,
                  gate_push_chunk=1 << 20, sweep_interval_s=None)
#: the selftest's name of a kernel where chip_smoke's entry differs
SELFTEST_NAMES = {"distinct_update_hashed": "distinct_update_prehashed"}


class _StepClock:
    """Phase 47's injected clock: each read moves it 0.1 ms, each sleep by
    what it asks, so the counts do not depend on the host's timing."""

    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        self.t += 1e-4
        return self.t

    def sleep(self, d: float) -> None:
        self.t += d


def load_check_run(device) -> tuple:
    """Phase 47's check: the short schedule through ``run_load`` under the
    injected clock on a service on ``device``; the result's counts, the
    service's counters and its engine's state as numpy."""
    from reservoir_tpu_torch import ReservoirService, SamplerConfig, convert, obs
    from reservoir_tpu_torch.tools import loadgen

    torch.set_num_threads(4)
    svc = ReservoirService(SamplerConfig(max_sample_size=LOAD_K, num_reservoirs=LOAD_CHECK_CAPACITY,
                                         tile_size=LOAD_TILE), key=0, pipelined=False, device=device, **LOAD_KNOBS)
    obs.enable(obs.Registry())
    try:
        clock = _StepClock()
        res = loadgen.run_load(svc, loadgen.LoadSpec(**LOAD_CHECK_SPEC), clock=clock, sleep=clock.sleep)
        svc.sync()
        state = convert.state_to_numpy(svc.bridge.engine.state)
        counters = svc.metrics.snapshot()
    finally:
        obs.disable()
        svc.shutdown()
    return res.snapshot(), counters, state


def state_digest(state) -> str:
    """The sha256 of every field of a state (numpy bytes, in field order)."""
    import hashlib

    from reservoir_tpu_torch import convert

    h = hashlib.sha256()
    for name, value in convert.state_to_numpy(state).items():
        h.update(name.encode())
        if value is not None:
            h.update(np.ascontiguousarray(value).view(np.uint8).tobytes())
    return h.hexdigest()


def mesh2_tiles(dev) -> list:
    """Phase 46's tiles, config 5's shape, from a card generator seeded 46
    (each process and the parent make the same)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(46)
    return [torch.randint(-(2**31), 2**31 - 1, (R, B), dtype=torch.int32, device=dev, generator=gen)
            for _ in range(MESH_DEV_TILES + MESH_HOST_TILES)]


def mesh2_worker(pid: int, port: int) -> dict:
    """Phase 46 in one of the two processes: join the gloo group, build the
    8-rank mesh (4 ranks of the card a process), and feed config 5's
    engine 10 device and 2 host tiles between barriers (after a warm-up
    engine's two tiles); its launches, its times, the digest of the rows
    it reads back (every row, through the collective), and
    ``sharded_result`` timed, its samples checked against the state."""
    import torch.distributed as dist

    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.ops import algorithm_l as plain
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import merge_cuda as mkern
    from reservoir_tpu_torch.parallel import make_mesh, multihost, sharded_result

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", num_processes=MESH2_PROCESSES, process_id=pid, backend="gloo",
                         timeout=300)
    mesh = make_mesh(devices=[dev] * MESH2_RANKS)
    if mesh.size != MESH2_PROCESSES * MESH2_RANKS or mesh.local_ranks != tuple(
            range(pid * MESH2_RANKS, (pid + 1) * MESH2_RANKS)):
        raise AssertionError(f"process {pid}: {mesh!r}")
    cfg = rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B, mesh_axis="res")
    tiles = mesh2_tiles(dev)
    host = [t.cpu().numpy() for t in tiles[MESH_DEV_TILES:]]
    warm = rtt.ReservoirEngine(cfg, key=1, mesh=mesh)
    warm.sample(tiles[0])
    warm.sample(host[0])
    del warm
    torch.cuda.synchronize()
    dist.barrier()
    before = kern.launches
    eng = rtt.ReservoirEngine(cfg, key=0, mesh=mesh)
    if len(eng._shards) != MESH2_RANKS:
        raise AssertionError(f"process {pid} holds {len(eng._shards)} shards")
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for t in tiles[:MESH_DEV_TILES]:
        eng.sample(t)
    torch.cuda.synchronize()
    dist.barrier()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in host:
        eng.sample(t)
    torch.cuda.synchronize()
    dist.barrier()
    t_host = time.perf_counter() - t0
    launches = kern.launches - before
    t0 = time.perf_counter()
    state = eng.state
    torch.cuda.synchronize()
    t_state = time.perf_counter() - t0
    digest = state_digest(state)
    call = sharded_result(mesh)
    call(eng._shards)  # warm
    torch.cuda.synchronize()
    dist.barrier()
    gathers = mkern.launches
    t0 = time.perf_counter()
    samples, sizes, totals = call(eng._shards)
    torch.cuda.synchronize()
    t_result = time.perf_counter() - t0
    gathers = mkern.launches - gathers
    want_s, want_z = plain.result(state)
    ok = all(torch.equal(s.view(torch.int32), want_s.view(torch.int32)) and torch.equal(z, want_z)
             for s, z in zip(samples, sizes))
    total = int(totals[0].item())
    dist.destroy_process_group()
    return {"pid": pid, "launches": launches, "device_fed_s": t_dev, "host_fed_s": t_host, "state_s": t_state,
            "sharded_result_s": t_result, "gather_launches": gathers, "result_ok": ok, "total": total,
            "digest": digest, "process_s": time.perf_counter() - t_start}


def selftest_phases(dev, here: str, sharded: dict, serve: dict) -> tuple:
    """Phases 45-47: the parity selftest in its child process, the mesh
    over two processes, and the open-loop load run.  Returns the
    ``selftest`` line and the additions to the kernels' entries (by
    name)."""
    import concurrent.futures
    import multiprocessing

    line, extra = {}, {}
    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        load_ref = pool.submit(load_check_run, "cpu")
        line["selftest"] = selftest_phase(extra)
        gc.collect()
        torch.cuda.empty_cache()
        line["mesh2"] = mesh2_phase(dev, sharded)
        gc.collect()
        torch.cuda.empty_cache()
        line["load"] = load_phase(dev, serve, load_ref)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return line, extra


def selftest_phase(extra: dict) -> dict:
    """Phase 45: ``device_selftest_subprocess(timeout_s=300)``: every
    parity and KS key true, nothing partial; the dict on a line of its
    own, and each kernel's launches in the selftest."""
    from reservoir_tpu_torch.utils.selftest import KERNEL_CHECKS, KERNELS, device_selftest_subprocess

    t0 = time.perf_counter()
    out = device_selftest_subprocess(timeout_s=300)
    seconds = time.perf_counter() - t0
    log(json.dumps({"device_selftest": out, "seconds": seconds}))
    keys = KERNEL_CHECKS + ("kernel_parity", "gated_parity", "merge_parity", "ks_ok", "ks_distinct_ok",
                            "ks_weighted_ok")
    bad = [k for k in keys if out.get(k) is not True]
    if bad or "partial" in out or "error" in out:
        fail(f"[45 selftest] not every key true: {bad}, partial {out.get('partial')!r}, error {out.get('error')!r}")
    launches = out["launches"]
    if sorted(launches) != sorted(KERNELS) or not all(launches[k] > 0 for k in KERNELS):
        fail(f"[45 selftest] a kernel was not launched in the selftest: {launches}")
    for name, n in launches.items():
        extra.setdefault(SELFTEST_NAMES.get(name, name), {})["selftest_launches"] = n
    log(f"[45 selftest] {card_line()} | device_selftest_subprocess(timeout_s=300): {len(KERNEL_CHECKS)} kernel "
        f"checks, kernel_parity, gated_parity, merge_parity true; KS uniform {out['ks_uniform']:.6f}, distinct "
        f"{out['ks_distinct']:.6f}, weighted {out['ks_weighted']:.6f} < 0.01; {sum(launches.values())} launches; "
        f"{seconds:.2f} s in all (the child's own {out['seconds']:.2f} s, after the probe)")
    return {"keys": {k: out[k] for k in keys}, "ks": {k: out[k] for k in ("ks_uniform", "ks_distinct",
                                                                         "ks_weighted")},
            "launches": launches, "seconds": seconds, "child_seconds": out["seconds"]}


def mesh2_phase(dev, sharded: dict) -> dict:
    """Phase 46: two processes joined over gloo, four ranks of the card
    each, at config 5: 4 launches a tile in each process, every row each
    reads back equal to the unmeshed card engine's (fed the same tiles
    after the processes end), ``sharded_result`` right on every rank;
    elem/s beside phase 42's one-process mesh and unmeshed engine."""
    import concurrent.futures
    import multiprocessing
    import socket

    import reservoir_tpu_torch as rtt

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    n = MESH_DEV_TILES + MESH_HOST_TILES
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(MESH2_PROCESSES,
                                                mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(mesh2_worker, pid, port) for pid in range(MESH2_PROCESSES)]
        got = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - t0
    for g in got:
        if g["launches"] != MESH2_RANKS * n:
            fail(f"[46 two-process mesh] process {g['pid']}: {g['launches']} algl_update launches for {n} tiles, "
                 f"not {MESH2_RANKS} a tile")
        if not g["result_ok"] or g["gather_launches"] != 1:
            fail(f"[46 two-process mesh] process {g['pid']}: sharded_result's rows wrong or "
                 f"{g['gather_launches']} merge_ring_gather launches, not 1")
    tiles = mesh2_tiles(dev)
    single = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=K, num_reservoirs=R, tile_size=B), key=0)
    for t in tiles[:MESH_DEV_TILES]:
        single.sample(t)
    for t in tiles[MESH_DEV_TILES:]:
        single.sample(t.cpu().numpy())
    want = state_digest(single.state)
    total = int(single.state.count.long().sum().item())
    total = (total + 2**31) % 2**32 - 2**31
    del tiles, single
    for g in got:
        if g["digest"] != want or g["total"] != total:
            fail(f"[46 two-process mesh] process {g['pid']}'s rows != the unmeshed card engine's")
    t_dev = max(g["device_fed_s"] for g in got)
    t_host = max(g["host_fed_s"] for g in got)
    rates = {"device_fed": MESH_DEV_TILES * R * B / t_dev, "host_fed": MESH_HOST_TILES * R * B / t_host}
    one = sharded["engines"]["config 5"]["elem_per_s"]
    rec = {"processes": MESH2_PROCESSES, "ranks_a_process": MESH2_RANKS, "backend": "gloo",
           "launches_a_process": [g["launches"] for g in got], "elem_per_s": rates,
           "one_process_mesh_elem_per_s": one["meshed"], "unmeshed_elem_per_s": one["unmeshed"],
           "state_read_s": max(g["state_s"] for g in got),
           "sharded_result_s": max(g["sharded_result_s"] for g in got), "wall_s": wall}
    log(f"[46 two-process mesh] {card_line()} | config 5 over {MESH2_PROCESSES} processes x {MESH2_RANKS} ranks of "
        f"the card (gloo): {n} tiles, {MESH2_RANKS * n} algl_update launches a process; every row each process "
        f"reads back == the unmeshed card engine; elem/s fed from the device {rates['device_fed']:.6e} (phase 42: "
        f"one process, 8 ranks {one['meshed']['device_fed']:.6e}, unmeshed {one['unmeshed']['device_fed']:.6e}), "
        f"from the host {rates['host_fed']:.6e} (phase 42: {one['meshed']['host_fed']:.6e}, "
        f"{one['unmeshed']['host_fed']:.6e}); the state read back {rec['state_read_s']:.4f} s, sharded_result "
        f"{rec['sharded_result_s']:.4f} s (one merge_ring_gather a process, one gloo all_gather); {wall:.1f} s "
        f"with the processes' start")
    return rec


def load_phase(dev, serve: dict, reference) -> dict:
    """Phase 47: ``run_load`` against the card service for 3 s on the load
    tool's defaults (2,000 arrivals/s, 1,000 sessions over 800 rows,
    Zipf 1.1, chunks of 64, churn 0.01, a snapshot every 13): offered and
    served, the corrected wait's p50/p99 and sessions/s beside phase 32;
    then the short schedule under the injected clock: its counts, the
    service's counters and the engine's state equal to ``device="cpu"``'s
    (``reference``, a child's future)."""
    from reservoir_tpu_torch import ReservoirService, SamplerConfig, obs
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.tools import loadgen

    svc = ReservoirService(SamplerConfig(max_sample_size=LOAD_K, num_reservoirs=LOAD_CAPACITY, tile_size=LOAD_TILE),
                           key=0, ttl_s=LOAD_SPEC["duration_s"], auditor=obs.SampleQualityAuditor(), **LOAD_KNOBS)
    reg = obs.enable(obs.Registry())
    try:
        plane = obs.SLOPlane()
        before = kern.launches
        res = loadgen.run_load(svc, loadgen.LoadSpec(**LOAD_SPEC))
        svc.sync()
        torch.cuda.synchronize()
        launches = kern.launches - before
        verdicts = {k: v.verdict for k, v in plane.evaluate().items()}
        ingest = reg.peek("serve.ingest_s")
        ingest_p = ingest.percentiles() if ingest is not None and ingest.count else (0.0, 0.0, 0.0)
    finally:
        obs.disable()
        svc.shutdown()
    r = res.snapshot()
    if r["completed"] + r["rejected"] + r["errors"] != r["offered"] or r["errors"] or not r["completed"]:
        fail(f"[47 load] offered {r['offered']} != served {r['completed']} + rejected {r['rejected']} + errors "
             f"{r['errors']}, or errors")
    if verdicts.get("sample_quality") != "ok" or not launches:
        fail(f"[47 load] the auditor's sample quality is {verdicts.get('sample_quality')!r}, launches {launches}")
    sessions_s = (r["opens"] + r["reopens"]) / r["wall_s"]
    got = load_check_run(dev)
    want = reference.result(timeout=900)
    if got[0] != want[0] or got[1] != want[1] or not same_host(got[2], want[2]):
        fail("[47 load] under the injected clock the card service's counts or state != device=\"cpu\"")
    phase32 = serve["timings"]
    rec = {"spec": LOAD_SPEC, "capacity": LOAD_CAPACITY, "result": r, "sessions_per_s": sessions_s,
           "ingest_p50_ms": 1e3 * ingest_p[0], "ingest_p99_ms": 1e3 * ingest_p[1], "slo": verdicts,
           "algl_update_launches": launches, "phase32_sessions_per_s": phase32["sessions_per_s"],
           "check": {"spec": LOAD_CHECK_SPEC, "capacity": LOAD_CHECK_CAPACITY, "result": got[0]}}
    log(f"[47 load] {card_line()} | run_load on the card service ({LOAD_CAPACITY} rows, k {LOAD_K}): "
        f"{LOAD_SPEC['rate']:.0f} arrivals/s for {LOAD_SPEC['duration_s']:.0f} s, offered {r['offered']}, served "
        f"{r['completed']}, rejected {r['rejected']}, opens {r['opens']}, reopens {r['reopens']}, closes "
        f"{r['closes']}; loadgen.wait_s p50 {1e3 * r['wait_p50_s']:.4f} ms p99 {1e3 * r['wait_p99_s']:.4f} ms, "
        f"behind at most {1e3 * r['max_behind_s']:.4f} ms; {r['achieved_rate']:.6e} arrivals/s, {sessions_s:.6e} "
        f"sessions/s (phase 32's lifecycle: {phase32['sessions_per_s']:.6e}); ingest p50 {1e3 * ingest_p[0]:.4f} "
        f"ms p99 {1e3 * ingest_p[1]:.4f} ms; SLO {verdicts}; {launches} algl_update launches; the short "
        f"schedule under the injected clock: counts, counters and state == device=\"cpu\"")
    return rec




# phase 48: the sweep's jobs, (kernel, shape, variants); the gate's three
# pairs are (gate_tile, gate_push_chunk)
GEOMETRY_JOBS = (
    ("algl", (R, K, B), None),
    ("algl", (2048, 32, 256), None),
    ("weighted", (WR, WK, WB), None),
    ("distinct", (DR, DK, DB), None),
    ("gate", (64, 16, 4096), ((64, 1 << 20), (128, 1 << 20), (64, 1 << 18))),
)
GEOMETRY_TIMEOUT_S = 240
GEOMETRY_NAMES = {"algl": "algl_update", "weighted": "weighted_update", "distinct": "distinct_update"}


def geometry_phase(dev, here: str) -> tuple:
    """Phase 48: the launch-geometry sweep into a temporary autotune cache,
    every variant's state held bit for bit against the default geometry's
    (in the sweep's child), the cache holding a variant only where it beat
    the default past its spread; then engines at config 5 and the serve
    shape that read a non-default entry (the fastest non-default variant,
    written into a second temporary cache, so that every run sends the
    engine through an ``algl_update_rows`` instantiation), their rows
    0..1023 against ``device="cpu"``.  Returns the ``geometry`` line and the
    additions to the kernels' entries (by name)."""
    from statistics import median

    import reservoir_tpu_torch as rtt
    from reservoir_tpu_torch.ops import algorithm_l_cuda as kern
    from reservoir_tpu_torch.ops import autotune, blocking
    from reservoir_tpu_torch.tools import block_sweep

    work = os.path.join(here, "build", "chip_smoke")  # gitignored
    os.makedirs(work, exist_ok=True)
    cache = os.path.join(work, "autotune.json")  # the sweep's
    engine_cache = os.path.join(work, "autotune_engine.json")  # the engines'
    out = os.path.join(work, "block_sweep.jsonl")
    for path in (cache, engine_cache, out):
        if os.path.exists(path):
            os.unlink(path)
    prev = os.environ.get("RESERVOIR_ALGL_AUTOTUNE_CACHE")
    os.environ["RESERVOIR_ALGL_AUTOTUNE_CACHE"] = engine_cache
    kind = torch.cuda.get_device_name(0)
    try:
        jobs = [{"kernel": kn, "shape": list(shape),
                 "variants": [list(v) for v in (variants or block_sweep.default_variants(kn))]}
                for kn, shape, variants in GEOMETRY_JOBS]
        t0 = time.perf_counter()
        try:
            records = block_sweep.sweep(jobs, cache, timeout=GEOMETRY_TIMEOUT_S, out=out)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            fail(f"[48 geometry] the sweep failed: {e}")
        sweep_s = time.perf_counter() - t0
        card = card_line()
        line, extra = {"card": card, "sweep_seconds": sweep_s, "turns": block_sweep.TURNS, "jobs": []}, {}
        for job in jobs:
            kn, (jr, jk, jb) = job["kernel"], job["shape"]
            recs = [r for r in records if r["kernel"] == kn and (r["R"], r["k"], r["B"]) == (jr, jk, jb)]
            if len(recs) != len(job["variants"]):
                fail(f"[48 geometry] {kn} at R={jr}, k={jk}, B={jb}: {len(recs)} records for "
                     f"{len(job['variants'])} variants")
            bad = [r for r in recs if not r["same_bits"]]
            if bad:
                fail(f"[48 geometry] {kn} at R={jr}, k={jk}, B={jb}: a variant's state differs from the "
                     f"default geometry's: {bad}")
            recorded = [r for r in recs if r["cached"]]
            if len(recorded) != (1 if any(r["beats_default"] for r in recs) else 0):
                fail(f"[48 geometry] {kn} at R={jr}: {len(recorded)} entries recorded for "
                     f"{sum(r['beats_default'] for r in recs)} variants past the default's spread")
            got = autotune.lookup(kind, jr, jk, jb, "int32", path=cache, kernel=kn)
            if kn == "gate":
                for r in recs:
                    log(f"[48 geometry] {card} | gate at R={jr}, k={jk}, B={jb}, gate_tile {r['gate_tile']}, "
                        f"gate_push_chunk {r['gate_push_chunk']}{' (default)' if r['default'] else ''}: "
                        f"{r['elem_per_sec']:.6e} elem/s host-fed at best (passes "
                        f"{', '.join(f'{x:.4f}' for x in r['s'])} s, in turns), bits equal the default's"
                        + ("; beats the default past its spread" if r["beats_default"] else ""))
                fastest = min(recs, key=lambda r: median(r["s"]))
                won = [[r["gate_tile"], r["gate_push_chunk"]] for r in recorded]
                held = None if got is None else [got.gate_tile, got.gate_push_chunk]
                entry = {"shape": [jr, jk, jb], "variants": recs,
                         "fastest": [fastest["gate_tile"], fastest["gate_push_chunk"]],
                         "recorded": won[0] if won else None}
            else:
                default = blocking.DEFAULT_BLOCK[kn]
                for r in recs:
                    log(f"[48 geometry] {card} | {GEOMETRY_NAMES[kn]} at R={jr}, k={jk}, B={jb}, "
                        f"{r['block_r']} rows a block{' (default)' if r['default'] else ''}: bare launch "
                        f"{', '.join(f'{x:.4f}' for x in r['ms'])} ms (in turns), {r['elem_per_sec']:.6e} "
                        "elem/s at best, bits equal the default's"
                        + ("; beats the default past its spread" if r["beats_default"] else ""))
                fastest = min(recs, key=lambda r: median(r["ms"]))
                won = [r["block_r"] for r in recorded]
                held = None if got is None else got.block_r
                entry = {"shape": [jr, jk, jb], "variants": recs, "default": default,
                         "fastest": fastest["block_r"], "recorded": won[0] if won else None,
                         "fastest_other": min((r for r in recs if not r["default"]),
                                              key=lambda r: median(r["ms"]))["block_r"]}
                rows = extra.setdefault(GEOMETRY_NAMES[kn], {}).setdefault("rows_a_block", {})
                rows[f"R={jr},k={jk},B={jb}"] = {
                    "default": default, "fastest": entry["fastest"], "recorded": entry["recorded"],
                    "ms": {str(r["block_r"]): median(r["ms"]) for r in recs}}
            if held != entry["recorded"]:
                fail(f"[48 geometry] the cache holds {got} for {kn} at R={jr}, not the recorded "
                     f"{entry['recorded']}")
            log(f"[48 geometry] {kn} at R={jr}, k={jk}, B={jb}: fastest (median turn) {entry['fastest']}, "
                f"recorded {entry['recorded'] if entry['recorded'] is not None else 'nothing (the default holds)'}")
            line["jobs"].append(entry)

        # engines that read a non-default entry (the fastest non-default
        # variant) at config 5 and the serve shape, each against
        # device="cpu" on rows 0..1023
        gen = torch.Generator(device=dev)
        line["engines"] = []
        for job, (er, ek, eb) in ((line["jobs"][0], (R, K, B)), (line["jobs"][1], (2048, 32, 256))):
            forced = job["fastest_other"]
            autotune.record(kind, er, ek, eb, "int32", autotune.Geometry(forced, 0, 0), path=engine_cache,
                            source="chip_smoke phase 48", kernel="algl")
            want_rows = blocking.resolve_block_r("algl", forced, er)
            if want_rows is None:
                fail(f"[48 geometry] the entry {forced} at R={er} resolves to the default launch")
            gen.manual_seed(480 + er)
            tiles = [random_tile(gen, eb, torch.int32, dev)[:er] for _ in range(3)]
            cfg = rtt.SamplerConfig(max_sample_size=ek, num_reservoirs=er, tile_size=eb)
            kern.launches = 0
            engine = rtt.ReservoirEngine(cfg, key=48, reusable=True)
            for tile in tiles:
                engine.sample(tile)
            torch.cuda.synchronize()
            launches = kern.launches
            key = ("algl", eb, "int32")
            if engine._rows_by_key.get(key, "missing") != want_rows or launches != len(tiles):
                fail(f"[48 geometry] the engine at R={er} took {engine._rows_by_key} rows a block and {launches} "
                     f"launches, not the entry's {want_rows} for {len(tiles)} tiles")
            rows = min(er, ROWS_CPU)
            cpu = rtt.ReservoirEngine(rtt.SamplerConfig(max_sample_size=ek, num_reservoirs=rows, tile_size=eb),
                                      key=48, reusable=True, device="cpu")
            for tile in tiles:
                cpu.sample(tile[:rows].cpu())
            got, want = engine.peek_arrays(), cpu.peek_arrays()
            if not all(np.array_equal(g[:rows], w) for g, w in zip(got, want)):
                fail(f"[48 geometry] the engine at R={er} at {want_rows} rows a block != device='cpu' on rows "
                     f"0..{rows - 1}")
            geometry_by_key = {"|".join(map(str, k)): (None if g is None else g._asdict())
                               for k, g in engine._geometry_by_key.items()}
            log(f"[48 geometry] engine at R={er}, k={ek}, B={eb} reading the entry {forced} (the fastest "
                f"non-default variant): _geometry_by_key {json.dumps(geometry_by_key)}, {want_rows} rows a "
                f"block, {launches} algl_update_rows launches for {len(tiles)} tiles, rows 0..{rows - 1} equal "
                "to device='cpu'")
            line["engines"].append({"shape": [er, ek, eb], "geometry_by_key": geometry_by_key,
                                    "launches": launches, "rows_a_block": want_rows})
            del engine, cpu, tiles
    finally:
        if prev is None:
            os.environ.pop("RESERVOIR_ALGL_AUTOTUNE_CACHE", None)
        else:
            os.environ["RESERVOIR_ALGL_AUTOTUNE_CACHE"] = prev
        for path in (cache, engine_cache, out):
            if os.path.exists(path):
                os.unlink(path)
    return line, extra


if __name__ == "__main__":
    main()
