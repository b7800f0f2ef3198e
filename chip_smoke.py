#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flink_siddhi_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and nvcc (it builds the port's CUDA kernels from
flink_siddhi_tpu_torch/csrc/ into build/torch_kernels/). It imports nothing
of JAX and nothing of the JAX package. Phases, each failing the run on any
fault:

1. device: the card's name and power limit;
2. build: the nine kernels (and empty ones: the launch floor, and the
   slot scan's serial floors: empty barrier rounds and empty warp
   rounds; and the float probe) compiled with -ftz=true from the
   checkout's sources, one nvcc per source, all started together
   (seconds);
3. kernels: each kernel held to its plain PyTorch version at the shapes the
   main paths use and at edge shapes — the reverse cummin exactly (int32)
   at E from 1 to 2^24 (more tiles than can be resident, so the look-back
   must progress), with and without the pad column, over random,
   all-INT_MAX, ascending, descending and full-range rows, over 1,000
   back-to-back calls, at a stack's shapes (64 rows of 8,192 and of
   131,072 events), and captured into a CUDA graph replayed on four new
   inputs at the headline's and the stack's shapes (each replay exact,
   one kernel call a replay in a profiler trace of the replays and on the
   host, one look-back epoch a replay); the chain advance exactly on
   headline-shaped inputs
   whose gathers are local (each fresh start searching from the next
   position) and on inputs with random positions, with padded and
   contiguous table rows, V = 0 (no kernel on the card), E = 0 and a
   `within` that wraps int32, and with its query axis (Q = 1 and Q = 64,
   a `within` per query or one for all, guards, E = 0, V = 0) against
   its batched plain version; the unique-window fold (NaN-aware) with its
   table bitwise equal, NaN at the same places, counts, minima and maxima
   exact and its sums and averages within rtol 1e-4, also with NaN, +inf
   and -inf values, a hot key, no event masked, codes past both ends,
   E = 3,001 and 524,287, C = 1 and C = 2^20; the slot NFA scan (K4)
   exactly (its state, scalars and whole emission buffer) against its
   plain version on CPU copies, from a carried state, on random inputs
   for eight spec shapes (quantified, sequence, cross filter, or group,
   grouped every, mid-chain every fork, and group, a full pool) at S = 64
   and E = 4,096, some at S = 1,024 and E = 16,384, with a device count of
   0 and of E, NaN and +-inf prices (the first port's 17 cases); every
   launch shape (one warp at S = 1, 31, 32, 33; more warps at S = 65,
   1,024, 2,048, 4,096), a full pool that forks at S = 64 and 96,
   programs with `/` and `%`, a 22-deep stack and 1,708 words, and the
   cross query hoisted; and captured into a CUDA graph replayed on new
   inputs; the join's pair step (K5) exactly (every rank below its cap,
   and n) against its plain version on CPU copies at E = 8,192 in six
   cases (a length window with J1's `on`; a time window over ring
   timestamps in order and out of order; past its cap with outer rows; a
   self-join with `within`; a float program with `/`, `%` and comparisons
   over subnormal values, through the interpreter K4 shares) and six of
   its slow paths (warps whose pairs overflow their staging; a union of
   bands past one shared-memory chunk, both seen walking again by the
   kernel's counter; a disordered tape under a time window; E = 8,269,
   not a multiple of the tile; a direction with no arriving event; a
   self-join of one stream with `within` and outer rows on both sides),
   and, with the plain version on the card, at E = 524,288 past its cap
   of 2,097,152 and at E = 131,072 with pairs past 2^31 (n saturated at
   2^31 - 1); a 487-word `on` program 241 deep (past the kernel's local
   stack: its global stack) at E = 1,024, one block a tile and a cut
   grid; and captured into a CUDA graph replayed on new inputs; then
   the float probe (what -ftz=true does to the intrinsics alone) is
   printed; the table mutation (K6) exactly (each row's last match, and
   the table a delete and an update leave) against its plain version at
   E = 8,192 and C = 1,024: a delete, an update with many events a row
   (the last writer wins), a float condition with no int key, an `on`
   over a select output that is no table column, an empty and a full
   table, E not a multiple of the kernel's chunk; with the plain version
   on the card, C = 16,384 (E = 65,536) and the tables path's shape (E =
   524,288, C = 1,024); the 487-word program at E = 4,096 and C = 128,
   one block a chunk and a cut grid; a CUDA graph replay; and K5 on a
   table direction
   (the stream-table join with outer rows) against its plain version;
   K3's integer path (int32 value columns, most past 2^24: the table and
   int32 minima and maxima exact, sums within rtol 1e-5) in four cases;
   and the scan windows' kernels against their plain versions (run on CPU
   copies, from a carried state the plain version left after a first
   batch): K7 (session_scan) equal as stored, sums too, at S1's shape
   (524,288 events, 1,024 keys, stragglers, an int column), unkeyed and
   at 64 keys; K8 (frequency_scan) at F1's and F2's shapes, a full lossy
   table (victims), codes past its lookup map, a 70,000-slot table in
   device memory and Zipf codes; K9 (sort_window_scan) at O1's and O2's
   shapes, C = 100 with NaN keys and a 20,000-slot buffer in device
   memory (``check_scan_windows``);
4. headline: the bench's 3-step `every ... within 5 sec` chain pattern
   through compile_plan -> BatchSource -> Job at batch 524,288 over a
   10,485,760-event stream (N_BATCHES = 20 tapes), with the launch
   counters reset just before
   and read just after; rows checked against the port's own CPU path on
   the first 1,048,576 events;
5. filter: the bench's filter query, the same way;
5b. bench main path: the headline, the filter and pattern2 as bench.py
   runs them, with EngineConfig(lazy_projection=True,
   pred_pushdown=True): the streaming Job over the first BENCH_TAPES = 14
   tapes (20 before phase 8i came, cut for the time limit: 14 keep two
   full resident segments of 7), one step a micro-batch (rows of the first 1,048,576 events held to the CPU path
   under the same settings; host syncs equal to the drain fetches alone),
   then ResidentReplay counts-only, each segment one CUDA graph replay —
   stage seconds (the graphs' warm-up and capture included), run() +
   flush() and three rerun()s (events/s median and best of the reruns),
   emitted counts equal to the streaming run's, the chain kernels
   launched once per compacted step, as often as on the eager path (the
   resident replay pads no segment; every step compacted on the
   host-known bound, with no read), graphs captured,
   no eager segment, one staged segment under sync debug mode "error",
   wire bytes per event from the staged segments, peak device memory
   allocated and reserved (the graph pools), a profiler-traced rerun's
   idle share, device records and host ops a segment, and its kernel
   calls on the card (kernel records in the trace, equal to the host's
   counts, which a replay adds back rather than counts at a launch) —
   and a resident run with a collector over the whole stream, whose rows
   equal the streaming rows (a graph replays segments it was not
   captured on), with no lazy-ring miss; then the fused streaming Job (8
   tapes a segment, bench.py's settings): its rows over the whole stream
   equal to the one-step-a-tape card path's and, on the first 1,048,576
   events, to the CPU path's, then counts-only over the whole stream: a
   warm run (the captures), three timed runs (events/s median and best,
   launches, host syncs, uploads), a traced run (kernel calls on the card
   equal to the host's counts); no eager segment, and no capture after
   the warm run. A line "graphs" after phase 8 gathers every path's
   resident and fused numbers. Every drain is asynchronous: each resident
   run's run loop waits at most once, at the end, besides its forced
   completions (reported), the fetch thread's waits equal the drains'
   fetches, and the drains whose counts reached the host while a later
   segment still ran are counted (drains overlapped: the headline must
   have some); last, a fused Job captures after a dropped resident Job,
   with one collection inside its first capture (``capture_after_drop``);
5c. drain pipeline: the five bench configs in sink mode as bench.py's
   _mode_sink runs them (fused, build_job's settings, prewarm_drains(), a
   columnar counting sink on every output stream; a warm run over two
   micro-batches, then one timed run): events/s, rows, an exact checksum
   of the timestamps and numeric columns, the columnar flag read back
   from the job (headline, filter, pattern2 and window_groupby must take
   the lane); then the same with a row sink, whose rows and checksum must
   be equal (window_groupby on 2,097,152 events and multiquery64 on
   1,048,576, cut for time); then the headline paced as bench.py's
   _latency_phase sets it (batch 131,072, drain interval 60 ms, 25% of
   the fused headline's events/s from phase 5b, about 3 s): drain.total
   and drain.staleness p50 and p99 from Job.telemetry. A line "drain"
   after phase 8 gathers them;
6. quote board: `#window.unique(symbol)` with count/sum/avg/min/max over
   StockStream, 10,000 Zipf-weighted symbols (a 16,384-slot table), at
   batch 524,288 over 4,194,304 events (QUOTE_BATCHES = 8; 20 before
   phase 8i came, cut for the time limit), the unique-window fold called
   once per micro-batch and host syncs counted (drains only); rows checked
   against the port's CPU path on the first 32,768 events; then the fused
   streaming Job, as in phase 5b (its rows over the 8 micro-batches
   equal to the one-step-a-tape card path's);
7. windows (in a process of its own, `--windows`): the bench's
   window_groupby (`#window.length(1000) select id,
   sum(price), count() group by id`, 1,000 ids) as phase 5b runs the
   bench main path over WINDOW_GROUPBY_BATCHES = 14 tapes of 524,288 (20
   before phase 8h came, cut for the time limit; two resident segments of
   7 tapes, so the row check replays a graph on a segment it was not
   captured on) — streaming rows of the first 1,048,576 events held to
   the CPU path (float sums within rtol 1e-5), host syncs only the
   drains', the raw id off the wire, then ResidentReplay counts-only with
   a row an event, reruns, wire bytes, peak
   memory, a traced rerun's idle share and one segment under sync debug
   mode "error"; then every other window class through the streaming Job
   over two micro-batches of 524,288 events (65,536 on the matrix path),
   rows held to the CPU path and two staged steps under sync debug mode
   "error": length min/max, event-time group-by avg, time min (matrix),
   externalTime, timeLength, cumulative group-by, lengthBatch, timeBatch
   group-by, externalTimeBatch, cron, expired events over length and time
   windows, delay, and an INT sum that wraps int32 (exact);
8. multiquery64 (in a process of its own, `--multiquery OUT`): the bench's
   64 two-step chains (query q from id q mod 50 to id (7q + 1) mod 50,
   each into its own stream) compiled to one stacked artifact stepping
   131,072-event windows, as phase 5b runs the bench main path over
   MQ_BATCHES = 8 tapes of 524,288 (20 before phase 8h came, cut for the
   time limit): streaming rows of the first 1,048,576 events held to the
   CPU path in all 64 streams, host syncs only the drains', ResidentReplay
   counts-only with both chain kernels launched once per step (32 a run,
   on the host and in the trace) and no compaction read, and the rest of
   phase 5b (fused
   streaming included; the resident and fused rows over the first
   1,048,576 events: 4 segments of 2 steps on one graph); then one
   step on
   the stack's full-width branch (its peak memory, its rows equal to the
   compacted branch's). The chain kernels' stacked inputs go to phase 9;
8b. slot NFA (in a process of its own, `--slots OUT`): four slot-NFA
   queries over SLOT_STEPS = 8 tapes of the bench stream (4,194,304
   events; 20 tapes before phase 8f came, cut for the time limit) under
   bench.py's settings (SLOT_QUERIES:
   a quantified middle element and an 'or' group, both relevance-
   compacted; a sequence with `+` and a cross-element filter, both
   scanning every event): rows of the first 32,768 events on the card
   equal to the CPU path's; the streaming Job over the whole stream with
   a row sink (rows, exact checksum, K4 once a micro-batch and no other
   kernel, the pool's overflow); ResidentReplay with the sink (the same
   rows and checksum), then counts-only: three reruns (events/s median
   and best), graphs captured, no eager segment, K4 once a step on the
   host and in a traced rerun, one staged segment under sync debug mode
   "error"; K4 on the third step's input: ms a step, events visited, us
   a visited event, its old serial floor (empty barrier rounds at the
   pool's width) and its warp floor (empty `__syncwarp` + `__shfl_sync`
   rounds in one warp). K4's inputs of each query's third step go to
   phase 9;
8c. joins and chaining (in a process of its own, `--joins OUT`):
   inputStream1 and inputStream2 (the bench schema and generator, seeds 7
   and 8, one event a ms each, 3,670,016 each (5,242,880 before phase
   8i came), interleaved: a tape of
   524,288 events holds 262,144 of each) under bench.py's settings: J1,
   the reference's own join test with its windows scaled (`length(100)`
   join `time(100)` on `s1.id == s2.id`, about 2 pairs an event); G1, J1
   aggregated (`sum(s2.price)`, `count()` group by `s1.id`: the
   aggregated-join rewrite into a chain); C1 over the bench stream (a
   filter query chained into `#window.length(1000)` with `sum`). Each:
   rows of the first 65,536 events at a 4,096-event tape on the card
   equal to the CPU path's (float sums within rtol 1e-5); rows at a
   524,288-event tape over the first 1,048,576 events equal, as sorted
   multisets, to the card's at 4,096; the streaming Job over the whole
   streams (a counting columnar sink; K5 once a step and no other kernel;
   overflow 0); ResidentReplay (a run with the sink, the same count; then
   counts-only: three reruns, events/s median and best, graphs captured,
   no eager segment, one staged segment under sync debug mode "error", K5
   once a step on the host and in a traced rerun). Then a left outer join
   with `within 50`, rows only, card against CPU on 65,536 events. K5's
   input of J1's third step goes to phase 9;
8d. event tables (in a process of its own, `--tables OUT`): TABLES, the
   shape of Siddhi's event-table example (a PriceTable of 1,024 rows fed
   by inputStream1's `price > 99.8`, updated by inputStream2's `price <
   50.0` and pruned by its `price > 99.5` on the id, inputStream2 joined
   against it), over the two streams of 8c with 10,000 ids: the card's
   `joined` rows and final table (valid, ptr, columns) equal to the CPU
   path's at the same tape size over the first two steps; the streaming
   Job over the whole streams (a counting columnar sink; K6 twice a step,
   the update's and the delete's, K5 once; overflow 0; the table's valid
   rows at the end); ResidentReplay (a run with the sink: the same count
   and table; counts-only reruns, events/s median and best, graphs
   captured, no eager segment, one segment under sync debug mode "error",
   the kernels once a query a step on the host and in a traced rerun:
   idle share, device ms a step, the heaviest device ops); the left outer
   variant, rows only, card against CPU on 65,536 events at a 16,384
   tape. The third step's K6 and K5 inputs go to phase 9;
8e. partitions and windowed table writes (in a process of its own,
   `--partitions OUT`): P1, the headline kept per account (`partition
   with (user of inputStream)`: the slot NFA with the implicit
   `sK.user == s1.user` filter, within 10 sec, 512 slots) and P2 (a
   per-key `#window.length(1000)` with sum, avg and count, and a
   partitioned running sum: no kernel) over the bench stream with an
   account column (1,000 accounts); W1, phase 8d's TABLES with its insert
   aggregated (`sum(price) group by id`) and its update windowed
   (`#window.lengthBatch(1024)` with `avg(price) group by id`: rewritten
   into a synthesized stream, then K6) over 8d's streams. Each: rows of
   the first 65,536 events on the card equal to the CPU path's (W1 at a
   16,384 tape, with its final table; floats within rtol 1e-5); the
   streaming Job over the whole stream (counting columnar sinks; P1 K4
   once a step, W1 K6 twice and K5 once, P2 no kernel; overflow 0);
   ResidentReplay (a run with the sinks, the same counts; counts-only
   reruns, events/s median and best, graphs captured, no eager segment,
   one segment under sync debug mode "error", the launches on the host
   and in a traced rerun). P1 and P2 run PART_STEPS = 8 tapes of 524,288
   (20 before phase 8h came, cut for the time limit). P1's K4 and W1's K6
   inputs of the third step go to phase 9;
8f. scan windows (in a process of its own, `--scan-windows OUT`):
   SCAN_STEPS = 4 tapes of 524,288 events (2, SCAN_SHORT_STEPS, for the
   one-warp plans O1, F1 and F2 since phase 8g came) each of S1
   (`#window.session(2
   sec, user)` over the partition stream: K7, and the flush's rows), O1
   (`#window.sort(10, price)`, one buffer: K9 on one warp), O2 (a
   `sort(4, price, 'desc')` per id inside `partition with`: K9, a warp a
   partition), F1 (`#window.frequent(8, id)`: K8), F2
   (`lossyFrequent(0.015, 0.0015, id)`, 4,096 slots: K8) over the bench
   stream, and U1 (the quote board over INT/LONG volumes: K3's integer
   path) over phase 6's quote stream, each through ``part_plan``: rows
   of the first 8,192 events on the card equal to the CPU path's (floats
   and U1's LONG sum within rtol 1e-5), then the streaming and resident
   runs of 8b-8e (the kernel once a step on the host and in a traced
   rerun). Each plan's third-step (a short plan's second-step) kernel
   inputs go to phase 9;
8g. event time and recovery (in a process of its own, `--event-time
   OUT`): E1, the headline as the bench runs it (bench.py's settings,
   the fused streaming Job, 8 tapes a segment) over ET_TAPES = 8 tapes
   of the bench stream through `DisorderSource` (arrival shuffled by up
   to 2,000 ms, 64 stragglers held back 20,000 ms, seeded; polls of
   ET_CHUNK events) under `with_watermarks(2,000)` in event time with
   late_policy 'side_output': its rows equal to the same Job's over the
   in-order stream (the stragglers left out), `late_events` and the side
   output's rows equal to the injected stragglers exactly, K1 and K2
   launched (counted by their wrappers), then counts-only reruns of both
   for events/s (printed beside phase 5b's fused rate; not a gate); E2,
   E1 saved after 4 tapes (`save_checkpoint`) and restored into a fresh
   Job that runs to the end: under the bench settings the same row count
   and the same rows wherever no lazy column was carried across the
   restore, the first Job restored in place (its graphs' tensors
   overwritten) giving the fresh Job's rows; with lazy projection off the
   rows of the uninterrupted run exactly; the snapshot's bytes and the
   save and restore times; E3, slot query (a) of phase 8b (K4) and the
   tables path of 8d (K6, K5) over 4 tapes, saved after 2 and restored
   into a fresh Job: the uninterrupted run's rows and final table; and a
   file the CPU path writes (after 2 of 4 tapes of 4,096 events) restored
   on the card gives the CPU path's rows; E4, the quote board (K3) with
   `output last every 4096 events` and window_groupby with `output
   snapshot every 1 sec`, card against CPU over the first 65,536 events
   (the window's last snapshot, one row a group); E5, a Supervisor over
   E1's fused headline (late policy 'drop', lazy projection off) killed
   at source pulls 3 and 9 and in its second checkpoint (checkpoints
   every 2 cycles, 3 kept): 3 crashes, no committed row duplicated or
   lost against the unfaulted run, `late_dropped` exact, its
   `last_recovery_ms`; then the resident drive over 4 tapes, killed
   mid-stage and in its first checkpoint, its rows the unfaulted
   resident run's;
8h. ingestion and the deployable pipeline (in a process of its own,
   `--pipeline OUT`): H0, the native decoder built from the port's copy
   of fast_decode.cpp into build/torch_native/ (its seconds; it must
   load); H1, the headline through ``CEPPipeline``: the bench stream
   over PIPE_EVENTS = 524,288 events (1,048,576 before phase 8k came)
   as JSON records in a 4-partition topic of
   tests/torch_fake_kafka.py (v2 batches of 16,384 records, gzip'd on
   the wire, round robin over the partitions), read from `kafka://` in
   event time with per-partition watermarks, checkpointed every second
   into a transactional `kafka://` output: the output topic read
   committed holds the in-order Job's rows exactly once, K1 and K2
   launched and nothing else, the fault counters 0, a commit marker a
   committed epoch; printed (not gated): events/s end to end and the
   split into fetch (with the records' decode), the native JSON decode,
   the gate, the tape build, the device step (CUDA events), sink
   emission and produce plus commit; H2, the same over 262,144 events,
   checkpointed every cycle, killed by runtime/faultinject.py at its
   second source pull and inside its second checkpoint and restarted
   by the pipeline's restart strategy: 2 crashes, the committed rows
   the in-order Job's with 0 duplicated and 0 lost, the dead run's
   orphan aborted, `txn_stats` agreeing with the topic's markers; H3,
   the quote board (K3) from a JSON-lines file and window_groupby from a
   CSV file through ``CEPPipeline``: the quote board over 1,048,576
   events (its decode rate in MB/s, K3 launched), its rows of the first
   65,536 events and window_groupby's over 65,536 against the CPU path's
   (floats within rtol 1e-5; the CPU path in a helper process,
   `--pipeline-cpu OUT`, started first so that it runs beside H1 and
   H2);
8i. the dynamic control plane (in a process of its own, `--control
   OUT`): headline variants (`ctrl_cql`: their ids, operators and
   windows are slot data, one template) admitted, disabled, updated and
   retired by a ControlListSource stamped at tape boundaries
   (`ctrl_timeline`: 4 variants before tape 0 forming group 1, 4 more at
   tape 2 filling its 8 slots, at tape 3 a 9th opening group 2, a filter
   on its own runtime and CQL that does not compile (CQL000), at tape 4
   two disables, two retires and an update, at tape 5 an admit into a
   reclaimed slot and an enable, at tape 6 group 2's only member and the
   filter retired) over CTRL_TAPES = 8 tapes of the bench stream, the
   Job's plan compiler on the default EngineConfig (chain plans fold),
   beside one static plan: the headline under bench.py's settings
   (pushdown, lazy projection) on its own runtime, in segments of
   CTRL_SEGMENT = 4 tapes (a segment whose oldest tape waited 500 ms
   dispatches short, padded to 4), staged across the control boundaries.
   First the rate runs: the group with 1 member and with 8, processing
   time, fused, a warm pass over 8 tapes, a timed one over the next 8
   (events/s) and a profiler-traced one over them (``traced_run``): K1
   and K2 ran on the card exactly once each per group step, the group
   step's device time and the card's idle share; no capture and no eager
   segment after the warm pass; the group's kernel inputs of an eager
   third step (K1 on 16 rows of 524,288, K2 at Q = 8, V = 525,312) go to
   phase 9. D1, the fused streaming Job in event time: the control
   counters (admitted, stack_join, retired, admission_rejected = 1), the
   live plan ids, every group's overflow 0, group 1's graphs never
   rebound (one binding, one state signature in its graph keys) across
   its folds, evicts and enables, the static plan's binding, graph keys
   and graph count unchanged across every control event and its rows
   equal to a static run's, each member that is never disabled (and v6's
   two incarnations) equal to a static compile of its CQL run alone over
   the tapes between its admit and its retire, the disabled members
   silent while disabled, the ms from the boundary to each applied
   event; D1 again in a profiler trace: the same rows, and K1 and K2 ran
   on the card once each per step of a chain runtime (the groups' and
   the static plan's); and the same timeline over the first 65,536
   events (8 tapes of 8,192) on the card equal, plan by plan, to the CPU
   path's (in a helper process, `--control-cpu OUT`, started first). D2,
   the timeline through ResidentReplay in epochs: rows equal to D1's plan
   by plan. D3, QueryControlService on 127.0.0.1 over a
   live Job fed 4 tapes of 131,072 events in processing time: POST of 8
   variants, the listing's 8 folded slots on one host, `/disable`, `PUT`
   and `DELETE`, each query's rows against its static compile. D4, a
   checkpoint after tape 3 (the later events still pending in it)
   restored into a fresh Job that replays `dynamic` into the same slots
   and runs tapes 4-7: D1's rows, 0 duplicated and 0 lost;
8j. subplan sharing and admission (in a process of its own, `--share
   OUT`): A1, bench.py's subplan-share fleet (`share_fleet`: four
   families of six structurally distinct tenants, each family behind the
   exact prefix `price < P`, P = 3, 5, 7, 10, the sixth the chain
   pattern whose shared suffix runs on K1 and K2) over `S(id, price,
   timestamp)` on the bench stream, 8 tapes of 524,288 events, admitted
   through ControlPlane with the admission gate (default budgets; the
   Job re-checks at apply time, precleared) before tape 0, a columnar
   sink on each tenant's stream, the fused Job (bench.py's 8 tapes a
   segment, the Job's own ring; processing time) once with
   `share_subplans` off and once on: tape 0 the warm-up (its captures), tapes 1-7 timed with the closing
   drain (events/s; the speedup printed, not gated), then tape 1 again in
   a profiler trace of the card (K1 and K2 on the card equal to the
   host's counts, never 0); each side's plans, hosts and members,
   `subplan_share` (24 shared) and `stack_join`, graphs captured (after
   the warm-up too, and each suffix's), the loopback's mid rows and its
   host seconds; each tenant's rows shared equal to unshared over all
   events (float aggregates within WINDOW_RTOL: a window's sum rounds
   from float64 running sums over the tapes its rows ride), the rows the
   tenants emitted summing to the job's emitted total (mid streams count
   nowhere), 0 dropped events, no suffix tape regrown; the fleet over
   the first 65,536 events (tapes of 8,192, one step a tape) shared and
   unshared on the card and on the CPU (`--share-cpu OUT`, started
   first), all equal. A2, in event time over 8 tapes of 131,072 events
   (1,048,576, cut for the time limit): family 0's six members retired at
   tape 2 (its host drops, `subplan_unshare` 1), one re-admitted at tape
   3 (the host re-forms), fused; a checkpoint after tape 3 with the share
   table (one step a tape) restored into a fresh Job that runs tapes
   4-7: 0 duplicated and 0 lost rows against the uninterrupted run; the
   same timeline through ResidentReplay in epochs: rows equal to the
   fused run's. A3, every plan of the JAX package's zoo (its CQL copied
   here) and a unique window with aggregates (K3): the apply-time static
   tier's ms and the deep tier's (meta tensors), admitted, then one tape
   of 65,536 events on the card with the admitted footprint (state and
   a full accumulator ring) recorded: measured bytes at most admitted, no
   overrun, and at most what torch's allocator holds for the Job (the
   rest reported: tapes, slots); then a fused Job fed a tape a cycle
   takes the zoo through QueryControlService with the gate on a REST
   thread, which goes on gating the zoo until its run loop, applying the
   admits, captured graphs during a gate call (no capture error), the
   gate's ms per CQL, and every hostile-zoo entry refused with HTTP
   422 by its exact rule id (its profile's budgets) and, pushed raw past
   the gate, at apply time by the same id;
8k. telemetry (in a process of its own, `--telemetry OUT`), bench.py's
   settings throughout (lazy projection, pushdown, batch 524,288): T1,
   the fused counts-only headline over TEL_TAPES = 8 tapes, a warm run,
   then A B B A runs of the same Job with the registry off
   (`telemetry.enabled = False`: spans, tracer, journal and SLO
   silenced) and on at the default `sample_every` (1,024): events/s of
   each and their ratio, K1 and K2 launched in every run; one more run
   each way under cProfile, the functions whose own time grows most with
   the registry on (ms a tape: where the telemetry's host time goes);
   then one
   resident replay of the tapes with the registry on and a collector:
   its rows over the first 131,072 events equal to the CPU path's,
   `trace.e2e` and `drain.staleness` p50/p99 (the replay stages off the
   clock, so `trace.e2e` includes staging), the limiting leg and
   coverage of `metrics()["attribution"]`; T2, the headline behind a
   `SocketLineSource` in processing time, every event sampled, and a
   `SideChannelProber` in its own process sending 200 sentinel triples
   (ids 1, 2, 3, the probe's number in the third's price, which the
   headline's `s3.price` carries into its row) every 20 ms: every probe
   received or listed lost, the prober's pid not this one's, its p99
   within max(3x, 250 ms) of `trace.e2e`'s; T3, phase 8i's template
   (tenant acme's v1 and v2, bobcorp's v3 folding into their group while
   v2 is disabled, v2 enabled, v1 retired, at tape boundaries, beside the
   static headline) over 4 tapes in the streaming, fused and resident
   modes: the per-plan `rows_emitted` summing to the emitted rows, the
   same split in every mode; in the fused run SLO policies on both
   tenants (acme's p99 of 0.001 ms breaches) behind QueryControlService,
   `/api/v1/metrics/prometheus` fetched while the run loop steps and
   passed by the reference suite's text checker, `/api/v1/slo`
   reconciled with `/api/v1/flightrecorder`'s counts,
   `metrics()["compiles"]` per plan equal to the graphs each runtime
   captured; the timeline over 4 tapes of 8,192 on the card and on the
   CPU: the same per-plan split and journal; that card Job checkpointed
   and restored into a fresh one, its journal whole and its seq going on;
9. kernels (with phase 10 in a process of its own, `--kernels OUT`: late in
   a long process profiler traces lost records): each kernel timed on the
   inputs it was given on its path — its
   device time (profiler trace; for the unique fold CUDA events over 25
   back-to-back calls and each stage kernel's traced device time) and its
   per-call time (CUDA events, median) — beside its plain version, the
   library call that computes the same function where there is one, its
   bound and the launch floor (an empty kernel's device time). The reverse
   cummin and the chain advance also at full width (the headline's own
   524,288-event tapes with relevance compaction off) and at multiquery64's
   stacked shapes (held exactly to their plain versions first), and their
   kernel launches per call counted in a profiler trace (each must be 1);
   K4 on each slot query's recorded step (CUDA events around back-to-back
   calls), per visited event, beside its byte bound and its serial and
   warp floors (the visited events' count of empty rounds), held exactly to
   its plain version on the quantified query's step (the plain version
   timed on the CPU, where it runs); K5 on J1's third step (CUDA events
   around back-to-back calls), the candidates in its bands and ns per
   candidate, the tiles it walked again, beside its bound and the launch
   floor, held exactly to its plain version (the dense pair mask, in
   chunks) run on the card on the same input, whose time is the plain
   time; then the same step with one event of the time window ten
   windows late, timed and held exactly to `late_witness` (the in-order
   pairs with the moved entry's one mask column recomputed: E x 1 cells,
   where the dense plain version's 10.3 s a call does not fit the time
   limit); K6 on the tables path's third step
   (the update and the delete; CUDA events around back-to-back calls),
   exact against its plain version run on the card, the candidates it
   walked, those the rows need and E x C, its bound (bytes, and the needed
   candidates at 67e12 int32 operations/s; also at E x C); K5 on the
   tables path's third step (the stream-table join), exact and timed;
   K4 on P1's third step at 512 slots and K6 on W1's (the rewritten
   update and the delete), each exact against its plain version and
   timed; K7 on S1's third step, K8 on F1's and F2's second, K9 on
   O1's second and O2's third (``time_scan_kernel``: held to the plain
   version on the CPU
   copies, on the whole tape or, where the plain version walks event by
   event, its first 4,096 events; CUDA events around back-to-back calls,
   K8 and K9 one call each way after the held call (two runs and a
   warm-up before phase 8j came, cut for its time); the byte bound and
   the longest chain's serial floor of empty warp rounds), K7 unkeyed over S1's third step (one thread walks the tape),
   and K3's integer path on U1's third step; K1 and K2 at a dynamic
   group's shapes (phase 8i's recorded step: 16 rows of 524,288 events;
   Q = 8 over V = 525,312), exact against their plain versions, timed
   beside their bound and, for K1, torch.cummin;
10. where the quote board's time goes, over its first 4 micro-batches:
   tape staging, device steps (under
   torch's sync debug mode "error": a host wait inside a step fails the
   run) and a profiler-traced run for the card's idle share;
11. api: the README's quick start, pattern and quote board through
   SiddhiCEP on the default device, checked against the CPU.

The last line is {"ok": true, "device": {...}}; the kernels' JSON line and
the card's nvidia-smi line come before it. Exits non-zero, printing no
result, when CUDA is unavailable or any phase fails.

    python3 chip_smoke.py --ab DIR [DIR ...]

compares checkouts on one card instead: each DIR is the root of a
checkout (its own chip_smoke.py and flink_siddhi_tpu_torch/), run in the
order given, each in a process of its own that builds its own kernels and
drives the headline and filter paths (phases 4 and 5, without their row
checks) once on two micro-batches to warm up and then AB_REPEATS times in
full, printing one JSON line per path with every wall time and events/s,
and one line per chain kernel, and one for the padded next-match table
as that checkout's chain core builds it, with device and call time on the
headline's inputs of that checkout.
Give the two versions as A B B A, so that drift of the card or the host
during the call shows.

    python3 chip_smoke.py --ab-drain DIR [DIR ...]

runs, with the package of each checkout in a process of its own, the
resident headline (stage, AB_RERUNS reruns: events/s median and best,
peak memory allocated and reserved) and the headline's sink mode (phase
5c's job, FUSED_RUNS timed runs; a checkout without the columnar lane
gets the same sink as a row sink): events/s, rows and checksum. Give the
checkouts as A B B A.

    python3 chip_smoke.py --ab-graphs DIR [DIR ...]

runs the five bench configs (headline, filter, pattern2, window_groupby,
multiquery64; bench settings, counts-only, this file's stream) with the
package of each checkout, each in a process of its own, and prints one
JSON line per checkout: per config, resident (stage seconds, AB_RERUNS
reruns: events/s median and best; a traced rerun: idle share, device
records and host torch ops per segment and per step; peak memory
allocated and reserved) and streaming counts-only with
fused_segment_len FUSED_K (a checkout before the fused mode steps one tape
at a time): events/s median and best of AB_RERUNS runs. Give the
checkouts as A B B A here too.

    python3 chip_smoke.py --ab-slots DIR [DIR ...]

runs phase 8b's four slot queries with the package of each checkout, each
in a process of its own: resident counts-only (stage seconds, AB_RERUNS
reruns: events/s median and best, the count emitted) and K4 on the third
step's recorded input (ms a step, events visited, us a visited event).
Give the checkouts as A B B A.

    python3 chip_smoke.py --capture-after-drop DIR [DIR ...]

runs ``capture_after_drop`` (a fused Job capturing after a dropped
resident Job, with one collection inside its first capture; also the end
of phase 5b) with the package of each checkout, in a process of its own:
a checkout whose runtime frees a dropped Job's graphs inside a capture
fails there.
"""

import dataclasses
import inspect
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 524_288
N_BATCHES = 20
# phase 5b's tapes of the bench stream (20 before phase 8i came: the time
# limit; 14 keep two full resident segments of 7)
BENCH_TAPES = 14
CHECK_BATCHES = 2  # rows held to the CPU path over these micro-batches
N_IDS = 50
N_IDS_WINDOW = 1_000  # window_groupby's ids (bench.py:479)
WINDOW_CLASS_BATCHES = 2  # micro-batches of each other window class
# phase 7's window_groupby: tapes of BATCH (20 before phase 8h came: the
# smoke's time limit)
WINDOW_GROUPBY_BATCHES = 14
MATRIX_BATCH = 65_536  # the matrix path's batch: [E, C] windows per column
WINDOW_RTOL = 1e-5  # float sums and averages, card against the CPU
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
L2_BYTES = 50 * 2**20  # H100 SXM L2, same source
INT32_OPS_PER_S = 67e12  # non-tensor-core 32-bit rate, same source
F32_OPS_PER_S = 67e12  # non-tensor-core float32 rate, same source
QUOTE_BATCHES = 8  # the quote board's stream: 8 x 524,288 events
QUOTE_CHECK_EVENTS = 32_768  # rows held to the CPU path over these events
BREAKDOWN_BATCHES = 4  # phase 10's traced quote-board run
QUOTE_ROW_BATCHES = 8  # the quote board's fused rows against the eager run
N_SYMBOLS = 10_000
FOLD_RTOL = 1e-5  # sums: the kernel's fp64 scan vs the plain float32 fold
AB_REPEATS = 3  # full runs of each path per checkout with --ab
# phase 8's result and recorded kernel inputs, in the ignored build tree
SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "smoke")

HEADLINE = (
    "from every s1 = inputStream[id == 1] -> s2 = inputStream[id == 2] -> "
    "s3 = inputStream[id == 3] within 5 sec "
    "select s1.timestamp as t1, s3.timestamp as t3, s3.price as price "
    "insert into matches"
)
FILTER = (
    "from inputStream[id == 2] select id, name, price insert into matches"
)
PATTERN2 = (
    "from every s1 = inputStream[id == 1] -> s2 = inputStream[id == 2] "
    "select s1.timestamp as t1, s2.timestamp as t2 insert into matches"
)
QUOTE_BOARD = (
    "from StockStream#window.unique(symbol) "
    "select symbol, count() as symbols, sum(price * volume) as notional, "
    "avg(price) as avg_price, min(price) as lo, max(price) as hi "
    "insert into Board"
)
QUOTE_SLOTS = [("count", -1), ("sum", 0), ("avg", 1), ("min", 1),
               ("max", 1)]
WINDOW_GROUPBY = (
    "from inputStream#window.length(1000) select id, sum(price) as total, "
    "count() as cnt group by id insert into matches"
)
# bench.py's multiquery64: 64 two-step chains, query q from id q mod 50
# to id (7q + 1) mod 50, each into its own stream m<q>
MULTIQUERY64 = "; ".join(
    f"from every s1 = inputStream[id == {q % 50}] -> "
    f"s2 = inputStream[id == {(q * 7 + 1) % 50}] "
    f"select s1.timestamp as t1, s2.timestamp as t2 insert into m{q}"
    for q in range(64)
)
MQ_OUTS = tuple(f"m{q}" for q in range(64))
MQ_STEP_EVENTS = 131_072  # a stack of 16 or more queries steps this wide
# phase 8's tapes of BATCH (20 before phase 8h came: the smoke's time limit)
MQ_BATCHES = 8


def log(*a):
    print(*a, flush=True)


def nvidia_smi():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def device_activity(prof):
    """Device time in a profiler trace: the union of every kernel / copy
    interval on the card (us; overlaps counted once) and the summed
    duration per name."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy, lo, hi, per_name = 0.0, None, None, {}
    for a, b, name in spans:
        per_name[name] = per_name.get(name, 0.0) + (b - a)
        if hi is None or a > hi:
            busy += (hi - lo) if hi is not None else 0.0
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += (hi - lo) if hi is not None else 0.0
    return busy, per_name


def device_records(prof):
    """The number of kernel and copy records on the card in a trace."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def timed(fn, runs=25, warmup=3, attempts=5):
    """(device ms per call, call ms). Device ms: the summed duration of the
    card's records in a trace of ``runs`` calls (``kernel_records``; one
    stream, so they do not overlap), over ``runs`` — the kernels' own time.
    Call ms: the median of CUDA events around single calls, which also
    holds the host's launch overhead while the card waits. Every call
    launches the same work, so a trace whose record count is not a
    multiple of ``runs`` has lost records (or holds none) and is taken
    again, up to ``attempts`` times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    for _ in range(attempts):
        records = kernel_records(fn, runs)
        n = sum(count for count, _ in records.values())
        if n and n % runs == 0:
            us = sum(t for _, t in records.values())
            return us / runs / 1e3, statistics.median(times)
        log(f"  trace of {runs} calls holds {n} device records; again")
    raise RuntimeError(f"no trace of {runs} calls held a whole number of "
                       "device records per call")


def rotating(fn, args):
    """A zero-argument call of ``fn`` that cycles through copies of
    ``args``, enough that a call's inputs were last touched more than four
    L2 sizes of other inputs ago (up to 64 copies): a timed call then
    reads them from HBM, as the byte bound assumes, and not from the L2
    that the call before left them in. Inputs under L2_BYTES / 64 fit in
    the L2 with all their copies and stay there, as they do on the path."""
    import torch

    size = sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))
    n = max(1, min(64, -(-4 * L2_BYTES // max(size, 1)) + 1))
    sets = [tuple(args)] + [tuple(keep_copy(a) for a in args)
                            for _ in range(n - 1)]
    sets = itertools.cycle(sets)
    return lambda: fn(*next(sets))


def timed_back_to_back(fn, runs, warmup=1):
    """(ms per call, call ms) for a call that takes a good part of a
    second: CUDA events around ``runs`` back-to-back calls, over ``runs``
    (the host's launch work hides behind the card's), and the median of
    CUDA events around single calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs, statistics.median(times)


# per kernel wrapper, the kernel that each of its calls launches exactly
# once (the unique fold's pipeline ends with its rows kernel)
TRACED_KERNELS = {"multi_reverse_cummin": "suffix_min_kernel",
                  "chain_advance": "chain_advance_kernel",
                  "unique_window_fold": "rows_kernel",
                  "slot_nfa_scan": "slot_nfa_kernel",
                  "join_pairs": "join_walk_kernel",
                  "table_mutate": "table_mutate_kernel",
                  "session_scan": "session_scan_kernel",
                  "frequency_scan": "frequency_scan_kernel",
                  "sort_window_scan": "sort_window_kernel"}


def traced_launches(prof, names=TRACED_KERNELS):
    """Per kernel wrapper in ``names`` (the wrappers a checkout's package
    has), its calls that ran on the card in a profiler trace: the records
    of the kernel it launches once a call (TRACED_KERNELS)."""
    import re

    from torch.autograd import DeviceType

    pats = {k: re.compile(rf"(?<!\w){TRACED_KERNELS[k]}(?!\w)")
            for k in names}
    out = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k, pat in pats.items():
                if pat.search(e.name):
                    out[k] += 1
    return out


def traced_run(co, run, what, prepare=None, attempts=3, host_ops=True):
    """``run()``, which returns its wall seconds, in a profiler trace of
    the card and the host, after ``prepare()`` and with the wrappers'
    launch counts reset. The launches each wrapper counted on the host
    must equal its calls that ran on the card (``traced_launches``): on a
    graph path each replay adds the launches its capture counted back to
    the host counts, so only the trace shows that a replay ran each
    kernel. A trace with fewer records than the host counted (the tracer
    loses records at times, see ``kernel_records``) is taken again, up to
    ``attempts`` times; one with more fails at once. ``host_ops=False``
    traces the card alone (a run of many runtimes records far fewer
    events; the trace then holds no host op). Returns (trace, seconds,
    launches counted in the trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    for _ in range(attempts):
        if prepare is not None:
            prepare()
        co.reset_launches()
        with profile(activities=activities) as prof:
            wall = run()
        host = co.launch_counts()
        traced = traced_launches(prof, host)
        if traced == host:
            return prof, wall, traced
        if any(traced[k] > host[k] for k in host):
            raise AssertionError(f"{what}: the card ran {traced} kernel "
                                 f"calls, the host counted {host}")
        log(f"  {what}: a trace of {traced} kernel calls, {host} counted "
            "on the host; again")
    raise AssertionError(f"{what}: no trace held the kernel calls the host "
                         f"counted ({host})")


def kernel_records(fn, runs, warmup=10):
    """Per name, (records, device us) of every kernel and copy on the card
    in a profiler trace of ``runs`` calls of ``fn``, with a sync at both
    edges of the active window, so that it holds only its own calls' work.
    The tracer starts recording only some time after it is enabled: after
    earlier traces in a process, a window that followed two warm-up calls
    lost its first two calls' records. So ``warmup`` calls, and a pause,
    run traced but unrecorded before the window. On an H100, late in a
    long process, a window lost its first 9 of 25 calls (all 25 of the
    empty kernel's), as if the card's record times, converted to the
    host's clock, fell before the window opened: a second pause after it
    opens is meant to keep them inside (``main`` also runs the kernel
    timing in a fresh process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=runs,
                                   repeat=1)) as prof:
        for i in range(warmup + runs):
            fn()
            if i == warmup - 1:
                time.sleep(0.02)
            if i in (warmup - 1, warmup + runs - 1):
                torch.cuda.synchronize()
            prof.step()
            if i == warmup - 1:
                time.sleep(0.05)
    records = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = records.get(e.name, (0, 0.0))
            records[e.name] = (n + 1, us + e.time_range.end
                               - e.time_range.start)
    return records


def launches_per_call(fn, kernel, runs=25, attempts=5):
    """Kernel launches per call of ``fn``, counted on the card: the records
    of a trace of ``runs`` calls (``kernel_records``), over ``runs``. Fails
    unless every record is the kernel named ``kernel``. A trace whose count
    is not a multiple of ``runs``, or that holds none, has lost records and
    is taken again, up to ``attempts`` times."""
    for _ in range(attempts):
        records = kernel_records(fn, runs)
        total = sum(n for n, _ in records.values())
        if total and total % runs == 0:
            break
        log(f"  {kernel} trace: {total} records for {runs} calls; again")
    others = [name for name in records if kernel not in name]
    if others:
        raise AssertionError(f"{kernel}: the call also ran {others}")
    return total / runs


def same(a, b, what):
    import torch

    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"{what}: kernel and plain version disagree")
    if a.dtype == torch.bool:
        return 0
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def no_slot_scan(launches, what):
    """The slot NFA scan (K4), the join's pair step (K5) and the table
    mutation (K6) run on no path but their own."""
    for k in ("slot_nfa_scan", "join_pairs", "table_mutate"):
        if launches.get(k):
            raise AssertionError(f"{what}: {k} launched {launches[k]} times")


# -- phase 3: kernels against their plain versions -----------------------------

INT_MAX = 2 ** 31 - 1
K1_SHAPES_E = (1, 3, 1_023, 1_025, 4_097, 65_536, 70_001, 524_288, 1 << 24)
K1_REPEATS = 1_000
K1_STACKED_SHAPES = ((64, 8_192), (64, 131_072))


def special_rows(C, E, dev, gen):
    """C rows cycling through all INT_MAX, ascending, descending and
    full-range int32 values."""
    import torch

    ar = torch.arange(E, dtype=torch.int32, device=dev)
    kinds = [
        torch.full((E,), INT_MAX, dtype=torch.int32, device=dev),
        ar,
        E - 1 - ar,
        torch.randint(-2 ** 31, INT_MAX, (E,), generator=gen, device=dev,
                      dtype=torch.int32),
    ]
    return torch.stack([kinds[c % len(kinds)] for c in range(C)])


def check_reverse_cummin(co, dev, gen):
    """Exact at every shape, kind of row and pad; then K1_REPEATS
    back-to-back calls over changing inputs (a stale look-back state or a
    race shows as a mismatch)."""
    import torch

    err = 0
    for C in (1, 2, 8):
        for E in K1_SHAPES_E:
            inputs = {
                "matcher": torch.randint(0, E + 1, (C, E), generator=gen,
                                         device=dev, dtype=torch.int32),
                "special": special_rows(C, E, dev, gen),
            }
            for kind, x in inputs.items():
                for pad in (None, E):
                    got = co.multi_reverse_cummin(x, pad=pad)
                    ref = co.reverse_cummin_plain(x, pad)
                    torch.cuda.synchronize()
                    err = max(err, same(got, ref, f"reverse_cummin C={C} "
                                        f"E={E} {kind} pad={pad}"))
            del inputs
            log(f"  reverse_cummin C={C} E={E}: exact (matcher and special "
                "rows, pad on and off)")
    # a stack's table build: one row per member query (multiquery64: 64
    # members, a 8,192-event compacted window; 131,072 at full width)
    for C, E in K1_STACKED_SHAPES:
        x = torch.randint(0, E + 1, (C, E), generator=gen, device=dev,
                          dtype=torch.int32)
        got = co.multi_reverse_cummin(x, pad=E)
        torch.cuda.synchronize()
        err = max(err, same(got, co.reverse_cummin_plain(x, E),
                            f"reverse_cummin stacked C={C} E={E}"))
        log(f"  reverse_cummin stacked C={C} E={E}: exact (pad on)")
    E = 65_536
    xs = [torch.randint(0, E + 1, (2, E), generator=gen, device=dev,
                        dtype=torch.int32) for _ in range(4)]
    refs = [co.reverse_cummin_plain(x, E) for x in xs]
    wrong = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(K1_REPEATS):
        got = co.multi_reverse_cummin(xs[i % 4], pad=E)
        wrong += (got != refs[i % 4]).sum()
    if int(wrong):
        raise AssertionError(f"reverse_cummin: {int(wrong)} wrong values "
                             f"over {K1_REPEATS} back-to-back calls")
    log(f"  reverse_cummin C=2 E={E}: {K1_REPEATS} back-to-back calls exact")
    return err


K1_REPLAY_SHAPES = ((2, 65_536), (64, 8_192))  # headline's, the stack's
K1_REPLAYS = 4


def check_reverse_cummin_replay(co, graphs, dev, gen):
    """The reverse cummin captured into a CUDA graph (one call, the pad
    column on) and replayed K1_REPLAYS times on other inputs copied into
    its static input, at the headline's and the stack's shapes: each
    replay exact against the plain version (a look-back epoch baked into
    the captured launch would read the last replay's prefixes), one kernel
    call a replay on the card, counted in a profiler trace of the replays,
    and as many on the host, and the scratch's epoch mirror advanced once
    a replay."""
    import torch

    err = 0
    for C, E in K1_REPLAY_SHAPES:
        x = torch.randint(0, E + 1, (C, E), generator=gen, device=dev,
                          dtype=torch.int32)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # sizes the stream's scratch
            co.multi_reverse_cummin(x, pad=E)
        torch.cuda.current_stream().wait_stream(side)
        g, out = graphs.capture(lambda: co.multi_reverse_cummin(x, pad=E),
                                side)
        (buf, n), = g.calls
        epochs = []

        def replays():
            nonlocal err
            t0, used0 = time.perf_counter(), buf.used
            for i in range(K1_REPLAYS):
                new = (special_rows(C, E, dev, gen) if i % 2
                       else torch.randint(0, E + 1, (C, E), generator=gen,
                                          device=dev, dtype=torch.int32))
                x.copy_(new)
                g.replay()
                torch.cuda.synchronize()
                err = max(err, same(out, co.reverse_cummin_plain(new, E),
                                    f"reverse_cummin replay {i} C={C} "
                                    f"E={E}"))
            epochs.append(buf.used - used0)
            return time.perf_counter() - t0

        _, _, calls = traced_run(co, replays,
                                 f"reverse_cummin replays C={C} E={E}")
        if (n != 1 or calls["multi_reverse_cummin"] != K1_REPLAYS
                or set(epochs) != {K1_REPLAYS}):
            raise AssertionError("reverse_cummin replay: kernel calls or "
                                 "epochs not one a replay")
        log(f"  reverse_cummin C={C} E={E}: {K1_REPLAYS} graph replays on "
            "new inputs exact")
    return err


def chain_inputs(co, dev, gen, K, n_guards, E=65_536, P=1024, density=0.3,
                 local=False, aligned=True, ts0=0):
    """A candidate set shaped like the headline's compacted step: P
    carried partials plus one fresh start per tape position. With
    ``local`` the candidates sit where the matcher puts them (carried
    partials at pos 0, the fresh start at e searching from e + 1, all at
    step 1, starts at their own ts), so neighbouring candidates gather
    neighbouring table entries; otherwise pos, step and start are random.
    ``aligned``: the table as the matcher builds it (the reverse cummin's
    padded rows, 16-byte aligned), else contiguous [R, E + 1] rows.
    ``ts0``: the tape's first timestamp."""
    import torch

    R = K - 1 + n_guards
    hits = torch.rand((R, E), generator=gen, device=dev) < density
    idx = torch.where(hits, torch.arange(E, dtype=torch.int32, device=dev),
                      E).to(torch.int32)
    if aligned:
        nxt = co.multi_reverse_cummin(idx, pad=E)
    else:
        nxt = co.reverse_cummin_plain(idx, E)
    V = P + E
    ts = (ts0 + torch.cumsum(torch.randint(0, 3, (E,), generator=gen,
                                           device=dev), 0)).to(torch.int32)
    ts_pad = torch.cat([ts, torch.zeros(1, dtype=torch.int32, device=dev)])
    act = torch.rand(V, generator=gen, device=dev) < 0.5
    if local:
        step = torch.ones(V, dtype=torch.int32, device=dev)
        pos = torch.cat([torch.zeros(P, dtype=torch.int32, device=dev),
                         torch.arange(1, E + 1, dtype=torch.int32,
                                      device=dev)])
        start = torch.cat([torch.full((P,), ts0, dtype=torch.int32,
                                      device=dev), ts])
    else:
        step = torch.randint(1, K, (V,), generator=gen, device=dev,
                             dtype=torch.int32)
        pos = torch.randint(0, E + 1, (V,), generator=gen, device=dev,
                            dtype=torch.int32)
        hi = int(ts.max()) + 1 if E else ts0 + 1
        start = torch.randint(ts0, hi, (V,), generator=gen, device=dev,
                              dtype=torch.int32)
    return nxt, ts_pad, act, step, pos, start


def check_chain_advance(co, dev, gen):
    """Exact on local and random-position inputs, padded and contiguous
    table rows, V = 0 (which must launch no kernel on the card), E = 0 and
    a `within` that wraps int32."""
    import torch

    err = 0
    wrap = -2 ** 31 + 10  # ts near INT_MIN: ts[j] - start wraps for starts
    cases = [
        # (name, K, guard rows per step 1..K-1, within, chain_inputs kwargs)
        ("headline-shaped, local", 3, [[], []], 5000,
         dict(local=True)),
        ("headline-shaped, local, unaligned rows", 3, [[], []], 5000,
         dict(local=True, aligned=False)),
        ("local K=4, guards", 4, [[3], [], [4]], 900,
         dict(local=True, density=0.1)),
        ("headline K=3 R=2 P=1024 E=65536, random pos", 3,
         [[], []], 5000, {}),
        ("guard K=3, one mid-chain guard", 3, [[], [2]], 1 << 18, {}),
        ("K=4", 4, [[], [], []], 5000, {}),
        ("K=4 no within, guards, unaligned rows", 4, [[3], [], [4]], None,
         dict(aligned=False)),
        ("V=0", 3, [[], []], 5000, dict(E=1000, P=0, density=0.0)),
        ("E=0", 3, [[], []], 5000, dict(E=0, P=100)),
        ("within wraps int32", 3, [[], []], 4000,
         dict(ts0=wrap, E=4096, P=64)),
    ]
    for name, K, guards, within, kw in cases:
        n_guards = sum(len(g) for g in guards)
        nxt, ts_pad, act, step, pos, start = chain_inputs(
            co, dev, gen, K, n_guards, **kw
        )
        if name == "V=0":
            act, step, pos, start = (t[:0] for t in (act, step, pos, start))
        if name == "within wraps int32":
            # starts just below INT_MAX and ts just above INT_MIN:
            # ts[j] - start wraps round to spans of 15 .. ~8,200, so
            # `within` keeps some completions and kills others
            start = torch.full_like(start, INT_MAX - 5)
        args = (nxt, list(range(K - 1)), guards, ts_pad, act, step, pos,
                start, within)
        got = co.chain_advance(*args)
        ref = co.chain_advance_plain(*args)
        torch.cuda.synchronize()
        for g, r, what in zip(got, ref, ("act", "step", "pos", "jmat")):
            err = max(err, same(g, r, f"chain_advance {name} {what}"))
        note = ""
        if name == "V=0":
            records = kernel_records(lambda: co.chain_advance(*args), runs=5)
            if records:
                raise AssertionError(f"chain_advance V=0 ran {records}")
            note = ", no kernel on the card"
        log(f"  chain_advance {name}: exact{note}")
    return err


def stacked_chain_inputs(co, dev, gen, Q, K, n_guards, E=8_192, P=1024,
                         density=0.05, local=True):
    """Q queries' candidate sets as a stack's step gives them to the
    advance: one reverse cummin over every query's rows (a padded
    ``[Q * R, E + 1]`` table, each query's R rows together), each query's
    own ts row ``[Q, E + 1]`` and candidates ``[Q, V]``; ``local`` as in
    ``chain_inputs``, else random positions, steps and starts."""
    import torch

    R = K - 1 + n_guards
    hits = torch.rand((Q * R, E), generator=gen, device=dev) < density
    idx = torch.where(hits, torch.arange(E, dtype=torch.int32, device=dev),
                      E).to(torch.int32)
    nxt = co.multi_reverse_cummin(idx, pad=E)
    V = P + E
    ts = torch.cumsum(torch.randint(0, 40, (Q, E), generator=gen,
                                    device=dev), 1).to(torch.int32)
    ts_pad = torch.cat([ts, torch.zeros((Q, 1), dtype=torch.int32,
                                        device=dev)], 1)
    act = torch.rand((Q, V), generator=gen, device=dev) < 0.5
    if local:
        step = torch.ones((Q, V), dtype=torch.int32, device=dev)
        pos = torch.cat([torch.zeros((Q, P), dtype=torch.int32, device=dev),
                         torch.arange(1, E + 1, dtype=torch.int32,
                                      device=dev).expand(Q, E)], 1)
        start = torch.cat([torch.zeros((Q, P), dtype=torch.int32,
                                       device=dev), ts], 1)
    else:
        step = torch.randint(1, K, (Q, V), generator=gen, device=dev,
                             dtype=torch.int32)
        pos = torch.randint(0, E + 1, (Q, V), generator=gen, device=dev,
                            dtype=torch.int32)
        start = torch.randint(0, max(int(ts.max()), 0) + 1, (Q, V),
                              generator=gen, device=dev, dtype=torch.int32)
    return nxt, ts_pad, act, step, pos, start


def check_stacked_chain_advance(co, dev, gen):
    """The advance with a query axis, exact against its batched plain
    version: Q = 1 and Q = 64 (multiquery64's step shape), a `within`
    per query (an int32 [Q] on the card) or one for all, guards, random
    positions, E = 0, and V = 0 (no kernel on the card)."""
    import torch

    err = 0
    cases = [
        # (name, Q, K, guard rows per step 1..K-1, within, input kwargs)
        ("Q=1, within per query", 1, 2, [[]], "per-query", {}),
        ("Q=64 multiquery64-shaped, no within", 64, 2, [[]], None, {}),
        ("Q=64, within per query", 64, 2, [[]], "per-query", {}),
        ("Q=64 K=3, a guard, one within, random pos", 64, 3, [[], [2]],
         3000, dict(local=False)),
        ("Q=5 K=4, guards, within per query, random pos", 5, 4,
         [[3], [], [4]], "per-query", dict(local=False, E=4_096, P=64)),
        ("Q=3 E=0", 3, 2, [[]], None, dict(E=0, P=100)),
        ("Q=64 V=0", 64, 2, [[]], None, dict(E=1000, P=0)),
    ]
    for name, Q, K, guards, within, kw in cases:
        n_guards = sum(len(g) for g in guards)
        nxt, ts_pad, act, step, pos, start = stacked_chain_inputs(
            co, dev, gen, Q, K, n_guards, **kw
        )
        if name.endswith("V=0"):
            act, step, pos, start = (t[:, :0] for t in (act, step, pos,
                                                        start))
        if within == "per-query":
            within = torch.randint(100, 20_000, (Q,), generator=gen,
                                   device=dev, dtype=torch.int32)
        args = (nxt, list(range(K - 1)), guards, ts_pad, act, step, pos,
                start, within)
        got = co.chain_advance(*args)
        ref = co.chain_advance_plain(*args)
        torch.cuda.synchronize()
        for g, r, what in zip(got, ref, ("act", "step", "pos", "jmat")):
            err = max(err, same(g, r, f"chain_advance {name} {what}"))
        note = ""
        if name.endswith("V=0"):
            records = kernel_records(lambda: co.chain_advance(*args), runs=5)
            if records:
                raise AssertionError(f"chain_advance {name} ran {records}")
            note = ", no kernel on the card"
        log(f"  chain_advance {name}: exact{note}")
    return err


def zipf_codes(gen, n, n_keys):
    """n key codes drawn with Zipf rank weights (s = 1) over n_keys."""
    import torch

    w = 1.0 / torch.arange(1, n_keys + 1, dtype=torch.float64)
    return torch.multinomial(w, n, replacement=True,
                             generator=gen).to(torch.int32)


def fold_inputs(dev, gen, E, C, A, codes=None, p_mask=0.7, p_valid=0.3):
    """A batch of E events and a carried table of C slots, a share p_valid
    of it valid. Codes past either end of the table clip to its edge
    slots."""
    import torch

    mask = torch.rand(E, generator=gen) < p_mask
    if codes is None:
        codes = torch.randint(-2, C + 3, (E,), generator=gen,
                              dtype=torch.int32)
    vals = torch.round(torch.rand((A, E), generator=gen) * 49_900 + 100) / 100
    valid0 = torch.rand(C, generator=gen) < p_valid
    bufs0 = torch.where(valid0, torch.rand((A, C), generator=gen) * 500, 0.0)
    t = [x.to(dev) for x in (mask, codes, vals, valid0, bufs0)]
    return t[0], t[1], t[2], t[3], t[4]


def non_finite(dev, gen, args):
    """The same batch with non-finite values: column 0 takes +inf and -inf
    (0.2% of events each, so both are often valid at once), column 1 NaN
    (0.1%); the carried table holds a NaN, an inf and a -inf."""
    import torch

    mask, codes, vals, valid0, bufs0 = (x.cpu() for x in args)
    E, C = int(mask.shape[0]), int(valid0.shape[0])
    vals, bufs0, valid0 = vals.clone(), bufs0.clone(), valid0.clone()
    r = torch.rand(E, generator=gen)
    vals[0] = torch.where(r < 0.002, float("inf"), vals[0])
    vals[0] = torch.where((r >= 0.002) & (r < 0.004), float("-inf"), vals[0])
    vals[1] = torch.where(torch.rand(E, generator=gen) < 0.001,
                          float("nan"), vals[1])
    valid0[:3] = True
    bufs0[0, 0], bufs0[0, 1], bufs0[1, 2] = (float("inf"), float("-inf"),
                                             float("nan"))
    t = [x.to(dev) for x in (mask, codes, vals, valid0, bufs0)]
    return t[0], t[1], t[2], t[3], t[4]


def int_columns(dev, gen, args, int_cols):
    """The same batch with the columns ``int_cols`` holding int32 values by
    bit pattern (K3's integer path): 80% uniform in [0, 2^31) (so most are
    past 2^24, where float32 rounds them), the rest in [-100, 100), in the
    events and the carried table. Large values of both signs would cancel
    in the sums, where the plain version's float32 sum (as the
    reference's) strays past FOLD_RTOL from the kernel's exact one."""
    import torch

    mask, codes, vals, valid0, bufs0 = (x.cpu() for x in args)
    vals, bufs0 = vals.clone(), bufs0.clone()
    for a in int_cols:
        for t in (vals, bufs0):
            n = int(t.shape[1])
            big = torch.randint(0, 2 ** 31 - 1, (n,), generator=gen,
                                dtype=torch.int64)
            small = torch.randint(-100, 100, (n,), generator=gen)
            pick = torch.rand(n, generator=gen) < 0.8
            t[a] = torch.where(pick, big, small).to(torch.int32).view(
                torch.float32)
    t = [x.to(dev) for x in (mask, codes, vals, valid0, bufs0)]
    return t[0], t[1], t[2], t[3], t[4]


def fold_err(got, ref, slots, what, int_cols=()):
    """Kernel vs plain fold, NaN-aware: the table bitwise equal; NaN at the
    same places of every row; elsewhere counts, minima and maxima equal and
    sums and averages within FOLD_RTOL (an int column's min and max rows
    equal as int32). Returns the rows' max abs and max relative error over
    the finite float values."""
    import torch

    rows, ref_rows = got[2], ref[2]
    int_rows = [s for s, (kind, a) in enumerate(slots)
                if kind in ("min", "max") and a in int_cols]
    for s in int_rows:
        if not torch.equal(rows[s].view(torch.int32),
                           ref_rows[s].view(torch.int32)):
            raise AssertionError(f"{what}: int32 {slots[s][0]} row {s} "
                                 "differs")
    keep = [s for s in range(len(slots)) if s not in int_rows]
    got = (got[0], got[1], rows[keep])
    ref = (ref[0], ref[1], ref_rows[keep])
    slots = [slots[s] for s in keep]

    if not torch.equal(got[0], ref[0]):
        raise AssertionError(f"{what}: valid differs")
    g, r = got[1], ref[1]
    if (g.dtype != r.dtype or g.shape != r.shape
            or not torch.equal(g.view(torch.int32), r.view(torch.int32))):
        raise AssertionError(f"{what}: bufs differ")
    rows, ref_rows = got[2], ref[2]
    if rows.shape != ref_rows.shape:
        raise AssertionError(f"{what}: rows shape differs")
    if not slots:
        return 0.0, 0.0
    for s, (kind, _) in enumerate(slots):
        nan = torch.isnan(ref_rows[s])
        if not torch.equal(torch.isnan(rows[s]), nan):
            raise AssertionError(f"{what}: {kind} row {s}: NaN elsewhere")
        a, b = rows[s][~nan], ref_rows[s][~nan]
        if kind in ("count", "min", "max"):
            ok = torch.equal(a, b)
        else:
            ok = torch.allclose(a, b, rtol=FOLD_RTOL, atol=0)
        if not ok:
            raise AssertionError(f"{what}: {kind} row {s} differs")
    fin = torch.isfinite(ref_rows)
    diff = (rows - ref_rows).abs()[fin]
    if not diff.numel():
        return 0.0, 0.0
    rel = diff / ref_rows.abs()[fin].clamp(min=1e-30)
    return float(diff.max()), float(rel.max())


def check_unique_fold(co, dev, gen):
    import torch

    all5 = [("count", -1), ("sum", 0), ("avg", 0), ("min", 1), ("max", 1),
            ("sum", 1)]
    both = all5 + [("min", 0), ("max", 0), ("avg", 1)]
    zipf = zipf_codes(gen, BATCH, N_SYMBOLS)
    cases = [
        # (name, E, C, A, slots, codes, fold_inputs keywords)
        ("small E=3001 C=128 A=2", 3001, 128, 2, all5, None, {}),
        ("edge E=1 C=128 A=0", 1, 128, 0, [("count", -1)], None, {}),
        ("main E=524288 C=16384 A=2", BATCH, 16_384, 2, QUOTE_SLOTS, zipf,
         {}),
        ("carried table 30% valid E=524288 C=16384", BATCH, 16_384, 2, both,
         zipf, {"p_valid": 0.3}),
        ("table E=20000 C=65536 A=2", 20_000, 65_536, 2, all5, None, {}),
        ("E=524287 C=16384", BATCH - 1, 16_384, 2, all5,
         zipf[:BATCH - 1], {}),
        ("hot key: every event on one slot", BATCH, 16_384, 2, both,
         torch.full((BATCH,), 77, dtype=torch.int32), {}),
        ("no event masked", 50_000, 4096, 2, both, None, {"p_mask": 0.0}),
        ("codes past both ends", 50_000, 4096, 2, both,
         torch.randint(-10_000, 14_096, (50_000,), generator=gen,
                       dtype=torch.int32), {}),
        ("C=1", 20_000, 1, 2, both, None, {}),
        ("C=2^20 E=8192", 8192, 1 << 20, 2, both, None, {}),
        ("empty carried table E=65536 C=16384", 65_536, 16_384, 2, both,
         None, {"p_valid": 0.0}),
    ]
    nonfinite = [
        ("NaN, +inf and -inf E=20000 C=128", 20_000, 128, 2, both, None, {}),
        ("NaN, +inf and -inf E=524288 C=16384", BATCH, 16_384, 2, both,
         zipf, {}),
    ]
    # K3's integer path: column 0 int32 (U1's volume), column 1 float
    # (NaN and infinities in the second case)
    ints = [
        ("int32 column E=3001 C=128", 3001, 128, 2, both, None, {}),
        ("int32 column E=524288 C=16384", BATCH, 16_384, 2, both, zipf,
         {}),
        ("int32 column, float NaN and inf E=20000 C=4096", 20_000, 4096, 2,
         both, None, {}),
        ("int32 columns only E=65536 C=16384", 65_536, 16_384, 2, both,
         None, {}),
    ]
    err = rel = 0.0
    for i, (name, E, C, A, slots, codes, kw) in enumerate(
            cases + nonfinite + ints):
        args = fold_inputs(dev, gen, E, C, A, codes=codes, **kw)
        int_cols = ()
        if i >= len(cases) + len(nonfinite):
            int_cols = (0, 1) if "only" in name else (0,)
            if "NaN" in name:
                args = non_finite(dev, gen, args)
            args = int_columns(dev, gen, args, int_cols)
        elif i >= len(cases):
            args = non_finite(dev, gen, args)
        got = co.unique_window_fold(*args, slots, int_cols)
        ref = co.unique_window_fold_plain(*args, slots, int_cols)
        torch.cuda.synchronize()
        e, r = fold_err(got, ref, slots, f"unique_window_fold {name}",
                        int_cols)
        n_nan = int(torch.isnan(ref[2][[
            s for s, (k, a) in enumerate(slots)
            if not (k in ("min", "max") and a in int_cols)]]).sum())
        err, rel = max(err, e), max(rel, r)
        log(f"  unique_window_fold {name}: table exact, rows max abs err "
            f"{e:.6g}, max rel err {r:.3g}, NaN cells {n_nan}, "
            f"{co.unique_window_fold.kernel_launches} kernel launches, "
            f"{co.unique_window_fold.scratch_bytes} B scratch")
    return err, rel


# -- phase 3, K7-K9: the scan windows' loops --------------------------------

SCAN_RTOL = 1e-5  # K8 / K9 sums: the kernels' fp64 warp sums vs float32


def same_bits(a, b, what):
    """Equal as stored: float32 by bit pattern, except that any NaN equals
    any NaN (the kernels write the canonical NaN)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} against "
                             f"{b.dtype}{tuple(b.shape)}")
    if a.dtype == torch.float32:
        nan = torch.isnan(b)
        if not torch.equal(torch.isnan(a), nan) or not torch.equal(
                a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]):
            raise AssertionError(f"{what}: kernel and plain version disagree")
        return 0
    return same(a, b, what)


def scan_rows_err(got, ref, slots, int_cols, what):
    """K8 / K9 rows, kernel against plain: counts, minima and maxima equal
    as stored (an int column's by int32 bits; NaN places equal), sums and
    averages within SCAN_RTOL with NaN and infinities in the same places.
    Returns the largest relative difference."""
    import torch

    worst = 0.0
    for s, (kind, a) in enumerate(slots):
        g, r = got[s], ref[s]
        if kind in ("min", "max") and a in int_cols:
            same(g.view(torch.int32), r.view(torch.int32), f"{what} {kind}")
            continue
        if kind in ("count", "min", "max"):
            same_bits(g, r, f"{what} {kind} row {s}")
            continue
        nan = torch.isnan(r)
        fin = torch.isfinite(r)
        if (not torch.equal(torch.isnan(g), nan)
                or not torch.equal(g[~fin & ~nan], r[~fin & ~nan])
                or not torch.allclose(g[fin], r[fin], rtol=SCAN_RTOL,
                                      atol=0)):
            raise AssertionError(f"{what}: {kind} row {s} differs")
        if fin.any():
            rel = ((g[fin] - r[fin]).abs()
                   / r[fin].abs().clamp(min=1e-30)).max()
            worst = max(worst, float(rel))
    return worst


def scan_values(rng, E, A, int_cols, p_nan=0.0):
    """Float32 ``[A, E]`` argument values: prices in [1, 500) to the cent,
    an int column's int32 values in [0, 2^31) (most past 2^24; one sign,
    as ``int_columns`` says why) by bit pattern, a share ``p_nan`` of a
    float column NaN."""
    v = np.round(rng.random((A, E)) * 499 + 1, 2).astype(np.float32)
    for a in range(A):
        if a in int_cols:
            v[a] = rng.integers(0, 2 ** 31 - 1, E).astype(
                np.int32).view(np.float32)
        elif p_nan:
            v[a][rng.random(E) < p_nan] = np.nan
    return v


def session_inputs(co, rng, E, G, A, int_cols, gap, keyed=True):
    """K7's inputs: 80% of E events masked, one ms apart with 1% of them
    up to three gaps late (stragglers), keys uniform over G (all 0
    unkeyed), float32 arguments (an int column's values as float32, as the
    artifact casts them), and a carried table from the plain version's
    walk over a first batch of the same shape."""
    import torch

    def batch(t0):
        ts = t0 + np.arange(E, dtype=np.int64)
        late = rng.random(E) < 0.01
        ts[late] -= rng.integers(1, 3 * gap, int(late.sum()))
        codes = (rng.integers(0, G, E) if keyed else np.zeros(E)).astype(
            np.int32)
        vals = np.round(rng.random((A, E)) * 499 + 1, 2).astype(np.float32)
        for a in int_cols:
            vals[a] = rng.integers(-2 ** 31, 2 ** 31 - 1, E).astype(
                np.float32)
        return (torch.from_numpy(rng.random(E) < 0.8),
                torch.from_numpy(codes), torch.from_numpy(ts.astype(np.int32)),
                torch.from_numpy(vals))

    ident = [(2 ** 31 - 1, -2 ** 31) if a in int_cols
             else (float("inf"), float("-inf")) for a in range(A)]
    mn = torch.zeros((A, G), dtype=torch.float32)
    mx = torch.zeros((A, G), dtype=torch.float32)
    for a, (lo, hi) in enumerate(ident):
        if a in int_cols:
            mn[a] = torch.full((G,), lo, dtype=torch.int32).view(
                torch.float32)
            mx[a] = torch.full((G,), hi, dtype=torch.int32).view(
                torch.float32)
        else:
            mn[a], mx[a] = lo, hi
    state = (torch.zeros(G, dtype=torch.bool),
             torch.zeros(G, dtype=torch.int32),
             torch.zeros(G, dtype=torch.int32),
             torch.zeros((A, G), dtype=torch.float32), mn, mx)
    first = co.session_scan_plain(*batch(1000), *state, gap, int_cols)[:6]
    return (*batch(1000 + E), *first, gap, int_cols)


def session_check(co, args, what, dev):
    """K7 on ``dev`` against its plain version on the CPU copies: every
    output equal as stored (the sums too: both add in the reference's
    order)."""
    import torch

    t0 = time.perf_counter()
    ref = co.session_scan_plain(*args)
    plain_s = time.perf_counter() - t0
    got = co.session_scan(*[a.to(dev) if isinstance(a, torch.Tensor) else a
                            for a in args])
    torch.cuda.synchronize()
    names = ("open", "last", "cnt", "s", "mn", "mx", "closes", "c_last",
             "c_cnt", "c_s", "c_mn", "c_mx")
    for g, r, n in zip(got, ref, names):
        same_bits(g.cpu(), r, f"session_scan {what}: {n}")
    return int(ref[6].sum()), plain_s


def frequency_inputs(co, rng, E, C, A, int_cols, lossy, n_codes,
                     support=0.015, error=0.0015, zipf=False, k_map=None,
                     full=False):
    """K8's inputs: 80% of E events masked, codes uniform (or Zipf) over
    ``n_codes``, ``scan_values`` arguments, and a carried table from the
    plain version over a first batch of the same shape (``full``: every
    slot valid, holding codes 0 .. C - 1 with small counts, so unseen
    codes take the lossy victim path). ``k_map`` cuts the lookup map below
    the codes (the ballot-scan path)."""
    import torch

    width = max(int(np.ceil(1.0 / error)), 1) if lossy else 0
    factor = float(np.float32(support - error))
    slots = [("count", -1)] + [(k, a) for a in range(A)
                               for k in ("sum", "min", "max", "avg")]

    def batch():
        if zipf:
            w = 1.0 / np.arange(1, n_codes + 1)
            codes = rng.choice(n_codes, E, p=w / w.sum())
        else:
            codes = rng.integers(0, n_codes, E)
        return (torch.from_numpy(rng.random(E) < 0.8),
                torch.from_numpy(codes.astype(np.int32)),
                torch.from_numpy(scan_values(rng, E, A, int_cols, 0.001)))

    state = (torch.zeros(C, dtype=torch.bool),
             torch.full((C,), -1, dtype=torch.int32),
             torch.zeros(C, dtype=torch.int32),
             torch.zeros(C, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32),
             torch.zeros((A, C), dtype=torch.float32))
    tail = (slots, int_cols, lossy, width, factor,
            n_codes if k_map is None else k_map)
    first = co.frequency_scan_plain(*batch(), *state, *tail)[:6]
    if full:
        first = (torch.ones(C, dtype=torch.bool),
                 torch.arange(C, dtype=torch.int32),
                 torch.from_numpy(rng.integers(1, 6, C).astype(np.int32)),
                 torch.from_numpy(rng.integers(0, 3, C).astype(np.int32)),
                 torch.tensor(40, dtype=torch.int32),
                 torch.from_numpy(scan_values(rng, C, A, int_cols)))
    return (*batch(), *first, *tail)


def frequency_check(co, args, what, dev):
    """K8 on ``dev`` against its plain version on the CPU copies: the
    table, ``seen`` and ``emit`` equal, the rows by ``scan_rows_err``."""
    import torch

    t0 = time.perf_counter()
    ref = co.frequency_scan_plain(*args)
    plain_s = time.perf_counter() - t0
    got = co.frequency_scan(*[a.to(dev) if isinstance(a, torch.Tensor)
                              else a for a in args])
    torch.cuda.synchronize()
    for g, r, n in zip(got[:7], ref[:7], ("valid", "code", "freq", "delta",
                                          "seen", "bufs", "emit")):
        same_bits(g.cpu(), r, f"frequency_scan {what}: {n}")
    rel = scan_rows_err(got[7].cpu(), ref[7], args[9], args[10],
                        f"frequency_scan {what}")
    return int(ref[6].sum()), rel, plain_s


def sort_inputs(co, rng, E, P, C, A, int_cols, n_parts=None,
                p_nan_key=0.0):
    """K9's inputs: 80% of E events masked, partitions uniform over
    ``n_parts`` (of P buffers), float32 keys (a share ``p_nan_key`` NaN),
    ``scan_values`` arguments, and carried buffers from the plain version
    over a first batch of the same shape."""
    import torch

    slots = [("count", -1)] + [(k, a) for a in range(A)
                               for k in ("sum", "min", "max", "avg")]

    def batch():
        keys = np.round(rng.random(E) * 100, 2).astype(np.float32)
        keys[rng.random(E) < p_nan_key] = np.nan
        return (torch.from_numpy(rng.random(E) < 0.8),
                torch.from_numpy(rng.integers(0, n_parts or P, E).astype(
                    np.int32)),
                torch.from_numpy(keys),
                torch.from_numpy(scan_values(rng, E, A, int_cols, 0.001)))

    state = (torch.zeros((P, C), dtype=torch.bool),
             torch.zeros((P, C), dtype=torch.float32),
             torch.zeros((A, P, C), dtype=torch.float32))
    first = co.sort_window_scan_plain(*batch(), *state, slots, int_cols)[:3]
    return (*batch(), *first, slots, int_cols)


def sort_check(co, args, what, dev):
    """K9 on ``dev`` against its plain version on the CPU copies: the
    buffers equal as stored, the rows by ``scan_rows_err``."""
    import torch

    t0 = time.perf_counter()
    ref = co.sort_window_scan_plain(*args)
    plain_s = time.perf_counter() - t0
    got = co.sort_window_scan(*[a.to(dev) if isinstance(a, torch.Tensor)
                                else a for a in args])
    torch.cuda.synchronize()
    for g, r, n in zip(got[:3], ref[:3], ("valid", "bkey", "bufs")):
        same_bits(g.cpu(), r, f"sort_window_scan {what}: {n}")
    return scan_rows_err(got[3].cpu(), ref[3], args[7], args[8],
                         f"sort_window_scan {what}"), plain_s


def check_scan_windows(co, dev):
    """Phase 3, K7-K9: each kernel against its plain version (run on CPU
    copies), from a carried state the plain version left after a first
    batch. K7 (session_scan) equal as stored: S1's shape (E = 524,288,
    1,024 keys, 2 s gap, an int column past 2^24, stragglers), an unkeyed
    walk (E = 2,048) and 64 keys. K8 (frequency_scan): F1's `frequent(8)`
    and F2's `lossyFrequent(0.015, 0.0015)` (4,096 slots) over 50 codes,
    a lossy table of 16 slots over 300 codes (the victim path), codes past
    the lookup map (the ballot scan), a 70,000-slot `frequent` table in
    device memory (past shared memory), Zipf codes. K9
    (sort_window_scan): O1's shape (C = 10, one partition), O2's (64
    buffers of 4, 50 partitions), C = 100 (four chunks), NaN keys, a
    20,000-slot buffer in device memory. Int columns in each. Returns
    (max relative sum error, the plain versions' seconds)."""
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    rel = 0.0
    plain_s = 0.0
    for what, E, G, A, ints, gap, keyed in (
            ("S1 shape E=524288 G=1024", BATCH, 1024, 2, (1,), 2000, True),
            ("unkeyed E=2048", 2048, 128, 2, (1,), 3, False),
            ("64 keys E=65536 gap 80 ms", 65_536, 64, 1, (), 80, True)):
        args = session_inputs(co, rng, E, G, A, ints, gap, keyed)
        closed, ps = session_check(co, args, what, dev)
        plain_s += ps
        log(f"  session_scan {what}: exact, {closed} sessions closed "
            f"(plain {ps:.2f} s)")
    for what, E, C, A, ints, lossy, n_codes, kw in (
            ("F1 frequent(8) E=8192", 8192, 8, 2, (1,), False, 50, {}),
            ("F2 lossyFrequent cap 4096 E=8192", 8192, 4096, 1, (), True,
             50, {}),
            ("lossy full 16 slots, 300 Zipf codes (victims)", 4096, 16, 2,
             (0,), True, 300, dict(support=0.35, error=0.3, zipf=True,
                                   full=True)),
            ("codes past the map", 4096, 8, 1, (), False, 50,
             dict(k_map=10)),
            ("frequent 70000 slots in device memory", 1024, 70_000, 1, (),
             False, 90_000, {}),
            ("lossy Zipf codes", 8192, 256, 1, (0,), True, 2000,
             dict(support=0.05, error=0.01, zipf=True))):
        args = frequency_inputs(co, rng, E, C, A, ints, lossy, n_codes, **kw)
        emitted, r, ps = frequency_check(co, args, what, dev)
        rel, plain_s = max(rel, r), plain_s + ps
        log(f"  frequency_scan {what}: exact, {emitted} rows, sums rel err "
            f"{r:.3g} (plain {ps:.2f} s)")
    for what, E, P, C, A, ints, kw in (
            ("O1 shape C=10 E=4096", 4096, 1, 10, 2, (1,), {}),
            ("O2 shape 64 x 4, 50 partitions E=65536", 65_536, 64, 4, 1,
             (), dict(n_parts=50)),
            ("C=100 E=2048, NaN keys", 2048, 1, 100, 2, (0,),
             dict(p_nan_key=0.01)),
            ("C=20000 in device memory E=512", 512, 1, 20_000, 3, (2,),
             {})):
        args = sort_inputs(co, rng, E, P, C, A, ints, **kw)
        r, ps = sort_check(co, args, what, dev)
        rel, plain_s = max(rel, r), plain_s + ps
        log(f"  sort_window_scan {what}: exact, sums rel err {r:.3g} "
            f"(plain {ps:.2f} s)")
    log(f"  K7-K9 checks {time.perf_counter() - t0:.1f} s")
    return rel, plain_s


# -- phase 3, K4: the slot NFA scan -----------------------------------------

# the slot-NFA queries of phase 8b over the bench stream (ids uniform in
# [0, 50), 1 ms apart), and phase 3's spec shapes
SLOT_QUERIES = (
    # (a) a quantified middle element, compacted (6% of events relevant)
    ("quantified",
     "from every s1 = inputStream[id == 1] -> "
     "s2 = inputStream[id == 2]<2:4> -> s3 = inputStream[id == 3] "
     "within 1 sec select s1.price as p1, s2[0].price as p2first, "
     "s2[last].price as p2last, s3.timestamp as t3 insert into matches"),
    # (b) a sequence with a `+` element: every event scanned
    ("sequence",
     "from every s1 = inputStream[id < 10], "
     "s2 = inputStream[id >= 10 and id < 30]+, s3 = inputStream[id >= 30] "
     "select s1.timestamp as t1, s2[0].price as p2first, "
     "s2[last].price as p2last, s3.price as p3 insert into matches"),
    # (c) a cross-element filter: its event-only conjunct `id == 2` is the
    # element's mask, only `price > s1.price` runs per slot, and the scan
    # visits the events with id 1 or 2 (before the hoist, the mask was the
    # stream gate and every event was visited)
    ("cross",
     "from every s1 = inputStream[id == 1] -> "
     "s2 = inputStream[id == 2 and price > s1.price] within 1 sec "
     "select s1.price as p1, s2.price as p2, s2.timestamp as t2 "
     "insert into matches"),
    # (d) an 'or' group whose unfired member decodes None, compacted
    ("or_group",
     "from every s1 = inputStream[id == 1] -> "
     "(s2 = inputStream[id == 2] or s3 = inputStream[id == 4]) -> "
     "s4 = inputStream[id == 3] within 1 sec select s1.price as p1, "
     "s2.price as p2, s3.price as p3, s4.timestamp as t4 "
     "insert into matches"),
)
# phase 3's further spec shapes: (name, cql, per-element mask density)
SLOT_SHAPES = dict(
    quantified=(SLOT_QUERIES[0][1], (0.02, 0.05, 0.02)),
    sequence=(SLOT_QUERIES[1][1], (0.2, 0.4, 0.4)),
    cross=(SLOT_QUERIES[2][1], (0.02, 1.0)),
    or_group=(SLOT_QUERIES[3][1], (0.02, 0.02, 0.02, 0.02)),
    grouped_every=(
        "from every (s1 = inputStream[id == 1] -> s2 = inputStream[id == 2])"
        " select s1.price as p1, s2.timestamp as t2 insert into matches",
        (0.05, 0.05)),
    midchain_fork=(
        "from every s1 = inputStream[id == 1] -> "
        "every s2 = inputStream[id == 2] -> "
        "s3 = inputStream[id == 3 and price > s2.price] within 300 ms "
        "select s1.price as p1, s2.price as p2, s3.price as p3 "
        "insert into matches",
        (0.03, 0.05, 0.05)),
    and_group=(
        "from every s1 = inputStream[id == 1] -> "
        "(a = inputStream[id == 2] and b = inputStream[id == 3]) -> "
        "s4 = inputStream[id == 4] within 1 sec select s1.price as p1, "
        "a.price as pa, b.timestamp as tb, s4.price as p4 "
        "insert into matches",
        (0.03, 0.03, 0.03, 0.03)),
    # every without within: partials pin the pool, which fills
    full_pool=(
        "from every s1 = inputStream[id < 25] -> "
        "s2 = inputStream[id == 49]<2:3> select s1.price as p1, "
        "s2[1].price as p2 insert into matches",
        (0.5, 0.001)),
    # (c) with the masks of its hoisted conjunct: ids 1 and 2
    cross_hoisted=(SLOT_QUERIES[2][1], (0.02, 0.02)),
    # a full pool whose partials fork (mid-chain every, no within)
    fork_pool=(
        "from every s1 = inputStream[id < 25] -> "
        "every s2 = inputStream[id < 40] -> s3 = inputStream[id == 49] "
        "select s1.price as p1, s2.price as p2, s3.price as p3 "
        "insert into matches",
        (0.3, 0.3, 0.01)),
    # `/` and `%`, int and float: s1.id is 1, so (s1.id - 1) divides by 0
    div_mod=(
        "from every s1 = inputStream[id == 1] -> s2 = inputStream["
        "price / s1.price > 1.5 or id % (s1.id + 1) == 0 or "
        "(id - 25) / (s1.id - 1) < -3 or price % s1.price < 1.0 or "
        "id % (s1.id - 1) == 0 or price % (s1.price - 50.0) > 7.0] "
        "within 1 sec select s1.price as p1, s2.price as p2 "
        "insert into matches",
        (0.02, 1.0)),
    # a program 22 entries deep (the stack held 16 before): price >
    # s1.price - 10
    deep_program=(
        "from every s1 = inputStream[id == 1] -> s2 = inputStream[price > "
        + "".join(f"({k} - " for k in range(20)) + "s1.price" + ")" * 20
        + "] within 1 sec select s1.price as p1, s2.price as p2 "
        "insert into matches",
        (0.02, 1.0)),
    # a program of 1,708 words (programs held 1,024 words before)
    long_program=(
        "from every s1 = inputStream[id == 1] -> s2 = inputStream["
        + " and ".join(f"price != s1.price + {k}" for k in range(190))
        + "] within 50 ms select s1.price as p1, s2.price as p2 "
        "insert into matches",
        (0.01, 1.0)),
)


def slot_plan(fpt, cql, slots):
    """The slot artifact of ``cql`` over the bench stream's schema, with a
    pool of ``slots``."""
    schema = fpt.StreamSchema([("id", "int"), ("name", "string"),
                               ("price", "double"), ("timestamp", "long")])
    plan = fpt.compile_plan(cql, {"inputStream": schema},
                            config=fpt.EngineConfig(pattern_slots=slots))
    (art,) = plan.artifacts
    if type(art).__name__ != "SlotNFAArtifact":
        raise AssertionError(f"{cql[:60]}: compiled to {type(art).__name__}")
    return art


def slot_inputs(art, E, density, rng, dev, compacted=None):
    """Random scan inputs for ``art``: ts 1 ms apart, 1% invalid events,
    element k's mask bit with probability ``density[k]`` (the entry masks a
    random subset), the capture and program columns as the bench stream's
    (prices float32 with NaN, +inf and -inf among them, ids in [0, 50),
    timestamps), and for a compacted scan the relevant events' index and
    count (``compacted``: None for the scan's own rule, else the count to
    pass: 0 or E)."""
    import torch

    K = art.spec.n_elements
    ts = 1000 + np.arange(E, dtype=np.int32)
    valid = rng.random(E) < 0.99
    mword = np.zeros(E, np.int32)
    for k in range(K):
        mword |= ((rng.random(E) < density[k]) & valid).astype(np.int32) << k
    eword = mword & ~((rng.random(E) < 0.1).astype(np.int32) << (K - 1))
    cols = []
    for key in art._cols:
        if key.endswith("price"):
            v = (rng.random(E) * 100).astype(np.float32)
            v[rng.random(E) < 0.01] = np.nan
            v[rng.random(E) < 0.01] = np.inf
            v[rng.random(E) < 0.01] = -np.inf
            cols.append(v.view(np.int32))
        elif key.endswith("timestamp"):
            cols.append(ts)
        else:
            cols.append(rng.integers(0, 50, E).astype(np.int32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    args = [t(ts), t(valid), t(mword), t(eword),
            t(np.stack(cols)) if cols else
            torch.zeros((0, E), dtype=torch.int32, device=dev)]
    idx = cnt = None
    if art.spec.kind == "pattern" and E >= 4096:
        rel = (mword != 0) & valid
        order = np.concatenate([np.flatnonzero(rel), np.flatnonzero(~rel)])
        n = int(rel.sum()) if compacted is None else compacted
        if compacted == E:
            order = np.arange(E)
        idx, cnt = t(order.astype(np.int32)), t(np.array([n], np.int32))
    return args + [idx, cnt]


def slot_check(co, art, E, density, rng, dev, what, compacted=None):
    """K4 on the card against its plain version on CPU copies, from a
    carried state (the plain version run over a random prefix first):
    the state, the scalars and the whole emission buffer exactly. Returns
    the emitted rows and the overflow."""
    import torch

    plan = art.scan_plan
    mat, scal = art._pack_state(art.init_state("cpu"))
    pre = slot_inputs(art, 1024, density, rng, "cpu")
    mat, scal4, _ = co.slot_nfa_scan_plain(plan, mat, scal, *pre)
    scal = scal4[:3].clone()
    args = slot_inputs(art, E, density, rng, "cpu", compacted)
    ref = co.slot_nfa_scan_plain(plan, mat, scal, *args)
    got = co.slot_nfa_scan(plan, mat.to(dev), scal.to(dev),
                           *[a.to(dev) if a is not None else None
                             for a in args])
    for g, r, name in zip(got, ref, ("state", "scalars", "buffer")):
        same(g.cpu(), r, f"slot_nfa_scan {what}: {name}")
    return int(ref[1][3]), int(ref[1][2])


def slot_graph_check(co, art, E, density, rng, dev, replays=3):
    """K4 captured into a CUDA graph, replayed on new inputs copied into
    the captured tensors: each replay exact against the plain version."""
    import torch

    plan = art.scan_plan
    mat, scal = art._pack_state(art.init_state("cpu"))
    static = [a.to(dev) if a is not None else None
              for a in [mat, scal] + slot_inputs(art, E, density, rng, "cpu")]
    co.slot_nfa_scan(plan, *static)  # the plan's upload, outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = co.slot_nfa_scan(plan, *static)
    torch.cuda.current_stream().wait_stream(stream)
    for r in range(replays):
        pre = slot_inputs(art, 1024, density, rng, "cpu")
        mat2, scal4, _ = co.slot_nfa_scan_plain(plan, mat, scal, *pre)
        new = [mat2, scal4[:3].clone()] + slot_inputs(art, E, density, rng,
                                                      "cpu")
        for dst, src in zip(static, new):
            if dst is not None:
                dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        ref = co.slot_nfa_scan_plain(plan, *new)
        for g, rr, name in zip(out, ref, ("state", "scalars", "buffer")):
            same(g.cpu(), rr, f"slot_nfa_scan graph replay {r}: {name}")
    return replays


# phase 3's original spec shapes (each at S = 64, E = 4,096)
SLOT_SHAPES_BASE = ("quantified", "sequence", "cross", "or_group",
                    "grouped_every", "midchain_fork", "and_group",
                    "full_pool")


def check_slot_nfa(fpt, co, dev):
    """K4 held exactly to its plain version on random inputs. The 17 cases
    of the first port: every original spec shape at S = 64 and E = 4,096; the
    quantified, cross and fork shapes at S = 1,024; the sequence and cross
    shapes at E = 16,384 (S = 64), the quantified and sequence shapes at S
    = 1,024 and E = 16,384; a device count of 0 and of E; a full pool
    (overflow); NaN and +-inf prices. Then every launch shape of the
    redesign (one warp at S = 1, 31, 32, 33; the multi-warp pools at S =
    65, 1,024, 2,048, 4,096), a full pool that forks at S = 64 and 96,
    programs with `/` and `%`, a 22-deep stack and 1,708 words, and (c)
    hoisted. And a CUDA graph replayed on new inputs."""
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    cases = [(name, 64, 4096, None) for name in SLOT_SHAPES_BASE]
    cases += [(n, 1024, 4096, None)
              for n in ("quantified", "cross", "midchain_fork")]
    cases += [(n, 64, 16384, None) for n in ("sequence", "cross")]
    cases += [(n, 1024, 16384, None) for n in ("quantified", "sequence")]
    cases += [("quantified", 64, 4096, 0), ("quantified", 64, 4096, 4096)]
    n_base = len(cases)
    cases += [("quantified", S, 4096, None) for S in (1, 31, 32, 33, 65)]
    cases += [("midchain_fork", S, 4096, None) for S in (31, 33, 65)]
    cases += [("sequence", S, 4096, None) for S in (1, 33, 65)]
    cases += [("quantified", S, 4096, None) for S in (2048, 4096)]
    cases += [("fork_pool", S, 4096, None) for S in (64, 96)]
    cases += [(n, 64, 4096, None) for n in ("div_mod", "deep_program",
                                            "cross_hoisted")]
    cases += [("long_program", 64, 1024, None)]
    out = {}
    arts = {}
    for name, S, E, forced in cases:
        art = arts.get((name, S))
        if art is None:
            art = arts[(name, S)] = slot_plan(fpt, SLOT_SHAPES[name][0], S)
        what = f"{name} S={S} E={E}" + (
            f" count={forced}" if forced is not None else "")
        rows, over = slot_check(co, art, E, SLOT_SHAPES[name][1], rng, dev,
                                what, forced)
        out[what] = {"rows": rows, "overflow": over}
    for what in ("full_pool S=64 E=4096", "fork_pool S=64 E=4096",
                 "fork_pool S=96 E=4096"):
        if not out[what]["overflow"]:
            raise AssertionError(f"slot_nfa_scan: {what} did not overflow")
    if not all(v["rows"] for k, v in out.items() if "count=0" not in k):
        raise AssertionError(f"slot_nfa_scan: a case emitted nothing: {out}")
    replays = slot_graph_check(co, arts[("cross", 64)], 4096,
                               SLOT_SHAPES["cross"][1], rng, dev)
    log(f"  slot_nfa_scan exact against its plain version in {len(cases)} "
        f"cases ({n_base} of the first port's) and {replays} graph replays "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(out)}")
    return 0


# -- phase 3, K5: the join's pair step ------------------------------------------

JOIN_CHECK_E = 8_192  # phase 3's K5 inputs: tape positions a call
JOIN_BIG_E = 524_288  # ... and at J1's batch
JOIN_HUGE_E = 131_072  # ... and where the pairs pass 2^31


def _f32_words(x):
    return x.astype(np.float32).view(np.int32)


DEEP_LOADS = 240  # phase 3's deep `on` program: loads of its right side
DEEP_CUT_WORDS = 1 << 16  # ... and a global stack this small: a cut grid


def deep_on_program(sp, n=DEEP_LOADS):
    """A program of more than 300 words, past K5's and K6's 227-word local
    stacks: ``a.id == b.id and a.price + (b.price + (a.price + ...)) > n *
    50.0``, its ``n`` price loads (alternately the event's and the
    other side's) pushed before their adds: about 2 n words, a stack n + 1
    deep; about half of the key's candidates pass. Returns (program,
    depth)."""
    lit = int(np.float32(n * 50.0).view(np.int32))
    loads = tuple(sp.OP_EVT | 1 << 8 if k % 2 == 0 else sp.OP_CAP | 1 << 8
                  for k in range(n))
    right = loads + (sp.OP_ADD_F,) * (n - 1) + (sp.OP_LIT, lit,
                                                sp.OP_GT_F)
    prog = ((sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I,
             sp.OP_ANDJ | (len(right) + 1) << 8) + right + (sp.OP_AND,))
    return prog, sp._depth(prog)


def join_inputs(co, E, C, rng, dev, mode_time, sorted_ts, n=100, span=100,
                outer=(False, False), prog=None, depth=0, dense=False,
                subnormal=False, jitter=0, sides="both"):
    """One K5 call's inputs (two ``JoinDir``s and the tape's ts) as a join
    step makes them: each tape position arrives on one side (ts one ms
    apart, two streams interleaved); each side's combined buffer is its
    ring of C entries (``seen`` events before, the last C valid) then its
    batch events in tape order. Columns: id in [0, 50) (or [0, 2):
    ``dense``), a float price (with subnormal values: ``subnormal``).
    ``sorted_ts=False`` moves some ring timestamps out of order;
    ``jitter`` moves each tape ts by up to that many ms either way (a
    disordered stream). ``sides``: "both" (two streams), "one" (every
    event on stream 0: direction 1 has no arriving event) or "same" (a
    self-join: every event arrives on both sides and is in both
    buffers)."""
    import torch

    side = rng.integers(0, 2, E) if sides == "both" else np.zeros(E, int)
    ts = (np.arange(E) + 5_000).astype(np.int32)
    if jitter:
        ts = (ts + rng.integers(-jitter, jitter + 1, E)).astype(np.int32)
    ids = rng.integers(0, 2 if dense else 50, E).astype(np.int32)
    price = (rng.random(E) * 100).astype(np.float32)
    if subnormal:
        # subnormal values, and small normal ones whose remainders are
        # subnormal (fmodf under -ftz=true flushes those)
        tiny = np.float32(np.finfo(np.float32).tiny)
        u = rng.random(E)
        k = u < 0.3
        price[k] = (rng.uniform(-4, 4, int(k.sum())) * tiny / 8).astype(
            np.float32)
        k = (u >= 0.3) & (u < 0.5)
        price[k] = (rng.uniform(1, 4, int(k.sum())) * tiny).astype(
            np.float32)
    dirs = []
    for d in (0, 1):
        a_mask = side == d if sides != "same" else np.ones(E, bool)
        b_mask = side != d if sides != "same" else np.ones(E, bool)
        M = int(b_mask.sum())
        seen = int(rng.integers(C // 2, 4 * C))
        order = np.concatenate([np.flatnonzero(b_mask),
                                np.flatnonzero(~b_mask)])
        ring_ts = np.sort(5_000 - rng.integers(1, 4 * min(span, 1000),
                                                C)).astype(np.int32)
        if not sorted_ts:
            ring_ts = rng.permutation(ring_ts)
        b_ts = np.concatenate([ring_ts, ts[order]])
        b_valid = np.concatenate([np.arange(C) >= C - min(seen, C),
                                  np.arange(E) < M])
        b_posid = np.concatenate([np.full(C, -1), order]).astype(np.int32)
        b_cum = (seen + np.cumsum(b_mask)).astype(np.int32)
        ring_ids = rng.integers(0, 2 if dense else 50, C).astype(np.int32)
        ring_px = (rng.random(C) * 100).astype(np.float32)
        b_cols = np.stack([np.concatenate([ring_ids, ids[order]]),
                           _f32_words(np.concatenate([ring_px,
                                                      price[order]]))])
        a_cols = np.stack([ids, _f32_words(price)])
        t = lambda x, dt=torch.int32: torch.from_numpy(
            np.ascontiguousarray(x)).to(dt).to(dev)
        dirs.append(co.JoinDir(
            a_mask=t(a_mask, torch.bool), a_cols=t(a_cols),
            b_ts=t(b_ts), b_valid=t(b_valid, torch.bool),
            b_posid=t(b_posid), b_cum=t(b_cum),
            b_seen=t(np.asarray([seen])), b_cols=t(b_cols),
            prog=prog or (), depth=depth, mode_time=mode_time and d == 0,
            n=n, span=span, C=C, outer=outer[d],
        ))
    return dirs, torch.from_numpy(ts).to(dev)


JOIN_PLAIN_CARD_CELLS = 1 << 28  # the plain version's chunk on the card


def join_plain(co, dirs, ts, cap, self_join, within, on_card=False):
    """K5's plain version on CPU copies of its inputs, or ``on_card`` on
    the card's own (in chunks of JOIN_PLAIN_CARD_CELLS mask cells: the
    dense formulation at a full-width step, which the CPU cannot run in
    the time limit). Returns its (i, j, seg, n) and its ms."""
    import torch

    if not on_card:
        dirs, ts = join_args_copy((dirs, ts))
    chunk = co._PLAIN_CHUNK_CELLS
    co._PLAIN_CHUNK_CELLS = JOIN_PLAIN_CARD_CELLS if on_card else chunk
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = co.join_pairs_plain(dirs, ts, cap, self_join, within)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        co._PLAIN_CHUNK_CELLS = chunk
    return ref, ms


def join_check(co, dirs, ts, cap, self_join, within, what, on_card=False):
    """K5 against its plain version (CPU copies, or on the card:
    ``join_plain``), exactly: every rank below cap and n. Returns (n, cap,
    the largest difference (0), the plain version's ms)."""
    got = co.join_pairs(dirs, ts, cap, self_join, within)
    ref, ms = join_plain(co, dirs, ts, cap, self_join, within, on_card)
    err = 0
    for g, r, part in zip(got, ref, ("i", "j", "segment", "n")):
        err = max(err, same(g.to(r.device), r,
                            f"join_pairs {what}: {part}"))
    return int(ref[3][0]), cap, err, ms


def join_counts(co, dirs, ts, cap, self_join, within):
    """One more K5 call on the same inputs, with its counters: (the
    candidates in the arriving events' bands, the tiles walked again)."""
    import torch

    visits = torch.zeros(1, dtype=torch.int64, device=ts.device)
    rewalks = torch.zeros(1, dtype=torch.int64, device=ts.device)
    co.join_pairs(dirs, ts, cap, self_join, within, visits=visits,
                  rewalks=rewalks)
    return int(visits[0]), int(rewalks[0])


def check_join_pairs(fpt, co, dev):
    """Phase 3, K5: the kernel exactly equal to its plain version on the
    card's inputs at E = 8,192 (a length window and a time window over
    ring timestamps in and out of order), past its cap, with outer rows, a
    self-join, `within`, and `on` programs (J1's equality; `/` and `%` and
    comparisons over float columns with subnormal values, through the
    interpreter K4 shares); the redesign's slow paths, each asserted to
    run by the kernel's re-walk counter where it has one: warps whose
    pairs overflow their staging, a length window whose tiles' union of
    bands passes one shared-memory chunk, a disordered tape under a time
    window (a tile's bands start out of order), a tape that ends inside a
    tile, a direction with no arriving event, a self-join of one stream
    with `within` and outer rows on both sides; a program deeper than the
    kernel's local stack (``deep_on_program``: its global stack) at E =
    1,024, one block a tile and a cut grid (a global stack of
    DEEP_CUT_WORDS words: each block walks its tiles in turn); at E =
    524,288 (J1's
    batch: 4,096 tiles in the look-back, binary searches over 262k-entry
    buffers) past its cap of 2,097,152; and at E = 131,072 with no `on`
    over windows that hold every earlier event, whose pairs pass 2^31
    (the count saturates at 2^31 - 1; every tile's union streams in
    chunks); the last two with the plain version on the card. Then a CUDA
    graph replay of one call. Also prints the float probe: what the
    build's -ftz=true does to the intrinsics alone."""
    import torch

    from flink_siddhi_tpu_torch.compiler import slot_program as sp

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    E, C = JOIN_CHECK_E, 128
    eq = (sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I)  # a.id == b.id
    one = int(np.float32(1.0).view(np.int32))
    half = int(np.float32(0.5).view(np.int32))
    fprog = (  # a.price / b.price > 1.0 or a.price % b.price < 0.5 ...
        sp.OP_EVT | 1 << 8, sp.OP_CAP | 1 << 8, sp.OP_DIV_F,
        sp.OP_LIT, one, sp.OP_GT_F, sp.OP_ORJ | 7 << 8,
        sp.OP_EVT | 1 << 8, sp.OP_CAP | 1 << 8, sp.OP_MOD_F,
        sp.OP_LIT, half, sp.OP_LT_F, sp.OP_OR,
        sp.OP_ANDJ | 4 << 8, sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I, sp.OP_AND,
    )
    cases = [
        ("length n=100, J1's on", dict(mode_time=False, sorted_ts=True,
                                       prog=eq, depth=2), 4 * E, False,
         None),
        ("time, ring ts in order", dict(mode_time=True,
                                        sorted_ts=True, prog=eq,
                                        depth=2), 4 * E, False, None),
        ("time, ring ts out of order", dict(mode_time=True,
                                            sorted_ts=False, prog=eq,
                                            depth=2), 4 * E, False, None),
        ("past cap, outer rows", dict(mode_time=True, sorted_ts=True,
                                      dense=True, outer=(True, True)),
         E, False, None),
        ("self-join, within, unsorted", dict(mode_time=True,
                                             sorted_ts=False, prog=eq,
                                             depth=2, outer=(True, False)),
         4 * E, True, 40),
        ("float program, subnormals", dict(mode_time=False,
                                           sorted_ts=True, prog=fprog,
                                           depth=3, subnormal=True,
                                           dense=True), 4 * E, False, None),
    ]
    odd = E + 77
    cases += [  # the redesign's slow paths (`at_E`: another tape)
        ("staging overflow", dict(mode_time=False, sorted_ts=True,
                                  prog=eq, depth=2, dense=True),
         64 * E, False, None),
        ("union past one chunk", dict(mode_time=False, sorted_ts=True,
                                      prog=eq, depth=2, n=E),
         128 * E, False, None),
        ("time, a disordered tape", dict(mode_time=True, sorted_ts=False,
                                         prog=eq, depth=2, jitter=300),
         4 * E, False, None),
        ("E not a multiple of the tile", dict(mode_time=True,
                                              sorted_ts=True, prog=eq,
                                              depth=2, at_E=odd,
                                              outer=(True, True)),
         4 * odd, False, None),
        ("a direction with no arrivals", dict(mode_time=True,
                                              sorted_ts=True, prog=eq,
                                              depth=2, sides="one",
                                              outer=(True, True)),
         4 * E, False, None),
        ("self-join, within, outer rows", dict(mode_time=True,
                                               sorted_ts=False, prog=eq,
                                               depth=2, sides="same",
                                               outer=(True, True)),
         8 * E, True, 40),
    ]
    deep, ddepth = deep_on_program(sp)
    if len(deep) < 300 or ddepth <= co.STACK_LOCAL_DEPTH:
        raise AssertionError(f"the deep program: {len(deep)} words, "
                             f"depth {ddepth}")
    dE = 1_024  # the plain version's dense mask runs the whole program
    cases += [  # the global stack: one block a tile, then a cut grid
        (f"a {len(deep)}-word program, depth {ddepth}", dict(
            mode_time=False, sorted_ts=True, prog=deep, depth=ddepth,
            at_E=dE), 4 * dE, False, None),
        (f"a {len(deep)}-word program, a cut grid", dict(
            mode_time=True, sorted_ts=False, prog=deep, depth=ddepth,
            outer=(True, True), at_E=dE, stack_words=DEEP_CUT_WORDS),
         4 * dE, False, None),
    ]
    big = JOIN_BIG_E
    cases += [
        (f"E = {big}, past cap", dict(mode_time=True, sorted_ts=True,
                                     dense=True, prog=eq, depth=2),
         4 * big, False, None, big),
        ("pairs past 2^31", dict(mode_time=True, sorted_ts=True,
                                 n=1 << 30, span=1 << 30),
         4 * JOIN_HUGE_E, False, None, JOIN_HUGE_E),
    ]
    out = {}
    err = 0
    for what, kw, cap, self_join, within, *e in cases:
        at_E = kw.pop("at_E", e[0] if e else E)
        words = kw.pop("stack_words", co.STACK_WORDS)
        dirs, ts = join_inputs(co, at_E, C, rng, dev, **kw)
        words, co.STACK_WORDS = co.STACK_WORDS, words
        try:
            n, cap, e_, ms = join_check(co, dirs, ts, cap, self_join,
                                        within, what, on_card=bool(e))
            visits, rewalks = join_counts(co, dirs, ts, cap, self_join,
                                          within)
        finally:
            co.STACK_WORDS = words
        err = max(err, e_)
        out[what] = {"n": n, "cap": cap, "visits": visits,
                     "rewalks": rewalks}
        if e:
            out[what]["plain_ms_on_card"] = ms
        if "past cap" in what and n <= cap:
            raise AssertionError(f"join_pairs {what}: n {n} within cap")
        if "2^31" in what and n != co.N_MAX:
            raise AssertionError(f"join_pairs {what}: n {n} unsaturated")
        if what in ("staging overflow", "union past one chunk",
                    "pairs past 2^31") and not rewalks:
            raise AssertionError(f"join_pairs {what}: no tile walked "
                                 "again")
        if what.startswith("union") and n > cap:
            raise AssertionError(f"join_pairs {what}: n {n} past cap, "
                                 "the re-walk's writes unchecked")
        del dirs, ts
        torch.cuda.empty_cache()
    # a CUDA graph replay of one call, on new inputs copied in
    dirs, ts = join_inputs(co, E, C, rng, dev, mode_time=True,
                           sorted_ts=True, prog=eq, depth=2)
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        # warm on the capturing stream (the program, the look-back scratch)
        co.join_pairs(dirs, ts, 4 * E, False, None)
        with torch.cuda.graph(g, stream=s):
            res = co.join_pairs(dirs, ts, 4 * E, False, None)
    torch.cuda.current_stream().wait_stream(s)
    new, _ = join_inputs(co, E, C, rng, dev, mode_time=True,
                         sorted_ts=True, prog=eq, depth=2)
    for d, nd in zip(dirs, new):
        for f in dataclasses.fields(d):
            v = getattr(d, f.name)
            if isinstance(v, torch.Tensor):
                v.copy_(getattr(nd, f.name))
    g.replay()
    torch.cuda.synchronize()
    ref = co.join_pairs(new, ts, 4 * E, False, None)
    for a, b, part in zip(res, ref, ("i", "j", "segment", "n")):
        same(a, b, f"join_pairs graph replay: {part}")
    # the float probe: the intrinsics under -ftz=true, no explicit flush
    tiny = np.float32(np.finfo(np.float32).tiny)
    a = torch.tensor([tiny / 4, tiny * 1.5, 3e-39, 1.0], device=dev)
    b = torch.tensor([0.0, tiny, 1.0, 3e-39], device=dev)
    probe = co.ftz_probe(a, b).cpu().numpy()
    log(f"  float probe (+, *, /, <, ==, fmodf of {a.tolist()} and "
        f"{b.tolist()}): {probe.tolist()}")
    log(f"  join_pairs: exact against its plain version in "
        f"{len(cases)} cases and a graph replay ({json.dumps(out)}; "
        f"{time.perf_counter() - t0:.1f} s)")
    return err


TABLE_CHECK_E = 8_192  # phase 3's K6 inputs: tape positions a call
TABLE_C = 1_024  # the reference's default table_capacity
TABLE_BIG_C = 16_384
MUTATE_PLAIN_CARD_CELLS = 1 << 28  # the plain version's chunk on the card


def mutate_inputs(E, C, rng, dev, n_ids=2_048, p_mask=0.5, fill=0.7):
    """One K6 call's inputs as a table update makes them: the events' words
    (id, price, and a select output ``price * 2.0`` that is no table
    column), the query's mask, and a table of C rows (id, price) with
    ``fill`` of them valid."""
    import torch

    ids = rng.integers(0, n_ids, E).astype(np.int32)
    price = (rng.random(E) * 100).astype(np.float32)
    a_cols = np.stack([ids, _f32_words(price), _f32_words(price * 2)])
    b_cols = np.stack([rng.integers(0, n_ids, C).astype(np.int32),
                       _f32_words((rng.random(C) * 100).astype(np.float32))])
    t = lambda x, dt=torch.int32: torch.from_numpy(
        np.ascontiguousarray(x)).to(dt).to(dev)
    return (t(rng.random(E) < p_mask, torch.bool), t(a_cols),
            t(rng.random(C) < fill, torch.bool), t(b_cols))


def mutate_plain(co, args, on_card=False):
    """K6's plain version on CPU copies of its inputs, or ``on_card`` on
    the card's own (in chunks of MUTATE_PLAIN_CARD_CELLS cells). Returns
    its ``last`` and its ms."""
    import torch

    if not on_card:
        args = tuple(keep_copy(a, "cpu") for a in args)
    chunk = co._PLAIN_CHUNK_CELLS
    co._PLAIN_CHUNK_CELLS = MUTATE_PLAIN_CARD_CELLS if on_card else chunk
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = co.table_mutate_plain(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        co._PLAIN_CHUNK_CELLS = chunk
    return ref, ms


def mutate_apply(args, last):
    """The table after the match, as TableMutateArtifact applies it: the
    rows a delete leaves valid, and an update's id and price columns (each
    from the event's words at ``last``)."""
    import torch

    _mask, a_cols, valid, b_cols = args[:4]
    hit = last >= 0
    at = torch.clamp(last, min=0).long()
    return (valid & ~hit,
            torch.where(hit[None, :], a_cols[:2][:, at], b_cols))


def mutate_check(co, args, what, on_card=False):
    """K6 against its plain version, exactly: ``last`` and the table after
    a delete and after an update. Returns (last, the candidates the kernel
    walked, the plain version's ms)."""
    import torch

    got = co.table_mutate(*args)
    ref, ms = mutate_plain(co, args, on_card)
    same(got.to(ref.device), ref, f"table_mutate {what}: last")
    ref_args = args if on_card else tuple(keep_copy(a, "cpu") for a in args)
    for g, r, part in zip(mutate_apply(args, got),
                          mutate_apply(ref_args, ref), ("valid", "columns")):
        same(g.to(r.device), r, f"table_mutate {what}: {part}")
    visits = torch.zeros(1, dtype=torch.int64, device=args[0].device)
    co.table_mutate(*args, visits=visits)
    return got, int(visits[0]), ms


def check_table_mutate(fpt, co, dev):
    """Phase 3, K6: the kernel exactly equal to its plain version (``last``
    and the table it leaves after a delete and an update) at E = 8,192 and
    C = 1,024: a delete (`T.id == id`), an update with many events a row
    (the last writer wins), a float condition with no int key (the
    interpreter on every candidate), an `on` reading a select output that
    is no table column, an empty table, a full table, E not a multiple of
    the kernel's chunk; with the plain version on the card, C = 16,384 at
    E = 65,536 and the path's shape (E = 524,288, C = 1,024); a program
    deeper than the kernel's local stack (``deep_on_program``) at E =
    4,096, C = 128, with one block a chunk and with a cut grid (a global
    stack of DEEP_CUT_WORDS words); a CUDA graph replay of one call. Then
    K5 on a table direction (``table_join_dir``, the stream-table join,
    outer rows) against its plain version."""
    import torch

    from flink_siddhi_tpu_torch.compiler import slot_program as sp

    t0 = time.perf_counter()
    rng = np.random.default_rng(15)
    E, C = TABLE_CHECK_E, TABLE_C
    key = (sp.OP_CAP, sp.OP_EVT, sp.OP_EQ_I)  # T.id == id
    no_key = (sp.OP_CAP | 1 << 8, sp.OP_EVT | 1 << 8, sp.OP_LT_F)
    out_only = key + (sp.OP_ANDJ | 4 << 8, sp.OP_EVT | 2 << 8,
                      sp.OP_CAP | 1 << 8, sp.OP_GT_F, sp.OP_AND)
    deep, ddepth = deep_on_program(sp)
    cases = [  # what, input kwargs, program, depth, E, C, on the card
        ("delete", {}, key, 2, E, C, False),
        ("update, many events a row", dict(n_ids=16), key, 2, E, C, False),
        ("float condition, no int key", {}, no_key, 2, E, C, False),
        ("on over a select output", dict(n_ids=64), out_only, 2, E, C,
         False),
        ("empty table", dict(fill=0.0), key, 2, E, C, False),
        ("full table", dict(fill=1.0, n_ids=256), key, 2, E, C, False),
        ("E not a multiple of the chunk", dict(n_ids=64), key, 2,
         E + 77, C, False),
        (f"C = {TABLE_BIG_C}", dict(n_ids=10_000), key, 2, 65_536,
         TABLE_BIG_C, True),
        (f"E = {BATCH}, C = {C}", dict(n_ids=10_000, p_mask=0.25), key, 2,
         BATCH, C, True),
        # the global stack: every chunk a block, then a cut grid (each
        # block walking its chunks in turn); E = 4,096 and 128 rows, as
        # the plain version's dense match runs the whole program
        (f"a {len(deep)}-word program, depth {ddepth}", dict(n_ids=16),
         deep, ddepth, 4_096, 128, False),
        (f"a {len(deep)}-word program, a cut grid",
         dict(n_ids=16, stack_words=DEEP_CUT_WORDS), deep, ddepth, 4_096,
         128, False),
    ]
    out = {}
    for what, kw, prog, depth, e, c, on_card in cases:
        words = kw.pop("stack_words", co.STACK_WORDS)
        args = (*mutate_inputs(e, c, rng, dev, **kw), prog, depth)
        words, co.STACK_WORDS = co.STACK_WORDS, words
        try:
            last, visits, ms = mutate_check(co, args, what, on_card)
        finally:
            co.STACK_WORDS = words
        hits = int((last >= 0).sum())
        out[what] = {"E": e, "C": c, "rows_matched": hits,
                     "visits": visits}
        if on_card:
            out[what]["plain_ms_on_card"] = ms
        if what == "empty table" and hits:
            raise AssertionError("table_mutate: a match in an empty table")
        if what != "empty table" and not hits:
            raise AssertionError(f"table_mutate {what}: no row matched")
        if what.startswith("float") and co.join_key_hint(prog) != (-1, -1):
            raise AssertionError("table_mutate: the float case has a key")
        if what.startswith("update"):
            mask, a_cols, valid, b_cols = (x.cpu() for x in args[:4])
            m = mask[:, None] & valid[None, :] & (a_cols[0][:, None]
                                                  == b_cols[0][None, :])
            if int(m.sum(0).max()) < 10:
                raise AssertionError("table_mutate: too few events a row")
        del args
    # a CUDA graph replay of one call, on new inputs copied in
    args = (*mutate_inputs(E, C, rng, dev), key, 2)
    g = torch.cuda.CUDAGraph()
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        co.table_mutate(*args)  # the program on the capturing device
        with torch.cuda.graph(g, stream=st):
            res = co.table_mutate(*args)
    torch.cuda.current_stream().wait_stream(st)
    new = mutate_inputs(E, C, rng, dev)
    for a, b in zip(args, new):
        a.copy_(b)
    g.replay()
    torch.cuda.synchronize()
    same(res, co.table_mutate(*args), "table_mutate graph replay")
    # K5 on a table direction: the stream-table join's pair step
    mask, a_cols, valid, b_cols = mutate_inputs(E, C, rng, dev, n_ids=512)
    d = co.table_join_dir(mask, a_cols, valid, b_cols,
                          (sp.OP_EVT, sp.OP_CAP, sp.OP_EQ_I), 2, True)
    ts = torch.arange(E, dtype=torch.int32, device=dev)
    n, _, _, _ = join_check(co, [d], ts, 4 * E, False, None,
                            "a table direction, outer rows")
    visits, rewalks = join_counts(co, [d], ts, 4 * E, False, None)
    out["join_pairs on a table direction"] = {
        "n": n, "visits": visits, "rewalks": rewalks}
    if not n:
        raise AssertionError("join_pairs on a table direction: no row")
    log(f"  table_mutate: exact against its plain version in {len(cases)} "
        f"cases and a graph replay; join_pairs on a table direction exact "
        f"({json.dumps(out)}; {time.perf_counter() - t0:.1f} s)")
    return 0


# -- phases 4 and 5: the main path end to end ----------------------------------

def bench_stream(fpt, n_events, batch, n_ids=N_IDS):
    """The bench's synthetic stream (bench.py make_batches): rng seed 7,
    id uniform in [0, n_ids), name "test_event", price uniform x 100,
    timestamp 1000 + i ms."""
    schema = fpt.StreamSchema([("id", "int"), ("name", "string"),
                               ("price", "double"), ("timestamp", "long")])
    rng = np.random.default_rng(7)
    code = schema.string_tables["name"].intern("test_event")
    out = []
    for start in range(0, n_events, batch):
        m = min(batch, n_events - start)
        ids = rng.integers(0, n_ids, size=m).astype(np.int32)
        cols = {
            "id": ids,
            "name": np.full(m, code, dtype=np.int32),
            "price": rng.random(m, dtype=np.float64) * 100.0,
            "timestamp": 1000 + start + np.arange(m, dtype=np.int64),
        }
        out.append(fpt.EventBatch("inputStream", schema, cols,
                                  cols["timestamp"]))
    return schema, out


def run_job(fpt, cql, schema, batches, device, stream="inputStream",
            out="matches", config=None):
    plan = fpt.compile_plan(cql, {stream: schema}, plan_id="bench",
                            config=config)
    job = fpt.Job([plan], [fpt.BatchSource(stream, schema, iter(batches))],
                  batch_size=BATCH, time_mode="processing", device=device)
    t0 = time.perf_counter()
    job.run()
    rows = job.results_with_ts(out)
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    return rows, time.perf_counter() - t0, job


def end_to_end(fpt, co, name, cql, schema, batches, kernels_expected):
    import torch

    check = batches[:CHECK_BATCHES]
    n_check = sum(len(b) for b in check)
    cpu_rows, cpu_s, _ = run_job(fpt, cql, schema, check, "cpu")
    # warm-up on the card over the same micro-batches: also a second row
    # check, of a job that ends where the CPU job ends
    warm_rows, _, _ = run_job(fpt, cql, schema, check, "cuda")
    if warm_rows != cpu_rows:
        raise AssertionError(f"{name}: card rows differ from CPU rows")
    n_events = sum(len(b) for b in batches)
    torch.cuda.reset_peak_memory_stats()
    co.reset_launches()
    rows, wall, job = run_job(fpt, cql, schema, batches, "cuda")
    launches = co.launch_counts()
    last_ts = int(check[-1].timestamps[-1])
    head = [r for r in rows if r[0] <= last_ts]
    if head != cpu_rows:
        raise AssertionError(
            f"{name}: rows of the first {n_check} events differ from the "
            "CPU path"
        )
    if not rows or job.processed_events != n_events:
        raise AssertionError(f"{name}: no rows or events lost")
    ts = np.asarray([r[0] for r in rows])
    if not np.all(np.diff(ts) >= 0):
        raise AssertionError(f"{name}: rows out of emission order")
    no_slot_scan(launches, name)
    for k in kernels_expected:
        if launches[k] < N_BATCHES:
            raise AssertionError(
                f"{name}: {k} launched {launches[k]} times over "
                f"{N_BATCHES} micro-batches"
            )
    result = {
        "path": name,
        "events": n_events,
        "batch": BATCH,
        "matches": len(rows),
        "wall_s": wall,
        "events_per_s": n_events / wall,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "host_syncs": job.host_syncs,
        "launches": launches,
        "cpu_check_events": n_check,
        "cpu_check_rows": len(cpu_rows),
        "cpu_check_s": cpu_s,
    }
    log(json.dumps(result))
    breakdown(fpt, name, cql, schema, batches)
    return result


def stage_wire_tapes(plan, batches, epoch, dev):
    """One wire tape a batch on ``dev``, built and uploaded as the Job's
    ``_stage_tape`` and ``WireTape.to`` do (widths sticky across the
    batches)."""
    from flink_siddhi_tpu_torch.runtime.tape import build_wire_tape

    kinds = {}
    return [
        build_wire_tape(plan.spec, [b], epoch, kinds, want_prov=False)[0]
        .to(dev)
        for b in batches
    ]


def breakdown(fpt, name, cql, schema, batches, stream="inputStream",
              out="matches", sync_free=False):
    """Where one path's time goes, measured around the program's own
    calls: the wire tape build + upload of every batch as the Job stages
    it (``build_wire_tape`` with sticky widths, ``WireTape.to``), the
    device steps on those pre-staged wire tapes (each step expands its
    tape on the device first, as the Job's do), and a profiler-traced run
    of the whole job for the device busy share (memcpy and kernels) and
    the heaviest kernels. With ``sync_free`` the steps run under torch's
    sync debug mode "error": any host wait for the device inside a step
    fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    plan = fpt.compile_plan(cql, {stream: schema}, plan_id="bench")
    epoch = int(batches[0].timestamps.min())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tapes = stage_wire_tapes(plan, batches, epoch, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    states, acc = plan.init_state(dev), plan.init_acc(dev)
    t0 = time.perf_counter()
    if sync_free:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for tape in tapes:
            states = plan.grow_state(states)
            states, acc = plan.step_acc(states, acc, tape)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del tapes, states, acc
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced_s, _ = run_job(fpt, cql, schema, batches, "cuda",
                                 stream=stream, out=out)
    busy_us, per_name = device_activity(prof)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    res = {
        "path": name,
        "stage_tapes_s": stage_s,
        "device_steps_s": step_s,
        "traced_wall_s": traced_s,
        "traced_device_busy_s": busy_us / 1e6,
        "traced_idle_share": 1 - busy_us / 1e6 / traced_s,
        "top_device_ms": [[k[:70], v / 1e3] for k, v in top],
        "steps_checked_sync_free": sync_free,
    }
    log(json.dumps(res))
    return res


# -- phase 5b: the bench main path (bench.py's settings and driver) -----------

def bench_config(fpt):
    """bench.py:build_job's engine settings: late materialization and wire
    predicate pushdown."""
    return fpt.EngineConfig(lazy_projection=True, pred_pushdown=True)


def replay_job(fpt, cql, schema, batches, retain):
    plan = fpt.compile_plan(cql, {"inputStream": schema}, plan_id="bench",
                            config=bench_config(fpt))
    return fpt.Job([plan], [fpt.BatchSource("inputStream", schema,
                                            iter(batches))],
                   batch_size=BATCH, time_mode="processing",
                   retain_results=retain, device="cuda")


def rows_match(got, ref, rtol, what, int_close=()):
    """Fails unless the rows ``got`` equal ``ref``: the same timestamps in
    the same order and every value equal, float values within ``rtol``
    (0: exactly), and so the int columns ``int_close`` (an INT/LONG sum is
    a float32 sum cast to int, whose rounding moves with the order of the
    adds). Returns the largest relative difference of a float."""
    if got == ref:
        return 0.0
    if rtol == 0.0:
        raise AssertionError(f"{what}: rows differ")
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} rows, expected {len(ref)}")
    worst = 0.0
    for (tg, rg), (tr, rr) in zip(got, ref):
        if tg != tr or len(rg) != len(rr):
            raise AssertionError(f"{what}: row at {tr} differs: {rg} {rr}")
        for c, (a, b) in enumerate(zip(rg, rr)):
            if a == b:
                continue
            if not (isinstance(b, float) and isinstance(a, float)
                    or c in int_close):
                raise AssertionError(f"{what}: row at {tr}: {rg} vs {rr}")
            rel = abs(a - b) / abs(b)
            if not rel <= rtol:
                raise AssertionError(f"{what}: row at {tr}: {rg} vs {rr}")
            worst = max(worst, rel)
    return worst


def stream_rows(job, outs):
    """Every output stream's rows (with timestamps) of a job."""
    return {o: job.results_with_ts(o) for o in outs}


def resident_waits(d, segments, what):
    """A resident run's drain counts (``drain_accounts`` differences):
    the run loop waits at most once, at the end (one plan), besides its
    forced completions (a ring position freed for the next segment, when
    the run is more segments ahead of the card than the ring holds; they
    are reported, and one whose drain had finished waits for nothing);
    one drain a segment."""
    if d["drain_waits"] > 1 + d["drains_forced"]:
        raise AssertionError(f"{what}: {d['drain_waits']} run-loop waits "
                             f"({d['drains_forced']} forced) over "
                             f"{segments} segments")
    if d["drain_fetches"] < segments:
        raise AssertionError(f"{what}: {d['drain_fetches']} fetches for "
                             f"{segments} segments")


def drain_accounts(job, what):
    """Fails unless the run loop waited for the card only in drains (no
    compaction read: host syncs = drain waits) and the fetch thread's
    waits are the completed drains' fetches (none queued); returns the
    counts."""
    if job.host_syncs != job.drain_waits:
        raise AssertionError(f"{what}: {job.host_syncs} run-loop waits, "
                             f"{job.drain_waits} of them in drains")
    if job.fetch_syncs != job.drain_fetches:
        raise AssertionError(f"{what}: {job.fetch_syncs} fetch-thread "
                             f"waits, {job.drain_fetches} drain fetches")
    return {"host_syncs": job.host_syncs, "drain_waits": job.drain_waits,
            "drains_forced": job.drains_forced,
            "fetch_syncs": job.fetch_syncs,
            "drain_fetches": job.drain_fetches,
            "drains_overlapped": job.drains_overlapped}


def bench_main_path(fpt, co, name, cql, schema, batches, chain, rtol=0.0,
                    expect_rows=None, outs=("matches",), row_batches=None):
    """One path as bench.py runs it: EngineConfig(lazy_projection=True,
    pred_pushdown=True) over the whole stream, through the streaming Job
    one step a micro-batch (rows of the first micro-batches held to the
    CPU path under the same settings; host syncs), through ResidentReplay,
    counts-only as bench.py's resident mode runs it (stage, run() +
    flush(), three rerun()s; each segment one CUDA graph replay), and
    through the fused streaming Job (``fused_segment``). Then one staged
    segment under torch's sync debug mode "error", a profiler-traced rerun
    for the card's idle share, its device records and host ops a segment
    and the kernel calls that ran on the card (``traced_run``), and a
    resident run with a collector over the first ``row_batches``
    micro-batches (None: the whole stream), long enough that a graph
    replays a segment it was not captured on: its rows equal to the
    streaming run's and, on the CPU check's events, to the CPU path's,
    with no lazy miss. With ``chain`` the chain kernels must launch once
    per compacted step, as on the eager path, in the host counts and in
    the trace, and every step must have been compacted on the host-known
    bound (no read). No segment may run eagerly. Floats of the rows are
    held to the CPU path and the eager card path within ``rtol`` (0:
    exactly); with ``expect_rows`` the run must emit that many rows. Every
    stream of ``outs`` is checked; counts are summed over them."""
    import torch

    from flink_siddhi_tpu_torch.compiler import nfa

    cfg = bench_config(fpt)
    check = batches[:CHECK_BATCHES]
    rowed = batches[:row_batches]
    n_events = sum(len(b) for b in batches)
    last_ts = int(check[-1].timestamps[-1])
    rowed_ts = int(rowed[-1].timestamps[-1])
    _, cpu_s, cpu_job = run_job(fpt, cql, schema, check, "cpu",
                                out=outs[0], config=cfg)
    cpu_rows = stream_rows(cpu_job, outs)
    del cpu_job
    run_job(fpt, cql, schema, check, "cuda", out=outs[0],
            config=cfg)  # warm-up

    # the streaming Job over the whole stream, rows kept
    _, wall, job = run_job(fpt, cql, schema, batches, "cuda", out=outs[0],
                           config=cfg)
    rows = stream_rows(job, outs)
    max_rel = 0.0
    for o in outs:
        max_rel = max(max_rel, rows_match(
            [r for r in rows[o] if r[0] <= last_ts], cpu_rows[o], rtol,
            f"{name}: streaming rows of {o} of the first "
            f"{sum(len(b) for b in check)} events against the CPU path",
        ))
    n_rows = sum(len(r) for r in rows.values())
    # the eager card path's rows over the row check's micro-batches
    eager_rows = {o: [r for r in rows[o] if r[0] <= rowed_ts]
                  for o in outs}
    rt = job._plans["bench"]
    if rt.lazy is not None and rt.lazy.missed:
        raise AssertionError(f"{name}: {rt.lazy.missed} lazy misses")
    streaming = {"rows": n_rows, "wall_s": wall,
                 "events_per_s": n_events / wall,
                 **drain_accounts(job, f"{name}: streaming")}
    del rows, job, rt

    # ResidentReplay, counts-only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    job = replay_job(fpt, cql, schema, batches, retain=False)
    rep = fpt.ResidentReplay(job)
    rep.stage()
    (pid, segs), = rep.segments.items()
    n_tapes = sum(len(seg) for seg in segs)
    # the bytes the staged segments hold on the card: every tape's leaves,
    # each 16-byte aligned
    wire_bytes = sum(seg.nbytes for seg in segs)
    ts_kinds = sorted({seg.template.ts_kind for seg in segs})
    seg_lens = [len(seg) for seg in segs]
    art = job._plans[pid].plan.artifacts[0]
    n_ring = len(job._plans[pid].ring)
    captured = job.graphs_captured
    reserved_stage = torch.cuda.max_memory_reserved()
    co.reset_launches()
    syncs0 = getattr(art, "host_syncs", 0)
    host_syncs0 = job.host_syncs
    acct0 = drain_accounts(job, f"{name}: resident stage")
    t0 = time.perf_counter()
    rep.run()
    job.flush()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = co.launch_counts()
    no_slot_scan(launches, f"{name}: resident run")
    run_syncs = job.host_syncs - host_syncs0
    acct = drain_accounts(job, f"{name}: resident run")
    first_drains = {k: acct[k] - acct0[k] for k in acct}
    resident_waits(first_drains, len(segs), f"{name}: resident run")
    count = sum(job.emitted_counts.values())
    if count != streaming["rows"] or count != (expect_rows or count):
        raise AssertionError(f"{name}: resident run emitted {count} rows, "
                             f"the streaming run {streaming['rows']}")
    if job.eager_segments or job.graphs_captured != captured or not captured:
        raise AssertionError(
            f"{name}: {job.eager_segments} eager segments, "
            f"{job.graphs_captured} graphs ({captured} at stage)"
        )
    if chain:
        compacted = sum(
            nfa.step_branch(art, seg.template.capacity, b.get(art.name))
            == "compact" for seg in segs for b in seg.bounds
        )
        if compacted != n_tapes or art.host_syncs != syncs0:
            raise AssertionError(f"{name}: {compacted} of {n_tapes} "
                                 "steps compacted without a read")
        for k in ("multi_reverse_cummin", "chain_advance"):
            if launches[k] != compacted:
                raise AssertionError(
                    f"{name}: {k} launched {launches[k]} times for "
                    f"{compacted} compacted steps"
                )
    reruns = []
    for _ in range(3):
        before = sum(job.emitted_counts.values())
        acct0 = drain_accounts(job, f"{name}: resident rerun")
        reruns.append(rep.rerun())
        if sum(job.emitted_counts.values()) - before != count:
            raise AssertionError(f"{name}: a rerun emitted another count")
        acct = drain_accounts(job, f"{name}: resident rerun")
        resident_waits({k: acct[k] - acct0[k] for k in acct}, len(segs),
                       f"{name}: resident rerun")
    if job.graphs_captured != captured:
        raise AssertionError(f"{name}: a rerun captured a graph")
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()

    # one staged segment with no host wait
    job.reset_engine_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rep.run_segment(pid, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # a profiler-traced rerun: the card's idle share, device records and
    # host ops a segment, and the kernel calls that ran on the card
    prof, traced_s, traced_launch = traced_run(
        co, rep.rerun, f"{name}: traced resident rerun")
    traced = traced_share(prof, traced_s, len(segs), n_tapes)
    del prof
    no_slot_scan(traced_launch, f"{name}: traced resident rerun")
    if chain:
        for k in ("multi_reverse_cummin", "chain_advance"):
            if traced_launch[k] != compacted:
                raise AssertionError(
                    f"{name}: {k} ran {traced_launch[k]} times on the card "
                    f"in a rerun of {compacted} compacted steps"
                )
    stage_s = rep.stage_seconds
    del rep, job, segs

    # resident rows with a collector, over the row check's micro-batches
    rjob = replay_job(fpt, cql, schema, rowed, retain=True)
    rrep = fpt.ResidentReplay(rjob)
    rrep.execute()
    res_segments = sum(len(v) for v in rrep.segments.values())
    if rjob.eager_segments or not res_segments > rjob.graph_keys:
        raise AssertionError(
            f"{name}: the resident row check ran {rjob.eager_segments} "
            f"eager segments, {res_segments} segments on "
            f"{rjob.graph_keys} graph keys (none replayed on another "
            "segment)"
        )
    drain_accounts(rjob, f"{name}: resident rows")
    res_rows = stream_rows(rjob, outs)
    for o in outs:
        rows_match(res_rows[o], eager_rows[o], rtol,
                   f"{name}: resident rows of {o} of "
                   f"{len(rowed)} micro-batches vs the eager card path")
        max_rel = max(max_rel, rows_match(
            [r for r in res_rows[o] if r[0] <= last_ts], cpu_rows[o],
            rtol, f"{name}: resident rows of {o} vs the CPU path"))
    lazy = rjob._plans["bench"].lazy
    if lazy is not None and lazy.missed:
        raise AssertionError(f"{name}: resident rows missed lazy values")
    res_check_rows = sum(len(r) for r in res_rows.values())
    del rjob, rrep, res_rows
    fused, rel = fused_segment(
        fpt, co, name, cql, schema, batches, outs=outs, config=cfg,
        cpu_rows=cpu_rows, cpu_ts=last_ts, eager_rows=eager_rows,
        rtol=rtol, row_batches=row_batches,
        expect_launches=("multi_reverse_cummin", "chain_advance")
        if chain else (),
    )
    del eager_rows
    max_rel = max(max_rel, rel)
    result = {
        "path": f"bench_{name}",
        "config": "EngineConfig(lazy_projection=True, pred_pushdown=True)",
        "events": n_events,
        "batch": BATCH,
        "streaming": streaming,
        "resident": {
            "stage_s": stage_s,
            "first_run_s": first_s,
            "rerun_s": reruns,
            "events_per_s_median": n_events / statistics.median(reruns),
            "events_per_s_best": n_events / min(reruns),
            "rows": count,
            "segments": seg_lens,
            "launches": launches,
            "launches_traced": traced_launch,
            "graphs_captured": captured,
            "ring_positions": n_ring,
            "eager_segments": 0,
            "host_syncs_first_run": run_syncs,
            "drains_first_run": first_drains,
            "max_memory_reserved_after_stage_bytes": reserved_stage,
            "max_memory_allocated_bytes": peak,
            "max_memory_reserved_bytes": peak_reserved,
            **traced,
            "segment_sync_free": True,
            "steps": n_tapes,
        },
        "fused_streaming": fused,
        "wire_bytes_per_event": wire_bytes / n_events,
        "wire_bytes": wire_bytes,
        "ts_kinds": ts_kinds,
        "cpu_check_events": sum(len(b) for b in check),
        "cpu_check_rows": sum(len(r) for r in cpu_rows.values()),
        "cpu_check_s": cpu_s,
        "row_check_batches": len(rowed),
        "resident_check_rows": res_check_rows,
        "max_rel_err_vs_cpu": max_rel,
    }
    log(json.dumps(result))
    return result


def traced_share(prof, wall_s, segments, steps):
    """From a profiler trace of one run: the card's busy seconds and idle
    share, its kernel and copy records, and the host's top-level torch ops,
    per segment and per step, and the heaviest device names."""
    busy_us, per_name = device_activity(prof)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    records = device_records(prof)
    host_ops = sum(1 for e in prof.events()
                   if e.cpu_parent is None and e.name.startswith("aten::"))
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "traced_run_s": wall_s,
        "traced_device_busy_s": busy_us / 1e6,
        "traced_idle_share": 1 - busy_us / 1e6 / wall_s,
        "traced_device_records_per_segment": records / segments,
        "traced_device_records_per_step": records / steps,
        "traced_host_ops_per_segment": host_ops / segments,
        "top_device_ms": [[k[:70], v / 1e3] for k, v in top],
    }


FUSED_K = 8  # bench.py's BENCH_SEGMENT default
FUSED_RUNS = 3


def fused_job(fpt, cql, schema, batches, retain, config=None,
              stream="inputStream"):
    """A streaming Job with bench.py's fused dispatch: segments of
    FUSED_K tapes (at most ``Job.max_inflight_cycles``, bench.py's
    BENCH_INFLIGHT, unfinished on the card)."""
    plan = fpt.compile_plan(cql, {stream: schema}, plan_id="bench",
                            config=config)
    job = fpt.Job([plan], [fpt.BatchSource(stream, schema, iter(batches))],
                  batch_size=BATCH, time_mode="processing",
                  retain_results=retain, device="cuda")
    job.fused_segment_len = FUSED_K
    return job


def re_source(fpt, job, schema, batches, stream="inputStream"):
    """Point ``job`` at a fresh source over the same batches (bench.py's
    re_source): with ``Job.reset_engine_state`` a rerun of the stream."""
    from flink_siddhi_tpu_torch.runtime.executor import MIN_WM

    job._sources = [fpt.BatchSource(stream, schema, iter(batches))]
    job._source_wm = [MIN_WM]
    job._source_done = [False]


def fused_segment(fpt, co, name, cql, schema, batches, outs, config,
                  cpu_rows, cpu_ts, eager_rows, rtol, stream="inputStream",
                  expect_launches=(), row_batches=None):
    """The fused streaming Job (FUSED_K tapes a segment, one graph replay
    a segment): its rows over the first ``row_batches`` micro-batches
    (None: the whole stream; long enough that a graph replays a segment
    it was not captured on) held to the eager card path's
    (``eager_rows``, over the same micro-batches) and, up to ``cpu_ts``,
    to the CPU path's; then counts-only over the whole stream, as
    bench.py's streaming mode runs it (``streaming_counts``). Returns
    (result, largest relative float difference to the CPU rows)."""
    rowed = batches[:row_batches]
    job = fused_job(fpt, cql, schema, rowed, True, config, stream)
    job.run()
    if (job.eager_segments or not job.graphs_captured
            or not job.fusion_dispatches > job.graph_keys):
        raise AssertionError(
            f"{name}: the fused row check ran {job.eager_segments} eager "
            f"segments, {job.fusion_dispatches} segments on "
            f"{job.graph_keys} graph keys (none replayed on another "
            "segment)"
        )
    drain_accounts(job, f"{name}: fused rows")
    rows = stream_rows(job, outs)
    del job
    rel = 0.0
    for o in outs:
        rows_match(rows[o], eager_rows[o], rtol,
                   f"{name}: fused rows of {o} of {len(rowed)} "
                   "micro-batches vs the eager card path")
        rel = max(rel, rows_match([r for r in rows[o] if r[0] <= cpu_ts],
                                  cpu_rows[o], rtol,
                                  f"{name}: fused rows of {o} vs the CPU"))
    check_rows = sum(len(r) for r in rows.values())
    del rows
    result = streaming_counts(fpt, co, name, cql, schema, batches, config,
                              stream, expect_launches)
    result["row_check_batches"] = len(rowed)
    result["check_rows"] = check_rows
    log(json.dumps({"path": f"fused_{name}", **result}))
    return result, rel


def streaming_counts(fpt, co, name, cql, schema, batches, config, stream,
                     expect_launches=()):
    """The fused streaming Job counts-only over the whole stream, as
    bench.py's streaming mode runs it: one warm run (the graphs are
    captured there), FUSED_RUNS timed runs of the same job (reset and
    re-sourced: events/s median and best, launches and host syncs of the
    last), and a profiler-traced run (``traced_run``: the kernel calls
    that ran on the card equal to the host's counts). No segment may run
    eagerly, no timed or traced run may capture a graph, and the host
    syncs are the drains'. Each kernel named in ``expect_launches``
    launches once a step (padding tapes included), in the host counts and
    in the trace."""
    import torch

    n_events = sum(len(b) for b in batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    job = fused_job(fpt, cql, schema, batches, False, config, stream)
    t0 = time.perf_counter()
    job.run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captured = job.graphs_captured
    counts = sum(job.emitted_counts.values())

    def rerun():
        job.reset_engine_state()
        re_source(fpt, job, schema, batches, stream)

    def run():
        before = sum(job.emitted_counts.values())
        t0 = time.perf_counter()
        job.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sum(job.emitted_counts.values()) - before != counts:
            raise AssertionError(f"{name}: a streaming run emitted another "
                                 "count")
        return wall

    runs = []
    for _ in range(FUSED_RUNS):
        rerun()
        co.reset_launches()
        acct0 = drain_accounts(job, f"{name}: fused run")
        disp0, up0 = job.fusion_dispatches, job.fusion_h2d_uploads
        runs.append(run())
    launches = co.launch_counts()
    no_slot_scan(launches, f"{name}: fused runs")
    dispatches = job.fusion_dispatches - disp0
    k = job._fused_k(job._plans["bench"])
    steps = dispatches * k  # every segment padded to k tapes
    acct = drain_accounts(job, f"{name}: fused run")
    result = {
        "segment_len": k,
        "max_inflight_cycles": job.max_inflight_cycles,
        "warm_run_s": warm_s,
        "run_s": runs,
        "events_per_s_median": n_events / statistics.median(runs),
        "events_per_s_best": n_events / min(runs),
        "rows": counts,
        "steps": steps,
        "dispatches": dispatches,
        "h2d_uploads": job.fusion_h2d_uploads - up0,
        "graphs_captured": captured,
        "eager_segments": job.eager_segments,
        "host_syncs": acct["host_syncs"] - acct0["host_syncs"],
        "drains": {k: acct[k] - acct0[k] for k in acct},
        "backpressure_waits": job.backpressure_waits,
        "launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
    }
    prof, traced_s, traced_launch = traced_run(
        co, run, f"{name}: traced fused run", prepare=rerun)
    result["launches_traced"] = traced_launch
    result.update(traced_share(prof, traced_s, dispatches, steps))
    del prof
    if job.eager_segments or job.graphs_captured != captured:
        raise AssertionError(
            f"{name}: {job.eager_segments} eager segments; "
            f"{job.graphs_captured - captured} graphs captured after the "
            "warm run"
        )
    for kname in expect_launches:
        if launches[kname] != steps or traced_launch[kname] != steps:
            raise AssertionError(
                f"{name}: fused {kname} launched {launches[kname]} times "
                f"(on the card {traced_launch[kname]}) in {steps} steps")
    return result


# -- phase 5c: the drain pipeline (sink mode, paced latency) ----------------

SINK_CUT = 4 * BATCH  # window_groupby in sink mode
SINK_CUT_MQ = 2 * BATCH  # multiquery64 in sink mode (the row path)
LAT_BATCH = 131_072  # bench.py:_latency_phase's micro-batch
LAT_SECONDS = 3.0
LAT_SHARE = 0.25  # offered rate: this share of the fused headline's


class RowCount:
    """A row sink (``fn(abs_ts, row)``) that counts rows and keeps an
    exact checksum that does not depend on how rows are batched: the
    wrapping sum of the float64 bit patterns of the timestamps and of
    every numeric field (``fields``: (index, name) pairs)."""

    def __init__(self, fields):
        self.fields = fields
        self.reset()

    def reset(self):
        self.rows = self.batches = 0
        self.checksum = 0
        self._ts, self._vals = [], []

    @staticmethod
    def bits(col):
        return int(np.asarray(col, dtype=np.float64).view(np.int64)
                   .sum(dtype=np.int64))

    def _add(self, ts, cols):
        self.checksum = (self.checksum + self.bits(ts)
                         + sum(self.bits(c) for c in cols)) % 2**64

    def __call__(self, ts, row):
        self.rows += 1
        self._ts.append(ts)
        self._vals.append(row)
        if len(self._ts) >= 1 << 16:
            self.fold()

    def fold(self):
        if self._ts:
            self._add(self._ts, [[r[i] for r in self._vals]
                                 for i, _ in self.fields])
            self._ts, self._vals = [], []
        return self.rows, self.checksum


class ColumnarCount(RowCount):
    """bench.py's _CountingColumnarSink (``accept_columns``), with the
    checksum of ``RowCount``; a checkout without the columnar lane calls
    it as a row sink."""

    def accept_columns(self, ts, cols):
        self.rows += len(ts)
        self.batches += 1
        self._add(ts, [cols[n] for _, n in self.fields])


def sink_job(fpt, cql, schema, batches, sink_cls):
    """bench.py:_mode_sink's job: build_job's settings (bench settings,
    counts-only, in-flight 6, p99 target 400 ms, drain interval 250 ms,
    prewarm_drains()), fused dispatch of FUSED_K tapes, and one sink on
    every output stream."""
    job = fused_job(fpt, cql, schema, batches, False, bench_config(fpt))
    job.max_inflight_cycles = 6
    job.target_p99_ms = 400.0
    job.drain_interval_ms = 250.0
    sinks = []
    for rt in job._plans.values():
        for sid, schemas in rt.plan.output_streams().items():
            fields = [(i, f.name) for i, f in enumerate(schemas[0].fields)
                      if f.atype.name != "STRING"]
            sinks.append(sink_cls(fields))
            job.add_sink(sid, sinks[-1])
    if hasattr(job, "prewarm_drains"):
        job.prewarm_drains()
    return job, sinks


def sink_mode(fpt, cql, schema, batches, sink_cls, runs=1):
    """A warm run over two micro-batches (the captures), then ``runs``
    timed runs over ``batches``; returns (job, sinks, wall seconds)."""
    import torch

    job, sinks = sink_job(fpt, cql, schema, batches[:2], sink_cls)
    job.run()
    walls = []
    for _ in range(runs):
        for s in sinks:
            s.reset()
        job.reset_engine_state()
        re_source(fpt, job, schema, batches)
        if hasattr(job, "telemetry"):
            job.telemetry = type(job.telemetry)()
        t0 = time.perf_counter()
        job.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return job, sinks, walls


def sink_totals(sinks):
    rows = checksum = 0
    for s in sinks:
        r, c = s.fold()
        rows += r
        checksum = (checksum + c) % 2**64
    return rows, checksum


def columnar_lane(job):
    """bench.py:_mode_sink's flag, read back from the engine: every
    output stream on the columnar lane and every artifact with a columnar
    decode."""
    return all(
        sid in job._columnar_streams(rt)
        for rt in job._plans.values() for sid in rt.plan.output_streams()
    ) and all(
        not hasattr(a, "decode_packed") or hasattr(a, "decode_packed_columns")
        for rt in job._plans.values() for a in rt.plan.artifacts
    )


def hist_ms(job, name):
    h = job.telemetry.histogram(name)
    return {"count": h.count, "p50_ms": h.percentile_ms(50),
            "p99_ms": h.percentile_ms(99)}


def sink_phase(fpt, name, cql, schema, batches, want_columnar):
    """One config in sink mode, as bench.py:_mode_sink runs it (the
    columnar sink), and again with a row sink on every stream: the rows
    and the checksum must be equal; the columnar flag is read back."""
    job, sinks, (wall,) = sink_mode(fpt, cql, schema, batches,
                                    ColumnarCount)
    rows, checksum = sink_totals(sinks)
    columnar = columnar_lane(job)
    accounts = drain_accounts(job, f"{name}: sink mode")
    total, stale = hist_ms(job, "drain.total"), hist_ms(job,
                                                        "drain.staleness")
    del job, sinks
    rjob, rsinks, (rwall,) = sink_mode(fpt, cql, schema, batches, RowCount)
    rrows, rchecksum = sink_totals(rsinks)
    del rjob, rsinks
    n_events = sum(len(b) for b in batches)
    if not rows or (rows, checksum) != (rrows, rchecksum):
        raise AssertionError(
            f"{name}: sink mode delivered {rows} rows (checksum {checksum})"
            f", a row sink {rrows} ({rchecksum})")
    if columnar != want_columnar:
        raise AssertionError(f"{name}: columnar lane {columnar}, expected "
                             f"{want_columnar}")
    res = {"path": f"sink_{name}", "events": n_events,
           "cut": None if len(batches) == N_BATCHES else
           f"{n_events} of {N_BATCHES * BATCH} events",
           "events_per_s": n_events / wall, "wall_s": wall,
           "rows": rows, "checksum": checksum, "columnar": columnar,
           "row_sink_events_per_s": n_events / rwall,
           "row_sink_wall_s": rwall,
           "drain_total": total, "drain_staleness": stale, **accounts}
    log(json.dumps(res))
    return res


class PacedSource:
    """bench.py's _PacedSource: the i-th micro-batch of ``base`` (cycled,
    its timestamps moved past the previous cycle's) is due at t0 + i *
    ``period`` from the first poll; a poll releases every due batch, as
    one."""

    def __init__(self, fpt, base, n, period):
        self.fpt, self.base, self.n, self.period = fpt, base, n, period
        self.stream_id, self.schema = base[0].stream_id, base[0].schema
        self.span = int(base[-1].timestamps[-1]) - int(
            base[0].timestamps[0]) + 1
        self.i, self.t0 = 0, None

    def _batch(self, i):
        b = self.base[i % len(self.base)]
        shift = (i // len(self.base)) * self.span
        if not shift:
            return b
        ts = b.timestamps + shift
        return self.fpt.EventBatch(self.stream_id, self.schema,
                                   {**b.columns, "timestamp": ts}, ts)

    def poll(self, max_events):
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        out = []
        while self.i < self.n and self.t0 + self.i * self.period <= now:
            out.append(self._batch(self.i))
            self.i += 1
        done = self.i >= self.n
        if not out:
            return None, None, done
        b = out[0] if len(out) == 1 else self.fpt.EventBatch.concat(out)
        return b, int(b.timestamps.max()), done


def paced_latency(fpt, schema, batches, fused_events_per_s):
    """The headline as bench.py:_latency_phase sets it: micro-batches of
    LAT_BATCH, drain interval 60 ms, build_job's settings and a columnar
    sink, warmed off the clock on the 1x, 2x and 4x tape shapes, then an
    offered rate of LAT_SHARE of the fused headline's events/s, paced by
    sleeping between run_cycle calls, for about LAT_SECONDS: drain.total
    and drain.staleness from Job.telemetry."""
    import torch

    base = [b.slice(s, s + LAT_BATCH) for b in batches
            for s in range(0, len(b), LAT_BATCH)]
    rate = LAT_SHARE * fused_events_per_s
    period = LAT_BATCH / rate
    n = max(int(LAT_SECONDS / period), 16)
    warm = [base[0], base[1], fpt.EventBatch.concat(base[2:4]),
            fpt.EventBatch.concat(base[4:8])]
    plan = fpt.compile_plan(HEADLINE, {"inputStream": schema},
                            plan_id="bench", config=bench_config(fpt))
    job = fpt.Job([plan], [fpt.BatchSource("inputStream", schema,
                                           iter(warm))],
                  batch_size=LAT_BATCH, time_mode="processing",
                  retain_results=False, device="cuda")
    job.max_inflight_cycles = 6
    job.target_p99_ms = 400.0
    job.drain_interval_ms = 60.0
    job.prewarm_drains()
    fields = [(i, f.name) for i, f in enumerate(
        plan.output_streams()["matches"][0].fields)]
    sink = ColumnarCount(fields)
    job.add_sink("matches", sink)
    while not job.finished:
        job.run_cycle()
    job.drain_outputs(wait=True)
    job.telemetry = type(job.telemetry)()
    sink.reset()
    from flink_siddhi_tpu_torch.runtime.executor import MIN_WM

    job._sources = [PacedSource(fpt, base[8:], n, period)]
    job._source_wm, job._source_done = [MIN_WM], [False]
    waits0, forced0 = job.drain_waits, job.drains_forced
    ev0 = job.processed_events
    t0 = time.perf_counter()
    while not job.finished:
        before = job.processed_events
        job.run_cycle()
        if job.processed_events == before:
            time.sleep(0.0005)
    job.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = job.processed_events - ev0
    res = {"path": "paced_latency_headline", "batch": LAT_BATCH,
           "drain_interval_ms": job.drain_interval_ms,
           "offered_events_per_s": rate,
           "offered_share_of_fused": LAT_SHARE,
           "events": events, "wall_s": wall,
           "achieved_events_per_s": events / wall, "rows": sink.rows,
           "drain_total": hist_ms(job, "drain.total"),
           "drain_staleness": hist_ms(job, "drain.staleness"),
           "drains_completed": job.telemetry.counter_value(
               "drains.completed"),
           "drain_waits": job.drain_waits - waits0,
           "drains_forced": job.drains_forced - forced0,
           "max_inflight_cycles": job.max_inflight_cycles}
    if not sink.rows or not res["drain_staleness"]["count"]:
        raise AssertionError("paced latency: no rows or no drain recorded")
    log(json.dumps(res))
    return res


# -- phase 7: windows and aggregation -----------------------------------------

def int_stream(fpt, n_events, batch):
    """A stream whose INT sums pass int32's range: IntStream (id int, vol
    int, timestamp long), rng seed 13, id uniform in [0, 8), vol drawn
    from values near +-2^31, timestamp 1000 + i ms."""
    schema = fpt.StreamSchema([("id", "int"), ("vol", "int"),
                               ("timestamp", "long")])
    rng = np.random.default_rng(13)
    near = np.array([2 ** 31 - 1, 2 ** 31 - 5, -2 ** 31, -2 ** 31 + 7, 3,
                     -11], np.int64)
    out = []
    for start in range(0, n_events, batch):
        m = min(batch, n_events - start)
        cols = {
            "id": rng.integers(0, 8, m).astype(np.int32),
            "vol": rng.choice(near, m).astype(np.int32),
            "timestamp": 1000 + start + np.arange(m, dtype=np.int64),
        }
        out.append(fpt.EventBatch("IntStream", schema, cols,
                                  cols["timestamp"]))
    return schema, out


# (name, cql, matrix path?, float tolerance against the CPU): every other
# window class, over the bench stream (ids in [0, 50)) or IntStream
WINDOW_CLASSES = [
    ("length_minmax",
     "from inputStream[id < 5]#window.length(1000) select id, "
     "min(price) as lo, max(price) as hi, count() as c group by id "
     "insert into out", False, 0.0),
    ("time_groupby_avg",
     "from inputStream[id < 5]#window.time(400 milliseconds) select id, "
     "avg(price) as a, count() as c group by id insert into out", False,
     WINDOW_RTOL),
    ("time_min_matrix",
     "from inputStream[id < 5]#window.time(400 milliseconds) select "
     "min(price) as lo, max(price) as hi, count() as c insert into out",
     True, 0.0),
    ("external_time",
     "from inputStream[id < 5]#window.externalTime(timestamp, "
     "300 milliseconds) select id, sum(price) as s group by id "
     "insert into out", True, WINDOW_RTOL),
    ("time_length",
     "from inputStream[id < 5]#window.timeLength(300 milliseconds, 20) "
     "select sum(price) as s, count() as c insert into out", True,
     WINDOW_RTOL),
    ("cumulative_groupby",
     "from inputStream[id < 5] select id, sum(price) as s, avg(price) as a, "
     "min(price) as lo, max(price) as hi group by id insert into out",
     False, WINDOW_RTOL),
    ("length_batch",
     "from inputStream#window.lengthBatch(5000) select id, "
     "sum(price) as s, count() as c group by id insert into out", False,
     WINDOW_RTOL),
    ("time_batch_groupby",
     "from inputStream#window.timeBatch(10 sec) select id, sum(price) as s, "
     "max(price) as hi group by id insert into out", False, WINDOW_RTOL),
    ("external_time_batch",
     "from inputStream#window.externalTimeBatch(timestamp, 10 sec) select "
     "count() as c, avg(price) as a insert into out", False, WINDOW_RTOL),
    ("cron",
     "from inputStream#window.cron('*/10 * * * * ?') select id, "
     "count() as c, sum(price) as s group by id insert into out", False,
     WINDOW_RTOL),
    ("expired_length",
     "from inputStream[id == 3]#window.length(100) select id, price "
     "insert expired events into out", False, 0.0),
    ("expired_time",
     "from inputStream[id == 4]#window.time(400 milliseconds) select id, "
     "price insert expired events into out", False, 0.0),
    ("delay",
     "from inputStream[id == 5]#window.delay(250 milliseconds) select id, "
     "price insert into out", False, 0.0),
    ("int_sum_wrap",
     "from IntStream[id < 2]#window.length(64) select id, sum(vol) as v, "
     "count() as c group by id insert into out", False, 0.0),
]


def window_class(fpt, name, cql, schema, batches, stream, rtol):
    """One window class through the streaming Job on the card, its rows
    held to the CPU path's (floats within ``rtol``, 0: exactly; host syncs
    only the drains'), then the staged wire tapes of its first two
    micro-batches stepped under torch's sync debug mode "error"."""
    import torch

    cpu_rows, cpu_s, _ = run_job(fpt, cql, schema, batches, "cpu",
                                 stream=stream, out="out")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, wall, job = run_job(fpt, cql, schema, batches, "cuda",
                              stream=stream, out="out")
    peak = torch.cuda.max_memory_allocated()
    max_rel = rows_match(rows, cpu_rows, rtol, f"window class {name}")
    if not rows:
        raise AssertionError(f"window class {name}: no rows")
    drain_accounts(job, f"window class {name}")
    dev = torch.device("cuda")
    plan = fpt.compile_plan(cql, {stream: schema}, plan_id="bench")
    tapes = stage_wire_tapes(plan, batches[:2],
                             int(batches[0].timestamps.min()), dev)
    states, acc = plan.init_state(dev), plan.init_acc(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for tape in tapes:
            states = plan.grow_state(states)
            states, acc = plan.step_acc(states, acc, tape)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    art = plan.artifacts[0]
    n_events = sum(len(b) for b in batches)
    res = {
        "class": name,
        "artifact": type(art).__name__,
        "sort_path": bool(getattr(art, "_blocked", lambda: False)()),
        "batch": len(batches[0]),
        "events": n_events,
        "rows": len(rows),
        "cpu_s": cpu_s,
        "card_wall_s": wall,
        "card_events_per_s": n_events / wall,
        "max_memory_allocated_bytes": peak,
        "max_rel_err_vs_cpu": max_rel,
        "host_syncs": job.host_syncs,
        "segment_steps_sync_free": True,
    }
    log(json.dumps(res))
    return res


def window_phase(fpt, co):
    """The bench's window_groupby as bench.py runs it (phase 5b's runner,
    1,000 ids), then every other window class through the streaming Job
    at batch 524,288 (65,536 on the matrix path) over
    WINDOW_CLASS_BATCHES micro-batches."""
    wschema, wbatches = bench_stream(fpt, BATCH * WINDOW_GROUPBY_BATCHES,
                                     BATCH, n_ids=N_IDS_WINDOW)
    plan = fpt.compile_plan(WINDOW_GROUPBY, {"inputStream": wschema},
                            config=bench_config(fpt))
    if plan.spec.device_columns != ("inputStream.price",):
        raise AssertionError("window_groupby ships "
                             f"{plan.spec.device_columns}")
    bench = bench_main_path(fpt, co, "window_groupby", WINDOW_GROUPBY,
                            wschema, wbatches, chain=False,
                            rtol=WINDOW_RTOL,
                            expect_rows=BATCH * WINDOW_GROUPBY_BATCHES)
    os.makedirs(SMOKE_DIR, exist_ok=True)
    with open(os.path.join(SMOKE_DIR, "window_groupby.json"), "w") as f:
        json.dump(bench, f)
    del wschema, wbatches
    schema, batches = bench_stream(fpt, BATCH * WINDOW_CLASS_BATCHES, BATCH)
    mschema, mbatches = bench_stream(fpt, MATRIX_BATCH * WINDOW_CLASS_BATCHES,
                                     MATRIX_BATCH)
    ischema, ibatches = int_stream(fpt, BATCH * WINDOW_CLASS_BATCHES, BATCH)
    classes = []
    for name, cql, matrix, rtol in WINDOW_CLASSES:
        if name == "int_sum_wrap":
            args = (ischema, ibatches, "IntStream")
        elif matrix:
            args = (mschema, mbatches, "inputStream")
        else:
            args = (schema, batches, "inputStream")
        classes.append(window_class(fpt, name, cql, *args, rtol))
    return {"bench": bench, "classes": classes}


# -- phase 8: multiquery64, a stack of 64 chain queries -----------------------

def full_branch_step(fpt, co, nfa, schema, batches):
    """One multiquery64 step over a capped 131,072-event tape on the
    stack's full-width branch (relevance compaction off): the branch's
    peak device memory, its kernels' inputs (recorded), and its rows
    equal to the compacted branch's on the same tape."""
    import torch

    plan = fpt.compile_plan(MULTIQUERY64, {"inputStream": schema},
                            config=bench_config(fpt))
    (art,) = plan.artifacts
    cap = plan.tape_capacity_limit
    epoch = int(batches[0].timestamps.min())
    tape, = stage_wire_tapes(plan, [batches[1].slice(0, cap)], epoch,
                             torch.device("cuda"))

    def step():
        states, acc = plan.init_state("cuda"), plan.init_acc("cuda")
        # a pool carried from the batch before this tape
        prev, = stage_wire_tapes(plan, [batches[0].slice(BATCH - cap,
                                                         BATCH)],
                                 epoch, torch.device("cuda"))
        states, _ = plan.step_acc(states, plan.init_acc("cuda"), prev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        states, acc = plan.step_acc(states, acc, tape)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        meta = acc["meta"].cpu().numpy()
        n = int(meta[0].max())
        rows = plan.drain_decode(meta[0], acc["buf"][:, :n].cpu().numpy())
        return peak, meta, rows

    _, meta_c, rows_c = step()
    rec_k1 = Recorder(co.multi_reverse_cummin, keep=2)
    rec_k2 = Recorder(co.chain_advance, keep=2)
    saved = nfa._COMPACT_MIN_E
    nfa.multi_reverse_cummin, nfa.chain_advance = rec_k1, rec_k2
    nfa._COMPACT_MIN_E = cap + 1
    try:
        peak, meta_f, rows_f = step()
    finally:
        nfa._COMPACT_MIN_E = saved
        nfa.multi_reverse_cummin = co.multi_reverse_cummin
        nfa.chain_advance = co.chain_advance
    if int(rec_k2.args[4].shape[1]) != art.pool + cap:
        raise AssertionError("the full-width stack step ran compacted")
    key = lambda rows: [(sch.stream_id, r) for sch, r in rows[art.name]]
    if (meta_c != meta_f).any() or key(rows_c) != key(rows_f):
        raise AssertionError("multiquery64: the full-width branch's rows "
                             "differ from the compacted branch's")
    res = {"tape_events": cap, "peak_bytes": peak,
           "rows": int(meta_f[0].sum())}
    log(json.dumps({"path": "multiquery64_full_branch", **res}))
    return res, rec_k1, rec_k2


def multiquery_phase(fpt, co, out_path):
    """The bench's multiquery64 as bench.py runs it (phase 5b's runner):
    64 two-step chains, one stacked artifact, 131,072-event steps. Then
    one step on the stack's full-width branch. The chain kernels' stacked
    inputs (a compacted step of the warm-up run, and the full-width step)
    are saved for the kernel timing with the phase's result."""
    import torch
    from flink_siddhi_tpu_torch.compiler import nfa

    schema, batches = bench_stream(fpt, BATCH * MQ_BATCHES, BATCH)
    plan = fpt.compile_plan(MULTIQUERY64, {"inputStream": schema},
                            config=bench_config(fpt))
    (art,) = plan.artifacts
    if (type(art).__name__ != "StackedChainArtifact"
            or len(art.members) != 64
            or plan.tape_capacity_limit != MQ_STEP_EVENTS):
        raise AssertionError(f"multiquery64 compiled to {plan.artifacts} "
                             f"capped at {plan.tape_capacity_limit}")
    # the CPU check steps 8 tapes of 131,072 events: keep a compacted
    # step of the warm-up run on the card (its 4th)
    cpu_steps = CHECK_BATCHES * BATCH // MQ_STEP_EVENTS
    rec_k1 = Recorder(co.multi_reverse_cummin, keep=cpu_steps + 4)
    rec_k2 = Recorder(co.chain_advance, keep=cpu_steps + 4)
    nfa.multi_reverse_cummin, nfa.chain_advance = rec_k1, rec_k2
    try:
        # rows over the CPU check's micro-batches: 8 steps of 131,072
        # events, 4 segments on one graph
        bench = bench_main_path(fpt, co, "multiquery64", MULTIQUERY64,
                                schema, batches, chain=True, outs=MQ_OUTS,
                                row_batches=CHECK_BATCHES)
    finally:
        nfa.multi_reverse_cummin = co.multi_reverse_cummin
        nfa.chain_advance = co.chain_advance
    steps = MQ_BATCHES * BATCH // MQ_STEP_EVENTS
    res = bench["resident"]
    for k in ("multi_reverse_cummin", "chain_advance"):
        if res["launches"][k] != steps or res["launches_traced"][k] != steps:
            raise AssertionError(f"multiquery64: {k} launched "
                                 f"{res['launches'][k]} times (on the card "
                                 f"{res['launches_traced'][k]}) in {steps} "
                                 "steps")
    if rec_k2.args is None or rec_k2.args[4].device.type != "cuda":
        raise AssertionError("multiquery64: no stacked kernel input "
                             "recorded on the card")
    full, full_k1, full_k2 = full_branch_step(fpt, co, nfa, schema, batches)
    torch.save({
        "k1": [keep_copy(a, "cpu") for a in rec_k1.args],
        "k1_kw": rec_k1.kwargs,
        "k2": [keep_copy(a, "cpu") for a in rec_k2.args],
        "k1_full": [keep_copy(a, "cpu") for a in full_k1.args],
        "k1_full_kw": full_k1.kwargs,
        "k2_full": [keep_copy(a, "cpu") for a in full_k2.args],
    }, out_path + ".pt")
    with open(out_path, "w") as f:
        json.dump({"bench": bench, "full_branch": full}, f)


# -- phase 8b: the slot NFA (sequences, quantifiers, groups, cross filters) --

SLOT_CHECK_EVENTS = 32_768  # rows held to the CPU path over these events
SLOT_TIMED_RUNS = 5  # phase 9's timed calls of K4 on each query's input
SLOT_STEPS = 8  # phase 8b's tapes of BATCH (20 before phase 8f: the budget)


def keep_calls(fn, keep, into, copy=None):
    """A stand-in for the kernel wrapper ``fn``: it forwards every call and
    keeps a copy of the inputs of the calls in ``keep`` ({call number:
    key}) in ``into`` (``copy``: ``args_copy``, to the host, by
    default)."""
    calls = [0]

    def call(*args, **kwargs):
        calls[0] += 1
        if calls[0] in keep:
            into[keep[calls[0]]] = (copy or args_copy)(args)
        return fn(*args, **kwargs)
    return call


def main_path_runs(fpt, co, name, outs, make_job, want, steps, n_events,
                   patches=(), make_sink=None, tables=False):
    """The runs phases 8b-8e make of one plan over its whole stream:

    - the streaming Job (``make_job(device, retain)``; a sink on each of
      ``outs``, ``make_sink()`` or a counting columnar one; each kernel
      launched ``want`` times a step over ``steps`` steps, no other;
      overflow 0; ``patches``, (module, name, stand-in), in place for this
      run only, record kernel inputs);
    - ResidentReplay: a run with the sinks (the same rows, a row sink's
      checksum, with ``tables`` the same final PriceTable), then
      counts-only: three reruns (events/s median and best), graphs
      captured, no eager segment, one staged segment under sync debug mode
      "error", the launches on the host and in a traced rerun.
    Returns the part of the result all these phases share."""
    import torch

    make_sink = make_sink or (lambda: ColumnRows(keep=False))

    def sunk(sinks):  # what the two runs must share
        return {o: snk.fold() if isinstance(snk, RowCount) else snk.rows
                for o, snk in sinks.items()}

    # the streaming Job over the whole stream, kernel inputs recorded
    sinks = {o: make_sink() for o in outs}
    job = make_job("cuda", False)
    for o, snk in sinks.items():
        job.add_sink(o, snk)
    real = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, stand_in in patches:
        setattr(mod, attr, stand_in)
    torch.cuda.synchronize()
    co.reset_launches()
    try:
        t0 = time.perf_counter()
        job.run()
        job.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in real:
            setattr(mod, attr, fn)
    launches = co.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update({k: v * steps for k, v in want.items()})
    if launches != expect:
        raise AssertionError(f"{name}: streaming launches {launches}, "
                             f"expected {expect}")
    drain_accounts(job, f"{name}: streaming")
    rows = {o: snk.rows for o, snk in sinks.items()}
    got = sunk(sinks)
    overflow = overflow_counts(job)
    tbl = table_state(job)[0] if tables else None
    if min(rows.values()) < 1000 or any(overflow.values()):
        raise AssertionError(f"{name}: rows {rows}, overflow {overflow}")
    if tables and not int(tbl["valid"].sum()):
        raise AssertionError(f"{name}: no valid table row at the end")
    del job

    # ResidentReplay: with the sinks, then counts-only
    torch.cuda.reset_peak_memory_stats()
    rsinks = {o: make_sink() for o in outs}
    job = make_job("cuda", False)
    for o, snk in rsinks.items():
        job.add_sink(o, snk)
    rep = fpt.ResidentReplay(job)
    rep.stage()
    (pid, segs), = rep.segments.items()
    rsteps = sum(len(seg) for seg in segs)
    captured = job.graphs_captured
    co.reset_launches()
    t0 = time.perf_counter()
    rep.run()
    job.flush()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    rlaunch = co.launch_counts()
    drain_accounts(job, f"{name}: resident run")
    rexpect = dict(expect, **{k: v * rsteps for k, v in want.items()})
    if sunk(rsinks) != got:
        raise AssertionError(f"{name}: resident rows {sunk(rsinks)}, "
                             f"streaming {got}")
    if tables:
        for k, v in table_state(job)[0].items():
            same(v, tbl[k], f"{name}: resident PriceTable's {k} vs "
                            "streaming")
    if (rlaunch != rexpect or job.eager_segments or not captured
            or job.graphs_captured != captured):
        raise AssertionError(
            f"{name}: launches {rlaunch} in {rsteps} steps (expected "
            f"{rexpect}), {job.eager_segments} eager segments, "
            f"{job.graphs_captured} graphs ({captured} at stage)")
    job._sinks.clear()  # counts-only from here: rerun() replays
    reruns = []
    for _ in range(3):
        before = {o: job.emitted_counts.get(o, 0) for o in outs}
        reruns.append(rep.rerun())
        if {o: job.emitted_counts.get(o, 0) - before[o]
                for o in outs} != rows:
            raise AssertionError(f"{name}: a rerun emitted other counts")
    if job.graphs_captured != captured:
        raise AssertionError(f"{name}: a rerun captured a graph")
    eager = job.eager_segments
    peak = torch.cuda.max_memory_allocated()
    # one staged segment with no host wait inside a step
    job.reset_engine_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rep.run_segment(pid, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    prof, traced_s, traced_launch = traced_run(
        co, rep.rerun, f"{name}: traced resident rerun")
    traced = traced_share(prof, traced_s, len(segs), rsteps)
    del prof
    if traced_launch != rexpect:
        raise AssertionError(f"{name}: {traced_launch} kernel calls on the "
                             f"card in a rerun of {rsteps} steps")
    result = {
        "events": n_events,
        "batch": BATCH,
        "rows": rows,
        "overflow": overflow,
        "streaming": {"wall_s": wall, "events_per_s": n_events / wall,
                      "launches": launches},
        "resident": {
            "stage_s": rep.stage_seconds,
            "first_run_s": first_s,
            "rerun_s": reruns,
            "events_per_s_median": n_events / statistics.median(reruns),
            "events_per_s_best": n_events / min(reruns),
            "steps": rsteps,
            "segments": [len(seg) for seg in segs],
            "launches": rlaunch,
            "launches_traced": traced_launch,
            "graphs_captured": captured,
            "eager_segments": eager,
            "segment_sync_free": True,
            "max_memory_allocated_bytes": peak,
            "device_ms_per_step": traced["traced_device_busy_s"] * 1e3
            / rsteps,
            **traced,
        },
    }
    if tables:
        result["valid_rows_at_end"] = int(tbl["valid"].sum())
    return result


def slot_query(fpt, co, nfa, name, cql, schema, batches):
    """One slot-NFA query over the bench stream, the bench's settings:
    rows of the first SLOT_CHECK_EVENTS events on the card equal to the
    CPU path's; then ``main_path_runs`` with a row sink (rows and an exact
    checksum; K4 once a micro-batch and no other kernel; its third call's
    inputs recorded) and K4 timed on them. Returns (result, K4's recorded
    inputs)."""
    cfg = bench_config(fpt)
    prefix = [batches[0].slice(0, SLOT_CHECK_EVENTS)]
    cpu_rows, cpu_s, cpu_job = run_job(fpt, cql, schema, prefix, "cpu",
                                       config=cfg)
    art = cpu_job._plans["bench"].plan.artifacts[0]
    if type(art).__name__ != "SlotNFAArtifact":
        raise AssertionError(f"{name}: compiled to {type(art).__name__}")
    del cpu_job
    card_rows, _, _ = run_job(fpt, cql, schema, prefix, "cuda", config=cfg)
    if card_rows != cpu_rows or len(cpu_rows) < 50:
        raise AssertionError(f"{name}: {len(card_rows)} card rows, "
                             f"{len(cpu_rows)} CPU rows over the first "
                             f"{SLOT_CHECK_EVENTS} events, not equal")
    fields = [(i, f.name) for i, f in enumerate(art.output_schema.fields)
              if f.atype.name != "STRING"]
    n_events = sum(len(b) for b in batches)
    rec = Recorder(co.slot_nfa_scan, keep=3)
    sinks = []

    def make_sink():
        sinks.append(RowCount(fields))
        return sinks[-1]

    runs = main_path_runs(
        fpt, co, f"slot {name}", ("matches",),
        lambda dev, retain: replay_job(fpt, cql, schema, batches, retain),
        {"slot_nfa_scan": 1}, len(batches), n_events,
        patches=((nfa, "slot_nfa_scan", rec),), make_sink=make_sink)
    scan_args = rec.args
    # K4 on this run's third step: events visited, us a visited event,
    # beside the old serial floor and the warp floor
    k4 = slot_scan_times(co, scan_args, None)
    log(f"  {name}: K4 {k4['ms']} ms a step, {k4['events_visited']} events "
        f"visited, {k4['per_event_us']} us a visited event; serial floor "
        f"{k4['serial_floor_ms']} ms, warp floor {k4['warp_floor_ms']} ms")
    result = {
        "path": f"slot_{name}",
        "cql": cql,
        "kind": art.spec.kind,
        # the scan visits the relevant events of a '->' pattern's tape; a
        # sequence's, or a pattern's whose every event is relevant, is full
        "scan": "compacted" if scan_args[-1] is not None
        and int(scan_args[-1][0]) < int(scan_args[3].shape[0]) else "full",
        "slots": art.slots,
        "cpu_check_events": SLOT_CHECK_EVENTS,
        "cpu_check_rows": len(cpu_rows),
        "cpu_check_s": cpu_s,
        **runs,
        "rows": runs["rows"]["matches"],
        "checksum": sinks[0].checksum,
        "overflow": sum(runs["overflow"].values()),
        "k4": k4,
    }
    log(json.dumps(result))
    return result, scan_args


def slot_phase(fpt, co, out_path):
    """The four slot-NFA queries (SLOT_QUERIES) over the bench stream; the
    result goes to ``out_path``, K4's recorded inputs to
    ``out_path``.pt."""
    import torch

    from flink_siddhi_tpu_torch.compiler import nfa

    schema, batches = bench_stream(fpt, BATCH * SLOT_STEPS, BATCH)
    results, recorded = [], {}
    for name, cql in SLOT_QUERIES:
        t0 = time.perf_counter()
        res, args = slot_query(fpt, co, nfa, name, cql, schema, batches)
        res["phase_s"] = time.perf_counter() - t0
        results.append(res)
        recorded[name] = [keep_copy(a, "cpu") for a in args]
        log(f"  slot {name}: {res['rows']} rows, overflow "
            f"{res['overflow']}, resident "
            f"{res['resident']['events_per_s_median']:.4g} events/s, "
            f"{res['phase_s']:.1f} s")
    with open(out_path, "w") as f:
        json.dump(results, f)
    torch.save(recorded, out_path + ".pt")


def slots_main(out_path):
    """Phase 8b alone (``--slots OUT``), run by ``main`` in a child
    process."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    slot_phase(fpt, co, out_path)
    return 0


# -- phase 8c: stream joins and query chaining ---------------------------------

# 8c's, 8d's and W1's streams: tapes of BATCH (20 before phase 8i came)
JOIN_TAPES = 14
JOIN_MS = BATCH * JOIN_TAPES // 2  # each stream: one event a ms (3,670,016)
JOIN_STREAM_BATCH = BATCH // 2  # each stream's events a step: the tape BATCH
JOIN_SMALL = 4_096  # the row checks' tape (2,048 events of each stream)
JOIN_CHECK_MS = 32_768  # held to the CPU path: 65,536 events
JOIN_ROW_STEPS = 2  # steps at BATCH held to the card's JOIN_SMALL rows
JOIN_RTOL = 1e-5  # G1's and C1's float sums across batchings
# J1: the reference's own join test (SiddhiCEPITCase.java:306-327), its
# windows scaled to one event a ms: about 2 pairs an event
J1 = (
    "from inputStream1#window.length(100) as s1 "
    "join inputStream2#window.time(100) as s2 on s1.id == s2.id "
    "select s1.timestamp as t, s1.name as n, s1.price as p1, "
    "s2.price as p2 insert into JoinStream"
)
# G1: J1 aggregated (the aggregated-join rewrite: a join into an
# intermediate stream, a grouped cumulative aggregation over it)
G1 = (
    "from inputStream1#window.length(100) as s1 "
    "join inputStream2#window.time(100) as s2 on s1.id == s2.id "
    "select s1.id as id, sum(s2.price) as total, count() as n "
    "group by s1.id insert into JoinStream"
)
# C1: query chaining over the single bench stream
C1 = (
    "from inputStream[price > 10.0] select id, price insert into mid; "
    "from mid#window.length(1000) select sum(price) as s insert into out"
)
J1_OUTER = (
    "from inputStream1#window.length(100) as s1 left outer join "
    "inputStream2#window.time(100) as s2 on s1.id == s2.id within 50 "
    "select s1.id as id, s2.price as p2 insert into JoinStream"
)
JOIN_QUERIES = (("J1", J1, ("inputStream1", "inputStream2"), "JoinStream"),
                ("G1", G1, ("inputStream1", "inputStream2"), "JoinStream"),
                ("C1", C1, ("inputStream",), "out"))


def join_columns(fpt, sids, n_ms, n_ids=N_IDS):
    """The bench schema (one object, one string table) and, per stream,
    the bench generator's columns over ``n_ms`` events one ms apart (ts
    1000 + i): id uniform in [0, n_ids), name "test_event", price uniform
    x 100; stream k's rng seed 7 + k (inputStream1 and inputStream have
    the bench's own seed)."""
    schema = fpt.StreamSchema([("id", "int"), ("name", "string"),
                               ("price", "double"), ("timestamp", "long")])
    code = schema.string_tables["name"].intern("test_event")
    cols = {}
    for k, sid in enumerate(sids):
        rng = np.random.default_rng(7 + k)
        ts = 1000 + np.arange(n_ms, dtype=np.int64)
        cols[sid] = {"id": rng.integers(0, n_ids, n_ms).astype(np.int32),
                     "name": np.full(n_ms, code, dtype=np.int32),
                     "price": rng.random(n_ms) * 100.0, "timestamp": ts}
    return schema, cols


def join_batches(fpt, schema, cols, per_batch, n_ms=None):
    """Each stream's columns cut into batches of ``per_batch`` events (the
    first ``n_ms`` events)."""
    out = {}
    for sid, c in cols.items():
        n = len(c["timestamp"]) if n_ms is None else n_ms
        out[sid] = [fpt.EventBatch(sid, schema,
                                   {k: v[s:min(s + per_batch, n)]
                                    for k, v in c.items()},
                                   c["timestamp"][s:min(s + per_batch, n)])
                    for s in range(0, n, per_batch)]
    return out


def join_job(fpt, cql, schema, streams, device, retain=True):
    """A Job over ``streams`` ({sid: batches}, one batch a stream a cycle:
    the tape holds every stream's batch) with the bench's settings."""
    plan = fpt.compile_plan(cql, {sid: schema for sid in streams},
                            plan_id="bench", config=bench_config(fpt))
    return fpt.Job([plan], [fpt.BatchSource(sid, schema, iter(bs))
                            for sid, bs in streams.items()],
                   batch_size=BATCH, time_mode="processing",
                   retain_results=retain, device=device)


class ColumnRows:
    """A columnar sink that keeps every column (``keep``) or only counts
    the rows."""

    def __init__(self, keep=True):
        self.keep, self.rows = keep, 0
        self.parts = []

    def accept_columns(self, ts, cols):
        self.rows += len(ts)
        if self.keep:
            self.parts.append((np.asarray(ts).copy(),
                               {k: np.asarray(v).copy()
                                for k, v in cols.items()}))

    def table(self):
        ts = np.concatenate([p[0] for p in self.parts])
        return ts, {k: np.concatenate([p[1][k] for p in self.parts])
                    for k in self.parts[0][1]}


def join_rows_equal(name, got, ref, what):
    """Rows as sorted multisets: J1's exactly; G1's by (id, n) and C1's by
    ts, their float sums within JOIN_RTOL. Returns the largest relative
    difference."""
    (gts, g), (rts, r) = got, ref
    if len(gts) != len(rts):
        raise AssertionError(f"{name} {what}: {len(gts)} rows, expected "
                             f"{len(rts)}")
    if name == "J1":
        keys = ("p2", "p1", "t")
    elif name == "G1":
        keys = ("n", "id")
    else:
        keys = ()
    go = np.lexsort([g[k] for k in keys] + [gts])
    ro = np.lexsort([r[k] for k in keys] + [rts])
    if not np.array_equal(gts[go], rts[ro]):
        raise AssertionError(f"{name} {what}: timestamps differ")
    worst = 0.0
    for k in g:
        a, b = g[k][go], r[k][ro]
        if name != "J1" and k in ("total", "s"):
            a, b = a.astype(np.float64), b.astype(np.float64)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
            worst = max(worst, float(rel.max()) if len(rel) else 0.0)
            if not worst <= JOIN_RTOL:
                raise AssertionError(f"{name} {what}: {k} differs by "
                                     f"{worst}")
        elif not np.array_equal(a, b):
            raise AssertionError(f"{name} {what}: column {k} differs")
    return worst


def join_table(fpt, cql, schema, streams, device, out):
    """Every row of ``out`` (columns, through a columnar sink) of a run."""
    import torch

    job = join_job(fpt, cql, schema, streams, device, retain=False)
    sink = ColumnRows()
    job.add_sink(out, sink)
    t0 = time.perf_counter()
    job.run()
    job.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    return sink.table(), time.perf_counter() - t0, job


def join_query(fpt, co, name, cql, sids, out, cols, schema):
    """One query of phase 8c, the bench's settings:

    - rows of the first JOIN_CHECK_MS ms of every stream at a JOIN_SMALL
      tape on the card equal to the CPU path's (floats within JOIN_RTOL);
    - rows at a BATCH tape over the first JOIN_ROW_STEPS steps equal, as
      sorted multisets, to the card's at JOIN_SMALL over the same events;
    - ``main_path_runs`` over the whole streams (K5 once a step and no
      other kernel; K5's third call's inputs recorded).
    Returns (result, K5's recorded inputs or None)."""
    join = name != "C1"
    small_cpu = join_batches(fpt, schema, cols, JOIN_SMALL // len(sids),
                             JOIN_CHECK_MS)
    small_dev = join_batches(fpt, schema, cols, JOIN_SMALL // len(sids),
                             JOIN_CHECK_MS)
    cpu_rows, cpu_s, cpu_job = join_table(fpt, cql, schema, small_cpu,
                                          "cpu", out)
    kinds = [type(a).__name__ for a in cpu_job._plans["bench"].plan.artifacts]
    del cpu_job
    card_rows, _, _ = join_table(fpt, cql, schema, small_dev, "cuda", out)
    rel_cpu = join_rows_equal(name, card_rows, cpu_rows,
                              f"first {JOIN_CHECK_MS} ms, card vs CPU")
    if len(cpu_rows[0]) < 1000:
        raise AssertionError(f"{name}: {len(cpu_rows[0])} CPU rows")
    # a BATCH tape against the card's JOIN_SMALL tape, the same events
    n_ms = JOIN_ROW_STEPS * BATCH // len(sids)
    big_rows, _, _ = join_table(
        fpt, cql, schema,
        join_batches(fpt, schema, cols, BATCH // len(sids), n_ms), "cuda",
        out)
    small_rows, _, _ = join_table(
        fpt, cql, schema,
        join_batches(fpt, schema, cols, JOIN_SMALL // len(sids), n_ms),
        "cuda", out)
    rel_big = join_rows_equal(name, big_rows, small_rows,
                              f"first {JOIN_ROW_STEPS} steps, tape {BATCH} "
                              f"vs {JOIN_SMALL}")
    del big_rows, small_rows
    streams = join_batches(fpt, schema, cols, BATCH // len(sids))
    recorded = {}
    runs = main_path_runs(
        fpt, co, name, (out,),
        lambda dev, retain: join_job(fpt, cql, schema, streams, dev, retain),
        {"join_pairs": 1} if join else {}, len(streams[sids[0]]),
        sum(len(c["timestamp"]) for c in cols.values()),
        patches=((co, "join_pairs",
                  keep_calls(co.join_pairs, {3: "args"}, recorded,
                             join_args_copy)),))
    result = {
        "path": f"join_{name}",
        "cql": cql,
        "artifacts": kinds,
        "cpu_check_events": JOIN_CHECK_MS * len(sids),
        "cpu_check_rows": len(cpu_rows[0]),
        "cpu_check_s": cpu_s,
        "cpu_check_max_rel": rel_cpu,
        "batch_check_events": n_ms * len(sids),
        "batch_check_max_rel": rel_big,
        **runs,
        "rows": runs["rows"][out],
        "overflow": sum(runs["overflow"].values()),
    }
    log(json.dumps(result))
    return result, recorded.get("args")


def join_args_copy(args, device="cpu"):
    """A copy of one K5 call's arguments (its JoinDirs' tensors copied)."""
    import torch

    dirs, ts, *rest = args
    return ([dataclasses.replace(d, **{
        f.name: getattr(d, f.name).to(device, copy=True)
        for f in dataclasses.fields(d)
        if isinstance(getattr(d, f.name), torch.Tensor)}) for d in dirs],
        ts.to(device, copy=True), *rest)


def outer_join_rows(fpt, co):
    """The left outer join with `within 50` (J1_OUTER): rows only, on the
    first JOIN_CHECK_MS ms of both streams at a JOIN_SMALL tape, the card's
    equal to the CPU path's (missing sides None)."""
    sids = ("inputStream1", "inputStream2")
    schema, cols = join_columns(fpt, sids, JOIN_CHECK_MS)
    out = []
    for dev in ("cpu", "cuda"):
        job = join_job(fpt, J1_OUTER, schema,
                       join_batches(fpt, schema, cols, JOIN_SMALL // 2),
                       dev)
        job.run()
        job.flush()
        out.append(job.results_with_ts("JoinStream"))
    if out[0] != out[1] or len(out[0]) < 1000:
        raise AssertionError(f"left outer join: {len(out[1])} card rows, "
                             f"{len(out[0])} CPU rows, not equal")
    missing = sum(1 for _, r in out[0] if r[1] is None)
    if not missing:
        raise AssertionError("left outer join: no unmatched row")
    return {"rows": len(out[0]), "unmatched_rows": missing}


def join_phase(fpt, co, out_path):
    """J1, G1 (two streams) and C1 (the bench stream) as ``join_query``
    runs them, and the left outer join's rows; the result goes to
    ``out_path``, J1's recorded K5 inputs to ``out_path``.pt."""
    import torch

    results, recorded = [], None
    for name, cql, sids, out in JOIN_QUERIES:
        t0 = time.perf_counter()
        schema, cols = join_columns(fpt, sids, JOIN_MS * 2 // len(sids))
        res, args = join_query(fpt, co, name, cql, sids, out, cols, schema)
        del cols
        res["phase_s"] = time.perf_counter() - t0
        results.append(res)
        if name == "J1":
            recorded = args
        log(f"  {name}: {res['rows']} rows, resident "
            f"{res['resident']['events_per_s_median']:.4g} events/s, "
            f"{res['phase_s']:.1f} s")
    outer = outer_join_rows(fpt, co)
    log(f"  left outer join within 50: {json.dumps(outer)}")
    with open(out_path, "w") as f:
        json.dump({"queries": results, "outer": outer}, f)
    torch.save(recorded, out_path + ".pt")


def joins_main(out_path):
    """Phase 8c alone (``--joins OUT``), run by ``main`` in a child
    process."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    join_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


# -- phase 8d: event tables ----------------------------------------------------

TABLE_N_IDS = 10_000  # the tables phase's ids
TABLE_CHECK_STEPS = 2  # steps at BATCH held to the CPU path
TABLE_OUTER_MS = 32_768  # the outer join's rows: 65,536 events
TABLE_OUTER_TAPE = 16_384
# Siddhi's event-table example in shape: a reference table fed by one
# stream, updated and pruned by another, looked up by it
TABLES = (
    "define table PriceTable (id int, price double); "
    "from inputStream1[price > 99.8] select id, price "
    "insert into PriceTable; "
    "from inputStream2[price < 50.0] select id, price "
    "update PriceTable on PriceTable.id == id; "
    "from inputStream2[price > 99.5] select id "
    "delete PriceTable on PriceTable.id == id; "
    "from inputStream2 {join} PriceTable "
    "on inputStream2.id == PriceTable.id "
    "select inputStream2.id as id, inputStream2.price as p2, "
    "PriceTable.price as p1 insert into joined"
)
TABLE_SIDS = ("inputStream1", "inputStream2")


def table_state(job):
    """The PriceTable's state of a run (valid, ptr, the columns) on the
    host, and the insert's and the join's overflow counters."""
    states = job._plans["bench"].states
    tbl = {k: v.cpu() for k, v in states["@tables"]["PriceTable"].items()}
    over = {name: int(st["overflow"]) for name, st in states.items()
            if name != "@tables" and "overflow" in st}
    return tbl, over


def table_rows_equal(got, ref, what):
    """Rows in emission order, exactly (float columns by bit pattern)."""
    (gts, g), (rts, r) = got, ref
    if len(gts) != len(rts) or not np.array_equal(gts, rts):
        raise AssertionError(f"tables {what}: {len(gts)} rows, expected "
                             f"{len(rts)}, or their timestamps differ")
    for k in r:
        a, b = np.asarray(g[k]), np.asarray(r[k])
        if a.dtype.kind == "f":
            a, b = a.astype(np.float32).view(np.int32), \
                b.astype(np.float32).view(np.int32)
        if not np.array_equal(a, b):
            raise AssertionError(f"tables {what}: column {k} differs")


def table_check(fpt, schema, cols):
    """The card's `joined` rows and final table state against the CPU
    path's at the same tape size (BATCH) over the first TABLE_CHECK_STEPS
    steps: table writes are sequenced by micro-batch, so rows compare only
    at one tape size."""
    n_ms = TABLE_CHECK_STEPS * BATCH // 2
    out = {}
    for dev in ("cpu", "cuda"):
        rows, secs, job = join_table(
            fpt, TABLES.format(join="join"), schema,
            join_batches(fpt, schema, cols, BATCH // 2, n_ms), dev,
            "joined")
        out[dev] = (rows, secs, *table_state(job))
        del job
    (crow, csec, ctbl, cover), (grow, _, gtbl, gover) = out["cpu"], \
        out["cuda"]
    table_rows_equal(grow, crow, f"first {TABLE_CHECK_STEPS} steps, card "
                                 "vs CPU")
    for k, v in ctbl.items():
        same(gtbl[k], v, f"tables: the final PriceTable's {k}, card vs CPU")
    if gover != cover or len(crow[0]) < 1000:
        raise AssertionError(f"tables: overflow {gover} vs {cover}, "
                             f"{len(crow[0])} CPU rows")
    return {"cpu_check_events": 2 * n_ms, "cpu_check_rows": len(crow[0]),
            "cpu_check_s": csec,
            "cpu_check_valid_rows": int(ctbl["valid"].sum())}


def table_outer_rows(fpt, schema):
    """The left outer variant, rows only: TABLE_OUTER_MS ms of both streams
    at a TABLE_OUTER_TAPE tape, the card's rows and table equal to the CPU
    path's."""
    _, cols = join_columns(fpt, TABLE_SIDS, TABLE_OUTER_MS,
                           n_ids=TABLE_N_IDS)
    out = []
    for dev in ("cpu", "cuda"):
        rows, _, job = join_table(
            fpt, TABLES.format(join="left outer join"), schema,
            join_batches(fpt, schema, cols, TABLE_OUTER_TAPE // 2), dev,
            "joined")
        out.append((rows, table_state(job)[0]))
    (crows, ctbl), (grows, gtbl) = out
    table_rows_equal(grows, crows, "left outer join, card vs CPU")
    for k, v in ctbl.items():
        same(gtbl[k], v, f"tables outer: the final PriceTable's {k}")
    ts, c = crows
    unmatched = int((c["p1"] == 0).sum())
    if not unmatched or len(ts) < 1000:
        raise AssertionError(f"tables outer: {len(ts)} rows, {unmatched} "
                             "unmatched")
    return {"events": 2 * TABLE_OUTER_MS, "tape": TABLE_OUTER_TAPE,
            "rows": len(ts), "unmatched_rows": unmatched}


def args_copy(args, device="cpu"):
    """A copy of a kernel call's arguments: its tensors (a JoinDir's too)
    copied to ``device``."""
    import torch

    if isinstance(args[0], list):
        return join_args_copy(args, device)
    return tuple(a.to(device, copy=True) if isinstance(a, torch.Tensor)
                 else a for a in args)


def table_phase(fpt, co, out_path):
    """Phase 8d: the TABLES plan over inputStream1 and inputStream2 (the
    bench generator, seeds 7 and 8, TABLE_N_IDS ids, one event a ms each,
    JOIN_MS each; a BATCH tape holds half of each) under bench.py's
    settings:

    - the card's rows and final table against the CPU path's
      (``table_check``);
    - ``main_path_runs`` over the whole streams (K6 twice a step, the
      update's and the delete's, K5 once; the third step's K6 and K5
      inputs recorded for phase 9; the final table the same resident and
      streaming);
    - the left outer variant, rows only (``table_outer_rows``).
    The result goes to ``out_path``, the recorded inputs to
    ``out_path``.pt."""
    import torch

    t_phase = time.perf_counter()
    schema, cols = join_columns(fpt, TABLE_SIDS, JOIN_MS,
                                n_ids=TABLE_N_IDS)
    cql = TABLES.format(join="join")
    check = table_check(fpt, schema, cols)
    streams = join_batches(fpt, schema, cols, BATCH // 2)
    recorded = {}
    # per step: the update's K6, then the delete's, then the join's K5
    runs = main_path_runs(
        fpt, co, "tables", ("joined",),
        lambda dev, retain: join_job(fpt, cql, schema, streams, dev, retain),
        {"table_mutate": 2, "join_pairs": 1}, len(streams[TABLE_SIDS[0]]),
        2 * JOIN_MS,
        patches=((co, "table_mutate", keep_calls(
            co.table_mutate, {5: "update", 6: "delete"}, recorded)),
            (co, "join_pairs", keep_calls(co.join_pairs, {3: "join"},
                                          recorded))),
        tables=True)
    outer = table_outer_rows(fpt, schema)
    result = {
        "path": "tables",
        "cql": cql,
        "n_ids": TABLE_N_IDS,
        **check,
        **runs,
        "rows": runs["rows"]["joined"],
        "outer": outer,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(json.dumps(result))
    with open(out_path, "w") as f:
        json.dump(result, f)
    torch.save(recorded, out_path + ".pt")


def tables_main(out_path):
    """Phase 8d alone (``--tables OUT``), run by ``main`` in a child
    process."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    table_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


# -- phase 8e: partitions and windowed table writes ---------------------------

PART_USERS = 1_000  # the partition key: accounts uniform in [0, 1,000)
PART_USER_SEED = 23  # the account column's own rng seed
PART_CHECK_EVENTS = 65_536  # rows held to the CPU path over these events
PART_SLOTS = 512  # P1's pool: about 200 partials live at a time
PART_RTOL = 1e-5  # float sums and averages, card against the CPU
# P1's and P2's tapes of BATCH (20 before phase 8h came: the smoke's time
# limit)
PART_STEPS = 8
W1_CHECK_STEPS = 1  # W1's row check: steps at BATCH
# P1: the headline kept per account (keyed CEP: a partial advances only on
# its own account's events, through the implicit `sK.user == s1.user`)
P1 = (
    "partition with (user of inputStream) begin "
    "from every s1 = inputStream[id == 1] -> s2 = inputStream[id == 2] "
    "-> s3 = inputStream[id == 3] within 10 sec "
    "select s1.user as u, s1.timestamp as t1, s3.timestamp as t3 "
    "insert into matches; end"
)
# P2: per-key state with no kernel: each account's own last 1,000 events
# (PerKeyWindowArtifact) and its running total (a grouped cumulative
# aggregation)
P2 = (
    "partition with (user of inputStream) begin "
    "from inputStream#window.length(1000) select user, sum(price) as s, "
    "avg(price) as a, count() as c insert into o; "
    "from inputStream select user, sum(price) as total insert into totals; "
    "end"
)
# W1: TABLES with its insert aggregated and its update windowed (the
# rewrite: a lengthBatch window into a synthesized stream, then K6)
W1 = (
    "define table PriceTable (id int, price double); "
    "from inputStream1[price > 99.8] select id, sum(price) as price "
    "group by id insert into PriceTable; "
    "from inputStream2#window.lengthBatch(1024) select id, "
    "avg(price) as price group by id "
    "update PriceTable on PriceTable.id == id; "
    "from inputStream2[price > 99.5] select id "
    "delete PriceTable on PriceTable.id == id; "
    "from inputStream2 join PriceTable "
    "on inputStream2.id == PriceTable.id "
    "select inputStream2.id as id, inputStream2.price as p2, "
    "PriceTable.price as p1 insert into joined"
)


def partition_stream(fpt, n_events, batch):
    """The bench stream (``bench_stream``: seed 7, one event a ms, id in
    [0, 50), price uniform x 100) with an int column ``user`` uniform in
    [0, PART_USERS) from its own seed."""
    _, base = bench_stream(fpt, n_events, batch)
    schema = fpt.StreamSchema([("id", "int"), ("name", "string"),
                               ("price", "double"), ("user", "int"),
                               ("timestamp", "long")])
    code = schema.string_tables["name"].intern("test_event")
    rng = np.random.default_rng(PART_USER_SEED)
    out = []
    for b in base:
        m = len(b)
        cols = dict(b.columns, name=np.full(m, code, dtype=np.int32),
                    user=rng.integers(0, PART_USERS, m).astype(np.int32))
        out.append(fpt.EventBatch("inputStream", schema, cols,
                                  cols["timestamp"]))
    return schema, out


def part_job(fpt, cql, schema, batches, device, retain, config=None):
    """A Job of one plan over the stream ``inputStream`` at BATCH."""
    plan = fpt.compile_plan(cql, {"inputStream": schema}, plan_id="bench",
                            config=config or bench_config(fpt))
    return fpt.Job([plan], [fpt.BatchSource("inputStream", schema,
                                            iter(batches))],
                   batch_size=BATCH, time_mode="processing",
                   retain_results=retain, device=device)


def overflow_counts(job):
    """Each artifact's own overflow counter (dropped partials, table rows
    that did not land, join rows past the cut)."""
    return {name: int(st["overflow"])
            for name, st in job._plans["bench"].states.items()
            if name != "@tables" and "overflow" in st}


def part_plan(fpt, co, name, cql, outs, make_job, check_job, want, steps,
              n_events, patches=(), tables=False, int_close=()):
    """One plan of phases 8e and 8f: rows of ``check_job``'s events on the
    card equal to the CPU path's (floats and the ``int_close`` columns
    within PART_RTOL; W1 at one tape size, its final table too), then
    ``main_path_runs`` over the whole stream. Returns the result."""
    import torch

    t_plan = time.perf_counter()
    got = {}
    for dev in ("cpu", "cuda"):
        job = check_job(dev)
        t0 = time.perf_counter()
        job.run()
        job.flush()
        got[dev] = ({o: job.results_with_ts(o) for o in outs},
                    time.perf_counter() - t0,
                    table_state(job)[0] if tables else None)
        del job
    worst = 0.0
    for o in outs:
        worst = max(worst, rows_match(got["cuda"][0][o], got["cpu"][0][o],
                                      PART_RTOL, f"{name} {o}: card vs CPU",
                                      int_close))
    check_rows = sum(len(r) for r in got["cpu"][0].values())
    if tables:
        for k, v in got["cpu"][2].items():
            a, b = got["cuda"][2][k], v
            if a.dtype.is_floating_point:
                if not torch.allclose(a, b, rtol=PART_RTOL, atol=0):
                    raise AssertionError(f"{name}: the final PriceTable's "
                                         f"{k}, card vs CPU")
            else:
                same(a, b, f"{name}: the final PriceTable's {k}, card vs "
                           "CPU")
    if check_rows < 10:  # P1: about 30 matches in 65,536 events
        raise AssertionError(f"{name}: {check_rows} CPU rows in the check")
    runs = main_path_runs(fpt, co, name, outs, make_job, want, steps,
                          n_events, patches=patches, tables=tables)
    return {
        "path": name,
        "cql": cql,
        "cpu_check_rows": check_rows,
        "cpu_check_s": got["cpu"][1],
        "cpu_check_max_rel": worst,
        **runs,
        "plan_s": time.perf_counter() - t_plan,
    }


def partition_phase(fpt, co, out_path):
    """Phase 8e: P1 (a keyed pattern on K4 at PART_SLOTS slots) and P2 (a
    per-key length window and a partitioned aggregation: no kernel) over
    the partition stream, W1 (TABLES with an aggregated insert and a
    windowed update: K6 twice a step, K5 once) over phase 8d's streams,
    each through ``part_plan`` under bench.py's settings. K4's inputs of
    P1's third step and K6's of W1's go to ``out_path``.pt, the result to
    ``out_path``."""
    import torch

    from flink_siddhi_tpu_torch.compiler import nfa

    t_phase = time.perf_counter()
    schema, batches = partition_stream(fpt, BATCH * PART_STEPS, BATCH)
    n_events = BATCH * PART_STEPS
    prefix = [batches[0].slice(0, PART_CHECK_EVENTS)]
    p1_cfg = fpt.EngineConfig(pattern_slots=PART_SLOTS,
                              lazy_projection=True, pred_pushdown=True)
    results, recorded = [], {}
    for name, cql, outs, want, cfg, patches in (
        ("P1", P1, ("matches",), {"slot_nfa_scan": 1}, p1_cfg,
         ((nfa, "slot_nfa_scan", keep_calls(co.slot_nfa_scan, {3: "k4"},
                                            recorded)),)),
        ("P2", P2, ("o", "totals"), {}, None, ()),
    ):
        res = part_plan(
            fpt, co, name, cql, outs,
            lambda dev, retain, _c=cql, _g=cfg: part_job(
                fpt, _c, schema, batches, dev, retain, _g),
            lambda dev, _c=cql, _g=cfg: part_job(
                fpt, _c, schema, prefix, dev, True, _g),
            want, PART_STEPS, n_events, patches=patches)
        kinds = [type(a).__name__ for a in
                 fpt.compile_plan(cql, {"inputStream": schema},
                                  config=cfg).artifacts]
        res["artifacts"] = kinds
        results.append(res)
    if results[0]["artifacts"] != ["SlotNFAArtifact"] or results[1][
            "artifacts"] != ["PerKeyWindowArtifact", "CumulativeAggArtifact"]:
        raise AssertionError(f"partitions: compiled to "
                             f"{[r['artifacts'] for r in results]}")
    del batches, prefix

    tschema, cols = join_columns(fpt, TABLE_SIDS, JOIN_MS,
                                 n_ids=TABLE_N_IDS)
    streams = join_batches(fpt, tschema, cols, BATCH // 2)
    # the first W1_CHECK_STEPS steps at BATCH: the full-size lengthBatch
    # grid and its synthesized tape on both paths
    check = join_batches(fpt, tschema, cols, BATCH // 2,
                         W1_CHECK_STEPS * BATCH // 2)
    kept = {}
    # per step: the update's K6, then the delete's, then the join's K5
    res = part_plan(
        fpt, co, "W1", W1, ("joined",),
        lambda dev, retain: join_job(fpt, W1, tschema, streams, dev, retain),
        lambda dev: join_job(fpt, W1, tschema, check, dev),
        {"table_mutate": 2, "join_pairs": 1}, len(streams[TABLE_SIDS[0]]),
        2 * JOIN_MS, patches=((co, "table_mutate", keep_calls(
            co.table_mutate, {5: "update", 6: "delete"}, kept)),),
        tables=True)
    res["artifacts"] = [type(a).__name__ for a in fpt.compile_plan(
        W1, {sid: tschema for sid in TABLE_SIDS}).artifacts]
    res["cpu_check_events"] = W1_CHECK_STEPS * BATCH
    results.append(res)
    recorded["w1"] = kept
    for r in results:
        log(f"  {r['path']}: rows {r['rows']}, overflow {r['overflow']}, "
            f"resident {r['resident']['events_per_s_median']:.4g} events/s "
            f"(best {r['resident']['events_per_s_best']:.4g}), streaming "
            f"{r['streaming']['events_per_s']:.4g}, idle "
            f"{r['resident']['traced_idle_share']:.3f}, launches "
            f"{r['resident']['launches_traced']}, {r['plan_s']:.1f} s")
    out = {"plans": results, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(out))
    with open(out_path, "w") as f:
        json.dump(out, f)
    torch.save(recorded, out_path + ".pt")


def partitions_main(out_path):
    """Phase 8e alone (``--partitions OUT``), run by ``main`` in a child
    process."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    partition_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


# -- phase 8f: the scan windows ----------------------------------------------

SCAN_STEPS = 4  # tapes of BATCH each plan runs (the kernels walk in series)
# the plans whose kernel runs on one warp (K8, K9 unpartitioned: 0.5-0.8 s
# a step) run 2 tapes (4 before phase 8g came: the time limit); phase 9
# times their kernel on the last step
SCAN_SHORT = ("O1", "F1", "F2")
SCAN_SHORT_STEPS = 2
SCAN_CHECK_EVENTS = 8_192  # rows held to the CPU path over these events
SCAN_PLAIN_EVENTS = 4_096  # phase 9: a walking plain version's prefix
S1 = ("from inputStream#window.session(2 sec, user) select user, "
      "count() as c, sum(price) as s, max(price) as hi insert into sessions")
O1 = ("from inputStream#window.sort(10, price) select id, count() as c, "
      "min(price) as mn, max(price) as mx, sum(price) as s insert into lows")
O2 = ("partition with (id of inputStream) begin "
      "from inputStream#window.sort(4, price, 'desc') select id, "
      "max(price) as hi, min(price) as lo, count() as c insert into tops; "
      "end")
F1 = ("from inputStream#window.frequent(8, id) select id, count() as c, "
      "sum(price) as s insert into heavy")
F2 = ("from inputStream#window.lossyFrequent(0.015, 0.0015, id) select id, "
      "count() as c insert into hitters")
U1 = ("from StockStream#window.unique(symbol) select symbol, "
      "count() as symbols, sum(volume) as v, max(volume) as vmax, "
      "avg(price) as p insert into Board")
# name, cql, output, stream (partition, bench, quote), kernel, artifact,
# int columns compared within PART_RTOL (a LONG sum)
SCAN_PLANS = (
    ("S1", S1, "sessions", "partition", "session_scan",
     "SessionWindowArtifact", ()),
    ("O1", O1, "lows", "bench", "sort_window_scan", "ScanWindowArtifact",
     ()),
    ("O2", O2, "tops", "bench", "sort_window_scan", "ScanWindowArtifact",
     ()),
    ("F1", F1, "heavy", "bench", "frequency_scan", "FrequencyWindowArtifact",
     ()),
    ("F2", F2, "hitters", "bench", "frequency_scan",
     "FrequencyWindowArtifact", ()),
    ("U1", U1, "Board", "quote", "unique_window_fold", "ScanWindowArtifact",
     (2,)),
)


def scan_steps(name):
    """The tapes phase 8f runs plan ``name`` over."""
    return SCAN_SHORT_STEPS if name in SCAN_SHORT else SCAN_STEPS


def scan_recorded_step(name):
    """The step whose kernel inputs phase 9 times: the third, or a short
    plan's last."""
    return min(3, scan_steps(name))


def scan_job(fpt, cql, sid, schema, batches, device, retain):
    """A Job of one plan over the stream ``sid`` at BATCH, bench.py's
    settings."""
    plan = fpt.compile_plan(cql, {sid: schema}, plan_id="bench",
                            config=bench_config(fpt))
    return fpt.Job([plan], [fpt.BatchSource(sid, schema, iter(batches))],
                   batch_size=BATCH, time_mode="processing",
                   retain_results=retain, device=device)


def scan_phase(fpt, co, out_path):
    """Phase 8f: S1 (a keyed session over the partition stream: K7), O1
    and O2 (a sort window, unpartitioned and per id: K9), F1 and F2
    (frequent and lossyFrequent: K8) over the bench stream, U1 (the quote
    board over INT/LONG volumes: K3's integer path) over phase 6's quote
    stream, each SCAN_STEPS tapes of BATCH through ``part_plan`` (its rows
    of the first SCAN_CHECK_EVENTS events held to the CPU path). Each
    kernel's inputs of its plan's third step go to ``out_path``.pt, the
    result to ``out_path``."""
    import torch

    from flink_siddhi_tpu_torch.compiler import scan_windows

    t_phase = time.perf_counter()
    n_events = BATCH * SCAN_STEPS
    streams = {"partition": partition_stream(fpt, n_events, BATCH),
               "bench": bench_stream(fpt, n_events, BATCH),
               "quote": quote_stream(fpt, n_events, BATCH)[:2]}
    sids = {"partition": "inputStream", "bench": "inputStream",
            "quote": "StockStream"}
    results, recorded = [], {}
    for name, cql, out, stream, kernel, art_name, int_close in SCAN_PLANS:
        schema, batches = streams[stream]
        sid = sids[stream]
        steps = scan_steps(name)
        batches = batches[:steps]
        prefix = [batches[0].slice(0, SCAN_CHECK_EVENTS)]
        res = part_plan(
            fpt, co, name, cql, (out,),
            lambda dev, retain, _c=cql, _s=sid, _h=schema, _b=batches:
                scan_job(fpt, _c, _s, _h, _b, dev, retain),
            lambda dev, _c=cql, _s=sid, _h=schema, _p=prefix:
                scan_job(fpt, _c, _s, _h, _p, dev, True),
            {kernel: 1}, steps, BATCH * steps,
            patches=((scan_windows, kernel, keep_calls(
                getattr(co, kernel), {scan_recorded_step(name): name},
                recorded)),),
            int_close=int_close)
        res["artifacts"] = [type(a).__name__ for a in fpt.compile_plan(
            cql, {sid: schema}, config=bench_config(fpt)).artifacts]
        if res["artifacts"] != [art_name]:
            raise AssertionError(f"{name}: compiled to {res['artifacts']}")
        res["kernel"] = kernel
        results.append(res)
        log(f"  {name}: rows {res['rows']}, resident "
            f"{res['resident']['events_per_s_median']:.4g} events/s (best "
            f"{res['resident']['events_per_s_best']:.4g}), streaming "
            f"{res['streaming']['events_per_s']:.4g}, idle "
            f"{res['resident']['traced_idle_share']:.3f}, device "
            f"{res['resident']['device_ms_per_step']:.4g} ms a step, "
            f"launches {res['resident']['launches_traced'][kernel]} traced, "
            f"{res['plan_s']:.1f} s")
    out = {"plans": results, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(out))
    with open(out_path, "w") as f:
        json.dump(out, f)
    torch.save(recorded, out_path + ".pt")


def scan_windows_main(out_path):
    """Phase 8f alone (``--scan-windows OUT``), run by ``main`` in a child
    process."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    scan_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


# -- phase 8g: event time and recovery ----------------------------------------

ET_TAPES = 8  # E1: tapes of BATCH of the bench stream (4,194,304 events)
# the disordered source's polls: a release (a poll plus the rows the gate
# held back) stays within one BATCH tape
ET_CHUNK = BATCH - 8_192
ET_SEED = 41
ET_SKEW_MS = 2_000  # the disorder bound and the watermark's (1 ms an event)
ET_LATE = 64  # injected stragglers
ET_LATE_RELEASE_MS = 20_000  # each released this far behind the stream
ET_SAVE_AFTER = 4  # E2: cycles (tapes) before the checkpoint
ET_STATE_TAPES = 4  # E3: tapes of each plan, the checkpoint after 2
ET_CPU_TAPE = 4_096  # E3: the CPU-written file's tapes (4 of them)
ET_RATE_EVENTS = 65_536  # E4: events held to the CPU path
ET_RATE_TAPE = 16_384
ET_RESIDENT_TAPES = 4  # E5: the resident drive's tapes
ET_QUOTE_RATE = QUOTE_BOARD.replace(
    "insert into Board", "output last every 4096 events insert into Board")
ET_WINDOW_SNAPSHOT = WINDOW_GROUPBY.replace(
    "insert into matches", "output snapshot every 1 sec insert into matches")


def et_disorder(fpt, schema, batches):
    """The bench stream through ``DisorderSource``: arrival shuffled by up
    to ET_SKEW_MS and ET_LATE stragglers held back ET_LATE_RELEASE_MS
    (seeded); served in ET_CHUNK polls."""
    from flink_siddhi_tpu_torch.runtime.faultinject import (
        DisorderSchedule,
        DisorderSource,
    )

    sched = DisorderSchedule(seed=ET_SEED, skew_ms=ET_SKEW_MS,
                             late_count=ET_LATE,
                             late_release_ms=ET_LATE_RELEASE_MS)
    return DisorderSource(fpt.BatchSource("inputStream", schema,
                                          iter(batches)), sched,
                          chunk=ET_CHUNK)


def et_replay(src):
    """The arranged stream of ``src`` from its start, watermarked at the
    disorder bound (a new source object; the arrangement is shared)."""
    import copy

    from flink_siddhi_tpu_torch.runtime.sources import with_watermarks

    fresh = copy.copy(src)
    fresh.injected = dict(src.injected)
    fresh.load_state_dict({"pos": 0})
    return with_watermarks(fresh, skew_ms=ET_SKEW_MS)


def et_job(fpt, schema, source, retain, config=None, policy="side_output"):
    """E1's Job: the headline in the fused streaming Job (FUSED_K tapes a
    segment) in event time, bench.py's settings unless ``config``."""
    plan = fpt.compile_plan(HEADLINE, {"inputStream": schema},
                            plan_id="bench",
                            config=config or bench_config(fpt))
    job = fpt.Job([plan], [source], batch_size=BATCH, time_mode="event",
                  retain_results=retain, device="cuda")
    job.fused_segment_len = FUSED_K
    job.late_policy = policy
    return job


def et_run(job):
    """Run ``job`` to its end; the wall seconds (synchronized)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    job.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def et_rerun(fpt, job, source):
    """A counts-only rerun of ``job`` (its graphs captured already) over
    ``source``: fresh engine state and gate, no sink, no retention.
    Returns events/s."""
    from flink_siddhi_tpu_torch.runtime.executor import MIN_WM

    job._sinks.clear()
    job.retain_results = False
    job.reset_engine_state()
    job._sources, job._source_wm, job._source_done = [source], [MIN_WM], \
        [False]
    job.late_events = job.late_dropped = 0
    n = job.processed_events
    wall = et_run(job)
    return (job.processed_events - n) / wall


def on_card(states):
    """Whether every tensor of a (nested) engine state is on the card."""
    if isinstance(states, dict):
        return all(on_card(v) for v in states.values())
    return states.device.type == "cuda"


def sorted_rows(rows):
    return sorted(rows, key=lambda r: (r[0], tuple(
        (v is None, v if v is not None else 0) for v in r[1])))


def et_headline(fpt, co, schema, batches, src):
    """E1: the disordered headline against the same Job over the in-order
    stream (the pristine stream without the stragglers), the stragglers
    on the side output exactly, K1 and K2 launched; then counts-only
    reruns of both for events/s. Returns (result, the disordered run's
    rows)."""
    from flink_siddhi_tpu_torch.runtime.executor import late_stream
    from flink_siddhi_tpu_torch.runtime.sources import with_watermarks

    keep = np.ones(len(src.pristine), dtype=bool)
    keep[src.late_log] = False
    in_order = src.pristine.take(np.nonzero(keep)[0])
    ordered = [in_order.slice(s, s + ET_CHUNK)
               for s in range(0, len(in_order), ET_CHUNK)]

    def ordered_source():
        return with_watermarks(fpt.BatchSource("inputStream", schema,
                                               iter(ordered)), skew_ms=0)

    ref_job = et_job(fpt, schema, ordered_source(), True)
    et_run(ref_job)
    ref = ref_job.results_with_ts("matches")
    if ref_job.late_events or len(ref) < 1000:
        raise AssertionError(f"E1 in order: {ref_job.late_events} late, "
                             f"{len(ref)} rows")
    job = et_job(fpt, schema, et_replay(src), True)
    co.reset_launches()
    wall = et_run(job)
    launches = co.launch_counts()
    rows = job.results_with_ts("matches")
    late_rows = job.collected.get(late_stream("inputStream"), [])
    want_late = sorted(
        (int(t), tuple(r[n] for n in schema.field_names))
        for t, r in zip(src.pristine.timestamps[src.late_log].tolist(),
                        src.pristine.take(src.late_log).records()))
    if sorted_rows(rows) != sorted_rows(ref):
        raise AssertionError(f"E1: {len(rows)} rows under disorder, "
                             f"{len(ref)} in order, or they differ")
    if (job.late_events != ET_LATE or job.late_dropped
            or sorted(late_rows) != want_late):
        raise AssertionError(f"E1: late_events {job.late_events}, dropped "
                             f"{job.late_dropped}, {len(late_rows)} rows on "
                             f"the side output, {ET_LATE} injected")
    if (not launches["multi_reverse_cummin"] or not launches["chain_advance"]
            or any(v for k, v in launches.items()
                   if k not in ("multi_reverse_cummin", "chain_advance"))):
        raise AssertionError(f"E1: launches {launches}")
    if job.eager_segments:
        raise AssertionError(f"E1: {job.eager_segments} eager segments")
    n = len(src.pristine)
    result = {
        "events": n, "tape": BATCH, "poll": ET_CHUNK,
        "skew_ms": ET_SKEW_MS, "late_injected": ET_LATE,
        "late_release_ms": ET_LATE_RELEASE_MS, "rows": len(rows),
        "late_events": job.late_events,
        "side_output_rows": len(late_rows),
        "launches": launches, "graphs_captured": job.graphs_captured,
        "first_run_s": wall,
        "watermark_lag_ms": hist_ms(job, "watermark.lag"),
        "gate_residency_ms": hist_ms(job, "gate.residency"),
        "reorder_s": job.telemetry.snapshot()["stages"].get(
            "reorder", {}).get("seconds"),
    }
    result["events_per_s"] = et_rerun(fpt, job, et_replay(src))
    result["in_order_events_per_s"] = et_rerun(fpt, ref_job,
                                               ordered_source())
    if job.graphs_captured != result["graphs_captured"]:
        raise AssertionError("E1: the counts-only rerun captured a graph")
    del job, ref_job
    return result, rows


def et_split(fpt, schema, src, config, path):
    """E2's split run: ET_SAVE_AFTER cycles, ``save_checkpoint``, then a
    fresh Job restores the file and runs to the end. Returns (rows before
    the save, rows after the restore, the late rows of both, timings, the
    first Job)."""
    import torch

    from flink_siddhi_tpu_torch.runtime.executor import late_stream

    first = et_job(fpt, schema, et_replay(src), True, config)
    for _ in range(ET_SAVE_AFTER):
        first.run_cycle()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    second = et_job(fpt, schema, et_replay(src), True, config)
    t0 = time.perf_counter()
    second.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if not on_card(second._plans["bench"].states):
        raise AssertionError("E2: the restored state is not on the card")
    et_run(second)
    late = (first.collected.get(late_stream("inputStream"), [])
            + second.collected.get(late_stream("inputStream"), []))
    if second.late_events != ET_LATE or len(late) != ET_LATE:
        raise AssertionError(f"E2: {second.late_events} late events after "
                             f"the restore, {len(late)} late rows")
    return (first.results_with_ts("matches"),
            second.results_with_ts("matches"),
            {"save_s": save_s, "restore_s": restore_s,
             "snapshot_bytes": os.path.getsize(path)}, first)


def et_checkpoint(fpt, schema, src, whole):
    """E2: E1 checkpointed after ET_SAVE_AFTER tapes and restored into a
    fresh Job. Under the bench settings the rows count as the
    uninterrupted run's (``whole``) and equal them where no lazy column
    was carried across the restore; the first Job restored in place (its
    graphs bound to its state) gives the fresh Job's rows. With
    lazy_projection off the rows equal the uninterrupted run's exactly.
    Returns (the result, the uninterrupted rows with lazy projection
    off)."""
    import collections

    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, "event_time.ckpt")
    before, after, timing, first = et_split(fpt, schema, src, None, path)
    split = before + after
    with_none = [r for r in split if None in r[1]]
    extra = (collections.Counter(r for r in split if None not in r[1])
             - collections.Counter(whole))
    if len(split) != len(whole) or sum(extra.values()):
        raise AssertionError(f"E2: {len(split)} rows split, {len(whole)} "
                             f"whole, {sum(extra.values())} not in it")
    # the first Job restored in place: its graphs' tensors overwritten
    n0 = len(before)
    graphs = first.graphs_captured
    first.restore(path)
    et_run(first)
    again = first.results_with_ts("matches")[n0:]
    if sorted_rows(again) != sorted_rows(after):
        raise AssertionError("E2: the Job restored in place differs from "
                             "the fresh one")
    if first.graphs_captured != graphs:
        raise AssertionError(f"E2: the in-place restore captured "
                             f"{first.graphs_captured - graphs} graphs")
    del first
    # lazy projection off: exact
    eager_cfg = fpt.EngineConfig(lazy_projection=False, pred_pushdown=True)
    ref = et_job(fpt, schema, et_replay(src), True, eager_cfg)
    et_run(ref)
    exact = ref.results_with_ts("matches")
    del ref
    before2, after2, timing2, first2 = et_split(fpt, schema, src, eager_cfg,
                                                path)
    del first2
    if sorted_rows(before2 + after2) != sorted_rows(exact):
        raise AssertionError("E2: with lazy projection off the split rows "
                             "differ from the uninterrupted run's")
    return {"rows": len(split), "rows_with_none": len(with_none),
            "rows_before_save": len(before), **timing,
            "lazy_off": {"rows": len(exact), **timing2},
            "in_place_restore_rows": len(again)}, exact


def et_state(fpt, co, name, make_job, outs, kernels, tables=False):
    """E3 for one plan: the uninterrupted run of ET_STATE_TAPES tapes and
    the split one (2 tapes, ``save_checkpoint``, a fresh Job restores and
    runs 2 more): the same rows and, with ``tables``, the same final
    table; each of ``kernels`` launched."""
    import torch

    path = os.path.join(SMOKE_DIR, f"event_time_{name}.ckpt")
    whole = make_job("cuda", ET_STATE_TAPES)
    co.reset_launches()
    et_run(whole)
    launches = co.launch_counts()
    if any(not launches[k] for k in kernels):
        raise AssertionError(f"E3 {name}: launches {launches}")
    first = make_job("cuda", ET_STATE_TAPES)
    first.run_cycle()
    first.run_cycle()
    first.save_checkpoint(path)
    second = make_job("cuda", ET_STATE_TAPES)
    t0 = time.perf_counter()
    second.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    et_run(second)
    for o in outs:
        got = first.results_with_ts(o) + second.results_with_ts(o)
        want = whole.results_with_ts(o)
        if sorted_rows(got) != sorted_rows(want) or len(want) < 10:
            raise AssertionError(f"E3 {name} {o}: {len(got)} rows split, "
                                 f"{len(want)} whole, or they differ")
    if tables:
        a, b = table_state(second)[0], table_state(whole)[0]
        for k, v in b.items():
            same(a[k], v, f"E3 {name}: the final PriceTable's {k}")
    return {"rows": {o: len(whole.results_with_ts(o)) for o in outs},
            "launches": launches, "snapshot_bytes": os.path.getsize(path),
            "restore_s": restore_s}


def et_cpu_file(fpt, name, make_job, outs):
    """E3: a file the CPU path writes (after 2 of 4 tapes of ET_CPU_TAPE)
    restores on the card, and the rows after it equal the CPU path's
    restored from the same file."""
    path = os.path.join(SMOKE_DIR, f"event_time_{name}_cpu.ckpt")
    cpu = make_job("cpu", 4)
    cpu.run_cycle()
    cpu.run_cycle()
    cpu.save_checkpoint(path)
    rows = {}
    for dev in ("cpu", "cuda"):
        job = make_job(dev, 4)
        job.restore(path)
        et_run(job) if dev == "cuda" else job.run()
        rows[dev] = {o: job.results_with_ts(o) for o in outs}
    for o in outs:
        if rows["cuda"][o] != rows["cpu"][o] or not rows["cpu"][o]:
            raise AssertionError(f"E3 {name}: the CPU file restored on the "
                                 f"card gives {len(rows['cuda'][o])} rows, "
                                 f"the CPU {len(rows['cpu'][o])}")
    return {o: len(rows["cpu"][o]) for o in outs}


def et_states(fpt, co, batches):
    """E3: slot query (a) of phase 8b (K4) and the tables path of 8d (K6,
    K5) across a restore on the card, and files of the CPU path restored
    on the card."""
    from flink_siddhi_tpu_torch.runtime.sources import ReplayBatchSource

    schema = batches[0].schema
    slot_cql = SLOT_QUERIES[0][1]

    def slot_job(dev, tapes, tape=BATCH):
        events = [b.slice(s, s + tape) for b in batches
                  for s in range(0, len(b), tape)][:tapes]
        plan = fpt.compile_plan(slot_cql, {"inputStream": schema},
                                plan_id="bench", config=bench_config(fpt))
        job = fpt.Job([plan], [ReplayBatchSource("inputStream", schema,
                                                 events)],
                      batch_size=tape, time_mode="processing", device=dev)
        if dev == "cuda":
            job.fused_segment_len = FUSED_K
        return job

    tschema, cols = join_columns(fpt, TABLE_SIDS,
                                 ET_STATE_TAPES * BATCH // 2,
                                 n_ids=TABLE_N_IDS)
    # the CPU-written file's streams: N_IDS ids, so that the table fills
    # and the join emits in 16,384 events
    _, small = join_columns(fpt, TABLE_SIDS, 4 * ET_CPU_TAPE // 2)

    def table_job(dev, tapes, tape=BATCH, cols=cols):
        streams = join_batches(fpt, tschema, cols, tape // 2,
                               tapes * tape // 2)
        plan = fpt.compile_plan(TABLES.format(join="join"),
                                {sid: tschema for sid in streams},
                                plan_id="bench", config=bench_config(fpt))
        job = fpt.Job([plan], [ReplayBatchSource(sid, tschema, bs)
                               for sid, bs in streams.items()],
                      batch_size=tape, time_mode="processing", device=dev)
        if dev == "cuda":
            job.fused_segment_len = FUSED_K
        return job

    out = {
        "slot_a": et_state(fpt, co, "slot_a", slot_job, ("matches",),
                           ("slot_nfa_scan",)),
        "tables": et_state(fpt, co, "tables", table_job, ("joined",),
                           ("table_mutate", "join_pairs"), tables=True),
    }
    out["slot_a"]["cpu_file_rows"] = et_cpu_file(
        fpt, "slot_a", lambda dev, n: slot_job(dev, n, ET_CPU_TAPE),
        ("matches",))
    out["tables"]["cpu_file_rows"] = et_cpu_file(
        fpt, "tables", lambda dev, n: table_job(dev, n, ET_CPU_TAPE, small),
        ("joined",))
    return out


def et_rates(fpt, co):
    """E4: the quote board (K3) with `output last every 4096 events` and
    window_groupby with `output snapshot every 1 sec` over their first
    ET_RATE_EVENTS events at ET_RATE_TAPE tapes, card against CPU (the
    window's last snapshot, flushed at the end: one row a group)."""
    qschema, qbatches, _ = quote_stream(fpt, ET_RATE_EVENTS, ET_RATE_TAPE)
    wschema, wbatches = bench_stream(fpt, ET_RATE_EVENTS, ET_RATE_TAPE,
                                     n_ids=N_IDS_WINDOW)
    out = {}
    for name, cql, sid, schema, batches, o in (
            ("quote_board", ET_QUOTE_RATE, "StockStream", qschema, qbatches,
             "Board"),
            ("window_groupby", ET_WINDOW_SNAPSHOT, "inputStream", wschema,
             wbatches, "matches")):
        rows, launches = {}, None
        for dev in ("cpu", "cuda"):
            plan = fpt.compile_plan(cql, {sid: schema}, plan_id="bench",
                                    config=bench_config(fpt))
            if o not in plan.output_rates:
                raise AssertionError(f"E4 {name}: no rate on {o}")
            job = fpt.Job([plan], [fpt.BatchSource(sid, schema,
                                                   iter(batches))],
                          batch_size=ET_RATE_TAPE, time_mode="processing",
                          device=dev)
            co.reset_launches()
            job.run()
            rows[dev] = job.results_with_ts(o)
            if dev == "cuda":
                launches = co.launch_counts()
        got, ref = rows["cuda"], rows["cpu"]
        if name == "window_groupby":
            groups = N_IDS_WINDOW
            got, ref = (sorted(r[-groups:], key=lambda x: x[1][0])
                        for r in (got, ref))
            if len({r[1][0] for r in ref}) != groups:
                raise AssertionError(f"E4 {name}: the last snapshot holds "
                                     f"{len(ref)} rows, not one a group")
        rel = rows_match(got, ref, WINDOW_RTOL, f"E4 {name}: card vs CPU")
        if name == "quote_board":
            if (len(ref) != ET_RATE_EVENTS // 4096
                    or not launches["unique_window_fold"]):
                raise AssertionError(f"E4 {name}: {len(ref)} rows, "
                                     f"launches {launches}")
        out[name] = {"rows": len(rows["cpu"]), "compared_rows": len(ref),
                     "max_rel": rel, "launches": launches}
    return out


def et_supervised(fpt, schema, batches, src, whole):
    """E5: a Supervisor over E1's fused headline (late policy 'drop',
    lazy projection off: under it a partial carried across a restore
    decodes its lazy columns as None, E2), killed at source pulls 3 and 9
    and in its second checkpoint: 3 crashes, the committed rows equal the
    unfaulted run's (``whole``) with none duplicated or lost,
    late_dropped exact; then the resident drive (bench.py's settings)
    over ET_RESIDENT_TAPES tapes, killed mid-stage and in its first
    checkpoint, its rows equal an unfaulted resident run's."""
    import collections
    import shutil

    from flink_siddhi_tpu_torch.runtime.faultinject import (
        CrashPlan,
        DisorderSchedule,
        DisorderSource,
        wrap_job,
    )
    from flink_siddhi_tpu_torch.runtime.sources import with_watermarks
    from flink_siddhi_tpu_torch.runtime.supervisor import Supervisor

    sup_dir = os.path.join(SMOKE_DIR, "supervised")
    shutil.rmtree(sup_dir, ignore_errors=True)
    os.makedirs(sup_dir)
    crash = CrashPlan(at_pulls=(3, 9), at_checkpoints=(2,))

    eager_cfg = fpt.EngineConfig(lazy_projection=False, pred_pushdown=True)

    def factory():
        return wrap_job(et_job(fpt, schema, et_replay(src), False,
                               eager_cfg, policy="drop"), crash)

    sup = Supervisor(factory, os.path.join(sup_dir, "ckpt"),
                     checkpoint_every_cycles=2, keep_checkpoints=3,
                     max_restarts=10, restart_window_s=3600.0)
    t0 = time.perf_counter()
    final = sup.run()
    wall = time.perf_counter() - t0
    committed = collections.Counter(sup.results_with_ts("matches"))
    oracle = collections.Counter(whole)
    dup = sum((committed - oracle).values())
    lost = sum((oracle - committed).values())
    tel = sup.telemetry.snapshot()
    if crash.crashes != 3 or dup or lost \
            or final.late_dropped != ET_LATE:
        raise AssertionError(f"E5: {crash.crashes} crashes, {dup} "
                             f"duplicate and {lost} lost rows, late_dropped "
                             f"{final.late_dropped} of {ET_LATE}")
    result = {
        "crashes": crash.crashes, "duplicate_rows": dup, "lost_rows": lost,
        "rows": sum(committed.values()), "late_dropped": final.late_dropped,
        "last_recovery_ms": sup.last_recovery_ms,
        "restore_ms": tel["histograms"]["recovery.restore_ms"],
        "checkpoints": tel["counters"]["recovery.checkpoints"],
        "events_replayed": tel["counters"].get("recovery.events_replayed",
                                               0),
        "rows_discarded": tel["counters"].get("recovery.rows_discarded", 0),
        "wall_s": wall,
    }
    # the resident drive
    short = DisorderSource(
        fpt.BatchSource("inputStream", schema,
                        iter(batches[:ET_RESIDENT_TAPES])),
        DisorderSchedule(seed=ET_SEED, skew_ms=ET_SKEW_MS), chunk=ET_CHUNK)
    rcrash = CrashPlan(at_pulls=(2,), at_checkpoints=(1,))

    def resident_job():
        return et_job(fpt, schema, et_replay(short), False)

    ref = resident_job()
    got_ref = []
    ref.add_sink("matches", lambda t, row: got_ref.append((t, row)))
    rep = fpt.ResidentReplay(ref)
    rep.stage()
    rep.run()
    ref.flush()
    del ref, rep
    rsup = Supervisor(lambda: wrap_job(resident_job(), rcrash),
                      os.path.join(sup_dir, "resident"), mode="resident",
                      max_restarts=5, restart_window_s=3600.0)
    rsup.run()
    if rcrash.crashes != 2 or sorted_rows(
            rsup.results_with_ts("matches")) != sorted_rows(got_ref) \
            or len(got_ref) < 1000:
        raise AssertionError(f"E5 resident: {rcrash.crashes} crashes, "
                             f"{len(rsup.results_with_ts('matches'))} rows, "
                             f"{len(got_ref)} unfaulted")
    result["resident"] = {"crashes": rcrash.crashes, "rows": len(got_ref),
                          "events": int(len(short.pristine))}
    shutil.rmtree(sup_dir, ignore_errors=True)
    return result


def event_time_phase(fpt, co, out_path):
    """Phase 8g: E1 to E5 (see the module docstring). The result goes to
    ``out_path``."""
    import torch

    t_phase = time.perf_counter()
    schema, batches = bench_stream(fpt, BATCH * ET_TAPES, BATCH)
    src = et_disorder(fpt, schema, batches)
    laps = {}
    t = time.perf_counter()
    e1, rows = et_headline(fpt, co, schema, batches, src)
    laps["e1_s"] = time.perf_counter() - t
    log(f"  E1: {e1['rows']} rows under disorder equal to the in-order "
        f"run's, {e1['late_events']} late rows on the side output, "
        f"{e1['events_per_s']:.4g} events/s (in order "
        f"{e1['in_order_events_per_s']:.4g}), launches {e1['launches']}")
    t = time.perf_counter()
    e2, exact = et_checkpoint(fpt, schema, src, rows)
    laps["e2_s"] = time.perf_counter() - t
    log(f"  E2: snapshot {e2['snapshot_bytes']} bytes, save "
        f"{e2['save_s']:.3f} s, restore {e2['restore_s']:.3f} s; "
        f"{e2['rows']} rows, {e2['rows_with_none']} with a lazy column "
        f"carried across the restore; lazy projection off: exact")
    t = time.perf_counter()
    e3 = et_states(fpt, co, batches)
    laps["e3_s"] = time.perf_counter() - t
    log(f"  E3: {json.dumps(e3)}")
    t = time.perf_counter()
    e4 = et_rates(fpt, co)
    laps["e4_s"] = time.perf_counter() - t
    log(f"  E4: {json.dumps(e4)}")
    t = time.perf_counter()
    e5 = et_supervised(fpt, schema, batches, src, exact)
    laps["e5_s"] = time.perf_counter() - t
    log(f"  E5: {e5['crashes']} crashes, {e5['duplicate_rows']} duplicate "
        f"and {e5['lost_rows']} lost rows, late_dropped "
        f"{e5['late_dropped']}, last_recovery_ms "
        f"{e5['last_recovery_ms']:.1f}; resident "
        f"{e5['resident']['crashes']} crashes, rows equal")
    torch.cuda.synchronize()
    out = {"E1": e1, "E2": e2, "E3": e3, "E4": e4, "E5": e5, **laps,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"event_time": out}))
    with open(out_path, "w") as f:
        json.dump(out, f)


def event_time_main(out_path):
    """Phase 8g alone (``--event-time OUT``), run by ``main`` in a child
    process."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    event_time_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


# -- phase 8h: ingestion and the deployable pipeline --------------------------

# H1: the bench stream over 1 tape (524,288; 2 tapes before phase 8k came:
# the time limit)
PIPE_EVENTS = BATCH
PIPE_PARTITIONS = 4  # H1's input topic
PIPE_RECORDS = 16_384  # records a v2 batch, round robin over the partitions
PIPE_CKPT_S = 1.0  # H1's checkpoint interval (each commits its rows)
# a fetch asks each partition for this much: one or two gzip'd batches
PIPE_FETCH_BYTES = 1 << 18
PIPE_CRASH_EVENTS = BATCH // 2  # H2: 262,144 events
PIPE_CRASH = dict(at_pulls=(2,), at_checkpoints=(2,))  # H2's kill points
PIPE_FILE_EVENTS = 2 * BATCH  # H3: the decode rate over 1,048,576 events
PIPE_CHECK_EVENTS = 65_536  # H3: rows held to the CPU path over these
PIPE_FILE_CHUNK = 64 << 20  # H3: bytes a file source reads a poll
PIPE_FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
               ("timestamp", "long")]
QUOTE_FIELDS = [("symbol", "string"), ("price", "double"),
                ("volume", "long"), ("timestamp", "long")]


def fake_kafka():
    """``tests/torch_fake_kafka.py`` (the in-process broker on the port's
    wire-format copies), imported by its path."""
    import importlib.util

    name = "torch_fake_kafka"
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_fake_kafka.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def bench_json(batches):
    """The bench stream's events as JSON record values (floats by repr:
    they decode to the same doubles)."""
    vals = []
    for b in batches:
        c = b.columns
        vals += [b'{"id":%d,"name":"test_event","price":%r,"timestamp":%d}'
                 % t for t in zip(c["id"].tolist(), c["price"].tolist(),
                                  c["timestamp"].tolist())]
    return vals


def fill_topic(broker, topic, vals):
    """``vals`` into ``topic``: v2 batches of PIPE_RECORDS records, batch
    b on partition b mod PIPE_PARTITIONS."""
    broker.create_topic(topic, partitions=PIPE_PARTITIONS)
    for b, s in enumerate(range(0, len(vals), PIPE_RECORDS)):
        broker.append(topic, b % PIPE_PARTITIONS, vals[s:s + PIPE_RECORDS])


class _Seconds:
    """Wall seconds spent inside wrapped calls, by name; a call nested in
    another of the same name counts once."""

    def __init__(self):
        self.s, self.bytes, self._depth = {}, 0, {}

    def wrap(self, name, fn, count_bytes=False):
        def timed_call(*a, **kw):
            d = self._depth.get(name, 0)
            self._depth[name] = d + 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._depth[name] = d
                if d == 0:
                    self.s[name] = (self.s.get(name, 0.0)
                                    + time.perf_counter() - t0)
                    if count_bytes:
                        self.bytes += len(a[0])
        return timed_call


def smoke_pipeline(fpt):
    """``CEPPipeline`` as a deployment drives a bounded input: each built
    job's Kafka source is closed at once (it drains the topic, then the
    job finishes), its calls are timed (``secs``: broker fetch with the
    records' decode, the native decode, the sinks' produce and commit;
    the device step by CUDA events), and ``crash`` (a CrashPlan) arms its
    kill points."""
    import torch

    from flink_siddhi_tpu_torch.runtime.faultinject import wrap_job

    class SmokePipeline(fpt.CEPPipeline):
        crash = None

        def build(self):
            job = super().build()
            self.secs, self.step_events = _Seconds(), []
            sec = self.secs
            src = job._sources[0]
            src = getattr(src, "inner", src)
            if hasattr(src, "client"):
                src.close()
                src.client.fetch = sec.wrap("fetch", src.client.fetch)
            if not src._decoder.native:
                raise AssertionError("a byte source decodes in Python")
            for m in ("decode_json", "decode_csv"):
                setattr(src._decoder, m, sec.wrap(
                    "decode", getattr(src._decoder, m), count_bytes=True))
            for sink in getattr(self, "_kafka_sinks", ()):
                for m in ("flush", "prepare_commit", "commit_transaction"):
                    setattr(sink, m, sec.wrap("produce_commit",
                                              getattr(sink, m)))
            step = job._step_plan
            cuda = job.device.type == "cuda"

            def timed_step(rt, ready):
                if not cuda:
                    return sec.wrap("device_step", step)(rt, ready)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = step(rt, ready)
                e1.record()
                self.step_events.append((e0, e1))
                return out

            job._step_plan = timed_step
            return job if self.crash is None else wrap_job(job, self.crash)

        def split(self):
            """The last built job's split: seconds by layer."""
            stages = self.job.telemetry.snapshot()["stages"]
            out = {k: self.secs.s.get(k, 0.0)
                   for k in ("fetch", "decode", "produce_commit")}
            # the Job's spans (a span inside another is kept as nested.*)
            for key, span in (("ingest", "ingest"), ("gate", "reorder"),
                              ("tape_build", "tape_build"),
                              ("sink_emit", "sink"), ("drain", "drain")):
                out[key] = sum(stages.get(k, {}).get("seconds", 0.0)
                               for k in (span, "nested." + span))
            if self.step_events:
                torch.cuda.synchronize()
                out["device_step"] = sum(
                    a.elapsed_time(b) for a, b in self.step_events) / 1e3
            else:
                out["device_step"] = self.secs.s.get("device_step", 0.0)
            return out

    return SmokePipeline


def kafka_config(fpt, bootstrap, topic, out, ckpt, interval_s, txn_id):
    """The headline from ``kafka://`` in event time (per-partition
    watermarks: each partition's records are in order, so skew 0 covers
    the interleave) into a transactional ``kafka://`` output."""
    return fpt.PipelineConfig(
        stream_id="inputStream", fields=PIPE_FIELDS, cql=HEADLINE,
        input_path=f"kafka://{bootstrap}/{topic}",
        output_path=f"kafka://{bootstrap}/{out}", ts_field="timestamp",
        batch_size=BATCH, watermark_skew_ms=0, checkpoint_path=ckpt,
        checkpoint_interval_s=interval_s, restart_attempts=4,
        restart_delay_s=0.0, transactional_id=txn_id,
        fetch_max_bytes=PIPE_FETCH_BYTES)


def in_order_rows(fpt, schema, batches, device):
    """The port's streaming Job over the same events in order (the oracle
    of phase 8g's E1, with the pipeline's default settings)."""
    from flink_siddhi_tpu_torch.runtime.sources import with_watermarks

    plan = fpt.compile_plan(HEADLINE, {"inputStream": schema})
    job = fpt.Job([plan], [with_watermarks(
        fpt.BatchSource("inputStream", schema, iter(batches)), skew_ms=0)],
        batch_size=BATCH, device=device)
    job.run()
    return [(t, tuple(float(v) if isinstance(v, float) else v for v in r))
            for t, r in job.results_with_ts("matches")]


def committed_rows(fk, broker, topic):
    """The output topic read committed (the external observer), as
    (ts, (t1, t3, price)) rows in topic order."""
    rows = []
    for v in fk.read_topic(broker.bootstrap, topic, committed=True):
        d = json.loads(v)
        if d.pop("stream") != "matches":
            raise AssertionError(f"a row of stream {d}")
        rows.append((d["ts"], (d["t1"], d["t3"], d["price"])))
    return rows


def row_account(got, want, what):
    """Fails unless ``got`` holds ``want``'s rows exactly once (as
    multisets); returns (duplicated, lost)."""
    import collections

    g, w = collections.Counter(got), collections.Counter(want)
    dup, lost = sum((g - w).values()), sum((w - g).values())
    if dup or lost or not want:
        raise AssertionError(f"{what}: {len(got)} rows committed against "
                             f"{len(want)}: {dup} duplicated, {lost} lost")
    return dup, lost


def control_markers(broker, topic):
    """The output partition's transaction markers by kind."""
    import collections

    return dict(collections.Counter(
        m["control"] for m in broker.batch_meta.get((topic, 0), ())
        if m["control"] is not None))


def pipe_kafka(fpt, co, fk, schema, batches, device, n_events, tmp):
    """H1: the headline read from a 4-partition topic through CEPPipeline
    into a transactional topic, checkpointed every PIPE_CKPT_S; its
    committed rows against the in-order Job's. Returns the result."""
    import torch

    Pipe = smoke_pipeline(fpt)
    vals = bench_json(batches)
    t0 = time.perf_counter()
    broker = fk.FakeBroker()
    try:
        fill_topic(broker, "in", vals)
        broker.create_topic("out")
        fill_s = time.perf_counter() - t0
        want = in_order_rows(fpt, schema, batches, device)
        ckpt = os.path.join(tmp, "h1.ckpt")
        pipe = Pipe(kafka_config(fpt, broker.bootstrap, "in", "out", ckpt,
                                 PIPE_CKPT_S, "h1"), device=device)
        co.reset_launches()
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = co.launch_counts()
        job = pipe.job
        split = pipe.split()
        stats = [s.txn_stats() for s in pipe._kafka_sinks]
        counters = job.metrics()["telemetry"]["counters"]
        pipe.close()
        got = committed_rows(fk, broker, "out")
        dup, lost = row_account(got, want, "H1")
        if job.processed_events != n_events or job.late_events:
            raise AssertionError(f"H1: {job.processed_events} events, "
                                 f"{job.late_events} late")
        if (not launches["multi_reverse_cummin"]
                or not launches["chain_advance"]
                or any(v for k, v in launches.items()
                       if k not in ("multi_reverse_cummin",
                                    "chain_advance"))):
            raise AssertionError(f"H1: launches {launches}")
        faults = {k: v for k, v in counters.items() if k.startswith("faults.")}
        txn_life = {k: faults.pop(k, 0) for k in ("faults.txn.begin",
                                                  "faults.txn.commit")}
        if any(faults.values()):
            raise AssertionError(f"H1: fault counters {faults}")
        markers = control_markers(broker, "out")
        if (stats[0]["pending"] or markers.get("abort")
                or markers.get("commit") != stats[0]["epoch_n"]):
            raise AssertionError(f"H1: txn_stats {stats}, markers {markers}")
        return {
            "events": n_events, "partitions": PIPE_PARTITIONS,
            "records_a_batch": PIPE_RECORDS, "tape": BATCH,
            "json_bytes": sum(map(len, vals)), "topic_fill_s": fill_s,
            "rows": len(got), "duplicated": dup, "lost": lost,
            "in_topic_order": got == sorted(got, key=lambda r: r[0]),
            "wall_s": wall, "events_per_s": n_events / wall,
            "split_s": split, "cycles": counters.get("cycles"),
            "checkpoints": markers.get("commit"), "txn_stats": stats[0],
            "faults": faults, "txn_lifecycle": txn_life,
            "launches": launches,
        }
    finally:
        broker.close()


def pipe_crashes(fpt, co, fk, schema, batches, device, h1_rows_of, tmp):
    """H2: H1's pipeline over PIPE_CRASH_EVENTS, checkpointed every cycle,
    killed at a source pull and inside a checkpoint
    (``runtime/faultinject.py``) and restarted by its restart strategy:
    the committed rows exactly once."""
    from flink_siddhi_tpu_torch.runtime.faultinject import CrashPlan

    Pipe = smoke_pipeline(fpt)
    broker = fk.FakeBroker()
    try:
        fill_topic(broker, "in", bench_json(batches))
        broker.create_topic("out")
        want = h1_rows_of(batches)
        pipe = Pipe(kafka_config(fpt, broker.bootstrap, "in", "out",
                                 os.path.join(tmp, "h2.ckpt"), 0.0, "h2"),
                    device=device, sleep=lambda s: None)
        pipe.crash = CrashPlan(**PIPE_CRASH)
        co.reset_launches()
        t0 = time.perf_counter()
        pipe.run()
        wall = time.perf_counter() - t0
        launches = co.launch_counts()
        stats = pipe._kafka_sinks[0].txn_stats()
        pipe.close()
        got = committed_rows(fk, broker, "out")
        dup, lost = row_account(got, want, "H2")
        markers = control_markers(broker, "out")
        uncommitted = len(fk.read_topic(broker.bootstrap, "out",
                                        committed=False))
        crashes = pipe.crash.crashes
        if (crashes != 2 or stats["pending"] or stats["fenced"]
                or markers.get("commit") != stats["epoch_n"]
                or not markers.get("abort") or uncommitted <= len(got)):
            raise AssertionError(f"H2: {crashes} crashes, txn_stats {stats}, "
                                 f"markers {markers}, {uncommitted} rows "
                                 f"written, {len(got)} committed")
        return {"events": sum(len(b) for b in batches), "crashes": crashes,
                "rows": len(got), "duplicated": dup, "lost": lost,
                "rows_written_uncommitted_included": uncommitted,
                "markers": markers, "txn_stats": stats, "wall_s": wall,
                "launches": launches}
    finally:
        broker.close()


def write_lines(path, lines):
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    return os.path.getsize(path)


def quote_json(fpt, batches, schema):
    table = schema.string_tables["symbol"]
    names = [table.value(i).encode() for i in range(len(table))]
    out = []
    for b in batches:
        c = b.columns
        out += [b'{"symbol":"%s","price":%r,"volume":%d,"timestamp":%d}'
                % (names[s], p, v, t) for s, p, v, t in zip(
                    c["symbol"].tolist(), c["price"].tolist(),
                    c["volume"].tolist(), b.timestamps.tolist())]
    return out


def file_run(fpt, Pipe, cfg_kw, device, out_path, keep=None):
    """One pipeline run over a file into a JSON-lines file: (its first
    ``keep`` rows as dicts (None: all), its row count, the pipeline, wall
    seconds)."""
    import torch

    if os.path.exists(out_path):
        os.remove(out_path)
    pipe = Pipe(fpt.PipelineConfig(output_path=out_path, **cfg_kw),
                device=device)
    t0 = time.perf_counter()
    pipe.run()
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pipe.close()
    with open(out_path, "rb") as f:
        lines = f.read().splitlines()
    return [json.loads(line) for line in lines[:keep]], len(lines), pipe, \
        wall


def h3_files(fpt, tmp):
    """H3's inputs, written into ``tmp`` (the same bytes in every
    process): the quote stream's first PIPE_FILE_EVENTS and first
    PIPE_CHECK_EVENTS events as JSON lines, and window_groupby's stream
    over PIPE_CHECK_EVENTS events as CSV. Returns their paths."""
    qschema, qbatches, _ = quote_stream(fpt, PIPE_FILE_EVENTS, BATCH)
    lines = quote_json(fpt, qbatches, qschema)
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("big", "quotes.jsonl"), ("small", "quotes_check.jsonl"),
        ("csv", "window.csv"))}
    write_lines(paths["big"], lines)
    write_lines(paths["small"], lines[:PIPE_CHECK_EVENTS])
    del lines, qbatches
    _, wbatches = bench_stream(fpt, PIPE_CHECK_EVENTS, BATCH,
                               n_ids=N_IDS_WINDOW)
    c = wbatches[0].columns
    write_lines(paths["csv"], [b"id,name,price,timestamp"] + [
        b"%d,test_event,%r,%d" % t for t in zip(
            c["id"].tolist(), c["price"].tolist(), c["timestamp"].tolist())])
    return paths


def h3_configs(paths):
    """(the quote board's config over the check file, window_groupby's)"""
    board = dict(stream_id="StockStream", fields=QUOTE_FIELDS,
                 cql=QUOTE_BOARD, ts_field="timestamp", batch_size=BATCH,
                 chunk_bytes=PIPE_FILE_CHUNK, input_path=paths["small"])
    window = dict(stream_id="inputStream", fields=PIPE_FIELDS,
                  cql=WINDOW_GROUPBY, input_path=paths["csv"], format="csv",
                  csv_header=True, ts_field="timestamp", batch_size=BATCH,
                  chunk_bytes=PIPE_FILE_CHUNK)
    return board, window


def h3_cpu_main(out_path):
    """H3's CPU path (``--pipeline-cpu OUT``): the quote board's and
    window_groupby's rows over the first PIPE_CHECK_EVENTS events through
    CEPPipeline on the CPU, as JSON to OUT. Phase 8h starts it first, so
    that it runs beside H1 and H2."""
    import tempfile

    import torch

    import flink_siddhi_tpu_torch as fpt

    torch.set_num_threads(4)
    Pipe = smoke_pipeline(fpt)
    os.makedirs(SMOKE_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=SMOKE_DIR) as tmp:
        board, window = h3_configs(h3_files(fpt, tmp))
        out = os.path.join(tmp, "rows.jsonl")
        rows = {"quote_board": file_run(fpt, Pipe, board, "cpu", out)[0],
                "window_groupby": file_run(fpt, Pipe, window, "cpu",
                                           out)[0]}
    with open(out_path, "w") as f:
        json.dump(rows, f)
    return 0


def pipe_files(fpt, co, device, tmp, cpu_rows):
    """H3: the quote board (K3) through CEPPipeline from a JSON-lines file
    and window_groupby from a CSV file; over the first PIPE_CHECK_EVENTS
    events the card's rows against the CPU path's (``cpu_rows()``, from
    ``h3_cpu_main``); the quote board's decode rate over
    PIPE_FILE_EVENTS events."""
    Pipe = smoke_pipeline(fpt)
    paths = h3_files(fpt, tmp)
    board, window = h3_configs(paths)
    cols = ("symbol", "symbols", "notional", "avg_price", "lo", "hi")

    def board_rows(rows):
        return [(r["ts"], tuple(r[c] for c in cols)) for r in rows]

    def window_rows(rows):
        return [(r["ts"], (r["id"], r["total"], r["cnt"])) for r in rows]

    # the card's rows of the first PIPE_CHECK_EVENTS events come from the
    # run over the whole file: a unique window's row depends on the events
    # before it only
    out = os.path.join(tmp, "rows.jsonl")
    co.reset_launches()
    card, n_rows, pipe, wall = file_run(
        fpt, Pipe, dict(board, input_path=paths["big"]), device, out,
        keep=PIPE_CHECK_EVENTS)
    launches = co.launch_counts()
    wcard, n_wrows, wpipe, wwall = file_run(fpt, Pipe, window, device, out)
    os.remove(out)
    cpu = cpu_rows()
    rel = board_err(board_rows(card), board_rows(cpu["quote_board"]),
                    "H3 quote board")
    wrel = rows_match(window_rows(wcard), window_rows(cpu["window_groupby"]),
                      WINDOW_RTOL, "H3 window_groupby")
    if (n_rows != PIPE_FILE_EVENTS
            or pipe.job.processed_events != PIPE_FILE_EVENTS
            or n_wrows != PIPE_CHECK_EVENTS):
        raise AssertionError(f"H3: {n_rows} rows of {PIPE_FILE_EVENTS}, "
                             f"window_groupby {n_wrows}")
    if device != "cpu" and not launches["unique_window_fold"]:
        raise AssertionError(f"H3: launches {launches}")
    split = pipe.split()
    big_bytes = os.path.getsize(paths["big"])
    return {"quote_board": {
        "events": PIPE_FILE_EVENTS, "file_bytes": big_bytes,
        "rows": n_rows, "cpu_check_events": PIPE_CHECK_EVENTS,
        "cpu_check_rows": len(card), "cpu_check_max_rel": rel,
        "wall_s": wall, "events_per_s": PIPE_FILE_EVENTS / wall,
        "decode_s": split["decode"],
        "decode_mb_per_s": pipe.secs.bytes / split["decode"] / 1e6,
        "split_s": split, "launches": launches,
    }, "window_groupby": {
        "events": PIPE_CHECK_EVENTS, "rows": len(wcard),
        "cpu_check_max_rel": wrel, "wall_s": wwall,
        "decode_mb_per_s": wpipe.secs.bytes / wpipe.secs.s["decode"] / 1e6}}


def pipeline_phase(fpt, co, out_path, device="cuda"):
    """Phase 8h: H0 to H3 (see the module docstring). The result goes to
    ``out_path``."""
    from flink_siddhi_tpu_torch import native

    t_phase = time.perf_counter()
    build_s = native.build()
    if not native.available():
        raise AssertionError("H0: the native decoder did not build or load")
    log(f"  H0: native decoder built in {build_s:.2f} s into "
        f"{native.library_path()}")
    fk = fake_kafka()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    # H3's CPU path in a process of its own, beside H1 and H2
    cpu_path = os.path.join(SMOKE_DIR, "pipeline_cpu.json")
    cpu_proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--pipeline-cpu", cpu_path])

    def cpu_rows():
        if cpu_proc.wait(timeout=600) != 0:
            raise AssertionError(f"H3's CPU path failed "
                                 f"({cpu_proc.returncode})")
        with open(cpu_path) as f:
            return json.load(f)

    schema, batches = bench_stream(fpt, PIPE_EVENTS, BATCH)
    laps = {}
    try:
        pipe_runs(fpt, co, fk, schema, batches, device, cpu_rows, laps)
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()
    out = {"H0": {"build_s": build_s, "library": native.library_path()},
           **laps, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"pipeline": out}))
    with open(out_path, "w") as f:
        json.dump(out, f)


def pipe_runs(fpt, co, fk, schema, batches, device, cpu_rows, laps):
    """H1 to H3 into ``laps`` (with each one's seconds)."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=SMOKE_DIR) as tmp:
        t = time.perf_counter()
        h1 = pipe_kafka(fpt, co, fk, schema, batches, device, PIPE_EVENTS,
                        tmp)
        laps["h1_s"] = time.perf_counter() - t
        log(f"  H1: {h1['rows']} rows committed, equal to the in-order "
            f"Job's; {h1['events_per_s']:.4g} events/s end to end; split "
            f"{json.dumps(h1['split_s'])}; launches {h1['launches']}")
        t = time.perf_counter()
        crash_batches = [b.slice(0, PIPE_CRASH_EVENTS) for b in batches[:1]]
        h2 = pipe_crashes(fpt, co, fk, schema, crash_batches, device,
                          lambda bs: in_order_rows(fpt, schema, bs, device),
                          tmp)
        laps["h2_s"] = time.perf_counter() - t
        log(f"  H2: {h2['crashes']} crashes, {h2['rows']} rows committed, "
            f"{h2['duplicated']} duplicated, {h2['lost']} lost; "
            f"markers {h2['markers']}; txn_stats {h2['txn_stats']}")
        del batches, crash_batches
        t = time.perf_counter()
        h3 = pipe_files(fpt, co, device, tmp, cpu_rows)
        laps["h3_s"] = time.perf_counter() - t
        log(f"  H3: {json.dumps(h3)}")
    laps.update(H1=h1, H2=h2, H3=h3)


def pipeline_main(out_path):
    """Phase 8h alone (``--pipeline OUT``), run by ``main`` in a child
    process."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    pipeline_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


# -- phase 6: the quote board (#window.unique aggregation) -------------------

def quote_stream(fpt, n_events, batch, seed=11):
    """Siddhi's StockStream (symbol string, price double, volume long):
    10,000 symbols "S00000".."S09999" drawn with Zipf rank weights (s = 1),
    price uniform in [1, 500) to the cent, volume an integer in [1, 10,000],
    timestamp 1000 + i ms; numpy, from ``seed``."""
    schema = fpt.StreamSchema([("symbol", "string"), ("price", "double"),
                               ("volume", "long")])
    table = schema.string_tables["symbol"]
    codes = np.array([table.intern(f"S{i:05d}") for i in range(N_SYMBOLS)],
                     np.int32)
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, N_SYMBOLS + 1)
    sym = rng.choice(N_SYMBOLS, size=n_events, p=w / w.sum())
    price = np.round(rng.uniform(1.0, 500.0, n_events), 2)
    volume = rng.integers(1, 10_001, n_events)
    ts = 1000 + np.arange(n_events, dtype=np.int64)
    out = []
    for start in range(0, n_events, batch):
        sl = slice(start, start + batch)
        out.append(fpt.EventBatch(
            "StockStream", schema,
            {"symbol": codes[sym[sl]], "price": price[sl],
             "volume": volume[sl]}, ts[sl],
        ))
    return schema, out, len(np.unique(sym))


def board_err(got, ref, what):
    """Quote-board rows: timestamps, symbol, count, lo and hi exact;
    notional and avg_price within FOLD_RTOL. Returns the max relative
    error of those two."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} rows, expected {len(ref)}")
    if [t for t, _ in got] != [t for t, _ in ref]:
        raise AssertionError(f"{what}: timestamps differ")
    for i in (0, 1, 4, 5):
        if [r[i] for _, r in got] != [r[i] for _, r in ref]:
            raise AssertionError(f"{what}: column {i} differs")
    rel = 0.0
    for i in (2, 3):
        g = np.array([r[i] for _, r in got])
        r = np.array([r[i] for _, r in ref])
        if not np.allclose(g, r, rtol=FOLD_RTOL, atol=0):
            raise AssertionError(f"{what}: column {i} beyond rtol")
        rel = max(rel, float(np.max(np.abs(g - r) / np.abs(r))))
    return rel


def quote_board(fpt, co):
    import torch

    n_events = QUOTE_BATCHES * BATCH
    schema, batches, n_keys = quote_stream(fpt, n_events, BATCH)
    check = [batches[0].slice(0, QUOTE_CHECK_EVENTS)]
    kw = dict(stream="StockStream", out="Board")
    cpu_rows, cpu_s, _ = run_job(fpt, QUOTE_BOARD, schema, check, "cpu", **kw)
    warm_rows, _, _ = run_job(fpt, QUOTE_BOARD, schema, check, "cuda", **kw)
    board_err(warm_rows, cpu_rows, "quote board warm-up vs CPU")
    torch.cuda.reset_peak_memory_stats()
    co.reset_launches()
    rows, wall, job = run_job(fpt, QUOTE_BOARD, schema, batches, "cuda",
                              **kw)
    launches = co.launch_counts()
    rel = board_err(rows[:QUOTE_CHECK_EVENTS], cpu_rows,
                    f"quote board: rows of the first {QUOTE_CHECK_EVENTS} "
                    "events vs the CPU path")
    if len(rows) != n_events or job.processed_events != n_events:
        raise AssertionError("quote board: one row per event expected")
    if rows[-1][1][1] != n_keys:
        raise AssertionError("quote board: final count is not the number "
                             "of distinct symbols")
    if launches != dict.fromkeys(launches, 0) | {
            "unique_window_fold": QUOTE_BATCHES}:
        raise AssertionError(
            f"quote board: launches {launches}, expected the unique fold "
            f"once per micro-batch ({QUOTE_BATCHES})"
        )
    drains = drain_accounts(job, "quote board")
    state = job._plans["bench"].states["query_0"]
    slots = int(state["valid"].shape[0])
    bucket = 128
    while bucket < n_keys:
        bucket *= 2
    if slots != bucket or int(state["valid"].sum()) != n_keys:
        raise AssertionError(
            f"quote board: a table of {slots} slots for {n_keys} symbols"
        )
    peak = torch.cuda.max_memory_allocated()
    n_rows = len(rows)
    del job
    # fused streaming: segments of the unique fold's steps, one graph
    # replay each (the table grows, and its graphs are captured again, in
    # the row check and the warm run); its rows over the first
    # QUOTE_ROW_BATCHES micro-batches held to the eager run's
    fused, frel = fused_segment(
        fpt, co, "quote_board", QUOTE_BOARD, schema, batches,
        outs=("Board",), config=None, cpu_rows={"Board": cpu_rows},
        cpu_ts=int(check[-1].timestamps[-1]),
        eager_rows={"Board": rows[:QUOTE_ROW_BATCHES * BATCH]},
        rtol=FOLD_RTOL, stream="StockStream",
        expect_launches=("unique_window_fold",),
        row_batches=QUOTE_ROW_BATCHES,
    )
    del rows
    result = {
        "path": "quote_board",
        "events": n_events,
        "batch": BATCH,
        "rows": n_rows,
        "symbols": n_keys,
        "table_slots": slots,
        "fold_kernel_launches_per_call":
            co.unique_window_fold.kernel_launches,
        "fold_scratch_bytes": co.unique_window_fold.scratch_bytes,
        "wall_s": wall,
        "events_per_s": n_events / wall,
        "max_memory_allocated_bytes": peak,
        **drains,
        "launches": launches,
        "cpu_check_events": QUOTE_CHECK_EVENTS,
        "cpu_check_rows": len(cpu_rows),
        "cpu_check_s": cpu_s,
        "cpu_check_max_rel_err": max(rel, frel),
        "fused_streaming": fused,
    }
    log(json.dumps(result))
    return result, schema, batches


def keep_copy(a, device=None):
    """A copy of a kernel argument (on ``device``, else on its own); a
    tensor keeps its strides (the padded next-match table's rows stay
    16-byte aligned)."""
    import torch

    if not isinstance(a, torch.Tensor):
        return a
    return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                               device=device or a.device).copy_(a)


class Recorder:
    """Forwards to a kernel wrapper and keeps a copy of the inputs of its
    ``keep``-th call (the main path's real inputs for phase 9)."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls = fn, keep, 0
        self.args, self.kwargs = None, {}

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls == self.keep:
            self.args = tuple(keep_copy(a) for a in args)
            self.kwargs = dict(kwargs)
        return self.fn(*args, **kwargs)


def full_width_inputs(fpt, co, nfa, schema, batches, keep=3):
    """The chain kernels' inputs at full width: the headline's own tapes
    (E = 524,288 events) stepped through ChainPatternArtifact.step with
    relevance compaction off, recorded at the ``keep``-th step (a pool
    carried from the steps before)."""
    import torch

    dev = torch.device("cuda")
    plan = fpt.compile_plan(HEADLINE, {"inputStream": schema},
                            plan_id="bench")
    epoch = int(batches[0].timestamps.min())
    rec_k1 = Recorder(co.multi_reverse_cummin, keep=keep)
    rec_k2 = Recorder(co.chain_advance, keep=keep)
    saved = nfa._COMPACT_MIN_E
    nfa.multi_reverse_cummin, nfa.chain_advance = rec_k1, rec_k2
    nfa._COMPACT_MIN_E = BATCH + 1
    try:
        states, acc = plan.init_state(dev), plan.init_acc(dev)
        for tape in stage_wire_tapes(plan, batches[:keep], epoch, dev):
            states = plan.grow_state(states)
            states, acc = plan.step_acc(states, acc, tape)
        torch.cuda.synchronize()
    finally:
        nfa._COMPACT_MIN_E = saved
        nfa.multi_reverse_cummin = co.multi_reverse_cummin
        nfa.chain_advance = co.chain_advance
    if rec_k1.args is None or rec_k2.args is None:
        raise AssertionError("no full-width kernel inputs recorded")
    if int(rec_k2.args[3].shape[0]) - 1 != BATCH:
        raise AssertionError("the full-width step ran compacted")
    return rec_k1, rec_k2


# -- phase 9: kernel timing on main-path inputs -------------------------------

def bound_of(nbytes, ops, ops_per_s):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def reverse_cummin_times(co, x, pad):
    """Device and call ms of the kernel, its plain version and the library
    call, and the bound, on one input."""
    import torch

    C, E = (int(s) for s in x.shape)
    ms, call_ms = timed(rotating(
        lambda x: co.multi_reverse_cummin(x, pad=pad), (x,)))
    plain_ms, plain_call_ms = timed(rotating(
        lambda x: co.reverse_cummin_plain(x, pad), (x,)))
    # the one PyTorch call computing the same function (without the pad
    # column): cummin of the flipped rows
    lib_ms, _ = timed(rotating(
        lambda x: torch.flip(torch.cummin(torch.flip(x, [-1]), -1).values,
                             [-1]), (x,)))
    # read each input once, write each output once (the pad column too)
    nbytes = C * E * 4 + C * (E + (pad is not None)) * 4
    bound_ms, bound_by = bound_of(nbytes, C * E, INT32_OPS_PER_S)
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "plain_call_ms": plain_call_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "shape": [C, E],
            "pad": pad}


def time_reverse_cummin(co, rec, rec_full, launches, err, floor_ms):
    """The reverse cummin on the main path's input and at full width, with
    its kernel launches per call counted on the card at both (must be 1)."""
    k = co.multi_reverse_cummin
    main = reverse_cummin_times(co, rec.args[0], rec.kwargs.get("pad"))
    full = reverse_cummin_times(co, rec_full.args[0],
                                rec_full.kwargs.get("pad"))
    for r, t in ((rec, main), (rec_full, full)):
        t["kernel_launches_per_call"] = launches_per_call(
            lambda: k(r.args[0], **r.kwargs), "suffix_min_kernel"
        )
        if t["kernel_launches_per_call"] != 1:
            raise AssertionError(f"reverse_cummin: "
                                 f"{t['kernel_launches_per_call']} kernel "
                                 f"launches a call at {t['shape']}")
    return {
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": "flink_siddhi_tpu/compiler/pallas_ops.py:65",
        "launches": launches, "max_abs_err": err,
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "call_ms",
                                      "plain_call_ms", "shape", "pad",
                                      "kernel_launches_per_call")},
        "kernel_launches_by": "profiler trace of 25 calls",
        "floor_ms": floor_ms,
        "tile": co.CUMMIN_TILE,
        "full_width": full,
    }


def chain_work(args):
    """(bytes, gathers) of the advance on THESE inputs (one query, or a
    stack's Q): the candidate rows streamed in and out, plus one 4-byte
    read per gather that a live candidate issues (table and ts reads,
    capped at their sizes); candidates not at step k issue no gather at
    step k."""
    import torch

    nxt, pos_rows, guard_rows, ts_pad, act, step, pos, start, within = args
    if act.dim() == 1:
        ts_pad, act, step, pos, start = (
            t.unsqueeze(0) for t in (ts_pad, act, step, pos, start)
        )
    Q, V = (int(x) for x in act.shape)
    E = int(ts_pad.shape[1]) - 1
    tables = nxt.view(Q, -1, E + 1)
    w = within.unsqueeze(1) if isinstance(within, torch.Tensor) else within
    n_steps = len(pos_rows)
    gathers = 0
    a, s, p = act, step, pos
    for k in range(1, n_steps + 1):
        at_k = a & (s == k)
        idx = p.clamp(0, E).long()
        gathers += (1 + len(guard_rows[k - 1])) * int(at_k.sum())
        j = torch.take_along_dim(tables[:, pos_rows[k - 1]], idx, 1)
        found = at_k & (j < E)
        for g in guard_rows[k - 1]:
            jg = torch.take_along_dim(tables[:, g], idx, 1)
            bad = at_k & (jg <= j) & (jg < E)
            a = a & ~bad
            found = found & ~bad
        if within is not None:
            gathers += int(found.sum())  # ts[j]
            ok = (torch.take_along_dim(ts_pad, j.long(), 1) - start) <= w
            a = a & ~(found & ~ok)
            found = found & ok
        s = torch.where(found, k + 1, s)
        p = torch.where(found, j + 1, p)
    # act 1 B + step/pos/start 12 B in; act 1 B + step/pos 8 B + jmat out
    streamed = Q * V * (13 + 9 + n_steps * 4)
    if isinstance(within, torch.Tensor):
        streamed += Q * 4
    table_bytes = (int(nxt.shape[0]) + Q) * (E + 1) * 4
    return streamed + min(table_bytes, 4 * gathers), gathers


def chain_advance_times(co, args):
    """Device and call ms of the kernel and its plain version, the bound
    and the kernel launches per call (counted on the card), on one
    input."""
    nxt, pos_rows, guard_rows, ts_pad, act, step, pos, start, within = args
    ms, call_ms = timed(rotating(co.chain_advance, args))
    plain_ms, plain_call_ms = timed(rotating(co.chain_advance_plain, args))
    nbytes, gathers = chain_work(args)
    bound_ms, bound_by = bound_of(nbytes, gathers * 4,  # compares/selects
                                  INT32_OPS_PER_S)
    per_call = launches_per_call(lambda: co.chain_advance(*args),
                                 "chain_advance_kernel")
    if per_call != 1:
        raise AssertionError(f"chain_advance: {per_call} kernel launches a "
                             f"call")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "plain_call_ms": plain_call_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_launches_per_call": per_call,
            "shape": {"Q": int(act.shape[0]) if act.dim() == 2 else 1,
                      "rows": int(nxt.shape[0]),
                      "row_stride": int(nxt.stride(0)),
                      "E": int(ts_pad.shape[-1]) - 1,
                      "V": int(act.shape[-1]), "K": len(pos_rows) + 1,
                      "gathers": gathers}}


def time_chain_advance(co, rec, rec_full, launches, err, floor_ms):
    """The chain advance on the main path's input and at full width."""
    k = co.chain_advance
    main = chain_advance_times(co, rec.args)
    full = chain_advance_times(co, rec_full.args)
    return {
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": "flink_siddhi_tpu/compiler/pallas_ops.py:297",
        "launches": launches, "max_abs_err": err,
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "call_ms",
                                      "plain_call_ms",
                                      "kernel_launches_per_call", "shape")},
        "kernel_launches_by": "profiler trace of 25 calls",
        "floor_ms": floor_ms,
        "full_width": full,
    }


# the unique fold's stage kernels (csrc/unique_fold.cu), by name
FOLD_STAGES = ("init_kernel", "radix_hist", "scan_reduce", "scan_mid",
               "scan_apply", "radix_scatter", "neighbours", "table_kernel",
               "delta_kernel", "interval_kernel", "rows_kernel")


def fold_stage_ms(fn, runs, launches_per_call, attempts=3):
    """Device ms per call of each stage kernel in a trace of ``runs``
    calls (``kernel_records``; None for a stage the trace does not hold). A
    trace that holds another number of kernel records than ``runs`` x
    ``launches_per_call`` is taken again, up to ``attempts`` times, since a
    dropped record would lower a stage's time unseen; then every stage is
    None."""
    for _ in range(attempts):
        us = {stage: 0.0 for stage in FOLD_STAGES}
        n = {stage: 0 for stage in FOLD_STAGES}
        for name, (count, t) in kernel_records(fn, runs).items():
            for stage in FOLD_STAGES:
                if f"{stage}(" in name or name.endswith(stage):
                    us[stage] += t
                    n[stage] += count
        if sum(n.values()) == runs * launches_per_call:
            return {stage: us[stage] / runs / 1e3 if n[stage] else None
                    for stage in FOLD_STAGES}
        print(f"  unique_window_fold trace: {sum(n.values())} stage records,"
              f" expected {runs * launches_per_call}")
    print("  unique_window_fold stage times not kept")
    return {stage: None for stage in FOLD_STAGES}


def time_unique_fold(co, args, launches, err, rel, floor_ms):
    import math

    mask, codes, vals, valid0, bufs0, slots = args[:6]
    runs = 25
    ms, call_ms = timed_back_to_back(lambda: co.unique_window_fold(*args),
                                     runs=runs)
    stages = fold_stage_ms(lambda: co.unique_window_fold(*args), runs,
                           co.unique_window_fold.kernel_launches)
    plain_ms, plain_call_ms = timed_back_to_back(
        lambda: co.unique_window_fold_plain(*args), runs=2
    )
    E, C, A, S = (int(mask.shape[0]), int(valid0.shape[0]),
                  int(vals.shape[0]), len(slots))
    # read mask 1 B + code 4 B + A values per event and both tables once,
    # write S rows and the new tables once
    nbytes = E * (1 + 4 + 4 * A) + S * E * 4 + 2 * (C + 4 * A * C)
    # the least exact in-order work: one leaf update and log2(C) combines
    # of a segment tree per event and statistic
    n_stats = co._fold_plan(slots)[1]
    ops = E * n_stats * max(1, math.ceil(math.log2(C)))
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    traced = [v for v in stages.values() if v is not None]
    return {
        "name": co.unique_window_fold.name, "route": "cuda",
        "source": co.unique_window_fold.source,
        "replaces": "flink_siddhi_tpu/compiler/pallas_ops.py:539",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / F32_OPS_PER_S else "operations",
        "library_ms": None, "call_ms": call_ms,
        "plain_call_ms": plain_call_ms,
        "max_rel_err": rel,
        "floor_ms": floor_ms,
        "ms_by": f"cuda events over {runs} back-to-back calls",
        "kernel_launches_per_call": co.unique_window_fold.kernel_launches,
        "scratch_bytes": co.unique_window_fold.scratch_bytes,
        "stage_device_ms": stages,
        "stage_device_ms_sum": sum(traced) if traced else None,
        "shape": {"E": E, "C": C, "A": A, "S": S, "stats": n_stats,
                  "active_events": int(mask.sum())},
    }


def slot_scan_work(args):
    """(bytes, events visited) of one scan call on THESE inputs: each event
    it visits read once (ts, valid, both masks, the columns, the index
    entry), the state read and written once, and the emission buffer it
    returns written once."""
    plan, state, _scal, ts, _valid, _m, _me, _cols, idx, cnt = args
    E = int(ts.shape[0])
    n = int(cnt[0]) if cnt is not None else E
    per_event = 13 + 4 * plan.n_cols + (4 if idx is not None else 0)
    nbytes = (n * per_event + 2 * state.numel() * 4 + 7 * 4
              + plan.buf_rows * (E + plan.slots) * 4)
    return nbytes, n


def slot_scan_times(co, args, floor_ms):
    """K4 on one recorded input: its time a call (CUDA events around
    back-to-back calls: the kernel and its buffer's zero fill) and a
    single call's, per visited event, its byte bound, its old serial floor
    (the events' count of empty block barrier rounds in a block of the
    pool's width, as the first port's one thread a slot took) and its warp
    floor (as many empty `__syncwarp` + `__shfl_sync` rounds in one warp,
    the one-warp pool's), each measured the same way."""
    plan = args[0]
    fn = rotating(lambda *a: co.slot_nfa_scan(*a), args)
    # a call lasts tens of ms to a second: CUDA events around
    # back-to-back calls (a call's kernel and its buffer's zero fill)
    ms, call_ms = timed_back_to_back(fn, SLOT_TIMED_RUNS)
    nbytes, n = slot_scan_work(args)
    bound_ms, bound_by = bound_of(nbytes, n * plan.slots, INT32_OPS_PER_S)
    serial_ms, _ = timed_back_to_back(
        lambda: co.launch_barrier_rounds(n, min(plan.slots, 1024)),
        SLOT_TIMED_RUNS)
    warp_ms, _ = timed_back_to_back(lambda: co.launch_warp_rounds(n),
                                    SLOT_TIMED_RUNS)
    return {"ms": ms, "call_ms": call_ms,
            "events_visited": n, "events": int(args[3].shape[0]),
            "per_event_us": ms * 1e3 / max(n, 1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "serial_floor_ms": serial_ms, "warp_floor_ms": warp_ms,
            "floor_ms": floor_ms, "slots": plan.slots, "bytes": nbytes}


def time_slot_nfa(co, recorded, launches, floor_ms):
    """K4 on each slot query's recorded main-path input (held exactly to
    its plain version, on CPU copies, for the quantified query, whose
    plain time is the one reported), with the quantified query's numbers
    in the kernels' line and every query's beside them."""
    import torch

    queries = {}
    for name, args in recorded.items():
        args = tuple(a.to("cuda") if isinstance(a, torch.Tensor) else a
                     for a in args)
        queries[name] = slot_scan_times(co, args, floor_ms)
    args = recorded["quantified"]
    got = co.slot_nfa_scan(*(a.to("cuda") if isinstance(a, torch.Tensor)
                             else a for a in args))
    t0 = time.perf_counter()
    ref = co.slot_nfa_scan_plain(*args)
    plain_s = time.perf_counter() - t0
    err = 0
    for g, r, what in zip(got, ref, ("state", "scalars", "buffer")):
        err = max(err, same(g.cpu(), r, f"slot_nfa_scan main-path {what}"))
    main = queries["quantified"]
    entry = {
        "name": co.slot_nfa_scan.name, "route": "cuda",
        "source": co.slot_nfa_scan.source,
        "replaces": "flink_siddhi_tpu/compiler/nfa.py:3107 (no Pallas "
                    "counterpart: the reference's lax.scan)",
        "launches": launches, "max_abs_err": err,
        **{k: main[k] for k in ("ms", "call_ms", "bound_ms",
                                "bound_by", "serial_floor_ms",
                                "warp_floor_ms", "per_event_us",
                                "events_visited")},
        "plain_ms": plain_s * 1e3,
        "plain_device": "cpu",
        "library_ms": None,
        "floor_ms": floor_ms,
        "queries": queries,
    }
    for name, q in queries.items():
        log(f"  slot_nfa_scan {name}: {q['ms']} ms a call on the card "
            f"({q['call_ms']} ms single), {q['events_visited']} "
            f"events visited, {q['per_event_us']} us a visited event, "
            f"serial floor {q['serial_floor_ms']} ms, warp floor "
            f"{q['warp_floor_ms']} ms, bound {q['bound_ms']} ms")
    return entry


def join_pairs_work(args, visits, n):
    """(bytes, operations) of one K5 call on THESE inputs: every input
    the pairs need read once (each direction's arriving mask and program
    columns, its b-counts, the other side's combined ts, valid flags and
    program columns, its tape positions only for a self-join, the tape's
    ts), the ``n`` pairs it emits written once (three int32 words each,
    and n); per candidate the walk visited, its checks (valid, self-join,
    window, within: 4) and its program's words. The wrapper's zero fill of
    the ranks past n is not the function's work: ``time_join_pairs``
    reports its bytes apart."""
    dirs, ts, cap, self_join = args[0], args[1], args[2], args[3]
    E = int(ts.shape[0])
    nbytes = 4 * E + 3 * 4 * min(n, cap) + 4
    for d in dirs:
        Nb = int(d.b_ts.shape[0])
        nbytes += E + 4 * E * (int(d.a_cols.shape[0]) + 1)
        nbytes += Nb * (4 + 1 + 4 * int(d.b_cols.shape[0])) + 4
        if self_join:
            nbytes += 4 * Nb
    per = 4 + max(len(d.prog) for d in dirs)
    return nbytes, visits * per


def late_event(args, device="cuda"):
    """A copy of one K5 call's arguments with one event of the time
    window's combined buffer moved out of order: the batch entry in the
    middle stamped ten windows late. Returns (args, the entry, its new
    ts)."""
    args = join_args_copy(args, device)
    for d in args[0]:
        if d.mode_time:
            j = d.C + int(d.b_valid[d.C:].sum()) // 2
            ts_j = int(d.b_ts[j]) - 10 * d.span
            d.b_ts[j] = ts_j
            return args, j, ts_j
    raise AssertionError("late_event: no time window in the call")


def late_witness(co, inorder, late, j):
    """K5 on a late-event step held exactly, at full width, to a witness
    that costs E x 1 mask cells where the dense plain version costs E x
    Nb (10.3 s a call at J1's step): a pair-mask cell depends on its row
    and its buffer entry alone, so moving entry ``j`` of the time window's
    direction changes that direction's column ``j`` only. The late step's
    (i, j, segment, n) are the in-order step's (``inorder``, the kernel's
    output that ``join_check`` held to the plain version) with column
    ``j`` taken from the plain mask over that one column and the
    direction's outer rows derived again, in the plain version's order:
    by segment, then i, then j. Returns the late step's n."""
    import torch

    dirs, ts, cap, self_join, within = late
    di = next(k for k, d in enumerate(dirs) if d.mode_time)
    d = dirs[di]
    n0 = int(inorder[3][0])
    if n0 > cap:
        raise AssertionError(f"late witness: {n0} pairs pass the cap {cap}")
    i0, j0, s0 = (x[:n0].long() for x in inorder[:3])
    one = dataclasses.replace(
        d, b_ts=d.b_ts[j:j + 1], b_valid=d.b_valid[j:j + 1],
        b_posid=d.b_posid[j:j + 1], b_cols=d.b_cols[:, j:j + 1],
        b_seen=d.b_seen + j)
    E = int(ts.shape[0])
    col = co._join_member(one, ts, torch.arange(E, device=ts.device),
                          self_join, within)[:, 0]
    pairs = s0 == 2 * di
    keep = ~(pairs & (j0 == j)) & (s0 != 2 * di + 1)
    new_i = torch.nonzero(col)[:, 0]
    parts = [(i0[keep], j0[keep], s0[keep]),
             (new_i, torch.full_like(new_i, j),
              torch.full_like(new_i, 2 * di))]
    if d.outer:
        hit = col.clone()
        hit[i0[pairs & (j0 != j)]] = True
        oi = torch.nonzero(d.a_mask & ~hit)[:, 0]
        parts.append((oi, torch.zeros_like(oi),
                      torch.full_like(oi, 2 * di + 1)))
    i1, j1, s1 = (torch.cat(p) for p in zip(*parts))
    n1 = int(i1.shape[0])
    if n1 > cap:
        raise AssertionError(f"late witness: {n1} pairs pass the cap {cap}")
    nb = max(int(x.b_ts.shape[0]) for x in dirs)
    order = torch.argsort((s1 * E + i1) * nb + j1)
    got = co.join_pairs(*late)
    for g, w, part in zip(got, (i1, j1, s1), ("i", "j", "segment")):
        want = torch.zeros(cap, dtype=torch.int32, device=ts.device)
        want[:n1] = w[order].to(torch.int32)
        same(g, want, f"join_pairs late-event step against its witness: "
                      f"{part}")
    if int(got[3][0]) != n1:
        raise AssertionError(f"join_pairs late-event step: n "
                             f"{int(got[3][0])} against the witness's {n1}")
    return n1


def time_join_pairs(co, recorded, launches, err, floor_ms):
    """K5 on J1's third step's recorded input: held exactly (every rank
    below cap, and n) to its plain version run on the card on the same
    input (the dense pair mask in chunks; its time is the plain time);
    timed (CUDA events around back-to-back calls); the candidates in the
    arriving events' bands (the kernel's counter), ns per candidate, the
    tiles walked again, its bound. Then the same with one event of the
    time window moved out of order (``late_event``): its time, pairs and
    visits beside the in-order step's, held exactly to ``late_witness``
    (the dense plain version on the card, 10.3 s a call, left out for the
    time limit)."""
    args = join_args_copy(recorded, "cuda")
    n, _, e, plain_ms = join_check(co, *args, "J1's third step",
                                   on_card=True)
    err = max(err, e)
    ms, call_ms = timed_back_to_back(lambda: co.join_pairs(*args), 20)
    visits, rewalks = join_counts(co, *args)
    nbytes, ops = join_pairs_work(args, visits, n)
    bound_ms, bound_by = bound_of(nbytes, ops, INT32_OPS_PER_S)
    late, j, ts_j = late_event(recorded)
    late_n = late_witness(co, co.join_pairs(*args), late, j)
    late_ms, _ = timed_back_to_back(lambda: co.join_pairs(*late), 20)
    late_visits, late_rewalks = join_counts(co, *late)
    E, cap = int(args[1].shape[0]), int(args[2])
    entry = {
        "name": co.join_pairs.name, "route": "cuda",
        "source": co.join_pairs.source,
        "replaces": "flink_siddhi_tpu/compiler/join.py:335 (no Pallas "
                    "counterpart: the reference's dense pair mask and "
                    "argsort, JoinArtifact._direction and step :310)",
        "launches": launches, "max_abs_err": err,
        "max_abs_err_by": "exact comparison with the plain version on "
                          "J1's third step (on the card) and phase 3's "
                          "cases; its late-event step exact against "
                          "late_witness",
        "ms": ms, "call_ms": call_ms,
        "plain_ms": plain_ms, "plain_device": "cuda",
        "plain_shape": f"J1's third step (E = {E}), mask chunks of "
                       f"{JOIN_PLAIN_CARD_CELLS} cells",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "floor_ms": floor_ms,
        "events": E, "pairs": n, "cap": cap,
        "candidates_visited": visits,
        "ns_per_visited_candidate": ms * 1e6 / max(visits, 1),
        "tiles": 2 * -(-E // co.JOIN_TILE), "rewalked_tiles": rewalks,
        "bytes": nbytes, "operations": ops,
        "zero_fill_bytes": 3 * 4 * cap,
        "late_event": {"entry": j, "ts": ts_j, "ms": late_ms,
                       "pairs": late_n, "candidates_visited": late_visits,
                       "rewalked_tiles": late_rewalks},
    }
    log(f"  join_pairs on J1's third step: {ms} ms a call ({call_ms} ms "
        f"single), {n} pairs of {E} events, {visits} candidates visited, "
        f"{entry['ns_per_visited_candidate']} ns each, {rewalks} of "
        f"{entry['tiles']} tiles walked again; bound {bound_ms} ms "
        f"({bound_by}); {launches} launches in the J1 run; exact against "
        f"the plain version on the card ({plain_ms} ms); one event ten "
        f"windows late: {late_ms} ms, {late_n} pairs (exact against its "
        f"witness), {late_visits} candidates visited, {late_rewalks} "
        f"tiles walked again")
    return entry


def mutate_work(co, args, last):
    """(bytes, operations, candidates) of one K6 call on THESE inputs: the
    mask and the valid flags read once, the program's event words of the
    masked events only (no other event can match), the table's words, and
    ``last`` written once; the candidates the rows need
    (per valid row, the query's events from its last match to the tape's
    end, all of them for a row with no match: what a walk that stops at
    the match must visit), one key comparison each, or the program's
    words each when it has no key."""
    import torch

    mask, a_cols, valid, b_cols, prog, _depth = args
    E, C = int(mask.shape[0]), int(valid.shape[0])
    total = int(mask.sum())
    nbytes = (E + 4 * total * int(a_cols.shape[0]) + C
              + 4 * C * int(b_cols.shape[0]) + 4 * C)
    after = torch.cumsum(mask.flip(0).long(), 0).flip(0)  # events at >= i
    need = torch.where(last >= 0, after[torch.clamp(last, min=0).long()],
                       total)
    needed = int(need[valid].sum())
    per = 1 if co.join_key_hint(prog) != (-1, -1) else max(len(prog), 1)
    return nbytes, needed * per, needed


def time_table_mutate(co, recorded, launches, floor_ms,
                      what="the tables path's third step"):
    """K6 on the tables path's third step (phase 8d's recorded update and
    delete calls): held exactly to its plain version run on the card on
    the same input; timed (CUDA events around back-to-back calls); the
    candidates it walked, those the rows need (``mutate_work``) and E x C;
    its bound from this input's bytes and needed candidates, and the bound
    at E x C candidates. Returns the kernels-line entry (the update's
    numbers; the delete's under "delete")."""
    out = {}
    for name in ("update", "delete"):
        args = args_copy(recorded[name], "cuda")
        last, visits, plain_ms = mutate_check(
            co, args, f"{what}, {name}", on_card=True)
        ms, call_ms = timed_back_to_back(lambda: co.table_mutate(*args), 20)
        nbytes, ops, needed = mutate_work(co, args, last)
        bound_ms, bound_by = bound_of(nbytes, ops, INT32_OPS_PER_S)
        E, C = int(args[0].shape[0]), int(args[2].shape[0])
        out[name] = {
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_all_candidates": max(
                nbytes / HBM_BYTES_PER_S, E * C / INT32_OPS_PER_S) * 1e3,
            "events": E, "rows": C, "events_masked": int(args[0].sum()),
            "rows_valid": int(args[2].sum()),
            "rows_matched": int((last >= 0).sum()),
            "candidates_all": E * C, "candidates_needed": needed,
            "candidates_walked": visits, "bytes": nbytes,
            "operations": ops,
        }
        log(f"  table_mutate on {what} ({name}): "
            f"{ms} ms a call ({call_ms} ms single), {out[name]['rows_valid']}"
            f" valid rows, {out[name]['events_masked']} events, "
            f"{out[name]['rows_matched']} rows matched; candidates: "
            f"{visits} walked, {needed} needed, {E * C} E x C; bound "
            f"{bound_ms} ms ({bound_by}), "
            f"{out[name]['bound_ms_all_candidates']} ms at E x C; exact "
            f"against the plain version on the card ({plain_ms} ms)")
    up = out["update"]
    return {
        "name": co.table_mutate.name, "route": "cuda",
        "source": co.table_mutate.source,
        "replaces": "flink_siddhi_tpu/compiler/table.py:362 (no Pallas "
                    "counterpart: the reference's dense (E, C) match and "
                    "argmax, TableMutateArtifact.step_tables)",
        "launches": launches, "max_abs_err": 0,
        "max_abs_err_by": f"exact comparison with the plain version on "
                          f"{what} (on the card) and phase 3's cases",
        **{k: up[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                              "bound_by")},
        "plain_device": "cuda",
        "plain_shape": f"the update of {what} (E = {up['events']}, C = "
                       f"{up['rows']}), chunks of {MUTATE_PLAIN_CARD_CELLS} "
                       "cells",
        "library_ms": None, "floor_ms": floor_ms,
        "update": up, "delete": out["delete"],
    }


def table_join_work(co, args, n):
    """(bytes, operations) that the stream-table join needs on THESE
    inputs (one direction, ``table_join_dir``): the probe mask read once,
    the ``on``'s event words of the masked probes, the table's valid flags
    and words read once, the ``n`` rows written once (three int32 words
    each) and n; with
    an int key, one key comparison per masked event and per valid row (a
    hash join's probe and build) and the program's words per row; without
    one, the program's words per (masked event, valid row). The direction's
    fixed window tensors and every candidate the walk visits are not the
    function's work: ``join_pairs_work`` gives the walk's own bound."""
    (d,), ts, cap = args[0], args[1], args[2]
    E, C = int(ts.shape[0]), int(d.b_valid.shape[0])
    rows = min(n, cap)
    masked, valid = int(d.a_mask.sum()), int(d.b_valid.sum())
    nbytes = (E + 4 * masked * int(d.a_cols.shape[0]) + C
              + 4 * C * int(d.b_cols.shape[0]) + 3 * 4 * rows + 4)
    per = max(len(d.prog), 1)
    if co.join_key_hint(d.prog) != (-1, -1):
        return nbytes, masked + valid + rows * per
    return nbytes, masked * valid * per


def time_table_join(co, recorded, floor_ms):
    """K5 on the tables path's third step (the stream-table join, one
    direction): exact against its plain version run on the card, timed
    (CUDA events around back-to-back calls), its candidates; its bound
    from the work the function needs (``table_join_work``), and the bound
    of the candidates the walk visited (``join_pairs_work``) beside it."""
    args = args_copy(recorded, "cuda")
    n, _, _, plain_ms = join_check(co, *args, "the tables path's third "
                                   "step", on_card=True)
    ms, call_ms = timed_back_to_back(lambda: co.join_pairs(*args), 20)
    visits, rewalks = join_counts(co, *args)
    nbytes, ops = table_join_work(co, args, n)
    bound_ms, bound_by = bound_of(nbytes, ops, INT32_OPS_PER_S)
    w_bytes, w_ops = join_pairs_work(args, visits, n)
    walked_ms, walked_by = bound_of(w_bytes, w_ops, INT32_OPS_PER_S)
    E = int(args[1].shape[0])
    entry = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "events": E,
             "pairs": n, "candidates_visited": visits,
             "rewalked_tiles": rewalks, "bytes": nbytes, "operations": ops,
             "bound_ms_walked_candidates": walked_ms,
             "bound_walked_by": walked_by, "bytes_walked": w_bytes,
             "operations_walked": w_ops}
    log(f"  join_pairs on the tables path's third step (the table join): "
        f"{ms} ms a call ({call_ms} ms single), {n} rows of {E} events, "
        f"{visits} candidates, {rewalks} tiles walked again; bound "
        f"{bound_ms} ms ({bound_by}: {nbytes} bytes, {ops} operations), "
        f"{walked_ms} ms ({walked_by}) for the candidates walked; exact "
        f"against the plain version on the card ({plain_ms} ms)")
    return entry


@dataclasses.dataclass
class Event:
    id: int
    name: str
    price: float
    timestamp: int


@dataclasses.dataclass
class Quote:
    symbol: str
    price: float
    volume: int
    timestamp: int


SCAN_REPLACES = {
    "session_scan": "flink_siddhi_tpu/compiler/scan_windows.py:769 (no "
                    "Pallas counterpart: the reference's lax.scan in "
                    "SessionWindowArtifact.step, :684)",
    "frequency_scan": "flink_siddhi_tpu/compiler/scan_windows.py:1086 (no "
                      "Pallas counterpart: the reference's lax.scan in "
                      "FrequencyWindowArtifact.step, :962)",
    "sort_window_scan": "flink_siddhi_tpu/compiler/scan_windows.py:305 (no "
                        "Pallas counterpart: the reference's lax.scan over "
                        "body_sort, :246, in ScanWindowArtifact.step)",
}


def cut_events(args, n, per_event):
    """A kernel call's CPU arguments cut to the first ``n`` events (the
    per-event tensors at positions ``per_event``; a value array's last
    axis), the carried state kept."""
    out = list(args)
    for i in per_event:
        out[i] = args[i][..., :n].contiguous()
    return tuple(out)


def scan_work(kernel, args, rows):
    """(bytes, operations, the longest serial chain) of one K7 / K8 / K9
    call on THESE inputs, which close or emit ``rows`` rows (K7, K8): each
    input read once and each output written once (the closed, emitted or
    masked rows), and the work its events need: a session's few updates
    an event and value; a frequency table's update an event and, per
    emitted row, each slot statistic over the slots valid at the end; a
    sort buffer's count, shift and statistics over its C slots per event.
    The chain is what runs in series: a key's events (K7), every masked
    event (K8), a partition's events (K9)."""
    import torch

    mask = args[0]
    E, m = int(mask.shape[0]), int(mask.sum())
    if kernel == "session_scan":
        codes, vals = args[1], args[3]
        A, G = int(vals.shape[0]), int(args[4].shape[0])
        nbytes = (E * (1 + 4 + 4 + 4 * A) + 2 * G * (1 + 4 + 4 + 12 * A)
                  + rows * (1 + 8 + 12 * A))
        chain = int(torch.bincount(codes[mask].long()).max()) if m else 0
        return nbytes, m * (4 + 4 * A), chain
    if kernel == "frequency_scan":
        vals, valid, slots = args[2], args[3], args[9]
        A, C, S = int(vals.shape[0]), int(valid.shape[0]), len(slots)
        emitted = rows
        members = int(valid.sum())
        nbytes = (E * (1 + 4 + 4 * A) + 2 * C * (13 + 4 * A) + E
                  + emitted * S * 4)
        return nbytes, m * (4 + A) + emitted * members * S, m
    part, vals, valid, slots = args[1], args[3], args[4], args[7]
    A, S = int(vals.shape[0]), len(slots)
    P, C = int(valid.shape[0]), int(valid.shape[1])
    nbytes = E * (1 + 4 + 4 + 4 * A) + 2 * P * C * (5 + 4 * A) + m * S * 4
    chain = int(torch.bincount(part[mask].long()).max()) if m else 0
    return nbytes, m * C * (2 + A + S), chain


def time_scan_kernel(co, kernel, plans, recorded, launches, floor_ms,
                     dev="cuda"):
    """K7, K8 or K9 on phase 8f's recorded steps of ``plans`` (the
    first plan's is the kernels-line entry, the others under their names):
    held to its plain version (run on the CPU copies) on the whole tape,
    or, where the plain version walks event by event (one partition, one
    global table), on the first SCAN_PLAIN_EVENTS events with the carried
    state; timed (CUDA events around back-to-back calls) on the whole
    tape; its bound from ``scan_work``, and its serial floor (the longest
    chain's count of empty warp rounds, csrc/empty.cu)."""
    per_event = {"session_scan": (0, 1, 2, 3), "frequency_scan": (0, 1, 2),
                 "sort_window_scan": (0, 1, 2, 3)}[kernel]
    check = {"session_scan": session_check,
             "frequency_scan": frequency_check,
             "sort_window_scan": sort_check}[kernel]
    entries = {}
    for name in plans:
        args = recorded[name]
        walks = (kernel == "frequency_scan"
                 or (kernel == "sort_window_scan"
                     and int(args[4].shape[0]) == 1))
        held = (cut_events(args, SCAN_PLAIN_EVENTS, per_event) if walks
                else args)
        step = f"step {scan_recorded_step(name)}"
        res = check(co, held, f"{name}'s {step}"
                    + (f" (first {SCAN_PLAIN_EVENTS} events)" if walks
                       else ""), dev)
        plain_s, rel = res[-1], (res[-2] if kernel != "session_scan"
                                 else 0.0)
        cargs = args_copy(args, dev)
        fn = getattr(co, kernel)
        # K8 and K9 take 0.5-0.8 s a call: one timed call each way (the
        # held call above warmed them), cut for phase 8j's time
        runs, warm = (1, 0) if kernel != "session_scan" else (2, 1)
        ms, call_ms = timed_back_to_back(lambda: fn(*cargs), runs, warm)
        # the rows the checked call closed or emitted (K7, K8)
        rows = 0 if kernel == "sort_window_scan" else res[0]
        nbytes, ops, chain = scan_work(kernel, held, rows)
        if walks:  # the whole tape's bytes and work, scaled from the cut
            full = int(args[0].sum()) / max(int(held[0].sum()), 1)
            nbytes, ops = nbytes * full, ops * full
            chain = scan_work(kernel, args, 0)[2]
        bound_ms, bound_by = bound_of(nbytes, ops, INT32_OPS_PER_S)
        floor_serial, _ = timed_back_to_back(
            lambda: co.launch_warp_rounds(max(chain, 1)), runs, warm)
        entries[name] = {
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_s * 1e3,
            "plain_device": "cpu",
            "plain_shape": (f"the first {SCAN_PLAIN_EVENTS} events of "
                            f"{step}" if walks else step),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "operations": ops, "serial_chain_events": chain,
            "serial_floor_ms": floor_serial, "max_rel_err": rel,
            "events": int(args[0].shape[0]),
            "events_masked": int(args[0].sum()),
        }
        log(f"  {kernel} on {name}'s {step}: {ms} ms a call "
            f"({call_ms} ms single), {entries[name]['events_masked']} "
            f"events, longest chain {chain} events, serial floor "
            f"{floor_serial} ms, bound {bound_ms} ms ({bound_by}); held to "
            f"its plain version on {entries[name]['plain_shape']} (CPU "
            f"{plain_s:.2f} s), sums rel err {rel:.3g}")
    first = entries[plans[0]]
    return {
        "name": kernel, "route": "cuda", "source": fn.source,
        "replaces": SCAN_REPLACES[kernel],
        "launches": launches[plans[0]], "max_abs_err": 0,
        "max_abs_err_by": "equal as stored against the plain version "
                          "(sums within SCAN_RTOL, max_rel_err) on each "
                          "plan's recorded step and phase 3's cases",
        **{k: first[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                 "bound_by")},
        "plain_device": "cpu", "plain_shape": first["plain_shape"],
        "library_ms": None, "floor_ms": floor_ms,
        "launches_by_plan": {p: launches[p] for p in plans},
        "plans": entries,
    }


def time_unkeyed_session(co, recorded):
    """K7 with every code 0 (an unkeyed session: one thread walks the whole
    tape) on S1's third step: exact against the plain version on its first
    2,048 events, timed over the whole tape."""
    import torch

    args = list(recorded["S1"])
    args[1] = torch.zeros_like(args[1])
    args = tuple(args)
    check = cut_events(args, 2048, (0, 1, 2, 3))
    session_check(co, check, "an unkeyed session (first 2,048 events)",
                  "cuda")
    cargs = args_copy(args, "cuda")
    ms, call_ms = timed_back_to_back(lambda: co.session_scan(*cargs), 2)
    n = int(args[0].sum())
    floor_ms, _ = timed_back_to_back(lambda: co.launch_warp_rounds(n), 2)
    log(f"  session_scan unkeyed over S1's third step: {ms} ms a call, "
        f"{n} events on one thread ({ms / max(n, 1) * 1e6:.1f} ns each), "
        f"serial floor {floor_ms} ms")
    return {"ms": ms, "call_ms": call_ms, "events_masked": n,
            "ns_per_event": ms / max(n, 1) * 1e6,
            "serial_floor_ms": floor_ms}


def time_fold_int(co, args, launches):
    """K3's integer path on U1's recorded third step: exact against its
    plain version on the card (the table, counts and int32 extremes
    equal, sums within FOLD_RTOL), timed."""
    import torch

    cargs = args_copy(args, "cuda")
    got = co.unique_window_fold(*cargs)
    t0 = time.perf_counter()
    ref = co.unique_window_fold_plain(*cargs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, rel = fold_err(got, ref, args[5], "unique_window_fold on U1's "
                        "third step", args[6])
    ms, call_ms = timed_back_to_back(lambda: co.unique_window_fold(*cargs),
                                     10)
    mask, vals, valid0 = args[0], args[2], args[3]
    E, C, A, S = (int(mask.shape[0]), int(valid0.shape[0]),
                  int(vals.shape[0]), len(args[5]))
    nbytes = E * (1 + 4 + 4 * A) + S * E * 4 + 2 * (C + 4 * A * C)
    bound_ms, bound_by = bound_of(nbytes, 0, INT32_OPS_PER_S)
    log(f"  unique_window_fold (int32 columns) on U1's third step: {ms} ms "
        f"a call ({call_ms} ms single), bound {bound_ms} ms ({bound_by}); "
        f"exact (sums rel err {rel:.3g}) against the plain version on the "
        f"card ({plain_ms:.1f} ms)")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "plain_device": "cuda", "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "max_rel_err": rel,
            "launches": launches, "int_cols": list(args[6]),
            "shape": {"E": E, "C": C, "A": A, "S": S}}


def api_check(fpt):
    """The README's quick start, pattern and quote board through SiddhiCEP
    on the default device, against the CPU."""
    events = [Event(i % 4, f"n{i % 3}", float(i), 1000 + 1000 * i)
              for i in range(50)]
    fields = ["id", "name", "price", "timestamp"]
    rows = fpt.SiddhiCEP.define("inputStream", events, fields).cql(
        "from inputStream[id == 2] select name, price insert into out"
    ).returns("out")
    if rows[:2] != [("n2", 2.0), ("n0", 6.0)] or len(rows) != 12:
        raise AssertionError(f"api filter rows: {rows[:4]}")
    pat = ("from every s1 = A[id == 2] -> s2 = A[id == 3] "
           "select s1.id as a, s2.timestamp as t insert into o")
    got = fpt.SiddhiCEP.define("A", events, fields).cql(pat) \
        .return_as_map("o")
    ref = fpt.SiddhiCEP.define("A", events, fields, device="cpu") \
        .cql(pat).return_as_map("o")
    if got != ref or got[0] != {"a": 2, "t": 4000} or len(got) != 12:
        raise AssertionError(f"api pattern rows: {got[:3]} vs {ref[:3]}")
    quotes = [Quote(sym, price, vol, 1000 + i) for i, (sym, price, vol)
              in enumerate([("IBM", 75.5, 100), ("WSO2", 57.25, 10),
                            ("IBM", 76.0, 50), ("ORCL", 32.5, 200)] * 5)]
    qfields = ["symbol", "price", "volume", "timestamp"]
    board = fpt.SiddhiCEP.define("StockStream", quotes, qfields) \
        .cql(QUOTE_BOARD).returns("Board")
    board_cpu = fpt.SiddhiCEP.define("StockStream", quotes, qfields,
                                     device="cpu") \
        .cql(QUOTE_BOARD).returns("Board")
    board_err([(0, r) for r in board], [(0, r) for r in board_cpu],
              "api quote board")
    if board[3] != ("ORCL", 3, 76.0 * 50 + 57.25 * 10 + 32.5 * 200,
                    (76.0 + 57.25 + 32.5) / 3, 32.5, 76.0):
        raise AssertionError(f"api quote board rows: {board[:4]}")
    log(f"  quick start: {len(rows)} rows; pattern: {len(got)} rows; "
        f"quote board: {len(board)} rows; equal to the CPU")


# -- phase 8i: the dynamic control plane -----------------------------------

CTRL_TAPES = 8  # D1, D2, D4: tapes of BATCH of the bench stream (4,194,304)
CTRL_RATE_TAPES = 8  # the rate runs: a warm pass, then the next 8 tapes
CTRL_CPU_TAPE = 8_192  # D1's CPU check: the first 65,536 events, 8 tapes
CTRL_REST_TAPE = BATCH // 4  # D3's tapes (131,072 events), 4 of them
CTRL_REST_TAPES = 4
CTRL_SAVE_AFTER = 4  # D4: cycles (tapes 0-3) before the checkpoint
# the control Jobs' fused segment: the static plan's tapes stay staged
# across the control boundaries (a group's drain hint makes its own 1)
CTRL_SEGMENT = 4


def ctrl_cql(n, a, b, c, w_s, op2="=="):
    """A headline variant: its ids, operators and window are slot data,
    so every variant shares one template (one group)."""
    return (f"from every s1 = inputStream[id == {a}] -> "
            f"s2 = inputStream[id {op2} {b}] -> s3 = inputStream[id == {c}] "
            f"within {w_s} sec select s1.timestamp as t1, s3.timestamp as "
            f"t3, s3.price as price insert into v{n}")


CTRL_QUERIES = {
    "v1": ctrl_cql(1, 1, 2, 3, 5),  # the headline itself
    "v2": ctrl_cql(2, 4, 5, 6, 2),
    "v3": ctrl_cql(3, 7, 8, 9, 5),
    "v4": ctrl_cql(4, 10, 48, 11, 2, op2=">="),
    "v5": ctrl_cql(5, 12, 13, 14, 5),
    "v6": ctrl_cql(6, 15, 16, 17, 2),
    "v7": ctrl_cql(7, 18, 19, 20, 5),
    "v8": ctrl_cql(8, 21, 22, 23, 2),
    "v9": ctrl_cql(9, 24, 25, 26, 5),
    "v10": ctrl_cql(10, 27, 28, 29, 2),
    "f1": "from inputStream[id == 30] select id, price insert into f1",
    "bad": "from inputStream[id == ] select nothing",
}
CTRL_UPDATE = ctrl_cql(6, 15, 16, 17, 1)  # v6's PUT: a new within
CTRL_STREAMS = tuple(f"v{i}" for i in range(1, 11)) + ("f1", "matches")
# each query's incarnations: (tape it applies at, tape it retires at,
# its CQL); v2 and v3 are disabled at tape 4 (v2 enabled again at 5)
CTRL_LIFE = {
    "v1": [(0, 8, "v1")], "v4": [(0, 4, "v4")], "v5": [(2, 4, "v5")],
    "v6": [(2, 4, "v6"), (4, 8, "update")], "v7": [(2, 8, "v7")],
    "v8": [(2, 8, "v8")], "v9": [(3, 6, "v9")], "v10": [(5, 8, "v10")],
    "f1": [(3, 6, "f1")],
}
CTRL_COUNTERS = {"admitted": 12, "stack_join": 9, "retired": 5,
                 "admission_rejected": 1}


def ctrl_timeline(tape):
    """The control timeline, each event stamped at a tape boundary (tape
    k's first ts, 1000 + k * tape; 0 before tape 0): every mode applies it
    at the same boundary."""
    from flink_siddhi_tpu_torch.control.events import (
        MetadataControlEvent as M,
        OperationControlEvent as O,
    )

    def at(k):
        return 1000 + k * tape

    def add(*pids):
        b = M.builder()
        for pid in pids:
            b.add_execution_plan(CTRL_QUERIES[pid], plan_id=pid)
        return b.build()

    drop4 = M.builder().remove_execution_plan("v4").remove_execution_plan(
        "v5").build()
    drop6 = M.builder().remove_execution_plan("v9").remove_execution_plan(
        "f1").build()
    return [
        (0, add("v1", "v2", "v3", "v4")),  # group 1
        (at(2), add("v5", "v6", "v7", "v8")),  # fills its 8 slots
        (at(3), add("v9", "f1", "bad")),  # group 2, a runtime, CQL000
        (at(4), O.disable_query("v2")), (at(4), O.disable_query("v3")),
        (at(4), drop4),
        (at(4), M.builder().update_execution_plan("v6", CTRL_UPDATE)
         .build()),
        (at(5), add("v10")),  # into a reclaimed slot
        (at(5), O.enable_query("v2")),
        (at(6), drop6),  # group 2's only member: its host is dropped
    ]


def static_plan(fpt, schema):
    """Phase 8i's static plan: the headline under bench.py's settings."""
    return fpt.compile_plan(HEADLINE, {"inputStream": schema},
                            plan_id="bench", config=bench_config(fpt))


def ctrl_job(fpt, schema, batches, device, tape, control=True,
             time_mode="event", retain=True, static=True):
    """The control plane's streaming Job: the static plan (``static``), a
    ControlListSource of the timeline, the default EngineConfig for the
    plans it adds (chain plans fold), fused dispatch in segments of
    CTRL_SEGMENT tapes."""
    job = fpt.Job(
        [static_plan(fpt, schema)] if static else [],
        [fpt.BatchSource("inputStream", schema, iter(batches))],
        batch_size=tape, time_mode=time_mode, device=device,
        retain_results=retain,
        control_sources=([fpt.ControlListSource(ctrl_timeline(tape))]
                         if control is True else list(control or ())),
        plan_compiler=lambda cql, pid: fpt.compile_plan(
            cql, {"inputStream": schema}, plan_id=pid),
    )
    job.fused_segment_len = CTRL_SEGMENT
    return job


def ctrl_rows(job, as_lists=False):
    out = {}
    for s in CTRL_STREAMS:
        rows = job.results_with_ts(s)
        out[s] = ([[t, list(r)] for t, r in rows] if as_lists else rows)
    return out


def ctrl_status(job):
    c = job.control_status()["counters"]
    return {"counters": {k: c.get(k, 0) for k in CTRL_COUNTERS},
            "plan_ids": sorted(job.plan_ids),
            "folded": {p: list(f) for p, f in sorted(job._folded.items())}}


def ctrl_scaled(fpt, device):
    """The timeline over the first 65,536 events of the bench stream in
    tapes of CTRL_CPU_TAPE (D1's row check)."""
    schema, batches = bench_stream(fpt, BATCH, BATCH)
    first = batches[0]
    tapes = [first.slice(s, s + CTRL_CPU_TAPE)
             for s in range(0, CTRL_TAPES * CTRL_CPU_TAPE, CTRL_CPU_TAPE)]
    job = ctrl_job(fpt, schema, tapes, device, CTRL_CPU_TAPE)
    job.run()
    return {"rows": ctrl_rows(job, as_lists=True), **ctrl_status(job)}


def control_cpu_main(out_path):
    """D1's CPU path (``--control-cpu OUT``): the timeline over the first
    65,536 events on the CPU, as JSON to OUT. Phase 8i starts it first,
    so that it runs beside the card's runs."""
    import torch

    import flink_siddhi_tpu_torch as fpt

    torch.set_num_threads(4)
    with open(out_path, "w") as f:
        json.dump(ctrl_scaled(fpt, "cpu"), f)
    return 0


def ctrl_static(fpt, schema, cql, batches, out, time_mode="event"):
    """The oracle: a static compile of one query's CQL, run alone on the
    card over the tapes it lived through."""
    plan = fpt.compile_plan(cql, {"inputStream": schema}, plan_id="static")
    job = fpt.Job([plan], [fpt.BatchSource("inputStream", schema,
                                           iter(batches))],
                  batch_size=len(batches[0]), time_mode=time_mode,
                  device="cuda")
    job.run()
    return job.results_with_ts(out)


def static_alone(fpt, schema, batches):
    """D1's static plan run alone, as D1 runs it (fused, CTRL_SEGMENT
    tapes a segment, event time): its rows, graph keys and graphs."""
    job = fpt.Job([static_plan(fpt, schema)],
                  [fpt.BatchSource("inputStream", schema, iter(batches))],
                  batch_size=BATCH, time_mode="event", device="cuda")
    job.fused_segment_len = CTRL_SEGMENT
    job.run()
    g = job._plans["bench"].graphs
    out = {"rows": job.results_with_ts("matches"), "graph_keys": g.keys,
           "graphs_captured": g.captured,
           "eager_segments": job.eager_segments}
    del job
    return out


class CtrlWatch:
    """Wraps ``job._apply_control``: the ms of each event's application
    (synchronized: the boundary to an applied event), before each event
    every group host's overflow, and its and the static plan's graph
    binding and graph counts, and the events that changed the static
    plan's runtime (its binding, graphs, states or staged tapes) while
    they applied. Wraps ``job._run_segment``: each
    runtime's steps (a segment's tapes, padding included), and the steps
    its warm-ups ran (a segment whose graph key is new runs its steps once
    eagerly, on copies of the states, before the capture)."""

    def __init__(self, job):
        import torch

        from flink_siddhi_tpu_torch.compiler import nfa

        self.job = job
        self.applied = []
        self.hosts = {}
        self.steps = {}
        self.warm = {}
        self.chain = set()  # runtimes whose steps run K1 and K2
        self.static_changed = []
        inner = job._apply_control
        run_segment = job._run_segment

        def run_seg(rt, seg):
            pid = rt.plan.plan_id
            keys = rt.graphs.keys if rt.graphs is not None else 0
            out = run_segment(rt, seg)
            self.steps[pid] = self.steps.get(pid, 0) + len(seg)
            self.warm[pid] = self.warm.get(pid, 0) + (
                len(seg) if rt.graphs.keys > keys else 0)
            if any(isinstance(a, (nfa.DynamicChainGroup,
                                  nfa.ChainPatternArtifact))
                   for a in rt.plan.artifacts):
                self.chain.add(pid)
            return out

        job._run_segment = run_seg

        def apply(ev):
            self.look()
            static = self.static_runtime()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner(ev)
            torch.cuda.synchronize()
            self.applied.append((type(ev).__name__,
                                 sorted(getattr(ev, "added_plans", {})),
                                 (time.perf_counter() - t0) * 1e3))
            if self.static_runtime() != static:
                self.static_changed.append(repr(ev))

        job._apply_control = apply

    def static_runtime(self):
        rt = self.job._plans.get("bench")
        if rt is None:
            return None
        g = rt.graphs
        return (id(rt.states), [id(t) for t in rt.states.values()],
                len(rt.seg_pending), rt.acc_pos,
                None if g is None else (id(g._bound), g.keys, g.captured))

    def look(self):
        for pid, rt in list(self.job._plans.items()):
            if not (pid.startswith("@dyn:") or pid == "bench"):
                continue
            h = self.hosts.setdefault(pid, {"overflow": 0, "bound": set(),
                                            "keys": [], "captured": []})
            if pid != "bench":
                g = rt.plan.artifacts[0]
                h["overflow"] = max(h["overflow"], int(
                    rt.states[g.name]["overflow"].sum()))
            if rt.graphs is not None and rt.graphs._bound is not None:
                h["bound"].add(id(rt.graphs._bound))
                h["keys"].append(rt.graphs.keys)
                h["captured"].append(rt.graphs.captured)


def ctrl_rate(fpt, co, nfa, schema, batches, members):
    """The group with ``members`` live members (all admitted before tape
    0), processing time, fused: a warm pass over the first
    CTRL_RATE_TAPES tapes (its graphs captured there), a timed pass over
    the next ones (events/s), then a profiler-traced pass over them
    (``traced_run``): K1 and K2 ran on the card once each per group step
    (a replay adds its capture's counts to the host's, so only the trace
    shows it), the step's device time and the card's idle share. With 8
    members, the kernels' inputs of an eager third step are recorded for
    phase 9."""
    import torch

    from flink_siddhi_tpu_torch.control.events import MetadataControlEvent

    b = MetadataControlEvent.builder()
    for i in range(members):
        b.add_execution_plan(CTRL_QUERIES[f"v{i + 1}"], plan_id=f"v{i + 1}")
    warm, timed_b = (batches[:CTRL_RATE_TAPES],
                     batches[CTRL_RATE_TAPES:2 * CTRL_RATE_TAPES])
    job = ctrl_job(fpt, schema, warm, "cuda", BATCH,
                   control=[fpt.ControlListSource([(0, b.build())])],
                   time_mode="processing", retain=False, static=False)
    job.run()
    torch.cuda.synchronize()
    (pid, rt), = job._plans.items()
    group = rt.plan.artifacts[0]
    if sum(m is not None for m in group.members) != members:
        raise AssertionError(f"control: {members} members did not fold "
                             "into one group")
    captured = job.graphs_captured
    re_source(fpt, job, schema, timed_b)
    co.reset_launches()
    disp0 = job.fusion_dispatches
    t0 = time.perf_counter()
    job.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = co.launch_counts()
    steps = (job.fusion_dispatches - disp0) * job._fused_k(rt)
    n = sum(len(x) for x in timed_b)
    emitted = sum(job.emitted_counts.values())
    box = {}

    def traced():
        d0 = job.fusion_dispatches
        t0 = time.perf_counter()
        job.run()
        torch.cuda.synchronize()
        box["dispatches"] = job.fusion_dispatches - d0
        return time.perf_counter() - t0

    prof, traced_s, traced_k = traced_run(
        co, traced, f"control rate, {members} member(s)",
        prepare=lambda: re_source(fpt, job, schema, timed_b))
    t_steps = box["dispatches"] * job._fused_k(rt)
    share = traced_share(prof, traced_s, box["dispatches"], t_steps)
    del prof
    kernels = ("multi_reverse_cummin", "chain_advance")
    for k in kernels:
        if launches[k] != steps or traced_k[k] != t_steps:
            raise AssertionError(
                f"control: {k} launched {launches[k]} times in {steps} "
                f"group steps, ran {traced_k[k]} times on the card in "
                f"{t_steps} traced ones, with {members} member(s)")
    if job.eager_segments or job.graphs_captured != captured:
        raise AssertionError(
            f"control: {job.eager_segments} eager segments, "
            f"{job.graphs_captured - captured} graphs captured after the "
            "warm pass")
    out = {"members": members, "events": n, "run_s": wall,
           "events_per_s": n / wall, "steps": steps,
           "segment_len": job._fused_k(rt),
           "launches": {k: launches[k] for k in kernels},
           "launches_traced": {k: traced_k[k] for k in kernels},
           "traced_steps": t_steps,
           "device_ms_per_step": share["traced_device_busy_s"] * 1e3
           / t_steps,
           "traced": share,
           "graphs_captured": captured, "emitted": emitted}
    recorded = None
    if members == 8:
        rec_k1 = Recorder(co.multi_reverse_cummin, keep=3)
        rec_k2 = Recorder(co.chain_advance, keep=3)
        nfa.multi_reverse_cummin, nfa.chain_advance = rec_k1, rec_k2
        try:
            states = {k: {n_: t.clone() for n_, t in v.items()}
                      for k, v in rt.states.items()}
            acc = rt.plan.init_acc(job.device)
            epoch = int(warm[0].timestamps.min())
            for tape in stage_wire_tapes(rt.plan, warm[:3], epoch,
                                         job.device):
                states, acc = rt.plan.step_acc(states, acc, tape)
            torch.cuda.synchronize()
        finally:
            nfa.multi_reverse_cummin = co.multi_reverse_cummin
            nfa.chain_advance = co.chain_advance
        recorded = {
            "k1": [keep_copy(a, "cpu") for a in rec_k1.args],
            "k1_kw": rec_k1.kwargs,
            "k2": [keep_copy(a, "cpu") for a in rec_k2.args],
        }
    del job
    return out, recorded


def ctrl_d1(fpt, co, schema, batches):
    """D1: the timeline at full width through the fused streaming Job;
    then D1 again in a profiler trace (``traced_run``): the same rows, and
    K1 and K2 ran on the card once each per step of a chain runtime."""
    import torch

    box = {}

    def prepare():
        box.clear()
        box["job"] = ctrl_job(fpt, schema, batches, "cuda", BATCH)
        box["watch"] = CtrlWatch(box["job"])

    def run():
        t0 = time.perf_counter()
        box["job"].run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prepare()
    co.reset_launches()
    wall = run()
    launches = co.launch_counts()
    job, watch = box["job"], box["watch"]
    watch.look()
    rows = ctrl_rows(job)
    status = ctrl_status(job)
    hosts = {pid: {"overflow": h["overflow"], "bindings": len(h["bound"]),
                   "graph_keys": h["keys"][-1] if h["keys"] else 0,
                   "graphs_captured": h["captured"][-1] if h["captured"]
                   else 0, "keys_seen": sorted(set(h["keys"])),
                   "looks_bound": len(h["keys"])}
             for pid, h in watch.hosts.items()}
    g1 = job._plans.get("@dyn:v1")
    keys = list(g1.graphs.graphs) if g1 is not None and g1.graphs else []
    state_sigs = {k[2] for k in keys}
    eager = job.eager_segments
    dispatches = job.fusion_dispatches
    applied = watch.applied
    static_changed = watch.static_changed
    del job, watch
    box.clear()
    prof, traced_s, traced_k = traced_run(co, run, "control D1",
                                          prepare=prepare)
    tjob, twatch = box["job"], box["watch"]
    share = traced_share(prof, traced_s, tjob.fusion_dispatches,
                         sum(twatch.steps.values()))
    del prof
    if ctrl_rows(tjob) != rows:
        raise AssertionError("control D1: the traced run's rows differ")
    chain_steps = sum(twatch.steps[p] + twatch.warm[p]
                      for p in twatch.chain)
    kernels = ("multi_reverse_cummin", "chain_advance")
    for k in kernels:
        if traced_k[k] != chain_steps:
            raise AssertionError(
                f"control D1: {k} ran {traced_k[k]} times on the card in "
                f"{chain_steps} steps of the chain runtimes, warm-ups "
                f"included (steps {twatch.steps}, warm {twatch.warm}, "
                f"chain {sorted(twatch.chain)})")
    out = {"rows": rows, **status, "wall_s": wall,
           "events": sum(len(b) for b in batches),
           "launches": {k: launches[k] for k in kernels},
           "launches_traced": {k: traced_k[k] for k in kernels},
           "steps": {p: twatch.steps[p] for p in sorted(twatch.steps)},
           "warm_steps": {p: twatch.warm[p] for p in sorted(twatch.warm)},
           "chain_runtimes": sorted(twatch.chain),
           "dispatches": dispatches, "traced": share,
           "hosts": hosts, "group1_state_sigs": len(state_sigs),
           "group1_keys": len(keys),
           "applied": applied, "static_changed_by": static_changed,
           "eager_segments": eager}
    del tjob, twatch
    box.clear()
    return out


def ctrl_oracles(fpt, schema, batches, d1_rows, tape):
    """Each member never disabled: its rows equal a static compile of its
    CQL run alone over the tapes between its admit and its retire. The
    disabled ones emit no row while disabled."""
    checked = 0
    for s, lives in CTRL_LIFE.items():
        want = []
        for lo, hi, q in lives:
            cql = CTRL_UPDATE if q == "update" else CTRL_QUERIES[q]
            want += ctrl_static(fpt, schema, cql, batches[lo:hi], s)
        got = d1_rows[s]
        if sorted(got) != sorted(want) or not want:
            raise AssertionError(
                f"control D1: {s}'s {len(got)} rows differ from its static "
                f"compile's {len(want)} over tapes {lives}")
        checked += len(got)

    def starts(k):
        return 1000 + k * tape

    if any(starts(4) <= t < starts(5) for t, _ in d1_rows["v2"]):
        raise AssertionError("control D1: v2 emitted while disabled")
    if any(t >= starts(4) for t, _ in d1_rows["v3"]):
        raise AssertionError("control D1: v3 emitted while disabled")
    if not d1_rows["v2"] or not any(t >= starts(5) for t, _ in
                                    d1_rows["v2"]):
        raise AssertionError("control D1: v2 emitted nothing once enabled")
    return checked


def ctrl_d2(fpt, schema, batches, d1_rows):
    """D2: the same timeline through ResidentReplay, in epochs."""
    import torch

    job = ctrl_job(fpt, schema, batches, "cuda", BATCH)
    rep = fpt.ResidentReplay(job)
    t0 = time.perf_counter()
    rep.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = ctrl_rows(job)
    for s in CTRL_STREAMS:
        if rows[s] != d1_rows[s]:
            raise AssertionError(f"control D2: {s}'s resident rows differ "
                                 "from the streaming run's")
    out = {"epochs": len(rep._epochs), "wall_s": wall,
           "eager_segments": job.eager_segments,
           "graphs_captured": job.graphs_captured, **ctrl_status(job)}
    del job, rep
    return out


class FeedSource:
    """A live source the caller feeds one batch at a time."""

    def __init__(self, schema, stream_id="inputStream"):
        self.stream_id, self.schema = stream_id, schema
        self.queue = []

    def poll(self, max_events):
        if self.queue:
            return self.queue.pop(0), None, False
        return None, None, False


def ctrl_d3(fpt, schema, batches):
    """D3: QueryControlService over a live Job fed the bench stream in
    processing time: POST 8 variants, GET the listing, disable, PUT and
    DELETE; each query's rows against its static compile."""
    import http.client

    import torch

    from flink_siddhi_tpu_torch.app.service import (
        ControlQueueSource,
        QueryControlService,
    )

    tapes = [batches[0].slice(s, s + CTRL_REST_TAPE)
             for s in range(0, CTRL_REST_TAPES * CTRL_REST_TAPE,
                            CTRL_REST_TAPE)]
    feed = FeedSource(schema)
    ctrl = ControlQueueSource()
    job = fpt.Job([], [feed], batch_size=CTRL_REST_TAPE,
                  time_mode="processing", device="cuda",
                  control_sources=[ctrl],
                  plan_compiler=lambda cql, pid: fpt.compile_plan(
                      cql, {"inputStream": schema}, plan_id=pid))
    svc = QueryControlService(
        ctrl, job=job, validate=lambda cql: fpt.compile_plan(
            cql, {"inputStream": schema})).start()
    statuses = []
    try:
        conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=10)

        def call(method, path, body=None):
            conn.request(method, path,
                         body=json.dumps(body) if body else None,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            statuses.append(r.status)
            return r.status, json.loads(r.read() or b"{}")

        ids = [f"r{i}" for i in range(1, 9)]
        for i, rid in enumerate(ids):
            st, body = call("POST", "/api/v1/queries",
                            {"cql": CTRL_QUERIES[f"v{i + 1}"], "id": rid})
            if st != 201 or body["id"] != rid:
                raise AssertionError(f"control D3: POST {rid} -> {st}")

        def step(k):
            feed.queue.append(tapes[k])
            job.run_cycle()

        step(0)
        step(1)
        st, listing = call("GET", "/api/v1/queries")
        folded = sorted(q["folded"]["slot"] for q in listing["queries"])
        hosts = {q["folded"]["host"] for q in listing["queries"]}
        if st != 200 or folded != list(range(8)) or len(hosts) != 1:
            raise AssertionError(f"control D3: listing {listing}")
        if call("POST", "/api/v1/queries/r2/disable")[0] != 200:
            raise AssertionError("control D3: disable")
        if call("PUT", "/api/v1/queries/r6",
                {"cql": CTRL_UPDATE})[0] != 200:
            raise AssertionError("control D3: PUT")
        if call("DELETE", "/api/v1/queries/r4")[0] != 200:
            raise AssertionError("control D3: DELETE")
        step(2)
        step(3)
        job.drain_outputs()
        st, after = call("GET", "/api/v1/queries")
        by_id = {q["id"]: q for q in after["queries"]}
        if sorted(by_id) != sorted(set(ids) - {"r4"}) \
                or by_id["r2"]["enabled"] is not False:
            raise AssertionError(f"control D3: listing after {after}")
        st, one = call("GET", "/api/v1/queries/r6")
        if st != 200 or one["state"] != "live":
            raise AssertionError(f"control D3: r6 {one}")
        st, health = call("GET", "/api/v1/health")
        if st != 200 or health["control"]["counters"]["admitted"] != 9:
            raise AssertionError(f"control D3: health {health}")
    finally:
        svc.stop()
    torch.cuda.synchronize()
    # each query's rows: r2 until its disable, r4 until its DELETE, r6's
    # two incarnations, the others all four tapes
    checked = 0
    for i, rid in enumerate(ids):
        s = f"v{i + 1}"
        if rid in ("r2", "r4"):
            want = ctrl_static(fpt, schema, CTRL_QUERIES[s], tapes[:2], s,
                               "processing")
        elif rid == "r6":
            want = (ctrl_static(fpt, schema, CTRL_QUERIES[s], tapes[:2], s,
                                "processing")
                    + ctrl_static(fpt, schema, CTRL_UPDATE, tapes[2:], s,
                                  "processing"))
        else:
            want = ctrl_static(fpt, schema, CTRL_QUERIES[s], tapes, s,
                               "processing")
        got = job.results_with_ts(s)
        if sorted(got) != sorted(want):
            raise AssertionError(f"control D3: {rid}'s {len(got)} rows "
                                 f"differ from its static compile's "
                                 f"{len(want)}")
        checked += len(got)
    out = {"statuses": sorted(set(statuses)), "requests": len(statuses),
           "rows_checked": checked, "events": sum(len(t) for t in tapes),
           **ctrl_status(job)}
    del job
    return out


def ctrl_d4(fpt, schema, batches, d1_rows):
    """D4: a checkpoint after tape 3 (the events of tapes 4-7 still
    pending in it), restored into a fresh Job that replays ``dynamic``
    into the same slots, then tapes 4-7: rows equal D1's, none duplicated
    or lost. The static plan's lazy columns of a partial match carried
    across the restore decode as None, as in the JAX package (its rows
    count as D1's, the others equal)."""
    import torch

    first = ctrl_job(fpt, schema, batches, "cuda", BATCH)
    first.run(max_cycles=CTRL_SAVE_AFTER)
    path = os.path.join(SMOKE_DIR, "control_ckpt.bin")
    t0 = time.perf_counter()
    first.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    before = ctrl_rows(first)
    folded = dict(first._folded)
    pending = len(first._control_pending)
    del first
    job = ctrl_job(fpt, schema, batches[CTRL_SAVE_AFTER:], "cuda", BATCH,
                   control=None)
    t0 = time.perf_counter()
    job.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if {p: tuple(f) for p, f in job._folded.items()} != \
            {p: tuple(f) for p, f in folded.items()}:
        raise AssertionError("control D4: the restore re-formed other "
                             "slots")
    job.run()
    after = ctrl_rows(job)
    dup = lost = 0
    holes = []
    for s in CTRL_STREAMS:
        got = before[s] + after[s]
        want = d1_rows[s]
        if s == "matches":
            # one row with None for each of D1's rows the others miss
            holes = [r for r in got if None in r[1]]
            got = [r for r in got if None not in r[1]]
            kept = set(got)
            if len(set(want) - kept) != len(holes):
                raise AssertionError(
                    f"control D4: {len(holes)} static rows with None for "
                    f"{len(set(want) - kept)} of D1's missing")
            want = [r for r in want if r in kept]
        dup += len(got) - len(set(got))
        lost += len(set(want) - set(got))
        if sorted(got) != sorted(want):
            raise AssertionError(f"control D4: {s}'s rows across the "
                                 "restore differ from D1's")
    out = {"pending_at_save": pending, "save_s": save_s,
           "restore_s": restore_s, "snapshot_bytes": os.path.getsize(path),
           "duplicate_rows": dup, "lost_rows": lost,
           "lazy_none_rows": len(holes), **ctrl_status(job)}
    os.remove(path)
    del job
    return out


def control_phase(fpt, co, out_path):
    """Phase 8i: the rate runs, D1 to D4 (see the module docstring). The
    result goes to ``out_path``, the group's kernel inputs to
    ``out_path``.pt."""
    import torch

    from flink_siddhi_tpu_torch.compiler import nfa

    t_phase = time.perf_counter()
    parts = {}  # seconds of each part of the phase

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    os.makedirs(SMOKE_DIR, exist_ok=True)
    cpu_path = os.path.join(SMOKE_DIR, "control_cpu.json")
    cpu_proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--control-cpu", cpu_path])
    try:
        schema, batches = bench_stream(fpt, 2 * CTRL_RATE_TAPES * BATCH,
                                       BATCH)
        rates = {}
        recorded = None
        for m in (1, 8):
            rates[m], rec = ctrl_rate(fpt, co, nfa, schema, batches, m)
            recorded = rec or recorded
            log(f"  rate, {m} member(s): {rates[m]['events_per_s']:.4g} "
                f"events/s; {rates[m]['launches_traced']} on the card in "
                f"{rates[m]['traced_steps']} traced group steps, "
                f"{rates[m]['device_ms_per_step']:.4g} device ms a step")
        part("rate")
        batches = batches[:CTRL_TAPES]
        d1 = ctrl_d1(fpt, co, schema, batches)
        part("D1_and_traced_D1")
        expect = CTRL_COUNTERS
        if d1["counters"] != expect:
            raise AssertionError(f"control D1: counters {d1['counters']} "
                                 f"!= {expect}")
        if d1["plan_ids"] != ["bench", "v1", "v10", "v2", "v3", "v6", "v7",
                              "v8"]:
            raise AssertionError(f"control D1: plan ids {d1['plan_ids']}")
        for pid, h in d1["hosts"].items():
            if h["overflow"]:
                raise AssertionError(f"control D1: {pid} overflowed")
        g1 = d1["hosts"]["@dyn:v1"]
        if g1["bindings"] != 1 or d1["group1_state_sigs"] != 1:
            raise AssertionError(
                f"control D1: group 1's graphs were rebound "
                f"({g1['bindings']} bindings, {d1['group1_state_sigs']} "
                "state signatures)")
        if d1["eager_segments"]:
            raise AssertionError("control D1: eager segments")
        # the static plan, left alone by every control event: no event
        # changed its runtime while it applied (binding, graphs, states,
        # staged tapes), one binding (seen bound at 3 control events or
        # more), its rows those of a run without the control plane
        alone = static_alone(fpt, schema, batches)
        st = d1["hosts"]["bench"]
        if sorted(d1["rows"]["matches"]) != sorted(alone["rows"]) \
                or not alone["rows"]:
            raise AssertionError(
                f"control D1: the static plan's {len(d1['rows']['matches'])}"
                f" rows differ from its {len(alone['rows'])} alone")
        if (d1["static_changed_by"] or st["bindings"] != 1
                or st["looks_bound"] < 3 or alone["eager_segments"]):
            raise AssertionError(
                f"control D1: the static plan's runtime {st}, changed by "
                f"{d1['static_changed_by']}")
        d1["static_alone"] = {k: v for k, v in alone.items() if k != "rows"}
        del alone
        part("static_alone")
        d1["oracle_rows_checked"] = ctrl_oracles(fpt, schema, batches,
                                                 d1["rows"], BATCH)
        part("oracles")
        scaled = ctrl_scaled(fpt, "cuda")
        part("scaled")
        if cpu_proc.wait(timeout=600) != 0:
            raise AssertionError("control D1's CPU path failed")
        part("cpu_wait")
        with open(cpu_path) as f:
            cpu = json.load(f)
        for k in ("counters", "plan_ids", "folded"):
            if scaled[k] != cpu[k]:
                raise AssertionError(f"control D1 (65,536 events): {k} "
                                     f"{scaled[k]} != the CPU's {cpu[k]}")
        for s in CTRL_STREAMS:
            if scaled["rows"][s] != cpu["rows"][s]:
                raise AssertionError(f"control D1 (65,536 events): {s}'s "
                                     "rows differ from the CPU path's")
        d1["cpu_check_rows"] = sum(len(r) for r in cpu["rows"].values())
        d1_rows = d1.pop("rows")
        d1["rows"] = {s: len(r) for s, r in d1_rows.items()}
        d2 = ctrl_d2(fpt, schema, batches, d1_rows)
        part("D2")
        d3 = ctrl_d3(fpt, schema, batches)
        part("D3")
        d4 = ctrl_d4(fpt, schema, batches, d1_rows)
        part("D4")
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()
    torch.cuda.synchronize()
    admits = [a for a in d1["applied"] if a[1]]
    out = {"rate": {str(m): r for m, r in rates.items()}, "D1": d1,
           "D2": d2, "D3": d3, "D4": d4,
           "admit_apply_ms": [[a[1], a[2]] for a in admits],
           "part_s": parts, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"control": out}))
    with open(out_path, "w") as f:
        json.dump(out, f)
    torch.save(recorded, out_path + ".pt")


def control_main(out_path):
    """Phase 8i alone (``--control OUT``), run by ``main`` in a child
    process (alone it also builds the CUDA kernels)."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    control_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


# -- phase 8j: subplan sharing and admission ---------------------------------

SHARE_TAPES = 8  # A1, A2: tapes of BATCH of the bench stream (4,194,304)
# the families' prefixes, price < P: 3-10% of the bench stream's uniform
# prices pass each, as bench.py's fleet intends for its own stream
SHARE_PRICES = (3.0, 5.0, 7.0, 10.0)
SHARE_TRACED_TAPES = 1  # A1: tape 1 again, in a profiler trace
SHARE_CPU_TAPE = 8_192  # A1's CPU check: the first 65,536 events, 8 tapes
SHARE_SAVE_AFTER = 4  # A2: cycles (tapes 0-3) before the checkpoint
SHARE_A2_TAPE = BATCH // 4  # A2's tapes (8 of them: 1,048,576 events)
ADMIT_TAPE = 65_536  # A3: the events of each zoo plan's one tape
# A3: the plan zoo and the hostile zoo of the JAX package's
# analysis/zoo.py (its CQL, copied: nothing of that package is imported)
ZOO = {
    "filter_select": "from S[id == 2] select id, name, price insert into out",
    "length_window_agg": (
        "from S#window.length(16) select sum(price) as total, "
        "count() as c insert into out"),
    "time_window_groupby": (
        "from S#window.time(3 sec) select id, avg(price) as a "
        "group by id insert into out"),
    "timebatch_window": (
        "from S#window.timeBatch(2 sec) select sum(price) as s "
        "insert into out"),
    "unique_window": (
        "from S#window.unique(id) select id, price insert into out"),
    "sort_window": (
        "from S#window.sort(8, price) select id, price insert into out"),
    "expired_events": (
        "from S#window.length(4) select id, price "
        "insert expired events into out"),
    "chain_pattern": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2] -> "
        "s3 = S[id == 3] "
        "select s1.price as p1, s3.price as p3 insert into out"),
    "chain_pattern_within": (
        "from every s1 = S[id == 1] -> s2 = S[price > 50.0] "
        "within 5 sec "
        "select s1.id as a, s2.price as p insert into out"),
    "pattern_absence": (
        "from every s1 = S[id == 1] -> not S[id == 9] -> "
        "s2 = S[id == 2] "
        "select s1.price as p1, s2.price as p2 insert into out"),
    "slot_nfa_quantified": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2]<2:4> -> "
        "s3 = S[id == 3] "
        "select s1.price as a, s3.price as b insert into out"),
    "sequence": (
        "from every s1 = S[id == 1], s2 = S[id == 2] "
        "select s1.price as p1, s2.price as p2 insert into out"),
    "window_join": (
        "from S#window.length(8) as a join Trades#window.length(8) "
        "as b on a.id == b.vol "
        "select a.id, b.price insert into out"),
    "join_groupby_rewrite": (
        "from S#window.length(8) as a join Trades#window.length(8) "
        "as b on a.id == b.vol "
        "select a.id, sum(b.price) as total group by a.id "
        "insert into out"),
    "chained_composition": (
        "from S[price > 10.0] select id, price insert into mid; "
        "from mid#window.length(8) select sum(price) as s "
        "insert into out"),
    "multiquery_stack6": "; ".join(
        f"from every s1 = S[id == {i}] -> s2 = S[id == {i + 1}] "
        f"select s1.price as p1, s2.price as p2 insert into out{i}"
        for i in range(6)),
}
# the zoo's unique window selects no aggregate (a select); this one runs
# the unique-window fold (K3)
ZOO_EXTRA = {"unique_window_agg": (
    "from S#window.unique(id) select id, count() as c, sum(price) as s, "
    "max(price) as hi insert into out")}
HOSTILE = {
    "hostile_length_window_1m": (
        "from S#window.length(1048576) select sum(price) as s "
        "insert into out", "ADM101", "default"),
    "hostile_join_amplification": (
        "from S#window.length(131072) as a join "
        "Trades#window.length(131072) as b on a.id == b.vol "
        "select a.id, b.price insert into out", "ADM120", "default"),
    "hostile_pattern_no_within": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2] "
        "select s1.price as p1, s2.price as p2 insert into out",
        "ADM110", "strict"),
    "hostile_eternal_within": (
        "from every s1 = S[id == 1] -> s2 = S[id == 2] within 3600 sec "
        "select s1.price as p1, s2.price as p2 insert into out",
        "ADM111", "strict"),
    "hostile_unbounded_join": (
        "from S as a join Trades as b on a.id == b.vol "
        "select a.id, b.price insert into out", "ADM112", "strict"),
}


def share_fleet():
    """bench.py's ``_subplan_fleet_mix(4, 6)`` with the families'
    predicates ``price < SHARE_PRICES[f]``: per family six structurally
    distinct tenants behind one exact prefix, the sixth the chain pattern
    whose shared suffix runs on K1 and K2. (plan id, tenant, CQL, its
    output stream)."""
    fleet = []
    for f, p in enumerate(SHARE_PRICES):
        pred = f"price < {p}"
        a, b = (f * 11 + 3) % N_IDS, (f * 7 + 1) % N_IDS
        shapes = [
            (f"sh_eq{f}", f"from S[{pred}][id == {a}] "
                          f"select id, price insert into sh_eq{f}"),
            (f"sh_gt{f}", f"from S[{pred}][id > {a}] "
                          f"select id, price insert into sh_gt{f}"),
            (f"sh_lt{f}", f"from S[{pred}][id < {a + 1}] "
                          f"select id, price insert into sh_lt{f}"),
            (f"sh_w{f}", f"from S[{pred}]#window.lengthBatch(128) "
                         f"select sum(price) as tot insert into sh_w{f}"),
            (f"sh_ff{f}", f"from S[{pred}][id == {a}][price > 1.0] "
                          f"select id insert into sh_ff{f}"),
            (f"sh_p{f}", f"from every s1 = S[{pred} and id == {a}] -> "
                         f"s2 = S[{pred} and id == {b}] within 1 sec "
                         "select s1.timestamp as t1, s2.timestamp as t2 "
                         f"insert into sh_p{f}"),
        ]
        for m, (out, cql) in enumerate(shapes):
            fleet.append((f"f{f}m{m}", f"fam{f}", cql, out))
    return fleet


SHARE_OUTS = tuple(t[3] for t in share_fleet())


def share_stream(fpt, n_events, tape):
    """The bench stream as ``S(id int, price double, timestamp long)``."""
    _, batches = bench_stream(fpt, n_events, tape)
    schema = fpt.StreamSchema([("id", "int"), ("price", "double"),
                               ("timestamp", "long")])
    return schema, [
        fpt.EventBatch("S", schema, {k: b.columns[k] for k in
                                     ("id", "price", "timestamp")},
                       b.timestamps)
        for b in batches]


def share_compiler(fpt, schemas):
    return lambda cql, pid: fpt.compile_plan(cql, schemas, plan_id=pid)


def share_job(fpt, schema, batches, device, share, control,
              time_mode="processing", fused=True):
    job = fpt.Job(
        [], [fpt.BatchSource("S", schema, iter(batches))],
        batch_size=len(batches[0]), time_mode=time_mode, device=device,
        control_sources=[control],
        plan_compiler=share_compiler(fpt, {"S": schema}))
    job.share_subplans = share
    if fused:
        # bench.py's segment and the Job's own accumulator ring: a
        # loopback consumer's segments are one tape (Job._fused_k)
        job.fused_segment_len = FUSED_K
    return job


def admit_fleet(fpt, job, ctrl, schema):
    """The fleet through ControlPlane with the admission gate (default
    budgets; the job re-checks at apply time under the same): the gate's
    ms over the 24 CQL strings, on this thread."""
    from flink_siddhi_tpu_torch.analysis import DEFAULT_BUDGETS

    job.admission_budgets = DEFAULT_BUDGETS
    plane = fpt.ControlPlane(job, ctrl, gate=fpt.AdmissionGate(
        share_compiler(fpt, {"S": schema}), budgets=DEFAULT_BUDGETS))
    t0 = time.perf_counter()
    for pid, tenant, cql, _ in share_fleet():
        plane.admit(cql, plan_id=pid, tenant=tenant, timestamp_ms=0)
    ctrl.close()
    return (time.perf_counter() - t0) * 1e3


class LoopbackWatch:
    """Wraps ``job._feed_loopback`` and ``job._flush_loopback``: the mid
    rows the hosts fed, and the host seconds spent feeding and flushing
    (the flush steps the suffixes)."""

    def __init__(self, job):
        self.rows = 0
        self.seconds = 0.0
        feed, flush = job._feed_loopback, job._flush_loopback

        def fed(schema, rows):
            t0 = time.perf_counter()
            feed(schema, rows)
            self.rows += len(rows)
            self.seconds += time.perf_counter() - t0

        def flushed(force=False):
            t0 = time.perf_counter()
            flush(force)
            self.seconds += time.perf_counter() - t0

        job._feed_loopback, job._flush_loopback = fed, flushed


def share_hosts(job):
    return {e["host"]: sorted(e["members"])
            for e in job.control_status()["shared"].values()}


def share_rows(job):
    return {s: sorted(job.results_with_ts(s)) for s in SHARE_OUTS}


def share_same(got, ref, what):
    """Each tenant's rows of ``got`` against ``ref``: equal, float values
    within WINDOW_RTOL (a window's sum is a difference of float64 running
    sums over the tapes its rows ride, and a suffix's tapes are the mid
    stream's, so the rounding to float32 can move by an ulp). Returns the
    largest relative difference."""
    worst = 0.0
    for s in SHARE_OUTS:
        worst = max(worst, rows_match(got[s], ref[s], WINDOW_RTOL,
                                      f"{what}: {s}"))
    return worst


def share_key(row):
    """A row's identity for the duplicate and lost counts: its timestamp
    and its non-float values (floats are held by ``share_same``)."""
    t, r = row
    return t, tuple(None if isinstance(v, float) else v for v in r)


class TenantSink:
    """A columnar sink (``accept_columns``): one tenant's rows as arrays,
    so that no tenant row becomes a tuple (nor a mid row: the loopback
    takes columns)."""

    def __init__(self):
        self.parts = []

    def accept_columns(self, ts, cols):
        self.parts.append((np.asarray(ts), {k: np.asarray(v)
                                            for k, v in cols.items()}))

    def rows(self):
        """(timestamps, [columns]) in (ts, column values) order."""
        if not self.parts:
            return np.zeros(0, np.int64), []
        ts = np.concatenate([p[0] for p in self.parts])
        names = list(self.parts[0][1])
        cols = [np.concatenate([p[1][n] for p in self.parts])
                for n in names]
        order = np.lexsort(cols[::-1] + [ts])
        return ts[order], [c[order] for c in cols]


def cols_same(got, ref, what):
    """Each tenant's columnar rows against ``ref``'s: equal, float columns
    within WINDOW_RTOL (see ``share_same``). Returns the largest relative
    difference."""
    worst = 0.0
    for s in SHARE_OUTS:
        (tg, cg), (tr, cr) = got[s], ref[s]
        if not np.array_equal(tg, tr) or len(cg) != len(cr):
            raise AssertionError(f"{what}: {s}'s rows differ ({len(tg)} "
                                 f"against {len(tr)})")
        for a, b in zip(cg, cr):
            if a.dtype.kind == "f":
                rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
                w = float(rel.max()) if len(rel) else 0.0
                if not w <= WINDOW_RTOL:
                    raise AssertionError(f"{what}: {s}'s values differ "
                                         f"by {w}")
                worst = max(worst, w)
            elif not np.array_equal(a, b):
                raise AssertionError(f"{what}: {s}'s values differ")
    return worst


def share_side(fpt, co, schema, batches, share):
    """A1, one side: the fleet admitted before tape 0, a columnar sink on
    each tenant's stream, the fused Job over tape 0 (the warm-up: its
    captures), then timed over tapes 1-7 with the closing drain
    (bench.py's timed window), then tape 1 again in a profiler trace (K1
    and K2 on the card, equal to the host's counts)."""
    import torch

    t_side = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t_side - sum(parts.values())

    ctrl = fpt.ControlQueueSource()
    job = share_job(fpt, schema, batches[:1], "cuda", share, ctrl)
    job.retain_results = False
    sinks = {}
    for s in SHARE_OUTS:
        sinks[s] = TenantSink()
        job.add_sink(s, sinks[s])
    gate_ms = admit_fleet(fpt, job, ctrl, schema)
    watch = LoopbackWatch(job)
    part("admit")
    job.run()
    job.drain_outputs()
    torch.cuda.synchronize()
    warm = {pid: (rt.graphs.captured if rt.graphs is not None else 0)
            for pid, rt in job._plans.items()}
    part("warm_tape")
    re_source(fpt, job, schema, batches[1:], stream="S")
    co.reset_launches()
    lb0 = (watch.rows, watch.seconds)
    t0 = time.perf_counter()
    job.run()
    job.drain_outputs()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    part("timed")
    launches = co.launch_counts()
    n = sum(len(b) for b in batches[1:])
    rows = {s: sinks[s].rows() for s in SHARE_OUTS}
    part("rows")
    captured = {pid: (rt.graphs.captured if rt.graphs is not None else 0)
                for pid, rt in job._plans.items()}
    emitted = dict(job.emitted_counts)
    st = job.control_status()["counters"]
    out = {
        "share": share, "events": n, "run_s": wall, "events_per_s": n / wall,
        "plans": len(job._plans), "tenants": len(job.plan_ids),
        "hosts": share_hosts(job),
        "subplan_share": st.get("subplan_share", 0),
        "stack_join": st.get("stack_join", 0),
        "admitted": st.get("admitted", 0), "preclear": st.get("preclear", 0),
        "admission_rejected": st.get("admission_rejected", 0),
        "gate_ms_24": gate_ms,
        "graphs_captured": job.graphs_captured,
        "graphs_captured_after_warmup": {
            p: captured[p] - warm.get(p, 0) for p in captured
            if captured[p] != warm.get(p, 0)},
        # each suffix runtime's graphs (a folded suffix's: its group's)
        "suffix_graphs": {p: captured[p] for p, rt in job._plans.items()
                          if any(s.startswith("_shr_")
                                 for s in rt.plan.spec.stream_codes)},
        "eager_segments": job.eager_segments,
        "loopback_rows": watch.rows - lb0[0],
        "loopback_host_s": watch.seconds - lb0[1],
        "launches": {k: launches[k] for k in
                     ("multi_reverse_cummin", "chain_advance")},
        "dropped_events": (SHARE_TAPES * BATCH - job.processed_events
                           - job.shed_events - job.late_dropped),
        "emitted": sum(emitted.values()),
        "rows": sum(len(r[0]) for r in rows.values()),
    }
    # the loopback's flush chunks never regrew a suffix's tape
    for pid, rt in job._plans.items():
        if any(s.startswith("_shr_") for s in rt.plan.spec.stream_codes) \
                and rt.tape_capacity != BATCH:
            raise AssertionError(f"share A1: suffix {pid}'s tape grew to "
                                 f"{rt.tape_capacity}")
    # rows attributed to tenants sum to the job's emitted total: the mid
    # streams count nowhere (hosts are plumbing)
    if any(s.startswith("_shr_") for s in emitted) or \
            sum(emitted.get(s, 0) for s in SHARE_OUTS) != out["emitted"]:
        raise AssertionError(f"share A1: emitted {emitted} is not the "
                             "tenants' rows alone")
    for s in SHARE_OUTS:
        if emitted.get(s, 0) != len(rows[s][0]):
            raise AssertionError(f"share A1: {s} counted {emitted.get(s)}"
                                 f" rows, its sink took {len(rows[s][0])}")
    if out["dropped_events"]:
        raise AssertionError(f"share A1: {out['dropped_events']} events "
                             "dropped")

    def traced():
        t0 = time.perf_counter()
        job.run()
        job.drain_outputs()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, traced_s, traced_k = traced_run(
        co, traced, f"share A1 ({'shared' if share else 'unshared'})",
        prepare=lambda: re_source(
            fpt, job, schema, batches[1:1 + SHARE_TRACED_TAPES],
            stream="S"), host_ops=False)
    out["traced_idle_share"] = traced_share(
        prof, traced_s, 1, 1)["traced_idle_share"]
    del prof
    out["launches_traced"] = {k: traced_k[k] for k in
                              ("multi_reverse_cummin", "chain_advance")}
    for k, c in out["launches_traced"].items():
        if not c:
            raise AssertionError(f"share A1: {k} never ran on the card")
    part("traced")
    out["part_s"] = parts
    del job
    return out, rows


def share_scaled(fpt, device):
    """A1's row check: the fleet over the first 65,536 events of the bench
    stream in tapes of SHARE_CPU_TAPE, shared and unshared, one step a
    tape."""
    schema, batches = share_stream(fpt, BATCH, BATCH)
    first = batches[0]
    tapes = [first.slice(s, s + SHARE_CPU_TAPE)
             for s in range(0, 8 * SHARE_CPU_TAPE, SHARE_CPU_TAPE)]
    out = {}
    for share in (False, True):
        ctrl = fpt.ControlQueueSource()
        job = share_job(fpt, schema, tapes, device, share, ctrl,
                        fused=False)
        admit_fleet(fpt, job, ctrl, schema)
        job.run()
        out["shared" if share else "unshared"] = {
            s: [[t, list(r)] for t, r in rows]
            for s, rows in share_rows(job).items()}
    return out


def share_cpu_main(out_path):
    """A1's CPU path (``--share-cpu OUT``), as JSON to OUT; phase 8j starts
    it first, so that it runs beside the card's runs."""
    import torch

    import flink_siddhi_tpu_torch as fpt

    torch.set_num_threads(4)
    with open(out_path, "w") as f:
        json.dump(share_scaled(fpt, "cpu"), f)
    return 0


def share_timeline(fpt, tape):
    """A2's timeline in event time, at boundaries of tapes of ``tape``
    events: the fleet before tape 0, family 0's six members retired at
    tape 2 (its host drops), one of its shapes re-admitted at tape 3 (the
    host re-forms)."""
    from flink_siddhi_tpu_torch.control.events import MetadataControlEvent

    def at(k):
        return 1000 + k * tape

    add = MetadataControlEvent.builder()
    fleet = share_fleet()
    for pid, _, cql, _ in fleet:
        add.add_execution_plan(cql, plan_id=pid)
    drop = MetadataControlEvent.builder()
    for pid, _, _, _ in fleet[:6]:
        drop.remove_execution_plan(pid)
    again = MetadataControlEvent.builder()
    again.add_execution_plan(fleet[0][2], plan_id="f0r")
    return [(0, add.build()), (at(2), drop.build()), (at(3), again.build())]


def share_a2(fpt, schema, batches):
    """A2 over SHARE_TAPES tapes of SHARE_A2_TAPE events in event time, one
    step a tape: family 0's members retired (its host drops,
    ``subplan_unshare`` 1) and one re-admitted (the host re-forms); a
    checkpoint after tape 3 with the share table restored into a fresh Job
    that runs tapes 4-7 (0 duplicated and 0 lost rows against the
    uninterrupted run)."""
    import torch

    tape = len(batches[0])

    def job_of(tapes, control):
        return share_job(fpt, schema, tapes, "cuda", True,
                         fpt.ControlListSource(control), time_mode="event",
                         fused=False)

    whole = job_of(batches, share_timeline(fpt, tape))
    t0 = time.perf_counter()
    whole.run()
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    hosts = share_hosts(whole)
    counters = whole.control_status()["counters"]
    fam0 = [h for h, m in hosts.items() if m == ["f0r"]]
    if counters.get("subplan_unshare") != 1 or len(hosts) != 4 or not fam0:
        raise AssertionError(f"share A2: hosts {hosts}, counters "
                             f"{counters}")
    whole_rows = share_rows(whole)
    del whole
    first = job_of(batches, share_timeline(fpt, tape))
    first.run(max_cycles=SHARE_SAVE_AFTER)
    path = os.path.join(SMOKE_DIR, "share_ckpt.bin")
    t0 = time.perf_counter()
    first.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    saved_hosts = share_hosts(first)
    before = share_rows(first)
    del first
    job = job_of(batches[SHARE_SAVE_AFTER:], [])
    t0 = time.perf_counter()
    job.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if share_hosts(job) != saved_hosts:
        raise AssertionError("share A2: the restore re-formed other hosts")
    job.run()
    after = share_rows(job)
    dup = lost = 0
    split = {}
    for s in SHARE_OUTS:
        got = before[s] + after[s]
        keys = [share_key(r) for r in got]
        dup += len(keys) - len(set(keys))
        lost += len({share_key(r) for r in whole_rows[s]} - set(keys))
        split[s] = sorted(got)
    rel_split = share_same(split, whole_rows, "share A2 across the restore")
    if dup or lost:
        raise AssertionError(f"share A2: {dup} duplicated, {lost} lost rows "
                             "across the restore")
    snapshot_bytes = os.path.getsize(path)
    os.remove(path)
    del job
    out = {"tape": tape, "whole_s": whole_s, "hosts_after_readmit": hosts,
           "subplan_unshare": counters.get("subplan_unshare"),
           "subplan_share": counters.get("subplan_share"),
           "hosts_at_save": len(saved_hosts), "save_s": save_s,
           "restore_s": restore_s, "snapshot_bytes": snapshot_bytes,
           "rows": sum(len(r) for r in whole_rows.values()),
           "duplicate_rows": dup, "lost_rows": lost,
           "max_rel_split": rel_split}
    return out


def share_resident(fpt, schema, batches, fused_rows):
    """A2's resident run: the fleet (admitted at ts 0) through
    ResidentReplay in epochs over A1's 8 tapes, with a columnar sink on
    each tenant's stream: rows equal to A1's fused shared run's."""
    import torch

    job = share_job(fpt, schema, batches, "cuda", True,
                    fpt.ControlListSource(share_timeline(fpt, BATCH)[:1]),
                    time_mode="event", fused=False)
    job.retain_results = False
    sinks = {s: TenantSink() for s in SHARE_OUTS}
    for s, sink in sinks.items():
        job.add_sink(s, sink)
    watch = LoopbackWatch(job)
    t0 = time.perf_counter()
    rep = fpt.ResidentReplay(job)
    rep.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = cols_same({s: sinks[s].rows() for s in SHARE_OUTS}, fused_rows,
                    "share A2, resident against A1's fused run")
    out = {"wall_s": wall, "events_per_s": job.processed_events / wall,
           "epochs": len(rep._epochs), "stage_s": rep.stage_seconds,
           "graphs_captured": job.graphs_captured,
           "eager_segments": job.eager_segments,
           "hosts": len(share_hosts(job)), "loopback_rows": watch.rows,
           "loopback_host_s": watch.seconds, "max_rel_fused": rel}
    del job, rep
    return out


def zoo_schemas(fpt):
    return {
        "S": fpt.StreamSchema([("id", "int"), ("name", "string"),
                               ("price", "double"), ("timestamp", "long")]),
        "Trades": fpt.StreamSchema([("sym", "string"), ("price", "double"),
                                    ("vol", "int"), ("timestamp", "long")]),
    }


def zoo_tapes(fpt, schemas, n, seed=11):
    """One tape of ``n`` events of each zoo stream (ids and volumes in
    [0, 50), prices uniform x 100, 1 ms apart), as EventBatches."""
    rng = np.random.default_rng(seed)
    ts = 1000 + np.arange(n, dtype=np.int64)
    s, t = schemas["S"], schemas["Trades"]
    names = np.array([s.string_tables["name"].intern(x)
                      for x in ("a", "b", "c")], np.int32)
    syms = np.array([t.string_tables["sym"].intern(x)
                     for x in ("IBM", "WSO2", "ORCL")], np.int32)
    return {
        "S": fpt.EventBatch("S", s, {
            "id": rng.integers(0, N_IDS, n).astype(np.int32),
            "name": names[rng.integers(0, 3, n)],
            "price": rng.random(n) * 100.0, "timestamp": ts}, ts),
        "Trades": fpt.EventBatch("Trades", t, {
            "sym": syms[rng.integers(0, 3, n)],
            "price": rng.random(n) * 100.0,
            "vol": rng.integers(0, N_IDS, n).astype(np.int32),
            "timestamp": ts}, ts),
    }


def admit_zoo(fpt, co):
    """A3's plans: each zoo plan analyzed (the deep tier on meta tensors,
    default budgets: admitted), its apply-time static tier timed, then
    one tape of ADMIT_TAPE events of each stream on the card with the
    admitted footprint recorded (state and a full accumulator ring):
    measured bytes at most admitted, no overrun, and the measured bytes
    live on the card: at most what the caching allocator counts as held
    since before the Job (``torch.cuda.memory_allocated``); the rest of
    what it holds (tapes, graph slots and pools) is outside the meter and
    reported. The unique-window fold (K3) runs in ``unique_window_agg``."""
    import torch

    from flink_siddhi_tpu_torch.analysis import (
        DEFAULT_BUDGETS,
        analyze_plan,
        verify_plan,
    )

    out = {}
    k3 = 0
    for name, cql in {**ZOO, **ZOO_EXTRA}.items():
        schemas = zoo_schemas(fpt)
        plan = fpt.compile_plan(cql, schemas, plan_id=name)
        t0 = time.perf_counter()
        issues = verify_plan(plan, trace=False, raise_on_error=False)
        static = analyze_plan(plan, deep=False)
        static_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rep = analyze_plan(plan, budgets=DEFAULT_BUDGETS, deep=True)
        deep_ms = (time.perf_counter() - t0) * 1e3
        if issues or static.findings or not rep.admitted:
            raise AssertionError(f"share A3: {name} refused: "
                                 f"{[i.render() for i in issues]} "
                                 f"{[i.render() for i in rep.findings]}")
        tapes = zoo_tapes(fpt, schemas, ADMIT_TAPE)
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated()
        job = fpt.Job([plan], [fpt.BatchSource(sid, schemas[sid],
                                               iter([tapes[sid]]))
                               for sid in ("S", "Trades")],
                      batch_size=ADMIT_TAPE, time_mode="processing",
                      device="cuda", retain_results=False)
        job.set_admitted_footprint(
            name, job.admitted_bytes(rep.state_bytes, rep.acc_bytes))
        co.reset_launches()
        job.run()
        job.drain_outputs()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - held0
        launches = co.launch_counts()
        k3 += launches["unique_window_fold"]
        fp = job.footprint_status()[name]
        overruns = job.telemetry.snapshot()["counters"].get(
            "footprint.overruns", 0)
        if fp["measured_bytes"] > fp["admitted_bytes"] or overruns:
            raise AssertionError(f"share A3: {name} measured {fp} "
                                 f"({overruns} overruns)")
        if fp["measured_bytes"] > held:
            raise AssertionError(
                f"share A3: {name} meter counts {fp['measured_bytes']} B, "
                f"the allocator holds {held} B for the Job")
        out[name] = {
            "state_bytes": rep.state_bytes, "acc_bytes": rep.acc_bytes,
            "admitted_bytes": fp["admitted_bytes"],
            "ring": len(job._plans[name].ring),
            "measured_bytes": fp["measured_bytes"],
            "allocator_held_bytes": held,
            "unmetered_bytes": held - fp["measured_bytes"],
            "utilization": fp["utilization"],
            "amplification": rep.amplification,
            "residency_ms": (None if rep.residency_ms is None
                             else float(rep.residency_ms)),
            "static_tier_ms": static_ms, "deep_tier_ms": deep_ms,
            "emitted": sum(job.emitted_counts.values()),
            "launches": {k: v for k, v in launches.items() if v}}
        del job
    if not out["unique_window_agg"]["launches"].get("unique_window_fold"):
        raise AssertionError("share A3: the unique-window fold never ran")
    return out, k3


def admit_during_capture(fpt, co):
    """A3's gate while the run loop captures graphs: a fused Job in
    processing time, fed a tape a cycle, takes the zoo through
    QueryControlService with the admission gate (default budgets) on a
    REST thread, while its run loop applies the admits and captures each
    new runtime's segment graphs; the hostile zoo posted to services whose
    gate holds each entry's profile (HTTP 422 with its exact rule id);
    then each hostile entry pushed raw past the gate and refused at apply
    time by the same rule id. After the posts the gate runs on over the
    zoo on the same thread until the run loop captured graphs during one
    of its calls. The gate's ms per CQL; no capture error."""
    import threading
    import urllib.error
    import urllib.request

    import torch

    from flink_siddhi_tpu_torch.analysis import (
        DEFAULT_BUDGETS,
        STRICT_BUDGETS,
    )
    from flink_siddhi_tpu_torch.control.events import MetadataControlEvent

    profiles = {"default": DEFAULT_BUDGETS, "strict": STRICT_BUDGETS}
    schemas = zoo_schemas(fpt)
    compiler = share_compiler(fpt, schemas)
    src = FeedSource(schemas["S"], "S")
    ctrl = fpt.ControlQueueSource()
    job = fpt.Job([], [src], batch_size=SHARE_CPU_TAPE,
                  time_mode="processing", device="cuda",
                  control_sources=[ctrl], plan_compiler=compiler,
                  retain_results=False)
    # segments of 2 tapes: each new runtime captures within the few
    # cycles the gate's calls take (this part times no throughput)
    job.fused_segment_len = 2
    job.admission_budgets = DEFAULT_BUDGETS
    gates = {p: fpt.AdmissionGate(compiler, budgets=b)
             for p, b in profiles.items()}
    svcs = {p: fpt.QueryControlService(ctrl, job=job,
                                       admission=gates[p]).start()
            for p in profiles}
    gate_ms, refused, errors = {}, {}, []
    state = {"done": False, "captures": [], "overlapping": 0, "calls": 0}

    def captured():
        # the CPU (the dry run) captures nothing; its keys still count
        return (job.graphs_captured if job.device.type == "cuda"
                else job.graph_keys)

    def post(profile, name, cql):
        req = urllib.request.Request(
            f"http://127.0.0.1:{svcs[profile].port}/api/v1/queries",
            data=json.dumps({"cql": cql, "id": name}).encode(),
            method="POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read()), \
                    (time.perf_counter() - t0) * 1e3
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), \
                (time.perf_counter() - t0) * 1e3

    def rest():
        try:
            state["captures"].append((job.graph_keys, job.graphs_captured))
            for name, cql in {**ZOO, **ZOO_EXTRA}.items():
                code, body, ms = post("default", name, cql)
                if code != 201 or not body["admission"]["admitted"]:
                    errors.append((name, code, body))
                gate_ms[name] = ms
            for name, (cql, rule, profile) in HOSTILE.items():
                code, body, ms = post(profile, name, cql)
                refused[name] = {"http": code, "rules": body.get("rules"),
                                 "gate_ms": ms}
                if code != 422 or rule not in body.get("rules", ()):
                    errors.append((name, code, body))
            # the posts return once their events are pushed, and the
            # run loop applies and captures over its next cycles: the
            # gate goes on over the zoo on this thread until a capture
            # has run during one of its calls
            deadline = time.perf_counter() + 120
            cqls = list({**ZOO, **ZOO_EXTRA}.values())
            while not state["overlapping"]:
                if time.perf_counter() > deadline:
                    raise AssertionError("no capture during a gate call")
                c = captured()
                gates["default"](cqls[state["calls"] % len(cqls)])
                state["calls"] += 1
                state["overlapping"] += captured() > c
            state["captures"].append((job.graph_keys, job.graphs_captured))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(("rest thread", repr(e)))
        finally:
            state["done"] = True

    th = threading.Thread(target=rest)
    schema = schemas["S"]
    base = zoo_tapes(fpt, schemas, SHARE_CPU_TAPE)["S"]
    cycles = 0
    try:
        th.start()
        deadline = time.perf_counter() + 300
        while not state["done"] or cycles < 4:
            ts = base.timestamps + cycles * SHARE_CPU_TAPE
            src.queue.append(fpt.EventBatch("S", schema, dict(
                base.columns, timestamp=ts), ts))
            job.run_cycle()
            cycles += 1
            if time.perf_counter() > deadline:
                raise AssertionError("share A3: the REST thread hung")
        th.join()
        for _ in range(4):  # the last admits apply and capture
            ts = base.timestamps + cycles * SHARE_CPU_TAPE
            src.queue.append(fpt.EventBatch("S", schema, dict(
                base.columns, timestamp=ts), ts))
            job.run_cycle()
            cycles += 1
        job.drain_outputs()
        torch.cuda.synchronize()
    finally:
        for svc in svcs.values():
            svc.stop()
    if errors:
        raise AssertionError(f"share A3: {errors}")
    (k0, c0), (k1, c1) = state["captures"]
    if k1 <= k0 or (job.device.type == "cuda" and c1 <= c0):
        raise AssertionError("share A3: no graph was captured while the "
                             "gate ran")
    if set(job.plan_ids) != set(ZOO) | set(ZOO_EXTRA):
        raise AssertionError(f"share A3: live plans {sorted(job.plan_ids)}")
    # apply time: each hostile entry pushed raw (no verdict) under its
    # profile's budgets, refused by the same rule id
    apply = {}
    for name, (cql, rule, profile) in HOSTILE.items():
        job.admission_budgets = profiles[profile]
        b = MetadataControlEvent.builder()
        b.add_execution_plan(cql, plan_id=f"raw:{name}")
        ctrl.push(b.build())
        t0 = time.perf_counter()
        job.run_cycle()
        apply[name] = (time.perf_counter() - t0) * 1e3
        rules = job.control_rejections.get(f"raw:{name}", {}).get("rules")
        if not rules or rule not in rules or f"raw:{name}" in job.plan_ids:
            raise AssertionError(f"share A3: {name} at apply time: {rules}")
        refused[name]["apply_rules"] = rules
        refused[name]["apply_cycle_ms"] = apply[name]
    out = {"cycles": cycles, "graphs_captured": job.graphs_captured,
           "graph_keys_while_gating": k1 - k0,
           "captured_while_gating": c1 - c0,
           "gate_calls_after_posts": state["calls"],
           "eager_segments": job.eager_segments,
           "gate_ms": gate_ms, "hostile": refused,
           "preclear": job.control_status()["counters"].get("preclear", 0)}
    del job
    return out


def share_phase(fpt, co, out_path):
    """Phase 8j: A1 (the fleet, shared and unshared), A2 (retire, restore,
    resident) and A3 (admission), see the module docstring."""
    import torch

    t_phase = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    os.makedirs(SMOKE_DIR, exist_ok=True)
    cpu_path = os.path.join(SMOKE_DIR, "share_cpu.json")
    cpu_proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--share-cpu", cpu_path])
    try:
        schema, batches = share_stream(fpt, SHARE_TAPES * BATCH, BATCH)
        unshared, u_rows = share_side(fpt, co, schema, batches, False)
        part("A1_unshared")
        shared, s_rows = share_side(fpt, co, schema, batches, True)
        part("A1_shared")
        rel_sides = cols_same(s_rows, u_rows, "share A1, shared against "
                              "unshared")
        del u_rows
        resident = share_resident(fpt, schema, batches, s_rows)
        del s_rows
        part("A2_resident")
        if shared["subplan_share"] != 24 or len(shared["hosts"]) != 4:
            raise AssertionError(f"share A1: {shared['subplan_share']} "
                                 f"shares, hosts {shared['hosts']}")
        scaled = share_scaled(fpt, "cuda")
        part("A1_scaled")
        if cpu_proc.wait(timeout=600) != 0:
            raise AssertionError("share A1's CPU path failed")
        part("cpu_wait")
        with open(cpu_path) as f:
            cpu = json.load(f)
        def tuples(rows):
            return {s: [(t, tuple(r)) for t, r in rows[s]]
                    for s in SHARE_OUTS}

        ref = tuples(cpu["unshared"])
        rel_cpu = max(
            share_same(tuples(rows[side]), ref,
                       f"share A1 (65,536 events), {where} {side}")
            for where, rows in (("card", scaled), ("CPU", cpu))
            for side in ("unshared", "shared"))
        cpu_rows = sum(len(r) for r in cpu["unshared"].values())
        schema2, small = share_stream(fpt, SHARE_TAPES * SHARE_A2_TAPE,
                                      SHARE_A2_TAPE)
        a2 = share_a2(fpt, schema2, small)
        a2["resident"] = resident
        part("A2")
        zoo, k3 = admit_zoo(fpt, co)
        part("A3_zoo")
        gate = admit_during_capture(fpt, co)
        part("A3_gate")
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()
    torch.cuda.synchronize()
    out = {"A1": {"unshared": unshared, "shared": shared,
                  "speedup": shared["events_per_s"]
                  / unshared["events_per_s"],
                  "rows": shared["rows"], "cpu_check_rows": cpu_rows,
                  "max_rel_shared_unshared": rel_sides,
                  "max_rel_cpu": rel_cpu},
           "A2": a2, "A3": {"zoo": zoo, "gate": gate},
           "launches": {"K1": shared["launches_traced"][
                            "multi_reverse_cummin"],
                        "K2": shared["launches_traced"]["chain_advance"],
                        "K3": k3},
           "part_s": parts, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"share": out}))
    with open(out_path, "w") as f:
        json.dump(out, f)


def share_main(out_path):
    """Phase 8j alone (``--share OUT``), run by ``main`` in a child
    process (alone it also builds the CUDA kernels)."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    share_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0



# -- phase 8k: telemetry on the card ----------------------------------------

TEL_TAPES = 8  # T1: tapes of BATCH of the bench stream (4,194,304)
TEL_CPU_EVENTS = 131_072  # T1: resident rows against the CPU path over these
TEL_PROBES = 200  # T2: sentinel triples, one a period
TEL_PROBE_PERIOD_S = 0.02
TEL_PROBE_MAGIC = 1_000_000.0  # T2: a probe's s3.price, MAGIC + its number
TEL_PROBE_T0 = 2_000_000_000  # T2: triple k at T0 + 10 s x k (+0, 1, 2 ms)
TEL_CTRL_TAPES = 4  # T3: tapes of BATCH in each of the three modes
TEL_CTRL_CPU_TAPE = 8_192  # T3's card-against-CPU check: 4 tapes of 8,192
TEL_TENANTS = {"v1": "acme", "v2": "acme", "v3": "bobcorp"}

# the reference suite's standalone Prometheus text checker
# (tests/test_scoped_metrics.py): the port's one copy, which the port's
# telemetry tests import from here

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{[^{}]*\})?"
    r" (-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)$"
)
LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_VALID_TYPES = ("counter", "gauge", "summary", "histogram", "untyped")


def check_prometheus_text(text):
    """Standalone Prometheus text-format (0.0.4) checker — no client
    dependency. Every line must be blank, a comment, or a parsable
    ``name{labels} value`` sample; every sample's family must have
    exactly one TYPE declared before its samples; counter values
    non-negative; all values finite. Returns (n_samples, types)."""
    types_ = {}
    n_samples = 0
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            assert len(parts) == 4, f"line {ln}: malformed TYPE"
            name, mtype = parts[2], parts[3]
            assert mtype in _VALID_TYPES, f"line {ln}: {mtype!r}"
            assert name not in types_, (
                f"line {ln}: duplicate TYPE for {name}"
            )
            types_[name] = mtype
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"line {ln}: unparsable sample {line!r}"
        name, labels, value = m.group(1), m.group(2), m.group(3)
        family = name
        for suffix in ("_count", "_sum"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and base in types_:
                family = base
        assert family in types_, (
            f"line {ln}: sample {name} has no TYPE declaration"
        )
        v = float(value)
        assert math.isfinite(v), f"line {ln}: non-finite {value}"
        if types_[family] == "counter":
            assert v >= 0, f"line {ln}: negative counter"
        if labels:
            body = labels[1:-1]
            pairs = LABEL_RE.findall(body)
            rebuilt = ",".join(f'{k}="{v2}"' for k, v2 in pairs)
            assert rebuilt == body, (
                f"line {ln}: malformed labels {labels!r}"
            )
        n_samples += 1
    return n_samples, types_


def tel_overhead(fpt, co, schema, batches):
    """T1: the fused counts-only headline over the tapes, as bench.py's
    streaming mode runs it: a warm run (the captures), then A B B A runs
    of the same Job (reset and re-sourced) with the registry disabled (A:
    spans, tracer, journal and SLO silenced) and enabled at the default
    ``sample_every`` (B): events/s of each, K1 and K2 launches of each.
    Then one resident replay of the same tapes with the registry on and
    a collector: its rows over the first TEL_CPU_EVENTS events against
    the CPU path's, ``trace.e2e`` and ``drain.staleness`` p50/p99, and the
    limiting leg of ``metrics()["attribution"]``."""
    import torch

    cfg = bench_config(fpt)
    n = sum(len(b) for b in batches)
    job = fused_job(fpt, HEADLINE, schema, batches, False, cfg)
    job.run()
    torch.cuda.synchronize()
    captured = job.graphs_captured
    counts = sum(job.emitted_counts.values())
    kernels = ("multi_reverse_cummin", "chain_advance")
    sides = []
    for enabled in (False, True, True, False):
        job.reset_engine_state()
        re_source(fpt, job, schema, batches)
        job.telemetry.enabled = enabled
        before = sum(job.emitted_counts.values())
        co.reset_launches()
        t0 = time.perf_counter()
        job.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = co.launch_counts()
        if sum(job.emitted_counts.values()) - before != counts:
            raise AssertionError("telemetry T1: a run emitted another count")
        if not all(launches[k] for k in kernels):
            raise AssertionError(f"telemetry T1: {launches}")
        sides.append({"telemetry": enabled, "run_s": wall,
                      "events_per_s": n / wall,
                      "launches": {k: launches[k] for k in kernels}})
    if job.eager_segments or job.graphs_captured != captured:
        raise AssertionError(
            f"telemetry T1: {job.eager_segments} eager segments, "
            f"{job.graphs_captured - captured} captures after the warm run")
    off = statistics.median(s["events_per_s"] for s in sides
                            if not s["telemetry"])
    on = statistics.median(s["events_per_s"] for s in sides
                           if s["telemetry"])
    sampled = job.tracer.snapshot()["sampled"]
    profile = tel_host_profile(fpt, job, schema, batches)
    del job

    # the resident replay with the registry on and a collector
    cut = batches[0].slice(0, TEL_CPU_EVENTS)
    cpu_rows, _, _ = run_job(fpt, HEADLINE, schema, [cut], "cpu",
                             config=cfg)
    job = replay_job(fpt, HEADLINE, schema, batches, True)
    co.reset_launches()
    rep = fpt.ResidentReplay(job)
    t0 = time.perf_counter()
    rep.stage()
    rep.run()
    job.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = co.launch_counts()
    rows = job.results_with_ts("matches")
    last = int(cut.timestamps[-1])
    rows_match([r for r in rows if r[0] <= last], cpu_rows, 0.0,
               "telemetry T1: resident rows against the CPU path")
    if not cpu_rows or not all(launches[k] for k in kernels):
        raise AssertionError(f"telemetry T1 resident: {len(cpu_rows)} CPU "
                             f"rows, launches {launches}")
    m = job.metrics()
    hists = m["telemetry"]["histograms"]
    trace = m["telemetry"]["trace"]
    att = m["attribution"]
    rows_by_plan = m["telemetry"]["scopes"]["plan"]["bench"]["counters"][
        "rows_emitted"]
    if rows_by_plan != len(rows) or trace["completed"] < 1:
        raise AssertionError(f"telemetry T1 resident: {rows_by_plan} rows "
                             f"attributed of {len(rows)}, trace {trace}")

    def p(h):
        return {"count": h["count"], "p50_ms": h["p50_ms"],
                "p99_ms": h["p99_ms"]}

    out = {
        "events": n, "sides": sides,
        "events_per_s_off": off, "events_per_s_on": on,
        "ratio_on_off": on / off, "sampled_per_run": sampled,
        "host_profile": profile,
        "resident": {
            "events": n, "wall_s": wall, "rows": len(rows),
            "cpu_check_rows": len(cpu_rows),
            "launches": {k: launches[k] for k in kernels},
            "trace_sampled": trace["sampled"],
            "trace_completed": trace["completed"],
            "trace_e2e": p(trace["e2e"]),
            "drain_staleness": p(hists["drain.staleness"]),
            "limiting_leg": att["limiting_leg"],
            "limiting_share": att["limiting_share"],
            "coverage": att["coverage"],
        },
    }
    del job, rep
    return out


def tel_host_profile(fpt, job, schema, batches):
    """T1's host profile: one more run each way (registry on, then off)
    under cProfile, after the timed ones. Returns the profiled seconds of
    each run, and the functions whose own time grows most with the
    registry on, in ms a tape, with their calls in the on run: where the
    telemetry's host time goes."""
    import cProfile
    import pstats

    import torch

    own = {}
    wall = {}
    for enabled in (True, False):
        job.reset_engine_state()
        re_source(fpt, job, schema, batches)
        job.telemetry.enabled = enabled
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        job.run()
        torch.cuda.synchronize()
        prof.disable()
        wall[enabled] = time.perf_counter() - t0
        side = own[enabled] = {}
        for (path, line, name), (_, calls, tt, _, _) in \
                pstats.Stats(prof).stats.items():
            side[f"{os.path.basename(path)}:{line}:{name}"] = (tt, calls)
    tapes = len(batches)
    grown = sorted(
        ((own[True][k][0] - own[False].get(k, (0.0, 0))[0], k)
         for k in own[True]), reverse=True)[:8]
    return {"profiled_s_on": wall[True], "profiled_s_off": wall[False],
            "grown_ms_a_tape": [
                [k, d * 1e3 / tapes, own[True][k][1]] for d, k in grown]}


def tel_nonce(row):
    """T2: the probe number a headline row carries in its s3.price (None
    for a row of ordinary traffic)."""
    p = float(row[2])
    if p < TEL_PROBE_MAGIC / 2:
        return None
    return int(round(p - TEL_PROBE_MAGIC))


def tel_probe_lines(k, price3):
    """One sentinel triple: ids 1, 2, 3 a ms apart, 10 s after the last
    (one match each, none across triples: `within 5 sec`)."""
    t = TEL_PROBE_T0 + 10_000 * k
    return "".join(
        json.dumps({"id": i + 1, "name": "probe", "price": price,
                    "timestamp": t + i}) + "\n"
        for i, price in enumerate((0.5, 0.5, price3)))


def tel_prober(fpt, co, schema):
    """T2: the headline on the card behind a SocketLineSource in
    processing time, every event sampled; a SideChannelProber in its own
    process sends TEL_PROBES sentinel triples through the socket, one
    every TEL_PROBE_PERIOD_S, and times each match's ack on its own
    clock. Every probe received or listed lost, the prober's pid not
    ours, its p99 within max(3x, 250 ms) of ``trace.e2e``'s."""
    import torch

    from flink_siddhi_tpu_torch.telemetry.prober import SideChannelProber

    src = fpt.SocketLineSource("inputStream", schema, port=0,
                               ts_field="timestamp")
    plan = fpt.compile_plan(HEADLINE, {"inputStream": schema},
                            plan_id="bench", config=bench_config(fpt))
    job = fpt.Job([plan], [src], batch_size=BATCH, time_mode="processing",
                  retain_results=False, device="cuda")
    job.drain_interval_ms = 20.0
    job.tracer.sample_every = 1
    seen = []
    payloads = [tel_probe_lines(k + 1, TEL_PROBE_MAGIC + k)
                for k in range(TEL_PROBES)]
    prober = SideChannelProber(src.host, src.port, payloads,
                               period_s=TEL_PROBE_PERIOD_S, timeout_s=10.0)
    sink = prober.make_sink(tel_nonce)

    def counting_sink(ts, row):
        seen.append(ts)
        sink(ts, row)

    job.add_sink("matches", counting_sink)
    try:
        # the first steps off the probes' clock: one triple of ordinary
        # traffic, its match surfaced
        import socket

        with socket.create_connection((src.host, src.port)) as c:
            c.sendall(tel_probe_lines(0, 1.0).encode())
        t_end = time.monotonic() + 30.0
        while not seen and time.monotonic() < t_end:
            job.run_cycle()
            time.sleep(0.001)
        if not seen:
            raise AssertionError("telemetry T2: the warm-up triple's match "
                                 "never surfaced")
        co.reset_launches()
        prober.start()
        t0 = time.perf_counter()
        t_end = time.monotonic() + 60.0
        while prober.poll_result() is None and time.monotonic() < t_end:
            job.run_cycle()
            time.sleep(0.001)
        report = prober.result(10.0)
        wall = time.perf_counter() - t0
        launches = co.launch_counts()
        torch.cuda.synchronize()
    finally:
        prober.close()
        src.close()
    if report is None:
        raise AssertionError("telemetry T2: the prober produced no report")
    trace = job.tracer.snapshot()
    e2e = trace["e2e"]
    p50, p99 = report.percentile_ms(50), report.percentile_ms(99)
    out = {"n_sent": report.n_sent, "received": report.n_received,
           "lost": list(report.lost), "prober_pid": report.pid,
           "smoke_pid": os.getpid(), "clock": report.clock,
           "prober_p50_ms": p50, "prober_p99_ms": p99,
           "trace_e2e_count": e2e["count"], "trace_e2e_p50_ms": e2e["p50_ms"],
           "trace_e2e_p99_ms": e2e["p99_ms"], "wall_s": wall,
           "launches": {k: launches[k] for k in ("multi_reverse_cummin",
                                                 "chain_advance")}}
    del job
    if (report.n_sent != TEL_PROBES
            or report.n_received + len(report.lost) != report.n_sent
            or report.pid == os.getpid() or prober.child_pid != report.pid
            or report.n_received < 1):
        raise AssertionError(f"telemetry T2: {out}")
    if e2e["count"] < report.n_received:
        raise AssertionError(f"telemetry T2: {e2e['count']} traces for "
                             f"{report.n_received} probes received")
    t99 = e2e["p99_ms"]
    if not (p99 <= max(3 * t99, t99 + 250.0)
            and t99 <= max(3 * p99, p99 + 250.0)):
        raise AssertionError(f"telemetry T2: the prober's p99 {p99} ms "
                             f"against trace.e2e's {t99} ms")
    if not all(out["launches"].values()):
        raise AssertionError(f"telemetry T2: launches {out['launches']}")
    return out


def tel_timeline(tape):
    """T3's control timeline (phase 8i's template): tenant acme's v1 and
    v2 before tape 0, bobcorp's v3 folding into their group at tape 1
    while v2 is disabled, v2 enabled at tape 2, v1 retired at tape 3."""
    from flink_siddhi_tpu_torch.control.events import (
        MetadataControlEvent as M,
        OperationControlEvent as O,
    )

    def at(k):
        return 1000 + k * tape

    def add(pid):
        b = M.builder()
        b.add_execution_plan(CTRL_QUERIES[pid], plan_id=pid)
        ev = b.build()
        ev.tenant = TEL_TENANTS[pid]
        return ev

    return [
        (0, add("v1")), (0, add("v2")),
        (at(1), add("v3")), (at(1), O.disable_query("v2")),
        (at(2), O.enable_query("v2")),
        (at(3), M.builder().remove_execution_plan("v1").build()),
    ]


def tel_job(fpt, schema, batches, device, tape, mode):
    """T3's Job: phase 8i's, over this timeline, in ``mode``."""
    job = ctrl_job(fpt, schema, batches, device, tape,
                   control=[fpt.ControlListSource(tel_timeline(tape))])
    if mode == "streaming":
        job.fused_segment_len = None
    return job


def tel_account(job):
    """A T3 run's attribution: per user plan ``rows_emitted`` (group and
    shared hosts left out), the emitted total, the journal's (kind, plan,
    tenant) sequence without the card's own compile entries."""
    rows = {pid: reg.counter_value("rows_emitted")
            for pid, reg in job.telemetry.scope_map("plan").items()
            if not pid.startswith(("@dyn:", "@shr:"))}
    journal = [[e["kind"], e.get("plan"), e.get("tenant")]
               for e in job.flightrec.events(limit=4096)
               if not e["kind"].startswith("compile.")]
    return {"rows_by_plan": rows,
            "emitted": sum(n for s, n in job.emitted_counts.items()
                           if not s.endswith("@late")),
            "journal": journal}


def tel_scrape(base, texts, stop):
    """Fetch the Prometheus text until ``stop`` is set (a thread beside
    the run loop)."""
    import urllib.request

    while not stop.is_set():
        with urllib.request.urlopen(f"{base}/metrics/prometheus") as r:
            texts.append((time.perf_counter(), r.read().decode("utf-8")))
        time.sleep(0.02)


def tel_control(fpt, co, schema, batches):
    """T3: the timeline beside the static headline (bench settings) at
    full width in three modes (streaming, fused, resident in epochs): the
    per-plan ``rows_emitted`` summing to the emitted rows, the same split
    in every mode; the fused run with SLO policies on both tenants (acme's
    tight enough to breach) behind QueryControlService, the Prometheus
    text fetched while the run loop steps and checked, ``/api/v1/slo``
    reconciled against ``/api/v1/flightrecorder``'s counts, and
    ``metrics()["compiles"]`` per plan equal to the graphs each runtime
    captured. Then the timeline over 4 tapes of TEL_CTRL_CPU_TAPE events
    on the card and on the CPU: the same per-plan split and journal; that
    card Job checkpointed and restored into a fresh one, its seq going
    on."""
    import threading

    import torch

    from flink_siddhi_tpu_torch.telemetry import SLOPolicy

    kernels = ("multi_reverse_cummin", "chain_advance")
    modes = {}
    for mode in ("streaming", "fused", "resident"):
        job = tel_job(fpt, schema, batches, "cuda", BATCH, mode)
        svc = stop = scraper = None
        texts = []
        if mode == "fused":
            job.slo.min_interval_s = 0.0
            job.slo.set_policy(SLOPolicy(tenant="acme", p99_ms=1e-3))
            job.slo.set_policy(SLOPolicy(tenant="bobcorp", p99_ms=1e9))
            svc = fpt.QueryControlService(fpt.ControlQueueSource(),
                                          job=job).start()
            base = f"http://127.0.0.1:{svc.port}/api/v1"
            stop = threading.Event()
            scraper = threading.Thread(target=tel_scrape,
                                       args=(base, texts, stop))
        co.reset_launches()
        t0 = time.perf_counter()
        try:
            if scraper is not None:
                scraper.start()
            if mode == "resident":
                fpt.ResidentReplay(job).execute()
            else:
                job.run()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if scraper is not None:
                stop.set()
                scraper.join()
                slo, frec = tel_get(base, "/slo"), tel_get(
                    base, "/flightrecorder?kind=slo&limit=4096")
        finally:
            if svc is not None:
                stop.set()
                svc.stop()
        launches = co.launch_counts()
        acct = tel_account(job)
        if sum(acct["rows_by_plan"].values()) != acct["emitted"] \
                or not acct["emitted"]:
            raise AssertionError(f"telemetry T3 {mode}: rows by plan "
                                 f"{acct['rows_by_plan']}, emitted "
                                 f"{acct['emitted']}")
        if not all(launches[k] for k in kernels):
            raise AssertionError(f"telemetry T3 {mode}: {launches}")
        res = {"wall_s": t1 - t0, **acct,
               "launches": {k: launches[k] for k in kernels},
               "graphs_captured": job.graphs_captured}
        if mode == "fused":
            during = [t for t, _ in texts if t0 <= t <= t1]
            for _, text in texts:
                check_prometheus_text(text)
            n_samples, _ = check_prometheus_text(texts[-1][1])
            evs = frec["events"]
            counted = {k: sum(1 + e.get("collapsed", 0) for e in evs
                              if e["kind"] == k)
                       for k in ("slo.violation", "slo.recovered")}
            if not (during and slo["reconciled"]
                    and counted["slo.violation"] == slo["violations_total"]
                    and counted["slo.recovered"] == slo["recoveries_total"]
                    and slo["violations_total"] >= 1
                    and not slo["tenants"]["acme"]["compliant"]
                    and slo["tenants"]["bobcorp"]["compliant"]):
                raise AssertionError(f"telemetry T3: {len(during)} scrapes "
                                     f"during the run, slo {slo}, journal "
                                     f"{counted}")
            captured = {f"plan:{pid}": rt.graphs.captured
                        for pid, rt in job._plans.items()
                        if rt.graphs is not None and rt.graphs.captured}
            compiles = job.metrics()["compiles"]
            if compiles["by_signature"] != captured or not captured:
                raise AssertionError(f"telemetry T3: compiles "
                                     f"{compiles['by_signature']} against "
                                     f"graphs captured {captured}")
            res.update({
                "scrapes": len(texts), "scrapes_during_run": len(during),
                "prometheus_samples": n_samples,
                "slo": {k: slo[k] for k in (
                    "reconciled", "violations_total", "recoveries_total",
                    "evaluations", "worst_burning_tenant")},
                "journal_slo": counted,
                "compiles": compiles["by_signature"],
                "compile_s": compiles["total_duration_s"],
            })
        modes[mode] = res
        del job
    split = {m: r["rows_by_plan"] for m, r in modes.items()}
    if len({json.dumps(s, sort_keys=True) for s in split.values()}) != 1:
        raise AssertionError(f"telemetry T3: per-plan splits {split}")

    # the same timeline over small tapes on the card and on the CPU
    first = batches[0]
    tapes = [first.slice(s, s + TEL_CTRL_CPU_TAPE) for s in range(
        0, TEL_CTRL_TAPES * TEL_CTRL_CPU_TAPE, TEL_CTRL_CPU_TAPE)]
    small = {}
    for device in ("cuda", "cpu"):
        job = tel_job(fpt, schema, tapes, device, TEL_CTRL_CPU_TAPE,
                      "fused")
        job.run()
        small[device] = (tel_account(job), job)
    card, cpu = small["cuda"][0], small["cpu"][0]
    if (card["rows_by_plan"] != cpu["rows_by_plan"]
            or card["journal"] != cpu["journal"]):
        raise AssertionError(f"telemetry T3 ({TEL_CTRL_TAPES} tapes of "
                             f"{TEL_CTRL_CPU_TAPE}): card {card} against "
                             f"the CPU's {cpu}")
    # a checkpoint with the journal, restored into a fresh Job
    job = small["cuda"][1]
    path = os.path.join(SMOKE_DIR, "telemetry.ckpt")
    job.save_checkpoint(path)
    at_save = [(e["seq"], e["kind"]) for e in job.flightrec.events(
        limit=4096)]
    fresh = ctrl_job(fpt, schema, [], "cuda", TEL_CTRL_CPU_TAPE,
                     control=False)
    fresh.restore(path)
    got = [(e["seq"], e["kind"]) for e in fresh.flightrec.events(
        limit=4096)]
    if got[:-1] != at_save or got[-1] != (at_save[-1][0] + 1,
                                          "checkpoint.restore"):
        raise AssertionError(f"telemetry T3: the restored journal ends "
                             f"{got[-3:]}, saved {at_save[-3:]}")
    del small, job, fresh
    return {"modes": {m: {k: v for k, v in r.items() if k != "journal"}
                      for m, r in modes.items()},
            "journal": modes["fused"]["journal"],
            "split": split["fused"],
            "cpu_check": {"rows_by_plan": cpu["rows_by_plan"],
                          "journal_entries": len(cpu["journal"])},
            "checkpoint": {"seq_at_save": at_save[-1][0],
                           "seq_after_restore": got[-1][0]}}


def tel_get(base, path):
    import urllib.request

    with urllib.request.urlopen(f"{base}{path}") as r:
        return json.loads(r.read())


def telemetry_phase(fpt, co, out_path):
    """Phase 8k: T1 (overhead), T2 (the prober), T3 (the control
    timeline's attribution, journal, SLO, exposition, compiles and a
    checkpoint), see the module docstring."""
    import torch

    t_phase = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    os.makedirs(SMOKE_DIR, exist_ok=True)
    schema, batches = bench_stream(fpt, TEL_TAPES * BATCH, BATCH)
    part("stream")
    t1 = tel_overhead(fpt, co, schema, batches)
    part("T1")
    t2 = tel_prober(fpt, co, schema)
    part("T2")
    t3 = tel_control(fpt, co, schema, batches[:TEL_CTRL_TAPES])
    part("T3")
    torch.cuda.synchronize()
    launches = {k: {"T1": t1["sides"][1]["launches"][k],
                    "T1_resident": t1["resident"]["launches"][k],
                    "T2": t2["launches"][k],
                    **{f"T3_{m}": r["launches"][k]
                       for m, r in t3["modes"].items()}}
                for k in ("multi_reverse_cummin", "chain_advance")}
    out = {"T1": t1, "T2": t2, "T3": t3, "launches": launches,
           "part_s": parts, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"telemetry_detail": out}))
    with open(out_path, "w") as f:
        json.dump(out, f)


def telemetry_main(out_path):
    """Phase 8k alone (``--telemetry OUT``), run by ``main`` in a child
    process (alone it also builds the CUDA kernels)."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    co.build()
    telemetry_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs one CUDA device", file=sys.stderr)
        return 2
    try:
        import flink_siddhi_tpu_torch as fpt
        from flink_siddhi_tpu_torch.compiler import cuda_ops as co
        from flink_siddhi_tpu_torch.compiler import nfa, scan_windows
        from flink_siddhi_tpu_torch.runtime import graphs
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/11] device: {kind} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    # 2. build
    build_s = co.build()
    log(f"[2/11] build: {len(co.SOURCES)} kernel sources in "
        f"{build_s:.2f} s")
    for name, out in co.LIBRARIES.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions (synthetic inputs)
    gen = torch.Generator().manual_seed(7)
    gen_dev = torch.Generator(device=dev).manual_seed(7)
    log("[3/11] kernels vs plain versions")
    err_k1 = check_reverse_cummin(co, dev, gen_dev)
    err_k2 = check_chain_advance(co, dev, gen_dev)
    err_k2 = max(err_k2, check_stacked_chain_advance(co, dev, gen_dev))
    err_k3, rel_k3 = check_unique_fold(co, dev, gen)
    err_k1 = max(err_k1, check_reverse_cummin_replay(co, graphs, dev,
                                                     gen_dev))
    err_k4 = check_slot_nfa(fpt, co, dev)
    err_k5 = check_join_pairs(fpt, co, dev)
    err_k6 = check_table_mutate(fpt, co, dev)
    rel_k789, _ = check_scan_windows(co, dev)

    def lap(what):
        log(f"  {what} done at {time.perf_counter() - t_start:.1f} s")

    lap("phases 1-3")
    # 4. headline end to end; record each kernel's inputs mid-run
    schema, batches = bench_stream(fpt, BATCH * N_BATCHES, BATCH)
    log(f"[4/11] headline: {BATCH * N_BATCHES} events in {N_BATCHES} "
        f"micro-batches of {BATCH}")
    rec_k1 = Recorder(co.multi_reverse_cummin, keep=10)
    rec_k2 = Recorder(co.chain_advance, keep=10)
    nfa.multi_reverse_cummin, nfa.chain_advance = rec_k1, rec_k2
    try:
        head = end_to_end(fpt, co, "headline", HEADLINE, schema, batches,
                          kernels_expected=("multi_reverse_cummin",
                                            "chain_advance"))
    finally:
        nfa.multi_reverse_cummin = co.multi_reverse_cummin
        nfa.chain_advance = co.chain_advance
    full_k1, full_k2 = full_width_inputs(fpt, co, nfa, schema, batches)

    lap("phase 4")
    # 5. filter end to end (no kernel on this path)
    log("[5/11] filter")
    end_to_end(fpt, co, "filter", FILTER, schema, batches,
               kernels_expected=())

    # 5b. both paths as bench.py runs them: its EngineConfig, the streaming
    # Job and ResidentReplay
    log("[5b/11] bench main path: lazy projection + predicate pushdown, "
        "streaming Job and ResidentReplay")
    bench_batches = batches[:BENCH_TAPES]
    bench_head = bench_main_path(fpt, co, "headline", HEADLINE, schema,
                                 bench_batches, chain=True)
    bench_filter = bench_main_path(fpt, co, "filter", FILTER, schema,
                                   bench_batches, chain=False)
    bench_p2 = bench_main_path(fpt, co, "pattern2", PATTERN2, schema,
                               bench_batches, chain=True)
    del bench_batches
    drop = capture_after_drop(fpt, schema, batches[:4])
    log(f"  a fused Job captured after a dropped resident Job: "
        f"{json.dumps(drop)}")

    lap("phases 5 and 5b")
    # 5c. the drain pipeline: the five bench configs in sink mode (a
    # columnar sink, then a row sink: the same rows and checksum), and the
    # headline's paced latency
    log("[5c/11] drain pipeline: sink mode (columnar lane and row sink), "
        "paced latency")
    t_drain = time.perf_counter()
    sink_results = [
        sink_phase(fpt, name, cql, schema, batches, True)
        for name, cql in (("headline", HEADLINE), ("filter", FILTER),
                          ("pattern2", PATTERN2))
    ]
    wschema, wbatches = bench_stream(fpt, SINK_CUT, BATCH,
                                     n_ids=N_IDS_WINDOW)
    sink_results.append(sink_phase(fpt, "window_groupby", WINDOW_GROUPBY,
                                   wschema, wbatches, True))
    del wschema, wbatches
    # a stack routes rows to 64 streams: the row path, as in the reference
    sink_results.append(sink_phase(fpt, "multiquery64", MULTIQUERY64,
                                   schema, batches[:SINK_CUT_MQ // BATCH],
                                   False))
    paced = paced_latency(fpt, schema, batches,
                          bench_head["fused_streaming"]["events_per_s_median"])
    log(f"  drain phase {time.perf_counter() - t_drain:.1f} s")
    del schema, batches

    lap("phase 5c")
    # 6. the quote board end to end; record the fold's inputs of the
    # second micro-batch (calls 1 and 2 are the CPU check and the warm-up)
    log(f"[6/11] quote board: {QUOTE_BATCHES * BATCH} events in "
        f"{QUOTE_BATCHES} micro-batches of {BATCH}")
    rec_k3 = Recorder(co.unique_window_fold, keep=4)
    scan_windows.unique_window_fold = rec_k3
    try:
        board, _, _ = quote_board(fpt, co)
    finally:
        scan_windows.unique_window_fold = co.unique_window_fold

    lap("phase 6")
    # 7. windows and aggregation: the bench's window_groupby and every other
    # window class (no kernel on these paths)
    log(f"[7/11] windows: window_groupby over "
        f"{BATCH * WINDOW_GROUPBY_BATCHES} events "
        f"({N_IDS_WINDOW} ids), then {len(WINDOW_CLASSES)} window classes")
    # in a process of its own: after this phase's traced rerun, the
    # kernel timing's traces in the same process lost records
    t_win = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--windows"], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"windows phase failed ({r.returncode})")
    log(f"  windows phase {time.perf_counter() - t_win:.1f} s")

    # 8. multiquery64: 64 chain queries stacked on one query axis (in a
    # process of its own, as phase 7)
    log(f"[8/11] multiquery64: 64 stacked chain queries over "
        f"{BATCH * MQ_BATCHES} events, {MQ_STEP_EVENTS}-event steps")
    t_mq = time.perf_counter()
    mq_path = os.path.join(SMOKE_DIR, "multiquery64.json")
    os.makedirs(SMOKE_DIR, exist_ok=True)
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--multiquery", mq_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"multiquery64 phase failed ({r.returncode})")
    with open(mq_path) as f:
        mq = json.load(f)
    mq_inputs = torch.load(mq_path + ".pt")
    log(f"  multiquery64 phase {time.perf_counter() - t_mq:.1f} s")

    # the graph phase: each path's segments as CUDA graph replays,
    # resident and fused streaming, in one line
    with open(os.path.join(SMOKE_DIR, "window_groupby.json")) as f:
        bench_wg = json.load(f)
    log(json.dumps({"graphs": graph_summary(
        [bench_head, bench_filter, bench_p2, bench_wg, mq["bench"]], board,
    )}))
    overlapped = bench_head["resident"]["drains_first_run"][
        "drains_overlapped"]
    log(json.dumps({"drain": {
        "resident": {b["path"]: b["resident"]["drains_first_run"]
                     for b in (bench_head, bench_filter, bench_p2, bench_wg,
                               mq["bench"])},
        "sink_mode": [{k: r[k] for k in (
            "path", "cut", "events_per_s", "row_sink_events_per_s", "rows",
            "checksum", "columnar")} for r in sink_results],
        "paced_latency": {k: paced[k] for k in (
            "offered_events_per_s", "drain_total", "drain_staleness")},
    }}))
    if not overlapped:
        raise AssertionError("resident headline: no drain overlapped a "
                             "later segment")

    # 8b. the slot NFA: four slot-NFA queries over the bench stream (in a
    # process of its own, as phases 7 and 8; K4's recorded inputs go to
    # phase 9)
    log(f"[8b/11] slot NFA: {len(SLOT_QUERIES)} queries over "
        f"{BATCH * SLOT_STEPS} events")
    t_slot = time.perf_counter()
    slot_path = os.path.join(SMOKE_DIR, "slots.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--slots", slot_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"slot NFA phase failed ({r.returncode})")
    with open(slot_path) as f:
        slots = json.load(f)
    log(f"  slot NFA phase {time.perf_counter() - t_slot:.1f} s")
    log(json.dumps({"slots": [{k: q[k] for k in (
        "path", "scan", "rows", "checksum", "overflow", "cpu_check_rows")}
        | {"resident_events_per_s_median":
           q["resident"]["events_per_s_median"],
           "resident_events_per_s_best": q["resident"]["events_per_s_best"],
           "streaming_events_per_s": q["streaming"]["events_per_s"],
           "idle_share": q["resident"]["traced_idle_share"],
           "eager_segments": q["resident"]["eager_segments"],
           "steps": q["resident"]["steps"],
           "launches_traced": q["resident"]["launches_traced"][
               "slot_nfa_scan"]}
        for q in slots]}))

    # 8c. stream joins and query chaining: J1 and G1 over two streams, C1
    # over the bench stream (in a process of its own, as 8b; J1's recorded
    # K5 inputs go to phase 9)
    log(f"[8c/11] joins and chaining: J1, G1 over two streams of "
        f"{JOIN_MS} events each, C1 over the bench stream")
    t_join = time.perf_counter()
    join_path = os.path.join(SMOKE_DIR, "joins.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--joins", join_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"joins phase failed ({r.returncode})")
    with open(join_path) as f:
        joins = json.load(f)
    log(f"  joins phase {time.perf_counter() - t_join:.1f} s")
    log(json.dumps({"joins": [{k: q[k] for k in (
        "path", "artifacts", "rows", "overflow", "cpu_check_rows",
        "cpu_check_max_rel", "batch_check_max_rel")}
        | {"resident_events_per_s_median":
           q["resident"]["events_per_s_median"],
           "resident_events_per_s_best": q["resident"]["events_per_s_best"],
           "streaming_events_per_s": q["streaming"]["events_per_s"],
           "idle_share": q["resident"]["traced_idle_share"],
           "eager_segments": q["resident"]["eager_segments"],
           "graphs_captured": q["resident"]["graphs_captured"],
           "steps": q["resident"]["steps"],
           "launches_traced": q["resident"]["launches_traced"][
               "join_pairs"]}
        for q in joins["queries"]], "outer": joins["outer"]}))

    # 8d. event tables: the TABLES plan over two streams (in a process of
    # its own, as 8c; the third step's K6 and K5 inputs go to phase 9)
    log(f"[8d/11] tables: insert, update, delete and a stream-table join "
        f"over two streams of {JOIN_MS} events each")
    t_tab = time.perf_counter()
    table_path = os.path.join(SMOKE_DIR, "tables.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--tables", table_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"tables phase failed ({r.returncode})")
    with open(table_path) as f:
        tables = json.load(f)
    log(f"  tables phase {time.perf_counter() - t_tab:.1f} s")
    res = tables["resident"]
    log(json.dumps({"tables": {
        k: tables[k] for k in (
            "rows", "overflow", "valid_rows_at_end", "cpu_check_rows",
            "cpu_check_valid_rows", "outer")}
        | {"resident_events_per_s_median": res["events_per_s_median"],
           "resident_events_per_s_best": res["events_per_s_best"],
           "streaming_events_per_s": tables["streaming"]["events_per_s"],
           "idle_share": res["traced_idle_share"],
           "device_ms_per_step": res["device_ms_per_step"],
           "top_device_ms": res["top_device_ms"],
           "eager_segments": res["eager_segments"],
           "graphs_captured": res["graphs_captured"],
           "steps": res["steps"],
           "launches": {k: tables["streaming"]["launches"][k]
                        for k in ("table_mutate", "join_pairs")},
           "launches_traced": {k: res["launches_traced"][k]
                               for k in ("table_mutate", "join_pairs")}}}))

    # 8e. partitions and windowed table writes: P1, P2 over the partition
    # stream, W1 over 8d's streams (in a process of its own, as 8d; P1's
    # K4 and W1's K6 inputs of the third step go to phase 9)
    log(f"[8e/11] partitions and windowed table writes: P1, P2 over "
        f"{BATCH * PART_STEPS} events with {PART_USERS} accounts, W1 over "
        f"two streams of {JOIN_MS} events each")
    t_part = time.perf_counter()
    part_path = os.path.join(SMOKE_DIR, "partitions.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--partitions", part_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"partitions phase failed ({r.returncode})")
    with open(part_path) as f:
        parts = json.load(f)
    log(f"  partitions phase {time.perf_counter() - t_part:.1f} s")
    log(json.dumps({"partitions": [{k: q[k] for k in (
        "path", "artifacts", "rows", "overflow", "cpu_check_rows",
        "cpu_check_max_rel")}
        | {"resident_events_per_s_median":
           q["resident"]["events_per_s_median"],
           "resident_events_per_s_best": q["resident"]["events_per_s_best"],
           "streaming_events_per_s": q["streaming"]["events_per_s"],
           "idle_share": q["resident"]["traced_idle_share"],
           "device_ms_per_step": q["resident"]["device_ms_per_step"],
           "top_device_ms": q["resident"]["top_device_ms"],
           "eager_segments": q["resident"]["eager_segments"],
           "graphs_captured": q["resident"]["graphs_captured"],
           "steps": q["resident"]["steps"],
           "launches": q["streaming"]["launches"],
           "launches_traced": q["resident"]["launches_traced"]}
        for q in parts["plans"]], "phase_s": parts["phase_s"]}))

    # 8f. the scan windows: S1 (K7), O1, O2 (K9), F1, F2 (K8), U1 (K3's
    # integer path), SCAN_STEPS tapes each (in a process of its own, as
    # 8e; each plan's third-step kernel inputs go to phase 9)
    log(f"[8f/11] scan windows: S1, O1, O2, F1, F2, U1 over "
        f"{BATCH * SCAN_STEPS} events each")
    t_scan = time.perf_counter()
    scan_path = os.path.join(SMOKE_DIR, "scan_windows.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--scan-windows", scan_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"scan windows phase failed ({r.returncode})")
    with open(scan_path) as f:
        scans = json.load(f)
    log(f"  scan windows phase {time.perf_counter() - t_scan:.1f} s")
    log(json.dumps({"scan_windows": [{k: q[k] for k in (
        "path", "artifacts", "kernel", "rows", "cpu_check_rows",
        "cpu_check_max_rel")}
        | {"resident_events_per_s_median":
           q["resident"]["events_per_s_median"],
           "resident_events_per_s_best": q["resident"]["events_per_s_best"],
           "streaming_events_per_s": q["streaming"]["events_per_s"],
           "idle_share": q["resident"]["traced_idle_share"],
           "device_ms_per_step": q["resident"]["device_ms_per_step"],
           "top_device_ms": q["resident"]["top_device_ms"],
           "eager_segments": q["resident"]["eager_segments"],
           "graphs_captured": q["resident"]["graphs_captured"],
           "steps": q["resident"]["steps"],
           "launches": q["streaming"]["launches"][q["kernel"]],
           "launches_traced": q["resident"]["launches_traced"][q["kernel"]]}
        for q in scans["plans"]], "phase_s": scans["phase_s"]}))

    # 8g. event time and recovery: the disordered headline, checkpoints
    # and restores on the card, output rate limiting, the supervisor (in
    # a process of its own, as 8f)
    log(f"[8g/11] event time and recovery: the headline over "
        f"{BATCH * ET_TAPES} events under disorder, checkpoints, output "
        f"rate limiting, the supervisor")
    t_et = time.perf_counter()
    et_path = os.path.join(SMOKE_DIR, "event_time.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--event-time", et_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"event time phase failed ({r.returncode})")
    with open(et_path) as f:
        et = json.load(f)
    log(f"  event time phase {time.perf_counter() - t_et:.1f} s")
    e1, e2, e5 = et["E1"], et["E2"], et["E5"]
    log(json.dumps({"event_time": {
        "E1": {k: e1[k] for k in (
            "events", "rows", "late_events", "side_output_rows",
            "events_per_s", "in_order_events_per_s", "launches")}
        | {"phase_5b_fused_events_per_s_median":
           bench_head["fused_streaming"]["events_per_s_median"]},
        "E2": {k: e2[k] for k in ("snapshot_bytes", "save_s", "restore_s",
                                  "rows", "rows_with_none", "lazy_off")},
        "E3": et["E3"], "E4": et["E4"],
        "E5": {k: e5[k] for k in (
            "crashes", "duplicate_rows", "lost_rows", "late_dropped",
            "last_recovery_ms", "resident")},
        "phase_s": et["phase_s"]}}))

    # 8h. ingestion and the deployable pipeline: the headline read from a
    # Kafka topic into a transactional one, across crashes, and the file
    # endpoints (in a process of its own, as 8g)
    log(f"[8h/11] ingestion and the pipeline: the headline over "
        f"{PIPE_EVENTS} events from a {PIPE_PARTITIONS}-partition Kafka "
        f"topic, exactly once across crashes, JSON-lines and CSV files")
    t_pipe = time.perf_counter()
    pipe_path = os.path.join(SMOKE_DIR, "pipeline.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--pipeline", pipe_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"pipeline phase failed ({r.returncode})")
    with open(pipe_path) as f:
        pipe = json.load(f)
    log(f"  pipeline phase {time.perf_counter() - t_pipe:.1f} s")
    h1, h2, h3 = pipe["H1"], pipe["H2"], pipe["H3"]
    log(json.dumps({"pipeline": {
        "H0": pipe["H0"],
        "H1": {k: h1[k] for k in (
            "events", "rows", "duplicated", "lost", "events_per_s",
            "split_s", "faults", "launches")},
        "H2": {k: h2[k] for k in (
            "events", "crashes", "rows", "duplicated", "lost", "markers",
            "txn_stats")},
        "H3": {"quote_board": {k: h3["quote_board"][k] for k in (
            "events", "cpu_check_rows", "cpu_check_max_rel",
            "events_per_s", "decode_mb_per_s", "launches")},
            "window_groupby": h3["window_groupby"]},
        "phase_s": pipe["phase_s"]}}))

    # 8i. the dynamic control plane: control events at tape boundaries,
    # dynamic groups on K1 and K2, control-in-replay, the REST service, a
    # checkpoint with dynamic queries and pending events (in a process of
    # its own, as 8h)
    log(f"[8i/11] control plane: admit, update, retire and enable at "
        f"epoch boundaries over {BATCH * CTRL_TAPES} events, dynamic "
        f"groups, ResidentReplay in epochs, the REST service, a "
        f"checkpoint")
    t_ctrl = time.perf_counter()
    ctrl_path = os.path.join(SMOKE_DIR, "control.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--control", ctrl_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"control phase failed ({r.returncode})")
    with open(ctrl_path) as f:
        ctrl = json.load(f)
    log(f"  control phase {time.perf_counter() - t_ctrl:.1f} s")
    d1 = ctrl["D1"]
    log(json.dumps({"control": {
        "rate": {m: {k: r[k] for k in (
            "events_per_s", "steps", "launches", "launches_traced",
            "device_ms_per_step")} | {
                "idle_share": r["traced"]["traced_idle_share"]}
                 for m, r in ctrl["rate"].items()},
        "D1": {k: d1[k] for k in (
            "counters", "plan_ids", "rows", "oracle_rows_checked",
            "cpu_check_rows", "hosts", "static_alone", "wall_s",
            "launches", "launches_traced", "steps", "warm_steps")},
        "D2": ctrl["D2"], "D3": ctrl["D3"],
        "D4": {k: ctrl["D4"][k] for k in (
            "pending_at_save", "duplicate_rows", "lost_rows",
            "snapshot_bytes", "save_s", "restore_s")},
        "admit_apply_ms": ctrl["admit_apply_ms"],
        "part_s": ctrl["part_s"], "phase_s": ctrl["phase_s"]}}))

    # 8j. subplan sharing and admission: the 24-tenant fleet shared and
    # unshared, retire and restore, the zoo through the admission gate
    # while graphs are captured (in a process of its own, as 8i)
    log(f"[8j/11] subplan sharing and admission: {len(share_fleet())} "
        f"tenants over {BATCH * SHARE_TAPES} events, shared and unshared; "
        f"retire, restore, resident; the plan zoo through the gate")
    t_share = time.perf_counter()
    share_path = os.path.join(SMOKE_DIR, "share.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--share", share_path], timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"share phase failed ({r.returncode})")
    with open(share_path) as f:
        share = json.load(f)
    log(f"  share phase {time.perf_counter() - t_share:.1f} s")
    a1 = share["A1"]
    keep = ("events_per_s", "plans", "hosts", "subplan_share", "stack_join",
            "graphs_captured", "graphs_captured_after_warmup",
            "suffix_graphs", "launches_traced", "loopback_rows",
            "loopback_host_s", "dropped_events", "traced_idle_share")
    log(json.dumps({"share": {
        "A1": {"unshared": {k: a1["unshared"][k] for k in keep},
               "shared": {k: a1["shared"][k] for k in keep},
               "speedup": a1["speedup"], "rows": a1["rows"],
               "cpu_check_rows": a1["cpu_check_rows"],
               "max_rel_shared_unshared": a1["max_rel_shared_unshared"],
               "max_rel_cpu": a1["max_rel_cpu"]},
        "A2": share["A2"],
        "A3": {"zoo": {n: {k: z[k] for k in (
                   "state_bytes", "acc_bytes", "admitted_bytes", "ring",
                   "measured_bytes", "allocator_held_bytes",
                   "static_tier_ms", "deep_tier_ms")}
                   for n, z in share["A3"]["zoo"].items()},
               "gate": share["A3"]["gate"]},
        "launches": share["launches"],
        "part_s": share["part_s"], "phase_s": share["phase_s"]}}))
    log(f"  share: speedup {a1['speedup']:.3f} (shared "
        f"{a1['shared']['events_per_s']:.4g} events/s, unshared "
        f"{a1['unshared']['events_per_s']:.4g})")

    # 8k. telemetry: the overhead of the hooks on the fused headline, the
    # out-of-process prober, the control timeline's attribution, journal,
    # SLO, exposition and compiles (in a process of its own, as 8j)
    log(f"[8k/11] telemetry: the fused headline over {BATCH * TEL_TAPES} "
        f"events with the registry off and on, {TEL_PROBES} probes from "
        f"another process, the control timeline in three modes")
    t_tel = time.perf_counter()
    tel_path = os.path.join(SMOKE_DIR, "telemetry.json")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--telemetry", tel_path], timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"telemetry phase failed ({r.returncode})")
    with open(tel_path) as f:
        tel = json.load(f)
    log(f"  telemetry phase {time.perf_counter() - t_tel:.1f} s")
    t1, t2, t3 = tel["T1"], tel["T2"], tel["T3"]
    log(json.dumps({"telemetry": {
        "T1": {k: t1[k] for k in (
            "events", "events_per_s_off", "events_per_s_on",
            "ratio_on_off", "sampled_per_run")}
        | {"sides": [[s_["telemetry"], s_["events_per_s"], s_["launches"]]
                     for s_ in t1["sides"]],
           "resident": t1["resident"],
           "host_profile": t1["host_profile"]},
        "T2": {k: t2[k] for k in (
            "n_sent", "received", "lost", "prober_pid", "smoke_pid",
            "prober_p50_ms", "prober_p99_ms", "trace_e2e_count",
            "trace_e2e_p50_ms", "trace_e2e_p99_ms", "launches")},
        "T3": {"split": t3["split"], "modes": {
            m: {k: r_[k] for k in ("wall_s", "emitted", "launches",
                                   "graphs_captured")}
            for m, r_ in t3["modes"].items()},
            "fused": {k: t3["modes"]["fused"][k] for k in (
                "scrapes", "scrapes_during_run", "prometheus_samples",
                "slo", "journal_slo", "compiles", "compile_s")},
            "journal_entries": len(t3["journal"]),
            "cpu_check": t3["cpu_check"], "checkpoint": t3["checkpoint"]},
        "launches": tel["launches"],
        "part_s": tel["part_s"], "phase_s": tel["phase_s"]}}))
    log(f"  telemetry: {t1['events_per_s_on']:.4g} events/s on, "
        f"{t1['events_per_s_off']:.4g} off ({t1['ratio_on_off']:.4f}); "
        f"prober p99 {t2['prober_p99_ms']} ms, trace.e2e p99 "
        f"{t2['trace_e2e_p99_ms']} ms")

    lap("phases 7, 8, 8b, 8c, 8d, 8e, 8f, 8g, 8h, 8i, 8j and 8k")
    # 9 and 10 in a process of its own: late in a long process, profiler
    # traces lost records (kernel_records); a fresh one held them
    log("[9/11] kernels on their paths' inputs (in a process of its own)")
    if rec_k1.args is None or rec_k2.args is None or rec_k3.args is None:
        raise AssertionError("no kernel inputs recorded on the main paths")
    if rec_k3.args[0].device.type != "cuda":
        raise AssertionError("the recorded fold call did not run on the card")
    k_path = os.path.join(SMOKE_DIR, "kernels.json")
    torch.save({
        "recorded": {name: {"args": [keep_copy(x, "cpu") for x in r.args],
                            "kwargs": r.kwargs}
                     for name, r in (("k1", rec_k1), ("k1_full", full_k1),
                                     ("k2", rec_k2), ("k2_full", full_k2),
                                     ("k3", rec_k3))},
        "err": [err_k1, err_k2, err_k3, rel_k3, err_k4, err_k5, err_k6,
                rel_k789],
        "launches": {"head": head["launches"], "board": board["launches"],
                     "slots": sum(q["streaming"]["launches"]["slot_nfa_scan"]
                                  for q in slots),
                     "bench": bench_head["resident"]["launches_traced"],
                     "mq": mq["bench"]["resident"]["launches_traced"],
                     "fqb": board["fused_streaming"]["launches_traced"],
                     "joins": joins["queries"][0]["streaming"]["launches"][
                         "join_pairs"],
                     "joins_traced": {
                         q["path"]: q["resident"]["launches_traced"]
                         for q in joins["queries"]},
                     "tables": tables["streaming"]["launches"],
                     "tables_traced": tables["resident"]["launches_traced"],
                     "partitions": {q["path"]: q["streaming"]["launches"]
                                    for q in parts["plans"]},
                     "partitions_traced": {
                         q["path"]: q["resident"]["launches_traced"]
                         for q in parts["plans"]},
                     "scans": {q["path"]: q["streaming"]["launches"][
                         q["kernel"]] for q in scans["plans"]},
                     "scans_traced": {q["path"]: q["resident"][
                         "launches_traced"][q["kernel"]]
                         for q in scans["plans"]},
                     "event_time": {
                         "E1": et["E1"]["launches"],
                         "E3": {p: et["E3"][p]["launches"]
                                for p in ("slot_a", "tables")},
                         "E4": et["E4"]["quote_board"]["launches"]},
                     "pipeline": {
                         "H1": h1["launches"], "H2": h2["launches"],
                         "H3": h3["quote_board"]["launches"]},
                     "control": {
                         "D1": d1["launches_traced"],
                         "rate": {m: r["launches_traced"]
                                  for m, r in ctrl["rate"].items()}},
                     "share": share["launches"]},
    }, k_path + ".pt")
    del rec_k1, rec_k2, rec_k3, full_k1, full_k2, mq_inputs
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--kernels", k_path], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"kernel phase failed ({r.returncode})")
    with open(k_path) as f:
        kernels = json.load(f)
    lap("phases 9 and 10")

    # 11. the API on the default device
    log("[11/11] api")
    api_check(fpt)

    torch.cuda.synchronize()
    log(f"  total smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


GRAPH_KEYS = (
    "events_per_s_median", "events_per_s_best", "stage_s", "warm_run_s",
    "traced_host_ops_per_segment", "traced_device_records_per_segment",
    "traced_idle_share", "max_memory_allocated_bytes",
    "max_memory_reserved_bytes", "graphs_captured", "eager_segments",
    "host_syncs", "host_syncs_first_run", "drains_first_run", "drains",
    "ring_positions", "max_memory_reserved_after_stage_bytes",
    "launches", "launches_traced",
    "segment_len",
    "dispatches",
)


def graph_summary(bench_paths, board):
    """Per path, resident and fused streaming: the graph phase's metrics
    (see GRAPH_KEYS) from the paths' results."""
    out = []
    for b in bench_paths:
        for mode in ("resident", "fused_streaming"):
            out.append({"path": b["path"], "mode": mode, **{
                k: v for k, v in b[mode].items() if k in GRAPH_KEYS}})
    out.append({"path": "quote_board", "mode": "fused_streaming", **{
        k: v for k, v in board["fused_streaming"].items()
        if k in GRAPH_KEYS}})
    return out


def ab_one(root):
    """The headline and filter paths of the checkout at ``root``, with its
    own package, kernels and chip_smoke.py helpers."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs  # the checkout's own, not this file
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co
    from flink_siddhi_tpu_torch.compiler import nfa

    co.build()
    schema, batches = cs.bench_stream(fpt, cs.BATCH * cs.N_BATCHES, cs.BATCH)
    n_events = sum(len(b) for b in batches)
    # the checkout's chain kernels on its own headline inputs (the second
    # micro-batch, and the third at full width), timed the same way for
    # every checkout
    rec_k1 = Recorder(co.multi_reverse_cummin, keep=2)
    rec_k2 = Recorder(co.chain_advance, keep=2)
    nfa.multi_reverse_cummin, nfa.chain_advance = rec_k1, rec_k2
    try:
        cs.run_job(fpt, cs.HEADLINE, schema, batches[:2], "cuda")
    finally:
        nfa.multi_reverse_cummin = co.multi_reverse_cummin
        nfa.chain_advance = co.chain_advance
    full_k1, full_k2 = full_width_inputs(fpt, co, nfa, schema, batches)
    for what, recs in (("main-path", (rec_k1, rec_k2)),
                       ("full-width", (full_k1, full_k2))):
        for rec in recs:
            ms, call_ms = timed(lambda: rec.fn(*rec.args, **rec.kwargs))
            print(json.dumps({"checkout": root, "kernel": rec.fn.name,
                              "input": what, "ms": ms, "call_ms": call_ms}),
                  flush=True)
        # the whole padded table build the checkout's chain core does: the
        # kernel with its pad column, or the kernel and a cat with a full
        x = recs[0].args[0]
        C, E = (int(s) for s in x.shape)
        if "pad" in inspect.signature(
                type(co.multi_reverse_cummin).__call__).parameters:
            def table():
                return co.multi_reverse_cummin(x, pad=E)
        else:
            def table():
                col = torch.full((C, 1), E, dtype=torch.int32,
                                 device=x.device)
                return torch.cat([co.multi_reverse_cummin(x), col], 1)
        ms, call_ms = timed(table)
        print(json.dumps({"checkout": root,
                          "kernel": "padded next-match table",
                          "input": what, "ms": ms, "call_ms": call_ms}),
              flush=True)
    for name, cql in (("headline", cs.HEADLINE), ("filter", cs.FILTER)):
        cs.run_job(fpt, cql, schema, batches[:2], "cuda")
        walls = []
        for _ in range(AB_REPEATS):
            rows, wall, _ = cs.run_job(fpt, cql, schema, batches, "cuda")
            walls.append(wall)
        torch.cuda.synchronize()
        print(json.dumps({
            "checkout": root, "path": name, "events": n_events,
            "rows": len(rows), "wall_s": walls,
            "events_per_s": [n_events / w for w in walls],
        }), flush=True)
    return 0


AB_GRAPH_CONFIGS = (
    ("headline", HEADLINE, N_IDS), ("filter", FILTER, N_IDS),
    ("pattern2", PATTERN2, N_IDS),
    ("window_groupby", WINDOW_GROUPBY, N_IDS_WINDOW),
    ("multiquery64", MULTIQUERY64, N_IDS),
)
AB_RERUNS = 5


def ab_graphs_one(root):
    """The five bench configs with the package of the checkout at
    ``root``, counts-only under the bench's settings: resident (stage,
    run() + flush(), AB_RERUNS reruns, a traced rerun: idle share, device
    records and host ops a segment and a step, peak memory) and streaming
    with ``fused_segment_len`` FUSED_K (a checkout without the fused mode
    steps one tape at a time), one warm run and AB_RERUNS timed runs."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    if not os.path.abspath(fpt.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {fpt.__file__}, not {root}'s")
    co.build()
    streams = {}
    out = {"checkout": root, "paths": []}
    for name, cql, n_ids in AB_GRAPH_CONFIGS:
        if n_ids not in streams:
            streams[n_ids] = bench_stream(fpt, BATCH * N_BATCHES, BATCH,
                                          n_ids=n_ids)
        schema, batches = streams[n_ids]
        n_events = sum(len(b) for b in batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        job = replay_job(fpt, cql, schema, batches, retain=False)
        rep = fpt.ResidentReplay(job)
        rep.stage()
        rep.run()
        job.flush()
        reruns = [rep.rerun() for _ in range(AB_RERUNS)]
        peak = (torch.cuda.max_memory_allocated(),
                torch.cuda.max_memory_reserved())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_s = rep.rerun()
        segs = rep.segments["bench"]
        traced = traced_share(prof, traced_s, len(segs),
                              sum(len(seg) for seg in segs))
        del traced["top_device_ms"]
        resident = {
            "stage_s": rep.stage_seconds, "rerun_s": reruns,
            "events_per_s_median": n_events / statistics.median(reruns),
            "events_per_s_best": n_events / min(reruns),
            "segments": len(segs), "max_memory_allocated_bytes": peak[0],
            "max_memory_reserved_bytes": peak[1], **traced,
        }
        del rep, job, prof
        job = fused_job(fpt, cql, schema, batches, False, bench_config(fpt))
        job.run()
        runs = []
        for _ in range(AB_RERUNS):
            job.reset_engine_state()
            re_source(fpt, job, schema, batches)
            t0 = time.perf_counter()
            job.run()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        streaming = {
            "fused": hasattr(job, "fusion_dispatches"), "run_s": runs,
            "events_per_s_median": n_events / statistics.median(runs),
            "events_per_s_best": n_events / min(runs),
        }
        del job
        out["paths"].append({"path": name, "resident": resident,
                             "streaming_counts_only": streaming})
    print(json.dumps(out), flush=True)
    return 0


def resident_timeline(rep):
    """One rerun of a counts-only resident replay with each segment's
    launch stamped on the host (ms from the start) and a CUDA event
    recorded behind it (ms of the card's clock from an event before the
    first): ``launched``, ``done``, the card's busy span (first segment's
    start to last segment's end, by events around the run), and the wall
    after the last segment's end (the final drain, flush and sync)."""
    import torch

    job = rep.job
    inner = rep.run_segment
    marks = []

    def stamped(pid, i):
        inner(pid, i)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((time.perf_counter(), ev))

    job.reset_engine_state()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    rep.run_segment = stamped
    try:
        t0 = time.perf_counter()
        start.record()
        rep.run()
        job.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del rep.run_segment
    done = [start.elapsed_time(ev) for _, ev in marks]
    return {"wall_ms": wall * 1e3,
            "launched_ms": [(t - t0) * 1e3 for t, _ in marks],
            "done_ms": done, "tail_ms": wall * 1e3 - done[-1]}


def ab_drain_one(root):
    """The resident headline and the headline's sink mode with the
    package of the checkout at ``root`` (bench settings): resident stage,
    run() + flush() and AB_RERUNS reruns (events/s median and best, peak
    memory allocated and reserved, the drain counts where the checkout
    has them); sink mode (a ``ColumnarCount`` on the stream, which a
    checkout without the columnar lane calls as a row sink) over
    FUSED_RUNS timed runs: events/s, rows and checksum."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    if not os.path.abspath(fpt.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {fpt.__file__}, not {root}'s")
    co.build()
    schema, batches = bench_stream(fpt, BATCH * N_BATCHES, BATCH)
    n_events = sum(len(b) for b in batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    job = replay_job(fpt, HEADLINE, schema, batches, retain=False)
    rep = fpt.ResidentReplay(job)
    rep.stage()
    rep.run()
    job.flush()
    reruns = [rep.rerun() for _ in range(AB_RERUNS)]
    resident = {
        "stage_s": rep.stage_seconds, "rerun_s": reruns,
        "events_per_s_median": n_events / statistics.median(reruns),
        "events_per_s_best": n_events / min(reruns),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
        "host_syncs": job.host_syncs,
        "drains_overlapped": getattr(job, "drains_overlapped", None),
        "timeline": [resident_timeline(rep) for _ in range(AB_RERUNS)],
    }
    del rep, job
    job, sinks, walls = sink_mode(fpt, HEADLINE, schema, batches,
                                  ColumnarCount, runs=FUSED_RUNS)
    rows, checksum = sink_totals(sinks)
    sink = {"run_s": walls,
            "events_per_s_median": n_events / statistics.median(walls),
            "events_per_s_best": n_events / min(walls),
            "rows": rows, "checksum": checksum,
            "columnar": hasattr(job, "_columnar_streams")
            and columnar_lane(job)}
    print(json.dumps({"checkout": root, "path": "headline",
                      "resident": resident, "sink_mode": sink}), flush=True)
    return 0


def ab_slots_one(root):
    """The four slot queries (SLOT_QUERIES) with the package of the
    checkout at ``root`` (bench settings, S = 64): resident counts-only
    (stage, run() + flush(), AB_RERUNS reruns: events/s median and best,
    the count emitted), and K4 on the third step's recorded input (CUDA
    events around back-to-back calls: ms a step, events visited, us a
    visited event)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co
    from flink_siddhi_tpu_torch.compiler import nfa

    if not os.path.abspath(fpt.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {fpt.__file__}, not {root}'s")
    co.build()
    schema, batches = bench_stream(fpt, BATCH * N_BATCHES, BATCH)
    n_events = sum(len(b) for b in batches)
    out = {"checkout": root, "queries": []}
    for name, cql in SLOT_QUERIES:
        job = replay_job(fpt, cql, schema, batches, retain=False)
        rep = fpt.ResidentReplay(job)
        rep.stage()
        rep.run()
        job.flush()
        torch.cuda.synchronize()
        count = sum(job.emitted_counts.values())
        reruns = [rep.rerun() for _ in range(AB_RERUNS)]
        stage_s = rep.stage_seconds
        del rep, job
        rec = Recorder(co.slot_nfa_scan, keep=3)
        nfa.slot_nfa_scan = rec
        try:
            run_job(fpt, cql, schema, batches[:3], "cuda",
                    config=bench_config(fpt))
        finally:
            nfa.slot_nfa_scan = co.slot_nfa_scan
        args = rec.args
        ms, call_ms = timed_back_to_back(lambda: co.slot_nfa_scan(*args),
                                         SLOT_TIMED_RUNS)
        n = int(args[-1][0]) if args[-1] is not None else int(
            args[3].shape[0])
        out["queries"].append({
            "query": name, "stage_s": stage_s, "rerun_s": reruns,
            "events_per_s_median": n_events / statistics.median(reruns),
            "events_per_s_best": n_events / min(reruns),
            "emitted": count, "k4_ms": ms, "k4_call_ms": call_ms,
            "events_visited": n, "k4_us_per_visited_event": ms * 1e3 / n,
        })
    print(json.dumps(out), flush=True)
    return 0


def capture_after_drop(fpt, schema, batches):
    """A dropped Job's CUDA graphs against the next Job's captures (the
    fault behind `--ab-graphs`' "a fused capture was invalidated"): a
    resident headline replay, its segments captured and a rerun traced,
    is dropped (what sits in reference cycles is garbage the cyclic
    collector frees later); then a fused Job captures its segments, with
    one run of the
    collector inside its first capture, as Python may run it at any
    allocation there. Freeing a CUDA graph inside a capture invalidates
    it; a runtime that frees the garbage before it captures passes.
    Returns what the collector found inside the capture, the graphs
    captured and the count emitted; raises if a capture fails."""
    import gc

    import torch

    from flink_siddhi_tpu_torch.runtime import graphs

    from torch.profiler import ProfilerActivity, profile

    job = replay_job(fpt, HEADLINE, schema, batches, retain=False)
    rep = fpt.ResidentReplay(job)
    rep.stage()
    rep.run()
    job.flush()
    # a traced rerun, as `--ab-graphs` makes one before its fused Job
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep.rerun()
    torch.cuda.synchronize()
    del rep, job, prof
    inner = graphs.capture
    found = []

    def collecting(fn, *args, **kwargs):
        def body():
            if not found:
                found.append(gc.collect())
            return fn()
        return inner(body, *args, **kwargs)

    graphs.capture = collecting
    try:
        fjob = fused_job(fpt, HEADLINE, schema, batches, False,
                         bench_config(fpt))
        fjob.run()
        torch.cuda.synchronize()
    finally:
        graphs.capture = inner
    return {"collected_in_capture": found[0] if found else None,
            "graphs_captured": fjob.graphs_captured,
            "emitted": sum(fjob.emitted_counts.values())}


def capture_after_drop_one(root):
    """``capture_after_drop`` with the package of the checkout at
    ``root``, over the bench stream's first 4 micro-batches."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    if not os.path.abspath(fpt.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {fpt.__file__}, not {root}'s")
    co.build()
    schema, batches = bench_stream(fpt, BATCH * 4, BATCH)
    print(json.dumps({"checkout": root,
                      **capture_after_drop(fpt, schema, batches)}),
          flush=True)
    return 0


def ab(roots, mode="--ab-one"):
    for root in roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            mode, root])
        if r.returncode != 0:
            print(f"chip_smoke --ab: {root} failed ({r.returncode})",
                  file=sys.stderr)
            return 1
    return 0


def kernels_main(path):
    """Phases 9 and 10 alone (``--kernels OUT``), run by ``main`` in a
    child process: the recorded kernel inputs and the counts come from
    OUT.pt, the stacked inputs from phase 8's file; the kernels' line goes
    to OUT."""
    import types

    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    saved = torch.load(path + ".pt")
    rec_k1, full_k1, rec_k2, full_k2, rec_k3 = (
        types.SimpleNamespace(
            args=tuple(keep_copy(a, "cuda") for a in r["args"]),
            kwargs=r["kwargs"])
        for r in (saved["recorded"][k] for k in (
            "k1", "k1_full", "k2", "k2_full", "k3"))
    )
    (err_k1, err_k2, err_k3, rel_k3, err_k4, err_k5, err_k6,
     rel_k789) = saved["err"]
    launches = saved["launches"]
    mq_inputs = torch.load(os.path.join(SMOKE_DIR, "multiquery64.json.pt"))
    # 9. kernel timing on each path's own inputs
    for rec, what in ((rec_k1, "main-path"), (full_k1, "full-width")):
        pad = rec.kwargs.get("pad")
        err_k1 = max(err_k1, same(
            co.multi_reverse_cummin(rec.args[0], pad=pad),
            co.reverse_cummin_plain(rec.args[0], pad),
            f"reverse_cummin {what} input",
        ))
    for rec, what in ((rec_k2, "main-path"), (full_k2, "full-width")):
        got = co.chain_advance(*rec.args)
        ref = co.chain_advance_plain(*rec.args)
        for g, r in zip(got, ref):
            err_k2 = max(err_k2, same(g, r, f"chain_advance {what} input"))
    # the stack's recorded inputs (phase 8): K1 over 64 queries' rows,
    # K2 with its query axis, compacted and at full width
    mq_k1 = [keep_copy(a, "cuda") for a in mq_inputs["k1"]]
    mq_k1_full = [keep_copy(a, "cuda") for a in mq_inputs["k1_full"]]
    mq_k2 = [keep_copy(a, "cuda") for a in mq_inputs["k2"]]
    mq_k2_full = [keep_copy(a, "cuda") for a in mq_inputs["k2_full"]]
    for x, kw, what in ((mq_k1, mq_inputs["k1_kw"], "stacked"),
                        (mq_k1_full, mq_inputs["k1_full_kw"],
                         "stacked full-width")):
        err_k1 = max(err_k1, same(
            co.multi_reverse_cummin(x[0], pad=kw.get("pad")),
            co.reverse_cummin_plain(x[0], kw.get("pad")),
            f"reverse_cummin {what} input",
        ))
    for args, what in ((mq_k2, "stacked"), (mq_k2_full,
                                            "stacked full-width")):
        got = co.chain_advance(*args)
        ref = co.chain_advance_plain(*args)
        for g, r in zip(got, ref):
            err_k2 = max(err_k2, same(g, r, f"chain_advance {what} input"))
    log("  stacked kernel inputs: K1 and K2 exact against their plain "
        "versions")
    # phase 8i's: K1 and K2 at a dynamic group's shapes (8 slots)
    ctrl_rec = torch.load(os.path.join(SMOKE_DIR, "control.json.pt"),
                          weights_only=False)
    g_k1 = [keep_copy(a, "cuda") for a in ctrl_rec["k1"]]
    g_pad = ctrl_rec["k1_kw"].get("pad")
    g_k2 = tuple(keep_copy(a, "cuda") for a in ctrl_rec["k2"])
    if tuple(g_k1[0].shape) != (16, BATCH) or \
            tuple(g_k2[4].shape) != (8, 1024 + BATCH):
        raise AssertionError(
            f"dynamic group inputs: K1 {tuple(g_k1[0].shape)}, K2 "
            f"{tuple(g_k2[4].shape)}")
    err_g1 = same(co.multi_reverse_cummin(g_k1[0], pad=g_pad),
                  co.reverse_cummin_plain(g_k1[0], g_pad),
                  "reverse_cummin dynamic group input")
    err_g2 = 0
    for g, r in zip(co.chain_advance(*g_k2), co.chain_advance_plain(*g_k2)):
        err_g2 = max(err_g2, same(g, r, "chain_advance dynamic group input"))
    err_k1, err_k2 = max(err_k1, err_g1), max(err_k2, err_g2)
    log("  dynamic group kernel inputs: K1 and K2 exact against their "
        "plain versions")
    floor_ms, floor_call_ms = timed(co.launch_empty)
    log(f"  launch floor: an empty kernel's device time {floor_ms} ms "
        f"(call {floor_call_ms} ms)")
    slots = rec_k3.args[5]  # (mask, codes, vals, valid0, bufs0, slots,
    # int_cols)
    e3, r3 = fold_err(co.unique_window_fold(*rec_k3.args),
                      co.unique_window_fold_plain(*rec_k3.args), slots,
                      "unique_window_fold main-path input")
    err_k3, rel_k3 = max(err_k3, e3), max(rel_k3, r3)
    slot_recorded = torch.load(os.path.join(SMOKE_DIR, "slots.json.pt"),
                               weights_only=False)
    kernels = [
        time_reverse_cummin(co, rec_k1, full_k1,
                            launches["head"]["multi_reverse_cummin"],
                            err_k1, floor_ms),
        time_chain_advance(co, rec_k2, full_k2,
                           launches["head"]["chain_advance"], err_k2,
                           floor_ms),
        time_unique_fold(co, rec_k3.args,
                         launches["board"]["unique_window_fold"], err_k3,
                         rel_k3, floor_ms),
        time_slot_nfa(co, slot_recorded, launches["slots"], floor_ms),
        time_join_pairs(co, torch.load(os.path.join(SMOKE_DIR,
                                                    "joins.json.pt"),
                                       weights_only=False),
                        launches["joins"], err_k5, floor_ms),
    ]
    table_recorded = torch.load(os.path.join(SMOKE_DIR, "tables.json.pt"),
                                weights_only=False)
    kernels.append(time_table_mutate(
        co, table_recorded, launches["tables"]["table_mutate"], floor_ms))
    kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], err_k4)
    kernels[5]["max_abs_err"] = max(kernels[5]["max_abs_err"], err_k6)
    kernels[5]["launches_tables_resident_traced"] = \
        launches["tables_traced"]["table_mutate"]
    kernels[4]["launches_joins_resident_traced"] = {
        p: t["join_pairs"] for p, t in launches["joins_traced"].items()}
    kernels[4]["launches_tables"] = launches["tables"]["join_pairs"]
    kernels[4]["launches_tables_resident_traced"] = \
        launches["tables_traced"]["join_pairs"]
    kernels[4]["table_join"] = time_table_join(
        co, table_recorded["join"], floor_ms)
    # phase 8e's inputs: K4 on P1's third step (S = PART_SLOTS, the keyed
    # pattern's cross program), K6 on W1's (the rewritten windowed update
    # and the delete)
    part_recorded = torch.load(os.path.join(SMOKE_DIR,
                                            "partitions.json.pt"),
                               weights_only=False)
    p1_args = tuple(a.to("cuda") if isinstance(a, torch.Tensor) else a
                    for a in part_recorded["k4"])
    for g, r, what in zip(co.slot_nfa_scan(*p1_args),
                          co.slot_nfa_scan_plain(*part_recorded["k4"]),
                          ("state", "scalars", "buffer")):
        same(g.cpu(), r, f"slot_nfa_scan on P1's third step: {what}")
    p1 = slot_scan_times(co, p1_args, floor_ms)
    log(f"  slot_nfa_scan on P1's third step (S = {p1['slots']}): "
        f"{p1['ms']} ms a call ({p1['call_ms']} ms single), "
        f"{p1['events_visited']} events visited, {p1['per_event_us']} us "
        f"a visited event, bound {p1['bound_ms']} ms; exact against its "
        "plain version (CPU copies)")
    kernels[3]["partitioned_p1"] = p1
    kernels[3]["launches_partitions"] = launches["partitions"]
    kernels[3]["launches_partitions_resident_traced"] = {
        p: t["slot_nfa_scan"] for p, t in launches["partitions_traced"].items()}
    kernels[5]["w1"] = time_table_mutate(
        co, part_recorded["w1"], launches["partitions"]["W1"]["table_mutate"],
        floor_ms, what="W1's third step")
    kernels[5]["launches_w1_resident_traced"] = \
        launches["partitions_traced"]["W1"]["table_mutate"]
    kernels[4]["launches_w1"] = launches["partitions"]["W1"]["join_pairs"]
    kernels[4]["launches_w1_resident_traced"] = \
        launches["partitions_traced"]["W1"]["join_pairs"]
    # phase 8f's inputs: K7 on S1's third step (and unkeyed), K9 on O1's
    # and O2's, K8 on F1's and F2's, K3's integer path on U1's
    scan_recorded = torch.load(os.path.join(SMOKE_DIR,
                                            "scan_windows.json.pt"),
                               weights_only=False)
    for kernel, plans in (("session_scan", ("S1",)),
                          ("frequency_scan", ("F1", "F2")),
                          ("sort_window_scan", ("O1", "O2"))):
        entry = time_scan_kernel(co, kernel, plans, scan_recorded,
                                 launches["scans"], floor_ms)
        entry["max_rel_err"] = max(rel_k789, max(
            e["max_rel_err"] for e in entry["plans"].values()))
        entry["launches_resident_traced"] = {
            p: launches["scans_traced"][p] for p in plans}
        kernels.append(entry)
    kernels[6]["unkeyed"] = time_unkeyed_session(co, scan_recorded)
    kernels[2]["launches_share"] = {
        "A3_zoo": launches["share"]["K3"],
        "by": "the wrapper's count over phase 8j's one-tape zoo runs "
              "(unique_window_agg)"}
    kernels[2]["int_path_u1"] = time_fold_int(co, scan_recorded["U1"],
                                              launches["scans"]["U1"])
    kernels[2]["launches_u1_resident_traced"] = launches["scans_traced"][
        "U1"]
    # phase 8g's launches: E1's disordered headline (K1, K2), E3's runs
    # across a restore (K4; K6 and K5), E4's rate-limited quote board (K3)
    et_l = launches["event_time"]
    for k, count in (
            (kernels[0], et_l["E1"]["multi_reverse_cummin"]),
            (kernels[1], et_l["E1"]["chain_advance"]),
            (kernels[2], et_l["E4"]["unique_window_fold"]),
            (kernels[3], et_l["E3"]["slot_a"]["slot_nfa_scan"]),
            (kernels[4], et_l["E3"]["tables"]["join_pairs"]),
            (kernels[5], et_l["E3"]["tables"]["table_mutate"])):
        k["launches_event_time"] = count
    # phase 8h's launches: the headline from Kafka (H1) and across its
    # crashes (H2), the quote board from a JSON-lines file (H3)
    pl = launches["pipeline"]
    for k in kernels[:2]:
        k["launches_pipeline"] = {h: pl[h][k["name"]] for h in ("H1", "H2")}
    kernels[2]["launches_pipeline"] = {"H3": pl["H3"]["unique_window_fold"]}
    # the kernels' calls that ran on the card in a traced rerun of the
    # bench main path's resident headline and multiquery64's, and in a
    # traced fused run of the quote board (kernel records in the profiler
    # trace, equal to the host's counts: traced_run)
    for k in kernels:
        k["launches_bench_main_path"] = \
            launches["bench"][k["name"]]
        k["launches_multiquery64"] = \
            launches["mq"][k["name"]]
        k["launches_fused_quote_board"] = \
            launches["fqb"][k["name"]]
        k["launches_graph_paths_by"] = "kernel records in a profiler trace"
    # the chain kernels at the stack's shapes
    kernels[0]["stacked"] = reverse_cummin_times(co, mq_k1[0],
                                                 mq_inputs["k1_kw"].get(
                                                     "pad"))
    kernels[0]["stacked"]["full_width"] = reverse_cummin_times(
        co, mq_k1_full[0], mq_inputs["k1_full_kw"].get("pad"))
    kernels[1]["stacked"] = chain_advance_times(co, tuple(mq_k2))
    kernels[1]["stacked"]["full_width"] = chain_advance_times(
        co, tuple(mq_k2_full))
    # the chain kernels at a dynamic group's shapes, and their launches in
    # phase 8i, counted in profiler traces (D1: once a step of a chain
    # runtime, warm-ups included; the rate runs: once a group step)
    kernels[0]["dynamic_group"] = reverse_cummin_times(co, g_k1[0], g_pad)
    kernels[1]["dynamic_group"] = chain_advance_times(co, g_k2)
    for k, e in zip(kernels[:2], (err_g1, err_g2)):
        k["dynamic_group"]["max_abs_err"] = e
        k["launches_control"] = {
            "D1": launches["control"]["D1"][k["name"]],
            "rate": {m: c[k["name"]]
                     for m, c in launches["control"]["rate"].items()},
            "by": "kernel records in a profiler trace"}
        k["launches_share"] = {
            "A1_shared": launches["share"]["K1" if k is kernels[0]
                                           else "K2"],
            "by": "kernel records in a profiler trace of phase 8j's "
                  f"shared fleet over {SHARE_TRACED_TAPES} tape"}
        g = k["dynamic_group"]
        log(f"  {k['name']} at a dynamic group's shape {g['shape']}: "
            f"{g['ms']} ms (call {g['call_ms']}), plain {g['plain_ms']}, "
            f"library {g['library_ms']}, bound {g['bound_ms']} "
            f"({g['bound_by']})")
    for k in kernels[:2]:
        st = k["stacked"]
        log(f"  {k['name']} stacked: {st['ms']} ms (call {st['call_ms']}), "
            f"full width {st['full_width']['ms']} ms, bound "
            f"{st['bound_ms']}, {k['launches_multiquery64']} launches in "
            f"a multiquery64 resident run")
    for k in kernels[:2]:
        log(f"  {k['name']}: {k['ms']} ms (call {k['call_ms']}), full "
            f"width {k['full_width']['ms']} ms, bound {k['bound_ms']}, "
            f"floor {floor_ms}")

    # 10. where the quote board's time goes (after the kernel timing: a
    # profiler session after this traced run recorded no device time on
    # the card)
    log(f"[10/11] quote board: where the time goes (the first "
        f"{BREAKDOWN_BATCHES} micro-batches)")
    qschema, qbatches, _ = quote_stream(fpt, QUOTE_BATCHES * BATCH, BATCH)
    breakdown(fpt, "quote_board", QUOTE_BOARD, qschema,
              qbatches[:BREAKDOWN_BATCHES], stream="StockStream",
              out="Board", sync_free=True)

    torch.cuda.synchronize()
    with open(path, "w") as f:
        json.dump(kernels, f)
    return 0


def multiquery_main(out_path):
    """Phase 8 alone (``--multiquery OUT``), run by ``main`` in a child
    process: its result goes to OUT, the stacked kernel inputs to
    OUT.pt."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    multiquery_phase(fpt, co, out_path)
    torch.cuda.synchronize()
    return 0


def windows_main():
    """Phase 7 alone (``--windows``), run by ``main`` in a child process."""
    import torch

    if not torch.cuda.is_available():
        return 2
    import flink_siddhi_tpu_torch as fpt
    from flink_siddhi_tpu_torch.compiler import cuda_ops as co

    window_phase(fpt, co)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--windows"]:
        sys.exit(windows_main())
    if len(sys.argv) == 3 and sys.argv[1] == "--slots":
        sys.exit(slots_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--joins":
        sys.exit(joins_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--tables":
        sys.exit(tables_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--partitions":
        sys.exit(partitions_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--scan-windows":
        sys.exit(scan_windows_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--event-time":
        sys.exit(event_time_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--pipeline":
        sys.exit(pipeline_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--pipeline-cpu":
        sys.exit(h3_cpu_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--control":
        sys.exit(control_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--control-cpu":
        sys.exit(control_cpu_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--share":
        sys.exit(share_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--share-cpu":
        sys.exit(share_cpu_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--telemetry":
        sys.exit(telemetry_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--multiquery":
        sys.exit(multiquery_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels":
        sys.exit(kernels_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-one":
        sys.exit(ab_one(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab":
        sys.exit(ab(sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-graphs-one":
        sys.exit(ab_graphs_one(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab-graphs":
        sys.exit(ab(sys.argv[2:], mode="--ab-graphs-one"))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-drain-one":
        sys.exit(ab_drain_one(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab-drain":
        sys.exit(ab(sys.argv[2:], mode="--ab-drain-one"))
    if len(sys.argv) == 3 and sys.argv[1] == "--capture-after-drop-one":
        sys.exit(capture_after_drop_one(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--capture-after-drop":
        sys.exit(ab(sys.argv[2:], mode="--capture-after-drop-one"))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-slots-one":
        sys.exit(ab_slots_one(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab-slots":
        sys.exit(ab(sys.argv[2:], mode="--ab-slots-one"))
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
