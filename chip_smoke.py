#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flink_siddhi_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and nvcc (it builds the port's CUDA kernels from
flink_siddhi_tpu_torch/csrc/ into build/torch_kernels/). It imports nothing
of JAX and nothing of the JAX package. Phases, each failing the run on any
fault:

1. device: the card's name and power limit;
2. build: the three kernels (and an empty one, the launch floor) compiled
   from the checkout's sources, one nvcc per source, all started together
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
   E = 3,001 and 524,287, C = 1 and C = 2^20;
4. headline: the bench's 3-step `every ... within 5 sec` chain pattern
   through compile_plan -> BatchSource -> Job at batch 524,288 over a
   10,485,760-event stream, with the launch counters reset just before
   and read just after; rows checked against the port's own CPU path on
   the first 1,048,576 events;
5. filter: the bench's filter query, the same way;
5b. bench main path: the headline, the filter and pattern2 as bench.py
   runs them, with EngineConfig(lazy_projection=True,
   pred_pushdown=True): the streaming Job over the whole stream, one step
   a micro-batch (rows of the first 1,048,576 events held to the CPU path
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
   resident and fused numbers;
6. quote board: `#window.unique(symbol)` with count/sum/avg/min/max over
   StockStream, 10,000 Zipf-weighted symbols (a 16,384-slot table), at
   batch 524,288 over 10,485,760 events, the unique-window fold called
   once per micro-batch and host syncs counted (drains only); rows checked
   against the port's CPU path on the first 32,768 events; then the fused
   streaming Job, as in phase 5b (its rows over the whole stream equal to
   the one-step-a-tape card path's);
7. windows (in a process of its own, `--windows`): the bench's
   window_groupby (`#window.length(1000) select id,
   sum(price), count() group by id`, 1,000 ids) as phase 5b runs the
   bench main path — streaming rows of the first 1,048,576 events held to
   the CPU path (float sums within rtol 1e-5), host syncs only the
   drains', the raw id off the wire, then ResidentReplay counts-only with
   10,485,760 rows a run (every event emits one), reruns, wire bytes, peak
   memory, a traced rerun's idle share and one segment under sync debug
   mode "error"; then every other window class through the streaming Job
   over four micro-batches of 524,288 events (65,536 on the matrix path),
   rows held to the CPU path and two staged steps under sync debug mode
   "error": length min/max, event-time group-by avg, time min (matrix),
   externalTime, timeLength, cumulative group-by, lengthBatch, timeBatch
   group-by, externalTimeBatch, cron, expired events over length and time
   windows, delay, and an INT sum that wraps int32 (exact);
8. multiquery64 (in a process of its own, `--multiquery OUT`): the bench's
   64 two-step chains (query q from id q mod 50 to id (7q + 1) mod 50,
   each into its own stream) compiled to one stacked artifact stepping
   131,072-event windows, as phase 5b runs the bench main path: streaming
   rows of the first 1,048,576 events held to the CPU path in all 64
   streams, host syncs only the drains', ResidentReplay counts-only with
   both chain kernels launched once per step (80 a run, on the host and
   in the trace) and no compaction read, and the rest of phase 5b (fused
   streaming included; the resident and fused rows over the first
   1,048,576 events: 4 segments of 2 steps on one graph); then one
   step on
   the stack's full-width branch (its peak memory, its rows equal to the
   compacted branch's). The chain kernels' stacked inputs go to phase 9;
9. kernels: each kernel timed on the inputs it was given on its path — its
   device time (profiler trace; for the unique fold CUDA events over 25
   back-to-back calls and each stage kernel's traced device time) and its
   per-call time (CUDA events, median) — beside its plain version, the
   library call that computes the same function where there is one, its
   bound and the launch floor (an empty kernel's device time). The reverse
   cummin and the chain advance also at full width (the headline's own
   524,288-event tapes with relevance compaction off) and at multiquery64's
   stacked shapes (held exactly to their plain versions first), and their
   kernel launches per call counted in a profiler trace (each must be 1);
10. where the quote board's time goes: tape staging, device steps (under
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
"""

import dataclasses
import inspect
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 524_288
N_BATCHES = 20
CHECK_BATCHES = 2  # rows held to the CPU path over these micro-batches
N_IDS = 50
N_IDS_WINDOW = 1_000  # window_groupby's ids (bench.py:479)
WINDOW_CLASS_BATCHES = 4  # micro-batches of each other window class
MATRIX_BATCH = 65_536  # the matrix path's batch: [E, C] windows per column
WINDOW_RTOL = 1e-5  # float sums and averages, card against the CPU
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
L2_BYTES = 50 * 2**20  # H100 SXM L2, same source
INT32_OPS_PER_S = 67e12  # non-tensor-core 32-bit rate, same source
F32_OPS_PER_S = 67e12  # non-tensor-core float32 rate, same source
QUOTE_BATCHES = 20  # the quote board's stream: 20 x 524,288 events
QUOTE_CHECK_EVENTS = 32_768  # rows held to the CPU path over these events
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
                  "unique_window_fold": "rows_kernel"}


def traced_launches(prof):
    """Per kernel wrapper, its calls that ran on the card in a profiler
    trace: the records of the kernel it launches once a call
    (TRACED_KERNELS)."""
    import re

    from torch.autograd import DeviceType

    pats = {k: re.compile(rf"(?<!\w){n}(?!\w)")
            for k, n in TRACED_KERNELS.items()}
    out = dict.fromkeys(TRACED_KERNELS, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k, pat in pats.items():
                if pat.search(e.name):
                    out[k] += 1
    return out


def traced_run(co, run, what, prepare=None, attempts=3):
    """``run()``, which returns its wall seconds, in a profiler trace of
    the card and the host, after ``prepare()`` and with the wrappers'
    launch counts reset. The launches each wrapper counted on the host
    must equal its calls that ran on the card (``traced_launches``): on a
    graph path each replay adds the launches its capture counted back to
    the host counts, so only the trace shows that a replay ran each
    kernel. A trace with fewer records than the host counted (the tracer
    loses records at times, see ``kernel_records``) is taken again, up to
    ``attempts`` times; one with more fails at once. Returns (trace,
    seconds, launches counted in the trace)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        if prepare is not None:
            prepare()
        co.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run()
        host = co.launch_counts()
        traced = traced_launches(prof)
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
    run traced but unrecorded before the window."""
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


def fold_err(got, ref, slots, what):
    """Kernel vs plain fold, NaN-aware: the table bitwise equal; NaN at the
    same places of every row; elsewhere counts, minima and maxima equal and
    sums and averages within FOLD_RTOL. Returns the rows' max abs and max
    relative error over the finite values."""
    import torch

    if not torch.equal(got[0], ref[0]):
        raise AssertionError(f"{what}: valid differs")
    g, r = got[1], ref[1]
    if (g.dtype != r.dtype or g.shape != r.shape
            or not torch.equal(g.view(torch.int32), r.view(torch.int32))):
        raise AssertionError(f"{what}: bufs differ")
    rows, ref_rows = got[2], ref[2]
    if rows.shape != ref_rows.shape:
        raise AssertionError(f"{what}: rows shape differs")
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
    err = rel = 0.0
    for i, (name, E, C, A, slots, codes, kw) in enumerate(cases + nonfinite):
        args = fold_inputs(dev, gen, E, C, A, codes=codes, **kw)
        if i >= len(cases):
            args = non_finite(dev, gen, args)
        got = co.unique_window_fold(*args, slots)
        ref = co.unique_window_fold_plain(*args, slots)
        torch.cuda.synchronize()
        e, r = fold_err(got, ref, slots, f"unique_window_fold {name}")
        n_nan = int(torch.isnan(ref[2]).sum())
        err, rel = max(err, e), max(rel, r)
        log(f"  unique_window_fold {name}: table exact, rows max abs err "
            f"{e:.6g}, max rel err {r:.3g}, NaN cells {n_nan}, "
            f"{co.unique_window_fold.kernel_launches} kernel launches, "
            f"{co.unique_window_fold.scratch_bytes} B scratch")
    return err, rel


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


def rows_match(got, ref, rtol, what):
    """Fails unless the rows ``got`` equal ``ref``: the same timestamps in
    the same order and every value equal, float values within ``rtol``
    (0: exactly). Returns the largest relative difference of a float."""
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
        for a, b in zip(rg, rr):
            if a == b:
                continue
            if not (isinstance(b, float) and isinstance(a, float)):
                raise AssertionError(f"{what}: row at {tr}: {rg} vs {rr}")
            rel = abs(a - b) / abs(b)
            if not rel <= rtol:
                raise AssertionError(f"{what}: row at {tr}: {rg} vs {rr}")
            worst = max(worst, rel)
    return worst


def stream_rows(job, outs):
    """Every output stream's rows (with timestamps) of a job."""
    return {o: job.results_with_ts(o) for o in outs}


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
    if job.host_syncs != job.drain_syncs:
        raise AssertionError(
            f"{name}: {job.host_syncs} host syncs, {job.drain_syncs} of "
            "them drain fetches"
        )
    streaming = {"rows": n_rows, "wall_s": wall,
                 "events_per_s": n_events / wall,
                 "host_syncs": job.host_syncs,
                 "drain_syncs": job.drain_syncs}
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
    captured = job.graphs_captured
    co.reset_launches()
    syncs0 = getattr(art, "host_syncs", 0)
    host_syncs0 = job.host_syncs
    t0 = time.perf_counter()
    rep.run()
    job.flush()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = co.launch_counts()
    run_syncs = job.host_syncs - host_syncs0
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
        reruns.append(rep.rerun())
        if sum(job.emitted_counts.values()) - before != count:
            raise AssertionError(f"{name}: a rerun emitted another count")
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
    if rjob.eager_segments or not res_segments > rjob.graphs_captured:
        raise AssertionError(
            f"{name}: the resident row check ran {rjob.eager_segments} "
            f"eager segments, {res_segments} segments on "
            f"{rjob.graphs_captured} graphs (none replayed on another "
            "segment)"
        )
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
            "eager_segments": 0,
            "host_syncs_first_run": run_syncs,
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
    FUSED_K tapes (at most the package's MAX_INFLIGHT_CYCLES, bench.py's
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
            or not job.fusion_dispatches > job.graphs_captured):
        raise AssertionError(
            f"{name}: the fused row check ran {job.eager_segments} eager "
            f"segments, {job.fusion_dispatches} segments on "
            f"{job.graphs_captured} graphs (none replayed on another "
            "segment)"
        )
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

    from flink_siddhi_tpu_torch.runtime.executor import MAX_INFLIGHT_CYCLES

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
        syncs0, drains0 = job.host_syncs, job.drain_syncs
        disp0, up0 = job.fusion_dispatches, job.fusion_h2d_uploads
        runs.append(run())
    launches = co.launch_counts()
    dispatches = job.fusion_dispatches - disp0
    k = job._fused_k(job._plans["bench"])
    steps = dispatches * k  # every segment padded to k tapes
    if job.host_syncs - syncs0 != job.drain_syncs - drains0:
        raise AssertionError(f"{name}: streaming host syncs beyond the "
                             "drains")
    result = {
        "segment_len": k,
        "max_inflight_cycles": MAX_INFLIGHT_CYCLES,
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
        "host_syncs": job.host_syncs - syncs0,
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
    if not rows or job.host_syncs != job.drain_syncs:
        raise AssertionError(f"window class {name}: {len(rows)} rows, "
                             f"{job.host_syncs} host syncs, "
                             f"{job.drain_syncs} of them drains")
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
    at batch 524,288 (65,536 on the matrix path) over four micro-batches."""
    wschema, wbatches = bench_stream(fpt, BATCH * N_BATCHES, BATCH,
                                     n_ids=N_IDS_WINDOW)
    plan = fpt.compile_plan(WINDOW_GROUPBY, {"inputStream": wschema},
                            config=bench_config(fpt))
    if plan.spec.device_columns != ("inputStream.price",):
        raise AssertionError("window_groupby ships "
                             f"{plan.spec.device_columns}")
    bench = bench_main_path(fpt, co, "window_groupby", WINDOW_GROUPBY,
                            wschema, wbatches, chain=False,
                            rtol=WINDOW_RTOL,
                            expect_rows=BATCH * N_BATCHES)
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

    schema, batches = bench_stream(fpt, BATCH * N_BATCHES, BATCH)
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
    steps = N_BATCHES * BATCH // MQ_STEP_EVENTS
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
    if launches != {"multi_reverse_cummin": 0, "chain_advance": 0,
                    "unique_window_fold": QUOTE_BATCHES}:
        raise AssertionError(
            f"quote board: launches {launches}, expected the unique fold "
            f"once per micro-batch ({QUOTE_BATCHES})"
        )
    if job.host_syncs != job.drain_syncs:
        raise AssertionError("quote board: host syncs beyond the drains")
    host_syncs, drain_syncs = job.host_syncs, job.drain_syncs
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
    # the row check and the warm run); its rows over the whole stream
    # held to the eager run's
    fused, frel = fused_segment(
        fpt, co, "quote_board", QUOTE_BOARD, schema, batches,
        outs=("Board",), config=None, cpu_rows={"Board": cpu_rows},
        cpu_ts=int(check[-1].timestamps[-1]), eager_rows={"Board": rows},
        rtol=FOLD_RTOL, stream="StockStream",
        expect_launches=("unique_window_fold",),
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
        "host_syncs": host_syncs,
        "drain_syncs": drain_syncs,
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

    mask, codes, vals, valid0, bufs0, slots = args
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

    # 5. filter end to end (no kernel on this path)
    log("[5/11] filter")
    end_to_end(fpt, co, "filter", FILTER, schema, batches,
               kernels_expected=())

    # 5b. both paths as bench.py runs them: its EngineConfig, the streaming
    # Job and ResidentReplay
    log("[5b/11] bench main path: lazy projection + predicate pushdown, "
        "streaming Job and ResidentReplay")
    bench_head = bench_main_path(fpt, co, "headline", HEADLINE, schema,
                                 batches, chain=True)
    bench_filter = bench_main_path(fpt, co, "filter", FILTER, schema,
                                   batches, chain=False)
    bench_p2 = bench_main_path(fpt, co, "pattern2", PATTERN2, schema,
                               batches, chain=True)
    del schema, batches

    # 6. the quote board end to end; record the fold's inputs of the
    # second micro-batch (calls 1 and 2 are the CPU check and the warm-up)
    log(f"[6/11] quote board: {QUOTE_BATCHES * BATCH} events in "
        f"{QUOTE_BATCHES} micro-batches of {BATCH}")
    rec_k3 = Recorder(co.unique_window_fold, keep=4)
    scan_windows.unique_window_fold = rec_k3
    try:
        board, qschema, qbatches = quote_board(fpt, co)
    finally:
        scan_windows.unique_window_fold = co.unique_window_fold

    # 7. windows and aggregation: the bench's window_groupby and every other
    # window class (no kernel on these paths)
    log(f"[7/11] windows: window_groupby over {BATCH * N_BATCHES} events "
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
        f"{BATCH * N_BATCHES} events, {MQ_STEP_EVENTS}-event steps")
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

    # 9. kernel timing on each path's own inputs
    log("[9/11] kernels on their paths' inputs")
    if rec_k1.args is None or rec_k2.args is None or rec_k3.args is None:
        raise AssertionError("no kernel inputs recorded on the main paths")
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
    floor_ms, floor_call_ms = timed(co.launch_empty)
    log(f"  launch floor: an empty kernel's device time {floor_ms} ms "
        f"(call {floor_call_ms} ms)")
    if rec_k3.args[0].device.type != "cuda":
        raise AssertionError("the recorded fold call did not run on the card")
    slots = rec_k3.args[-1]
    e3, r3 = fold_err(co.unique_window_fold(*rec_k3.args),
                      co.unique_window_fold_plain(*rec_k3.args), slots,
                      "unique_window_fold main-path input")
    err_k3, rel_k3 = max(err_k3, e3), max(rel_k3, r3)
    kernels = [
        time_reverse_cummin(co, rec_k1, full_k1,
                            head["launches"]["multi_reverse_cummin"],
                            err_k1, floor_ms),
        time_chain_advance(co, rec_k2, full_k2,
                           head["launches"]["chain_advance"], err_k2,
                           floor_ms),
        time_unique_fold(co, rec_k3.args,
                         board["launches"]["unique_window_fold"], err_k3,
                         rel_k3, floor_ms),
    ]
    # the kernels' calls that ran on the card in a traced rerun of the
    # bench main path's resident headline and multiquery64's, and in a
    # traced fused run of the quote board (kernel records in the profiler
    # trace, equal to the host's counts: traced_run)
    for k in kernels:
        k["launches_bench_main_path"] = \
            bench_head["resident"]["launches_traced"][k["name"]]
        k["launches_multiquery64"] = \
            mq["bench"]["resident"]["launches_traced"][k["name"]]
        k["launches_fused_quote_board"] = \
            board["fused_streaming"]["launches_traced"][k["name"]]
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
    log("[10/11] quote board: where the time goes")
    breakdown(fpt, "quote_board", QUOTE_BOARD, qschema, qbatches,
              stream="StockStream", out="Board", sync_free=True)
    del qschema, qbatches

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
    "host_syncs", "host_syncs_first_run", "launches", "launches_traced",
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


def ab(roots, mode="--ab-one"):
    for root in roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            mode, root])
        if r.returncode != 0:
            print(f"chip_smoke --ab: {root} failed ({r.returncode})",
                  file=sys.stderr)
            return 1
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
    if len(sys.argv) == 3 and sys.argv[1] == "--multiquery":
        sys.exit(multiquery_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-one":
        sys.exit(ab_one(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab":
        sys.exit(ab(sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-graphs-one":
        sys.exit(ab_graphs_one(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab-graphs":
        sys.exit(ab(sys.argv[2:], mode="--ab-graphs-one"))
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
