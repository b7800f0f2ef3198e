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
   all-INT_MAX, ascending, descending and full-range rows, and over 1,000
   back-to-back calls; the chain advance exactly on headline-shaped inputs
   whose gathers are local (each fresh start searching from the next
   position) and on inputs with random positions, with padded and
   contiguous table rows, V = 0 (no kernel on the card), E = 0 and a
   `within` that wraps int32; the unique-window fold (NaN-aware) with its
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
5b. bench main path: the headline and the filter as bench.py runs them,
   with EngineConfig(lazy_projection=True, pred_pushdown=True): the
   streaming Job over the whole stream (rows of the first 1,048,576 events
   held to the CPU path under the same settings; for the headline, host
   syncs equal to the drain fetches alone), then ResidentReplay
   counts-only — stage seconds, run() + flush() and three rerun()s
   (events/s median and best of the reruns), emitted counts equal to the
   streaming run's, the chain kernels launched once per compacted step
   (every step compacted on the host-known bound, with no read), one
   staged segment's steps under sync debug mode "error", wire bytes per
   event from the staged tensors, peak device memory, a profiler-traced
   rerun's idle share — and a resident run with a collector over the
   first 1,048,576 events whose rows equal the streaming rows, with no
   lazy-ring miss;
6. quote board: `#window.unique(symbol)` with count/sum/avg/min/max over
   StockStream, 10,000 Zipf-weighted symbols (a 16,384-slot table), at
   batch 524,288 over 10,485,760 events, the unique-window fold called
   once per micro-batch and host syncs counted (drains only); rows checked
   against the port's CPU path on the first 32,768 events;
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
8. kernels: each kernel timed on the inputs it was given on its path — its
   device time (profiler trace; for the unique fold CUDA events over 25
   back-to-back calls and each stage kernel's traced device time) and its
   per-call time (CUDA events, median) — beside its plain version, the
   library call that computes the same function where there is one, its
   bound and the launch floor (an empty kernel's device time). The reverse
   cummin and the chain advance also at full width (the headline's own
   524,288-event tapes with relevance compaction off), and their kernel
   launches per call counted in a profiler trace (each must be 1);
9. where the quote board's time goes: tape staging, device steps (under
   torch's sync debug mode "error": a host wait inside a step fails the
   run) and a profiler-traced run for the card's idle share;
10. api: the README's quick start, pattern and quote board through
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
"""

import dataclasses
import inspect
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
INT32_OPS_PER_S = 67e12  # non-tensor-core 32-bit rate, same source
F32_OPS_PER_S = 67e12  # non-tensor-core float32 rate, same source
QUOTE_BATCHES = 20  # the quote board's stream: 20 x 524,288 events
QUOTE_CHECK_EVENTS = 32_768  # rows held to the CPU path over these events
N_SYMBOLS = 10_000
FOLD_RTOL = 1e-5  # sums: the kernel's fp64 scan vs the plain float32 fold
AB_REPEATS = 3  # full runs of each path per checkout with --ab

HEADLINE = (
    "from every s1 = inputStream[id == 1] -> s2 = inputStream[id == 2] -> "
    "s3 = inputStream[id == 3] within 5 sec "
    "select s1.timestamp as t1, s3.timestamp as t3, s3.price as price "
    "insert into matches"
)
FILTER = (
    "from inputStream[id == 2] select id, name, price insert into matches"
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
    if rtol == 0.0:
        if got != ref:
            raise AssertionError(f"{what}: rows differ")
        return 0.0
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


def bench_main_path(fpt, co, name, cql, schema, batches, chain, rtol=0.0,
                    expect_rows=None):
    """One path as bench.py runs it: EngineConfig(lazy_projection=True,
    pred_pushdown=True) over the whole stream, through the streaming Job
    (rows of the first micro-batches held to the CPU path under the same
    settings; host syncs) and through ResidentReplay, counts-only as
    bench.py's resident mode runs it: stage, run() + flush(), three
    rerun()s. Then the steps of one staged segment under torch's sync debug
    mode "error", a resident run with a collector over the first
    micro-batches (rows equal to the streaming run's, no lazy miss), and a
    profiler-traced rerun for the card's idle share. With ``chain`` the
    chain kernels must launch once per compacted step, and every step must
    have been compacted on the host-known bound (no read). Floats of the
    rows are held to the CPU path within ``rtol`` (0: exactly); with
    ``expect_rows`` the run must emit that many rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = bench_config(fpt)
    check = batches[:CHECK_BATCHES]
    n_events = sum(len(b) for b in batches)
    last_ts = int(check[-1].timestamps[-1])
    cpu_rows, cpu_s, _ = run_job(fpt, cql, schema, check, "cpu", config=cfg)
    run_job(fpt, cql, schema, check, "cuda", config=cfg)  # warm-up

    # the streaming Job over the whole stream, rows kept
    rows, wall, job = run_job(fpt, cql, schema, batches, "cuda", config=cfg)
    max_rel = rows_match(
        [r for r in rows if r[0] <= last_ts], cpu_rows, rtol,
        f"{name}: streaming rows of the first "
        f"{sum(len(b) for b in check)} events against the CPU path",
    )
    rt = job._plans["bench"]
    if rt.lazy is not None and rt.lazy.missed:
        raise AssertionError(f"{name}: {rt.lazy.missed} lazy misses")
    if job.host_syncs != job.drain_syncs:
        raise AssertionError(
            f"{name}: {job.host_syncs} host syncs, {job.drain_syncs} of "
            "them drain fetches"
        )
    streaming = {"rows": len(rows), "wall_s": wall,
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
    tapes = [t for seg in segs for t in seg]
    # the bytes each staged tape holds on the card (n_valid and the ts
    # base stay on the host as scalars)
    wire_bytes = sum(a.nbytes for t in tapes for a in t.arrays())
    ts_kinds = sorted({t.ts_kind for t in tapes})
    seg_lens = [len(seg) for seg in segs]
    art = job._plans[pid].plan.artifacts[0]
    co.reset_launches()
    syncs0 = getattr(art, "host_syncs", 0)
    t0 = time.perf_counter()
    rep.run()
    job.flush()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = co.launch_counts()
    count = job.emitted_counts.get("matches", 0)
    if count != streaming["rows"] or count != (expect_rows or count):
        raise AssertionError(f"{name}: resident run emitted {count} rows, "
                             f"the streaming run {streaming['rows']}")
    if chain:
        from flink_siddhi_tpu_torch.compiler.nfa import _compact_width

        R = _compact_width(BATCH)
        compacted = sum(t.bounds[art.name] <= R for t in tapes)
        if compacted != len(tapes) or art.host_syncs != syncs0:
            raise AssertionError(f"{name}: {compacted} of {len(tapes)} "
                                 "steps compacted without a read")
        for k in ("multi_reverse_cummin", "chain_advance"):
            if launches[k] != compacted:
                raise AssertionError(
                    f"{name}: {k} launched {launches[k]} times for "
                    f"{compacted} compacted steps"
                )
    reruns = []
    for _ in range(3):
        before = job.emitted_counts["matches"]
        reruns.append(rep.rerun())
        if job.emitted_counts["matches"] - before != count:
            raise AssertionError(f"{name}: a rerun emitted another count")
    peak = torch.cuda.max_memory_allocated()

    # one staged segment's steps with no host wait
    job.reset_engine_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rep.run_segment(pid, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # a profiler-traced rerun: the card's idle share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_s = rep.rerun()
    busy_us, per_name = device_activity(prof)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    stage_s = rep.stage_seconds
    del rep, job, tapes, segs

    # resident rows with a collector, over the first micro-batches
    rjob = replay_job(fpt, cql, schema, check, retain=True)
    fpt.ResidentReplay(rjob).execute()
    res_rows = rjob.results_with_ts("matches")
    max_rel = max(max_rel, rows_match(res_rows, cpu_rows, rtol,
                                      f"{name}: resident rows"))
    lazy = rjob._plans["bench"].lazy
    if lazy is not None and lazy.missed:
        raise AssertionError(f"{name}: resident rows missed lazy values")
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
            "max_memory_allocated_bytes": peak,
            "traced_rerun_s": traced_s,
            "traced_device_busy_s": busy_us / 1e6,
                "traced_idle_share": 1 - busy_us / 1e6 / traced_s,
            "top_device_ms": [[k[:70], v / 1e3] for k, v in top],
            "segment_steps_sync_free": True,
        },
        "wire_bytes_per_event": wire_bytes / n_events,
        "wire_bytes": wire_bytes,
        "ts_kinds": ts_kinds,
        "cpu_check_events": sum(len(b) for b in check),
        "cpu_check_rows": len(cpu_rows),
        "cpu_check_s": cpu_s,
        "resident_check_rows": len(res_rows),
        "max_rel_err_vs_cpu": max_rel,
    }
    log(json.dumps(result))
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
    state = job._plans["bench"].states["query_0"]
    slots = int(state["valid"].shape[0])
    bucket = 128
    while bucket < n_keys:
        bucket *= 2
    if slots != bucket or int(state["valid"].sum()) != n_keys:
        raise AssertionError(
            f"quote board: a table of {slots} slots for {n_keys} symbols"
        )
    result = {
        "path": "quote_board",
        "events": n_events,
        "batch": BATCH,
        "rows": len(rows),
        "symbols": n_keys,
        "table_slots": slots,
        "fold_kernel_launches_per_call":
            co.unique_window_fold.kernel_launches,
        "fold_scratch_bytes": co.unique_window_fold.scratch_bytes,
        "wall_s": wall,
        "events_per_s": n_events / wall,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "host_syncs": job.host_syncs,
        "drain_syncs": job.drain_syncs,
        "launches": launches,
        "cpu_check_events": QUOTE_CHECK_EVENTS,
        "cpu_check_rows": len(cpu_rows),
        "cpu_check_s": cpu_s,
        "cpu_check_max_rel_err": rel,
    }
    log(json.dumps(result))
    return result, schema, batches


def keep_copy(a):
    """A copy of a kernel argument; a tensor keeps its strides (the
    padded next-match table's rows stay 16-byte aligned)."""
    import torch

    if not isinstance(a, torch.Tensor):
        return a
    return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                               device=a.device).copy_(a)


class Recorder:
    """Forwards to a kernel wrapper and keeps a copy of the inputs of its
    ``keep``-th call (the main path's real inputs for phase 8)."""

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


# -- phase 8: kernel timing on main-path inputs -------------------------------

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
    ms, call_ms = timed(lambda: co.multi_reverse_cummin(x, pad=pad))
    plain_ms, plain_call_ms = timed(lambda: co.reverse_cummin_plain(x, pad))
    # the one PyTorch call computing the same function (without the pad
    # column): cummin of the flipped rows
    lib_ms, _ = timed(
        lambda: torch.flip(torch.cummin(torch.flip(x, [-1]), -1).values,
                           [-1])
    )
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
    """(bytes, gathers) of the advance on THESE inputs: the candidate rows
    streamed in and out, plus one 4-byte read per gather that a live
    candidate issues (table and ts reads, capped at their sizes);
    candidates not at step k issue no gather at step k."""
    import torch

    nxt, pos_rows, guard_rows, ts_pad, act, step, pos, start, within = args
    E = int(ts_pad.shape[0]) - 1
    V = int(act.shape[0])
    n_steps = len(pos_rows)
    gathers = 0
    a, s, p = act, step, pos
    for k in range(1, n_steps + 1):
        at_k = a & (s == k)
        idx = p.clamp(0, E).long()
        gathers += (1 + len(guard_rows[k - 1])) * int(at_k.sum())
        j = nxt[pos_rows[k - 1]][idx]
        found = at_k & (j < E)
        for g in guard_rows[k - 1]:
            jg = nxt[g][idx]
            bad = at_k & (jg <= j) & (jg < E)
            a = a & ~bad
            found = found & ~bad
        if within is not None:
            gathers += int(found.sum())  # ts[j]
            ok = (ts_pad[j.long()] - start) <= within
            a = a & ~(found & ~ok)
            found = found & ok
        s = torch.where(found, k + 1, s)
        p = torch.where(found, j + 1, p)
    # act 1 B + step/pos/start 12 B in; act 1 B + step/pos 8 B + jmat out
    streamed = V * 13 + V * 9 + n_steps * V * 4
    tables = (int(nxt.shape[0]) * (E + 1) + E + 1) * 4
    return streamed + min(tables, 4 * gathers), gathers


def chain_advance_times(co, args):
    """Device and call ms of the kernel and its plain version, the bound
    and the kernel launches per call (counted on the card), on one
    input."""
    nxt, pos_rows, guard_rows, ts_pad, act, step, pos, start, within = args
    ms, call_ms = timed(lambda: co.chain_advance(*args))
    plain_ms, plain_call_ms = timed(lambda: co.chain_advance_plain(*args))
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
            "shape": {"rows": int(nxt.shape[0]),
                      "row_stride": int(nxt.stride(0)),
                      "E": int(ts_pad.shape[0]) - 1,
                      "V": int(act.shape[0]), "K": len(pos_rows) + 1,
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
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/10] device: {kind} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    # 2. build
    build_s = co.build()
    log(f"[2/10] build: {len(co.SOURCES)} kernel sources in "
        f"{build_s:.2f} s")
    for name, out in co.LIBRARIES.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions (synthetic inputs)
    gen = torch.Generator().manual_seed(7)
    gen_dev = torch.Generator(device=dev).manual_seed(7)
    log("[3/10] kernels vs plain versions")
    err_k1 = check_reverse_cummin(co, dev, gen_dev)
    err_k2 = check_chain_advance(co, dev, gen_dev)
    err_k3, rel_k3 = check_unique_fold(co, dev, gen)

    # 4. headline end to end; record each kernel's inputs mid-run
    schema, batches = bench_stream(fpt, BATCH * N_BATCHES, BATCH)
    log(f"[4/10] headline: {BATCH * N_BATCHES} events in {N_BATCHES} "
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
    log("[5/10] filter")
    end_to_end(fpt, co, "filter", FILTER, schema, batches,
               kernels_expected=())

    # 5b. both paths as bench.py runs them: its EngineConfig, the streaming
    # Job and ResidentReplay
    log("[5b/10] bench main path: lazy projection + predicate pushdown, "
        "streaming Job and ResidentReplay")
    bench_head = bench_main_path(fpt, co, "headline", HEADLINE, schema,
                                 batches, chain=True)
    bench_main_path(fpt, co, "filter", FILTER, schema, batches, chain=False)
    del schema, batches

    # 6. the quote board end to end; record the fold's inputs of the
    # second micro-batch (calls 1 and 2 are the CPU check and the warm-up)
    log(f"[6/10] quote board: {QUOTE_BATCHES * BATCH} events in "
        f"{QUOTE_BATCHES} micro-batches of {BATCH}")
    rec_k3 = Recorder(co.unique_window_fold, keep=4)
    scan_windows.unique_window_fold = rec_k3
    try:
        board, qschema, qbatches = quote_board(fpt, co)
    finally:
        scan_windows.unique_window_fold = co.unique_window_fold

    # 7. windows and aggregation: the bench's window_groupby and every other
    # window class (no kernel on these paths)
    log(f"[7/10] windows: window_groupby over {BATCH * N_BATCHES} events "
        f"({N_IDS_WINDOW} ids), then {len(WINDOW_CLASSES)} window classes")
    # in a process of its own: after this phase's traced rerun, the
    # kernel timing's traces in the same process lost records
    t_win = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--windows"], timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"windows phase failed ({r.returncode})")
    log(f"  windows phase {time.perf_counter() - t_win:.1f} s")

    # 8. kernel timing on each path's own inputs
    log("[8/10] kernels on their paths' inputs")
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
    # the kernels' launches in the bench main path's first resident run
    for k in kernels:
        k["launches_bench_main_path"] = \
            bench_head["resident"]["launches"][k["name"]]
    for k in kernels[:2]:
        log(f"  {k['name']}: {k['ms']} ms (call {k['call_ms']}), full "
            f"width {k['full_width']['ms']} ms, bound {k['bound_ms']}, "
            f"floor {floor_ms}")

    # 9. where the quote board's time goes (after the kernel timing: a
    # profiler session after this traced run recorded no device time on
    # the card)
    log("[9/10] quote board: where the time goes")
    breakdown(fpt, "quote_board", QUOTE_BOARD, qschema, qbatches,
              stream="StockStream", out="Board", sync_free=True)
    del qschema, qbatches

    # 10. the API on the default device
    log("[10/10] api")
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


def ab(roots):
    for root in roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--ab-one", root])
        if r.returncode != 0:
            print(f"chip_smoke --ab: {root} failed ({r.returncode})",
                  file=sys.stderr)
            return 1
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
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-one":
        sys.exit(ab_one(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab":
        sys.exit(ab(sys.argv[2:]))
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
