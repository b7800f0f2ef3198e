"""Event time in the torch port, held against the JAX package on the CPU
(``tests/test_event_time.py`` through the port).

* The watermark strategies and ``WatermarkedSource``, unit by unit, side by
  side with the reference's.
* Disorder: a seeded ``DisorderSchedule`` (bounded-skew shuffle and bursty
  duplicates) feeds the port a shuffled stream; its rows equal the port's
  own run over the sorted stream, the JAX package's run over the same
  shuffled stream, and ``baseline/interp.py`` over the sorted stream, in
  the streaming, fused and resident modes.
* The three late policies with exact counts against the injected
  schedule: 'drop', 'side_output' (full rows on ``late_stream``, to row
  and columnar sinks) and 'allow' (within and beyond the allowance).
* Idle sources, also under the 'block' shed policy.
* A two-source join under disorder, against the sorted streams and the
  JAX package.
* The gate's state across a checkpoint, and supervised kill and restore
  under disorder with 0 duplicate and 0 lost rows.
"""

import collections
import glob
import logging
import time

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime import executor as jax_executor
from flink_siddhi_tpu.runtime import faultinject as jax_faults
from flink_siddhi_tpu.runtime import sources as jax_sources
from flink_siddhi_tpu.runtime.replay import ResidentReplay as JaxReplay
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.runtime import executor as torch_executor
from flink_siddhi_tpu_torch.runtime import faultinject as torch_faults
from flink_siddhi_tpu_torch.runtime import sources as torch_sources
from flink_siddhi_tpu_torch.runtime.executor import MAX_WM, late_stream
from flink_siddhi_tpu_torch.runtime.faultinject import (
    CrashPlan,
    DisorderSchedule,
    DisorderSource,
    wrap_job,
)
from flink_siddhi_tpu_torch.runtime.sources import (
    BoundedDisorderWatermark,
    CallbackSource,
    ListSource,
    PunctuatedWatermark,
    WatermarkedSource,
    with_watermarks,
)
from flink_siddhi_tpu_torch.runtime.supervisor import Supervisor

torch.set_num_threads(2)

FIELDS = [("id", "int"), ("price", "double"), ("timestamp", "long")]

# (schema, compile_plan, Job, sources module, faultinject, ResidentReplay,
# Job keywords) of each package
PKGS = {
    "jax": (JaxSchema, jax_compile, jax_executor.Job, jax_sources,
            jax_faults, JaxReplay, {}),
    "torch": (fpt.StreamSchema, fpt.compile_plan, fpt.Job, torch_sources,
              torch_faults, fpt.ResidentReplay, {"device": "cpu"}),
}


def _schema(pkg="torch"):
    return PKGS[pkg][0](list(FIELDS))


def _stream(n=6000, seed=0, n_ids=5, step_ms=7):
    """Pristine sorted stream; integer-valued prices keep window sums
    exact in float32."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_ids, n)
    prices = rng.integers(0, 50, n).astype(np.float64)
    ts = 1_000 + np.arange(n, dtype=np.int64) * step_ms
    records = [(int(i), float(p), int(t)) for i, p, t in zip(ids, prices, ts)]
    return records, ts.tolist()


MULTI_CQL = (
    "from S[id == 2] select id, price insert into o_filter; "
    "from every s1 = S[id == 0] -> s2 = S[id == 1] within 2 sec "
    "select s1.timestamp as t1, s2.timestamp as t2 insert into o_pat; "
    "from S#window.length(50) select id, sum(price) as total, "
    "count() as cnt group by id insert into o_win; "
    "from S#window.timeBatch(3 sec) select sum(price) as total "
    "insert into o_tb; "
    "from S#window.unique(id) select id, sum(price) as total, "
    "count() as cnt insert into o_uni"
)
INTERP_CQL = (
    "from S[id == 2] select id, price insert into o_filter; "
    "from every s1 = S[id == 0] -> s2 = S[id == 1] within 2 sec "
    "select s1.timestamp as t1, s2.timestamp as t2 insert into o_pat; "
    "from S#window.length(50) select id, sum(price) as total, "
    "count() as cnt group by id insert into o_win"
)
FILTER_CQL = "from S[id == 2] select id, price insert into o"

CHUNK = 300
SKEW_MS = 200


def _norm(ts, row):
    return (int(ts), tuple(np.float32(v).item() if isinstance(v, float)
                           else v for v in row))


def _results(job):
    return {sid: sorted(_norm(t, r) for t, r in job.results_with_ts(sid))
            for sid in job.collected}


def _job(pkg, cql, sources, schema, **attrs):
    _, compile_plan, Job, *_rest, kw = PKGS[pkg]
    plan = compile_plan(cql, {"S": schema})
    job = Job([plan], sources, batch_size=CHUNK, time_mode="event", **kw)
    for k, v in attrs.items():
        setattr(job, k, v)
    return job


def _run_sorted(records, ts, cql=MULTI_CQL, pkg="torch"):
    # skew 0 (claims max - 1): duplicates at the previous batch's max ts
    # are not late
    srcs = PKGS[pkg][3]
    schema = _schema(pkg)
    job = _job(pkg, cql, [srcs.with_watermarks(
        srcs.ListSource("S", schema, records, timestamps=ts, chunk=CHUNK),
        skew_ms=0)], schema)
    job.run()
    assert job.late_events == 0
    return job


def _run_disordered(records, ts, schedule, mode="streaming", cql=MULTI_CQL,
                    strategy_skew=SKEW_MS, pkg="torch", **attrs):
    _, _, _, srcs, faults, Replay, _ = PKGS[pkg]
    schema = _schema(pkg)
    src = faults.DisorderSource(
        srcs.ListSource("S", schema, records, timestamps=ts, chunk=CHUNK),
        schedule, chunk=CHUNK)
    job = _job(pkg, cql, [srcs.with_watermarks(src, skew_ms=strategy_skew)],
               schema, **attrs)
    if mode == "fused":
        job.fused_segment_len = 3
        job.run()
    elif mode == "resident":
        rep = Replay(job)
        rep.stage()
        rep.run()
        job.flush()
    else:
        job.run()
    return job, src


def _jax_schedule(sched):
    return jax_faults.DisorderSchedule(**{
        f: getattr(sched, f) for f in sched.__dataclass_fields__})


# -- watermark strategy units -----------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_bounded_disorder_strategy(pkg):
    Strategy = PKGS[pkg][3].BoundedDisorderWatermark
    s = Strategy(500)
    assert s.current() is None
    s.observe(np.asarray([1_000, 3_000, 2_000]))
    assert s.current() == 2_499  # max - skew - 1
    s.observe(np.asarray([2_900]))
    assert s.current() == 2_499
    s.observe(np.asarray([10_000]))
    assert s.current() == 9_499
    clone = s.clone()
    assert clone.skew_ms == 500 and clone.current() is None
    fresh = Strategy(500)
    fresh.load_state_dict(s.state_dict())
    assert fresh.current() == 9_499
    assert s.state_dict() == {"kind": "bounded", "skew_ms": 500,
                              "max_ts": 10_000}
    with pytest.raises(ValueError):
        Strategy(-1)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_punctuated_strategy_passes_native_claims(pkg):
    s = PKGS[pkg][3].PunctuatedWatermark()
    s.observe(np.asarray([99_999]))
    assert s.current() is None
    s.advance(4_000)
    s.advance(3_000)
    assert s.current() == 4_000
    fresh = PKGS[pkg][3].PunctuatedWatermark()
    fresh.load_state_dict(s.state_dict())
    assert fresh.current() == 4_000
    assert s.state_dict() == {"kind": "punctuated", "wm": 4_000}


def test_watermarked_source_replaces_native_claim():
    schema = _schema()
    records, ts = _stream(n=10, step_ms=100)
    src = WatermarkedSource(
        ListSource("S", schema, records, timestamps=ts, chunk=5),
        BoundedDisorderWatermark(250),
    )
    batch, wm, done = src.poll(5)
    assert len(batch) == 5 and not done
    assert wm == int(batch.timestamps.max()) - 250 - 1
    d = src.state_dict()
    # the same state as the reference's wrapper over the same stream
    jsch = _schema("jax")
    jsrc = jax_sources.WatermarkedSource(
        jax_sources.ListSource("S", jsch, records, timestamps=ts, chunk=5),
        jax_sources.BoundedDisorderWatermark(250))
    jsrc.poll(5)
    assert d == jsrc.state_dict()
    src2 = WatermarkedSource(
        ListSource("S", schema, records, timestamps=ts, chunk=5),
        BoundedDisorderWatermark(250),
    )
    src2.load_state_dict(d)
    batch2, wm2, done2 = src2.poll(5)
    assert int(batch2.timestamps.min()) == ts[5]
    assert done2 and wm2 == MAX_WM
    assert with_watermarks(src2, skew_ms=3).strategy.skew_ms == 3
    with pytest.raises(ValueError):
        with_watermarks(src2)


def test_callback_and_replay_sources_match_the_reference():
    schema, jsch = _schema(), _schema("jax")
    got, want = [], []
    for srcs, sch, out in ((torch_sources, schema, got),
                           (jax_sources, jsch, want)):
        cb = srcs.CallbackSource("S", sch)
        cb.emit((1, 2.0, 10), 10)
        cb.advance_watermark(5)
        cb.emit((2, 3.0, 20), 20)
        b, wm, done = cb.poll(1)
        out.append((b.timestamps.tolist(), wm, done))
        cb.close()
        b, wm, done = cb.poll(8)
        out.append((b.timestamps.tolist(), wm, done))
        out.append(cb.poll(8)[1:])
        batches = [srcs.ListSource("S", sch, [(i, 1.0, i)], timestamps=[i])
                   .poll(4)[0] for i in range(3)]
        rep = srcs.ReplayBatchSource("S", sch, batches)
        out.append(rep.poll(4)[1:])
        d = rep.state_dict()
        rep2 = srcs.ReplayBatchSource("S", sch, batches)
        rep2.load_state_dict(d)
        out.append([rep2.poll(4)[1:] for _ in range(3)])
    assert got == want


# -- disorder: shuffled == sorted, both packages ----------------------------

_ORACLE_MEMO = {}


def _sorted_with_dups(records, ts, dup_log, dup_burst):
    dups = dup_log.tolist()
    allr = list(records) + [records[i] for i in dups for _ in range(dup_burst)]
    allt = list(ts) + [ts[i] for i in dups for _ in range(dup_burst)]
    order = np.argsort(np.asarray(allt), kind="stable")
    return [allr[i] for i in order], [allt[i] for i in order]


@pytest.mark.parametrize("mode", ["streaming", "fused", "resident"])
def test_disorder_rowexact_vs_sorted_oracle(mode):
    """The port fed the shuffled stream (watermarking at the disorder
    bound) emits what it emits over the sorted stream and what the JAX
    package emits over the same shuffled stream, in every mode."""
    records, ts = _stream(n=3000)
    sched = DisorderSchedule(seed=42, skew_ms=SKEW_MS, dup_rate=0.005,
                             dup_burst=2)
    job, src = _run_disordered(records, ts, sched, mode=mode)
    assert job.late_events == 0
    if "sorted" not in _ORACLE_MEMO:
        _ORACLE_MEMO["sorted"] = _results(_run_sorted(*_sorted_with_dups(
            records, ts, src.dup_log, sched.dup_burst)))
        ref, _ = _run_disordered(records, ts, _jax_schedule(sched),
                                 pkg="jax")
        _ORACLE_MEMO["jax"] = _results(ref)
    got = _results(job)
    for want in (_ORACLE_MEMO["sorted"], _ORACLE_MEMO["jax"]):
        assert got.keys() == want.keys()
        for sid in want:
            assert got[sid] == want[sid], (mode, sid)
    if mode == "streaming":
        snap = job.telemetry.snapshot()["histograms"]
        assert snap["watermark.lag"]["count"] > 0
        assert snap["gate.residency"]["count"] > 0


def test_disorder_rowexact_vs_baseline_interpreter():
    from flink_siddhi_tpu.baseline import BaselineEngine

    records, ts = _stream(n=3000)
    sched = DisorderSchedule(seed=7, skew_ms=SKEW_MS, dup_rate=0.005,
                             dup_burst=2)
    job, src = _run_disordered(records, ts, sched, cql=INTERP_CQL)
    eng = BaselineEngine(INTERP_CQL, ["id", "price", "timestamp"])
    rows = collections.defaultdict(list)
    eng._emit = lambda out, t, row: rows[out].append(_norm(t, row))
    allr, allt = _sorted_with_dups(records, ts, src.dup_log,
                                   sched.dup_burst)
    for (rid, price, t), at in zip(allr, allt):
        eng.process({"id": rid, "price": price, "timestamp": t}, at)
    got = _results(job)
    for sid in ("o_filter", "o_pat", "o_win"):
        assert got[sid] == sorted(rows[sid]), sid


@pytest.mark.parametrize("seed,skew_ms", [(1, 50), (2, 500)])
def test_disorder_rowexact_small_sweep(seed, skew_ms):
    """A smaller sweep of the reference's randomized one: shuffles and
    duplicates at two disorder bounds, streaming and fused, against the
    port's sorted run."""
    records, ts = _stream(n=2000, seed=seed)
    sched = DisorderSchedule(seed=seed * 31, skew_ms=skew_ms, dup_rate=0.01,
                             dup_burst=3)
    oracle = None
    for mode in ("streaming", "fused"):
        job, src = _run_disordered(records, ts, sched, mode=mode,
                                   strategy_skew=skew_ms)
        assert job.late_events == 0
        if oracle is None:
            oracle = _results(_run_sorted(*_sorted_with_dups(
                records, ts, src.dup_log, 3)))
        assert _results(job) == oracle, (seed, skew_ms, mode)


# -- the late policies ------------------------------------------------------

def _filter_oracle(records, ts, indices):
    return sorted((int(ts[i]), (records[i][0],
                                np.float32(records[i][1]).item()))
                  for i in indices if records[i][0] == 2)


def _late_schedule(seed=9):
    return DisorderSchedule(seed=seed, skew_ms=SKEW_MS, late_count=12,
                            late_release_ms=2_000)


def test_late_policy_drop_counts_exact():
    records, ts = _stream()
    sched = _late_schedule()
    job, src = _run_disordered(records, ts, sched, cql=FILTER_CQL,
                               late_policy="drop")
    assert src.injected["late"] == 12
    assert job.late_dropped == 12 == job.late_events
    counters = job.telemetry.snapshot()["counters"]
    assert counters["faults.late_dropped"] == 12
    late = set(src.late_log.tolist())
    keep = [i for i in range(len(records)) if i not in late]
    got = sorted(_norm(t, r) for t, r in job.results_with_ts("o"))
    assert got == _filter_oracle(records, ts, keep)
    ref, _ = _run_disordered(records, ts, _jax_schedule(sched),
                             cql=FILTER_CQL, pkg="jax", late_policy="drop")
    assert ref.late_dropped == job.late_dropped
    assert got == sorted(_norm(t, r) for t, r in ref.results_with_ts("o"))
    m = job.metrics()
    assert m["late_dropped"] == 12 and m["late_policy"] == "drop"


def test_late_policy_side_output_routes_full_rows():
    records, ts = _stream()
    sched = _late_schedule(seed=13)
    schema = _schema()
    src = DisorderSource(
        ListSource("S", schema, records, timestamps=ts, chunk=CHUNK),
        sched, chunk=CHUNK)
    job = _job("torch", FILTER_CQL, [with_watermarks(src, skew_ms=SKEW_MS)],
               schema, late_policy="side_output")
    col_rows, row_rows = [], []

    class _ColSink:
        def accept_columns(self, t, cols):
            for k in range(len(t)):
                col_rows.append((int(t[k]), tuple(
                    cols[n][k] for n in schema.field_names)))

    job.add_sink(late_stream("S"), _ColSink())
    job.add_sink(late_stream("S"),
                 lambda t, row: row_rows.append((int(t), row)))
    job.run()
    want = sorted((int(ts[i]), records[i]) for i in src.late_log.tolist())
    assert sorted(col_rows) == want
    assert sorted(row_rows) == want
    assert sorted(job.collected[late_stream("S")]) == want
    assert job.late_events == len(want) and job.late_dropped == 0
    counters = job.telemetry.snapshot()["counters"]
    assert counters["faults.late_side_output"] == len(want)
    late = set(src.late_log.tolist())
    keep = [i for i in range(len(records)) if i not in late]
    assert sorted(_norm(t, r) for t, r in job.results_with_ts("o")) \
        == _filter_oracle(records, ts, keep)
    ref, _ = _run_disordered(records, ts, _jax_schedule(sched),
                             cql=FILTER_CQL, pkg="jax",
                             late_policy="side_output")
    assert sorted(ref.collected[jax_executor.late_stream("S")]) == want


def test_late_side_output_columnar_only_keeps_no_rows():
    """With retention off and only a columnar sink on the late channel,
    the late rows reach it as columns and no row tuple is kept."""
    records, ts = _stream(n=3000)
    schema = _schema()
    src = DisorderSource(
        ListSource("S", schema, records, timestamps=ts, chunk=CHUNK),
        _late_schedule(seed=5), chunk=CHUNK)
    job = _job("torch", FILTER_CQL, [with_watermarks(src, skew_ms=SKEW_MS)],
               schema, late_policy="side_output", retain_results=False)
    seen = []

    class _ColSink:
        def accept_columns(self, t, cols):
            seen.extend(t.tolist())

    job.add_sink(late_stream("S"), _ColSink())
    job.run()
    assert sorted(seen) == sorted(ts[i] for i in src.late_log.tolist())
    assert late_stream("S") not in job.collected
    assert job.emitted_counts[late_stream("S")] == len(seen) == 12


def test_late_policy_allow_admits_within_allowance_in_order():
    records, ts = _stream()
    sched = _late_schedule(seed=17)
    job, src = _run_disordered(records, ts, sched, cql=FILTER_CQL,
                               late_policy="allow",
                               allowed_lateness_ms=15_000)
    assert src.injected["late"] == 12
    assert job.late_dropped == 0 and job.late_events == 0
    assert sorted(_norm(t, r) for t, r in job.results_with_ts("o")) \
        == _filter_oracle(records, ts, range(len(records)))


def test_late_policy_allow_beyond_allowance_drops_loudly(caplog):
    records, ts = _stream()
    sched = _late_schedule(seed=21)
    with caplog.at_level(logging.WARNING,
                         logger="flink_siddhi_tpu_torch.runtime.executor"):
        job, src = _run_disordered(records, ts, sched, cql=FILTER_CQL,
                                   late_policy="allow",
                                   allowed_lateness_ms=100)
    assert job.late_dropped == src.injected["late"] == 12
    assert any("re-fire" in r.message.lower() for r in caplog.records)
    ref, _ = _run_disordered(records, ts, _jax_schedule(sched),
                             cql=FILTER_CQL, pkg="jax", late_policy="allow",
                             allowed_lateness_ms=100)
    assert sorted(_norm(t, r) for t, r in job.results_with_ts("o")) \
        == sorted(_norm(t, r) for t, r in ref.results_with_ts("o"))


# -- idle sources -----------------------------------------------------------

def test_idle_source_stops_pinning_watermark_and_unidles():
    schema = _schema()
    records, ts = _stream(n=900, step_ms=10)
    quiet = CallbackSource("S", schema)
    flowing = ListSource("S", schema, records, timestamps=ts, chunk=CHUNK)
    job = _job("torch", FILTER_CQL, [flowing, quiet], schema,
               idle_timeout_ms=40.0)
    deadline = time.monotonic() + 10.0
    while not job.collected.get("o") and time.monotonic() < deadline:
        job.run_cycle()
        job.drain_outputs()
    assert job.collected.get("o"), "idle source still pins the gate"
    assert job.idle_source_ids() == ["S"]
    m = job.metrics()
    assert [s for s in m["sources"] if s["idle"]], m["sources"]
    assert job.telemetry.snapshot()["counters"]["idle.marked"] >= 1
    quiet.emit((2, 1.0, 999_999), timestamp_ms=999_999)
    job.run_cycle()
    assert job.idle_source_ids() == []
    assert job.telemetry.snapshot()["counters"]["idle.unidled"] == 1


def test_idle_source_keeps_polling_under_block_shed_policy():
    schema = _schema()
    records, ts = _stream(n=1200, step_ms=10)
    quiet = CallbackSource("S", schema)
    flowing = ListSource("S", schema, records, timestamps=ts, chunk=CHUNK)
    job = _job("torch", FILTER_CQL, [flowing, quiet], schema,
               idle_timeout_ms=0.0, max_pending_events=2 * CHUNK,
               shed_policy="block")
    deadline = time.monotonic() + 10.0
    while not job.collected.get("o") and time.monotonic() < deadline:
        job.run_cycle()
        job.drain_outputs()
    assert job.collected.get("o"), "block policy deadlocked the gate"
    quiet.advance_watermark(10**9)
    quiet.close()
    done_by = time.monotonic() + 10.0
    while not job.finished and time.monotonic() < done_by:
        job.run_cycle()
    assert job.finished
    assert sorted(_norm(t, r) for t, r in job.results_with_ts("o")) \
        == _filter_oracle(records, ts, range(len(records)))


def test_all_sources_idle_holds_the_watermark():
    """Idle means no information, not done: with every source idle the
    gate holds instead of releasing everything (the reference's rule)."""
    schema = _schema()
    quiet = CallbackSource("S", schema)
    job = _job("torch", FILTER_CQL, [quiet], schema, idle_timeout_ms=0.0)
    quiet.emit((2, 1.0, 100), 100)
    quiet.advance_watermark(50)
    job.run_cycle()
    assert job._gate_wm == 50 and job._pending_total() == 1
    job.run_cycle()  # empty poll: idle
    assert job.idle_source_ids() == ["S"]
    assert job._watermark() == 50
    assert job._pending_total() == 1


# -- a two-source join under disorder ---------------------------------------

JOIN_CQL = (
    "from T#window.length(4) as t join Q#window.length(3) as q "
    "on t.sym == q.sym select t.sym, t.price, q.bid insert into oj"
)


def _join_schemas(pkg="torch"):
    Schema = PKGS[pkg][0]
    return (Schema([("sym", "int"), ("price", "double")]),
            Schema([("sym", "int"), ("bid", "double")]))


def _join_streams(n=900, seed=3):
    rng = np.random.default_rng(seed)
    trades = [(int(s), float(p)) for s, p in
              zip(rng.integers(0, 4, n), rng.integers(1, 90, n))]
    quotes = [(int(s), float(b)) for s, b in
              zip(rng.integers(0, 4, n), rng.integers(1, 90, n))]
    t_ts = (1_001 + np.arange(n, dtype=np.int64) * 10).tolist()
    q_ts = (1_006 + np.arange(n, dtype=np.int64) * 10).tolist()
    return trades, t_ts, quotes, q_ts


def _run_join(pkg, disordered):
    _, compile_plan, Job, srcs, faults, _, kw = PKGS[pkg]
    ts_schema, qs_schema = _join_schemas(pkg)
    trades, t_ts, quotes, q_ts = _join_streams()
    t_src = srcs.ListSource("T", ts_schema, trades, timestamps=t_ts,
                            chunk=CHUNK)
    q_src = srcs.ListSource("Q", qs_schema, quotes, timestamps=q_ts,
                            chunk=CHUNK)
    if disordered:
        t_src = srcs.with_watermarks(faults.DisorderSource(
            t_src, faults.DisorderSchedule(seed=51, skew_ms=SKEW_MS),
            chunk=CHUNK), skew_ms=SKEW_MS)
        q_src = srcs.with_watermarks(faults.DisorderSource(
            q_src, faults.DisorderSchedule(seed=52, skew_ms=SKEW_MS),
            chunk=CHUNK), skew_ms=SKEW_MS)
    plan = compile_plan(JOIN_CQL, {"T": ts_schema, "Q": qs_schema})
    job = Job([plan], [t_src, q_src], batch_size=CHUNK, time_mode="event",
              **kw)
    job.run()
    return sorted(_norm(t, r) for t, r in job.results_with_ts("oj"))


def test_multi_source_join_under_disorder():
    want = _run_join("torch", disordered=False)
    assert want, "join oracle produced no rows"
    got = _run_join("torch", disordered=True)
    assert got == want
    assert got == _run_join("jax", disordered=True)


# -- checkpoints and supervised recovery ------------------------------------

def test_gate_watermark_state_survives_checkpoint_roundtrip(tmp_path):
    records, ts = _stream(n=1200)
    schema = _schema()

    def build():
        src = DisorderSource(
            ListSource("S", schema, records, timestamps=ts, chunk=CHUNK),
            DisorderSchedule(seed=2, skew_ms=SKEW_MS), chunk=CHUNK)
        return _job("torch", FILTER_CQL,
                    [with_watermarks(src, skew_ms=SKEW_MS)], schema)

    job = build()
    for _ in range(3):
        job.run_cycle()
    path = str(tmp_path / "ckpt")
    job.save_checkpoint(path)
    pre_rows = job.results_with_ts("o")
    restored = build()
    restored.restore(path)
    assert restored._released_wm == job._released_wm
    assert restored._gate_wm == job._gate_wm
    assert restored._source_wm == job._source_wm
    assert restored._max_event_ts == job._max_event_ts
    # the strategy's state rode the source's entry
    assert restored._sources[0].strategy.state_dict() \
        == job._sources[0].strategy.state_dict()
    while not restored.finished:
        restored.run_cycle()
    restored.flush()
    whole = build()
    whole.run()
    assert sorted(pre_rows + restored.results_with_ts("o")) \
        == sorted(whole.results_with_ts("o"))


def test_end_of_stream_horizon_is_never_max(tmp_path):
    """The end-of-stream sentinel releases everything but is never gate
    state: a checkpoint taken at the end of a stream restores into a job
    that goes on with more data, and none of it is late."""
    records, ts = _stream(n=600)
    schema = _schema()
    first = _job("torch", FILTER_CQL, [with_watermarks(ListSource(
        "S", schema, records[:300], timestamps=ts[:300], chunk=CHUNK),
        skew_ms=0)], schema)
    first.run()
    assert first._released_wm == ts[299] and first._gate_wm != MAX_WM
    snap = first.snapshot()
    assert snap["event_time"]["released_wm"] == ts[299]
    more = _job("torch", FILTER_CQL, [with_watermarks(ListSource(
        "S", schema, records, timestamps=ts, chunk=CHUNK), skew_ms=0)],
        schema)
    more.restore(snap)
    more.run()
    assert more.late_events == 0
    assert sorted(_norm(t, r) for t, r in first.results_with_ts("o")
                  + more.results_with_ts("o")) \
        == _filter_oracle(records, ts, range(600))


def test_supervised_kill_restore_exactly_once_under_disorder(tmp_path):
    """Watermark state survives supervised kill and restore (one kill
    mid-checkpoint) with 0 duplicate and 0 lost rows against the unfaulted
    run, and the late account stays exact across the restarts."""
    records, ts = _stream(n=3000)
    schema = _schema()
    sched = DisorderSchedule(seed=29, skew_ms=SKEW_MS, dup_rate=0.005,
                             dup_burst=2, late_count=8,
                             late_release_ms=2_000)
    crash = CrashPlan(at_pulls=(3, 9), at_checkpoints=(2,))

    def factory(armed=True):
        src = DisorderSource(
            ListSource("S", schema, records, timestamps=ts, chunk=CHUNK),
            sched, chunk=CHUNK)
        job = _job("torch", FILTER_CQL,
                   [with_watermarks(src, skew_ms=SKEW_MS)], schema,
                   retain_results=False, late_policy="drop")
        return wrap_job(job, crash) if armed else job

    ckpt = str(tmp_path / "ckpt")
    sup = Supervisor(factory, ckpt, checkpoint_every_cycles=2,
                     keep_checkpoints=3, max_restarts=10,
                     restart_window_s=3600.0)
    final_job = sup.run()
    assert crash.crashes == 3
    oracle_job = factory(armed=False)
    rows = []
    oracle_job.add_sink("o", lambda t, row: rows.append((t, row)))
    oracle_job.run()
    committed = collections.Counter(sup.results_with_ts("o"))
    oracle = collections.Counter(rows)
    assert sum((committed - oracle).values()) == 0, "duplicate rows"
    assert sum((oracle - committed).values()) == 0, "lost rows"
    assert final_job.late_dropped == sched.late_count
    assert glob.glob(f"{ckpt}.tmp.*") == []
    h = sup.health()
    assert h["alive"] and h["finished"] and h["restarts"] == 3
    assert h["late_dropped"] == sched.late_count
    assert sup.last_recovery_ms is not None
