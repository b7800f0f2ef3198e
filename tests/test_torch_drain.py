"""The asynchronous drain of the torch port, on the CPU.

A drain swaps the live accumulator for a free position of the plan's
accumulator ring and queues the old one; the job's fetch thread copies its
counts, then (only when a consumer wants rows and any were emitted) the
used columns at a bucketed width, and decodes; the run loop completes
drains in order and emits (``runtime/executor.py``). On the CPU every
drain is ready at once and the same code runs. Here:

- rows, stream by stream and in order, equal to the JAX package's ``Job``
  and to the port's synchronous drain (``drain_outputs()`` after every
  cycle; in resident mode a waiting drain after every segment), for the
  bench's five configs and the plan zoo's ``chain_pattern``,
  ``length_window_agg`` and ``expired_events``, streaming, fused and
  resident (exact, except float window sums: ``assert_rows``);
- the queue bound: queueing ``MAX_PENDING_DRAINS`` + 1 drains completes
  exactly one on the run loop;
- the fetch phases: an empty drain fetches no data, and a drain's data
  width is ``bucket_size(max_n, 64)`` capped at ``acc_capacity()``; no
  decoded payload is a view of the fetched buffer (which the fetch thread
  reuses);
- counts-only drains keep ``emitted_counts`` equal to the JAX Job's;
- interval drains go stalest first, at most two in flight per plan;
- the lazy ring: lookups from a second thread agree with the run loop's
  under concurrent pushes;
- the drain queue is empty whenever a graph capture would start;
- the columnar sink lane (from ``tests/test_output_columnar.py``): a
  columnar sink sees the data a row sink sees, and the same column
  batches as under the JAX package; the lane needs every consumer
  columnar; the staleness histogram of the deadline drains, also under
  fused dispatch (from ``tests/test_fused_stream.py``).
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

import bench
from flink_siddhi_tpu.analysis.zoo import PLAN_ZOO
from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler.output import ColumnBatch
from flink_siddhi_tpu_torch.runtime.executor import _LazyRing
from flink_siddhi_tpu_torch.runtime.tape import bucket_size

import torch_windows_common as wc
from test_torch_fused import CONFIGS, _assert_like_jax, _columns, _job

torch.set_num_threads(2)

ZOO = ("chain_pattern", "length_window_agg", "expired_events")
ZOO_BATCH = 2048
MODES = ("streaming", "fused", "resident")


def _zoo_data():
    return wc.stream(4 * ZOO_BATCH, ZOO_BATCH, n_ids=5)


def _make(pkg, name):
    """A fresh Job of a bench config or a zoo plan, rows kept."""
    if name in CONFIGS:
        data = _columns(1000 if name == "window_groupby" else 50)
        job = _job(pkg, bench._config_cql(name), data, None)
        job.drain_interval_ms = 500.0
        return job
    return wc.job(pkg, PLAN_ZOO[name], _zoo_data(), ZOO_BATCH)


@functools.lru_cache(maxsize=None)
def _jax_rows(name):
    job = _make("jax", name)
    job.run()
    return {sid: job.results_with_ts(sid) for sid in sorted(job.collected)}


def _port_rows(name, mode, sync):
    """The port's rows of ``name`` in ``mode``: with ``sync`` a waiting
    drain after every cycle (resident: after every segment); without, the
    drains the job schedules itself, started without a wait."""
    job = _make("torch", name)
    if mode == "resident":
        rep = fpt.ResidentReplay(job)
        rep.stage()
        if sync:
            for pid, segs in rep.segments.items():
                for i in range(len(segs)):
                    rep.run_segment(pid, i)
                    job._drain_plan(job._plans[pid])
        else:
            rep.run()
        job.flush()
    else:
        if mode == "fused":
            job.fused_segment_len = 4
            job.drain_interval_ms = 1e9  # no short segments
        else:
            job.drain_interval_ms = 0.0  # an interval drain every cycle
        job.drain_every_cycles = 2  # and a capacity swap every two
        while not job.finished:
            job.run_cycle()
            if sync:
                job.drain_outputs()
        job.flush()
    rows = {sid: job.results_with_ts(sid) for sid in sorted(job.collected)}
    return rows, job


def _assert_like_reference(name, got, ref):
    if name in CONFIGS:
        data = _columns(1000 if name == "window_groupby" else 50)
        _assert_like_jax(name, got, ref, data)
        return
    assert got.keys() == ref.keys() == {"out"}
    oracle = None
    if name == "length_window_agg":
        f = wc.flat(_zoo_data())
        oracle = {0: wc.window_oracle(f, np.ones(len(f["id"]), bool),
                                      wc.last(16), wc.stats(f, "price")[0],
                                      group=False)}
    wc.assert_rows(got["out"], ref["out"], oracle, min_rows=100)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CONFIGS + ZOO)
def test_async_drain_rows_equal_jax_and_synchronous_drain(name, mode):
    got, job = _port_rows(name, mode, sync=False)
    sync, _ = _port_rows(name, mode, sync=True)
    assert got == sync
    _assert_like_reference(name, got, _jax_rows(name))
    done = job.telemetry.counter_value("drains.completed")
    # a resident run drains once a segment (one here, bar windows)
    assert done >= (1 if mode == "resident" else 2)
    assert not any(rt.drain_q for rt in job._plans.values())
    assert job.fetch_syncs == job.drain_fetches >= done


class _Gate:
    """Holds the fetch thread at the start of every fetch until opened."""

    def __init__(self, job):
        self.open = threading.Event()
        inner = job._fetch_acc

        def gated(*a):
            self.open.wait(30)
            return inner(*a)

        job._fetch_acc = gated


def _filter_job(n_batches=10, data=None):
    data = _columns(50, n_batches) if data is None else data
    job = _job("torch", bench._config_cql("filter"), data, None)
    job.drain_interval_ms = None
    job.drain_every_cycles = 10 ** 9
    return job, job._plans["p"]


def test_queue_bound_completes_exactly_one():
    job, rt = _filter_job()
    gate = _Gate(job)
    forced = job._force_oldest

    def force(rt_):
        gate.open.set()  # the oldest may now finish
        forced(rt_)

    job._force_oldest = force
    for i in range(job.MAX_PENDING_DRAINS + 1):
        job.run_cycle()
        job._drain_request(rt)
        assert job.drains_forced == (i == job.MAX_PENDING_DRAINS)
    assert len(rt.drain_q) == job.MAX_PENDING_DRAINS
    assert len(rt.ring) == job.MAX_PENDING_DRAINS + 1
    job._settle_drains()  # else the next request may find no free position
    job.run()
    ref, _ = _port_rows("filter", "streaming", sync=True)
    assert {"matches": job.results_with_ts("matches")} == ref
    assert job.drains_forced == 1


def _record_widths(job):
    widths = []
    view = job._host_view
    job._host_view = lambda rt_, w: widths.append(w) or view(rt_, w)
    return widths


def test_fetch_phases_and_widths():
    # an empty drain: a batch with no id 2 fetches its counts only
    data = _columns(50, 3)
    data[0]["id"][:] = 0
    job, rt = _filter_job(data=data)
    widths = _record_widths(job)
    job.run_cycle()
    job.drain_outputs()
    assert job.drain_fetches == 1 and widths == []
    assert job.results("matches") == []
    job.run_cycle()
    job.drain_outputs()
    n = len(job.collected["matches"])
    assert job.drain_fetches == 3 and n > 0
    assert widths == [bucket_size(n, fpt.Job.MIN_FETCH_WIDTH)]
    # the width is capped at the accumulator's capacity (not a power of
    # two here): 69,632 matches in one drain, 70,000 columns
    rows = 4  # ts + id, name, price
    cfg = dict(acc_budget_bytes=rows * 4 * 70_000)
    m = 17 * 4096
    schema = fpt.StreamSchema(wc.FIELDS[:3] + [("timestamp", "long")])
    cols = {"id": np.full(m, 2, np.int32),
            "name": np.zeros(m, np.int32),
            "price": np.arange(m, dtype=np.float64),
            "timestamp": 1000 + np.arange(m, dtype=np.int64)}
    plan = fpt.compile_plan(bench._config_cql("filter"),
                            {"inputStream": schema}, plan_id="p",
                            config=fpt.EngineConfig(**cfg))
    assert plan.acc_capacity() == 70_000
    big = fpt.Job([plan], [fpt.BatchSource("inputStream", schema, iter(
        [fpt.EventBatch("inputStream", schema, cols, cols["timestamp"])]))],
        batch_size=m, time_mode="processing", device="cpu")
    widths = _record_widths(big)
    big.run()
    assert widths == [70_000] and len(big.results("matches")) == m


@pytest.mark.parametrize("name", ["filter", "headline", "window_groupby"])
def test_decoded_payloads_copy_out_of_the_fetched_block(name):
    # the fetch thread reuses its host buffer: no payload may view it
    job = _make("torch", name)
    job.drain_interval_ms, job.drain_every_cycles = None, 10 ** 9
    rt = job._plans["p"]
    while not job.finished:
        job.run_cycle()
    job._dispatch_segment(rt)
    counts = rt.acc["meta"][0].numpy().copy()
    n = int(counts.max())
    block = rt.acc["buf"][:, :n].numpy()
    streams = frozenset(rt.plan.output_streams())
    for columnar in (frozenset(), streams):
        dec = rt.plan.drain_decode(
            counts, block, lookup=rt.lazy.lookup if rt.lazy else None,
            columnar_streams=columnar,
            lookup_np=rt.lazy.lookup_np if rt.lazy else None)
        arrays = [a for payloads in dec.values() for _, p in payloads
                  for a in ([p.ts, *p.cols.values()]
                            if isinstance(p, ColumnBatch) else [])]
        assert sum(len(p) for ps in dec.values() for _, p in ps) > 0
        assert not any(np.shares_memory(a, block) for a in arrays)
        assert bool(columnar) == bool(arrays)


@pytest.mark.parametrize("config", ["headline", "multiquery64",
                                    "window_groupby"])
def test_counts_only_drains_keep_emitted_counts(config):
    data = _columns(1000 if config == "window_groupby" else 50)
    cql = bench._config_cql(config)
    ref = _job("jax", cql, data, None, retain=False)
    ref.run()
    got = _job("torch", cql, data, None, retain=False)
    got.drain_every_cycles = 2
    got.run()
    assert got.emitted_counts == ref.emitted_counts
    assert sum(got.emitted_counts.values()) > 0
    done = got.telemetry.counter_value("drains.completed")
    # counts only: one fetch a drain, no data, no decode
    assert got.fetch_syncs == got.drain_fetches == done >= 5
    assert got._plans["p"].host_buf is None


def test_interval_drains_stalest_first_two_in_flight():
    schema = fpt.StreamSchema(wc.FIELDS)
    plans = [fpt.compile_plan(f"from S[id == {i}] select id insert into o{i}",
                              {"S": schema}, plan_id=f"p{i}")
             for i in range(3)]
    job = fpt.Job(plans, [fpt.BatchSource("S", schema, iter([]))],
                  device="cpu")
    gate = _Gate(job)
    job.drain_interval_ms = 10.0
    order = []
    request = job._drain_request
    job._drain_request = lambda rt: order.append(rt.plan.plan_id) or \
        request(rt)
    now = time.monotonic()
    for rounds in range(3):
        for i, age in enumerate((3.0, 1.0, 2.0)):
            rt = job._plans[f"p{i}"]
            rt.acc_dirty, rt.dirty_since = True, now - age
        job._interval_drain()
    # stalest first, twice; a third drain of a plan waits for one of two
    assert order == ["p0", "p2", "p1"] * 2
    assert [len(rt.drain_q) for rt in job._plans.values()] == [2, 2, 2]
    gate.open.set()
    job._settle_drains()
    assert job.drain_fetches == 6 and job.drains_forced == 0


def test_lazy_ring_lookups_from_another_thread_under_pushes():
    ring = _LazyRing(budget_bytes=64 * 8 * 4)  # four entries of 64
    stop = threading.Event()
    bad = []

    def fetch_side():
        rng = np.random.default_rng(3)
        while not stop.is_set():
            hi = max(ring.starts[-1] + 64 if ring.starts else 0, 1)
            ords = rng.integers(max(0, hi - 512), hi, 200)
            for vals in (ring.lookup("k", ords),
                         ring.lookup_np("k", ords).tolist()):
                for o, v in zip(ords.tolist(), vals):
                    if v is not None and v != 3 * o:
                        bad.append((o, v))

    t = threading.Thread(target=fetch_side)
    t.start()
    for start in range(0, 64 * 3000, 64):
        ring.push(start, {"k": 3 * np.arange(start, start + 64,
                                             dtype=np.int64)})
    stop.set()
    t.join()
    assert not bad
    # what is left agrees between the two threads' resolvers
    live = np.arange(ring.starts[0], ring.starts[-1] + 64)
    assert ring.lookup("k", live) == (3 * live).tolist()
    assert ring.lookup_np("k", live).tolist() == (3 * live).tolist()


def test_drain_queue_is_empty_whenever_a_capture_would_start():
    # a wire width widens mid-stream: a new graph key (a capture on a GPU)
    # while drains are queued; the fetch thread is held back until the
    # settle before it (default settings: the id travels on the wire)
    cql = bench._config_cql("filter")
    data = _columns(50, wide_from=5)
    job = _job("torch", cql, data, 2, config={})
    job.drain_every_cycles = 2
    gate = _Gate(job)
    seen = []
    settle = job._settle_drains

    def settle_then_look():
        before = sum(len(rt.drain_q) for rt in job._plans.values())
        gate.open.set()
        settle()
        seen.append((before, [len(rt.drain_q) for rt in
                              job._plans.values()]))
        gate.open.clear()

    job._settle_drains = settle_then_look
    while not job.finished:
        job.run_cycle()
    gate.open.set()
    job.flush()
    assert len(seen) >= 2 and max(before for before, _ in seen) > 0
    assert all(after == [0] for _, after in seen)
    per_batch = _job("torch", cql, data, None, config={})
    per_batch.run()
    assert job.results_with_ts("matches") == \
        per_batch.results_with_ts("matches")


# -- the columnar sink lane (tests/test_output_columnar.py) ------------------

def _schema(pkg):
    Schema = fpt.StreamSchema if pkg == "torch" else JaxSchema
    return Schema([("id", "int"), ("name", "string"), ("price", "double")])


def _make_batches(pkg, schema, n=4000, chunk=1000, n_ids=5, seed=0):
    Batch = fpt.EventBatch if pkg == "torch" else JaxBatch
    name_code = schema.string_tables["name"].intern("ev")
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_ids, n).astype(np.int32)
    prices = rng.random(n)
    ts = np.arange(n, dtype=np.int64) + 1_000
    return [Batch("s", schema, {"id": ids[i:i + chunk],
                                "name": np.full(len(ids[i:i + chunk]),
                                                name_code, np.int32),
                                "price": prices[i:i + chunk]},
                  ts[i:i + chunk])
            for i in range(0, n, chunk)]


class _Recorder(fpt.ColumnarSink):
    """Records whatever lane delivers, normalized to (ts, row) pairs, and
    the column batches themselves."""

    def __init__(self, names):
        self.names = names
        self.rows = []
        self.batches = []

    def accept_columns(self, ts, cols):
        self.batches.append((ts.copy(), {k: v.copy()
                                         for k, v in cols.items()}))
        lists = [cols[n].tolist() for n in self.names]
        for t, *vals in zip(ts.tolist(), *lists):
            self.rows.append((int(t), tuple(vals)))


CASES = {
    "aligned_select": (
        "from s[id == 2] select id, name, price insert into out", {}),
    "buffered_pattern": (
        "from every e1 = s[id == 1] -> e2 = s[id == 2] "
        "select e1.price as p1, e2.price as p2 insert into out", {}),
    "packed_lazy": (
        "from s[id == 2] select id, name, price insert into out",
        dict(lazy_projection=True, pred_pushdown=True)),
}


def _columnar_run(pkg, case, columnar_only, retain=False):
    cql, cfg = CASES[case]
    schema = _schema(pkg)
    if pkg == "torch":
        plan = fpt.compile_plan(cql, {"s": schema},
                                config=fpt.EngineConfig(**cfg))
        job = fpt.Job([plan], [fpt.BatchSource(
            "s", schema, iter(_make_batches(pkg, schema)))],
            batch_size=1000, retain_results=retain, device="cpu")
    else:
        plan = jax_compile(cql, {"s": schema}, config=JaxConfig(**cfg))
        job = JaxJob([plan], [JaxSource(
            "s", schema, iter(_make_batches(pkg, schema)))],
            batch_size=1000, retain_results=retain)
    names = plan.output_streams()["out"][0].field_names
    col_sink = _Recorder(names)
    row_rows = []
    job.add_sink("out", col_sink)
    if not columnar_only:
        job.add_sink("out", lambda ts, row: row_rows.append((ts, tuple(row))))
    job.run()
    return col_sink, row_rows, job


def _concat(batches):
    ts = np.concatenate([t for t, _ in batches])
    return ts, {k: np.concatenate([c[k] for _, c in batches])
                for k in batches[0][1]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_columnar_and_row_sinks_observe_identical_data(case):
    # fast lane: columnar-only consumers, no row tuple in the engine
    col_fast, _, job = _columnar_run("torch", case, columnar_only=True)
    rt = job._plans["plan"]
    assert job._columnar_streams(rt) == {"out"}
    # mixed consumers: the stream decodes row-wise; the columnar sink gets
    # the converted batches, the row sink the tuples
    col_mixed, row_rows, _ = _columnar_run("torch", case, False)
    assert col_fast.rows, case
    assert col_fast.rows == col_mixed.rows == row_rows, case
    # the same column batches, values and dtypes, as the JAX package's
    ref, _, _ = _columnar_run("jax", case, columnar_only=True)
    got_ts, got = _concat(col_fast.batches)
    ref_ts, want = _concat(ref.batches)
    assert np.array_equal(got_ts, ref_ts) and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_columnar_lane_requires_all_columnar_consumers():
    schema = _schema("torch")
    plan = fpt.compile_plan("from s[id == 2] select id, price insert into out",
                            {"s": schema})
    job = fpt.Job([plan], [fpt.BatchSource(
        "s", schema, iter(_make_batches("torch", schema)))],
        batch_size=1000, retain_results=True, device="cpu")
    sink = _Recorder(["id", "price"])
    job.add_sink("out", sink)
    rt = next(iter(job._plans.values()))
    assert job._columnar_streams(rt) == frozenset()
    job.run()
    # the columnar sink still observed every row via the fallback
    assert sink.rows == [(ts, row) for ts, row in job.collected["out"]]
    # retention off, a row sink beside it: still the row path
    job2 = fpt.Job([plan], [], retain_results=False, device="cpu")
    job2.add_sink("out", _Recorder(["id", "price"]))
    rt2 = next(iter(job2._plans.values()))
    assert job2._columnar_streams(rt2) == {"out"}
    job2.add_sink("out", lambda ts, row: None)
    assert job2._columnar_streams(rt2) == frozenset()


def test_tail_scheduler_records_staleness_and_deadline_drains():
    schema = _schema("torch")
    plan = fpt.compile_plan("from s[id == 2] select id, price insert into out",
                            {"s": schema})
    job = fpt.Job([plan], [fpt.BatchSource(
        "s", schema, iter(_make_batches("torch", schema)))],
        batch_size=1000, retain_results=False, device="cpu")
    job.drain_interval_ms = 20.0
    sink = _Recorder(["id", "price"])
    job.add_sink("out", sink)
    while not job.finished:
        job.run_cycle()
        time.sleep(0.005)  # give deadlines a chance to arrive
    job.flush()
    h = job.telemetry.histogram("drain.staleness")
    assert h.count > 0
    assert h.percentile_ms(99) < 10 * (20.0 + 1000.0)
    assert sink.rows
    for leg in ("wait_ready", "queue", "fetch", "fetch_meta", "decode",
                "emit_lag", "total", "transport"):
        assert job.telemetry.histogram(f"drain.{leg}").count == \
            job.telemetry.counter_value("drains.completed") > 0, leg


def test_drain_staleness_bounded_under_fused_dispatch():
    cql = bench._config_cql("window_groupby")
    schema = fpt.StreamSchema([("id", "int"), ("name", "string"),
                               ("price", "double"), ("timestamp", "long")])
    rng = np.random.default_rng(7)
    code = schema.string_tables["name"].intern("test_event")
    batches = []
    for start in range(0, 40_000, 2048):
        m = min(2048, 40_000 - start)
        cols = {"id": rng.integers(0, 1000, m).astype(np.int32),
                "name": np.full(m, code, np.int32),
                "price": rng.random(m) * 100.0,
                "timestamp": 1000 + start + np.arange(m, dtype=np.int64)}
        batches.append(fpt.EventBatch("inputStream", schema, cols,
                                      cols["timestamp"]))
    job = fpt.Job([fpt.compile_plan(cql, {"inputStream": schema})],
                  [fpt.BatchSource("inputStream", schema, iter(batches))],
                  batch_size=2048, time_mode="processing", device="cpu")
    job.fused_segment_len = 16
    job.drain_interval_ms = 25.0
    job.run()
    h = job.telemetry.histogram("drain.staleness")
    assert h.count > 0, "staleness stopped recording under fused mode"
    assert h.percentile_ms(99) < 10_000.0, h.percentile_ms(99)
    counters = job.telemetry.snapshot()["counters"]
    assert counters.get("fusion.dispatches", 0) >= 1
