"""The fused streaming ``Job`` of the torch port against the JAX package's.

With ``fused_segment_len`` K > 1 the port's ``Job`` stages K micro-batch
tapes, stacks them into one segment buffer and advances the plan over the
segment in one dispatch (a CUDA graph replay on a GPU; here, on the CPU,
the same segment body runs its steps in turn), as the reference's
``_stage_fused``/``_dispatch_segment`` do with one ``lax.scan`` call.
These tests mirror the reference's ``tests/test_fused_stream.py``:

- rows, stream by stream, equal to the port's per-batch ``Job`` and to the
  JAX package's fused ``Job`` on the same seeded stream, for the bench's
  five configs under its settings, at K = 4 and K = 8 (10 micro-batches:
  both end on a partial segment padded with empty tapes);
- a trailing partial segment padded with empty tapes is row-inert;
- a structural break (the id's wire width widened mid-stream) dispatches
  the shorter segment first, with the same rows;
- the effective K is clamped by the drain hint; flush and drain dispatch
  staged tapes; the ``fusion_*`` counters add up; the in-flight window
  drops finished segments and waits for the oldest past its limit.

Streams are the bench's (``bench.make_batches``: seed 7, ids uniform, 1 ms
cadence), 10 micro-batches of 4,096 events, so the chain matcher's
relevance compaction is on. Rows are compared exactly, except
window_groupby's float sums against the JAX package, held to a float64
oracle as ``tests/test_torch_replay.py`` does (the two packages add them in
another order); the port's fused and per-batch rows are equal exactly.
"""

import collections

import numpy as np
import pytest
import torch

import bench
from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt

from torch_windows_common import assert_rows, last, stats, window_oracle

torch.set_num_threads(2)

BATCH = 4096
N_BATCHES = 10
CONFIGS = ("filter", "headline", "multiquery64", "pattern2",
           "window_groupby")
BENCH = dict(lazy_projection=True, pred_pushdown=True)
_FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
           ("timestamp", "long")]
_PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, JaxConfig,
            {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
              fpt.compile_plan, fpt.Job, fpt.EngineConfig,
              {"device": "cpu"}),
}


def _columns(n_ids, n_batches=N_BATCHES, wide_from=None):
    """The bench's stream (``bench.make_batches``'s numbers) as columns per
    micro-batch; from batch ``wide_from`` on, every id is raised by 200,
    so that the id's wire width widens from int8 to int16."""
    rng = np.random.default_rng(7)
    out = []
    for b in range(n_batches):
        start = b * BATCH
        ids = rng.integers(0, n_ids, size=BATCH).astype(np.int32)
        if wide_from is not None and b >= wide_from:
            ids = ids + 200
        out.append({
            "id": ids,
            "price": rng.random(BATCH, dtype=np.float64) * 100.0,
            "ts": 1000 + start + np.arange(BATCH, dtype=np.int64),
        })
    return out


def _job(pkg, cql, data, seg, config=BENCH, retain=True):
    Schema, Batch, Source, compile_plan, Job, Config, kw = _PKGS[pkg]
    schema = Schema(_FIELDS)
    code = schema.string_tables["name"].intern("test_event")
    batches = [
        Batch("inputStream", schema,
              {"id": d["id"], "name": np.full(len(d["id"]), code, np.int32),
               "price": d["price"], "timestamp": d["ts"]}, d["ts"])
        for d in data
    ]
    plan = compile_plan(cql, {"inputStream": schema}, plan_id="p",
                        config=Config(**config))
    job = Job([plan], [Source("inputStream", schema, iter(batches))],
              batch_size=BATCH, time_mode="processing",
              retain_results=retain, **kw)
    job.fused_segment_len = seg
    # no staleness dispatch of a partial segment: the counts below are
    # those of full segments
    job.drain_interval_ms = 1e9
    return job


def _rows(job):
    return {sid: job.results_with_ts(sid) for sid in sorted(job.collected)}


def _run(pkg, cql, data, seg, **kw):
    job = _job(pkg, cql, data, seg, **kw)
    job.run()
    return _rows(job), job


def _assert_like_jax(config, got, ref, data):
    assert got.keys() == ref.keys() and sum(map(len, ref.values())) >= 100
    if config != "window_groupby":
        assert got == ref
        return
    f = {k: np.concatenate([d[k] for d in data]) for k in ("id", "price")}
    oracle = window_oracle(f, np.ones(len(f["id"]), bool), last(1000),
                           stats(f, "price")[0])
    assert_rows(got["matches"], ref["matches"], {1: oracle})


@pytest.mark.parametrize("seg", [4, 8])
@pytest.mark.parametrize("config", CONFIGS)
def test_fused_matches_per_batch_and_jax_fused_rowexact(config, seg):
    cql = bench._config_cql(config)
    data = _columns(1000 if config == "window_groupby" else 50)
    ref, _ = _run("jax", cql, data, seg)
    per_batch, _ = _run("torch", cql, data, None)
    got, job = _run("torch", cql, data, seg)
    assert got == per_batch
    _assert_like_jax(config, got, ref, data)
    k = job._fused_k(job._plans["p"])
    assert job.fusion_batches == N_BATCHES
    assert job.fusion_dispatches == -(-N_BATCHES // k)
    assert N_BATCHES % k  # a partial trailing segment, padded
    # under the bench's settings every segment could be captured
    assert job.eager_segments == 0
    assert job.host_syncs == job.drain_waits
    assert job.fetch_syncs == job.drain_fetches > 0


def test_padded_partial_segment_is_row_inert():
    # one partial segment of 3 tapes padded to K = 8 with empty tapes:
    # the rows and the final states equal the per-batch job's
    cql = bench._config_cql("headline")
    data = _columns(50, n_batches=3)
    base = _job("torch", cql, data, None)
    base.run()
    job = _job("torch", cql, data, 8)
    job.run()
    assert _rows(job) == _rows(base) and _rows(base)["matches"]
    assert (job.fusion_batches, job.fusion_dispatches) == (3, 1)
    for (k, a), (_, b) in zip(
        sorted(_flat(job._plans["p"].states)),
        sorted(_flat(base._plans["p"].states)),
    ):
        assert torch.equal(a, b), k


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, f"{path}.{k}")]
    return [(path, tree)]


def test_structural_break_dispatches_the_shorter_segment_first():
    # ids past 127 from batch 6 on: the id travels as int8, then int16,
    # so batches 0-5 and 6-9 have different wire structures. The stack
    # ships its id column (no pushdown), and its literals match ids 200+
    cql = "; ".join(
        f"from every s1 = inputStream[id == {a}] -> "
        f"s2 = inputStream[id == {b}] "
        f"select s1.timestamp as t1, s2.timestamp as t2 insert into m{q}"
        for q, (a, b) in enumerate(
            [(q % 50 + 200 * (q % 2), (q * 7 + 1) % 50 + 200 * (q % 2))
             for q in range(64)]
        )
    )
    data = _columns(50, wide_from=6)
    ref, _ = _run("jax", cql, data, 4)
    per_batch, _ = _run("torch", cql, data, None)
    got, job = _run("torch", cql, data, 4)
    assert got == per_batch == ref
    assert sum(map(len, ref.values())) >= 1000
    rt = job._plans["p"]
    assert dict(rt.wire_kinds)["inputStream.id"] == "i16"
    # 6 tapes of int8 ids: 4 + 2 (cut short by the break); 4 of int16: 4
    assert job.fusion_batches == 10
    assert job.fusion_dispatches == 3
    assert job.eager_segments == 0


@pytest.mark.parametrize("config", ["headline", "window_groupby"])
def test_fused_k_is_clamped_by_the_drain_hint(config):
    # the hint: steps whose widest emission blocks fit the accumulator
    # twice over (a window that emits a row per event allows fewer)
    cql = bench._config_cql(config)
    job = _job("torch", cql, _columns(50, n_batches=2), None)
    job.run()
    rt = job._plans["p"]
    hint = job._drain_hints["p"]
    assert 1 < hint < 10_000
    job.fused_segment_len = 10_000
    assert job._fused_k(rt) == hint
    job.fused_segment_len = 2
    assert job._fused_k(rt) == 2
    job.fused_segment_len = None
    assert job._fused_k(rt) == 1


@pytest.mark.parametrize("how", ["drain", "flush", "results"])
def test_drain_and_flush_dispatch_staged_tapes(how):
    cql = bench._config_cql("pattern2")
    data = _columns(50, n_batches=3)
    base, _ = _run("torch", cql, data, None)
    job = _job("torch", cql, data, 8)
    for _ in range(3):
        job.run_cycle()
    rt = job._plans["p"]
    assert len(rt.seg_pending) == 3 and job.fusion_dispatches == 0
    if how == "drain":
        job.drain_outputs()
    elif how == "flush":
        job.flush()
    assert job.results_with_ts("matches") == base["matches"]
    assert job.fusion_dispatches == 1 and not rt.seg_pending


def test_fusion_counters_add_up():
    cql = bench._config_cql("filter")
    data = _columns(50, n_batches=7)
    job = _job("torch", cql, data, 3)
    job.run()
    assert job.fusion_batches == 7
    assert job.fusion_dispatches == 3  # 3 + 3 + 1 (padded)
    # the CPU path stacks in host memory: no upload
    assert job.fusion_h2d_uploads == 0
    assert job._plans["p"].seg_pending == []


class _Ticket:
    """A stand-in for a CUDA event: done once ``clock`` passes ``at``;
    ``synchronize`` advances the clock to it."""

    def __init__(self, clock, at):
        self.clock, self.at = clock, at

    def query(self):
        return self.clock[0] >= self.at

    def synchronize(self):
        self.clock[0] = max(self.clock[0], self.at)


def test_inflight_window_retires_done_tickets_and_waits_past_the_limit():
    from flink_siddhi_tpu_torch.runtime.executor import retire_tickets

    clock = [0]
    tickets = collections.deque(_Ticket(clock, at) for at in (1, 2, 3, 4))
    retire_tickets(tickets, 6)  # within the window, none done: no wait
    assert [t.at for t in tickets] == [1, 2, 3, 4] and clock == [0]
    clock[0] = 2
    retire_tickets(tickets, 6)  # the done ones leave from the front
    assert [t.at for t in tickets] == [3, 4] and clock == [2]
    tickets.extend(_Ticket(clock, at) for at in (5, 6, 7))
    retire_tickets(tickets, 2)  # past the limit: wait for the oldest
    assert [t.at for t in tickets] == [6, 7] and clock == [5]


def test_default_settings_headline_counts_its_eager_segments():
    # without pushdown the headline's host-known bound counts every event
    # (above the compact width), so each tape's chain matcher reads its
    # count: no segment can be captured, and each is counted
    cql = bench._config_cql("headline")
    data = _columns(50)
    ref, _ = _run("jax", cql, data, 4, config={})
    got, job = _run("torch", cql, data, 4, config={})
    assert got == ref
    assert job.eager_segments == job.fusion_dispatches == 3
    assert job.host_syncs == job.drain_waits + N_BATCHES
    assert job.fetch_syncs == job.drain_fetches > 0
