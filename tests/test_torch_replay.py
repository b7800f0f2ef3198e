"""The bench's main path as the bench runs it, in the torch port against
the JAX package: ``EngineConfig(lazy_projection=True, pred_pushdown=True)``
(narrow wire tapes with predicate bits pushed to the host, projection-only
columns resolved through the host's lazy ring), driven by the streaming
``Job`` and by ``ResidentReplay``.

Inputs: the bench's headline, filter, pattern2 and window_groupby queries
and the zoo's chain_pattern, chain_pattern_within and pattern_absence
plans, over the bench's stream shape (numpy, seeded) at 65,536 events and
batch 8,192, so the chain matcher's relevance compaction is on (E >=
4,096); window_groupby draws 1,000 ids, as bench.py does for it. Rows are
compared exactly, timestamps and order included: pushed predicates run in
float64 on the host in both packages, and lazy values come from the same
host columns. window_groupby's float sums are held within rtol 1e-5, or
to a float64 oracle (``tests/torch_windows_common.py:assert_rows``): the
two packages add them in another order.

Also covered: ``rerun()`` counts, the lazy ring's eviction (None rows and
the ``missed`` count) against the reference's, and the chain matcher's
compaction choice without a host wait — a sparse stream takes the
compacted branch with no per-batch read, a dense one the full-width
branch, and a stream whose host-known bound exceeds the compact width
while its true relevant count does not reads the count once per batch and
still takes the compacted branch.
"""

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.analysis.zoo import PLAN_ZOO
from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.replay import ResidentReplay as JaxReplay
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler import nfa
from flink_siddhi_tpu_torch.runtime.replay import (
    ResidentReplay,
    ShardedResidentReplay,
)

from torch_windows_common import assert_rows, last, stats, window_oracle

torch.set_num_threads(2)

BATCH = 8192
N_EVENTS = 8 * BATCH
BENCH = dict(lazy_projection=True, pred_pushdown=True)
_FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
           ("timestamp", "long")]
_NAMES = ("alpha", "beta", "gamma")

HEADLINE = (
    "from every s1 = inputStream[id == 1] -> s2 = inputStream[id == 2] -> "
    "s3 = inputStream[id == 3] within 5 sec "
    "select s1.timestamp as t1, s3.timestamp as t3, s3.price as price "
    "insert into matches"
)
CASES = {
    "headline": (HEADLINE, "inputStream", "matches"),
    "filter": ("from inputStream[id == 2] select id, name, price "
               "insert into matches", "inputStream", "matches"),
    "pattern2": ("from every s1 = inputStream[id == 1] -> "
                 "s2 = inputStream[id == 2] select s1.timestamp as t1, "
                 "s2.timestamp as t2 insert into matches", "inputStream",
                 "matches"),
    "chain_pattern": (PLAN_ZOO["chain_pattern"], "S", "out"),
    "chain_pattern_within": (PLAN_ZOO["chain_pattern_within"], "S", "out"),
    "pattern_absence": (PLAN_ZOO["pattern_absence"], "S", "out"),
    "window_groupby": ("from inputStream#window.length(1000) select id, "
                       "sum(price) as total, count() as cnt group by id "
                       "insert into matches", "inputStream", "matches"),
    # the slot NFA: a segment holding its scan replays as one graph too
    "slot_nfa_quantified": (PLAN_ZOO["slot_nfa_quantified"], "S", "out"),
}
# ids the stream draws from, per case (bench.py: 1,000 for window_groupby)
_N_IDS = {"window_groupby": 1000}
_PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, JaxConfig,
            JaxReplay, {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
              fpt.compile_plan, fpt.Job, fpt.EngineConfig, ResidentReplay,
              {"device": "cpu"}),
}


def _columns(n_ids, seed=7, n_events=N_EVENTS, price=None):
    """The bench's stream shape: id uniform in [0, n_ids), names drawn
    from three, price uniform x 100 (or ``price(rng, m)``), timestamp
    1000 + i ms."""
    rng = np.random.default_rng(seed)
    out = []
    for start in range(0, n_events, BATCH):
        m = min(BATCH, n_events - start)
        out.append({
            "id": rng.integers(0, n_ids, m).astype(np.int32),
            "name": rng.integers(0, len(_NAMES), m),
            "price": (rng.random(m) * 100.0 if price is None
                      else price(rng, m)),
            "ts": 1000 + start + np.arange(m, dtype=np.int64),
        })
    return out


def _job(pkg, cql, data, stream, retain=True, **config):
    Schema, Batch, Source, compile_plan, Job, Config, _, kw = _PKGS[pkg]
    schema = Schema(_FIELDS)
    codes = np.array(
        [schema.string_tables["name"].intern(n) for n in _NAMES], np.int32
    )
    batches = [
        Batch(stream, schema, {"id": d["id"], "name": codes[d["name"]],
                               "price": d["price"], "timestamp": d["ts"]},
              d["ts"])
        for d in data
    ]
    plan = compile_plan(cql, {stream: schema}, plan_id="p",
                        config=Config(**config))
    return Job([plan], [Source(stream, schema, iter(batches))],
               batch_size=BATCH, time_mode="processing",
               retain_results=retain, **kw)


def _streaming(pkg, cql, data, stream, out, **config):
    job = _job(pkg, cql, data, stream, **config)
    job.run()
    return job.results_with_ts(out), job


def _resident(pkg, cql, data, stream, out, **config):
    job = _job(pkg, cql, data, stream, **config)
    _PKGS[pkg][6](job).execute()
    return job.results_with_ts(out), job


def _assert_same_rows(case, got, ref, data):
    assert len(ref) >= 100
    if case != "window_groupby":
        assert got == ref
        return
    f = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    oracle = window_oracle(f, np.ones(len(f["id"]), bool), last(1000),
                           stats(f, "price")[0])
    assert_rows(got, ref, {1: oracle})


@pytest.mark.parametrize("case", sorted(CASES))
def test_streaming_rows_match_jax(case):
    cql, stream, out = CASES[case]
    data = _columns(_N_IDS.get(case, 50))
    ref, _ = _streaming("jax", cql, data, stream, out, **BENCH)
    got, tjob = _streaming("torch", cql, data, stream, out, **BENCH)
    _assert_same_rows(case, got, ref, data)
    plan = tjob._plans["p"].plan
    if case == "window_groupby":
        # no filter to push; the id travels as its group code only
        assert plan.spec.device_columns == ("inputStream.price",)
        return
    if case == "slot_nfa_quantified":
        # the reference gives a slot plan no wire options: the default tape
        assert plan.spec.device_columns is None and not plan.spec.host_preds
        return
    assert plan.spec.host_preds  # every other case pushes its filters
    # the wire carries predicate bits and the columns the device needs
    assert plan.spec.device_columns is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_resident_rows_match_jax_and_streaming(case):
    cql, stream, out = CASES[case]
    data = _columns(_N_IDS.get(case, 50))
    ref, _ = _resident("jax", cql, data, stream, out, **BENCH)
    got, tjob = _resident("torch", cql, data, stream, out, **BENCH)
    streamed, _ = _streaming("torch", cql, data, stream, out, **BENCH)
    _assert_same_rows(case, got, ref, data)
    assert got == streamed
    # a window's rows decode through its encoder, a slot plan's from its
    # buffer, neither through a lazy ring
    lazy = tjob._plans["p"].lazy
    if case in ("window_groupby", "slot_nfa_quantified"):
        assert lazy is None
    else:
        assert lazy.missed == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_rerun_counts_equal_run(case):
    cql, stream, out = CASES[case]
    job = _job("torch", cql, _columns(_N_IDS.get(case, 50)), stream,
               retain=False, **BENCH)
    rep = ResidentReplay(job)
    rep.stage()
    rep.run()
    job.flush()
    first = job.emitted_counts.get(out, 0)
    assert first >= 100
    for i in range(2):
        rep.rerun()
        assert job.emitted_counts[out] == (i + 2) * first
    # counts-only: the job retains nothing, so rerun refuses a consumer
    job.add_sink(out, lambda ts, row: None)
    with pytest.raises(ValueError, match="counts-only"):
        rep.rerun()


def test_small_lazy_ring_budget_matches_jax():
    # the resident replay stages the whole stream before the first drain:
    # a 96 KiB ring keeps only the last entries, so early matches decode
    # None — the same rows and the same miss count as the reference
    cql, stream, out = CASES["headline"]
    data = _columns(50)
    kw = dict(BENCH, lazy_ring_budget_bytes=96 * 1024)
    ref, jjob = _resident("jax", cql, data, stream, out, **kw)
    got, tjob = _resident("torch", cql, data, stream, out, **kw)
    assert got == ref
    missed = tjob._plans["p"].lazy.missed
    assert missed == jjob._plans["p"].lazy.missed > 0
    assert any(v is None for _, row in got for v in row)
    assert any(None not in row for _, row in got)


def test_float32_edge_pushed_predicate_matches_jax():
    # prices straddle the float32 rounding of the bound: float64 on the
    # host (pushed) decides them as the reference does
    edge = 50.000001
    f32 = float(np.float32(edge))  # 50.0: float32 rounds the bound down
    assert f32 < edge

    def price(rng, m):
        near = np.array([edge, f32, np.nextafter(edge, 0.0),
                         np.nextafter(edge, 100.0), 50.0], np.float64)
        return np.where(rng.random(m) < 0.5, rng.choice(near, m),
                        rng.random(m) * 100.0)

    cql = ("from every s1 = S[id == 1] -> s2 = S[price > 50.000001] "
           "within 5 sec select s1.id as a, s2.price as p insert into out")
    data = _columns(20, price=price)
    ref, _ = _streaming("jax", cql, data, "S", "out", **BENCH)
    got, tjob = _streaming("torch", cql, data, "S", "out", **BENCH)
    assert len(ref) >= 100 and got == ref
    assert tjob._plans["p"].plan.artifacts[0].pushed_preds == (0, 1)
    # the bound's own neighbours decide exactly as float64 does
    assert all(p > edge for _, (_, p) in got)


@pytest.fixture
def advance_widths(monkeypatch):
    """The candidate count V of every chain-advance call (P + R on the
    compacted branch, P + E on the full-width one)."""
    widths = []
    real = nfa.chain_advance

    def rec(nxt, pos_rows, guard_rows, ts_pad, act, *rest):
        widths.append(int(act.shape[0]))
        return real(nxt, pos_rows, guard_rows, ts_pad, act, *rest)

    monkeypatch.setattr(nfa, "chain_advance", rec)
    return widths


def _compact_v(pool=1024):
    return pool + nfa._compact_width(BATCH)


def test_sparse_stream_compacts_with_no_per_batch_sync(advance_widths):
    # 3 pushed elements over 50 ids: about 6% relevant, under E/8; the
    # pushed masks make the host's bound exact, so no batch reads it
    cql, stream, out = CASES["headline"]
    data = _columns(50)
    ref, _ = _streaming("jax", cql, data, stream, out, **BENCH)
    got, tjob = _streaming("torch", cql, data, stream, out, **BENCH)
    assert got == ref
    assert advance_widths == [_compact_v()] * len(data)
    assert tjob._plans["p"].plan.artifacts[0].host_syncs == 0
    assert tjob.host_syncs == tjob.drain_waits
    assert tjob.fetch_syncs == tjob.drain_fetches > 0


def test_dense_stream_takes_full_width_branch(advance_widths):
    cql, stream, out = CASES["headline"]
    data = _columns(4, seed=11)
    assert np.isin(data[0]["id"], [1, 2, 3]).sum() > BATCH // 8
    ref, _ = _streaming("jax", cql, data, stream, out, **BENCH)
    got, tjob = _streaming("torch", cql, data, stream, out, **BENCH)
    assert len(ref) >= 1000 and got == ref
    assert advance_widths == [1024 + BATCH] * len(data)
    # the bound exceeds R, so each batch reads the device count once
    assert tjob._plans["p"].plan.artifacts[0].host_syncs == len(data)


def test_bound_above_width_reads_count_once_per_batch(advance_widths):
    # element 2's filter calls a function: it stays on the device, so the
    # host's bound counts its whole stream (every event) while the true
    # relevant count stays sparse (about 6%) — one read per batch, and
    # the compacted branch
    cql = ("from every s1 = inputStream[id == 1] -> "
           "s2 = inputStream[math:abs(price) < 2.0] -> "
           "s3 = inputStream[id == 3] within 5 sec "
           "select s1.timestamp as t1, s3.price as price "
           "insert into matches")
    data = _columns(50)
    ref, _ = _streaming("jax", cql, data, "inputStream", "matches",
                        **BENCH)
    got, tjob = _streaming("torch", cql, data, "inputStream", "matches",
                           **BENCH)
    assert len(ref) >= 100 and got == ref
    art = tjob._plans["p"].plan.artifacts[0]
    assert art.pushed_preds == (0, 2)
    assert art.host_syncs == len(data)
    assert advance_widths == [_compact_v()] * len(data)


def test_resident_replay_refuses_to_cross_the_ordinal_wrap(monkeypatch):
    # with a small wrap the staged stream crosses it: a plan whose rows
    # are observed is refused before any tape is built, a counts-only
    # plan stages and counts as the streaming run does
    from flink_siddhi_tpu_torch.runtime import executor
    monkeypatch.setattr(executor, "_LAZY_ORD_WRAP", 3 * BATCH)
    cql, stream, out = CASES["headline"]
    data = _columns(50)
    job = _job("torch", cql, data, stream, **BENCH)
    with pytest.raises(ValueError, match=str(3 * BATCH)):
        ResidentReplay(job).stage()
    _, ref = _streaming("torch", cql, data, stream, out, **BENCH)
    job = _job("torch", cql, data, stream, retain=False, **BENCH)
    ResidentReplay(job).execute()
    assert job.emitted_counts == ref.emitted_counts
    assert ref.emitted_counts[out] > 0


def test_refusals_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="item 10"):
        fpt.Job([], [], device="cpu", control_sources=[object()])
    with pytest.raises(NotImplementedError, match="item 11"):
        ShardedResidentReplay(fpt.Job([], [], device="cpu"))


def test_timed_absence_under_bench_config_matches_jax():
    # a terminal timed absence keeps its ts row (its emission time is a
    # deadline, not an event's) and emits its last deadlines from the
    # end-of-stream flush, decoded through the lazy ring. Batch 2,048:
    # the full-width branch, where the reference is the oracle (its
    # compacted branch misses guards here: ROADMAP.md Queue 3)
    cql = ("from every s1 = S[id == 1] -> not S[id == 9] for 40 "
           "milliseconds select s1.timestamp as t1, s1.price as p "
           "insert into out")
    flat = _columns(60, seed=13, n_events=3 * BATCH)
    data = [{k: v[i:i + 2048] for k, v in d.items()}
            for d in flat for i in range(0, BATCH, 2048)]
    for run in (_streaming, _resident):
        ref, _ = run("jax", cql, data, "S", "out", **BENCH)
        got, tjob = run("torch", cql, data, "S", "out", **BENCH)
        assert len(ref) >= 100 and got == ref
    art = tjob._plans["p"].plan.artifacts[0]
    assert art.pushed_preds == (0, 1) and art._row_plan()[2] == 0


@pytest.mark.parametrize("case", ["headline", "filter"])
def test_lazy_decode_matches_jax_rows_and_columns(case):
    """Both decodes of a lazy block — rows through the ring's ``lookup``,
    columns through ``lookup_np`` — against the reference's, on one block
    and one ring content, with a budget that has evicted the oldest
    ordinals (None values, object columns) and misses counted alike."""
    from flink_siddhi_tpu.runtime.executor import _LazyRing as JaxRing
    from flink_siddhi_tpu_torch.runtime.executor import _LazyRing

    cql, stream, _ = CASES[case]
    data = _columns(50, n_events=4 * BATCH)
    arts, rings = {}, {}
    for pkg, Ring in (("jax", JaxRing), ("torch", _LazyRing)):
        job = _job(pkg, cql, data, stream, **BENCH)
        arts[pkg] = job._plans["p"].plan.artifacts[0]
        # four entries of one batch each; the budget keeps the last three
        ring = Ring(budget_bytes=3 * BATCH * 20 + 1)
        for i, d in enumerate(data):
            cols = {"inputStream.timestamp": d["ts"].copy(),
                    "inputStream.price": d["price"].copy(),
                    "inputStream.id": d["id"].copy(),
                    "inputStream.name": d["id"] % 3,
                    "@ts": (d["ts"] - 1000).astype(np.int32)}
            ring.push(i * BATCH, {k: v for k, v in cols.items()
                                  if k == "@ts" or k in
                                  arts[pkg].lazy_src_keys})
        rings[pkg] = ring
    rng = np.random.default_rng(3)
    n = 500
    ords = np.sort(rng.integers(0, 4 * BATCH, n)).astype(np.int32)
    # the chain's compact layout: one ordinal row per element read; the
    # select's: a ts row and one row per field (sorted times: the ords)
    n_rows = getattr(arts["torch"], "acc_rows",
                     1 + len(arts["torch"].output_schema.fields))
    block = np.stack([ords] * n_rows)
    rows = {p: arts[p].decode_packed(n, block, lookup=rings[p].lookup)
            for p in arts}
    cols = {p: arts[p].decode_packed_columns(
        n, block, lookup_np=rings[p].lookup_np) for p in arts}
    assert rows["torch"][0][1] == rows["jax"][0][1]
    assert any(v is None for _, r in rows["torch"][0][1] for v in r)
    tb, jb = cols["torch"][0][1], cols["jax"][0][1]
    assert np.array_equal(tb.ts, jb.ts)
    assert sorted(tb.cols) == sorted(jb.cols)
    for k in jb.cols:
        assert tb.cols[k].dtype == jb.cols[k].dtype
        assert list(tb.cols[k]) == list(jb.cols[k])
    assert rings["torch"].missed == rings["jax"].missed > 0
