"""The torch port's first slice, end to end, against the JAX package.

Each test makes one stream with numpy from a seed, hands the same columns
to both packages (each through its own schema, batches and source), runs
the same SiddhiQL through ``compile_plan`` -> ``Job`` on each side (the
port on the CPU, through its kernels' plain versions; the JAX package on
its CPU/XLA path), and requires the same rows with the same timestamps in
the same order. No tolerance is needed anywhere: filters compare float32
columns identically on both sides, and projections copy float32 values.

Covered: the bench's filter, headline and pattern2 queries at batch 8,192
(the relevance-compacted branch of the chain matcher) and on a stream dense
enough to force its full-width branch; the zoo plans filter_select,
chain_pattern, chain_pattern_within, pattern_absence, the plain
projections over unique_window and sort_window, and the window zoo plans
length_window_agg, time_window_groupby, timebatch_window and
expired_events; partials carried
across micro-batch boundaries; the pool overflow counter; non-every and
timed-absence patterns (incl. the end-of-stream flush); event-time mode
through the fluent API; and engine state carried from the JAX plan into
the port's mid-stream.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import flink_siddhi_tpu as fst
from flink_siddhi_tpu.analysis.zoo import PLAN_ZOO
from flink_siddhi_tpu.compiler.config import EngineConfig as JaxConfig
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxSource
from flink_siddhi_tpu.runtime.tape import build_tape as jax_build_tape
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.compiler.config import EngineConfig as TorchConfig
from flink_siddhi_tpu_torch.compiler.plan import state_to_numpy
from flink_siddhi_tpu_torch.runtime.tape import build_tape as torch_build_tape

from torch_windows_common import assert_rows

torch.set_num_threads(2)

_FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
           ("timestamp", "long")]

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


def _columns(n_events, batch, n_ids, seed=7, step_ms=1,
             names=("test_event",)):
    """The bench's stream shape: id uniform in [0, n_ids), price uniform
    x 100, timestamp = 1000 + i * step_ms, names drawn from ``names``."""
    rng = np.random.default_rng(seed)
    out = []
    for start in range(0, n_events, batch):
        m = min(batch, n_events - start)
        out.append({
            "id": rng.integers(0, n_ids, m).astype(np.int32),
            "name": rng.integers(0, len(names), m),
            "price": rng.random(m) * 100.0,
            "ts": 1000 + step_ms * (start + np.arange(m, dtype=np.int64)),
        })
    return out


_PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxSource, jax_compile, JaxJob, JaxConfig,
            {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, fpt.BatchSource,
              fpt.compile_plan, fpt.Job, TorchConfig, {"device": "cpu"}),
}


def _run(pkg, cql, data, batch, stream="inputStream", out="matches",
         names=("test_event",), time_mode="processing", **config):
    """Run ``cql`` over ``data`` in one package; returns (rows, job)."""
    Schema, Batch, Source, compile_plan, Job, Config, kw = _PKGS[pkg]
    schema = Schema(_FIELDS)
    codes = np.array(
        [schema.string_tables["name"].intern(n) for n in names], np.int32
    )
    batches = [
        Batch(stream, schema, {"id": d["id"], "name": codes[d["name"]],
                               "price": d["price"], "timestamp": d["ts"]},
              d["ts"])
        for d in data
    ]
    plan = compile_plan(cql, {stream: schema}, plan_id="p",
                        config=Config(**config))
    job = Job([plan], [Source(stream, schema, iter(batches))],
              batch_size=batch, time_mode=time_mode, **kw)
    job.run()
    return job.results_with_ts(out), job


def _assert_same(cql, data, batch, min_rows=1, **kw):
    ref, jjob = _run("jax", cql, data, batch, **kw)
    got, tjob = _run("torch", cql, data, batch, **kw)
    assert len(ref) >= min_rows, "the stream produced too few rows"
    assert got == ref
    return ref, jjob, tjob


@pytest.mark.parametrize("name,cql", [
    ("filter", FILTER), ("headline", HEADLINE), ("pattern2", PATTERN2),
])
def test_bench_configs_match_jax(name, cql):
    # batch 8192 >= the matcher's compaction threshold (4096): the
    # relevance-compacted branch runs, with one host sync per batch
    _, _, tjob = _assert_same(cql, _columns(4 * 8192, 8192, 50), 8192,
                              min_rows=100)
    if name != "filter":
        assert tjob.host_syncs >= 4


def test_headline_dense_stream_takes_full_width_branch():
    data = _columns(3 * 8192, 8192, 4, seed=11)
    relevant = np.isin(data[0]["id"], [1, 2, 3]).sum()
    assert relevant > 8192 // 8  # more than the compact width E/8
    _assert_same(HEADLINE, data, 8192, min_rows=1000)


_ZOO_SLICE = ["filter_select", "chain_pattern", "chain_pattern_within",
              "pattern_absence", "unique_window", "sort_window",
              "length_window_agg", "time_window_groupby", "timebatch_window",
              "expired_events"]
_ZOO_AGGREGATES = {"length_window_agg", "time_window_groupby",
                   "timebatch_window"}


@pytest.mark.parametrize("name", _ZOO_SLICE)
def test_zoo_plans_match_jax(name):
    data = _columns(2 * 8192, 8192, 10, seed=3,
                    names=("alpha", "beta", "gamma"))
    kw = dict(stream="S", out="out", names=("alpha", "beta", "gamma"))
    if name not in _ZOO_AGGREGATES:
        _assert_same(PLAN_ZOO[name], data, 8192, min_rows=10, **kw)
        return
    ref, _ = _run("jax", PLAN_ZOO[name], data, 8192, **kw)
    got, _ = _run("torch", PLAN_ZOO[name], data, 8192, **kw)
    assert_rows(got, ref, min_rows=4)


def test_partials_carry_across_batch_boundaries():
    # sparse triggers and small batches: most matches start in an earlier
    # micro-batch than the one that completes them
    cql = (
        "from every s1 = inputStream[id == 1] -> "
        "s2 = inputStream[id == 2] -> s3 = inputStream[id == 3] "
        "select s1.timestamp as t1, s3.timestamp as t3, s3.price as p "
        "insert into matches"
    )
    data = _columns(12 * 300, 300, 120, seed=5)
    ref, _, _ = _assert_same(cql, data, 300, min_rows=10)
    crossed = [r for _, r in ref if (r[0] - 1000) // 300 < (r[1] - 1000) // 300]
    assert len(crossed) >= 5


def test_pool_overflow_counter_matches_jax():
    # every without within pins partials; an 8-slot pool overflows
    cql = (
        "from every s1 = inputStream[id < 12] -> s2 = inputStream[id == 29] "
        "select s1.price as p1, s2.timestamp as t2 insert into matches"
    )
    data = _columns(6 * 256, 256, 30, seed=9)
    _, jjob, tjob = _assert_same(cql, data, 256, pattern_pool=8)
    jover = int(np.asarray(jjob._plans["p"].states["query_0"]["overflow"]))
    tover = int(tjob._plans["p"].states["query_0"]["overflow"])
    assert jover == tover > 0


@pytest.mark.parametrize("cql", [
    # non-every: exactly one match, earliest start then earliest completion
    "from s1 = inputStream[id == 1] -> s2 = inputStream[id == 2] "
    "select s1.price as p1, s2.timestamp as t2 insert into matches",
    # mid-chain absence with within
    "from every s1 = inputStream[id == 1] -> not inputStream[id == 9] -> "
    "s2 = inputStream[id == 2] within 300 milliseconds "
    "select s1.price as p1, s2.price as p2 insert into matches",
], ids=["non_every", "mid_chain_absence_within"])
def test_pattern_forms_match_jax(cql):
    _assert_same(cql, _columns(3 * 8192, 8192, 60, seed=13), 8192)


TIMED_ABSENCE = (
    "from every s1 = inputStream[id == 1] -> "
    "not inputStream[id == 9] for 40 milliseconds "
    "select s1.timestamp as t1, s1.price as p insert into matches"
)


def test_timed_absence_matches_jax_and_oracle():
    """Terminal timed absence, pending deadlines emitted by the
    end-of-stream flush. At batch 2,048 (the matcher's full-width branch)
    the port equals the JAX package. At batch 8,192 (the compacted branch)
    the port equals both that and a brute-force oracle; the JAX package's
    compacted branch is not the reference there, because it searches an
    unsorted padded tail and misses in-window guards (ROADMAP.md Queue 3).
    """
    data = _columns(3 * 8192, 8192, 60, seed=13)
    flat = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    small = [{k: v[i:i + 2048] for k, v in flat.items()}
             for i in range(0, len(flat["id"]), 2048)]
    ref, _, _ = _assert_same(TIMED_ABSENCE, small, 2048, min_rows=100)
    got, _ = _run("torch", TIMED_ABSENCE, data, 8192)
    assert got == ref
    guards = flat["ts"][flat["id"] == 9]
    oracle = [
        (int(t) + 40, (int(t), float(np.float32(p))))
        for t, p in zip(flat["ts"][flat["id"] == 1],
                        flat["price"][flat["id"] == 1])
        if not np.any((guards > t) & (guards <= t + 40))
    ]
    assert got == oracle


@dataclasses.dataclass
class _Event:
    id: int
    name: str
    price: float
    timestamp: int


def test_event_time_api_matches_jax():
    # the README's pattern through define/cql/return_as_map in event-time
    # mode: the watermark gate releases prefixes batch by batch
    events = [_Event(i % 4, f"n{i % 3}", float(i), 1000 + 1000 * i)
              for i in range(60)]
    fields = ["id", "name", "price", "timestamp"]
    cql = ("from every s1 = A[id == 2] -> s2 = A[id == 3] "
           "select s1.id as a, s2.timestamp as t insert into o")
    ref = fst.SiddhiCEP.define("A", events, fields, batch_size=16) \
        .cql(cql).return_as_map("o")
    got = fpt.SiddhiCEP.define("A", events, fields, batch_size=16,
                               device="cpu").cql(cql).return_as_map("o")
    assert len(ref) >= 10 and got == ref


def test_state_carried_from_jax_into_port():
    """The JAX plan runs batch 1; its state, fetched as numpy, seeds the
    port's plan; both run batch 2 from the same carried partials."""
    data = _columns(2 * 8192, 8192, 50, seed=21)
    jplan = jax_compile(HEADLINE, {"inputStream": JaxSchema(_FIELDS)})
    tplan = fpt.compile_plan(HEADLINE,
                             {"inputStream": fpt.StreamSchema(_FIELDS)})

    def batch(Schema, Batch, d):
        schema = Schema(_FIELDS)
        return Batch("inputStream", schema,
                     {"id": d["id"], "name": d["name"].astype(np.int32),
                      "price": d["price"], "timestamp": d["ts"]}, d["ts"])

    epoch = 1000
    jstep = jax.jit(jplan.step_acc)
    jt1, _ = jax_build_tape(jplan.spec, [batch(JaxSchema, JaxBatch, data[0])],
                            epoch)
    jst, _ = jstep(jplan.init_state(), jplan.init_acc(), jt1)
    carried = jax.device_get(jst)
    assert carried["query_0"]["active"].any()

    tst = fpt.state_from_numpy(tplan, carried, "cpu")
    jt2, _ = jax_build_tape(jplan.spec, [batch(JaxSchema, JaxBatch, data[1])],
                            epoch)
    tt2 = torch_build_tape(
        tplan.spec, [batch(fpt.StreamSchema, fpt.EventBatch, data[1])], epoch
    ).to(torch.device("cpu"))
    jst2, jacc = jstep(jst, jplan.init_acc(), jt2)
    tst2, tacc = tplan.step_acc(tst, tplan.init_acc("cpu"), tt2)

    def rows(plan, meta, buf):
        counts = np.asarray(meta)[0]
        n = int(counts.max())
        return plan.drain_decode(counts, np.asarray(buf)[:, :n])["query_0"]

    jrows = rows(jplan, jacc["meta"], jacc["buf"])[0][1]
    trows = rows(tplan, tacc["meta"].numpy(), tacc["buf"].numpy())[0][1]
    assert trows == jrows
    # some batch-2 matches started from partials carried out of batch 1
    assert any(r[0] - epoch < 8192 for _, r in jrows)
    jfinal = jax.device_get(jst2)["query_0"]
    tfinal = state_to_numpy(tst2)["query_0"]
    for k in jfinal:
        assert np.array_equal(np.asarray(jfinal[k]), tfinal[k]), k


def test_multi_query_plan_matches_jax_stacked_group():
    # both packages stack the zoo's six structurally identical chains onto
    # one query axis: one stacked artifact, the same rows in each stream
    data = _columns(2 * 8192, 8192, 10, seed=3,
                    names=("alpha", "beta", "gamma"))
    kw = dict(stream="S", out="out0", names=("alpha", "beta", "gamma"))
    _, jjob = _run("jax", PLAN_ZOO["multiquery_stack6"], data, 8192, **kw)
    _, tjob = _run("torch", PLAN_ZOO["multiquery_stack6"], data, 8192, **kw)
    jarts = jjob._plans["p"].plan.artifacts
    tarts = tjob._plans["p"].plan.artifacts
    assert [type(a).__name__ for a in tarts] == ["StackedChainArtifact"]
    assert [a.name for a in tarts] == [a.name for a in jarts]
    assert len(tarts[0].members) == 6
    for i in range(6):
        ref = jjob.results_with_ts(f"out{i}")
        assert len(ref) > 100
        assert tjob.results_with_ts(f"out{i}") == ref
