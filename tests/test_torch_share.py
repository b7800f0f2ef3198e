"""Cross-tenant subplan sharing in the port, held to the JAX package's.

The cases of ``tests/test_subplan_share.py`` run on both packages (the
port on ``device="cpu"``) over the same events and control timelines, and
their observations must agree: the split and its keys, each tenant's rows
(shared against unshared, in streaming, fused and resident modes), the
share table of ``control_status()``, the share and unshare counters, the
tenant scopes, a checkpoint of the share table, and the plan listing.
``analysis/share.py`` is pinned to the reference's text, and a fleet over
a string column holds the loopback's string codes (a suffix's string
predicate compares the codes the source interned).
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.analysis import share as j_share
from flink_siddhi_tpu.compiler.plan import compile_plan as j_compile
from flink_siddhi_tpu.control import MetadataControlEvent as JMeta
from flink_siddhi_tpu.runtime.executor import Job as JJob
from flink_siddhi_tpu.runtime.replay import ResidentReplay as JReplay
from flink_siddhi_tpu.runtime.sources import BatchSource as JBatchSource
from flink_siddhi_tpu.runtime.sources import ControlListSource as JControl
from flink_siddhi_tpu.schema.batch import EventBatch as JBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JSchema
from flink_siddhi_tpu.schema.types import AttributeType as JType

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.analysis import share as t_share
from flink_siddhi_tpu_torch.control import MetadataControlEvent as TMeta
from flink_siddhi_tpu_torch.runtime.sources import (
    BatchSource as TBatchSource,
    ControlListSource as TControl,
)

torch.set_num_threads(2)

_REPO = Path(__file__).resolve().parent.parent

JAX = types.SimpleNamespace(
    name="jax", Job=JJob, compile_plan=j_compile, Schema=JSchema,
    Type=JType, Batch=JBatch, BatchSource=JBatchSource, Control=JControl,
    Meta=JMeta, Replay=JReplay, share=j_share, kw={},
)
TORCH = types.SimpleNamespace(
    name="torch", Job=fpt.Job, compile_plan=fpt.compile_plan,
    Schema=fpt.StreamSchema, Type=fpt.AttributeType, Batch=fpt.EventBatch,
    BatchSource=TBatchSource, Control=TControl, Meta=TMeta,
    Replay=fpt.ResidentReplay, share=t_share, kw={"device": "cpu"},
)

# three STRUCTURALLY distinct tenants behind one exact leading-bracket
# predicate: plain filter chain, windowed aggregate, pattern whose every
# element carries the shared conjunct
T1 = "from S[price > 2.0][id == 1] select id, price insert into o1"
T2 = ("from S[price > 2.0]#window.lengthBatch(2) "
      "select sum(price) as tot insert into o2")
T3 = ("from every s1 = S[price > 2.0 and id == 1] -> "
      "s2 = S[price > 2.0 and id == 2] within 60 sec "
      "select s1.timestamp as t1, s2.timestamp as t2 insert into o3")


def _both(case, *args):
    ref = case(JAX, *args)
    got = case(TORCH, *args)
    assert got == ref
    return got


def _schema(pk):
    return pk.Schema([
        ("id", pk.Type.INT),
        ("price", pk.Type.DOUBLE),
        ("timestamp", pk.Type.LONG),
    ])


def _compiler(pk, schema):
    return lambda cql, pid: pk.compile_plan(cql, {"S": schema}, plan_id=pid)


def _query_of(pk, cql):
    return pk.compile_plan(cql, {"S": _schema(pk)},
                           plan_id="probe").source_ast.queries[0]


def _mk(pk, schema, n, start):
    ids = (np.arange(n) % 4).astype(np.int64)
    ts = (start + np.arange(n) * 1000).astype(np.int64)
    return pk.Batch("S", schema, {
        "id": ids, "price": np.arange(n, dtype=np.float64),
        "timestamp": ts}, ts)


def _add(pk, pid, cql, t, tenant=None):
    b = pk.Meta.builder()
    b.add_execution_plan(cql, plan_id=pid)
    ev = b.build()
    ev.tenant = tenant or pid
    return (t, ev)


def _drop(pk, pid, t):
    b = pk.Meta.builder()
    b.remove_execution_plan(pid)
    return (t, b.build())


def _job(pk, starts, timeline, share=True, fused=False):
    schema = _schema(pk)
    batches = [_mk(pk, schema, 8, s) for s in starts]
    job = pk.Job([], [pk.BatchSource("S", schema, iter(batches))],
                 batch_size=8, time_mode="event",
                 control_sources=[pk.Control(timeline)],
                 plan_compiler=_compiler(pk, schema), **pk.kw)
    job.share_subplans = share
    if fused:
        job.fused_segment_len = 2
    return job


def _rows(job):
    return {sid: sorted(rows) for sid, rows in job.collected.items()
            if rows}


def _shared_table(job):
    """The share table with its host ids, mid streams and members."""
    return {k: (e["host"], e["mid"], sorted(e["members"]))
            for k, e in job.control_status()["shared"].items()}


STARTS = (1000, 9000, 17000, 25000)


def test_share_module_is_the_reference_text():
    original = (_REPO / "flink_siddhi_tpu" / "analysis" /
                "share.py").read_bytes()
    copy = (_REPO / "flink_siddhi_tpu_torch" / "analysis" /
            "share.py").read_bytes()
    assert copy == original


# -- split + key semantics ----------------------------------------------------

def split_lifts_leading_bracket_and_pattern_common_conjuncts(pk):
    s1 = pk.share.split_shared_prefix(_query_of(pk, T1))
    s2 = pk.share.split_shared_prefix(_query_of(pk, T2))
    s3 = pk.share.split_shared_prefix(_query_of(pk, T3))
    assert s1 and s2 and s3
    assert s1.key() == s2.key() == s3.key()
    assert (pk.share.render_expr(s1.predicate)
            == pk.share.render_expr(s3.predicate))
    return s1.key(), pk.share.render_expr(s1.predicate)


def share_key_includes_constants(pk):
    a = pk.share.split_shared_prefix(_query_of(pk, T1))
    b = pk.share.split_shared_prefix(_query_of(
        pk, "from S[price > 9.0][id == 1] select id, price insert into o1"))
    assert a.key() != b.key()
    return a.key(), b.key()


def share_key_is_renderer_stable(pk):
    sp = pk.share.split_shared_prefix(_query_of(pk, T1))
    cql = pk.share.prefix_cql(sp, pk.share.MID_STREAM_PREFIX + "x")
    host_q = pk.compile_plan(cql, {"S": _schema(pk)},
                             plan_id="h").source_ast.queries[0]
    assert (pk.share.render_expr(host_q.input.filters[0])
            == pk.share.render_expr(sp.predicate))
    return cql


def split_refusals(pk):
    q = pk.share.split_shared_prefix
    assert q(_query_of(pk, "from S select id, price insert into o1")) is None
    sp = q(_query_of(pk, T1))
    mid = pk.share.MID_STREAM_PREFIX + "x"
    s_cql = pk.share.suffix_cql(_query_of(pk, T1), sp, mid, _schema(pk))
    plan = pk.compile_plan(s_cql, {"S": _schema(pk)}, plan_id="sfx")
    assert q(plan.source_ast.queries[0]) is None
    assert q(_query_of(
        pk, "from every s1 = S[id == 1] -> s2 = S[price > 2.0] "
        "within 60 sec select s1.timestamp as t1 insert into o3")) is None
    assert q(_query_of(
        pk, "from S[price > 2.0] select id, price insert into o1")) is None
    assert q(_query_of(
        pk, "from S[price > 2.0] select sum(price) as tot "
        "insert into o1")) is not None
    return s_cql


SPLIT_CASES = {
    f.__name__: f for f in (
        split_lifts_leading_bracket_and_pattern_common_conjuncts,
        share_key_includes_constants,
        share_key_is_renderer_stable,
        split_refusals,
    )
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_matches_the_reference(name):
    _both(SPLIT_CASES[name])


# -- row exactness: shared vs unshared, all three modes ----------------------

def _fleet_timeline(pk):
    return [_add(pk, "t1", T1, 0, "ten0"), _add(pk, "t2", T2, 100, "ten1"),
            _add(pk, "t3", T3, 200, "ten2")]


def shared_fleet(pk, mode):
    oracle = _job(pk, STARTS, _fleet_timeline(pk), share=False)
    oracle.run()
    job = _job(pk, STARTS, _fleet_timeline(pk), share=True,
               fused=(mode == "fused"))
    if mode == "resident":
        pk.Replay(job).execute()
    else:
        job.run()
    st = job.control_status()["shared"]
    assert len(st) == 1
    entry = list(st.values())[0]
    assert sorted(entry["members"]) == ["t1", "t2", "t3"]
    assert entry["host"].startswith(pk.share.SHARE_HOST_PREFIX)
    assert _rows(job) == _rows(oracle)
    assert not any(p.startswith(pk.share.SHARE_HOST_PREFIX)
                   for p in job.plan_ids)
    counters = job.control_status()["counters"]
    scopes = job.telemetry.snapshot()["scopes"]["tenant"]
    return (_rows(job), _shared_table(job), sorted(job.plan_ids),
            counters.get("subplan_share"), counters.get("admitted"),
            {t: scopes[t]["counters"].get("control.subplan_share")
             for t in ("ten0", "ten1", "ten2")},
            job.processed_events, job.emitted_counts)


@pytest.mark.parametrize("mode", ["streaming", "fused", "resident"])
def test_shared_fleet_row_exact_vs_unshared(mode):
    _both(shared_fleet, mode)


# -- refcounted retire / re-admit --------------------------------------------

def retire_refcounts_host_and_readmit_reforms_it(pk):
    tl = [
        _add(pk, "t1", T1, 0),
        _add(pk, "t2", T2, 100),
        _drop(pk, "t1", 9_500),     # the host survives on t2
        _drop(pk, "t2", 17_500),    # the last member: the host drops
        _add(pk, "t1b", T1, 25_500),  # the host re-forms
    ]
    job = _job(pk, STARTS, tl)
    job.run()
    cs = job.control_status()
    assert cs["counters"].get("subplan_share") == 3
    assert cs["counters"].get("subplan_unshare") == 1
    assert len(cs["shared"]) == 1
    assert list(cs["shared"].values())[0]["members"] == ["t1b"]
    assert job.collected.get("o1")
    scopes = job.telemetry.snapshot()["scopes"]["tenant"]
    assert scopes["t1"]["counters"]["control.subplan_share"] == 1
    return (_rows(job), _shared_table(job),
            {k: cs["counters"].get(k) for k in
             ("subplan_share", "subplan_unshare", "admitted", "retired")},
            {t: scopes[t]["counters"].get("control.subplan_share")
             for t in ("t1", "t2", "t1b")})


def test_retire_refcounts_host_and_readmit_reforms_it():
    _both(retire_refcounts_host_and_readmit_reforms_it)


# -- checkpoint: the share table rides the snapshot --------------------------

def checkpoint_restores_share_table_row_exact(pk):
    tl = [_add(pk, "t1", T1, 0), _add(pk, "t2", T2, 100)]
    j1 = _job(pk, STARTS[:2], tl)
    j1.run()
    snap = j1.snapshot()
    assert snap["shared"], "snapshot missing the shared block"
    j2 = _job(pk, STARTS[2:], [])
    j2.restore(snap)
    assert j2.control_status()["shared"], "share table not restored"
    j2.run()
    oracle = _job(pk, STARTS, tl)
    oracle.run()
    merged = {}
    for j in (j1, j2):
        for sid, rows in j.collected.items():
            merged.setdefault(sid, []).extend(rows)
    merged = {s: sorted(r) for s, r in merged.items() if r}
    assert merged == _rows(oracle)
    listing = {q["id"]: q for q in j2.query_listing()}
    for pid in ("t1", "t2"):
        assert listing[pid]["shared"]["host"].startswith(
            pk.share.SHARE_HOST_PREFIX)
    return (merged, _shared_table(j2), sorted(snap["shared"]),
            {pid: listing[pid]["shared"] for pid in ("t1", "t2")})


def test_checkpoint_restores_share_table_row_exact():
    _both(checkpoint_restores_share_table_row_exact)


# -- the loopback's string codes ----------------------------------------------

NAMES = ("alpha", "beta", "gamma", "delta")


def string_fleet(pk, share, mode):
    """Tenants over a string column: the prefix and the suffixes compare
    strings, and a suffix's predicate must see the codes the source
    interned (the mid DDL shares the environment's dictionary)."""
    schema = pk.Schema([("id", pk.Type.INT), ("name", pk.Type.STRING),
                        ("price", pk.Type.DOUBLE),
                        ("timestamp", pk.Type.LONG)])
    strings = schema.string_tables["name"]
    # intern the names in an order of their own, so that a suffix whose
    # dictionary were fresh would map 'beta' to another code
    for n in ("delta", "gamma", "beta", "alpha"):
        strings.intern(n)
    rng = np.random.default_rng(5)
    batches = []
    for k in range(6):
        n = 24
        ts = (1000 + k * 24_000 + np.arange(n) * 1000).astype(np.int64)
        names = rng.integers(0, len(NAMES), n)
        codes = np.array([strings.intern(NAMES[i]) for i in names],
                         np.int32)
        batches.append(pk.Batch("S", schema, {
            "id": rng.integers(0, 4, n).astype(np.int32),
            "name": codes,
            "price": rng.integers(0, 100, n).astype(np.float64),
            "timestamp": ts}, ts))
    pred = "name != 'gamma' and price > 20.0"
    cqls = {
        "s1": f"from S[{pred}][name == 'beta'] select id, name, price "
              "insert into o1",
        "s2": f"from S[{pred}][id == 2] select name, price insert into o2",
        "s3": f"from S[{pred}]#window.lengthBatch(3) "
              "select sum(price) as tot insert into o3",
        "s4": f"from every s1 = S[{pred} and name == 'alpha'] -> "
              f"s2 = S[{pred} and name == 'delta'] within 10 sec "
              "select s1.timestamp as t1, s2.name as n2 insert into o4",
    }
    tl = [_add(pk, pid, cql, 0) for pid, cql in cqls.items()]
    job = pk.Job([], [pk.BatchSource("S", schema, iter(batches))],
                 batch_size=24, time_mode="event",
                 control_sources=[pk.Control(tl)],
                 plan_compiler=lambda cql, pid: pk.compile_plan(
                     cql, {"S": schema}, plan_id=pid), **pk.kw)
    job.share_subplans = share
    if mode == "fused":
        job.fused_segment_len = 2
    if mode == "resident":
        pk.Replay(job).execute()
    else:
        job.run()
    return _rows(job), len(job.control_status()["shared"])


@pytest.mark.parametrize("mode", ["streaming", "fused", "resident"])
def test_string_fleet_crosses_the_loopback(mode):
    shared = _both(string_fleet, True, mode)
    unshared = _both(string_fleet, False, "streaming")
    assert shared[1] == 1 and unshared[1] == 0
    assert shared[0] == unshared[0]
    assert shared[0]["o1"] and shared[0]["o4"]
    assert all(r[1][1] == "beta" for r in shared[0]["o1"])


class _Columns:
    """A columnar sink: the rows it was given, as (ts, row) tuples."""

    def __init__(self):
        self.rows = []

    def accept_columns(self, ts, cols):
        names = list(cols)
        self.rows.extend(
            (int(t), tuple(cols[n][i].item() for n in names))
            for i, t in enumerate(ts))


def _sink_fleet(share, fused):
    job = _job(TORCH, STARTS, _fleet_timeline(TORCH), share=share,
               fused=fused)
    job.retain_results = False
    sinks = {"o1": _Columns(), "o2": _Columns()}  # o3: counts only
    for sid, sink in sinks.items():
        job.add_sink(sid, sink)
    job.run()
    job.drain_outputs()
    return ({sid: sorted(s.rows) for sid, s in sinks.items()},
            dict(job.emitted_counts))


@pytest.mark.parametrize("fused", [False, True])
def test_counts_only_and_columnar_consumers_feed_the_loopback(fused):
    """With retention off, columnar sinks on two tenants' streams and none
    on the third, the hosts' mid rows still decode and loop back: each
    tenant's rows and counts equal the unshared run's, and the mid
    streams count nowhere."""
    shared = _sink_fleet(True, fused)
    unshared = _sink_fleet(False, fused)
    assert shared == unshared
    assert shared[0]["o1"] and shared[0]["o2"] and shared[1]["o3"]
    assert not any(s.startswith(t_share.MID_STREAM_PREFIX)
                   for s in shared[1])
