"""The port's dynamic control plane on the CPU, held to the JAX package's.

Each case runs the JAX package's control plane and the port's
(``device="cpu"``) on the same inputs and holds rows, plan ids, slots,
status and counters equal; the reference test's own assertions run on both
sides:

* every case of ``tests/test_control_e2e.py`` and of
  ``tests/test_dynamic_group.py``. The reference's "no retrace" criterion
  (its jitted step traced no more) becomes the port's: the fused run's
  graph keys do not grow at a fold, an evict or an enable;
* ``tests/test_control_plane.py``'s admit / stack-join / retire-reclaim,
  the run-loop ownership guard, the refused unparsable CQL, the REST
  service under sustained load, the resident replay in epochs against the
  streaming run, a live control queue in a resident replay, a checkpoint
  taken with an admit still pending, and the tenant's JSON round trip,
  with the admission gate on both sides; its hostile query refused by
  ADM110 at the REST boundary (422) and at apply time, the gate refusing
  before any event is pushed, and a gated admit skipping the apply-time
  deep tier (``control.preclear``);
* ``tests/test_app.py``'s REST round trip over the ported routes, and
  ``tests/test_replay.py``'s control-streams contract;
* ``DynamicChainGroup.step`` against the reference's on random tapes
  (states and packed blocks equal), one call of each chain kernel per
  group step with 1 member or 8, a retire followed by an admit into the
  same slot within one drain interval (rows attributed to the member that
  produced them), and what still waits for a later ROADMAP item.
"""

import dataclasses
import functools
import http.client
import json
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

import flink_siddhi_tpu as jfst
from flink_siddhi_tpu.app import service as j_service
from flink_siddhi_tpu.compiler import nfa as j_nfa
from flink_siddhi_tpu.compiler.plan import compile_plan as j_compile
from flink_siddhi_tpu.control import events as j_events
from flink_siddhi_tpu.control import plane as j_plane
from flink_siddhi_tpu.runtime import executor as j_executor
from flink_siddhi_tpu.runtime import replay as j_replay
from flink_siddhi_tpu.runtime import sources as j_sources
from flink_siddhi_tpu.runtime.tape import build_tape as j_build_tape
from flink_siddhi_tpu.schema.batch import EventBatch as JBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JSchema
from flink_siddhi_tpu.schema.types import AttributeType as JType

import flink_siddhi_tpu_torch as tfst
from flink_siddhi_tpu_torch.app import service as t_service
from flink_siddhi_tpu_torch.compiler import nfa as t_nfa
from flink_siddhi_tpu_torch.compiler.plan import compile_plan as t_compile
from flink_siddhi_tpu_torch.control import events as t_events
from flink_siddhi_tpu_torch.control import plane as t_plane
from flink_siddhi_tpu_torch.runtime import executor as t_executor
from flink_siddhi_tpu_torch.runtime import replay as t_replay
from flink_siddhi_tpu_torch.runtime import sources as t_sources
from flink_siddhi_tpu_torch.runtime.tape import build_tape as t_build_tape

torch.set_num_threads(2)

JAX = types.SimpleNamespace(
    name="jax", Job=j_executor.Job, compile_plan=j_compile,
    StreamSchema=JSchema, AttributeType=JType, EventBatch=JBatch,
    CallbackSource=j_sources.CallbackSource,
    BatchSource=j_sources.BatchSource,
    ControlListSource=j_sources.ControlListSource,
    ControlQueueSource=j_service.ControlQueueSource,
    QueryControlService=j_service.QueryControlService,
    ControlPlane=j_plane.ControlPlane, AdmissionGate=j_plane.AdmissionGate,
    MetadataControlEvent=j_events.MetadataControlEvent,
    OperationControlEvent=j_events.OperationControlEvent,
    ResidentReplay=j_replay.ResidentReplay,
    CEPEnvironment=jfst.CEPEnvironment, SiddhiCEP=jfst.SiddhiCEP,
    executor=j_executor, events=j_events,
)
TORCH = types.SimpleNamespace(
    name="torch", Job=functools.partial(t_executor.Job, device="cpu"),
    compile_plan=t_compile, StreamSchema=tfst.StreamSchema,
    AttributeType=tfst.AttributeType, EventBatch=tfst.EventBatch,
    CallbackSource=t_sources.CallbackSource,
    BatchSource=t_sources.BatchSource,
    ControlListSource=t_sources.ControlListSource,
    ControlQueueSource=t_service.ControlQueueSource,
    QueryControlService=t_service.QueryControlService,
    ControlPlane=t_plane.ControlPlane, AdmissionGate=t_plane.AdmissionGate,
    MetadataControlEvent=t_events.MetadataControlEvent,
    OperationControlEvent=t_events.OperationControlEvent,
    ResidentReplay=t_replay.ResidentReplay,
    CEPEnvironment=functools.partial(tfst.CEPEnvironment, device="cpu"),
    SiddhiCEP=tfst.SiddhiCEP, executor=t_executor, events=t_events,
)
BOTH = (JAX, TORCH)


def _both(case, *args):
    """Run ``case`` on each package; the observations must agree."""
    ref = case(JAX, *args)
    got = case(TORCH, *args)
    assert got == ref
    return got


def _schema(pk):
    return pk.StreamSchema([
        ("id", pk.AttributeType.INT),
        ("price", pk.AttributeType.DOUBLE),
        ("timestamp", pk.AttributeType.LONG),
    ])


class Rec:
    def __init__(self, id, price, timestamp):
        self.id, self.price, self.timestamp = id, price, timestamp


def _compiler(pk, schema):
    return lambda cql, pid: pk.compile_plan(cql, {"S": schema}, plan_id=pid)


def _marker(pk, job):
    """The "no retrace" marker: the reference's traces of its jitted
    step; the port's graph keys (its fused runs' segment shapes)."""
    if pk is JAX:
        return sum(rt.traces["n"] for rt in job._plans.values())
    return job.graph_keys


def _fused(pk, job):
    """The port runs its dynamic-group cases fused (two tapes a segment),
    so that a fold, an evict or an enable meets the segment graphs'
    binding."""
    if pk is TORCH:
        job.fused_segment_len = 2
    return job


# -- tests/test_control_e2e.py ------------------------------------------------

@dataclasses.dataclass
class Event:
    id: int
    price: float
    timestamp: int


E2E_FIELDS = ["id", "price", "timestamp"]


def _make_events(n, start_ts=1000):
    return [Event(i % 4, float(i), start_ts + 1000 * i) for i in range(n)]


def _dyn(pk, events, control, batch_size=4096):
    env = pk.CEPEnvironment(batch_size=batch_size)
    return pk.SiddhiCEP.define("S", events, E2E_FIELDS, env=env).cql(control)


def e2e_add_plan_mid_stream(pk):
    events = _make_events(10)
    ev = pk.MetadataControlEvent.builder()
    ev.add_execution_plan("from S select id, price insert into out")
    out = _dyn(pk, events, [(5500, ev.build())], batch_size=1).returns("out")
    assert out == [(e.id, e.price) for e in events if e.timestamp > 5500]
    return out


def e2e_multiple_plans_fan_out(pk):
    events = _make_events(8)
    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan("from S[id == 1] select id insert into ones")
    b.add_execution_plan("from S[id == 2] select id insert into twos")
    job = _dyn(pk, events, [(0, b.build())]).execute()
    assert len(job.results("ones")) == 2
    assert len(job.results("twos")) == 2
    return job.results("ones"), job.results("twos")


def e2e_disable_enable_query(pk):
    events = _make_events(10)
    b = pk.MetadataControlEvent.builder()
    pid = b.add_execution_plan("from S select id insert into out")
    control = [
        (0, b.build()),
        (4500, pk.OperationControlEvent.disable_query(pid)),
        (7500, pk.OperationControlEvent.enable_query(pid)),
    ]
    out = _dyn(pk, events, control, batch_size=1).returns("out")
    assert out == [(e.id,) for e in events
                   if e.timestamp <= 4500 or e.timestamp > 7500]
    return out


def e2e_remove_plan(pk):
    events = _make_events(10)
    b = pk.MetadataControlEvent.builder()
    pid = b.add_execution_plan("from S select id insert into out")
    drop = pk.MetadataControlEvent.builder()
    drop.remove_execution_plan(pid)
    out = _dyn(pk, events, [(0, b.build()), (5500, drop.build())],
               batch_size=1).returns("out")
    assert out == [(e.id,) for e in events if e.timestamp <= 5500]
    return out


def e2e_update_plan(pk):
    events = _make_events(10)
    b = pk.MetadataControlEvent.builder()
    pid = b.add_execution_plan("from S[id == 1] select id insert into out")
    upd = (pk.MetadataControlEvent.builder()
           .update_execution_plan(
               pid, "from S[id == 2] select id insert into out")
           .build())
    out = _dyn(pk, events, [(0, b.build()), (5500, upd)],
               batch_size=1).returns("out")
    assert out == [(e.id,) for e in events
                   if (e.timestamp <= 5500 and e.id == 1)
                   or (e.timestamp > 5500 and e.id == 2)]
    return out


def e2e_dynamic_pattern_plan(pk):
    events = [Event(2, 1.0, 1000), Event(3, 2.0, 2000), Event(2, 3.0, 3000),
              Event(3, 4.0, 4000)]
    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan(
        "from every s1 = S[id == 2] -> s2 = S[id == 3] "
        "select s1.price as p1, s2.price as p2 insert into outputStream"
    )
    out = _dyn(pk, events, [(0, b.build())]).return_as_map("outputStream")
    assert out == [{"p1": 1.0, "p2": 2.0}, {"p1": 3.0, "p2": 4.0}]
    return out


def e2e_control_json_round_trip(pk):
    b = pk.MetadataControlEvent.builder()
    pid = b.add_execution_plan("from S select id insert into out")
    ev2 = pk.events.control_event_from_json(
        pk.events.control_event_to_json(b.build()))
    assert ev2.added_plans == {pid: "from S select id insert into out"}
    op = pk.OperationControlEvent.disable_query("abc")
    op2 = pk.events.control_event_from_json(
        pk.events.control_event_to_json(op))
    assert (op2.action, op2.plan_id) == ("disable", "abc")
    return len(ev2.added_plans), op2.action, op2.plan_id


E2E_CASES = {
    f.__name__[len("e2e_"):]: f for f in (
        e2e_add_plan_mid_stream, e2e_multiple_plans_fan_out,
        e2e_disable_enable_query, e2e_remove_plan, e2e_update_plan,
        e2e_dynamic_pattern_plan, e2e_control_json_round_trip,
    )
}


@pytest.mark.parametrize("name", sorted(E2E_CASES))
def test_control_e2e_matches_the_reference(name):
    _both(E2E_CASES[name])


# -- tests/test_dynamic_group.py ----------------------------------------------

def _group_job(pk, src, schema, control=None):
    job = pk.Job(
        [], [src], batch_size=64, time_mode="processing",
        control_sources=[control] if control is not None else [],
        plan_compiler=_compiler(pk, schema),
    )
    return _fused(pk, job)


def _chain_cql(pid, a, b):
    return (
        f"from every s1 = S[id == {a}] -> s2 = S[id == {b}] "
        f"select s1.timestamp as t1, s2.timestamp as t2 "
        f"insert into out_{pid}"
    )


def _emit(src, lo, hi, price=float):
    for i in range(lo, hi):
        src.emit(Rec(i % 4, price(i), 1000 + i), 1000 + i)


def dg_second_add_is_a_data_update_no_retrace(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    job = _group_job(pk, src, schema)
    job.add_plan(pk.compile_plan(_chain_cql("q1", 1, 2), {"S": schema},
                                 plan_id="q1"), dynamic=True)
    _emit(src, 0, 8)
    job.run_cycle()
    assert job.results("out_q1") == [(1001, 1002), (1005, 1006)]
    marker = _marker(pk, job)
    assert marker >= 1
    job.add_plan(pk.compile_plan(_chain_cql("q2", 2, 3), {"S": schema},
                                 plan_id="q2"), dynamic=True)
    assert len(job._plans) == 1
    assert set(job.plan_ids) == {"q1", "q2"}
    _emit(src, 8, 16)
    job.run_cycle()
    assert job.results("out_q2") == [(1010, 1011), (1014, 1015)]
    assert _marker(pk, job) == marker
    assert len(job.results("out_q1")) == 4
    n1 = len(job.results("out_q1"))
    job.set_plan_enabled("q1", False)
    _emit(src, 16, 24)
    job.run_cycle()
    assert len(job.results("out_q1")) == n1
    assert _marker(pk, job) == marker
    job.remove_plan("q2")
    assert job.plan_ids == ["q1"]
    job.remove_plan("q1")
    assert job.plan_ids == [] and not job._plans
    return job.results("out_q1"), job.results("out_q2")


def dg_dynamic_adds_via_control_events(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    control = pk.ControlQueueSource()
    job = _group_job(pk, src, schema, control)
    b = pk.MetadataControlEvent.builder()
    pid_a = b.add_execution_plan(_chain_cql("a", 1, 2))
    control.push(b.build())
    _emit(src, 0, 8)
    job.run_cycle()
    job.results("out_a")
    t0 = _marker(pk, job)
    b2 = pk.MetadataControlEvent.builder()
    b2.add_execution_plan(_chain_cql("b", 3, 1))
    control.push(b2.build())
    _emit(src, 8, 16)
    job.run_cycle()
    assert len(job.results("out_b")) > 0
    assert _marker(pk, job) == t0
    control.push(pk.OperationControlEvent.disable_query(pid_a))
    na = len(job.results("out_a"))
    _emit(src, 16, 24)
    job.run_cycle()
    job.run_cycle()
    assert len(job.results("out_a")) == na
    assert _marker(pk, job) == t0
    return job.results("out_a"), job.results("out_b")


def dg_mixed_types_and_within_fold(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    job = _group_job(pk, src, schema)
    cql1 = ("from every s1 = S[price == 5.0] -> s2 = S[price == 7.0] "
            "within 5 sec select s1.timestamp as t1, s2.timestamp as t2 "
            "insert into oa")
    cql2 = ("from every s1 = S[price == 1.0] -> s2 = S[price == 2.0] "
            "within 1 sec select s1.timestamp as t1, s2.timestamp as t2 "
            "insert into ob")
    job.add_plan(pk.compile_plan(cql1, {"S": schema}, plan_id="a"),
                 dynamic=True)
    src.emit(Rec(0, 5.0, 1000), 1000)
    src.emit(Rec(0, 7.0, 2000), 2000)
    job.run_cycle()
    job.results("oa")
    t0 = _marker(pk, job)
    job.add_plan(pk.compile_plan(cql2, {"S": schema}, plan_id="b"),
                 dynamic=True)
    for price, ts in ((1.0, 3000), (2.0, 5000), (1.0, 6000), (2.0, 6500)):
        src.emit(Rec(0, price, ts), ts)
    job.run_cycle()
    assert job.results("oa") == [(1000, 2000)]
    assert job.results("ob") == [(6000, 6500)]
    assert _marker(pk, job) == t0
    return job.results("oa"), job.results("ob")


def dg_non_template_dynamic_add_still_works(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    job = _group_job(pk, src, schema)
    job.add_plan(pk.compile_plan(_chain_cql("q1", 1, 2), {"S": schema},
                                 plan_id="q1"), dynamic=True)
    job.add_plan(pk.compile_plan(
        "from S select id, sum(price) as total group by id "
        "insert into totals", {"S": schema}, plan_id="w1"), dynamic=True)
    assert len(job._plans) == 2
    assert set(job.plan_ids) == {"q1", "w1"}
    _emit(src, 0, 8)
    job.run_cycle()
    assert len(job.results("totals")) == 8
    return job.results("totals")


def dg_checkpoint_restore_replays_dynamic_group(pk, tmp_path):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    control = pk.ControlQueueSource()
    job = _group_job(pk, src, schema, control)
    b = pk.MetadataControlEvent.builder()
    pid_a = b.add_execution_plan(_chain_cql("a", 1, 2))
    pid_b = b.add_execution_plan(_chain_cql("b", 2, 3))
    control.push(b.build())
    src.emit(Rec(1, 0.0, 1000), 1000)
    src.emit(Rec(9, 0.0, 1001), 1001)
    job.run_cycle()
    path = tmp_path / f"ckpt-{pk.name}.bin"
    job.save_checkpoint(str(path))
    src2 = pk.CallbackSource("S", schema)
    job2 = _group_job(pk, src2, schema)
    job2.restore(str(path))
    assert set(job2.plan_ids) == {pid_a, pid_b}
    src2.emit(Rec(2, 0.0, 2000), 2000)
    job2.run_cycle()
    assert job2.results("out_a") == [(1000, 2000)]
    return job2.results("out_a"), sorted(s for _, s in job2._folded.values())


def dg_duplicate_dynamic_add_replaces_not_duplicates(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    job = _group_job(pk, src, schema)
    for _ in range(2):
        job.add_plan(pk.compile_plan(_chain_cql("q1", 1, 2), {"S": schema},
                                     plan_id="q1"), dynamic=True)
    assert job.plan_ids == ["q1"]
    _emit(src, 0, 8)
    job.run_cycle()
    assert job.results("out_q1") == [(1001, 1002), (1005, 1006)]
    return job.results("out_q1"), dict(job._folded)


def dg_non_integral_literal_on_int_column_not_folded(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    job = _group_job(pk, src, schema)
    job.add_plan(pk.compile_plan(_chain_cql("q1", 1, 2), {"S": schema},
                                 plan_id="q1"), dynamic=True)
    cql = ("from every s1 = S[id == 5.5] -> s2 = S[id == 2] "
           "select s1.timestamp as t1, s2.timestamp as t2 insert into oz")
    job.add_plan(pk.compile_plan(cql, {"S": schema}, plan_id="qz"),
                 dynamic=True)
    assert "qz" in job._plans
    src.emit(Rec(5, 0.0, 1000), 1000)
    src.emit(Rec(2, 0.0, 1001), 1001)
    job.run_cycle()
    assert job.results("oz") == []
    return sorted(job._plans), job.results("oz")


def dg_direct_dynamic_add_checkpoint_needs_cql(pk, tmp_path):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    job = _group_job(pk, src, schema)
    cql = _chain_cql("q1", 1, 2)
    job.add_plan(pk.compile_plan(cql, {"S": schema}, plan_id="q1"),
                 dynamic=True)
    src.emit(Rec(1, 0.0, 1000), 1000)
    job.run_cycle()
    with pytest.raises(ValueError, match="no\\s+recorded CQL"):
        job.save_checkpoint(str(tmp_path / f"x-{pk.name}.bin"))
    src2 = pk.CallbackSource("S", schema)
    job2 = _group_job(pk, src2, schema)
    job2.add_plan(pk.compile_plan(cql, {"S": schema}, plan_id="q1"),
                  dynamic=True, cql=cql)
    src2.emit(Rec(1, 0.0, 1000), 1000)
    job2.run_cycle()
    p = tmp_path / f"ok-{pk.name}.bin"
    job2.save_checkpoint(str(p))
    src3 = pk.CallbackSource("S", schema)
    job3 = _group_job(pk, src3, schema)
    job3.restore(str(p))
    src3.emit(Rec(2, 0.0, 2000), 2000)
    job3.run_cycle()
    assert job3.results("out_q1") == [(1000, 2000)]
    return job3.results("out_q1")


def dg_replay_skips_member_with_missing_cql(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    control = pk.ControlQueueSource()
    job = _group_job(pk, src, schema, control)
    b = pk.MetadataControlEvent.builder()
    pids = [b.add_execution_plan(_chain_cql(n, a, a + 1), plan_id=n)
            for n, a in (("a", 1), ("b", 2), ("c", 3))]
    control.push(b.build())
    job.run_cycle()
    assert len(job._folded) == 3
    cqls = dict(job._dynamic_cql)
    first_pid = min(job._folded, key=lambda p: job._folded[p][1])
    del cqls[first_pid]
    src2 = pk.CallbackSource("S", schema)
    job2 = _group_job(pk, src2, schema)
    job2._replay_dynamic(cqls, dict(job._folded),
                         {p: True for p in job._folded})
    survivors = set(pids) - {first_pid}
    assert set(job2.plan_ids) == survivors
    src2.emit(Rec(2, 0.0, 1000), 1000)
    src2.emit(Rec(3, 0.0, 2000), 2000)
    job2.run_cycle()
    name_b = [p for p in pids if p in survivors][0]
    assert job2.results(f"out_{name_b}") == [(1000, 2000)]
    return job2.results(f"out_{name_b}"), sorted(job2._folded.items())


def dg_range_predicates_fold_without_retrace(pk):
    def cql(pid, f1, f2):
        return (f"from every s1 = S[{f1}] -> s2 = S[{f2}] "
                f"select s1.timestamp as t1, s2.timestamp as t2 "
                f"insert into out_{pid}")

    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    job = _group_job(pk, src, schema)
    job.add_plan(pk.compile_plan(cql("a", "price > 10.0", "price < 3.0"),
                                 {"S": schema}, plan_id="a"), dynamic=True)
    for i in range(8):
        src.emit(Rec(i, float(i * 4), 1000 + i), 1000 + i)
    job.run_cycle()
    assert job.results("out_a") == []
    traces0 = _marker(pk, job)
    job.add_plan(pk.compile_plan(cql("b", "price >= 20.0", "price >= 24.0"),
                                 {"S": schema}, plan_id="b"), dynamic=True)
    assert len(job._plans) == 1
    for i in range(8, 16):
        src.emit(Rec(i, float(i * 4), 1000 + i), 1000 + i)
    job.run_cycle()
    assert job.results("out_b")[0] == (1008, 1009)
    assert _marker(pk, job) == traces0
    return job.results("out_a"), job.results("out_b")


def dg_range_chain_matches_static_compile(pk):
    cql = ("from every s1 = S[price > 5.0] -> s2 = S[price <= 2.0] "
           "select s1.timestamp as t1, s2.timestamp as t2 insert into o")
    recs = [Rec(i, float([8, 1, 9, 2, 7, 0][i % 6]), 1000 + i)
            for i in range(24)]

    def run(dynamic):
        schema = _schema(pk)
        src = pk.CallbackSource("S", schema)
        job = _group_job(pk, src, schema)
        job.add_plan(pk.compile_plan(cql, {"S": schema}, plan_id="q"),
                     dynamic=dynamic)
        for r in recs:
            src.emit(r, r.timestamp)
        job.run_cycle()
        job.flush()
        return job.results("o")

    static = run(False)
    assert run(True) == static
    assert len(static) > 0
    return static


DG_CASES = {
    f.__name__[len("dg_"):]: f for f in (
        dg_second_add_is_a_data_update_no_retrace,
        dg_dynamic_adds_via_control_events,
        dg_mixed_types_and_within_fold,
        dg_non_template_dynamic_add_still_works,
        dg_checkpoint_restore_replays_dynamic_group,
        dg_duplicate_dynamic_add_replaces_not_duplicates,
        dg_non_integral_literal_on_int_column_not_folded,
        dg_direct_dynamic_add_checkpoint_needs_cql,
        dg_replay_skips_member_with_missing_cql,
        dg_range_predicates_fold_without_retrace,
        dg_range_chain_matches_static_compile,
    )
}
_DG_TMP = {"checkpoint_restore_replays_dynamic_group",
           "direct_dynamic_add_checkpoint_needs_cql"}


@pytest.mark.parametrize("name", sorted(DG_CASES))
def test_dynamic_group_matches_the_reference(name, tmp_path):
    args = (tmp_path,) if name in _DG_TMP else ()
    _both(DG_CASES[name], *args)


# -- tests/test_control_plane.py ----------------------------------------------

def _cp_chain(a, b, out="out"):
    return (f"from every s1 = S[id == {a}] -> s2 = S[id == {b}] "
            "within 60 sec "
            f"select s1.timestamp as t1, s2.timestamp as t2 "
            f"insert into {out}")


def _cp_job(pk, src, ctrl, schema, **kw):
    return pk.Job([], [src], batch_size=64, time_mode="processing",
                  control_sources=[ctrl],
                  plan_compiler=_compiler(pk, schema), **kw)


def _plane(pk, job, ctrl, schema):
    return pk.ControlPlane(
        job, ctrl, gate=pk.AdmissionGate(_compiler(pk, schema)))


def cp_admit_stack_join_retire_reclaim_slot(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    ctrl = pk.ControlQueueSource()
    job = _cp_job(pk, src, ctrl, schema)
    plane = _plane(pk, job, ctrl, schema)
    plane.admit(_cp_chain(1, 2), plan_id="q1", tenant="acme")
    _emit(src, 0, 8)
    job.run_cycle()
    assert job.results("out") == [(1001, 1002), (1005, 1006)]
    plane.admit(_cp_chain(2, 3), plan_id="q2")
    job.run_cycle()
    assert len(job._plans) == 1
    st = plane.status()
    assert st["counters"]["admitted"] == 2
    assert st["counters"]["stack_join"] == 1
    assert st["plans"]["q1"]["folded"]["slot"] == 0
    assert st["plans"]["q2"]["folded"]["slot"] == 1
    plane.retire("q1")
    n_before = len(job.results("out"))
    _emit(src, 8, 16)
    job.run_cycle()
    rows = job.results("out")
    assert rows[n_before:] == [(1010, 1011), (1014, 1015)]
    plane.admit(_cp_chain(3, 0), plan_id="q3")
    job.run_cycle()
    st = plane.status()
    assert st["plans"]["q3"]["folded"]["slot"] == 0
    assert st["counters"]["retired"] == 1
    assert st["counters"]["stack_join"] == 2
    return (rows, {k: v["folded"] for k, v in st["plans"].items()},
            {k: st["counters"][k] for k in
             ("admitted", "stack_join", "retired")},
            job.tenant_of("q1"), job.tenant_of("q3"))


def cp_ownership_guard_catches_off_thread_mutation(pk, monkeypatch):
    monkeypatch.setattr(pk.executor, "RUNLOOP_OWNERSHIP_GUARD", True)
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    ctrl = pk.ControlQueueSource()
    job = _cp_job(pk, src, ctrl, schema)
    plane = _plane(pk, job, ctrl, schema)
    plane.admit(_cp_chain(1, 2), plan_id="q1")
    _emit(src, 0, 8)
    job.run_cycle()
    assert job.results("out") == [(1001, 1002), (1005, 1006)]
    caught = []

    def rogue():
        try:
            job.set_plan_enabled("q1", False)
        except pk.executor.OwnershipViolation as e:
            caught.append(e)

    t = threading.Thread(target=rogue)
    t.start()
    t.join()
    assert len(caught) == 1
    msg = str(caught[0])
    assert "owns Job state" in msg and "control event" in msg
    _emit(src, 8, 12)
    job.run_cycle()
    assert job.results("out")[-1] == (1009, 1010)
    t2 = threading.Thread(target=plane.set_enabled, args=("q1", False))
    t2.start()
    t2.join()
    _emit(src, 12, 20)
    n_before = len(job.results("out"))
    job.run_cycle()
    assert len(job.results("out")) == n_before
    job.set_plan_enabled("q1", True)
    return job.results("out"), job._folded_enabled["q1"]


def cp_unparsable_cql_refused_not_fatal(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    ctrl = pk.ControlQueueSource()
    job = _cp_job(pk, src, ctrl, schema)
    b = pk.MetadataControlEvent.builder()
    bad_id = b.add_execution_plan("this is not siddhi ql at all",
                                  plan_id="bad")
    ctrl.push(b.build())
    _emit(src, 0, 4)
    job.run_cycle()
    assert bad_id not in job.plan_ids
    assert job.control_rejections[bad_id]["rules"] == ["CQL000"]
    rej = job.control_rejections[bad_id]
    return (rej["rules"], rej["source"],
            job.control_status()["counters"]["admission_rejected"])


def cp_service_sustained_load_zero_drops_bounded_latency(pk):
    import time as _t

    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    ctrl = pk.ControlQueueSource()
    job = pk.Job([], [src], batch_size=4096, time_mode="processing",
                 control_sources=[ctrl],
                 plan_compiler=_compiler(pk, schema), retain_results=False)
    svc = pk.QueryControlService(
        ctrl, job=job,
        admission=pk.AdmissionGate(_compiler(pk, schema))).start()
    fed = 0
    cyc = []
    try:
        base = f"http://127.0.0.1:{svc.port}/api/v1"

        def post(path, body=None):
            req = urllib.request.Request(
                f"{base}/{path}",
                data=json.dumps(body).encode() if body else None,
                method="POST")
            with urllib.request.urlopen(req) as resp:
                return json.loads(resp.read())

        def run_cycles(n):
            nonlocal fed
            for _ in range(n):
                _emit(src, fed, fed + 256)
                fed += 256
                t0 = _t.perf_counter()
                job.run_cycle()
                cyc.append(_t.perf_counter() - t0)

        ids = []
        for q in range(6):
            ids.append(post("queries", {
                "cql": _cp_chain(q % 4, (q + 1) % 4), "id": f"q{q}"})["id"])
            run_cycles(3)
        post(f"queries/{ids[0]}/disable")
        run_cycles(3)
        post(f"queries/{ids[0]}/enable")
        req = urllib.request.Request(f"{base}/queries/{ids[1]}",
                                     method="DELETE")
        urllib.request.urlopen(req).read()
        run_cycles(3)
        assert set(job.plan_ids) == set(ids) - {ids[1]}
    finally:
        svc.stop()
    job.drain_outputs()
    assert job.processed_events == fed
    assert job.shed_events == 0 and job.late_dropped == 0
    steady = sorted(cyc)[: int(len(cyc) * 0.5)]
    assert max(steady) < 1.0, steady[-5:]
    st = job.control_status()
    assert st["counters"]["admitted"] == 6
    assert st["counters"]["retired"] == 1
    assert st["counters"]["stack_join"] >= 5
    return (sorted(job.plan_ids), sorted(job._folded.items()),
            {k: st["counters"][k] for k in
             ("admitted", "stack_join", "retired")},
            job.processed_events, job.emitted_counts)


def _mk_batches(pk, schema, n, start):
    ids = (np.arange(n) % 4).astype(np.int64)
    ts = (start + np.arange(n) * 1000).astype(np.int64)
    return pk.EventBatch("S", schema, {
        "id": ids, "price": np.arange(n, dtype=np.float64),
        "timestamp": ts}, ts)


def _cp_timeline(pk):
    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan(_cp_chain(1, 2), plan_id="qa")
    b2 = pk.MetadataControlEvent.builder()
    b2.add_execution_plan(_cp_chain(2, 3), plan_id="qb")
    drop = pk.MetadataControlEvent.builder()
    drop.remove_execution_plan("qa")
    return [
        (0, b.build()),
        (9_500, b2.build()),
        (15_500, pk.OperationControlEvent.disable_query("qb")),
        (20_500, pk.OperationControlEvent.enable_query("qb")),
        (25_500, drop.build()),
    ]


def _cp_run_mode(pk, mode):
    schema = _schema(pk)
    batches = [_mk_batches(pk, schema, 8, s)
               for s in (1000, 9000, 17000, 25000)]
    job = pk.Job([], [pk.BatchSource("S", schema, iter(batches))],
                 batch_size=8, time_mode="event",
                 control_sources=[pk.ControlListSource(_cp_timeline(pk))],
                 plan_compiler=_compiler(pk, schema))
    if mode == "resident":
        pk.ResidentReplay(job).execute()
    else:
        job.run()
    return job


def cp_resident_epoch_control_parity_with_streaming(pk):
    a = _cp_run_mode(pk, "streaming")
    b = _cp_run_mode(pk, "resident")
    rows_a = sorted(a.results_with_ts("out"))
    rows_b = sorted(b.results_with_ts("out"))
    assert rows_a and rows_a == rows_b
    assert a.processed_events == b.processed_events
    st = b.control_status()
    assert st["counters"]["admitted"] == 2
    assert st["counters"]["retired"] == 1
    return rows_b, b.processed_events


def cp_resident_live_control_queue_drains_and_completes(pk):
    schema = _schema(pk)
    src = pk.BatchSource("S", schema, iter([_mk_batches(pk, schema, 8,
                                                        1000)]))
    ctrl = pk.ControlQueueSource()
    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan(_cp_chain(1, 2), plan_id="qy")
    ctrl.push(b.build(), timestamp_ms=0)
    job = pk.Job([], [src], batch_size=8, time_mode="event",
                 control_sources=[ctrl],
                 plan_compiler=_compiler(pk, schema))
    pk.ResidentReplay(job).execute()
    assert job.plan_ids == ["qy"]
    assert job.results("out") == [(2000, 3000), (6000, 7000)]
    return job.results("out")


def cp_checkpoint_mid_admit_applies_exactly_once(pk):
    schema = _schema(pk)

    def build(batches, control):
        return pk.Job([], [pk.BatchSource("S", schema, iter(batches))],
                      batch_size=8, time_mode="event",
                      control_sources=[pk.ControlListSource(control)],
                      plan_compiler=_compiler(pk, schema))

    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan(_cp_chain(1, 2), plan_id="qx")
    src1 = pk.CallbackSource("S", schema)
    job1 = pk.Job([], [src1], batch_size=8, time_mode="event",
                  control_sources=[pk.ControlListSource([(9_500,
                                                           b.build())])],
                  plan_compiler=_compiler(pk, schema))
    for i in range(8):
        src1.emit(Rec(i % 4, float(i), 1000 + i * 1000), 1000 + i * 1000)
    job1.run_cycle()
    assert job1.plan_ids == []
    snap = job1.snapshot()
    assert snap["control_pending"], "admit was not captured pending"
    job2 = build([_mk_batches(pk, schema, 8, 9000)], [])
    job2.restore(snap)
    job2.run()
    assert job2.plan_ids == ["qx"]
    assert len(job2._plans) == 1
    rows = job2.results_with_ts("out")
    assert rows == sorted(set(rows)) and rows
    snap2 = job2.snapshot()
    job3 = build([_mk_batches(pk, schema, 8, 17000)], [])
    job3.restore(snap2)
    job3.run()
    assert job3.plan_ids == ["qx"]
    assert len(job3._plans) == 1
    rows3 = job3.results_with_ts("out")
    assert rows3 == sorted(set(rows3))
    return rows, rows3


def cp_tenant_field_json_round_trip(pk):
    b = pk.MetadataControlEvent.builder()
    pid = b.add_execution_plan(_cp_chain(1, 2), plan_id="fixed-id")
    ev = b.build()
    ev.tenant = "acme"
    ev2 = pk.events.control_event_from_json(
        pk.events.control_event_to_json(ev))
    assert ev2.tenant == "acme"
    assert pid == "fixed-id" and ev2.added_plans == ev.added_plans
    op = pk.OperationControlEvent.disable_query("abc")
    op.tenant = "zorg"
    op2 = pk.events.control_event_from_json(
        pk.events.control_event_to_json(op))
    assert (op2.action, op2.plan_id, op2.tenant) == ("disable", "abc",
                                                     "zorg")
    op3 = pk.events.control_event_from_json(json.dumps(
        {"type": "operation", "action": "enable", "plan_id": "p"}))
    assert op3.tenant is None
    return ev2.tenant, ev2.added_plans, op2.tenant, op3.tenant


# the hostile zoo's unbounded-residency query: plancheck-clean, refused
# under the strict multi-tenant budgets by exactly ADM110
HOSTILE_CQL = (
    "from every s1 = S[id == 1] -> s2 = S[id == 2] "
    "select s1.price as p1, s2.price as p2 insert into out"
)


def _strict(pk):
    if pk is JAX:
        from flink_siddhi_tpu.analysis.admit import STRICT_BUDGETS
    else:
        from flink_siddhi_tpu_torch.analysis.admit import STRICT_BUDGETS
    return STRICT_BUDGETS


def cp_hostile_refused_by_rule_id_rest_and_apply_time(pk):
    import urllib.error

    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    ctrl = pk.ControlQueueSource()
    job = _cp_job(pk, src, ctrl, schema)
    job.admission_budgets = _strict(pk)
    gate = pk.AdmissionGate(_compiler(pk, schema), budgets=_strict(pk))
    svc = pk.QueryControlService(ctrl, job=job, admission=gate).start()
    seen = []
    try:
        base = f"http://127.0.0.1:{svc.port}/api/v1"
        req = urllib.request.Request(
            f"{base}/queries",
            data=json.dumps({"cql": HOSTILE_CQL}).encode(),
            method="POST",
        )
        try:
            urllib.request.urlopen(req)
            raise AssertionError("hostile add returned 2xx")
        except urllib.error.HTTPError as e:
            assert e.code == 422
            body = json.loads(e.read())
            assert body["rules"] == ["ADM110"]
        boundary_id = body["id"]
        assert job.control_rejections[boundary_id]["source"] == "service"
        with urllib.request.urlopen(f"{base}/queries/{boundary_id}") as r:
            status = json.loads(r.read())
        assert status["state"] == "rejected"
        assert status["rules"] == ["ADM110"]
        seen.append((body["rules"], status["state"], status["rules"]))
        req = urllib.request.Request(
            f"{base}/queries",
            data=json.dumps({"cql": _cp_chain(1, 2),
                             "tenant": "acme"}).encode(),
            method="POST",
        )
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 201
            created = json.loads(resp.read())
        assert created["admission"]["admitted"] is True
        assert created["admission"]["signature"]
        _emit(src, 0, 4)
        job.run_cycle()
        assert created["id"] in job.plan_ids
        seen.append((created["admission"]["admitted"],
                     created["admission"]["residency_ms"],
                     created["admission"]["amplification"]))
        b = pk.MetadataControlEvent.builder()
        hostile_id = b.add_execution_plan(HOSTILE_CQL, plan_id="hostile-1")
        ctrl.push(b.build())
        job.run_cycle()
        assert hostile_id not in job.plan_ids
        assert job.control_rejections[hostile_id]["rules"] == ["ADM110"]
        with urllib.request.urlopen(f"{base}/health") as resp:
            health = json.loads(resp.read())
        counters = health["control"]["counters"]
        assert counters["admission_rejected"] >= 1
        assert hostile_id in health["control"]["rejections"]
        with urllib.request.urlopen(f"{base}/queries/{hostile_id}") as r:
            status = json.loads(r.read())
        assert status["state"] == "rejected"
        assert status["rules"] == ["ADM110"]
        seen.append((status["rules"], counters["admission_rejected"],
                     counters.get("preclear")))
    finally:
        svc.stop()
    return seen


def cp_gate_rejects_before_event_ever_pushed(pk):
    ctrl = pk.ControlQueueSource()
    plane = pk.ControlPlane(
        None, ctrl,
        gate=pk.AdmissionGate(_compiler(pk, _schema(pk)),
                              budgets=_strict(pk)))
    with pytest.raises(ControlRejected_of(pk)) as ei:
        plane.admit(HOSTILE_CQL)
    assert ei.value.rules == ["ADM110"]
    assert ctrl.poll(16)[0] == []  # nothing reached the stream
    return ei.value.rules, ei.value.summary["admitted"]


def ControlRejected_of(pk):
    return (j_plane if pk is JAX else t_plane).ControlRejected


CP_CASES = {
    f.__name__[len("cp_"):]: f for f in (
        cp_hostile_refused_by_rule_id_rest_and_apply_time,
        cp_gate_rejects_before_event_ever_pushed,
        cp_admit_stack_join_retire_reclaim_slot,
        cp_unparsable_cql_refused_not_fatal,
        cp_service_sustained_load_zero_drops_bounded_latency,
        cp_resident_epoch_control_parity_with_streaming,
        cp_resident_live_control_queue_drains_and_completes,
        cp_checkpoint_mid_admit_applies_exactly_once,
        cp_tenant_field_json_round_trip,
    )
}


@pytest.mark.parametrize("name", sorted(CP_CASES))
def test_control_plane_matches_the_reference(name):
    _both(CP_CASES[name])


HUGE_WINDOW_CQL = ("from S#window.length(1073741824) select sum(price) as s "
                   "insert into out")


@pytest.mark.parametrize("where", ["rest", "apply_time", "compile"])
def test_state_budget_refuses_a_huge_window_before_any_host_state(
        where, monkeypatch):
    """A 2^30-event window (about 9 GiB of state) is refused by ADM101
    on its meta-tensor footprint: no tier allocates its state on the
    host or steps it first. ``init_state`` on any device but meta fails
    before it allocates, so a regression fails here, not by memory."""
    import resource
    import time
    import urllib.error

    from flink_siddhi_tpu_torch.analysis.admit import (
        DEFAULT_BUDGETS, AdmissionError)
    from flink_siddhi_tpu_torch.compiler.config import EngineConfig
    from flink_siddhi_tpu_torch.compiler.plan import CompiledPlan

    real = CompiledPlan.init_state
    devices = []

    def meta_only(self, device):
        devices.append(torch.device(device).type)
        if torch.device(device).type != "meta":
            raise AssertionError(f"{self.plan_id}: state on {device}")
        return real(self, device)

    monkeypatch.setattr(CompiledPlan, "init_state", meta_only)
    pk = TORCH
    schema = _schema(pk)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.monotonic()
    if where == "compile":
        with pytest.raises(AdmissionError) as ei:
            pk.compile_plan(HUGE_WINDOW_CQL, {"S": schema}, plan_id="huge",
                            config=EngineConfig(
                                admission_budgets=DEFAULT_BUDGETS,
                                verify_plans=True))
        rules = [i.rule for i in ei.value.issues]
    else:
        src = pk.CallbackSource("S", schema)
        ctrl = pk.ControlQueueSource()
        job = _cp_job(pk, src, ctrl, schema)
        job.admission_budgets = DEFAULT_BUDGETS
        if where == "apply_time":
            b = pk.MetadataControlEvent.builder()
            pid = b.add_execution_plan(HUGE_WINDOW_CQL, plan_id="huge")
            ctrl.push(b.build())
            job.run_cycle()
            assert pid not in job.plan_ids
            rules = job.control_rejections[pid]["rules"]
        else:
            gate = pk.AdmissionGate(_compiler(pk, schema),
                                    budgets=DEFAULT_BUDGETS)
            svc = pk.QueryControlService(ctrl, job=job,
                                         admission=gate).start()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{svc.port}/api/v1/queries",
                    data=json.dumps({"cql": HUGE_WINDOW_CQL}).encode(),
                    method="POST",
                )
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req)
                assert ei.value.code == 422
                rules = json.loads(ei.value.read())["rules"]
            finally:
                svc.stop()
    seconds = time.monotonic() - t0
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
    assert rules == ["ADM101"]
    assert devices and set(devices) == {"meta"}
    assert seconds < 10.0
    assert grown_kib < 256 * 1024


def test_ownership_guard_catches_off_thread_mutation(monkeypatch):
    _both(cp_ownership_guard_catches_off_thread_mutation, monkeypatch)


# -- tests/test_app.py:156 and tests/test_replay.py:174 ------------------------

def rest_roundtrip(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    control = pk.ControlQueueSource()
    plan0 = pk.compile_plan("from S[id == 0] select price insert into base",
                            {"S": schema}, plan_id="base")
    job = pk.Job([plan0], [src], batch_size=8, time_mode="processing",
                 control_sources=[control],
                 plan_compiler=_compiler(pk, schema))
    svc = pk.QueryControlService(
        control, job=job,
        validate=lambda cql: pk.compile_plan(cql, {"S": schema})).start()
    seen = []
    try:
        conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=5)

        def call(method, path, body=None):
            conn.request(method, path,
                         body=json.dumps(body) if body else None,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read() or b"{}")

        def feed(lo, hi):
            for i in range(lo, hi):
                src.emit(Rec(i % 2, float(i), 1000 + i), 1000 + i)

        status, resp = call("POST", "/api/v1/queries", {
            "cql": "from S[id == 1] select price insert into ones",
            "id": "q-ones"})
        assert status == 201
        qid = resp["id"]
        seen.append(status)
        feed(0, 8)
        job.run_cycle()
        feed(8, 16)
        job.run_cycle()
        assert qid in job.plan_ids
        ones_so_far = len(job.results("ones"))
        assert ones_so_far > 0
        status, _ = call("POST", f"/api/v1/queries/{qid}/disable")
        assert status == 200
        feed(16, 24)
        job.run_cycle()
        job.run_cycle()
        assert len(job.results("ones")) == ones_so_far
        call("POST", f"/api/v1/queries/{qid}/enable")
        feed(24, 32)
        job.run_cycle()
        job.run_cycle()
        assert len(job.results("ones")) > ones_so_far
        status, resp = call("GET", "/api/v1/queries")
        assert status == 200
        by_id = {q["id"]: q for q in resp["queries"]}
        assert by_id[qid]["enabled"] is True
        assert by_id[qid]["tenant"] == "default"
        assert "folded" in by_id[qid]
        listing = sorted((q["id"], q["enabled"], q["folded"])
                         for q in resp["queries"])
        status, one = call("GET", f"/api/v1/queries/{qid}")
        seen.append((status, one["state"], one["enabled"], one["folded"]))
        status, _ = call("DELETE", f"/api/v1/queries/{qid}")
        assert status == 200
        src.emit(Rec(1, 99.0, 2000), 2000)
        job.run_cycle()
        job.run_cycle()
        assert qid not in job.plan_ids
        status, m = call("GET", "/api/v1/metrics")
        assert status == 200
        assert m["processed_events"] > 0
        assert "ones" in m["emitted"]
        seen.append((m["processed_events"], m["emitted"]))
        status, t = call("GET", "/api/v1/traces")
        assert status == 200 and t["sample_every"] > 0
        status, _ = call("GET", "/api/v1/nope")
        assert status == 404
        status, _ = call("POST", "/api/v1/queries", {})
        assert status == 400
        status, resp = call("POST", "/api/v1/queries",
                            {"cql": "this is not cql"})
        assert status == 400 and "error" in resp
        status, health = call("GET", "/api/v1/health")
        counters = health["control"]["counters"]
        seen.append((status, health["alive"], {
            k: counters.get(k) for k in ("admitted", "stack_join",
                                         "retired", "admission_rejected")
        }))
        b = pk.MetadataControlEvent.builder()
        b.add_execution_plan("nor is this", plan_id="bad")
        control.push(b.build())
        src.emit(Rec(0, 5.0, 3000), 3000)
        before = len(job.results("base"))
        job.run_cycle()
        job.run_cycle()
        assert len(job.results("base")) > before
    finally:
        svc.stop()
    return (seen, listing, job.results("ones"), job.results("base"),
            job.control_rejections["bad"]["rules"])


def test_control_service_rest_roundtrip():
    _both(rest_roundtrip)


def _telemetry_route_body(path, status, ctype, raw):
    """What the telemetry routes answer for a live job (200 and its
    body), and the fleet's drain (501 naming item 13)."""
    if path == "/api/v1/fleet/drain":
        assert status == 501, path
        assert "item 13" in json.loads(raw)["error"], path
        return
    assert status == 200, path
    if path == "/api/v1/metrics/prometheus":
        assert ctype.startswith("text/plain"), ctype
        text = raw.decode("utf-8")
        assert "# TYPE fst_build_info gauge" in text
        assert "fst_processed_events_total 8" in text
        return
    body = json.loads(raw)
    if path == "/api/v1/traces":
        assert body["sample_every"] == 1024 and body["enabled"] is True
        assert body["sampled"] == 1  # ts 1024 of 1020..1027
    elif path == "/api/v1/flightrecorder":
        assert body["seq"] >= 1
        kinds = [e["kind"] for e in body["events"]]
        assert kinds[0] == "control.admit"
        assert body["events"][0]["plan"] == "q1"
    elif path == "/api/v1/slo":
        assert body["policies"] == 0 and body["reconciled"] is True


def test_service_later_routes_answer_501_naming_their_item():
    """The one route still to come, the fleet's drain, answers 501
    naming its ROADMAP item."""
    ctrl = TORCH.ControlQueueSource()
    svc = TORCH.QueryControlService(ctrl).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=5)
        conn.request("POST", "/api/v1/fleet/drain")
        r = conn.getresponse()
        body = json.loads(r.read())
        assert r.status == 501
        assert "item 13" in body["error"]
    finally:
        svc.stop()


@pytest.mark.parametrize("method,path", [
    ("GET", "/api/v1/metrics/prometheus"),
    ("GET", "/api/v1/traces"),
    ("GET", "/api/v1/flightrecorder"),
    ("GET", "/api/v1/slo"),
])
def test_telemetry_routes_answer_200_with_their_bodies(method, path):
    """The four telemetry routes answer 200 with their bodies over a
    live job."""
    schema = _schema(TORCH)
    src = TORCH.CallbackSource("S", schema)
    ctrl = TORCH.ControlQueueSource()
    job = TORCH.Job([], [src], batch_size=8, time_mode="processing",
                    control_sources=[ctrl],
                    plan_compiler=_compiler(TORCH, schema))
    TORCH.ControlPlane(job, ctrl).admit(
        "from S[id == 1] select price insert into ones", plan_id="q1")
    for i in range(8):
        src.emit(Rec(i % 2, float(i), 1020 + i), 1020 + i)
    job.run_cycle()
    job.drain_outputs()
    svc = TORCH.QueryControlService(ctrl, job=job).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=5)
        conn.request(method, path)
        r = conn.getresponse()
        _telemetry_route_body(path, r.status,
                              r.getheader("Content-Type", ""), r.read())
    finally:
        svc.stop()


def test_resident_control_streams_contract():
    for pk in BOTH:
        schema = pk.StreamSchema([("id", pk.AttributeType.INT),
                                  ("timestamp", pk.AttributeType.LONG)])
        plan = pk.compile_plan(
            "from inputStream[id == 1] select id insert into out",
            {"inputStream": schema})
        job = pk.Job([plan], [pk.BatchSource("inputStream", schema,
                                             iter([]))],
                     control_sources=[pk.ControlListSource([])])
        pk.ResidentReplay(job).execute()
        assert job.finished
        if pk is JAX:
            with pytest.raises(ValueError, match="epoch") as ei:
                j_replay.ShardedResidentReplay(JAX.Job(
                    [plan], [], control_sources=[JAX.ControlListSource([])]))
            msg = str(ei.value)
            assert "streaming" in msg and "control_plane" in msg
    with pytest.raises(NotImplementedError, match="item 11"):
        t_replay.ShardedResidentReplay(TORCH.Job(
            [], [], control_sources=[TORCH.ControlListSource([])]))


class _StuckControl:
    """A live control source that never finishes and never advances its
    watermark."""

    def poll(self, max_events):
        return [], 0, False


def test_unbounded_control_in_a_resident_replay_raises():
    # control that never finishes holds the watermark: the bounded
    # replay refuses it with the reference's message instead of spinning
    for pk in BOTH:
        schema = _schema(pk)
        batches = [_mk_batches(pk, schema, 8, 1000)]
        job = pk.Job([], [pk.BatchSource("S", schema, iter(batches))],
                     batch_size=8, time_mode="event",
                     control_sources=[_StuckControl()],
                     plan_compiler=_compiler(pk, schema))
        with pytest.raises(RuntimeError, match="un-closed "
                                               "ControlQueueSource"):
            pk.ResidentReplay(job).stage()


# -- DynamicChainGroup.step against the reference's ---------------------------

_OPS = ("==", "!=", "<", "<=", ">", ">=")


def _random_member(rng, i):
    a, b = rng.integers(0, 6, 2)
    op1, op2 = rng.choice(_OPS, 2)
    within = int(rng.integers(1, 8)) * 50
    return (f"from every s1 = S[id {op1} {a}] -> s2 = S[price {op2} "
            f"{float(b * 10)}] -> s3 = S[id == {int(rng.integers(0, 6))}] "
            f"within {within} milliseconds "
            f"select s1.timestamp as t1, s3.timestamp as t3, "
            f"s2.price as p insert into o{i}")


def _group_of(pk, cqls):
    schema = _schema(pk)
    job = pk.Job([], [], plan_compiler=_compiler(pk, schema))
    for i, cql in enumerate(cqls):
        job.add_plan(pk.compile_plan(cql, {"S": schema}, plan_id=f"m{i}"),
                     dynamic=True, cql=cql)
    (rt,) = job._plans.values()
    return rt, rt.plan.artifacts[0]


def _columns(rng, n, t0):
    return {
        "id": rng.integers(0, 6, n).astype(np.int32),
        "price": np.round(rng.random(n) * 60, 1),
        "timestamp": (t0 + np.cumsum(rng.integers(0, 40, n))).astype(
            np.int64),
    }


@pytest.mark.parametrize("seed", [3, 11])
def test_group_step_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    cqls = [_random_member(rng, i) for i in range(5)]
    j_rt, j_group = _group_of(JAX, cqls)
    t_rt, t_group = _group_of(TORCH, cqls)
    assert [m and m[0] for m in t_group.members] == \
        [m and m[0] for m in j_group.members]
    jst = j_rt.states[j_group.name]
    tst = t_rt.states[t_group.name]
    for k in jst:
        assert np.array_equal(np.asarray(jst[k]), tst[k].numpy()), k
    t0 = 1000
    for step in range(3):
        cols = _columns(rng, 512, t0)
        t0 = int(cols["timestamp"][-1]) + 1
        jtape, _ = j_build_tape(
            j_rt.plan.spec,
            [JBatch("S", _schema(JAX), cols, cols["timestamp"])], 1000)
        ttape = t_build_tape(
            t_rt.plan.spec,
            [tfst.EventBatch("S", _schema(TORCH), cols, cols["timestamp"])],
            1000).to(torch.device("cpu"))
        jst, (jn, jblock, jover) = j_group.step(jst, jtape)
        tst, (tn, tblock, tover) = t_group.step(tst, ttape)
        assert int(tn) == int(jn) and int(tover) == int(jover)
        assert int(jn) > 0 or step == 0
        n = int(jn)
        assert np.array_equal(np.asarray(jblock)[:, :n],
                              tblock.numpy()[:, :n])
        assert tblock.shape == np.asarray(jblock).shape
        for k in jst:
            assert np.array_equal(np.asarray(jst[k]), tst[k].numpy()), k
        got = t_group.decode_packed(n, tblock.numpy()[:, :n])
        want = j_group.decode_packed(n, np.asarray(jblock)[:, :n])
        assert [(s.stream_id, r) for s, r in got] == \
            [(s.stream_id, r) for s, r in want]


def test_template_conjuncts_match_the_reference():
    # the port's _template_conjuncts (shared with the stacks) against the
    # reference's, over the parametric family and its refusals
    filters = [
        "id == 2", "id != 2", "5 < id", "id >= 1 and id < 4",
        "price > 2.5", "price == 3", "id == 5.5", "id == 5.0",
        "id > 1 and id < 4 and id != 2", "id + 1 == 2", "price > id",
        "name == 'a'", "name != 'b' and id == 1",
    ]
    for f in filters:
        cql = (f"from every s1 = S[{f}] -> s2 = S[id == 1] "
               "select s1.timestamp as t insert into o")
        got = []
        for pk, mod in ((JAX, j_nfa), (TORCH, t_nfa)):
            schema = pk.StreamSchema([
                ("id", pk.AttributeType.INT),
                ("price", pk.AttributeType.DOUBLE),
                ("name", pk.AttributeType.STRING),
                ("timestamp", pk.AttributeType.LONG),
            ])
            plan = pk.compile_plan(cql, {"S": schema})
            art = plan.artifacts[0]
            conj = mod._template_conjuncts(art.spec.elements[0],
                                           plan.spec.column_types)
            tpl = mod.chain_template_of(art, plan.spec.column_types)
            got.append((conj, tpl is None, tpl and tpl[1:]))
        assert got[1] == got[0], f


# -- one K1 and one K2 call per group step ------------------------------------

@pytest.fixture
def kernel_calls(monkeypatch):
    """Spy on the chain core's two kernels (their CPU plain versions)."""
    calls = {"k1": [], "k2": []}
    k1, k2 = t_nfa.multi_reverse_cummin, t_nfa.chain_advance

    def spy_k1(x, pad=None):
        calls["k1"].append(tuple(x.shape))
        return k1(x, pad)

    def spy_k2(nxt, pos_rows, guard_rows, ts_pad, act, *rest):
        calls["k2"].append(tuple(act.shape))
        return k2(nxt, pos_rows, guard_rows, ts_pad, act, *rest)

    monkeypatch.setattr(t_nfa, "multi_reverse_cummin", spy_k1)
    monkeypatch.setattr(t_nfa, "chain_advance", spy_k2)
    return calls


@pytest.mark.parametrize("members", [1, 8])
def test_group_step_calls_each_kernel_once(kernel_calls, members):
    schema = _schema(TORCH)
    src = TORCH.CallbackSource("S", schema)
    job = _group_job(TORCH, src, schema)
    for q in range(members):
        cql = (f"from every s1 = S[id == {q % 4}] -> s2 = S[id == "
               f"{(q + 1) % 4}] -> s3 = S[price >= {float(q)}] "
               f"within 5 sec select s1.timestamp as t1, s3.timestamp "
               f"as t3 insert into o{q}")
        job.add_plan(TORCH.compile_plan(cql, {"S": schema},
                                        plan_id=f"q{q}"), dynamic=True)
    assert len(job._plans) == 1
    keys = job.graph_keys
    kernel_calls["k1"].clear()
    kernel_calls["k2"].clear()
    steps = 6
    for c in range(steps):
        _emit(src, 64 * c, 64 * (c + 1))
        job.run_cycle()
    job.drain_outputs()
    (rt,) = job._plans.values()
    group = rt.plan.artifacts[0]
    # the padded group's width whatever the live count: Q x (K-1) rows
    # of 64 events, Q queries over P + E candidates
    Q, P = group.capacity, group.pool
    E = kernel_calls["k1"][0][1]
    assert E >= 64
    assert kernel_calls["k1"] == [(Q * 2, E)] * steps
    assert kernel_calls["k2"] == [(Q, P + E)] * steps
    assert job.graph_keys >= keys
    assert sum(len(job.results(f"o{q}")) for q in range(members)) > 0


def test_fold_evict_enable_keep_the_graph_binding():
    """A fold, an evict and an enable are data writes into the tensors the
    segment graphs are bound to: the binding and its keys stay."""
    schema = _schema(TORCH)
    src = TORCH.CallbackSource("S", schema)
    job = _group_job(TORCH, src, schema)
    job.add_plan(TORCH.compile_plan(_chain_cql("a", 1, 2), {"S": schema},
                                    plan_id="a"), dynamic=True)
    _emit(src, 0, 64)
    job.run_cycle()
    job.drain_outputs()
    (rt,) = job._plans.values()
    bound = rt.graphs._bound_flat
    keys = job.graph_keys
    tensors = [t for _, t in bound]
    for act in (
        lambda: job.add_plan(TORCH.compile_plan(
            _chain_cql("b", 2, 3), {"S": schema}, plan_id="b"),
            dynamic=True),
        lambda: job.set_plan_enabled("a", False),
        lambda: job.set_plan_enabled("a", True),
        lambda: job.remove_plan("b"),
    ):
        act()
        _emit(src, 0, 64)
        job.run_cycle()
        job.drain_outputs()
        assert rt.graphs._bound_flat is bound
        assert [t for _, t in rt.graphs._bound_flat] == tensors
        assert job.graph_keys == keys


# -- the asynchronous drain: retire, then admit into the same slot ------------

def _attribution(pk):
    schema = _schema(pk)
    src = pk.CallbackSource("S", schema)
    ctrl = pk.ControlQueueSource()
    job = pk.Job([], [src], batch_size=64, time_mode="processing",
                 control_sources=[ctrl],
                 plan_compiler=_compiler(pk, schema))
    job.drain_interval_ms = 60_000.0  # no interval drain in between
    _fused(pk, job)
    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan(_cp_chain(1, 2, out="oa"), plan_id="qa")
    b.add_execution_plan(_cp_chain(2, 3, out="ob"), plan_id="qb")
    ctrl.push(b.build())
    _emit(src, 0, 16)
    job.run_cycle()
    _emit(src, 16, 32)
    job.run_cycle()
    if pk is TORCH:
        # a drain queued, not completed, with qa's rows in it
        (rt,) = job._plans.values()
        job._dispatch_segment(rt)
        job._drain_request(rt)
        assert rt.drain_q
    drop = pk.MetadataControlEvent.builder()
    drop.remove_execution_plan("qa")
    ctrl.push(drop.build())
    add = pk.MetadataControlEvent.builder()
    add.add_execution_plan(_cp_chain(3, 0, out="oc"), plan_id="qc")
    ctrl.push(add.build())
    _emit(src, 32, 48)
    job.run_cycle()
    out = {s: job.results(s) for s in ("oa", "ob", "oc")}
    assert dict(job._folded)["qc"][1] == 0  # qa's slot, reclaimed
    assert out["oa"] == [(1001, 1002), (1005, 1006), (1009, 1010),
                         (1013, 1014), (1017, 1018), (1021, 1022),
                         (1025, 1026), (1029, 1030)]
    assert out["oc"] and all(t1 >= 1032 for t1, _ in out["oc"])
    return out, sorted(job._folded.items())


def test_retire_then_admit_into_the_slot_attributes_each_row():
    _both(_attribution)


@pytest.mark.parametrize("event", ["retire", "disable", "admit"])
def test_device_failure_at_a_control_boundary_stops_the_run(event):
    """A bad control event is logged and the loop goes on; a failure of
    the device work a mutation does (the blocking drain of a retire, the
    dispatch before an enable or a fold) stops the run, so that staged
    tapes are never dropped behind a log line."""
    schema = _schema(TORCH)
    src = TORCH.CallbackSource("S", schema)
    ctrl = TORCH.ControlQueueSource()
    job = _group_job(TORCH, src, schema, ctrl)
    b = TORCH.MetadataControlEvent.builder()
    b.add_execution_plan(_cp_chain(1, 2, out="oa"), plan_id="qa")
    ctrl.push(b.build())
    ctrl.push(object(), 0)  # not a control event: logged, the loop goes on
    _emit(src, 0, 16)
    job.run_cycle()
    assert job.plan_ids == ["qa"]
    assert job.results("oa") == [(1001, 1002), (1005, 1006), (1009, 1010),
                                 (1013, 1014)]

    def fail(rt):
        raise RuntimeError("the device is lost")

    job._drain_plan = job._dispatch_segment = fail
    if event == "retire":
        ev = TORCH.MetadataControlEvent.builder()
        ev.remove_execution_plan("qa")
        ev = ev.build()
    elif event == "disable":
        ev = TORCH.OperationControlEvent.disable_query("qa")
    else:
        ev = TORCH.MetadataControlEvent.builder()
        ev.add_execution_plan(_cp_chain(2, 3, out="ob"), plan_id="qb")
        ev = ev.build()
    ctrl.push(ev)
    _emit(src, 16, 32)
    with pytest.raises(RuntimeError, match="the device is lost"):
        job.run_cycle()


# -- what waits for later items ----------------------------------------------

def test_later_items_refuse_naming_their_item():
    job = TORCH.Job([], [])
    st = job.control_status()
    # the executable cache waits for the graph cache keyed by
    # plan_signature
    assert "aot_cache" not in st
    assert st["shared"] == {}


def test_control_events_module_is_exported_like_the_reference():
    for name in ("MetadataControlEvent", "OperationControlEvent",
                 "ControlEvent", "CONTROL_STREAM", "ControlPlane",
                 "ControlRejected", "AdmissionGate"):
        assert hasattr(tfst, name) and hasattr(jfst, name), name
    assert tfst.MetadataControlEvent is t_events.MetadataControlEvent
    assert tfst.CONTROL_STREAM == jfst.CONTROL_STREAM
