"""The port's flight recorder (``telemetry/flightrec.py``, an exact copy of
the reference's) wired through its Job, checkpoint, supervisor, Kafka sink
and REST service, on the CPU, held to the JAX package's.

The reference's cases of ``tests/test_flightrec.py`` on the port: rate
collapse, the disabled registry, the state round trip, the leg cover of
``attribution.py`` over the port's ``TOP_LEVEL_STAGES``, the journal
exactly once under supervised kill -> restore -> kill -> restore, the
crash dump on an exhausted restart budget (the supervisor is an exact copy
whose journal paths now run), and the filterable
``GET /api/v1/flightrecorder`` route. Beside them:

* the journal's (kind, plan, tenant, collapsed) sequence over the
  reference's control timelines equals the JAX package's, in streaming,
  fused and resident modes and under subplan sharing. The reference's
  ``aotcache.*`` and ``compile.xla`` entries are left out of the
  comparison (the port has no executable cache yet, ROADMAP.md Queue 1
  item 10, and lowers nothing: its compile entries are CUDA graph
  captures and kernel builds, none of which happens on the CPU);
* a checkpoint with a journal moves both ways between the packages: the
  restored journal holds every entry of the writer's at the save once,
  and the restore extends it with the next seq;
* ``add_sink`` binds a ``KafkaSink``'s transaction journal.

Every comparison is exact; no test bounds a wall clock.
"""

import json
import urllib.error
import urllib.request

import pytest

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime import kafka as jax_kafka
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import ListSource as JaxListSource
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.runtime import kafka as port_kafka
from flink_siddhi_tpu_torch.runtime.faultinject import CrashPlan, wrap_job
from flink_siddhi_tpu_torch.runtime.sources import ListSource
from flink_siddhi_tpu_torch.runtime.supervisor import (
    RestartBudgetExceeded,
    Supervisor,
)
from flink_siddhi_tpu_torch.telemetry import (
    TOP_LEVEL_STAGES,
    FlightRecorder,
    MetricsRegistry,
    attribution,
)

from tests import fake_kafka as jax_broker
from tests import torch_fake_kafka as port_broker
from tests.torch_telemetry_common import (
    JAX,
    MODES,
    TORCH,
    Rec,
    chain_cql,
    compiler,
    journal,
    schema,
    timeline_job,
)

FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
          ("timestamp", "long")]
CQL = ("from S#window.length(6) select id, sum(price) as t, "
       "count() as c insert into out")


def _record_tuples(n):
    return [((i % 4), f"n{i % 3}", float(i), 1000 + 10 * i)
            for i in range(n)]


# -- unit: ring, collapse, checkpoint state ---------------------------------

def test_rate_collapse_bounds_journal_under_burst():
    fr = FlightRecorder(capacity=64)
    for _ in range(500):
        fr.record("fault.shed", events=10)
    evs = fr.events(kind="fault.shed")
    assert len(evs) == 1
    assert evs[0]["events"] == 5000
    assert evs[0]["collapsed"] == 499
    assert evs[0]["t_last"] >= evs[0]["t_mono"]
    fr.record("control.admit", plan="q1")
    fr.record("control.admit", plan="q1")
    assert len(fr.events(kind="control.admit")) == 2
    assert fr.counts_by_kind()["fault.shed"] == 500
    assert fr.events(limit=0) == []
    assert len(fr.events(limit=1)) == 1


def test_disabled_registry_silences_recorder():
    reg = MetricsRegistry(enabled=False)
    fr = FlightRecorder(registry=reg)
    assert fr.record("control.admit", plan="q") is None
    assert fr.events() == [] and fr.seq == 0
    reg.enabled = True
    assert fr.record("control.admit", plan="q") == 1


def test_state_roundtrip_continues_sequence():
    fr = FlightRecorder()
    for i in range(5):
        fr.record("checkpoint.save", path=f"p{i}")
    state = fr.state_dict()
    fr.record("fault.crash")
    fr2 = FlightRecorder()
    fr2.record("noise.before.restore")
    fr2.restore_state(state)
    assert [e["kind"] for e in fr2.events()] == ["checkpoint.save"] * 5
    assert fr2.record("supervisor.restart") == 6
    assert [e["seq"] for e in fr2.events(since_seq=4)] == [5, 6]
    assert len(fr2.events(kind="supervisor")) == 1
    assert [e["seq"] for e in fr2.events(limit=2)] == [5, 6]
    assert [e["seq"] for e in fr2.events(since_seq=1, limit=2)] == [2, 3]


def test_attribution_cover_is_exhaustive_and_disjoint():
    """The port's TOP_LEVEL_STAGES is the reference's whole tuple, so the
    leg cover's import-time check holds; stages the port never records
    stay at zero."""
    from flink_siddhi_tpu.telemetry import TOP_LEVEL_STAGES as REF

    assert TOP_LEVEL_STAGES == REF
    mapped = [s for stages in attribution.LEG_STAGES.values()
              for s in stages]
    assert sorted(mapped) == sorted(set(mapped))
    assert set(mapped) == set(TOP_LEVEL_STAGES)
    att = attribution.limiting_leg(
        {"ingest": {"seconds": 1.0, "count": 1},
         "dispatch": {"seconds": 7.0, "count": 9},
         "drain": {"seconds": 1.5, "count": 4}},
        elapsed_s=10.0,
    )
    assert att["limiting_leg"] == "dispatch"
    assert att["coverage"] == pytest.approx(0.95, abs=0.01)
    assert att["legs"]["decode"]["overlapped"] is True
    att = attribution.limiting_leg(
        {"plan_compile": {"seconds": 8.0, "count": 1},
         "ingest": {"seconds": 1.4, "count": 1},
         "dispatch": {"seconds": 0.6, "count": 9}},
        elapsed_s=10.0,
    )
    assert att["limiting_leg"] == "host_staging"
    assert att["legs"]["setup"]["share"] == pytest.approx(0.8)


# -- the journal against the reference's -------------------------------------

@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_journal_matches_the_reference(mode, share):
    got = journal(timeline_job(TORCH, mode, share=share))
    ref = journal(timeline_job(JAX, mode, share=share))
    assert got == ref
    kinds = {k for k, *_ in got}
    assert "control.admit" in kinds and "control.retire" in kinds
    if share:
        assert "control.subplan_share" in kinds
    else:
        assert {"control.disable", "control.enable"} <= kinds


# -- exactly once under supervised kill/restore ------------------------------

def _supervised(tmp_path, crash, n, **kw):
    schema_ = fpt.StreamSchema(list(FIELDS))

    def factory():
        src = ListSource("S", schema_, _record_tuples(n),
                         ts_field="timestamp", chunk=16)
        plan = fpt.compile_plan(CQL, {"S": schema_})
        job = fpt.Job([plan], [src], batch_size=16, retain_results=False,
                      device="cpu")
        return wrap_job(job, crash)

    return Supervisor(factory, str(tmp_path / "ckpt"), **kw)


def test_journal_survives_double_kill_restore_exactly_once(tmp_path):
    crash = CrashPlan(at_pulls=(2, 5))
    sup = _supervised(tmp_path, crash, 60, checkpoint_every_cycles=1,
                      keep_checkpoints=3, max_restarts=5,
                      restart_window_s=3600.0)
    job = sup.run()
    assert crash.crashes == 2 and sup.restart_count == 2
    evs = job.flightrec.events()
    seqs = [e["seq"] for e in evs]
    assert seqs == sorted(seqs) and len(seqs) == len(set(seqs))
    restarts = [e for e in evs if e["kind"] == "supervisor.restart"]
    assert [r["restart"] for r in restarts] == [1, 2]
    assert all("InjectedCrash" in r["cause"] for r in restarts)
    assert all(r["restore_ms"] > 0 for r in restarts)
    restores = [e for e in evs if e["kind"] == "checkpoint.restore"]
    assert len(restores) == 2
    saves = [e for e in evs if e["kind"] == "checkpoint.save"]
    assert len(saves) >= 2
    assert len({e["seq"] for e in saves}) == len(saves)
    assert restores[0]["seq"] < restarts[0]["seq"] < restores[1]["seq"]
    h = sup.health()
    lr = h["last_restart"]
    assert "InjectedCrash" in lr["cause"] and lr["restart"] == 2
    assert lr["flightrec_seq"] == restarts[1]["seq"]
    assert h["crash_dump_path"] is None


def test_crash_dump_written_on_restart_budget_exhaustion(tmp_path):
    crash = CrashPlan(at_pulls=tuple(range(1, 50)))
    sup = _supervised(tmp_path, crash, 20, max_restarts=2,
                      restart_window_s=3600.0)
    with pytest.raises(RestartBudgetExceeded):
        sup.run()
    dump_path = sup.crash_dump_path
    assert dump_path == str(tmp_path / "ckpt") + ".flightdump.json"
    with open(dump_path) as f:
        doc = json.load(f)
    assert doc["header"]["reason"] == "restart budget exhausted"
    assert "InjectedCrash" in doc["header"]["cause"]
    assert "supervisor.budget_exhausted" in [e["kind"]
                                             for e in doc["events"]]
    assert sup.health()["crash_dump_path"] == dump_path


# -- a checkpoint's journal, both ways ---------------------------------------

_CKPT_PKGS = {
    "torch": (fpt.StreamSchema, ListSource, fpt.compile_plan,
              lambda plans, srcs: fpt.Job(plans, srcs, batch_size=16,
                                          device="cpu")),
    "jax": (JaxSchema, JaxListSource, jax_compile,
            lambda plans, srcs: JaxJob(plans, srcs, batch_size=16)),
}


def _ckpt_job(pkg, n):
    Schema, Source, compile_plan, Job = _CKPT_PKGS[pkg]
    schema_ = Schema(list(FIELDS))
    src = Source("S", schema_, _record_tuples(n), ts_field="timestamp",
                 chunk=16)
    return Job([compile_plan(CQL, {"S": schema_})], [src])


def _entries(job):
    return [(e["seq"], e["kind"], e.get("plan"), e.get("tenant"))
            for e in job.flightrec.events()]


@pytest.mark.parametrize("writer,reader",
                         [("jax", "torch"), ("torch", "jax")])
def test_checkpoint_journal_moves_both_ways(tmp_path, writer, reader):
    """A file written by either package restores its journal in the other
    exactly once: the writer's entries at the save (its checkpoint.save
    included), then the reader's checkpoint.restore with the next seq."""
    src_job = _ckpt_job(writer, 64)
    src_job.run(max_cycles=2)
    src_job.flightrec.record("fault.late", events=3, stream="S")
    path = str(tmp_path / "ck")
    src_job.save_checkpoint(path)
    at_save = _entries(src_job)
    assert at_save[-1][1] == "checkpoint.save"
    # entries after the save are not in the file
    src_job.flightrec.record("control.reject", plan="late")
    dst = _ckpt_job(reader, 64)
    dst.flightrec.record("noise.before.restore")
    dst.restore(path)
    got = _entries(dst)
    assert got[:-1] == at_save
    assert got[-1][:2] == (at_save[-1][0] + 1, "checkpoint.restore")
    assert len({s for s, *_ in got}) == len(got)
    # the restored job goes on journaling from there
    dst.run()
    assert dst.flightrec.seq >= got[-1][0]


# -- the Kafka sink's transactions -------------------------------------------

def _txn_kinds(kafka, broker_mod, job_of):
    broker = broker_mod.FakeBroker()
    try:
        broker.create_topic("o")
        job = job_of()
        sink = kafka.KafkaSink(broker.bootstrap, "o", ["id", "t", "c"],
                               transactional_id="tx", flush_every=8)
        job.add_sink("out", sink)
        job.run()
        job.drain_outputs()
        sink.prepare_commit()
        sink.commit_transaction()
        return [(e["kind"], e.get("plan")) for e in job.flightrec.events()
                if e["kind"].startswith("txn.")]
    finally:
        broker.close()


def test_add_sink_binds_the_kafka_sinks_transaction_journal():
    """``add_sink`` binds a sink's flight recorder: the KafkaSink (an
    exact copy) journals its transaction lifecycle into the Job's, as the
    reference's does."""
    def job_of(pkg):
        def make():
            Schema, Source, compile_plan, Job = _CKPT_PKGS[pkg]
            schema_ = Schema(list(FIELDS))
            src = Source("S", schema_, _record_tuples(32),
                         ts_field="timestamp")
            return Job([compile_plan(CQL, {"S": schema_})], [src])
        return make

    got = _txn_kinds(port_kafka, port_broker, job_of("torch"))
    ref = _txn_kinds(jax_kafka, jax_broker, job_of("jax"))
    assert got == ref
    assert ("txn.commit", "o") in got


# -- the REST surface + the live journal -------------------------------------

def test_flightrecorder_route_filters_and_live_journal():
    """One control-plane session journaled end to end, read back over
    GET /api/v1/flightrecorder with kind/plan/since_seq filters; the
    metrics() surface carries the summary and the live limiting leg."""
    sch = schema(TORCH)
    src = TORCH.CallbackSource("S", sch)
    ctrl = TORCH.ControlQueueSource()
    job = TORCH.Job([], [src], batch_size=64, time_mode="processing",
                    control_sources=[ctrl], plan_compiler=compiler(TORCH))
    plane = TORCH.ControlPlane(job, ctrl)
    plane.admit(chain_cql(1, 2), plan_id="q1", tenant="acme")
    for i in range(8):
        src.emit(Rec(i % 4, float(i), 1000 + i), 1000 + i)
    job.run_cycle()
    plane.admit(chain_cql(2, 3), plan_id="q2")  # stack join
    job.run_cycle()
    plane.set_enabled("q2", False)
    job.run_cycle()
    plane.retire("q1")
    job.run_cycle()
    job.drain_outputs()

    evs = job.flightrec.events()
    kinds = [e["kind"] for e in evs]
    assert kinds.count("control.admit") == 2
    assert "control.disable" in kinds and "control.retire" in kinds
    admits = job.flightrec.events(kind="control.admit")
    assert admits[0]["plan"] == "q1" and admits[0]["tenant"] == "acme"
    assert admits[1]["stack_join"] is True

    m = job.metrics()
    assert m["flight_recorder"]["seq"] == evs[-1]["seq"]
    assert m["flight_recorder"]["by_kind"]["control.admit"] == 2
    att = m["attribution"]
    assert att["limiting_leg"] in attribution.CANDIDATE_LEGS
    assert att["coverage"] == pytest.approx(1.0)
    # nothing is captured or built on the CPU
    assert m["compiles"]["total_lowerings"] == 0

    svc = TORCH.QueryControlService(ctrl, job=job).start()
    try:
        base = f"http://127.0.0.1:{svc.port}/api/v1/flightrecorder"
        with urllib.request.urlopen(base) as resp:
            doc = json.loads(resp.read())
        assert doc["seq"] == evs[-1]["seq"]
        assert [e["seq"] for e in doc["events"]] == [e["seq"] for e in evs]
        with urllib.request.urlopen(f"{base}?kind=control&plan=q1") as r:
            q1 = json.loads(r.read())["events"]
        assert q1 and all(e["kind"].startswith("control")
                          and e["plan"] == "q1" for e in q1)
        cursor = evs[len(evs) // 2]["seq"]
        with urllib.request.urlopen(f"{base}?since_seq={cursor}&limit=3") \
                as r:
            tail = json.loads(r.read())["events"]
        assert all(e["seq"] > cursor for e in tail) and len(tail) <= 3
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}?since_seq=oops")
        assert ei.value.code == 400
    finally:
        svc.stop()


def _event_time_case(p):
    sch = schema(p)
    src = p.CallbackSource("S", sch)
    idle = p.CallbackSource("I", sch)
    plan = p.compile_plan("from S[id == 1] select price insert into o",
                          {"S": sch}, plan_id="only")
    job = p.Job([plan], [src, idle], batch_size=8)
    job.idle_timeout_ms = 0
    for ts in (1000, 2000, 3000):
        src.emit(Rec(1, 1.0, ts), ts)
    src.advance_watermark(2500)
    job.run_cycle()
    job.run_cycle()
    src.emit(Rec(1, 2.0, 500), 500)  # late: below the released 2500
    src.advance_watermark(2600)
    job.run_cycle()
    idle.emit(Rec(1, 3.0, 4000), 4000)  # the idle source un-idles
    job.run_cycle()
    return (
        [(e["kind"], e.get("plan"), e.get("stream"), e.get("events"))
         for e in job.flightrec.events()
         if e["kind"].startswith(("fault.", "watermark."))],
        job.telemetry.scope_map("plan")["only"].counter_value(
            "late_events"),
    )


def test_event_time_faults_journal_like_the_reference():
    """The event-time sites journal as the reference's: late rows
    (``fault.late``, counted to the one plan consuming the stream), an
    idle source (``watermark.idle`` / ``watermark.unidle``) and the
    gate's stalls. Both packages give the same sequence."""
    got = _event_time_case(TORCH)
    assert got == _event_time_case(JAX)
    kinds = [k for k, *_ in got[0]]
    assert "fault.late" in kinds and "watermark.idle" in kinds
    assert got[1] == 1
