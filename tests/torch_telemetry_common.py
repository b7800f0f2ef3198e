"""Shared harness of the port's telemetry tests (``test_torch_flightrec``,
``test_torch_tracing``, ``test_torch_slo``, ``test_torch_scoped_metrics``,
``test_torch_prober``): each package as one namespace, the reference's
control timelines on seeded input, and the reference suite's standalone
Prometheus text checker (``tests/test_scoped_metrics.py``), whose port-side
copy lives in ``chip_smoke.py``.

The same timeline runs on the JAX package's ``Job`` and on the port's
(``device="cpu"``) in streaming, fused and resident modes; the tests hold
per-plan attribution, tenant rollups, journal sequences, tracer counts and
exposition series equal between them. What the port does not have yet is
left out of a comparison, and each test says which: the reference's
executable cache (its ``aotcache.*`` journal entries and its tenants'
``cache_hits`` / ``cache_misses``, ROADMAP.md Queue 1 item 10) and its
XLA lowerings (``compile.xla``; the port's compile events are CUDA graph
captures and kernel builds, none of which happens on the CPU).
"""

import functools
import types

import numpy as np
import torch

# the reference suite's standalone Prometheus text checker: the port's one
# copy is chip_smoke.py's (phase 8k checks the card's exposition with it,
# and chip_smoke.py imports no JAX)
from chip_smoke import LABEL_RE, _SAMPLE_RE, check_prometheus_text  # noqa: F401
from flink_siddhi_tpu.app import service as j_service
from flink_siddhi_tpu.compiler.plan import compile_plan as j_compile
from flink_siddhi_tpu.control import events as j_events
from flink_siddhi_tpu.control import plane as j_plane
from flink_siddhi_tpu.runtime import executor as j_executor
from flink_siddhi_tpu.runtime import replay as j_replay
from flink_siddhi_tpu.runtime import sources as j_sources
from flink_siddhi_tpu.schema.batch import EventBatch as JBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JSchema
from flink_siddhi_tpu.schema.types import AttributeType as JType
from flink_siddhi_tpu import telemetry as j_telemetry
from flink_siddhi_tpu.telemetry import openmetrics as j_openmetrics
from flink_siddhi_tpu.telemetry import slo as j_slo

import flink_siddhi_tpu_torch as tfst
from flink_siddhi_tpu_torch.app import service as t_service
from flink_siddhi_tpu_torch.compiler.plan import compile_plan as t_compile
from flink_siddhi_tpu_torch.control import events as t_events
from flink_siddhi_tpu_torch.control import plane as t_plane
from flink_siddhi_tpu_torch.runtime import executor as t_executor
from flink_siddhi_tpu_torch.runtime import replay as t_replay
from flink_siddhi_tpu_torch.runtime import sources as t_sources
from flink_siddhi_tpu_torch import telemetry as t_telemetry
from flink_siddhi_tpu_torch.telemetry import openmetrics as t_openmetrics
from flink_siddhi_tpu_torch.telemetry import slo as t_slo

torch.set_num_threads(2)

JAX = types.SimpleNamespace(
    name="jax", Job=j_executor.Job, compile_plan=j_compile,
    StreamSchema=JSchema, AttributeType=JType, EventBatch=JBatch,
    BatchSource=j_sources.BatchSource,
    CallbackSource=j_sources.CallbackSource,
    ControlListSource=j_sources.ControlListSource,
    ListSource=j_sources.ListSource,
    SocketLineSource=j_sources.SocketLineSource,
    ControlQueueSource=j_service.ControlQueueSource,
    QueryControlService=j_service.QueryControlService,
    ControlPlane=j_plane.ControlPlane, AdmissionGate=j_plane.AdmissionGate,
    MetadataControlEvent=j_events.MetadataControlEvent,
    OperationControlEvent=j_events.OperationControlEvent,
    ResidentReplay=j_replay.ResidentReplay,
    telemetry=j_telemetry, openmetrics=j_openmetrics, slo=j_slo,
)
TORCH = types.SimpleNamespace(
    name="torch", Job=functools.partial(t_executor.Job, device="cpu"),
    compile_plan=t_compile, StreamSchema=tfst.StreamSchema,
    AttributeType=tfst.AttributeType, EventBatch=tfst.EventBatch,
    BatchSource=t_sources.BatchSource,
    CallbackSource=t_sources.CallbackSource,
    ControlListSource=t_sources.ControlListSource,
    ListSource=t_sources.ListSource,
    SocketLineSource=t_sources.SocketLineSource,
    ControlQueueSource=t_service.ControlQueueSource,
    QueryControlService=t_service.QueryControlService,
    ControlPlane=t_plane.ControlPlane, AdmissionGate=t_plane.AdmissionGate,
    MetadataControlEvent=t_events.MetadataControlEvent,
    OperationControlEvent=t_events.OperationControlEvent,
    ResidentReplay=t_replay.ResidentReplay,
    telemetry=t_telemetry, openmetrics=t_openmetrics, slo=t_slo,
)
BOTH = (JAX, TORCH)
MODES = ("streaming", "fused", "resident")

# journal kinds of the reference's modules the port has not ported yet
# (the executable cache) or does not have (XLA lowerings): left out of a
# journal comparison
UNPORTED_KINDS = ("aotcache.", "compile.")


class Rec:
    def __init__(self, id, price, timestamp):
        self.id, self.price, self.timestamp = id, price, timestamp


def schema(pk):
    return pk.StreamSchema([
        ("id", pk.AttributeType.INT),
        ("price", pk.AttributeType.DOUBLE),
        ("timestamp", pk.AttributeType.LONG),
    ])


def compiler(pk):
    sch = schema(pk)
    return lambda cql, pid: pk.compile_plan(cql, {"S": sch}, plan_id=pid)


def chain_cql(a, b, out="out"):
    return (f"from every s1 = S[id == {a}] -> s2 = S[id == {b}] "
            "within 60 sec "
            f"select s1.timestamp as t1, s2.timestamp as t2 "
            f"insert into {out}")


def mk_batch(pk, n, start, seed):
    """``n`` events from ``start`` one second apart; ids drawn from a
    seeded numpy generator (the same arrays for both packages)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, n).astype(np.int64)
    ts = (start + np.arange(n) * 1000).astype(np.int64)
    return pk.EventBatch(
        "S", schema(pk),
        {"id": ids, "price": np.round(rng.random(n) * 10.0, 3),
         "timestamp": ts},
        ts,
    )


STARTS = (1000, 9000, 17000, 25000)


def control_timeline(pk):
    """The reference's scoped-metrics timeline with tenants on the adds:
    admit qa (acme) -> stack-join qb (bobcorp) -> disable/enable qb ->
    retire qa."""
    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan(chain_cql(1, 2), plan_id="qa")
    ev_a = b.build()
    ev_a.tenant = "acme"
    b2 = pk.MetadataControlEvent.builder()
    b2.add_execution_plan(chain_cql(2, 3), plan_id="qb")
    ev_b = b2.build()
    ev_b.tenant = "bobcorp"
    drop = pk.MetadataControlEvent.builder()
    drop.remove_execution_plan("qa")
    return [
        (0, ev_a),
        (9_500, ev_b),
        (15_500, pk.OperationControlEvent.disable_query("qb")),
        (20_500, pk.OperationControlEvent.enable_query("qb")),
        (25_500, drop.build()),
    ]


SHR_A = "from S[price > 2.0][id == 1] select id, price insert into oa"
SHR_B = ("from S[price > 2.0]#window.lengthBatch(2) "
         "select sum(price) as tot insert into ob")


def share_timeline(pk):
    """The reference's sharing timeline: sa and sb share one prefix host,
    sa retires (the host lives on for sb), sa2 re-joins it."""
    def add(pid, cql, t, tenant):
        b = pk.MetadataControlEvent.builder()
        b.add_execution_plan(cql, plan_id=pid)
        ev = b.build()
        ev.tenant = tenant
        return (t, ev)

    drop = pk.MetadataControlEvent.builder()
    drop.remove_execution_plan("sa")
    return [
        add("sa", SHR_A, 0, "acme"),
        add("sb", SHR_B, 100, "bobcorp"),
        (9_500, drop.build()),
        add("sa2", SHR_A, 17_500, "acme"),
    ]


# the seed of the timelines' data: every plan of both timelines emits
# rows in its phase (sa before its retire, sa2 after its re-admit)
SEED = 14


def run_timeline(pk, mode, timeline=control_timeline, share=False,
                 n=8, seed=SEED):
    """One run of ``timeline`` over four seeded batches in ``mode``."""
    batches = [mk_batch(pk, n, s, seed + i) for i, s in enumerate(STARTS)]
    job = pk.Job(
        [], [pk.BatchSource("S", schema(pk), iter(batches))],
        batch_size=n, time_mode="event",
        control_sources=[pk.ControlListSource(timeline(pk))],
        plan_compiler=compiler(pk),
    )
    job.share_subplans = share
    if mode == "fused":
        job.fused_segment_len = 2
    if mode == "resident":
        pk.ResidentReplay(job).execute()
    else:
        job.run()
    return job


_RUNS = {}


def timeline_job(pk, mode, share=False, seed=SEED):
    """One run per (package, mode, timeline, seed), shared by the tests of
    a worker process."""
    key = (pk.name, mode, share, seed)
    if key not in _RUNS:
        _RUNS[key] = run_timeline(
            pk, mode, share_timeline if share else control_timeline,
            share=share, seed=seed)
    return _RUNS[key]


def per_plan(job, counter="rows_emitted"):
    """A counter of every user plan's scope (group and shared hosts
    left out)."""
    return {
        pid: reg.counter_value(counter)
        for pid, reg in job.telemetry.scope_map("plan").items()
        if not pid.startswith(("@dyn:", "@shr:"))
    }


def job_total(job):
    return sum(n for sid, n in job.emitted_counts.items()
               if not sid.endswith("@late"))


def rollup_counters(job):
    """The tenant rollup's counters and plan lists, without the
    executable cache's (the port has none yet)."""
    return {
        tenant: {k: v for k, v in ent.items()
                 if k in ("plans", "rows_emitted", "matches",
                          "late_events", "stack_joins")}
        for tenant, ent in job.tenant_rollup().items()
    }


def journal(job):
    """The journal's (kind, plan, tenant, collapsed) sequence, without
    the kinds of unported modules."""
    return [
        (e["kind"], e.get("plan"), e.get("tenant"), e.get("collapsed", 0))
        for e in job.flightrec.events()
        if not e["kind"].startswith(UNPORTED_KINDS)
    ]


def prom_samples(text):
    """{(name, frozenset(labels)): value} of an exposition."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        assert m, line
        labels = frozenset(LABEL_RE.findall(m.group(2) or ""))
        out[(m.group(1), labels)] = float(m.group(3))
    return out
