"""The port's SLO watchdog (``telemetry/slo.py``, an exact copy of the
reference's) and the serving surface around it, on the CPU.

The reference's cases of ``tests/test_slo.py``: violation and recovery
with exact journal parity, missing data that is no breach, the loss and
freshness objectives over the gate, burn rates per window, the evaluation
rate limit, the ``/api/v1/slo`` route with the ``/health`` block and the
flight recorder's ``?tenant=`` filter, the Prometheus exposition under
control churn, and the carried verdict that skips the deep re-analysis
(``control.preclear``, journaled). The watchdog's verdicts on a stub job
equal the JAX package's on the same stub, exactly, and the carried-verdict
case's counter, control journal and refusals equal the reference's on the
same control sequence. No test bounds a wall clock (the timings the
watchdog reads are recorded by the tests themselves, or are far from the
objectives).
"""

import json
import re
import time
import urllib.request

import pytest

from tests.torch_telemetry_common import (
    BOTH,
    JAX,
    TORCH,
    Rec,
    chain_cql,
    compiler,
    schema,
)


def filter_cql(v, out="out"):
    return f"from S[id == {v}] select id, price insert into {out}"


def make_job(pk, src, ctrl, **kw):
    return pk.Job([], [src], batch_size=64, time_mode="processing",
                  control_sources=[ctrl], plan_compiler=compiler(pk), **kw)


class _StubJob:
    """The exact surface ``SLOWatchdog._measure`` reads, of one package's
    registry and recorder."""

    def __init__(self, pk):
        self.telemetry = pk.telemetry.MetricsRegistry()
        self.flightrec = pk.telemetry.FlightRecorder(
            registry=self.telemetry)
        self._plan_tenant = {}
        self._max_event_ts = None
        self._gate_wm = -(2 ** 62)
        self.late_dropped = 0
        self.shed_events = 0
        self.processed_events = 0

    def tenant_of(self, pid):
        return self._plan_tenant.get(pid, "default")


def _record_drain_ms(job, pid, ms, n=50):
    h = job.telemetry.scope("plan", pid).histogram("drain.total")
    for _ in range(n):
        h.record(int(ms * 1e3))  # microseconds


def _verdicts(snap):
    """A snapshot as JSON data: every field derives from the values the
    stub recorded and the evaluation times the test passes."""
    return json.loads(json.dumps(snap))


def _violation_case(pk):
    job = _StubJob(pk)
    job._plan_tenant["q1"] = "t0"
    wd = pk.slo.SLOWatchdog(job, min_interval_s=0.0)
    wd.set_policy(pk.slo.SLOPolicy(tenant="t0", p99_ms=10.0, budget=0.5,
                                   windows_s=(100.0,)))
    _record_drain_ms(job, "q1", ms=50.0)
    t_base = time.monotonic()
    for i in range(3):
        wd.evaluate(now=t_base + i)
    breach = _verdicts(wd.snapshot())
    evs = [(e["kind"], e.get("tenant"), e.get("collapsed", 0))
           for e in job.flightrec.events()]
    wd.set_policy(pk.slo.SLOPolicy(tenant="t0", p99_ms=10_000.0))
    wd.evaluate(now=t_base + 10.0)
    healed = _verdicts(wd.snapshot())
    evs2 = [(e["kind"], e.get("tenant"), e.get("collapsed", 0))
            for e in job.flightrec.events()]
    return breach, evs, healed, evs2


def test_violation_recovery_transitions_and_journal_parity():
    breach, evs, healed, evs2 = _violation_case(TORCH)
    assert (breach, evs, healed, evs2) == _violation_case(JAX)
    t0 = breach["tenants"]["t0"]
    assert t0["compliant"] is False and t0["breaches"] == ["p99_ms"]
    assert t0["measured"]["p99_ms"] > 10.0
    assert t0["violations"] == breach["violations_total"] == 3
    assert evs == [("slo.violation", "t0", 2)]
    assert breach["journal"]["violations"] == 3
    assert breach["reconciled"] is True
    assert breach["active_violations"] == 1
    assert breach["worst_burning_tenant"] == "t0"
    assert t0["burn_rates"]["100s"] == pytest.approx(2.0)
    assert healed["tenants"]["t0"]["compliant"] is True
    assert healed["recoveries_total"] == 1
    assert evs2[-1] == ("slo.recovered", "t0", 0)
    assert healed["reconciled"] is True
    assert healed["active_violations"] == 0


def _missing_case(pk):
    job = _StubJob(pk)
    wd = pk.slo.SLOWatchdog(job, min_interval_s=0.0)
    wd.set_policy(pk.slo.SLOPolicy(tenant="t9", p99_ms=1.0,
                                   freshness_s=0.001, loss_ratio=1e-9))
    wd.evaluate(now=0.0)
    return _verdicts(wd.snapshot())


def test_missing_data_is_not_a_breach():
    snap = _missing_case(TORCH)
    assert snap == _missing_case(JAX)
    t9 = snap["tenants"]["t9"]
    assert t9["compliant"] is True and t9["measured"] == {}
    assert snap["violations_total"] == 0


def _gate_case(pk):
    job = _StubJob(pk)
    job.late_dropped, job.shed_events = 5, 5
    job.processed_events = 990
    job._max_event_ts = 10_000
    job._gate_wm = 7_500
    wd = pk.slo.SLOWatchdog(job, min_interval_s=0.0)
    wd.set_policy(pk.slo.SLOPolicy(tenant="t0", loss_ratio=0.005,
                                   freshness_s=3.0))
    wd.evaluate(now=0.0)
    return _verdicts(wd.snapshot())["tenants"]["t0"]


def test_loss_and_freshness_objectives_measure_the_gate():
    t0 = _gate_case(TORCH)
    assert t0 == _gate_case(JAX)
    assert t0["breaches"] == ["loss_ratio"]
    assert t0["measured"]["loss_ratio"] == pytest.approx(0.01, abs=1e-12)
    assert t0["measured"]["freshness_s"] == pytest.approx(2.5, abs=1e-12)


def test_burn_rates_are_per_window_fractions_over_budget():
    history = [(float(t), t >= 6) for t in range(8)]
    for pk in BOTH:
        rates = pk.slo.SLOWatchdog._burn_rates(
            history, windows_s=(3.0, 10.0), budget=0.1, now=7.0)
        assert rates["3s"] == pytest.approx(5.0, abs=1e-12)
        assert rates["10s"] == pytest.approx(2.5, abs=1e-12)


def test_evaluate_rate_limit_and_policy_less_noop():
    for pk in BOTH:
        job = _StubJob(pk)
        wd = pk.slo.SLOWatchdog(job, min_interval_s=1.0)
        wd.evaluate(now=0.0)
        assert wd.snapshot()["evaluations"] == 0
        wd.set_policy(pk.slo.SLOPolicy(tenant="t0", p99_ms=1.0))
        wd.evaluate(now=2.0)
        wd.evaluate(now=2.5)  # inside min_interval_s: dropped
        wd.evaluate(now=3.5)
        assert wd.snapshot()["evaluations"] == 2


def test_a_job_evaluates_once_a_cycle_and_not_when_disabled():
    """``run_cycle`` calls the watchdog at the epoch boundary; with the
    registry off it evaluates nothing."""
    for enabled in (True, False):
        sch = schema(TORCH)
        src = TORCH.CallbackSource("S", sch)
        job = TORCH.Job([TORCH.compile_plan(filter_cql(1), {"S": sch},
                                            plan_id="q")], [src],
                        batch_size=8, time_mode="processing")
        job.telemetry.enabled = enabled
        job.slo.min_interval_s = 0.0
        job.slo.set_policy(TORCH.slo.SLOPolicy(tenant="default",
                                               p99_ms=1e9))
        for cycle in range(3):
            src.emit(Rec(1, 1.0, 1000 + cycle), 1000 + cycle)
            job.run_cycle()
        assert job.slo.snapshot()["evaluations"] == (3 if enabled else 0)


# -- the REST surface ---------------------------------------------------------

def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}") as resp:
        body = resp.read()
    try:
        return json.loads(body)
    except ValueError:
        return body.decode()


def test_slo_route_health_block_and_tenant_filter():
    sch = schema(TORCH)
    src = TORCH.CallbackSource("S", sch)
    ctrl = TORCH.ControlQueueSource()
    job = make_job(TORCH, src, ctrl)
    plane = TORCH.ControlPlane(job, ctrl)
    plane.admit(filter_cql(1), plan_id="q1", tenant="t0")
    plane.admit(filter_cql(2), plan_id="q2", tenant="t1")
    job.slo.min_interval_s = 0.0
    job.slo.set_policy(TORCH.slo.SLOPolicy(tenant="t0", p99_ms=1e-4))
    job.slo.set_policy(TORCH.slo.SLOPolicy(tenant="t1", p99_ms=1e9))
    for cycle in range(3):
        for i in range(8):
            src.emit(Rec(1 + (i % 2), float(i), 1000 + i), 1000 + i)
        job.run_cycle()
    job.drain_outputs()
    job.run_cycle()

    svc = TORCH.QueryControlService(ctrl, job=job).start()
    try:
        base = f"http://127.0.0.1:{svc.port}/api/v1"
        slo = _get(base, "/slo")
        assert slo["policies"] == 2 and slo["reconciled"] is True
        assert slo["tenants"]["t0"]["compliant"] is False
        assert slo["tenants"]["t0"]["breaches"] == ["p99_ms"]
        assert slo["tenants"]["t1"]["compliant"] is True
        assert slo["violations_total"] == slo["journal"]["violations"]
        assert slo["worst_burning_tenant"] == "t0"
        seq = slo["tenants"]["t0"]["last_violation_seq"]
        assert isinstance(seq, int) and seq >= 1

        blk = _get(base, "/health")["slo"]
        assert blk["policies"] == 2 and blk["active_violations"] == 1
        assert blk["worst_burning_tenant"] == "t0"
        assert blk["violations_total"] >= 1
        assert "tenants" not in blk

        t0_evs = _get(base, "/flightrecorder?tenant=t0")["events"]
        assert t0_evs and all(e["tenant"] == "t0" for e in t0_evs)
        kinds = {e["kind"] for e in t0_evs}
        assert "control.admit" in kinds and "slo.violation" in kinds
        t1_evs = _get(base, "/flightrecorder?tenant=t1")["events"]
        assert all(e["tenant"] == "t1" for e in t1_evs)
        assert not any(e["kind"] == "slo.violation" for e in t1_evs)
        both = _get(base, "/flightrecorder?tenant=t0&kind=slo")["events"]
        assert both and all(e["kind"].startswith("slo")
                            and e["tenant"] == "t0" for e in both)
    finally:
        svc.stop()


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def _prom_parse(text):
    samples = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"unparsable exposition line: {line!r}"
        labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
        samples.append((m.group("name"), labels, float(m.group("value"))))
    return samples


def test_prometheus_exposition_consistent_under_churn():
    sch = schema(TORCH)
    src = TORCH.CallbackSource("S", sch)
    ctrl = TORCH.ControlQueueSource()
    job = make_job(TORCH, src, ctrl)
    plane = TORCH.ControlPlane(job, ctrl)
    plane.admit(filter_cql(1), plan_id="q1", tenant="t0")
    svc = TORCH.QueryControlService(ctrl, job=job).start()
    try:
        base = f"http://127.0.0.1:{svc.port}/api/v1"

        def feed(n=8):
            for i in range(n):
                src.emit(Rec(1 + (i % 3), float(i), 1000 + i), 1000 + i)
            job.run_cycle()
            job.drain_outputs()

        def scrape():
            samples = _prom_parse(_get(base, "/metrics/prometheus"))
            keys = [(n, tuple(sorted(lb.items()))) for n, lb, _ in samples]
            assert len(keys) == len(set(keys))
            processed = [v for n, lb, v in samples
                         if n == "fst_processed_events_total"
                         and "plan" not in lb and "tenant" not in lb]
            assert len(processed) == 1
            return processed[0], {lb["tenant"] for _, lb, _ in samples
                                  if "tenant" in lb}

        feed()
        p0, tenants = scrape()
        assert "t0" in tenants
        plane.admit(filter_cql(2), plan_id="q2", tenant="t1")
        feed()
        p1, tenants = scrape()
        assert p1 >= p0 and {"t0", "t1"} <= tenants
        plane.set_enabled("q2", False)
        feed()
        p2, tenants = scrape()
        assert p2 >= p1 and "t1" in tenants
        plane.set_enabled("q2", True)
        feed()
        plane.retire("q2")
        feed()
        p3, tenants = scrape()
        assert p3 >= p2 and {"t0", "t1"} <= tenants
        assert p3 == 40
    finally:
        svc.stop()


def _preclear_case(pk):
    from flink_siddhi_tpu.analysis.admit import STRICT_BUDGETS as J_STRICT
    from flink_siddhi_tpu_torch.analysis.admit import (
        STRICT_BUDGETS as T_STRICT,
    )

    strict = J_STRICT if pk is JAX else T_STRICT
    sch = schema(pk)
    src = pk.CallbackSource("S", sch)
    ctrl = pk.ControlQueueSource()
    job = make_job(pk, src, ctrl)
    job.admission_budgets = strict
    gate = pk.AdmissionGate(compiler(pk), budgets=strict)
    plane = pk.ControlPlane(job, ctrl, gate=gate)
    plane.admit(chain_cql(1, 2), plan_id="q1", tenant="t0")
    job.run_cycle()
    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan(chain_cql(2, 3), plan_id="q2")
    ctrl.push(b.build())
    job.run_cycle()
    b = pk.MetadataControlEvent.builder()
    b.add_execution_plan(
        chain_cql(3, 4).replace(" within 60 sec", ""),
        admission={"admitted": False,
                   "findings": [{"rule": "ADM110", "message": "x"}]},
        plan_id="q3",
    )
    ctrl.push(b.build())
    job.run_cycle()
    return (
        job.telemetry.counter_value("control.preclear"),
        [(e["kind"], e.get("plan"), e.get("tenant"))
         for e in job.flightrec.events()
         if e["kind"].startswith("control.")],
        sorted(job.plan_ids),
        job.control_rejections["q3"]["source"],
        job._plan_admitted_bytes["q1"] > 0,
        job._plan_admitted_bytes["q2"] > 0,
    )


def test_carried_verdict_preclears_deep_reanalysis():
    got = _preclear_case(TORCH)
    assert got == _preclear_case(JAX)
    n_pre, entries, plan_ids, source, b1, b2 = got
    assert n_pre == 1
    assert entries.count(("control.preclear", "q1", "t0")) == 1
    assert ("control.reject", "q3", None) in entries
    assert plan_ids == ["q1", "q2"] and source == "carried-verdict"
    assert b1 and b2


def test_a_dropped_job_is_freed_without_the_cyclic_collector():
    """The watchdog reads its Job through a weak proxy: a Job stepped one
    micro-batch at a time is freed (its device memory with it) when its
    last reference goes, as before the watchdog came, not at the cyclic
    collector's next pass."""
    import gc
    import weakref

    sch = schema(TORCH)
    src = TORCH.CallbackSource("S", sch)
    job = TORCH.Job([TORCH.compile_plan(filter_cql(1), {"S": sch},
                                        plan_id="q")], [src],
                    batch_size=8, time_mode="processing")
    job.slo.min_interval_s = 0.0
    job.slo.set_policy(TORCH.slo.SLOPolicy(tenant="default", p99_ms=1e9))
    for i in range(3):
        src.emit(Rec(1, 1.0, 1000 + i), 1000 + i)
        job.run_cycle()
    job.drain_outputs()
    assert job.slo.snapshot()["evaluations"] == 3
    ref = weakref.ref(job)
    was = gc.isenabled()
    gc.disable()
    try:
        del job
        assert ref() is None
    finally:
        if was:
            gc.enable()
