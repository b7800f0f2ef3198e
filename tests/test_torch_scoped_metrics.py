"""The port's per-plan attribution, tenant rollup, compile events and
OpenMetrics exposition on the CPU, held to the JAX package's.

The reference's cases of ``tests/test_scoped_metrics.py`` run on port Jobs
(``device="cpu"``) over the reference's control timelines
(``tests/torch_telemetry_common.py``), and the same seeded input runs
through both packages:

* **conservation**: per-plan ``rows_emitted`` scopes sum exactly to the
  job's emitted total across admit / stack join / disable / enable /
  retire, and under subplan sharing, in streaming, fused and resident
  modes, with the per-plan split equal across the modes;
* **parity**: per-plan ``rows_emitted`` and ``matches``, the job total
  and the tenant rollup's counters equal the JAX package's, exactly. The
  rollup's ``cache_hits`` / ``cache_misses`` are left out: they count the
  reference's executable cache, which the port does not have yet
  (ROADMAP.md Queue 1 item 10);
* **OpenMetrics**: the port's text passes the reference suite's
  standalone checker, carries ``plan`` and ``tenant`` labels, and has the
  reference's sample names, label sets and TYPE lines, but for the
  recorded differences (ROADMAP.md Queue 3): the ``fst_build_info``
  labels, and the series of what the port does not have (XLA lowerings,
  the executable cache) or counts only on a CUDA device (segment
  uploads). Sample values are equal but for wall-clock timings, the
  footprint gauges (the port meters its whole accumulator ring) and the
  drain and segment schedule (wall-clock budgets decide it; under
  sharing a loopback consumer's segments are one tape);
* **compile events**: a "lowering" of the port is a CUDA graph capture or
  a kernel build (``telemetry/compile_events.py``), counted under the
  plan whose section fired it.

Every comparison is exact (integers); no test bounds a wall clock.
"""

import json
import re
import sys
import threading
import time
import types
import urllib.request

import pytest

import flink_siddhi_tpu as jpkg
import flink_siddhi_tpu_torch as tpkg
from flink_siddhi_tpu_torch.compiler import cuda_ops
from flink_siddhi_tpu_torch.runtime import graphs as t_graphs
from flink_siddhi_tpu_torch.telemetry import compile_events

from tests.torch_telemetry_common import (
    BOTH,
    JAX,
    LABEL_RE,
    MODES,
    TORCH,
    Rec,
    chain_cql,
    check_prometheus_text,
    compiler,
    job_total,
    per_plan,
    prom_samples,
    rollup_counters,
    run_timeline,
    schema,
    timeline_job,
)


# -- conservation across the control timeline, all three modes --------------

@pytest.mark.parametrize("mode", MODES)
def test_rows_emitted_conserve_across_control_timeline(mode):
    """The two members share ONE output stream and one dynamic group
    host: the per-slot decode attributes each row to its member."""
    job = timeline_job(TORCH, mode)
    rows = per_plan(job)
    total = job_total(job)
    assert total > 0
    assert sum(rows.values()) == total, (rows, total)
    assert rows.get("qa", 0) > 0 and rows.get("qb", 0) > 0
    # no limiter thins: matches (before the limiter) equal rows
    assert per_plan(job, "matches") == rows


@pytest.mark.parametrize("mode", ["fused", "resident"])
def test_per_plan_attribution_parity_with_streaming(mode):
    assert per_plan(timeline_job(TORCH, mode)) == per_plan(
        timeline_job(TORCH, "streaming"))


@pytest.mark.parametrize("seed", [14, 21])
@pytest.mark.parametrize("mode", MODES)
def test_attribution_matches_the_reference(mode, seed):
    """Per-plan rows and matches, the emitted total and the tenant
    rollup's counters equal the JAX package's on the same seeded input."""
    got, ref = (timeline_job(pk, mode, seed=seed) for pk in (TORCH, JAX))
    assert per_plan(got) == per_plan(ref)
    assert per_plan(got, "matches") == per_plan(ref, "matches")
    assert per_plan(got, "late_events") == per_plan(ref, "late_events")
    assert job_total(got) == job_total(ref)
    assert rollup_counters(got) == rollup_counters(ref)
    assert got.metrics()["plans"] == ref.metrics()["plans"]


def test_tenant_rollup_merges_plan_scopes():
    job = timeline_job(TORCH, "streaming")
    m = job.metrics()
    tenants = m["tenants"]
    assert tenants["acme"]["plans"] == ["qa"]
    assert tenants["bobcorp"]["plans"] == ["qb"]
    rows = per_plan(job)
    assert tenants["acme"]["rows_emitted"] == rows["qa"]
    assert tenants["bobcorp"]["rows_emitted"] == rows["qb"]
    assert sum(t["rows_emitted"] for t in tenants.values()) \
        == job_total(job)
    # the drain legs of the group host are in each member's scope,
    # merged bucket-exactly per tenant
    assert tenants["acme"]["drain"]["count"] >= 1
    assert m["plans"]["qb"]["tenant"] == "bobcorp"
    json.dumps(m)


def _stack_case(pk):
    src = pk.CallbackSource("S", schema(pk))
    ctrl = pk.ControlQueueSource()
    job = pk.Job([], [src], batch_size=64, time_mode="processing",
                 control_sources=[ctrl], plan_compiler=compiler(pk))
    plane = pk.ControlPlane(job, ctrl)
    plane.admit(chain_cql(1, 2), plan_id="c1", tenant="acme")
    plane.admit(chain_cql(2, 3), plan_id="c2", tenant="bobcorp")
    for i in range(8):
        src.emit(Rec(i % 4, float(i), 1000 + i), 1000 + i)
    job.run_cycle()
    job.run_cycle()
    return job


def test_tenant_cache_and_stack_attribution():
    """bobcorp's constants-only variant stack-joins acme's group: a data
    write counted in ITS tenant scope. The port has no executable cache
    yet, so its cache counters stay 0 where the reference counts acme's
    compile as a miss."""
    t = _stack_case(TORCH).metrics()["tenants"]
    r = _stack_case(JAX).metrics()["tenants"]
    for tenant in ("acme", "bobcorp"):
        assert t[tenant]["stack_joins"] == r[tenant]["stack_joins"]
        assert t[tenant]["cache_hits"] == t[tenant]["cache_misses"] == 0
    assert t["acme"]["stack_joins"] == 0
    assert t["bobcorp"]["stack_joins"] == 1
    assert r["acme"]["cache_misses"] == 1
    scopes = _stack_case(TORCH).telemetry.snapshot()["scopes"]["tenant"]
    assert scopes["bobcorp"]["counters"]["control.stack_join"] == 1


def test_query_listing_one_poll_shows_fleet():
    job = timeline_job(TORCH, "streaming")
    listing = {q["id"]: q for q in job.query_listing()}
    assert "qa" not in listing  # retired
    qb = listing["qb"]
    assert qb["tenant"] == "bobcorp" and qb["enabled"] is True
    assert qb["folded"]["host"].startswith("@dyn:")
    assert isinstance(qb["folded"]["slot"], int)
    assert listing == {q["id"]: q for q in
                       timeline_job(JAX, "streaming").query_listing()}


# -- conservation under subplan sharing --------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_rows_conserve_under_subplan_sharing(mode):
    """Two tenants ride one shared prefix host across admit / retire /
    re-admit: every row counts to a member, none to the host (its mid
    rows loop back before any counter)."""
    job = timeline_job(TORCH, mode, share=True)
    assert job.control_status()["counters"]["subplan_share"] == 3
    rows = per_plan(job)
    total = job_total(job)
    assert total > 0
    assert sum(rows.values()) == total, (rows, total)
    assert rows.get("sa", 0) > 0
    assert rows.get("sb", 0) > 0
    assert rows.get("sa2", 0) > 0
    assert all(
        reg.counter_value("rows_emitted") == 0
        for pid, reg in job.telemetry.scope_map("plan").items()
        if pid.startswith("@shr:")
    )


@pytest.mark.parametrize("mode", ["fused", "resident"])
def test_shared_attribution_parity_with_streaming(mode):
    assert per_plan(timeline_job(TORCH, mode, share=True)) == per_plan(
        timeline_job(TORCH, "streaming", share=True))


@pytest.mark.parametrize("mode", MODES)
def test_shared_attribution_matches_the_reference(mode):
    """Under sharing too, every scope's counters equal the reference's,
    the hosts' included (a host's scope counts the mid rows it drained
    as matches, in both packages, and no rows)."""
    got, ref = (timeline_job(pk, mode, share=True) for pk in (TORCH, JAX))
    scopes = {}
    for name, job in (("got", got), ("ref", ref)):
        scopes[name] = {
            pid: (reg.counter_value("rows_emitted"),
                  reg.counter_value("matches"))
            for pid, reg in job.telemetry.scope_map("plan").items()
        }
    assert scopes["got"] == scopes["ref"]
    assert rollup_counters(got) == rollup_counters(ref)
    assert job_total(got) == job_total(ref)


def test_shared_tenant_rollup_conserves():
    job = timeline_job(TORCH, "streaming", share=True)
    tenants = job.metrics()["tenants"]
    assert sum(t["rows_emitted"] for t in tenants.values()) \
        == job_total(job)
    assert sorted(tenants["acme"]["plans"]) == ["sa", "sa2"]
    assert tenants["bobcorp"]["plans"] == ["sb"]
    assert tenants.get("shared", {}).get("rows_emitted", 0) == 0


# -- OpenMetrics --------------------------------------------------------------

def test_openmetrics_renders_and_parses_with_scoped_labels():
    job = timeline_job(TORCH, "streaming")
    text = job.openmetrics()
    n_samples, types = check_prometheus_text(text)
    assert n_samples > 20
    assert re.search(
        r'fst_rows_emitted_total\{plan="qa",tenant="acme"\} \d+', text)
    assert re.search(
        r'fst_rows_emitted_total\{plan="qb",tenant="bobcorp"\} \d+', text)
    assert 'quantile="0.99"' in text
    assert types.get("fst_drain_total_seconds") == "summary"
    assert 'fst_tenant_rows_emitted_total{tenant="acme"}' in text
    m = re.search(
        r'fst_rows_emitted_total\{plan="qb",tenant="bobcorp"\} (\d+)',
        text)
    assert int(m.group(1)) == per_plan(job)["qb"]


# series of what the port does not have yet or counts on a CUDA device
# only (ROADMAP.md Queue 3): the reference's XLA lowerings, its executable
# cache, and the segment uploads (the port uploads, pinned, on a CUDA
# device only, and does not count their overlap)
_REFERENCE_ONLY = re.compile(
    r"^fst_(compile_lowering|control_cache_|fusion_h2d_)")
# values that differ by design: wall-clock timings, the footprint meter
# (the port meters its whole accumulator ring), and the executable cache's
# tenant counters
_VALUE_EXEMPT = re.compile(
    r"(_seconds(_count|_sum)?$|^fst_footprint_|^fst_tenant_cache_)")
# the drain and segment schedule: set by wall-clock budgets (the drain
# interval, a partial segment's age), and under sharing a loopback
# consumer's segments are one tape in the port
_SCHEDULE = re.compile(r"^fst_(drains_[a-z]+|fusion_dispatches)_total$")


def _types(text):
    return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_openmetrics_series_match_the_reference(mode, share):
    got, ref = (timeline_job(pk, mode, share=share) for pk in (TORCH, JAX))
    t_text, r_text = got.openmetrics(), ref.openmetrics()
    check_prometheus_text(t_text)
    t_s, r_s = prom_samples(t_text), prom_samples(r_text)
    r_keys = {k for k in r_s if not _REFERENCE_ONLY.match(k[0])
              and k[0] != "fst_build_info"}
    t_keys = {k for k in t_s if k[0] != "fst_build_info"}
    assert t_keys == r_keys
    t_types, r_types = _types(t_text), _types(r_text)
    assert t_types == {f: ty for f, ty in r_types.items()
                       if not _REFERENCE_ONLY.match(f)}
    for key in t_keys:
        if _VALUE_EXEMPT.search(key[0]):
            continue
        if _SCHEDULE.match(key[0]):
            continue
        assert t_s[key] == r_s[key], key


def test_prometheus_route_serves_text_format():
    job = timeline_job(TORCH, "streaming")
    svc = TORCH.QueryControlService(TORCH.ControlQueueSource(),
                                    job=job).start()
    try:
        base = f"http://127.0.0.1:{svc.port}/api/v1"
        with urllib.request.urlopen(f"{base}/metrics/prometheus") as resp:
            assert resp.status == 200
            assert resp.headers.get("Content-Type", "").startswith(
                "text/plain")
            text = resp.read().decode("utf-8")
        n_samples, _ = check_prometheus_text(text)
        assert n_samples > 0
        assert 'plan="qb"' in text and 'tenant="bobcorp"' in text
        with urllib.request.urlopen(f"{base}/queries/qb") as resp:
            q = json.loads(resp.read())
        assert q["tenant"] == "bobcorp"
        assert q["metrics"]["counters"]["rows_emitted"] == \
            per_plan(job)["qb"]
        assert "host_footprint" in q["metrics"]
        with urllib.request.urlopen(f"{base}/queries") as resp:
            listing = json.loads(resp.read())["queries"]
        assert listing and all(
            {"id", "tenant", "enabled", "folded"} <= set(q2)
            for q2 in listing)
    finally:
        svc.stop()


def _build_info(text):
    m = re.search(r"^fst_build_info\{([^}]*)\} 1$", text, re.M)
    assert m, "fst_build_info sample missing"
    return dict(LABEL_RE.findall(m.group(1)))


def test_build_info_gauge_present_and_parses():
    """The port's build-info labels: its version, torch's, the backend of
    the Job's device, and the bench schema version (0: the port's bench
    does not exist yet)."""
    import torch

    job = timeline_job(TORCH, "streaming")
    text = job.openmetrics()
    _, types = check_prometheus_text(text)
    assert types.get("fst_build_info") == "gauge"
    labels = _build_info(text)
    assert labels == {
        "package_version": tpkg.__version__,
        "torch_version": torch.__version__,
        "backend": "cpu",
        "bench_schema_version": "0",
    }


def test_build_info_differs_from_the_reference_only_by_the_label_change():
    """The recorded label change (ROADMAP.md Queue 3): jax_version becomes
    torch_version, the backend is the Job's device type, and the bench
    schema version is the port's; the package version is the same."""
    got = _build_info(timeline_job(TORCH, "streaming").openmetrics())
    ref = _build_info(timeline_job(JAX, "streaming").openmetrics())
    assert set(ref) - set(got) == {"jax_version"}
    assert set(got) - set(ref) == {"torch_version"}
    assert got["package_version"] == ref["package_version"]
    assert got["backend"] == ref["backend"] == "cpu"
    assert ref["bench_schema_version"] == str(jpkg.BENCH_SCHEMA_VERSION)
    assert got["bench_schema_version"] == "0"


def test_checker_rejects_malformed_text():
    with pytest.raises(AssertionError):
        check_prometheus_text("fst_x_total 1\n")
    with pytest.raises(AssertionError):
        check_prometheus_text(
            "# TYPE fst_x_total counter\nfst_x_total oops\n")
    with pytest.raises(AssertionError):
        check_prometheus_text(
            "# TYPE fst_x gauge\nfst_x{bad-label=\"v\"} 1\n")


# -- compile events: graph captures and kernel builds -----------------------

def _one_plan_job():
    sch = schema(TORCH)
    plan = TORCH.compile_plan("from S[id == 1] select price insert into o",
                              {"S": sch}, plan_id="p")
    src = TORCH.CallbackSource("S", sch)
    return TORCH.Job([plan], [src], batch_size=8,
                     time_mode="processing"), src


def test_a_cpu_run_records_no_compile_event():
    """On the CPU nothing is captured or built: a fused run sees its graph
    keys and records no compile event."""
    job, src = _one_plan_job()
    job.fused_segment_len = 2
    with compile_events.watch() as w:
        for i in range(8):
            src.emit(Rec(i % 2, float(i), 1000 + i), 1000 + i)
        job.run_cycle()
        job.drain_outputs()
    assert job.graph_keys >= 1 and job.graphs_captured == 0
    assert w.count == 0
    assert job.metrics()["compiles"]["total_lowerings"] == 0


def test_a_capture_counts_under_its_plan(monkeypatch):
    """A lowering of the port is a CUDA graph capture: each graph
    ``SegmentGraphs.prepare`` captures (one a ring position) is one event,
    recorded after the capture guard and counted under the plan of the
    section (``Job._compile_scope``): the sink's label, the registry's
    ``compile.lowerings``, the journal's ``compile.capture``."""
    job, src = _one_plan_job()
    job.fused_segment_len = 2
    seconds = [0.25, 0.5]
    monkeypatch.setattr(t_graphs.SegmentGraphs, "_warm_and_capture",
                        lambda self, rt, seg, key: list(seconds))
    with compile_events.watch() as w:
        for i in range(8):
            src.emit(Rec(i % 2, float(i), 1000 + i), 1000 + i)
        job.run_cycle()
        job.drain_outputs()
    assert w.count == 2 and w.durations == seconds
    c = job.metrics()["compiles"]
    assert c["by_signature"] == {"plan:p": 2}
    assert c["total_lowerings"] == 2
    assert c["total_duration_s"] == pytest.approx(0.75, abs=1e-9)
    assert job.telemetry.counter_value("compile.lowerings") == 2
    caps = job.flightrec.events(kind="compile.capture")
    assert [e["signature"] for e in caps] == ["plan:p", "plan:p"]
    assert [e["duration_ms"] for e in caps] == [250.0, 500.0]
    text = job.openmetrics()
    assert "fst_compile_lowerings_total 2" in text
    # outside any Job's section an event reaches the watchers only
    with compile_events.watch() as w2:
        compile_events.record("capture", 0.1)
    assert w2.count == 1
    assert job.metrics()["compiles"]["total_lowerings"] == 2


def test_a_kernel_build_is_a_compile_event(monkeypatch, tmp_path):
    """A lowering of the port is also a kernel build: each source
    ``cuda_ops._Libraries.build`` compiles (one nvcc run) records a
    'build' event; a
    library already on disk only loads and records none. A stand-in
    compiler writes the output file; the loader is stubbed (no CUDA
    here)."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n  shift\ndone\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_ops, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_ops.ctypes, "CDLL",
                        lambda path: type("Lib", (), {})())
    job, _ = _one_plan_job()
    libs = cuda_ops._Libraries()
    rt = job._plans["p"]
    with compile_events.watch() as w, job._compile_scope(rt):
        libs.build(["empty", "reverse_cummin"])
        libs2 = cuda_ops._Libraries()
        libs2.build(["empty"])  # on disk now: loads only
    assert w.count == 2
    assert job.metrics()["compiles"]["by_signature"] == {"plan:p": 2}
    builds = job.flightrec.events(kind="compile.build")
    assert len(builds) == 2
    assert all(e["signature"] == "plan:p" for e in builds)


def test_compile_events_api_is_the_references():
    """The module keeps the reference's surface (watch, attribution,
    install/installed, CompileSink, the registry names)."""
    from flink_siddhi_tpu.telemetry import compile_events as ref

    for name in ("watch", "attribution", "install", "installed",
                 "CompileSink", "CompileWatcher", "UNATTRIBUTED"):
        assert hasattr(compile_events, name) and hasattr(ref, name), name
    compile_events.install()
    assert compile_events.installed()
    sink = compile_events.CompileSink()
    assert set(sink.snapshot()) == set(ref.CompileSink().snapshot())


@pytest.mark.parametrize("pk", BOTH, ids=lambda p: p.name)
def test_metrics_carry_the_reference_blocks(pk):
    """metrics() has the reference's top-level blocks in both packages."""
    m = timeline_job(pk, "streaming").metrics()
    for key in ("plans", "tenants", "footprint", "compiles", "fleet",
                "attribution", "flight_recorder", "slo", "telemetry"):
        assert key in m, key
    assert "trace" in m["telemetry"]
    assert m["fleet"] is None
    json.dumps(m)


def test_exposition_scraped_while_the_run_loop_steps():
    """Readers on other threads (the REST service's) take the snapshot
    while the run loop steps the control timeline, with a short switch
    interval: every text parses, and the run's attribution is the
    undisturbed run's."""
    jobs, texts, errors = [], [], []
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            if not jobs:
                time.sleep(1e-3)
                continue
            try:
                texts.append(check_prometheus_text(jobs[0].openmetrics())[0])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

    def job_spy(*a, **kw):
        jobs.append(TORCH.Job(*a, **kw))
        return jobs[-1]

    pk = types.SimpleNamespace(**{**vars(TORCH), "Job": job_spy})
    readers = [threading.Thread(target=scrape) for _ in range(3)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in readers:
            t.start()
        job = run_timeline(pk, "fused")
    finally:
        sys.setswitchinterval(old)
        stop.set()
        for t in readers:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in readers)
    assert not errors, errors[:1]
    assert texts
    assert per_plan(job) == per_plan(timeline_job(TORCH, "fused"))
    assert sum(per_plan(job).values()) == job_total(job)
