"""The port's per-event trace sampling (``telemetry/tracing.py``, an exact
copy of the reference's) wired through its Job, on the CPU, held to the
JAX package's.

An event is sampled iff ``abs_ts % sample_every == 0``: stamped at the
source pull, marked where the fused path stages and dispatches it (the
per-batch path at dispatch, the resident replay at the end of staging),
and completed where a row with its timestamp surfaces. The reference's
trace cases of ``tests/test_telemetry.py`` run on the port's sampler and
Jobs, and the same seeded stream runs through both packages' Jobs in
streaming, fused and resident modes: the stamped, completed, evicted and
pending counts and the number of samples in each leg's histogram are
equal, exactly. Latency values are wall-clock and are not compared; no
test bounds a wall clock. The registry's ``enabled`` switch silences
spans, tracer, journal and SLO together.
"""

import json

import numpy as np
import pytest

from flink_siddhi_tpu_torch.runtime import executor as t_executor
from flink_siddhi_tpu_torch.telemetry import (
    LatencyHistogram,
    MetricsRegistry,
    TraceSampler,
)

from tests.torch_telemetry_common import BOTH, JAX, MODES, TORCH


def test_trace_completion_first_wins_and_marks_legs():
    reg = MetricsRegistry()
    tr = TraceSampler(reg, sample_every=4)
    ts = np.arange(0, 64, dtype=np.int64)
    tr.stamp_ingest(ts)
    assert tr.sampled == 16
    tr.mark(ts, "dispatch")
    assert reg.histogram("trace.ingest_to_dispatch").count == 16
    rows = [(int(t), ()) for t in ts]
    tr.complete_rows(0, rows)
    assert tr.completed == 16
    tr.complete_rows(0, rows)  # a duplicate emission: stamps popped
    assert tr.completed == 16
    assert reg.histogram("trace.e2e").count == 16
    snap = tr.snapshot()
    assert snap["pending"] == 0 and len(snap["recent"]) == 16
    json.dumps(snap)


def test_trace_pending_is_bounded():
    tr = TraceSampler(MetricsRegistry(), sample_every=1, max_pending=64)
    tr.stamp_ingest(np.arange(0, 1000, dtype=np.int64))
    assert tr.snapshot()["pending"] <= 64
    assert tr.evicted >= 1000 - 64
    tr.complete_rows(0, [(5, ())])  # evicted: cannot complete
    assert tr.completed == 0


def test_trace_shard_histograms_merge_into_snapshot():
    reg = MetricsRegistry()
    tr = TraceSampler(reg, sample_every=1)
    shard_hists = [LatencyHistogram() for _ in range(4)]
    for s in range(4):
        ts = np.arange(s * 100, s * 100 + 100, dtype=np.int64)
        tr.stamp_ingest(ts)
        tr.complete_rows(0, [(int(t), ()) for t in ts], hist=shard_hists[s])
    assert tr.completed == 400
    assert reg.histogram("trace.e2e").count == 0
    assert tr.snapshot(extra_hists=shard_hists)["e2e"]["count"] == 400


def test_trace_disabled_is_inert():
    tr = TraceSampler(MetricsRegistry(), sample_every=0)
    assert not tr.enabled
    tr.stamp_ingest(np.arange(100, dtype=np.int64))
    tr.mark(np.arange(100, dtype=np.int64), "dispatch")
    tr.complete_rows(0, [(0, ())])
    assert tr.sampled == 0 and tr.completed == 0
    assert not TraceSampler(MetricsRegistry(enabled=False),
                            sample_every=1).enabled


def test_complete_ts_is_the_columnar_twin_of_complete_rows():
    a = TraceSampler(MetricsRegistry(), sample_every=3)
    b = TraceSampler(MetricsRegistry(), sample_every=3)
    ts = np.arange(100, 160, dtype=np.int64)
    a.stamp_ingest(ts)
    b.stamp_ingest(ts)
    a.complete_rows(100, [(int(t) - 100, ()) for t in ts])
    b.complete_ts(100, ts - 100)
    assert (a.sampled, a.completed) == (b.sampled, b.completed) == (20, 20)


# -- the Job: counts against the reference ------------------------------------

def _small_job(pk, n_events, batch, mode, sample_every=8, columnar=False,
               enabled=True):
    """The reference suite's small job: a seeded stream of ids 0..9 and a
    filter keeping id 3 (``enabled``: the registry's switch, set before
    the run)."""
    sch = pk.StreamSchema([("id", pk.AttributeType.INT),
                           ("price", pk.AttributeType.DOUBLE)])
    rng = np.random.default_rng(11)
    batches = []
    for start in range(0, n_events, batch):
        m = min(batch, n_events - start)
        cols = {"id": rng.integers(0, 10, m).astype(np.int32),
                "price": rng.random(m) * 50.0}
        ts = 1_000 + start + np.arange(m, dtype=np.int64)
        batches.append(pk.EventBatch("s", sch, cols, ts))
    plan = pk.compile_plan("from s[id == 3] select id, price insert into out",
                           {"s": sch}, plan_id="t")
    job = pk.Job([plan], [pk.BatchSource("s", sch, iter(batches))],
                 batch_size=batch, time_mode="processing",
                 retain_results=not columnar)
    job.telemetry.enabled = enabled
    job.tracer.sample_every = sample_every
    if columnar:
        got = []

        class Sink:
            def accept_columns(self, ts, cols):
                got.append(len(ts))

        job.add_sink("out", Sink())
    if mode == "fused":
        job.fused_segment_len = 2
    if mode == "resident":
        pk.ResidentReplay(job).execute()
    else:
        job.run()
    return job


def _trace_counts(job):
    t = job.tracer.snapshot()
    hists = job.telemetry.snapshot()["histograms"]
    legs = {k: v["count"] for k, v in hists.items()
            if k.startswith("trace.")}
    return (t["sample_every"], t["sampled"], t["completed"], t["pending"],
            t["evicted"], t["e2e"]["count"], legs)


@pytest.mark.parametrize("columnar", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_tracer_counts_match_the_reference(mode, columnar):
    got = _trace_counts(_small_job(TORCH, 16_384, 4_096, mode,
                                   columnar=columnar))
    ref = _trace_counts(_small_job(JAX, 16_384, 4_096, mode,
                                   columnar=columnar))
    assert got == ref
    sample_every, sampled, completed, pending, evicted, e2e, legs = got
    assert sampled == 16_384 // 8
    assert 0 < completed == e2e < sampled
    assert pending == sampled - completed and evicted == 0
    leg = {"streaming": "trace.ingest_to_dispatch",
           "fused": "trace.ingest_to_staged",
           "resident": "trace.ingest_to_staged"}[mode]
    assert legs[leg] == sampled


@pytest.mark.parametrize("sample_every", [1, 2, 3, 1000, 1024, 4096])
def test_the_one_pass_subset_is_the_tracers(sample_every):
    """``Job._sampled`` (a bitwise and for a power-of-two
    ``sample_every``) selects exactly the tracer's ``abs_ts %
    sample_every == 0`` subset, in order, negative timestamps
    included."""
    job = TORCH.Job([], [])
    job.tracer.sample_every = sample_every
    rng = np.random.default_rng(5)
    ts = np.concatenate([rng.integers(-2**40, 2**40, 50_000),
                         np.arange(-5_000, 5_000)]).astype(np.int64)
    got = job._sampled(ts)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, job.tracer.sampled_subset(ts))


@pytest.mark.parametrize("mode", MODES)
def test_one_sampling_pass_per_pulled_batch(mode, monkeypatch):
    """The sampling rule runs once over each pulled batch: the pull's
    subset serves the stamp and the staged and dispatch marks, whose
    counts the test above holds to the reference."""
    passes = []
    sampled = t_executor.Job._sampled

    def counting(self, ts):
        passes.append(len(ts))
        return sampled(self, ts)

    monkeypatch.setattr(t_executor.Job, "_sampled", counting)
    job = _small_job(TORCH, 16_384, 4_096, mode)
    assert passes == [4_096] * 4
    assert job.tracer.sampled == 16_384 // 8


def test_streaming_job_traces_end_to_end():
    job = _small_job(TORCH, 16_384, 4_096, "streaming")
    m = job.metrics()
    trace = m["telemetry"]["trace"]
    assert trace["sample_every"] == 8 and trace["sampled"] > 0
    assert trace["completed"] > 0
    assert trace["e2e"]["count"] == trace["completed"]
    assert trace["e2e"]["p50_ms"] <= trace["e2e"]["p99_ms"]
    assert len(trace["recent"]) == min(trace["completed"], 256)
    json.dumps(m)


def test_the_default_sample_rate_is_the_references():
    for pk in BOTH:
        job = pk.Job([], [])
        assert job.tracer.sample_every == 1024


def _rows(job):
    return job.emitted_counts.get("out", 0)


@pytest.mark.parametrize("mode", MODES)
def test_disabled_registry_silences_every_hook(mode):
    """``telemetry.enabled = False`` (the overhead A/B's off side):
    no stage, histogram, trace, journal entry or scope counter is
    recorded, and the rows are those of the enabled run."""
    on = _small_job(TORCH, 8_192, 4_096, mode)
    job = _small_job(TORCH, 8_192, 4_096, mode, enabled=False)
    assert _rows(job) == _rows(on) > 0
    snap = job.telemetry.snapshot()
    assert snap["stages"] == {} and snap["histograms"] == {}
    assert job.tracer.sampled == 0 and job.flightrec.seq == 0
    assert job.telemetry.scope_map("plan") == {}
    assert on.telemetry.scope_map("plan")["t"].counter_value(
        "rows_emitted") == _rows(on)


def test_resident_replay_names_its_stages():
    """A bounded replay's wall clock lands in named stages (staging off
    the clock, then the replay) and the live limiting-leg view covers the
    attributed total."""
    job = _small_job(TORCH, 16_384, 4_096, "resident")
    stages = job.telemetry.snapshot()["stages"]
    for name in ("stage.source_pull", "stage.h2d", "tape_build",
                 "replay.dispatch", "replay.drain"):
        assert name in stages, name
    att = job.metrics()["attribution"]
    assert att["coverage"] == pytest.approx(1.0)
    assert set(att["legs"]["host_staging"]["stages"]) >= {
        "stage.source_pull", "tape_build"}
