"""Supervised recovery of the torch port (``runtime/supervisor.py``,
``runtime/faultinject.py``): the non-Kafka cases of
``tests/test_faults.py`` on the CPU, with the committed rows held to an
unfaulted run of the port and to the JAX package's rows.

* The fused streaming Job killed mid-segment and mid-checkpoint; the
  resident drive killed mid-stage and mid-checkpoint: 0 duplicate and 0
  lost rows.
* The restart budget, and every checkpoint generation unreadable.
* The checkpoint safelist.
* The shed policies: 'drop_oldest' counts, 'block' never deadlocks a
  single source and stops pulling a source far ahead of the watermark.
* ``supervisor.py`` and ``faultinject.py`` are exact copies of the
  reference's (``tests/test_torch_host.py``); here they drive the port.
"""

import collections
import glob
import io
import pickle

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import ListSource as JaxListSource
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.runtime import checkpoint as ckpt_mod
from flink_siddhi_tpu_torch.runtime.faultinject import (
    CrashPlan,
    InjectedCrash,
    wrap_job,
)
from flink_siddhi_tpu_torch.runtime.sources import CallbackSource, ListSource
from flink_siddhi_tpu_torch.runtime.supervisor import (
    CheckpointsUnreadableError,
    RestartBudgetExceeded,
    Supervisor,
)
from flink_siddhi_tpu_torch.schema.batch import EventBatch

torch.set_num_threads(2)

FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
          ("timestamp", "long")]
# stateful: the window ring and the running sums must survive every restore
CQL = ("from S#window.length(6) select id, sum(price) as t, "
       "count() as c insert into out")


def _schema(sid="S"):
    return fpt.StreamSchema(list(FIELDS))


def _record_tuples(n):
    return [((i % 4), f"n{i % 3}", float(i), 1000 + 10 * i)
            for i in range(n)]


def _job(src, cql=CQL, **kw):
    plan = fpt.compile_plan(cql, {"S": src.schema})
    return fpt.Job([plan], [src], batch_size=16, device="cpu", **kw)


def _oracle_rows(n, cql=CQL):
    """The unfaulted run of the port, held equal to the JAX package's."""
    src = ListSource("S", _schema(), _record_tuples(n), ts_field="timestamp")
    job = _job(src, cql)
    job.run()
    got = job.results_with_ts("out")
    jschema = JaxSchema(list(FIELDS))
    jjob = JaxJob([jax_compile(cql, {"S": jschema})],
                  [JaxListSource("S", jschema, _record_tuples(n),
                                 ts_field="timestamp")], batch_size=16)
    jjob.run()
    assert got == jjob.results_with_ts("out")
    return got


def test_supervised_fused_exactly_once_kill_mid_segment(tmp_path):
    """Segments of 4 tapes, kills at pulls that land mid-segment (tapes
    staged, not dispatched) and one mid-checkpoint: a checkpoint
    dispatches the staged partial segment first, so it lands on a segment
    boundary, and the committed rows equal the unfaulted run's."""
    n = 96
    crash = CrashPlan(at_pulls=(3, 7), at_checkpoints=(2,))

    def factory():
        src = ListSource("S", _schema(), _record_tuples(n),
                         ts_field="timestamp")
        job = _job(src, retain_results=False)
        job.fused_segment_len = 4
        return wrap_job(job, crash)

    ckpt = str(tmp_path / "ckpt")
    sup = Supervisor(factory, ckpt, checkpoint_every_cycles=3,
                     keep_checkpoints=3, max_restarts=10,
                     restart_window_s=3600.0)
    final = sup.run()
    assert crash.crashes == 3
    assert final.fusion_dispatches > 0
    oracle = collections.Counter(_oracle_rows(n))
    committed = collections.Counter(sup.results_with_ts("out"))
    assert sum((committed - oracle).values()) == 0, "duplicate rows"
    assert sum((oracle - committed).values()) == 0, "lost rows"
    assert glob.glob(f"{ckpt}.tmp.*") == []
    tel = sup.telemetry.snapshot()
    assert tel["counters"]["faults.crashes"] == 3
    assert tel["histograms"]["recovery.restore_ms"]["count"] >= 1
    assert sup.last_recovery_ms is not None


def test_supervised_resident_mode_exactly_once(tmp_path):
    n = 60
    crash = CrashPlan(at_pulls=(2,), at_checkpoints=(1,))

    def factory():
        src = ListSource("S", _schema(), _record_tuples(n),
                         ts_field="timestamp")
        return wrap_job(_job(src, retain_results=False), crash)

    sup = Supervisor(factory, str(tmp_path / "ckpt"), mode="resident",
                     max_restarts=5, restart_window_s=3600.0)
    sup.run()
    assert crash.crashes == 2
    assert sup.results_with_ts("out") == _oracle_rows(n)
    tel = sup.telemetry.snapshot()
    assert tel["counters"]["recovery.rows_discarded"] >= 1


def test_restart_budget_fails_loudly(tmp_path):
    crash = CrashPlan(at_pulls=tuple(range(1, 50)))  # always crash

    def factory():
        src = ListSource("S", _schema(), _record_tuples(20),
                         ts_field="timestamp")
        return wrap_job(_job(src, retain_results=False), crash)

    sup = Supervisor(factory, str(tmp_path / "ckpt"), max_restarts=2,
                     restart_window_s=3600.0)
    with pytest.raises(RestartBudgetExceeded) as ei:
        sup.run()
    assert isinstance(ei.value.__cause__, InjectedCrash)
    assert sup.health()["alive"] is False
    assert sup.results("out") == []


def test_all_generations_unreadable_refuses_loudly(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    crash = CrashPlan(at_pulls=(3,))  # after the cycle-2 checkpoint
    builds = {"n": 0}

    def factory():
        builds["n"] += 1
        if builds["n"] == 2:
            for p in (ckpt, f"{ckpt}.1", f"{ckpt}.2"):
                if glob.glob(p):
                    with open(p, "wb") as f:
                        f.write(b"not a checkpoint")
        src = ListSource("S", _schema(), _record_tuples(64),
                         ts_field="timestamp", chunk=16)
        return wrap_job(_job(src, retain_results=False), crash)

    sup = Supervisor(factory, ckpt, checkpoint_every_cycles=2,
                     keep_checkpoints=3, max_restarts=5,
                     restart_window_s=3600.0)
    with pytest.raises(CheckpointsUnreadableError, match="refusing"):
        sup.run()
    assert sup.health()["alive"] is False
    committed = sup.results_with_ts("out")
    oracle = _oracle_rows(64)
    assert committed == oracle[: len(committed)]
    assert sup.telemetry.snapshot()["counters"][
        "recovery.bad_checkpoints"] >= 1


def _fallback_run(pkg, tmp_path):
    """A supervised run whose newest generation is made unreadable before
    the restart: the supervisor falls back to the older one."""
    from flink_siddhi_tpu.runtime import faultinject as jax_fi
    from flink_siddhi_tpu.runtime import supervisor as jax_sv

    def build():
        if pkg == "torch":
            return _job(ListSource("S", _schema(), _record_tuples(96),
                                   ts_field="timestamp", chunk=16),
                        retain_results=False)
        schema = JaxSchema(list(FIELDS))
        return JaxJob([jax_compile(CQL, {"S": schema})],
                      [JaxListSource("S", schema, _record_tuples(96),
                                     ts_field="timestamp", chunk=16)],
                      batch_size=16, retain_results=False)

    fi_plan, fi_wrap, sup_cls = (
        (CrashPlan, wrap_job, Supervisor) if pkg == "torch"
        else (jax_fi.CrashPlan, jax_fi.wrap_job, jax_sv.Supervisor))
    ckpt = str(tmp_path / f"ckpt_{pkg}")
    crash = fi_plan(at_pulls=(6,))
    builds = {"n": 0}

    def factory():
        builds["n"] += 1
        if builds["n"] == 2:
            with open(ckpt, "wb") as f:
                f.write(b"not a checkpoint")
        return fi_wrap(build(), crash)

    sup = sup_cls(factory, ckpt, checkpoint_every_cycles=2,
                  keep_checkpoints=3, max_restarts=5,
                  restart_window_s=3600.0)
    sup.run()
    return sup


def test_supervisor_falls_back_past_an_unreadable_generation(tmp_path):
    """The newest generation unreadable, an older one good: the restart
    comes from the older one (counted), and the committed rows are the
    reference supervisor's in the same run (the rows committed between
    the two generations surface again in both: a fallback is for a
    generation whose commit never happened)."""
    sup = _fallback_run("torch", tmp_path)
    counters = sup.telemetry.snapshot()["counters"]
    assert counters["recovery.bad_checkpoints"] == 1
    assert counters["recovery.checkpoint_fallbacks"] == 1
    assert counters["recovery.events_replayed"] > 0
    ref = _fallback_run("jax", tmp_path)
    assert sup.results_with_ts("out") == ref.results_with_ts("out")
    assert set(sup.results_with_ts("out")) == set(_oracle_rows(96))


def test_checkpoint_load_rejects_arbitrary_classes():
    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    blob = pickle.dumps({"version": 1, "payload": Evil()})
    with pytest.raises(pickle.UnpicklingError, match="safelist"):
        ckpt_mod.safe_load_snapshot(io.BytesIO(blob))
    ok = pickle.dumps({"a": np.arange(3), "b": np.float64(1.5),
                       "c": [(1, "x")]})
    out = ckpt_mod.safe_load_snapshot(io.BytesIO(ok))
    assert out["b"] == 1.5 and list(out["a"]) == [0, 1, 2]


def test_shed_policy_drop_oldest_counts_loudly():
    fast = ListSource("S", _schema(), _record_tuples(64),
                      ts_field="timestamp", chunk=16)
    job = _job(fast)
    job.max_pending_events = 20
    job.shed_policy = "drop_oldest"
    job.run_cycle()
    big = EventBatch.from_records(
        "S", fast.schema, _record_tuples(40),
        timestamps=[10_000 + i for i in range(40)])
    job._pending.setdefault("S", []).append(big)
    assert job._pending_total() > job.max_pending_events
    job._shed_pending()
    assert job._pending_total() <= job.max_pending_events
    assert job.shed_events > 0
    counters = job.metrics()["telemetry"]["counters"]
    assert counters["faults.shed_events"] == job.shed_events


def test_block_policy_single_source_never_deadlocks():
    n = 64
    src = ListSource("S", _schema(), _record_tuples(n),
                     ts_field="timestamp", chunk=8)
    job = _job(src)
    job.max_pending_events = 4
    job.shed_policy = "block"
    job.run(max_cycles=10_000)
    assert job.finished
    assert job.results_with_ts("out") == _oracle_rows(n)


def test_block_policy_blocks_the_ahead_source():
    ahead = ListSource("S", _schema(), _record_tuples(64),
                       ts_field="timestamp", chunk=32)
    lag = CallbackSource("S2", _schema("S2"))
    lag.advance_watermark(50)
    plan = fpt.compile_plan(CQL, {"S": ahead.schema})
    job = fpt.Job([plan], [ahead, lag], batch_size=32, device="cpu")
    job.max_pending_events = 8
    job.shed_policy = "block"
    job.run_cycle()
    before = job._pending_total()
    assert before > job.max_pending_events
    job.run_cycle()
    counters = job.metrics()["telemetry"]["counters"]
    assert counters.get("faults.backpressure_blocks", 0) >= 1
    assert job._pending_total() == before
    lag.close()
