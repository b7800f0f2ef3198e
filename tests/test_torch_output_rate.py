"""``output [all|last|first] every N events | <duration>`` and ``output
snapshot every <duration>`` in the torch port: the eight cases of
``tests/test_output_rate.py``, with the port's rows equal to the JAX
package's on the same input (and, where they are timing-free, to the
reference's expected rows); the limiter on the columnar lane; and the
compiler's refusals with the reference's text."""

import time

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.query.lexer import SiddhiQLError as JaxQLError
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import BatchSource as JaxBatchSource
from flink_siddhi_tpu.runtime.sources import (
    CallbackSource as JaxCallbackSource,
)
from flink_siddhi_tpu.schema.batch import EventBatch as JaxBatch
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.query.lexer import SiddhiQLError
from flink_siddhi_tpu_torch.runtime.sources import BatchSource, CallbackSource

torch.set_num_threads(2)

FIELDS = [("id", "int"), ("timestamp", "long")]
PKGS = {
    "jax": (JaxSchema, JaxBatch, JaxBatchSource, jax_compile, JaxJob,
            JaxCallbackSource, {}),
    "torch": (fpt.StreamSchema, fpt.EventBatch, BatchSource,
              fpt.compile_plan, fpt.Job, CallbackSource, {"device": "cpu"}),
}


def _batches(pkg, schema, lo, hi, step):
    Batch = PKGS[pkg][1]
    ids = np.arange(lo, hi, dtype=np.int32)
    ts = 1000 + np.arange(lo, hi, dtype=np.int64)
    return [Batch("S", schema, {"id": ids[s:s + step],
                                "timestamp": ts[s:s + step]}, ts[s:s + step])
            for s in range(0, hi - lo, step)]


def run(pkg, cql, n=10, batch=4):
    Schema, _, Source, compile_plan, Job, _, kw = PKGS[pkg]
    schema = Schema(list(FIELDS))
    plan = compile_plan(cql, {"S": schema})
    job = Job([plan], [Source("S", schema, iter(_batches(pkg, schema, 0, n,
                                                         batch)))],
              batch_size=batch, time_mode="processing", **kw)
    job.run()
    return job


def both(cql, **kw):
    """The port's ids of stream o, after asserting they equal the JAX
    package's."""
    got = [r[0] for r in run("torch", cql, **kw).results("o")]
    want = [r[0] for r in run("jax", cql, **kw).results("o")]
    assert got == want
    return got


def test_output_last_every_n_events():
    assert both("from S select id output last every 3 events "
                "insert into o") == [2, 5, 8, 9]


def test_output_first_every_n_events():
    assert both("from S select id output first every 4 events "
                "insert into o") == [0, 4, 8]


def test_output_all_every_n_events_batches():
    assert both("from S select id output all every 5 events "
                "insert into o") == list(range(10))


def test_output_time_mode_flushes_at_stream_end():
    # the run ends well inside 1 s: only the end-of-stream flush emits
    assert both("from S select id output last every 1 sec "
                "insert into o") == [9]


@pytest.mark.parametrize("pkg,err", [("jax", JaxQLError),
                                     ("torch", SiddhiQLError)])
def test_output_snapshot_plain_select_rejects_loudly(pkg, err):
    Schema, *_ = PKGS[pkg]
    compile_plan = PKGS[pkg][3]
    with pytest.raises(err, match="snapshot"):
        compile_plan("from S select id output snapshot every 1 sec "
                     "insert into o", {"S": Schema(list(FIELDS))})


def _periodic_snapshot(pkg):
    Schema, _, _, compile_plan, Job, Callback, kw = PKGS[pkg]
    schema = Schema(list(FIELDS))
    src = Callback("S", schema)
    plan = compile_plan(
        "from S select id, count() as c group by id "
        "output snapshot every 40 insert into o", {"S": schema})
    assert plan.snapshot_keys["o"] == (0,)
    job = Job([plan], [src], batch_size=8, time_mode="processing", **kw)
    job.drain_interval_ms = 10.0
    for i in range(6):
        src.emit({"id": i % 2, "timestamp": 1000 + i}, 1000 + i)
    t0 = time.monotonic()
    while len(job.results("o")) < 2 and time.monotonic() - t0 < 5.0:
        job.run_cycle()
        time.sleep(0.005)
    first = sorted(job.results("o")[:2])
    src.emit({"id": 0, "timestamp": 2000}, 2000)
    src.close()
    job.run()
    return first, sorted(job.results("o")[-2:])


def test_output_snapshot_periodic_aggregate_per_group():
    first, final = _periodic_snapshot("torch")
    assert first == [(0, 3), (1, 3)]
    assert final == [(0, 4), (1, 3)]
    assert (first, final) == _periodic_snapshot("jax")


def _limiter_without_new_rows(pkg):
    Schema, _, _, compile_plan, Job, Callback, kw = PKGS[pkg]
    schema = Schema(list(FIELDS))
    src = Callback("S", schema)
    plan = compile_plan("from S select id output all every 50 "
                        "insert into o", {"S": schema})
    job = Job([plan], [src], batch_size=8, time_mode="processing", **kw)
    job.drain_interval_ms = 10.0
    src.emit({"id": 7, "timestamp": 1000}, 1000)
    t0 = time.monotonic()
    # idle cycles only: the buffered row surfaces once 50 ms elapse
    while not job.results("o") and time.monotonic() - t0 < 5.0:
        job.run_cycle()
        time.sleep(0.005)
    out = [r[0] for r in job.results("o")]
    elapsed = time.monotonic() - t0
    src.close()
    job.run()
    return out, elapsed


def test_time_mode_limiter_emits_without_new_rows():
    out, elapsed = _limiter_without_new_rows("torch")
    assert out == [7] and elapsed < 5.0
    assert out == _limiter_without_new_rows("jax")[0]


def _phase_across_checkpoint(pkg, tmp_path):
    Schema, _, Source, compile_plan, Job, _, kw = PKGS[pkg]
    schema = Schema(list(FIELDS))
    cql = "from S select id output last every 3 events insert into o"

    def build(lo, hi):
        return Job([compile_plan(cql, {"S": schema})],
                   [Source("S", schema, iter(_batches(pkg, schema, lo, hi,
                                                      2)))],
                   batch_size=2, time_mode="processing", **kw)

    solo = build(0, 10)
    solo.run()
    expect = [r[0] for r in solo.results("o")]
    job1 = build(0, 10)
    job1.run(max_cycles=2)
    assert not job1.finished
    ck = str(tmp_path / f"ck_{pkg}")
    job1.save_checkpoint(ck)
    job2 = build(4, 10)
    job2.restore(ck)
    job2.run()
    got = ([r[0] for r in job1.results("o")]
           + [r[0] for r in job2.results("o")])
    return got, expect, ck


def test_limiter_phase_survives_checkpoint(tmp_path):
    got, expect, ck = _phase_across_checkpoint("torch", tmp_path)
    assert got == expect == [2, 5, 8, 9]
    jgot, _, jck = _phase_across_checkpoint("jax", tmp_path)
    assert got == jgot
    # the limiter's phase crosses packages too: the reference's file
    # restores into the port and emits at the same boundaries
    schema = fpt.StreamSchema(list(FIELDS))
    job = fpt.Job(
        [fpt.compile_plan("from S select id output last every 3 events "
                          "insert into o", {"S": schema})],
        [BatchSource("S", schema, iter(_batches("torch", schema, 4, 10,
                                                2)))],
        batch_size=2, time_mode="processing", device="cpu")
    job.restore(jck)
    job.run()
    assert [r[0] for r in job.results("o")] == [5, 8, 9]


class _Cols(fpt.ColumnarSink):
    def __init__(self):
        self.ids = []

    def accept_columns(self, ts, cols):
        self.ids.extend(np.asarray(cols["id"]).tolist())


@pytest.mark.parametrize("which,n,want", [
    ("last", 3, [2, 5, 8, 9]), ("first", 4, [0, 4, 8]),
    ("all", 5, list(range(10))),
])
def test_limiter_on_the_columnar_lane(which, n, want):
    """A columnar-only consumer with retention off: the limiter thins
    whole column batches (``feed_columns``), with the row lane's
    result."""
    schema = fpt.StreamSchema(list(FIELDS))
    plan = fpt.compile_plan(f"from S select id output {which} every {n} "
                            "events insert into o", {"S": schema})
    job = fpt.Job([plan], [BatchSource("S", schema, iter(
        _batches("torch", schema, 0, 10, 4)))], batch_size=4,
        time_mode="processing", device="cpu", retain_results=False)
    sink = _Cols()
    job.add_sink("o", sink)
    assert job._columnar_streams(job._plans["plan"]) == {"o"}
    job.run()
    assert sink.ids == want


def test_snapshot_limiter_stays_off_the_columnar_lane():
    schema = fpt.StreamSchema(list(FIELDS))
    plan = fpt.compile_plan("from S select id, count() as c group by id "
                            "output snapshot every 1 sec insert into o",
                            {"S": schema})
    job = fpt.Job([plan], [], device="cpu", retain_results=False)
    job.add_sink("o", _Cols())
    assert job._columnar_streams(job._plans["plan"]) == frozenset()


@pytest.mark.parametrize("cql,text", [
    ("from S select id, count() as c group by id, timestamp output "
     "snapshot every 1 sec insert into o", "must project every group key"),
    ("from S[id > 1] select id output last every 2 events insert into o; "
     "from S[id < 1] select id insert into o", "multiple writer queries"),
    ("from S select id output last every 2 events insert into m; "
     "from m#window.length(2) select id insert into o", "chained stream"),
    ("define table T (id int); from S select id output last every 2 events "
     "insert into T", "on a table write is not supported"),
], ids=["snapshot_keys", "two_writers", "chained", "table_write"])
def test_rate_limit_refusals_carry_the_reference_text(cql, text):
    """The reference's four refusals, raised by both packages with the
    same message."""
    msgs = []
    for pkg, err in (("jax", JaxQLError), ("torch", SiddhiQLError)):
        Schema, *_ = PKGS[pkg]
        with pytest.raises(err, match=text) as ei:
            PKGS[pkg][3](cql, {"S": Schema(list(FIELDS))})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_columnar_limiter_buffer_survives_a_checkpoint_file(tmp_path):
    """A limiter fed by the columnar lane buffers column batches; the
    snapshot writes them as ``(ts, row)`` pairs, so the file loads under
    the safelist and the restored job emits at the same chunk
    boundaries (the reference pickles the column batches themselves,
    which its own safelist refuses: ROADMAP.md Queue 3)."""
    schema = fpt.StreamSchema(list(FIELDS))
    cql = "from S select id output all every 5 events insert into o"

    def build(lo, hi):
        job = fpt.Job([fpt.compile_plan(cql, {"S": schema})],
                      [BatchSource("S", schema, iter(
                          _batches("torch", schema, lo, hi, 2)))],
                      batch_size=2, time_mode="processing", device="cpu",
                      retain_results=False)
        sink = _Cols()
        job.add_sink("o", sink)
        return job, sink

    job1, sink1 = build(0, 12)
    job1.run(max_cycles=4)  # 8 events
    path = str(tmp_path / "ck")
    job1.save_checkpoint(path)  # drains: one chunk out, 3 rows buffered
    assert sink1.ids == [0, 1, 2, 3, 4]
    assert len(job1._rate_limiters["o"].buf) == 3  # as (ts, row) pairs
    job2, sink2 = build(8, 12)
    job2.restore(path)
    job2.run()
    assert sink1.ids + sink2.ids == list(range(12))
