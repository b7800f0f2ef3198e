"""The port's deployable pipeline (``app/pipeline.py``) and socket source,
on the CPU, held to the JAX package's.

* ``tests/test_app.py``'s pipeline cases: a JSON-lines file end to end,
  the restart from a checkpoint, the restart budget, the ``kafka://``
  round trip in both broker dialects, Kafka offsets resumed across a
  restart, and a resume landing inside a gzip'd v2 batch; each output
  equal to the reference pipeline's on the same input. A CSV file too.
* ``tests/test_socket_source.py``'s two cases.
* What the port adds: ``transactional_id`` (a ``kafka://`` output
  committed with each checkpoint: exactly once across crashes killed by
  ``runtime/faultinject.py`` and the pipeline's own restarts) and the
  ``device`` argument (CUDA by default, raising without it).
* A pipeline with control sources: a ``ControlListSource`` adds, pauses,
  resumes, updates and retires queries mid-file, rows equal to the
  reference pipeline's.
"""

import collections
import json
import socket
import time

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.app import pipeline as jax_pipeline
from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.runtime import kafka as jax_kafka
from flink_siddhi_tpu.runtime.executor import Job as JaxJob

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.app import pipeline as port_pipeline
from flink_siddhi_tpu_torch.app.pipeline import CEPPipeline, PipelineConfig
from flink_siddhi_tpu_torch.connectors.kafka.protocol import API_FETCH
from flink_siddhi_tpu_torch.runtime import kafka as port_kafka
from flink_siddhi_tpu_torch.runtime.faultinject import CrashPlan, wrap_job
from flink_siddhi_tpu_torch.runtime.sources import SocketLineSource

from tests import fake_kafka as jax_broker
from tests import torch_fake_kafka as port_broker

torch.set_num_threads(2)

FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
          ("timestamp", "long")]

# per package: its pipeline module, broker module, Kafka module and Job
_PKG = {
    "torch": dict(pipeline=port_pipeline, broker=port_broker,
                  kafka=port_kafka,
                  job=lambda plans, srcs, **kw: fpt.Job(plans, srcs,
                                                        device="cpu", **kw),
                  compile=fpt.compile_plan),
    "jax": dict(pipeline=jax_pipeline, broker=jax_broker, kafka=jax_kafka,
                job=JaxJob, compile=jax_compile),
}


def write_events(path, n=120):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"id": i % 4, "name": f"n{i % 3}",
                                "price": float(i),
                                "timestamp": 1000 + i}) + "\n")


def _kafka_events(n, start=0):
    return [json.dumps({"id": (start + i) % 4, "name": f"n{(start + i) % 3}",
                        "price": float(start + i),
                        "timestamp": 1000 + start + i})
            for i in range(n)]


def _pipe(pkg, cfg_kw, **kw):
    mod = _PKG[pkg]["pipeline"]
    cfg = mod.PipelineConfig(stream_id=cfg_kw.pop("stream_id", "S"),
                             fields=FIELDS, **cfg_kw)
    if pkg == "torch":
        kw["device"] = "cpu"
    return mod.CEPPipeline(cfg, **kw)


def _file_run(pkg, tmp_path, cfg_kw):
    outp = tmp_path / f"out-{pkg}.jsonl"
    pipe = _pipe(pkg, dict(cfg_kw, output_path=str(outp)),
                 sleep=lambda s: None)
    pipe.run()
    pipe.close()
    return [json.loads(line) for line in open(outp)]


# -- tests/test_app.py's pipeline cases --------------------------------------

def test_pipeline_end_to_end(tmp_path):
    inp = tmp_path / "in.jsonl"
    write_events(inp)
    cfg = dict(cql="from S[id == 2] select name, price insert into matches",
               input_path=str(inp), ts_field="timestamp", batch_size=32)
    rows = _file_run("torch", tmp_path, dict(cfg))
    assert len(rows) == 30
    assert rows[0]["stream"] == "matches"
    assert rows[0]["name"] == "n2" and rows[0]["price"] == 2.0
    assert rows[0]["ts"] == 1002
    assert rows == _file_run("jax", tmp_path, dict(cfg))


def test_pipeline_csv_file_equals_the_reference(tmp_path):
    inp = tmp_path / "in.csv"
    with open(inp, "w") as f:
        f.write("id,name,price,timestamp\n")
        for i in range(300):
            f.write(f"{i % 5},n{i % 3},{i * 0.5},{1000 + i}\n")
    cfg = dict(cql=("from S#window.length(10) select id, sum(price) as s, "
                    "count() as c group by id insert into o"),
               input_path=str(inp), format="csv", csv_header=True,
               ts_field="timestamp", batch_size=64, chunk_bytes=700)
    rows = _file_run("torch", tmp_path, dict(cfg))
    assert len(rows) == 300
    assert rows == _file_run("jax", tmp_path, dict(cfg))


def _flaky_run(pkg, tmp_path):
    """The reference test's crash injection: fail once after three
    checkpointed cycles, then the pipeline's restart resumes."""
    inp, outp = tmp_path / "in.jsonl", tmp_path / f"out-{pkg}.jsonl"
    ckpt = tmp_path / f"{pkg}.ckpt"
    write_events(inp, n=100)
    pipe = _pipe(pkg, dict(
        cql="from S[id == 1] select price insert into m",
        input_path=str(inp), output_path=str(outp), ts_field="timestamp",
        batch_size=16, chunk_bytes=512, checkpoint_path=str(ckpt),
        checkpoint_interval_s=0.0, restart_attempts=2, restart_delay_s=0.0,
    ), sleep=lambda s: None)
    crashed = {"done": False}
    cls = type(pipe)
    orig = cls._run_once

    def flaky(self):
        job = self.build()
        if ckpt.exists():
            job.restore(str(ckpt))
        cycles = 0
        while not job.finished:
            job.run_cycle()
            job.save_checkpoint(str(ckpt))
            cycles += 1
            if cycles == 3 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected fault")
        job.flush()
        job.drain_outputs()
        self.job = job

    cls._run_once = flaky
    try:
        pipe.run()
    finally:
        cls._run_once = orig
    pipe.close()
    assert crashed["done"]
    return [json.loads(line) for line in open(outp)]


def test_pipeline_restart_resumes_from_checkpoint(tmp_path):
    rows = _flaky_run("torch", tmp_path)
    prices = [r["price"] for r in rows]
    expected = [float(i) for i in range(100) if i % 4 == 1]
    assert set(expected) <= set(prices)
    # the same rows as the reference's restart, re-emitted tail included
    assert rows == _flaky_run("jax", tmp_path)


def test_pipeline_restart_exhaustion_raises(tmp_path):
    inp, outp = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    write_events(inp, n=10)
    pipe = _pipe("torch", dict(cql="from S select id insert into m",
                               input_path=str(inp), output_path=str(outp),
                               restart_attempts=2, restart_delay_s=0.0),
                 sleep=lambda s: None)
    calls = {"n": 0}

    def always_fail(self):
        calls["n"] += 1
        raise RuntimeError("boom")

    orig = CEPPipeline._run_once
    CEPPipeline._run_once = always_fail
    try:
        with pytest.raises(RuntimeError):
            pipe.run()
    finally:
        CEPPipeline._run_once = orig
    assert calls["n"] == 3  # initial + 2 restarts


def _kafka_roundtrip(pkg, legacy, n=200):
    broker = _PKG[pkg]["broker"].FakeBroker(legacy=legacy)
    try:
        broker.create_topic("in")
        broker.create_topic("out")
        broker.append("in", 0, _kafka_events(n))
        pipe = _pipe(pkg, dict(
            stream_id="inputStream",
            cql="from inputStream[id == 2] select name, price "
                "insert into out",
            input_path=f"kafka://{broker.bootstrap}/in",
            output_path=f"kafka://{broker.bootstrap}/out",
            ts_field="timestamp", time_mode="processing", batch_size=64,
            compression="none" if legacy else "gzip"))
        job = pipe.build()
        src = job._sources[0]
        while job.processed_events < n:
            job.run_cycle()
        src.close()
        while not job.finished:
            job.run_cycle()
        job.flush()
        job.drain_outputs()
        for sink in pipe._kafka_sinks:
            sink.flush()
        out = [json.loads(v.decode()) for _, v in broker.logs[("out", 0)]]
        pipe.close()
        return out
    finally:
        broker.close()


@pytest.mark.parametrize("legacy", [False, True], ids=["v2", "v0"])
def test_kafka_pipeline_roundtrip(legacy):
    n = 200
    out_rows = _kafka_roundtrip("torch", legacy, n)
    assert len(out_rows) == n // 4
    assert all(r["stream"] == "out" for r in out_rows)
    assert [r["name"] for r in out_rows] == [f"n{i % 3}"
                                             for i in range(2, n, 4)]
    assert [r["price"] for r in out_rows] == [float(i)
                                              for i in range(2, n, 4)]
    assert out_rows == _kafka_roundtrip("jax", legacy, n)


def _offsets_resume(pkg, tmp_path, gzip_batches):
    """A job over topic t checkpointed after 48 events, more events
    produced, the job rebuilt and restored: every event once."""
    p = _PKG[pkg]
    broker = p["broker"].FakeBroker()
    try:
        broker.create_topic("t")
        if gzip_batches:
            producer = p["kafka"].KafkaClient(broker.host, broker.port)
            producer.produce("t", 0, [e.encode() for e in _kafka_events(100)],
                             compression="gzip")
            producer.close()
            assert broker.bounds[("t", 0)] == [0]
        else:
            broker.append("t", 0, _kafka_events(100))
        schema = _pipe(pkg, dict(cql="", input_path="x",
                                 output_path="x")).config.schema()
        cql = "from S select id, price insert into o"
        seen = []

        def build_job():
            src = p["kafka"].KafkaSource("S", schema, broker.bootstrap, "t",
                                         ts_field="timestamp")
            job = p["job"]([p["compile"](cql, {"S": schema})], [src],
                           batch_size=32, time_mode="processing",
                           retain_results=False)
            job.add_sink("o", lambda ts, row: seen.append(row))
            return job, src

        ckpt = str(tmp_path / f"ckpt-{pkg}")
        job1, src1 = build_job()
        if gzip_batches:
            assert src1.client.api_versions()[API_FETCH] == 4
        while job1.processed_events < 48:
            job1.run_cycle()
        job1.save_checkpoint(ckpt)
        committed = dict(src1.offsets)
        if gzip_batches:
            assert 0 < committed[0] < 100  # the seam lies inside a batch
        taken_at = len(seen)
        if gzip_batches:
            producer2 = p["kafka"].KafkaClient(broker.host, broker.port)
            producer2.produce(
                "t", 0, [e.encode() for e in _kafka_events(40, start=100)],
                compression="gzip")
            producer2.close()
        else:
            broker.append("t", 0, _kafka_events(40, start=100))
        del seen[taken_at:]  # the failure: what followed the snapshot
        job2, src2 = build_job()
        job2.restore(ckpt)
        assert src2.offsets == committed
        src2.close()
        while not job2.finished:
            job2.run_cycle()
        job2.flush()
        job2.drain_outputs()
        assert len(seen) == 140
        assert sorted(price for _, price in seen) == \
            [float(i) for i in range(140)]
        return seen
    finally:
        broker.close()


def test_kafka_offsets_resume_across_restart(tmp_path):
    assert _offsets_resume("torch", tmp_path, False) == \
        _offsets_resume("jax", tmp_path, False)


def test_kafka_v2_gzip_resume_mid_batch(tmp_path):
    assert _offsets_resume("torch", tmp_path, True) == \
        _offsets_resume("jax", tmp_path, True)


# -- tests/test_socket_source.py ---------------------------------------------

SOCKET_SCHEMA = [("id", "int"), ("price", "double"), ("timestamp", "long")]


def _socket_job(src, cql):
    schema = src.schema
    return fpt.Job([fpt.compile_plan(cql, {"S": schema})], [src],
                   batch_size=64, time_mode="processing", device="cpu")


def test_socket_json_lines_end_to_end():
    schema = fpt.StreamSchema(list(SOCKET_SCHEMA))
    src = SocketLineSource("S", schema, port=0, ts_field="timestamp")
    job = _socket_job(src, "from S[id == 2] select id, price insert into o")
    lines = b"".join(b'{"id": %d, "price": %d.5, "timestamp": %d}\n'
                     % (i % 3, i, 1000 + i) for i in range(30))
    with socket.create_connection(("127.0.0.1", src.port)) as c:
        c.sendall(lines)
    deadline = time.time() + 10
    while time.time() < deadline:
        job.run_cycle()
        if len(job.results("o")) == 10:
            break
        time.sleep(0.01)
    src.close()
    job.run()  # drains and finishes after close
    rows = job.results("o")
    assert [r[0] for r in rows] == [2] * 10
    assert [r[1] for r in rows] == [i + 0.5 for i in range(2, 30, 3)]


def test_socket_csv_partial_lines_and_close():
    schema = fpt.StreamSchema(list(SOCKET_SCHEMA))
    src = SocketLineSource("S", schema, port=0, fmt="csv",
                           ts_field="timestamp")
    job = _socket_job(src, "from S select id insert into o")
    # one line split across two sends; the last line unterminated (the
    # reader flushes it on disconnect)
    with socket.create_connection(("127.0.0.1", src.port)) as c:
        c.sendall(b"1,0.5,10")
        time.sleep(0.05)
        c.sendall(b"00\n2,1.5,1001\n3,2.5,1002")
    time.sleep(0.2)
    src.close()
    job.run()
    assert [r[0] for r in job.results("o")] == [1, 2, 3]
    assert [t for t, _ in job.results_with_ts("o")] == [1000, 1001, 1002]


# -- what the port adds ------------------------------------------------------

def test_pipeline_runs_on_cuda_by_default_and_raises_without_it(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PipelineConfig(stream_id="S", fields=FIELDS,
                         cql="from S select id insert into o",
                         input_path="x", output_path=str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CEPPipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_pipeline.main([_config_file(tmp_path, cfg)])
    assert CEPPipeline(cfg, device="cpu").device == torch.device("cpu")


def _config_file(tmp_path, cfg):
    import dataclasses

    path = tmp_path / "pipeline.json"
    path.write_text(json.dumps(dataclasses.asdict(cfg)))
    return str(path)


def test_main_runs_a_config_file_on_the_cpu(tmp_path):
    inp, outp = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    write_events(inp, n=40)
    cfg = PipelineConfig(stream_id="S", fields=FIELDS,
                         cql="from S[id == 3] select price insert into m",
                         input_path=str(inp), output_path=str(outp),
                         ts_field="timestamp", batch_size=16)
    assert port_pipeline.main([_config_file(tmp_path, cfg), "--device",
                               "cpu"]) == 0
    assert [json.loads(line)["price"] for line in open(outp)] == \
        [float(i) for i in range(3, 40, 4)]


def _control_pipeline(pkg, tmp_path):
    from flink_siddhi_tpu.control import events as jax_events
    from flink_siddhi_tpu.runtime.sources import (
        ControlListSource as JaxControlList,
    )
    from flink_siddhi_tpu_torch.control import events as port_events
    from flink_siddhi_tpu_torch.runtime.sources import ControlListSource

    ev, ctl = ((port_events, ControlListSource) if pkg == "torch"
               else (jax_events, JaxControlList))
    add = ev.MetadataControlEvent.builder()
    add.add_execution_plan(
        "from every s1 = S[id == 1] -> s2 = S[id == 3] "
        "select s1.price as price, s2.name as name insert into matches",
        plan_id="chain")
    add.add_execution_plan(
        "from S[id == 0] select name, price insert into matches",
        plan_id="zeros")
    upd = ev.MetadataControlEvent.builder().update_execution_plan(
        "zeros", "from S[id == 0 and price > 90.0] select name, price "
                 "insert into matches").build()
    drop = ev.MetadataControlEvent.builder().remove_execution_plan(
        "chain").build()
    control = ctl([
        (1020, add.build()),
        (1040, ev.OperationControlEvent.disable_query("chain")),
        (1050, ev.OperationControlEvent.enable_query("chain")),
        (1070, upd),
        (1100, drop),
    ])
    inp = tmp_path / f"in-{pkg}.jsonl"
    write_events(inp)
    outp = tmp_path / f"out-{pkg}.jsonl"
    pipe = _pipe(pkg, dict(
        cql="from S[id == 2] select name, price insert into matches",
        input_path=str(inp), output_path=str(outp), ts_field="timestamp",
        batch_size=8), control_sources=[control], sleep=lambda s: None)
    job = pipe.run()
    pipe.close()
    status = job.control_status()["counters"]
    return ([json.loads(line) for line in open(outp)], sorted(job.plan_ids),
            {k: status.get(k) for k in ("admitted", "retired",
                                        "stack_join")})


def test_pipeline_control_sources_match_the_reference(tmp_path):
    # three plans write one stream: their rows interleave by drain, so
    # compare them in (ts, name, price) order
    def key(r):
        return r["ts"], r["name"], r["price"]

    rows, ids, counters = _control_pipeline("torch", tmp_path)
    ref_rows, ref_ids, ref_counters = _control_pipeline("jax", tmp_path)
    assert sorted(rows, key=key) == sorted(ref_rows, key=key)
    assert (ids, counters) == (ref_ids, ref_counters)
    assert ids == ["plan", "zeros"]
    assert counters == {"admitted": 3, "retired": 2, "stack_join": None}
    # 'zeros' (id 0: ts = 0 mod 4, price = ts - 1000) runs from its add
    # to the end, with only prices above 90 after its update
    zeros = [r["ts"] for r in rows if r["ts"] % 4 == 0]
    assert 1000 not in zeros and 1060 in zeros and 1096 in zeros
    assert not any(1080 <= t <= 1090 for t in zeros)


def test_transactional_output_needs_kafka_and_checkpoints(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_path"):
        CEPPipeline(PipelineConfig(
            stream_id="S", fields=FIELDS, cql="", input_path="x",
            output_path="kafka://127.0.0.1:1/o", transactional_id="t"),
            device="cpu")
    with pytest.raises(ValueError, match="kafka://"):
        CEPPipeline(PipelineConfig(
            stream_id="S", fields=FIELDS, cql="", input_path="x",
            output_path=str(tmp_path / "o"), transactional_id="t",
            checkpoint_path=str(tmp_path / "c")), device="cpu")


# a chain pattern (the headline's shape, K1 and K2 on the card) over a
# 4-partition topic in event time
PATTERN = ("from every s1 = S[id == 1] -> s2 = S[id == 2] -> "
           "s3 = S[id == 3] within 50 milliseconds "
           "select s1.timestamp as t1, s3.timestamp as t3, s3.price as price "
           "insert into matches")


class _Bounded(CEPPipeline):
    """The pipeline over a bounded topic (its source closed at build:
    drain the topic, then finish), armed with ``crash``'s kill points."""

    crash = None

    def build(self):
        job = super().build()
        job._sources[0].close()
        return job if self.crash is None else wrap_job(job, self.crash)


def _pattern_topic(broker, n, per_batch, parts=4):
    """Round-robin batches of ``per_batch`` records over ``parts``
    partitions. With ``fetch_max_bytes=1`` a fetch brings one batch of
    each partition and a poll takes them all, as at full size. (A poll
    smaller than a fetch would take the partitions one after another, and
    a partition that has not produced yet pins no watermark.)"""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 6, n)
    price = np.round(rng.random(n) * 100, 3)
    broker.create_topic("in", partitions=parts)
    broker.create_topic("out")
    for b, s in enumerate(range(0, n, per_batch)):
        broker.append("in", b % parts, [
            json.dumps({"id": int(ids[i]), "name": "e",
                        "price": float(price[i]), "timestamp": 1000 + i})
            for i in range(s, min(n, s + per_batch))])
    cols = {"id": ids.astype(np.int32), "price": price,
            "timestamp": 1000 + np.arange(n, dtype=np.int64)}
    return cols


def _in_order_rows(cols):
    """The port's streaming Job over the same events in order."""
    schema = fpt.StreamSchema(list(FIELDS))
    code = schema.string_tables["name"].intern("e")
    n = len(cols["id"])
    batch = fpt.EventBatch("S", schema, {
        "id": cols["id"], "name": np.full(n, code, np.int32),
        "price": cols["price"], "timestamp": cols["timestamp"]},
        cols["timestamp"])
    job = fpt.Job([fpt.compile_plan(PATTERN, {"S": schema})],
                  [fpt.BatchSource("S", schema, iter([batch]))],
                  batch_size=n, device="cpu")
    job.run()
    return [(t, dict(zip(("t1", "t3", "price"), r)))
            for t, r in job.results_with_ts("matches")]


def _committed(broker):
    return [json.loads(v) for v in
            port_broker.read_topic(broker.bootstrap, "out")]


@pytest.mark.parametrize("crash", [None, (3, 7, 2)],
                         ids=["unfaulted", "killed"])
def test_transactional_kafka_pipeline_exactly_once(tmp_path, crash):
    """kafka:// in (4 partitions, per-partition watermarks) -> a chain
    pattern -> a transactional kafka:// out, checkpointed every cycle;
    killed at two source pulls and inside a checkpoint and restarted by
    the pipeline's own restart strategy: the committed output equals the
    in-order Job's rows, 0 duplicated and 0 lost."""
    n, per_batch = 4_096, 128
    broker = port_broker.FakeBroker()
    try:
        cols = _pattern_topic(broker, n, per_batch)
        cfg = PipelineConfig(
            stream_id="S", fields=FIELDS, cql=PATTERN,
            input_path=f"kafka://{broker.bootstrap}/in",
            output_path=f"kafka://{broker.bootstrap}/out",
            ts_field="timestamp", batch_size=1_024, watermark_skew_ms=0,
            fetch_max_bytes=1,
            checkpoint_path=str(tmp_path / "ckpt"),
            checkpoint_interval_s=0.0, restart_attempts=4,
            restart_delay_s=0.0, transactional_id="cep")
        pipe = _Bounded(cfg, device="cpu", sleep=lambda s: None)
        if crash is not None:
            pipe.crash = CrashPlan(at_pulls=crash[:2],
                                   at_checkpoints=crash[2:])
        pipe.run()
        stats = [s.txn_stats() for s in pipe._kafka_sinks]
        pipe.close()
        want = _in_order_rows(cols)
        got = [(r.pop("ts"), r) for r in _committed(broker)]
        assert len(want) > 20
        for _, r in got:
            assert r.pop("stream") == "matches"
        assert sorted(got, key=repr) == sorted(want, key=repr)
        assert collections.Counter(map(repr, got)) == \
            collections.Counter(map(repr, want))
        assert pipe.job.late_events == 0
        assert not stats[0]["pending"] and stats[0]["commits"] >= 1
        if crash is not None:
            assert pipe.crash.crashes == 3
            # the restored sinks resumed or fenced what the dead ones
            # left: uncommitted rows exist on the wire, never committed
            uncommitted = port_broker.read_topic(broker.bootstrap, "out",
                                                 committed=False)
            assert len(uncommitted) >= len(got)
    finally:
        broker.close()
