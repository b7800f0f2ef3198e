"""The port's Kafka layer (``connectors/kafka/``, ``runtime/kafka.py``:
exact copies of the reference's) driving the port's engine, on the CPU.

* The wire codecs (varints, CRC-32C, v0/v1 message sets, v2 record
  batches) byte-equal to the JAX package's on seeded inputs.
* The two packages' clients and brokers are interchangeable: the port's
  ``KafkaSource`` reading from the reference's ``FakeBroker`` and the
  reference's reading from ``tests/torch_fake_kafka.py`` give the same
  batches and watermarks.
* ``tests/test_event_time.py``'s four per-partition watermark cases.
* Both Kafka cases of ``tests/test_faults.py`` against the port's Job
  (seeds 7, 23 supervised; 1, 17 unsupervised): rows equal to the JAX
  package's, exactly once, and the ``faults.kafka.*`` counters in the
  Job's registry (``Job`` binds its sources' telemetry).
* A checkpoint file holding ``KafkaSource`` offsets and watermark state
  and a ``KafkaSink``'s pending transaction, written by one package and
  restored by the other, both ways: the restored sink resumes the
  commit, and the output topic holds the unfaulted run's rows once.
"""

import glob
import json

import numpy as np
import pytest
import torch

from flink_siddhi_tpu.compiler.plan import compile_plan as jax_compile
from flink_siddhi_tpu.connectors.kafka.crc32c import crc32c as jax_crc32c
from flink_siddhi_tpu.connectors.kafka import records as jax_records
from flink_siddhi_tpu.connectors.kafka import varint as jax_varint
from flink_siddhi_tpu.runtime import kafka as jax_kafka
from flink_siddhi_tpu.runtime.executor import Job as JaxJob
from flink_siddhi_tpu.runtime.sources import (
    BoundedDisorderWatermark as JaxBounded,
)
from flink_siddhi_tpu.runtime.sources import ListSource as JaxListSource
from flink_siddhi_tpu.schema.stream_schema import StreamSchema as JaxSchema

import flink_siddhi_tpu_torch as fpt
from flink_siddhi_tpu_torch.connectors.kafka.crc32c import (
    crc32c as port_crc32c,
)
from flink_siddhi_tpu_torch.connectors.kafka import records as port_records
from flink_siddhi_tpu_torch.connectors.kafka import varint as port_varint
from flink_siddhi_tpu_torch.connectors.kafka.codecs import (
    CODEC_GZIP,
    CODEC_NONE,
)
from flink_siddhi_tpu_torch.connectors.kafka.retry import RetryPolicy
from flink_siddhi_tpu_torch.runtime import kafka as port_kafka
from flink_siddhi_tpu_torch.runtime.faultinject import CrashPlan, wrap_job
from flink_siddhi_tpu_torch.runtime.kafka import (
    KafkaClient,
    KafkaSink,
    KafkaSource,
)
from flink_siddhi_tpu_torch.runtime.sources import (
    BoundedDisorderWatermark,
    ListSource,
)
from flink_siddhi_tpu_torch.runtime.supervisor import Supervisor
from flink_siddhi_tpu_torch.telemetry import MetricsRegistry

from tests import fake_kafka as jax_broker
from tests import torch_fake_kafka as port_broker
from tests.faults import FaultSchedule

torch.set_num_threads(2)

FIELDS = [("id", "int"), ("name", "string"), ("price", "double"),
          ("timestamp", "long")]
# stateful: the window ring and running sums must survive every restore
CQL = ("from S#window.length(6) select id, sum(price) as t, "
       "count() as c insert into out")


def _records(n, start=0):
    return [json.dumps({"id": (start + i) % 4, "name": f"n{(start + i) % 3}",
                        "price": float(start + i),
                        "timestamp": 1000 + 10 * (start + i)})
            for i in range(n)]


def _record_tuples(n):
    return [((i % 4), f"n{i % 3}", float(i), 1000 + 10 * i)
            for i in range(n)]


def _test_retry(seed=0):
    return RetryPolicy(max_attempts=6, base_delay_ms=1.0, max_delay_ms=4.0,
                       seed=seed)


def _oracle_rows(n, cql=CQL, batch_size=16):
    """The unfaulted ground truth: the port's plain job over the same
    logical stream, held equal to the JAX package's."""
    schema = fpt.StreamSchema(list(FIELDS))
    job = fpt.Job([fpt.compile_plan(cql, {"S": schema})],
                  [ListSource("S", schema, _record_tuples(n),
                              ts_field="timestamp")],
                  batch_size=batch_size, device="cpu")
    job.run()
    got = job.results_with_ts("out")
    jschema = JaxSchema(list(FIELDS))
    jjob = JaxJob([jax_compile(cql, {"S": jschema})],
                  [JaxListSource("S", jschema, _record_tuples(n),
                                 ts_field="timestamp")],
                  batch_size=batch_size)
    jjob.run()
    assert got == jjob.results_with_ts("out")
    return got


# -- the wire codecs, byte for byte ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_varint_and_crc32c_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-2**31, 2**31, 200).tolist() + [0, -1, 2**31 - 1]
    longs = rng.integers(-2**63, 2**63 - 1, 200, dtype=np.int64).tolist()
    for n in ints:
        b = port_varint.encode_varint(n)
        assert b == jax_varint.encode_varint(n)
        assert port_varint.decode_varint(b) == jax_varint.decode_varint(b)
    for n in longs:
        b = port_varint.encode_varlong(n)
        assert b == jax_varint.encode_varlong(n)
        assert port_varint.decode_varlong(b) == jax_varint.decode_varlong(b)
    for size in (0, 1, 7, 64, 1000):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert port_crc32c(data) == jax_crc32c(data)


@pytest.mark.parametrize("codec", [CODEC_NONE, CODEC_GZIP])
@pytest.mark.parametrize("seed", [3, 4])
def test_record_batches_equal_the_reference(codec, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    ts0 = int(rng.integers(0, 2**40))
    entries = []
    for i in range(n):
        key = None if rng.random() < 0.5 else rng.bytes(int(
            rng.integers(0, 12)))
        value = None if rng.random() < 0.05 else rng.bytes(int(
            rng.integers(0, 90)))
        entries.append((ts0 + int(rng.integers(0, 10_000)), key, value))
    kw = dict(base_offset=int(rng.integers(0, 2**40)), codec=codec,
              producer_id=int(rng.integers(0, 2**40)), producer_epoch=3,
              base_sequence=int(rng.integers(0, 2**20)), transactional=True)
    batch = port_records.encode_record_batch(entries, **kw)
    assert batch == jax_records.encode_record_batch(entries, **kw)
    assert port_records.decode_record_batch(batch) == \
        jax_records.decode_record_batch(batch)
    assert port_records.decode_batch_meta(batch) == \
        jax_records.decode_batch_meta(batch)
    values = [v for _, _, v in entries if v is not None]
    for magic in (0, 1):
        mset = port_records.encode_message_set(values, magic=magic,
                                               ts_ms=ts0)
        assert mset == jax_records.encode_message_set(values, magic=magic,
                                                      ts_ms=ts0)
        assert port_records.decode_record_set(mset) == \
            jax_records.decode_record_set(mset)
    ctrl = port_records.encode_control_batch(7, 1001, 2, commit=True)
    assert ctrl == jax_records.encode_control_batch(7, 1001, 2, commit=True)


# -- the packages' clients and brokers are interchangeable ------------------

def _fill(broker, n_parts=3):
    rng = np.random.default_rng(21)
    broker.create_topic("t", partitions=n_parts)
    t = 0
    for b in range(12):
        recs = []
        for _ in range(int(rng.integers(5, 40))):
            t += int(rng.integers(0, 30))
            recs.append(json.dumps({
                "id": int(rng.integers(0, 5)),
                "name": f"n{int(rng.integers(0, 4))}",
                "price": float(rng.random()), "timestamp": 1000 + t}))
        broker.append("t", b % n_parts, recs)


def _drain(src, max_events):
    out = []
    for _ in range(200):
        batch, wm, done = src.poll(max_events)
        out.append((None if batch is None else
                    (batch.timestamps.tolist(),
                     {k: v.tolist() for k, v in batch.columns.items()}),
                    wm, done))
        if done:
            return out
    raise AssertionError("source never finished")


@pytest.mark.parametrize("max_events", [17, 64])
def test_sources_across_the_packages_give_the_same_batches(max_events):
    """The port's source on the reference's broker and the reference's
    source on the port's broker: the same batches, watermarks and
    checkpointed positions."""
    ref_broker, port_b = jax_broker.FakeBroker(), port_broker.FakeBroker()
    try:
        _fill(ref_broker)
        _fill(port_b)
        port_src = KafkaSource("S", fpt.StreamSchema(list(FIELDS)),
                               ref_broker.bootstrap, "t",
                               ts_field="timestamp",
                               watermark=BoundedDisorderWatermark(50))
        ref_src = jax_kafka.KafkaSource("S", JaxSchema(list(FIELDS)),
                                        port_b.bootstrap, "t",
                                        ts_field="timestamp",
                                        watermark=JaxBounded(50))
        port_src.close()
        ref_src.close()
        got, want = _drain(port_src, max_events), _drain(ref_src, max_events)
        assert got == want
        assert sum(len(b[0]) for b, _, _ in got if b) == sum(
            len(v) for v in port_b.logs.values())
        assert port_src.state_dict() == ref_src.state_dict()
    finally:
        ref_broker.close()
        port_b.close()


# -- per-partition watermarks (tests/test_event_time.py:649-794) -------------

def _wm_schema():
    return fpt.StreamSchema([("id", "int"), ("price", "double"),
                             ("timestamp", "long")])


def _rec(i, t):
    return json.dumps({"id": i, "price": 1.0, "timestamp": t}).encode()


def test_kafka_per_partition_watermark_min_across_partitions():
    broker = port_broker.FakeBroker()
    try:
        broker.create_topic("t", partitions=2)
        broker.append("t", 0, [_rec(1, 10_000), _rec(2, 20_000)])
        broker.append("t", 1, [_rec(3, 5_000)])
        schema = _wm_schema()
        src = KafkaSource("S", schema, broker.bootstrap, "t",
                          ts_field="timestamp",
                          watermark=BoundedDisorderWatermark(1_000))
        batch, wm, done = src.poll(64)
        assert len(batch) == 3 and not done
        assert wm == 3_999
        d = src.state_dict()
        assert set(d["wm"]) == {"0", "1"}
        src2 = KafkaSource("S", schema, broker.bootstrap, "t",
                           ts_field="timestamp",
                           watermark=BoundedDisorderWatermark(1_000))
        src2.load_state_dict(d)
        assert src2._partition_watermark() == 3_999
        broker.append("t", 1, [_rec(4, 21_000)])
        batch, wm, done = src.poll(64)
        assert len(batch) == 1
        assert wm == 18_999
    finally:
        broker.close()


def test_kafka_empty_partition_does_not_pin_watermark():
    broker = port_broker.FakeBroker()
    try:
        broker.create_topic("t", partitions=2)
        broker.append("t", 0, [_rec(1, 50_000)])
        src = KafkaSource("S", _wm_schema(), broker.bootstrap, "t",
                          ts_field="timestamp",
                          watermark=BoundedDisorderWatermark(1_000))
        batch, wm, _ = src.poll(64)
        assert len(batch) == 1
        assert wm == 48_999
    finally:
        broker.close()


def test_kafka_partition_idleness_unpins_min_watermark():
    broker = port_broker.FakeBroker()
    try:
        broker.create_topic("t", partitions=2)
        broker.append("t", 0, [_rec(1, 10_000)])
        broker.append("t", 1, [_rec(2, 5_000)])

        def make_src():
            return KafkaSource("S", _wm_schema(), broker.bootstrap, "t",
                               ts_field="timestamp",
                               watermark=BoundedDisorderWatermark(1_000),
                               idle_timeout_ms=0)

        src = make_src()
        reg = MetricsRegistry()
        src.bind_telemetry(reg)
        _b, wm, _d = src.poll(64)
        assert wm == 3_999
        broker.append("t", 0, [_rec(3, 30_000)])
        _b, wm, _d = src.poll(64)
        assert src._part_idle[1] and not src._part_idle[0]
        assert wm == 28_999
        assert reg.counter("idle.partition_marked").value == 1
        d = src.state_dict()
        assert d["part_idle"] == {"0": False, "1": True}
        src2 = make_src()
        src2.load_state_dict(d)
        assert src2._part_idle[1]
        assert src2._partition_watermark() == 28_999
        _b, wm, done = src.poll(64)
        assert (wm, done) == (None, False)
        assert src._part_idle[0] and src._part_idle[1]
        broker.append("t", 1, [_rec(4, 6_000)])
        _b, wm, _d = src.poll(64)
        assert not src._part_idle[1] and src._part_idle[0]
        assert wm == 4_999
        assert reg.counter("idle.partition_unidled").value == 1
    finally:
        broker.close()


def test_kafka_partition_with_buffered_backlog_is_not_idle():
    broker = port_broker.FakeBroker()
    try:
        broker.create_topic("t", partitions=2)
        broker.append("t", 0, [_rec(i, 10_000 + 1_000 * i)
                               for i in range(4)])
        broker.append("t", 1, [_rec(9, 5_000)])
        src = KafkaSource("S", _wm_schema(), broker.bootstrap, "t",
                          ts_field="timestamp",
                          watermark=BoundedDisorderWatermark(1_000),
                          idle_timeout_ms=0)
        _b, wm, _d = src.poll(2)
        assert not src._part_idle[1]
        assert wm == 9_999
        _b, wm, _d = src.poll(64)
        assert not src._part_idle[1]
        assert wm == 3_999
    finally:
        broker.close()


# -- tests/test_faults.py's Kafka cases against the port ---------------------

@pytest.mark.parametrize("seed", [7, 23])
def test_supervised_kafka_exactly_once_under_fault_schedule(tmp_path, seed):
    n = 96
    broker = port_broker.FakeBroker()
    try:
        broker.create_topic("t")
        for start in range(0, n, 16):
            broker.append("t", 0, _records(16, start=start))
        broker.fault_hook = FaultSchedule(seed, p_fault=0.25)
        crash = CrashPlan(at_pulls=(4, 9), at_checkpoints=(2,))
        schema = fpt.StreamSchema(list(FIELDS))

        def factory():
            src = KafkaSource("S", schema, broker.bootstrap, "t",
                              ts_field="timestamp",
                              client=KafkaClient(broker.host, broker.port,
                                                 retry=_test_retry(seed)))
            src.close()  # bounded run: drain the topic, then finish
            job = fpt.Job([fpt.compile_plan(CQL, {"S": schema})], [src],
                          batch_size=16, retain_results=False, device="cpu")
            return wrap_job(job, crash)

        ckpt = str(tmp_path / "ckpt")
        sup = Supervisor(factory, ckpt, checkpoint_every_cycles=3,
                         keep_checkpoints=3, max_restarts=10,
                         restart_window_s=3600.0)
        sup.run()
        assert crash.crashes == 3
        assert sup.restart_count == 3
        assert sup.results_with_ts("out") == _oracle_rows(n)
        assert glob.glob(f"{ckpt}.tmp.*") == []
        tel = sup.telemetry.snapshot()
        assert tel["counters"]["faults.crashes"] == 3
        assert tel["counters"]["recovery.checkpoints"] >= 2
        assert tel["histograms"]["recovery.restore_ms"]["count"] >= 1
        h = sup.health()
        assert h["alive"] and h["finished"] and h["restarts"] == 3
    finally:
        broker.close()


@pytest.mark.parametrize("seed", [1, 17])
def test_kafka_source_survives_wire_faults_unsupervised(seed):
    n = 64
    broker = port_broker.FakeBroker()
    try:
        broker.create_topic("t")
        for start in range(0, n, 16):
            broker.append("t", 0, _records(16, start=start))
        schedule = FaultSchedule(seed, p_fault=0.3)
        broker.fault_hook = schedule
        schema = fpt.StreamSchema(list(FIELDS))
        src = KafkaSource("S", schema, broker.bootstrap, "t",
                          ts_field="timestamp",
                          client=KafkaClient(broker.host, broker.port,
                                             retry=_test_retry(seed)))
        src.close()
        job = fpt.Job([fpt.compile_plan(CQL, {"S": schema})], [src],
                      batch_size=16, device="cpu")
        job.run()
        assert job.results_with_ts("out") == _oracle_rows(n)
        counters = job.metrics()["telemetry"]["counters"]
        faults = {k: v for k, v in counters.items()
                  if k.startswith("faults.kafka.")}
        # the client's own account reached the Job's registry whole
        assert faults == src.client.fault_counts
        if any(a != "delay" for _, _, a in schedule.injected):
            assert sum(faults.values()) >= 1
    finally:
        broker.close()


def test_sink_fault_counters_reach_the_jobs_registry():
    """``add_sink`` binds a KafkaSink's telemetry: its txn lifecycle
    (``faults.txn.*``) counts in the Job's registry."""
    broker = port_broker.FakeBroker()
    try:
        broker.create_topic("t")
        broker.create_topic("o")
        broker.append("t", 0, _records(32))
        schema = fpt.StreamSchema(list(FIELDS))
        src = KafkaSource("S", schema, broker.bootstrap, "t",
                          ts_field="timestamp")
        src.close()
        job = fpt.Job([fpt.compile_plan(CQL, {"S": schema})], [src],
                      batch_size=16, retain_results=False, device="cpu")
        sink = KafkaSink(broker.bootstrap, "o", ["id", "t", "c"],
                         transactional_id="tx", flush_every=8)
        job.add_sink("out", sink)
        job.run()
        job.drain_outputs()
        sink.prepare_commit()
        sink.commit_transaction()
        counters = job.metrics()["telemetry"]["counters"]
        assert counters["faults.txn.begin"] == 1
        assert counters["faults.txn.commit"] == 1
        assert len(port_broker.read_topic(broker.bootstrap, "o")) == 32
    finally:
        broker.close()


# -- a checkpoint with offsets and a pending transaction, both ways ----------

_PKGS = {
    "torch": dict(kafka=port_kafka, Bounded=BoundedDisorderWatermark,
                  schema=lambda: fpt.StreamSchema(list(FIELDS)),
                  job=lambda plans, srcs: fpt.Job(plans, srcs, batch_size=32,
                                                  retain_results=False,
                                                  device="cpu"),
                  compile=fpt.compile_plan),
    "jax": dict(kafka=jax_kafka, Bounded=JaxBounded,
                schema=lambda: JaxSchema(list(FIELDS)),
                job=lambda plans, srcs: JaxJob(plans, srcs, batch_size=32,
                                               retain_results=False),
                compile=jax_compile),
}


def _txn_job(pkg, broker):
    """A Job of ``pkg`` over topic t (2 partitions, per-partition
    watermarks) into a transactional sink on topic o. A fetch brings one
    16-record batch of each partition, and a poll takes both."""
    p = _PKGS[pkg]
    schema = p["schema"]()
    src = p["kafka"].KafkaSource("S", schema, broker.bootstrap, "t",
                                 ts_field="timestamp", max_bytes=1,
                                 watermark=p["Bounded"](0))
    job = p["job"]([p["compile"](CQL, {"S": schema})], [src])
    sink = p["kafka"].KafkaSink(broker.bootstrap, "o", ["id", "t", "c"],
                                stream_id="out", transactional_id="pipe",
                                flush_every=8)
    job.add_sink("out", sink)
    return job, src, sink


def _topic_rows(broker, committed=True):
    return [json.loads(v) for v in
            port_broker.read_topic(broker.bootstrap, "o",
                                   committed=committed)]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_checkpoint_with_offsets_and_pending_txn_moves_between_packages(
        tmp_path, writer, reader):
    n = 160
    broker = port_broker.FakeBroker()
    try:
        broker.create_topic("t", partitions=2)
        broker.create_topic("o")
        for b, start in enumerate(range(0, n, 16)):
            broker.append("t", b % 2, _records(16, start=start))
        # the unfaulted run of the writer's package: the output topic's
        # rows once everything committed
        ref_broker = port_broker.FakeBroker()
        try:
            ref_broker.create_topic("t", partitions=2)
            ref_broker.create_topic("o")
            for b, start in enumerate(range(0, n, 16)):
                ref_broker.append("t", b % 2, _records(16, start=start))
            job, src, sink = _txn_job(writer, ref_broker)
            src.close()
            job.run()
            job.save_checkpoint(str(tmp_path / "whole"))
            job.commit_sink_transactions()
            want = _topic_rows(ref_broker)
        finally:
            ref_broker.close()
        assert len(want) == n

        ckpt = str(tmp_path / "ckpt")
        job, src, sink = _txn_job(writer, broker)
        for _ in range(4):
            job.run_cycle()
        # phase one only: the snapshot carries the open transaction,
        # then the writer dies before EndTxn
        job.save_checkpoint(ckpt)
        assert sink.txn_stats()["pending"]
        pending_rows = len(_topic_rows(broker, committed=False))
        assert pending_rows > 0 and _topic_rows(broker) == []
        offsets = dict(src.offsets)
        sink.client.close()
        src.client.close()

        job2, src2, sink2 = _txn_job(reader, broker)
        job2.restore(ckpt)
        assert src2.offsets == offsets
        # the restored sink resumed the snapshot's commit
        assert sink2.txn_stats()["resumed"] == 1
        assert len(_topic_rows(broker)) == pending_rows
        src2.close()
        job2.run()
        job2.save_checkpoint(ckpt)
        job2.commit_sink_transactions()
        got = _topic_rows(broker)
        assert got == want  # 0 duplicated, 0 lost, in order
    finally:
        broker.close()
