"""Config-driven, restartable CEP pipeline.

Parity target: the reference's deployable job (CEPPipeline.scala:33-78):
Kafka JSON data topic -> SiddhiCEP.cql(...) -> Kafka sink, with
checkpointing every 5 s and a fixed-delay restart strategy (4 attempts,
10 s apart, CEPPipeline.scala:35-38). Here the endpoints are byte
streams (files, pipes, sockets wrapped as file objects) decoded by the
native column decoder, the engine is the port's plan executor on a CUDA
device (``device``; ``"cpu"`` only when the caller asks), and the
restart strategy resumes from the latest on-disk checkpoint — which the
reference could not do (its engine-state restore was left TODO,
AbstractSiddhiOperator.java:341).

With ``transactional_id`` set, a ``kafka://`` output is the two-phase
commit ``KafkaSink``: each checkpoint's rows commit after the checkpoint
is on disk, so a read-committed consumer of the output topic sees every
row exactly once across crashes and restarts. ``fetch_max_bytes`` sizes
a ``kafka://`` input's fetches. ``control_sources`` (a
``ControlListSource``, or the ``ControlQueueSource`` a
``QueryControlService`` pushes onto) add, update, retire and pause
queries while the job runs; their CQL compiles against the pipeline's
stream.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..compiler.plan import compile_plan
from ..device import DeviceLike, resolve_device
from ..extensions.registry import ExtensionRegistry, builtin_registry
from ..runtime.executor import ColumnarSink, Job
from ..runtime.sources import CsvSource, JsonLinesSource
from ..schema.stream_schema import StreamSchema
from ..schema.types import AttributeType

_LOG = logging.getLogger(__name__)

_TYPES = {t.name.lower(): t for t in AttributeType}


def _parse_kafka_url(url: str) -> Tuple[str, str]:
    """kafka://host:port/topic -> (host:port, topic)."""
    rest = url[len("kafka://"):]
    bootstrap, _, topic = rest.partition("/")
    if not bootstrap or not topic:
        raise ValueError(
            f"kafka url must be kafka://host:port/topic, got {url!r}"
        )
    return bootstrap, topic


@dataclass
class PipelineConfig:
    """Everything needed to deploy one CEP job (the reference reads the
    same shape from CLI ParameterTool, CEPPipeline.scala:23-30)."""

    stream_id: str
    fields: Sequence[Tuple[str, str]]  # (name, type name: int/long/...)
    cql: str
    input_path: str  # newline-delimited JSON (or CSV with format='csv')
    output_path: str  # JSON-lines sink, '-' = stdout
    format: str = "json"  # 'json' | 'csv'
    ts_field: Optional[str] = None  # event-time field (epoch ms)
    time_mode: str = "event"
    batch_size: int = 8192
    checkpoint_path: Optional[str] = None
    checkpoint_interval_s: float = 5.0  # reference: enableCheckpointing(5000)
    restart_attempts: int = 4  # reference: fixedDelayRestart(4, 10s)
    restart_delay_s: float = 10.0
    csv_header: bool = False
    csv_delim: str = ","
    chunk_bytes: int = 1 << 20  # ingest read granularity
    allowed_lateness_ms: int = 0  # bounded ts disorder in the input
    # (watermark holdback; 0 requires globally sorted ts_field)
    compression: str = "none"  # produce-side codec for kafka:// output
    # ('none' | 'gzip'; connectors.kafka.codecs names — needs a broker
    # negotiating Produce >= 3, i.e. v2 record batches)
    # -- event-time robustness (docs/event_time.md) -----------------------
    # watermark generation: when set, the source's watermark is
    # GENERATED as max-observed-ts - skew - 1 (BoundedDisorderWatermark;
    # per-partition for kafka:// inputs) instead of trusting the
    # transport's native claim. None keeps the historical claim
    # (max ts - allowed_lateness_ms).
    watermark_skew_ms: Optional[int] = None
    # late rows (below the released watermark): 'drop' (counted) |
    # 'side_output' (full rows on '<stream>@late') | 'allow' (in-order
    # admission within allowed_lateness_ms)
    late_policy: str = "drop"
    # a source silent this long stops pinning the min watermark
    # (None = never; see Job.idle_timeout_ms)
    idle_timeout_ms: Optional[float] = None
    # kafka:// output only: the two-phase-commit sink's id (one sink an
    # output stream, id f"{transactional_id}.{stream}"); needs
    # checkpoint_path. None: the plain at-least-once producer
    transactional_id: Optional[str] = None
    # kafka:// input only: the bytes a fetch asks of each partition
    # (KafkaSource's max_bytes; a broker returns at least one whole batch)
    fetch_max_bytes: int = 1 << 20

    def schema(self) -> StreamSchema:
        return StreamSchema(
            [(n, _TYPES[t.lower()]) for n, t in self.fields]
        )

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        d = json.loads(text)
        d["fields"] = [tuple(f) for f in d["fields"]]
        return cls(**d)


class _JsonLinesColumnarSink(ColumnarSink):
    """File/stdout egress on the columnar sink fast lane: one JSON
    object per emitted row, serialized from whole column arrays. The
    pipeline runs with retention off, so on a single-consumer stream no
    per-row tuples ever materialize between the drained device buffer
    and the bytes on disk; on streams that decode row-wise (mixed
    consumers, side channels) the runtime converts once per batch and
    this sink observes identical data."""

    def __init__(self, out, stream_id: str, names: Sequence[str]) -> None:
        self._out = out
        self._sid = stream_id
        self._names = list(names)

    def accept_columns(self, ts, cols) -> None:
        names = self._names
        col_lists = [cols[n].tolist() for n in names]
        sid = self._sid
        dumps = json.dumps
        lines = [
            dumps({"stream": sid, "ts": t, **dict(zip(names, vals))})
            for t, *vals in zip(ts.tolist(), *col_lists)
        ]
        self._out.write("\n".join(lines) + "\n")


class CEPPipeline:
    """Build + run a restartable pipeline from a PipelineConfig."""

    def __init__(
        self,
        config: PipelineConfig,
        extensions: Optional[ExtensionRegistry] = None,
        control_sources: Sequence = (),
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        device: DeviceLike = None,  # None = the CUDA device
    ) -> None:
        if config.transactional_id is not None and (
            not config.output_path.startswith("kafka://")
            or not config.checkpoint_path
        ):
            raise ValueError(
                "transactional_id needs a kafka:// output_path and a "
                "checkpoint_path (rows commit with each checkpoint)"
            )
        self.device = resolve_device(device)
        self.config = config
        self.extensions = extensions or builtin_registry()
        self._control_sources = list(control_sources)
        self._clock = clock
        self._sleep = sleep
        self.job: Optional[Job] = None
        self._out = None

    # -- graph build (the reference's main(), CEPPipeline.scala:33-72) ----
    def build(self) -> Job:
        cfg = self.config
        schema = cfg.schema()
        if cfg.input_path.startswith("kafka://"):
            # kafka://host:port/topic — the reference's deployable shape
            # (FlinkKafkaConsumer010, CEPPipeline.scala:49-51); offsets
            # checkpoint as the source position
            from ..runtime.kafka import KafkaSource
            from ..runtime.sources import BoundedDisorderWatermark

            bootstrap, topic = _parse_kafka_url(cfg.input_path)
            src = KafkaSource(
                cfg.stream_id, schema, bootstrap, topic,
                fmt=cfg.format, delim=cfg.csv_delim,
                ts_field=cfg.ts_field, max_bytes=cfg.fetch_max_bytes,
                allowed_lateness_ms=cfg.allowed_lateness_ms,
                # per-partition bounded-disorder generation; the source
                # watermark is the min across assigned partitions
                watermark=(
                    BoundedDisorderWatermark(cfg.watermark_skew_ms)
                    if cfg.watermark_skew_ms is not None
                    else None
                ),
                # one silent PARTITION unpins at the same timeout the
                # job applies per SOURCE (runtime/kafka.py idleness)
                idle_timeout_ms=cfg.idle_timeout_ms,
            )
        elif cfg.format == "csv":
            src = CsvSource(
                cfg.stream_id, schema, cfg.input_path,
                delim=cfg.csv_delim, header=cfg.csv_header,
                ts_field=cfg.ts_field, chunk_bytes=cfg.chunk_bytes,
                allowed_lateness_ms=cfg.allowed_lateness_ms,
            )
        else:
            src = JsonLinesSource(
                cfg.stream_id, schema, cfg.input_path,
                ts_field=cfg.ts_field, chunk_bytes=cfg.chunk_bytes,
                allowed_lateness_ms=cfg.allowed_lateness_ms,
            )
        if (
            cfg.watermark_skew_ms is not None
            and not cfg.input_path.startswith("kafka://")
        ):
            # file/socket inputs: one bounded-disorder strategy per
            # source, replacing the byte source's native claim
            from ..runtime.sources import with_watermarks

            src = with_watermarks(src, skew_ms=cfg.watermark_skew_ms)
        plan = compile_plan(
            cfg.cql, {cfg.stream_id: schema}, extensions=self.extensions
        )
        job = Job(
            [plan],
            [src],
            batch_size=cfg.batch_size,
            time_mode=cfg.time_mode,
            # rows go to the sink file; retaining them host-side too would
            # grow memory without bound over an unbounded input stream
            retain_results=False,
            device=self.device,
            control_sources=self._control_sources,
            plan_compiler=lambda cql, plan_id: compile_plan(
                cql, {cfg.stream_id: schema},
                extensions=self.extensions, plan_id=plan_id,
            ),
        )
        if cfg.late_policy not in ("drop", "side_output", "allow"):
            raise ValueError(
                f"late_policy must be drop|side_output|allow, got "
                f"{cfg.late_policy!r}"
            )
        job.late_policy = cfg.late_policy
        job.allowed_lateness_ms = int(cfg.allowed_lateness_ms)
        job.idle_timeout_ms = cfg.idle_timeout_ms
        self._attach_sink(job, plan)
        self.job = job
        return job

    def _attach_sink(self, job: Job, plan) -> None:
        cfg = self.config
        import sys

        if cfg.output_path.startswith("kafka://"):
            # kafka://host:port/topic egress (FlinkKafkaProducer010,
            # CEPPipeline.scala:53-56): one JSON object per emitted row
            from ..runtime.kafka import KafkaSink

            bootstrap, topic = _parse_kafka_url(cfg.output_path)
            self._kafka_sinks = []
            for out_stream, schemas in plan.output_streams().items():
                sink = KafkaSink(
                    bootstrap, topic, list(schemas[0].field_names),
                    stream_id=out_stream,
                    compression=cfg.compression,
                    transactional_id=(
                        None if cfg.transactional_id is None
                        else f"{cfg.transactional_id}.{out_stream}"
                    ),
                )
                self._kafka_sinks.append(sink)
                job.add_sink(out_stream, sink)
            return
        if self._out is None or getattr(self._out, "closed", False):
            self._out = (
                sys.stdout
                if cfg.output_path == "-"
                else open(cfg.output_path, "a", encoding="utf-8")
            )
        out = self._out
        for out_stream, schemas in plan.output_streams().items():
            job.add_sink(
                out_stream,
                _JsonLinesColumnarSink(
                    out, out_stream, schemas[0].field_names
                ),
            )

    # -- run with checkpoint + fixed-delay restart ------------------------
    def run(self) -> Job:
        cfg = self.config
        attempts_left = cfg.restart_attempts
        while True:
            try:
                self._run_once()
                break
            except Exception:
                if attempts_left <= 0:
                    raise
                attempts_left -= 1
                _LOG.exception(
                    "pipeline failed; restarting in %.1fs (%d attempts "
                    "left)", cfg.restart_delay_s, attempts_left,
                )
                self._close_kafka()  # each attempt builds fresh clients
                self._sleep(cfg.restart_delay_s)
        if self._out is not None and self.config.output_path != "-":
            self._out.flush()
        return self.job

    def _run_once(self) -> None:
        cfg = self.config
        job = self.build()
        ckpt = cfg.checkpoint_path
        if ckpt and os.path.exists(ckpt):
            job.restore(ckpt)
            _LOG.info("restored from checkpoint %s", ckpt)
        last_ckpt = self._clock()
        while not job.finished:
            job.run_cycle()
            now = self._clock()
            if ckpt and now - last_ckpt >= cfg.checkpoint_interval_s:
                # barrier order: surface every in-flight emission, THEN
                # producer-flush, THEN commit source offsets — a crash
                # anywhere in between replays input (at-least-once) but
                # can never skip rows still sitting in a sink buffer
                # (the role of Flink's checkpoint-barrier flush)
                job.drain_outputs()
                for sink in getattr(self, "_kafka_sinks", ()):
                    sink.flush()
                job.save_checkpoint(ckpt)
                # phase two of a transactional sink: the checkpoint that
                # will never re-emit these rows is on disk
                job.commit_sink_transactions()
                last_ckpt = now
        job.flush()
        job.drain_outputs()
        for sink in getattr(self, "_kafka_sinks", ()):
            sink.flush()
        if ckpt:
            job.save_checkpoint(ckpt)
            job.commit_sink_transactions()

    def _close_kafka(self) -> None:
        """Drop broker connections (failed attempt / shutdown) — the
        restart loop builds fresh sources and sinks each time."""
        for sink in getattr(self, "_kafka_sinks", ()):
            try:
                sink.client.close()
            except Exception:
                pass
        self._kafka_sinks = []
        if self.job is not None:
            for src in self.job._sources:
                client = getattr(src, "client", None)
                if client is not None:
                    client.close()

    def close(self) -> None:
        self._close_kafka()
        if self._out is not None and self.config.output_path != "-":
            self._out.close()
            self._out = None


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: ``python -m flink_siddhi_tpu_torch.app.pipeline
    config.json [--device cpu]``."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="path to a PipelineConfig JSON file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    with open(args.config, "r", encoding="utf-8") as f:
        cfg = PipelineConfig.from_json(f.read())
    CEPPipeline(cfg, device=args.device).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
