"""Ingest sources.

Role of the reference's SourceFunction fixtures + Kafka adapters
(test: source/RandomEventSource.java:25-82; experimental CEPPipeline Kafka
ingestion). A source hands the executor columnar chunks plus a watermark;
the executor owns event-time ordering (the reference's per-subtask
priority queue, AbstractSiddhiOperator.java:221-232, becomes a host-side
reorder buffer that releases watermark-complete prefixes to the device).

Watermark generation is a per-source policy (``WatermarkStrategy``,
``with_watermarks``); the in-memory and byte sources carry checkpointable
positions. The byte sources (JSON lines, CSV, a socket; ``runtime/kafka.py``
for a topic) decode on the host with the ``native/`` column decoder.
``ControlListSource`` replays a timestamped control timeline (the control
plane's bounded source; ``app/service.py:ControlQueueSource`` is the live
one).
"""

from __future__ import annotations

import logging

from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

_LOG = logging.getLogger(__name__)

from ..schema.batch import EventBatch
from ..schema.stream_schema import StreamSchema


class Source:
    """Pull-based source protocol."""

    stream_id: str
    schema: StreamSchema

    def poll(
        self, max_events: int
    ) -> Tuple[Optional[EventBatch], Optional[int], bool]:
        """Return (batch-or-None, watermark_ms-or-None, done)."""
        raise NotImplementedError


# -- watermark generation strategies (docs/event_time.md) -------------------
#
# Historically every source computed its own watermark claim inline
# (ListSource: batch max ts; byte sources: max ts - allowed_lateness).
# Production ingest is disordered, so watermark generation is a POLICY,
# not a property of the transport: these strategies make it pluggable
# per source (the role of Flink's WatermarkStrategy /
# BoundedOutOfOrdernessTimestampExtractor; semantics per Akidau et al.,
# "The Dataflow Model", VLDB 2015 — PAPERS.md #5).

class WatermarkStrategy:
    """Per-source watermark generation policy.

    ``observe(timestamps)`` sees every polled batch's event times;
    ``observe_native(wm)`` sees the wrapped source's own watermark
    claim (most strategies ignore it); ``current()`` returns the
    watermark to publish, or None while unknown. ``clone()`` returns a
    fresh instance with the same parameters (per-partition generation
    in runtime/kafka.py clones one template per assigned partition).
    State must round-trip ``state_dict``/``load_state_dict`` — the
    watermark is engine state and survives checkpoint/restore."""

    def observe(self, timestamps: np.ndarray) -> None:
        raise NotImplementedError

    def observe_native(self, watermark_ms: int) -> None:
        pass  # most strategies generate; punctuated passes through

    def current(self) -> Optional[int]:
        raise NotImplementedError

    def clone(self) -> "WatermarkStrategy":
        raise NotImplementedError

    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, d: dict) -> None:
        raise NotImplementedError


class BoundedDisorderWatermark(WatermarkStrategy):
    """``wm = max observed event time - skew_ms - 1``: correct for any
    input whose disorder is bounded by ``skew_ms`` (an event can arrive
    at most that far behind the newest event seen). The default
    strategy for sources with no native watermark. A row later than the
    bound is classified LATE at the executor gate and handled by the
    job's ``late_policy`` (docs/event_time.md).

    The ``- 1``: a watermark W asserts "no more rows with ts <= W", and
    an event AT the bound (ts == max - skew) is still admissible — e.g.
    a duplicate of the max-minus-skew event delivered again. Claiming
    ``max - skew`` would make exactly-at-the-bound arrivals late;
    Flink's ``BoundedOutOfOrdernessWatermarks`` subtracts the same 1 ms
    for the same reason."""

    def __init__(self, skew_ms: int) -> None:
        if int(skew_ms) < 0:
            raise ValueError(f"skew_ms must be >= 0, got {skew_ms}")
        self.skew_ms = int(skew_ms)
        self._max_ts: Optional[int] = None

    def observe(self, timestamps: np.ndarray) -> None:
        if len(timestamps):
            t = int(np.max(timestamps))
            if self._max_ts is None or t > self._max_ts:
                self._max_ts = t

    def current(self) -> Optional[int]:
        if self._max_ts is None:
            return None
        return self._max_ts - self.skew_ms - 1

    def clone(self) -> "BoundedDisorderWatermark":
        return BoundedDisorderWatermark(self.skew_ms)

    def state_dict(self) -> dict:
        return {"kind": "bounded", "skew_ms": self.skew_ms,
                "max_ts": self._max_ts}

    def load_state_dict(self, d: dict) -> None:
        self.skew_ms = int(d["skew_ms"])
        self._max_ts = (
            None if d.get("max_ts") is None else int(d["max_ts"])
        )

    def __repr__(self) -> str:
        return f"BoundedDisorderWatermark(skew_ms={self.skew_ms})"


class PunctuatedWatermark(WatermarkStrategy):
    """Explicit/punctuated watermarks: trust the wrapped source's own
    claims (or explicit ``advance`` calls) verbatim — the historical
    behavior of every in-repo test source, kept as a named strategy so
    test fixtures that hand-craft perfect watermarks stay expressible
    under the strategy layer."""

    def __init__(self) -> None:
        self._wm: Optional[int] = None

    def observe(self, timestamps: np.ndarray) -> None:
        pass  # event times do not move a punctuated watermark

    def observe_native(self, watermark_ms: int) -> None:
        wm = int(watermark_ms)
        if self._wm is None or wm > self._wm:
            self._wm = wm

    advance = observe_native  # for callers that advance it explicitly

    def current(self) -> Optional[int]:
        return self._wm

    def clone(self) -> "PunctuatedWatermark":
        return PunctuatedWatermark()

    def state_dict(self) -> dict:
        return {"kind": "punctuated", "wm": self._wm}

    def load_state_dict(self, d: dict) -> None:
        self._wm = None if d.get("wm") is None else int(d["wm"])


class WatermarkedSource(Source):
    """Wrap any Source with an explicit watermark-generation strategy.

    The inner source's own watermark claim is REPLACED by the
    strategy's (PunctuatedWatermark forwards it, making the historical
    behavior explicit); the end-of-stream MAX sentinel always passes
    through so bounded inputs still terminate. Checkpoints carry both
    the inner source's position and the strategy's state."""

    def __init__(self, inner: Source, strategy: WatermarkStrategy) -> None:
        self.inner = inner
        self.strategy = strategy
        self.stream_id = inner.stream_id
        self.schema = inner.schema

    def poll(self, max_events: int):
        batch, native_wm, done = self.inner.poll(max_events)
        if batch is not None and len(batch):
            self.strategy.observe(batch.timestamps)
        if native_wm is not None and native_wm != np.iinfo(np.int64).max:
            self.strategy.observe_native(native_wm)
        if done:
            return batch, np.iinfo(np.int64).max, True
        return batch, self.strategy.current(), False

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def bind_telemetry(self, registry) -> None:
        bind = getattr(self.inner, "bind_telemetry", None)
        if bind is not None:
            bind(registry)

    # -- checkpoint support -------------------------------------------------
    def state_dict(self) -> dict:
        inner_sd = getattr(self.inner, "state_dict", None)
        return {
            "inner": inner_sd() if inner_sd is not None else None,
            "watermark": self.strategy.state_dict(),
        }

    def load_state_dict(self, d: dict) -> None:
        if d.get("inner") is not None:
            load = getattr(self.inner, "load_state_dict", None)
            if load is not None:
                load(d["inner"])
        if d.get("watermark") is not None:
            self.strategy.load_state_dict(d["watermark"])


def with_watermarks(
    source: Source, strategy: Optional[WatermarkStrategy] = None,
    skew_ms: Optional[int] = None,
) -> Source:
    """Convenience: wrap ``source`` with ``strategy`` (or a
    ``BoundedDisorderWatermark(skew_ms)`` when only a skew is given)."""
    if strategy is None:
        if skew_ms is None:
            raise ValueError("pass strategy= or skew_ms=")
        strategy = BoundedDisorderWatermark(skew_ms)
    return WatermarkedSource(source, strategy)


class ListSource(Source):
    """Replays an in-memory list of records with explicit or field-derived
    timestamps (the RandomEventSource analog: deterministic event times)."""

    def __init__(
        self,
        stream_id: str,
        schema: StreamSchema,
        records: Sequence[Any],
        timestamps: Optional[Sequence[int]] = None,
        ts_field: Optional[str] = None,
        chunk: Optional[int] = None,
    ) -> None:
        self.stream_id = stream_id
        self.schema = schema
        self._records = list(records)
        if timestamps is not None:
            self._ts = [int(t) for t in timestamps]
        elif ts_field is not None:
            idx = schema.field_index(ts_field)
            self._ts = [
                int(schema.get_row(r)[idx]) for r in self._records
            ]
        else:
            self._ts = list(range(len(self._records)))
        if len(self._ts) != len(self._records):
            raise ValueError("timestamps/records length mismatch")
        self._pos = 0
        self._chunk = chunk

    def poll(self, max_events: int):
        if self._pos >= len(self._records):
            return None, np.iinfo(np.int64).max, True
        n = min(
            max_events,
            self._chunk or max_events,
            len(self._records) - self._pos,
        )
        lo, hi = self._pos, self._pos + n
        self._pos = hi
        batch = EventBatch.from_records(
            self.stream_id,
            self.schema,
            self._records[lo:hi],
            timestamps=self._ts[lo:hi],
        )
        done = self._pos >= len(self._records)
        wm = np.iinfo(np.int64).max if done else max(self._ts[lo:hi])
        return batch, wm, done

    # -- checkpoint support -------------------------------------------------
    def state_dict(self) -> dict:
        return {"pos": self._pos}

    def load_state_dict(self, d: dict) -> None:
        self._pos = int(d["pos"])


class BatchSource(Source):
    """Wraps an iterator of prebuilt EventBatches (zero per-record Python
    work)."""

    def __init__(
        self,
        stream_id: str,
        schema: StreamSchema,
        batches: Iterable[EventBatch],
    ) -> None:
        self.stream_id = stream_id
        self.schema = schema
        self._it: Iterator[EventBatch] = iter(batches)
        self._done = False

    def poll(self, max_events: int):
        if self._done:
            return None, np.iinfo(np.int64).max, True
        try:
            batch = next(self._it)
        except StopIteration:
            self._done = True
            return None, np.iinfo(np.int64).max, True
        wm = int(batch.timestamps.max()) if len(batch) else None
        return batch, wm, False


class ReplayBatchSource(BatchSource):
    """BatchSource over an in-memory Sequence of prebuilt EventBatches
    with an EXACT, checkpointable replay position — the
    supervised-recovery analog of ListSource for the zero-per-record
    ingest path (``bench.py --fault`` and supervised replay runs
    restore mid-stream through it). The iterator-backed parent stays
    non-checkpointable: an iterator has no position to restore."""

    def __init__(
        self,
        stream_id: str,
        schema: StreamSchema,
        batches: Sequence[EventBatch],
    ) -> None:
        super().__init__(stream_id, schema, iter(()))
        self._batches = list(batches)
        self._pos = 0

    def poll(self, max_events: int):
        if self._pos >= len(self._batches):
            return None, np.iinfo(np.int64).max, True
        batch = self._batches[self._pos]
        self._pos += 1
        done = self._pos >= len(self._batches)
        wm = (
            np.iinfo(np.int64).max
            if done
            else (int(batch.timestamps.max()) if len(batch) else None)
        )
        return batch, wm, done

    # -- checkpoint support -------------------------------------------------
    def state_dict(self) -> dict:
        return {"pos": self._pos}

    def load_state_dict(self, d: dict) -> None:
        self._pos = int(d["pos"])


class ControlListSource:
    """Replays timestamped control events (the control-topic analog of the
    reference's dynamic path, SiddhiStream.java:126-140: control events ride
    a broadcast stream interleaved with data by event time).

    ``events``: iterable of ``(timestamp_ms, ControlEvent)`` pairs, or bare
    ControlEvents (timestamped by their ``created_ms``)."""

    def __init__(self, events) -> None:
        pairs = []
        for e in events:
            if isinstance(e, tuple):
                pairs.append((int(e[0]), e[1]))
            else:
                pairs.append((int(e.created_ms), e))
        self._events = sorted(pairs, key=lambda p: p[0])
        self._pos = 0

    def poll(self, max_events: int):
        """Return (list[(ts, event)], watermark_ms, done)."""
        if self._pos >= len(self._events):
            return [], np.iinfo(np.int64).max, True
        take = self._events[self._pos : self._pos + max_events]
        self._pos += len(take)
        done = self._pos >= len(self._events)
        wm = np.iinfo(np.int64).max if done else take[-1][0]
        return take, wm, done


class CallbackSource(Source):
    """Push-style adapter: user code calls ``emit``; the executor drains."""

    def __init__(self, stream_id: str, schema: StreamSchema) -> None:
        self.stream_id = stream_id
        self.schema = schema
        self._pending: list = []
        self._watermark: Optional[int] = None
        self._closed = False

    def emit(self, record: Any, timestamp_ms: int) -> None:
        if self._closed:
            raise RuntimeError("source closed")
        self._pending.append((record, int(timestamp_ms)))

    def advance_watermark(self, watermark_ms: int) -> None:
        self._watermark = int(watermark_ms)

    def close(self) -> None:
        self._closed = True

    def poll(self, max_events: int):
        if not self._pending:
            if self._closed:
                return None, np.iinfo(np.int64).max, True
            return None, self._watermark, False
        take = self._pending[:max_events]
        self._pending = self._pending[max_events:]
        batch = EventBatch.from_records(
            self.stream_id,
            self.schema,
            [r for r, _ in take],
            timestamps=[t for _, t in take],
        )
        wm = self._watermark
        if self._closed and not self._pending:
            wm = np.iinfo(np.int64).max
        return batch, wm, self._closed and not self._pending


def make_column_decoder(schema: StreamSchema):
    """Shared native-decoder setup for byte sources (file/socket/Kafka):
    -> (fields, ColumnDecoder) where fields = [(name, kind, string
    table-or-None)] in schema order."""
    from ..native import (
        KIND_BOOL,
        KIND_DOUBLE,
        KIND_INT,
        KIND_STRING,
        ColumnDecoder,
    )
    from ..schema.types import AttributeType

    kind_of = {
        AttributeType.INT: KIND_INT,
        AttributeType.LONG: KIND_INT,
        AttributeType.FLOAT: KIND_DOUBLE,
        AttributeType.DOUBLE: KIND_DOUBLE,
        AttributeType.BOOL: KIND_BOOL,
        AttributeType.STRING: KIND_STRING,
        AttributeType.OBJECT: KIND_STRING,
    }
    fields = [
        (name, kind_of[atype], schema.string_tables.get(name))
        for name, atype in zip(schema.field_names, schema.field_types)
    ]
    return fields, ColumnDecoder(fields)


def decoded_columns(fields, schema: StreamSchema, cols):
    """Decoder output arrays -> schema-typed host columns (string
    fields keep their canonical int32 dictionary codes)."""
    columns = {}
    for (name, _kind, table), arr in zip(fields, cols):
        if table is not None:
            columns[name] = arr.astype(np.int32, copy=False)
        else:
            atype = schema.field_type(name)
            columns[name] = arr.astype(atype.host_dtype, copy=False)
    return columns


class _DecodedLinesSource(Source):
    """Shared machinery for byte-stream sources decoded by the native
    columnar decoder (flink_siddhi_tpu/native): reads a chunk of lines,
    decodes to columns in C++ (pure-Python fallback), assembles an
    EventBatch. Timestamps come from ``ts_field`` (epoch ms) or arrival
    order.

    Watermarks advance to each decoded chunk's max timestamp minus
    ``allowed_lateness_ms``. With the default 0 the input's ``ts_field``
    must be globally non-decreasing across chunks — a later chunk holding
    older timestamps would be released after newer events and silently
    change pattern/window results. For inputs with bounded disorder, set
    ``allowed_lateness_ms`` to the max expected skew so the executor's
    reorder buffer can re-sort within that horizon."""

    def __init__(
        self,
        stream_id: str,
        schema: StreamSchema,
        fileobj,
        ts_field: Optional[str] = None,
        chunk_bytes: int = 1 << 20,
        drop_invalid: bool = True,
        allowed_lateness_ms: int = 0,
    ) -> None:
        self.stream_id = stream_id
        self.schema = schema
        self._f = fileobj
        self._ts_field = ts_field
        self._chunk_bytes = chunk_bytes
        self._drop_invalid = drop_invalid
        self._carry = b""
        self._done = False
        self._arrival = 0
        self._lateness = int(allowed_lateness_ms)
        self._fields, self._decoder = make_column_decoder(schema)
        # checkpoint-position health: True once a tell()/seek() failed,
        # i.e. the checkpointed position is NOT exact (resume is
        # at-least-once from wherever the stream actually is). Sources
        # with no tell/seek at all (sockets) are not degraded — an
        # arrival-order position was never promised for them.
        self._state_degraded = False
        # fst:ephemeral registry handle; Job.__init__ re-binds after restore
        self._telemetry = None

    def bind_telemetry(self, registry) -> None:
        """Job.__init__ wiring: state-capture faults land in the job's
        registry as ``faults.source_state``."""
        self._telemetry = registry

    def _note_state_fault(self, what: str, exc: Exception) -> None:
        self._state_degraded = True
        if self._telemetry is not None:
            self._telemetry.inc("faults.source_state")
        _LOG.warning(
            "%s: source position %s failed (%s); the checkpoint is "
            "marked degraded — restore replays from the stream's "
            "current position (at-least-once)",
            self.stream_id, what, exc,
        )

    def _decode(self, data: bytes, max_rows: int):
        raise NotImplementedError

    def poll(self, max_events: int):
        if self._done:
            return None, np.iinfo(np.int64).max, True
        data = self._carry
        raw = self._f.read(self._chunk_bytes)
        if isinstance(raw, str):
            raw = raw.encode("utf-8")
        eof = not raw
        data += raw
        if not eof:
            # hold back the trailing partial line
            cut = data.rfind(b"\n")
            if cut < 0:
                self._carry = data
                return None, None, False
            self._carry, data = data[cut + 1:], data[: cut + 1]
        else:
            self._carry = b""
        if not data.strip():
            self._done = eof
            wm = np.iinfo(np.int64).max if self._done else None
            return None, wm, self._done
        n_lines = data.count(b"\n") + (0 if data.endswith(b"\n") else 1)
        if n_lines > max_events:
            # honor the executor's batch size: decode only max_events
            # lines now, push the rest back in front of the carry
            nl = np.nonzero(
                np.frombuffer(data, dtype=np.uint8) == 0x0A
            )[0]
            cut = int(nl[max_events - 1]) + 1
            self._carry = data[cut:] + self._carry
            data = data[:cut]
            n_lines = max_events
            eof = False  # more data pending regardless of file state
        self._done = eof
        cols, valid, n = self._decode(data, n_lines)
        columns = decoded_columns(self._fields, self.schema, cols)
        if self._ts_field is not None:
            ts = columns[self._ts_field].astype(np.int64)
        else:
            ts = self._arrival + np.arange(n, dtype=np.int64)
            self._arrival += n
        if self._drop_invalid and not valid.all():
            keep = valid.astype(bool)
            columns = {k: v[keep] for k, v in columns.items()}
            ts = ts[keep]
        batch = EventBatch(self.stream_id, self.schema, columns, ts)
        wm = int(ts.max()) - self._lateness if len(ts) else None
        if self._done:
            wm = np.iinfo(np.int64).max
        return (batch if len(ts) else None), wm, self._done

    @property
    def native(self) -> bool:
        return self._decoder.native

    # -- checkpoint/resume: byte offset into a seekable input -------------
    def state_dict(self) -> dict:
        tell = getattr(self._f, "tell", None)
        pos = None
        if tell is not None:
            try:
                pos = int(tell()) - len(self._carry)
            except (OSError, ValueError) as e:
                # NOT silent: a position we could not capture means the
                # checkpoint cannot promise exactly-once resume for
                # this source — count it, mark the state degraded, and
                # let the snapshot carry the marker instead of a
                # silently-wrong position
                self._note_state_fault("capture (tell)", e)
        d = {
            "pos": pos,
            "arrival": self._arrival,
            "done": self._done,
        }
        if self._state_degraded:
            d["degraded"] = True
        return d

    def load_state_dict(self, d: dict) -> None:
        self._arrival = int(d.get("arrival", 0))
        self._done = bool(d.get("done", False))
        self._state_degraded = bool(d.get("degraded", False))
        pos = d.get("pos")
        if pos is not None and hasattr(self._f, "seek"):
            try:
                self._f.seek(pos)
                self._carry = b""
            except (OSError, ValueError) as e:
                # at-least-once replay from the stream's current
                # position — counted and marked, never silent
                self._note_state_fault("restore (seek)", e)


class JsonLinesSource(_DecodedLinesSource):
    """Newline-delimited JSON ingest (the Kafka-JSON-topic analog of the
    reference's experimental pipeline, CEPPipeline.scala:41-55), decoded by
    the native C++ column decoder."""

    def __init__(self, stream_id, schema, path_or_fileobj, **kw):
        f = (
            open(path_or_fileobj, "rb")
            if isinstance(path_or_fileobj, (str, bytes))
            else path_or_fileobj
        )
        super().__init__(stream_id, schema, f, **kw)

    def _decode(self, data: bytes, max_rows: int):
        return self._decoder.decode_json(data, max_rows)


class CsvSource(_DecodedLinesSource):
    """Delimiter-separated ingest; columns map to schema fields by
    position. ``header=True`` skips the first line."""

    def __init__(
        self, stream_id, schema, path_or_fileobj, delim=",",
        header=False, **kw,
    ):
        f = (
            open(path_or_fileobj, "rb")
            if isinstance(path_or_fileobj, (str, bytes))
            else path_or_fileobj
        )
        self._delim = delim
        self._skip_header = header
        super().__init__(stream_id, schema, f, **kw)

    def _decode(self, data: bytes, max_rows: int):
        if self._skip_header:
            cut = data.find(b"\n")
            data = data[cut + 1:] if cut >= 0 else b""
            self._skip_header = False
        return self._decoder.decode_csv(data, max_rows, self._delim)

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        if d.get("pos"):  # resuming mid-file: the header is behind us
            self._skip_header = False


class SocketLineSource(_DecodedLinesSource):
    """TCP line ingest: listen on (host, port); every connected client
    streams newline-delimited JSON (``fmt='json'``) or CSV
    (``fmt='csv'``) events. This is the in-repo analog of the
    reference's experimental Kafka source (CEPPipeline.scala:33-78) with
    no external broker: ``nc host port < events.jsonl`` deploys it.

    A background acceptor + one reader thread per client append
    complete lines to a bounded byte queue that backs the parent's
    chunk reads; the source is UNBOUNDED — the job finishes only after
    ``close()`` drains what is buffered."""

    def __init__(
        self,
        stream_id: str,
        schema: StreamSchema,
        host: str = "127.0.0.1",
        port: int = 0,
        fmt: str = "json",
        delim: str = ",",
        max_buffer_bytes: int = 64 << 20,
        **kw,
    ) -> None:
        import socket
        import threading

        if fmt not in ("json", "csv"):
            raise ValueError(fmt)
        self._fmt = fmt
        self._delim = delim
        self._q: list = []
        # fst:ephemeral live socket buffer accounting; network data is not checkpointable (sockets have no position)
        self._q_bytes = 0
        self._max_buffer = max_buffer_bytes
        self.dropped_bytes = 0
        self._qlock = threading.Lock()
        # fst:ephemeral close() marker: a restored listener is open by construction
        self._closed = False

        src = self

        class _QueueFile:
            def read(self, n):
                with src._qlock:
                    if not src._q:
                        return b""
                    data = b"".join(src._q)
                    src._q.clear()
                    src._q_bytes = 0
                return data

        super().__init__(stream_id, schema, _QueueFile(), **kw)
        self._server = socket.create_server((host, port))
        self._server.settimeout(0.2)
        self.host, self.port = self._server.getsockname()[:2]
        threading.Thread(target=self._accept_loop, daemon=True).start()

    # fst:thread-root name=ingest
    def _accept_loop(self) -> None:
        import socket
        import threading

        while not self._closed:
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(
                target=self._reader, args=(conn,), daemon=True
            ).start()

    # fst:thread-root name=ingest
    def _reader(self, conn) -> None:
        carry = b""
        try:
            while not self._closed:
                chunk = conn.recv(1 << 16)
                if not chunk:
                    break
                carry += chunk
                cut = carry.rfind(b"\n")
                if cut < 0:
                    continue
                complete, carry = carry[: cut + 1], carry[cut + 1:]
                with self._qlock:
                    if self._q_bytes + len(complete) > self._max_buffer:
                        # bounded-memory policy: shed newest, count it
                        self.dropped_bytes += len(complete)
                    else:
                        self._q.append(complete)
                        self._q_bytes += len(complete)
        finally:
            if carry.strip():
                with self._qlock:
                    self._q.append(carry + b"\n")
                    self._q_bytes += len(carry) + 1
            conn.close()

    def close(self) -> None:
        """Stop accepting; the job drains what is buffered and ends."""
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass

    def _decode(self, data: bytes, max_rows: int):
        if self._fmt == "json":
            return self._decoder.decode_json(data, max_rows)
        return self._decoder.decode_csv(data, max_rows, self._delim)

    def poll(self, max_events: int):
        batch, wm, done = super().poll(max_events)
        if done and not self._closed:
            # an empty read is "no data right now", not end-of-stream
            self._done = False
            return batch, None, False
        return batch, wm, done
