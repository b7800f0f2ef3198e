"""Ingest sources.

Role of the reference's SourceFunction fixtures (test:
source/RandomEventSource.java:25-82). A source hands the executor columnar
chunks plus a watermark; the executor owns event-time ordering (the
reference's per-subtask priority queue, AbstractSiddhiOperator.java:221-232,
becomes a host-side reorder buffer that releases watermark-complete prefixes
to the device).

Watermark generation is a per-source policy (``WatermarkStrategy``,
``with_watermarks``); the in-memory sources carry checkpointable
positions. Not in the port yet: ``ControlListSource`` (ROADMAP.md Queue 1
item 10) and the byte sources with ``make_column_decoder`` (they wait for
the ``native/`` loader, item 9).
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

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
