"""Ingest sources.

Role of the reference's SourceFunction fixtures (test:
source/RandomEventSource.java:25-82). A source hands the executor columnar
chunks plus a watermark; the executor owns event-time ordering (the
reference's per-subtask priority queue, AbstractSiddhiOperator.java:221-232,
becomes a host-side reorder buffer that releases watermark-complete prefixes
to the device).
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
