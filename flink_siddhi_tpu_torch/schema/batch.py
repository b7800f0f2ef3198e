"""Columnar micro-batches: the structure-of-arrays event unit.

The engine never processes single events (reference hot loop is per event,
AbstractSiddhiOperator.java:209-233); the unit of work is an ``EventBatch`` —
one host numpy array per field, plus int64 epoch-ms timestamps and a stream id.
Batches flow host-side until the runtime assembles the device tape (see
runtime/executor.py), which is where epoch-rebasing to int32 device time
happens.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .stream_schema import StreamSchema


@dataclass
class EventBatch:
    """A timestamp-carrying columnar chunk of one stream."""

    stream_id: str
    schema: StreamSchema
    columns: Dict[str, np.ndarray]
    timestamps: np.ndarray  # int64 epoch ms

    def __post_init__(self) -> None:
        self.timestamps = np.asarray(self.timestamps, dtype=np.int64)
        n = len(self.timestamps)
        for name, col in self.columns.items():
            if len(col) != n:
                raise ValueError(
                    f"column {name!r} length {len(col)} != {n} timestamps"
                )

    def __len__(self) -> int:
        return len(self.timestamps)

    @classmethod
    def from_records(
        cls,
        stream_id: str,
        schema: StreamSchema,
        records: Sequence[Any],
        timestamps: Optional[Sequence[int]] = None,
        default_ts: int = 0,
    ) -> "EventBatch":
        rows = [schema.get_row(r) for r in records]
        cols = schema.encode_columns(rows)
        if timestamps is None:
            ts = np.full(len(rows), default_ts, dtype=np.int64)
        else:
            ts = np.asarray(timestamps, dtype=np.int64)
        return cls(stream_id, schema, cols, ts)

    @classmethod
    def empty(cls, stream_id: str, schema: StreamSchema) -> "EventBatch":
        cols = {
            n: np.empty(0, dtype=t.device_dtype)
            for n, t in zip(schema.field_names, schema.field_types)
        }
        return cls(stream_id, schema, cols, np.empty(0, dtype=np.int64))

    def slice(self, start: int, stop: int) -> "EventBatch":
        return EventBatch(
            self.stream_id,
            self.schema,
            {n: c[start:stop] for n, c in self.columns.items()},
            self.timestamps[start:stop],
        )

    def take(self, idx: np.ndarray) -> "EventBatch":
        return EventBatch(
            self.stream_id,
            self.schema,
            {n: c[idx] for n, c in self.columns.items()},
            self.timestamps[idx],
        )

    def sort_by_time(self) -> "EventBatch":
        ts = self.timestamps
        if len(ts) < 2 or np.all(ts[:-1] <= ts[1:]):
            return self
        return self.take(np.argsort(ts, kind="stable"))

    @staticmethod
    def concat(batches: Sequence["EventBatch"]) -> "EventBatch":
        if not batches:
            raise ValueError("concat of zero batches")
        head = batches[0]
        if len(batches) == 1:
            return head
        for b in batches[1:]:
            if b.stream_id != head.stream_id:
                raise ValueError("concat across different streams")
        return EventBatch(
            head.stream_id,
            head.schema,
            {
                n: np.concatenate([b.columns[n] for b in batches])
                for n in head.columns
            },
            np.concatenate([b.timestamps for b in batches]),
        )

    # -- debugging / oracle support -----------------------------------------
    def record(self, i: int) -> Dict[str, Any]:
        """Decode event i back to a host dict (oracle + sinks use this)."""
        out: Dict[str, Any] = {}
        for name in self.schema.field_names:
            out[name] = self.schema.decode_value(name, self.columns[name][i])
        return out

    def records(self) -> List[Dict[str, Any]]:
        return [self.record(i) for i in range(len(self))]
