"""The device tape: one timestamp-merged columnar micro-batch.

The physical event representation the batch step consumes. Where the
reference funnels each event through ``Tuple2<StreamRoute, Object>`` and a
per-event serializer (SiddhiStreamOperator.java:51-54, StreamSerializer.java:
38-66), the tape packs a whole micro-batch: all involved streams merged in
timestamp order, one device tensor per referenced (stream, field), plus stream
codes, rebased int32 timestamps, and a validity mask. Padded to bucketed
lengths so every artifact sees a handful of widths, not one per batch.

``build_tape`` assembles the host (numpy) tape; ``Tape.to`` stages it onto
the plan's device, through pinned host memory when the device is a GPU.
Group keys (``EncodedColumn``) are interned into dense int32 codes on the
host while the tape is built, so the device never looks a key up and the
host learns every new key without waiting for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..schema.batch import EventBatch
from ..schema.types import AttributeType

MIN_BUCKET = 128


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class EncodedColumn:
    """A host-computed dense-code column: rows of ``in_keys`` (for events of
    ``stream_code``) interned through ``encoder`` into ``out_key``. Used for
    group-keyed state tables (schema/encoders.py).

    ``select_fn`` (cols -> bool mask), when set, restricts interning to rows
    the owning query's filters accept — otherwise a heavily filtered query
    over a high-cardinality stream would grow its state table for keys that
    can never emit. It takes the host tape's numpy columns."""

    out_key: str
    in_keys: Tuple[str, ...]
    stream_code: int
    encoder: object  # GroupEncoder
    select_fn: object = None


@dataclass(frozen=True)
class TapeSpec:
    """What the step needs materialized."""

    stream_codes: Dict[str, int]  # stream_id -> dense code
    columns: Tuple[str, ...]  # "stream.field" keys
    column_types: Dict[str, AttributeType]
    encoded: Tuple[EncodedColumn, ...] = ()


@dataclass
class Tape:
    ts: object  # int32[E] ms since job epoch
    stream: object  # int32[E]
    valid: object  # bool[E]
    cols: Dict[str, object]  # "stream.field" -> array[E]

    @property
    def capacity(self) -> int:
        return self.ts.shape[-1]

    def to(self, device: torch.device) -> "Tape":
        """Stage a host (numpy) tape onto ``device``. On a GPU each column
        is copied into pinned host memory and uploaded asynchronously on
        the current stream; the caching host allocator keeps the pinned
        buffer alive until its copy has run."""
        def put(arr: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if device.type == "cpu":
                return t
            return t.pin_memory().to(device, non_blocking=True)

        return Tape(
            put(self.ts),
            put(self.stream),
            put(self.valid),
            {k: put(v) for k, v in self.cols.items()},
        )


def _merged_stream_values(
    batches: Sequence[EventBatch],
    stream_id: str,
    field: str,
    total: int,
    order,
    identity: bool,
    dtype=None,
):
    """One (stream, field)'s values in merged tape order, or None when no
    batch carries the stream. Native host dtype unless ``dtype`` is
    given. Single-batch results may alias the batch's column — callers
    must copy before retaining."""
    if len(batches) == 1:
        b = batches[0]
        if b.stream_id != stream_id:
            return None
        col = b.columns[field]
        return col if dtype is None else col.astype(dtype, copy=False)
    merged = None
    offset = 0
    for b in batches:
        n = len(b)
        if b.stream_id == stream_id and n:
            if merged is None:
                dt = dtype if dtype is not None else b.columns[field].dtype
                merged = np.zeros(total, dtype=dt)
            merged[offset : offset + n] = b.columns[field]
        offset += n
    if merged is None:
        return None
    return merged if identity else merged[order]


def build_tape(
    spec: TapeSpec,
    batches: Sequence[EventBatch],
    epoch_ms: int,
    capacity: Optional[int] = None,
) -> Tape:
    """Merge per-stream batches into one padded, ts-sorted host tape
    (numpy arrays; ``Tape.to`` moves it to the device). Every encoded
    column's keys are interned here, growing its encoder."""
    total = sum(len(b) for b in batches)
    cap = capacity if capacity is not None else bucket_size(total)
    if total > cap:
        raise ValueError(f"{total} events exceed tape capacity {cap}")

    ts_all = np.empty(total, dtype=np.int64)
    stream_all = np.empty(total, dtype=np.int32)
    offset = 0
    for b in batches:
        n = len(b)
        if b.stream_id not in spec.stream_codes:
            raise KeyError(f"stream {b.stream_id!r} not in tape spec")
        ts_all[offset : offset + n] = b.timestamps
        stream_all[offset : offset + n] = spec.stream_codes[b.stream_id]
        offset += n

    # per-stream batches arrive time-sorted (the reorder buffer sorts on
    # release), so a single-batch cycle needs no argsort at all
    identity = total == 0 or bool(np.all(ts_all[1:] >= ts_all[:-1]))
    order = None
    if identity:
        ts_sorted = ts_all
        stream_sorted = stream_all
    else:
        order = np.argsort(ts_all, kind="stable")
        ts_sorted = ts_all[order]
        stream_sorted = stream_all[order]

    ts = np.zeros(cap, dtype=np.int32)
    ts[:total] = (ts_sorted - epoch_ms).astype(np.int32)
    # padding gets the max timestamp so time-window logic never treats
    # padding as "newest event"
    if total and total < cap:
        ts[total:] = ts[total - 1]
    stream = np.full(cap, -1, dtype=np.int32)
    stream[:total] = stream_sorted
    valid = np.zeros(cap, dtype=np.bool_)
    valid[:total] = True

    cols: Dict[str, np.ndarray] = {}
    for key in spec.columns:
        stream_id, field = key.split(".", 1)
        dtype = spec.column_types[key].device_dtype
        col = np.zeros(cap, dtype=dtype)
        vals = _merged_stream_values(
            batches, stream_id, field, total, order, identity, dtype
        )
        if vals is not None:
            col[:total] = vals
        cols[key] = col

    for enc in spec.encoded:
        select = stream[:total] == enc.stream_code
        if enc.select_fn is not None:
            view = {k: v[:total] for k, v in cols.items()}
            select = select & np.asarray(enc.select_fn(view))
        # key columns are referenced by the query, so they are on the tape
        in_cols = [cols[k][:total] for k in enc.in_keys]
        codes = enc.encoder.intern_rows(in_cols, select)
        col = np.zeros(cap, dtype=np.int32)
        col[:total] = codes
        cols[enc.out_key] = col
    return Tape(ts, stream, valid, cols)
