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
``build_wire_tape`` narrows it for the upload (``WireTape``, below), and
``WireTape.expand`` rebuilds the logical tape on the device as the first ops
of the step. Group keys (``EncodedColumn``) are interned into dense int32
codes on the host while the tape is built, so the device never looks a key
up and the host learns every new key without waiting for the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

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
class HostPred:
    """A host-computed pseudo-column shipped instead of raw columns.

    Wire predicate pushdown: ``fn`` maps a dict of merged-order host
    columns (raw host dtypes — f64 for DOUBLE) to a bool mask that ships
    as ONE BIT per event. With ``dtype`` set to an integer type it is a
    host-computed VALUE column instead (``#window.cron``'s per-event
    window index: calendar math stays on the host), narrowed on the wire
    like any int column. A ref of ``"@ts"`` reads the merged-order
    absolute event timestamps (int64 ms)."""

    out_key: str  # "@p:<n>" pseudo-column the device reads
    fn: object  # Dict[str, np.ndarray] -> np.ndarray
    refs: Tuple[str, ...]
    dtype: object = np.bool_


@dataclass(frozen=True)
class TapeSpec:
    """What the step needs materialized."""

    stream_codes: Dict[str, int]  # stream_id -> dense code
    columns: Tuple[str, ...]  # "stream.field" keys
    column_types: Dict[str, AttributeType]
    encoded: Tuple[EncodedColumn, ...] = ()
    # late materialization: when set, only these columns ship to the
    # device (projection-only columns stay host-side; the engine emits
    # event ordinals that decode against the host's retained batches)
    device_columns: Optional[Tuple[str, ...]] = None
    # wire predicate pushdown: host-evaluated masks added to the tape
    host_preds: Tuple[HostPred, ...] = ()
    # per chain matcher (artifact name), its queries (one, or a stack's
    # members), each as its elements' (stream code, pushed mask key or
    # None, ``(column key, int literal)`` equality conjuncts): the host
    # counts the events that could be relevant to each query — an upper
    # bound on the device's relevant count, so the matcher picks its
    # compaction branch without a read (``_relevance_bounds``)
    relevance: Tuple[
        Tuple[str, Tuple[Tuple[Tuple[int, Optional[str], Tuple], ...],
                         ...]], ...
    ] = ()

    def built_columns(self) -> Tuple[str, ...]:
        if self.device_columns is None:
            return self.columns
        return tuple(
            k for k in self.columns if k in set(self.device_columns)
        )


def _put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on a GPU through pinned host memory,
    uploaded asynchronously on the current stream (the caching host
    allocator keeps the pinned buffer alive until its copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    if t.numel() == 0:
        return torch.empty(0, dtype=t.dtype, device=device)
    return t.pin_memory().to(device, non_blocking=True)


@dataclass
class Tape:
    ts: object  # int32[E] ms since job epoch
    stream: object  # int32[E]
    valid: object  # bool[E]
    cols: Dict[str, object]  # "stream.field" -> array[E]
    # host-known upper bounds on each chain matcher's relevant-event
    # count (TapeSpec.relevance; a stack's: its largest member's), as
    # Python ints
    bounds: Dict[str, int] = field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.ts.shape[-1]

    def to(self, device: torch.device) -> "Tape":
        """Stage a host (numpy) tape onto ``device`` (``_put``)."""
        return Tape(
            _put(self.ts, device),
            _put(self.stream, device),
            _put(self.valid, device),
            {k: _put(v, device) for k, v in self.cols.items()},
            dict(self.bounds),
        )


# --------------------------------------------------------------------------
# Wire tape: the narrow host->device format
# --------------------------------------------------------------------------
# The wire format strips everything the device can reconstruct:
#   * validity mask  -> one host-known count (post-sort validity is always
#     a prefix)
#   * stream codes   -> omitted entirely for single-input plans
#   * int columns    -> narrowest safe width (int8/int16/int32), sticky per
#     column so widths only ever widen
#   * a column whose values equal the event timestamp (a very common schema
#     shape: an explicit `timestamp` attribute) -> "alias", 0 bytes
#   * bool columns (pushed predicates) -> bit-packed, 1 bit per event
#   * timestamps -> per-event int8/int16 deltas, or none at all for a
#     constant cadence ('d0': base + step * i)
# ``WireTape.expand()`` runs as the first ops of the step and rebuilds the
# full logical ``Tape`` on the device.

_INT_KINDS = ("i8", "i16", "i32")
_KIND_DTYPE = {
    "i8": np.int8,
    "i16": np.int16,
    "i32": np.int32,
    "f32": np.float32,
    "b1": np.uint8,  # bit-packed bools: 1 bit/event on the wire
}
_TS_KINDS = ("d0", "d8", "d16", "i32")  # widening order


def _int_kind(lo: int, hi: int) -> str:
    if -128 <= lo and hi <= 127:
        return "i8"
    if -32768 <= lo and hi <= 32767:
        return "i16"
    return "i32"


@dataclass
class WireTape:
    """Narrow micro-batch: numpy arrays from ``build_wire_tape``, device
    tensors after ``to``; ``expand()`` -> ``Tape``. The per-tape scalars
    the step reads (valid count, timestamp base and step) travel as the
    int32 leaf ``scalars``, so a step reads no tape value on the host and
    a CUDA graph captured on one tape replays another of the same
    structure (``runtime/segment.py``). ``n_valid`` and ``ts_base`` keep
    host copies for staging; ``capacity``, ``kinds``, ``ts_kind``,
    ``stream_const`` and ``epoch_i32`` are the tape's structure."""

    ts: object  # int8/int16 deltas, int32 absolute, or empty ('d0')
    n_valid: np.ndarray  # int32[1]
    stream: object  # int8[E] or None (single-stream plans)
    cols: Dict[str, object]  # key -> narrow array (absent for aliases)
    kinds: Tuple[Tuple[str, str], ...] = ()  # (key, kind), kind may be alias
    stream_const: int = -1  # valid when stream is None
    epoch_i32: int = 0  # int32-wrapped epoch for alias reconstruction
    # 'i32' absolute | 'd8'/'d16' per-event deltas (+ base) | 'd0'
    # constant delta: ZERO wire bytes — ts reconstructs from (base, step)
    ts_kind: str = "i32"
    ts_base: Optional[np.ndarray] = None  # int32[1] first ts, or [2]
    cap: int = 0  # tape capacity ('d0' ships no ts array)
    bounds: Dict[str, int] = field(default_factory=dict)
    # int32 [n_valid, ts base, ts step, last valid index (0 when empty)]
    scalars: object = None

    @property
    def capacity(self) -> int:
        return self.cap if self.cap else self.ts.shape[-1]

    def arrays(self) -> List:
        """Every array that travels to the device."""
        out = [self.ts] + list(self.cols.values())
        if self.stream is not None:
            out.append(self.stream)
        out.append(self.scalars)
        return out

    def to(self, device: torch.device) -> "WireTape":
        """Stage a host wire tape onto ``device`` (pinned, asynchronous:
        see ``_put``)."""
        return WireTape(
            ts=_put(self.ts, device),
            n_valid=self.n_valid,
            stream=(
                None if self.stream is None else _put(self.stream, device)
            ),
            cols={k: _put(v, device) for k, v in self.cols.items()},
            kinds=self.kinds,
            stream_const=self.stream_const,
            epoch_i32=self.epoch_i32,
            ts_kind=self.ts_kind,
            ts_base=self.ts_base,
            cap=self.cap,
            bounds=dict(self.bounds),
            scalars=_put(self.scalars, device),
        )

    def expand(self) -> Tape:
        """The logical tape, rebuilt on the staged tensors' device. All
        int32 arithmetic wraps as the reference's does."""
        i32 = torch.int32
        dev = self.ts.device
        cap = self.capacity
        # 0-d views of the staged scalars: no host read, no launch
        n, base, step, last = (self.scalars[i] for i in range(4))
        iota = torch.arange(cap, dtype=i32, device=dev)
        valid = iota < n
        if self.ts_kind == "i32":
            ts = self.ts
        elif self.ts_kind == "d0":
            # regular cadence: ts = base + step*i, clamped so padding
            # repeats the last valid timestamp (build_tape contract:
            # padding must never look like the newest event)
            ts = torch.clamp(iota, max=last) * step + base
        else:
            # sorted timestamps travel as per-event deltas; the padding
            # deltas are 0, which reproduces build_tape's "padding repeats
            # the last timestamp"
            ts = base + torch.cumsum(self.ts.to(i32), 0, dtype=i32)
        if self.stream is None:
            stream = torch.full((cap,), -1, dtype=i32, device=dev)
            stream.masked_fill_(valid, self.stream_const)
        else:
            stream = self.stream.to(i32)
        cols = {}
        bit = None
        for key, kind in self.kinds:
            if kind == "alias_ts":
                cols[key] = ts + self.epoch_i32
            elif kind == "b1":
                if bit is None:
                    bit = torch.arange(8, dtype=torch.uint8, device=dev)
                packed = self.cols[key]
                bits = (packed.unsqueeze(1) >> bit) & 1
                cols[key] = bits.reshape(-1).to(torch.bool)
            elif kind == "f32":
                cols[key] = self.cols[key]
            else:
                cols[key] = self.cols[key].to(i32)
        return Tape(ts, stream, valid, cols, dict(self.bounds))


def build_wire_tape(
    spec: TapeSpec,
    batches: Sequence[EventBatch],
    epoch_ms: int,
    sticky_kinds: Dict[str, str],
    capacity: Optional[int] = None,
    want_prov: bool = True,
) -> Tuple[WireTape, Optional[np.ndarray]]:
    """build_tape + narrowing. ``sticky_kinds`` (mutated) remembers each
    column's widest kind seen so widths only ever widen.
    ``want_prov=False`` skips building the merged-order provenance map
    (``build_host_tape``)."""
    tape, prov = build_host_tape(
        spec, batches, epoch_ms, capacity, want_prov=want_prov
    )
    total = sum(len(b) for b in batches)
    epoch_i32 = int(np.int64(epoch_ms) & 0xFFFFFFFF)
    if epoch_i32 >= 1 << 31:
        epoch_i32 -= 1 << 32

    kinds: List[Tuple[str, str]] = []
    cols: Dict[str, np.ndarray] = {}
    with np.errstate(over="ignore"):
        recon = None
        for key in sorted(tape.cols):
            col = tape.cols[key]
            sticky = sticky_kinds.get(key)
            if col.dtype == np.float32:
                kind = "f32"
            elif col.dtype == np.bool_:
                kind = "b1"  # bit-packed: 1 bit/event on the wire
            else:
                # alias check first (0 wire bytes); sticky 'alias_ts' may
                # degrade to a real int kind the first time it mismatches
                kind = None
                if sticky in (None, "alias_ts"):
                    if recon is None:
                        recon = tape.ts[:total] + np.int32(epoch_i32)
                    if np.array_equal(col[:total], recon):
                        kind = "alias_ts"
                if kind is None:
                    lo, hi = (
                        (int(col[:total].min()), int(col[:total].max()))
                        if total
                        else (0, 0)
                    )
                    kind = _int_kind(lo, hi)
                # widths only widen; alias degrades to measured width
                if sticky is not None and sticky != kind:
                    order = ("alias_ts",) + _INT_KINDS
                    if kind in order and sticky in order:
                        kind = order[max(order.index(kind),
                                         order.index(sticky))]
            sticky_kinds[key] = kind
            kinds.append((key, kind))
            if kind == "b1":
                cols[key] = np.packbits(col, bitorder="little")
            elif kind != "alias_ts":
                cols[key] = (
                    col
                    if kind in ("f32", "i32")
                    else col.astype(_KIND_DTYPE[kind])
                )

    # timestamps: sorted, so deltas are small -> 1-2 wire bytes instead
    # of 4; a perfectly regular cadence ('d0', the common replay/sensor
    # shape) ships ZERO ts bytes — just (first, step)
    ts_kind = sticky_kinds.get("__ts__")
    ts_arr = tape.ts
    ts_base = None
    if ts_kind == "d0" and total >= 2:
        # sticky fast path: the cadence was already proven regular on a
        # >=4096-event batch; any size keeps d0 here, and an irregular
        # batch falls through to the generic widening below
        step = int(tape.ts[1]) - int(tape.ts[0])
        if 0 <= step <= (1 << 30) and bool(
            np.all(
                tape.ts[1:total] - tape.ts[: total - 1] == step
            )
        ):
            ts_base = np.asarray([tape.ts[0], step], dtype=np.int32)
            ts_arr = np.zeros(0, dtype=np.int8)
            sticky_kinds["__ts__"] = "d0"
            return _finish_wire(
                spec, tape, total, cols, kinds, epoch_i32,
                "d0", ts_base, ts_arr,
            ), prov
    if ts_kind != "i32" and total:
        deltas = np.diff(tape.ts.astype(np.int64), prepend=tape.ts[0])
        vd = deltas[1:total]  # valid-region deltas (padding repeats)
        dmax = int(vd.max()) if len(vd) else 0
        dmin = int(vd.min()) if len(vd) else 0
        # d0 needs EVIDENCE of a regular cadence: a small batch is
        # trivially "constant" and would degrade on the next irregular
        # one — below the threshold the saving is noise anyway
        if dmin == dmax and 0 <= dmin <= (1 << 30) and total >= 4096:
            want = "d0"
        elif 0 <= dmin and dmax <= 127:
            want = "d8"
        elif 0 <= dmin and dmax <= 32767:
            want = "d16"
        else:
            want = "i32"
        if ts_kind in _TS_KINDS and want in _TS_KINDS:
            want = _TS_KINDS[
                max(_TS_KINDS.index(want), _TS_KINDS.index(ts_kind))
            ]
        ts_kind = want
        if ts_kind == "d0":
            step = int(vd[0]) if len(vd) else 0
            ts_base = np.asarray([tape.ts[0], step], dtype=np.int32)
            ts_arr = np.zeros(0, dtype=np.int8)
        elif ts_kind != "i32":
            ts_base = np.asarray([tape.ts[0]], dtype=np.int32)
            ts_arr = deltas.astype(
                np.int8 if ts_kind == "d8" else np.int16
            )
    else:
        ts_kind = "i32"
    sticky_kinds["__ts__"] = ts_kind
    return _finish_wire(
        spec, tape, total, cols, kinds, epoch_i32, ts_kind, ts_base,
        ts_arr,
    ), prov


def _finish_wire(
    spec, tape, total, cols, kinds, epoch_i32, ts_kind, ts_base, ts_arr
) -> WireTape:
    single = len(spec.stream_codes) == 1
    stream_const = next(iter(spec.stream_codes.values())) if single else -1
    narrow_stream_ok = max(spec.stream_codes.values(), default=0) <= 127
    base = (0, 0) if ts_base is None else (
        int(ts_base[0]), int(ts_base[1]) if len(ts_base) > 1 else 0
    )
    return WireTape(
        ts=ts_arr,
        n_valid=np.asarray([total], dtype=np.int32),
        stream=(
            None
            if single
            else tape.stream.astype(np.int8)
            if narrow_stream_ok
            else tape.stream
        ),
        cols=cols,
        kinds=tuple(kinds),
        stream_const=stream_const,
        epoch_i32=epoch_i32,
        ts_kind=ts_kind,
        ts_base=ts_base,
        cap=tape.capacity,
        bounds=dict(tape.bounds),
        scalars=np.asarray([total, base[0], base[1], max(total - 1, 0)],
                           dtype=np.int32),
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
    return build_host_tape(spec, batches, epoch_ms, capacity,
                           want_prov=False)[0]


def build_host_tape(
    spec: TapeSpec,
    batches: Sequence[EventBatch],
    epoch_ms: int,
    capacity: Optional[int] = None,
    want_prov: bool = True,
) -> Tuple[Tape, Optional[np.ndarray]]:
    """``build_tape``, also returning the merged-order provenance map:
    ``prov[i] = (batch index, row index)`` of tape position i (the lazy
    ring gathers multi-batch columns through it), or None when
    ``want_prov`` is False."""
    total = sum(len(b) for b in batches)
    cap = capacity if capacity is not None else bucket_size(total)
    if total > cap:
        raise ValueError(f"{total} events exceed tape capacity {cap}")

    ts_all = np.empty(total, dtype=np.int64)
    stream_all = np.empty(total, dtype=np.int32)
    prov = (
        np.empty((total, 2), dtype=np.int64) if want_prov else None
    )
    offset = 0
    for bi, b in enumerate(batches):
        n = len(b)
        if b.stream_id not in spec.stream_codes:
            raise KeyError(f"stream {b.stream_id!r} not in tape spec")
        ts_all[offset : offset + n] = b.timestamps
        stream_all[offset : offset + n] = spec.stream_codes[b.stream_id]
        if prov is not None:
            prov[offset : offset + n, 0] = bi
            prov[offset : offset + n, 1] = np.arange(n)
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
        if prov is not None:
            prov = prov[order]

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
    for key in spec.built_columns():
        stream_id, field_name = key.split(".", 1)
        dtype = spec.column_types[key].device_dtype
        col = np.zeros(cap, dtype=dtype)
        vals = _merged_stream_values(
            batches, stream_id, field_name, total, order, identity, dtype
        )
        if vals is not None:
            col[:total] = vals
        cols[key] = col

    for enc in spec.encoded:
        select = stream[:total] == enc.stream_code
        if enc.select_fn is not None:
            view = {k: v[:total] for k, v in cols.items()}
            select = select & np.asarray(enc.select_fn(view))
        in_cols = []
        for k in enc.in_keys:
            col = cols.get(k)
            if col is not None:
                col = col[:total]
            else:
                # the raw column was pruned off the wire; intern from the
                # host batches
                sid_k, fld_k = k.split(".", 1)
                col = _merged_stream_values(
                    batches, sid_k, fld_k, total, order, identity,
                    spec.column_types[k].device_dtype,
                )
                if col is None:
                    col = np.zeros(total, dtype=np.int64)
            in_cols.append(col)
        codes = enc.encoder.intern_rows(in_cols, select)
        col = np.zeros(cap, dtype=np.int32)
        col[:total] = codes
        cols[enc.out_key] = col

    # wire predicate pushdown: evaluate each host predicate over the
    # merged-order RAW host columns (f64 where the schema says DOUBLE)
    # and add the result as a bool pseudo-column — it ships bit-packed,
    # replacing the raw predicate columns on the wire entirely
    if spec.host_preds:
        henv: Dict[str, np.ndarray] = {}
        ref_keys = {k for hp in spec.host_preds for k in hp.refs}
        for key in ref_keys:
            if key == "@ts":  # merged-order absolute timestamps
                henv[key] = ts_sorted[:total]
                continue
            stream_id, fname = key.split(".", 1)
            vals = _merged_stream_values(
                batches, stream_id, fname, total, order, identity
            )
            henv[key] = (
                vals
                if vals is not None
                else np.zeros(total, dtype=np.int64)
            )
        for hp in spec.host_preds:
            res = np.broadcast_to(
                np.asarray(hp.fn(henv), dtype=hp.dtype), (total,)
            )
            col = np.zeros(cap, dtype=hp.dtype)
            col[:total] = res
            cols[hp.out_key] = col

    bounds = _relevance_bounds(spec, stream[:total], cols, total)
    return Tape(ts, stream, valid, cols, bounds), prov


def _relevance_bounds(spec: TapeSpec, stream: np.ndarray, cols,
                      total: int) -> Dict[str, int]:
    """Per chain matcher, an upper bound on the relevant events of its
    widest query. A query without literal conjuncts counts the union of
    its elements' events (stream, and pushed mask), exactly. A query
    whose elements carry ``col == literal`` conjuncts (a stack's members)
    adds up its elements' bounds: the element's stream count, cut to the
    count of each of its literals in the column, from one count of each
    column's values over the stream (``np.bincount`` for small
    non-negative values, else ``np.unique``)."""
    masks: Dict[int, np.ndarray] = {}
    base: Dict[Tuple[int, Optional[str]], int] = {}  # an element's events
    # (stream code, column) -> (sorted values, their counts, the column's
    # dtype), or None when the column is not an integer column of the tape
    value_counts: Dict[Tuple[int, str], Optional[Tuple]] = {}

    def in_stream(code: int) -> np.ndarray:
        if code not in masks:
            masks[code] = stream == code
        return masks[code]

    def literal_count(code: int, key: str, lit: int) -> Optional[int]:
        if (code, key) not in value_counts:
            col = cols.get(key)
            vc = None
            if col is not None and col.dtype.kind in "iu":
                vals = col[:total]
                if len(spec.stream_codes) > 1:
                    vals = vals[in_stream(code)]
                if vals.size and vals.min() >= 0 and (
                    vals.max() <= 4 * vals.size + 1024
                ):
                    bc = np.bincount(vals)
                    nz = np.flatnonzero(bc)
                    vc = (nz, bc[nz], col.dtype)
                else:
                    vc = (*np.unique(vals, return_counts=True), col.dtype)
            value_counts[(code, key)] = vc
        vc = value_counts[(code, key)]
        if vc is None:
            return None
        u, c, dtype = vc
        info = np.iinfo(dtype)
        if not info.min <= lit <= info.max:
            return None  # the device's cast of this literal wraps
        i = int(np.searchsorted(u, lit))
        return int(c[i]) if i < len(u) and u[i] == lit else 0

    bounds = {}
    for name, members in spec.relevance:
        best = 0
        for elements in members:
            if not any(eqs for _, _, eqs in elements):
                rel = np.zeros(total, dtype=np.bool_)
                for code, key, _ in elements:
                    m = in_stream(code)
                    rel |= m if key is None else m & cols[key][:total]
                best = max(best, int(np.count_nonzero(rel)))
                continue
            n = 0
            for code, key, eqs in elements:
                if (code, key) not in base:
                    m = in_stream(code)
                    base[(code, key)] = int(np.count_nonzero(
                        m if key is None else m & cols[key][:total]
                    ))
                el = base[(code, key)]
                for col_key, lit in eqs:
                    c = literal_count(code, col_key, lit)
                    if c is not None:
                        el = min(el, c)
                n += el
            best = max(best, n)
        bounds[name] = best
    return bounds
