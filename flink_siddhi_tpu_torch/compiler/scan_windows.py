"""Per-event scan windows: ``#window.unique``, ``#window.sort``,
``#window.session``, ``#window.frequent`` and ``#window.lossyFrequent``.

The torch port of ``flink_siddhi_tpu/compiler/scan_windows.py``. These
windows keep a data-dependent set (the latest event per key, the top n by a
key, each key's open session, the counted heavy hitters) whose evolution
is sequential in the event axis; the reference runs each as a ``lax.scan``
over the micro-batch with a fixed-size table carried across batches. Here
each scan is one call of a hand-written CUDA kernel (its plain PyTorch
version on the CPU), with no host read, so a CUDA graph holds the step:

* ``#window.unique(attr)`` (Siddhi's ``#window.unique:ever``): the fold
  ``cuda_ops.unique_window_fold`` (K3), float and int32 value columns, in
  groups of at most 64 aggregate slots (the kernel's plan);
* ``#window.sort(n, attr[, 'asc'|'desc'])``: ``cuda_ops.sort_window_scan``
  (K9), a ``[C]`` buffer, ``[P, C]`` inside ``partition with``;
* ``#window.session(gap[, key])``: ``cuda_ops.session_scan`` (K7), a table
  of one open session per key; its rows are the closed sessions (packed
  output), and the flush at the end of the stream closes every open one;
* ``#window.frequent`` / ``lossyFrequent``: ``cuda_ops.frequency_scan``
  (K8), a fixed table of ``cap`` counted keys.

Keyed tables bucket to their encoder's size (128 slots, doubling as keys
appear); the host knows that size, so growth (``grow_state``) never waits
for the device. ``#window.unique`` inside ``partition with`` raises
``SiddhiQLError`` naming ROADMAP.md Queue 1 item 8 (the reference masks
its aggregates to the arriving event's partition, a segmented fold).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import torch_dtype
from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.encoders import GroupEncoder
from ..schema.types import AttributeType
from .cuda_ops import (
    FOLD_MAX_ARGS,
    FOLD_MAX_SLOTS,
    f32_to_i32,
    frequency_scan,
    session_scan,
    sort_window_scan,
    unique_window_fold,
)
from .expr import ColumnEnv, ExprResolver, as_column, compile_expr
from .output import OutputField, OutputSchema, emission_order
from .plan import _later
from .window import (_Agg, _bucket, _group_encoding, _identity, _query_mask,
                     _SlotResolver)

_MIN_UNIQUE_CAPACITY = 128
_AGG_KINDS = ("count", "sum", "avg", "min", "max")


def _int_cols(arg_types) -> Tuple[int, ...]:
    return tuple(j for j, t in enumerate(arg_types)
                 if torch_dtype(t.device_dtype) != torch.float32)


def _arg_words(arg_fns, arg_types, env, tape) -> torch.Tensor:
    """The aggregate arguments as float32 ``[A, E]``, each cast to its own
    type first; an int32 column by bit pattern."""
    E = tape.capacity
    cols = [as_column(fn(env), E, tape.ts).to(torch_dtype(t.device_dtype))
            for fn, t in zip(arg_fns, arg_types)]
    if not cols:
        return torch.zeros((0, E), dtype=torch.float32, device=tape.ts.device)
    return torch.stack([c.view(torch.float32) if c.dtype == torch.int32
                        else c for c in cols])


def _state_words(state: Dict, prefix: str, n: int, like) -> torch.Tensor:
    """State columns ``{prefix}{j}`` stacked as float32 words."""
    if not n:
        return torch.zeros((0, *like.shape), dtype=torch.float32,
                           device=like.device)
    return torch.stack([state[f"{prefix}{j}"].view(torch.float32)
                        if state[f"{prefix}{j}"].dtype == torch.int32
                        else state[f"{prefix}{j}"] for j in range(n)])


def _typed_state(words: torch.Tensor, t: AttributeType) -> torch.Tensor:
    """A float32 word row back to its column type (a view)."""
    dt = torch_dtype(t.device_dtype)
    return words.view(torch.int32) if dt == torch.int32 else words


def _slot_value(row: torch.Tensor, agg: _Agg, int_cols) -> torch.Tensor:
    """An aggregate slot's float32 row in its output type, as the
    reference's ``astype``: an int column's min / max row is int32 by bit
    pattern; a float row becomes an int type toward zero, saturating."""
    if agg.kind in ("min", "max") and agg.arg_idx in int_cols:
        row = row.view(torch.int32)
    dt = torch_dtype(agg.out_type.device_dtype)
    if dt == torch.int32 and row.dtype == torch.float32:
        return f32_to_i32(row)
    return row.to(dt)


def _pick(words: torch.Tensor, cols: List[int]) -> torch.Tensor:
    """Rows ``cols`` of ``words`` (all of them as they are), indexed by
    host ints: no index tensor goes to the device."""
    if cols == list(range(int(words.shape[0]))):
        return words
    if not cols:
        return words[:0]
    return torch.stack([words[a] for a in cols])


def _fold_groups(aggs: List[_Agg]) -> List[Tuple[List[int], List[int]]]:
    """The aggregate slots in groups that K3's plan takes (at most
    FOLD_MAX_SLOTS slots reading at most FOLD_MAX_ARGS columns): each
    ``(slot indices, the columns they read)``."""
    groups: List[Tuple[List[int], List[int]]] = []
    slots: List[int] = []
    cols: List[int] = []
    for s, a in enumerate(aggs):
        new = a.kind != "count" and a.arg_idx not in cols
        if slots and (len(slots) == FOLD_MAX_SLOTS
                      or (new and len(cols) == FOLD_MAX_ARGS)):
            groups.append((slots, cols))
            slots, cols = [], []
            new = a.kind != "count"
        slots.append(s)
        if new:
            cols.append(a.arg_idx)
    groups.append((slots, cols))
    return groups


@dataclass
class ScanWindowArtifact:
    """``#window.sort`` and ``#window.unique`` with aggregates. State: the
    buffer — ``valid`` bool, for sort ``key`` float32, one ``a{j}`` column
    per aggregate argument in its own type; ``[C]``, or ``[P, C]`` for a
    sort inside ``partition with`` — and ``enabled``: the reference's
    keys."""

    name: str
    output_schema: OutputSchema
    stream_code: int
    filter_fns: List
    kind: str  # 'sort' | 'unique'
    sort_n: Optional[int]
    sort_key_fn: Optional[Callable]
    sort_desc: bool
    code_key: Optional[str]
    encoder: Optional[GroupEncoder]
    aggs: List[_Agg]
    arg_fns: List[Callable]
    arg_types: List[AttributeType]
    proj_fns: List
    output_mode: str = "aligned"
    # a sort inside 'partition with': one buffer a partition key
    part_key: Optional[str] = None
    part_encoder: Optional[GroupEncoder] = None

    def cost_info(self) -> Dict:
        """Admission-cost descriptor (analysis/admit.py): sort keeps a
        fixed top-N buffer; unique keeps the last event per key in a
        bucketed table that grows with key cardinality."""
        info = {
            "name": self.name,
            "kind": "scan_window",
            "amplification": 1,
            "residency_ms": None,
        }
        if self.kind == "unique":
            info["grows_with"] = "keys"
        return info

    def _cap(self) -> int:
        if self.kind == "sort":
            return self.sort_n
        return _bucket(len(self.encoder), _MIN_UNIQUE_CAPACITY)

    def _pcap(self) -> int:
        return _bucket(
            len(self.part_encoder) if self.part_encoder else 1, 16)

    def _buf_shape(self):
        C = self._cap()
        return (self._pcap(), C) if self.part_key is not None else (C,)

    def init_state(self, device) -> Dict:
        shape = self._buf_shape()
        st = {
            "enabled": torch.tensor(True, device=device),
            "valid": torch.zeros(shape, dtype=torch.bool, device=device),
        }
        if self.kind == "sort":
            st["key"] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
        for j, t in enumerate(self.arg_types):
            st[f"a{j}"] = torch.zeros(
                shape, dtype=torch_dtype(t.device_dtype), device=device)
        return st

    def grow_state(self, state: Dict) -> Dict:
        """Re-bucket the buffer after host interning found new keys or
        partitions (a host-side size: no device wait)."""
        shape = self._buf_shape()
        if tuple(state["valid"].shape) == shape:
            return state
        out = {"enabled": state["enabled"]}
        for k, v in state.items():
            if k == "enabled":
                continue
            pad = torch.zeros(shape, dtype=v.dtype, device=v.device)
            pad[tuple(slice(0, s) for s in v.shape)] = v
            out[k] = pad
        return out

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E = tape.capacity
        if tuple(state["valid"].shape) != self._buf_shape():
            raise ValueError(
                f"{self.name}: a {tuple(state['valid'].shape)} buffer for "
                f"{self._buf_shape()}; grow the state first "
                "(CompiledPlan.grow_state)")
        vals = _arg_words(self.arg_fns, self.arg_types, env, tape)
        int_cols = _int_cols(self.arg_types)
        if self.kind == "sort":
            new_buf, rows = self._sort(state, env, tape, mask, vals,
                                       int_cols)
        else:
            new_buf, rows = self._unique(state, env, mask, vals, int_cols)
        for s, a in enumerate(self.aggs):
            env[a.slot] = _slot_value(rows[s], a, int_cols)
        cols = tuple(as_column(p(env), E, tape.ts) for p in self.proj_fns)
        new_state = {"enabled": state["enabled"], **new_buf}
        for j, t in enumerate(self.arg_types):
            new_state[f"a{j}"] = _typed_state(new_state[f"a{j}"], t)
        return new_state, (mask, tape.ts, cols)

    def _sort(self, state, env, tape, mask, vals, int_cols):
        E = tape.capacity
        keys = as_column(self.sort_key_fn(env), E, tape.ts).to(torch.float32)
        if self.sort_desc:
            keys = -keys
        if self.part_key is not None:
            part = env[self.part_key].to(torch.int32).clamp(
                0, self._pcap() - 1)
        else:
            part = torch.zeros(E, dtype=torch.int32, device=mask.device)
        flat = self.part_key is None
        grow = (lambda t: t.unsqueeze(-2)) if flat else (lambda t: t)
        bufs = _state_words(state, "a", len(self.arg_types), state["valid"])
        valid, bkey, bufs, rows = sort_window_scan(
            mask, part, keys, vals, grow(state["valid"]), grow(state["key"]),
            grow(bufs), [(a.kind, a.arg_idx) for a in self.aggs], int_cols)
        if flat:
            valid, bkey, bufs = valid[0], bkey[0], bufs[:, 0]
        out = {"valid": valid, "key": bkey}
        for j in range(len(self.arg_types)):
            out[f"a{j}"] = bufs[j]
        return out, rows

    def _unique(self, state, env, mask, vals, int_cols):
        """K3 once per group of slots (``_fold_groups``), each with only
        the columns its slots read; every call sees the same mask and
        codes, so each returns the same valid and the same table for its
        columns."""
        codes = env[self.code_key]
        bufs0 = _state_words(state, "a", len(self.arg_types), state["valid"])
        out: Dict[str, torch.Tensor] = {}
        rows = []
        for slot_ids, cols in _fold_groups(self.aggs):
            at = {a: i for i, a in enumerate(cols)}
            slots = [(self.aggs[s].kind, at.get(self.aggs[s].arg_idx, -1))
                     for s in slot_ids]
            valid, bufs, g_rows = unique_window_fold(
                mask, codes, _pick(vals, cols), state["valid"],
                _pick(bufs0, cols), slots,
                tuple(at[a] for a in cols if a in int_cols))
            out.setdefault("valid", valid)
            for i, a in enumerate(cols):
                out.setdefault(f"a{a}", bufs[i])
            rows.append(g_rows)
        # the groups are consecutive runs of slots
        return out, torch.cat(rows) if len(rows) > 1 else rows[0]


@dataclass
class SessionWindowArtifact:
    """``#window.session(gap[, key])``: per-key sessions that close when
    the gap elapses with no event for that key. State: ``open`` bool,
    ``last`` and ``cnt`` int32, per argument ``s{j}`` float32 and
    ``mn{j}`` / ``mx{j}`` in its type, all ``[G]``, and ``enabled``.

    Emission timing, as in the reference: a closed session emits when its
    key's next event arrives past the gap (ts = the session's last event +
    gap) or at the end of the stream (``flush``)."""

    name: str
    output_schema: OutputSchema
    stream_code: int
    filter_fns: List
    gap_ms: int
    code_key: Optional[str]
    encoder: Optional[GroupEncoder]
    aggs: List[_Agg]
    arg_fns: List[Callable]
    arg_types: List[AttributeType]
    proj_map: List  # per select item: ('key',) | ('agg', slot)
    output_mode: str = "packed"

    def cost_info(self) -> Dict:
        """Admission-cost descriptor: per-key session aggregates (no
        events retained); one closed-session row per closing event.
        The session table grows with key cardinality."""
        return {
            "name": self.name,
            "kind": "session_window",
            "amplification": 1,
            "residency_ms": None,
            "grows_with": "keys",
        }

    def _cap(self) -> int:
        return _bucket(len(self.encoder) if self.encoder else 1,
                       _MIN_UNIQUE_CAPACITY)

    def init_state(self, device) -> Dict:
        G = self._cap()
        st = {
            "enabled": torch.tensor(True, device=device),
            "open": torch.zeros(G, dtype=torch.bool, device=device),
            "last": torch.zeros(G, dtype=torch.int32, device=device),
            "cnt": torch.zeros(G, dtype=torch.int32, device=device),
        }
        for j, t in enumerate(self.arg_types):
            dt = torch_dtype(t.device_dtype)
            st[f"s{j}"] = torch.zeros(G, dtype=torch.float32, device=device)
            st[f"mn{j}"] = torch.full((G,), _identity("min", dt), dtype=dt,
                                      device=device)
            st[f"mx{j}"] = torch.full((G,), _identity("max", dt), dtype=dt,
                                      device=device)
        return st

    def grow_state(self, state: Dict) -> Dict:
        G = self._cap()
        if int(state["open"].shape[0]) >= G:
            return state
        out = {"enabled": state["enabled"]}
        for k, v in state.items():
            if k == "enabled":
                continue
            fill = (_identity("min" if k.startswith("mn") else "max",
                              v.dtype)
                    if k.startswith(("mn", "mx")) else 0)
            pad = torch.full((G,), fill, dtype=v.dtype, device=v.device)
            pad[: v.shape[0]] = v
            out[k] = pad
        return out

    def emit_block_width(self, tape_capacity: int, state: Dict) -> int:
        return tape_capacity + self._cap()

    def _session_rows(self, cnt, s, mn, mx) -> Dict[str, torch.Tensor]:
        """Slot values (float32) of sessions with count ``cnt`` int32
        ``[X]``, sums ``s`` float32 ``[A, X]`` and extremes ``mn`` / ``mx``
        float32 words ``[A, X]`` (the reference's ``_session_rows``)."""
        cntf = cnt.to(torch.float32)
        out = {}
        for agg in self.aggs:
            j = agg.arg_idx
            if agg.kind == "count":
                v = cntf
            elif agg.kind == "sum":
                v = s[j]
            elif agg.kind == "avg":
                v = s[j] / torch.clamp(cntf, min=1.0)
            else:
                w = (mn if agg.kind == "min" else mx)[j]
                v = _typed_state(w, self.arg_types[j]).to(torch.float32)
            out[agg.slot] = v
        return out

    def _pack(self, n, emit_ts, code_col, slot_vals):
        """``(n, (1 + fields, width) int32 block)``: the ts row, then one
        row per select item (key codes; float aggregates by bit pattern;
        integer aggregates rounded, as the reference's round + astype)."""
        rows = [emit_ts.to(torch.int32)]
        for kind, f in zip(self.proj_map, self.output_schema.fields):
            if kind[0] == "key":
                rows.append(code_col.to(torch.int32))
                continue
            v = slot_vals[kind[1]].to(torch.float32)
            if torch_dtype(f.atype.device_dtype) == torch.float32:
                rows.append(v.view(torch.int32))
            else:
                rows.append(f32_to_i32(torch.round(v)))
        return n, torch.stack(rows)

    def _state_words(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        A = len(self.arg_types)
        return (_state_words(state, "mn", A, state["open"]),
                _state_words(state, "mx", A, state["open"]))

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E = tape.capacity
        A = len(self.arg_types)
        G = int(state["open"].shape[0])
        if G != self._cap():
            raise ValueError(
                f"{self.name}: a {G}-key session table for "
                f"{len(self.encoder) if self.encoder else 1} keys; grow the "
                "state first (CompiledPlan.grow_state)")
        dev = mask.device
        codes = (env[self.code_key].to(torch.int32).clamp(0, G - 1)
                 if self.code_key is not None
                 else torch.zeros(E, dtype=torch.int32, device=dev))
        vals = (torch.stack([as_column(fn(env), E, tape.ts).to(torch.float32)
                             for fn in self.arg_fns])
                if A else torch.zeros((0, E), dtype=torch.float32,
                                      device=dev))
        s = (torch.stack([state[f"s{j}"] for j in range(A)]) if A
             else torch.zeros((0, G), dtype=torch.float32, device=dev))
        mn, mx = self._state_words(state)
        (open_, last, cnt, s, mn, mx, closes, c_last, c_cnt, c_s, c_mn,
         c_mx) = session_scan(
            mask, codes, tape.ts.to(torch.int32), vals, state["open"],
            state["last"], state["cnt"], s, mn, mx, self.gap_ms,
            _int_cols(self.arg_types))
        slot_vals = self._session_rows(c_cnt, c_s, c_mn, c_mx)
        n = closes.sum(dtype=torch.int32)
        pos = torch.cumsum(closes, 0, dtype=torch.int32) - 1
        dest = torch.where(closes, pos, E).long()

        def compact(col):
            out = torch.zeros(E + 1, dtype=col.dtype, device=dev)
            return out.scatter_(0, dest, col)[:E]

        new_state = self._new_state(state, open_, last, cnt, s, mn, mx)
        return new_state, self._pack(
            n, compact(c_last + self.gap_ms), compact(codes),
            {k: compact(v) for k, v in slot_vals.items()})

    def _new_state(self, state, open_, last, cnt, s, mn, mx) -> Dict:
        out = {"enabled": state["enabled"], "open": open_, "last": last,
               "cnt": cnt}
        for j, t in enumerate(self.arg_types):
            out[f"s{j}"] = s[j]
            out[f"mn{j}"] = _typed_state(mn[j], t)
            out[f"mx{j}"] = _typed_state(mx[j], t)
        return out

    @property
    def flush_is_noop(self) -> bool:
        return False

    def flush(self, state: Dict) -> Tuple[Dict, Tuple]:
        """End of stream: every open session closes (time passes every
        deadline: the engine-wide flush rule)."""
        G = int(state["open"].shape[0])
        A = len(self.arg_types)
        open_ = state["open"]
        dev = open_.device
        n = open_.sum(dtype=torch.int32)
        pos = torch.cumsum(open_, 0, dtype=torch.int32) - 1
        dest = torch.where(open_, pos, G).long()
        codes = torch.arange(G, dtype=torch.int32, device=dev)
        s = (torch.stack([state[f"s{j}"] for j in range(A)]) if A
             else torch.zeros((0, G), dtype=torch.float32, device=dev))
        mn, mx = self._state_words(state)
        rows = self._session_rows(state["cnt"], s, mn, mx)

        def compact(col):
            out = torch.zeros(G + 1, dtype=col.dtype, device=dev)
            return out.scatter_(0, dest, col)[:G]

        new_state = dict(state)
        new_state["open"] = torch.zeros(G, dtype=torch.bool, device=dev)
        return new_state, self._pack(
            n, compact(state["last"] + self.gap_ms), compact(codes),
            {k: compact(v) for k, v in rows.items()})

    def decode_packed(self, n: int, block: np.ndarray):
        """Rows in emission order; the key column decodes its codes back
        through the encoder."""
        schema = self.output_schema
        order = emission_order(block[0], n)
        ts_list = np.asarray(block[0, :n])[order].astype(np.int64).tolist()
        col_lists = []
        for c, (f, kind) in enumerate(zip(schema.fields, self.proj_map)):
            raw = np.asarray(block[1 + c, :n])[order]
            if kind[0] == "key":
                # an append-only encoder: extend the cached table
                lut = self.__dict__.setdefault("_lut_cache", {}).setdefault(
                    c, [])
                for i in range(len(lut), len(self.encoder)):
                    lut.append(f.decode(self.encoder.value(i)[0]))
                col_lists.append([lut[int(v)] if 0 <= int(v) < len(lut)
                                  else None for v in raw.tolist()])
            else:
                if torch_dtype(f.atype.device_dtype) == torch.float32:
                    raw = raw.view(np.float32)
                col_lists.append(f.decode_column(raw))
        rows = (list(zip(ts_list, map(tuple, zip(*col_lists))))
                if col_lists else [(t, ()) for t in ts_list])
        return [(schema, rows)]


@dataclass
class FrequencyWindowArtifact:
    """``#window.frequent(count[, attrs])`` (Misra-Gries heavy hitters) and
    ``#window.lossyFrequent(support[, error][, attrs])`` (Manku-Motwani
    lossy counting), siddhi-core's FrequentWindowProcessor and
    LossyFrequentWindowProcessor: a fixed table of ``cap`` counted keys,
    each keeping its latest event. State: ``valid`` bool, ``code``,
    ``freq`` (and, lossy, ``delta``) int32, ``a{j}`` in their types, all
    ``[cap]``; ``seen`` int32 (events so far); ``enabled``.

    Emits aligned rows for admitted arrivals (frequent) or arrivals that
    meet the support threshold (lossyFrequent), aggregating over the
    tracked set (the reference's table, documented there: a full lossy
    table replaces its entry of smallest freq + delta)."""

    name: str
    output_schema: OutputSchema
    stream_code: int
    filter_fns: List
    kind: str  # 'frequent' | 'lossyFrequent'
    cap: int
    support: float
    error: float
    code_key: str
    encoder: GroupEncoder
    aggs: List[_Agg]
    arg_fns: List[Callable]
    arg_types: List[AttributeType]
    proj_fns: List
    output_mode: str = "aligned"

    def cost_info(self) -> Dict:
        """Admission-cost descriptor: fixed-slot heavy-hitter sketch —
        the canonical bounded-memory shape; one row per admitted
        arrival."""
        return {
            "name": self.name,
            "kind": "sketch_window",
            "amplification": 1,
            "residency_ms": None,
        }

    @property
    def _lossy(self) -> bool:
        return self.kind == "lossyFrequent"

    def init_state(self, device) -> Dict:
        C = self.cap
        st = {
            "enabled": torch.tensor(True, device=device),
            "valid": torch.zeros(C, dtype=torch.bool, device=device),
            "code": torch.full((C,), -1, dtype=torch.int32, device=device),
            "freq": torch.zeros(C, dtype=torch.int32, device=device),
            "seen": torch.tensor(0, dtype=torch.int32, device=device),
        }
        if self._lossy:
            st["delta"] = torch.zeros(C, dtype=torch.int32, device=device)
        for j, t in enumerate(self.arg_types):
            st[f"a{j}"] = torch.zeros(
                C, dtype=torch_dtype(t.device_dtype), device=device)
        return st

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = _query_mask(self, state, tape, env)
        E = tape.capacity
        lossy = self._lossy
        # the reference's float32 constants: ceil(1 / error) events a
        # bucket, float32(support - error) times float32(n) the threshold
        width = max(int(np.ceil(1.0 / self.error)), 1) if lossy else 0
        factor = float(np.float32(self.support - self.error))
        delta = (state["delta"] if lossy
                 else torch.zeros_like(state["freq"]))
        int_cols = _int_cols(self.arg_types)
        (valid, code, freq, delta, seen, bufs, emit, rows) = frequency_scan(
            mask, env[self.code_key].to(torch.int32),
            _arg_words(self.arg_fns, self.arg_types, env, tape),
            state["valid"], state["code"], state["freq"], delta,
            state["seen"],
            _state_words(state, "a", len(self.arg_types), state["valid"]),
            [(a.kind, a.arg_idx) for a in self.aggs], int_cols, lossy, width,
            factor, len(self.encoder))
        for s, a in enumerate(self.aggs):
            env[a.slot] = _slot_value(rows[s], a, int_cols)
        cols = tuple(as_column(p(env), E, tape.ts) for p in self.proj_fns)
        new_state = {"enabled": state["enabled"], "valid": valid,
                     "code": code, "freq": freq, "seen": seen}
        if lossy:
            new_state["delta"] = delta
        for j, t in enumerate(self.arg_types):
            new_state[f"a{j}"] = _typed_state(bufs[j], t)
        return new_state, (mask & emit, tape.ts, cols)


def _projections(q, rewritten, collector, resolver, extensions):
    slot_types = {a.slot: a.out_type for a in collector.aggs}
    slot_resolver = _SlotResolver(resolver, slot_types)
    proj_fns: List = []
    out_fields: List[OutputField] = []
    for item in rewritten:
        ce = compile_expr(item.expr, slot_resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(
            OutputField(item.output_name(), ce.atype, ce.table))
    return proj_fns, OutputSchema(q.output_stream, tuple(out_fields))


def _check_aggs(collector, kind: str) -> None:
    for a in collector.aggs:
        if a.kind not in _AGG_KINDS:
            raise SiddhiQLError(
                f"{a.kind}() is not supported over #window.{kind}")


def compile_scan_window(
    q: ast.Query,
    name: str,
    window,
    resolver: ExprResolver,
    schemas,
    stream_codes,
    extensions,
    filter_fns,
    rewritten,
    collector,
    having_re,
):
    kind, args = window
    inp = q.input
    part_attr = None
    if q.partition_with:
        part_attr = dict(q.partition_with).get(inp.stream_id)
        if part_attr is None:
            raise SiddhiQLError(
                f"stream {inp.stream_id!r} has no partition key")
    if kind == "session":
        return _compile_session_window(
            q, name, args, resolver, stream_codes, extensions, filter_fns,
            rewritten, collector, having_re, part_attr=part_attr)
    if kind in ("frequent", "lossyFrequent"):
        if part_attr is not None:
            raise SiddhiQLError(
                f"#window.{kind} inside 'partition with' is not "
                "supported yet")
        return _compile_frequency_window(
            q, name, kind, args, resolver, schemas, stream_codes,
            extensions, filter_fns, rewritten, collector, having_re)
    gb = tuple(ast.bare_group_key(g) for g in q.selector.group_by)
    if gb and (part_attr is None or gb != (part_attr,)):
        raise SiddhiQLError(
            f"group by over #window.{kind} is not supported yet")
    if having_re is not None:
        raise SiddhiQLError(
            f"having over #window.{kind} is not supported yet")
    _check_aggs(collector, kind)

    sort_n = sort_key_fn = code_key = encoder = None
    sort_desc = False
    encoded = ()
    if kind == "sort":
        if not args or not isinstance(args[0], ast.Literal):
            raise SiddhiQLError(
                "#window.sort needs (length, attribute[, 'asc'|'desc'])")
        sort_n = int(args[0].value)
        if len(args) < 2:
            raise SiddhiQLError("#window.sort needs a sort attribute")
        ce = compile_expr(args[1], resolver, extensions)
        if not ce.atype.is_numeric:
            raise SiddhiQLError("#window.sort key must be numeric")
        sort_key_fn = ce.fn
        if len(args) > 2:
            if not (isinstance(args[2], ast.Literal)
                    and args[2].value in ("asc", "desc")):
                raise SiddhiQLError(
                    "#window.sort order must be 'asc' or 'desc'")
            sort_desc = args[2].value == "desc"
    else:  # unique
        if len(args) != 1 or not isinstance(args[0], ast.Attr):
            raise SiddhiQLError("#window.unique needs one key attribute")
        if part_attr is not None:
            raise _later("#window.unique inside 'partition with'", 8)
        code_key, encoder, encoded = _group_encoding(
            name, [resolver.resolve(args[0])], stream_codes[inp.stream_id],
            filter_fns)
    part_key = part_encoder = None
    part_encoded = ()
    if part_attr is not None:
        part_key, part_encoder, part_encoded = _group_encoding(
            name + "@part", [resolver.resolve(ast.Attr(part_attr))],
            stream_codes[inp.stream_id], filter_fns)

    proj_fns, schema = _projections(q, rewritten, collector, resolver,
                                    extensions)
    art = ScanWindowArtifact(
        name=name,
        output_schema=schema,
        stream_code=stream_codes[inp.stream_id],
        filter_fns=filter_fns,
        kind=kind,
        sort_n=sort_n,
        sort_key_fn=sort_key_fn,
        sort_desc=sort_desc,
        code_key=code_key,
        encoder=encoder,
        aggs=collector.aggs,
        arg_fns=collector.arg_fns,
        arg_types=collector.arg_types,
        proj_fns=proj_fns,
        part_key=part_key,
        part_encoder=part_encoder,
    )
    art.encoded_columns = tuple(encoded) + tuple(part_encoded)
    return art


def _compile_frequency_window(
    q, name, kind, args, resolver, schemas, stream_codes, extensions,
    filter_fns, rewritten, collector, having_re,
):
    inp = q.input
    if q.selector.group_by:
        raise SiddhiQLError(
            f"group by over #window.{kind} is not supported yet")
    if having_re is not None:
        raise SiddhiQLError(
            f"having over #window.{kind} is not supported yet")
    _check_aggs(collector, kind)
    support = error = 0.0
    if kind == "frequent":
        cap = int(args[0].value)
        if cap <= 0:
            raise SiddhiQLError("#window.frequent count must be > 0")
        rest = list(args[1:])
    else:
        support = float(args[0].value)
        rest = list(args[1:])
        # an optional errorBound literal before the attribute list
        if rest and isinstance(rest[0], ast.Literal) and not isinstance(
                rest[0], ast.TimeLiteral):
            error = float(rest[0].value)
            rest = rest[1:]
        else:
            error = support / 10.0  # siddhi's default: support / 10
        if not 0.0 < error < support <= 1.0:
            raise SiddhiQLError(
                "#window.lossyFrequent needs 0 < errorBound < "
                "supportThreshold <= 1")
        # a fixed table: 4 / error slots comfortably exceed lossy
        # counting's 1 / error working set between prunes
        cap = _bucket(int(math.ceil(4.0 / error)), 16)
    if not rest:
        # no attribute list: siddhi keys the frequency on ALL attributes
        rest = [ast.Attr(n) for n in schemas[inp.stream_id].field_names]
    for a in rest:
        if not isinstance(a, ast.Attr):
            raise SiddhiQLError(
                f"#window.{kind} key arguments must be attributes")
    code_key, encoder, encoded = _group_encoding(
        name, [resolver.resolve(a) for a in rest],
        stream_codes[inp.stream_id], filter_fns)
    proj_fns, schema = _projections(q, rewritten, collector, resolver,
                                    extensions)
    art = FrequencyWindowArtifact(
        name=name,
        output_schema=schema,
        stream_code=stream_codes[inp.stream_id],
        filter_fns=filter_fns,
        kind=kind,
        cap=cap,
        support=support,
        error=error,
        code_key=code_key,
        encoder=encoder,
        aggs=collector.aggs,
        arg_fns=collector.arg_fns,
        arg_types=collector.arg_types,
        proj_fns=proj_fns,
    )
    art.encoded_columns = encoded
    return art


def _compile_session_window(
    q, name, args, resolver, stream_codes, extensions, filter_fns, rewritten,
    collector, having_re, part_attr=None,
):
    gap_ms, key_attr = args
    inp = q.input
    if part_attr is not None:
        # 'partition with' sessions: the partition key is the session key
        # (each partition instance tracks its own gap)
        if key_attr is not None and key_attr.name != part_attr:
            raise SiddhiQLError(
                "#window.session inside 'partition with' must key the "
                "session by the partition attribute (or omit the key)")
        key_attr = ast.Attr(part_attr)
    if having_re is not None:
        raise SiddhiQLError(
            "having over #window.session is not supported yet")
    code_key, encoder, encoded = None, None, ()
    if key_attr is not None:
        code_key, encoder, encoded = _group_encoding(
            name, [resolver.resolve(key_attr)], stream_codes[inp.stream_id],
            filter_fns)
    gb = tuple(ast.bare_group_key(g) for g in q.selector.group_by)
    if gb and (key_attr is None or gb != (key_attr.name,)):
        raise SiddhiQLError(
            "group by on #window.session must be the session key")
    slot_names = {a.slot for a in collector.aggs}
    proj_map = []
    out_fields: List[OutputField] = []
    for item in rewritten:
        e = item.expr
        if isinstance(e, ast.Attr) and e.name in slot_names:
            agg = next(a for a in collector.aggs if a.slot == e.name)
            proj_map.append(("agg", e.name))
            out_fields.append(
                OutputField(item.output_name(), agg.out_type, None))
        elif (isinstance(e, ast.Attr) and key_attr is not None
              and e.name == key_attr.name):
            ra = resolver.resolve(e)
            proj_map.append(("key",))
            out_fields.append(
                OutputField(item.output_name(), ra.atype, ra.table))
        else:
            raise SiddhiQLError(
                "#window.session select items must be the session key "
                "or aggregations (a closed session has no single "
                "current event to read other attributes from)")
    if not collector.aggs:
        raise SiddhiQLError(
            "#window.session without aggregation emits nothing; "
            "aggregate the session (e.g. count())")
    _check_aggs(collector, "session")
    art = SessionWindowArtifact(
        name=name,
        output_schema=OutputSchema(q.output_stream, tuple(out_fields)),
        stream_code=stream_codes[inp.stream_id],
        filter_fns=filter_fns,
        gap_ms=int(gap_ms),
        code_key=code_key,
        encoder=encoder,
        aggs=collector.aggs,
        arg_fns=collector.arg_fns,
        arg_types=collector.arg_types,
        proj_map=proj_map,
    )
    art.encoded_columns = encoded
    return art
