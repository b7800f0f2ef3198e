"""Stateless select/filter/projection queries.

``from S[pred] select a, b as c insert into Out`` compiles to a branch-free
masked pass over the tape: one predicate evaluation + projections for the
whole micro-batch (the per-event path of the reference is
SiddhiStreamOperator.processEvent -> siddhi-core filter processors,
SiddhiStreamOperator.java:51-54).

Two wire options apply to a plan whose only query is a select
(``select_wire_opts``): predicate pushdown ships host-evaluable filter
conjuncts as one packed mask bit per event, and lazy projection keeps
projection-only columns on the host, emitting event ordinals that the
executor's lazy ring resolves at decode time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.types import AttributeType
from .expr import (
    ColumnEnv,
    ExprResolver,
    as_column,
    compile_expr,
    compile_host_pred,
)
from .output import OutputField, OutputSchema, emission_order


@dataclass
class SelectArtifact:
    """Compiled stateless query. State = {'enabled': bool scalar} so a
    query can be paused/resumed (OperationControlEvent parity), plus the
    ordinal base ``seen`` when lazy projection applies."""

    name: str
    output_schema: OutputSchema
    output_mode: str  # 'aligned'
    stream_code: int
    filter_fns: List
    proj_fns: List
    # per select item: tape key when the item is a plain attribute
    # reference, else None; and the set of tape keys the item reads
    proj_srcs: Tuple[Optional[str], ...] = ()
    proj_refs: Tuple[FrozenSet[str], ...] = ()
    pred_keys: FrozenSet[str] = frozenset()
    # per filter conjunct: the numpy-compiled twin (None when the
    # conjunct isn't host-evaluable) and the tape keys it reads
    host_filter_fns: Tuple = ()
    filter_refs: Tuple[FrozenSet[str], ...] = ()
    # late materialization (set by apply_lazy_select): tape keys whose
    # values stay host-side; their rows emit ordinals
    lazy_pairs: Tuple[str, ...] = ()
    # wire predicate pushdown (set by select_wire_opts): conjuncts now
    # evaluated host-side and shipped as one packed mask bit
    pushed_preds: Tuple[int, ...] = ()

    def cost_info(self) -> Dict:
        """Admission-cost descriptor (analysis/admit.py): stateless
        pass-through — at most one row out per input event, nothing
        retained."""
        return {
            "name": self.name,
            "kind": "select",
            "amplification": 1,
            "residency_ms": 0,
        }

    @property
    def lazy_src_keys(self) -> Tuple[str, ...]:
        return self.lazy_pairs

    def init_state(self, device) -> Dict:
        state = {"enabled": torch.tensor(True, device=device)}
        if self.lazy_pairs:
            # ordinal base: counts every valid event ever seen, the same
            # space the host's lazy ring is pushed in
            state["seen"] = torch.tensor(0, dtype=torch.int32, device=device)
        return state

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = tape.valid & (tape.stream == self.stream_code)
        for f in self.filter_fns:
            mask = mask & f(env)
        mask = mask & state["enabled"]
        cap = tape.capacity
        if not self.lazy_pairs:
            cols = tuple(
                as_column(p(env), cap, tape.ts) for p in self.proj_fns
            )
            return state, (mask, tape.ts, cols)
        lazy = set(self.lazy_pairs)
        ordinal = state["seen"] + torch.arange(
            cap, dtype=torch.int32, device=tape.ts.device
        )
        cols = tuple(
            ordinal
            if src is not None and src in lazy
            else as_column(p(env), cap, tape.ts)
            for src, p in zip(self.proj_srcs, self.proj_fns)
        )
        new_state = dict(state)
        new_state["seen"] = state["seen"] + tape.valid.sum(
            dtype=torch.int32
        )
        return new_state, (mask, tape.ts, cols)

    @property
    def wants_lookup(self) -> bool:
        return bool(self.lazy_pairs)

    def decode_packed(self, n: int, block: np.ndarray, lookup=None):
        """Lazy-mode decode: ordinal rows resolve against the host ring;
        evicted ordinals decode as None (bounded-memory policy)."""
        schema = self.output_schema
        if not self.lazy_pairs:
            return [(schema, schema.decode_packed_block(n, block))]
        lazy = set(self.lazy_pairs)
        order = emission_order(block[0], n)
        ts_list = (
            np.asarray(block[0, :n])[order].astype(np.int64).tolist()
        )
        col_lists = []
        for c, f in enumerate(schema.fields):
            raw = np.asarray(block[1 + c, :n])[order]
            src = self.proj_srcs[c]
            if src is not None and src in lazy:
                col_lists.append(_lazy_values(raw, f, lookup, src))
            else:
                if np.dtype(f.atype.device_dtype) == np.dtype(np.float32):
                    raw = raw.view(np.float32)
                col_lists.append(f.decode_column(raw))
        rows = (
            list(zip(ts_list, map(tuple, zip(*col_lists))))
            if col_lists
            else [(t, ()) for t in ts_list]
        )
        return [(schema, rows)]

    def decode_packed_columns(
        self, n: int, block: np.ndarray, lookup_np=None
    ):
        """Columnar twin of :meth:`decode_packed`: lazy ordinal rows
        resolve through the ring's vectorized ``lookup_np`` and every
        column stays a numpy array."""
        from .output import ColumnBatch

        schema = self.output_schema
        if not self.lazy_pairs:
            return [(schema, schema.decode_packed_columns(n, block))]
        lazy = set(self.lazy_pairs)
        order = emission_order(block[0], n)
        ts_out = np.asarray(block[0, :n])[order].astype(np.int64)
        cols = {}
        for c, f in enumerate(schema.fields):
            raw = np.asarray(block[1 + c, :n])[order]
            src = self.proj_srcs[c]
            if src is not None and src in lazy:
                cols[f.name] = _lazy_column_np(raw, f, lookup_np, src)
            else:
                if np.dtype(f.atype.device_dtype) == np.dtype(np.float32):
                    raw = raw.view(np.float32)
                cols[f.name] = f.decode_column_np(raw)
        return [(schema, ColumnBatch(ts_out, cols))]


def _lazy_values(ords, field, lookup, key) -> List:
    """Resolve one lazy-projected ordinal column to Python values through
    the ring's ``lookup``; evicted ordinals (and no ring) give None, and
    encoded fields map code -> value through their table."""
    vals = lookup(key, ords) if lookup is not None else [None] * len(ords)
    if field.table is not None:
        return [None if v is None else field.table.value(int(v))
                for v in vals]
    return [None if v is None else (v.item() if hasattr(v, "item") else v)
            for v in vals]


def _lazy_column_np(ords, field, lookup_np, key) -> np.ndarray:
    """Resolve one lazy-projected ordinal column to values (vectorized
    ring gather); evicted ordinals stay None, and encoded fields map
    code->value through the table in one np.take."""
    if lookup_np is None:
        return np.full(len(ords), None, dtype=object)
    vals = lookup_np(key, ords)
    if field.table is None:
        return vals
    if vals.dtype == object:  # misses present: keep None-capable dtype
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals.tolist()):
            out[i] = None if v is None else field.table.value(int(v))
        return out
    return field.decode_column_np(vals)


def apply_lazy_select(artifact: SelectArtifact):
    """Late materialization for a stateless query: plain-reference select
    items whose column feeds no predicate (and no computed expression)
    switch to ordinal emission, and their columns drop off the device
    tape. Returns the tape columns the device still needs, or None when
    nothing is lazy-eligible."""
    keep = set(artifact.pred_keys)
    for src, refs in zip(artifact.proj_srcs, artifact.proj_refs):
        if src is None:
            keep |= set(refs)
    lazy = {
        src for src in artifact.proj_srcs if src is not None
    } - keep
    if not lazy:
        return None
    artifact.lazy_pairs = tuple(sorted(lazy))
    return keep


def select_wire_opts(artifact: SelectArtifact, config):
    """Wire optimizations for a stateless query, in order: predicate
    pushdown (host-evaluable conjuncts collapse to ONE packed mask bit
    per event) then late materialization (with pushed predicate columns
    now lazy-eligible). Returns (needed_device_columns, host_preds) or
    None when nothing applies."""
    from ..runtime.tape import HostPred

    host_preds: Tuple[HostPred, ...] = ()
    if config.pred_pushdown and artifact.filter_fns:
        pushable = [
            i
            for i, h in enumerate(artifact.host_filter_fns)
            if h is not None
        ]
        if pushable:
            # push only if it actually FREES wire columns: a pushed
            # conjunct whose columns still ship (computed projections,
            # unpushed conjuncts, or non-lazy plain projections) adds a
            # mask bit and host work for zero savings
            kept_cols = set()
            for i, refs in enumerate(artifact.filter_refs):
                if i not in pushable:
                    kept_cols |= set(refs)
            for src, refs in zip(
                artifact.proj_srcs, artifact.proj_refs
            ):
                if src is None:
                    kept_cols |= set(refs)
                elif not config.lazy_projection:
                    kept_cols.add(src)
            pushed_refs = {
                k
                for i in pushable
                for k in artifact.host_filter_fns[i].refs
            }
            if not (pushed_refs - kept_cols):
                pushable = []
        if pushable:
            fns = tuple(
                artifact.host_filter_fns[i].fn for i in pushable
            )
            refs = tuple(sorted(pushed_refs))
            key = "@p:0"

            def mask_fn(env, _fns=fns):
                m = _fns[0](env)
                for f in _fns[1:]:
                    m = np.logical_and(m, f(env))
                return m

            host_preds = (HostPred(key, mask_fn, refs),)
            kept = set(range(len(artifact.filter_fns))) - set(pushable)
            artifact.filter_fns = [
                f
                for i, f in enumerate(artifact.filter_fns)
                if i in kept
            ] + [lambda env, k=key: env[k]]
            artifact.pred_keys = frozenset(
                k
                for i in kept
                for k in artifact.filter_refs[i]
            )
            artifact.pushed_preds = tuple(pushable)

    lazy_needed = None
    if config.lazy_projection:
        lazy_needed = apply_lazy_select(artifact)

    if not host_preds and lazy_needed is None:
        return None
    if lazy_needed is not None:
        needed = set(lazy_needed)
    else:
        needed = set(artifact.pred_keys)
        for refs in artifact.proj_refs:
            needed |= set(refs)
    return needed, host_preds


def compile_select(
    query: ast.Query,
    name: str,
    resolver: ExprResolver,
    schemas,  # stream_id -> StreamSchema (for select *)
    stream_code: int,
    extensions,
) -> SelectArtifact:
    inp = query.input
    if not isinstance(inp, ast.StreamInput):
        raise SiddhiQLError("not a stream query")
    filter_fns = []
    pred_keys = set()
    host_filter_fns = []
    filter_refs = []
    for f in inp.filters:
        ce = compile_expr(f, resolver, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("stream filter must be boolean")
        filter_fns.append(ce.fn)
        refs = frozenset(
            resolver.resolve(a).key for a in ast.iter_attrs(f)
        )
        filter_refs.append(refs)
        pred_keys |= refs
        host_filter_fns.append(compile_host_pred(f, resolver))

    items = query.selector.items
    if query.selector.is_star:
        schema = schemas[inp.stream_id]
        items = tuple(
            ast.SelectItem(ast.Attr(n), None) for n in schema.field_names
        )

    proj_fns = []
    out_fields = []
    proj_srcs = []
    proj_refs = []
    for item in items:
        ce = compile_expr(item.expr, resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(
            OutputField(item.output_name(), ce.atype, ce.table)
        )
        proj_srcs.append(
            resolver.resolve(item.expr).key
            if isinstance(item.expr, ast.Attr) and item.expr.index is None
            else None
        )
        proj_refs.append(
            frozenset(
                resolver.resolve(a).key for a in ast.iter_attrs(item.expr)
            )
        )
    return SelectArtifact(
        name=name,
        output_schema=OutputSchema(query.output_stream, tuple(out_fields)),
        output_mode="aligned",
        stream_code=stream_code,
        filter_fns=filter_fns,
        proj_fns=proj_fns,
        proj_srcs=tuple(proj_srcs),
        proj_refs=tuple(proj_refs),
        pred_keys=frozenset(pred_keys),
        host_filter_fns=tuple(host_filter_fns),
        filter_refs=tuple(filter_refs),
    )
