"""Event tables: bounded keyed stores shared across a plan's queries.

Reference surface (SURVEY.md §2.10 — siddhi-core event tables): ``define
table T (...)``, inserting stream output into a table, updating/deleting
table rows with an ``on`` condition, and joining a stream against a table.
The port's counterpart of ``flink_siddhi_tpu/compiler/table.py``: a table
is a fixed-capacity ring of column tensors in the plan state
(``states["@tables"][T]``), threaded through the query artifacts in
definition order, so later queries observe earlier queries' table writes
at micro-batch granularity (the reference's documented coarsening of
siddhi-core's per-event sequencing: the rows depend on the tape size).

- **insert** appends the masked events at a rolling write pointer
  (overwriting the oldest on overflow; deleted slots stay holes until the
  pointer reaches them): a stable rank and one scatter, a dump slot for
  the events that do not land.
- **update / delete** match every event against every table row through
  the ``on`` condition, compiled to a postfix program
  (``slot_program.py``: the event's stream columns and select outputs
  are its event loads, the table's columns its other loads) that K6
  (``cuda_ops.table_mutate``, ``csrc/table_mutate.cu``) runs per (event,
  row) candidate, returning each row's last matching tape position. The
  reference builds the dense (E, C) match matrix and an ``argmax`` over
  it (``table.py:362-408``). Delete clears the matched rows; update
  writes each select output that names a table column from the last
  matching event (tape order) — a gather at that position.
- **stream-table join** enumerates (event, row) pairs in (i, j) order,
  the stream-preserving outer rows after them, with K5 (``cuda_ops.
  join_pairs``, the windowed join's pair step) over one direction whose
  "window" is every valid table slot (``cuda_ops.table_join_dir``).

- **windowed / aggregated insert** (``WindowedTableInsertArtifact``): a
  window or aggregation artifact of ``window.py`` whose emitted rows
  append to the ring instead of an output stream; at the end of the
  stream its last rows (a batch window's carry) land through
  ``flush_tables``. A windowed or aggregated update / delete is rewritten
  by ``plan._rewrite_windowed_mutations`` into a windowed query into a
  synthesized stream and a plain mutation over it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.stream_schema import StreamSchema
from ..schema.types import AttributeType
from . import cuda_ops
from .expr import (ColumnEnv, ExprResolver, ResolvedAttr, _dt, as_column,
                   compile_expr)
from .output import OutputField, OutputSchema
from .slot_program import OnProgram, compile_on

_I32 = torch.int32
JOIN_OUT_FACTOR = 4  # a table join's rows are cut at 4 E, as the reference


def table_key(table_id: str, field: str) -> str:
    return f"@tbl:{table_id}.{field}"


def init_table_state(table_id: str, schema: StreamSchema, device,
                     capacity: int) -> Dict:
    st = {
        "valid": torch.zeros(capacity, dtype=torch.bool, device=device),
        "ptr": torch.tensor(0, dtype=_I32, device=device),
    }
    for fname, ftype in zip(schema.field_names, schema.field_types):
        st[table_key(table_id, fname)] = torch.zeros(
            capacity, dtype=_dt(ftype), device=device)
    return st


class _TableResolver:
    """Resolves ``T.field`` to table column keys, everything else through the
    base stream resolver. For update/delete ``on`` conditions, bare names
    resolve to the query's select-output columns first (Siddhi compares table
    attrs against output attrs)."""

    def __init__(self, base, table_id: str, schema: StreamSchema,
                 out_slots: Optional[Dict[str, AttributeType]] = None):
        self._base = base
        self._tid = table_id
        self._schema = schema
        self._out = out_slots or {}

    def resolve(self, attr: ast.Attr) -> ResolvedAttr:
        if attr.qualifier == self._tid:
            if attr.name not in self._schema:
                raise SiddhiQLError(
                    f"table {self._tid!r} has no attribute {attr.name!r}"
                )
            atype = self._schema.field_type(attr.name)
            table = self._schema.string_tables.get(attr.name)
            return ResolvedAttr(table_key(self._tid, attr.name), atype, table)
        if attr.qualifier is None and attr.index is None:
            if attr.name in self._out:
                return ResolvedAttr(
                    f"@out:{attr.name}", self._out[attr.name], None
                )
        return self._base.resolve(attr)


def _collect_bare_names(expr: ast.Expr, out: set) -> None:
    if isinstance(expr, ast.Attr):
        if expr.qualifier is None:
            out.add(expr.name)
    elif isinstance(expr, ast.Unary):
        _collect_bare_names(expr.operand, out)
    elif isinstance(expr, ast.Binary):
        _collect_bare_names(expr.left, out)
        _collect_bare_names(expr.right, out)
    elif isinstance(expr, ast.Call):
        for a in expr.args:
            _collect_bare_names(a, out)


def _stream_front(q, schemas, stream_codes, extensions):
    """Shared select/filter front-end over the (single) input stream."""
    inp = q.input
    if not isinstance(inp, ast.StreamInput):
        raise SiddhiQLError(
            "table insert/update/delete queries take a single stream input"
        )
    if inp.windows:
        raise SiddhiQLError("windows are not supported on table writes yet")
    ref = inp.ref_name
    scopes = {ref: (inp.stream_id, schemas[inp.stream_id])}
    if ref != inp.stream_id:
        scopes[inp.stream_id] = (inp.stream_id, schemas[inp.stream_id])
    resolver = ExprResolver(scopes, default_scope=ref)
    filter_fns = []
    for f in inp.filters:
        ce = compile_expr(f, resolver, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("stream filter must be boolean")
        filter_fns.append(ce.fn)
    items = q.selector.items
    if q.selector.is_star:
        schema = schemas[inp.stream_id]
        items = tuple(
            ast.SelectItem(ast.Attr(n), None) for n in schema.field_names
        )
    if q.selector.group_by or q.selector.having is not None or any(
        ast.contains_aggregate(i.expr) for i in items
    ):
        raise SiddhiQLError(
            "aggregations/group by are not supported in table writes"
        )
    proj = []
    for item in items:
        ce = compile_expr(item.expr, resolver, extensions)
        proj.append((item.output_name(), ce))
    return inp, resolver, filter_fns, proj


def _masked(tape, stream_code, filter_fns, enabled, env):
    mask = tape.valid & (tape.stream == stream_code)
    for f in filter_fns:
        mask = mask & f(env)
    return mask & enabled


def _ring_append(tbl: Dict, table_id: str, keep,
                 named_vals) -> Tuple[Dict, torch.Tensor]:
    """Append ``keep``-masked rows to the table ring. If one batch inserts
    more than C rows, only the newest C land (ring semantics; it also keeps
    the scatter's positions unique). The rows that do not land go to a dump
    slot past the ring, sliced off (the reference's ``mode="drop"``).
    Returns (tbl, the count appended, int32), with no host read."""
    tbl = dict(tbl)
    C = int(tbl["valid"].shape[0])
    rank = torch.cumsum(keep, 0, dtype=_I32) - 1
    M = keep.sum(dtype=_I32)
    keep2 = keep & (rank >= M - C)
    pos = torch.where(keep2, torch.remainder(tbl["ptr"] + rank, C),
                      C).long()

    def put(col, vals):
        out = torch.cat([col, col[:1]])
        out.index_put_((pos,), vals.to(col.dtype))
        return out[:C]

    for cname, vals in named_vals:
        key = table_key(table_id, cname)
        tbl[key] = put(tbl[key], vals)
    tbl["valid"] = put(tbl["valid"], torch.ones_like(keep))
    tbl["ptr"] = torch.remainder(tbl["ptr"] + M, C).to(_I32)
    return tbl, M


def _empty(schema: OutputSchema, device) -> Tuple:
    """A table write's emission: no rows."""
    return (
        torch.zeros((), dtype=_I32, device=device),
        torch.zeros(1, dtype=_I32, device=device),
        tuple(torch.zeros(1, dtype=_dt(f.atype), device=device)
              for f in schema.fields),
    )


def _words(envd: ColumnEnv, keys, like: torch.Tensor) -> torch.Tensor:
    """The columns ``keys`` of ``envd`` as int32 words ``[len(keys),
    width]``, ``like``'s width and device (float32 by bit pattern, the
    program's values)."""
    width = int(like.shape[0])
    if not keys:
        return torch.zeros((0, width), dtype=_I32, device=like.device)
    rows = []
    for k in keys:
        v = as_column(envd[k], width, like)
        rows.append(v.view(_I32) if v.dtype == torch.float32
                    else v.to(_I32))
    return torch.stack(rows)


class _PairEnv(dict):
    """A table join's pair rows as a column env, each column gathered when
    a projection first reads it: a stream column at the pairs' tape
    positions ``pi``, a table column at their slots ``pj`` (zeros on the
    outer rows, whose table side is missing)."""

    def __init__(self, env: ColumnEnv, pi, tbl: Dict, pj, paired):
        super().__init__()
        self._env, self._pi = env, pi
        self._tbl, self._pj, self._paired = tbl, pj, paired

    def __missing__(self, key: str) -> torch.Tensor:
        if key in self._tbl:
            at_j = self._tbl[key][self._pj]
            v = torch.where(self._paired, at_j, torch.zeros_like(at_j))
        else:
            v = self._env[key][self._pi]
        self[key] = v
        return v


def _on_words(on: OnProgram, derived: Dict[str, Tuple[str, Callable]],
              evt_env: ColumnEnv, tbl_env: ColumnEnv, ts: torch.Tensor,
              valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(event words ``[a_n, E]``, table words ``[b_n, C]``) of the ``on``
    program ``on``, with its ``derived`` columns (key -> (side, fn), side
    "evt" or "tbl") computed over the tape and over the table."""
    evt_env, tbl_env = dict(evt_env), dict(tbl_env)
    for key, (side, fn) in derived.items():
        if side == "evt":
            evt_env[key] = fn(evt_env)
        else:
            tbl_env[key] = fn(tbl_env)
    return (_words(evt_env, on.evt_keys, ts),
            _words(tbl_env, on.cap_keys, valid))


def _later_call(call: ast.Call) -> SiddhiQLError:
    return SiddhiQLError(
        f"the function {call.full_name!r} over both a stream and a table in "
        "a table 'on' condition is not in the torch port's table program "
        "(ROADMAP.md Queue 1 item 8): a registered function is a torch "
        "function over a batch and cannot run per (event, row) candidate "
        "inside the table kernels; the JAX package flink_siddhi_tpu runs it"
    )


def _key_side(key: str) -> str:
    return "tbl" if key.startswith("@tbl:") else "evt"


def _compile_on(on: ast.Expr, resolver, extensions):
    """The ``on`` condition (already validated by ``compile_expr``) as a
    program and its derived columns: table columns (``@tbl:`` keys) are
    its other loads, the rest (stream columns, select outputs) its event
    loads; a call over one side is a derived column of that side."""
    progs, derived = compile_on(
        on, resolver, extensions, ("evt",),
        lambda e: {_key_side(resolver.resolve(a).key)
                   for a in ast.iter_attrs(e)},
        _key_side,
        lambda side, n: f"@fn{n}" if side == "evt" else f"@tbl:@fn{n}",
        _later_call)
    return progs["evt"], derived


@dataclass
class TableInsertArtifact:
    """``from S select ... insert into T`` — appends projected rows."""

    name: str
    output_schema: OutputSchema  # degenerate: no stream output
    table_id: str
    col_names: List[str]
    stream_code: int
    filter_fns: List[Callable]
    proj_fns: List[Callable]
    uses_tables: bool = True
    output_mode: str = "buffered"

    def init_state(self, device) -> Dict:
        return {"enabled": torch.tensor(True, device=device),
                "overflow": torch.tensor(0, dtype=_I32, device=device)}

    def step_tables(self, state, tables, tape):
        env: ColumnEnv = dict(tape.cols)
        mask = _masked(
            tape, self.stream_code, self.filter_fns, state["enabled"], env
        )
        E = tape.capacity
        named = [(cname, as_column(p(env), E, tape.ts))
                 for cname, p in zip(self.col_names, self.proj_fns)]
        tbl, M = _ring_append(
            tables[self.table_id], self.table_id, mask, named
        )
        C = int(tbl["valid"].shape[0])
        new_state = dict(state)
        new_state["overflow"] = state["overflow"] + torch.clamp(
            M - C, min=0)
        new_tables = dict(tables)
        new_tables[self.table_id] = tbl
        return new_state, new_tables, _empty(self.output_schema,
                                             tape.ts.device)


@dataclass
class TableMutateArtifact:
    """``update T on <cond>`` / ``delete T on <cond>``: each row's last
    matching event (K6), against the table as it stands before this
    query's writes; the last matching event wins an update."""

    name: str
    output_schema: OutputSchema
    table_id: str
    action: str  # 'update' | 'delete'
    col_names: List[str]  # update targets (match table fields by name)
    stream_code: int
    filter_fns: List[Callable]
    proj_fns: List[Callable]
    on: OnProgram
    derived: Dict[str, Tuple[str, Callable]]  # the on's: key -> (side, fn)
    uses_tables: bool = True
    output_mode: str = "buffered"

    def init_state(self, device) -> Dict:
        return {"enabled": torch.tensor(True, device=device)}

    def step_tables(self, state, tables, tape):
        env: ColumnEnv = dict(tape.cols)
        mask = _masked(
            tape, self.stream_code, self.filter_fns, state["enabled"], env
        )
        E = tape.capacity
        tbl = dict(tables[self.table_id])
        out_vals = {}
        evt_env: ColumnEnv = dict(env)
        for cname, p in zip(self.col_names, self.proj_fns):
            v = as_column(p(env), E, tape.ts)
            out_vals[cname] = v
            evt_env[f"@out:{cname}"] = v
        a_cols, b_cols = _on_words(self.on, self.derived, evt_env, tbl,
                                   tape.ts, tbl["valid"])
        last = cuda_ops.table_mutate(mask, a_cols, tbl["valid"], b_cols,
                                     self.on.code, self.on.depth)
        hit = last >= 0
        if self.action == "delete":
            tbl["valid"] = tbl["valid"] & ~hit
        else:
            at = torch.clamp(last, min=0).long()
            for cname in self.col_names:
                key = table_key(self.table_id, cname)
                if key in tbl:
                    tbl[key] = torch.where(
                        hit, out_vals[cname][at].to(tbl[key].dtype),
                        tbl[key])
        new_tables = dict(tables)
        new_tables[self.table_id] = tbl
        return state, new_tables, _empty(self.output_schema,
                                         tape.ts.device)


@dataclass
class TableJoinArtifact:
    """``from S join T on <cond> select ... insert into Out``: stream
    events x the table's valid rows, pairs in (i, j) order and the
    stream-preserving outer rows (the table side zero-filled) after them,
    cut at ``4 E``."""

    name: str
    output_schema: OutputSchema
    table_id: str
    stream_code: int
    filter_fns: List[Callable]
    on: OnProgram  # an empty program when the join has no `on`
    derived: Dict[str, Tuple[str, Callable]]  # the on's: key -> (side, fn)
    proj_fns: List[Callable]
    outer: bool  # left outer (stream side preserved)
    uses_tables: bool = True
    output_mode: str = "buffered"

    def emit_block_width(self, tape_capacity: int, state: Dict) -> int:
        """Widest per-cycle emission block (drain-cadence contract)."""
        return JOIN_OUT_FACTOR * tape_capacity

    def init_state(self, device) -> Dict:
        return {"enabled": torch.tensor(True, device=device),
                "overflow": torch.tensor(0, dtype=_I32, device=device)}

    def step_tables(self, state, tables, tape):
        env: ColumnEnv = dict(tape.cols)
        mask = _masked(
            tape, self.stream_code, self.filter_fns, state["enabled"], env
        )
        tbl = tables[self.table_id]
        a_cols, b_cols = _on_words(self.on, self.derived, env, tbl, tape.ts,
                                   tbl["valid"])
        d = cuda_ops.table_join_dir(mask, a_cols, tbl["valid"], b_cols,
                                    self.on.code, self.on.depth, self.outer)
        cap = JOIN_OUT_FACTOR * tape.capacity
        pi, pj, pseg, n = cuda_ops.join_pairs([d], tape.ts, cap, False,
                                              None)
        pi, pj = pi.long(), pj.long()
        row_env = _PairEnv(env, pi, tbl, pj, pseg == 0)
        cols = tuple(as_column(p(row_env), cap, tape.ts)
                     for p in self.proj_fns)
        new_state = dict(state)
        new_state["overflow"] = state["overflow"] + torch.clamp(
            n[0] - cap, min=0)
        return new_state, tables, (torch.clamp(n[0], max=cap),
                                   tape.ts[pi], cols)


@dataclass
class WindowedTableInsertArtifact:
    """``from S#window... select <aggs> ... insert into T``: a window or
    aggregation artifact (sliding, cumulative or batch) whose emitted rows
    append to the table ring instead of an output stream. State: the inner
    artifact's under ``win`` and the rows that did not land under
    ``overflow``."""

    name: str
    output_schema: OutputSchema  # degenerate: no stream output
    table_id: str
    col_names: List[str]
    inner: object  # the compiled window / aggregation artifact
    uses_tables: bool = True
    output_mode: str = "buffered"

    @property
    def encoded_columns(self):
        # the inner artifact's group keys are still interned on the host
        return getattr(self.inner, "encoded_columns", ())

    @property
    def host_columns(self):
        # host-computed tape columns (#window.cron's window ids)
        return getattr(self.inner, "host_columns", ())

    def init_state(self, device) -> Dict:
        return {"win": self.inner.init_state(device),
                "overflow": torch.tensor(0, dtype=_I32, device=device)}

    def grow_state(self, state: Dict) -> Dict:
        grow = getattr(self.inner, "grow_state", None)
        if grow is None:
            return state
        return dict(state, win=grow(state["win"]))

    def _apply(self, state: Dict, wst: Dict, out, tables):
        """The inner artifact's emission ``out`` appended to the table:
        (new state, new tables)."""
        if self.inner.output_mode == "aligned":
            keep, ts, cols = out
        else:  # buffered: the first n rows
            n, ts, cols = out
            keep = torch.arange(int(ts.shape[0]), dtype=_I32,
                                device=ts.device) < n
        L = int(keep.shape[0])
        named = [(c, as_column(v, L, ts))
                 for c, v in zip(self.col_names, cols)]
        tbl, M = _ring_append(tables[self.table_id], self.table_id, keep,
                              named)
        C = int(tbl["valid"].shape[0])
        new_tables = dict(tables)
        new_tables[self.table_id] = tbl
        return ({"win": wst,
                 "overflow": state["overflow"] + torch.clamp(M - C, min=0)},
                new_tables)

    def step_tables(self, state, tables, tape):
        wst, out = self.inner.step(state["win"], tape)
        new_state, new_tables = self._apply(state, wst, out, tables)
        return new_state, new_tables, _empty(self.output_schema,
                                             tape.ts.device)

    def flush_tables(self, state, tables):
        """End of stream: the inner window's flush rows (a batch window's
        last windows) land in the table too. Returns (state, tables)."""
        flush = getattr(self.inner, "flush", None)
        if flush is None:
            return state, tables
        wst, out = flush(state["win"])
        return self._apply(state, wst, out, tables)


# --------------------------------------------------------------------------
# compile entry points (called from plan.py)
# --------------------------------------------------------------------------

def _windowed(q: ast.Query) -> bool:
    """A table write over a window or an aggregation: an insert runs it
    through ``WindowedTableInsertArtifact``, an update or delete through
    ``plan._rewrite_windowed_mutations`` (which also takes a ``having``;
    an insert with one is refused by ``_stream_front``, as the
    reference's)."""
    inp = q.input
    return isinstance(inp, ast.StreamInput) and bool(
        inp.windows
        or q.selector.group_by
        or any(ast.contains_aggregate(i.expr) for i in q.selector.items)
    )


def compile_table_write(
    q: ast.Query,
    name: str,
    schemas: Dict[str, StreamSchema],
    table_schemas: Dict[str, StreamSchema],
    stream_codes: Dict[str, int],
    extensions,
    config=None,
):
    tid = q.output_stream
    tschema = table_schemas[tid]
    if q.output_action == "insert" and _windowed(q):
        # windowed / aggregated insert: compile the full window artifact
        # and redirect its emissions into the table ring
        from .window import compile_window_query

        inner = compile_window_query(
            q, f"{name}@win", schemas, stream_codes, extensions, config
        )
        for f in inner.output_schema.fields:
            if f.name not in tschema:
                raise SiddhiQLError(
                    f"table {tid!r} has no column {f.name!r}"
                )
        return WindowedTableInsertArtifact(
            name=name,
            output_schema=OutputSchema(f"@void:{name}", ()),
            table_id=tid,
            col_names=[f.name for f in inner.output_schema.fields],
            inner=inner,
        )
    inp, resolver, filter_fns, proj = _stream_front(
        q, schemas, stream_codes, extensions
    )
    sc = stream_codes[inp.stream_id]
    empty_schema = OutputSchema(f"@void:{name}", ())

    if q.output_action == "insert":
        for cname, ce in proj:
            if cname not in tschema:
                raise SiddhiQLError(
                    f"table {tid!r} has no column {cname!r}"
                )
        return TableInsertArtifact(
            name=name,
            output_schema=empty_schema,
            table_id=tid,
            col_names=[c for c, _ in proj],
            stream_code=sc,
            filter_fns=filter_fns,
            proj_fns=[ce.fn for _, ce in proj],
        )

    if q.on_condition is None:
        raise SiddhiQLError(
            f"{q.output_action} {tid} requires an 'on' condition"
        )
    # every select output must either write a table column or feed the on
    # condition — anything else is almost certainly a typo (the insert path
    # validates strictly, so keep the paths symmetric)
    on_names = set()
    _collect_bare_names(q.on_condition, on_names)
    for cname, _ in proj:
        if cname not in tschema and cname not in on_names:
            raise SiddhiQLError(
                f"table {tid!r} has no column {cname!r} and the "
                f"{q.output_action} 'on' condition does not reference it"
            )
    out_slots = {c: ce.atype for c, ce in proj}
    tres = _TableResolver(resolver, tid, tschema, out_slots)
    on_ce = compile_expr(q.on_condition, tres, extensions)
    if on_ce.atype != AttributeType.BOOL:
        raise SiddhiQLError("'on' condition must be boolean")
    on, derived = _compile_on(q.on_condition, tres, extensions)
    return TableMutateArtifact(
        name=name,
        output_schema=empty_schema,
        table_id=tid,
        action=q.output_action,
        col_names=[c for c, _ in proj],
        stream_code=sc,
        filter_fns=filter_fns,
        proj_fns=[ce.fn for _, ce in proj],
        on=on,
        derived=derived,
    )


def compile_table_join(
    q: ast.Query,
    name: str,
    schemas: Dict[str, StreamSchema],
    table_schemas: Dict[str, StreamSchema],
    stream_codes: Dict[str, int],
    extensions,
    config=None,
):
    inp = q.input
    assert isinstance(inp, ast.JoinInput)
    if inp.left.stream_id in table_schemas:
        tside, sside = inp.left, inp.right
        stream_outer = inp.join_type == "right outer join"
        table_outer = inp.join_type in (
            "left outer join", "full outer join",
        )
    else:
        tside, sside = inp.right, inp.left
        stream_outer = inp.join_type == "left outer join"
        table_outer = inp.join_type in (
            "right outer join", "full outer join",
        )
    if table_outer:
        raise SiddhiQLError(
            "outer join preserving the table side is not supported: a "
            "table has no arrival events to emit unmatched rows on. "
            "Reference behavior, siddhi-core 4.2.40 (the version "
            "pinned by the reference repo's pom.xml): org.wso2.siddhi"
            ".core.util.parser.JoinInputStreamParser"
            ".populateJoinProcessors raises SiddhiAppCreationException "
            "when a TABLE side is the join trigger — only STREAM and "
            "WINDOW sides can trigger — and unmatched-side rows are "
            "emitted only by triggering events, so the table-preserving "
            "half of an outer join never fires there either"
        )
    if sside.stream_id in table_schemas:
        raise SiddhiQLError(
            "table-table joins are not supported: a join needs a "
            "stream side to trigger on. Reference behavior, "
            "siddhi-core 4.2.40 (the version pinned by the reference "
            "repo's pom.xml): org.wso2.siddhi.core.util.parser"
            ".JoinInputStreamParser.parseInputStream raises "
            "SiddhiAppCreationException when both join inputs are "
            "static (table) sources — neither side produces the "
            "triggering events a join runtime executes on"
        )
    if tside.windows:
        raise SiddhiQLError("windows are not valid on a table join side")
    tid = tside.stream_id
    tschema = table_schemas[tid]

    ref = sside.ref_name
    scopes = {ref: (sside.stream_id, schemas[sside.stream_id])}
    if ref != sside.stream_id:
        scopes[sside.stream_id] = (
            sside.stream_id, schemas[sside.stream_id],
        )
    base = ExprResolver(scopes, default_scope=ref)

    class _JoinResolver:
        """T.field / alias.field -> table cols; rest -> stream."""

        def resolve(self, attr: ast.Attr) -> ResolvedAttr:
            if attr.qualifier in (tid, tside.ref_name):
                if attr.name not in tschema:
                    raise SiddhiQLError(
                        f"table {tid!r} has no attribute {attr.name!r}"
                    )
                return ResolvedAttr(
                    table_key(tid, attr.name),
                    tschema.field_type(attr.name),
                    tschema.string_tables.get(attr.name),
                )
            try:
                return base.resolve(attr)
            except SiddhiQLError:
                if attr.qualifier is None and attr.name in tschema:
                    return ResolvedAttr(
                        table_key(tid, attr.name),
                        tschema.field_type(attr.name),
                        tschema.string_tables.get(attr.name),
                    )
                raise

    resolver = _JoinResolver()
    filter_fns = []
    for f in sside.filters:
        ce = compile_expr(f, base, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("stream filter must be boolean")
        filter_fns.append(ce.fn)

    on, derived = OnProgram((), 0, (), ()), {}
    if inp.on is not None:
        ce = compile_expr(inp.on, resolver, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("join 'on' condition must be boolean")
        on, derived = _compile_on(inp.on, resolver, extensions)

    items = q.selector.items
    if q.selector.is_star:
        items = tuple(
            ast.SelectItem(
                ast.Attr(f, qualifier=sside.ref_name), f"{sside.ref_name}_{f}"
            )
            for f in schemas[sside.stream_id].field_names
        ) + tuple(
            ast.SelectItem(
                ast.Attr(f, qualifier=tside.ref_name), f"{tside.ref_name}_{f}"
            )
            for f in tschema.field_names
        )
    proj_fns, out_fields = [], []
    for item in items:
        if ast.contains_aggregate(item.expr):
            raise SiddhiQLError(
                "aggregations over table joins are not supported yet"
            )
        ce = compile_expr(item.expr, resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(OutputField(item.output_name(), ce.atype, ce.table))

    return TableJoinArtifact(
        name=name,
        output_schema=OutputSchema(q.output_stream, tuple(out_fields)),
        table_id=tid,
        stream_code=stream_codes[sside.stream_id],
        filter_fns=filter_fns,
        on=on,
        derived=derived,
        proj_fns=proj_fns,
        outer=stream_outer,
    )
