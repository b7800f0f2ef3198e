"""Windows + aggregations: the aggregate collector and the window dispatch.

The torch port of ``flink_siddhi_tpu/compiler/window.py``, as far as this
slice goes. Siddhi windows emit one aggregated row per *arriving* event over
the events the window currently holds; the reference re-expresses each
window shape as a data-parallel device plan over a micro-batch. Here:

* the aggregate layer every window shares: ``_AggCollector`` dedups the
  select clause's aggregate calls and their argument expressions and
  rewrites the select items to read ``@aggN`` slots, which
  ``_SlotResolver`` layers over the stream's columns;
* ``_group_encoding``: dense host-interned key codes (schema/encoders.py)
  for state tables keyed by an attribute, carried on the tape as an
  ``EncodedColumn``;
* ``compile_window_query``: a window with a plain projection compiles to
  the stateless select (Siddhi emits arriving events unchanged for
  ``insert into``), and the per-event scan windows go to
  ``scan_windows.py`` (``#window.unique`` in this slice).

Every other shape — length, time, batch and cron windows, cumulative
aggregation, group-by, expired-event output — raises ``SiddhiQLError``
naming its later slice (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..query import ast
from ..query.lexer import SiddhiQLError
from ..runtime.tape import EncodedColumn
from ..schema.encoders import GroupEncoder
from ..schema.types import AttributeType
from .expr import ExprResolver, ResolvedAttr, compile_expr
from .plan import _later

# --------------------------------------------------------------------------
# Aggregate extraction / expression rewriting
# --------------------------------------------------------------------------

_SUMLIKE_TYPES = {
    AttributeType.INT: AttributeType.LONG,
    AttributeType.LONG: AttributeType.LONG,
    AttributeType.FLOAT: AttributeType.DOUBLE,
    AttributeType.DOUBLE: AttributeType.DOUBLE,
}


@dataclass
class _Agg:
    kind: str  # sum count avg min max stddev distinctcount
    arg_idx: int  # index into distinct arg expressions; -1 = none (count())
    out_type: AttributeType
    slot: str  # env key "@aggN"


class _AggCollector:
    """Dedups aggregate calls and their argument expressions."""

    def __init__(self, resolver: ExprResolver, extensions) -> None:
        self.resolver = resolver
        self.extensions = extensions
        self.aggs: List[_Agg] = []
        self.arg_fns: List[Callable] = []
        self.arg_types: List[AttributeType] = []
        self._agg_keys: Dict[str, int] = {}
        self._arg_keys: Dict[str, int] = {}

    def _arg_index(self, expr: ast.Expr) -> Tuple[int, AttributeType]:
        key = repr(expr)
        if key in self._arg_keys:
            i = self._arg_keys[key]
            return i, self.arg_types[i]
        ce = compile_expr(expr, self.resolver, self.extensions)
        if not ce.atype.is_numeric and ce.atype != AttributeType.STRING:
            raise SiddhiQLError(
                f"cannot aggregate over type {ce.atype.value}"
            )
        i = len(self.arg_fns)
        self._arg_keys[key] = i
        self.arg_fns.append(ce.fn)
        self.arg_types.append(ce.atype)
        return i, ce.atype

    def intern(self, call: ast.Call) -> _Agg:
        key = repr(call)
        if key in self._agg_keys:
            return self.aggs[self._agg_keys[key]]
        kind = call.name.lower()
        if kind == "count":
            if len(call.args) > 1:
                raise SiddhiQLError("count() takes at most one argument")
            arg_idx, out_type = -1, AttributeType.LONG
        else:
            if len(call.args) != 1:
                raise SiddhiQLError(f"{kind}() takes exactly one argument")
            arg_idx, arg_type = self._arg_index(call.args[0])
            if kind == "sum":
                if arg_type not in _SUMLIKE_TYPES:
                    raise SiddhiQLError("sum() needs a numeric argument")
                out_type = _SUMLIKE_TYPES[arg_type]
            elif kind in ("avg", "stddev"):
                if not arg_type.is_numeric:
                    raise SiddhiQLError(f"{kind}() needs a numeric argument")
                out_type = AttributeType.DOUBLE
            elif kind in ("min", "max"):
                if not arg_type.is_numeric:
                    raise SiddhiQLError(f"{kind}() needs a numeric argument")
                out_type = arg_type
            elif kind == "distinctcount":
                out_type = AttributeType.LONG
            else:
                raise SiddhiQLError(f"unknown aggregation {call.name!r}")
        agg = _Agg(kind, arg_idx, out_type, f"@agg{len(self.aggs)}")
        self._agg_keys[key] = len(self.aggs)
        self.aggs.append(agg)
        return agg

    def rewrite(self, expr: ast.Expr) -> ast.Expr:
        """Replace aggregate calls with slot references."""
        if ast.is_aggregate_call(expr):
            return ast.Attr(self.intern(expr).slot)
        if isinstance(expr, ast.Unary):
            return ast.Unary(expr.op, self.rewrite(expr.operand))
        if isinstance(expr, ast.Binary):
            return ast.Binary(
                expr.op, self.rewrite(expr.left), self.rewrite(expr.right)
            )
        if isinstance(expr, ast.Call):
            return ast.Call(
                expr.name,
                tuple(self.rewrite(a) for a in expr.args),
                expr.namespace,
            )
        return expr


class _SlotResolver:
    """Resolver layering synthetic env slots (@aggN, select aliases) over the
    stream resolver."""

    def __init__(self, base, slots: Dict[str, AttributeType]) -> None:
        self._base = base
        self._slots = dict(slots)

    def resolve(self, attr: ast.Attr) -> ResolvedAttr:
        if attr.qualifier is None and attr.index is None:
            if attr.name in self._slots:
                return ResolvedAttr(attr.name, self._slots[attr.name], None)
        return self._base.resolve(attr)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def _window_of(inp: ast.StreamInput):
    """Classify the (at most one) window handler on a stream input."""
    if not inp.windows:
        return None
    if len(inp.windows) > 1:
        raise SiddhiQLError("at most one #window handler per stream input")
    w = inp.windows[0]
    name = w.name.split(".")[-1]
    lname = name.lower()
    if lname in ("length", "lengthbatch"):
        if len(w.args) != 1 or not isinstance(w.args[0], ast.Literal):
            raise SiddhiQLError(f"#window.{name} needs one integer argument")
        return ("length" if lname == "length" else "lengthBatch",
                int(w.args[0].value))
    if lname in ("time", "timebatch"):
        if len(w.args) != 1:
            raise SiddhiQLError(f"#window.{name} needs one time argument")
        return ("time" if lname == "time" else "timeBatch",
                _time_arg(w.args[0]))
    if lname == "externaltime":
        if len(w.args) != 2 or not isinstance(w.args[0], ast.Attr):
            raise SiddhiQLError(
                "#window.externalTime needs (tsAttribute, duration)"
            )
        return ("externalTime", (w.args[0], _time_arg(w.args[1])))
    if lname == "externaltimebatch":
        if len(w.args) != 2 or not isinstance(w.args[0], ast.Attr):
            raise SiddhiQLError(
                "#window.externalTimeBatch needs (tsAttribute, duration)"
            )
        return ("externalTimeBatch", (w.args[0], _time_arg(w.args[1])))
    if lname == "session":
        if not w.args or len(w.args) > 2:
            raise SiddhiQLError(
                "#window.session needs (gap[, keyAttribute])"
            )
        key = None
        if len(w.args) == 2:
            if not isinstance(w.args[1], ast.Attr):
                raise SiddhiQLError(
                    "#window.session key must be an attribute"
                )
            key = w.args[1]
        return ("session", (_time_arg(w.args[0]), key))
    if lname == "delay":
        if len(w.args) != 1:
            raise SiddhiQLError("#window.delay needs one time argument")
        return ("delay", _time_arg(w.args[0]))
    if lname == "timelength":
        if len(w.args) != 2 or not isinstance(w.args[1], ast.Literal):
            raise SiddhiQLError(
                "#window.timeLength needs (duration, count)"
            )
        return ("timeLength", (_time_arg(w.args[0]), int(w.args[1].value)))
    if lname in ("sort", "unique"):
        return (lname, tuple(w.args))
    if lname == "frequent":
        if not w.args or not isinstance(w.args[0], ast.Literal):
            raise SiddhiQLError(
                "#window.frequent needs (count[, attributes...])"
            )
        return ("frequent", tuple(w.args))
    if lname == "lossyfrequent":
        if not w.args or not isinstance(w.args[0], ast.Literal):
            raise SiddhiQLError(
                "#window.lossyFrequent needs "
                "(supportThreshold[, errorBound][, attributes...])"
            )
        return ("lossyFrequent", tuple(w.args))
    if lname == "cron":
        if len(w.args) != 1 or not isinstance(w.args[0], ast.Literal):
            raise SiddhiQLError(
                "#window.cron needs one cron-expression string"
            )
        return ("cron", str(w.args[0].value))
    raise SiddhiQLError(f"unsupported window #window.{w.name}")


def _time_arg(a: ast.Expr) -> int:
    if isinstance(a, ast.TimeLiteral):
        return a.ms
    if isinstance(a, ast.Literal) and isinstance(a.value, int):
        return a.value
    raise SiddhiQLError("expected a time duration argument")


def compile_window_query(
    q: ast.Query,
    name: str,
    schemas,
    stream_codes: Dict[str, int],
    extensions,
):
    """A stream query with a window, aggregates or group-by."""
    inp = q.input
    assert isinstance(inp, ast.StreamInput)
    ref = inp.ref_name
    scopes = {ref: (inp.stream_id, schemas[inp.stream_id])}
    if ref != inp.stream_id:
        scopes[inp.stream_id] = (inp.stream_id, schemas[inp.stream_id])
    resolver = ExprResolver(scopes, default_scope=ref)

    window = _window_of(inp)
    if window is not None and window[0] == "delay":
        # the reference emits delayed events (its expired-window path)
        raise _later("#window.delay", 6)

    filter_fns = []
    for f in inp.filters:
        ce = compile_expr(f, resolver, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("stream filter must be boolean")
        filter_fns.append(ce.fn)

    items = q.selector.items
    schema = schemas[inp.stream_id]
    if q.selector.is_star:
        items = tuple(
            ast.SelectItem(ast.Attr(n), None) for n in schema.field_names
        )

    group_names = q.selector.group_by
    collector = _AggCollector(resolver, extensions)
    rewritten = [
        ast.SelectItem(collector.rewrite(i.expr), i.alias) for i in items
    ]
    having_re = (
        collector.rewrite(q.selector.having)
        if q.selector.having is not None
        else None
    )

    if not collector.aggs and not group_names:
        # window with plain projection: current-event output == stateless
        # select (Siddhi emits arriving events unchanged for `insert into`)
        from .select import compile_select

        return compile_select(
            q, name, resolver, schemas, stream_codes[inp.stream_id],
            extensions,
        )

    if window is not None and window[0] in (
        "sort", "unique", "session", "frequent", "lossyFrequent",
    ):
        from .scan_windows import compile_scan_window

        return compile_scan_window(
            q, name, window, resolver, stream_codes, extensions,
            filter_fns, rewritten, collector, having_re,
        )
    raise _later("windows and aggregation", 6)


def _group_encoding(
    name: str,
    group_resolved: List[ResolvedAttr],
    stream_code: int,
    filter_fns: Sequence[Callable] = (),
):
    """Dense group codes for state-table artifacts. Interning keeps tables
    dense for arbitrary key distributions and multi-column keys, and
    respects the query's filters so rejected events never grow the table.
    The filters are the query's own torch closures, run here on CPU
    tensors over the host's numpy columns: interning happens while the
    tape is built, before anything reaches the device."""
    if not group_resolved:
        return None, None, ()
    encoder = GroupEncoder()
    out_key = f"@group:{name}"
    select_fn = None
    if filter_fns:
        fns = list(filter_fns)

        def select_fn(cols, _fns=fns):
            env = {k: torch.from_numpy(v) for k, v in cols.items()}
            m = torch.ones(len(next(iter(cols.values()))), dtype=torch.bool)
            for f in _fns:
                m = m & f(env)
            return m.numpy()

    enc = EncodedColumn(
        out_key=out_key,
        in_keys=tuple(r.key for r in group_resolved),
        stream_code=stream_code,
        encoder=encoder,
        select_fn=select_fn,
    )
    return out_key, encoder, (enc,)
