"""Cross-tenant common-subplan extraction (docs/control_plane.md).

PR 12's stack-join merges constants-only variants of ONE structure;
real fleets also contain structurally-distinct tenant queries that
nevertheless share an identical *prefix* — the same source-stream
filter feeding different windows/patterns. This module is the analysis
half of subplan sharing: given a single-query plan AST it decides
whether a shareable prefix exists, derives the process-stable key two
tenants must agree on to execute that prefix ONCE, and renders the
split back to CQL so the executor can compile the prefix as a producer
host (``@shr:<key>``) and the tenant's residue as a consumer suffix
reading the loopback mid-stream (``_shr_<key>``).

The split is *semantics-preserving by construction* for event-time
plans: the prefix is a stateless filter with ``select *`` over the
source stream, so the suffix observes exactly the rows (and exactly the
timestamps) the unsplit query's own leading filter would have admitted
— windows, patterns and aggregations downstream see an identical
event-time history. Two key spaces, deliberately distinct:

* **execution share key** (:func:`share_key`) — constants INCLUDED.
  Two tenants may ride one compiled+running prefix only when their
  predicates are semantically identical, constants and all.
* **segment signature** (``analysis.admit.segment_signatures``) —
  constants MASKED, the per-segment extension of ``plan_signature``:
  the shape-class bucket used for reporting and for the AOT-cache tier
  under the shared host (a ``@shr`` host is an ordinary cacheable plan,
  so its executables share by the normal cache-key contract).

Safety net: both rendered CQL halves are re-parsed and re-verified by
the ordinary plan compiler at admit time — a predicate this module
cannot faithfully render fails compilation and the admit falls back to
the unshared ladder rung, never to a wrong program.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..query import ast as qast
from ..schema.types import AttributeType

# loopback mid-stream / shared-host id prefixes (executor contract)
MID_STREAM_PREFIX = "_shr_"
SHARE_HOST_PREFIX = "@shr:"


# --------------------------------------------------------------------------
# CQL rendering (the supported split subset; round-tripped through the
# parser at admit time, so fidelity bugs fail closed)
# --------------------------------------------------------------------------


class RenderError(ValueError):
    """The AST node has no faithful CQL rendering in the split subset."""


def render_expr(e: qast.Expr) -> str:
    """Fully-parenthesized CQL for an expression tree."""
    if isinstance(e, qast.Literal):
        v = e.value
        if e.atype is AttributeType.STRING:
            esc = str(v).replace("\\", "\\\\").replace("'", "\\'")
            return f"'{esc}'"
        if e.atype is AttributeType.BOOL:
            return "true" if v else "false"
        if e.atype is AttributeType.LONG:
            return f"{int(v)}L"
        if e.atype is AttributeType.INT:
            return str(int(v))
        if e.atype is AttributeType.FLOAT:
            return f"{float(v)!r}f"
        # DOUBLE: keep a decimal point so the lexer sees FLOAT
        t = repr(float(v))
        return t if ("." in t or "e" in t or "E" in t) else t + ".0"
    if isinstance(e, qast.TimeLiteral):
        return f"{int(e.ms)} millisec"
    if isinstance(e, qast.Attr):
        if e.index is not None:
            raise RenderError(f"indexed attr {e!r} not renderable")
        return f"{e.qualifier}.{e.name}" if e.qualifier else e.name
    if isinstance(e, qast.Unary):
        inner = render_expr(e.operand)
        return f"(not {inner})" if e.op == "not" else f"(- {inner})"
    if isinstance(e, qast.Binary):
        return f"({render_expr(e.left)} {e.op} {render_expr(e.right)})"
    if isinstance(e, qast.Call):
        args = ", ".join(render_expr(a) for a in e.args)
        return f"{e.full_name}({args})"
    raise RenderError(f"unrenderable expression node {type(e).__name__}")


def _render_window(w: qast.Window) -> str:
    args = ", ".join(render_expr(a) for a in w.args)
    if ":" in w.name:  # stream function (#str:..., #log)
        return f"#{w.name}({args})"
    return f"#window.{w.name}({args})"


def _render_stream_input(si: qast.StreamInput) -> str:
    parts = [si.stream_id]
    parts += [f"[{render_expr(f)}]" for f in si.filters]
    parts += [_render_window(w) for w in si.windows]
    if si.alias:
        parts.append(f" as {si.alias}")
    return "".join(parts)


def _render_quantifier(el: qast.PatternElement) -> str:
    mn, mx = el.min_count, el.max_count
    if (mn, mx) == (1, 1):
        return ""
    if (mn, mx) == (1, -1):
        return "+"
    if (mn, mx) == (0, -1):
        return "*"
    if (mn, mx) == (0, 1):
        return "?"
    return f"<{mn}:{mx}>" if mx != -1 else f"<{mn}:>"


def _render_element(el: qast.PatternElement) -> str:
    if el.entry_filter is not None:
        # synthesized by the sequence-absence rewrite, never by the
        # parser — a source AST carrying one is outside the subset
        raise RenderError("entry_filter elements are not renderable")
    out = ""
    if el.negated:
        out += "not "
    if not (el.negated and el.alias.startswith("_not_")):
        out += f"{el.alias} = "
    out += el.stream_id
    if el.filter is not None:
        out += f"[{render_expr(el.filter)}]"
    out += _render_quantifier(el)
    if el.absent_for is not None:
        out += f" for {int(el.absent_for)} millisec"
    return out


def _render_pattern(p: qast.PatternInput) -> str:
    connector = " -> " if p.kind == "pattern" else ", "
    steps: List[str] = []
    for el in p.elements:
        txt = _render_element(el)
        if el.group_link is not None:
            if not steps:
                raise RenderError("group_link on the first element")
            steps[-1] = f"{steps[-1]} {el.group_link} {txt}"
        elif el.every_marked:
            steps.append(f"every {txt}")
        else:
            steps.append(txt)
    chain = connector.join(steps)
    if p.every_:
        chain = f"every ({chain})" if p.every_grouped else f"every {chain}"
    if p.within is not None:
        chain += f" within {int(p.within)} millisec"
    return chain


def _render_selector(sel: qast.Selector) -> str:
    if sel.is_star:
        out = "select *"
    else:
        items = []
        for it in sel.items:
            txt = render_expr(it.expr)
            if it.alias:
                txt += f" as {it.alias}"
            items.append(txt)
        out = "select " + ", ".join(items)
    if sel.group_by:
        out += " group by " + ", ".join(sel.group_by)
    if sel.having is not None:
        out += " having " + render_expr(sel.having)
    return out


def render_query(q: qast.Query) -> str:
    """CQL for one query in the split subset (insert-into only)."""
    if q.output_action != "insert":
        raise RenderError("only insert queries are renderable")
    if q.on_condition is not None or q.partition_with or q.group_sources:
        raise RenderError("query uses features outside the split subset")
    if q.output_rate is not None:
        raise RenderError("output-rate queries are outside the subset")
    inp = q.input
    if isinstance(inp, qast.StreamInput):
        body = _render_stream_input(inp)
    elif isinstance(inp, qast.PatternInput):
        body = _render_pattern(inp)
    else:
        raise RenderError("joins are outside the split subset")
    events = "" if q.output_events == "current" else f"{q.output_events} "
    head = f"@info(name='{q.name}') " if q.name else ""
    return (
        f"{head}from {body} {_render_selector(q.selector)} "
        f"insert {events}into {q.output_stream}"
    )


def render_stream_def(stream_id: str, schema) -> str:
    """``define stream`` DDL for a StreamSchema — the suffix CQL's
    declaration of the loopback mid-stream."""
    fields = ", ".join(
        f"{name} {atype.value}"
        for name, atype in zip(schema.field_names, schema.field_types)
    )
    return f"define stream {stream_id} ({fields})"


# --------------------------------------------------------------------------
# prefix split
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PrefixSplit:
    """A shareable split of one query: the source stream and the exact
    predicate the prefix producer evaluates (qualifiers stripped — it
    runs as ``from <stream>[pred] select *``)."""

    stream_id: str
    predicate: qast.Expr

    def key(self) -> str:
        return share_key(self.stream_id, self.predicate)


def share_key(stream_id: str, predicate: qast.Expr) -> str:
    """The EXECUTION share key: process-stable, constants INCLUDED.
    Two tenant queries may attach to one running prefix host only when
    this key matches — sharing a compiled+running filter is only sound
    for semantically identical predicates (unlike the AOT cache key,
    which masks constants because there they are data/operands of an
    equal-shape program)."""
    blob = json.dumps(
        [stream_id, render_expr(predicate)],
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def mid_stream_of(key: str) -> str:
    return f"{MID_STREAM_PREFIX}{key[:16]}"


def host_id_of(key: str) -> str:
    return f"{SHARE_HOST_PREFIX}{key[:16]}"


def _flatten_and(e: Optional[qast.Expr]) -> List[qast.Expr]:
    if e is None:
        return []
    if isinstance(e, qast.Binary) and e.op == "and":
        return _flatten_and(e.left) + _flatten_and(e.right)
    return [e]


def _join_and(conjuncts: List[qast.Expr]) -> Optional[qast.Expr]:
    if not conjuncts:
        return None
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = qast.Binary("and", out, c)
    return out


def _strip_qualifiers(
    pred: qast.Expr, allowed: Tuple[str, ...]
) -> Optional[qast.Expr]:
    """Rebase a predicate onto the bare source stream: qualifiers in
    ``allowed`` (element aliases / the stream's ref name) drop, anything
    else — or an indexed capture, or an aggregate — disqualifies."""
    ok = [True]

    def leaf(a: qast.Attr) -> qast.Attr:
        if a.index is not None:
            ok[0] = False
            return a
        if a.qualifier is not None and a.qualifier not in allowed:
            ok[0] = False
            return a
        return qast.Attr(a.name)

    if qast.contains_aggregate(pred):
        return None
    out = qast.map_expr(pred, leaf)
    return out if ok[0] else None


def split_shared_prefix(q: qast.Query) -> Optional[PrefixSplit]:
    """Decide whether ``q`` has a shareable filter prefix, and return
    it (or None — the query stays on the unshared ladder rungs).

    * ``from S[p]...`` stream queries: the LEADING bracket predicate is
      the prefix unit (the author's own bracket grouping is the share
      granule); the suffix keeps ``filters[1:]``, windows, selector.
    * pattern/sequence queries over ONE stream: the conjuncts common to
      EVERY element's filter form the prefix (each event entering any
      element must have passed them); the suffix keeps the residue
      per element.

    Joins, partitions, rate-limited/expired outputs and table actions
    are outside the subset; a query already reading a ``_shr_`` mid
    stream never splits again (one level of sharing)."""
    if (
        q.output_action != "insert"
        or q.on_condition is not None
        or q.partition_with
        or q.group_sources
        or q.output_rate is not None
        or q.output_events != "current"
    ):
        return None
    inp = q.input
    if isinstance(inp, qast.StreamInput):
        if inp.stream_id.startswith(MID_STREAM_PREFIX):
            return None
        if not inp.filters:
            return None
        if not (
            inp.filters[1:]
            or inp.windows
            or q.selector.group_by
            or q.selector.having is not None
            or (
                not q.selector.is_star
                and any(
                    qast.contains_aggregate(it.expr)
                    for it in q.selector.items
                )
            )
        ):
            # the residue would be a bare projection: a 1-member host
            # plus a structureless suffix costs strictly more than the
            # original plan (two dispatch legs, one of them stateless),
            # and in a serving fleet it would put every single-bracket
            # filter tenant — including latency probes — behind the
            # loopback hop for nothing
            return None
        pred = _strip_qualifiers(
            inp.filters[0], (inp.ref_name, inp.stream_id)
        )
        if pred is None:
            return None
        return PrefixSplit(inp.stream_id, pred)
    if isinstance(inp, qast.PatternInput):
        els = inp.elements
        streams = {el.stream_id for el in els}
        if len(streams) != 1:
            return None
        (sid,) = streams
        if sid.startswith(MID_STREAM_PREFIX):
            return None
        if any(el.entry_filter is not None for el in els):
            return None
        per_el = [_flatten_and(el.filter) for el in els]
        if any(not c for c in per_el):
            return None  # an unfiltered element admits everything
        common = [
            c for c in per_el[0]
            if all(c in rest for rest in per_el[1:])
        ]
        if not common:
            return None
        aliases = tuple(el.alias for el in els) + (sid,)
        pred = _strip_qualifiers(_join_and(common), aliases)
        if pred is None:
            return None
        return PrefixSplit(sid, pred)
    return None


def _remove_conjuncts(
    filt: Optional[qast.Expr], shared: List[qast.Expr]
) -> Optional[qast.Expr]:
    remaining = list(shared)
    kept = []
    for c in _flatten_and(filt):
        if c in remaining:
            remaining.remove(c)
        else:
            kept.append(c)
    return _join_and(kept)


def suffix_query(q: qast.Query, split: PrefixSplit, mid: str) -> qast.Query:
    """The per-tenant residue of ``q`` after the shared prefix moved to
    the producer: same query, reading ``mid`` with the shared predicate
    removed. The source stream's name survives as the alias so selector
    qualifiers keep resolving."""
    inp = q.input
    if isinstance(inp, qast.StreamInput):
        new_inp = dataclasses.replace(
            inp,
            stream_id=mid,
            alias=inp.ref_name,
            filters=inp.filters[1:],
        )
        return dataclasses.replace(q, input=new_inp)
    assert isinstance(inp, qast.PatternInput)
    shared = _flatten_and(split.predicate)

    def _requalify(el_alias: str, e: qast.Expr) -> List[qast.Expr]:
        # element filters may carry the shared conjuncts under the
        # element alias / stream qualifier; compare them qualifier-
        # stripped, exactly as the split derived the predicate
        stripped = _strip_qualifiers(e, (el_alias, split.stream_id))
        return [stripped] if stripped is not None else [e]

    new_els = []
    for el in inp.elements:
        conj = _flatten_and(el.filter)
        kept = []
        remaining = list(shared)
        for c in conj:
            (canon,) = _requalify(el.alias, c) or [c]
            if canon in remaining:
                remaining.remove(canon)
            else:
                kept.append(c)
        new_els.append(
            dataclasses.replace(
                el, stream_id=mid, filter=_join_and(kept)
            )
        )
    new_inp = dataclasses.replace(inp, elements=tuple(new_els))
    return dataclasses.replace(q, input=new_inp)


def prefix_cql(split: PrefixSplit, mid: str) -> str:
    """The producer host's plan text: stateless filter, ``select *``,
    emitting the loopback mid-stream."""
    return (
        f"from {split.stream_id}[{render_expr(split.predicate)}] "
        f"select * insert into {mid}"
    )


def suffix_cql(
    q: qast.Query, split: PrefixSplit, mid: str, mid_schema
) -> str:
    """The consumer suffix's plan text: mid-stream DDL (so the tenant
    plan compiles against the job's registered schemas — the DDL path
    shares the environment string dictionary) + the rewritten query."""
    ddl = render_stream_def(mid, mid_schema)
    return f"{ddl};\n{render_query(suffix_query(q, split, mid))}"
