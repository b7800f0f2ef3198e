"""Chain pattern queries compiled to a dense, batch-parallel matcher.

The torch port of the chain matcher of ``flink_siddhi_tpu/compiler/nfa.py``
— ``[every] e0 -> e1 -> ... -> eK`` where every element is a plain (1,1)
occurrence, with mid-chain absence guards (``A -> not B -> C``), terminal
timed absence (``A -> not B for t``) and ``within``. Per-element predicates
are evaluated once for the whole batch; "next match at/after position p"
becomes a reverse cummin per element (the ``multi_reverse_cummin`` kernel);
every partial match then advances through the whole chain in one pass (the
``chain_advance`` kernel) — no per-event loop at all. Partial matches that
outlive the batch carry in a fixed pool of slots. Chain queries of one
shape stack on a leading query axis (``StackedChainArtifact``, built by
``group_chain_artifacts``): one core, and one launch of each kernel, per
step for all of them.

Patterns that need the general slot NFA (sequences, quantifiers, and/or
groups, cross-element filters, grouped ``every``, mid-chain ``-> every``)
are not in this port yet: ``compile_pattern_query`` raises for them.

Match semantics (pinned against the reference's integration tests,
SiddhiCEPITCase.java:333-382): ``every`` starts an independent partial at
each occurrence of the first element; without ``every`` the pattern matches
exactly once (earliest start, earliest completion), then disarms; ``->``
ignores unrelated events between steps; ``within t`` bounds the first-to-
last span.

JAX semantics that torch does not share, and what this module does:
out-of-range gathers never happen (indices are clamped as the reference
clamps), dropped scatters go to a dump column that is sliced off, and
int64 results of ``sum``/``cumsum``/``arange`` are cast back to int32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import torch_dtype
from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.types import AttributeType
from .cuda_ops import chain_advance, multi_reverse_cummin
from .expr import (
    ColumnEnv,
    ExprResolver,
    ResolvedAttr,
    as_column,
    as_i32,
    compile_expr,
    compile_host_pred,
)
from .output import OutputField, OutputSchema, emission_order

DEFAULT_PARTIAL_POOL = 1024  # chain matcher: carried partial matches
_BIG = 2 ** 30
_I32 = torch.int32


def _slot_nfa_only(what: str) -> SiddhiQLError:
    return SiddhiQLError(
        f"{what} needs the slot NFA, which the torch port does not have "
        "yet (ROADMAP.md Queue 1 item 8); the JAX package "
        "flink_siddhi_tpu runs it"
    )


# --------------------------------------------------------------------------
# Capture resolution: select-clause refs -> captured-value env keys
# --------------------------------------------------------------------------

def _cap_key(alias: str, which: str, name: str) -> str:
    return f"{alias}@{which}.{name}"


class CaptureResolver:
    """Resolves select/having attribute refs against pattern captures.

    ``s1.x`` / ``s1[0].x`` -> first absorbed event's value;
    ``s1[last].x`` -> last absorbed event's value. Bare names resolve
    uniquely across elements (ambiguity is an error, as in Siddhi).
    """

    def __init__(self, elements, schemas):
        # alias -> (element index, stream_id, schema); absent ('not')
        # elements never match an event, so they have nothing to select
        self._by_alias: Dict[str, Tuple[int, str, object]] = {}
        self._negated = {el.alias for el in elements if el.negated}
        self._elements = tuple(elements)
        for i, el in enumerate(elements):
            self._by_alias[el.alias] = (i, el.stream_id, schemas[el.stream_id])
        self.referenced: List[Tuple[int, str, str]] = []  # (elem, col, which)

    def element_of(self, attr: ast.Attr) -> Optional[int]:
        """The element index an attribute reference resolves to, or None
        (unknown / ambiguous). Mirrors resolve()'s rules without raising
        or recording."""
        if attr.qualifier is not None:
            info = self._by_alias.get(attr.qualifier)
            return info[0] if info is not None else None
        hits = [
            info[0]
            for alias, info in self._by_alias.items()
            if attr.name in info[2] and alias not in self._negated
        ]
        return hits[0] if len(hits) == 1 else None

    def _note(self, elem: int, col: str, which: str) -> None:
        key = (elem, col, which)
        if key not in self.referenced:
            self.referenced.append(key)

    def resolve(self, attr: ast.Attr) -> ResolvedAttr:
        if attr.qualifier is None:
            hits = [
                (alias, info)
                for alias, info in self._by_alias.items()
                if attr.name in info[2] and alias not in self._negated
            ]
            if not hits:
                raise SiddhiQLError(f"unknown attribute {attr.name!r}")
            if len(hits) > 1:
                raise SiddhiQLError(
                    f"ambiguous attribute {attr.name!r}; qualify it with a "
                    "pattern alias"
                )
            alias, (idx, _sid, schema) = hits[0]
            which = "first"
        else:
            if attr.qualifier not in self._by_alias:
                raise SiddhiQLError(
                    f"unknown pattern alias {attr.qualifier!r}"
                )
            alias = attr.qualifier
            idx, _sid, schema = self._by_alias[alias]
            if attr.index is None or attr.index == 0:
                which = "first"
            elif attr.index == "last":
                which = "last"
            elif isinstance(attr.index, int) and attr.index > 0:
                mx = self._elements[idx].max_count
                if 0 <= mx <= attr.index:
                    raise SiddhiQLError(
                        f"{alias}[{attr.index}] can never exist: the "
                        f"element absorbs at most {mx} event(s)"
                    )
                raise _slot_nfa_only(f"indexed capture {alias}[{attr.index}]")
            else:
                raise SiddhiQLError(
                    f"indexed capture {alias}[{attr.index!r}] is not "
                    "supported; use a non-negative index or [last]"
                )
            if attr.name not in schema:
                raise SiddhiQLError(
                    f"stream of alias {alias!r} has no attribute {attr.name!r}"
                )
        if alias in self._negated:
            raise SiddhiQLError(
                f"cannot select from absent ('not') element {alias!r}"
            )
        atype = schema.field_type(attr.name)
        table = schema.string_tables.get(attr.name)
        self._note(idx, attr.name, which)
        return ResolvedAttr(_cap_key(alias, which, attr.name), atype, table)


# --------------------------------------------------------------------------
# Compile-time spec
# --------------------------------------------------------------------------

@dataclass
class _PatternSpec:
    elements: Tuple[ast.PatternElement, ...]
    every: bool
    within: Optional[int]
    pred_fns: List[Optional[Callable[[ColumnEnv], torch.Tensor]]]
    stream_code_of: List[int]
    # captures: (elem idx, col name, 'first'|'last'); col key per element
    captures: List[Tuple[int, str, str]]
    cap_dtype: Dict[Tuple[int, str], np.dtype]
    cap_src_key: Dict[Tuple[int, str], str]  # tape column key
    proj_fns: List
    out_fields: Tuple[OutputField, ...]
    output_stream: str
    # per select item: the capture pair it reads when it is a plain
    # reference (else None), and every capture pair it reads
    proj_srcs: Tuple[Optional[Tuple[int, str]], ...] = ()
    proj_ref_pairs: Tuple[Tuple[Tuple[int, str], ...], ...] = ()
    # per element: the numpy twin of its filter (expr.compile_host_pred),
    # None when it has none or the filter is not host-evaluable
    host_pred_fns: Tuple = ()

    @property
    def n_elements(self) -> int:
        return len(self.elements)


def _build_spec(
    q: ast.Query,
    schemas,
    stream_codes: Dict[str, int],
    extensions,
) -> _PatternSpec:
    """The chain subset of the reference's ``_build_spec``: the same
    validation, and a ``SiddhiQLError`` for every pattern form that needs
    the slot NFA."""
    inp = q.input
    if not isinstance(inp, ast.PatternInput):
        raise SiddhiQLError("not a pattern query")
    if inp.kind == "sequence":
        raise _slot_nfa_only("a sequence (',')")
    aliases = [el.alias for el in inp.elements]
    if len(set(aliases)) != len(aliases):
        raise SiddhiQLError("pattern aliases must be unique")
    for i, el in enumerate(inp.elements):
        if el.group_link is not None:
            raise _slot_nfa_only("an 'and'/'or' group")
        if el.negated:
            # mid-chain absence: `A -> not B -> C`; terminal TIMED
            # absence: `A -> not B for 5 sec`
            if i == 0:
                raise SiddhiQLError(
                    "a pattern cannot start with an absent ('not') element"
                )
            last = i == len(inp.elements) - 1
            if last and el.absent_for is None:
                raise SiddhiQLError(
                    "terminal absence needs a duration: "
                    "'-> not B for 5 sec'"
                )
            if not last and el.absent_for is not None:
                raise SiddhiQLError(
                    "timed absence ('not B for t') must be the last "
                    "pattern element"
                )
            if (el.min_count, el.max_count) != (1, 1):
                raise SiddhiQLError(
                    "absent ('not') elements cannot be quantified"
                )
        elif el.absent_for is not None:
            raise SiddhiQLError(
                "'for <duration>' is only valid on absent ('not') elements"
            )
        if el.stream_id not in stream_codes:
            raise SiddhiQLError(f"stream {el.stream_id!r} is not defined")
    for el in inp.elements:
        if (el.min_count, el.max_count) != (1, 1):
            raise _slot_nfa_only("a quantified pattern element")
        if getattr(el, "every_marked", False):
            raise _slot_nfa_only("a mid-chain '-> every'")
    if inp.every_grouped:
        raise _slot_nfa_only("a grouped 'every (A -> B)'")

    cap_resolver = CaptureResolver(inp.elements, schemas)
    alias_idx = {el.alias: i for i, el in enumerate(inp.elements)}
    pred_fns: List[Optional[Callable]] = []
    host_pred_fns: List = []
    for i, el in enumerate(inp.elements):
        schema = schemas[el.stream_id]
        if el.filter is None:
            pred_fns.append(None)
            host_pred_fns.append(None)
            continue
        foreign = {
            a.qualifier
            for a in ast.iter_attrs(el.filter)
            if a.qualifier is not None
            and a.qualifier in alias_idx
            and a.qualifier != el.alias
        }
        if foreign:
            if el.negated:
                raise SiddhiQLError(
                    "cross-element references are not supported in absent "
                    "('not') element filters"
                )
            raise _slot_nfa_only("a cross-element filter")
        scopes = {
            el.alias: (el.stream_id, schema),
            el.stream_id: (el.stream_id, schema),
        }
        resolver = ExprResolver(scopes, default_scope=el.alias)
        ce = compile_expr(el.filter, resolver, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("pattern element filter must be boolean")
        pred_fns.append(ce.fn)
        host_pred_fns.append(compile_host_pred(el.filter, resolver))
    if q.selector.is_star:
        raise SiddhiQLError(
            "select * is not valid for pattern queries; name the captures"
        )
    proj_fns, out_fields, proj_srcs, proj_ref_pairs = [], [], [], []
    for item in q.selector.items:
        if ast.contains_aggregate(item.expr):
            raise SiddhiQLError(
                "aggregations over pattern matches are not supported"
            )
        ce = compile_expr(item.expr, cap_resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(OutputField(item.output_name(), ce.atype, ce.table))
        pairs = set()
        for a in ast.iter_attrs(item.expr):
            e = cap_resolver.element_of(a)
            if e is not None:
                pairs.add((e, a.name))
        proj_ref_pairs.append(tuple(sorted(pairs)))
        src = None
        if isinstance(item.expr, ast.Attr) and item.expr.index in (
            None, 0, "last",
        ):
            # the reference's rule: unqualified names count every element
            # carrying them, absent ones too
            a = item.expr
            infos = (
                [cap_resolver._by_alias.get(a.qualifier)]
                if a.qualifier is not None
                else list(cap_resolver._by_alias.values())
            )
            hits = [i for i in infos if i is not None and a.name in i[2]]
            if len(hits) == 1:
                src = (hits[0][0], a.name)
        proj_srcs.append(src)
    if q.selector.having is not None:
        raise SiddhiQLError("having is not valid on pattern queries")

    captures = list(cap_resolver.referenced)
    cap_dtype, cap_src = {}, {}
    for elem, col, _which in captures:
        el = inp.elements[elem]
        atype = schemas[el.stream_id].field_type(col)
        cap_dtype[(elem, col)] = atype.device_dtype
        cap_src[(elem, col)] = f"{el.stream_id}.{col}"

    return _PatternSpec(
        elements=inp.elements,
        every=inp.every_,
        within=inp.within,
        pred_fns=pred_fns,
        stream_code_of=[stream_codes[el.stream_id] for el in inp.elements],
        captures=captures,
        cap_dtype=cap_dtype,
        cap_src_key=cap_src,
        proj_fns=proj_fns,
        out_fields=tuple(out_fields),
        output_stream=q.output_stream,
        proj_srcs=tuple(proj_srcs),
        proj_ref_pairs=tuple(proj_ref_pairs),
        host_pred_fns=tuple(host_pred_fns),
    )


def _cap_pairs(spec: _PatternSpec) -> List[Tuple[int, str]]:
    seen: List[Tuple[int, str]] = []
    for elem, col, _w in spec.captures:
        if (elem, col) not in seen:
            seen.append((elem, col))
    return seen


def _skey(prefix: str, elem: int, col: str) -> str:
    """Flat string key for state dicts (one key type across the state)."""
    return f"{prefix}:{elem}:{col}"


_COMPACT_MIN_E = 4096  # below this, compaction overhead beats the gain


def _compact_width(E: int) -> int:
    """Relevant-event buffer width for chain relevance compaction."""
    return max(2048, E // 8)


def _compact_index(rel: torch.Tensor, R: int):
    """Scatter-compact the True positions of each row of ``rel`` (bool[E],
    or bool[Q, E] for a stack) into an ascending index buffer of width R per
    row, in ONE scatter. Returns (idx, cnt, cvalid), cnt with a kept last
    axis; positions beyond R land in a dump column that is sliced off
    (callers branch on cnt <= R)."""
    E = int(rel.shape[-1])
    dev = rel.device
    cnt = rel.sum(-1, keepdim=True, dtype=_I32)
    cpos = torch.cumsum(rel, -1, dtype=_I32) - 1
    dest = torch.where(rel & (cpos < R), cpos, R).long()
    idx = torch.zeros(rel.shape[:-1] + (R + 1,), dtype=_I32, device=dev)
    src = torch.arange(E, dtype=_I32, device=dev)
    idx.scatter_(-1, dest, src if rel.dim() == 1 else src.expand_as(rel))
    cvalid = torch.arange(R, dtype=_I32, device=dev) < torch.clamp(cnt, max=R)
    return idx[..., :R], cnt, cvalid


def step_branch(artifact, capacity: int, bound: Optional[int]) -> str:
    """The branch a chain matcher's step takes on a tape of ``capacity``
    events whose host-known relevance bound (``Tape.bounds``) is
    ``bound``: "full" (too narrow to compact), "compact" (decided on the
    host), or "read" (the bound exceeds the compact width: the step reads
    the device count, a host sync, so no CUDA graph can capture it)."""
    if capacity < _COMPACT_MIN_E:
        return "full"
    if bound is not None and bound <= artifact.compact_width(capacity):
        return "compact"
    return "read"


def _compaction(artifact, tape, rel: torch.Tensor, R: int):
    """Relevance compaction of ``rel`` at width R: (idx, cvalid), or None
    for the full-width branch — the reference's lax.cond on the device
    count. The host decides with no wait when the tape's host-known bound
    for ``artifact`` (TapeSpec.relevance) is at most R; only a larger bound
    reads the largest count, one host sync in ``artifact.host_syncs``."""
    idx, cnt, cvalid = _compact_index(rel, R)
    if step_branch(artifact, tape.capacity,
                   tape.bounds.get(artifact.name)) == "read":
        artifact.host_syncs += 1
        if int(cnt.max()) > R:
            return None
    return idx, cvalid


def _element_preds(spec: _PatternSpec, tape, enabled) -> List[torch.Tensor]:
    """bool[E] match mask per element, fused over the whole batch."""
    env: ColumnEnv = dict(tape.cols)
    preds = []
    for k in range(spec.n_elements):
        m = tape.valid & (tape.stream == spec.stream_code_of[k])
        fn = spec.pred_fns[k]
        if fn is not None:
            m = m & fn(env)
        preds.append(m & enabled)
    return preds


def _emit_env(spec: _PatternSpec, cap_arrays: Dict) -> ColumnEnv:
    """Capture buffers -> env for the projection closures."""
    env: ColumnEnv = {}
    for elem, col, which in spec.captures:
        alias = spec.elements[elem].alias
        env[_cap_key(alias, which, col)] = cap_arrays[(elem, col, which)]
    return env


def _from_i32(row: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return row.view(torch.float32)
    return row.to(dtype)


@dataclass(frozen=True)
class _ChainCfg:
    """Static chain-matcher configuration — everything the core needs
    besides data.

    ``positive`` are the original element indices the chain advances
    through; ``guards[k]`` are the absent ('not') elements between
    positive steps k-1 and k — a guard match before the step-k match
    kills the partial (mid-chain absence, `A -> not B -> C`)."""

    K: int  # number of POSITIVE elements
    every: bool
    has_within: bool
    pairs: Tuple[Tuple[int, str], ...]
    cap_dtypes: Tuple[str, ...]  # numpy dtype names, per pair
    positive: Tuple[int, ...] = ()
    guards: Tuple[Tuple[int, ...], ...] = ()  # per positive step
    # terminal timed absence (`... -> not B for t`): the guard element's
    # index; partials that finish all positive steps WAIT, and emit at
    # (last positive ts + t) unless a guard match lands inside the window
    t_guard: Optional[int] = None

    @staticmethod
    def of(spec: "_PatternSpec") -> "_ChainCfg":
        pairs = tuple(_cap_pairs(spec))
        positive = tuple(
            i for i, el in enumerate(spec.elements) if not el.negated
        )
        guards: List[Tuple[int, ...]] = []
        for k, elem in enumerate(positive):
            lo = positive[k - 1] if k else -1
            guards.append(
                tuple(
                    g
                    for g in range(lo + 1, elem)
                    if spec.elements[g].negated
                )
            )
        last = spec.elements[-1]
        t_guard = (
            len(spec.elements) - 1
            if last.negated and last.absent_for is not None
            else None
        )
        return _ChainCfg(
            K=len(positive),
            every=spec.every,
            has_within=spec.within is not None,
            pairs=pairs,
            cap_dtypes=tuple(
                np.dtype(spec.cap_dtype[p]).name for p in pairs
            ),
            positive=positive,
            guards=tuple(guards),
            t_guard=t_guard,
        )


def _chain_core(
    cfg: _ChainCfg,
    P: int,
    state: Dict,  # per key [P] or a scalar; with a query axis [Q, P], [Q]
    preds: torch.Tensor,  # bool[(Q,) n_elements, E] — positive AND guard
    # rows, by ORIGINAL element index (cfg.K counts positive elements only)
    cap_srcs: Dict,  # pair -> value[(Q,) E]
    within_val,  # int, or int32[Q] (ignored unless cfg.has_within)
    ts: torch.Tensor,  # int32[(Q,) E]
    valid: torch.Tensor,  # bool[(Q,) E]
    tfor_val=0,  # int, or int32[Q]: the timed-absence window (t_guard)
    batch_max: Optional[torch.Tensor] = None,  # int32 scalar: max valid
    # ts of the FULL batch (a relevance-compacted caller passes it so
    # within-expiry and absence deadlines still see the whole batch's
    # time horizon; a stack passes it for every query)
):
    """One micro-batch of the chain matcher for one query, or for Q
    queries of one ``cfg`` on a leading query axis: advance carried
    partials + fresh starts through all elements, find completions, and
    compact survivors back into each query's pool. The reference runs its
    per-query core under ``jax.vmap`` for a stack; here every op works on
    the last axis and broadcasts over the query axis, and the two kernels
    serve every query at once: all next-match tables in one
    ``multi_reverse_cummin`` launch, the advance in one ``chain_advance``
    launch (its query grid axis). Capture and emit-ts gathers replay off
    the advance's per-step match positions.

    Returns (new_state, complete[(Q,) V], emit_ts[(Q,) V],
    caps{pair: [(Q,) V]}).
    """
    K = cfg.K
    E = int(ts.shape[-1])
    lead = tuple(ts.shape[:-1])  # () or (Q,)
    V = P + E
    dev = ts.device
    pairs = list(cfg.pairs)
    cap_dtypes = {
        p: torch_dtype(n) for p, n in zip(cfg.pairs, cfg.cap_dtypes)
    }
    positive = cfg.positive
    guards = cfg.guards
    if len(positive) != K or len(guards) != K:
        raise ValueError("chain cfg: positive/guards disagree with K")
    arange = torch.arange(E, dtype=_I32, device=dev)
    # a per-query window broadcasts over each query's candidates
    if isinstance(within_val, torch.Tensor):
        within_b = within_val.unsqueeze(-1)
    else:
        within_b = within_val
    if isinstance(tfor_val, torch.Tensor):
        tfor_val = tfor_val.unsqueeze(-1)

    # nxt[row][p] = min q >= p with preds[e][q], else E, one row per
    # element the advance reads (positive targets, then guards, then the
    # timed-absence guard), every query's rows together; column E reads
    # "no match" (the kernel's pad)
    scan_rows = list(positive[1:]) + [g for gs in guards for g in gs]
    if cfg.t_guard is not None:
        scan_rows.append(cfg.t_guard)
    row_of = {e: r for r, e in enumerate(scan_rows)}
    nxt = None
    if scan_rows:
        idxs = torch.stack(
            [torch.where(preds[..., e, :], arange, E) for e in scan_rows],
            -2,
        )
        if lead:
            idxs = idxs.reshape(-1, E)
        nxt = multi_reverse_cummin(idxs, pad=E)
    ts_pad = torch.cat(
        [ts, torch.zeros(lead + (1,), dtype=_I32, device=dev)], -1
    )
    env_pad = {
        pair: torch.cat(
            [cap_srcs[pair],
             torch.zeros(lead + (1,), dtype=cap_srcs[pair].dtype,
                         device=dev)],
            -1,
        )
        for pair in pairs
    }

    # fresh starts: one candidate per tape position matching element 0
    starts = preds[..., 0, :]
    if not cfg.every:
        starts = starts & ~state["done"].unsqueeze(-1)
    v_active = torch.cat([state["active"], starts], -1)
    v_step = torch.cat(
        [state["step"], torch.ones(lead + (E,), dtype=_I32, device=dev)], -1
    )
    # search position: carried partials resume at batch start
    fresh_pos = arange + 1
    if lead:
        fresh_pos = fresh_pos.expand(lead + (E,))
    v_pos = torch.cat(
        [torch.zeros(lead + (P,), dtype=_I32, device=dev), fresh_pos], -1
    )
    v_start = torch.cat([state["start"], ts], -1)
    # fresh starts already completed element 0 at their own position, so a
    # single-element pattern (K == 1) emits at the start event's ts; K > 1
    # overwrites this on the final advance. With a terminal timed absence
    # the pool carries emit_ts (the waiting deadline's base) across batches.
    carried_emit = (
        state["emit_ts"]
        if cfg.t_guard is not None
        else torch.zeros(lead + (P,), dtype=_I32, device=dev)
    )
    v_emit_ts = torch.cat([carried_emit, ts], -1)
    caps = {}
    for pair in pairs:
        elem, _col = pair
        fresh = (
            cap_srcs[pair]
            if elem == 0
            else torch.zeros(lead + (E,), dtype=cap_dtypes[pair],
                             device=dev)
        )
        caps[pair] = torch.cat([state[_skey("cap", *pair)], fresh], -1)

    # advance every partial through all remaining positive elements in
    # one kernel pass; absence guards between steps kill a partial when a
    # guard event arrives at or before the step's own match. Capture and
    # emit-ts gathers replay off the per-step match positions (jmat).
    if K > 1:
        v_active, v_step, v_pos, jmat = chain_advance(
            nxt,
            [row_of[e] for e in positive[1:]],
            [[row_of[g] for g in guards[k]] for k in range(1, K)],
            ts_pad, v_active, v_step, v_pos, v_start,
            within_val if cfg.has_within else None,
        )
        for k in range(1, K):
            elem = positive[k]
            jk = jmat[..., k - 1, :]
            found = jk < E
            jl = jk.long()
            for pair in pairs:
                if pair[0] == elem:
                    caps[pair] = torch.where(
                        found, torch.gather(env_pad[pair], -1, jl),
                        caps[pair],
                    )
            if k == K - 1:
                v_emit_ts = torch.where(
                    found, torch.gather(ts_pad, -1, jl), v_emit_ts
                )

    if batch_max is None:
        batch_max = torch.where(valid, ts, -_BIG).max()
    still_waiting = None
    if cfg.t_guard is not None:
        # partials that finished every positive step WAIT for the absence
        # window: a guard match inside (last_ts, last_ts + t] kills them
        # (strictly after the last positive event); once batch time proves
        # the window elapsed guard-free, they mature and emit at the
        # deadline
        waiting = v_active & (v_step == K)
        deadline = v_emit_ts + tfor_val
        # the search starts at the first position whose ts exceeds
        # last_ts. Only the valid prefix is ts-sorted: the compacted
        # tape's padded tail repeats the batch's first ts, so the tail
        # is searched as +inf. (The reference searches the raw compacted
        # ts and misses in-window guards there: ROADMAP.md Queue 3.)
        past_emit = torch.searchsorted(
            torch.where(valid, ts, torch.iinfo(torch.int32).max),
            v_emit_ts, right=True, out_int32=True,
        )
        r = row_of[cfg.t_guard]
        guard_tbl = nxt.view(lead + (len(scan_rows), E + 1))[..., r, :]
        jg = torch.gather(
            guard_tbl, -1, torch.maximum(v_pos, past_emit).clamp(0, E).long()
        )
        guard_hit = (
            waiting & (jg < E)
            & (torch.gather(ts_pad, -1, jg.long()) <= deadline)
        )
        matured = waiting & ~guard_hit & (deadline <= batch_max)
        complete = matured
        v_emit_ts = torch.where(matured, deadline, v_emit_ts)
        still_waiting = waiting & ~guard_hit & ~matured
    else:
        complete = v_active & (v_step == K)
    if not cfg.every:
        # exactly one match per query: earliest start, then earliest
        # completion (argmin takes the first minimum, as jnp.argmin does)
        start_key = torch.where(complete, v_start, _BIG)
        min_start = start_key.amin(-1, keepdim=True)
        emit_key = torch.where(
            complete & (v_start == min_start), v_emit_ts, _BIG
        )
        winner = torch.argmin(emit_key, -1, keepdim=True)
        one = torch.arange(V, device=dev) == winner
        complete = complete & one & ~state["done"].unsqueeze(-1)
        new_done = state["done"] | complete.any(-1)
        if still_waiting is not None:
            # the single match is taken: waiting partials are void
            still_waiting = still_waiting & ~new_done.unsqueeze(-1)
    else:
        new_done = state["done"]

    # survivors -> new pool: one scatter over a stacked (state-row, (Q,)
    # V) matrix, a dump column P per query. The v ordering (carried pool
    # first, then fresh starts in tape order) is oldest-start-first for
    # time-ordered batches, so on overflow the newest partials drop.
    survive = v_active & (v_step < K)
    if cfg.has_within:
        survive = survive & ((batch_max - v_start) <= within_b)
    if still_waiting is not None:
        survive = survive | still_waiting
    keep_pos = torch.cumsum(survive, -1, dtype=_I32) - 1
    pool_dest = torch.where(survive & (keep_pos < P), keep_pos, P).long()
    n_survive = survive.sum(-1, dtype=_I32)

    fixed_rows = [as_i32(survive), v_step, v_start]
    if cfg.t_guard is not None:
        fixed_rows.append(v_emit_ts)
    n_fixed = len(fixed_rows)
    pool_rows = torch.stack(
        fixed_rows + [as_i32(caps[pair]) for pair in pairs]
    )
    n_rows = int(pool_rows.shape[0])
    pool_packed = torch.zeros(
        (n_rows,) + lead + (P + 1,), dtype=_I32, device=dev
    )
    pool_packed[1].fill_(1)  # free slots hold step 1
    pool_packed.scatter_(
        -1, pool_dest.unsqueeze(0).expand(pool_rows.shape), pool_rows
    )
    pool_packed = pool_packed[..., :P]
    new_state = {
        "enabled": state["enabled"],
        "active": pool_packed[0].to(torch.bool),
        "step": pool_packed[1],
        "start": pool_packed[2],
        "done": new_done,
        "overflow": state["overflow"]
        + torch.clamp(n_survive - P, min=0).to(_I32),
    }
    if cfg.t_guard is not None:
        new_state["emit_ts"] = pool_packed[3]
    for j, pair in enumerate(pairs):
        new_state[_skey("cap", *pair)] = _from_i32(
            pool_packed[n_fixed + j], cap_dtypes[pair]
        )
    return new_state, complete, v_emit_ts, caps


@dataclass
class ChainPatternArtifact:
    """``[every] e0 -> e1 -> ... -> eK``, each element exactly once.

    step() is loop-free over events: per-element "next match at/after p"
    tables come from one reverse cummin launch, and every partial (carried
    + newly started) advances through all remaining steps in one
    chain-advance launch.
    """

    name: str
    spec: _PatternSpec
    output_schema: OutputSchema
    # 'packed': step returns (n, (rows, V) int32 block) in the accumulator
    # append layout (``_row_plan``)
    output_mode: str = "packed"
    pool: int = DEFAULT_PARTIAL_POOL
    # host syncs this artifact made: the relevance-compaction branch reads
    # its relevant-event count when the tape's host-known bound exceeds
    # the compact width
    host_syncs: int = 0
    # late materialization: these capture pairs are PROJECTION-ONLY, so
    # their columns never ship to the device — the matcher captures the
    # event's global ordinal instead, and decode looks the value up in
    # the host's retained batches (runtime/executor._LazyRing)
    lazy_pairs: Tuple[Tuple[int, str], ...] = ()
    # wire predicate pushdown: element indices whose event-only filters
    # are host-evaluated and shipped as packed mask bits ("@p:<i>" cols)
    pushed_preds: Tuple[int, ...] = ()

    def emit_block_width(self, tape_capacity: int, state: Dict) -> int:
        """Widest per-cycle emission block (drain-cadence contract)."""
        return tape_capacity + self.pool

    compact_width = staticmethod(_compact_width)

    def relevance(self) -> Tuple:
        """One member: per element, (stream code, its pushed mask key or
        None, no literal conjuncts). An event outside every element's set
        can never be relevant, so the host's count over them bounds the
        device's relevant count (TapeSpec.relevance)."""
        return (tuple(
            (code, f"@p:{k}" if k in self.pushed_preds else None, ())
            for k, code in enumerate(self.spec.stream_code_of)
        ),)

    def _row_plan(self):
        """Emission block layout. Without lazy pairs: [ts, one row per
        projection]. Lazy plans compact it: projections that emit the SAME
        element's ordinal share one row, and the ts row is dropped
        entirely when it derives from the completing element's ordinal
        (the host ring retains rebased timestamps under ``@ts``) — the
        headline's block shrinks 4 rows -> 2.

        Returns (rows, row_of, ts_row, ts_ord_row): ``rows`` is a list of
        ("ts"|"ord"|"proj", proj_idx) sources, ``row_of[c]`` the block row
        of projection c, ``ts_row`` the ts row index or None, and
        ``ts_ord_row`` the row whose ordinals recover the emission ts
        when ``ts_row`` is None."""
        spec = self.spec
        C = len(spec.proj_fns)
        if not self.lazy_pairs:
            rows = [("ts", None)] + [("proj", c) for c in range(C)]
            return rows, list(range(1, 1 + C)), 0, None

        lazyset = set(self.lazy_pairs)

        def dedupable(elem: int) -> bool:
            # one ordinal == one event: only elements matching exactly
            # once (unquantified, non-negated) qualify
            el = spec.elements[elem]
            return (el.min_count, el.max_count) == (1, 1) and not el.negated

        last = spec.n_elements - 1
        drop_ts = (
            self._tfor_ms() is None
            and dedupable(last)
            and any(
                src is not None
                and src in lazyset
                and src[0] == last
                for src in spec.proj_srcs
            )
        )
        rows = []
        row_of = [0] * C
        ts_row = None
        if not drop_ts:
            ts_row = 0
            rows.append(("ts", None))
        ord_row: Dict[int, int] = {}
        for c, src in enumerate(spec.proj_srcs):
            if (
                src is not None
                and src in lazyset
                and dedupable(src[0])
            ):
                e = src[0]
                if e in ord_row:
                    row_of[c] = ord_row[e]
                    continue
                ord_row[e] = row_of[c] = len(rows)
                rows.append(("ord", c))
            else:
                row_of[c] = len(rows)
                rows.append(("proj", c))
        return rows, row_of, ts_row, (
            ord_row.get(last) if drop_ts else None
        )

    @property
    def acc_rows(self) -> int:
        return len(self._row_plan()[0])

    @property
    def ring_needs_ts(self) -> bool:
        """True when decode recovers emission timestamps from the host
        ring (the executor then retains a rebased ``@ts`` column)."""
        return bool(self.lazy_pairs) and self._row_plan()[2] is None

    def _emit_block(self, emit_ts, emit_env, width: int) -> torch.Tensor:
        """Stack the emission rows per ``_row_plan`` ("ord" rows evaluate
        their representative projection — identical values by the dedup
        criterion)."""
        out = []
        for kind, c in self._row_plan()[0]:
            if kind == "ts":
                out.append(as_i32(emit_ts))
            else:
                out.append(as_i32(as_column(
                    self.spec.proj_fns[c](emit_env), width, emit_ts
                )))
        return torch.stack(out)

    def _tfor_ms(self) -> Optional[int]:
        last = self.spec.elements[-1]
        return last.absent_for if last.negated else None

    def _cap_dtype(self, pair) -> np.dtype:
        if pair in self.lazy_pairs:
            return np.dtype(np.int32)  # global event ordinal
        return np.dtype(self.spec.cap_dtype[pair])

    def _cfg(self) -> _ChainCfg:
        cfg = _ChainCfg.of(self.spec)
        if self.lazy_pairs:
            cfg = dataclasses.replace(
                cfg,
                cap_dtypes=tuple(
                    self._cap_dtype(p).name for p in cfg.pairs
                ),
            )
        return cfg

    def init_state(self, device) -> Dict:
        P = self.pool
        state = {
            "enabled": torch.tensor(True, device=device),
            "active": torch.zeros(P, dtype=torch.bool, device=device),
            # next element to match
            "step": torch.ones(P, dtype=_I32, device=device),
            "start": torch.zeros(P, dtype=_I32, device=device),
            # non-every: already matched
            "done": torch.tensor(False, device=device),
            "overflow": torch.tensor(0, dtype=_I32, device=device),
        }
        if self._tfor_ms() is not None:
            # timed-absence waiting partials carry their deadline base
            state["emit_ts"] = torch.zeros(P, dtype=_I32, device=device)
        if self.lazy_pairs:
            # ordinal base: counts every valid event ever seen, the same
            # space the host's lazy ring is pushed in
            state["seen"] = torch.tensor(0, dtype=_I32, device=device)
        for pair in _cap_pairs(self.spec):
            state[_skey("cap", *pair)] = torch.zeros(
                P, dtype=torch_dtype(self._cap_dtype(pair)),
                device=device,
            )
        return state

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        spec = self.spec
        E = tape.capacity
        P = self.pool
        V = P + E  # virtual partial set: carried pool ++ fresh starts
        pairs = _cap_pairs(spec)
        preds = torch.stack(_element_preds(spec, tape, state["enabled"]))
        seen_next = None
        if self.lazy_pairs:
            # capture the event's GLOBAL ordinal for projection-only
            # columns; the column itself never shipped to the device
            ordinals = state["seen"] + torch.arange(
                E, dtype=_I32, device=tape.ts.device
            )
            cap_srcs = {
                pair: (
                    ordinals
                    if pair in self.lazy_pairs
                    else tape.cols[spec.cap_src_key[pair]]
                )
                for pair in pairs
            }
            seen_next = state["seen"] + tape.valid.sum(dtype=_I32)
            state = {k: v for k, v in state.items() if k != "seen"}
        else:
            cap_srcs = {
                pair: tape.cols[spec.cap_src_key[pair]] for pair in pairs
            }
        within_val = spec.within if spec.within is not None else 0
        tfor_val = self._tfor_ms() or 0
        cfg = self._cfg()
        # within-expiry / absence deadlines always see the full batch's
        # time horizon, even on the relevance-compacted path
        bm_full = torch.where(tape.valid, tape.ts, -_BIG).max()

        def run(ts, valid, preds_m, srcs):
            """Core + emission packing; the packed block is padded to the
            full (rows, P+E) accumulator layout so the compacted and full
            paths return identical shapes."""
            st, complete, v_emit_ts, caps = _chain_core(
                cfg, P, state, preds_m, srcs, within_val, ts, valid,
                tfor_val=tfor_val, batch_max=bm_full,
            )
            v = int(ts.shape[0]) + P
            n_matches = complete.sum(dtype=_I32)
            emit_pos = torch.cumsum(complete, 0, dtype=_I32) - 1
            emit_dest = torch.where(complete, emit_pos, V).long()
            emit_env = _emit_env(
                spec,
                {
                    (elem, col, which): caps[(elem, col)]
                    for elem, col, which in spec.captures
                },
            )
            emit_rows = self._emit_block(v_emit_ts, emit_env, v)
            rows = self.acc_rows
            packed = torch.zeros(
                (rows, V + 1), dtype=_I32, device=ts.device
            )
            packed.scatter_(
                1, emit_dest.unsqueeze(0).expand(rows, v), emit_rows
            )
            return st, n_matches, packed[:, :V]

        # Relevance compaction: '->' ignores events matching no element,
        # and the chain advance is V-sized pointer-chase gathers —
        # shrinking V from P+E to P+E//8 cuts the step on selective
        # workloads. The full-width core runs in the (rare) batch where
        # more than E//8 events are relevant.
        compacted = None
        if E >= _COMPACT_MIN_E:
            compacted = _compaction(self, tape, preds.any(dim=0) & tape.valid,
                                    _compact_width(E))
        if compacted is not None:
            idx, cvalid = compacted
            il = idx.long()
            st, n_matches, packed = run(
                tape.ts[il],
                cvalid,
                preds[:, il] & cvalid.unsqueeze(0),
                {p_: s_[il] for p_, s_ in cap_srcs.items()},
            )
        else:
            st, n_matches, packed = run(tape.ts, tape.valid, preds,
                                        cap_srcs)
        if seen_next is not None:
            st["seen"] = seen_next
        return st, (n_matches, packed)

    @property
    def wants_lookup(self) -> bool:
        return bool(self.lazy_pairs)

    @property
    def lazy_src_keys(self) -> Tuple[str, ...]:
        """Tape-column keys whose values the host ring must retain."""
        return tuple(
            sorted({self.spec.cap_src_key[p] for p in self.lazy_pairs})
        )

    def _lazy_ts(self, n: int, block: np.ndarray, lookup):
        """The emission timestamps of a lazy block: its ts row, or the
        completing element's ordinals resolved through the ring's ``@ts``
        column by ``lookup`` (the ring's ``lookup`` or ``lookup_np``; an
        evicted ordinal decodes ts 0 — its values decode None anyway)."""
        _rows, _row_of, ts_row, ts_ord_row = self._row_plan()
        if ts_row is not None:
            return np.asarray(block[ts_row, :n]).astype(np.int64)
        if lookup is None:
            return np.zeros(n, dtype=np.int64)
        tvals = lookup("@ts", np.asarray(block[ts_ord_row, :n]))
        if isinstance(tvals, np.ndarray) and tvals.dtype != object:
            return tvals.astype(np.int64)
        return np.asarray(
            [0 if v is None else int(v) for v in list(tvals)], np.int64
        )

    def decode_packed(self, n: int, block: np.ndarray, lookup=None):
        """With lazy pairs, ordinal rows resolve against the host's
        retained batches (the lazy ring's ``lookup``); evicted ordinals
        decode as None (bounded-memory policy). On the compact layout the
        emission ts itself recovers from the completing element's ordinal
        (ring column ``@ts``)."""
        from .select import _lazy_values

        schema = self.output_schema
        if not self.lazy_pairs:
            return [(schema, schema.decode_packed_block(n, block))]
        _rows, row_of, _ts_row, _ = self._row_plan()
        ts_arr = self._lazy_ts(n, block, lookup)
        order = emission_order(ts_arr, n)
        ts_list = ts_arr[order].tolist()
        col_lists = []
        for c, f in enumerate(schema.fields):
            raw = np.asarray(block[row_of[c], :n])[order]
            src = self.spec.proj_srcs[c]
            if src is not None and src in self.lazy_pairs:
                col_lists.append(_lazy_values(
                    raw, f, lookup, self.spec.cap_src_key[src]
                ))
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

    def decode_packed_columns(self, n: int, block: np.ndarray,
                              lookup_np=None):
        """Columnar twin of :meth:`decode_packed`: the same emission order
        and lazy-ordinal semantics, but typed numpy columns — lazy values
        resolve through the ring's vectorized ``lookup_np``."""
        from .output import ColumnBatch
        from .select import _lazy_column_np

        schema = self.output_schema
        if not self.lazy_pairs:
            return [(schema, schema.decode_packed_columns(n, block))]
        _rows, row_of, _ts_row, _ = self._row_plan()
        ts_arr = self._lazy_ts(n, block, lookup_np)
        order = emission_order(ts_arr, n)
        cols = {}
        for c, f in enumerate(schema.fields):
            raw = np.asarray(block[row_of[c], :n])[order]
            src = self.spec.proj_srcs[c]
            if src is not None and src in self.lazy_pairs:
                cols[f.name] = _lazy_column_np(
                    raw, f, lookup_np, self.spec.cap_src_key[src]
                )
            else:
                if np.dtype(f.atype.device_dtype) == np.dtype(np.float32):
                    raw = raw.view(np.float32)
                cols[f.name] = f.decode_column_np(raw)
        return [(schema, ColumnBatch(ts_arr[order], cols))]

    @property
    def flush_is_noop(self) -> bool:
        return self._tfor_ms() is None

    def flush(self, state: Dict) -> Tuple[Dict, Tuple]:
        """End-of-stream: with a terminal timed absence, stream end means
        time advances past every pending deadline guard-free (the +inf
        watermark), so all waiting partials mature and emit."""
        spec = self.spec
        P = self.pool
        dev = state["active"].device
        tfor = self._tfor_ms()
        if tfor is None:
            return state, (
                torch.tensor(0, dtype=_I32),
                torch.zeros((self.acc_rows, 1), dtype=_I32, device=dev),
            )
        K = _ChainCfg.of(spec).K
        waiting = state["active"] & (state["step"] == K)
        deadline = state["emit_ts"] + tfor
        if not spec.every:
            # exactly-one-match rule holds at end of stream too: nothing
            # if already matched, else the earliest-start (then earliest
            # deadline) waiting partial
            waiting = waiting & ~state["done"]
            start_key = torch.where(waiting, state["start"], _BIG)
            min_start = start_key.min()
            dl_key = torch.where(
                waiting & (state["start"] == min_start), deadline, _BIG
            )
            winner = torch.argmin(dl_key)
            waiting = waiting & (torch.arange(P, device=dev) == winner)
        n = waiting.sum(dtype=_I32)
        pos = torch.cumsum(waiting, 0, dtype=_I32) - 1
        dest = torch.where(waiting, pos, P).long()
        emit_env = _emit_env(
            spec,
            {
                (e, c, w): state[_skey("cap", e, c)]
                for e, c, w in spec.captures
            },
        )
        rows = self._emit_block(deadline, emit_env, P)
        packed = torch.zeros(
            (rows.shape[0], P + 1), dtype=_I32, device=dev
        )
        packed.scatter_(
            1, dest.unsqueeze(0).expand(rows.shape[0], P), rows
        )
        new_state = dict(state)
        new_state["active"] = state["active"] & ~waiting
        return new_state, (n, packed[:, :P])


def apply_lazy_projection(
    artifact: ChainPatternArtifact,
    skip_pred_elements: frozenset = frozenset(),
):
    """Late materialization for a chain plan: capture pairs that are
    PROJECTION-ONLY (their column feeds no predicate, and every select
    item reading them is a plain reference) switch to ordinal capture,
    and their columns drop off the device tape entirely. Returns the set
    of tape columns the device still needs, or None when nothing is
    lazy-eligible. ``skip_pred_elements``: elements whose filters were
    pushed to the host wire — their columns no longer pin the tape."""
    spec = artifact.spec
    pred_cols = set()
    for i, el in enumerate(spec.elements):
        if el.filter is None or i in skip_pred_elements:
            continue
        for a in ast.iter_attrs(el.filter):
            pred_cols.add(f"{el.stream_id}.{a.name}")
    pairs = _cap_pairs(spec)
    lazy = []
    for pair in pairs:
        key = spec.cap_src_key[pair]
        if key in pred_cols:
            continue
        plain = True
        for i, prs in enumerate(spec.proj_ref_pairs):
            if pair in prs and spec.proj_srcs[i] != pair:
                plain = False  # computed expression needs the value
                break
        if plain:
            lazy.append(pair)
    if not lazy:
        return None
    artifact.lazy_pairs = tuple(sorted(lazy))
    needed = set(pred_cols)
    for pair in pairs:
        if pair not in artifact.lazy_pairs:
            needed.add(spec.cap_src_key[pair])
    return needed


def chain_wire_opts(artifact: ChainPatternArtifact, config):
    """Wire optimizations for a chain plan, in order: predicate pushdown
    (host-evaluable element filters collapse to one packed mask bit per
    element) then late materialization (with pushed predicate columns
    now lazy-eligible). Returns (needed_device_columns, host_preds) or
    None when nothing applies. (The port's chains have no cross-element
    filters, so no event column is pinned by one.)"""
    from ..runtime.tape import HostPred

    spec = artifact.spec
    host_preds = []
    pushed = []
    if config.pred_pushdown:
        candidates = [
            i
            for i, he in enumerate(spec.host_pred_fns)
            if he is not None and spec.pred_fns[i] is not None
        ]
        # push only elements whose masks FREE wire columns. Columns that
        # stay regardless: unpushable element predicates, and capture
        # sources that cannot go lazy (computed projections, or lazy
        # projection disabled).
        kept_base = set()
        for i, el in enumerate(spec.elements):
            if el.filter is None or i in candidates:
                continue
            for a in ast.iter_attrs(el.filter):
                kept_base.add(f"{el.stream_id}.{a.name}")
        for pair in _cap_pairs(spec):
            if not config.lazy_projection:
                kept_base.add(spec.cap_src_key[pair])
                continue
            for pi, prs in enumerate(spec.proj_ref_pairs):
                if pair in prs and spec.proj_srcs[pi] != pair:
                    kept_base.add(spec.cap_src_key[pair])
                    break
        for i in candidates:
            he = spec.host_pred_fns[i]
            if not (set(he.refs) - kept_base):
                continue  # frees nothing: keep the device predicate
            key = f"@p:{i}"
            host_preds.append(HostPred(key, he.fn, he.refs))
            spec.pred_fns[i] = lambda env, k=key: env[k]
            pushed.append(i)
        artifact.pushed_preds = tuple(pushed)

    lazy_needed = None
    if config.lazy_projection:
        lazy_needed = apply_lazy_projection(
            artifact, skip_pred_elements=frozenset(pushed)
        )

    if not host_preds and lazy_needed is None:
        return None
    if lazy_needed is not None:
        needed = set(lazy_needed)
    else:
        needed = set()
        for i, el in enumerate(spec.elements):
            if el.filter is None or i in pushed:
                continue
            for a in ast.iter_attrs(el.filter):
                needed.add(f"{el.stream_id}.{a.name}")
        for pair in _cap_pairs(spec):
            needed.add(spec.cap_src_key[pair])
    return needed, tuple(host_preds)


# --------------------------------------------------------------------------
# Multi-query stacking: structurally identical chain queries advanced
# together on a leading query axis (the reference's one-runtime-per-plan
# fan-out re-expressed as a device query axis; SURVEY.md §2.7-(5),
# AbstractSiddhiOperator.java:112,301-313)
# --------------------------------------------------------------------------

# comparison operators a stacked element filter may use, by code
_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
_CMP_CODE = {op: i for i, op in enumerate(_CMP_OPS)}
_CMP_FNS = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)


def _template_conjuncts(el, column_types):
    """Flatten an element filter into <=2 ``attr OP literal`` conjuncts,
    sorted by column key: ``[(key, op code, literal)]``, or None when the
    filter does not fit that family."""
    conj: List = []
    stack = [el.filter]
    while stack:
        f = stack.pop()
        if isinstance(f, ast.Binary) and f.op == "and":
            stack.append(f.left)
            stack.append(f.right)
            continue
        if not isinstance(f, ast.Binary) or f.op not in _CMP_CODE:
            return None
        a, lit, op = f.left, f.right, f.op
        if isinstance(a, ast.Literal) and isinstance(lit, ast.Attr):
            # `5 < x` -> `x > 5`
            a, lit = lit, a
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if not (
            isinstance(a, ast.Attr)
            and a.qualifier in (None, el.alias, el.stream_id)
            and a.index is None
            and isinstance(lit, ast.Literal)
        ):
            return None
        key = f"{el.stream_id}.{a.name}"
        val = lit.value
        if column_types is not None:
            atype = column_types.get(key)
            if atype is None:
                return None
            if atype == AttributeType.STRING and op not in ("==", "!="):
                return None  # interned codes have no meaningful order
            if (
                np.dtype(atype.device_dtype).kind in "iu"
                and isinstance(val, float)
                and not float(val).is_integer()
            ):
                return None  # the literal would truncate in the column
        conj.append((key, _CMP_CODE[op], val))
    if len(conj) > 2:
        return None
    conj.sort(key=lambda c: c[0])  # deterministic key order
    return conj


def _stack_compact_width(E: int) -> int:
    """A stack's per-query relevance window: its members are selective by
    construction (structurally identical literal filters), so E // 16,
    tighter than the single chain's E // 8."""
    return max(2048, E // 16)


# a stack's emission buffer is min(Q, _STACK_OUT_CAP)*E + Q*pool wide:
# lossless for stacks of up to _STACK_OUT_CAP queries, bounded (with a
# drained overflow counter) beyond that
_STACK_OUT_CAP = 8


@dataclass
class StackedChainArtifact:
    """A group of chain patterns sharing one ``_ChainCfg``: their
    per-query predicates, captures and projections are stacked as data,
    and the chain core runs once over a leading query axis — the device op
    count per step does not grow with the number of queries, and each
    kernel launches once per step for all of them.

    Emissions of all members compact through one scatter into a single
    packed block with a query-id row; the host splits the rows back to
    each member's output stream at decode time."""

    name: str
    members: List[ChainPatternArtifact]
    output_mode: str = "packed"
    column_types: Optional[Dict] = None
    # host syncs this artifact made: the relevance-compaction branch reads
    # the members' largest relevant count when the tape's host-known bound
    # exceeds the compact width
    host_syncs: int = 0

    def __post_init__(self):
        self.pool = self.members[0].pool
        self._cfg = _ChainCfg.of(self.members[0].spec)
        assert all(
            _ChainCfg.of(m.spec) == self._cfg for m in self.members
        ), "stacked members must share a chain signature"
        self._vec_info = self._build_vec_preds()
        # per device: the members' windows and literals, uploaded once
        self._consts: Dict = {}

    def _build_vec_preds(self):
        """Per-element conjunct vectors for the broadcast predicate path:
        when every member's element-k filter flattens to the same ``attr
        OP literal`` conjunct keys (numeric literals), the Q*K closure
        evaluations collapse to a few (Q, E) broadcast compares. None =
        fall back to the members' closures."""
        specs = [m.spec for m in self.members]
        K = specs[0].n_elements
        info = []
        for k in range(K):
            el0 = specs[0].elements[k]
            if el0.negated or (el0.min_count, el0.max_count) != (1, 1):
                return None
            if specs[0].pred_fns[k] is None:
                if any(s.pred_fns[k] is not None for s in specs):
                    return None
                if any(s.elements[k].filter is not None for s in specs):
                    return None  # cross filters stay on the slot path
                info.append(())
                continue
            per_member = []
            for s in specs:
                el = s.elements[k]
                if el.filter is None:
                    return None
                conj = _template_conjuncts(el, self.column_types)
                if conj is None:
                    return None
                per_member.append(conj)
            n_conj = len(per_member[0])
            if any(len(c) != n_conj for c in per_member):
                return None
            conjs = []
            for j in range(n_conj):
                keys = {c[j][0] for c in per_member}
                if len(keys) != 1:
                    return None
                vals = [c[j][2] for c in per_member]
                if any(isinstance(v, (str, bool)) for v in vals):
                    return None  # interned/string literals: closure path
                # integer literals stay exact: float64 would corrupt
                # int64 values past 2^53
                vals_np = (
                    np.asarray(vals, np.int64)
                    if all(isinstance(v, int) for v in vals)
                    else np.asarray(vals, np.float64)
                )
                conjs.append((
                    next(iter(keys)),
                    np.asarray([c[j][1] for c in per_member], np.int32),
                    vals_np,
                ))
            info.append(tuple(conjs))
        return tuple(info)

    def _device_consts(self, device, dtypes) -> Dict:
        """The members' ``within`` and timed-absence windows (int32
        ``[Q]``) and, per conjunct of the broadcast path, its literals
        ``[Q, 1]`` in the column's dtype and each distinct opcode's member
        mask — on ``device``, built at the first step there and kept, so
        that no step copies them again."""
        key = (str(device), dtypes)
        consts = self._consts.get(key)
        if consts is not None:
            return consts
        consts = {
            "within": torch.tensor(
                [m.spec.within or 0 for m in self.members], dtype=_I32
            ).to(device),
            "tfor": torch.tensor(
                [m._tfor_ms() or 0 for m in self.members], dtype=_I32
            ).to(device),
        }
        for k, conjs in enumerate(self._vec_info or ()):
            for j, (_key, opcodes, vals) in enumerate(conjs):
                # the literal takes the column's dtype from the 32-bit
                # value JAX holds it in (int32 or float32, x64 off)
                lit = torch.from_numpy(vals.astype(
                    np.int32 if vals.dtype.kind == "i" else np.float32
                )).to(dtypes[k][j]).unsqueeze(1)
                opc = torch.from_numpy(opcodes).unsqueeze(1)
                consts[(k, j)] = (
                    lit.to(device),
                    {int(oc): (opc == oc).to(device)
                     for oc in sorted(set(opcodes.tolist()))},
                )
        self._consts[key] = consts
        return consts

    def _vec_preds(self, tape, enabled, consts):
        """(Q, K, E) element masks by broadcast compares."""
        spec0 = self.members[0].spec
        out = []
        for k, conjs in enumerate(self._vec_info):
            mk = (tape.valid & (tape.stream == spec0.stream_code_of[k]))
            mk = mk.unsqueeze(0)
            for j, (key, _opcodes, _vals) in enumerate(conjs):
                col = tape.cols[key].unsqueeze(0)
                lits, sel = consts[(k, j)]
                cm = None
                for oc, member_mask in sel.items():
                    m = _CMP_FNS[oc](col, lits)
                    cm = m if cm is None else torch.where(member_mask, m, cm)
                mk = mk & cm
            out.append(mk & enabled.unsqueeze(1))
        return torch.stack(out, 1)

    @property
    def output_schema(self) -> OutputSchema:
        # representative: members share the field structure; decode routes
        # rows to each member's own stream by the qid row
        return self.members[0].output_schema

    @property
    def acc_rows(self) -> int:
        return 2 + len(self.output_schema.fields)  # ts + qid + columns

    def emit_block_width(self, tape_capacity: int, state: Dict) -> int:
        q = len(self.members)
        return min(q, _STACK_OUT_CAP) * tape_capacity + q * self.pool

    compact_width = staticmethod(_stack_compact_width)

    def relevance(self) -> Tuple:
        """Per member, per element: (stream code, None, its ``col ==
        int literal`` conjuncts) — TapeSpec.relevance. The host's count of
        each literal in its column bounds the member's relevant events."""
        out = []
        for m in self.members:
            elements = []
            for k, el in enumerate(m.spec.elements):
                eqs = ()
                if el.filter is not None:
                    conj = _template_conjuncts(el, self.column_types) or ()
                    eqs = tuple(
                        (key, val) for key, op, val in conj
                        if op == _CMP_CODE["=="] and isinstance(val, int)
                        and not isinstance(val, bool)
                    )
                elements.append((m.spec.stream_code_of[k], None, eqs))
            out.append(tuple(elements))
        return tuple(out)

    def init_state(self, device) -> Dict:
        Q, P = len(self.members), self.pool
        state = {
            "enabled": torch.ones(Q, dtype=torch.bool, device=device),
            "active": torch.zeros((Q, P), dtype=torch.bool, device=device),
            "step": torch.ones((Q, P), dtype=_I32, device=device),
            "start": torch.zeros((Q, P), dtype=_I32, device=device),
            "done": torch.zeros(Q, dtype=torch.bool, device=device),
            "overflow": torch.zeros(Q, dtype=_I32, device=device),
        }
        if self._cfg.t_guard is not None:
            state["emit_ts"] = torch.zeros((Q, P), dtype=_I32, device=device)
        spec0 = self.members[0].spec
        for pair in _cap_pairs(spec0):
            state[_skey("cap", *pair)] = torch.zeros(
                (Q, P), dtype=torch_dtype(spec0.cap_dtype[pair]),
                device=device,
            )
        return state

    def _emit_pack(self, new_state, complete, emit_ts, caps, E: int):
        """Pack every member's completions into one fixed-width block of
        rows (ts, qid, columns...), query-major: completions past the block
        width ``min(Q, _STACK_OUT_CAP)*E + Q*P`` drop, counted in the
        third element."""
        Q, P = len(self.members), self.pool
        dev = complete.device
        V_ = int(complete.shape[1])
        qid_row = torch.arange(Q, dtype=_I32, device=dev).unsqueeze(1)
        # when every member's column c is the same plain capture, the
        # stacked capture buffers ARE the output rows
        col_srcs = []
        for c in range(len(self.members[0].spec.proj_fns)):
            srcs = {m.spec.proj_srcs[c] for m in self.members}
            if len(srcs) != 1 or None in srcs:
                col_srcs = None
                break
            col_srcs.append(next(iter(srcs)))
        if col_srcs is not None:
            rows = torch.stack(
                [as_i32(emit_ts), qid_row.expand(Q, V_)]
                + [as_i32(caps[pair]) for pair in col_srcs]
            )  # (R, Q, V_)
        else:
            per_q = []
            for qi, m in enumerate(self.members):
                env = _emit_env(m.spec, {
                    (e, c, w): caps[(e, c)][qi] for e, c, w in m.spec.captures
                })
                per_q.append(torch.stack(
                    [as_i32(emit_ts[qi]), qid_row[qi].expand(V_)]
                    + [as_i32(as_column(p(env), V_, emit_ts))
                       for p in m.spec.proj_fns]
                ))
            rows = torch.stack(per_q, 1)  # (R, Q, V_)
        R = int(rows.shape[0])
        flat = rows.reshape(R, Q * V_)
        cflat = complete.reshape(Q * V_)
        n_total = cflat.sum(dtype=_I32)
        out_w = min(Q * (P + E), min(Q, _STACK_OUT_CAP) * E + Q * P)
        pos = torch.cumsum(cflat, 0, dtype=_I32) - 1
        dest = torch.where(cflat & (pos < out_w), pos, out_w).long()
        packed = torch.zeros((R, out_w + 1), dtype=_I32, device=dev)
        packed.scatter_(1, dest.unsqueeze(0).expand(R, Q * V_), flat)
        n_emitted = torch.clamp(n_total, max=out_w)
        # completions beyond the emission buffer are dropped; the third
        # element feeds the drained overflow counter
        return new_state, (n_emitted, packed[:, :out_w], n_total - n_emitted)

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        cfg = self._cfg
        E = tape.capacity
        P = self.pool
        Q = len(self.members)
        dtypes = tuple(
            tuple(tape.cols[key].dtype for key, _o, _v in conjs)
            for conjs in (self._vec_info or ())
        )
        consts = self._device_consts(tape.ts.device, dtypes)
        if self._vec_info is not None:
            preds = self._vec_preds(tape, state["enabled"], consts)
        else:
            preds = torch.stack([
                torch.stack(_element_preds(m.spec, tape, state["enabled"][qi]))
                for qi, m in enumerate(self.members)
            ])  # (Q, K, E)
        cap_srcs = {}
        for pair in cfg.pairs:
            keys = [m.spec.cap_src_key[pair] for m in self.members]
            cap_srcs[pair] = (
                tape.cols[keys[0]].expand(Q, E) if len(set(keys)) == 1
                else torch.stack([tape.cols[k] for k in keys])
            )
        # within/absence horizons always see the full batch (the
        # compacted path's ts only covers each query's relevant events)
        bm_full = torch.where(tape.valid, tape.ts, -_BIG).max()

        def run(ts, valid, preds_q, srcs):
            st, complete, emit_ts, caps = _chain_core(
                cfg, P, state, preds_q, srcs, consts["within"], ts, valid,
                tfor_val=consts["tfor"], batch_max=bm_full,
            )
            return self._emit_pack(st, complete, emit_ts, caps, E)

        # Per-query relevance compaction ('->' ignores events that match
        # none of the query's elements): each query advances over its own
        # compacted window; the tape's bound is the largest member's.
        compacted = None
        if E >= _COMPACT_MIN_E:
            Rw = _stack_compact_width(E)
            compacted = _compaction(
                self, tape, preds.any(1) & tape.valid.unsqueeze(0), Rw
            )
        if compacted is not None:
            idxs, cvalid = compacted
            il = idxs.long()
            return run(
                tape.ts[il],
                cvalid,
                torch.gather(preds, 2, il.unsqueeze(1).expand(
                    Q, int(preds.shape[1]), Rw
                )) & cvalid.unsqueeze(1),
                {p_: torch.gather(s_, 1, il) for p_, s_ in cap_srcs.items()},
            )
        return run(tape.ts.expand(Q, E), tape.valid.expand(Q, E), preds,
                   cap_srcs)

    def decode_packed(self, n: int, block: np.ndarray):
        """Split a fetched packed block into per-member (schema, rows)."""
        return _decode_qid_block(
            n, block,
            ((qi, m.output_schema) for qi, m in enumerate(self.members)),
        )

    @property
    def flush_is_noop(self) -> bool:
        return self._cfg.t_guard is None

    def flush(self, state: Dict) -> Tuple[Dict, Tuple]:
        """Timed-absence maturation at end of stream, per member query."""
        Q, P = len(self.members), self.pool
        C = len(self.members[0].spec.proj_fns)
        dev = state["active"].device
        if self._cfg.t_guard is None:
            return state, (
                torch.tensor(0, dtype=_I32, device=dev),
                torch.zeros((2 + C, 1), dtype=_I32, device=dev),
                torch.tensor(0, dtype=_I32, device=dev),
            )
        blocks, keep, active = [], [], []
        for qi, m in enumerate(self.members):
            sub = {k: v[qi] for k, v in state.items()}
            st_q, (n_q, packed_q) = m.flush(sub)
            active.append(st_q["active"])
            qid = torch.full((1, P), qi, dtype=_I32, device=dev)
            blocks.append(torch.cat([packed_q[:1], qid, packed_q[1:]]))
            keep.append(torch.arange(P, device=dev) < n_q)
        new_state = dict(state)
        new_state["active"] = torch.stack(active)
        # each member's block is front-compacted and zero past its count:
        # side by side, then compacted once
        block = torch.cat(blocks, 1)  # (2 + C, Q * P)
        kept = torch.cat(keep)
        n_total = kept.sum(dtype=_I32)
        pos = torch.cumsum(kept, 0, dtype=_I32) - 1
        dest = torch.where(kept, pos, Q * P).long()
        packed = torch.zeros((2 + C, Q * P + 1), dtype=_I32, device=dev)
        packed.scatter_(1, dest.unsqueeze(0).expand(2 + C, Q * P), block)
        return new_state, (
            n_total, packed[:, :Q * P], torch.tensor(0, dtype=_I32,
                                                     device=dev),
        )


def _decode_qid_block(n: int, block, slot_schemas):
    """Split a packed (ts, qid, cols...) block by the qid row into
    per-slot (schema, rows) lists. ``slot_schemas``: iterable of (slot,
    OutputSchema)."""
    out = []
    qid = block[1, :n]
    for slot, schema in slot_schemas:
        sel = np.nonzero(qid == slot)[0]
        if sel.size == 0:
            continue
        sub = block[:, :n][:, sel]
        out.append(
            (schema, schema.decode_packed_block(
                int(sel.size), sub, data_row=2
            ))
        )
    return out


def group_chain_artifacts(
    artifacts: List, exclude=frozenset(), column_types=None
) -> List:
    """Replace runs of structurally identical ChainPatternArtifacts (one
    ``_ChainCfg``, pool and output dtypes) with one StackedChainArtifact,
    named ``"@stack:" + its first member``, in the first member's place.
    Artifacts in ``exclude`` stay standalone. ``column_types`` enables the
    broadcast predicate path."""
    groups: Dict = {}
    for a in artifacts:
        if isinstance(a, ChainPatternArtifact) and a.name not in exclude:
            key = (
                _ChainCfg.of(a.spec),
                a.pool,
                tuple(
                    np.dtype(f.atype.device_dtype).name
                    for f in a.output_schema.fields
                ),
            )
            groups.setdefault(key, []).append(a)
    stacked_of = {}
    for members in groups.values():
        if len(members) >= 2:
            stacked = StackedChainArtifact(
                name="@stack:" + members[0].name,
                members=members,
                column_types=column_types,
            )
            for m in members:
                stacked_of[m.name] = stacked
    if not stacked_of:
        return artifacts
    out, added = [], set()
    for a in artifacts:
        s = stacked_of.get(getattr(a, "name", None))
        if s is None:
            out.append(a)
        elif s.name not in added:
            out.append(s)
            added.add(s.name)
    return out


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def compile_pattern_query(
    q: ast.Query,
    name: str,
    schemas,
    stream_codes: Dict[str, int],
    extensions,
    config=None,
) -> ChainPatternArtifact:
    from .config import DEFAULT_CONFIG

    config = config or DEFAULT_CONFIG
    spec = _build_spec(q, schemas, stream_codes, extensions)
    return ChainPatternArtifact(
        name=name,
        spec=spec,
        output_schema=OutputSchema(spec.output_stream, spec.out_fields),
        pool=config.pattern_pool,
    )
