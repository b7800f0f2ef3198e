"""Chain pattern queries compiled to a dense, batch-parallel matcher.

The torch port of the chain matcher of ``flink_siddhi_tpu/compiler/nfa.py``
— ``[every] e0 -> e1 -> ... -> eK`` where every element is a plain (1,1)
occurrence, with mid-chain absence guards (``A -> not B -> C``), terminal
timed absence (``A -> not B for t``) and ``within``. Per-element predicates
are evaluated once for the whole batch; "next match at/after position p"
becomes a reverse cummin per element (the ``multi_reverse_cummin`` kernel);
every partial match then advances through the whole chain in one pass (the
``chain_advance`` kernel) — no per-event loop at all. Partial matches that
outlive the batch carry in a fixed pool of slots.

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
)
from .output import OutputField, OutputSchema

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
    for i, el in enumerate(inp.elements):
        schema = schemas[el.stream_id]
        if el.filter is None:
            pred_fns.append(None)
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
    if q.selector.is_star:
        raise SiddhiQLError(
            "select * is not valid for pattern queries; name the captures"
        )
    proj_fns, out_fields = [], []
    for item in q.selector.items:
        if ast.contains_aggregate(item.expr):
            raise SiddhiQLError(
                "aggregations over pattern matches are not supported"
            )
        ce = compile_expr(item.expr, cap_resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(OutputField(item.output_name(), ce.atype, ce.table))
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
    """Scatter-compact the True positions of ``rel`` (bool[E]) into an
    ascending index buffer of width R. Returns (idx, cnt, cvalid);
    positions beyond R land in a dump slot that is sliced off (callers
    branch on cnt <= R)."""
    E = int(rel.shape[0])
    dev = rel.device
    cnt = rel.sum(dtype=_I32)
    cpos = torch.cumsum(rel, 0, dtype=_I32) - 1
    dest = torch.where(rel & (cpos < R), cpos, R).long()
    idx = torch.zeros(R + 1, dtype=_I32, device=dev)
    idx.scatter_(0, dest, torch.arange(E, dtype=_I32, device=dev))
    cvalid = torch.arange(R, dtype=_I32, device=dev) < torch.clamp(cnt, max=R)
    return idx[:R], cnt, cvalid


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
    state: Dict,
    preds: torch.Tensor,  # bool[n_elements, E] — positive AND guard rows,
    # by ORIGINAL element index (cfg.K counts positive elements only)
    cap_srcs: Dict,  # pair -> value[E]
    within_val: int,  # ignored unless cfg.has_within
    ts: torch.Tensor,  # int32[E]
    valid: torch.Tensor,  # bool[E]
    tfor_val: int = 0,  # the timed-absence window (cfg.t_guard set)
    batch_max: Optional[torch.Tensor] = None,  # int32 scalar: max valid
    # ts of the FULL batch (a relevance-compacted caller passes it so
    # within-expiry and absence deadlines still see the whole batch's
    # time horizon)
):
    """One micro-batch of the chain matcher for ONE query: advance carried
    partials + fresh starts through all elements, find completions, and
    compact survivors back into the pool. The two kernels run here: the
    next-match tables (``multi_reverse_cummin``) and the advance
    (``chain_advance``); capture and emit-ts gathers replay off the
    advance's per-step match positions.

    Returns (new_state, complete[V], emit_ts[V], caps{pair: [V]}).
    """
    K = cfg.K
    E = int(ts.shape[0])
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

    # nxt[row][p] = min q >= p with preds[e][q], else E, one row per
    # element the advance reads (positive targets, then guards, then the
    # timed-absence guard); column E reads "no match" (the kernel's pad)
    scan_rows = list(positive[1:]) + [g for gs in guards for g in gs]
    if cfg.t_guard is not None:
        scan_rows.append(cfg.t_guard)
    row_of = {e: r for r, e in enumerate(scan_rows)}
    nxt = None
    if scan_rows:
        idxs = torch.stack(
            [torch.where(preds[e], arange, E) for e in scan_rows]
        )
        nxt = multi_reverse_cummin(idxs, pad=E)
    ts_pad = torch.cat([ts, torch.zeros(1, dtype=_I32, device=dev)])
    env_pad = {
        pair: torch.cat(
            [cap_srcs[pair],
             torch.zeros(1, dtype=cap_srcs[pair].dtype, device=dev)]
        )
        for pair in pairs
    }

    # fresh starts: one candidate per tape position matching element 0
    starts = preds[0]
    if not cfg.every:
        starts = starts & ~state["done"]
    v_active = torch.cat([state["active"], starts])
    v_step = torch.cat(
        [state["step"], torch.ones(E, dtype=_I32, device=dev)]
    )
    # search position: carried partials resume at batch start
    v_pos = torch.cat([torch.zeros(P, dtype=_I32, device=dev), arange + 1])
    v_start = torch.cat([state["start"], ts])
    # fresh starts already completed element 0 at their own position, so a
    # single-element pattern (K == 1) emits at the start event's ts; K > 1
    # overwrites this on the final advance. With a terminal timed absence
    # the pool carries emit_ts (the waiting deadline's base) across batches.
    carried_emit = (
        state["emit_ts"]
        if cfg.t_guard is not None
        else torch.zeros(P, dtype=_I32, device=dev)
    )
    v_emit_ts = torch.cat([carried_emit, ts])
    caps = {}
    for pair in pairs:
        elem, _col = pair
        fresh = (
            cap_srcs[pair]
            if elem == 0
            else torch.zeros(E, dtype=cap_dtypes[pair], device=dev)
        )
        caps[pair] = torch.cat([state[_skey("cap", *pair)], fresh])

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
            jk = jmat[k - 1]
            found = jk < E
            jl = jk.long()
            for pair in pairs:
                if pair[0] == elem:
                    caps[pair] = torch.where(
                        found, env_pad[pair][jl], caps[pair]
                    )
            if k == K - 1:
                v_emit_ts = torch.where(found, ts_pad[jl], v_emit_ts)

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
        jg = nxt[row_of[cfg.t_guard]][
            torch.maximum(v_pos, past_emit).clamp(0, E).long()
        ]
        guard_hit = waiting & (jg < E) & (ts_pad[jg.long()] <= deadline)
        matured = waiting & ~guard_hit & (deadline <= batch_max)
        complete = matured
        v_emit_ts = torch.where(matured, deadline, v_emit_ts)
        still_waiting = waiting & ~guard_hit & ~matured
    else:
        complete = v_active & (v_step == K)
    if not cfg.every:
        # exactly one match: earliest start, then earliest completion
        # (argmin takes the first minimum, as jnp.argmin does)
        start_key = torch.where(complete, v_start, _BIG)
        min_start = start_key.min()
        emit_key = torch.where(
            complete & (v_start == min_start), v_emit_ts, _BIG
        )
        winner = torch.argmin(emit_key)
        one = torch.arange(V, device=dev) == winner
        complete = complete & one & ~state["done"]
        new_done = state["done"] | complete.any()
        if still_waiting is not None:
            # the single match is taken: waiting partials are void
            still_waiting = still_waiting & ~new_done
    else:
        new_done = state["done"]

    # survivors -> new pool: one scatter over a stacked (state-row, V)
    # matrix. The v ordering (carried pool first, then fresh starts in
    # tape order) is oldest-start-first for time-ordered batches, so on
    # overflow the newest partials drop (into the dump column P).
    survive = v_active & (v_step < K)
    if cfg.has_within:
        survive = survive & ((batch_max - v_start) <= within_val)
    if still_waiting is not None:
        survive = survive | still_waiting
    keep_pos = torch.cumsum(survive, 0, dtype=_I32) - 1
    pool_dest = torch.where(survive & (keep_pos < P), keep_pos, P).long()
    n_survive = survive.sum(dtype=_I32)

    fixed_rows = [as_i32(survive), v_step, v_start]
    if cfg.t_guard is not None:
        fixed_rows.append(v_emit_ts)
    n_fixed = len(fixed_rows)
    pool_rows = torch.stack(
        fixed_rows + [as_i32(caps[pair]) for pair in pairs]
    )
    n_rows = int(pool_rows.shape[0])
    pool_packed = torch.zeros((n_rows, P + 1), dtype=_I32, device=dev)
    pool_packed[1].fill_(1)  # free slots hold step 1
    pool_packed.scatter_(
        1, pool_dest.unsqueeze(0).expand(n_rows, V), pool_rows
    )
    pool_packed = pool_packed[:, :P]
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
    # 'packed': step returns (n, (1+C, V) int32 block) — ts row 0, one
    # bitcast row per projection — the accumulator append layout
    output_mode: str = "packed"
    pool: int = DEFAULT_PARTIAL_POOL
    # host syncs this artifact made: the relevance-compaction branch
    # reads its relevant-event count once per micro-batch
    host_syncs: int = 0

    def emit_block_width(self, tape_capacity: int) -> int:
        """Widest per-cycle emission block (drain-cadence contract)."""
        return tape_capacity + self.pool

    @property
    def acc_rows(self) -> int:
        return 1 + len(self.spec.proj_fns)

    def _emit_block(self, emit_ts, emit_env, width: int) -> torch.Tensor:
        """Stack the emission rows: [ts, one bitcast row per projection]."""
        out = [as_i32(emit_ts)]
        for p in self.spec.proj_fns:
            out.append(as_i32(as_column(p(emit_env), width, emit_ts)))
        return torch.stack(out)

    def _tfor_ms(self) -> Optional[int]:
        last = self.spec.elements[-1]
        return last.absent_for if last.negated else None

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
        for pair in _cap_pairs(self.spec):
            state[_skey("cap", *pair)] = torch.zeros(
                P, dtype=torch_dtype(self.spec.cap_dtype[pair]),
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
        cap_srcs = {
            pair: tape.cols[spec.cap_src_key[pair]] for pair in pairs
        }
        within_val = spec.within if spec.within is not None else 0
        tfor_val = self._tfor_ms() or 0
        cfg = _ChainCfg.of(spec)
        # within-expiry / absence deadlines always see the full batch's
        # time horizon, even on the relevance-compacted path
        bm_full = torch.where(tape.valid, tape.ts, -_BIG).max()

        def run(ts, valid, preds_m, srcs):
            """Core + emission packing; the packed block is padded to the
            full (1+C, P+E) accumulator layout so the compacted and full
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
        # more than E//8 events are relevant. The branch reads the count
        # on the host: one sync per micro-batch, counted in host_syncs.
        if E >= _COMPACT_MIN_E:
            R = _compact_width(E)
            rel = preds.any(dim=0) & tape.valid
            idx, cnt, cvalid = _compact_index(rel, R)
            self.host_syncs += 1
            if int(cnt) <= R:
                il = idx.long()
                st, n_matches, packed = run(
                    tape.ts[il],
                    cvalid,
                    preds[:, il] & cvalid.unsqueeze(0),
                    {p_: s_[il] for p_, s_ in cap_srcs.items()},
                )
                return st, (n_matches, packed)
        st, n_matches, packed = run(tape.ts, tape.valid, preds, cap_srcs)
        return st, (n_matches, packed)

    def decode_packed(self, n: int, block: np.ndarray):
        schema = self.output_schema
        return [(schema, schema.decode_packed_block(n, block))]

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
