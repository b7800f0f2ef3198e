"""Windowed two-stream joins, their pairs enumerated by one kernel (K5).

Reference surface: windowed joins with ``on`` conditions
(SiddhiCEPITCase.java:306-327, 413-439 — ``from A#window.length(5) join
B#window.time(500) on a.x == b.y``), which siddhi-core evaluates per arriving
event against the opposite window's buffered events.

Device shape (the reference's, ``flink_siddhi_tpu/compiler/join.py``): each
side keeps a ring of its last C matching events (the columns the join and
its projections read, carried across micro-batches). Per micro-batch each
side's matching events are compacted (stably, in tape order) behind its
ring: the side's combined buffer, entry j holding global ordinal
``seen - C + j``. An arriving event meets the other side's combined buffer
as of its arrival: window membership by ordinal bounds (length windows) or
timestamp bounds (time windows), ``within``, and the ``on`` condition. Every
ordered pair is emitted once, by whichever event arrives later.

The reference materializes each direction's (E, C + E) pair mask and sorts
it; here K5 (``cuda_ops.join_pairs``, ``csrc/join_pairs.cu``) enumerates
exactly the pairs that mask holds, in its order (direction, then arriving
tape position, then combined entry; each direction's unmatched outer rows
after its pairs), cut at ``out_factor * E``. The ``on`` condition is a
postfix program (``slot_program.py``; the arriving event's columns are its
event loads, the other side's combined columns its second load kind), run
by the interpreter K4 shares. The projections are torch ops over the pair
list: the arriving side's columns gathered at i, the other side's at j.

Outer joins emit the arriving event with the missing side's columns
zero-filled on the device and decoded as None (a trailing missing-side
row: 1 = right missing, 2 = left missing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.types import AttributeType
from . import cuda_ops
from .expr import (ColumnEnv, ExprResolver, ResolvedAttr, _dt, as_column,
                   compile_expr)
from .output import OutputField, OutputSchema
from .slot_program import OnProgram, compile_on
from .window import _window_of

_I32 = torch.int32


class _JoinResolver:
    """Side-qualified attribute resolution for join pair expressions.

    Every reference resolves to an env key unique to its SIDE
    (``l:S.x`` / ``r:S.x``) so self-joins (`from S as a join S as b`)
    can tell ``a.x`` from ``b.x``; ``used`` records each env key's
    (side tag, tape column key, type) for ring buffering."""

    def __init__(self, left_si, right_si, schemas) -> None:
        self._by_ref: Dict[str, Tuple[str, str, object]] = {}
        for tag, si in (("l", left_si), ("r", right_si)):
            if si.ref_name in self._by_ref:
                raise SiddhiQLError(
                    "self-join sides need distinct aliases: "
                    f"'from {si.stream_id} as a join {si.stream_id} as b'"
                )
            self._by_ref[si.ref_name] = (
                tag, si.stream_id, schemas[si.stream_id]
            )
        # stream-id qualifiers are allowed when exactly one side uses
        # that stream (and the id is not already a ref name)
        by_sid: Dict[str, List] = {}
        for ent in self._by_ref.values():
            by_sid.setdefault(ent[1], []).append(ent)
        for sid, ents in by_sid.items():
            if sid not in self._by_ref and len(ents) == 1:
                self._by_ref[sid] = ents[0]
        self.used: Dict[str, Tuple[str, str, AttributeType]] = {}

    def resolve(self, attr: ast.Attr) -> ResolvedAttr:
        if attr.index is not None:
            raise SiddhiQLError(
                "indexed references are not valid in join expressions"
            )
        if attr.qualifier is not None:
            ent = self._by_ref.get(attr.qualifier)
            if ent is None:
                raise SiddhiQLError(
                    f"unknown stream reference {attr.qualifier!r}"
                )
            hits = [ent]
        else:
            seen = set()
            hits = []
            for ref, ent in self._by_ref.items():
                if ent[0] in seen:
                    continue
                if attr.name in ent[2]:
                    seen.add(ent[0])
                    hits.append(ent)
            if not hits:
                raise SiddhiQLError(f"unknown attribute {attr.name!r}")
            if len(hits) > 1:
                raise SiddhiQLError(
                    f"ambiguous attribute {attr.name!r}; qualify it with "
                    "a stream alias"
                )
        tag, sid, schema = hits[0]
        if attr.name not in schema:
            raise SiddhiQLError(
                f"stream {sid!r} has no attribute {attr.name!r}"
            )
        atype = schema.field_type(attr.name)
        key = f"{tag}:{sid}.{attr.name}"
        self.used[key] = (tag, f"{sid}.{attr.name}", atype)
        return ResolvedAttr(
            key, atype, schema.string_tables.get(attr.name)
        )

    def tags(self, expr) -> set:
        """The side tags ``expr``'s attributes read."""
        return {self.resolve(a).key[0] for a in ast.iter_attrs(expr)
                if not a.name.startswith("@")}


@dataclass
class _Side:
    stream_id: str
    ref: str
    stream_code: int
    filter_fns: List[Callable]
    window_mode: str  # 'length' | 'time'
    window_n: int  # length bound (ring capacity for time/unbounded)
    time_ms: Optional[int]
    # (env_key, tape_key) buffered in this side's ring — env keys are
    # side-prefixed so a self-join's two rings stay distinct
    cols: List[Tuple[str, str]]
    col_types: List[AttributeType]
    outer: bool  # emit this side's unmatched arrivals
    # no window clause declared: retention is semantically unbounded
    # and only truncated by the ring
    unbounded: bool = False


@dataclass
class JoinArtifact:
    name: str
    output_schema: OutputSchema
    left: _Side
    right: _Side
    on_progs: Optional[Dict[str, OnProgram]]  # arriving tag -> program
    # derived columns (an `on` call over one side): key -> (side, fn)
    derived: Dict[str, Tuple[str, Callable]]
    within: Optional[int]
    proj_fns: List[Callable]
    # per projection: the side tags ('l'/'r') it references — outer-join
    # rows decode None for projections over the missing side
    proj_tags: Tuple[frozenset, ...] = ()
    output_mode: str = "buffered"
    out_factor: int = 4
    encoded_columns: Tuple = ()

    # cost_info (the admission descriptor) waits for ROADMAP Queue 1 item
    # 12 (the port's analysis layer)

    def emit_block_width(self, tape_capacity: int, state: Dict) -> int:
        """Widest per-cycle emission block (drain-cadence contract)."""
        return self.out_factor * tape_capacity

    @property
    def _nullable(self) -> bool:
        return self.left.outer or self.right.outer

    @property
    def acc_rows(self) -> int:
        return (
            1
            + len(self.output_schema.fields)
            + (1 if self._nullable else 0)
        )

    def decode_packed(self, n: int, block: "np.ndarray"):
        """Accumulator block -> rows; outer joins carry a trailing
        missing-side row (0 = pair, 1 = right missing, 2 = left missing)
        nullifying projections over the absent side (Siddhi null, not a
        zero-filled value)."""
        schema = self.output_schema
        C = len(schema.fields)
        if not self._nullable:
            return [(schema, schema.decode_packed_block(n, block))]
        from .output import emission_order

        # the missing-side row must follow decode's row permutation
        missing = np.asarray(block[1 + C, :n])[emission_order(block[0], n)]
        rows = schema.decode_packed_block(n, block[: 1 + C])
        out = []
        for i, (ts_v, row) in enumerate(rows):
            m = int(missing[i])
            if m:
                gone = "r" if m == 1 else "l"
                row = tuple(
                    None if gone in tags else v
                    for v, tags in zip(row, self.proj_tags)
                )
            out.append((ts_v, row))
        return [(schema, out)]

    def decode_packed_columns(self, n: int, block: "np.ndarray",
                              lookup_np=None):
        """Columnar twin of :meth:`decode_packed` (the same rows and
        order): typed columns, or for an outer join object columns that
        hold None for the missing side."""
        from .output import ColumnBatch

        schema = self.output_schema
        if not self._nullable:
            return [(schema, schema.decode_packed_columns(n, block))]
        (_, rows), = self.decode_packed(n, block)
        cols = {}
        for i, f in enumerate(schema.fields):
            c = np.empty(len(rows), dtype=object)
            c[:] = [r[1][i] for r in rows]
            cols[f.name] = c
        ts = np.fromiter((r[0] for r in rows), np.int64, len(rows))
        return [(schema, ColumnBatch(ts, cols))]

    def init_state(self, device) -> Dict:
        st = {"enabled": torch.tensor(True, device=device),
              "overflow": torch.tensor(0, dtype=_I32, device=device)}
        for tag, side in (("l", self.left), ("r", self.right)):
            C = side.window_n
            st[f"{tag}_valid"] = torch.zeros(C, dtype=torch.bool,
                                             device=device)
            st[f"{tag}_ts"] = torch.zeros(C, dtype=_I32, device=device)
            st[f"{tag}_seen"] = torch.tensor(0, dtype=_I32, device=device)
            for j, t in enumerate(side.col_types):
                st[f"{tag}_c{j}"] = torch.zeros(C, dtype=_dt(t),
                                                device=device)
        return st

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        E = tape.capacity
        dev = tape.ts.device
        ar = torch.arange(E, dtype=_I32, device=dev)

        sides = {}
        for tag, side in (("l", self.left), ("r", self.right)):
            mask = tape.valid & (tape.stream == side.stream_code)
            for f in side.filter_fns:
                mask = mask & f(env)
            mask = mask & state["enabled"]
            C = side.window_n
            # the stable compaction (jnp.argsort(~mask)): the side's
            # events in tape order, then the rest in tape order
            incl = torch.cumsum(mask, 0, dtype=_I32)
            M = incl[-1]
            dest = torch.where(mask, incl - 1, M + ar - incl).long()
            order = torch.empty(E, dtype=torch.long, device=dev)
            order.scatter_(0, dest, ar.long())
            carry = state[f"{tag}_seen"]
            comb = {
                env_key: torch.cat([
                    state[f"{tag}_c{j}"],
                    env[tape_key][order].to(state[f"{tag}_c{j}"].dtype),
                ])
                for j, (env_key, tape_key) in enumerate(side.cols)
            }
            ts_comb = torch.cat([state[f"{tag}_ts"], tape.ts[order]])
            valid_comb = torch.cat([state[f"{tag}_valid"], ar < M])
            sides[tag] = dict(
                side=side, mask=mask, M=M, comb=comb, ts=ts_comb,
                valid=valid_comb, carry=carry, cum=carry + incl,
                # tape position of each in-batch combined entry (-1 for
                # carried ring entries): identifies THE SAME event across
                # a self-join's two sides regardless of per-side filters
                posid=torch.cat([torch.full((C,), -1, dtype=_I32,
                                            device=dev), order.to(_I32)]),
            )

        # derived columns (an `on` call over one side), over the tape for
        # the arriving side and over the combined buffer for the other
        a_env: Dict[str, Dict[str, torch.Tensor]] = {}
        b_env: Dict[str, Dict[str, torch.Tensor]] = {}
        for tag in ("l", "r"):
            s = sides[tag]
            a_env[tag] = {ek: env[tk] for ek, tk in s["side"].cols}
            b_env[tag] = dict(s["comb"])
        for key, (tag, fn) in self.derived.items():
            a_env[tag][key] = as_column(fn(a_env[tag]), E, tape.ts)
            nb = int(sides[tag]["ts"].shape[0])
            b_env[tag][key] = as_column(fn(b_env[tag]), nb, tape.ts)

        dirs = []
        for atag, btag in (("l", "r"), ("r", "l")):
            a, b = sides[atag], sides[btag]
            bside: _Side = b["side"]
            prog = (self.on_progs or {}).get(atag)
            if prog is not None:
                a_cols = _words(a_env[atag], prog.evt_keys, E, dev)
                b_cols = _words(b_env[btag], prog.cap_keys,
                                int(b["ts"].shape[0]), dev)
            else:
                a_cols = torch.zeros((0, E), dtype=_I32, device=dev)
                b_cols = torch.zeros((0, int(b["ts"].shape[0])),
                                     dtype=_I32, device=dev)
            dirs.append(cuda_ops.JoinDir(
                a_mask=a["mask"], a_cols=a_cols, b_ts=b["ts"],
                b_valid=b["valid"], b_posid=b["posid"],
                b_cum=b["cum"], b_seen=b["carry"].reshape(1),
                b_cols=b_cols,
                prog=prog.code if prog is not None else (),
                depth=prog.depth if prog is not None else 0,
                mode_time=bside.window_mode == "time",
                n=bside.window_n, span=int(bside.time_ms or 0),
                C=bside.window_n, outer=a["side"].outer,
            ))
        cap = self.out_factor * E
        self_join = self.left.stream_code == self.right.stream_code
        pi, pj, pseg, n = cuda_ops.join_pairs(
            dirs, tape.ts, cap, self_join, self.within)
        pi, pj = pi.long(), pj.long()

        # the pair rows' env: per side, its columns from the tape at i
        # when it arrived (segments of its direction), from its combined
        # buffer at j when it was met, zeros when it is missing
        first = pseg < 2  # direction l -> r: l arrived
        row_env: ColumnEnv = {}
        for tag in ("l", "r"):
            arrived = first if tag == "l" else ~first
            met = pseg == (2 if tag == "l" else 0)
            for env_key, tape_key in sides[tag]["side"].cols:
                at_i = env[tape_key][pi]
                at_j = sides[tag]["comb"][env_key][pj].to(at_i.dtype)
                row_env[env_key] = torch.where(
                    arrived, at_i,
                    torch.where(met, at_j, torch.zeros_like(at_i)))
        ts_rows = tape.ts[pi]
        cols = tuple(as_column(p(row_env), cap, tape.ts)
                     for p in self.proj_fns)
        if self._nullable:
            # missing-side marker: 1 = right side absent, 2 = left absent
            missing = torch.where(pseg == 1, 1, torch.where(pseg == 3, 2, 0))
            cols = cols + (missing.to(_I32),)

        new_state = dict(state)
        new_state["overflow"] = state["overflow"] + torch.clamp(
            n[0] - cap, min=0)
        for tag in ("l", "r"):
            s = sides[tag]
            C = s["side"].window_n
            keep = s["M"] + torch.arange(C, device=dev)
            for j, (env_key, _tk) in enumerate(s["side"].cols):
                new_state[f"{tag}_c{j}"] = s["comb"][env_key][keep]
            new_state[f"{tag}_ts"] = s["ts"][keep]
            new_state[f"{tag}_valid"] = s["valid"][keep]
            new_state[f"{tag}_seen"] = state[f"{tag}_seen"] + s["M"]
        return new_state, (torch.clamp(n[0], max=cap), ts_rows, cols)


def _words(envd: Dict[str, torch.Tensor], keys, width: int,
           dev) -> torch.Tensor:
    """The columns ``keys`` of ``envd`` as int32 words ``[len(keys),
    width]`` (float32 by bit pattern, the program's values)."""
    if not keys:
        return torch.zeros((0, width), dtype=_I32, device=dev)
    rows = []
    for k in keys:
        v = envd[k]
        rows.append(v.view(_I32) if v.dtype == torch.float32
                    else v.to(_I32))
    return torch.stack(rows)


def _later_call(call: ast.Call) -> SiddhiQLError:
    return SiddhiQLError(
        f"the function {call.full_name!r} over both sides of a join's 'on' "
        "condition is not in the torch port's join program (ROADMAP.md "
        "Queue 1 item 8): a registered function is a torch function over "
        "a batch and cannot run per pair inside the pair step; the JAX "
        "package flink_siddhi_tpu runs it"
    )


def _compile_on(on, resolver: _JoinResolver, extensions):
    """The ``on`` condition as one program per direction (arriving tag ->
    ``OnProgram``) and its derived columns (a call over one side)."""
    return compile_on(on, resolver, extensions, ("l", "r"), resolver.tags,
                      lambda key: key.split(":", 1)[0],
                      lambda tag, n: f"{tag}:@fn{n}", _later_call)


def compile_join_query(
    q: ast.Query,
    name: str,
    schemas,
    stream_codes: Dict[str, int],
    extensions,
    config=None,
):
    from .config import DEFAULT_CONFIG

    config = config or DEFAULT_CONFIG
    inp = q.input
    assert isinstance(inp, ast.JoinInput)
    li, ri = inp.left, inp.right
    # self-joins are supported: the resolver side-prefixes env keys so
    # `from S as a join S as b on a.x == b.y` keeps the sides distinct
    resolver = _JoinResolver(li, ri, schemas)

    def side_of(si: ast.StreamInput, outer: bool) -> _Side:
        sres = ExprResolver(
            {si.ref_name: (si.stream_id, schemas[si.stream_id])},
            default_scope=si.ref_name,
        )
        fns = []
        for f in si.filters:
            ce = compile_expr(f, sres, extensions)
            if ce.atype != AttributeType.BOOL:
                raise SiddhiQLError("stream filter must be boolean")
            fns.append(ce.fn)
        w = _window_of(si)
        ring = config.join_window_capacity
        unbounded = False
        if w is None:
            mode, n, tms = "length", ring, None
            unbounded = True
        elif w[0] == "length":
            mode, n, tms = "length", w[1], None
        elif w[0] == "time":
            mode, n, tms = "time", ring, w[1]
        else:
            raise SiddhiQLError(
                f"window #{w[0]} is not supported on a join input "
                "(length/time only)"
            )
        return _Side(
            stream_id=si.stream_id,
            ref=si.ref_name,
            stream_code=stream_codes[si.stream_id],
            filter_fns=fns,
            window_mode=mode,
            window_n=n,
            time_ms=tms,
            cols=[],
            col_types=[],
            outer=outer,
            unbounded=unbounded,
        )

    jt = inp.join_type
    left = side_of(li, jt in ("left outer join", "full outer join"))
    right = side_of(ri, jt in ("right outer join", "full outer join"))

    items = q.selector.items
    if q.selector.is_star:
        items = tuple(
            ast.SelectItem(ast.Attr(f, qualifier=si.ref_name),
                           f"{si.ref_name}_{f}")
            for si in (li, ri)
            for f in schemas[si.stream_id].field_names
        )
    for item in items:
        if ast.contains_aggregate(item.expr):
            raise SiddhiQLError(
                "aggregations over join outputs are not supported yet; "
                "join into an intermediate stream and aggregate that"
            )
    if q.selector.group_by or q.selector.having is not None:
        raise SiddhiQLError(
            "group by / having on a join query is not supported yet"
        )

    on_progs, derived = None, {}
    if inp.on is not None:
        # compile_expr first: its validation and messages, as the
        # reference (and the columns it reads join the rings)
        ce = compile_expr(inp.on, resolver, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("join 'on' condition must be boolean")
        on_progs, derived = _compile_on(inp.on, resolver, extensions)

    proj_fns = []
    out_fields = []
    proj_tags: List[frozenset] = []
    for item in items:
        proj_tags.append(
            frozenset(
                resolver.used[resolver.resolve(a).key][0]
                for a in ast.iter_attrs(item.expr)
                if not a.name.startswith("@")
            )
        )
        ce = compile_expr(item.expr, resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(OutputField(item.output_name(), ce.atype,
                                      ce.table))

    # which columns each side must buffer in its ring (side-prefixed
    # env keys recorded by the resolver during on/projection compiles)
    for env_key, (tag, tape_key, atype) in sorted(resolver.used.items()):
        side = left if tag == "l" else right
        side.cols.append((env_key, tape_key))
        side.col_types.append(atype)

    return JoinArtifact(
        name=name,
        output_schema=OutputSchema(q.output_stream, tuple(out_fields)),
        left=left,
        right=right,
        on_progs=on_progs,
        derived=derived,
        within=inp.within,
        proj_fns=proj_fns,
        proj_tags=tuple(proj_tags),
        out_factor=config.join_out_factor,
    )
