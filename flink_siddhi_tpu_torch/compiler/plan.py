"""Whole-plan compilation: SiddhiQL text -> one device step per micro-batch.

The analog of the reference's plan pipeline — enriched-plan assembly
(SiddhiOperatorContext.getAllEnrichedExecutionPlan, :109-119), fail-fast
validation (AbstractSiddhiOperator.java:291-299), and per-plan runtime
creation (startSiddhiManager, :301-313) — except the product is not N
embedded interpreters but ONE step function: every query in the plan is an
artifact contributing to ``step(states, tape) -> (states, outputs)``, run
eagerly by torch on the plan's device.

This port covers plain stream queries (filter / projection, also over a
window), chain patterns (structurally identical ones stacked on a query
axis), sliding, batch and cumulative aggregation with
group-by and having, ``#window.unique``, ``#window.delay`` and
``insert expired events``. Joins, tables, partitions, query chaining,
``insert all events`` and output rate limiting raise ``SiddhiQLError``
naming the later slice of the port (ROADMAP.md Queue 1); the JAX package
``flink_siddhi_tpu`` runs them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..extensions.registry import ExtensionRegistry, builtin_registry
from ..query import ast, parse_plan
from ..query.lexer import SiddhiQLError
from ..runtime.tape import TapeSpec, WireTape
from ..schema.stream_schema import StreamSchema
from .config import DEFAULT_CONFIG, EngineConfig
from .expr import ExprResolver, as_i32
from .select import compile_select

_I32 = torch.int32


def _later(what: str, item: int) -> SiddhiQLError:
    return SiddhiQLError(
        f"{what} is not in the torch port yet (ROADMAP.md Queue 1 item "
        f"{item}); the JAX package flink_siddhi_tpu runs it"
    )


@dataclass
class CompiledPlan:
    plan_id: str
    spec: TapeSpec
    artifacts: List  # init_state / step / output_schema / output_mode
    schemas: Dict[str, StreamSchema]
    config: EngineConfig = DEFAULT_CONFIG
    # oversized micro-batches step in chunks of this tape capacity
    tape_capacity_limit: Optional[int] = None

    def init_state(self, device) -> Dict:
        return {a.name: a.init_state(device) for a in self.artifacts}

    def grow_state(self, states: Dict) -> Dict:
        """Re-bucket keyed state tables after host interning discovered
        new keys (their sizes are known on the host: no device wait)."""
        out = dict(states)
        for a in self.artifacts:
            grow = getattr(a, "grow_state", None)
            if grow is not None:
                out[a.name] = grow(states[a.name])
        return out

    def step(self, states: Dict, tape) -> Tuple[Dict, Dict]:
        """Advance every query one micro-batch (a staged wire tape is
        expanded on the device first)."""
        if isinstance(tape, WireTape):
            tape = tape.expand()
        new_states = {}
        outputs = {}
        for a in self.artifacts:
            s, out = a.step(states[a.name], tape)
            new_states[a.name] = s
            outputs[a.name] = out
        return new_states, outputs

    @property
    def has_flush(self) -> bool:
        """Whether end-of-stream flush can do ANY work."""
        return any(
            getattr(a, "flush", None) is not None
            and not getattr(a, "flush_is_noop", False)
            for a in self.artifacts
        )

    def flush(self, states: Dict) -> Tuple[Dict, Dict]:
        """End-of-stream flush (timed-absence patterns emit their pending
        deadlines)."""
        new_states = dict(states)
        outputs = {}
        for a in self.artifacts:
            fl = getattr(a, "flush", None)
            if fl is not None:
                s, out = fl(states[a.name])
                new_states[a.name] = s
                outputs[a.name] = out
        return new_states, outputs

    # -- device-side output accumulation ------------------------------------
    # Each artifact's per-batch emissions are appended on the device into
    # one int32 matrix per plan (ts row + one bitcast row per output
    # column); the host drains it with two fetches (counts, then the used
    # slice), amortized over many micro-batches.

    def acc_layout(self) -> List[Tuple[int, int]]:
        """(first_row, n_rows) per artifact in the packed buffer."""
        out = []
        row = 0
        for a in self.artifacts:
            n_rows = (
                a.acc_rows
                if hasattr(a, "acc_rows")
                else 1 + len(a.output_schema.fields)
            )
            out.append((row, n_rows))
            row += n_rows
        return out

    def acc_capacity(self) -> int:
        total_rows = sum(r for _, r in self.acc_layout()) or 1
        cap = self.config.acc_budget_bytes // (total_rows * 4)
        return int(max(1 << 16, min(1 << 23, cap)))

    def init_acc(self, device) -> Dict:
        """Zeroed accumulator on ``device``."""
        layout = self.acc_layout()
        total_rows = sum(r for _, r in layout) or 1
        a_count = max(len(self.artifacts), 1)
        return {
            # meta[0] = per-artifact emission counts, meta[1] = overflow
            # (one array, so a host drain-check costs ONE fetch)
            "meta": torch.zeros((2, a_count), dtype=_I32, device=device),
            "buf": torch.zeros(
                (total_rows, self.acc_capacity()), dtype=_I32,
                device=device,
            ),
        }

    def step_acc(self, states: Dict, acc: Dict, tape) -> Tuple[Dict, Dict]:
        """step() + on-device append of every emission into ``acc``.

        The append writes into ``acc["buf"]`` in place (the reference's
        functional update runs in place through buffer donation; here the
        caller's accumulator is simply updated). The write offset stays
        on the device: the block goes in through a device-computed column
        index, so an append never waits for the host."""
        new_states, outputs = self.step(states, tape)
        buf = acc["buf"]
        cap = int(buf.shape[1])
        ns, over = acc["meta"][0], acc["meta"][1]
        new_n, new_over = [], []
        for ai, (a, (row0, n_rows)) in enumerate(
            zip(self.artifacts, self.acc_layout())
        ):
            out = outputs[a.name]
            over_ai = over[ai]
            if a.output_mode == "packed":
                # the artifact already emits the accumulator block layout;
                # an optional third element counts the rows it dropped
                # before packing (a stack's emission buffer overflow)
                n, block = out[0], out[1]
                n = n.to(_I32)
                if len(out) > 2:
                    over_ai = over_ai + out[2].to(_I32)
            elif a.output_mode == "aligned":
                mask, ts, cols = out
                n = mask.sum(dtype=_I32)
                # O(V) front-compaction, tape order kept; all rows
                # compact through ONE scatter (dump column vlen)
                vlen = int(mask.shape[0])
                pos = torch.cumsum(mask, 0, dtype=_I32) - 1
                dest = torch.where(mask, pos, vlen).long()
                src = torch.stack(
                    [as_i32(r) for r in (ts, *cols)]
                )
                block = torch.zeros(
                    (src.shape[0], vlen + 1), dtype=_I32, device=buf.device
                )
                block.scatter_(
                    1, dest.unsqueeze(0).expand(src.shape[0], vlen), src
                )
                block = block[:, :vlen]
            else:  # buffered: (count, ts, cols), emitted rows first
                n, ts, cols = out
                n = n.to(_I32)
                block = torch.stack([as_i32(r) for r in (ts, *cols)])
            v = int(block.shape[1])
            n_true = n
            if v > cap:
                # block wider than the whole accumulator: rows beyond cap
                # are genuinely dropped and counted
                block = block[:, :cap]
                v = cap
            n = torch.clamp(n, max=v)
            fits = ns[ai] + v <= cap
            off = torch.where(fits, ns[ai], 0)
            cols_idx = off + torch.arange(v, device=buf.device)
            region = buf[row0:row0 + n_rows]
            cur = region.index_select(1, cols_idx)
            region.index_copy_(1, cols_idx, torch.where(fits, block, cur))
            new_n.append(torch.where(fits, ns[ai] + n, ns[ai]))
            new_over.append(
                over_ai + torch.where(fits, n_true - n, n_true)
            )
        if not self.artifacts:
            return new_states, acc
        return new_states, {
            "meta": torch.stack(
                [torch.stack(new_n), torch.stack(new_over)]
            ).to(_I32),
            "buf": buf,
        }

    def drain_decode(self, counts: np.ndarray, data: np.ndarray,
                     lookup=None, columnar_streams=frozenset(),
                     lookup_np=None) -> Dict[str, List]:
        """Host side of a drain: unpack the fetched buffer slice into
        per-artifact lists of (output_schema, decoded payload). ``data``
        is ``buf[:, :max(counts)]`` already on host; ``lookup`` resolves
        lazy ordinals (the executor's lazy ring). Stacked artifacts route
        their rows to each member's own stream.

        A payload is a row list by default; for an artifact whose output
        stream is in ``columnar_streams`` (every consumer speaks the
        columnar protocol, ``Job._columnar_streams``) and that has a
        columnar decode, it is a :class:`ColumnBatch`, with no per-row
        tuple; ``lookup_np`` is the ring's vectorized resolver for it.
        Every payload is a copy: no decode returns a view of ``data``
        (each reorders by ``emission_order``), so the caller may reuse
        the buffer ``data`` lies in."""
        out: Dict[str, List] = {}
        for ai, (a, (row0, n_rows)) in enumerate(
            zip(self.artifacts, self.acc_layout())
        ):
            n = int(counts[ai])
            if n == 0:
                out[a.name] = []
                continue
            block = data[row0:row0 + n_rows, :n]
            if hasattr(a, "decode_packed"):
                # columnar only for artifacts with the hook: a stack
                # routes to many streams and stays on rows
                if hasattr(a, "decode_packed_columns") and (
                    a.output_schema.stream_id in columnar_streams
                ):
                    out[a.name] = a.decode_packed_columns(
                        n, block, lookup_np=lookup_np
                    )
                elif getattr(a, "wants_lookup", False):
                    out[a.name] = a.decode_packed(n, block, lookup=lookup)
                else:
                    out[a.name] = a.decode_packed(n, block)
                continue
            if a.output_schema.stream_id in columnar_streams:
                out[a.name] = [(
                    a.output_schema,
                    a.output_schema.decode_packed_columns(n, block),
                )]
            else:
                out[a.name] = [(
                    a.output_schema,
                    a.output_schema.decode_packed_block(n, block),
                )]
        return out

    @property
    def input_stream_ids(self) -> List[str]:
        return list(self.spec.stream_codes)

    def output_streams(self) -> Dict[str, List]:
        """stream_id -> [OutputSchema] writing to it (a stack contributes
        every member's schema)."""
        by_stream: Dict[str, List] = {}
        for a in self.artifacts:
            for m in getattr(a, "members", None) or (a,):
                by_stream.setdefault(
                    m.output_schema.stream_id, []
                ).append(m.output_schema)
        return by_stream


def compile_plan(
    plan_text: str,
    schemas: Dict[str, StreamSchema],
    extensions: Optional[ExtensionRegistry] = None,
    plan_id: str = "plan",
    config: Optional[EngineConfig] = None,
) -> CompiledPlan:
    """Parse + validate + compile a full execution plan.

    ``schemas``: externally registered streams (SiddhiCEP.registerStream
    parity); ``define stream`` DDL inside the plan text adds to them.
    """
    if extensions is None:
        extensions = builtin_registry()
    if config is None:
        config = DEFAULT_CONFIG
    parsed = parse_plan(plan_text)

    # plan-internal DDL shares the environment's string dictionary (taken
    # from any registered schema) so string codes are comparable across
    # streams and query constants
    shared_strings = None
    for sch in schemas.values():
        for t in sch.string_tables.values():
            shared_strings = t
            break
        if shared_strings is not None:
            break
    if shared_strings is None:
        from ..schema.strings import StringTable

        shared_strings = StringTable()

    all_schemas = dict(schemas)
    for sd in parsed.stream_defs:
        if sd.stream_id not in all_schemas:
            all_schemas[sd.stream_id] = StreamSchema(
                list(sd.fields), shared_strings=shared_strings
            )
    if parsed.table_defs:
        raise _later("event tables ('define table')", 8)
    if not parsed.queries:
        raise SiddhiQLError("execution plan contains no queries")

    # fail fast on undefined inputs (UndefinedStreamException parity,
    # SiddhiCEP.java:134-140)
    produced = {q.output_stream for q in parsed.queries}
    input_ids: List[str] = []
    for q in parsed.queries:
        for sid in q.input_stream_ids():
            if sid in all_schemas:
                if sid not in input_ids:
                    input_ids.append(sid)
                continue
            if sid in produced:
                raise _later(
                    f"query chaining (stream {sid!r} fed by another "
                    "query)", 8,
                )
            raise SiddhiQLError(
                f"input stream {sid!r} is not defined or registered"
            )

    stream_codes = {sid: i for i, sid in enumerate(input_ids)}
    # materialize only fields some query REFERENCES (by field name,
    # conservatively across streams). ``select *`` anywhere disables
    # pruning (the set is unknowable).
    referenced = _referenced_field_names(parsed)
    columns = []
    column_types = {}
    for sid in input_ids:
        sch = all_schemas[sid]
        for fname, ftype in zip(sch.field_names, sch.field_types):
            if referenced is not None and fname not in referenced:
                continue
            key = f"{sid}.{fname}"
            columns.append(key)
            column_types[key] = ftype

    artifacts = []
    used_names = set()
    encoded = []
    for qi, q in enumerate(parsed.queries):
        qname = q.name or f"query_{qi}"
        if qname in used_names:
            raise SiddhiQLError(f"duplicate query name {qname!r}")
        used_names.add(qname)
        art = _compile_query(
            q, qname, all_schemas, stream_codes, extensions, config
        )
        encoded.extend(getattr(art, "encoded_columns", ()))
        artifacts.append(art)

    # multi-query parallelism: structurally identical chain patterns
    # stack onto a device query axis and advance together
    from .nfa import (
        ChainPatternArtifact,
        StackedChainArtifact,
        chain_wire_opts,
        group_chain_artifacts,
    )

    artifacts = group_chain_artifacts(artifacts, column_types=column_types)

    # late materialization and wire predicate pushdown (opt-in), for a
    # plan of one chain pattern, one select or one sliding window (a stack
    # gets neither): projection-only columns stay host-side,
    # host-evaluable filters ship as packed mask bits, and a window's
    # group columns travel as codes
    from .select import SelectArtifact, select_wire_opts
    from .window import SlidingWindowArtifact, window_wire_opts

    device_columns = None
    host_preds = ()
    if (
        config.lazy_projection or config.pred_pushdown
    ) and len(artifacts) == 1:
        res = None
        if isinstance(artifacts[0], ChainPatternArtifact):
            res = chain_wire_opts(artifacts[0], config)
        elif isinstance(artifacts[0], SelectArtifact):
            res = select_wire_opts(artifacts[0], config)
        elif isinstance(artifacts[0], SlidingWindowArtifact):
            res = window_wire_opts(artifacts[0], config)
        if res is not None:
            needed, host_preds = res
            device_columns = tuple(k for k in columns if k in needed)
    # artifact-declared host-computed columns (#window.cron's per-event
    # window ids: calendar math stays on the host)
    host_preds = tuple(host_preds) + tuple(
        hc for art in artifacts for hc in getattr(art, "host_columns", ())
    )
    relevance = tuple(
        (a.name, a.relevance())
        for a in artifacts
        if isinstance(a, (ChainPatternArtifact, StackedChainArtifact))
    )
    # a wide stack steps in windows of at most 131,072 events, as the
    # reference caps it (its compile time grows with width x queries):
    # the step boundaries decide the rows' order within a stream and when
    # a partial pool overflows, so the port keeps the same ones
    cap_limit = config.max_tape_capacity
    if cap_limit is None and any(
        isinstance(a, StackedChainArtifact) and len(a.members) >= 16
        for a in artifacts
    ):
        cap_limit = 131072

    return CompiledPlan(
        plan_id=plan_id,
        spec=TapeSpec(stream_codes, tuple(columns), column_types,
                      tuple(encoded), device_columns=device_columns,
                      host_preds=host_preds, relevance=relevance),
        artifacts=artifacts,
        schemas=all_schemas,
        config=config,
        tape_capacity_limit=cap_limit,
    )


def _compile_query(
    q: ast.Query,
    name: str,
    schemas: Dict[str, StreamSchema],
    stream_codes: Dict[str, int],
    extensions: ExtensionRegistry,
    config: EngineConfig = DEFAULT_CONFIG,
):
    if q.partition_with:
        raise _later("'partition with'", 8)
    if q.output_action != "insert":
        raise _later(f"table {q.output_action}", 8)
    if q.output_events == "all":
        # the reference splits it into a current-events query and an
        # expired one (its plan rewrite)
        raise _later("'insert all events into'", 8)
    if q.output_rate is not None:
        raise _later("output rate limiting ('output ... every')", 9)
    inp = q.input
    if (
        isinstance(inp, ast.StreamInput)
        and len(inp.windows) == 1
        and inp.windows[0].name.split(".")[-1].lower() == "delay"
        and q.output_events == "current"
    ):
        from .window import compile_delay_window

        # #window.delay(t): events pass through t ms late — the emission
        # schedule of a time window's EXPIRED stream (entry ts + span)
        return compile_delay_window(
            q, name, schemas, stream_codes, extensions, config
        )
    if q.output_events != "current":
        from .window import compile_expired_window

        # `insert expired events into`: emit events as they LEAVE the
        # window
        return compile_expired_window(
            q, name, schemas, stream_codes, extensions, config
        )
    if isinstance(inp, ast.StreamInput):
        has_agg = any(
            ast.contains_aggregate(i.expr) for i in q.selector.items
        )
        if inp.windows or has_agg or q.selector.group_by:
            from .window import compile_window_query

            return compile_window_query(
                q, name, schemas, stream_codes, extensions, config
            )
        ref = inp.ref_name
        resolver = ExprResolver(
            {ref: (inp.stream_id, schemas[inp.stream_id])},
            default_scope=ref,
        )
        if ref != inp.stream_id:
            resolver = ExprResolver(
                {
                    ref: (inp.stream_id, schemas[inp.stream_id]),
                    inp.stream_id: (inp.stream_id, schemas[inp.stream_id]),
                },
                default_scope=ref,
            )
        return compile_select(
            q, name, resolver, schemas, stream_codes[inp.stream_id],
            extensions,
        )
    if isinstance(inp, ast.PatternInput):
        from .nfa import compile_pattern_query

        return compile_pattern_query(
            q, name, schemas, stream_codes, extensions, config
        )
    if isinstance(inp, ast.JoinInput):
        raise _later("joins", 8)
    raise SiddhiQLError(f"unsupported input clause {type(inp).__name__}")


def _referenced_field_names(parsed):
    """Field names any query can read, or None when unknowable
    (``select *``). Name-level (not stream-qualified) and therefore
    conservative: a name used on ANY stream keeps that column on every
    stream carrying it."""
    names = set()

    def add_expr(e):
        if e is None:
            return
        for a in ast.iter_attrs(e):
            names.add(a.name)

    for q in parsed.queries:
        sel = q.selector
        if sel.is_star:
            return None
        for item in sel.items:
            add_expr(item.expr)
        for g in sel.group_by:
            names.add(ast.bare_group_key(g))
        add_expr(sel.having)
        add_expr(q.on_condition)
        for _sid, attr in q.partition_with:
            names.add(attr)
        inp = q.input
        sides = []
        if isinstance(inp, ast.StreamInput):
            sides = [inp]
        elif isinstance(inp, ast.JoinInput):
            sides = [inp.left, inp.right]
            add_expr(inp.on)
        elif isinstance(inp, ast.PatternInput):
            for el in inp.elements:
                add_expr(el.filter)
        for side in sides:
            for f in side.filters:
                add_expr(f)
            for w in side.windows:
                for arg in w.args:
                    add_expr(arg)
    return names


# --------------------------------------------------------------------------
# Engine state carried across packages
# --------------------------------------------------------------------------

def state_from_numpy(plan: CompiledPlan, states_np: Dict, device,
                     encoders: Optional[Dict[str, dict]] = None) -> Dict:
    """Engine state as numpy arrays (for example the JAX plan's state,
    fetched to the host) -> this plan's state tensors on ``device``.
    ``encoders`` — ``{enc.out_key: enc.encoder.state_dict()}`` over the
    source plan's ``spec.encoded``, the form the JAX package's checkpoints
    keep them in — loads the group-key encoders first: a keyed table's
    size follows its encoder, and its slots follow the encoder's codes.
    The per-artifact key sets (nested ones too, such as a window's
    ``ring``) must match the port's own ``init_state``; every shape and
    dtype must match it after growth to the loaded encoders."""
    device = torch.device(device)
    for enc in plan.spec.encoded:
        if encoders is None or enc.out_key not in encoders:
            raise KeyError(f"no encoder state for group key {enc.out_key!r}")
        enc.encoder.load_state_dict(encoders[enc.out_key])
    fresh = plan.grow_state(plan.init_state("cpu"))

    def load(path: str, src, ref):
        if isinstance(ref, dict):
            if not isinstance(src, dict) or set(src) != set(ref):
                raise KeyError(
                    f"{path}: state keys "
                    f"{sorted(src) if isinstance(src, dict) else src!r} "
                    f"differ from the port's {sorted(ref)}"
                )
            return {k: load(f"{path}.{k}", src[k], v)
                    for k, v in ref.items()}
        t = torch.from_numpy(np.array(src))  # own, writable copy
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(
                f"{path}: {t.dtype}{tuple(t.shape)} differs from "
                f"{ref.dtype}{tuple(ref.shape)}"
            )
        return t.to(device)

    out = {}
    for a in plan.artifacts:
        if a.name not in states_np:
            raise KeyError(f"no state for artifact {a.name!r}")
        out[a.name] = load(a.name, states_np[a.name], fresh[a.name])
    return out


def state_to_numpy(states: Dict) -> Dict:
    """The inverse of ``state_from_numpy``: every tensor fetched to the
    host as a numpy array, nested dicts kept."""
    if isinstance(states, dict):
        return {k: state_to_numpy(v) for k, v in states.items()}
    return states.detach().cpu().numpy()
