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
axis), the slot NFA's patterns and sequences, sliding, batch and
cumulative aggregation with group-by and having, the scan windows
(``#window.unique``, ``sort``, ``session``, ``frequent``,
``lossyFrequent``: ``scan_windows.py``), ``#window.delay``, ``insert expired events`` and ``insert all events``,
windowed two-stream joins (``compiler/join.py``; an aggregated join runs
as a join into an intermediate stream and an aggregation over it), query
chaining (a query reading another query's output inside the same step),
event tables (``compiler/table.py``: ``define table``, insert, also
from a window or an aggregation, update / delete ``on``, also windowed
through an intermediate stream, stream-table joins; the tables ride the
state under ``@tables`` and thread through the queries in order) and
``partition with`` (per-key patterns, per-key length windows, partitioned
aggregations: ``_rewrite_partitioned``). Output rate limiting
(``output ... every``) compiles to per-stream settings that the executor's
host limiter applies where rows surface.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..extensions.registry import ExtensionRegistry, builtin_registry
from ..query import ast, parse_plan
from ..query.lexer import SiddhiQLError
from ..runtime.tape import Tape, TapeSpec, WireTape
from ..schema.stream_schema import StreamSchema
from .config import DEFAULT_CONFIG, EngineConfig
from .expr import ExprResolver, _dt, as_column, as_i32
from .select import compile_select
from .table import _windowed, init_table_state

_I32 = torch.int32


def _later(what: str, item: int) -> SiddhiQLError:
    return SiddhiQLError(
        f"{what} is not in the torch port yet (ROADMAP.md Queue 1 item "
        f"{item}); the JAX package flink_siddhi_tpu runs it"
    )


@dataclass(frozen=True)
class ChainedInput:
    """A query whose input stream is ANOTHER query's output (query
    chaining, ``insert into mid`` -> ``from mid#window...``): the
    consumer reads a synthetic tape built from the producer's emissions
    inside the same step — the reference's multi-query composition style
    (package-info.java:19-51), with batch-granular propagation instead of
    per-event."""

    producer: str  # producing artifact's name
    stream_id: str  # the intermediate stream
    code: int  # stream code on the synthetic tape
    fields: Tuple  # producer OutputSchema fields (name/type order)
    mode: str  # producer output_mode: buffered | aligned | packed


@dataclass
class CompiledPlan:
    plan_id: str
    spec: TapeSpec
    artifacts: List  # init_state / step / output_schema / output_mode
    schemas: Dict[str, StreamSchema]
    config: EngineConfig = DEFAULT_CONFIG
    # oversized micro-batches step in chunks of this tape capacity
    tape_capacity_limit: Optional[int] = None
    # consumer artifact name -> its chained (internal) input descriptor
    chained: Dict[str, ChainedInput] = field(default_factory=dict)
    table_schemas: Dict[str, StreamSchema] = field(default_factory=dict)
    # output stream -> its ``output ... every`` clause (ast.OutputRate),
    # applied by the executor's host limiter; for a snapshot, the group
    # keys' positions in the output row
    output_rates: Dict[str, object] = field(default_factory=dict)
    snapshot_keys: Dict[str, tuple] = field(default_factory=dict)
    # the parsed plan after the compiler's rewrites: the admission
    # signature's structural descriptor and the subplan-share split read it
    source_ast: object = None

    def signature(self, capacity: int = 128) -> str:
        """The shape-bucket class key (``analysis/admit.plan_signature``)
        memoized per capacity: an admit hashes the same plan more than
        once (the report and the summary it carries)."""
        memo = self.__dict__.setdefault("_signature_memo", {})
        from ..runtime.tape import bucket_size

        cap = bucket_size(int(capacity))
        sig = memo.get(cap)
        if sig is None:
            from ..analysis.admit import plan_signature

            sig = memo[cap] = plan_signature(self, capacity=cap)
        return sig

    def init_state(self, device) -> Dict:
        states = {a.name: a.init_state(device) for a in self.artifacts}
        if self.table_schemas:
            states["@tables"] = {
                tid: init_table_state(tid, sch, device,
                                      self.config.table_capacity)
                for tid, sch in self.table_schemas.items()
            }
        return states

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
        expanded on the device first). Tables are threaded through the
        artifacts in query order, so later queries see earlier queries'
        table writes (batch-granular sequencing); chained consumers read a
        synthetic tape built from their producer's emissions this same
        step."""
        if isinstance(tape, WireTape):
            tape = tape.expand()
        new_states = {}
        outputs = {}
        tables = states.get("@tables", {})
        for a in self.artifacts:
            ci = self.chained.get(a.name)
            a_tape = (tape if ci is None
                      else _synthetic_tape(outputs[ci.producer], ci))
            if getattr(a, "uses_tables", False):
                s, tables, out = a.step_tables(states[a.name], tables,
                                               a_tape)
            else:
                s, out = a.step(states[a.name], a_tape)
            new_states[a.name] = s
            outputs[a.name] = out
        if "@tables" in states:
            new_states["@tables"] = tables
        return new_states, outputs

    @property
    def has_flush(self) -> bool:
        """Whether end-of-stream flush can do ANY work."""
        return any(
            getattr(a, "flush_tables", None) is not None
            or (getattr(a, "flush", None) is not None
                and not getattr(a, "flush_is_noop", False))
            for a in self.artifacts
        )

    def flush(self, states: Dict) -> Tuple[Dict, Dict]:
        """End-of-stream flush (timed-absence patterns emit their pending
        deadlines, batch windows their last windows). Artifacts writing to
        a table flush through the table state: a windowed table insert's
        last rows land in the table."""
        new_states = dict(states)
        outputs = {}
        tables = states.get("@tables", {})
        for a in self.artifacts:
            flt = getattr(a, "flush_tables", None)
            if flt is not None:
                new_states[a.name], tables = flt(states[a.name], tables)
                continue
            fl = getattr(a, "flush", None)
            if fl is not None:
                s, out = fl(states[a.name])
                new_states[a.name] = s
                outputs[a.name] = out
        if "@tables" in states:
            new_states["@tables"] = tables
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
                     lookup_np=None,
                     count_only_streams=frozenset()) -> Dict[str, List]:
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
        the buffer ``data`` lies in. An artifact of one output stream in
        ``count_only_streams`` (nothing observes its rows) is not decoded:
        its payload is its row count, an int."""
        out: Dict[str, List] = {}
        for ai, (a, (row0, n_rows)) in enumerate(
            zip(self.artifacts, self.acc_layout())
        ):
            n = int(counts[ai])
            if n == 0:
                out[a.name] = []
                continue
            if (a.output_schema.stream_id in count_only_streams
                    and not hasattr(a, "members")):
                out[a.name] = [(a.output_schema, n)]
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
            # stacks hold artifacts; dynamic groups hold (plan_id, schema)
            # per slot, None for a free one
            for m in getattr(a, "members", None) or (a,):
                if m is None:
                    continue
                sch = m.output_schema if hasattr(m, "output_schema") else m[1]
                by_stream.setdefault(sch.stream_id, []).append(sch)
        return by_stream


def _synthetic_tape(out, ci: ChainedInput) -> Tape:
    """Producer emissions -> the consumer's input Tape, inside the same
    step. All three artifact output modes convert losslessly: buffered
    (n, ts, cols), aligned (mask, ts, cols), packed (n, block with
    bitcast int32 rows)."""
    if ci.mode == "aligned":
        mask, ts, cols = out
        valid = mask
        width = int(valid.shape[0])
        col_vals = [as_column(c, width, ts) for c in cols]
    elif ci.mode == "buffered":
        n, ts, cols = out
        width = int(ts.shape[0])
        valid = torch.arange(width, dtype=_I32, device=ts.device) < n
        col_vals = [as_column(c, width, ts) for c in cols]
    else:  # packed: ts row + one bitcast int32 row per output column
        n, block = out[0], out[1]
        width = int(block.shape[1])
        ts = block[0]
        valid = torch.arange(width, dtype=_I32, device=ts.device) < n
        col_vals = []
        for i, f in enumerate(ci.fields):
            row = block[1 + i]
            dt = _dt(f.atype)
            col_vals.append(row.view(torch.float32) if dt == torch.float32
                            else row.to(dt))
    # producer emission buffers are in SLOT order; the consumer must see
    # stream time (order-sensitive consumers — per-event cumulative
    # prefixes — would otherwise accumulate in buffer order). Stable
    # sort keeps emission order within a timestamp.
    ts = ts.to(_I32)
    order = torch.argsort(torch.where(valid, ts, 2 ** 31 - 1), stable=True)
    ts = ts[order]
    valid = valid[order]
    col_vals = [v[order] for v in col_vals]
    stream = torch.where(valid, ci.code, -1).to(_I32)
    cols_map = {
        f"{ci.stream_id}.{f.name}": v for f, v in zip(ci.fields, col_vals)
    }
    return Tape(ts, stream, valid, cols_map)


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
    # tables share the string dictionary too, so a join or an `on` over a
    # string key compares the same codes
    table_schemas = {
        td.table_id: StreamSchema(
            list(td.fields), shared_strings=shared_strings
        )
        for td in parsed.table_defs
    }
    if not parsed.queries:
        raise SiddhiQLError("execution plan contains no queries")

    # direct `group by` / `having` / aggregation ON a join query: legal
    # SiddhiQL served by rewriting into the chaining form — join into a
    # synthesized intermediate stream, aggregate that (same step); a
    # windowed or aggregated update / delete the same way (the window
    # into a synthesized stream, a plain mutation over it)
    parsed = _rewrite_aggregated_joins(parsed, table_schemas, all_schemas)
    parsed = _rewrite_windowed_mutations(parsed, table_schemas)
    parsed = _rewrite_all_events(parsed)

    # fail fast on undefined inputs (UndefinedStreamException parity,
    # SiddhiCEP.java:134-140). A stream produced by an EARLIER query's
    # `insert into` is a valid chained input (query composition): the
    # consumer reads the producer's emissions inside the same step.
    producer_of: Dict[str, int] = {}
    multi_producer = set()
    for qi, q in enumerate(parsed.queries):
        if q.output_stream in producer_of:
            multi_producer.add(q.output_stream)
        else:
            producer_of[q.output_stream] = qi

    input_ids: List[str] = []
    internal_ids: List[str] = []
    for qi, q in enumerate(parsed.queries):
        for sid in q.input_stream_ids():
            if sid in table_schemas:
                continue  # table join side, not a stream input
            if sid in all_schemas:
                if sid not in input_ids:
                    input_ids.append(sid)
                continue
            pq = producer_of.get(sid)
            if pq is not None and pq < qi:
                if sid in multi_producer:
                    raise SiddhiQLError(
                        f"chained stream {sid!r} has multiple producer "
                        "queries; define it as a stream and union instead"
                    )
                if not isinstance(q.input, ast.StreamInput):
                    raise SiddhiQLError(
                        f"chained stream {sid!r} can only feed a plain "
                        "windowed/filtered query (joins and patterns over "
                        "intermediate streams are not supported yet)"
                    )
                if sid not in internal_ids:
                    internal_ids.append(sid)
                continue
            raise SiddhiQLError(
                f"input stream {sid!r} is not defined or registered"
            )

    stream_codes = {sid: i for i, sid in enumerate(input_ids)}
    internal_codes = {
        sid: len(input_ids) + j for j, sid in enumerate(internal_ids)
    }
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
    chained: Dict[str, ChainedInput] = {}
    merged_codes = {**stream_codes, **internal_codes}
    for qi, q in enumerate(parsed.queries):
        qname = q.name or f"query_{qi}"
        if qname in used_names:
            raise SiddhiQLError(f"duplicate query name {qname!r}")
        used_names.add(qname)
        art = _compile_query(
            q, qname, all_schemas, merged_codes, extensions,
            table_schemas, config,
        )
        inp = q.input
        if (
            isinstance(inp, ast.StreamInput)
            and inp.stream_id in internal_codes
        ):
            new_enc = []
            for enc in getattr(art, "encoded_columns", ()):
                if any(
                    k.split(".", 1)[0] == inp.stream_id
                    for k in enc.in_keys
                ):
                    enc = _rewire_chained_group(
                        art, enc, q, inp.stream_id, all_schemas,
                        merged_codes,
                    )
                new_enc.append(enc)
            if new_enc:
                art.encoded_columns = tuple(new_enc)
            producer = artifacts[producer_of[inp.stream_id]]
            if getattr(producer, "_nullable", False):
                raise SiddhiQLError(
                    f"chained stream {inp.stream_id!r} comes from an "
                    "outer join whose unmatched rows carry nulls; only "
                    "inner-join / stream producers can be chained"
                )
            chained[qname] = ChainedInput(
                producer=producer.name,
                stream_id=inp.stream_id,
                code=internal_codes[inp.stream_id],
                fields=tuple(producer.output_schema.fields),
                mode=producer.output_mode,
            )
        encoded.extend(getattr(art, "encoded_columns", ()))
        artifacts.append(art)
        # an intermediate stream becomes visible as a schema for the
        # queries AFTER its producer (validation already ordered this)
        if (
            q.output_stream in internal_codes
            and q.output_stream not in all_schemas
        ):
            all_schemas[q.output_stream] = StreamSchema(
                [(f.name, f.atype) for f in art.output_schema.fields],
                shared_strings=shared_strings,
            )

    # multi-query parallelism: structurally identical chain patterns
    # stack onto a device query axis and advance together. Chained
    # producers keep their own artifact (consumers read their outputs by
    # name).
    from .nfa import (
        ChainPatternArtifact,
        StackedChainArtifact,
        chain_wire_opts,
        group_chain_artifacts,
    )

    artifacts = group_chain_artifacts(
        artifacts,
        exclude=frozenset(ci.producer for ci in chained.values()),
        column_types=column_types,
    )

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

    output_rates, snapshot_keys = _output_rates(parsed, internal_codes,
                                                table_schemas)
    plan = CompiledPlan(
        plan_id=plan_id,
        spec=TapeSpec(stream_codes, tuple(columns), column_types,
                      tuple(encoded), device_columns=device_columns,
                      host_preds=host_preds, relevance=relevance),
        artifacts=artifacts,
        schemas=all_schemas,
        config=config,
        tape_capacity_limit=cap_limit,
        chained=chained,
        table_schemas=table_schemas,
        output_rates=output_rates,
        snapshot_keys=snapshot_keys,
        source_ast=parsed,
    )
    # compiled-plan verification and admission (the reference's tiers):
    # FST_VERIFY_PLANS=1 (the test lane) runs the static NFA/stack checks
    # and the cost-hook check on every compile; config.verify_plans or
    # =full adds the trace tier (one CPU step over the inert tape) and
    # the footprint + signature; a configured AdmissionBudgets turns
    # findings into AdmissionError; =0 turns everything off. The budgets'
    # verdict (meta tensors) comes before any CPU step: a plan over its
    # budgets is never stepped with its whole state on the host
    import os

    env = os.environ.get("FST_VERIFY_PLANS")
    if env != "0":
        from ..analysis.admit import admit_plan
        from ..analysis.plancheck import verify_plan

        full = bool(config.verify_plans) or env == "full"
        budgets = config.admission_budgets
        if budgets is not None:
            admit_plan(plan, budgets=budgets, deep=False, signature=False)
        if full or env == "1":
            verify_plan(plan, trace=full)
        if full or env == "1" or budgets is not None:
            admit_plan(plan, budgets=budgets, deep=full)
    return plan


def _output_rates(parsed, internal_codes, table_schemas):
    """``output [all|last|first] every N events | <duration>`` and
    ``output snapshot every <duration>``: the host limiter's settings per
    output stream (``runtime/executor.py:_OutputRateLimiter``) and, for a
    snapshot, the positions of the group keys in the output row. The
    reference's checks and refusals, with its text."""
    output_rates = {}
    snapshot_keys: Dict[str, tuple] = {}
    writers: Dict[str, int] = {}
    for q in parsed.queries:
        writers[q.output_stream] = writers.get(q.output_stream, 0) + 1
    for q in parsed.queries:
        r = q.output_rate
        if r is None:
            continue
        if r.mode == "snapshot":
            # periodic CURRENT-VALUE emission: one row per group with the
            # latest aggregate. A plain window-contents snapshot (every
            # retained event) would need device window dumps
            has_agg = q.selector.group_by or any(
                ast.contains_aggregate(i.expr) for i in q.selector.items
            )
            if not has_agg:
                raise SiddhiQLError(
                    "'output snapshot every ...' is supported for "
                    "aggregation queries (periodic current aggregate "
                    "per group); a plain window-contents snapshot is "
                    "not supported yet"
                )
            gb = {ast.bare_group_key(g) for g in q.selector.group_by}
            keys = []
            projected = set()
            for i, item in enumerate(q.selector.items):
                if isinstance(item.expr, ast.Attr) and item.expr.name in gb:
                    keys.append(i)
                    projected.add(item.expr.name)
            if gb - projected:
                # EVERY group key must be in the row, or distinct groups
                # overwrite one snapshot slot
                raise SiddhiQLError(
                    "'output snapshot' on a group-by query must "
                    "project every group key in the select "
                    f"(missing: {sorted(gb - projected)}); snapshot "
                    "rows are keyed by them"
                )
            snapshot_keys[q.output_stream] = tuple(keys)
        if writers[q.output_stream] > 1:
            # the limiter is keyed by stream: a second writer would be
            # throttled through the first one's limiter
            raise SiddhiQLError(
                f"output rate limiting on {q.output_stream!r} with "
                "multiple writer queries is not supported yet"
            )
        if q.output_stream in internal_codes:
            # chained consumers read the producer's emissions on the
            # device, unthinned
            raise SiddhiQLError(
                f"output rate limiting on chained stream "
                f"{q.output_stream!r} is not supported (the downstream "
                "query consumes the unthinned device emissions)"
            )
        if q.output_stream in table_schemas:
            # table writes apply on the device; the host limiter cannot
            # throttle them
            raise SiddhiQLError(
                "output rate limiting on a table write is not supported"
            )
        output_rates[q.output_stream] = r
    return output_rates, snapshot_keys


def _rewrite_partitioned(q: ast.Query, schemas) -> ast.Query:
    """Lower ``partition with (key of S) begin ... end`` semantics.

    Patterns: every non-first element gets an implicit cross-element
    equality filter ``el.key == e0.key`` — a partial match only advances
    on its own key's events, which is exactly Siddhi's per-partition NFA
    instance; the filter is a cross-element program, so a partitioned
    pattern runs on the slot NFA (K4). All keys share the one slot pool
    of ``EngineConfig.pattern_slots``, as in the reference.
    Aggregations: the key joins the group-by clause (per-key state); a
    partitioned length window compiles to ``PerKeyWindowArtifact``
    (``window.compile_window_query``). The forms the reference refuses
    here raise its messages.
    """
    import dataclasses

    if not q.partition_with:
        return q
    keymap = dict(q.partition_with)
    inp = q.input
    if isinstance(inp, ast.StreamInput):
        if inp.stream_id not in keymap:
            raise SiddhiQLError(
                f"stream {inp.stream_id!r} has no partition key; add "
                f"'<attr> of {inp.stream_id}' to the partition clause"
            )
        attr = keymap[inp.stream_id]
        if attr not in schemas[inp.stream_id]:
            raise SiddhiQLError(
                f"partition key {attr!r} is not an attribute of "
                f"{inp.stream_id!r}"
            )
        sel = q.selector
        has_agg = sel.group_by or any(
            ast.contains_aggregate(i.expr) for i in sel.items
        )
        if inp.windows:
            # per-partition window: EACH key's window holds that key's
            # last C events (NOT a group-by over one shared window) —
            # compiles to the per-key window artifact, which reads the
            # partition key from group_by (the canonical Siddhi
            # partition use; README.md:77-96)
            if q.output_events != "current":
                # per-key EXPIRY order differs from a shared window's;
                # silently compiling to shared-window expiry would be
                # exactly the wrong-answer class the partition carve-out
                # exists to prevent
                raise SiddhiQLError(
                    "'insert expired events into' inside 'partition "
                    "with' is not supported yet"
                )
            if not has_agg:
                # plain windowed projection emits arriving CURRENT
                # events unchanged; partitioning changes nothing
                return dataclasses.replace(q, partition_with=())
            bare = tuple(ast.bare_group_key(n) for n in sel.group_by)
            if attr not in bare:
                sel = dataclasses.replace(
                    sel, group_by=tuple(sel.group_by) + (attr,)
                )
            return dataclasses.replace(q, selector=sel)
        if has_agg and attr not in tuple(
            ast.bare_group_key(n) for n in sel.group_by
        ):
            sel = dataclasses.replace(
                sel, group_by=tuple(sel.group_by) + (attr,)
            )
            return dataclasses.replace(q, selector=sel)
        return q
    if isinstance(inp, ast.JoinInput):
        raise SiddhiQLError(
            "joins inside 'partition with' are not supported yet"
        )
    # pattern / sequence
    if inp.kind == "sequence":
        raise SiddhiQLError(
            "sequences inside 'partition with' are not supported yet "
            "(strict continuity is per-partition, not global)"
        )
    if not inp.every_:
        raise SiddhiQLError(
            "non-'every' patterns inside 'partition with' are not "
            "supported yet (the single-match rule is per partition key, "
            "but the engine's match gate is per instance)"
        )
    els = inp.elements
    el0 = els[0]
    if (el0.min_count, el0.max_count) != (1, 1):
        raise SiddhiQLError(
            "the first element of a partitioned pattern cannot be "
            "quantified yet"
        )
    if len(els) > 1 and els[1].group_link is not None:
        raise SiddhiQLError(
            "an 'and'/'or' group as the first step of a partitioned "
            "pattern is not supported yet"
        )
    for sid in {el.stream_id for el in els}:
        if sid not in keymap:
            raise SiddhiQLError(
                f"stream {sid!r} has no partition key; add "
                f"'<attr> of {sid}' to the partition clause"
            )
    new_els = [el0]
    attr0 = keymap[el0.stream_id]
    if attr0 not in schemas[el0.stream_id]:
        raise SiddhiQLError(
            f"partition key {attr0!r} is not an attribute of "
            f"{el0.stream_id!r}"
        )
    for el in els[1:]:
        if el.negated:
            raise SiddhiQLError(
                "absent ('not') elements inside 'partition with' "
                "patterns are not supported yet"
            )
        eq = ast.Binary(
            "==",
            ast.Attr(keymap[el.stream_id], qualifier=el.alias),
            ast.Attr(attr0, qualifier=el0.alias),
        )
        filt = (
            eq if el.filter is None else ast.Binary("and", el.filter, eq)
        )
        new_els.append(dataclasses.replace(el, filter=filt))
    return dataclasses.replace(
        q, input=dataclasses.replace(inp, elements=tuple(new_els))
    )


def _compile_query(
    q: ast.Query,
    name: str,
    schemas: Dict[str, StreamSchema],
    stream_codes: Dict[str, int],
    extensions: ExtensionRegistry,
    table_schemas: Optional[Dict[str, StreamSchema]] = None,
    config: EngineConfig = DEFAULT_CONFIG,
):
    table_schemas = table_schemas or {}
    q = _rewrite_partitioned(q, schemas)
    if q.output_stream in table_schemas or q.output_action in (
        "update", "delete",
    ):
        from .table import compile_table_write

        if q.output_stream not in table_schemas:
            raise SiddhiQLError(
                f"{q.output_action} target {q.output_stream!r} is not a "
                "defined table"
            )
        return compile_table_write(
            q, name, schemas, table_schemas, stream_codes, extensions,
            config,
        )
    inp = q.input
    if (
        isinstance(inp, ast.StreamInput)
        and inp.stream_id not in table_schemas  # table reads reject below
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
    if isinstance(inp, ast.JoinInput) and (
        inp.left.stream_id in table_schemas
        or inp.right.stream_id in table_schemas
    ):
        from .table import compile_table_join

        return compile_table_join(
            q, name, schemas, table_schemas, stream_codes, extensions,
            config,
        )
    if isinstance(inp, ast.StreamInput):
        if inp.stream_id in table_schemas:
            raise SiddhiQLError(
                f"cannot read table {inp.stream_id!r} as a stream; join a "
                "stream against it instead"
            )
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
        from .join import compile_join_query

        return compile_join_query(
            q, name, schemas, stream_codes, extensions, config
        )
    raise SiddhiQLError(f"unsupported input clause {type(inp).__name__}")


def _rewrite_aggregated_joins(parsed, table_schemas, all_schemas):
    """Expand ``from A join B ... select sum(x) group by k`` into the
    two-query chaining form: the join projects every referenced raw
    column into a synthesized intermediate stream; the aggregation runs
    over that stream. The reference composes multi-query plans the same
    way (package-info.java:19-51); this makes the single-query spelling
    — legal SiddhiQL — compile instead of raising a chaining hint."""
    import dataclasses

    out = []
    changed = False
    for q in parsed.queries:
        inp = q.input
        is_stream_join = isinstance(inp, ast.JoinInput) and not (
            inp.left.stream_id in table_schemas
            or inp.right.stream_id in table_schemas
        )
        sel = q.selector
        has_agg = any(
            ast.contains_aggregate(i.expr) for i in sel.items
        ) or bool(sel.group_by) or sel.having is not None
        if not (is_stream_join and has_agg) or q.output_action != "insert":
            out.append(q)
            continue
        if sel.is_star:
            raise SiddhiQLError(
                "select * with aggregation over a join is ambiguous; "
                "name the columns"
            )
        changed = True
        mid = f"@j:{q.output_stream}:{len(out)}"
        side_of = {
            inp.left.ref_name: inp.left.stream_id,
            inp.left.stream_id: inp.left.stream_id,
            inp.right.ref_name: inp.right.stream_id,
            inp.right.stream_id: inp.right.stream_id,
        }
        group_sources: Dict[str, str] = {}

        # every raw attr the outer selector/having reads gets a flat
        # alias on the intermediate stream
        mangled: Dict[Tuple, str] = {}
        join_items: List[ast.SelectItem] = []

        def flat(attr: ast.Attr) -> str:
            key = (attr.qualifier, attr.name)
            name = mangled.get(key)
            if name is None:
                name = (
                    f"{attr.qualifier}_{attr.name}"
                    if attr.qualifier
                    else attr.name
                )
                # collisions (e.g. `a_b` vs qualifier a, name b): suffix
                while any(i.alias == name for i in join_items):
                    name += "_"
                mangled[key] = name
                join_items.append(ast.SelectItem(attr, name))
                # provenance: which SOURCE column this flat field carries
                if attr.qualifier is not None:
                    sid = side_of.get(attr.qualifier)
                    if sid is not None:
                        group_sources[name] = f"{sid}.{attr.name}"
                else:
                    hits = [
                        sid
                        for sid in (
                            inp.left.stream_id, inp.right.stream_id
                        )
                        if sid in all_schemas
                        and attr.name in all_schemas[sid]
                    ]
                    if len(set(hits)) == 1:
                        group_sources[name] = f"{hits[0]}.{attr.name}"
            return name

        def _flat_attr(a: ast.Attr) -> ast.Attr:
            if a.index is not None:
                raise SiddhiQLError(
                    "indexed references are not valid on join queries"
                )
            return ast.Attr(flat(a))

        def rewrite(e: ast.Expr) -> ast.Expr:
            return ast.map_expr(e, _flat_attr)

        new_items = tuple(
            ast.SelectItem(rewrite(i.expr), i.output_name())
            for i in sel.items
        )
        out_aliases = {i.output_name() for i in sel.items}

        def rewrite_having(e: ast.Expr) -> ast.Expr:
            # having may reference SELECT aliases — those resolve
            # downstream against the aggregation's own output slots,
            # not against the join's raw columns
            return ast.map_expr(
                e,
                lambda a: (
                    a
                    if a.qualifier is None and a.name in out_aliases
                    else _flat_attr(a)
                ),
            )

        new_having = (
            rewrite_having(sel.having) if sel.having is not None else None
        )
        # group keys carry onto the intermediate stream under their
        # flattened alias (qualified keys keep their side)
        new_group = tuple(
            flat(ast.split_group_key(g)) for g in sel.group_by
        )

        join_q = dataclasses.replace(
            q,
            selector=ast.Selector(tuple(join_items)),
            output_stream=mid,
            name=(f"{q.name}@join" if q.name else None),
            output_rate=None,
        )
        agg_q = dataclasses.replace(
            q,
            input=ast.StreamInput(mid),
            selector=ast.Selector(new_items, new_group, new_having),
            group_sources=tuple(sorted(group_sources.items())),
        )
        out.extend([join_q, agg_q])
    if not changed:
        return parsed
    return dataclasses.replace(parsed, queries=tuple(out))


def _rewire_chained_group(art, enc, q, mid_sid, all_schemas, codes):
    """Group-by over a CHAINED stream: the group values exist only on
    device, so the host cannot build the code column. When the key's
    SOURCE column is known (synthesized join rewrites record it) and
    numeric, rewire: intern over the source column (intern-only, no wire
    column) and have the artifact map values -> codes on device from
    the synced sorted table."""
    import dataclasses as _dc

    from .window import CumulativeAggArtifact

    unsupported = SiddhiQLError(
        f"group by over chained stream {mid_sid!r} is not supported "
        "for this query shape (group keys are interned host-side but "
        "intermediate values exist only on device); group in the "
        "upstream query instead"
    )
    sources = dict(q.group_sources)
    if (
        not isinstance(art, CumulativeAggArtifact)
        or len(enc.in_keys) != 1
    ):
        raise unsupported
    mid_field = enc.in_keys[0].split(".", 1)[1]
    src_key = sources.get(mid_field)
    if src_key is None:
        raise unsupported
    src_sid, src_field = src_key.split(".", 1)
    atype = all_schemas[src_sid].field_type(src_field)
    if not (atype.is_numeric or atype.is_encoded):
        raise unsupported  # no ordered device representation to map
    # STRING/OBJECT keys work exactly like numerics here: both host
    # batches and device columns carry the shared-dictionary int32
    # CODES (schema/types.py is_encoded), so interning the source
    # column's codes and mapping value->group on device through the
    # synced sorted table is the same int32 searchsorted; group-key
    # output decode goes code -> string through the field decoder
    art.chained_group_src = enc.in_keys[0]
    art.chained_group_dtype = atype.device_dtype
    return _dc.replace(
        enc,
        in_keys=(src_key,),
        stream_code=codes[src_sid],
        select_fn=None,  # intern the source superset
        materialize=False,
    )


def _rewrite_all_events(parsed):
    """``insert all events into X``: siddhi emits BOTH arriving
    (current) and leaving (expired) window events into one stream.
    Re-expressed as two queries writing the same output — a current-
    events pass-through and the expired-events artifact — which is
    exactly what siddhi-core's StreamJunction receives from a window
    processor in ALL_EVENTS mode."""
    import dataclasses

    out = []
    changed = False
    for q in parsed.queries:
        if q.output_events != "all":
            out.append(q)
            continue
        if q.output_rate is not None:
            # the split halves would share one stream limiter, thinning
            # interleaved current/expired rows as one sequence — and
            # the multi-writer check would blame a "second query" the
            # user never wrote. Name the real combination instead.
            raise SiddhiQLError(
                "'insert all events into' combined with 'output ... "
                "every ...' is not supported; rate-limit the current-"
                "events and expired-events queries separately"
            )
        changed = True
        base = q.name or f"allq{len(out)}"
        out.append(
            dataclasses.replace(
                q, output_events="current", name=f"{base}@cur"
            )
        )
        out.append(
            dataclasses.replace(
                q, output_events="expired", name=f"{base}@exp"
            )
        )
    if not changed:
        return parsed
    return dataclasses.replace(parsed, queries=tuple(out))


def _rewrite_windowed_mutations(parsed, table_schemas):
    """``from S#window.x(...) select ... update T on ...`` (and delete):
    siddhi-core evaluates the window chain before the table mutation.
    Re-expressed through chaining: the windowed/aggregated selection
    emits into a synthesized intermediate stream; a plain mutate query
    consumes it (same device step)."""
    import dataclasses

    out = []
    changed = False
    for q in parsed.queries:
        windowed = (
            q.output_action in ("update", "delete")
            and q.output_stream in table_schemas
            and isinstance(q.input, ast.StreamInput)
            and (_windowed(q) or q.selector.having is not None)
        )
        if not windowed:
            out.append(q)
            continue
        changed = True
        mid = f"@t:{q.output_stream}:{len(out)}"
        win_q = dataclasses.replace(
            q,
            output_stream=mid,
            output_action="insert",
            on_condition=None,
            name=(f"{q.name}@win" if q.name else None),
            output_rate=None,  # rate-limiting applies to the MUTATION
        )
        # the mutate's projection carries only fields the mutation can
        # use: table columns and on-condition references (the windowed
        # query may also emit having-only fields like a count alias)
        tcols = set(table_schemas[q.output_stream].field_names)
        on_names = {
            a.name for a in ast.iter_attrs(q.on_condition)
        } if q.on_condition is not None else set()
        kept = tuple(
            ast.SelectItem(ast.Attr(i.output_name()), i.output_name())
            for i in q.selector.items
            if i.output_name() in tcols or i.output_name() in on_names
        )
        if not kept:
            raise SiddhiQLError(
                f"windowed {q.output_action} into {q.output_stream!r} "
                "selects no table column or on-condition field"
            )
        mut_q = dataclasses.replace(
            q,
            input=ast.StreamInput(mid),
            selector=ast.Selector(kept),
        )
        out.extend([win_q, mut_q])
    if not changed:
        return parsed
    return dataclasses.replace(parsed, queries=tuple(out))


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
    if "@tables" in fresh:
        out["@tables"] = load("@tables", states_np.get("@tables"),
                              fresh["@tables"])
    return out


def state_to_numpy(states: Dict) -> Dict:
    """The inverse of ``state_from_numpy``: every tensor fetched to the
    host as a numpy array, nested dicts kept."""
    if isinstance(states, dict):
        return {k: state_to_numpy(v) for k, v in states.items()}
    return states.detach().cpu().numpy()
