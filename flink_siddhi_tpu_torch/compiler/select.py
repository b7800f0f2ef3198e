"""Stateless select/filter/projection queries.

``from S[pred] select a, b as c insert into Out`` compiles to a branch-free
masked pass over the tape: one predicate evaluation + projections for the
whole micro-batch (the per-event path of the reference is
SiddhiStreamOperator.processEvent -> siddhi-core filter processors,
SiddhiStreamOperator.java:51-54).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.types import AttributeType
from .expr import ColumnEnv, ExprResolver, as_column, compile_expr
from .output import OutputField, OutputSchema


@dataclass
class SelectArtifact:
    """Compiled stateless query. State = {'enabled': bool scalar} so a
    query can be paused/resumed (OperationControlEvent parity)."""

    name: str
    output_schema: OutputSchema
    output_mode: str  # 'aligned'
    stream_code: int
    filter_fns: List
    proj_fns: List

    def init_state(self, device) -> Dict:
        return {"enabled": torch.tensor(True, device=device)}

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = tape.valid & (tape.stream == self.stream_code)
        for f in self.filter_fns:
            mask = mask & f(env)
        mask = mask & state["enabled"]
        cap = tape.capacity
        cols = tuple(as_column(p(env), cap, tape.ts) for p in self.proj_fns)
        return state, (mask, tape.ts, cols)


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
    for f in inp.filters:
        ce = compile_expr(f, resolver, extensions)
        if ce.atype != AttributeType.BOOL:
            raise SiddhiQLError("stream filter must be boolean")
        filter_fns.append(ce.fn)

    items = query.selector.items
    if query.selector.is_star:
        schema = schemas[inp.stream_id]
        items = tuple(
            ast.SelectItem(ast.Attr(n), None) for n in schema.field_names
        )

    proj_fns = []
    out_fields = []
    for item in items:
        ce = compile_expr(item.expr, resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(
            OutputField(item.output_name(), ce.atype, ce.table)
        )
    return SelectArtifact(
        name=name,
        output_schema=OutputSchema(query.output_stream, tuple(out_fields)),
        output_mode="aligned",
        stream_code=stream_code,
        filter_fns=filter_fns,
        proj_fns=proj_fns,
    )
