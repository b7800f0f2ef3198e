"""Per-event scan windows: ``#window.unique(attr)``.

The torch port of ``flink_siddhi_tpu/compiler/scan_windows.py``, as far as
this slice goes. The unique window keeps the latest event per key (Siddhi's
``#window.unique:ever(attr)``, siddhi-execution-unique): an arriving event
replaces the one its key held, and every arriving event emits one row of
aggregates over the events the window holds. That evolution is sequential
in the event axis; the reference runs it as a ``lax.scan`` (or its Pallas
fold) over a fixed slot table carried across micro-batches, indexed by
host-interned key codes. Here the whole fold is one call of
``cuda_ops.unique_window_fold``: the CUDA kernel on the card, its plain
chunked version on the CPU.

The table buckets to the encoder's size (128 slots, doubling as keys
appear); the host knows that size, so growth (``grow_state``) never waits
for the device.

Not in this slice (each raises ``SiddhiQLError`` naming ROADMAP.md Queue 1
item 8): ``#window.sort`` with aggregates, ``#window.session``,
``#window.frequent``/``lossyFrequent``, unique inside ``partition with``,
unique over INT/LONG value columns (the reference folds those with an
integer ``lax.scan``), and more aggregates than the fold kernel's plan
holds (64).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..device import torch_dtype
from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.encoders import GroupEncoder
from ..schema.types import AttributeType
from .cuda_ops import (
    FOLD_MAX_ARGS,
    FOLD_MAX_SLOTS,
    unique_window_fold,
)
from .expr import ColumnEnv, ExprResolver, as_column, compile_expr
from .output import OutputField, OutputSchema
from .plan import _later
from .window import _Agg, _bucket, _group_encoding, _SlotResolver

_MIN_UNIQUE_CAPACITY = 128


@dataclass
class ScanWindowArtifact:
    """``#window.unique(attr)`` with aggregates, unpartitioned. State: the
    slot table — ``valid`` bool ``[C]`` and one ``a{j}`` column per
    aggregate argument — and ``enabled``; the reference's keys."""

    name: str
    output_schema: OutputSchema
    stream_code: int
    filter_fns: List
    code_key: str
    encoder: GroupEncoder
    aggs: List[_Agg]
    arg_fns: List[Callable]
    arg_types: List[AttributeType]
    proj_fns: List
    output_mode: str = "aligned"

    def _cap(self) -> int:
        return _bucket(len(self.encoder), _MIN_UNIQUE_CAPACITY)

    def init_state(self, device) -> Dict:
        C = self._cap()
        st = {
            "enabled": torch.tensor(True, device=device),
            "valid": torch.zeros(C, dtype=torch.bool, device=device),
        }
        for j, t in enumerate(self.arg_types):
            st[f"a{j}"] = torch.zeros(
                C, dtype=torch_dtype(t.device_dtype), device=device
            )
        return st

    def grow_state(self, state: Dict) -> Dict:
        """Re-bucket the table after host interning found new keys (a
        host-side size: no device wait)."""
        C = self._cap()
        if int(state["valid"].shape[0]) == C:
            return state
        out = {"enabled": state["enabled"]}
        for k, v in state.items():
            if k == "enabled":
                continue
            pad = torch.zeros(C, dtype=v.dtype, device=v.device)
            pad[: v.shape[0]] = v
            out[k] = pad
        return out

    def step(self, state: Dict, tape) -> Tuple[Dict, Tuple]:
        env: ColumnEnv = dict(tape.cols)
        mask = tape.valid & (tape.stream == self.stream_code)
        for f in self.filter_fns:
            mask = mask & f(env)
        mask = mask & state["enabled"]
        E = tape.capacity
        A = len(self.arg_types)
        C = int(state["valid"].shape[0])
        if C != self._cap():
            raise ValueError(
                f"{self.name}: a {C}-slot table for {len(self.encoder)} "
                "keys; grow the state first (CompiledPlan.grow_state)"
            )
        vals = (
            torch.stack([
                as_column(fn(env), E, tape.ts).to(torch.float32)
                for fn in self.arg_fns
            ])
            if A
            else torch.zeros((0, E), dtype=torch.float32, device=mask.device)
        )
        bufs0 = (
            torch.stack([state[f"a{j}"] for j in range(A)])
            if A
            else torch.zeros((0, C), dtype=torch.float32, device=mask.device)
        )
        slots = [(a.kind, a.arg_idx) for a in self.aggs]
        valid, bufs, rows = unique_window_fold(
            mask, env[self.code_key], vals, state["valid"], bufs0, slots
        )
        for s, a in enumerate(self.aggs):
            env[a.slot] = rows[s].to(torch_dtype(a.out_type.device_dtype))
        cols = tuple(as_column(p(env), E, tape.ts) for p in self.proj_fns)
        new_state = {"enabled": state["enabled"], "valid": valid}
        for j in range(A):
            new_state[f"a{j}"] = bufs[j]
        return new_state, (mask, tape.ts, cols)


def compile_scan_window(
    q: ast.Query,
    name: str,
    window,
    resolver: ExprResolver,
    stream_codes,
    extensions,
    filter_fns,
    rewritten,
    collector,
    having_re,
):
    kind, args = window
    inp = q.input
    if q.partition_with:
        if kind in ("frequent", "lossyFrequent"):
            raise SiddhiQLError(
                f"#window.{kind} inside 'partition with' is not "
                "supported yet"
            )
        raise _later(f"#window.{kind} inside 'partition with'", 8)
    if kind in ("session", "frequent", "lossyFrequent"):
        raise _later(f"#window.{kind}", 8)
    if q.selector.group_by:
        raise SiddhiQLError(
            f"group by over #window.{kind} is not supported yet"
        )
    if having_re is not None:
        raise SiddhiQLError(
            f"having over #window.{kind} is not supported yet"
        )
    for a in collector.aggs:
        if a.kind not in ("count", "sum", "avg", "min", "max"):
            raise SiddhiQLError(
                f"{a.kind}() is not supported over #window.{kind}"
            )
    if kind == "sort":
        raise _later("#window.sort with aggregates", 8)
    if len(args) != 1 or not isinstance(args[0], ast.Attr):
        raise SiddhiQLError("#window.unique needs one key attribute")
    if any(np.dtype(t.device_dtype) != np.float32
           for t in collector.arg_types):
        raise _later(
            "#window.unique over INT/LONG value columns (min/max/sum of "
            "an integer argument)", 8,
        )
    if (len(collector.aggs) > FOLD_MAX_SLOTS
            or len(collector.arg_types) > FOLD_MAX_ARGS):
        raise _later(
            f"#window.unique with more than {FOLD_MAX_SLOTS} aggregates or "
            f"{FOLD_MAX_ARGS} aggregated expressions", 8,
        )
    code_key, encoder, encoded = _group_encoding(
        name, [resolver.resolve(args[0])], stream_codes[inp.stream_id],
        filter_fns,
    )

    slot_types = {a.slot: a.out_type for a in collector.aggs}
    slot_resolver = _SlotResolver(resolver, slot_types)
    proj_fns: List = []
    out_fields: List[OutputField] = []
    for item in rewritten:
        ce = compile_expr(item.expr, slot_resolver, extensions)
        proj_fns.append(ce.fn)
        out_fields.append(
            OutputField(item.output_name(), ce.atype, ce.table)
        )

    art = ScanWindowArtifact(
        name=name,
        output_schema=OutputSchema(q.output_stream, tuple(out_fields)),
        stream_code=stream_codes[inp.stream_id],
        filter_fns=filter_fns,
        code_key=code_key,
        encoder=encoder,
        aggs=collector.aggs,
        arg_fns=collector.arg_fns,
        arg_types=collector.arg_types,
        proj_fns=proj_fns,
    )
    art.encoded_columns = tuple(encoded)
    return art
