"""Expression -> vectorized torch closure compiler.

The reference evaluates predicates and projections per event inside the
embedded JVM engine (the inner loop of AbstractSiddhiOperator.java:209-233);
here every expression compiles once into a closure over column tensors — one
evaluation per *micro-batch*, all events in parallel on the plan's device.

Device dtypes follow ``schema/types.py``: LONG is int32 and DOUBLE is float32
on the device. A literal compiles to a 0-d CPU tensor of its device dtype,
which torch accepts as a scalar operand beside a CUDA column.

String semantics: STRING columns are dictionary codes (schema/strings.py), so
string equality compiles to int32 comparison; the constant is interned at
compile time, which keeps the mapping stable for the life of the plan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..device import torch_dtype
from ..extensions.registry import ExtensionRegistry
from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.strings import StringTable
from ..schema.types import AttributeType

# Environment handed to compiled closures: "streamId.field" -> tensor[E].
ColumnEnv = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ResolvedAttr:
    """Where an attribute reference lives on device."""

    key: str  # column key in the tape env
    atype: AttributeType
    table: Optional[StringTable] = None  # decode table for encoded types


class ExprResolver:
    """Maps ``Attr`` nodes to tape columns for one query context.

    ``scopes``: ref-name (stream id or alias) -> (stream_id, schema).
    Bare attributes resolve against ``default_scope`` first, then uniquely
    across all scopes (ambiguity is an error, matching Siddhi).
    """

    def __init__(self, scopes, default_scope: Optional[str] = None):
        self._scopes = dict(scopes)
        self._default = default_scope

    def resolve(self, attr: ast.Attr) -> ResolvedAttr:
        if attr.index is not None:
            raise SiddhiQLError(
                f"indexed reference {attr.qualifier}[{attr.index}] is only "
                "valid in pattern/sequence select clauses"
            )
        if attr.qualifier is not None:
            if attr.qualifier not in self._scopes:
                raise SiddhiQLError(
                    f"unknown stream reference {attr.qualifier!r}"
                )
            stream_id, schema = self._scopes[attr.qualifier]
            if attr.name not in schema:
                raise SiddhiQLError(
                    f"stream {attr.qualifier!r} has no attribute "
                    f"{attr.name!r}"
                )
            return self._resolved(stream_id, schema, attr.name)
        # bare name: default scope first
        if self._default is not None:
            stream_id, schema = self._scopes[self._default]
            if attr.name in schema:
                return self._resolved(stream_id, schema, attr.name)
        hits = [
            (sid, sch)
            for sid, sch in self._scopes.values()
            if attr.name in sch
        ]
        if not hits:
            raise SiddhiQLError(f"unknown attribute {attr.name!r}")
        if len({sid for sid, _ in hits}) > 1:
            raise SiddhiQLError(
                f"ambiguous attribute {attr.name!r}; qualify it with a "
                "stream name or alias"
            )
        return self._resolved(hits[0][0], hits[0][1], attr.name)

    @staticmethod
    def _resolved(stream_id, schema, name) -> ResolvedAttr:
        atype = schema.field_type(name)
        table = schema.string_tables.get(name)
        return ResolvedAttr(f"{stream_id}.{name}", atype, table)


@dataclass
class CompiledExpr:
    fn: Callable[[ColumnEnv], torch.Tensor]
    atype: AttributeType
    table: Optional[StringTable] = None  # set when output is decodable codes


_NUMERIC_ORDER = [
    AttributeType.INT,
    AttributeType.LONG,
    AttributeType.FLOAT,
    AttributeType.DOUBLE,
]


def promote(a: AttributeType, b: AttributeType) -> AttributeType:
    if a == b:
        return a
    if a in _NUMERIC_ORDER and b in _NUMERIC_ORDER:
        return _NUMERIC_ORDER[
            max(_NUMERIC_ORDER.index(a), _NUMERIC_ORDER.index(b))
        ]
    raise SiddhiQLError(f"cannot combine types {a.value} and {b.value}")


def as_column(x, width: int, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a column, or a scalar from a literal-only expression) as a
    ``[width]`` column on ``like``'s device. A scalar becomes a device
    fill, never a host->device copy (which would wait for the device)."""
    if isinstance(x, torch.Tensor) and x.device == like.device:
        return torch.broadcast_to(x, (width,))
    t = torch.as_tensor(x)
    return torch.full((width,), t.item(), dtype=t.dtype, device=like.device)


def as_i32(arr: torch.Tensor) -> torch.Tensor:
    """An int32 row of a column, as the accumulator packs it: float32 by
    its bit pattern (``view``, not a value cast), anything else by value."""
    if arr.dtype == torch.float32:
        return arr.view(torch.int32)
    return arr.to(torch.int32)


def _dt(atype: AttributeType) -> torch.dtype:
    return torch_dtype(atype.device_dtype)


def compile_expr(
    expr: ast.Expr,
    resolver: ExprResolver,
    extensions: Optional[ExtensionRegistry] = None,
) -> CompiledExpr:
    if isinstance(expr, ast.Literal):
        atype = expr.atype
        if atype == AttributeType.STRING:
            # bare string literal (not folded into an equality against a
            # column): keep host value; only comparisons use it
            value = expr.value
            return CompiledExpr(
                lambda env, v=value: v, atype, None
            )
        value = torch.tensor(expr.value, dtype=_dt(atype))
        return CompiledExpr(lambda env, v=value: v, atype, None)

    if isinstance(expr, ast.TimeLiteral):
        value = torch.tensor(expr.ms, dtype=torch.int32)
        return CompiledExpr(
            lambda env, v=value: v, AttributeType.LONG, None
        )

    if isinstance(expr, ast.Attr):
        r = resolver.resolve(expr)
        key = r.key
        return CompiledExpr(lambda env, k=key: env[k], r.atype, r.table)

    if isinstance(expr, ast.Unary):
        inner = compile_expr(expr.operand, resolver, extensions)
        if expr.op == "not":
            if inner.atype != AttributeType.BOOL:
                raise SiddhiQLError("'not' needs a boolean operand")
            f = inner.fn
            return CompiledExpr(
                lambda env: torch.logical_not(f(env)),
                AttributeType.BOOL,
            )
        if expr.op == "-":
            f = inner.fn
            return CompiledExpr(lambda env: -f(env), inner.atype)
        raise SiddhiQLError(f"unknown unary op {expr.op!r}")

    if isinstance(expr, ast.Binary):
        return _compile_binary(expr, resolver, extensions)

    if isinstance(expr, ast.Call):
        return _compile_call(expr, resolver, extensions)

    raise SiddhiQLError(f"cannot compile expression {expr!r}")


def _compile_binary(
    expr: ast.Binary,
    resolver: ExprResolver,
    extensions: Optional[ExtensionRegistry],
) -> CompiledExpr:
    op = expr.op
    left = compile_expr(expr.left, resolver, extensions)
    right = compile_expr(expr.right, resolver, extensions)

    if op in ("and", "or"):
        if (
            left.atype != AttributeType.BOOL
            or right.atype != AttributeType.BOOL
        ):
            raise SiddhiQLError(f"{op!r} needs boolean operands")
        lf, rf = left.fn, right.fn
        fn = (
            (lambda env: torch.logical_and(lf(env), rf(env)))
            if op == "and"
            else (lambda env: torch.logical_or(lf(env), rf(env)))
        )
        return CompiledExpr(fn, AttributeType.BOOL)

    if op in ("==", "!=", "<", "<=", ">", ">="):
        return _compile_comparison(op, expr, left, right)

    if op in ("+", "-", "*", "/", "%"):
        out_type = promote(left.atype, right.atype)
        lf, rf = left.fn, right.fn
        dtype = _dt(out_type)
        ops = {
            "+": torch.add,
            "-": torch.sub,
            "*": torch.mul,
            # python-style sign of the result, as jnp.mod
            "%": torch.remainder,
        }
        if op == "/":
            # Siddhi division: int/int stays integral (floored)
            if out_type in (AttributeType.INT, AttributeType.LONG):
                fn = lambda env: torch.floor_divide(
                    lf(env).to(dtype), rf(env).to(dtype)
                )
            else:
                fn = lambda env: torch.div(
                    lf(env).to(dtype), rf(env).to(dtype)
                )
        else:
            top = ops[op]
            fn = lambda env: top(lf(env).to(dtype), rf(env).to(dtype))
        return CompiledExpr(fn, out_type)

    raise SiddhiQLError(f"unknown binary op {op!r}")


def _compile_comparison(
    op: str, expr: ast.Binary, left: CompiledExpr, right: CompiledExpr
) -> CompiledExpr:
    tops = {
        "==": torch.eq,
        "!=": torch.ne,
        "<": torch.lt,
        "<=": torch.le,
        ">": torch.gt,
        ">=": torch.ge,
    }
    top = tops[op]

    lt, rt = left.atype, right.atype
    if AttributeType.STRING in (lt, rt):
        if op not in ("==", "!="):
            raise SiddhiQLError("strings only support == and !=")
        if lt != rt:
            raise SiddhiQLError("cannot compare string with non-string")
        # column vs literal: intern the constant into the column's table
        if left.table is not None and isinstance(expr.right, ast.Literal):
            code = left.table.intern(expr.right.value)
            lf = left.fn
            c = torch.tensor(code, dtype=torch.int32)
            return CompiledExpr(
                lambda env: top(lf(env), c), AttributeType.BOOL
            )
        if right.table is not None and isinstance(expr.left, ast.Literal):
            code = right.table.intern(expr.left.value)
            rf = right.fn
            c = torch.tensor(code, dtype=torch.int32)
            return CompiledExpr(
                lambda env: top(rf(env), c), AttributeType.BOOL
            )
        # column vs column: sound only when both share one dictionary
        if left.table is not None and right.table is not None:
            if left.table is not right.table:
                raise SiddhiQLError(
                    "cross-stream string comparison requires a shared "
                    "string dictionary (register the streams through one "
                    "CEP environment)"
                )
            lf, rf = left.fn, right.fn
            return CompiledExpr(
                lambda env: top(lf(env), rf(env)), AttributeType.BOOL
            )
        # literal vs literal: constant fold
        if isinstance(expr.left, ast.Literal) and isinstance(
            expr.right, ast.Literal
        ):
            lv = expr.left.value == expr.right.value
            res = torch.tensor(lv if op == "==" else not lv)
            return CompiledExpr(lambda env, r=res: r, AttributeType.BOOL)
        raise SiddhiQLError("unsupported string comparison")

    if AttributeType.BOOL in (lt, rt):
        if lt != rt or op not in ("==", "!="):
            raise SiddhiQLError("invalid boolean comparison")
        lf, rf = left.fn, right.fn
        return CompiledExpr(
            lambda env: top(lf(env), rf(env)), AttributeType.BOOL
        )

    dtype = _dt(promote(lt, rt))
    lf, rf = left.fn, right.fn
    return CompiledExpr(
        lambda env: top(lf(env).to(dtype), rf(env).to(dtype)),
        AttributeType.BOOL,
    )


def _compile_call(
    expr: ast.Call,
    resolver: ExprResolver,
    extensions: Optional[ExtensionRegistry],
) -> CompiledExpr:
    if ast.is_aggregate_call(expr):
        raise SiddhiQLError(
            f"aggregation {expr.name!r} is only valid in a select clause "
            "(compiled by the window/aggregation layer)"
        )
    if extensions is None:
        raise SiddhiQLError(
            f"no extension registry available for {expr.full_name!r}"
        )
    ext = extensions.lookup(expr.full_name)
    if ext is None:
        raise SiddhiQLError(
            f"unknown function {expr.full_name!r}; register it via "
            "register_extension()"
        )
    compiled_args = [
        compile_expr(a, resolver, extensions) for a in expr.args
    ]
    out_type = ext.resolve_return_type([a.atype for a in compiled_args])
    arg_fns = [a.fn for a in compiled_args]
    ext_fn = ext.fn
    dtype = _dt(out_type)

    def fn(env):
        vals = [f(env) for f in arg_fns]
        return torch.as_tensor(ext_fn(*vals)).to(dtype)

    return CompiledExpr(fn, out_type)

