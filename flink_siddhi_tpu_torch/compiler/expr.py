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
from typing import Callable, Dict, Optional, Tuple

import numpy as _np
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


# --------------------------------------------------------------------------
# float32 as the reference computes it: flush-to-zero and denormals-are-zero
# --------------------------------------------------------------------------
# XLA on the CPU runs every float32 operation with FTZ and DAZ: a subnormal
# operand counts as a (signed) zero and a subnormal result becomes one
# (``a - b``, ``a * b``, ``a / b``, the comparisons; unary minus is a sign
# flip and keeps a subnormal). The port applies the same flush explicitly,
# on every device: to the operands and the result of each float32
# operation, and to the operands of each float32 comparison.

_EXP_BITS = 0x7F800000
_SIGN_BIT = -0x80000000


def ftz(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor with each subnormal replaced by a zero of its
    sign; any other tensor as it is."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    w = x.view(torch.int32)
    return torch.where((w & _EXP_BITS) == 0, w & _SIGN_BIT,
                       w).view(torch.float32)


def fmod_exact(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """C's fmodf, exact (torch.fmod on the CPU divides first and can lose
    everything: fmod(-3e38, 1e-30) comes out NaN)."""
    if fa.device.type == "cpu" and fb.device.type == "cpu":
        fa, fb = torch.broadcast_tensors(fa, fb)
        with _np.errstate(invalid="ignore", divide="ignore"):
            return torch.from_numpy(_np.fmod(fa.contiguous().numpy(),
                                             fb.contiguous().numpy()))
    return torch.fmod(fa, fb)


def mod_f32(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """jnp.mod on float32 as the reference's CPU computes it: fmod of the
    operand over the flushed divisor (the remainder itself is exact and not
    flushed), then the divisor added when the flushed remainder's sign
    differs from it."""
    fb = ftz(fb)
    t = fmod_exact(fa, fb)
    tz = ftz(t)
    plus = ((tz < 0) != (fb < 0)) & (tz != 0)
    return torch.where(plus, ftz(tz + fb), t)


def _float_op(fn):
    """``fn`` over float32 operands with the reference's flush (operands
    and result); integer operands untouched."""
    def op(a, b):
        if a.dtype != torch.float32:
            return fn(a, b)
        return ftz(fn(ftz(a), ftz(b)))
    return op


def _float_cmp(fn):
    def op(a, b):
        if a.dtype != torch.float32:
            return fn(a, b)
        return fn(ftz(a), ftz(b))
    return op


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
            "+": _float_op(torch.add),
            "-": _float_op(torch.sub),
            "*": _float_op(torch.mul),
            # python-style sign of the result, as jnp.mod
            "%": (mod_f32 if dtype == torch.float32 else torch.remainder),
        }
        if op == "/":
            # Siddhi division: int/int stays integral (floored)
            if out_type in (AttributeType.INT, AttributeType.LONG):
                fn = lambda env: torch.floor_divide(
                    lf(env).to(dtype), rf(env).to(dtype)
                )
            else:
                div = _float_op(torch.div)
                fn = lambda env: div(lf(env).to(dtype), rf(env).to(dtype))
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
    cmp = _float_cmp(top)
    return CompiledExpr(
        lambda env: cmp(lf(env).to(dtype), rf(env).to(dtype)),
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



# --------------------------------------------------------------------------
# Host (numpy) predicate backend — wire predicate pushdown
# --------------------------------------------------------------------------
# A predicate whose columns serve no other device purpose can be evaluated
# on the host (numpy, at memory bandwidth) and shipped as ONE BIT per event
# instead of its raw columns. This is the numpy twin of compile_expr,
# restricted to the predicate-safe subset: literals, attribute reads,
# comparisons, boolean and arithmetic operators. Calls / extensions and
# indexed refs return None — those predicates stay on the device.
#
# Semantics note: host evaluation sees DOUBLE at float64 where the device
# sees float32 — host predicates are strictly *more* precise than the
# device path they replace (and match the reference's f64 semantics).
# Kept equal to the JAX package's copy (tests/test_torch_wire.py).


class _HostUnsupported(Exception):
    pass


@dataclass(frozen=True)
class HostExpr:
    fn: Callable  # Dict[str, np.ndarray] -> np.ndarray
    atype: AttributeType
    table: Optional[StringTable] = None
    refs: Tuple[str, ...] = ()  # tape column keys the fn reads


def compile_host_pred(
    expr: ast.Expr, resolver: ExprResolver
) -> Optional[HostExpr]:
    """Compile a boolean predicate to a numpy closure over host columns,
    or None when any sub-expression falls outside the host-safe subset."""
    try:
        he = _compile_host(expr, resolver)
    except (_HostUnsupported, SiddhiQLError):
        return None
    if he.atype != AttributeType.BOOL:
        return None
    return he


def _compile_host(expr: ast.Expr, resolver: ExprResolver) -> HostExpr:
    if isinstance(expr, ast.Literal):
        if expr.atype == AttributeType.STRING:
            value = expr.value
            return HostExpr(
                lambda env, v=value: v, AttributeType.STRING, None, ()
            )
        value = _np.asarray(expr.value, dtype=expr.atype.host_dtype)
        return HostExpr(lambda env, v=value: v, expr.atype, None, ())

    if isinstance(expr, ast.TimeLiteral):
        value = _np.asarray(expr.ms, dtype=_np.int64)
        return HostExpr(lambda env, v=value: v, AttributeType.LONG, None, ())

    if isinstance(expr, ast.Attr):
        if expr.index is not None:
            raise _HostUnsupported
        r = resolver.resolve(expr)
        key = r.key
        return HostExpr(
            lambda env, k=key: env[k], r.atype, r.table, (key,)
        )

    if isinstance(expr, ast.Unary):
        inner = _compile_host(expr.operand, resolver)
        if expr.op == "not":
            if inner.atype != AttributeType.BOOL:
                raise _HostUnsupported
            f = inner.fn
            return HostExpr(
                lambda env: _np.logical_not(f(env)),
                AttributeType.BOOL, None, inner.refs,
            )
        if expr.op == "-":
            f = inner.fn
            return HostExpr(
                lambda env: -f(env), inner.atype, None, inner.refs
            )
        raise _HostUnsupported

    if isinstance(expr, ast.Binary):
        return _compile_host_binary(expr, resolver)

    raise _HostUnsupported


def _compile_host_binary(expr: ast.Binary, resolver) -> HostExpr:
    op = expr.op
    left = _compile_host(expr.left, resolver)
    right = _compile_host(expr.right, resolver)
    refs = tuple(sorted(set(left.refs) | set(right.refs)))

    if op in ("and", "or"):
        if (
            left.atype != AttributeType.BOOL
            or right.atype != AttributeType.BOOL
        ):
            raise _HostUnsupported
        lf, rf = left.fn, right.fn
        fn = (
            (lambda env: _np.logical_and(lf(env), rf(env)))
            if op == "and"
            else (lambda env: _np.logical_or(lf(env), rf(env)))
        )
        return HostExpr(fn, AttributeType.BOOL, None, refs)

    nops = {
        "==": _np.equal, "!=": _np.not_equal, "<": _np.less,
        "<=": _np.less_equal, ">": _np.greater, ">=": _np.greater_equal,
    }
    if op in nops:
        nop = nops[op]
        lt, rt = left.atype, right.atype
        if AttributeType.STRING in (lt, rt):
            if op not in ("==", "!=") or lt != rt:
                raise _HostUnsupported
            # column vs literal: intern through the same dictionary the
            # device path uses, so codes agree
            if left.table is not None and isinstance(
                expr.right, ast.Literal
            ):
                code = left.table.intern(expr.right.value)
                lf = left.fn
                return HostExpr(
                    lambda env: nop(lf(env), code),
                    AttributeType.BOOL, None, refs,
                )
            if right.table is not None and isinstance(
                expr.left, ast.Literal
            ):
                code = right.table.intern(expr.left.value)
                rf = right.fn
                return HostExpr(
                    lambda env: nop(code, rf(env)),
                    AttributeType.BOOL, None, refs,
                )
            if (
                left.table is not None
                and right.table is not None
                and left.table is right.table
            ):
                lf, rf = left.fn, right.fn
                return HostExpr(
                    lambda env: nop(lf(env), rf(env)),
                    AttributeType.BOOL, None, refs,
                )
            raise _HostUnsupported
        if AttributeType.BOOL in (lt, rt):
            if lt != rt or op not in ("==", "!="):
                raise _HostUnsupported
        lf, rf = left.fn, right.fn
        return HostExpr(
            lambda env: nop(lf(env), rf(env)),
            AttributeType.BOOL, None, refs,
        )

    if op in ("+", "-", "*", "/", "%"):
        out_type = promote(left.atype, right.atype)
        lf, rf = left.fn, right.fn
        dtype = out_type.host_dtype
        if op == "/":
            if out_type in (AttributeType.INT, AttributeType.LONG):
                fn = lambda env: lf(env) // rf(env)
            else:
                fn = lambda env: (
                    _np.asarray(lf(env), dtype) / _np.asarray(rf(env), dtype)
                )
        else:
            nop2 = {
                "+": _np.add, "-": _np.subtract,
                "*": _np.multiply, "%": _np.mod,
            }[op]
            fn = lambda env: nop2(
                _np.asarray(lf(env), dtype), _np.asarray(rf(env), dtype)
            )
        return HostExpr(fn, out_type, None, refs)

    raise _HostUnsupported
