"""float32 subnormals: the port computes as the reference does on the CPU.

XLA on the CPU runs every float32 operation with flush-to-zero and
denormals-are-zero: a subnormal operand counts as a zero of its sign, and
a subnormal result becomes one. The port flushes the same way, explicitly
(``compiler/expr.py:ftz``), in its expressions (``compile_expr``) and in the
slot programs' plain evaluator (``slot_program._BINARY``), so both equal
``jnp`` under ``jit`` bit for bit on subnormal operands and results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_siddhi_tpu_torch.compiler import slot_program as sp
from flink_siddhi_tpu_torch.compiler.expr import ExprResolver, compile_expr
from flink_siddhi_tpu_torch.query.parser import parse_query
from flink_siddhi_tpu_torch.schema.stream_schema import StreamSchema

torch.set_num_threads(2)

TINY = np.float32(np.finfo(np.float32).tiny)
SUB = np.array([TINY / 4, -TINY / 4, TINY / 2**20, 3e-39, -3e-39, 1e-39],
               np.float32)
NORMAL = np.array([0.0, -0.0, TINY, -TINY, 1.5 * TINY, 2.0, -2.0, 1.0,
                   1e-30, 3e38, np.inf, -np.inf, np.nan], np.float32)


def _operands():
    vals = np.concatenate([SUB, NORMAL])
    a, b = np.meshgrid(vals, vals)
    # results that land among the subnormals: products and differences
    # of small normals
    rng = np.random.default_rng(5)
    ra = (rng.uniform(1, 2, 512) * TINY).astype(np.float32)
    rb = (rng.uniform(1, 2, 512) * TINY).astype(np.float32)
    rc = rng.uniform(1e-5, 0.99, 512).astype(np.float32)
    return (np.concatenate([a.ravel(), ra, ra, ra, rc * TINY]),
            np.concatenate([b.ravel(), rb, -rb, rc, rc]))


def parse_expression(text: str):
    return parse_query(f"from S[{text}] select x insert into o").input \
        .filters[0]


BINARY = {"+": jnp.add, "-": jnp.subtract, "*": jnp.multiply,
          "/": jnp.divide, "%": jnp.mod, "==": jnp.equal,
          "!=": jnp.not_equal, "<": jnp.less, "<=": jnp.less_equal,
          ">": jnp.greater, ">=": jnp.greater_equal}


def _same(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    if ref.dtype == np.float32:
        return (got.view(np.int32) == ref.view(np.int32)) | (
            np.isnan(got) & np.isnan(ref))
    return got == ref


@pytest.mark.parametrize("op", list(BINARY))
def test_expressions_flush_as_jnp_under_jit(op):
    a, b = _operands()
    ref = np.asarray(jax.jit(BINARY[op])(a, b))
    schema = StreamSchema([("x", "float"), ("y", "float")])
    ce = compile_expr(parse_expression(f"x {op} y"),
                      ExprResolver({"S": ("S", schema)}, "S"))
    got = ce.fn({"S.x": torch.from_numpy(a), "S.y": torch.from_numpy(b)})
    got = got.numpy()
    same = _same(got, ref)
    assert same.all(), (op, a[~same][:4], b[~same][:4], got[~same][:4],
                        ref[~same][:4])
    if op in ("+", "-", "*"):
        # the cases this test exists for: subnormal exact results
        exact = a.astype(np.float64)
        with np.errstate(invalid="ignore"):
            exact = {"+": exact + b, "-": exact - b, "*": exact * b}[op]
        assert ((np.abs(exact) < TINY) & (exact != 0)).sum() > 100


@pytest.mark.parametrize("op", list(BINARY))
def test_slot_programs_flush_as_jnp_under_jit(op):
    a, b = _operands()
    ref = np.asarray(jax.jit(BINARY[op])(a, b))
    code = {"+": sp.OP_ADD_F, "-": sp.OP_SUB_F, "*": sp.OP_MUL_F,
            "/": sp.OP_DIV_F, "%": sp.OP_MOD_F}.get(op)
    if code is None:
        code = sp.OP_EQ_F + sp._CMP.index(op)
    got = sp._BINARY[code](torch.from_numpy(a.view(np.int32)),
                           torch.from_numpy(b.view(np.int32))).numpy()
    if ref.dtype == np.float32:
        got = got.view(np.float32)
    else:
        got = got.astype(bool)
    same = _same(got, ref)
    assert same.all(), (op, a[~same][:4], b[~same][:4], got[~same][:4],
                        ref[~same][:4])


def test_unary_minus_keeps_subnormals_as_jnp():
    a, _ = _operands()
    ref = np.asarray(jax.jit(jnp.negative)(a))
    schema = StreamSchema([("x", "float")])
    ce = compile_expr(parse_expression("-x"),
                      ExprResolver({"S": ("S", schema)}, "S"))
    got = ce.fn({"S.x": torch.from_numpy(a)}).numpy()
    assert _same(got, ref).all()
    w = torch.from_numpy(a.view(np.int32))
    got = sp.eval_program((sp.OP_EVT, sp.OP_NEG_F), lambda c: w,
                          lambda c: w).numpy().view(np.float32)
    assert _same(got, ref).all()
    # the reference keeps a subnormal through a sign flip
    assert (np.abs(ref[:len(SUB)]) < TINY).all()
