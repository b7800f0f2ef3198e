"""Cross-element filters of the slot NFA as postfix programs over 32-bit words.

The reference compiles a cross-element filter (``s2 = S[price > s1.price]``)
with ``compile_expr`` and calls the closure inside its ``lax.scan`` body, on
the event's columns and every slot's captures (``flink_siddhi_tpu/compiler/
nfa.py:3115-3144``). In the port the scan is one CUDA kernel (K4,
``csrc/slot_nfa.cu``), which cannot call a torch closure. So each cross
filter compiles here into a short postfix program, and both the kernel and
its plain version (``cuda_ops.slot_nfa_scan_plain``) run that program: one
function on every device.

A program is a tuple of int32 words. A word holds an opcode in its low 8
bits and an argument above them; ``OP_LIT`` is followed by one literal
word. Every value on the stack is a 32-bit word: int32 by value, float32 by
its bit pattern, a boolean as 0 or 1. The device types of the port's
``compiler/expr.py`` are all 32-bit (INT and LONG are int32, FLOAT and
DOUBLE float32, STRING an int32 dictionary code), and its promotions are
reproduced exactly: an int32 operand of a float32 operation converts with
round-to-nearest-even (``OP_I2F``), int32 arithmetic wraps, float32
arithmetic rounds each operation on its own (no fused multiply-add) and
flushes as the reference's CPU does (a subnormal operand or result is a
zero of its sign: ``expr.ftz``).

Covered: loads of the event's own columns and of a slot's captures (first,
last and indexed), literals (numbers, time literals, interned strings),
``+ - * / %`` and unary ``-``, the six comparisons, ``and``, ``or`` (which
the kernel short-circuits), ``not``. ``/`` and ``%`` are the reference's
``jnp.floor_divide`` (int32), ``jnp.divide`` (float32) and ``jnp.mod``,
bit for bit: XLA's integer division by zero (``x // 0`` is -1 adjusted
for the signs, ``x % 0`` is 0) and ``INT_MIN // -1 == INT_MIN`` included.
A program's stack is as deep as it needs (the kernel sizes its stack from
the plan). A function call over the event's own columns is evaluated by
the caller over the whole batch (``derive``: a derived column the program
loads like an event column); a call whose arguments read a capture raises
``SiddhiQLError`` at compile time, on every device: a registered function
is a torch function over a batch and cannot run per slot inside the scan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..query import ast
from ..query.lexer import SiddhiQLError
from ..schema.types import AttributeType
from .expr import ResolvedAttr, _dt, compile_expr, ftz, mod_f32

# opcodes (csrc/slot_nfa.cu's enum Op)
OP_LIT = 1
OP_EVT = 2  # arg: event column
OP_CAP = 3  # arg: capture word of the slot
OP_I2F = 4
OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_NEG_I = 5, 6, 7, 8
OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_NEG_F = 9, 10, 11, 12
OP_EQ_I, OP_NE_I, OP_LT_I, OP_LE_I, OP_GT_I, OP_GE_I = 13, 14, 15, 16, 17, 18
OP_EQ_F, OP_NE_F, OP_LT_F, OP_LE_F, OP_GT_F, OP_GE_F = 19, 20, 21, 22, 23, 24
OP_AND, OP_OR, OP_NOT = 25, 26, 27
# short-circuit markers before the right operand of `and` / `or`: when the
# left operand decides (0 for `and`, 1 for `or`), skip ``arg`` words (the
# right operand and its OP_AND / OP_OR), leaving the left value. The
# operands have no side effects, so the kernel's skip and the plain
# version's evaluation of both sides give one value.
OP_ANDJ, OP_ORJ = 28, 29
OP_DIV_I, OP_MOD_I, OP_DIV_F, OP_MOD_F = 30, 31, 32, 33

_CMP = ("==", "!=", "<", "<=", ">", ">=")


def _later(what: str) -> SiddhiQLError:
    return SiddhiQLError(
        f"{what} in a cross-element filter is not in the torch port's slot "
        "program yet (ROADMAP.md Queue 1 item 8); the JAX package "
        "flink_siddhi_tpu runs it"
    )


def _promote(lk: str, rk: str) -> str:
    """compile_expr's numeric promotion on the program's types: int32 with
    float32 is float32."""
    if lk not in "if" or rk not in "if":
        raise SiddhiQLError(f"cannot combine {lk!r} and {rk!r} values")
    return "f" if "f" in (lk, rk) else "i"


def _kind(atype: AttributeType) -> str:
    """The program's type of a device value: 'i' int32, 'f' float32, 'b'
    bool, 's' string code."""
    if atype in (AttributeType.INT, AttributeType.LONG):
        return "i"
    if atype in (AttributeType.FLOAT, AttributeType.DOUBLE):
        return "f"
    if atype == AttributeType.BOOL:
        return "b"
    if atype == AttributeType.STRING:
        return "s"
    raise _later(f"a {atype.value} value")


@dataclass(frozen=True)
class SlotProgram:
    """A compiled filter before linking: ``code`` whose ``OP_EVT`` and
    ``OP_CAP`` arguments index ``evt_keys`` and ``cap_keys`` (the resolved
    attribute keys it reads), and its stack depth."""

    code: Tuple[int, ...]
    evt_keys: Tuple[str, ...]
    cap_keys: Tuple[str, ...]
    depth: int

    def link(self, evt_col: Callable[[str], int],
             cap_word: Callable[[str], int]) -> Tuple[int, ...]:
        """The program with each load's argument mapped to its event
        column (``evt_col(key)``) or capture word (``cap_word(key)``)."""
        out: List[int] = []
        i = 0
        while i < len(self.code):
            w = self.code[i]
            op, arg = w & 0xFF, w >> 8
            if op == OP_EVT:
                w = op | (evt_col(self.evt_keys[arg]) << 8)
            elif op == OP_CAP:
                w = op | (cap_word(self.cap_keys[arg]) << 8)
            out.append(w)
            if op == OP_LIT:
                out.append(self.code[i + 1])
                i += 1
            i += 1
        return tuple(out)


def _has_call(expr) -> bool:
    if isinstance(expr, ast.Call):
        return True
    if isinstance(expr, ast.Unary):
        return _has_call(expr.operand)
    if isinstance(expr, ast.Binary):
        return _has_call(expr.left) or _has_call(expr.right)
    return False


class _Compiler:
    def __init__(self, resolver, is_event: Callable[[str], bool],
                 derive: Optional[Callable] = None) -> None:
        self._resolver = resolver
        self._is_event = is_event
        self._derive = derive
        self.evt_keys: List[str] = []
        self.cap_keys: List[str] = []

    def _load_key(self, key: str, event: bool) -> List[int]:
        keys, op = ((self.evt_keys, OP_EVT) if event
                    else (self.cap_keys, OP_CAP))
        if key not in keys:
            keys.append(key)
        return [op | (keys.index(key) << 8)]

    def _load(self, r: ResolvedAttr) -> List[int]:
        return self._load_key(r.key, self._is_event(r.key))

    @staticmethod
    def _lit(value, atype: AttributeType) -> List[int]:
        """A literal's word, made as compile_expr makes the literal: a
        tensor of its device dtype."""
        t = torch.tensor(value, dtype=_dt(atype))
        if t.dtype == torch.float32:
            word = int(t.view(torch.int32))
        else:
            word = int(t.to(torch.int32))
        return [OP_LIT, word]

    def compile(self, expr) -> Tuple[List[int], str, object]:
        """(code, kind, string table or None) of ``expr``."""
        if self._derive is not None and _has_call(expr):
            # the largest one-sided subexpression holding a call: a column
            # the caller computes over the batch (an event column, unless
            # ``derive`` says otherwise with a fourth element)
            got = self._derive(expr)
            if got is not None:
                key, atype, table = got[:3]
                event = got[3] if len(got) > 3 else True
                return self._load_key(key, event), _kind(atype), table
        if isinstance(expr, ast.Literal):
            if expr.atype == AttributeType.STRING:
                return [], "s", None  # only inside a string comparison
            return self._lit(expr.value, expr.atype), _kind(expr.atype), None
        if isinstance(expr, ast.TimeLiteral):
            return self._lit(expr.ms, AttributeType.LONG), "i", None
        if isinstance(expr, ast.Attr):
            r = self._resolver.resolve(expr)
            return self._load(r), _kind(r.atype), r.table
        if isinstance(expr, ast.Unary):
            code, kind, _ = self.compile(expr.operand)
            if expr.op == "not":
                if kind != "b":
                    raise SiddhiQLError("'not' needs a boolean operand")
                return code + [OP_NOT], "b", None
            if expr.op == "-" and kind in ("i", "f"):
                return code + [OP_NEG_I if kind == "i" else OP_NEG_F], kind, \
                    None
            raise _later(f"unary {expr.op!r} on a {kind!r} value")
        if isinstance(expr, ast.Binary):
            return self._binary(expr)
        if isinstance(expr, ast.Call):
            raise SiddhiQLError(
                f"the function {expr.full_name!r} over an earlier element's "
                "capture in a cross-element filter is not in the torch "
                "port's slot program (ROADMAP.md Queue 1 item 8): a "
                "registered function is a torch function over a batch and "
                "cannot run per slot inside the scan; the JAX package "
                "flink_siddhi_tpu runs it"
            )
        raise _later(f"the expression {type(expr).__name__}")

    def _binary(self, expr: ast.Binary):
        op = expr.op
        lcode, lk, ltab = self.compile(expr.left)
        rcode, rk, rtab = self.compile(expr.right)
        if op in ("and", "or"):
            if lk != "b" or rk != "b":
                raise SiddhiQLError(f"{op!r} needs boolean operands")
            jump = (OP_ANDJ if op == "and" else OP_ORJ) | (
                (len(rcode) + 1) << 8)
            return lcode + [jump] + rcode + [
                OP_AND if op == "and" else OP_OR], "b", None
        if op in _CMP:
            return self._compare(expr, lcode, lk, ltab, rcode, rk, rtab), \
                "b", None
        if op in ("+", "-", "*", "/", "%"):
            out = _promote(lk, rk)
            lcode, rcode = self._to(lcode, lk, out), self._to(rcode, rk, out)
            fam = {"+": (OP_ADD_I, OP_ADD_F), "-": (OP_SUB_I, OP_SUB_F),
                   "*": (OP_MUL_I, OP_MUL_F), "/": (OP_DIV_I, OP_DIV_F),
                   "%": (OP_MOD_I, OP_MOD_F)}[op]
            return lcode + rcode + [fam[out == "f"]], out, None
        raise _later(f"the operator {op!r}")

    @staticmethod
    def _to(code: List[int], kind: str, out: str) -> List[int]:
        if kind == out:
            return code
        if kind == "i" and out == "f":
            return code + [OP_I2F]
        raise SiddhiQLError(f"cannot combine {kind!r} and {out!r} values")

    def _compare(self, expr, lcode, lk, ltab, rcode, rk, rtab) -> List[int]:
        op = expr.op
        idx = _CMP.index(op)
        if "s" in (lk, rk):
            if op not in ("==", "!="):
                raise SiddhiQLError("strings only support == and !=")
            if lk != rk:
                raise SiddhiQLError("cannot compare string with non-string")
            eq = OP_EQ_I + idx
            if ltab is not None and isinstance(expr.right, ast.Literal):
                return lcode + [OP_LIT, ltab.intern(expr.right.value), eq]
            if rtab is not None and isinstance(expr.left, ast.Literal):
                return rcode + [OP_LIT, rtab.intern(expr.left.value), eq]
            if ltab is not None and rtab is not None:
                if ltab is not rtab:
                    raise SiddhiQLError(
                        "cross-stream string comparison requires a shared "
                        "string dictionary (register the streams through "
                        "one CEP environment)"
                    )
                return lcode + rcode + [eq]
            if isinstance(expr.left, ast.Literal) and isinstance(
                expr.right, ast.Literal
            ):
                same = expr.left.value == expr.right.value
                return [OP_LIT, int(same if op == "==" else not same)]
            raise SiddhiQLError("unsupported string comparison")
        if "b" in (lk, rk):
            if lk != rk or op not in ("==", "!="):
                raise SiddhiQLError("invalid boolean comparison")
            return lcode + rcode + [OP_EQ_I + idx]
        out = _promote(lk, rk)
        base = OP_EQ_F if out == "f" else OP_EQ_I
        return self._to(lcode, lk, out) + self._to(rcode, rk, out) + \
            [base + idx]


def _depth(code) -> int:
    """The stack depth a program needs (and a check of its shape)."""
    sp = deepest = 0
    i = 0
    while i < len(code):
        op = code[i] & 0xFF
        if op in (OP_LIT, OP_EVT, OP_CAP):
            sp += 1
            i += 1 if op == OP_LIT else 0
        elif op not in (OP_I2F, OP_NEG_I, OP_NEG_F, OP_NOT, OP_ANDJ,
                        OP_ORJ):
            sp -= 1
        deepest = max(deepest, sp)
        i += 1
    if sp != 1:
        raise ValueError(f"malformed slot program {code}")
    return deepest


def compile_slot_program(expr: ast.Expr, resolver,
                         is_event: Callable[[str], bool],
                         derive: Optional[Callable] = None) -> SlotProgram:
    """Compile a boolean filter. ``resolver`` resolves its attributes (the
    slot NFA's ``_ElemFilterResolver``); ``is_event(key)`` tells an event
    column's key from a capture's. ``derive(expr)``, for a subexpression
    holding a function call, returns (column key, type, string table) of
    a column the caller computes over the batch when ``expr`` reads only
    the event, else None."""
    c = _Compiler(resolver, is_event, derive)
    code, kind, _ = c.compile(expr)
    if kind != "b":
        raise SiddhiQLError("pattern element filter must be boolean")
    return SlotProgram(tuple(code), tuple(c.evt_keys), tuple(c.cap_keys),
                       _depth(code))


@dataclass
class OnProgram:
    """An ``on`` condition (of a join or a table write) compiled for one
    arriving side: the linked program (event loads index ``evt_keys``, the
    other side's loads ``cap_keys``), its stack depth and those keys."""

    code: Tuple[int, ...]
    depth: int
    evt_keys: Tuple[str, ...]
    cap_keys: Tuple[str, ...]

    @classmethod
    def of(cls, p: SlotProgram) -> "OnProgram":
        return cls(p.link(p.evt_keys.index, p.cap_keys.index), p.depth,
                   p.evt_keys, p.cap_keys)


def compile_on(on: ast.Expr, resolver, extensions, arriving: Sequence[str],
               sides: Callable[[ast.Expr], set],
               key_side: Callable[[str], str],
               derived_key: Callable[[str, int], str],
               later_call: Callable[[ast.Call], SiddhiQLError]):
    """An ``on`` condition (already checked boolean) as one program per
    arriving side, and its derived columns. ``sides(expr)`` is the set of
    side tags ``expr`` reads (none: the arriving side's), ``key_side(key)``
    a resolved column key's side; a load is an event load when its side is
    the arriving one. A function call over one side is a derived column of
    that side, keyed ``derived_key(side, n)`` and shared by the programs;
    a call over two sides raises ``later_call(call)``. Returns
    ``({arriving side: OnProgram}, {key: (side, fn)})``."""
    derived: Dict[str, Tuple[str, Callable]] = {}
    by_node: Dict[int, Tuple] = {}

    def derive_for(arr: str):
        def derive(expr):
            tags = sides(expr) or {arr}
            if len(tags) != 1:
                if isinstance(expr, ast.Call):
                    raise later_call(expr)
                return None
            got = by_node.get(id(expr))
            if got is None:
                tag = next(iter(tags))
                key = derived_key(tag, len(derived))
                ce = compile_expr(expr, resolver, extensions)
                derived[key] = (tag, ce.fn)
                got = by_node[id(expr)] = (key, ce.atype, ce.table, tag)
            key, atype, table, tag = got
            return key, atype, table, tag == arr
        return derive

    progs = {}
    for arr in arriving:
        p = compile_slot_program(on, resolver,
                                 lambda key, a=arr: key_side(key) == a,
                                 derive_for(arr))
        progs[arr] = OnProgram.of(p)
    return progs, derived


# --------------------------------------------------------------------------
# The program in torch (the plain version's, and the tests' oracle)
# --------------------------------------------------------------------------

def _f(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.float32)


def _w(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _b(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _trunc_divmod(a: torch.Tensor, b: torch.Tensor):
    """XLA's truncating int32 division and remainder, in int64: x / 0 is
    -1 and x % 0 is x; INT_MIN / -1 comes out as 2^31 (INT_MIN once
    wrapped) and INT_MIN % -1 as 0."""
    a, b = torch.broadcast_tensors(a.long(), b.long())
    zero = b == 0
    q = torch.div(a, torch.where(zero, 1, b), rounding_mode="trunc")
    q = torch.where(zero, -1, q)
    r = torch.where(zero, a, a - q * b)
    return q, r


def _floor_div_i(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.floor_divide on int32 words."""
    q, r = _trunc_divmod(a, b)
    adj = (torch.sign(a.long()) != torch.sign(b.long())) & (r != 0)
    return (q - adj.long()).to(torch.int32)


def _mod_i(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.mod on int32 words: a zero divisor becomes 1."""
    d = torch.where(b == 0, 1, b)
    _, t = _trunc_divmod(a, d)
    plus = ((t < 0) != (d < 0)) & (t != 0)
    return torch.where(plus, t + d.long(), t).to(torch.int32)


def _mod_f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.mod on float32 words, with the reference's flush."""
    return _w(mod_f32(_f(a), _f(b)))


def _fop(fn):
    """A float32 operation on words, with the reference's flush of the
    operands and the result (``expr.ftz``)."""
    return lambda a, b: _w(ftz(fn(ftz(_f(a)), ftz(_f(b)))))


_BINARY = {
    OP_ADD_I: torch.add, OP_SUB_I: torch.sub, OP_MUL_I: torch.mul,
    OP_ADD_F: _fop(torch.add), OP_SUB_F: _fop(torch.sub),
    OP_MUL_F: _fop(torch.mul),
    OP_DIV_I: _floor_div_i, OP_MOD_I: _mod_i,
    OP_DIV_F: _fop(torch.div),
    OP_MOD_F: _mod_f,
    OP_AND: torch.bitwise_and, OP_OR: torch.bitwise_or,
}
for _i, _fn in enumerate((torch.eq, torch.ne, torch.lt, torch.le, torch.gt,
                          torch.ge)):
    _BINARY[OP_EQ_I + _i] = lambda a, b, fn=_fn: _b(fn(a, b))
    _BINARY[OP_EQ_F + _i] = lambda a, b, fn=_fn: _b(
        fn(ftz(_f(a)), ftz(_f(b))))


def eval_program(code, evt: Callable[[int], torch.Tensor],
                 cap: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """Run a linked program on int32 words: ``evt(c)`` is event column c's
    word(s), ``cap(w)`` capture word w's; they broadcast. Returns int32 0/1
    (or the one word of a literal-only program)."""
    stack: List[torch.Tensor] = []
    i = 0
    while i < len(code):
        w = code[i]
        op, arg = w & 0xFF, w >> 8
        if op == OP_LIT:
            i += 1
            stack.append(torch.tensor(code[i], dtype=torch.int32))
        elif op == OP_EVT:
            stack.append(evt(arg))
        elif op == OP_CAP:
            stack.append(cap(arg))
        elif op == OP_I2F:
            stack.append(_w(stack.pop().to(torch.float32)))
        elif op == OP_NEG_I:
            stack.append(torch.neg(stack.pop()))
        elif op == OP_NEG_F:
            stack.append(_w(torch.neg(_f(stack.pop()))))
        elif op == OP_NOT:
            stack.append(torch.bitwise_xor(stack.pop(), 1))
        elif op in (OP_ANDJ, OP_ORJ):
            pass  # both operands evaluated; OP_AND / OP_OR combines them
        else:
            b = stack.pop()
            stack.append(_BINARY[op](stack.pop(), b))
        i += 1
    return stack[0]
