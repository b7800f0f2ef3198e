"""User function extensions.

Parity with ``SiddhiCEP.registerExtension`` (SiddhiCEP.java:201-206) and the
``FunctionExecutor`` contract (test fixture
extension/CustomPlusFunctionExtension.java:30-107: ``init`` validates argument
types, ``execute`` computes, ``getReturnType`` drives output typing). Here an
extension is a **torch callable over column tensors** — it runs inside the
batch step on the plan's device, once per micro-batch, instead of a per-event
JVM virtual call. The return type is either fixed or derived from argument
types (the reference fixture returns DOUBLE for any numeric mix; builtins
below promote instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch

from ..schema.types import AttributeType


@dataclass
class Extension:
    """An elementwise function over column tensors."""

    name: str  # 'namespace:fn' or bare 'fn'
    fn: Callable[..., torch.Tensor]
    # fixed return type, or callable(arg_types) -> AttributeType
    return_type: object = None

    def resolve_return_type(
        self, arg_types: Sequence[AttributeType]
    ) -> AttributeType:
        rt = self.return_type
        if rt is None:
            return _promote_numeric(arg_types)
        if callable(rt):
            return rt(arg_types)
        return rt


def _promote_numeric(arg_types: Sequence[AttributeType]) -> AttributeType:
    order = [
        AttributeType.INT,
        AttributeType.LONG,
        AttributeType.FLOAT,
        AttributeType.DOUBLE,
    ]
    best = AttributeType.INT
    for t in arg_types:
        if t in order and order.index(t) > order.index(best):
            best = t
    return best


class ExtensionRegistry:
    def __init__(self, parent: Optional["ExtensionRegistry"] = None):
        self._parent = parent
        self._by_name: Dict[str, Extension] = {}

    def register(
        self,
        name: str,
        fn: Callable[..., torch.Tensor],
        return_type: object = None,
    ) -> None:
        self._by_name[name] = Extension(name, fn, return_type)

    def lookup(self, name: str) -> Optional[Extension]:
        ext = self._by_name.get(name)
        if ext is None and self._parent is not None:
            return self._parent.lookup(name)
        return ext

    def child(self) -> "ExtensionRegistry":
        return ExtensionRegistry(parent=self)


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def builtin_registry() -> ExtensionRegistry:
    """Built-in scalar functions (subset of siddhi-core's math/str builtins)."""
    r = ExtensionRegistry()
    D = AttributeType.DOUBLE
    r.register("math:abs", lambda a: torch.abs(_t(a)))
    r.register("math:sqrt", lambda a: torch.sqrt(_t(a)), D)
    r.register("math:log", lambda a: torch.log(_t(a)), D)
    r.register("math:exp", lambda a: torch.exp(_t(a)), D)
    r.register("math:floor", lambda a: torch.floor(_t(a)), D)
    r.register("math:ceil", lambda a: torch.ceil(_t(a)), D)
    r.register("math:power", lambda a, b: torch.pow(_t(a), _t(b)))
    r.register("math:round", lambda a: torch.round(_t(a)))
    r.register("math:min", lambda a, b: torch.minimum(_t(a), _t(b)))
    r.register("math:max", lambda a, b: torch.maximum(_t(a), _t(b)))
    r.register("abs", lambda a: torch.abs(_t(a)))
    r.register(
        "ifThenElse",
        lambda c, a, b: torch.where(_t(c), _t(a), _t(b)),
        lambda ts: _promote_numeric(ts[1:]) if len(ts) > 1 else D,
    )
    r.register("coalesce", lambda a, b: a)  # nulls are masked upstream
    return r
