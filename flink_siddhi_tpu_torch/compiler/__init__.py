from .plan import CompiledPlan, compile_plan, state_from_numpy
from .expr import CompiledExpr, compile_expr, ExprResolver

__all__ = [
    "CompiledPlan",
    "compile_plan",
    "state_from_numpy",
    "CompiledExpr",
    "compile_expr",
    "ExprResolver",
]
