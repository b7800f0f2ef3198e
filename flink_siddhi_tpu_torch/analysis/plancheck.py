"""Compiled-plan verifier: invariants of the artifact stack.

The port of ``flink_siddhi_tpu/analysis/plancheck.py``. The compiler
emits artifact stacks whose steps a segment captures into a CUDA graph
bound to the runtime's state tensors; this pass validates the stack
BEFORE it reaches the device — the analog of the reference validating
every SiddhiQL plan at parse time (SiddhiManager.validateExecutionPlan)
instead of letting a miscompile surface as garbage rows three subsystems
later.

Rule families (each issue carries its rule id, the reference's):

* PLC1xx — shape/dtype agreement: every artifact's emissions must agree
  with its declared OutputSchema; chained consumers must see exactly the
  fields their producer declares.
* PLC2xx — slot-NFA well-formedness: positive/guard element tables
  partition the declared elements (no unreachable slots), absence
  guards sit only on declared ``not`` elements, quantifier and
  next-match table bounds hold.
* PLC3xx — padded multi-query stacks: all members share one chain
  signature, slot bookkeeping is consistent, and padding/free rows are
  actually row-inert (``deep=True`` drives an all-invalid tape through
  the concrete step and requires zero emissions).
* PLC4xx — state fixed point: a step must return states and an
  accumulator with the same keys, shapes and dtypes that it takes, or
  the state a captured segment's graph is bound to goes stale.

The port has no ``jax.eval_shape``: state and accumulator shapes are
read from ``init_state`` / ``init_acc`` on ``torch.device("meta")`` (no
allocation), and the step's shapes from ONE step on the CPU over the
64-event all-invalid tape (the steps have data-dependent shapes and host
reads a meta tensor cannot run; on CPU tensors the kernel wrappers take
their plain versions). The CPU step's accumulator keeps the meta
accumulator's rows and dtypes with its columns cut to the tape's width
(an append past them takes the step's own overflow path), so a check
never allocates the full device budget on the host. The states are
whole: a caller with admission budgets judges the meta-tensor footprint
first (``compile_plan``, the admission gate, the apply-time tier), so a
plan over its state budget is never stepped here. Nothing here touches
a CUDA device: the admission gate runs it off the run loop, while the
run loop may be capturing a graph.

Wired into ``compile_plan`` behind ``EngineConfig.verify_plans`` /
``FST_VERIFY_PLANS`` (``=1``: the static tier on every compile, as the
test lane sets it; ``=full``: the trace tier too; ``=0``: off).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_META = torch.device("meta")
_CPU = torch.device("cpu")


@dataclass(frozen=True)
class PlanIssue:
    rule: str
    where: str  # "plan_id/artifact" locator
    message: str

    def render(self) -> str:
        return f"{self.rule} [{self.where}] {self.message}"


class PlanCheckError(Exception):
    def __init__(self, issues: Sequence[PlanIssue]):
        self.issues = list(issues)
        super().__init__(
            "compiled-plan verification failed:\n"
            + "\n".join(f"  {i.render()}" for i in self.issues)
        )


def np_dtype(dt) -> np.dtype:
    """The numpy dtype of a torch dtype (or of anything numpy reads)."""
    if isinstance(dt, torch.dtype):
        return torch.empty(0, dtype=dt).numpy().dtype
    return np.dtype(dt)


def _zero_tape(plan, capacity: int = 64):
    """A concrete, all-invalid CPU tape matching the plan's TapeSpec —
    the inert input: a correct plan emits NOTHING for it."""
    from ..runtime.tape import build_tape

    return build_tape(plan.spec, [], 0, capacity=capacity).to(_CPU)


def _shape_env(plan, capacity: int = 64):
    """(state, acc, tape): state and accumulator on meta tensors (shapes
    only, no allocation), the inert tape on the CPU."""
    states = plan.init_state(_META)
    acc = plan.init_acc(_META)
    return states, acc, _zero_tape(plan, capacity)


def _cpu_acc(acc_meta, width: int):
    """A CPU accumulator with the meta one's keys, dtypes and rows, its
    columns cut to ``width``."""
    def cut(t):
        shape = list(t.shape)
        if len(shape) == 2 and shape[1] > width:
            shape[1] = width
        return torch.zeros(shape, dtype=t.dtype, device=_CPU)

    return _map_leaves(acc_meta, cut)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _cpu_step(plan, capacity: int):
    """One step of the plan on the CPU over the inert tape:
    (states before, states after, outputs)."""
    states = plan.init_state(_CPU)
    tape = _zero_tape(plan, capacity)
    new_states, outputs = plan.step(states, tape)
    return states, new_states, outputs


# --------------------------------------------------------------------------
# PLC1xx: schema agreement
# --------------------------------------------------------------------------


def _check_outputs(plan, issues: List[PlanIssue], outputs) -> None:
    """``outputs``: the CPU step's outputs, or the exception it raised."""
    if isinstance(outputs, Exception):  # any step failure is a reject
        e = outputs
        issues.append(
            PlanIssue(
                "PLC100",
                plan.plan_id,
                f"plan step does not trace: {type(e).__name__}: {e}",
            )
        )
        return
    for a in plan.artifacts:
        out = outputs.get(a.name)
        where = f"{plan.plan_id}/{a.name}"
        mode = getattr(a, "output_mode", "buffered")
        if out is None:
            issues.append(
                PlanIssue("PLC101", where, "artifact produced no output")
            )
            continue
        if mode == "packed":
            n, block = out[0], out[1]
            rows = int(block.shape[0])
            want = getattr(a, "acc_rows", None)
            if want is None:
                sch = getattr(a, "output_schema", None)
                want = 1 + len(sch.fields) if sch is not None else rows
            if rows != want:
                issues.append(
                    PlanIssue(
                        "PLC102",
                        where,
                        f"packed block has {rows} rows, artifact "
                        f"declares {want} (ts/qid/column row layout "
                        "drifted — the accumulator would misroute "
                        "columns)",
                    )
                )
            if np_dtype(block.dtype) != np.dtype(np.int32):
                issues.append(
                    PlanIssue(
                        "PLC103",
                        where,
                        f"packed block dtype {block.dtype} != int32 "
                        "(the accumulator stores bitcast int32 rows)",
                    )
                )
            if np_dtype(n.dtype).kind not in "iu":
                issues.append(
                    PlanIssue(
                        "PLC103", where, f"packed count dtype {n.dtype}"
                    )
                )
            continue
        # buffered: (n, ts, cols); aligned: (mask, ts, cols)
        head, ts, cols = out[0], out[1], list(out[2])
        sch = getattr(a, "output_schema", None)
        if sch is None:
            continue
        if len(cols) != len(sch.fields):
            issues.append(
                PlanIssue(
                    "PLC104",
                    where,
                    f"emits {len(cols)} columns, schema declares "
                    f"{len(sch.fields)}",
                )
            )
            continue
        for f, col in zip(sch.fields, cols):
            want_dt = np.dtype(f.atype.device_dtype)
            got_dt = np_dtype(col.dtype)
            if got_dt != want_dt:
                issues.append(
                    PlanIssue(
                        "PLC105",
                        where,
                        f"field {f.name!r} declared {want_dt} but the "
                        f"step emits {got_dt} — decode would bitcast "
                        "garbage",
                    )
                )
        if mode == "aligned" and np_dtype(head.dtype) != np.dtype(bool):
            issues.append(
                PlanIssue(
                    "PLC103",
                    where,
                    f"aligned mask dtype {head.dtype} != bool",
                )
            )

    # chained consumers: the synthetic tape is built from ci.fields —
    # they must BE the producer's current declared fields
    for consumer, ci in plan.chained.items():
        where = f"{plan.plan_id}/{consumer}"
        producer = next(
            (a for a in plan.artifacts if a.name == ci.producer), None
        )
        if producer is None:
            issues.append(
                PlanIssue(
                    "PLC106",
                    where,
                    f"chained producer {ci.producer!r} missing",
                )
            )
            continue
        declared = tuple(producer.output_schema.fields)
        if tuple(ci.fields) != declared:
            issues.append(
                PlanIssue(
                    "PLC106",
                    where,
                    "chained input field list drifted from producer "
                    f"schema ({[f.name for f in ci.fields]} vs "
                    f"{[f.name for f in declared]})",
                )
            )
        if ci.mode != producer.output_mode:
            issues.append(
                PlanIssue(
                    "PLC106",
                    where,
                    f"chained mode {ci.mode!r} != producer mode "
                    f"{producer.output_mode!r}",
                )
            )


# --------------------------------------------------------------------------
# PLC2xx: slot-NFA well-formedness
# --------------------------------------------------------------------------


def _check_nfa_tables(plan, issues: List[PlanIssue]) -> None:
    for a in plan.artifacts:
        hook = getattr(a, "nfa_check_info", None)
        if hook is None:
            continue
        for info in hook():
            _check_one_nfa(plan.plan_id, info, issues)


def _check_one_nfa(plan_id: str, info: Dict, issues: List[PlanIssue]) -> None:
    where = f"{plan_id}/{info['name']}"
    n = info["n_elements"]
    positive: Tuple[int, ...] = tuple(info["positive"])
    guards: Tuple[Tuple[int, ...], ...] = tuple(
        tuple(g) for g in info["guards"]
    )
    negated: Tuple[bool, ...] = tuple(info["negated"])
    t_guard: Optional[int] = info.get("t_guard")

    def bad(rule: str, msg: str) -> None:
        issues.append(PlanIssue(rule, where, msg))

    if n <= 0:
        bad("PLC201", "pattern has no elements")
        return
    if len(negated) != n:
        bad("PLC201", f"negated flags length {len(negated)} != {n}")
        return
    if not positive:
        bad("PLC201", "no positive elements (nothing can ever match)")
    if list(positive) != sorted(set(positive)) or any(
        not (0 <= p < n) for p in positive
    ):
        bad(
            "PLC202",
            f"positive element table {positive} is not a strictly "
            f"increasing subset of range({n})",
        )
        return
    if any(negated[p] for p in positive):
        bad("PLC202", "a negated element appears in the positive table")
    if len(guards) != len(positive):
        bad(
            "PLC203",
            f"guard table has {len(guards)} rows for "
            f"{len(positive)} positive steps",
        )
        return
    for k, gs in enumerate(guards):
        lo = positive[k - 1] if k else -1
        hi = positive[k]
        for g in gs:
            if not (0 <= g < n):
                bad("PLC203", f"guard index {g} out of range({n})")
            elif not negated[g]:
                bad(
                    "PLC203",
                    f"absence guard on element {g}, which is not a "
                    "declared 'not' element",
                )
            elif not (lo < g < hi):
                bad(
                    "PLC203",
                    f"guard {g} of step {k} lies outside its inter-"
                    f"positive window ({lo}, {hi}) — the next-match "
                    "scan would consult the wrong table row",
                )
    # first-occurrence entry guards (sequence absence folded before a
    # QUANTIFIED element): only on a non-negated, non-first element whose
    # quantifier is real and whose min count is >= 1
    quant = info.get("quantifiers")
    for g in tuple(info.get("entry_guards", ())):
        if not (0 <= g < n):
            bad("PLC203", f"entry guard index {g} out of range({n})")
        elif negated[g]:
            bad(
                "PLC203",
                f"first-occurrence entry guard on element {g}, which "
                "is itself a 'not' element",
            )
        elif g == 0:
            bad(
                "PLC203",
                "first-occurrence entry guard on element 0 — nothing "
                "precedes it, so no absence can have produced the guard",
            )
        elif quant is not None and tuple(quant[g]) == (1, 1):
            bad(
                "PLC203",
                f"first-occurrence entry guard on unquantified element "
                f"{g} — (1,1) absences fold into the element filter, "
                "not the count-conditional entry path",
            )
        elif quant is not None and quant[g][0] < 1:
            bad(
                "PLC203",
                f"first-occurrence entry guard on optional element {g} "
                "(min count 0) — a skip would bypass the guard entirely",
            )
    if t_guard is not None:
        if not (0 <= t_guard < n) or not negated[t_guard]:
            bad(
                "PLC204",
                f"terminal timed-absence guard {t_guard} is not a "
                "declared 'not' element",
            )
        elif t_guard != n - 1:
            bad(
                "PLC204",
                f"terminal timed-absence guard {t_guard} is not the "
                "last element",
            )
    covered = set(positive) | {g for gs in guards for g in gs}
    if t_guard is not None:
        covered.add(t_guard)
    unreachable = sorted(set(range(n)) - covered)
    if unreachable:
        bad(
            "PLC205",
            f"elements {unreachable} are unreachable (neither positive "
            "steps nor absence guards — dead slots in the transition "
            "table)",
        )
    if quant is not None:
        for i, (mn, mx) in enumerate(quant):
            if mn < 0 or (mx >= 0 and mx < mn):
                bad(
                    "PLC206",
                    f"element {i} quantifier <{mn}:{mx}> is malformed",
                )
    prefix = info.get("min_prefix")
    if prefix is not None:
        arr = np.asarray(prefix)
        if arr.ndim != 1 or np.any(np.diff(arr) < 0) or arr[0] != 0:
            bad(
                "PLC207",
                "min-count prefix table is not a monotone cumulative "
                "sum starting at 0 (optional-skip bounds would read "
                "out of range)",
            )
    groups = info.get("groups")
    if groups is not None:
        seen: List[int] = []
        for mem in groups:
            seen.extend(mem)
        if sorted(seen) != list(range(n)):
            bad(
                "PLC208",
                f"group table {groups} does not partition "
                f"range({n}) — transition steps would skip or "
                "double-count elements",
            )
    bits = info.get("mask_bits")
    if bits is not None and bits > 31:
        bad(
            "PLC209",
            f"match bitmask needs {bits} bits > 31 (wire word bound)",
        )


# --------------------------------------------------------------------------
# PLC3xx: padded multi-query stacks
# --------------------------------------------------------------------------


def _check_stacks(plan, issues: List[PlanIssue]) -> None:
    from ..compiler.nfa import (
        DynamicChainGroup,
        StackedChainArtifact,
        _ChainCfg,
    )

    for a in plan.artifacts:
        where = f"{plan.plan_id}/{a.name}"
        if isinstance(a, StackedChainArtifact):
            if not a.members:
                issues.append(
                    PlanIssue("PLC301", where, "stacked group is empty")
                )
                continue
            cfg0 = _ChainCfg.of(a.members[0].spec)
            for m in a.members[1:]:
                if _ChainCfg.of(m.spec) != cfg0:
                    issues.append(
                        PlanIssue(
                            "PLC301",
                            where,
                            f"member {m.name!r} does not share the "
                            "stack's chain signature — the stacked "
                            "advance would run the wrong transition "
                            "table for it",
                        )
                    )
            pools = {m.pool for m in a.members}
            if len(pools) != 1:
                issues.append(
                    PlanIssue(
                        "PLC302",
                        where,
                        f"members disagree on partial pool size {pools}",
                    )
                )
            if a.out_cap_factor < 1:
                issues.append(
                    PlanIssue(
                        "PLC302",
                        where,
                        f"out_cap_factor {a.out_cap_factor} < 1",
                    )
                )
        if isinstance(a, DynamicChainGroup):
            if len(a.members) != a.capacity:
                issues.append(
                    PlanIssue(
                        "PLC303",
                        where,
                        f"dynamic group member table has "
                        f"{len(a.members)} slots, capacity declares "
                        f"{a.capacity}",
                    )
                )


def _check_inert(plan, issues: List[PlanIssue], outputs) -> None:
    """deep check: drive an all-invalid tape through the CONCRETE step
    (on the CPU); a correct plan (including every padded / free slot
    row) emits nothing. A stale or garbage pad row shows up as a
    phantom emission here, not as garbage in a tenant's sink.
    ``outputs``: the step's outputs, or the exception it raised."""
    if isinstance(outputs, Exception):
        e = outputs
        issues.append(
            PlanIssue(
                "PLC310",
                plan.plan_id,
                f"concrete step failed on the inert tape: "
                f"{type(e).__name__}: {e}",
            )
        )
        return
    for a in plan.artifacts:
        out = outputs.get(a.name)
        if out is None:
            continue
        where = f"{plan.plan_id}/{a.name}"
        mode = getattr(a, "output_mode", "buffered")
        if mode == "aligned":
            n = int(out[0].sum())
        else:
            n = int(out[0])
        if n != 0:
            issues.append(
                PlanIssue(
                    "PLC311",
                    where,
                    f"{n} emission(s) from an all-invalid tape — "
                    "padding/free rows are not row-inert",
                )
            )


# --------------------------------------------------------------------------
# PLC4xx: the state fixed point
# --------------------------------------------------------------------------


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Tuple]:
    """Path -> (shape, dtype) of every tensor leaf of a nested
    dict/list/tuple (the reference's ``keystr`` paths)."""
    out: Dict[str, Tuple] = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(_leaf_paths(tree[k], f"{prefix}[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaf_paths(v, f"{prefix}[{i}]"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (tuple(int(d) for d in tree.shape),
                       np_dtype(tree.dtype))
    return out


def _check_donation(plan, issues: List[PlanIssue], capacity: int) -> None:
    states_meta, acc_meta, tape = _shape_env(plan, capacity)
    try:
        states = plan.init_state(_CPU)
        acc = _cpu_acc(acc_meta, capacity)
        acc_in = _leaf_paths(acc)
        new_states, new_acc = plan.step_acc(states, acc, tape)
    except Exception as e:  # noqa: BLE001
        issues.append(
            PlanIssue(
                "PLC400",
                plan.plan_id,
                f"step_acc does not trace: {type(e).__name__}: {e}",
            )
        )
        return
    for label, b, a_ in (
        ("states", _leaf_paths(states_meta), _leaf_paths(new_states)),
        ("acc", acc_in, _leaf_paths(new_acc)),
    ):
        for key in sorted(set(b) | set(a_)):
            if key not in a_:
                issues.append(
                    PlanIssue(
                        "PLC401",
                        f"{plan.plan_id}/{label}{key}",
                        "leaf consumed but not produced — the state a "
                        "captured graph is bound to would go stale",
                    )
                )
            elif key not in b:
                issues.append(
                    PlanIssue(
                        "PLC401",
                        f"{plan.plan_id}/{label}{key}",
                        "leaf produced but never consumed — the step "
                        "signature is not a fixed point, so a captured "
                        "segment cannot bind it",
                    )
                )
            elif b[key] != a_[key]:
                issues.append(
                    PlanIssue(
                        "PLC402",
                        f"{plan.plan_id}/{label}{key}",
                        f"shape/dtype changes across the step "
                        f"({b[key]} -> {a_[key]}) — the in-place "
                        "state binding cannot reuse the buffer",
                    )
                )


# --------------------------------------------------------------------------
# entry
# --------------------------------------------------------------------------


def verify_plan(
    plan,
    deep: bool = False,
    trace: bool = True,
    capacity: int = 64,
    raise_on_error: bool = True,
) -> List[PlanIssue]:
    """Validate one CompiledPlan, in up to three tiers.

    * static (always): NFA transition tables + padded-stack
      bookkeeping — pure python, microseconds. This is the tier the
      test lane's ``FST_VERIFY_PLANS=1`` applies to EVERY compile.
    * ``trace=True``: one CPU step over the inert tape, against the
      meta-tensor state shapes — schema agreement + the state fixed
      point (``config.verify_plans`` / ``FST_VERIFY_PLANS=full``).
    * ``deep=True``: the inert tape's emissions counted, proving
      padding/free rows are row-inert — the zoo pass.
    """
    issues: List[PlanIssue] = []
    _check_nfa_tables(plan, issues)
    _check_stacks(plan, issues)
    outputs = None
    if trace or deep:
        # one CPU step serves the schema and the inertness checks
        try:
            outputs = _cpu_step(plan, capacity)[2]
        except Exception as e:  # noqa: BLE001 — reported by each check
            outputs = e
    if trace:
        _check_outputs(plan, issues, outputs)
        _check_donation(plan, issues, capacity)
    if deep:
        _check_inert(plan, issues, outputs)
    if issues and raise_on_error:
        raise PlanCheckError(issues)
    return issues
