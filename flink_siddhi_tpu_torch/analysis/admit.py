"""Admission-time static analysis: resource bounds, plan signatures,
verdicts.

The port of ``flink_siddhi_tpu/analysis/admit.py``. plancheck answers
"is this compiled artifact stack WELL-FORMED"; this module answers the
question the dynamic control plane has to ask before a tenant query
touches the running stack: "what does it COST, is that cost bounded, and
which shape class does it belong to". The rule ids, budgets and knobs
are the reference's:

* **resource bounds** — the device state footprint (window rings at
  their declared/bucketed capacities, slot-NFA pools, sketch/group
  tables) and the output accumulator: the bytes ``init_state`` and
  ``init_acc`` would allocate, read on ``torch.device("meta")`` tensors
  (no allocation; the port's own layouts, so not the reference's
  numbers), plus per-event output amplification and residency facts
  from per-artifact ``cost_info()`` hooks (the cost twin of
  ``nfa_check_info()``).
* **unbounded-state detection** — per the Dataflow model (Akidau et
  al., VLDB 2015) unbounded out-of-order state must be *explicitly*
  bounded: an ``every`` pattern with no ``within`` clause pins
  partial-match slots forever, and a window-less join side retains
  semantically-unbounded history (the engine truncates both at fixed
  capacity with counted overflow). Under a residency budget these are
  REJECTED, not estimated.
* **shape-bucket plan signatures** — a canonical, process-stable hash of
  the step's shape/dtype fixed point (states/acc on meta tensors, the
  outputs of one CPU step over the inert tape) plus the bucket-padded
  tape dims and a constants-masked structural descriptor: two queries
  differing only in constants collide; a window width (or batch size)
  change that crosses a shape/bucket boundary splits. It is the key the
  graph cache is to be keyed by.

Nothing here touches a CUDA device (the admission gate runs it off the
run loop). Verdicts are findings with ADM-series rule ids evaluated
against a configurable :class:`AdmissionBudgets`; ``compile_plan`` wires
this in behind ``EngineConfig.admission_budgets`` / ``FST_VERIFY_PLANS``
tiers exactly like plancheck.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# rule id -> one-line description (the reference's ids and texts)
ADM_RULES = {
    "ADM001": (
        "artifact exposes no cost_info() hook — its resource envelope "
        "is unknowable, so admission rejects it (conservative default: "
        "a new artifact class must declare its costs where it is "
        "added, like nfa_check_info/zoo rows)"
    ),
    "ADM002": (
        "malformed cost_info(): hook returned something the analyzer "
        "cannot read (missing keys / wrong types)"
    ),
    "ADM003": (
        "footprint analysis failed: the plan's state constructors do "
        "not run on meta tensors"
    ),
    "ADM101": "worst-case device state footprint exceeds the budget",
    "ADM102": "device output accumulator footprint exceeds the budget",
    "ADM110": (
        "unbounded slot residency: an 'every' pattern with no 'within' "
        "clause arms a new partial match per trigger event and never "
        "expires any — slots pin until pool exhaustion (then matches "
        "drop with counted overflow). Rejected under a residency "
        "budget; add 'within <t>'"
    ),
    "ADM111": "declared state residency exceeds the budget",
    "ADM112": (
        "unbounded window retention: a window-less join side (or "
        "equivalent) semantically retains all history; the engine "
        "truncates at ring capacity with counted overflow — silently "
        "degraded answers. Rejected under a residency budget; declare "
        "#window.length/#window.time"
    ),
    "ADM120": (
        "per-event output amplification exceeds the budget (joins / "
        "patterns that can emit many rows per input event demand that "
        "multiple of sink bandwidth and accumulator space)"
    ),
}

_REQUIRED_COST_KEYS = ("name", "kind", "amplification", "residency_ms")


@dataclass(frozen=True)
class AdmissionIssue:
    rule: str
    where: str  # "plan_id/artifact" locator
    message: str

    def render(self) -> str:
        return f"{self.rule} [{self.where}] {self.message}"


class AdmissionError(Exception):
    def __init__(self, issues: Sequence[AdmissionIssue], report=None):
        self.issues = list(issues)
        self.report = report
        super().__init__(
            "plan admission rejected:\n"
            + "\n".join(f"  {i.render()}" for i in self.issues)
        )


@dataclass(frozen=True)
class AdmissionBudgets:
    """The tenant resource envelope admission enforces. ``None`` knobs
    impose no constraint (budgets are *policy* — the engine cannot
    guess them, so the defaults are deliberately generous: they bound
    the pathological, not the merely large)."""

    # worst-case device state footprint per plan (ADM101); the window
    # rings / NFA pools / group+sketch tables at admission-time bucket
    # shapes
    max_state_bytes: int = 8 << 20
    # device output accumulator (ADM102) — separately knobbed because
    # EngineConfig.acc_budget_bytes already bounds it per plan
    max_acc_bytes: int = 512 << 20
    # worst-case rows emitted per input event, per artifact (ADM120)
    max_amplification: int = 1 << 16
    # max time an admitted event may influence retained state
    # (ADM110/111/112). None = no residency requirement: patterns
    # without 'within' pass (the single-tenant default); a multi-tenant
    # profile sets it and unbounded residency is REJECTED, not estimated
    max_residency_ms: Optional[int] = None


DEFAULT_BUDGETS = AdmissionBudgets()
# the multi-tenant admission profile: every admitted plan must bound
# how long state can live
STRICT_BUDGETS = AdmissionBudgets(max_residency_ms=60_000)


@dataclass
class AdmissionReport:
    plan_id: str
    # sha256 hex of the shape-bucket class (None in the static tier)
    signature: Optional[str] = None
    # worst-case byte footprints (None in the static tier)
    state_bytes: Optional[int] = None
    acc_bytes: Optional[int] = None
    # max per-artifact worst-case rows-out per input event
    amplification: int = 0
    # max residency across artifacts: 0 stateless, float('inf')
    # unbounded, None = count-bounded eviction (no time dimension)
    residency_ms: Optional[float] = None
    per_artifact: Dict[str, dict] = field(default_factory=dict)
    findings: List[AdmissionIssue] = field(default_factory=list)

    @property
    def admitted(self) -> bool:
        return not self.findings

    def summary(self) -> dict:
        """JSON-safe verdict payload — what a MetadataControlEvent
        carries next to the CQL on add/update (control/events.py)."""
        res = self.residency_ms
        if res is not None and math.isinf(res):
            res = "unbounded"
        return {
            "admitted": self.admitted,
            "signature": self.signature,
            "state_bytes": self.state_bytes,
            "acc_bytes": self.acc_bytes,
            "amplification": int(self.amplification),
            "residency_ms": res,
            "findings": [
                {"rule": i.rule, "where": i.where, "message": i.message}
                for i in self.findings
            ],
        }


# --------------------------------------------------------------------------
# cost_info collection (the static tier: pure python, microseconds)
# --------------------------------------------------------------------------


def _collect_costs(plan, issues: List[AdmissionIssue]) -> List[dict]:
    infos: List[dict] = []
    for a in plan.artifacts:
        where = f"{plan.plan_id}/{a.name}"
        hook = getattr(a, "cost_info", None)
        if hook is None:
            issues.append(
                AdmissionIssue(
                    "ADM001",
                    where,
                    f"{type(a).__name__} exposes no cost_info() hook",
                )
            )
            continue
        try:
            info = dict(hook())
        except Exception as e:  # noqa: BLE001 — a broken hook is a reject
            issues.append(
                AdmissionIssue(
                    "ADM002",
                    where,
                    f"cost_info() raised {type(e).__name__}: {e}",
                )
            )
            continue
        missing = [k for k in _REQUIRED_COST_KEYS if k not in info]
        if missing:
            issues.append(
                AdmissionIssue(
                    "ADM002", where, f"cost_info() lacks keys {missing}"
                )
            )
            continue
        amp = info["amplification"]
        res = info["residency_ms"]
        if not isinstance(amp, (int, np.integer)) or amp < 0:
            issues.append(
                AdmissionIssue(
                    "ADM002", where, f"amplification {amp!r} is not a "
                    "non-negative int",
                )
            )
            continue
        if res is not None and not (
            isinstance(res, (int, float, np.integer, np.floating))
            and (res >= 0 or math.isinf(res))
        ):
            issues.append(
                AdmissionIssue(
                    "ADM002", where, f"residency_ms {res!r} is not "
                    "None, a non-negative number, or inf",
                )
            )
            continue
        info["where"] = where
        infos.append(info)
    return infos


# --------------------------------------------------------------------------
# footprint (the state constructors on meta tensors — no allocation)
# --------------------------------------------------------------------------


def _tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict/list/tuple (meta
    tensors carry shape and dtype only)."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return int(tree.numel()) * int(tree.element_size())
    return 0


def _footprints(plan, issues: List[AdmissionIssue]):
    meta = torch.device("meta")
    try:
        states = plan.init_state(meta)
        acc = plan.init_acc(meta)
    except Exception as e:  # noqa: BLE001
        issues.append(
            AdmissionIssue(
                "ADM003",
                plan.plan_id,
                f"state constructors do not trace: "
                f"{type(e).__name__}: {e}",
            )
        )
        return None, None
    return _tree_nbytes(states), _tree_nbytes(acc)


# --------------------------------------------------------------------------
# shape-bucket plan signature (the graph cache's key)
# --------------------------------------------------------------------------

_SIGNATURE_VERSION = 1

# AST int fields that hold parsed CONSTANTS (time spans), masked to
# presence so e.g. `within 5 sec` vs `within 6 sec` collide — they
# compile to literal operands of the same program shape, exactly like
# filter constants
_MASKED_INT_FIELDS = {
    ("PatternInput", "within"),
    ("JoinInput", "within"),
    ("PatternElement", "absent_for"),
    ("OutputRate", "n_events"),
    ("OutputRate", "ms"),
}


def _canon_ast(node):
    """Canonical, constants-masked rendering of a query-AST subtree:
    pure JSON-able lists/strings, stable across processes."""
    from ..query import ast as qast
    from ..schema.types import AttributeType

    if isinstance(node, qast.Literal):
        return ["const", node.atype.name]
    if isinstance(node, qast.TimeLiteral):
        return ["const", "time"]
    if isinstance(node, AttributeType):
        return node.name
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        cls = type(node).__name__
        out = [cls]
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if (cls, f.name) in _MASKED_INT_FIELDS:
                out.append([f.name, ["const?", v is not None]])
            else:
                out.append([f.name, _canon_ast(v)])
        return out
    if isinstance(node, (tuple, list)):
        return [_canon_ast(x) for x in node]
    if isinstance(node, frozenset):
        return sorted(_canon_ast(x) for x in node)
    if node is None or isinstance(node, (str, bool)):
        return node
    if isinstance(node, (int, float, np.integer, np.floating)):
        # bare numbers in the AST are STRUCTURE (quantifier bounds,
        # window grid slots), not user constants — those are Literals
        return node if np.isfinite(node) else str(node)
    return repr(node)


def _canon_shapes(tree) -> List:
    from .plancheck import _leaf_paths

    return sorted(
        [k, list(shape), dt.str]
        for k, (shape, dt) in _leaf_paths(tree).items()
    )


def plan_signature(plan, capacity: int = 128) -> str:
    """The shape-bucket class key for ``plan`` stepped at micro-batches
    of up to ``capacity`` events (padded to ``bucket_size``).

    Built from (1) the bucket-padded tape layout, (2) the step's
    shape/dtype fixed point — states, accumulator and per-artifact
    outputs; the shapes a captured segment is bound to — and (3) a
    constants-masked structural descriptor of the source queries.
    Identical keys <=> same shape class: a graph cache keyed by this
    hash pays the first capture once per shape, and two tenants
    differing only in constants land in the same class (their
    constants are data in the dynamic-group world, literal operands of
    an identical program shape otherwise).

    Process-stable by construction: sha256 over canonical JSON, no
    Python ``hash()``, no id()s, no iteration-order dependence. State
    and accumulator shapes come from meta tensors, the outputs' from
    one CPU step over the inert tape (no CUDA device is touched)."""
    from ..runtime.tape import bucket_size
    from .plancheck import _cpu_step

    cap = bucket_size(int(capacity))
    meta = torch.device("meta")
    states = plan.init_state(meta)
    acc = plan.init_acc(meta)
    outputs = _cpu_step(plan, cap)[2]
    payload = {
        "v": _SIGNATURE_VERSION,
        "capacity": cap,
        "tape": {
            "streams": sorted(plan.spec.stream_codes.items()),
            "columns": [
                [k, np.dtype(
                    plan.spec.column_types[k].device_dtype
                ).str]
                for k in plan.spec.columns
            ],
            "device_columns": (
                None
                if plan.spec.device_columns is None
                else list(plan.spec.device_columns)
            ),
            "host_preds": [
                [hp.out_key, np.dtype(hp.dtype).str]
                for hp in plan.spec.host_preds
            ],
            "encoded": [
                [e.out_key, list(e.in_keys), bool(e.materialize)]
                for e in plan.spec.encoded
            ],
        },
        "state": _canon_shapes(states),
        "acc": _canon_shapes(acc),
        "outputs": _canon_shapes(outputs),
        "artifacts": [
            [type(a).__name__, a.name, getattr(a, "output_mode", None)]
            for a in plan.artifacts
        ],
        "chained": sorted(
            [c, ci.producer, ci.stream_id, ci.mode]
            for c, ci in plan.chained.items()
        ),
        "structure": _canon_ast(plan.source_ast),
        "tape_capacity_limit": plan.tape_capacity_limit,
    }
    blob = json.dumps(
        payload, sort_keys=True, separators=(",", ":"), default=str
    )
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _query_segments(q) -> List:
    """Ordered constants-masked segment descriptors for one query:
    source, then each filter bracket, then each window (or each pattern
    element), then the selector/output tail. The segment grain matches
    the subplan-share split unit in ``analysis/share.py`` — the first
    ``filter`` segment IS the shareable prefix's shape class."""
    from ..query import ast as qast

    segs: List = []
    inp = q.input
    if isinstance(inp, qast.StreamInput):
        segs.append(["source", inp.stream_id])
        for f in inp.filters:
            segs.append(["filter", _canon_ast(f)])
        for w in inp.windows:
            segs.append(["window", _canon_ast(w)])
    elif isinstance(inp, qast.PatternInput):
        segs.append(
            ["source", sorted({el.stream_id for el in inp.elements}),
             inp.kind]
        )
        for el in inp.elements:
            segs.append(["element", _canon_ast(el)])
        segs.append(
            ["pattern-tail", inp.every_, inp.every_grouped,
             ["const?", inp.within is not None]]
        )
    else:
        segs.append(["join", _canon_ast(inp)])
    segs.append(
        ["select", _canon_ast(q.selector), _canon_ast(q.output_rate),
         q.output_events, q.output_action]
    )
    return segs


def segment_signatures(plan) -> List[List[str]]:
    """Per-query CUMULATIVE prefix signatures — the per-segment
    extension of :func:`plan_signature`.

    For each source query, entry ``i`` hashes segments ``0..i`` of that
    query's constants-masked descriptor chain; two queries whose first
    ``k`` segments are structurally equal (constants may differ) agree
    on their first ``k`` keys regardless of what follows, and a
    structural change at segment ``i`` changes keys ``i..n`` only.
    Process-stable exactly like ``plan_signature`` (sha256 over
    canonical JSON). The control plane's subplan-share ladder uses the
    EXACT-constants key from ``analysis/share.py`` to pick a live host;
    these masked keys are the shape-class bucket it reports against."""
    out: List[List[str]] = []
    for q in plan.source_ast.queries:
        run: List = []
        hashes: List[str] = []
        for seg in _query_segments(q):
            run.append(seg)
            blob = json.dumps(
                ["seg", _SIGNATURE_VERSION, run],
                sort_keys=True, separators=(",", ":"), default=str,
            )
            hashes.append(
                hashlib.sha256(blob.encode("utf-8")).hexdigest()
            )
        out.append(hashes)
    return out


# --------------------------------------------------------------------------
# verdicts
# --------------------------------------------------------------------------


def _budget_findings(
    report: AdmissionReport,
    infos: List[dict],
    budgets: AdmissionBudgets,
) -> List[AdmissionIssue]:
    out: List[AdmissionIssue] = []
    if (
        report.state_bytes is not None
        and report.state_bytes > budgets.max_state_bytes
    ):
        out.append(
            AdmissionIssue(
                "ADM101",
                report.plan_id,
                f"worst-case device state footprint "
                f"{report.state_bytes} B exceeds the "
                f"{budgets.max_state_bytes} B budget",
            )
        )
    if (
        report.acc_bytes is not None
        and report.acc_bytes > budgets.max_acc_bytes
    ):
        out.append(
            AdmissionIssue(
                "ADM102",
                report.plan_id,
                f"output accumulator footprint {report.acc_bytes} B "
                f"exceeds the {budgets.max_acc_bytes} B budget",
            )
        )
    for info in infos:
        where = info["where"]
        amp = int(info["amplification"])
        if amp > budgets.max_amplification:
            out.append(
                AdmissionIssue(
                    "ADM120",
                    where,
                    f"per-event output amplification {amp} exceeds "
                    f"the {budgets.max_amplification} budget",
                )
            )
        res = info["residency_ms"]
        if budgets.max_residency_ms is None or res is None:
            continue
        if math.isinf(res):
            kind = info.get("kind", "")
            rule = "ADM110" if kind in ("pattern",) else "ADM112"
            out.append(
                AdmissionIssue(
                    rule,
                    where,
                    info.get("unbounded")
                    or "state residency is unbounded",
                )
            )
        elif res > budgets.max_residency_ms:
            out.append(
                AdmissionIssue(
                    "ADM111",
                    where,
                    f"declared residency {int(res)} ms exceeds the "
                    f"{budgets.max_residency_ms} ms budget",
                )
            )
    return out


def analyze_plan(
    plan,
    budgets: Optional[AdmissionBudgets] = None,
    capacity: int = 128,
    deep: bool = True,
    signature: bool = True,
) -> AdmissionReport:
    """Produce an :class:`AdmissionReport` for one CompiledPlan.

    Tiers (mirroring plancheck's cost ladder):

    * static (always): per-artifact ``cost_info()`` collection +
      validation (ADM001/002) — pure python, microseconds. This is
      what ``FST_VERIFY_PLANS=1`` applies to EVERY test-lane compile.
    * ``deep=True``: footprint from the state constructors on meta
      tensors + the shape-bucket plan signature (one CPU step over the
      inert tape; no CUDA device touched).
    * ``budgets`` set: verdicts — findings against the budget knobs
      (implies the deep tier: a budget cannot be checked against an
      uncomputed footprint).

    The verdict comes before the signature: a plan the budgets refuse
    is never stepped on the host (its state is allocated on meta
    tensors only), so a refused report carries no signature.
    ``signature=False`` stops at the verdict (the admission gate's
    first pass, before the trace tier).
    """
    report = AdmissionReport(plan_id=plan.plan_id)
    issues: List[AdmissionIssue] = []
    infos = _collect_costs(plan, issues)
    amp = 0
    res: Optional[float] = None
    for info in infos:
        amp = max(amp, int(info["amplification"]))
        r = info["residency_ms"]
        if r is not None:
            res = float(r) if res is None else max(res, float(r))
    report.amplification = amp
    report.residency_ms = res
    report.per_artifact = {
        i["where"]: {k: v for k, v in i.items() if k != "where"}
        for i in infos
    }
    if deep or budgets is not None:
        report.state_bytes, report.acc_bytes = _footprints(plan, issues)
    if budgets is not None and not issues:
        issues.extend(_budget_findings(report, infos, budgets))
    report.findings = issues
    if signature and (deep or budgets is not None) and not issues:
        # the one CPU step (the outputs' shapes), with the plan's whole
        # state on the host: only for a plan within its budgets
        report.signature = plan.signature(capacity)
    return report


def admit_plan(
    plan,
    budgets: Optional[AdmissionBudgets] = None,
    capacity: int = 128,
    deep: bool = True,
    raise_on_reject: bool = True,
    signature: bool = True,
) -> AdmissionReport:
    """``analyze_plan`` + raise :class:`AdmissionError` on findings —
    the ``compile_plan`` hook point (same contract as
    ``plancheck.verify_plan``)."""
    report = analyze_plan(
        plan, budgets=budgets, capacity=capacity, deep=deep,
        signature=signature,
    )
    if report.findings and raise_on_reject:
        raise AdmissionError(report.findings, report)
    return report
