"""Plan verification and admission analysis over the port's plans.

The port of ``flink_siddhi_tpu/analysis``, without its JAX-specific lint
(``fstlint``, ``rules``, ``threads``, ``findings``, ``baseline``) and
its zoo fixtures:

* ``plancheck`` — the compiled-plan verifier (PLC-series rule ids):
  shape/dtype agreement, slot-NFA table well-formedness, padded-stack
  inertness and the state fixed point, run at ``compile_plan`` behind
  ``EngineConfig.verify_plans`` / ``FST_VERIFY_PLANS``.
* ``admit`` — admission-time resource analysis over the same plan
  (ADM-series rule ids): the device state and accumulator footprint read
  on meta tensors, per-event output amplification, unbounded-residency
  refusal, and the shape-bucket ``plan_signature``, with verdicts
  against configurable ``AdmissionBudgets``
  (``EngineConfig.admission_budgets``).
* ``share`` — cross-tenant common-subplan extraction (an exact copy of
  the reference's): the shareable filter prefix of a tenant query, its
  execution key, and the prefix/suffix split rendered back to CQL.

Nothing here touches a CUDA device: state shapes come from meta tensors
and a step's shapes from one CPU step over an all-invalid tape.
"""

from .admit import (
    ADM_RULES,
    AdmissionBudgets,
    AdmissionError,
    AdmissionIssue,
    AdmissionReport,
    DEFAULT_BUDGETS,
    STRICT_BUDGETS,
    admit_plan,
    analyze_plan,
    plan_signature,
    segment_signatures,
)
from .plancheck import PlanCheckError, PlanIssue, verify_plan

__all__ = [
    "ADM_RULES",
    "AdmissionBudgets",
    "AdmissionError",
    "AdmissionIssue",
    "AdmissionReport",
    "DEFAULT_BUDGETS",
    "STRICT_BUDGETS",
    "admit_plan",
    "analyze_plan",
    "plan_signature",
    "segment_signatures",
    "PlanCheckError",
    "PlanIssue",
    "verify_plan",
]
