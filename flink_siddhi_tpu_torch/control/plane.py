"""The dynamic query control plane: admission gate + runtime facade.

The port of ``flink_siddhi_tpu/control/plane.py``:

* :class:`AdmissionGate` — the *before it touches the running stack*
  check: compile the candidate, run ``analysis/plancheck.verify_plan``
  (PLC-series structural findings) AND ``analysis/admit.analyze_plan``
  (ADM-series resource verdicts against ``AdmissionBudgets``), and
  either return the JSON-safe admission summary a control event carries
  or raise :class:`ControlRejected` with the exact rule ids. The REST
  service calls it at the boundary (HTTP 422 with the rule ids); the
  executor re-checks at apply time. The gate runs on the caller's
  thread, off the run loop, and touches no CUDA device: the checks read
  meta tensors and step the CPU (a CUDA allocation or launch from
  another thread while the run loop captures a graph would break that
  capture).
* :class:`ControlPlane` — the programmatic facade over a running ``Job``
  and its ``ControlQueueSource`` (``admit`` / ``retire`` /
  ``set_enabled`` / ``status``). It never mutates the job: every
  mutation is a control event pushed onto the queue, applied at the
  next epoch boundary on the run-loop thread (a micro-batch in
  streaming mode, a segment in fused mode, a replay epoch in resident
  mode) — the path REST calls and a control topic take.

The executable cache (``control/aotcache.py``) waits for ROADMAP.md
Queue 1's graph cache, keyed by ``plan_signature``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .events import MetadataControlEvent, OperationControlEvent

__all__ = ["AdmissionGate", "ControlPlane", "ControlRejected"]


class ControlRejected(Exception):
    """A candidate query refused at admission. ``rules`` holds the exact
    rule ids; ``findings`` the rendered messages."""

    def __init__(self, rules: List[str], findings: List[str], summary=None):
        self.rules = list(rules)
        self.findings = list(findings)
        self.summary = summary
        super().__init__(
            "query admission rejected ["
            + ", ".join(self.rules)
            + "]:\n"
            + "\n".join(f"  {f}" for f in self.findings)
        )


class AdmissionGate:
    """Compile + statically verify + admission-analyze one CQL string.

    ``compile_fn(cql, plan_id) -> CompiledPlan`` is the caller's
    compiler (the same one the job's ``plan_compiler`` uses, so the gate
    judges exactly what would run). ``budgets`` is the tenant resource
    envelope (``analysis/admit.AdmissionBudgets``); None runs the
    report-only tiers (footprint + signature still computed)."""

    def __init__(
        self,
        compile_fn: Callable,
        budgets=None,
        capacity: int = 128,
    ) -> None:
        self.compile_fn = compile_fn
        self.budgets = budgets
        self.capacity = capacity

    def __call__(self, cql: str, plan_id: str = "candidate") -> dict:
        """Returns the JSON-safe admission summary
        (``AdmissionReport.summary()``), or raises
        :class:`ControlRejected` / the compiler's own ``SiddhiQLError``
        for unparsable input."""
        from ..analysis.admit import AdmissionError, analyze_plan
        from ..analysis.plancheck import PlanCheckError, verify_plan

        try:
            plan = self.compile_fn(cql, plan_id)
        except PlanCheckError as e:
            raise ControlRejected(
                [i.rule for i in e.issues],
                [i.render() for i in e.issues],
            ) from e
        except AdmissionError as e:
            raise ControlRejected(
                [i.rule for i in e.issues],
                [i.render() for i in e.issues],
                summary=e.report.summary() if e.report else None,
            ) from e
        # compile_plan may have verified already under FST_VERIFY_PLANS;
        # the tiers run again here, so the gate stands alone where the
        # variable is absent. Cheapest first, and nothing is allocated on
        # the host before the budgets pass: the static tier (pure
        # python), then the verdict on the meta-tensor footprint, then
        # the trace tier and the signature (one CPU step each, with the
        # plan's whole state on the host)
        def refuse(issues, summary=None):
            raise ControlRejected(
                [i.rule for i in issues], [i.render() for i in issues],
                summary=summary,
            )

        plc = verify_plan(plan, trace=False, raise_on_error=False)
        if plc:
            refuse(plc)
        report = analyze_plan(
            plan, budgets=self.budgets, capacity=self.capacity, deep=True,
            signature=False,
        )
        if report.findings:
            refuse(report.findings, report.summary())
        plc = verify_plan(plan, trace=True, raise_on_error=False)
        if plc:
            refuse(plc)
        report.signature = plan.signature(self.capacity)
        return report.summary()


class ControlPlane:
    """Programmatic admit/retire/status over a running job.

    Every mutation is a control event pushed onto ``control`` (the
    ``app.service.ControlQueueSource`` the job was built with), so it
    applies at the next epoch boundary on the run-loop thread; the fused
    segment pending at that boundary is dispatched first, so a mutation
    never tears a step."""

    def __init__(
        self,
        job,
        control,
        gate: Optional[AdmissionGate] = None,
    ) -> None:
        self.job = job
        self.control = control
        self.gate = gate

    # -- mutations (epoch-boundary, via control events) -----------------
    def admit(
        self,
        cql: str,
        plan_id: Optional[str] = None,
        tenant: Optional[str] = None,
        timestamp_ms: Optional[int] = None,
    ) -> str:
        """Gate (when configured) + push the add event. Returns the plan
        id (minted when not given); raises :class:`ControlRejected` when
        the gate refuses — a refused query never reaches the control
        stream at all."""
        b = MetadataControlEvent.builder()
        pid = plan_id or MetadataControlEvent.new_plan_id()
        summary = None
        if self.gate is not None:
            summary = self.gate(cql, plan_id=pid)
        b.add_execution_plan(cql, admission=summary, plan_id=pid)
        ev = b.build()
        ev.tenant = tenant
        self.control.push(ev, timestamp_ms=timestamp_ms)
        return pid

    def retire(
        self, plan_id: str, timestamp_ms: Optional[int] = None
    ) -> None:
        b = MetadataControlEvent.builder()
        b.remove_execution_plan(plan_id)
        self.control.push(b.build(), timestamp_ms=timestamp_ms)

    def set_enabled(
        self,
        plan_id: str,
        enabled: bool,
        timestamp_ms: Optional[int] = None,
    ) -> None:
        ev = (
            OperationControlEvent.enable_query(plan_id)
            if enabled
            else OperationControlEvent.disable_query(plan_id)
        )
        self.control.push(ev, timestamp_ms=timestamp_ms)

    # -- observation ----------------------------------------------------
    def status(self) -> Dict:
        """The job's live plans (enabled, fold host/slot, shared host,
        tenant), the ``control.*`` counters, the share table and the
        recent-rejection ring."""
        job = self.job
        plans = {}
        for pid, rt in list(job._plans.items()):
            if pid.startswith(("@dyn:", "@shr:")):
                continue
            plans[pid] = {"enabled": rt.enabled, "folded": None,
                          "tenant": job.tenant_of(pid)}
        for pid, skey in list(job._shared_member.items()):
            e = job._shared.get(skey)
            if e is not None and pid in plans:
                plans[pid]["shared"] = {
                    "host": e["host_id"],
                    "members": len(e["members"]),
                }
        for pid, (host, slot) in list(job._folded.items()):
            plans[pid] = {
                "enabled": job._folded_enabled.get(pid, True),
                "folded": {"host": host, "slot": slot},
                "tenant": job.tenant_of(pid),
            }
        out = dict(job.control_status())
        out["plans"] = plans
        return out
