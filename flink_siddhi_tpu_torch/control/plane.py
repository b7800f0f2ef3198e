"""The dynamic query control plane's runtime facade.

The port of ``flink_siddhi_tpu/control/plane.py``: :class:`ControlPlane`
is the programmatic facade over a running ``Job`` and its
``ControlQueueSource`` (``admit`` / ``retire`` / ``set_enabled`` /
``status``). It never mutates the job: every mutation is a control event
pushed onto the queue, applied at the next epoch boundary on the run-loop
thread (a micro-batch in streaming mode, a segment in fused mode, a replay
epoch in resident mode) — the path REST calls and a control topic take.

Not in the port yet: :class:`AdmissionGate`, which compiles a candidate
and runs the static plan checks and the admission analysis
(``analysis/plancheck.py`` and ``analysis/admit.py``) against resource
budgets; it raises naming ROADMAP.md Queue 1 item 12. The executable
cache (``control/aotcache.py``) waits for item 10's next slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

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
    """The admission gate: compile, statically verify and analyze one CQL
    string against resource budgets. Not in the torch port yet."""

    def __init__(self, compile_fn=None, budgets=None,
                 capacity: int = 128) -> None:
        raise NotImplementedError(
            "the admission gate (analysis/plancheck.py and "
            "analysis/admit.py over the port's plans) is not in the torch "
            "port yet (ROADMAP.md Queue 1 item 12); a control event's CQL "
            "is compiled and its carried verdict honored at apply time"
        )


class ControlPlane:
    """Programmatic admit/retire/status over a running job.

    Every mutation is a control event pushed onto ``control`` (the
    ``app.service.ControlQueueSource`` the job was built with), so it
    applies at the next epoch boundary on the run-loop thread; the fused
    segment pending at that boundary is dispatched first, so a mutation
    never tears a step."""

    def __init__(self, job, control, gate=None) -> None:
        if gate is not None:
            raise NotImplementedError(
                "ControlPlane(gate=...): the admission gate is not in the "
                "torch port yet (ROADMAP.md Queue 1 item 12)"
            )
        self.job = job
        self.control = control
        self.gate = None

    # -- mutations (epoch-boundary, via control events) -----------------
    def admit(
        self,
        cql: str,
        plan_id: Optional[str] = None,
        tenant: Optional[str] = None,
        timestamp_ms: Optional[int] = None,
    ) -> str:
        """Push the add event; returns the plan id (minted when not
        given)."""
        b = MetadataControlEvent.builder()
        pid = plan_id or MetadataControlEvent.new_plan_id()
        b.add_execution_plan(cql, plan_id=pid)
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
        """The job's live plans (enabled, fold host/slot, tenant), the
        ``control.*`` counters and the recent-rejection ring."""
        job = self.job
        plans = {}
        for pid, rt in list(job._plans.items()):
            if pid.startswith("@dyn:"):
                continue
            plans[pid] = {"enabled": rt.enabled, "folded": None,
                          "tenant": job.tenant_of(pid)}
        for pid, (host, slot) in list(job._folded.items()):
            plans[pid] = {
                "enabled": job._folded_enabled.get(pid, True),
                "folded": {"host": host, "slot": slot},
                "tenant": job.tenant_of(pid),
            }
        out = dict(job.control_status())
        out["plans"] = plans
        return out
