"""Per-tenant SLO watchdog: objectives evaluated live off the scoped
registries, with multi-window burn rates and a journaled account.

Flink operators drive production decisions off continuously-evaluated
gauges (backpressure, PAPERS.md #1); this module is that layer for the
multi-tenant serving story. A tenant declares an :class:`SLOPolicy` —
a p99 latency objective over its merged drain histogram, a freshness
objective over the gate's watermark lag, and a loss budget over the
shared ingest's shed/late account — and the :class:`SLOWatchdog`
evaluates every policy at micro-batch **epoch boundaries** on the
run-loop thread (runtime/executor.py calls ``evaluate()`` once per
cycle, rate-limited by ``min_interval_s``; the call is a cheap no-op
when no policies are installed).

State model per tenant:

* each evaluation classifies the tenant **compliant** or **violating**
  (any breached objective = violating), with the breached objective
  names and measured values kept for the snapshot;
* a violating evaluation journals ``slo.violation`` into the flight
  recorder — the kind is RATE-COLLAPSED per tenant
  (telemetry/flightrec.py), so a sustained breach occupies O(1)
  journal slots while the exact evaluation count accumulates in the
  collapsed entry; the transition back to compliance journals one
  discrete ``slo.recovered``;
* **burn rates** follow the multi-window SRE convention: for each
  window in ``windows_s``, the fraction of evaluations inside the
  window that were violating, divided by the policy's error ``budget``
  (the fraction of time the tenant is allowed to be out of
  compliance). A burn rate of 1.0 spends the budget exactly; the
  short window catches a fast burn, the long window a slow leak.

The **reconciliation account**: ``snapshot()["journal"]`` re-derives
the violation/recovery totals from the flight recorder's ring
(``counts_by_kind`` counts a collapsed burst in full), and
``snapshot()["reconciled"]`` asserts they match the watchdog's own
tallies. ``bench.py --serve`` reads both sides through two different
REST routes (``/api/v1/slo`` and ``/api/v1/flightrecorder``) and the
schema gate requires exact agreement — the proof that the journaled
story and the counted story are the same story. (After a supervisor
restore the journal rolls back to the checkpoint with the rest of the
job state while a fresh watchdog starts at zero; the job factory
re-installs policies, and the account converges again from there —
``journal`` is the durable side, the in-memory tallies are
``fst:ephemeral`` like every other monotonic-clock state.)

Thread discipline (FST2xx): ``evaluate()`` runs only on the run-loop
thread; ``snapshot()`` / ``health_summary()`` run on the REST service
thread — all mutable state is guarded by one lock held only for
dict/deque operations.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# watermark sentinels (runtime/executor.py) — re-declared here rather
# than imported: telemetry must not import the runtime (layering)
_MAX_WM = (2 ** 63) - 1
_MIN_WM = -(2 ** 62)

DEFAULT_WINDOWS_S = (5.0, 60.0)


@dataclass(frozen=True)
class SLOPolicy:
    """One tenant's serving objectives. ``None`` disables an objective.

    * ``p99_ms`` — the tenant's merged ``drain.total`` p99 (the same
      bucket-exact fold ``metrics()["tenants"]`` publishes) must stay
      at or under this;
    * ``freshness_s`` — the gate's watermark lag (max event time ever
      pulled minus the released watermark) must stay at or under this:
      the "how stale can served results be" objective;
    * ``loss_ratio`` — the shared-ingest loss account
      (``late_dropped + shed_events`` over everything served) must
      stay at or under this fraction. Loss happens at the shared gate
      BEFORE per-plan attribution, so the measured value is job-wide
      by construction — the objective is per-tenant because the
      *budget* is the tenant's to set;
    * ``budget`` — allowed out-of-compliance fraction of evaluations
      (the error budget the burn rates are stated against);
    * ``windows_s`` — burn-rate windows, short to long.
    """

    tenant: str
    p99_ms: Optional[float] = None
    freshness_s: Optional[float] = None
    loss_ratio: Optional[float] = None
    budget: float = 0.01
    windows_s: Tuple[float, ...] = DEFAULT_WINDOWS_S

    def objectives(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.p99_ms is not None:
            out["p99_ms"] = float(self.p99_ms)
        if self.freshness_s is not None:
            out["freshness_s"] = float(self.freshness_s)
        if self.loss_ratio is not None:
            out["loss_ratio"] = float(self.loss_ratio)
        return out


@dataclass
class _TenantState:
    """fst:ephemeral per-tenant burn/violation state (re-armed after a
    restore; the durable account is the checkpointed journal)."""

    active: bool = False  # currently violating
    evaluations: int = 0
    violations: int = 0  # violating evaluations (journal parity)
    recoveries: int = 0
    breaches: List[str] = field(default_factory=list)
    measured: Dict[str, float] = field(default_factory=dict)
    last_violation_seq: Optional[int] = None
    # (t_mono, violating) per evaluation, pruned to the longest window
    history: deque = field(default_factory=deque)


class SLOWatchdog:
    """Evaluates :class:`SLOPolicy` objectives for one Job (see module
    docstring). Created unconditionally in ``Job.__init__`` — without
    policies every ``evaluate()`` returns immediately."""

    def __init__(self, job, min_interval_s: float = 0.25) -> None:
        self._job = job
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._policies: Dict[str, SLOPolicy] = {}
        self._states: Dict[str, _TenantState] = {}
        self._last_eval_t: Optional[float] = None
        self._evaluations = 0

    # -- policy management (run-loop or setup thread, pre-run) ---------------
    def set_policy(self, policy: SLOPolicy) -> None:
        if not isinstance(policy, SLOPolicy):
            raise TypeError(type(policy).__name__)
        with self._lock:
            self._policies[policy.tenant] = policy
            self._states.setdefault(policy.tenant, _TenantState())

    def remove_policy(self, tenant: str) -> None:
        with self._lock:
            self._policies.pop(tenant, None)
            self._states.pop(tenant, None)

    @property
    def policies(self) -> Dict[str, SLOPolicy]:
        with self._lock:
            return dict(self._policies)

    # -- measurement ---------------------------------------------------------
    def _measure(self, tenant: str, policy: SLOPolicy) -> Dict[str, float]:
        """Current measured value per declared objective, read from the
        job's scoped registries and gate state. Missing data (no drain
        samples yet, pre-first-event watermark) simply omits the
        objective — absent is honest, and a tenant cannot breach an
        objective nothing has measured yet."""
        job = self._job
        out: Dict[str, float] = {}
        if policy.p99_ms is not None:
            reg = job.telemetry
            pids = [
                pid
                for pid in reg.scope_map("plan")
                if not pid.startswith(("@dyn:", "@shr:"))
                and job.tenant_of(pid) == tenant
            ]
            if pids:
                hist = reg.merged_scope_histogram(
                    "plan", pids, "drain.total"
                )
                p99 = hist.percentile_ms(99)
                if p99 is not None:
                    out["p99_ms"] = round(float(p99), 3)
        if policy.freshness_s is not None:
            max_ts = getattr(job, "_max_event_ts", None)
            gate = getattr(job, "_gate_wm", _MIN_WM)
            if (
                max_ts is not None
                and _MIN_WM < gate < _MAX_WM
            ):
                out["freshness_s"] = round(
                    max(int(max_ts) - int(gate), 0) / 1e3, 3
                )
        if policy.loss_ratio is not None:
            lost = int(getattr(job, "late_dropped", 0)) + int(
                getattr(job, "shed_events", 0)
            )
            served = int(getattr(job, "processed_events", 0)) + lost
            if served > 0:
                out["loss_ratio"] = round(lost / served, 6)
        return out

    # -- evaluation (run-loop thread; fst:runloop-only) ----------------------
    def evaluate(self, now: Optional[float] = None) -> None:
        """One epoch-boundary evaluation pass over every policy,
        rate-limited to ``min_interval_s``. No-op without policies or
        when the job's telemetry is disabled (the watchdog reads the
        registries; with them off there is nothing true to say)."""
        with self._lock:
            if not self._policies:
                return
            policies = list(self._policies.items())
        tel = getattr(self._job, "telemetry", None)
        if tel is None or not tel.enabled:
            return
        t = time.monotonic() if now is None else float(now)
        if (
            self._last_eval_t is not None
            and t - self._last_eval_t < self.min_interval_s
        ):
            return
        self._last_eval_t = t
        frec = getattr(self._job, "flightrec", None)
        for tenant, policy in policies:
            measured = self._measure(tenant, policy)
            breaches = sorted(
                name
                for name, objective in policy.objectives().items()
                if name in measured and measured[name] > objective
            )
            violating = bool(breaches)
            seq = None
            if frec is not None:
                if violating:
                    # collapsible per tenant: a sustained breach is one
                    # journal entry with the evaluation count riding in
                    # ``collapsed`` (+ the latest measured values)
                    # measured rides as ONE dict value: the collapse
                    # fold adds numeric fields (count semantics), and
                    # a gauge like p99 must not accumulate across a
                    # burst — "latest wins" is what a dict gets
                    seq = frec.record(
                        "slo.violation",
                        tenant=tenant,
                        objectives=breaches,
                        measured=dict(measured),
                    )
                else:
                    with self._lock:
                        was_active = self._states[
                            tenant
                        ].active if tenant in self._states else False
                    if was_active:
                        frec.record("slo.recovered", tenant=tenant)
            with self._lock:
                st = self._states.setdefault(tenant, _TenantState())
                st.evaluations += 1
                st.breaches = breaches
                st.measured = measured
                if violating:
                    st.violations += 1
                    if seq is not None:
                        st.last_violation_seq = seq
                elif st.active:
                    st.recoveries += 1
                st.active = violating
                longest = max(policy.windows_s) if policy.windows_s else 0.0
                st.history.append((t, violating))
                while st.history and t - st.history[0][0] > longest:
                    st.history.popleft()
        with self._lock:
            self._evaluations += 1

    # -- reading (any thread) ------------------------------------------------
    @staticmethod
    def _burn_rates(
        history, windows_s: Tuple[float, ...], budget: float, now: float
    ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        budget = max(float(budget), 1e-9)
        for w in windows_s:
            inside = [v for (ts, v) in history if now - ts <= w]
            frac = (
                sum(1 for v in inside if v) / len(inside)
                if inside
                else 0.0
            )
            out[f"{w:g}s"] = round(frac / budget, 4)
        return out

    def snapshot(self) -> Dict[str, object]:
        """The ``Job.metrics()["slo"]`` / ``GET /api/v1/slo`` view:
        per-tenant compliance, burn rates, tallies, and the journal
        reconciliation account."""
        now = time.monotonic()
        with self._lock:
            policies = dict(self._policies)
            states = {
                t: (
                    st.active,
                    st.evaluations,
                    st.violations,
                    st.recoveries,
                    list(st.breaches),
                    dict(st.measured),
                    st.last_violation_seq,
                    list(st.history),
                )
                for t, st in self._states.items()
            }
            evaluations = self._evaluations
        tenants: Dict[str, object] = {}
        violations_total = recoveries_total = active_total = 0
        worst: Optional[str] = None
        worst_burn = -1.0
        for tenant, policy in sorted(policies.items()):
            (
                active, evals, violations, recoveries,
                breaches, measured, last_seq, history,
            ) = states.get(
                tenant, (False, 0, 0, 0, [], {}, None, [])
            )
            burn = self._burn_rates(
                history, policy.windows_s, policy.budget, now
            )
            peak = max(burn.values(), default=0.0)
            if peak > worst_burn:
                worst, worst_burn = tenant, peak
            violations_total += violations
            recoveries_total += recoveries
            active_total += 1 if active else 0
            tenants[tenant] = {
                "objectives": policy.objectives(),
                "budget": policy.budget,
                "windows_s": list(policy.windows_s),
                "compliant": not active,
                "breaches": breaches,
                "measured": measured,
                "burn_rates": burn,
                "evaluations": evals,
                "violations": violations,
                "recoveries": recoveries,
                "last_violation_seq": last_seq,
            }
        frec = getattr(self._job, "flightrec", None)
        by_kind = frec.counts_by_kind() if frec is not None else {}
        journal = {
            "violations": int(by_kind.get("slo.violation", 0)),
            "recoveries": int(by_kind.get("slo.recovered", 0)),
        }
        return {
            "policies": len(policies),
            "evaluations": evaluations,
            "tenants": tenants,
            "active_violations": active_total,
            "violations_total": violations_total,
            "recoveries_total": recoveries_total,
            # the journal-side account (ring occupancy, collapsed
            # bursts counted in full) and whether the two stories agree
            "journal": journal,
            "reconciled": (
                journal["violations"] == violations_total
                and journal["recoveries"] == recoveries_total
            ),
            "worst_burning_tenant": worst,
            "worst_burn_rate": round(max(worst_burn, 0.0), 4),
        }

    def health_summary(self) -> Dict[str, object]:
        """The compact ``/health`` block: who is burning worst and how
        many tenants are actively violating — alertable without the
        full snapshot."""
        snap = self.snapshot()
        return {
            "policies": snap["policies"],
            "active_violations": snap["active_violations"],
            "violations_total": snap["violations_total"],
            "worst_burning_tenant": snap["worst_burning_tenant"],
            "worst_burn_rate": snap["worst_burn_rate"],
        }
