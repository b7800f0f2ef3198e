"""Prometheus text-format exposition of a Job metrics snapshot.

The JAX package's module of this name, with one difference: the
``fst_build_info`` gauge's labels are the port's (``package_version``,
``torch_version``, ``backend`` from the Job's device, and
``bench_schema_version``) where the reference's labels name jax and its
default backend. Every other family, name and label is the reference's.

``render_openmetrics(Job.metrics(), backend)`` -> the text a Prometheus
scraper ingests (text format 0.0.4: ``# HELP`` / ``# TYPE`` comments
followed by ``name{label="value"} number`` samples), served by
``GET /api/v1/metrics/prometheus`` (app/service.py).

Mapping:

* registry **counters** -> ``fst_<name>_total`` counter samples;
* numeric **gauges** -> ``fst_<name>`` gauge samples (list/dict gauges
  stay JSON-only);
* **histograms** -> summaries in SECONDS: ``fst_<name>_seconds``
  quantile samples (0.5/0.9/0.99) plus ``_count`` and ``_sum``;
* **plan scopes** (``telemetry.scopes.plan.<id>``) emit the same
  series with ``plan`` and ``tenant`` labels — one family, labeled
  per scope (``sum by (tenant) (fst_rows_emitted_total)``);
* the **tenant rollup** block (``metrics()["tenants"]``) additionally
  emits pre-merged ``fst_tenant_*`` series, histograms merged
  bucket-exactly;
* the **SLO watchdog** block (``metrics()["slo"]``; telemetry/slo.py)
  emits ``fst_slo_*``: violation/recovery tallies, per-tenant
  compliance and burn rates (labeled by window), and declared vs
  measured objective values.

Metric and label names are sanitized to the Prometheus charset; label
values are escaped per the exposition format. Non-finite and
non-numeric values are skipped — an absent sample is honest, a NaN
sample poisons downstream rate() queries.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")
PREFIX = "fst_"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_QUANTILES = (("0.5", "p50_ms"), ("0.9", "p90_ms"), ("0.99", "p99_ms"))


def metric_name(name: str, suffix: str = "") -> str:
    n = _NAME_SANITIZE.sub("_", str(name))
    if n and n[0].isdigit():
        n = "_" + n
    return f"{PREFIX}{n}{suffix}"


def _escape(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _render_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _num(value) -> Optional[str]:
    """Sample-ready rendering of a numeric value, or None to skip."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    if not math.isfinite(value):
        return None
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


class _Writer:
    """Accumulates samples, emitting each family's TYPE line once (the
    format requires all of a family's samples to be contiguous under
    one TYPE declaration)."""

    def __init__(self) -> None:
        self._families: Dict[str, List[str]] = {}
        self._types: Dict[str, str] = {}
        self._order: List[str] = []

    def sample(
        self,
        family: str,
        mtype: str,
        labels: Optional[Dict[str, str]],
        value,
        name: Optional[str] = None,
    ) -> None:
        v = _num(value)
        if v is None:
            return
        if family not in self._types:
            self._types[family] = mtype
            self._families[family] = [f"# TYPE {family} {mtype}"]
            self._order.append(family)
        elif self._types[family] != mtype:
            return  # conflicting re-declaration: first writer wins
        self._families[family].append(
            f"{name or family}{_render_labels(labels)} {v}"
        )

    def summary(
        self,
        family: str,
        labels: Optional[Dict[str, str]],
        hist_snapshot: Dict,
    ) -> None:
        """One LatencyHistogram.snapshot() (ms fields) as a summary in
        seconds."""
        count = hist_snapshot.get("count")
        if not isinstance(count, int) or count <= 0:
            return
        for q, key in _QUANTILES:
            ms = hist_snapshot.get(key)
            if isinstance(ms, (int, float)):
                self.sample(
                    family, "summary",
                    {**(labels or {}), "quantile": q}, ms / 1e3,
                )
        self.sample(family, "summary", labels, count,
                    name=family + "_count")
        mean_ms = hist_snapshot.get("mean_ms")
        if isinstance(mean_ms, (int, float)):
            self.sample(
                family, "summary", labels, mean_ms * count / 1e3,
                name=family + "_sum",
            )

    def render(self) -> str:
        lines: List[str] = []
        for family in self._order:
            block = self._families[family]
            if len(block) > 1:  # TYPE line + at least one sample
                lines.extend(block)
        return "\n".join(lines) + ("\n" if lines else "")


def _emit_registry_snapshot(
    w: _Writer, snap: Dict, labels: Dict[str, str]
) -> None:
    """Counters/gauges/histograms of one registry snapshot (job-level
    with empty labels, or a plan scope with plan/tenant labels)."""
    for name, value in (snap.get("counters") or {}).items():
        w.sample(metric_name(name, "_total"), "counter", labels, value)
    for name, value in (snap.get("gauges") or {}).items():
        w.sample(metric_name(name), "gauge", labels, value)
    for name, hist in (snap.get("histograms") or {}).items():
        if isinstance(hist, dict):
            w.summary(metric_name(name, "_seconds"), labels, hist)


def _tenant_of_map(metrics: Dict) -> Dict[str, str]:
    """plan id -> tenant, covering retired plans too (the rollup block
    lists every scoped plan; live ``plans`` entries override)."""
    out: Dict[str, str] = {}
    for tenant, ent in (metrics.get("tenants") or {}).items():
        for pid in ent.get("plans", ()):
            out[str(pid)] = str(tenant)
    for pid, info in (metrics.get("plans") or {}).items():
        t = (info or {}).get("tenant")
        if t:
            out[str(pid)] = str(t)
    return out


def _build_info_labels(backend: Optional[str] = None) -> Dict[str, str]:
    """The fst_build_info label set: package version, torch version,
    backend, bench schema version — the standard *_info gauge pattern
    (value always 1; the labels ARE the payload), so a scraper can join
    any series against what produced it. ``backend`` is the device type
    of the Job the snapshot came from ("cuda" or "cpu"), never a probe
    that could fall back; the port's bench has no schema version yet, so
    ``bench_schema_version`` reads 0."""
    import torch

    import flink_siddhi_tpu_torch as _pkg

    return {
        "package_version": str(getattr(_pkg, "__version__", "0")),
        "torch_version": str(torch.__version__),
        "backend": str(backend or "unavailable"),
        "bench_schema_version": str(
            getattr(_pkg, "BENCH_SCHEMA_VERSION", 0)
        ),
    }


def render_openmetrics(metrics: Dict, backend: Optional[str] = None) -> str:
    """Render a ``Job.metrics()`` snapshot as Prometheus text;
    ``backend`` is the Job's device type (``fst_build_info``)."""
    w = _Writer()
    w.sample(metric_name("build_info"), "gauge",
             _build_info_labels(backend), 1)
    w.sample(
        metric_name("processed_events", "_total"), "counter", None,
        metrics.get("processed_events"),
    )
    for key in ("late_events", "late_dropped"):
        w.sample(metric_name(key, "_total"), "counter", None,
                 metrics.get(key))
    # per-STREAM rows get their own family: the plan scopes below emit
    # fst_rows_emitted_total{plan,tenant} for the same rows, and mixing
    # both label schemes in one family would make an unfiltered
    # sum(fst_rows_emitted_total) double-count every row
    stream_family = metric_name("stream_rows_emitted", "_total")
    for sid, n in (metrics.get("emitted") or {}).items():
        w.sample(stream_family, "counter", {"stream": str(sid)}, n)
    tenant_of = _tenant_of_map(metrics)

    def plan_labels(pid: str) -> Dict[str, str]:
        pid = str(pid)
        if pid.startswith(("@dyn:", "@shr:")):
            # a dynamic-group or shared-prefix host is SHARED device
            # state — its scope (footprint, drain legs) is not one
            # tenant's to claim
            return {"plan": pid, "tenant": "shared"}
        return {"plan": pid, "tenant": tenant_of.get(pid, "default")}

    for pid, info in (metrics.get("plans") or {}).items():
        w.sample(
            metric_name("plan_enabled"), "gauge", plan_labels(pid),
            1 if (info or {}).get("enabled") else 0,
        )

    tel = metrics.get("telemetry") or {}
    _emit_registry_snapshot(w, tel, {})
    scopes = tel.get("scopes") or {}
    for pid, snap in (scopes.get("plan") or {}).items():
        _emit_registry_snapshot(w, snap, plan_labels(pid))
    for tenant, snap in (scopes.get("tenant") or {}).items():
        _emit_registry_snapshot(w, snap, {"tenant": str(tenant)})

    for tenant, ent in (metrics.get("tenants") or {}).items():
        labels = {"tenant": str(tenant)}
        for key in (
            "rows_emitted", "matches", "late_events",
            "cache_hits", "cache_misses", "stack_joins",
        ):
            w.sample(
                metric_name(f"tenant_{key}", "_total"), "counter",
                labels, ent.get(key),
            )
        w.sample(
            metric_name("tenant_plans"), "gauge", labels,
            len(ent.get("plans", ())),
        )
        for key, fam in (
            ("drain", "tenant_drain_seconds"),
            ("drain_staleness", "tenant_drain_staleness_seconds"),
        ):
            hist = ent.get(key)
            if isinstance(hist, dict):
                w.summary(metric_name(fam), labels, hist)
    _emit_slo(w, metrics.get("slo"))
    _emit_fleet(w, metrics.get("fleet"))
    return w.render()


def _emit_fleet(w: _Writer, fleet) -> None:
    """The serving-fleet block (``metrics()["fleet"]``; fleet/,
    docs/fleet.md) as ``fst_fleet_*`` series: replica identity as an
    info-style gauge, the warm-store hit/miss/persist/error counters,
    the commit epoch, and whether/when the last rolling-restart
    handoff happened. Absent outside a fleet — the single-process
    exposition is byte-identical."""
    if not isinstance(fleet, dict):
        return
    labels = {}
    if fleet.get("replica") is not None:
        labels["replica"] = str(fleet["replica"])
    if fleet.get("role") is not None:
        labels["role"] = str(fleet["role"])
    w.sample(
        metric_name("fleet_replica_info"), "gauge", labels or None, 1
    )
    store = fleet.get("warm_store")
    if isinstance(store, dict):
        for key in ("hits", "misses", "persists", "errors"):
            w.sample(
                metric_name(f"fleet_warm_store_{key}", "_total"),
                "counter", labels or None, store.get(key),
            )
    w.sample(
        metric_name("fleet_epoch"), "gauge", labels or None,
        fleet.get("epoch"),
    )
    handoff = fleet.get("last_handoff")
    w.sample(
        metric_name("fleet_last_handoff"), "gauge", labels or None,
        1 if isinstance(handoff, dict) else 0,
    )


def _emit_slo(w: _Writer, slo) -> None:
    """The SLO watchdog block (``metrics()["slo"]``; telemetry/slo.py)
    as ``fst_slo_*`` series: job-level tallies plus per-tenant
    compliance, burn rates (labeled by window), and the declared vs
    measured objective values."""
    if not isinstance(slo, dict):
        return
    w.sample(metric_name("slo_policies"), "gauge", None,
             slo.get("policies"))
    w.sample(metric_name("slo_active_violations"), "gauge", None,
             slo.get("active_violations"))
    for key in ("violations", "recoveries", "evaluations"):
        w.sample(
            metric_name(f"slo_{key}", "_total"), "counter", None,
            slo.get(f"{key}_total", slo.get(key)),
        )
    for tenant, ent in (slo.get("tenants") or {}).items():
        if not isinstance(ent, dict):
            continue
        labels = {"tenant": str(tenant)}
        w.sample(
            metric_name("slo_compliant"), "gauge", labels,
            1 if ent.get("compliant") else 0,
        )
        for key in ("violations", "recoveries", "evaluations"):
            w.sample(
                metric_name(f"slo_tenant_{key}", "_total"),
                "counter", labels, ent.get(key),
            )
        for window, rate in (ent.get("burn_rates") or {}).items():
            w.sample(
                metric_name("slo_burn_rate"), "gauge",
                {**labels, "window": str(window)}, rate,
            )
        for name, val in (ent.get("objectives") or {}).items():
            w.sample(
                metric_name("slo_objective"), "gauge",
                {**labels, "objective": str(name)}, val,
            )
        for name, val in (ent.get("measured") or {}).items():
            w.sample(
                metric_name("slo_measured"), "gauge",
                {**labels, "objective": str(name)}, val,
            )
