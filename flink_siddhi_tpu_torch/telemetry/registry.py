"""Metrics registry: the single object a Job's components report into.

One ``MetricsRegistry`` per Job (``job.telemetry``). The run loop, the
drain fetch thread, the replay stager, the sharded drain path, and the
sink path all record into it; a metrics reader (``Job.metrics()`` /
``GET /api/v1/metrics``) snapshots it atomically from any thread.

SCOPED child registries (``scope(kind, id)``) attribute metrics to one
plan or tenant: a child is a full registry of its own (counters,
gauges, histograms) nested under the parent's snapshot as
``scopes[kind][id]``. Children follow the parent's ``enabled`` flag,
and their histograms keep the mergeable-geometry contract, so a tenant
rollup is a plain ``LatencyHistogram.merge`` fold over the tenant's
plan scopes (docs/observability.md "Scoped metric groups").

Everything degrades to near-zero cost when ``enabled`` is False: spans
return a shared no-op context and record/inc calls return immediately —
this is the switch the bench's telemetry-overhead A/B flips.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .histogram import LatencyHistogram
from .spans import NULL_SPAN, StageTimes


class Counter:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class MetricsRegistry:
    """Named counters, gauges, histograms, and stage times with an
    atomic JSON-safe ``snapshot()``."""

    def __init__(
        self, enabled: bool = True, parent: "MetricsRegistry" = None
    ) -> None:
        self._parent = parent
        self._enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, object] = {}
        self._hists: Dict[str, LatencyHistogram] = {}
        # scoped children: (kind, id) -> child registry. Children are
        # never dropped while the registry lives — a retired plan's
        # counters must keep contributing to conservation sums and
        # tenant rollups (bounded by the number of plans ever admitted).
        self._scopes: Dict[Tuple[str, str], "MetricsRegistry"] = {}
        self.stages = StageTimes()

    @property
    def enabled(self) -> bool:
        """Children follow the parent's switch: flipping the job
        registry's ``enabled`` (the bench overhead A/B) silences every
        plan/tenant scope with it."""
        if self._parent is not None:
            return self._parent.enabled
        return self._enabled

    @enabled.setter
    def enabled(self, value: bool) -> None:
        self._enabled = bool(value)

    # -- scoped children -----------------------------------------------------
    def scope(self, kind: str, scope_id) -> "MetricsRegistry":
        """Get-or-create the child registry for one scope (e.g.
        ``scope('plan', 'q1')``). Same thread-safety contract as every
        other accessor."""
        key = (str(kind), str(scope_id))
        with self._lock:
            child = self._scopes.get(key)
            if child is None:
                child = self._scopes[key] = MetricsRegistry(parent=self)
            return child

    def scope_map(self, kind: str) -> Dict[str, "MetricsRegistry"]:
        """Snapshot of one kind's children ({id: registry})."""
        kind = str(kind)
        with self._lock:
            return {
                sid: reg
                for (k, sid), reg in self._scopes.items()
                if k == kind
            }

    # -- point accessors (rollups read live objects, not snapshots) ----------
    def counter_value(self, name: str) -> int:
        with self._lock:
            c = self._counters.get(name)
        return 0 if c is None else c.value

    def gauge_value(self, name: str, default=None):
        with self._lock:
            return self._gauges.get(name, default)

    def get_histogram(self, name: str) -> Optional[LatencyHistogram]:
        """The live histogram object (or None) — what a cross-scope
        rollup merges via ``LatencyHistogram.merge``."""
        with self._lock:
            return self._hists.get(name)

    def merged_scope_histogram(
        self, kind: str, ids: List[str], name: str
    ) -> LatencyHistogram:
        """Fold one named histogram across the given scopes into a
        fresh histogram (the tenant-rollup primitive; scopes missing
        the name contribute nothing)."""
        out = LatencyHistogram()
        scopes = self.scope_map(kind)
        for sid in ids:
            reg = scopes.get(str(sid))
            if reg is None:
                continue
            h = reg.get_histogram(name)
            if h is not None:
                out.merge(h)
        return out

    # -- spans / stage time -------------------------------------------------
    def span(self, name: str):
        if not self.enabled:
            return NULL_SPAN
        return self.stages.span(name)

    def add_time(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.stages.add(name, seconds)

    # -- counters / gauges ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def inc(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counter(name).inc(n)

    def gauge(self, name: str, value) -> None:
        if self.enabled:
            with self._lock:
                self._gauges[name] = value

    # -- histograms ----------------------------------------------------------
    def histogram(self, name: str, **kwargs) -> LatencyHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram(**kwargs)
            return h

    def record_seconds(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.histogram(name).record_seconds(seconds)

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Atomic, JSON-serializable view: the registry lock pins the
        name->object maps while each object snapshots under its own
        lock, so a reader thread never observes a torn registry."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            scopes = dict(self._scopes)
        out = {
            "enabled": self.enabled,
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": dict(sorted(gauges.items())),
            "stages": self.stages.snapshot(),
            "histograms": {
                n: h.snapshot() for n, h in sorted(hists.items())
            },
        }
        if scopes:
            by_kind: Dict[str, Dict[str, object]] = {}
            for (kind, sid), reg in sorted(scopes.items()):
                by_kind.setdefault(kind, {})[sid] = reg.snapshot()
            out["scopes"] = by_kind
        return out
