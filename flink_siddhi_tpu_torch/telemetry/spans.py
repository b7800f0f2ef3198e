"""Structured tracing spans + per-stage wall-clock accounting.

``StageTimes`` is the honest-wall-clock ledger the bench's
``stage_breakdown`` is computed from: every instrumented host code
section runs under ``with stages.span("name"):`` and its elapsed
monotonic time accrues to that stage's total. Two rules keep the ledger
summable against a wall clock:

* spans that open while another span is already active on the SAME
  thread accrue under ``nested.<name>`` — their time is already counted
  by the enclosing span, so only top-level names participate in
  "stages must sum to >= 95% of elapsed" arithmetic (the nested names
  remain visible for drill-down);
* spans on different threads (the drain fetch thread overlaps the run
  loop by design) accrue normally under their own names — wall-clock
  attribution sums only the run-loop lane's stage names
  (``TOP_LEVEL_STAGES`` in the package root).

A bounded ring of recently-closed spans (name, end-monotonic, seconds)
is kept for debugging; it never grows past ``ring_capacity``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Tuple


class _NullSpan:
    """Shared no-op context for disabled telemetry (zero allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_st", "_name", "_t0", "_nested")

    def __init__(self, st: "StageTimes", name: str) -> None:
        self._st = st
        self._name = name

    def __enter__(self):
        tls = self._st._tls
        depth = getattr(tls, "depth", 0)
        self._nested = depth > 0
        tls.depth = depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._st._tls.depth -= 1
        self._st.add(self._name, dt, nested=self._nested)
        return False


class StageTimes:
    """Thread-safe per-stage time accumulator + recent-span ring."""

    def __init__(self, ring_capacity: int = 512) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._ring: deque = deque(maxlen=ring_capacity)
        self._tls = threading.local()

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add(
        self,
        name: str,
        seconds: float,
        count: int = 1,
        nested: bool = False,
    ) -> None:
        """Attribute ``seconds`` of wall-clock to stage ``name``.
        Callers measuring a section without a span (e.g. a duration
        computed before the registry existed) use this directly."""
        key = f"nested.{name}" if nested else name
        with self._lock:
            self._totals[key] = self._totals.get(key, 0.0) + seconds
            self._counts[key] = self._counts.get(key, 0) + count
            self._ring.append((key, time.monotonic(), seconds))

    def total(self, name: str) -> float:
        with self._lock:
            return self._totals.get(name, 0.0)

    def recent(self, n: int = 50) -> List[Tuple[str, float, float]]:
        with self._lock:
            return list(self._ring)[-n:]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "seconds": round(total, 6),
                    "count": self._counts.get(name, 0),
                }
                for name, total in sorted(self._totals.items())
            }
