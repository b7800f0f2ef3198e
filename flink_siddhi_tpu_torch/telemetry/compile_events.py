"""Compile telemetry of the torch port: every CUDA graph capture and every
kernel build, counted per Job and per plan.

The JAX package's module of this name listens to ``jax.monitoring``'s
lowering event. The port lowers nothing: its compiles are

* a **CUDA graph capture** (``runtime/graphs.py:capture``, one for each
  accumulator ring position of a segment key, from
  ``SegmentGraphs._warm_and_capture``), and
* a **kernel build** (``compiler/cuda_ops.py``: one ``nvcc`` run for each
  kernel source at its first use; a library already on disk only loads
  and is not counted).

Each site calls :func:`record` with the seconds it took. The surface is
the reference's, so dashboards and ``openmetrics`` read the same series:

* :func:`install` / :func:`installed`: kept for the callers of the
  reference's; there is no global listener list to register with, so
  installing only sets a flag;
* :func:`watch`: a context manager collecting every compile event in the
  process while it is open (count + durations);
* :class:`CompileSink`: the per-Job half. The executor marks its
  capture-bearing sections with :func:`attribution` (a thread-local scope
  carrying the job's sink and a plan label, ``plan:<id>``), so an event
  inside a marked section lands in that job's sink (per-label counts and
  a duration histogram, ``Job.metrics()["compiles"]``), in the job's
  registry (``compile.lowerings`` counter + ``compile.lowering``
  histogram: a "lowering" here is a capture or a build) and in its flight
  recorder (kind ``compile.capture`` or ``compile.build``).

A record never raises (a telemetry fault must not break a capture).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .histogram import LatencyHistogram

UNATTRIBUTED = "(unattributed)"

_lock = threading.Lock()
_installed = False
# open watch() contexts: every compile event in the process feeds each.
# Appended/removed under _lock; record() iterates a list() snapshot
_watchers: List["CompileWatcher"] = []
# thread-local attribution scope: (CompileSink, label) or None
_tls = threading.local()


def record(kind: str, secs: float) -> None:
    """One compile event of ``kind`` ('capture' or 'build') that took
    ``secs``: into every open watcher and the current thread's
    attribution scope."""
    try:
        with _lock:
            watchers = list(_watchers)
        for w in watchers:
            w._add(secs)
        scope = getattr(_tls, "scope", None)
        if scope is not None:
            sink, label = scope
            sink._add(label, secs, kind)
    except Exception:  # noqa: BLE001 — telemetry must not break a capture
        pass


def install() -> None:
    """Idempotent; the sites call :func:`record` directly, so there is
    no listener to register."""
    global _installed
    with _lock:
        _installed = True


def installed() -> bool:
    return _installed


class CompileWatcher:
    """A ``watch()`` handle: process-wide compile count + durations while
    open. Thread-safe."""

    def __init__(self) -> None:
        self._wlock = threading.Lock()
        self.durations: List[float] = []

    def _add(self, secs: float) -> None:
        with self._wlock:
            self.durations.append(float(secs))

    @property
    def count(self) -> int:
        with self._wlock:
            return len(self.durations)


class watch:
    """``with compile_events.watch() as w: ...; w.count``."""

    def __enter__(self) -> CompileWatcher:
        install()
        self._w = CompileWatcher()
        with _lock:
            _watchers.append(self._w)
        return self._w

    def __exit__(self, *exc) -> bool:
        with _lock:
            try:
                _watchers.remove(self._w)
            except ValueError:
                pass
        return False


class attribution:
    """Thread-local compile-attribution scope for one call section:
    compile events inside it land in ``sink`` under ``label``.
    Re-entrant (restores the outer scope on exit); a None sink is a no-op
    scope."""

    __slots__ = ("_scope", "_prev")

    def __init__(self, sink: Optional["CompileSink"], label: str) -> None:
        self._scope = None if sink is None else (sink, label)

    def __enter__(self):
        self._prev = getattr(_tls, "scope", None)
        _tls.scope = self._scope
        return self

    def __exit__(self, *exc) -> bool:
        _tls.scope = self._prev
        return False


class CompileSink:
    """One Job's compile accounting: per-label counts and one duration
    histogram, mirrored into the job's metrics registry (OpenMetrics
    rides that) and flight recorder."""

    def __init__(self, registry=None, flightrec=None) -> None:
        self._slock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._registry = registry
        self._flightrec = flightrec
        self._hist = LatencyHistogram()
        self._total = 0
        self._total_s = 0.0

    def _add(self, label: str, secs: float, kind: str = "capture") -> None:
        with self._slock:
            self._counts[label] = self._counts.get(label, 0) + 1
            self._total += 1
            self._total_s += float(secs)
        self._hist.record_seconds(secs)
        reg = self._registry
        if reg is not None:
            reg.inc("compile.lowerings")
            reg.record_seconds("compile.lowering", secs)
        fr = self._flightrec
        if fr is not None:
            fr.record(
                f"compile.{kind}", signature=label,
                duration_ms=round(float(secs) * 1e3, 3),
            )

    @property
    def total(self) -> int:
        with self._slock:
            return self._total

    def snapshot(self) -> dict:
        """``Job.metrics()["compiles"]``: totals, per-label counts, and
        the duration distribution (ms), under the reference's keys."""
        with self._slock:
            counts = dict(self._counts)
            total = self._total
            total_s = self._total_s
        return {
            "total_lowerings": total,
            "total_duration_s": round(total_s, 6),
            "by_signature": dict(sorted(counts.items())),
            "lowering_duration": self._hist.snapshot(),
        }
