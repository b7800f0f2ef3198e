"""Flight recorder: a bounded, structured event journal for one Job.

The runtime's most diagnostic moments — a control admit, a checkpoint
restore, a shed burst, a watermark stall, an XLA compile — were
scattered across counters (exact totals, no timeline) and log lines
(a timeline, not machine-readable). This is the black-box layer under
both, in the spirit of Dapper's always-on production tracing
(Sigelman et al.; PAPERS.md): every event is one small host-side
record with

* a **monotone sequence number** (``seq``) that survives
  checkpoint/restore exactly once — the journal is part of the job
  snapshot (runtime/checkpoint.py), so like every other piece of
  engine state it rolls back to the last checkpoint on a crash:
  entries recorded after the snapshot are discarded with the dead
  process (the same contract as the supervisor's uncommitted output),
  entries before it restore once, and the restored recorder continues
  the sequence without gaps or duplicates;
* **monotonic + wall timestamps** (``t_mono`` for ordering/arithmetic,
  ``t_wall`` for correlating with logs and other hosts);
* **scope labels** (``plan`` / ``tenant``) where the event is
  attributable;
* free-form payload fields (cause strings, counts, rule ids).

Bounded and burst-safe: the journal is a fixed-capacity ring (oldest
evicted), and high-frequency fault kinds (shed/late/stall/
backpressure/SLO breach) are RATE-COLLAPSED — a repeat of the same
(kind, plan, tenant) within ``collapse_window_s`` folds into the
previous entry
(``collapsed`` += 1, counts accumulated, ``t_last`` updated) instead
of appending, so a sustained overload occupies O(1) journal slots per
second while the exact totals stay in the counters.

Thread discipline (fstrace FST2xx, docs/static_analysis.md): the run
loop records, the REST service thread reads
(``GET /api/v1/flightrecorder``), and the supervisor records restarts
— genuinely multi-writer, so every access to the ring runs under one
lock, held only for dict/deque operations (no blocking calls, no I/O:
``dump()`` serializes OUTSIDE the lock from a snapshot).

Overhead: ``record()`` checks the owning registry's ``enabled`` flag
first and returns immediately when telemetry is off — the same switch
as every span/histogram (the bench ``BENCH_TELEMETRY=0`` A/B), so the
journal path is part of the measured <2% envelope. Events only fire
at control/fault/checkpoint boundaries, never per micro-batch.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# default ring capacity: ~200 bytes/event -> a few hundred KB of host
# memory and checkpoint payload at the cap, hours of quiet-period
# history, minutes under rate-collapsed bursts
DEFAULT_CAPACITY = 2048

# kinds that may legitimately fire every cycle under sustained
# overload — these collapse by (kind, plan, tenant) inside the window;
# every other kind is a discrete transition and always appends
COLLAPSIBLE_KINDS = frozenset(
    {
        "fault.shed",
        "fault.late",
        "fault.retry",
        "fault.backpressure",
        "watermark.stall",
        # a retrace storm (the exact incident class the journal must
        # survive) fires thousands of lowerings — collapsed, they are
        # one entry with duration_ms accumulated instead of a flood
        # that evicts the control/checkpoint/restart history; exact
        # counts live in the compile.lowerings counter
        "compile.xla",
        # a flapping transactional sink (broker rejecting every
        # EndTxn) aborts once per checkpoint epoch — collapsed so an
        # abort storm cannot evict the checkpoint/restart history;
        # commits/fences are discrete transitions and always append
        "txn.abort",
        # the SLO watchdog (telemetry/slo.py) journals one violation
        # per evaluation while a tenant is out of compliance — a
        # sustained breach collapses per tenant, the evaluation count
        # rides in ``collapsed``; slo.recovered is the discrete
        # transition and always appends
        "slo.violation",
        # warm-start store traffic (fleet/warmstore.py): a replica
        # bootstrap fires one hit per executable per plan and a busy
        # checkpoint cadence persists on every boundary — collapsed so
        # fleet churn cannot evict the control/restart history;
        # fleet.handoff (the rolling-restart transition) is discrete
        # and always appends
        "fleet.warm_hit",
        "fleet.warm_miss",
        "fleet.persist",
    }
)


class FlightRecorder:
    """Bounded structured event journal (see module docstring)."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        registry=None,
        collapse_window_s: float = 1.0,
    ) -> None:
        self._registry = registry
        self.collapse_window_s = float(collapse_window_s)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(int(capacity), 16))
        self._seq = 0
        # (kind, plan, tenant) -> the latest journal entry of that
        # key, for rate collapse — tenant in the key so one tenant's
        # SLO burst cannot fold into another's. Entries evicted from
        # the ring may linger here briefly; they fall out at the next
        # append of their key (and an update to an evicted entry is
        # invisible but harmless — the exact totals live in the
        # counters, not the journal).
        self._last_by_key: Dict[tuple, dict] = {}

    @property
    def enabled(self) -> bool:
        reg = self._registry
        return True if reg is None else bool(reg.enabled)

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    # -- recording -----------------------------------------------------------
    def record(
        self,
        kind: str,
        plan: Optional[str] = None,
        tenant: Optional[str] = None,
        **data,
    ) -> Optional[int]:
        """Append one event (or fold it into the previous one of the
        same (kind, plan, tenant) when the kind is collapsible and the
        repeat lands inside the collapse window). Returns the event's
        seq, or None when telemetry is disabled / the event
        collapsed."""
        if not self.enabled:
            return None
        now = time.monotonic()
        key = (kind, plan, tenant)
        with self._lock:
            if kind in COLLAPSIBLE_KINDS:
                prev = self._last_by_key.get(key)
                if (
                    prev is not None
                    and now - prev["t_mono"] <= self.collapse_window_s
                ):
                    prev["collapsed"] = prev.get("collapsed", 0) + 1
                    prev["t_last"] = now
                    for k, v in data.items():
                        # counts accumulate across the burst; the
                        # latest value wins for everything else
                        if isinstance(v, (int, float)) and isinstance(
                            prev.get(k), (int, float)
                        ):
                            prev[k] = prev[k] + v
                        else:
                            prev[k] = v
                    return None
            self._seq += 1
            ev = {
                "seq": self._seq,
                "t_mono": now,
                "t_wall": time.time(),
                "kind": str(kind),
            }
            if plan is not None:
                ev["plan"] = str(plan)
            if tenant is not None:
                ev["tenant"] = str(tenant)
            ev.update(data)
            self._events.append(ev)
            if kind in COLLAPSIBLE_KINDS:
                self._last_by_key[key] = ev
            return self._seq

    # -- reading -------------------------------------------------------------
    def events(
        self,
        kind: Optional[str] = None,
        plan: Optional[str] = None,
        since_seq: Optional[int] = None,
        limit: Optional[int] = None,
        tenant: Optional[str] = None,
    ) -> List[dict]:
        """Filtered snapshot, oldest first. ``kind`` matches exactly or
        by dotted prefix (``kind="control"`` matches ``control.admit``);
        ``plan`` / ``tenant`` match the entry's scope labels exactly
        (an entry without the label never matches a set filter);
        ``since_seq`` returns events with seq STRICTLY greater (the
        REST poll-cursor contract). ``limit`` keeps the newest N
        for a plain tail view — but with ``since_seq`` set it keeps
        the OLDEST N instead, so a cursor client pages FORWARD through
        a backlog larger than one page (newest-N there would silently
        drop the middle of the backlog with no way to retrieve it)."""
        with self._lock:
            evs = [dict(e) for e in self._events]
        if since_seq is not None:
            evs = [e for e in evs if e["seq"] > int(since_seq)]
        if kind is not None:
            evs = [
                e
                for e in evs
                if e["kind"] == kind or e["kind"].startswith(kind + ".")
            ]
        if plan is not None:
            evs = [e for e in evs if e.get("plan") == plan]
        if tenant is not None:
            evs = [e for e in evs if e.get("tenant") == tenant]
        if limit is not None and limit >= 0:
            # explicit slice-by-length: evs[-0:] would be the WHOLE
            # list, so limit=0 must short-circuit to empty
            limit = int(limit)
            if limit == 0:
                evs = []
            elif since_seq is not None:
                evs = evs[:limit]  # forward paging
            else:
                evs = evs[len(evs) - limit:]  # tail view
        return evs

    def counts_by_kind(self) -> Dict[str, int]:
        """Journal occupancy per kind (collapsed entries count the
        whole burst) — the metrics()/health summary."""
        with self._lock:
            out: Dict[str, int] = {}
            for e in self._events:
                out[e["kind"]] = (
                    out.get(e["kind"], 0) + 1 + e.get("collapsed", 0)
                )
        return out

    # -- checkpoint integration ---------------------------------------------
    def state_dict(self) -> dict:
        """Picklable journal state for the job snapshot: plain builtin
        containers only (the checkpoint safelist unpickler admits
        nothing else)."""
        with self._lock:
            return {
                "seq": self._seq,
                "events": [dict(e) for e in self._events],
            }

    def restore_state(self, state: Optional[dict]) -> None:
        """Adopt a checkpointed journal (absent/empty state is a
        no-op: pre-flight-recorder checkpoints restore cleanly). The
        sequence continues from the snapshot's value, so post-restore
        events extend the journal monotonically."""
        if not state:
            return
        with self._lock:
            self._seq = max(int(state.get("seq", 0)), self._seq)
            self._events.clear()
            self._last_by_key.clear()
            for e in state.get("events", ()):
                if isinstance(e, dict) and "seq" in e and "kind" in e:
                    self._events.append(dict(e))

    # -- crash dump ----------------------------------------------------------
    def dump(self, path: str, header: Optional[dict] = None) -> str:
        """Write the whole journal (plus an optional header — the
        supervisor adds cause/restart accounting) as one JSON document.
        Serialization happens outside the lock, from a snapshot."""
        doc = {
            "header": header or {},
            "seq": self.seq,
            "events": self.events(),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        return path
