"""Supervised execution: checkpoint on a cadence, detect crashes,
restart from the latest good snapshot — with exactly-once output.

The reference delegates this whole layer to Flink (asynchronous
barrier snapshots + fixed-delay restart, CEPPipeline.scala:26-28
``enableCheckpointing(5000)`` / ``fixedDelayRestart(4, 10s)``) and
then never restores the engine state it snapshots
(AbstractSiddhiOperator.java:339-342, an abandoned TODO). This module
is the missing supervisor over this engine's complete
checkpoint/restore (runtime/checkpoint.py):

* **cadence** — checkpoints at micro-batch boundaries every
  ``checkpoint_every_cycles`` cycles (and/or every
  ``checkpoint_interval_s`` seconds), with keep-last-K rotation;
* **crash detection + restart** — any exception out of the driven job
  rebuilds a fresh job (``factory()``) and restores the latest good
  generation (walking the rotation chain past unreadable files),
  under a restart budget: more than ``max_restarts`` crashes inside a
  ``restart_window_s`` window raises :class:`RestartBudgetExceeded`
  loudly instead of flapping forever;
* **exactly-once output** — the supervisor owns the emitted rows via
  a commit protocol: rows reaching its sinks are *uncommitted* until
  the next successful checkpoint (whose state, captured AFTER the
  drain, provably will not re-produce them); a crash discards the
  uncommitted suffix, which the restarted job re-emits from the
  restored state. ``results()`` therefore sees every row exactly once
  — no loss (the checkpoint replays the suffix), no duplicates (the
  discard) — which the fault-injection property tests pin row-exact
  against an unfaulted oracle (tests/test_faults.py);
* **accounting** — ``recovery.restore_ms`` (histogram),
  ``recovery.events_replayed`` / ``recovery.rows_discarded`` /
  ``faults.crashes`` (counters) in the supervisor's own registry,
  surfaced with liveness via :meth:`health` and
  ``GET /api/v1/health`` (app/service.py).

Modes: ``streaming`` drives ``run_cycle()`` (checkpoints at every
cadence boundary); ``resident`` drives a ResidentReplay (stage + scan
+ flush) — the resident scan has no host micro-batch boundaries, so
checkpoints happen only at the run's edges and a mid-run crash
restarts from the previous generation.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..telemetry import MetricsRegistry
from .checkpoint import checkpoint_generations

_LOG = logging.getLogger(__name__)


class RestartBudgetExceeded(RuntimeError):
    """More crashes than the restart budget allows inside one window —
    the job is failing deterministically; flapping further would only
    hide it. Chains the final crash as ``__cause__``."""


class CheckpointsUnreadableError(RuntimeError):
    """A checkpoint was committed this run but NO generation can be
    restored. Rebuilding from scratch would re-process the stream from
    the start and re-emit rows that are already committed — silently
    turning the exactly-once guarantee into at-least-twice. Refusing
    loudly is the only move that preserves the contract; the committed
    rows remain exactly-once."""


class Supervisor:
    def __init__(
        self,
        factory: Callable,
        checkpoint_path: str,
        *,
        checkpoint_every_cycles: int = 32,
        checkpoint_interval_s: Optional[float] = None,
        keep_checkpoints: int = 3,
        max_restarts: int = 3,
        restart_window_s: float = 300.0,
        mode: str = "streaming",  # 'streaming' | 'resident'
    ) -> None:
        if mode not in ("streaming", "resident"):
            raise ValueError(mode)
        self.factory = factory
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every_cycles = max(int(checkpoint_every_cycles), 1)
        self.checkpoint_interval_s = checkpoint_interval_s
        self.keep_checkpoints = max(int(keep_checkpoints), 1)
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.mode = mode
        # the supervisor's OWN registry: recovery/crash accounting must
        # survive the jobs it outlives (each job carries a fresh
        # per-job registry of its own)
        self.telemetry = MetricsRegistry()
        self.restart_count = 0
        self.last_recovery_ms: Optional[float] = None
        self.last_error: Optional[BaseException] = None
        # fst:threadsafe single-writer (the supervisor thread rebinds a fresh list per crash); health() reads a list() snapshot from the service thread
        self._crash_times: List[float] = []
        self._job = None
        self._finished = False
        self._alive = True
        self._last_ckpt_t: Optional[float] = None
        self._ckpt_count = 0
        # post-crash self-explanation (the /health last_restart block
        # + the supervisor.restart journal event): filled when a
        # restore completes after a crash
        # fst:threadsafe single-writer (supervisor thread); health() reads the whole dict reference GIL-atomically
        self._last_restart: Optional[Dict[str, object]] = None
        # events replayed by the MOST RECENT crash (computed at crash
        # time against the last committed checkpoint)
        self._last_replayed = 0
        # where the flight-recorder crash dump landed once the restart
        # budget was exhausted (None until then)
        self.crash_dump_path: Optional[str] = None
        # exactly-once commit protocol state
        self._committed: Dict[str, List[Tuple[int, tuple]]] = {}
        self._uncommitted: Dict[str, List[Tuple[int, tuple]]] = {}
        # processed_events as of the last committed checkpoint — the
        # base for events_replayed accounting on the next crash
        self._ckpt_processed = 0

    # -- output commit protocol -------------------------------------------
    def _make_sink(self, sid: str):
        bucket = self._uncommitted.setdefault(sid, [])

        def sink(abs_ts: int, row: tuple) -> None:
            bucket.append((abs_ts, row))

        return sink

    def _attach_sinks(self, job) -> None:
        seen = set()
        for rt in job._plans.values():
            for sid in rt.plan.output_streams():
                if sid not in seen:
                    seen.add(sid)
                    job.add_sink(sid, self._make_sink(sid))

    def _commit(self) -> None:
        """Everything currently uncommitted was emitted from state at
        or before the snapshot just persisted — the restored job will
        not re-produce it. Promote."""
        for sid, rows in self._uncommitted.items():
            if rows:
                self._committed.setdefault(sid, []).extend(rows)
                rows.clear()

    def _discard_uncommitted(self) -> int:
        n = sum(len(rows) for rows in self._uncommitted.values())
        for rows in self._uncommitted.values():
            rows.clear()
        return n

    def results_with_ts(self, output_stream: str):
        """Committed rows — exactly-once across crashes/restarts."""
        return list(self._committed.get(output_stream, []))

    def results(self, output_stream: str):
        return [row for _, row in self._committed.get(output_stream, [])]

    # -- checkpointing ------------------------------------------------------
    def _checkpoint(self, job) -> None:
        t0 = time.perf_counter()
        # save_checkpoint drains first: rows surfacing land in
        # _uncommitted BEFORE the state is captured, so everything
        # uncommitted after a successful save is safe to commit
        job.save_checkpoint(self.checkpoint_path, keep=self.keep_checkpoints)
        self.telemetry.record_seconds(
            "recovery.checkpoint", time.perf_counter() - t0
        )
        self.telemetry.inc("recovery.checkpoints")
        self._commit()
        # external transactional sinks commit ONLY here: the snapshot
        # that provably will not re-emit this epoch's rows is durable
        # and the internal row-account just promoted — EndTxn(commit)
        # now makes the epoch visible to read-committed consumers. A
        # crash between the save above and this call leaves the
        # pending transaction identity in the snapshot; the restore
        # resumes that exact commit (KafkaSink.load_state_dict), so
        # the external account stays exactly-once across the window.
        job.commit_sink_transactions()
        self._ckpt_count += 1
        self._last_ckpt_t = time.monotonic()
        self._ckpt_processed = job.processed_events

    def _build_restored(self):
        """Fresh job from the factory, restored from the newest
        readable checkpoint generation. An unreadable generation
        (crash-truncated, safelist-rejected) is logged and skipped —
        each candidate gets a pristine job, because a failed restore
        leaves a job partially mutated."""
        candidates = checkpoint_generations(
            self.checkpoint_path, self.keep_checkpoints
        )
        for i, path in enumerate(candidates):
            if not os.path.exists(path):
                continue
            job = self.factory()
            try:
                job.restore(path)
            except Exception as e:
                self.telemetry.inc("recovery.bad_checkpoints")
                _LOG.warning(
                    "checkpoint generation %s unreadable (%s); "
                    "falling back to the next", path, e,
                )
                continue
            if i:
                self.telemetry.inc("recovery.checkpoint_fallbacks")
            return job, path
        if self._ckpt_count > 0:
            # a checkpoint was taken AND committed this run; a
            # from-scratch rebuild would re-emit the committed rows
            self._alive = False
            raise CheckpointsUnreadableError(
                f"all {self.keep_checkpoints} checkpoint generation(s) "
                f"under {self.checkpoint_path!r} are missing or "
                f"unreadable, but {self._ckpt_count} checkpoint(s) "
                "were committed this run — restarting from scratch "
                "would duplicate committed output; refusing"
            )
        return self.factory(), None

    # -- crash handling -----------------------------------------------------
    def _record_crash(self, exc: BaseException) -> None:
        now = time.monotonic()
        self.last_error = exc
        self.restart_count += 1
        self.telemetry.inc("faults.crashes")
        discarded = self._discard_uncommitted()
        if discarded:
            self.telemetry.inc("recovery.rows_discarded", discarded)
        dead = self._job
        self._job = None  # a crash during rebuild must not re-account it
        replayed = 0
        if dead is not None:
            replayed = max(
                int(dead.processed_events) - int(self._ckpt_processed), 0
            )
            self.telemetry.inc("recovery.events_replayed", replayed)
        self._last_replayed = replayed
        self._crash_times = [
            t for t in self._crash_times
            if now - t <= self.restart_window_s
        ] + [now]
        _LOG.warning(
            "supervised job crashed (%s: %s); restart %d "
            "(%d uncommitted rows discarded)",
            type(exc).__name__, exc, self.restart_count, discarded,
        )
        if len(self._crash_times) > self.max_restarts:
            self._alive = False
            # black-box dump: the dead job's journal, written next to
            # the checkpoints BEFORE raising, so the terminal failure
            # leaves its own evidence file (best-effort — a dump
            # failure must not mask the budget error)
            if dead is not None:
                fr = getattr(dead, "flightrec", None)
                if fr is not None:
                    try:
                        fr.record(
                            "supervisor.budget_exhausted",
                            cause=f"{type(exc).__name__}: {exc}",
                            crashes=len(self._crash_times),
                            max_restarts=self.max_restarts,
                        )
                        self.crash_dump_path = fr.dump(
                            self.checkpoint_path + ".flightdump.json",
                            header={
                                "reason": "restart budget exhausted",
                                "cause": (
                                    f"{type(exc).__name__}: {exc}"
                                ),
                                "crashes_in_window": len(
                                    self._crash_times
                                ),
                                "max_restarts": self.max_restarts,
                                "restart_window_s": (
                                    self.restart_window_s
                                ),
                                "checkpoint_path": self.checkpoint_path,
                                "processed_events": int(
                                    dead.processed_events
                                ),
                            },
                        )
                        _LOG.error(
                            "flight-recorder crash dump written to %s",
                            self.crash_dump_path,
                        )
                    except Exception:  # noqa: BLE001 — best-effort
                        _LOG.exception("flight-recorder dump failed")
            raise RestartBudgetExceeded(
                f"{len(self._crash_times)} crashes within "
                f"{self.restart_window_s:.0f}s exceed the restart "
                f"budget of {self.max_restarts}; last error: "
                f"{type(exc).__name__}: {exc}"
            ) from exc

    # -- driving ------------------------------------------------------------
    def _drive_streaming(self, job) -> None:
        cycles = 0
        t_last = time.monotonic()
        while not job.finished:
            job.run_cycle()
            cycles += 1
            due = cycles >= self.checkpoint_every_cycles or (
                self.checkpoint_interval_s is not None
                and time.monotonic() - t_last
                >= self.checkpoint_interval_s
            )
            if due:
                self._checkpoint(job)
                cycles = 0
                t_last = time.monotonic()
        job.flush()

    def _drive_resident(self, job) -> None:
        from .replay import ResidentReplay

        rep = ResidentReplay(job)
        rep.stage()
        rep.run()
        job.flush()

    # fst:thread-root name=run-loop
    def run(self):
        """Drive the supervised job to completion; returns the final
        job. Raises :class:`RestartBudgetExceeded` when crashes exceed
        the budget (uncommitted output stays discarded — committed
        rows remain exactly-once). The supervisor thread IS the
        run-loop thread of every job it drives (fstrace ownership:
        docs/static_analysis.md)."""
        while True:
            try:
                t0 = time.perf_counter()
                job, restored_from = self._build_restored()
                self._attach_sinks(job)
                self._job = job
                self._ckpt_processed = job.processed_events
                restore_ms = (time.perf_counter() - t0) * 1e3
                if restored_from is not None:
                    self.last_recovery_ms = restore_ms
                    self.telemetry.record_seconds(
                        "recovery.restore_ms", restore_ms / 1e3
                    )
                    # journal the restart INTO THE RESTORED JOB: the
                    # journal is checkpoint state, so once the next
                    # checkpoint commits, this restart is recorded in
                    # it exactly once (a crash before that checkpoint
                    # rolls the entry back with everything else —
                    # the uncommitted-output contract)
                    cause = (
                        f"{type(self.last_error).__name__}: "
                        f"{self.last_error}"
                        if self.last_error is not None
                        else None
                    )
                    self._last_restart = {
                        "cause": cause,
                        "restore_ms": round(restore_ms, 3),
                        "events_replayed": int(self._last_replayed),
                        "restored_from": restored_from,
                        "restart": self.restart_count,
                        "flightrec_seq": None,
                    }
                    fr = getattr(job, "flightrec", None)
                    if fr is not None:
                        self._last_restart["flightrec_seq"] = fr.record(
                            "supervisor.restart",
                            cause=cause,
                            restore_ms=round(restore_ms, 3),
                            events_replayed=int(self._last_replayed),
                            restart=self.restart_count,
                        )
                    _LOG.info(
                        "restored from %s in %.1fms "
                        "(processed_events=%d)",
                        restored_from, restore_ms, job.processed_events,
                    )
                if self.mode == "resident":
                    self._drive_resident(job)
                else:
                    self._drive_streaming(job)
                # final checkpoint commits the end-of-stream suffix
                # (flush emissions included)
                self._checkpoint(job)
                self._finished = True
                return job
            except (KeyboardInterrupt, SystemExit):
                raise
            except CheckpointsUnreadableError:
                raise  # not a crash to retry: retrying cannot fix it
            except Exception as e:
                self._record_crash(e)

    @property
    def job(self):
        """The job currently being driven (None mid-restart/rebuild).
        GIL-atomic attribute read — safe from the REST service thread
        (the flight-recorder route reads the live job's journal
        through this)."""
        return self._job

    # -- health --------------------------------------------------------------
    def health(self) -> Dict[str, object]:
        """Liveness + checkpoint freshness + restart budget, JSON-safe
        (the GET /api/v1/health payload)."""
        now = time.monotonic()
        job = self._job
        # list() snapshot first: health() runs on the REST service
        # thread while the supervisor may be appending a crash — the
        # C-level copy is atomic under the GIL, a Python-level
        # comprehension over the live list is not
        recent = [
            t for t in list(self._crash_times)
            if now - t <= self.restart_window_s
        ]
        return {
            "alive": self._alive,
            "finished": self._finished,
            "mode": self.mode,
            "restarts": self.restart_count,
            "restart_budget": {
                "max_restarts": self.max_restarts,
                "window_s": self.restart_window_s,
                "used_in_window": len(recent),
            },
            "checkpoints": self._ckpt_count,
            "last_checkpoint_age_s": (
                round(now - self._last_ckpt_t, 3)
                if self._last_ckpt_t is not None
                else None
            ),
            "checkpoint_path": self.checkpoint_path,
            "last_error": (
                f"{type(self.last_error).__name__}: {self.last_error}"
                if self.last_error is not None
                else None
            ),
            "last_recovery_ms": self.last_recovery_ms,
            # post-crash self-explanation (ISSUE 15): cause, restore
            # cost, replay size, and the journal seq of the restart
            # event — a scrape explains the last restart without
            # journal spelunking
            "last_restart": self._last_restart,
            # SLO watchdog compact view (telemetry/slo.py): worst-
            # burning tenant + active violation count — a probe alerts
            # on a burning tenant without the full /api/v1/slo snapshot
            "slo": (
                job.slo.health_summary()
                if job is not None and getattr(job, "slo", None)
                else None
            ),
            "crash_dump_path": self.crash_dump_path,
            "processed_events": (
                int(job.processed_events) if job is not None else None
            ),
            # event-time robustness (docs/event_time.md): a probe can
            # alert on a silent topic (idle_sources) or a late-row
            # flood without scraping the full metrics route
            "idle_sources": (
                job.idle_source_ids() if job is not None else []
            ),
            "late_dropped": (
                int(job.late_dropped) if job is not None else None
            ),
            # transactional-sink account (runtime/kafka.py txn_stats):
            # epoch counter, commit/abort/fence/resume totals, and
            # whether a prepared commit is in flight — the external
            # exactly-once story in one scrape
            "transactional_sinks": self._txn_sink_stats(job),
            # serving-fleet block (fleet/, docs/fleet.md): replica
            # id/role, warm-store hit/miss/persist counters, commit
            # epoch, last handoff — None outside a fleet, so
            # single-process payloads are unchanged
            "fleet": (
                job.fleet_status()
                if job is not None
                and hasattr(job, "fleet_status")
                else None
            ),
            "telemetry": self.telemetry.snapshot(),
        }

    @staticmethod
    def _txn_sink_stats(job) -> List[Dict[str, object]]:
        if job is None:
            return []
        out: List[Dict[str, object]] = []
        # list() snapshots: health() runs on the REST service thread
        # while the run loop may attach sinks
        for sid, fns in list(getattr(job, "_sinks", {}).items()):
            for fn in list(fns):
                stats = getattr(fn, "txn_stats", None)
                if stats is not None:
                    out.append({"stream": sid, **stats()})
        return out
