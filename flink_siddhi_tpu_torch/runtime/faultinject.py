"""Deterministic process-fault injection for supervised jobs.

Failure is a first-class, injected, measured input here (PAPERS.md #4:
claims only count under load the system survives — the same standard
applied to recovery). This module holds the process-death half of the
harness, shared by the property tests (tests/faults.py re-exports it
next to the wire-fault ``FaultSchedule``) and by ``bench.py --fault``
(the measured-recovery block) — one implementation, so the debris a
"dying writer" leaves and the pull-boundary crash semantics cannot
drift between the tests and the bench — and the EVENT-TIME half:
:class:`DisorderSchedule` / :class:`DisorderSource` inject seeded
arrival disorder (bounded skew, bursty duplicates, late stragglers,
idle partitions) with an exact injected account, shared by the
disorder oracle tests (tests/test_event_time.py) and ``bench.py
--disorder`` (docs/event_time.md).

:class:`CrashPlan` + :func:`wrap_job` inject crashes into a SUPERVISED
job: at scheduled source-pull boundaries (mode-agnostic: streaming
``run_cycle`` and resident ``stage`` both pull), killed
MID-transaction (after the snapshot commits, before the
transactional sinks' EndTxn — the window the KIP-98 resume-commit
protocol exists to close), and killed
MID-checkpoint — a half-written ``*.tmp.*`` sibling is left behind
(exactly what a process death between the temp write and the atomic
replace leaves) and the crash raises BEFORE the replace, so the
previous good generation survives. The plan's counters live OUTSIDE
the job, so the schedule keeps advancing across supervisor restarts:
"crash at pulls 5 and 12" means the 5th and 12th pulls of the
supervised LIFETIME.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CrashPlan",
    "DisorderSchedule",
    "DisorderSource",
    "InjectedCrash",
    "wrap_job",
]


class InjectedCrash(RuntimeError):
    """The fault harness killed the job (simulated process death)."""


class CrashPlan:
    """Deterministic process-death schedule for a supervised job.

    ``at_pulls``: crash when the supervised lifetime's Nth source
    pull happens (1-based; ``_pull_sources`` is the micro-batch
    boundary in streaming mode and the staging loop in resident
    mode). ``at_checkpoints``: kill the Nth checkpoint attempt
    (1-based) mid-write — a garbage ``*.tmp.*`` sibling appears (as a
    dying writer leaves) and the crash fires BEFORE the atomic
    replace, so the previous good generation survives.
    ``at_commits``: kill the Nth sink-transaction commit (1-based)
    BEFORE EndTxn fires — the narrowest exactly-once window: the
    snapshot is already durable and the supervisor's internal rows
    already promoted, but the external transaction is still open. The
    restored job must RESUME that exact commit (not re-emit) for a
    read-committed consumer to stay 0-dup/0-lost."""

    def __init__(
        self,
        at_pulls: Sequence[int] = (),
        at_checkpoints: Sequence[int] = (),
        at_commits: Sequence[int] = (),
    ) -> None:
        self.at_pulls = frozenset(int(i) for i in at_pulls)
        self.at_checkpoints = frozenset(int(i) for i in at_checkpoints)
        self.at_commits = frozenset(int(i) for i in at_commits)
        self.pulls = 0
        self.checkpoints = 0
        self.commits = 0
        self.crashes = 0

    def tick_pull(self) -> None:
        self.pulls += 1
        if self.pulls in self.at_pulls:
            self.crashes += 1
            raise InjectedCrash(f"killed at source pull {self.pulls}")

    def will_kill_checkpoint(self) -> bool:
        """Whether the NEXT checkpoint attempt is scheduled to die —
        wrap_job peeks so it can replay the steps a real save runs
        before the mid-write death (drain + transactional prepare)."""
        return (self.checkpoints + 1) in self.at_checkpoints

    def tick_checkpoint(self, path: str) -> None:
        self.checkpoints += 1
        if self.checkpoints in self.at_checkpoints:
            self.crashes += 1
            # the debris a real mid-write death leaves: a partial temp
            # file next to the (untouched) previous good checkpoint
            with open(f"{path}.tmp.999999", "wb") as f:
                f.write(b"partial checkpoint debris")
            raise InjectedCrash(
                f"killed mid-checkpoint {self.checkpoints}"
            )

    def tick_commit(self) -> None:
        self.commits += 1
        if self.commits in self.at_commits:
            self.crashes += 1
            # after the snapshot's durable replace, before EndTxn:
            # the transaction the snapshot stamped pending stays OPEN
            # on the broker until the restored sink resumes the commit
            raise InjectedCrash(
                f"killed mid-transaction at commit {self.commits}"
            )


# -- event-time disorder injection (docs/event_time.md) ---------------------

@dataclass(frozen=True)
class DisorderSchedule:
    """Seeded event-time disorder over a recorded stream.

    Four production failure shapes, composable, all DETERMINISTIC from
    the seed (the late/dup counters the engine reports must reconcile
    EXACTLY against what was injected — tests and ``bench.py
    --disorder`` both assert it):

    * ``skew_ms``       — bounded arrival-order shuffle: each event's
      arrival is displaced by a seeded delay drawn from
      ``[0, skew_ms)`` event-time ms. An engine watermarking with
      ``BoundedDisorderWatermark(skew_ms)`` (same bound) re-sorts the
      stream EXACTLY — zero late rows by construction (the half-open
      draw keeps the boundary tie out of the late class).
    * ``dup_rate``/``dup_burst`` — bursty duplicates: a seeded
      fraction of events is re-emitted ``dup_burst`` extra times,
      adjacent to the original (the at-least-once-redelivery shape).
      Duplicates are REAL events to the engine and to the oracle.
    * ``late_count``/``late_release_ms`` — late stragglers: seeded
      picks held back and re-injected only after the stream has
      advanced ``late_release_ms`` of event time past them AND at
      least one micro-batch boundary — guaranteed below the released
      watermark of any strategy whose skew is < ``late_release_ms``,
      so the engine's late policy (not the reorder buffer) must handle
      them.
    * ``idle_gap_every``/``idle_gap_polls`` — idle partition: every
      Nth poll the source goes silent for a run of polls (no batch, no
      watermark claim), the shape that pins a min-watermark without
      idle-source handling.
    """

    seed: int = 0
    skew_ms: int = 0
    dup_rate: float = 0.0
    dup_burst: int = 2
    late_count: int = 0
    late_release_ms: int = 0
    idle_gap_every: int = 0
    idle_gap_polls: int = 0

    def arrival(
        self, ts, chunk: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Arrival plan over a pristine timestamp array.

        Returns ``(order, dup_log, late_log)``: ``order`` indexes the
        pristine arrays in ARRIVAL order (a duplicated index appears
        ``dup_burst`` extra times, adjacent; a straggler index appears
        displaced at least two ``chunk``-sized micro-batches past the
        first arrival position whose running max event time reaches
        ``its ts + late_release_ms``). ``dup_log``/``late_log`` are the
        pristine indices duplicated / made stragglers — the EXACT
        injected account."""
        ts = np.asarray(ts, dtype=np.int64)
        n = len(ts)
        chunk = max(int(chunk), 1)
        rng = np.random.default_rng(self.seed)
        if self.skew_ms > 0:
            # half-open [0, skew): an event's arrival key never ties
            # the skew bound, so a strategy with the SAME skew never
            # classifies a shuffled (non-straggler) row late
            delays = rng.integers(0, self.skew_ms, n, dtype=np.int64)
        else:
            delays = np.zeros(n, dtype=np.int64)
        keys = ts + delays
        order = np.argsort(keys, kind="stable")
        # stragglers: seeded picks among events whose release threshold
        # (ts + late_release_ms, pessimistically + skew for arrival
        # displacement) is crossed at least THREE chunks before the
        # stream end — a straggler placed in the stream's final
        # micro-batch could still merge in order (the horizon only
        # advances at batch boundaries), which would silently shrink
        # the injected-late account
        late_log = np.empty(0, dtype=np.int64)
        if self.late_count > 0:
            ts_sorted = np.sort(ts)
            thr_pos = np.searchsorted(
                ts_sorted,
                ts + int(self.late_release_ms) + int(self.skew_ms),
            )
            eligible = np.nonzero(thr_pos <= n - 3 * chunk)[0]
            if len(eligible) < self.late_count:
                raise ValueError(
                    f"late_count={self.late_count} stragglers need "
                    "their release threshold crossed >= 3 chunks "
                    f"before the stream end; only {len(eligible)} "
                    "events qualify (lengthen the stream or shrink "
                    "late_release_ms/chunk)"
                )
            late_log = np.sort(
                rng.choice(eligible, size=self.late_count, replace=False)
            )
        is_late = np.zeros(n, dtype=bool)
        is_late[late_log] = True
        base = order[~is_late[order]]
        # bursty duplicates among the normally-arriving events
        dup_log = np.empty(0, dtype=np.int64)
        counts = np.ones(len(base), dtype=np.int64)
        if self.dup_rate > 0.0:
            dmask = rng.random(len(base)) < self.dup_rate
            counts[dmask] += int(self.dup_burst)
            dup_log = np.sort(base[dmask])
        expanded = np.repeat(base, counts)
        # straggler placement: two whole micro-batches past the
        # position where the running max crosses the release
        # threshold (one boundary guarantees a separate cycle; the
        # second absorbs the index shift earlier insertions cause)
        if len(late_log):
            run_max = np.maximum.accumulate(ts[expanded])
            pos = []
            for i in late_log.tolist():
                p = int(
                    np.searchsorted(
                        run_max, ts[i] + int(self.late_release_ms),
                        side="left",
                    )
                )
                q = (p // chunk + 2) * chunk
                if q + len(late_log) > len(expanded):
                    # backstop for the eligibility margin above: a
                    # straggler that cannot be separated from its
                    # threshold by a batch boundary is not a straggler
                    raise ValueError(
                        f"straggler (ts={int(ts[i])}) cannot be placed "
                        ">= 2 chunks past its release threshold; the "
                        "stream is too short for this schedule"
                    )
                pos.append(q)
            expanded = np.insert(
                expanded, np.asarray(pos, dtype=np.int64), late_log
            )
        return expanded, dup_log, late_log


class DisorderSource:
    """Wrap a BOUNDED source with a :class:`DisorderSchedule`.

    The inner source is drained at construction (this is a test/bench
    harness, not a production transport: the whole stream must be in
    hand to place stragglers exactly), rearranged by
    ``schedule.arrival``, and served back in ``chunk``-sized polls with
    idle gaps injected on the schedule. Publishes NO watermark claim —
    compose with :func:`runtime.sources.with_watermarks` (that is the
    point: watermark GENERATION is what is under test). Exposes the
    exact injected account (``injected``, ``dup_log``, ``late_log``)
    and the pristine stream (``pristine``) for oracle construction.

    Checkpointable by position: the arranged sequence is a pure
    function of (schedule, inner stream), so a rebuilt wrapper over
    the same inner restores exactly (supervised kill->restore runs
    ride it)."""

    def __init__(self, inner, schedule: DisorderSchedule,
                 chunk: int = 4096) -> None:
        from ..schema.batch import EventBatch

        self.stream_id = inner.stream_id
        self.schema = inner.schema
        self.schedule = schedule
        self._chunk = max(int(chunk), 1)
        batches = []
        guard = 0
        while True:
            batch, _wm, done = inner.poll(1 << 16)
            if batch is not None and len(batch):
                batches.append(batch)
            if done:
                break
            guard += 1
            if batch is None and guard > 1_000_000:
                raise ValueError(
                    "DisorderSource needs a bounded inner source "
                    "(1M empty polls without done)"
                )
        if not batches:
            raise ValueError("inner source produced no events")
        self.pristine = EventBatch.concat(batches)
        order, dup_log, late_log = schedule.arrival(
            self.pristine.timestamps, self._chunk
        )
        self._arranged = self.pristine.take(order)
        self.order = order
        self.dup_log = dup_log
        self.late_log = late_log
        self.injected = {
            "duplicates": int(len(dup_log) * schedule.dup_burst),
            "late": int(len(late_log)),
            "idle_gaps": 0,
            "idle_polls": 0,
        }
        self._pos = 0
        self._polls = 0
        self._gap_left = 0
        self._gap_fresh = False

    def poll(self, max_events: int):
        if self._pos >= len(self._arranged):
            return None, np.iinfo(np.int64).max, True
        if self._gap_left > 0:
            # injected idle partition: silence, no watermark claim. A
            # gap counts as injected only when its first silent poll is
            # actually SERVED — a gap scheduled on the stream's last
            # data poll never happens (the injected account must match
            # what the engine could observe)
            if self._gap_fresh:
                self.injected["idle_gaps"] += 1
                self._gap_fresh = False
            self._gap_left -= 1
            self.injected["idle_polls"] += 1
            return None, None, False
        self._polls += 1
        every = self.schedule.idle_gap_every
        if every and self._polls % every == 0:
            self._gap_left = max(int(self.schedule.idle_gap_polls), 0)
            self._gap_fresh = self._gap_left > 0
        n = min(max_events, self._chunk,
                len(self._arranged) - self._pos)
        lo, hi = self._pos, self._pos + n
        self._pos = hi
        done = self._pos >= len(self._arranged)
        wm = np.iinfo(np.int64).max if done else None
        return self._arranged.slice(lo, hi), wm, done

    # -- checkpoint support -------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "pos": self._pos,
            "polls": self._polls,
            "gap_left": self._gap_left,
            "idle_polls": self.injected["idle_polls"],
            "idle_gaps": self.injected["idle_gaps"],
            "gap_fresh": self._gap_fresh,
        }

    def load_state_dict(self, d: dict) -> None:
        self._pos = int(d["pos"])
        self._polls = int(d.get("polls", 0))
        self._gap_left = int(d.get("gap_left", 0))
        self._gap_fresh = bool(d.get("gap_fresh", False))
        self.injected["idle_polls"] = int(d.get("idle_polls", 0))
        self.injected["idle_gaps"] = int(d.get("idle_gaps", 0))


def wrap_job(job, plan: CrashPlan):
    """Arm a freshly built job with ``plan``'s crash points (instance-
    level wraps; the plan itself persists across factory rebuilds)."""
    orig_pull = job._pull_sources
    orig_save = job.save_checkpoint
    orig_commit = job.commit_sink_transactions

    def pull_sources():
        plan.tick_pull()
        return orig_pull()

    def save_checkpoint(path, keep=1):
        if plan.will_kill_checkpoint():
            # a mid-WRITE death (what the tmp debris simulates)
            # happens after the real save's first steps — the drain
            # and the transactional prepare — so run them before
            # raising: rows are then already flushed into the open
            # transaction whose identity the never-completed snapshot
            # would have carried. The restored job must ABORT that
            # orphan (eager InitProducerId on the epoch id), never
            # resume it — the abort half of the exactly-once claim.
            job.drain_outputs()
            prep = getattr(job, "_prepare_sink_commits", None)
            if prep is not None:
                prep()
        plan.tick_checkpoint(path)
        return orig_save(path, keep=keep)

    def commit_sink_transactions():
        plan.tick_commit()
        return orig_commit()

    job._pull_sources = pull_sources
    job.save_checkpoint = save_checkpoint
    job.commit_sink_transactions = commit_sink_transactions
    return job
