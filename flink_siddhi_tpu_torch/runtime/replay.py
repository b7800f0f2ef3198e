"""Bounded-stream (replay / backfill) execution mode.

For BOUNDED inputs — replays, backfills, batch jobs over recorded streams —
the whole input is known up front, so the host work can move off the clock
without changing semantics:

1. pull every source dry through the SAME reorder/watermark gate the
   streaming loop uses (``Job._pull_sources`` / ``_release_ready``);
2. build every micro-batch's wire tape on the host (``Job._stage_tape`` —
   identical interning, lazy-ring retention, width narrowing);
3. stage every tape on the device;
4. advance the plan over them segment by segment — a plain loop of
   ``plan.step_acc`` over tapes already on the device, with no host wait
   inside a segment — and drain the emission accumulator between
   segments (``Job._drain_plan``, synchronous).

Per-batch semantics are those of streaming mode (the loop calls the same
``plan.step_acc`` on the same tapes); ``tests/test_torch_replay.py`` holds
streaming and resident rows equal, and both equal to the JAX package's.

Lazy projection note: resident mode stages the WHOLE stream before the
first drain, so a lazy-projected plan with consumers retains every
projection-only column in the host ring for the duration — size
``EngineConfig.lazy_ring_budget_bytes`` to the replay, or rows older than
the budget horizon decode as None (warned at drain time). Such a plan is also
refused past ``_LAZY_ORD_WRAP`` staged events, where streaming mode would
reset its ordinal space between two steps.

Not in the port yet: control-in-replay (the reference's epoch partitioning
of the stream by control events; the port's ``Job`` refuses control
sources, ROADMAP.md Queue 1 item 10) and ``ShardedResidentReplay`` (item
11).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from ..schema.batch import EventBatch
from . import executor
from .executor import Job, _PlanRuntime
from .tape import WireTape


def _clone(tree):
    """A copy of a (nested) dict of tensors."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class ResidentReplay:
    """One bounded run of a ``Job`` with device-resident input.

    Usage::

        job = Job([plan], [source], ...)
        rep = ResidentReplay(job)
        rep.stage()          # host tape building + upload + warm-up
        rep.run()            # the device replay (segments + drains)
        job.flush()          # end-of-stream flush, as in streaming mode

    After ``run``/``flush`` the job is in the state a streaming run over
    the same sources leaves it in: ``results()``, sinks and emitted
    counts all work.
    """

    def __init__(self, job: Job) -> None:
        self.job = job
        self.total_events = 0
        # plan_id -> segments, each a list of wire tapes on the device
        self.segments: Dict[str, List[List[WireTape]]] = {}
        self.stage_seconds = 0.0

    # -- staging ----------------------------------------------------------
    def stage(self) -> None:
        """Pull, tape building, upload and one warm step per plan, all
        OFF the replay clock."""
        t0 = time.perf_counter()
        job = self.job
        ready_sets: List[List[EventBatch]] = []
        while not job.finished:
            job._pull_sources()
            ready = job._release_ready()
            if ready:
                if job._epoch_ms is None:
                    job._epoch_ms = min(
                        int(b.timestamps.min()) for b in ready
                    )
                ready_sets.append(ready)
                self.total_events += sum(len(b) for b in ready)
        job.processed_events += self.total_events
        for pid, rt in job._plans.items():
            wires = self._plan_wires(rt, ready_sets)
            if wires is not None:
                self.segments[pid] = self._stage_plan(rt, wires)
        if job.device.type == "cuda":
            torch.cuda.synchronize(job.device)
        self.stage_seconds = time.perf_counter() - t0

    def _segment_cycles(self, rt: _PlanRuntime, capacity: int) -> int:
        """Steps per drain: the accumulator must hold a whole segment's
        emissions (there is no mid-segment drain), so reuse the streaming
        drain-hint bound — widest per-cycle emission block, halved
        capacity safety margin."""
        self.job._update_drain_hint(rt, capacity)
        return max(1, self.job._drain_hints[rt.plan.plan_id])

    def _plan_wires(self, rt: _PlanRuntime, ready_sets) -> Optional[List]:
        """Every host wire tape of one plan, in step order, or None when
        the plan sees no events. The reference rebuilds the early tapes
        against the final sticky widths and pads the last segment with
        empty tapes, only so that ``lax.scan`` gets one stacked structure;
        the port's segment is a loop over separate tapes, each expanded on
        its own, so neither is needed."""
        job = self.job
        windows = []
        for ready in ready_sets:
            windows.extend(job._plan_windows(rt, ready))
        if not windows:
            return None
        self._check_ordinal_space(rt, windows)
        wires = [job._stage_tape(rt, w) for w in windows]
        # host interning discovered every key of the stream by now
        rt.states = rt.plan.grow_state(rt.states)
        return wires

    def _check_ordinal_space(self, rt: _PlanRuntime, windows) -> None:
        """Streaming mode resets a lazy plan's ordinal space (the device
        counter ``seen`` and the host ring) between two steps when it
        nears ``_LAZY_ORD_WRAP``. Here every tape is built before any
        step runs, so that reset would land in the initial state, not
        between the steps it separates, and rows past it would decode
        against the wrong ring entries. A lazy plan whose rows are
        observed is therefore refused when its staged events would cross
        the wrap; a counts-only plan never decodes ordinals."""
        if rt.lazy is None or not self.job._has_consumers(rt):
            return
        total = sum(len(b) for w in windows for b in w)
        if rt.lazy_base + total > executor._LAZY_ORD_WRAP:
            raise ValueError(
                f"{rt.plan.plan_id}: a resident replay of a lazy-projected "
                f"plan with consumers holds at most "
                f"{executor._LAZY_ORD_WRAP} events (the lazy ordinal "
                f"space); this one stages {rt.lazy_base + total}. Replay "
                f"it in parts, run it streaming, or count only"
            )

    def _stage_plan(self, rt: _PlanRuntime, wires) -> List[List[WireTape]]:
        job = self.job
        k = min(len(wires), self._segment_cycles(rt, wires[0].capacity))
        tapes = [w.to(job.device) for w in wires]
        # one warm step on cloned state and accumulator: the kernels'
        # build and first launches, and the caching allocator's first
        # blocks, land here instead of in the timed run
        warm_states = _clone(rt.states)
        warm_acc = _clone(rt.acc)
        rt.plan.step_acc(warm_states, warm_acc, tapes[0])
        return [tapes[i:i + k] for i in range(0, len(tapes), k)]

    # -- execution --------------------------------------------------------
    def run_segment(self, plan_id: str, index: int) -> None:
        """The steps of one staged segment: ``plan.step_acc`` over its
        tapes, with no host wait (a chain matcher whose host-known
        relevance bound exceeds its compact width reads its count, as in
        streaming mode; ``Job.host_syncs`` counts it)."""
        rt = self.job._plans[plan_id]
        for tape in self.segments[plan_id][index]:
            rt.states, rt.acc = rt.plan.step_acc(rt.states, rt.acc, tape)
        rt.acc_dirty = True
        if rt.dirty_since is None:
            rt.dirty_since = time.monotonic()

    def run(self) -> None:
        """The replay itself: each segment's steps, then a drain."""
        job = self.job
        for pid, segs in self.segments.items():
            rt = job._plans[pid]
            for i in range(len(segs)):
                self.run_segment(pid, i)
                job._drain_plan(rt)

    def execute(self) -> None:
        """stage + run + end-of-stream flush."""
        self.stage()
        self.run()
        self.job.flush()

    def rerun(self) -> float:
        """Benchmarking aid: reset every plan's engine state and replay
        the SAME staged tapes again, returning elapsed seconds (run and
        flush, synchronized). Counts-only jobs only: collectors or sinks
        would observe every row once per run."""
        job = self.job
        for pid in self.segments:
            if job._has_consumers(job._plans[pid]):
                raise ValueError(
                    "rerun() is for no-consumer (counts-only) jobs; "
                    "sinks/collectors would double-observe rows"
                )
        job.reset_engine_state()
        t0 = time.perf_counter()
        self.run()
        job.flush()
        if job.device.type == "cuda":
            torch.cuda.synchronize(job.device)
        return time.perf_counter() - t0


class ShardedResidentReplay(ResidentReplay):
    """The reference's bounded replay over a sharded mesh job. Not in the
    port yet."""

    def __init__(self, job) -> None:
        raise NotImplementedError(
            "ShardedResidentReplay is not in the torch port yet (ROADMAP.md "
            "Queue 1 item 11, the parallel module); use ResidentReplay on "
            "one device"
        )
