"""Bounded-stream (replay / backfill) execution mode.

For BOUNDED inputs — replays, backfills, batch jobs over recorded streams —
the whole input is known up front, so the host work can move off the clock
without changing semantics:

1. pull every source dry through the SAME reorder/watermark gate the
   streaming loop uses (``Job._pull_sources`` / ``_release_ready``);
2. build every micro-batch's wire tape on the host (``Job._stage_tape`` —
   identical interning, lazy-ring retention, width narrowing), then
   rebuild the early tapes against the final sticky widths so that every
   tape has one structure (the reference's pass B);
3. stack the tapes into segments of K, one buffer a segment
   (``runtime/segment.py``), stage them on the device, and on a GPU warm
   and capture each segment shape's CUDA graph (``runtime/graphs.py``).
   The reference pads the last segment with empty tapes to keep one
   compiled scan; here a shorter last segment gets a graph of its own,
   captured off the clock, and steps no padding;
4. advance the plan ONE device dispatch per segment — a copy of the
   segment into the graph's slot and one graph replay, with no host wait
   (on the CPU the same steps in turn) — and after each a drain request
   (the accumulator swapped for a free ring position, its fetch queued)
   and a poll that never waits: the fetches overlap the next segments.
   The run loop waits once per plan, at the end (a blocking poll), and,
   when it runs more than ``Job.MAX_PENDING_DRAINS`` segments ahead of
   the card, for the oldest drain (``Job.drains_forced``).

Per-batch semantics are those of streaming mode (the segment body is
``plan.step_acc`` over the same tapes); ``tests/test_torch_replay.py``
holds streaming and resident rows equal, and both equal to the JAX
package's.

Lazy projection note: resident mode stages the WHOLE stream before the
first drain, so a lazy-projected plan with consumers retains every
projection-only column in the host ring for the duration — size
``EngineConfig.lazy_ring_budget_bytes`` to the replay, or rows older than
the budget horizon decode as None (warned at drain time). Such a plan is also
refused past ``_LAZY_ORD_WRAP`` staged events, where streaming mode would
reset its ordinal space between two steps.

Control-in-replay: a job with control sources replays in EPOCHS. The
control timeline partitions the bounded stream at exactly the micro-batch
boundaries the streaming loop would apply each control event at (the same
watermark gate, ``Job._pop_ready_control``), and each epoch applies its
events (the executor's own epoch-boundary paths), then stages and replays
its tapes under the resulting plan set. A live control source that never
finishes is refused. With ``Job.share_subplans`` on, a shared host's
segments run like any plan's, and its drain polls step the member
suffixes with the mid rows on the run loop between segments (the
loopback's threshold flush, and everything at the waiting poll that
closes the host's epoch). Not in the port yet: ``ShardedResidentReplay`` (item
11).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..schema.batch import EventBatch
from . import executor
from .executor import Job, _PlanRuntime
from .segment import Segment, stack_wires, wire_sig
from .tape import build_wire_tape


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
        # plan_id -> its segments on the device
        self.segments: Dict[str, List[Segment]] = {}
        self.stage_seconds = 0.0
        # control-in-replay: the epochs, each its control events and its
        # ready micro-batches (None: no control sources, one pass)
        self._epochs: Optional[List[Dict]] = None

    # -- staging ----------------------------------------------------------
    def stage(self) -> None:
        """Pull, tape building, upload, and the segment graphs' warm-up
        and capture, all OFF the replay clock."""
        t0 = time.perf_counter()
        job = self.job
        if job._control or job._control_pending:
            # control-in-replay: pull and partition now; each epoch stages
            # in run(), after its control events apply
            self._pull_epochs()
            self.stage_seconds = time.perf_counter() - t0
            return
        tel = job.telemetry
        ready_sets: List[List[EventBatch]] = []
        sampled_sets: List[List[np.ndarray]] = []
        with tel.span("stage.source_pull"):
            while not job.finished:
                job._pull_sources()
                ready = job._release_ready()
                if ready:
                    if job._epoch_ms is None:
                        job._epoch_ms = min(
                            int(b.timestamps.min()) for b in ready
                        )
                    ready_sets.append(ready)
                    sampled_sets.append(self._sampled(ready))
                    self.total_events += sum(len(b) for b in ready)
        job.processed_events += self.total_events
        for pid, rt in job._plans.items():
            wires = self._plan_wires(rt, ready_sets)
            if wires is not None:
                with tel.span("stage.h2d"):
                    self.segments[pid] = self._stage_plan(rt, wires)
        if self.segments:
            with tel.span("stage.prewarm"):
                job.prewarm_drains()
        self._mark_staged(sampled_sets)
        if job.device.type == "cuda":
            torch.cuda.synchronize(job.device)
        self.stage_seconds = time.perf_counter() - t0

    def _sampled(self, ready: List[EventBatch]) -> List[np.ndarray]:
        """The sampled subsets of a released set, taken while the
        pull's subsets are at hand (the next pull lets them go)."""
        job = self.job
        return [job._sampled_of(b) for b in ready] if job.tracer.enabled \
            else []

    def _mark_staged(self, sampled_sets) -> None:
        """The end of staging for the sampled events (stamped at the
        source pull): a replay trace splits into ingest->staged (tape
        building, upload, capture) and staged->emit. Staging runs off the
        replay clock, so ``trace.e2e`` includes it."""
        tracer = self.job.tracer
        for sampled in sampled_sets:
            for ts in sampled:
                tracer.mark(ts, "staged", presampled=True)

    def _segment_cycles(self, rt: _PlanRuntime, capacity: int) -> int:
        """Steps per drain: the accumulator must hold a whole segment's
        emissions (there is no mid-segment drain), so reuse the streaming
        drain-hint bound — widest per-cycle emission block, halved
        capacity safety margin."""
        self.job._update_drain_hint(rt, capacity)
        return max(1, self.job._drain_hints[rt.plan.plan_id])

    def _plan_wires(self, rt: _PlanRuntime, ready_sets) -> Optional[List]:
        """Every host wire tape of one plan, in step order, or None when
        the plan sees no events: the streaming host half per window
        (interning, lazy-ring retention, sticky widths), then the early
        tapes rebuilt against the final sticky widths so that every tape
        has the last one's structure and they stack (the reference's pass
        B; widths and capacity only widen, so the last tape's are
        final)."""
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
        want = wire_sig(wires[-1])
        for i, w in enumerate(wires[:-1]):
            if wire_sig(w) != want:
                wires[i] = build_wire_tape(
                    rt.plan.spec, windows[i], job._epoch_ms, rt.wire_kinds,
                    capacity=rt.tape_capacity, want_prov=False,
                )[0]
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

    def _stage_plan(self, rt: _PlanRuntime, wires) -> List[Segment]:
        """Segments of K tapes (the last may be shorter) staged on the
        device, and on a GPU each segment shape's graph warmed and
        captured, for every position of an accumulator ring that holds
        one position per segment and one more, at most
        ``Job.MAX_PENDING_DRAINS`` + 1 (a longer run completes the oldest
        drain when it needs a position)."""
        job = self.job
        k = min(len(wires), self._segment_cycles(rt, wires[0].capacity))
        segs = [stack_wires(wires[i:i + k]).to(job.device)
                for i in range(0, len(wires), k)]
        if rt.graphs is None:
            rt.ring_size = min(len(segs), job.MAX_PENDING_DRAINS) + 1
        runner = job._segments(rt)
        # the off-clock captures count under this plan's compile label
        with job._compile_scope(rt):
            for seg in segs:
                runner.prepare(rt, seg)
        return segs

    # -- control-in-replay (epoch partitioning) ---------------------------
    def _pull_epochs(self) -> None:
        """Pull every source AND control stream dry, partitioned into
        epochs at the exact boundaries streaming mode would apply each
        control event at. Bounded replay needs bounded control: a live
        control source that never finishes cannot drain, and is refused
        loudly instead of spinning."""
        job = self.job
        epochs: List[Dict] = []
        current: Dict = {"control": [], "ready": [], "sampled": []}
        stalled = 0
        with job.telemetry.span("stage.source_pull"):
            while not (all(job._source_done)
                       and not any(job._pending.values())):
                before = (
                    self.total_events, job._pending_total(),
                    len(job._control_pending), sum(job._control_done),
                    sum(job._source_done),
                )
                job._pull_sources()
                job._pull_control()
                ready_ctrl = job._pop_ready_control()
                if ready_ctrl:
                    # a boundary: events released from here on step under
                    # the post-control plan set
                    if current["ready"] or current["control"]:
                        epochs.append(current)
                        current = {"control": [], "ready": [], "sampled": []}
                    current["control"].extend(ready_ctrl)
                ready = job._release_ready()
                if ready:
                    if job._epoch_ms is None:
                        job._epoch_ms = min(
                            int(b.timestamps.min()) for b in ready)
                    current["ready"].append(ready)
                    current["sampled"].append(self._sampled(ready))
                    self.total_events += sum(len(b) for b in ready)
                # pulled-but-gated batches count as progress
                after = (
                    self.total_events, job._pending_total(),
                    len(job._control_pending), sum(job._control_done),
                    sum(job._source_done),
                )
                stalled = stalled + 1 if after == before else 0
                if stalled > 10_000:
                    raise RuntimeError(
                        "bounded replay cannot drain its inputs: a "
                        "control source that never finishes (e.g. an "
                        "un-closed ControlQueueSource) is holding the "
                        "watermark; close() it before stage(), or run "
                        "streaming mode (docs/control_plane.md)"
                    )
            # trailing control (ts past the last data row): streaming
            # would still apply it before finishing
            job._pull_control()
            tail = job._pop_ready_control()
            if tail:
                if current["ready"] or current["control"]:
                    epochs.append(current)
                    current = {"control": [], "ready": [], "sampled": []}
                current["control"].extend(tail)
        if current["ready"] or current["control"]:
            epochs.append(current)
        job.processed_events += self.total_events
        self._epochs = epochs

    def _run_epochs(self) -> None:
        """Epoch by epoch: apply the epoch's control events (the
        executor's own paths, so a mutation never tears a segment), stage
        the epoch's tapes for every live plan, replay its segments, and
        complete its drains before the next epoch's events apply."""
        job = self.job
        tel = job.telemetry
        for ep in self._epochs or []:
            for ev in ep["control"]:
                job._apply_control_safely(ev)
            if not ep["ready"]:
                continue
            staged: Dict[str, List[Segment]] = {}
            for pid, rt in list(job._plans.items()):
                if not rt.enabled:
                    continue
                wires = self._plan_wires(rt, ep["ready"])
                if wires is None:
                    continue
                with tel.span("stage.h2d"):
                    staged[pid] = self._stage_plan(rt, wires)
            if staged:
                with tel.span("stage.prewarm"):
                    job.prewarm_drains()
            self._mark_staged(ep["sampled"])
            for pid, segs in staged.items():
                rt = job._plans[pid]
                for seg in segs:
                    with tel.span("replay.dispatch"):
                        job._run_segment(rt, seg)
                    with tel.span("replay.drain"):
                        job._drain_request(rt)
                        job._drain_poll(rt)
                with tel.span("replay.drain"):
                    job._drain_poll(rt, block=True)

    # -- execution --------------------------------------------------------
    def run_segment(self, plan_id: str, index: int) -> None:
        """One staged segment: one graph replay on a GPU, with no host
        wait (a segment whose chain matcher must read its relevant count
        runs its steps eagerly instead, counted in ``Job.eager_segments``
        and ``Job.host_syncs``); its steps in turn on the CPU."""
        job = self.job
        job._run_segment(job._plans[plan_id], self.segments[plan_id][index])

    def run(self) -> None:
        """The replay itself: each segment (one dispatch), then a drain
        request and a poll that never waits, so that the fetches overlap
        the next segments; per plan at the end, a waiting poll. With
        control sources, the epoch-sequential form instead."""
        if self._epochs is not None:
            return self._run_epochs()
        job = self.job
        tel = job.telemetry
        for pid, segs in self.segments.items():
            rt = job._plans[pid]
            for i in range(len(segs)):
                with tel.span("replay.dispatch"):
                    self.run_segment(pid, i)
                with tel.span("replay.drain"):
                    job._drain_request(rt)
                    job._drain_poll(rt)
            with tel.span("replay.drain"):
                job._drain_poll(rt, block=True)

    def execute(self) -> None:
        """stage + run + end-of-stream flush."""
        self.stage()
        self.run()
        self.job.flush()

    def rerun(self) -> float:
        """Benchmarking aid: reset every plan's engine state (queued
        drains complete first, so the rerun starts from an empty drain
        queue) and replay the SAME staged tapes again, returning elapsed
        seconds (run and flush, synchronized). Counts-only jobs only:
        collectors or sinks would observe every row once per run."""
        if self._epochs is not None:
            raise ValueError(
                "rerun() does not support control-in-replay jobs: "
                "epochs mutate the plan set mid-run, so a reset replay "
                "would not traverse the same control timeline"
            )
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
