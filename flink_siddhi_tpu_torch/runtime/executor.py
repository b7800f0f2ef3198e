"""The micro-batch runtime: sources -> compiled plan(s) -> collectors/sinks.

A minimal ``Job`` of the torch port, after ``flink_siddhi_tpu/runtime/
executor.py``: a run loop that pulls sources, releases event-time-ordered
micro-batches through a watermark gate (or everything, in processing mode),
builds each plan's tape on the host, stages it onto the device, steps the
plan, and appends every emission to an on-device accumulator. The host
drains the accumulator in bulk (two fetches: counts, then the used slice)
and decodes rows for collectors and sinks.

Not in this port yet (ROADMAP.md Queue 1): the control plane, fused
segments, resident replay, telemetry, checkpoints, shared subplans, the
lazy ring, the narrow wire tape, and the late/idle/backpressure policies
beyond the default (late rows are dropped and counted).

The job runs on the CUDA device unless ``device`` names another one.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compiler.plan import CompiledPlan
from ..device import DeviceLike, resolve_device
from ..schema.batch import EventBatch
from .sources import Source
from .tape import bucket_size, build_tape

_LOG = logging.getLogger(__name__)

MAX_WM = np.iinfo(np.int64).max
MIN_WM = -(2 ** 62)  # pre-first-event watermark sentinel


@dataclass
class _PlanRuntime:
    plan: CompiledPlan
    states: Dict
    acc: Dict  # device-side output accumulator
    # sticky tape capacity: once a capacity is used, smaller batches (the
    # end-of-stream tail) pad up to it instead of bucketing down
    tape_capacity: int = 0
    # False while the accumulator is provably empty (drained, no step
    # since): a drain then skips its fetches entirely
    acc_dirty: bool = False
    # when the accumulator FIRST became dirty after a drain: the age of
    # the oldest undrained match (the interval drain keys off it)
    dirty_since: Optional[float] = None


class Job:
    """One running pipeline: sources -> compiled plan(s) -> collectors/sinks."""

    def __init__(
        self,
        plans: Sequence[CompiledPlan],
        sources: Sequence[Source],
        batch_size: int = 4096,
        time_mode: str = "event",  # 'event' | 'processing'
        retain_results: bool = True,  # keep emitted rows in collected[]
        device: DeviceLike = None,  # None = the CUDA device
    ) -> None:
        if time_mode not in ("event", "processing"):
            raise ValueError(time_mode)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.time_mode = time_mode
        self.retain_results = retain_results
        self._sources = list(sources)
        self._source_wm: List[int] = [MIN_WM] * len(self._sources)
        self._source_done: List[bool] = [False] * len(self._sources)
        # reorder buffer: stream_id -> pending EventBatches (event time)
        self._pending: Dict[str, List[EventBatch]] = {}
        self._epoch_ms: Optional[int] = None
        self._plans: Dict[str, _PlanRuntime] = {}
        # output_stream -> list[(ts, row_tuple)]
        self.collected: Dict[str, List[Tuple[int, Tuple]]] = {}
        self.emitted_counts: Dict[str, int] = {}  # total rows ever emitted
        self._sinks: Dict[str, List[Callable]] = {}
        self.processed_events = 0
        # drain the device accumulators at least every N cycles so a long
        # run cannot overflow them; per-plan capacity hints tighten it
        self.drain_every_cycles = 256
        self._drain_hints: Dict[str, int] = {}
        self._cycles_since_drain = 0
        # staleness budget: a plan's accumulated matches are drained when
        # the oldest reaches this age (None disables; capacity drains
        # still happen)
        self.drain_interval_ms: Optional[float] = 500.0
        # host syncs made by drains (the count fetch and the data fetch
        # each wait for the device); artifacts count their own
        self.drain_syncs = 0
        # event-time gate: the horizon released so far (rows at or below
        # it are late, dropped and counted) and the monotone gate wm
        self._released_wm: int = MIN_WM
        self._gate_wm: int = MIN_WM
        self._max_event_ts: Optional[int] = None
        self.late_events = 0
        self.late_dropped = 0
        for p in plans:
            self.add_plan(p)

    def add_plan(self, plan: CompiledPlan) -> None:
        if plan.plan_id in self._plans:
            raise ValueError(f"plan {plan.plan_id!r} is already running")
        self._plans[plan.plan_id] = _PlanRuntime(
            plan, plan.init_state(self.device), plan.init_acc(self.device)
        )

    def add_sink(self, output_stream: str, fn: Callable) -> None:
        """Attach a sink ``fn(abs_ts, row_tuple)``. Rows accumulated
        before the sink attached are drained first and not delivered to
        it; rows after are."""
        for rt in self._plans.values():
            self._drain_plan(rt)
        self._sinks.setdefault(output_stream, []).append(fn)

    @property
    def host_syncs(self) -> int:
        """Every host wait for the device so far: drain fetches plus the
        artifacts' own (the chain matcher's compaction branch)."""
        return self.drain_syncs + sum(
            getattr(a, "host_syncs", 0)
            for rt in self._plans.values()
            for a in rt.plan.artifacts
        )

    # -- run loop ------------------------------------------------------------
    def run(self, max_cycles: Optional[int] = None) -> None:
        cycles = 0
        while not self.finished:
            self.run_cycle()
            cycles += 1
            if max_cycles is not None and cycles >= max_cycles:
                break
        if self.finished:
            self.flush()

    def flush(self) -> None:
        """End-of-stream: drain accumulated matches, then fire final
        timer-driven emissions (timed-absence deadlines)."""
        for rt in self._plans.values():
            self._drain_plan(rt)
            if not rt.plan.has_flush:
                continue
            rt.states, outputs = rt.plan.flush(rt.states)
            self._decode_outputs(rt.plan, outputs)

    @property
    def finished(self) -> bool:
        return all(self._source_done) and not any(
            batches for batches in self._pending.values()
        )

    def run_cycle(self) -> int:
        """Pull, reorder, step, drain when due. Returns events processed."""
        self._pull_sources()
        ready = self._release_ready()
        total = 0
        if ready:
            total = sum(len(b) for b in ready)
            self.processed_events += total
            if self._epoch_ms is None:
                self._epoch_ms = min(
                    int(b.timestamps.min()) for b in ready
                )
            for rt in self._plans.values():
                self._step_plan(rt, ready)
            self._cycles_since_drain += 1
        if self.drain_interval_ms is not None:
            now = time.monotonic()
            for rt in self._plans.values():
                if (
                    rt.dirty_since is not None
                    and self._has_consumers(rt)
                    and (now - rt.dirty_since) * 1e3
                    >= self.drain_interval_ms
                ):
                    self._drain_plan(rt)
        if ready and self._cycles_since_drain >= min(
            self.drain_every_cycles,
            min(self._drain_hints.values(), default=self.drain_every_cycles),
        ):
            # capacity-bounding drain before the no-overflow horizon
            self.drain_outputs()
            self._cycles_since_drain = 0
        return total

    def _watermark(self) -> int:
        """min watermark across sources."""
        return min(self._source_wm) if self._source_wm else MAX_WM

    def _pull_sources(self) -> None:
        for i, src in enumerate(self._sources):
            if self._source_done[i]:
                continue
            batch, swm, done = src.poll(self.batch_size)
            if batch is not None and len(batch):
                self._pending.setdefault(src.stream_id, []).append(batch)
                bmax = int(batch.timestamps.max())
                if self._max_event_ts is None or bmax > self._max_event_ts:
                    self._max_event_ts = bmax
            if swm is not None:
                self._source_wm[i] = max(self._source_wm[i], swm)
            if done:
                self._source_done[i] = True
                self._source_wm[i] = MAX_WM

    def _release_ready(self) -> List[EventBatch]:
        """Watermark gate: release per-stream prefixes with ts <= the min
        watermark (processing mode releases everything). The gate
        watermark is monotone; rows at or below the horizon already
        released are late and are dropped (counted in late_events)."""
        if self.time_mode == "processing":
            ready = [
                EventBatch.concat(bs).sort_by_time()
                for bs in self._pending.values()
                if bs
            ]
            self._pending.clear()
            return ready
        raw = self._watermark()
        # the MAX end-of-stream sentinel releases everything but is never
        # kept as gate state
        if raw != MAX_WM and raw > self._gate_wm:
            self._gate_wm = raw
        wm = MAX_WM if raw == MAX_WM else self._gate_wm
        horizon = self._released_wm
        ready: List[EventBatch] = []
        for sid in list(self._pending):
            merged = EventBatch.concat(self._pending[sid]).sort_by_time()
            if horizon > MIN_WM:
                n_late = int(
                    np.searchsorted(
                        merged.timestamps, horizon, side="right"
                    )
                )
                if n_late:
                    self.late_events += n_late
                    self.late_dropped += n_late
                    _LOG.warning(
                        "%d late rows on %r dropped (event time at or "
                        "below the released horizon)", n_late, sid,
                    )
                    merged = merged.slice(n_late, len(merged))
            n_ready = int(
                np.searchsorted(merged.timestamps, wm, side="right")
            )
            if n_ready:
                ready.append(merged.slice(0, n_ready))
            rest = merged.slice(n_ready, len(merged))
            if len(rest):
                self._pending[sid] = [rest]
            else:
                del self._pending[sid]
        if wm != MAX_WM:
            if wm > self._released_wm:
                self._released_wm = wm
        elif (
            self._max_event_ts is not None
            and self._max_event_ts > self._released_wm
        ):
            # end of stream: everything observed has been released
            self._released_wm = self._max_event_ts
        return ready

    def _plan_windows(
        self, rt: _PlanRuntime, ready: List[EventBatch]
    ) -> List[List[EventBatch]]:
        """Split a ready set into the tape windows this plan will step
        (oversized single-stream micro-batches step in chunks of
        ``tape_capacity_limit``)."""
        plan = rt.plan
        involved = [
            b for b in ready if b.stream_id in plan.spec.stream_codes
        ]
        if not involved:
            return []
        total = sum(len(b) for b in involved)
        limit = plan.tape_capacity_limit
        if limit and total > limit and len(involved) == 1:
            b = involved[0]
            return [
                [b.slice(s, min(s + limit, len(b)))]
                for s in range(0, len(b), limit)
            ]
        return [involved]

    def _step_plan(self, rt: _PlanRuntime, ready: List[EventBatch]) -> None:
        for involved in self._plan_windows(rt, ready):
            tape = self._stage_tape(rt, involved)
            # host interning may have discovered new keys: re-bucket the
            # keyed state tables before the step (host-known sizes)
            rt.states = rt.plan.grow_state(rt.states)
            rt.states, rt.acc = rt.plan.step_acc(rt.states, rt.acc, tape)
            rt.acc_dirty = True
            if rt.dirty_since is None:
                rt.dirty_since = time.monotonic()
            self._update_drain_hint(rt.plan, tape.capacity)

    def _stage_tape(self, rt: _PlanRuntime, involved: List[EventBatch]):
        """Host half of one step: build the tape (numpy), then stage it
        onto the device (pinned host memory, asynchronous upload)."""
        total = sum(len(b) for b in involved)
        rt.tape_capacity = max(rt.tape_capacity, bucket_size(total))
        tape = build_tape(
            rt.plan.spec, involved, self._epoch_ms,
            capacity=rt.tape_capacity,
        )
        return tape.to(self.device)

    def _update_drain_hint(self, plan: CompiledPlan,
                           tape_capacity: int) -> None:
        """Capacity-bounding drain cadence: each artifact declares its
        widest per-cycle emission block; a drain empties the accumulator,
        so no overflow requires (k+1)*block <= cap, with the reference's
        /2 safety margin."""
        block = max(
            (
                a.emit_block_width(tape_capacity)
                if hasattr(a, "emit_block_width")
                else tape_capacity
                for a in plan.artifacts
            ),
            default=tape_capacity,
        )
        self._drain_hints[plan.plan_id] = max(
            1, plan.acc_capacity() // (2 * max(block, 1)) - 1
        )

    # -- drain -----------------------------------------------------------------
    def drain_outputs(self) -> None:
        """Surface all on-device accumulated emissions to collectors and
        sinks (synchronous)."""
        for rt in self._plans.values():
            self._drain_plan(rt)

    def _has_consumers(self, rt: _PlanRuntime) -> bool:
        if self.retain_results:
            return True
        return any(self._sinks.get(sid) for sid in rt.plan.output_streams())

    def _drain_plan(self, rt: _PlanRuntime) -> None:
        """Fetch the accumulator's counts (one host wait) and, when some
        consumer wants rows, the used slice of the buffer (a second);
        decode, emit, and reset the accumulator's counts in place (the
        stale buffer columns are overwritten by later appends and never
        read)."""
        if not rt.acc_dirty or not rt.plan.artifacts:
            return
        plan = rt.plan
        meta = rt.acc["meta"].cpu().numpy()
        self.drain_syncs += 1
        counts, overflow = meta[0], meta[1]
        max_n = int(counts.max()) if counts.size else 0
        if self._has_consumers(rt) and max_n:
            data = rt.acc["buf"][:, :max_n].cpu().numpy()
            self.drain_syncs += 1
            decoded = plan.drain_decode(counts, data)
            for a in plan.artifacts:
                for schema, rows in decoded.get(a.name) or []:
                    self._emit_rows(schema, rows)
        else:
            # counts-only drain (no consumers): keep the counters truthful
            for ai, a in enumerate(plan.artifacts):
                c = int(counts[ai])
                if c:
                    sid = a.output_schema.stream_id
                    self.emitted_counts[sid] = (
                        self.emitted_counts.get(sid, 0) + c
                    )
        for ai, a in enumerate(plan.artifacts):
            if overflow[ai] > 0:
                _LOG.warning(
                    "%s: %d emissions dropped (accumulator full; raise "
                    "EngineConfig.acc_budget_bytes or drain more often)",
                    a.name, int(overflow[ai]),
                )
        rt.acc["meta"].zero_()
        rt.acc_dirty = False
        rt.dirty_since = None

    def _decode_outputs(self, plan: CompiledPlan, outputs: Dict) -> None:
        """Decode step/flush outputs fetched straight from the device (the
        end-of-stream flush path; packed artifacts only)."""
        for a in plan.artifacts:
            if a.name not in outputs:
                continue
            count, block = outputs[a.name][0], outputs[a.name][1]
            n = int(count)
            if n == 0:
                continue
            decoded = a.decode_packed(n, block.cpu().numpy())
            for schema, rows in decoded:
                self._emit_rows(schema, rows)

    def _emit_rows(self, schema, rows) -> None:
        """Append decoded rows (relative ts) to collectors and sinks."""
        if not rows:
            return
        sid = schema.stream_id
        epoch = self._epoch_ms or 0
        self.emitted_counts[sid] = self.emitted_counts.get(sid, 0) + len(rows)
        sinks = self._sinks.get(sid)
        if self.retain_results:
            self.collected.setdefault(sid, []).extend(
                (epoch + rel_ts, row) for rel_ts, row in rows
            )
        for sink in sinks or ():
            for rel_ts, row in rows:
                sink(epoch + rel_ts, row)

    # -- results -------------------------------------------------------------
    def results(self, output_stream: str) -> List[Tuple]:
        self.drain_outputs()
        return [row for _, row in self.collected.get(output_stream, [])]

    def results_with_ts(self, output_stream: str) -> List[Tuple[int, Tuple]]:
        self.drain_outputs()
        return list(self.collected.get(output_stream, []))
