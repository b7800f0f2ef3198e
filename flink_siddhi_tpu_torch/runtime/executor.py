"""The micro-batch runtime: sources -> compiled plan(s) -> collectors/sinks.

A minimal ``Job`` of the torch port, after ``flink_siddhi_tpu/runtime/
executor.py``: a run loop that pulls sources, releases event-time-ordered
micro-batches through a watermark gate (or everything, in processing mode),
builds each plan's narrow wire tape on the host, stages it onto the
device, steps the plan, and appends every emission to an on-device
accumulator. ``runtime/replay.py:ResidentReplay`` drives the same job over
a bounded stream staged on the device beforehand.

Fused streaming (``fused_segment_len`` K > 1, the reference's
``_stage_fused``/``_dispatch_segment``): the host stages K tapes, stacks
them into one pinned host buffer (``runtime/segment.py``), and advances
the plan over the whole segment with one copy of that buffer into the
graph's input slot and one CUDA graph replay (``runtime/graphs.py``); on
the CPU the same segment body runs its steps in turn.
``fused_segment_len=None`` keeps one step per tape. At most
``Job.max_inflight_cycles`` segments are unfinished on the card.

The drain is asynchronous (the reference's ``_drain_request`` /
``_drain_poll``): a drain swaps the live accumulator for a free position
of the plan's accumulator ring, in stream order, queues the old one, and
issues the copy of its counts into pinned host memory on a copy stream,
behind a CUDA event recorded after the work that filled it. Once that
copy has completed, the job's one fetch thread reads the counts and, when
some consumer wants rows and any were emitted, copies the used columns (a
count-sized, bucketed width) on a second copy stream, releases the ring
position (an event the compute stream waits on before it reuses the
position), and decodes: to row tuples, or to ``ColumnBatch``es for a
stream whose every consumer is columnar (``ColumnarSink``). The run loop
completes finished drains in order and emits to collectors and sinks; it
waits for the card only in a waiting drain (``results()``, ``flush()``,
the end of a resident run) or when the queue or the ring is full (a
forced completion, counted). On the CPU the same code runs, every drain
ready at once. Drain latency legs go to ``Job.telemetry``
(``telemetry/``).

Event time is the reference's (``_pull_sources``, ``_release_ready``): a
monotone gate watermark over the sources that are not idle, a late policy
('drop', 'side_output' onto ``late_stream(sid)``, 'allow' with
``allowed_lateness_ms``), idle sources and a bounded backlog
(``max_pending_events`` with 'block' or 'drop_oldest'). Output rate
limiting (``output ... every``) thins rows where they surface
(``_OutputRateLimiter``). ``snapshot``, ``save_checkpoint`` and
``restore`` (``runtime/checkpoint.py``) carry the whole job in the JAX
package's checkpoint format; ``runtime/supervisor.py`` restarts from them.

The control plane (the reference's ``control_sources``, ``add_plan(...,
dynamic=True)``, ``remove_plan``, ``set_plan_enabled``): control events
from control sources apply at epoch boundaries, at the start of a cycle's
ingest (``_apply_ready_control``), gated by the same watermark as the
data; in fused mode the pending segment dispatches before any mutation of
its runtime, so a mutation never tears a step. A template-able chain
query admitted at run time folds into a padded ``DynamicChainGroup``
(``compiler/nfa.py``) as a data write into the state tensors the
runtime's graphs are bound to: no new runtime, no new graph key. A bad
control event is refused (``control_rejections``, the
``control.admission_rejected`` counter) and never stops the loop.
``RUNLOOP_OWNERSHIP_GUARD`` asserts that the mutators run on the run-loop
thread.

Admission (``analysis/``): an applied add or update is compiled, verified
(``plancheck``'s static tier) and analyzed (``admit``'s cost hooks, and
under ``Job.admission_budgets`` the footprint and the budget verdicts)
before it touches the stack; a refusal is recorded with its rule ids. A
verdict the service gate already passed rides the event (``precleared``)
and skips the deep re-check. The footprint meter (``footprint_status``)
holds each runtime's measured CUDA state and accumulator-ring bytes
against the bytes admission predicted for them. Staged tapes, graph
slots and graph pools are outside both.

Subplan sharing (``share_subplans``, ``FST_SUBPLAN_SHARE=1``): a dynamic
add whose query opens with a shareable filter prefix (``analysis/
share.py``) splits into a producer host ``@shr:<key>`` that runs the
prefix once for every tenant with the same predicate, and the tenant's
suffix reading the host's mid stream ``_shr_<key>``. The mid rows loop
back on the host as columns: the host's drains decode them on the fetch
thread to ``ColumnBatch``es (``_emit_columns`` hands them to
``_feed_loopback`` before any counter or sink), and ``_flush_loopback``
sorts them by time and steps the suffixes with them, in ``batch_size``
chunks, on the run loop. Retire reference-counts the members;
checkpoints carry the share table (``shared``).

Telemetry (``telemetry/``, the reference's): the registry's spans and
drain legs; the flight recorder (``Job.flightrec``: control applies,
checkpoint save and restore, shed, late, stall and backpressure bursts,
compiles), which a checkpoint carries; per-event trace sampling
(``Job.tracer``: stamped at the source pull, marked at staging and
dispatch, completed where a row surfaces); per-plan attribution (every
output schema stamped with the plan id its rows count to, a dynamic
group's members with their own; ``matches`` and ``rows_emitted`` counted
at the emission sites, drain legs in every member's scope); the SLO
watchdog (``Job.slo``, evaluated once a cycle); compile events (CUDA graph
captures and kernel builds, ``telemetry/compile_events.py``) attributed to
the plan whose section fired them; and the OpenMetrics text
(``Job.openmetrics``). Every hook runs on the host at a segment, drain or
cycle boundary, on arrays the host holds, never inside a captured graph.

Not in this port yet (ROADMAP.md Queue 1): the executable cache.

The job runs on the CUDA device unless ``device`` names another one.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.admit import _tree_nbytes
from ..compiler.output import ColumnBatch
from ..compiler.plan import CompiledPlan
from ..device import DeviceLike, resolve_device
from ..schema.batch import EventBatch
from ..telemetry import MetricsRegistry, compile_events
from ..telemetry.attribution import limiting_leg as _attr_limiting_leg
from ..telemetry.flightrec import FlightRecorder
from ..telemetry.slo import SLOWatchdog
from ..telemetry.tracing import TraceSampler
from .graphs import SegmentGraphs
from .segment import (
    Segment,
    pad_segment,
    segment_nbytes,
    stack_wires,
    wire_sig,
)
from .sources import Source
from .tape import WireTape, bucket_size, build_wire_tape

_LOG = logging.getLogger(__name__)

# Run-loop ownership contract: with the guard on, the first run()/
# run_cycle() stamps its thread id as the run-loop owner, and every
# state-mutating control entry point (add_plan / remove_plan /
# set_plan_enabled / _apply_control / reset_engine_state) asserts it runs
# on that thread: state mutates only via control events applied on the
# run loop (a REST handler thread pushes events, nothing else)
RUNLOOP_OWNERSHIP_GUARD = False


class OwnershipViolation(RuntimeError):
    """A run-loop-owned mutation entry point ran on a thread other than
    the stamped run-loop owner."""


@contextlib.contextmanager
def _device_work():
    """Device work inside a plan mutation (a segment dispatch, a blocking
    drain, a write into a group's state). Its failure propagates as it
    is, marked, so that ``Job._apply_control_safely`` lets it stop the run
    (the dispatched tapes are gone) rather than log it as a bad control
    event."""
    try:
        yield
    except Exception as e:
        e.control_device_fault = True
        raise


# every live Job of the process: a graph capture (any Job's) first waits
# for their fetch threads' CUDA calls (``Job._settle_drains``)
_LIVE_JOBS: "weakref.WeakSet[Job]" = weakref.WeakSet()

MAX_WM = np.iinfo(np.int64).max
MIN_WM = -(2 ** 62)  # pre-first-event watermark sentinel
_LAZY_ORD_WRAP = 1 << 30  # reset lazy ordinal space before int32 wrap
# side-output channel naming: a stream's late rows surface on
# '<stream_id>@late' (attach sinks there; ColumnarSink-capable)
LATE_STREAM_SUFFIX = "@late"


def late_stream(stream_id: str) -> str:
    """The side-output stream id carrying ``stream_id``'s late rows."""
    return stream_id + LATE_STREAM_SUFFIX


def _encode_mid(schema, cb: ColumnBatch, order: np.ndarray) -> Dict:
    """A mid stream's decoded columns, reordered by ``order``, encoded
    for the source's ``schema`` (the host's ``select *`` keeps its field
    order): device dtypes, strings interned in the source's dictionary,
    which every suffix's mid DDL shares."""
    cols: Dict[str, np.ndarray] = {}
    for name, atype, col in zip(schema.field_names, schema.field_types,
                                cb.cols.values()):
        col = col[order]
        if atype.is_encoded:
            vals = col.tolist()
            table = schema.string_tables[name]
            codes = {v: table.intern(v) for v in dict.fromkeys(vals)}
            cols[name] = np.fromiter(map(codes.__getitem__, vals),
                                     np.int32, len(vals))
        else:
            cols[name] = np.asarray(col, dtype=atype.device_dtype)
    return cols


def retire_tickets(tickets: Deque, limit: int) -> int:
    """The in-flight window over ``tickets`` (events of dispatched
    segments, oldest first): drop the finished ones from the front, and
    while more than ``limit`` remain, wait for the oldest. Returns the
    waits."""
    waits = 0
    while tickets:
        if len(tickets) > limit:
            tickets.popleft().synchronize()
            waits += 1
        elif tickets[0].query():
            tickets.popleft()
        else:
            break
    return waits


class ColumnarSink:
    """Protocol/base for sinks opting into the columnar fast lane.

    A sink exposing ``accept_columns(ts, cols)`` receives whole emission
    batches as ``(abs_ts int64 ndarray, {field_name: ndarray})`` in
    emission order, and no per-row tuple is built on streams where EVERY
    attached sink is columnar (and host retention is off). On streams that
    still decode row-wise (mixed consumers, a stacked artifact, retained
    results) the job converts once per emission batch and calls
    ``accept_columns`` with object-dtype columns, so a columnar sink
    observes identical data either way. Duck-typed: any object with
    ``accept_columns`` counts; subclassing this base is optional."""

    def accept_columns(
        self, ts: np.ndarray, cols: Dict[str, np.ndarray]
    ) -> None:
        raise NotImplementedError


class _OutputRateLimiter:
    """Host emission-layer rate limiter (``output [all|last|first] every
    N events | <duration>`` and ``output snapshot every <duration>``), the
    reference's ``_OutputRateLimiter`` (``flink_siddhi_tpu/runtime/
    executor.py:297-505``): the role of siddhi-core's output rate
    limiters, applied where rows surface to collectors and sinks, so that
    thinned streams also skip the retention and callback cost."""

    def __init__(self, rate, snapshot_keys: tuple = ()) -> None:
        self.mode = rate.mode  # 'events' | 'time' | 'snapshot'
        self.which = rate.which  # all | last | first
        self.n = max(int(rate.n_events), 1)
        self.ms = float(rate.ms)
        self.count = 0  # events-mode position within the chunk
        self.buf: List = []
        self.deadline: Optional[float] = None
        # snapshot mode: latest row per group key (positions into the
        # output row); emitted in full every interval
        self.snapshot_keys = tuple(snapshot_keys or ())
        self.cur: Dict = {}

    def _normalize_buf_rows(self) -> None:
        """A stream can change lanes mid-flight (a row sink attached via
        add_sink drops it off the columnar lane): column fragments the
        other lane buffered are lifted to ``(ts, row)`` pairs so chunk
        accounting continues exactly where it left off."""
        if any(isinstance(b, ColumnBatch) for b in self.buf):
            self.buf = [
                r
                for b in self.buf
                for r in (
                    b.rows() if isinstance(b, ColumnBatch) else [b]
                )
            ]

    def _normalize_buf_columns(self, field_names) -> None:
        """Inverse lane switch: row-era ``(ts, row)`` entries become
        single-row ColumnBatches (order preserved) so concat/take on
        the columnar path stay uniform."""
        def lift(entry):
            if isinstance(entry, ColumnBatch):
                return entry
            ts, row = entry
            return ColumnBatch(
                np.asarray([ts], dtype=np.int64),
                {
                    name: np.asarray([val], dtype=object)
                    for name, val in zip(field_names, row)
                },
            )

        if not all(isinstance(b, ColumnBatch) for b in self.buf):
            self.buf = [lift(b) for b in self.buf]

    def feed(self, rows: List) -> List:
        # normalize only when rows are actually absorbed into the
        # buffer: a flush (idle interval poll or elapsed deadline)
        # releases buffered entries AS-IS — _emit_pending/flush route
        # ColumnBatch entries through the columnar emit path, so a
        # columnar-lane buffer never explodes into per-row tuples just
        # to be rebuilt into columns for its own sinks
        if self.buf and rows:
            self._normalize_buf_rows()
        if self.mode == "snapshot":
            # roll the interval BEFORE absorbing, as in time mode: rows
            # arriving after a deadline belong to the new interval
            now = time.monotonic()
            if self.deadline is None:
                self.deadline = now + self.ms / 1e3
            flushed: List = []
            if now >= self.deadline:
                flushed = list(self.cur.values())
                self.deadline = now + self.ms / 1e3
            for r in rows:  # (rel_ts, row)
                k = tuple(r[1][i] for i in self.snapshot_keys)
                self.cur[k] = r
            return flushed
        if self.mode == "events":
            out: List = []
            for r in rows:
                pos = self.count % self.n
                self.count += 1
                if self.which == "first":
                    if pos == 0:
                        out.append(r)
                elif self.which == "last":
                    self.buf = [r]
                    if pos == self.n - 1:
                        out.append(r)
                        self.buf = []
                else:  # all: release the chunk when it completes
                    self.buf.append(r)
                    if pos == self.n - 1:
                        out.extend(self.buf)
                        self.buf = []
            return out
        # time mode (processing time): roll the interval over BEFORE
        # processing — rows arriving after a deadline belong to the NEW
        # interval (processing them first would drop the new interval's
        # first event / misattribute late rows to the old interval)
        now = time.monotonic()
        if self.deadline is None:
            self.deadline = now + self.ms / 1e3
        flushed: List = []
        if now >= self.deadline:
            if self.which != "first":
                flushed = (
                    self.buf if self.which == "all" else self.buf[-1:]
                )
            self.buf = []
            self.deadline = now + self.ms / 1e3
        if self.which == "first":
            out = list(flushed)
            for r in rows:
                if not self.buf:
                    self.buf = [r]  # first of the interval
                    out.append(r)
            return out
        self.buf.extend(rows)
        return flushed

    def feed_columns(self, cb) -> List:
        """Columnar twin of :meth:`feed`: account a whole ColumnBatch
        with index arithmetic and array slices — no row tuples. Events
        and time modes only (snapshot needs per-group latest rows and
        is excluded from the columnar lane by Job._columnar_streams).
        Parity with the row path is pinned by tests."""
        n = len(cb)
        if self.buf:
            self._normalize_buf_columns(list(cb.cols))
        if self.mode == "events":
            pos0 = self.count
            self.count += n
            pos = (pos0 + np.arange(n, dtype=np.int64)) % self.n
            if self.which == "first":
                sel = np.nonzero(pos == 0)[0]
                return [cb.take(sel)] if sel.size else []
            if self.which == "last":
                sel = np.nonzero(pos == self.n - 1)[0]
                out = [cb.take(sel)] if sel.size else []
                if n and (pos0 + n) % self.n != 0:
                    # an incomplete chunk's latest row waits for flush()
                    self.buf = [cb.take(np.array([n - 1]))]
                elif sel.size:
                    self.buf = []
                return out
            # all: release through the end of the last COMPLETE chunk
            complete = np.nonzero(pos == self.n - 1)[0]
            if not complete.size:
                if n:
                    self.buf.append(cb)
                return []
            cut = int(complete[-1]) + 1
            parts = list(self.buf) + ([cb.take(np.arange(cut))]
                                      if cut else [])
            self.buf = (
                [cb.take(np.arange(cut, n))] if cut < n else []
            )
            return [ColumnBatch.concat(parts)] if parts else []
        # time mode: same deadline-roll-before-absorb contract as feed()
        now = time.monotonic()
        if self.deadline is None:
            self.deadline = now + self.ms / 1e3
        flushed: List = []
        if now >= self.deadline:
            if self.which != "first":
                flushed = (
                    self.buf if self.which == "all" else self.buf[-1:]
                )
            self.buf = []
            self.deadline = now + self.ms / 1e3
        if self.which == "first":
            out = list(flushed)
            if not self.buf and n:
                head = cb.take(np.array([0]))
                self.buf = [head]
                out.append(head)
            return out
        if n:
            if self.which == "last":
                # only the latest row can ever surface: keep just it
                self.buf = [cb.take(np.array([n - 1]))]
            else:
                self.buf.append(cb)
        return flushed

    def flush(self) -> List:
        """End of stream: pending buffered output surfaces."""
        if self.mode == "snapshot":
            out = list(self.cur.values())
            self.cur = {}
            return out
        if self.which == "first":
            self.buf = []
            return []
        out = (
            self.buf
            if self.which == "all"
            else self.buf[-1:]
        )
        self.buf = []
        return out


class _LazyRing:
    """Host-retained projection-only columns (late materialization).

    Lazy-projected plans emit event ORDINALS; this ring maps them back
    to values at decode time. Entries are evicted oldest-first past a
    byte budget — an ordinal older than the horizon decodes as None
    (bounded-memory policy, counted in ``missed``). The run loop pushes
    and evicts while the drain fetch thread decodes, and so looks up:
    every method holds the ring's lock."""

    def __init__(self, budget_bytes: int = 256 << 20) -> None:
        self.starts: List[int] = []
        self.lens: List[int] = []
        self.cols: List[Dict[str, np.ndarray]] = []
        self.bytes = 0
        self.budget = budget_bytes
        self.missed = 0
        self._lock = threading.Lock()

    def push(self, start: int, cols: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(cols.values()))) if cols else 0
        with self._lock:
            self.starts.append(start)
            self.lens.append(n)
            self.cols.append(cols)
            self.bytes += sum(c.nbytes for c in cols.values())
            while self.bytes > self.budget and len(self.starts) > 1:
                old = self.cols.pop(0)
                self.starts.pop(0)
                self.lens.pop(0)
                self.bytes -= sum(c.nbytes for c in old.values())

    def _locate(self, ords):
        """(ords int64, entry index per ordinal, offset in it, hit mask)."""
        ords = np.asarray(ords, dtype=np.int64)
        starts = np.asarray(self.starts, dtype=np.int64)
        lens = np.asarray(self.lens, dtype=np.int64)
        idx = np.searchsorted(starts, ords, side="right") - 1
        safe = np.clip(idx, 0, None)
        ok = (idx >= 0) & (ords - starts[safe] < lens[safe])
        return idx, ords - starts[safe], ok

    def lookup(self, key: str, ords) -> List:
        """Batch ordinal resolve to Python values (None where evicted):
        one searchsorted + one gather per ring entry touched."""
        with self._lock:
            return self._lookup(key, ords)

    def _lookup(self, key: str, ords) -> List:
        n = len(ords)
        out: List = [None] * n
        if n == 0 or not self.starts:
            self.missed += n
            return out
        idx, offs, ok = self._locate(ords)
        self.missed += int(n - ok.sum())
        for i in np.unique(idx[ok]).tolist():
            sel = np.nonzero(ok & (idx == i))[0]
            entry = self.cols[i]
            if key not in entry:
                self.missed += len(sel)
                continue
            vals = entry[key][offs[sel]].tolist()
            for j, v in zip(sel.tolist(), vals):
                out[j] = v
        return out

    def lookup_np(self, key: str, ords) -> np.ndarray:
        """Vectorized ordinal resolve: the same gather as :meth:`lookup`,
        kept a numpy array — typed when every ordinal hits, object-dtype
        with None holes when any was evicted past the ring horizon."""
        with self._lock:
            return self._lookup_np(key, ords)

    def _lookup_np(self, key: str, ords) -> np.ndarray:
        n = len(ords)
        if n == 0 or not self.starts:
            self.missed += n
            return np.full(n, None, dtype=object)
        idx, offs, ok = self._locate(ords)
        out = None
        found = np.zeros(n, dtype=bool)
        for i in np.unique(idx[ok]).tolist():
            sel = np.nonzero(ok & (idx == i))[0]
            entry = self.cols[i]
            if key not in entry:
                continue
            col = entry[key]
            if out is None:
                out = np.zeros(n, dtype=col.dtype)
            out[sel] = col[offs[sel]]
            found[sel] = True
        self.missed += int(n - found.sum())
        if out is None:
            return np.full(n, None, dtype=object)
        if not bool(found.all()):
            obj = out.astype(object)
            obj[~found] = None
            return obj
        return out


@dataclass
class _PlanRuntime:
    plan: CompiledPlan
    states: Dict
    acc: Dict  # the live device-side output accumulator
    # the accumulator ring: ``acc`` is (a rebinding of) ring[acc_pos]; a
    # drain swaps in a free position while the fetch thread reads the old
    # one. ring_size positions at most (all of them before a graph is
    # captured); ring_release[i]: the CUDA event behind the copies of the
    # last fetch of position i, which the compute stream waits on before
    # it reuses it (None: nothing to wait for)
    ring: List[Dict] = field(default_factory=list)
    acc_pos: int = 0
    ring_size: int = 2
    ring_release: List = field(default_factory=list)
    # queued drains, oldest first (Job._drain_request)
    drain_q: Deque = field(default_factory=collections.deque)
    # host buffers: each ring position's counts, and the fetch thread's
    # used columns (pinned on a GPU; Job.prewarm_drains allocates them up
    # front)
    host_meta: Optional[torch.Tensor] = None
    host_buf: Optional[torch.Tensor] = None
    # sticky per-column wire widths (build_wire_tape)
    wire_kinds: Dict = field(default_factory=dict)
    # lazy projection: the tape keys the ring retains, whether it also
    # retains rebased timestamps ("@ts", for blocks without a ts row),
    # the ring itself (None for a plan with no lazy artifact), the
    # artifact whose state holds the device ordinal counter ``seen``, and
    # lazy_base, the host's copy of that counter (both count every valid
    # event staged, so the host never reads it from the device)
    lazy_keys: Tuple[str, ...] = ()
    lazy_ts: bool = False
    lazy: Optional[_LazyRing] = None
    lazy_state_name: Optional[str] = None
    lazy_base: int = 0
    lazy_miss_warned: int = 0
    # sticky tape capacity: once a capacity is used, smaller batches (the
    # end-of-stream tail) pad up to it instead of bucketing down
    tape_capacity: int = 0
    # False while the accumulator is provably empty (drained, no step
    # since): a drain then skips its fetches entirely
    acc_dirty: bool = False
    # when the accumulator FIRST became dirty after a drain: the age of
    # the oldest undrained match (the interval drain keys off it)
    dirty_since: Optional[float] = None
    # fused streaming: staged, undispatched host tapes as (tape, its
    # signature, staging time), and the CUDA events of dispatched
    # segments, oldest first (the in-flight ticket window)
    seg_pending: List = field(default_factory=list)
    tickets: Deque = field(default_factory=collections.deque)
    # the segment runner (graphs.py): the tensors segments update in
    # place and, on a GPU, the captured graphs; made at the first segment
    graphs: Optional[SegmentGraphs] = None
    # a disabled standalone plan steps no tape (OperationControlEvent)
    enabled: bool = True


class Job:
    """One running pipeline: sources -> compiled plan(s) -> collectors/sinks."""

    # queued drains per plan; past this the oldest is completed (each
    # holds a ring position until its fetch has copied it)
    MAX_PENDING_DRAINS = 6
    # the smallest data-fetch width: a drain copies the used columns
    # rounded up to a power of two of at least this
    MIN_FETCH_WIDTH = 64

    def __init__(
        self,
        plans: Sequence[CompiledPlan],
        sources: Sequence[Source],
        batch_size: int = 4096,
        time_mode: str = "event",  # 'event' | 'processing'
        retain_results: bool = True,  # keep emitted rows in collected[]
        device: DeviceLike = None,  # None = the CUDA device
        control_sources: Sequence = (),
        plan_compiler: Optional[Callable] = None,  # (cql, plan_id) -> plan
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
        # host waits, by thread. The run loop's in drains: a waiting
        # poll that had to wait for the card or the fetch thread (once a
        # poll), forced completions among them (drains_forced); the
        # artifacts count their own (host_syncs). The fetch thread's:
        # one per copy it waited for (fetch_syncs), which equals the
        # completed drains' fetches (drain_fetches) once none is queued.
        # drains_overlapped: drains whose counts reached the host while
        # the dispatch after them was still unfinished on the card
        self.drain_waits = 0
        self.drains_forced = 0
        self.fetch_syncs = 0
        self.drain_fetches = 0
        self.drains_overlapped = 0
        # stage-attributed wall clock, drain latency legs, counters
        self.telemetry = MetricsRegistry()
        self._fetch_pool_: Optional[concurrent.futures.Executor] = None
        _LIVE_JOBS.add(self)
        # the drains' copy streams: counts (issued by the run loop) and
        # data (by the fetch thread), apart so that a data copy never
        # queues behind the counts of a later, unfinished dispatch
        self._meta_stream = self._data_stream = None
        # output rate limiting: stream_id -> limiter (from the plans'
        # ``output ... every`` clauses, applied at emission)
        self._rate_limiters: Dict[str, _OutputRateLimiter] = {}
        # the interval cadence of time-mode limiters (run_cycle)
        self._last_full_drain = time.monotonic()
        # graceful degradation: bound the host reorder backlog. None =
        # unbounded. Over the bound, 'block' stops pulling every source
        # but the watermark laggards; 'drop_oldest' sheds the oldest
        # pending batches, counted (shed_events, faults.shed_events)
        self.max_pending_events: Optional[int] = None
        self.shed_policy: str = "block"  # 'block' | 'drop_oldest'
        self.shed_events = 0
        self._shed_warned_at = -1e9
        # the event-time gate. A row at or below the horizon already
        # released (_released_wm) is late; late_policy decides: 'drop'
        # (counted in late_dropped), 'side_output' (the full input row on
        # late_stream(sid)), 'allow' (the released horizon is held back by
        # allowed_lateness_ms, so rows late by at most that still merge in
        # order; later ones drop, loudly). The gate watermark (_gate_wm)
        # is monotone: an un-idled source cannot drag it back
        self.late_policy: str = "drop"
        self.allowed_lateness_ms: int = 0
        self.late_events = 0  # rows classified late (every policy)
        self.late_dropped = 0  # the subset discarded
        self._late_warned_at = -1e9
        self._released_wm: int = MIN_WM
        self._gate_wm: int = MIN_WM
        self._max_event_ts: Optional[int] = None
        # idle sources: a source that yields nothing for idle_timeout_ms
        # stops pinning the min watermark until its next event (0: at its
        # first empty poll; None: never)
        self.idle_timeout_ms: Optional[float] = None
        self._source_idle: List[bool] = [False] * len(self._sources)
        self._source_last_t: List[Optional[float]] = (
            [None] * len(self._sources))
        # gate residency: per stream, (arrival time, batch max ts) of
        # each pending batch, retired once the horizon passes its max
        self._pending_t: Dict[str, List[Tuple[float, int]]] = {}
        # fused streaming dispatch: K tapes a segment, one graph replay a
        # segment (None or 1: one step per tape)
        self.fused_segment_len: Optional[int] = None
        self.fusion_batches = 0  # tapes staged into segments
        self.fusion_dispatches = 0  # segments dispatched
        self.fusion_h2d_uploads = 0  # segment uploads (one a segment)
        # fused: at most this many dispatched segments unfinished on the
        # card per plan; the host waits for the oldest beyond it (counted
        # in backpressure_waits). With target_p99_ms set, run_cycle adapts
        # it to the measured cycle pace
        self.max_inflight_cycles = 6
        self.target_p99_ms: Optional[float] = None
        self._cycle_ema: Optional[float] = None
        self._last_cycle_t: Optional[float] = None
        self.backpressure_waits = 0
        # segments (resident or fused) that no graph can capture (a tape's
        # chain matcher must read its count): on a GPU they run their
        # steps eagerly (graphs.py)
        self.eager_segments = 0
        # fault visibility: sources that report transport or state faults
        # (KafkaSource's retry counters, a byte source's degraded
        # positions) count them into this job's registry
        for src in self._sources:
            bind = getattr(src, "bind_telemetry", None)
            if bind is not None:
                bind(self.telemetry)
        # -- the control plane ----------------------------------------------
        # control sources poll (ts, event) pairs; their watermarks join
        # the data sources' in the gate, and pending events apply at the
        # epoch boundary the watermark passes them
        self._control = list(control_sources)
        self._control_wm: List[int] = [MIN_WM] * len(self._control)
        self._control_done: List[bool] = [False] * len(self._control)
        self._control_pending: List[Tuple[int, object]] = []
        self._plan_compiler = plan_compiler
        # dynamic chain groups: user plan_id -> (host runtime id, slot);
        # the enabled flags' host mirror; each dynamic plan's CQL (what a
        # checkpoint replays); each plan's tenant
        self._folded: Dict[str, Tuple[str, int]] = {}
        self._folded_enabled: Dict[str, bool] = {}
        self._dynamic_cql: Dict[str, str] = {}
        self._plan_tenant: Dict[str, str] = {}
        # the run-loop owner's thread id (RUNLOOP_OWNERSHIP_GUARD), stamped
        # at the first cycle; a restored job re-stamps at its own
        self._runloop_thread: Optional[int] = None
        # recent control-path refusals by plan id: rule ids, rendered
        # findings, tenant, source. Bounded ring, oldest evicted first;
        # lock-guarded (a REST thread may read it while the run loop
        # records)
        self.control_rejections: Dict[str, dict] = {}
        self._rejections_lock = threading.Lock()
        self.MAX_REJECTIONS_KEPT = 64
        # apply-time admission budgets (analysis/admit.AdmissionBudgets):
        # None runs the static tiers only; set, an applied add or update
        # is refused on any ADM finding
        self.admission_budgets = None
        # the footprint meter's denominators: plan id -> the bytes
        # admission predicted (state + accumulator)
        self._plan_admitted_bytes: Dict[str, int] = {}
        self._footprint_warned_at = -1e9
        # -- subplan sharing (analysis/share.py) ----------------------------
        # share key -> {host_id, mid, prefix_cql, src, mid_schema,
        # members}: the host (@shr:<key>) runs the prefix once and its
        # mid-stream rows loop back on the host into every member's
        # suffix runtime; retire reference-counts the members and drops
        # the host with the last one. Run loop only; off-thread readers
        # take dict() snapshots
        self._shared: Dict[str, Dict] = {}
        # member plan id -> share key (the refcount's edges)
        self._shared_member: Dict[str, str] = {}
        # mid stream id -> share key: _emit_columns hands these streams
        # to the loopback before any counter or sink (mid rows are
        # plumbing, not output)
        self._loopback: Dict[str, str] = {}
        # mid stream id -> [[ColumnBatch of abs timestamps], rows, wall
        # time of the oldest]: coalesced between flushes, so that the
        # suffixes step once a flush, not once a drained host payload
        self._loopback_buf: Dict[str, list] = {}
        # opt-in: sharing changes the runtime layout of a dynamic admit
        # (host + suffix instead of one runtime)
        import os

        self.share_subplans = os.environ.get(
            "FST_SUBPLAN_SHARE", "0").lower() not in ("0", "", "false")
        for p in plans:
            self.add_plan(p)
        # -- the serving telemetry (made after the static adds, as the
        # reference's: a static add journals nothing) ------------------------
        # the flight recorder: the job's bounded journal (control applies,
        # checkpoint save and restore, shed/late/stall bursts, compiles),
        # silenced with the registry; a checkpoint carries it, so it
        # survives a restore exactly once
        self.flightrec = FlightRecorder(registry=self.telemetry)
        # compile events (CUDA graph captures, kernel builds) of sections
        # marked with _compile_scope: per-plan counts in
        # metrics()["compiles"], the compile.* registry series, the journal
        self._compile_sink = compile_events.CompileSink(
            self.telemetry, self.flightrec)
        compile_events.install()
        # per-event trace sampling: events with abs_ts % sample_every == 0
        # are stamped at the source pull and completed where a row with
        # that timestamp surfaces (trace.e2e); sample_every=0 turns it off
        self.tracer = TraceSampler(self.telemetry)
        # id(batch) -> (batch, its sampled subset) for the batches pulled
        # and still pending or released this cycle: the one full-batch
        # pass of the sampling rule, taken at the pull, serves the stamp
        # and the staged and dispatch marks (_sampled_of)
        self._trace_pulled: Dict[int, Tuple[EventBatch, np.ndarray]] = {}
        # per-tenant SLO objectives, evaluated once a cycle (a no-op
        # without policies: job.slo.set_policy). It reads the job through
        # a weak proxy: a watchdog holding the job would make every Job a
        # reference cycle, whose device memory only the cyclic collector
        # frees
        self.slo = SLOWatchdog(weakref.proxy(self))

    # -- run-loop ownership guard ---------------------------------------------
    def _stamp_runloop_owner(self) -> None:
        if self._runloop_thread is None:
            self._runloop_thread = threading.get_ident()

    def _assert_runloop_owner(self, what: str) -> None:
        """No-op unless RUNLOOP_OWNERSHIP_GUARD is on and a run loop has
        stamped ownership (set-up from the constructing thread is
        legitimate)."""
        if not RUNLOOP_OWNERSHIP_GUARD or self._runloop_thread is None:
            return
        me = threading.get_ident()
        if me != self._runloop_thread:
            raise OwnershipViolation(
                f"{what} executed on thread {me}, but the run loop "
                f"(thread {self._runloop_thread}) owns Job state — "
                "state mutates only via control events applied at "
                "micro-batch boundaries (push a control event instead "
                "of mutating directly; docs/control_plane.md)"
            )

    # -- plans: static and dynamic adds, retire, enable -----------------------
    def add_plan(self, plan: CompiledPlan, dynamic: bool = False,
                 cql: Optional[str] = None) -> None:
        """Run ``plan``. ``dynamic=True`` (the control plane's add): a
        template-able chain plan folds into a live dynamic group's free
        slot (a data write) or becomes a new padded group; a re-add of a
        live id replaces it. Pass ``cql`` so a direct dynamic add can be
        checkpointed (the control-event path records it)."""
        self._assert_runloop_owner("add_plan")
        if not dynamic:
            self._create_runtime(plan)
            return
        # the control path records the event's tenant before this call,
        # so admits and stack joins count into its scope too
        tenant = self.tenant_of(plan.plan_id)
        if plan.plan_id in self._folded or plan.plan_id in self._plans:
            # a redelivered add (an at-least-once control channel)
            # replaces, never double-registers
            self.remove_plan(plan.plan_id)
        if cql is not None:
            self._dynamic_cql[plan.plan_id] = cql
        if self._try_fold(plan):
            # a data write into a live group's slot: the cheapest admit
            for name in ("control.admitted", "control.stack_join"):
                self.telemetry.inc(name)
                self._inc_tenant(tenant, name)
            self.flightrec.record(
                "control.admit", plan=plan.plan_id, tenant=tenant,
                stack_join=True)
            return
        if self.share_subplans and self._try_share(plan, tenant):
            # the prefix runs as a shared host and the tenant rode in as
            # its suffix; _try_share's inner dynamic add counted it
            return
        self.flightrec.record(
            "control.admit", plan=plan.plan_id, tenant=tenant,
            stack_join=False)
        plan, admit0 = self._wrap_dynamic(plan)
        self.telemetry.inc("control.admitted")
        self._inc_tenant(tenant, "control.admitted")
        self._create_runtime(plan, admit0)

    def tenant_of(self, plan_id: str) -> str:
        """The tenant a plan is attributed to ('default' when it was
        admitted without one)."""
        return self._plan_tenant.get(plan_id) or "default"

    def _inc_tenant(self, tenant: Optional[str], name: str,
                    n: int = 1) -> None:
        """A tenant-scoped counter (``scopes.tenant.<id>``)."""
        tel = self.telemetry
        if tel.enabled:
            tel.scope("tenant", tenant or "default").inc(name, n)

    # -- per-plan attribution --------------------------------------------------
    def _stamp_attribution(self, plan: CompiledPlan) -> None:
        """Stamp every output schema of ``plan`` with the plan id its rows
        count to (``plan_attr``, read by ``_attr_scope`` where rows are
        counted), so per-plan counts are exact even when plans insert into
        one output stream. A dynamic group decodes each slot with its
        MEMBER's own schema, stamped with the member's id."""
        from ..compiler.nfa import DynamicChainGroup

        for schemas in plan.output_streams().values():
            for sch in schemas:
                sch.plan_attr = plan.plan_id
        for a in plan.artifacts:
            if isinstance(a, DynamicChainGroup):
                for m in a.members:
                    if m is not None:
                        m[1].plan_attr = m[0]

    def _attr_scope(self, schema):
        """The plan scope a schema's rows count to (None for a schema no
        plan stamped)."""
        pid = getattr(schema, "plan_attr", None)
        if pid is None:
            return None
        return self.telemetry.scope("plan", pid)

    def _scope_plans_of(self, rt: _PlanRuntime) -> List[str]:
        """The USER plan ids a runtime serves: itself for a standalone
        plan, every live member for a dynamic group host or a shared
        prefix host. A host's drain legs record into each member's scope
        (every member's matches waited through that drain)."""
        pid = rt.plan.plan_id
        if pid.startswith("@shr:"):
            for e in list(self._shared.values()):
                if e["host_id"] == pid:
                    return list(e["members"]) or [pid]
            return [pid]
        if not pid.startswith("@dyn:"):
            return [pid]
        from ..compiler.nfa import DynamicChainGroup

        arts = rt.plan.artifacts
        if arts and isinstance(arts[0], DynamicChainGroup):
            return [m[0] for m in arts[0].members if m is not None]
        return [pid]

    def _scoped_drain_record(self, rt: _PlanRuntime, total_s: float,
                             staleness_s: Optional[float]) -> None:
        """The plan-scoped twins of ``drain.total`` and
        ``drain.staleness``, in the scope of every plan the runtime
        serves."""
        tel = self.telemetry
        if not tel.enabled:
            return
        for pid in self._scope_plans_of(rt):
            sc = tel.scope("plan", pid)
            sc.record_seconds("drain.total", total_s)
            if staleness_s is not None:
                sc.record_seconds("drain.staleness", staleness_s)

    def _compile_scope(self, rt: _PlanRuntime):
        """The compile-attribution scope of one plan's section
        (``telemetry/compile_events.py``): a CUDA graph capture or a
        kernel build inside it counts under ``plan:<id>`` in
        ``metrics()["compiles"]``. Thread-local and re-entrant; entering it
        is an attribute store."""
        return compile_events.attribution(self._compile_sink,
                                          f"plan:{rt.plan.plan_id}")

    # -- the footprint meter (admitted vs measured) ---------------------------
    def admitted_bytes(self, state_bytes: int, acc_bytes: int) -> int:
        """The device bytes a plan with these admission footprints may
        hold here: its state and a full accumulator ring
        (``MAX_PENDING_DRAINS`` + 1 accumulators: the live one and those
        that queued drains still read). ``ADM102`` prices one
        accumulator, as the reference's budget does."""
        return int(state_bytes) + (self.MAX_PENDING_DRAINS + 1) * int(
            acc_bytes)

    def set_admitted_footprint(self, plan_id: str, nbytes: int) -> None:
        """Record the admission-predicted device bytes of a plan
        (``admitted_bytes``: state + accumulator ring): the meter's
        denominator. The control path records it from the admission
        analysis; static jobs set it from
        ``analysis.admit.analyze_plan(plan, deep=True)``."""
        self._plan_admitted_bytes[plan_id] = int(nbytes)

    def _update_footprint(self, rt: _PlanRuntime) -> None:
        """Measure the runtime's live device bytes (states + every
        accumulator of its ring) against the admission-time prediction,
        at drain boundaries only. Publishes ``footprint.measured_bytes``
        in the plan's scope and, with a recorded prediction,
        ``footprint.admitted_bytes``, ``footprint.utilization`` and the
        ``footprint.overruns`` counter when measured exceeds admitted (a
        live soundness monitor on the analyzer). Group hosts publish
        measured bytes only: a member's prediction prices a standalone
        query."""
        tel = self.telemetry
        if not tel.enabled:
            return
        # tensor metadata only: no device wait
        measured = _tree_nbytes(rt.states) + sum(
            _tree_nbytes(acc) for acc in (rt.ring or [rt.acc]))
        pid = rt.plan.plan_id
        sc = tel.scope("plan", pid)
        sc.gauge("footprint.measured_bytes", int(measured))
        admitted = self._plan_admitted_bytes.get(pid)
        if admitted is None or admitted <= 0:
            return
        sc.gauge("footprint.admitted_bytes", int(admitted))
        sc.gauge("footprint.utilization", round(measured / admitted, 6))
        if measured > admitted:
            tel.inc("footprint.overruns")
            sc.inc("footprint.overruns")
            now = time.monotonic()
            if now - self._footprint_warned_at >= 1.0:
                self._footprint_warned_at = now
                _LOG.warning(
                    "%s: measured device footprint %d B exceeds the "
                    "admitted %d B — the admission prediction was unsound "
                    "for this plan, or its state grew past the admission-"
                    "time shapes", pid, measured, admitted,
                )

    def footprint_status(self) -> Dict[str, Dict[str, object]]:
        """The last-polled footprint per runtime ({plan_id: {measured,
        admitted?, utilization?}}); reads scope gauges only, safe
        off-thread."""
        out: Dict[str, Dict[str, object]] = {}
        for pid, reg in self.telemetry.scope_map("plan").items():
            measured = reg.gauge_value("footprint.measured_bytes")
            if measured is None:
                continue
            ent: Dict[str, object] = {"measured_bytes": int(measured)}
            admitted = reg.gauge_value("footprint.admitted_bytes")
            if admitted is not None:
                ent["admitted_bytes"] = int(admitted)
                ent["utilization"] = reg.gauge_value(
                    "footprint.utilization")
            out[pid] = ent
        return out

    def _create_runtime(self, plan: CompiledPlan,
                        admit0: Optional[Callable] = None) -> None:
        if plan.plan_id in self._plans:
            raise ValueError(f"plan {plan.plan_id!r} is already running")
        with _device_work():
            acc = plan.init_acc(self.device)
            rt = _PlanRuntime(plan, plan.init_state(self.device), acc,
                              ring=[acc], ring_release=[None],
                              ring_size=self.MAX_PENDING_DRAINS + 1)
            if admit0 is not None:
                rt.states = admit0(rt.states)
        lazy_arts = [
            a for a in plan.artifacts if getattr(a, "lazy_src_keys", ())
        ]
        if lazy_arts:
            rt.lazy_keys = tuple(sorted(
                {k for a in lazy_arts for k in a.lazy_src_keys}
            ))
            rt.lazy_ts = any(
                getattr(a, "ring_needs_ts", False) for a in lazy_arts
            )
            rt.lazy = _LazyRing(plan.config.lazy_ring_budget_bytes)
            rt.lazy_state_name = lazy_arts[0].name
        self._plans[plan.plan_id] = rt
        # after admit0: a dynamic host's first member is registered by now,
        # so its schema gets the MEMBER's id
        self._stamp_attribution(plan)
        for sid, rate in plan.output_rates.items():
            self._rate_limiters[sid] = _OutputRateLimiter(
                rate, plan.snapshot_keys.get(sid, ()))

    # -- dynamic chain groups (data-write adds) --------------------------------
    def _group_string_tables(self, plan: CompiledPlan, tpl) -> Dict:
        """The string tables a group interns its members' STRING params
        through: the host plan's schemas' (the environment's shared
        dictionary)."""
        out = {}
        for keys in tpl.filter_keys:
            for key in keys:
                sid, fname = key.split(".", 1)
                out[key] = plan.schemas[sid].string_tables.get(fname)
        return out

    def _fold_into(self, host_id: str, plan: CompiledPlan, slot: int,
                   t) -> None:
        """Write ``plan`` into the host group's ``slot``, in place into the
        state tensors the runtime's graphs are bound to (no new state
        signature, so no new graph). Fused mode: the tapes staged before
        this add step without the new member first."""
        rt = self._plans[host_id]
        group = rt.plan.artifacts[0]
        tpl, params, within = t
        with _device_work():
            self._dispatch_segment(rt)
            group.admit(
                rt.states[group.name], slot, plan.plan_id,
                plan.artifacts[0].output_schema, params, within,
                self._group_string_tables(rt.plan, tpl),
            )
        self._folded[plan.plan_id] = (host_id, slot)
        self._folded_enabled[plan.plan_id] = True
        # the group decodes this slot with the member's schema object:
        # stamp it with the MEMBER's id (every member shares one stream)
        plan.artifacts[0].output_schema.plan_attr = plan.plan_id

    def _try_fold(self, plan: CompiledPlan) -> bool:
        from ..compiler.nfa import DynamicChainGroup, chain_template_of

        if len(plan.artifacts) != 1:
            return False
        t = chain_template_of(plan.artifacts[0], plan.spec.column_types)
        if t is None:
            return False
        tpl = t[0]
        for host_id, rt in self._plans.items():
            arts = rt.plan.artifacts
            if not (len(arts) == 1
                    and isinstance(arts[0], DynamicChainGroup)
                    and arts[0].template == tpl):
                continue
            slot = arts[0].free_slot()
            if slot is None:
                continue
            self._fold_into(host_id, plan, slot, t)
            return True
        return False

    def _wrap_dynamic(self, plan: CompiledPlan,
                      host_id: Optional[str] = None, slot: int = 0):
        """A single template-able chain plan becomes a padded dynamic
        group (so the NEXT structurally identical add is a data write);
        returns (the host plan, its first member's admit) or (``plan``,
        None). The host's tape spec drops the member's relevance entry:
        the group steps the full tape (its members' literals differ), so
        it never reads a relevant count and captures on every path."""
        import dataclasses

        from ..compiler.nfa import DynamicChainGroup, chain_template_of

        if len(plan.artifacts) != 1:
            return plan, None
        t = chain_template_of(plan.artifacts[0], plan.spec.column_types)
        if t is None:
            return plan, None
        tpl, params, within = t
        art = plan.artifacts[0]
        host_id = host_id or f"@dyn:{plan.plan_id}"
        if host_id in self._plans:  # an id collision
            return plan, None
        group = DynamicChainGroup(
            name=art.name,
            template=tpl,
            stream_code_of=tuple(
                plan.spec.stream_codes[sid] for sid in tpl.stream_ids
            ),
            column_types=dict(plan.spec.column_types),
            members=[None] * plan.config.dyn_query_slots,
            pool=art.pool,
            capacity=plan.config.dyn_query_slots,
        )
        spec = dataclasses.replace(plan.spec, relevance=tuple(
            r for r in plan.spec.relevance if r[0] != art.name))
        new_plan = dataclasses.replace(
            plan, plan_id=host_id, artifacts=[group], spec=spec)
        tables = self._group_string_tables(plan, tpl)

        def admit0(states):
            group.admit(states[group.name], slot, plan.plan_id,
                        art.output_schema, params, within, tables)
            return states

        self._folded[plan.plan_id] = (host_id, slot)
        self._folded_enabled[plan.plan_id] = True
        return new_plan, admit0

    def _replay_dynamic(self, dynamic_cql: Dict[str, str],
                        folded: Dict[str, Tuple[str, int]],
                        enabled: Dict[str, bool]) -> None:
        """Checkpoint restore: re-add the dynamically added queries so
        that runtimes, groups and SLOT assignments match the snapshot
        (the state restore then overlays params and partial pools)."""
        from ..compiler.nfa import chain_template_of

        by_host: Dict[str, List[Tuple[int, str]]] = {}
        for pid, (host_id, slot) in folded.items():
            by_host.setdefault(host_id, []).append((int(slot), pid))
        for host_id, members in sorted(by_host.items()):
            members.sort()
            first = True
            for slot, pid in members:
                cql = dynamic_cql.get(pid)
                if cql is None:
                    _LOG.warning(
                        "dynamic plan %r has no recorded CQL; it cannot "
                        "be restored", pid,
                    )
                    continue
                plan = self._plan_compiler(cql, pid)
                if first:
                    wrapped, admit0 = self._wrap_dynamic(
                        plan, host_id=host_id, slot=slot)
                    self._create_runtime(wrapped, admit0)
                    if wrapped.plan_id != host_id:
                        # the group could not be re-formed: its members
                        # restore as standalone runtimes
                        _LOG.warning(
                            "dynamic group %r could not be re-formed; "
                            "restoring its members as standalone plans",
                            host_id,
                        )
                        self._folded.pop(pid, None)
                        self._folded_enabled.pop(pid, None)
                        for s2, p2 in members:
                            if s2 <= slot or p2 not in dynamic_cql:
                                continue
                            self._create_runtime(
                                self._plan_compiler(dynamic_cql[p2], p2))
                        break
                    first = False
                else:
                    t = chain_template_of(plan.artifacts[0],
                                          plan.spec.column_types)
                    if t is None:
                        _LOG.warning(
                            "dynamic plan %r no longer folds into group "
                            "%r; restoring it standalone", pid, host_id,
                        )
                        self._folded.pop(pid, None)
                        self._folded_enabled.pop(pid, None)
                        self._create_runtime(plan)
                        continue
                    self._fold_into(host_id, plan, slot, t)
        for pid, cql in dynamic_cql.items():
            if pid not in folded and pid not in self._plans:
                # standalone dynamic plans (not template-able)
                self._create_runtime(self._plan_compiler(cql, pid))
        for pid, on in enabled.items():
            if not on:
                self.set_plan_enabled(pid, False)
        self._dynamic_cql.update(dynamic_cql)

    # -- cross-tenant shared subplans (analysis/share.py) ---------------------
    def _try_share(self, plan: CompiledPlan, tenant) -> bool:
        """The subplan-share rung (below the stack join): split a
        shareable filter prefix off the candidate, attach the tenant's
        residue as a consumer suffix, and run the prefix ONCE as a
        producer host shared by every tenant whose predicate is exactly
        equal. Both halves are rendered, compiled and verified before any
        state changes; any failure returns False and the admit falls
        through to the unshared rungs — never to a wrong program."""
        from ..analysis import share as shr
        from ..analysis.plancheck import verify_plan

        if self._plan_compiler is None:
            return False
        src = plan.source_ast
        if (src is None or len(src.queries) != 1 or src.stream_defs
                or src.table_defs or plan.chained):
            return False
        sp = shr.split_shared_prefix(src.queries[0])
        if sp is None:
            return False
        src_schema = plan.schemas.get(sp.stream_id)
        if src_schema is None:
            return False
        key = sp.key()
        mid = shr.mid_stream_of(key)
        host_id = shr.host_id_of(key)
        entry = self._shared.get(key)
        pid = plan.plan_id
        try:
            s_cql = shr.suffix_cql(src.queries[0], sp, mid, src_schema)
            suffix_plan = self._plan_compiler(s_cql, pid)
            if verify_plan(suffix_plan, trace=False, raise_on_error=False):
                return False
            host_plan = None
            if entry is None:
                p_cql = shr.prefix_cql(sp, mid)
                host_plan = self._plan_compiler(p_cql, host_id)
                if verify_plan(host_plan, trace=False,
                               raise_on_error=False):
                    return False
        except Exception:  # noqa: BLE001 — the renderer or the compiler
            # refused: this predicate is outside the faithful subset and
            # the admit proceeds unshared (fail closed, never wrong)
            return False
        if entry is None:
            self._create_runtime(host_plan)
            entry = {
                "host_id": host_id,
                "mid": mid,
                "prefix_cql": p_cql,
                "src": sp.stream_id,
                # the loopback's encode schema: the prefix is `select *`,
                # so mid rows carry the SOURCE stream's fields in source
                # order; encoded with the source schema (the environment's
                # string dictionary, which every suffix's mid DDL shares),
                # string codes stay comparable across the loopback
                "mid_schema": src_schema,
                "members": [],
            }
            self._shared[key] = entry
            self._loopback[mid] = key
        if entry["members"]:
            host_rt = self._plans.get(entry["host_id"])
            if host_rt is not None:
                # the live host's pending mid rows go to the EXISTING
                # members before this one attaches: a late joiner must
                # never see rows produced before its admit
                self._drain_plan(host_rt)
        entry["members"].append(pid)
        self._shared_member[pid] = key
        # a checkpoint replays the SUFFIX (the host re-forms from the
        # "shared" block first); _apply_control's setdefault keeps it
        self._dynamic_cql[pid] = s_cql
        self.telemetry.inc("control.subplan_share")
        self._inc_tenant(tenant, "control.subplan_share")
        self.flightrec.record(
            "control.subplan_share", plan=pid, tenant=tenant, host=host_id,
            mid=mid, key=key, members=len(entry["members"]))
        # the suffix takes the rest of the ladder itself: structurally
        # equal suffixes stack-join into one dynamic group (recursion is
        # safe: split_shared_prefix refuses readers of a mid stream)
        self.add_plan(suffix_plan, dynamic=True)
        folded = self._folded.get(pid)
        rt = self._plans.get(folded[0] if folded is not None else pid)
        if rt is not None:
            # pre-size the suffix's tape to the flush chunk bound
            # (_flush_loopback chunks at batch_size): a flush never
            # regrows a tape a captured segment is bound to
            rt.tape_capacity = max(rt.tape_capacity,
                                   bucket_size(self.batch_size))
        return True

    def _feed_loopback(self, schema, cb: ColumnBatch) -> None:
        """Buffer a shared prefix's decoded mid-stream columns for its
        consumer suffixes (absolute timestamps). Reached from
        ``_emit_columns`` before any counter, collector or sink: mid rows
        are plumbing, not output."""
        mid = schema.stream_id
        if mid not in self._loopback:
            return
        pend = self._loopback_buf.get(mid)
        if pend is None:
            # [batches, rows, the wall time of the OLDEST buffered row
            # (the freshness bound for jobs that never drain with a wait)]
            pend = self._loopback_buf[mid] = [[], 0, time.monotonic()]
        pend[0].append(ColumnBatch(cb.ts + np.int64(self._epoch_ms or 0),
                                   cb.cols))
        pend[1] += len(cb)

    def _flush_loopback(self, force: bool = False) -> None:
        """Step the consumer suffixes with their mid streams' coalesced
        rows, on the run loop. Two regimes:

        * threshold (``force=False``, the steady drain polls): a mid
          flushes once it has buffered ``batch_size`` rows, or once its
          oldest row is one drain interval old — the suffixes' dispatch
          rate follows the prefix's MATCH volume, not the source's tape
          volume;
        * barrier (``force=True``, every waiting drain: results,
          snapshot, retire, attach): everything flushes, so that rows the
          host produced are visible to the members before state is read,
          a member retires, or a late joiner attaches.

        Rows step time-ordered (a stable sort of the buffered columns) in
        chunks of ``batch_size``, so a suffix's tape capacity stays at the
        bucket it was pre-sized to."""
        if not self._loopback_buf:
            return
        limit = max(1, int(self.batch_size or 1))
        age_s = (self.drain_interval_ms or 0.0) / 1e3
        now = time.monotonic()
        ready = [
            mid for mid, (_, n, t0) in list(self._loopback_buf.items())
            if force or n >= limit or (age_s and now - t0 >= age_s)
        ]
        for mid in ready:
            pending = self._loopback_buf.pop(mid, None)
            if pending is None:
                continue  # a nested barrier flush took it
            entry = self._shared.get(self._loopback.get(mid, ""))
            if entry is None or not pending[1]:
                continue
            cb = ColumnBatch.concat(pending[0])
            order = np.argsort(cb.ts, kind="stable")
            ts = cb.ts[order]
            mid_schema = entry["mid_schema"]
            cols = _encode_mid(mid_schema, cb, order)
            consumers = [
                rt for rt in list(self._plans.values())
                if rt.enabled and mid in rt.plan.spec.stream_codes
            ]
            for i in range(0, len(ts), limit):
                batch = EventBatch(
                    mid, mid_schema,
                    {k: c[i:i + limit] for k, c in cols.items()},
                    ts[i:i + limit],
                )
                for rt in consumers:
                    self._step_plan(rt, [batch])

    def _replay_shared(self, shared: Dict[str, Dict]) -> None:
        """Checkpoint restore of the share table: re-form every producer
        host from its prefix CQL and rebuild the loopback routing BEFORE
        ``_replay_dynamic`` re-admits the member suffixes, so that hosts
        precede their consumers in runtime insertion order (a host drains
        before its consumers)."""
        for key, info in sorted(shared.items()):
            members = [str(m) for m in info.get("members", ())]
            if not members:
                continue
            host_id = str(info["host_id"])
            try:
                host_plan = self._plan_compiler(str(info["prefix_cql"]),
                                                host_id)
            except Exception:  # noqa: BLE001
                _LOG.warning(
                    "shared host %r could not be re-formed from its "
                    "prefix CQL; its members restore without a producer "
                    "— retire and re-admit them", host_id,
                )
                continue
            self._create_runtime(host_plan)
            mid = str(info["mid"])
            src = str(info["src"])
            self._shared[key] = {
                "host_id": host_id,
                "mid": mid,
                "prefix_cql": str(info["prefix_cql"]),
                "src": src,
                "mid_schema": host_plan.schemas[src],
                "members": members,
            }
            self._loopback[mid] = key
            for pid in members:
                self._shared_member[pid] = key

    def remove_plan(self, plan_id: str) -> None:
        """Retire a plan. Its rows produced so far surface first: a
        waiting drain of its runtime completes every queued drain (the
        fetch thread decodes a group's block by its members at decode
        time, so no queued block may outlive the member it holds rows
        of). A folded member's slot is then left row-inert, for a later
        admit to reclaim; the last member's retire drops the host. A
        shared member's host drains first (its mid rows step into this
        member's suffix, whose own drain then carries them out); the last
        member's retire drops the shared host."""
        self._assert_runloop_owner("remove_plan")
        if plan_id in self._folded or plan_id in self._plans:
            self.flightrec.record(
                "control.retire", plan=plan_id,
                tenant=self._plan_tenant.get(plan_id))
        skey = self._shared_member.pop(plan_id, None)
        if skey is not None:
            entry = self._shared.get(skey)
            if entry is not None:
                host_rt = self._plans.get(entry["host_id"])
                if host_rt is not None:
                    self._drain_plan(host_rt)
                entry["members"] = [
                    m for m in entry["members"] if m != plan_id]
                if not entry["members"]:
                    self._plans.pop(entry["host_id"], None)
                    self._drain_hints.pop(entry["host_id"], None)
                    self._loopback.pop(entry["mid"], None)
                    self._loopback_buf.pop(entry["mid"], None)
                    self._shared.pop(skey, None)
                    self.telemetry.inc("control.subplan_unshare")
                    self.flightrec.record(
                        "control.subplan_unshare", plan=plan_id,
                        host=entry["host_id"], key=skey)
        folded = self._folded.pop(plan_id, None)
        self._folded_enabled.pop(plan_id, None)
        self._dynamic_cql.pop(plan_id, None)
        # the footprint denominator dies with the runtime (an update
        # records it again)
        self._plan_admitted_bytes.pop(plan_id, None)
        if folded is not None:
            host_id, slot = folded
            self.telemetry.inc("control.retired")
            rt = self._plans.get(host_id)
            if rt is None:
                return
            group = rt.plan.artifacts[0]
            with _device_work():
                self._drain_plan(rt)
                group.evict(rt.states[group.name], slot)
            if all(m is None for m in group.members):
                self._plans.pop(host_id, None)
                self._drain_hints.pop(host_id, None)
            return
        rt = self._plans.get(plan_id)
        if rt is not None:
            with _device_work():
                self._drain_plan(rt)
            self.telemetry.inc("control.retired")
        self._plans.pop(plan_id, None)
        self._drain_hints.pop(plan_id, None)

    def set_plan_enabled(self, plan_id: str, enabled: bool) -> None:
        """Pause or resume a plan at this boundary: a folded member's
        enable flag is a data write into its group's state; a standalone
        plan steps no tape while disabled. Fused mode: the tapes staged
        before it step under the old setting first."""
        self._assert_runloop_owner("set_plan_enabled")
        self.flightrec.record(
            "control.enable" if enabled else "control.disable", plan=plan_id)
        folded = self._folded.get(plan_id)
        if folded is not None:
            self._folded_enabled[plan_id] = enabled
            host_id, slot = folded
            rt = self._plans.get(host_id)
            if rt is not None:
                group = rt.plan.artifacts[0]
                with _device_work():
                    self._dispatch_segment(rt)
                    group.set_enabled(rt.states[group.name], slot, enabled)
            return
        rt = self._plans.get(plan_id)
        if rt is not None:
            if not enabled:
                with _device_work():
                    self._dispatch_segment(rt)
            rt.enabled = enabled

    @property
    def plan_ids(self) -> List[str]:
        """Live user plan ids (group and shared hosts excluded, their
        members included). Safe off-thread: GIL-atomic list()
        snapshots."""
        return [pid for pid in list(self._plans)
                if not pid.startswith(("@dyn:", "@shr:"))] \
            + list(self._folded)

    # -- control events --------------------------------------------------------
    def _pull_control(self) -> None:
        for i, src in enumerate(self._control):
            if self._control_done[i]:
                continue
            events, wm, done = src.poll(self.batch_size)
            self._control_pending.extend(events)
            if wm is not None:
                self._control_wm[i] = max(self._control_wm[i], wm)
            if done:
                self._control_done[i] = True
                self._control_wm[i] = MAX_WM

    def _pop_ready_control(self) -> List:
        """Ready control events — ts at or below the current watermark
        (processing mode: all of them) — removed from the pending list in
        timestamp order. The one definition of the epoch-boundary
        selection: the streaming loop applies what this returns, and the
        resident replay (``runtime/replay.py``) partitions the bounded
        stream at the same boundaries."""
        pending = self._control_pending
        if not pending:
            return []
        pending.sort(key=lambda p: p[0])
        n_apply = len(pending)
        if self.time_mode != "processing":
            wm = self._watermark()
            n_apply = 0
            while n_apply < len(pending) and pending[n_apply][0] <= wm:
                n_apply += 1
        out = [ev for _ts, ev in pending[:n_apply]]
        if n_apply:
            del pending[:n_apply]
        return out

    def _apply_ready_control(self) -> None:
        for ev in self._pop_ready_control():
            self._apply_control_safely(ev)

    def _apply_control_safely(self, ev) -> None:
        """Apply one control event; a bad one (say, unparsable CQL pushed
        past any validation) is logged and never stops the loop. A failure
        of the device work a mutation does (``_device_work``) stops it."""
        try:
            self._apply_control(ev)
        except Exception as e:
            if getattr(e, "control_device_fault", False):
                raise
            _LOG.exception("control event rejected: %r", ev)

    def _apply_control(self, ev) -> None:
        self._assert_runloop_owner("_apply_control")
        from ..control.events import (
            MetadataControlEvent,
            OperationControlEvent,
        )

        if isinstance(ev, MetadataControlEvent):
            if (ev.added_plans or ev.updated_plans) \
                    and self._plan_compiler is None:
                raise RuntimeError(
                    "control event adds a plan but the job has no plan "
                    "compiler (create it through the dynamic cql() path)"
                )
            # a verdict carried on the event that rejected a plan keeps
            # it from the compiler; the rest of the event still applies
            verdicts = getattr(ev, "admission", None) or {}
            tenant = getattr(ev, "tenant", None)

            def rejected(plan_id: str) -> bool:
                v = verdicts.get(plan_id)
                if v is None or v.get("admitted", True):
                    return False
                findings = v.get("findings", ())
                self._record_rejection(
                    plan_id, [f.get("rule") for f in findings],
                    [f.get("message", "") for f in findings], tenant,
                    source="carried-verdict",
                )
                _LOG.warning(
                    "control event plan %s refused: its admission "
                    "verdict rejected it (%s)", plan_id,
                    [f.get("rule") for f in findings],
                )
                return True

            def precleared(plan_id: str) -> bool:
                """A carried PASSING service-gate verdict with the deep
                tier's footprint numbers: the gate already ran the whole
                analysis on this exact CQL, so apply time skips the deep
                re-check. Events without one (a raw control topic, a
                checkpointed pre-gate event) keep the full path."""
                v = verdicts.get(plan_id)
                return bool(
                    v is not None and v.get("admitted", False)
                    and v.get("state_bytes") is not None
                    and v.get("acc_bytes") is not None
                )

            def note_admission(plan_id: str, plan) -> None:
                """Tenant and admitted-footprint bookkeeping of an
                accepted add or update, before add_plan (its counters
                land in the tenant's scope, the meter has its denominator
                from the first drain). The apply-time analysis's own
                prediction wins over the carried summary."""
                if tenant is not None:
                    self._plan_tenant[plan_id] = tenant
                nb = getattr(plan, "_admitted_nbytes", None)
                if nb is None:
                    v = verdicts.get(plan_id) or {}
                    sb, ab = v.get("state_bytes"), v.get("acc_bytes")
                    if sb is not None and ab is not None:
                        nb = self.admitted_bytes(sb, ab)
                if nb is not None:
                    self._plan_admitted_bytes[plan_id] = int(nb)

            for plan_id, cql in ev.added_plans.items():
                if rejected(plan_id):
                    continue
                plan = self._compile_admitted(
                    plan_id, cql, tenant, precleared=precleared(plan_id))
                if plan is None:
                    continue
                note_admission(plan_id, plan)
                self.add_plan(plan, dynamic=True)
                # setdefault: a subplan-share admit already recorded the
                # tenant's SUFFIX CQL (what a checkpoint replays)
                self._dynamic_cql.setdefault(plan_id, cql)
            for plan_id, cql in ev.updated_plans.items():
                if rejected(plan_id):
                    continue  # the running plan stays as it is
                plan = self._compile_admitted(
                    plan_id, cql, tenant, precleared=precleared(plan_id))
                if plan is None:
                    continue
                self.remove_plan(plan_id)
                note_admission(plan_id, plan)
                self.add_plan(plan, dynamic=True)
                self._dynamic_cql.setdefault(plan_id, cql)
            for plan_id in ev.deleted_plan_ids:
                self.remove_plan(plan_id)
        elif isinstance(ev, OperationControlEvent):
            self.set_plan_enabled(ev.plan_id, ev.action == "enable")
        else:
            raise TypeError(f"unknown control event {type(ev)!r}")

    def _compile_admitted(self, plan_id: str, cql: str,
                          tenant: Optional[str] = None,
                          precleared: bool = False):
        """Apply-time admission: compile the candidate, run plancheck's
        static tier and the admission analysis against
        ``self.admission_budgets``, and return the plan — or None after
        recording the refusal with its rule ids (CQL that does not
        compile is ``CQL000``). Defense in depth behind the service
        gate: an event injected past the REST layer is still judged
        before it touches the stack.

        ``precleared``: the event carried a PASSING gate verdict with the
        deep tier's numbers, so the deep footprint + budget re-verdict is
        skipped (counted in ``control.preclear``; the carried bytes feed
        the footprint meter). The static verify and cost-hook tier still
        runs, so a forged verdict cannot smuggle an invalid plan in."""
        from ..analysis.admit import AdmissionError, analyze_plan
        from ..analysis.plancheck import PlanCheckError, verify_plan

        rules: List[str] = []
        rendered: List[str] = []
        try:
            plan = self._plan_compiler(cql, plan_id)
            issues = verify_plan(plan, trace=False, raise_on_error=False)
            rules += [i.rule for i in issues]
            rendered += [i.render() for i in issues]
            if not issues:
                budgets = self.admission_budgets
                if precleared and budgets is not None:
                    budgets = None
                    self.telemetry.inc("control.preclear")
                    self.flightrec.record(
                        "control.preclear", plan=plan_id, tenant=tenant)
                report = analyze_plan(plan, budgets=budgets,
                                      deep=budgets is not None)
                rules += [i.rule for i in report.findings]
                rendered += [i.render() for i in report.findings]
                if (report.state_bytes is not None
                        and report.acc_bytes is not None):
                    # the footprint meter's denominator: what THIS
                    # compiled plan was predicted to cost
                    plan._admitted_nbytes = self.admitted_bytes(
                        report.state_bytes, report.acc_bytes)
        except (PlanCheckError, AdmissionError) as e:
            # compile_plan itself verifies under FST_VERIFY_PLANS or the
            # config's budgets: the same refusal, the same record
            rules += [i.rule for i in e.issues]
            rendered += [i.render() for i in e.issues]
        except Exception as e:  # noqa: BLE001 — unparsable/uncompilable
            rules += ["CQL000"]
            rendered += [f"{type(e).__name__}: {e}"]
        if rules:
            self._record_rejection(plan_id, rules, rendered, tenant,
                                   source="apply-time")
            _LOG.warning(
                "control-path plan %s refused at apply time: %s",
                plan_id, rules,
            )
            return None
        return plan

    def _record_rejection(self, plan_id: str, rules, findings,
                          tenant: Optional[str] = None,
                          source: str = "apply-time") -> None:
        self.telemetry.inc("control.admission_rejected")
        # the recorder has its own lock: the service thread records
        # boundary refusals while the run loop records apply-time ones
        self.flightrec.record(
            "control.reject", plan=plan_id, tenant=tenant,
            rules=[r for r in rules if r], source=source)
        with self._rejections_lock:
            # re-insert at the ring's tail: a repeated refusal refreshes
            # its eviction position
            self.control_rejections.pop(plan_id, None)
            self.control_rejections[plan_id] = {
                "rules": [r for r in rules if r],
                "findings": list(findings),
                "tenant": tenant,
                "source": source,
            }
            while len(self.control_rejections) > self.MAX_REJECTIONS_KEPT:
                self.control_rejections.pop(
                    next(iter(self.control_rejections)))

    def control_status(self) -> Dict[str, object]:
        """The control plane's host-side view (safe off-thread): the
        ``control.*`` counters and the recent refusals."""
        counters = self.telemetry.snapshot().get("counters", {})
        with self._rejections_lock:
            rejections = dict(self.control_rejections)
        return {
            "counters": {
                k.split("control.", 1)[1]: v
                for k, v in counters.items() if k.startswith("control.")
            },
            "rejections": rejections,
            # the share table: per share key, the producer host and its
            # members (the retire refcount)
            "shared": {
                key: {
                    "host": e["host_id"],
                    "mid": e["mid"],
                    "members": list(e["members"]),
                }
                for key, e in dict(self._shared).items()
            },
        }

    def query_listing(self) -> List[Dict[str, object]]:
        """GET /api/v1/queries: id, tenant, enabled state, fold host/slot
        and shared host/key per live plan. Safe off-thread (GIL-atomic
        snapshots)."""
        out: List[Dict[str, object]] = []
        folded = dict(self._folded)
        folded_enabled = dict(self._folded_enabled)
        shared_member = dict(self._shared_member)
        for pid in self.plan_ids:
            f = folded.get(pid)
            if f is not None:
                enabled = bool(folded_enabled.get(pid, True))
                fold = {"host": f[0], "slot": int(f[1])}
            else:
                rt = self._plans.get(pid)
                enabled = bool(rt.enabled) if rt is not None else False
                fold = None
            skey = shared_member.get(pid)
            se = self._shared.get(skey) if skey is not None else None
            out.append({
                "id": pid, "tenant": self.tenant_of(pid),
                "enabled": enabled, "folded": fold,
                "shared": (None if se is None
                           else {"host": se["host_id"], "key": skey}),
            })
        return out

    def add_sink(self, output_stream: str, fn: Callable) -> None:
        """Attach a sink: ``fn(abs_ts, row_tuple)``, or an object with
        ``accept_columns(abs_ts_array, cols)`` (``ColumnarSink``). Rows
        accumulated before the sink attached are drained first and not
        delivered to it; rows after are. A sink with ``bind_telemetry``
        (``KafkaSink``: its ``faults.kafka.*`` and ``faults.txn.*``
        counters) is bound to this job's registry, and one with
        ``bind_flightrec`` (``KafkaSink``'s transaction lifecycle) to its
        flight recorder."""
        for rt in self._plans.values():
            self._drain_plan(rt)
        bind = getattr(fn, "bind_telemetry", None)
        if bind is not None:
            bind(self.telemetry)
        bind_f = getattr(fn, "bind_flightrec", None)
        if bind_f is not None:
            bind_f(self.flightrec)
        self._sinks.setdefault(output_stream, []).append(fn)

    @property
    def host_syncs(self) -> int:
        """The run loop's waits for a device value so far: waiting drains
        (``drain_waits``) plus the artifacts' own reads (the chain
        matcher's compaction branch). The fetch thread's waits are
        ``fetch_syncs``; the in-flight window's, ``backpressure_waits``."""
        return self.drain_waits + sum(
            getattr(a, "host_syncs", 0)
            for rt in self._plans.values()
            for a in rt.plan.artifacts
        )

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs captured so far, over every plan (one a ring
        position of each graph key)."""
        return sum(rt.graphs.captured for rt in self._plans.values()
                   if rt.graphs is not None)

    @property
    def graph_keys(self) -> int:
        """Graph keys captured so far, over every plan: the segment
        shapes, each captured once for every ring position (on the CPU,
        where nothing is captured, the keys first seen)."""
        return sum(rt.graphs.keys for rt in self._plans.values()
                   if rt.graphs is not None)

    def reset_engine_state(self) -> None:
        """Rerun aid: fresh device state (re-grown to the interned encoder
        sizes), emptied accumulators, fresh lazy rings and the event-time
        gate's phase, so the SAME job can replay an identical stream
        again (``ResidentReplay.rerun``). Queued drains complete first.
        Sticky wire widths and tape capacities stay: the staged tapes were
        built with them. Tensors that segment graphs are bound to, and
        the accumulator ring, are reset in place."""
        self._assert_runloop_owner("reset_engine_state")
        # a rerun is a fresh drive: its run loop re-stamps ownership
        self._runloop_thread = None
        self._settle_drains()
        # mid rows of the run before belong to no state of the rerun
        self._loopback_buf.clear()
        for rt in self._plans.values():
            self._install_states(
                rt, rt.plan.grow_state(rt.plan.init_state(self.device)))
        # host-side emission state too: a carried limiter phase would
        # make the second run emit at different boundaries
        for lim in self._rate_limiters.values():
            lim.count = 0
            lim.buf = []
            lim.cur = {}
            lim.deadline = None
        self._cycles_since_drain = 0
        self._last_full_drain = time.monotonic()
        self._cycle_ema = self._last_cycle_t = None
        # a rerun replays the SAME stream, so a carried released horizon
        # would classify every row late
        self._released_wm = MIN_WM
        self._gate_wm = MIN_WM
        self._max_event_ts = None
        self._pending_t.clear()
        self._trace_pulled.clear()
        self._source_idle = [False] * len(self._sources)
        self._source_last_t = [None] * len(self._sources)

    def _install_states(self, rt: _PlanRuntime, states: Dict,
                        lazy_base: int = 0) -> None:
        """Make ``states`` the plan's engine state (a rerun's fresh state,
        or a restored one) with every drain settled: the tensors that
        segment graphs are bound to are overwritten in place when
        ``states`` has their signature (otherwise the next segment
        rebinds, and drops every graph of the old binding), the
        accumulator ring is emptied, staged tapes and in-flight tickets
        dropped, and the lazy ring restarts at ordinal ``lazy_base``."""
        if rt.graphs is None or not rt.graphs.reset(rt, states):
            rt.states = states
        for acc in rt.ring:
            acc["meta"].zero_()
        rt.acc, rt.acc_pos = rt.ring[0], 0
        rt.ring_release = [None] * len(rt.ring)
        rt.seg_pending = []
        rt.tickets.clear()
        rt.acc_dirty = False
        rt.dirty_since = None
        if rt.lazy is not None:
            rt.lazy = _LazyRing(rt.lazy.budget)
            rt.lazy_base = lazy_base
            rt.lazy_miss_warned = 0

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
        timer-driven emissions (timed-absence deadlines, batch windows)."""
        for rt in self._plans.values():
            self._drain_plan(rt)
            if not rt.plan.has_flush:
                continue
            with self.telemetry.span("flush"):
                rt.states, outputs = rt.plan.flush(rt.states)
                self._decode_outputs(rt, outputs)
        # stream end: rate-limited output still buffered surfaces now
        with self.telemetry.span("flush"):
            for sid, limiter in self._rate_limiters.items():
                self._emit_pending(sid, limiter.flush())

    @property
    def finished(self) -> bool:
        return (
            all(self._source_done)
            and all(self._control_done)
            and not any(batches for batches in self._pending.values())
            and not self._control_pending
        )

    def run_cycle(self) -> int:
        """Pull, reorder, step, poll the drains, drain when due. Returns
        events processed. Never waits for the card, except in the
        in-flight window and a forced drain completion."""
        self._stamp_runloop_owner()
        tel = self.telemetry
        tel.inc("cycles")
        with tel.span("ingest"):
            self._pull_sources()
            # control at the epoch boundary: events the watermark passed
            # apply before this cycle's events step
            self._pull_control()
            self._apply_ready_control()
        with tel.span("reorder"):
            ready = self._release_ready()
        total = 0
        if ready:
            total = sum(len(b) for b in ready)
            self.processed_events += total
            if self._epoch_ms is None:
                self._epoch_ms = min(
                    int(b.timestamps.min()) for b in ready
                )
            for rt in list(self._plans.values()):
                if rt.enabled:
                    self._step_plan(rt, ready)
            self._cycles_since_drain += 1
            self._adapt_depth()
        # advance any in-flight drain (never waits)
        with tel.span("drain"):
            for rt in self._plans.values():
                self._drain_poll(rt)
        if self._fused_on():
            # a partial segment must not wait forever for a slow source:
            # once its oldest tape reaches the staleness budget, it
            # dispatches short (the reference's rule)
            age_s = (500.0 if self.drain_interval_ms is None
                     else self.drain_interval_ms) / 1e3
            now = time.monotonic()
            for rt in self._plans.values():
                if rt.seg_pending and now - rt.seg_pending[0][2] >= age_s:
                    self._dispatch_segment(rt)
        if self.drain_interval_ms is not None:
            # deadline-driven drains: due when the OLDEST undrained match
            # of a plan someone observes reaches the staleness budget
            interval_s = self.drain_interval_ms / 1e3
            due = min(
                (rt.dirty_since + interval_s for rt in self._plans.values()
                 if rt.dirty_since is not None and self._has_consumers(rt)),
                default=None,
            )
            if due is not None and time.monotonic() >= due:
                with tel.span("drain"):
                    self._interval_drain()
            # time-mode limiters emit on their own schedule, on the same
            # interval cadence (they hold host-side rows only)
            if time.monotonic() - self._last_full_drain >= interval_s:
                with tel.span("drain"):
                    self._poll_rate_limiters()
                self._last_full_drain = time.monotonic()
        if ready and self._cycles_since_drain >= min(
            self.drain_every_cycles,
            min(self._drain_hints.values(), default=self.drain_every_cycles),
        ):
            # capacity-bounding swap before the no-overflow horizon,
            # without a host wait
            self.drain_outputs(wait=False)
            self._cycles_since_drain = 0
        # SLO evaluation at the epoch boundary, after this cycle's drains
        # (rate-limited inside; a no-op without policies)
        self.slo.evaluate()
        return total

    def _adapt_depth(self) -> None:
        """With ``target_p99_ms``: the wall time between working cycles
        tracks the device pace once the in-flight window is full, so keep
        depth x pace (x K under fused dispatch, whose dispatches are
        segments) within half the target (the reference's rule)."""
        t_now = time.monotonic()
        if self._last_cycle_t is not None:
            dt = t_now - self._last_cycle_t
            self._cycle_ema = (dt if self._cycle_ema is None
                               else 0.8 * self._cycle_ema + 0.2 * dt)
            if self.target_p99_ms:
                budget_s = self.target_p99_ms / 2000.0
                k_seg = self.fused_segment_len if self._fused_on() else 1
                self.max_inflight_cycles = max(1, min(8, int(
                    budget_s / max(self._cycle_ema * k_seg, 1e-3)
                )))
        self._last_cycle_t = t_now

    def _watermark(self) -> int:
        """The min watermark across the sources that are not idle and the
        control streams. With every data source idle and no control
        stream it holds at the gate's last value instead of jumping to the
        end of the stream: idle means no information, not done (Flink's
        idleness)."""
        idle = self._source_idle
        wms = [wm for i, wm in enumerate(self._source_wm)
               if not (i < len(idle) and idle[i])] + self._control_wm
        if not wms:
            return self._gate_wm if self._sources else MAX_WM
        return min(wms)

    def _pending_total(self) -> int:
        return sum(len(b) for bs in self._pending.values() for b in bs)

    def idle_source_ids(self) -> List[str]:
        """Stream ids of the sources currently marked idle."""
        return [getattr(src, "stream_id", f"source[{i}]")
                for i, (src, idle) in enumerate(
                    zip(list(self._sources), list(self._source_idle)))
                if idle]

    def _sampled(self, timestamps: np.ndarray) -> np.ndarray:
        """The tracer's sampled subset of a batch's int64 timestamps
        (``abs_ts % sample_every == 0``). For a power-of-two
        ``sample_every`` the floor modulo is the low bits, so the pass is
        a bitwise and: the same subset at a third of the modulo's host
        time."""
        n = self.tracer.sample_every
        if n <= 0 or n & (n - 1) or not self.tracer.enabled:
            return self.tracer.sampled_subset(timestamps)
        return timestamps[np.flatnonzero((timestamps & (n - 1)) == 0)]

    def _sampled_of(self, batch: EventBatch) -> np.ndarray:
        """A released batch's sampled subset: the pull's when the batch
        is the one pulled (masking a sampled subset returns it unchanged,
        so the marks record what a full pass would), else a pass of its
        own (a merged, sorted or sliced batch)."""
        hit = self._trace_pulled.get(id(batch))
        if hit is not None and hit[0] is batch:
            return hit[1]
        return self._sampled(batch.timestamps)

    def _pull_sources(self) -> None:
        """Poll every source that is not done into the reorder buffer.
        Over ``max_pending_events`` under 'block', only the sources at
        or below the monotone gate watermark keep polling (they pin the
        min, so the backlog could not release without them); under
        'drop_oldest' the oldest pending batches are shed after the
        pulls. Idle tracking as the reference's (``idle_timeout_ms``)."""
        over = (self.max_pending_events is not None
                and self._pending_total() >= self.max_pending_events)
        block = over and self.shed_policy == "block"
        if block:
            wm = max(self._watermark(), self._gate_wm)
        if len(self._source_idle) != len(self._sources):
            # a caller swapped job._sources: re-size the idle tracking
            self._source_idle = [False] * len(self._sources)
            self._source_last_t = [None] * len(self._sources)
        if self._trace_pulled:
            # the batches released by the last pull's cycle are staged:
            # keep the subsets of those still pending
            live = {id(b) for bs in self._pending.values() for b in bs}
            self._trace_pulled = {k: v for k, v in self._trace_pulled.items()
                                  if k in live}
        timeout = self.idle_timeout_ms
        now = time.monotonic() if timeout is not None else 0.0
        for i, src in enumerate(self._sources):
            if self._source_done[i]:
                continue
            if block and self._source_wm[i] > wm:
                self.telemetry.inc("faults.backpressure_blocks")
                self.flightrec.record(
                    "fault.backpressure", stream=src.stream_id)
                continue
            batch, swm, done = src.poll(self.batch_size)
            if batch is not None and len(batch):
                sid = src.stream_id
                self._pending.setdefault(sid, []).append(batch)
                bmax = int(batch.timestamps.max())
                self._pending_t.setdefault(sid, []).append(
                    (time.monotonic(), bmax))
                if self._max_event_ts is None or bmax > self._max_event_ts:
                    self._max_event_ts = bmax
                # trace sampling stamps INGEST time (before the gate), so
                # a completed trace includes the reorder queueing
                if self.tracer.enabled:
                    sampled = self._sampled(batch.timestamps)
                    self.tracer.stamp_ingest(sampled)
                    self._trace_pulled[id(batch)] = (batch, sampled)
                if timeout is not None:
                    self._source_last_t[i] = now
                    if self._source_idle[i]:
                        # its watermark claim rejoins the min from now on
                        self._source_idle[i] = False
                        self.telemetry.inc("idle.unidled")
                        self.flightrec.record(
                            "watermark.unidle", stream=src.stream_id)
            elif timeout is not None and not self._source_idle[i]:
                if self._source_last_t[i] is None:
                    self._source_last_t[i] = now  # armed at the first poll
                if (now - self._source_last_t[i]) * 1e3 >= timeout:
                    self._source_idle[i] = True
                    self.telemetry.inc("idle.marked")
                    self.flightrec.record(
                        "watermark.idle", stream=src.stream_id,
                        idle_ms=round(
                            (now - self._source_last_t[i]) * 1e3, 1))
                    _LOG.debug(
                        "source %s idle for %.0f ms; left out of the min "
                        "watermark until its next event", src.stream_id,
                        (now - self._source_last_t[i]) * 1e3,
                    )
            if swm is not None:
                self._source_wm[i] = max(self._source_wm[i], swm)
            if done:
                self._source_done[i] = True
                self._source_wm[i] = MAX_WM
                self._source_idle[i] = False
        if (self.max_pending_events is not None
                and self.shed_policy == "drop_oldest"):
            self._shed_pending()

    def _shed_pending(self) -> None:
        """'drop_oldest': shed whole pending batches, oldest event time
        first, until the backlog is within the bound (a shed may overshoot
        by up to one batch), counted and warned at most once a second."""
        total = self._pending_total()
        if total <= self.max_pending_events:
            return
        shed = 0
        while total > self.max_pending_events:
            sid = min(
                (s for s, bs in self._pending.items() if bs),
                key=lambda s: (int(self._pending[s][0].timestamps.min())
                               if len(self._pending[s][0]) else MAX_WM),
                default=None,
            )
            if sid is None:
                break
            batch = self._pending[sid].pop(0)
            if not self._pending[sid]:
                del self._pending[sid]
            total -= len(batch)
            shed += len(batch)
        if shed:
            self.shed_events += shed
            self.telemetry.inc("faults.shed_events", shed)
            # rate-collapsed in the journal; the counters carry the totals
            self.flightrec.record(
                "fault.shed", events=shed, policy="drop_oldest")
            now = time.monotonic()
            if now - self._shed_warned_at >= 1.0:
                self._shed_warned_at = now
                _LOG.warning(
                    "pending backlog over max_pending_events=%d: shed "
                    "%d oldest events (%d total shed so far); matches "
                    "they would have produced are LOST — raise the "
                    "bound or switch shed_policy to 'block'",
                    self.max_pending_events, shed, self.shed_events,
                )

    def _release_ready(self) -> List[EventBatch]:
        """Watermark gate: release per-stream prefixes with ts <= the min
        watermark (processing mode releases everything). The gate
        watermark is monotone; under the 'allow' policy the released
        horizon is held back by ``allowed_lateness_ms``; rows at or below
        the horizon already released are late (``_handle_late``).
        Telemetry: ``watermark.lag`` (max event time minus the gate
        watermark) and ``gate.residency`` (the buffer age of released
        rows)."""
        if self.time_mode == "processing":
            ready = [
                EventBatch.concat(bs).sort_by_time()
                for bs in self._pending.values()
                if bs
            ]
            self._pending.clear()
            self._pending_t.clear()
            return ready
        raw = self._watermark()
        # the MAX end-of-stream sentinel releases everything but is never
        # kept as gate state: a checkpoint taken at the end of a stream
        # restores into jobs that go on with more data, and a stored MAX
        # horizon would classify every later row late
        if raw != MAX_WM and raw > self._gate_wm:
            self._gate_wm = raw
        wm = MAX_WM if raw == MAX_WM else self._gate_wm
        eff = wm
        if (self.late_policy == "allow" and self.allowed_lateness_ms > 0
                and wm != MAX_WM and wm > MIN_WM):
            # hold the released horizon back by the allowance: a row late
            # by at most that still merges in order
            eff = wm - self.allowed_lateness_ms
        tel = self.telemetry
        if (tel.enabled and self._max_event_ts is not None
                and MIN_WM < wm < MAX_WM):
            tel.record_seconds("watermark.lag",
                               max(self._max_event_ts - wm, 0) / 1e3)
        horizon = self._released_wm
        ready: List[EventBatch] = []
        now = time.monotonic()
        for sid in list(self._pending):
            merged = EventBatch.concat(self._pending[sid]).sort_by_time()
            if horizon > MIN_WM:
                n_late = int(np.searchsorted(merged.timestamps, horizon,
                                             side="right"))
                if n_late:
                    self._handle_late(merged.slice(0, n_late))
                    merged = merged.slice(n_late, len(merged))
            n_ready = int(np.searchsorted(merged.timestamps, eff,
                                          side="right"))
            entries = self._pending_t.get(sid)
            if n_ready:
                ready.append(merged.slice(0, n_ready))
                if entries and tel.enabled:
                    # the buffer age of the oldest batch still pending
                    tel.record_seconds("gate.residency",
                                       now - entries[0][0])
            if entries is not None:
                # retire the batches the horizon released in full
                while entries and entries[0][1] <= eff:
                    entries.pop(0)
            rest = merged.slice(n_ready, len(merged))
            if len(rest):
                self._pending[sid] = [rest]
            else:
                del self._pending[sid]
                self._pending_t.pop(sid, None)
        if not ready and self._pending and wm != MAX_WM:
            # the gate holds data it cannot release this cycle: a
            # watermark stall (rate-collapsed in the journal)
            self.flightrec.record(
                "watermark.stall", pending=self._pending_total(),
                gate_wm=int(self._gate_wm) if self._gate_wm > MIN_WM else None)
        if eff != MAX_WM:
            if eff > self._released_wm:
                self._released_wm = eff
        elif (self._max_event_ts is not None
              and self._max_event_ts > self._released_wm):
            # end of stream: everything observed has been released, so
            # the max observed event time is the horizon (exact), and it
            # survives a restore into a continued stream
            self._released_wm = self._max_event_ts
        return ready

    def _handle_late(self, batch: EventBatch) -> None:
        """Apply ``late_policy`` to rows at or below the released horizon.
        The counters are exact: the disorder tests reconcile them against
        the injected schedule."""
        n = len(batch)
        self.late_events += n
        self.flightrec.record(
            "fault.late", events=n, policy=self.late_policy,
            stream=batch.stream_id)
        tel = self.telemetry
        if tel.enabled:
            # lateness is a fact of the input stream: it counts to a plan
            # only when exactly one live plan consumes the stream
            consumers = [
                member
                for rt in list(self._plans.values())
                if batch.stream_id in rt.plan.spec.stream_codes
                for member in self._scope_plans_of(rt)
            ]
            if len(consumers) == 1:
                tel.scope("plan", consumers[0]).inc("late_events", n)
        if self.late_policy == "side_output":
            tel.inc("faults.late_side_output", n)
            self._emit_late(batch)
            return
        self.late_dropped += n
        tel.inc("faults.late_dropped", n)
        now = time.monotonic()
        if now - self._late_warned_at < 1.0:
            return
        self._late_warned_at = now
        if self.late_policy == "allow":
            _LOG.warning(
                "%s: %d rows later than allowed_lateness_ms=%d dropped "
                "(%d total). Admitting them would require window RE-FIRE "
                "(retracting and re-emitting panes already released), "
                "which this engine rejects by design. Raise "
                "allowed_lateness_ms or route them with "
                "late_policy='side_output'.",
                batch.stream_id, n, self.allowed_lateness_ms,
                self.late_dropped,
            )
        else:
            _LOG.warning(
                "%s: %d late rows dropped below the released watermark "
                "(%d total; policy 'drop'). Use late_policy='side_output' "
                "to capture them, or 'allow' + allowed_lateness_ms to "
                "admit bounded lateness in order.",
                batch.stream_id, n, self.late_dropped,
            )

    def _emit_late(self, batch: EventBatch) -> None:
        """'side_output': the full input rows surface on
        ``late_stream(stream_id)``, kept in ``collected`` under that id
        when retention is on and delivered to its sinks either way (a
        columnar sink gets the decoded column arrays)."""
        sid = late_stream(batch.stream_id)
        schema = batch.schema
        names = list(schema.field_names)
        self.emitted_counts[sid] = self.emitted_counts.get(sid, 0) + len(batch)
        sinks = self._sinks.get(sid) or []
        col_sinks = [s for s in sinks if hasattr(s, "accept_columns")]
        row_sinks = [s for s in sinks if not hasattr(s, "accept_columns")]
        if col_sinks:
            cols: Dict[str, np.ndarray] = {}
            for name in names:
                col = batch.columns[name]
                if schema.field_type(name).is_encoded:
                    cols[name] = np.asarray(
                        schema.string_tables[name].decode(col), dtype=object)
                else:
                    cols[name] = col
            with self.telemetry.span("sink"):
                for sink in col_sinks:
                    sink.accept_columns(batch.timestamps, cols)
        if not (row_sinks or self.retain_results):
            return
        rows = [(int(ts), tuple(rec[n] for n in names))
                for ts, rec in zip(batch.timestamps.tolist(),
                                   batch.records())]
        if self.retain_results:
            self.collected.setdefault(sid, []).extend(rows)
        if row_sinks:
            with self.telemetry.span("sink"):
                for ts, row in rows:
                    for sink in row_sinks:
                        sink(ts, row)

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
            if self._fused_on() and rt.plan.artifacts:
                self._stage_fused(rt, involved)
                continue
            tape = self._stage_tape(rt, involved).to(self.device)
            tel = self.telemetry
            with self._compile_scope(rt), tel.span("dispatch"):
                t0 = time.monotonic()
                # host interning may have discovered new keys: re-bucket
                # the keyed state tables before the step (host-known
                # sizes)
                rt.states = rt.plan.grow_state(rt.states)
                rt.states, rt.acc = rt.plan.step_acc(rt.states, rt.acc,
                                                     tape)
                rt.acc_dirty = True
                if rt.dirty_since is None:
                    rt.dirty_since = time.monotonic()
                if tel.enabled:
                    # the host side of one dispatch (the device's time
                    # hides behind it)
                    tel.record_seconds("dispatch.enqueue",
                                       time.monotonic() - t0)
            # sampled events' ingest->dispatch leg (the step is queued on
            # the card: the point their work was handed to it)
            for b in involved:
                self.tracer.mark(self._sampled_of(b), "dispatch",
                                 presampled=True)
            self._update_drain_hint(rt, tape.capacity)

    def _ticket(self, rt: _PlanRuntime) -> None:
        """On a GPU, an event behind the segment just dispatched, and the
        in-flight window over the plan's segments."""
        if self.device.type != "cuda":
            return
        ticket = torch.cuda.Event()
        ticket.record(torch.cuda.current_stream(self.device))
        rt.tickets.append(ticket)
        if len(rt.tickets) > self.max_inflight_cycles:
            with self.telemetry.span("backpressure_wait"):
                self.backpressure_waits += retire_tickets(
                    rt.tickets, self.max_inflight_cycles)
        else:
            retire_tickets(rt.tickets, self.max_inflight_cycles)

    # -- segments: fused streaming dispatch ----------------------------------
    def _fused_on(self) -> bool:
        return bool(self.fused_segment_len) and self.fused_segment_len > 1

    def _fused_k(self, rt: _PlanRuntime) -> int:
        """This plan's segment length: the configured K, clamped so that
        the accumulator holds a whole segment's emissions (no drain runs
        inside a segment: the drain hint's bound, as the resident replay
        applies it). A loopback consumer's segments are one tape: its
        tapes come a chunk at a time from the loopback's flushes, and a
        barrier flush would otherwise pad its one chunk to K, stepping
        K - 1 empty tapes of the full capacity."""
        k = self.fused_segment_len
        if not k or k <= 1 or not rt.plan.artifacts:
            return 1
        if self._loopback and not self._loopback.keys().isdisjoint(
                rt.plan.spec.stream_codes):
            return 1
        hint = self._drain_hints.get(rt.plan.plan_id)
        if hint:
            k = min(k, hint)
        return max(1, k)

    def _stage_fused(self, rt: _PlanRuntime,
                     involved: List[EventBatch]) -> None:
        """Stage one micro-batch tape toward the plan's segment (host side
        only). A tape of another structure (a wire width widened, the
        capacity grew) dispatches the shorter pending segment first."""
        tape = self._stage_tape(rt, involved)
        with self.telemetry.span("tape_build"):
            self._update_drain_hint(rt, tape.capacity)
            sig = wire_sig(tape)
        if rt.seg_pending and rt.seg_pending[0][1] != sig:
            self._dispatch_segment(rt)
        with self.telemetry.span("tape_build"):
            # the pull's sampled subsets serve the "staged" mark here and
            # the "dispatch" mark later
            sampled = [self._sampled_of(b) for b in involved]
            rt.seg_pending.append((tape, sig, time.monotonic(), sampled))
            for ts in sampled:
                self.tracer.mark(ts, "staged", presampled=True)
        self.fusion_batches += 1
        self.telemetry.inc("fusion.batches")
        if len(rt.seg_pending) >= self._fused_k(rt):
            self._dispatch_segment(rt)

    def _dispatch_segment(self, rt: _PlanRuntime) -> None:
        """Stack the pending tapes as one segment, padded with empty
        tapes to K (row-inert: no valid event), and advance the plan over
        it in one dispatch, within the in-flight window."""
        pending = rt.seg_pending
        if not pending:
            return
        rt.seg_pending = []
        wires = [p[0] for p in pending]
        k = max(self._fused_k(rt), len(wires))
        tel = self.telemetry
        with tel.span("dispatch"):
            t0 = time.monotonic()
            seg = self._stack_segment(pad_segment(wires, k))
            # host interning may have found new group keys: grow once a
            # segment, before the call
            rt.states = rt.plan.grow_state(rt.states)
            if rt.dirty_since is None:
                # its events have waited since the oldest tape was staged
                rt.dirty_since = pending[0][2]
            self._run_segment(rt, seg)
            if tel.enabled:
                # the host side of one segment's dispatch, under the fused
                # stage's name and the mode-agnostic one
                dt = time.monotonic() - t0
                tel.record_seconds("dispatch.segment", dt)
                tel.record_seconds("dispatch.enqueue", dt)
        self.fusion_dispatches += 1
        tel.inc("fusion.dispatches")
        # the sampled events' work is handed to the card: their dispatch
        # leg ends here, before any wait of the in-flight window
        for p in pending:
            for ts in p[3]:
                self.tracer.mark(ts, "dispatch", presampled=True)
        self._ticket(rt)

    def _stack_segment(self, wires: List[WireTape]) -> Segment:
        """The tapes stacked into one buffer: on a GPU in pinned host
        memory, which the segment's run copies to the card in one
        non-blocking upload on the current stream (``graphs.py``)."""
        if self.device.type != "cuda":
            return stack_wires(wires)
        self.fusion_h2d_uploads += 1
        self.telemetry.inc("fusion.h2d_uploads")
        return stack_wires(wires, out=torch.empty(
            segment_nbytes(wires[0], len(wires)), dtype=torch.uint8,
            pin_memory=True,
        ))

    def _segments(self, rt: _PlanRuntime) -> SegmentGraphs:
        """The plan's segment runner; made with the accumulator ring
        full, since every graph key is captured for each position."""
        if rt.graphs is None:
            while len(rt.ring) < rt.ring_size:
                self._grow_ring(rt)
            rt.graphs = SegmentGraphs(rt.plan, self.device,
                                      before_capture=self._settle_drains)
        return rt.graphs

    def _run_segment(self, rt: _PlanRuntime, seg: Segment) -> None:
        """Advance the plan over one segment on the device: one graph
        replay on a GPU, the same steps in turn on the CPU
        (``graphs.py``). A segment that cannot be captured (a tape's chain
        matcher must read its count) runs its steps eagerly, counted in
        ``eager_segments`` on any device."""
        with self._compile_scope(rt):
            captured = self._segments(rt).run(rt, seg)
        if not captured:
            self.eager_segments += 1
        rt.acc_dirty = True
        if rt.dirty_since is None:
            rt.dirty_since = time.monotonic()

    def _stage_tape(self, rt: _PlanRuntime,
                    involved: List[EventBatch]) -> WireTape:
        """Host half of one step: build the wire tape (interning group
        keys as a side effect) and retain lazy-projection columns in the
        ring. Shared by the streaming loop (which stages the tape onto
        the device with ``WireTape.to``) and the bounded replay's
        pre-stager (runtime/replay.py). The caller is responsible for
        ``plan.grow_state`` before the step."""
        with self.telemetry.span("tape_build"):
            return self._build_tape(rt, involved)

    def _build_tape(self, rt: _PlanRuntime,
                    involved: List[EventBatch]) -> WireTape:
        plan = rt.plan
        total = sum(len(b) for b in involved)
        rt.tape_capacity = max(rt.tape_capacity, bucket_size(total))
        # lazy-ring retention is decode-side state: a plan NOBODY
        # observes (no sinks, retention off) never decodes ordinals, so
        # retaining projection columns for it is pure memcpy waste
        retain_lazy = rt.lazy is not None and self._has_consumers(rt)
        tape, prov = build_wire_tape(
            plan.spec, involved, self._epoch_ms, rt.wire_kinds,
            capacity=rt.tape_capacity,
            # the provenance map serves the multi-batch retention below
            want_prov=retain_lazy and len(involved) > 1,
        )
        if rt.lazy is None:
            return tape
        if rt.lazy_base + total > _LAZY_ORD_WRAP:
            # int32 ordinal space: reset both sides well before the
            # device counter could wrap (undrained matches from before
            # the reset decode None — one warned event per ~1B processed)
            self._drain_plan(rt)
            states = dict(rt.states)
            sub = dict(states[rt.lazy_state_name])
            sub["seen"] = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
            states[rt.lazy_state_name] = sub
            rt.states = states
            rt.lazy_base = 0
            rt.lazy = _LazyRing(rt.lazy.budget)
            _LOG.warning(
                "%s: lazy ordinal space reset (wrap horizon)", plan.plan_id
            )
        if retain_lazy:
            rt.lazy.push(rt.lazy_base,
                         self._lazy_columns(rt, involved, prov, total))
        rt.lazy_base += total
        return tape

    def _lazy_columns(self, rt: _PlanRuntime, involved: List[EventBatch],
                      prov, total: int) -> Dict[str, np.ndarray]:
        """The merged-order values of the plan's projection-only columns
        (and rebased timestamps under ``@ts`` when decode needs them) —
        the device emits ordinals into this ring entry's space."""
        lcols: Dict[str, np.ndarray] = {}
        if len(involved) == 1:
            # single sorted batch: merged order == batch order. The copy
            # is NOT optional: sources may reuse column buffers across
            # polls, and event-time releases are views into a larger base
            b = involved[0]
            for key in rt.lazy_keys:
                sid, fname = key.split(".", 1)
                if b.stream_id == sid:
                    lcols[key] = np.array(b.columns[fname])
            if rt.lazy_ts:
                lcols["@ts"] = (b.timestamps - self._epoch_ms).astype(
                    np.int32
                )
            return lcols
        for key in rt.lazy_keys:
            sid, fname = key.split(".", 1)
            col = None
            for bi, b in enumerate(involved):
                if b.stream_id != sid:
                    continue
                sel = prov[:, 0] == bi
                if col is None:
                    col = np.zeros(total, dtype=b.columns[fname].dtype)
                col[sel] = b.columns[fname][prov[sel, 1]]
            if col is not None:
                lcols[key] = col
        if rt.lazy_ts:
            tcol = np.zeros(total, dtype=np.int32)
            for bi, b in enumerate(involved):
                sel = prov[:, 0] == bi
                tcol[sel] = (
                    b.timestamps[prov[sel, 1]] - self._epoch_ms
                ).astype(np.int32)
            lcols["@ts"] = tcol
        return lcols

    def _update_drain_hint(self, rt: _PlanRuntime,
                           tape_capacity: int) -> None:
        """Capacity-bounding drain cadence: each artifact declares its
        widest per-cycle emission block (from its state: a batch window
        flushes its whole group grid); a drain empties the accumulator,
        so no overflow requires (k+1)*block <= cap, with the reference's
        /2 safety margin."""
        plan = rt.plan
        block = max(
            (
                a.emit_block_width(tape_capacity, rt.states.get(a.name))
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
    def drain_outputs(self, wait: bool = True) -> None:
        """Surface all on-device accumulated emissions to collectors and
        sinks. ``wait=True`` (the contract of ``results()``) completes
        every drain before it returns; ``wait=False`` only starts them:
        each accumulator is swapped for a free ring position, and its
        fetch overlaps later dispatches, completed by a later poll."""
        for rt in self._plans.values():
            # staged, undispatched tapes reach the device first
            self._dispatch_segment(rt)
        with self.telemetry.span("drain"):
            for rt in list(self._plans.values()):
                self._drain_request(rt)
                self._drain_poll(rt, block=wait)
        if self._loopback and wait:
            # the hosts' drains above may have stepped mid rows into
            # their suffixes AFTER those suffixes' own drains (and, fused,
            # staged them without a dispatch): a waiting drain settles
            # them too. Hosts precede their members in insertion order,
            # so one more pass over the consumers suffices
            mids = set(self._loopback)
            with self.telemetry.span("drain"):
                for rt in list(self._plans.values()):
                    if not (mids & set(rt.plan.spec.stream_codes)):
                        continue
                    if (not rt.seg_pending and rt.dirty_since is None
                            and not rt.drain_q):
                        continue  # nothing left to surface
                    self._dispatch_segment(rt)
                    self._drain_request(rt)
                    self._drain_poll(rt, block=True)

    def _drain_plan(self, rt: _PlanRuntime) -> None:
        """A waiting drain of one plan."""
        self._dispatch_segment(rt)
        with self.telemetry.span("drain"):
            self._drain_request(rt)
            self._drain_poll(rt, block=True)

    def _settle_drains(self) -> None:
        """Complete every queued drain of every plan, then wait for every
        other live Job's running fetches (before a graph capture: no fetch
        thread's CUDA calls may overlap one, whichever Job's)."""
        for rt in list(self._plans.values()):
            # no loopback flush here: it would step suffixes (and, fused,
            # capture their graphs) inside another capture's preparation
            self._drain_poll_inner(rt, block=True)
        for job in list(_LIVE_JOBS):
            if job is not self:
                job._await_fetches()

    def _await_fetches(self) -> None:
        """Wait for the fetches handed to this Job's fetch thread (their
        results stay queued for its own run loop)."""
        futs = [entry["fut"] for rt in self._plans.values()
                for entry in rt.drain_q if "fut" in entry]
        concurrent.futures.wait(futs)

    def close(self) -> None:
        """Complete the queued drains and stop the fetch thread (a later
        drain starts a new one). A Job that is dropped without ``close``
        stops its thread when it is collected."""
        self._settle_drains()
        pool, self._fetch_pool_ = self._fetch_pool_, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _interval_drain(self) -> None:
        """The staleness pass over plans someone observes: plans whose
        oldest undrained match reached the budget, stalest first, at most
        two drains in flight per plan (the second's readiness wait
        overlaps the first's fetch; more only grows a backlog), within a
        budget of ``MAX_PENDING_DRAINS`` queued over all plans."""
        now = time.monotonic()
        interval_s = (self.drain_interval_ms or 0.0) / 1e3
        for rt in self._plans.values():
            self._drain_poll(rt)
        budget = self.MAX_PENDING_DRAINS - sum(
            len(rt.drain_q) for rt in self._plans.values()
        )
        cands = [
            rt for rt in self._plans.values()
            if rt.dirty_since is not None
            and now - rt.dirty_since >= interval_s
            and len(rt.drain_q) < 2
            and self._has_consumers(rt)
        ]
        cands.sort(key=lambda rt: rt.dirty_since)  # stalest first
        for rt in cands:
            if budget <= 0:
                break
            self._drain_request(rt)
            self._drain_poll(rt)
            budget -= 1

    def prewarm_drains(self) -> None:
        """Allocate the drains' host buffers up front, pinned on a GPU:
        the counts, and, for a plan someone observes, the used columns at
        the widest fetch width (``acc_capacity()``), which every narrower
        bucketed width views. Without it, the first drains allocate them
        mid-run."""
        for rt in self._plans.values():
            if not rt.plan.artifacts:
                continue
            self._host_meta(rt)
            if self._has_consumers(rt):
                self._host_view(rt, rt.plan.acc_capacity())

    def _host_meta(self, rt: _PlanRuntime) -> torch.Tensor:
        """One host copy of the counts per ring position (a ring holds
        at most ``MAX_PENDING_DRAINS`` + 1)."""
        if rt.host_meta is None:
            rt.host_meta = torch.empty(
                (self.MAX_PENDING_DRAINS + 1, *rt.acc["meta"].shape),
                dtype=torch.int32, pin_memory=self.device.type == "cuda",
            )
        return rt.host_meta

    def _host_view(self, rt: _PlanRuntime, width: int) -> torch.Tensor:
        """A contiguous [rows, width] view of the plan's host data buffer
        (grown to it when smaller)."""
        rows = int(rt.acc["buf"].shape[0])
        if rt.host_buf is None or rt.host_buf.numel() < rows * width:
            rt.host_buf = torch.empty(
                rows * width, dtype=torch.int32,
                pin_memory=self.device.type == "cuda",
            )
        return rt.host_buf[:rows * width].view(rows, width)

    def _grow_ring(self, rt: _PlanRuntime) -> None:
        """One more accumulator ring position (its buffer columns past a
        count are never read, so only its counts start zeroed)."""
        like = rt.ring[0]
        rt.ring.append({
            "meta": torch.zeros_like(like["meta"]),
            "buf": torch.empty_like(like["buf"]),
        })
        rt.ring_release.append(None)

    def _free_position(self, rt: _PlanRuntime) -> Optional[int]:
        """A ring position neither live nor held by a queued drain whose
        fetch has not copied it yet, round robin from the live one."""
        busy = {rt.acc_pos} | {e["pos"] for e in rt.drain_q
                               if not e.get("released")}
        n = len(rt.ring)
        for i in range(1, n + 1):
            pos = (rt.acc_pos + i) % n
            if pos not in busy:
                return pos
        return None

    def _force_oldest(self, rt: _PlanRuntime) -> None:
        """Complete the oldest queued drain on the run loop (a counted
        wait). No loopback flush here: it runs inside an accumulator swap,
        where a suffix's step would append to the accumulator being
        swapped out; the next poll flushes."""
        self.drains_forced += 1
        self.telemetry.inc("drains.forced")
        self._drain_poll_inner(rt, block=True, limit=1)

    def _swap_acc(self, rt: _PlanRuntime) -> None:
        """Make a free ring position the live accumulator: grow the ring
        (up to ``ring_size``; no graph captures a position added later,
        so a ring that graphs replay is full already) or, with every
        position in flight, complete the oldest drain first. Its counts
        are zeroed in stream order, after its last fetch's copies."""
        pos = self._free_position(rt)
        while pos is None:
            if len(rt.ring) < rt.ring_size:
                self._grow_ring(rt)
            else:
                self._force_oldest(rt)
            pos = self._free_position(rt)
        acc, release = rt.ring[pos], rt.ring_release[pos]
        if release is not None:
            torch.cuda.current_stream(self.device).wait_event(release)
        acc["meta"].zero_()
        rt.acc, rt.acc_pos = acc, pos

    def _drain_request(self, rt: _PlanRuntime) -> None:
        """Swap the live accumulator for a free ring position and queue
        the old one for its fetch: a ready event behind the work that
        filled it, the copy of its counts issued behind that event (on
        the CPU done at once), the consumers' lane, and the clock stamps.
        Past ``MAX_PENDING_DRAINS`` queued, the oldest completes."""
        if not rt.plan.artifacts:
            return
        # the footprint meter polls at drain boundaries only (tensor
        # metadata, no device wait)
        self._update_footprint(rt)
        if not rt.acc_dirty:
            return  # provably empty: nothing to swap or fetch
        old, pos = rt.acc, rt.acc_pos
        ready = None
        if self.device.type == "cuda":
            if self._meta_stream is None:
                self._meta_stream = torch.cuda.Stream(self.device)
                self._data_stream = torch.cuda.Stream(self.device)
            ready = torch.cuda.Event(enable_timing=True)
            ready.record(torch.cuda.current_stream(self.device))
        # the counts' copy goes out now, behind the work that filled them:
        # on the card it runs as soon as that work is done, while later
        # dispatches run
        meta_done = self._copy_to_host(self._host_meta(rt)[pos],
                                       old["meta"], self._meta_stream,
                                       after=ready)
        self._swap_acc(rt)
        rt.acc_dirty = False
        t_dirty, rt.dirty_since = rt.dirty_since, None
        want = self._has_consumers(rt)
        # no consumer: counts only (no data fetch, no decode); the swap
        # still happens (overflow accounting)
        rt.drain_q.append({
            "acc": old,
            "pos": pos,
            "ready": ready,
            "meta_done": meta_done,
            "want": want,
            # resolved now, so that a sink attached later (add_sink
            # drains first) cannot race it
            "columnar": self._columnar_streams(rt) if want else frozenset(),
            "unobserved": (self._unobserved_streams(rt) if want
                           else frozenset()),
            "t_req": time.monotonic(),
            # staleness: only consumer-visible drains report it
            "t_dirty": t_dirty if want else None,
        })
        self._advance_ready(rt)
        if len(rt.drain_q) > self.MAX_PENDING_DRAINS:
            self._force_oldest(rt)

    def _columnar_streams(self, rt: _PlanRuntime) -> frozenset:
        """Output streams of this plan whose rows never need to exist: a
        shared host's mid stream (the loopback takes columns), and, with
        host retention off, a stream whose every attached sink speaks
        the columnar protocol."""
        streams = rt.plan.output_streams()
        mids = frozenset(sid for sid in streams if sid in self._loopback)
        if self.retain_results:
            return mids
        return mids | frozenset(
            sid for sid in streams
            if self._sinks.get(sid)
            and all(hasattr(s, "accept_columns") for s in self._sinks[sid])
            # a snapshot limiter keeps the latest row per group key
            and getattr(self._rate_limiters.get(sid), "mode",
                        None) != "snapshot"
        )

    def _unobserved_streams(self, rt: _PlanRuntime) -> frozenset:
        """Output streams of this plan that nothing observes (host
        retention off, no sink: a chained plan's intermediate streams,
        most often): counted, never decoded."""
        if self.retain_results:
            return frozenset()
        # a shared host's mid stream is observed by its suffixes
        return frozenset(sid for sid in rt.plan.output_streams()
                         if not self._sinks.get(sid)
                         and sid not in self._loopback)

    def _has_consumers(self, rt: _PlanRuntime) -> bool:
        """Whether any host-side consumer observes this plan's rows (a
        shared host's consumers are its member suffixes)."""
        if self.retain_results:
            return True
        return any(self._sinks.get(sid) or sid in self._loopback
                   for sid in rt.plan.output_streams())

    @property
    def _fetch_pool(self) -> concurrent.futures.Executor:
        """The job's one fetch thread: FIFO completion. Fetch and decode
        run there (the lazy ring locks); sinks only ever run on the run
        loop (``_drain_poll`` emits)."""
        if self._fetch_pool_ is None:
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fpt-fetch"
            )
            weakref.finalize(self, pool.shutdown, False)
            self._fetch_pool_ = pool
        return self._fetch_pool_

    def _advance_ready(self, rt: _PlanRuntime, all_: bool = False) -> None:
        """Hand queued drains whose counts have reached the host to the
        fetch thread, in order (stop at the first whose have not): their
        fetch then never waits for unfinished compute. With ``all_`` (a
        waiting poll, whose caller waits anyway) every queued drain goes
        at once, and the fetch thread takes them back to back, each
        waiting for its counts there, with no round trip through the run
        loop between them."""
        for entry in rt.drain_q:
            if "fut" in entry:
                continue
            done = entry["meta_done"]
            if not all_ and done is not None and not done.query():
                break
            entry["t_ready"] = time.monotonic()
            entry["stages"] = {}
            entry["fut"] = self._fetch_pool.submit(
                self._fetch_acc, rt, entry, entry.pop("acc"),
                entry.pop("want"), entry.pop("columnar"),
                entry.pop("unobserved"),
            )

    def _copy_to_host(self, dst: torch.Tensor, src: torch.Tensor, stream,
                      after=None):
        """Copy ``src`` into the host tensor ``dst``: on a GPU a
        non-blocking copy on ``stream`` (after the event ``after``);
        returns the (timed) event behind it (None on the CPU, done
        already)."""
        if self.device.type != "cuda":
            dst.copy_(src)
            return None
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            if after is not None:
                stream.wait_event(after)
            dst.copy_(src, non_blocking=True)
            done = torch.cuda.Event(enable_timing=True)
            done.record(stream)
        return done

    def _fetch_acc(self, rt: _PlanRuntime, entry: Dict, acc: Dict,
                   want: bool, columnar: frozenset,
                   unobserved: frozenset = frozenset()):
        """The fetch thread's body, two-phase: the counts (their copy was
        issued at the request); then, only when a consumer wants rows and
        any were emitted, the used columns at a width bucketed from the
        largest count, on the data stream, which also releases the ring
        position; then the decode. Returns (counts, overflow, decoded or
        None, fetches made)."""
        stages = entry["stages"]
        stages["t_fetch0"] = time.monotonic()
        done = entry["meta_done"]
        if done is not None:
            done.synchronize()
        self.fetch_syncs += 1
        meta = self._host_meta(rt)[entry["pos"]].numpy().copy()
        counts, overflow = meta[0], meta[1]
        max_n = int(counts.max()) if counts.size else 0
        stages["t_meta"] = time.monotonic()
        if not want or max_n == 0:
            rt.ring_release[entry["pos"]] = done
            entry["released"] = True
            stages["t_dec0"] = stages["t_fetch1"] = time.monotonic()
            return counts, overflow, None, 1
        width = min(bucket_size(max_n, minimum=self.MIN_FETCH_WIDTH),
                    rt.plan.acc_capacity())
        host = self._host_view(rt, width)
        done = self._copy_to_host(host, acc["buf"][:, :width],
                                  self._data_stream)
        rt.ring_release[entry["pos"]] = done
        entry["released"] = True
        if done is not None:
            done.synchronize()
        self.fetch_syncs += 1
        stages["t_dec0"] = time.monotonic()
        lazy = rt.lazy
        decoded = rt.plan.drain_decode(
            counts, host.numpy()[:, :max_n],
            lookup=lazy.lookup if lazy is not None else None,
            columnar_streams=columnar,
            lookup_np=lazy.lookup_np if lazy is not None else None,
            count_only_streams=unobserved,
        )
        stages["t_fetch1"] = time.monotonic()
        return counts, overflow, decoded, 2

    def _drain_poll(self, rt: _PlanRuntime, block: bool = False,
                    limit: int = 0) -> None:
        """Complete finished drains in order and emit their decoded rows
        (decoded on the fetch thread already) to collectors and sinks.
        Without ``block`` this never waits; with it, every queued drain
        (or the first ``limit``) completes, and a poll that had to wait
        counts one run-loop wait. Then the loopback flushes: at its
        thresholds, or, for a waiting poll (a barrier: results, snapshot,
        retire, attach), everything."""
        try:
            self._drain_poll_inner(rt, block, limit)
        finally:
            self._flush_loopback(force=block)

    def _drain_poll_inner(self, rt: _PlanRuntime, block: bool = False,
                          limit: int = 0) -> None:
        waited = False
        try:
            self._advance_ready(rt, all_=block)
            done = 0
            while rt.drain_q:
                entry = rt.drain_q[0]
                if "fut" not in entry:
                    return
                fut = entry["fut"]
                if not fut.done():
                    if not block:
                        return
                    waited = True
                counts, overflow, decoded, fetches = fut.result()
                rt.drain_q.popleft()
                self.drain_fetches += fetches
                if self._overlapped(entry, rt):
                    self.drains_overlapped += 1
                    self.telemetry.inc("drains.overlapped")
                self._record_drain(rt, entry)
                self._complete_drain(rt, counts, overflow, decoded)
                done += 1
                if limit and done >= limit:
                    return
        finally:
            if waited:
                self.drain_waits += 1

    @staticmethod
    def _overlapped(entry: Dict, rt: _PlanRuntime) -> bool:
        """Whether a completed drain's counts reached the host while the
        dispatch after it was still unfinished on the card: the next
        queued drain's ready event had not completed by then (on the
        card's clock)."""
        done = entry["meta_done"]
        if done is None or not rt.drain_q:
            return False
        later = rt.drain_q[0]["ready"]
        return not later.query() or done.elapsed_time(later) > 0

    def _record_drain(self, rt: _PlanRuntime, entry: Dict) -> None:
        """A completed drain's latency legs, into ``drain.*``
        histograms: wait_ready (request to the hand-off to the fetch
        thread: its counts on the host, or a waiting poll), queue (to the
        fetch thread's start), fetch (the copies; fetch_meta the counts'
        alone), decode, emit_lag (decoded to completed on the run loop),
        total, transport (wait_ready + fetch) and staleness (the age of
        the oldest match it surfaced)."""
        tel = self.telemetry
        if not tel.enabled:
            return
        now = time.monotonic()
        st = entry.get("stages") or {}
        t_req = entry["t_req"]
        t_rdy = entry.get("t_ready", t_req)
        t_f0 = st.get("t_fetch0", t_rdy)
        t_f1 = st.get("t_fetch1", now)
        t_d0 = st.get("t_dec0", t_f1)
        legs = {
            "wait_ready": t_rdy - t_req,
            "queue": t_f0 - t_rdy,
            "fetch": t_d0 - t_f0,
            "decode": t_f1 - t_d0,
            "emit_lag": now - t_f1,
            "total": now - t_req,
        }
        if "t_meta" in st:
            legs["fetch_meta"] = st["t_meta"] - t_f0
        for leg, dt in legs.items():
            tel.record_seconds(f"drain.{leg}", dt)
        t_dirty = entry.get("t_dirty")
        if t_dirty is not None:
            tel.record_seconds("drain.staleness", now - t_dirty)
        tel.record_seconds("drain.transport",
                           legs["wait_ready"] + legs["fetch"])
        tel.inc("drains.completed")
        # the plan-scoped twins of total and staleness: every plan this
        # runtime serves waited through this drain
        self._scoped_drain_record(
            rt, legs["total"],
            (now - t_dirty) if t_dirty is not None else None)

    def _complete_drain(self, rt: _PlanRuntime, counts, overflow,
                        decoded) -> None:
        """The run loop's half of a drain: warnings, then the rows (or,
        counts-only, the emitted counters)."""
        plan = rt.plan
        for ai, a in enumerate(plan.artifacts):
            if overflow[ai] > 0:
                _LOG.warning(
                    "%s: %d emissions dropped (accumulator full; raise "
                    "EngineConfig.acc_budget_bytes or drain more often)",
                    a.name, int(overflow[ai]),
                )
        # the only place the engine degrades instead of failing loudly: a
        # lazy-projected value older than the ring budget decodes as None
        # in user rows — surface it, once per newly missed count
        if rt.lazy is not None and rt.lazy.missed > rt.lazy_miss_warned:
            _LOG.warning(
                "%s: %d lazy-projected values were evicted past the ring "
                "horizon and decoded as None (raise "
                "EngineConfig.lazy_ring_budget_bytes, or drain results "
                "more often)",
                plan.plan_id, rt.lazy.missed - rt.lazy_miss_warned,
            )
            rt.lazy_miss_warned = rt.lazy.missed
        tel = self.telemetry
        if decoded is None:
            # counts-only drain (no consumers, or nothing emitted): keep
            # the counters truthful. A stack (or a dynamic group) counts
            # to its representative member, in the plan scopes too: the
            # data block is never fetched, so it cannot split by slot
            for ai, a in enumerate(plan.artifacts):
                c = int(counts[ai])
                if c:
                    sch = a.output_schema
                    self.emitted_counts[sch.stream_id] = (
                        self.emitted_counts.get(sch.stream_id, 0) + c
                    )
                    sc = self._attr_scope(sch) if tel.enabled else None
                    if sc is not None:
                        sc.inc("rows_emitted", c)
                        sc.inc("matches", c)
            return
        for a in plan.artifacts:
            for schema, payload in decoded.get(a.name) or []:
                if isinstance(payload, int):  # a stream nothing observes
                    sid = schema.stream_id
                    self.emitted_counts[sid] = (
                        self.emitted_counts.get(sid, 0) + payload)
                    sc = self._attr_scope(schema) if tel.enabled else None
                    if sc is not None:
                        sc.inc("rows_emitted", payload)
                        sc.inc("matches", payload)
                    continue
                if tel.enabled:
                    # matches: drained rows BEFORE rate limiting
                    # (rows_emitted is the post-limit twin); a group's
                    # per-slot decode attributes each member exactly
                    sc = self._attr_scope(schema)
                    if sc is not None:
                        sc.inc("matches", len(payload))
                if isinstance(payload, ColumnBatch):
                    self._emit_columns(schema, payload)
                else:
                    self._emit_rows(schema, payload)

    def _decode_outputs(self, rt: _PlanRuntime, outputs: Dict) -> None:
        """Decode flush outputs fetched straight from the device (the
        end-of-stream flush path): packed blocks, and the buffered
        ``(count, ts, cols)`` of batch and expired windows."""
        for a in rt.plan.artifacts:
            if a.name not in outputs:
                continue
            out = outputs[a.name]
            n = int(out[0])
            if n == 0:
                continue
            if a.output_mode == "buffered":
                _, ts, cols = out
                decoded = [(a.output_schema, a.output_schema.decode_buffered(
                    n, ts.cpu().numpy(), [c.cpu().numpy() for c in cols]
                ))]
            elif getattr(a, "wants_lookup", False):
                decoded = a.decode_packed(
                    n, out[1].cpu().numpy(),
                    lookup=rt.lazy.lookup if rt.lazy is not None else None,
                )
            else:
                decoded = a.decode_packed(n, out[1].cpu().numpy())
            for schema, rows in decoded:
                self._emit_rows(schema, rows)

    def _emit_rows(self, schema, rows, rate_limit: bool = True) -> None:
        """Append decoded rows (relative ts) to collectors and sinks,
        through the stream's rate limiter unless ``rate_limit`` is off
        (rows it already released); a columnar sink on a stream that
        decodes row-wise gets them converted once a batch (object-dtype
        columns)."""
        if not rows:
            return
        sid = schema.stream_id
        if rate_limit:
            limiter = self._rate_limiters.get(sid)
            if limiter is not None:
                rows = limiter.feed(rows)
                if not rows:
                    return
        epoch = self._epoch_ms or 0
        # rows surfacing to a consumer complete their event's trace (after
        # the limiter: a thinned row is not visible)
        self.tracer.complete_rows(epoch, rows)
        self.emitted_counts[sid] = self.emitted_counts.get(sid, 0) + len(rows)
        if self.telemetry.enabled:
            # per-plan attribution at the site the job total counts, so
            # the plan scopes sum to it
            sc = self._attr_scope(schema)
            if sc is not None:
                sc.inc("rows_emitted", len(rows))
        if self.retain_results:
            self.collected.setdefault(sid, []).extend(
                (epoch + rel_ts, row) for rel_ts, row in rows
            )
        sinks = self._sinks.get(sid)
        if not sinks:
            return
        with self.telemetry.span("sink"):
            col_sinks = [s for s in sinks if hasattr(s, "accept_columns")]
            if col_sinks:
                abs_ts = np.fromiter((epoch + r[0] for r in rows), np.int64,
                                     len(rows))
                cols: Dict[str, np.ndarray] = {}
                for i, name in enumerate(schema.field_names):
                    c = np.empty(len(rows), dtype=object)
                    c[:] = [r[1][i] for r in rows]
                    cols[name] = c
                for sink in col_sinks:
                    sink.accept_columns(abs_ts, cols)
            for sink in sinks:
                if not hasattr(sink, "accept_columns"):
                    for rel_ts, row in rows:
                        sink(epoch + rel_ts, row)

    def _emit_columns(self, schema, cb: ColumnBatch,
                      rate_limit: bool = True) -> None:
        """The columnar lane's emission: counts, rate limiting and sink
        delivery account arrays, never row tuples. Reached only for
        streams that ``_columnar_streams`` approved (every consumer
        columnar, or a shared host's mid stream)."""
        if not len(cb):
            return
        sid = schema.stream_id
        if self._loopback and sid in self._loopback:
            # a shared prefix's mid stream: host-side plumbing into the
            # member suffixes — no counters, collectors or sinks
            self._feed_loopback(schema, cb)
            return
        if rate_limit:
            limiter = self._rate_limiters.get(sid)
            if limiter is not None:
                for part in limiter.feed_columns(cb):
                    self._emit_columns(schema, part, rate_limit=False)
                return
        epoch = self._epoch_ms or 0
        self.tracer.complete_ts(epoch, cb.ts)
        self.emitted_counts[sid] = self.emitted_counts.get(sid, 0) + len(cb)
        if self.telemetry.enabled:
            sc = self._attr_scope(schema)
            if sc is not None:
                sc.inc("rows_emitted", len(cb))
        abs_ts = cb.ts + np.int64(epoch)
        with self.telemetry.span("sink"):
            for sink in self._sinks.get(sid) or ():
                sink.accept_columns(abs_ts, cb.cols)

    def _poll_rate_limiters(self) -> None:
        """Time-mode and snapshot limiters emit on a schedule, not only
        when new rows arrive for their stream: buffered output whose
        interval elapsed surfaces from the interval-drain cadence."""
        for sid, limiter in self._rate_limiters.items():
            if limiter.mode == "time":
                if not limiter.buf:
                    continue
            elif limiter.mode == "snapshot":
                if not limiter.cur:
                    continue
            else:
                continue
            self._emit_pending(sid, limiter.feed([]))

    def _emit_pending(self, sid: str, pending: List) -> None:
        """Emit limiter-released output to ``sid``'s first output schema,
        past the limiter (it released it). Entries are ``(ts, row)``
        pairs or ColumnBatch fragments, by the lane that fed it."""
        if not pending:
            return
        for rt in self._plans.values():
            schemas = rt.plan.output_streams().get(sid)
            if schemas:
                rows = [p for p in pending if not isinstance(p, ColumnBatch)]
                if rows:
                    self._emit_rows(schemas[0], rows, rate_limit=False)
                for p in pending:
                    if isinstance(p, ColumnBatch):
                        self._emit_columns(schemas[0], p, rate_limit=False)
                return

    # -- checkpoint / restore ------------------------------------------------
    def _prepare_sink_commits(self) -> None:
        """Phase one of a transactional sink's commit: after the drain
        surfaced every row, each sink with ``prepare_commit`` stamps its
        open transaction pending, so the snapshot carries its identity.
        Other sinks are untouched."""
        for sinks in self._sinks.values():
            for s in sinks:
                prep = getattr(s, "prepare_commit", None)
                if prep is not None:
                    prep()

    def commit_sink_transactions(self) -> None:
        """Phase two, driven by the supervisor once the snapshot is
        durable: ``commit_transaction`` on every sink that has it."""
        for sinks in self._sinks.values():
            for s in sinks:
                commit = getattr(s, "commit_transaction", None)
                if commit is not None:
                    commit()

    def snapshot(self) -> Dict:
        """The job's whole state as a picklable dict
        (``runtime/checkpoint.py``, the JAX package's format). Staged
        tapes are dispatched and every drain completes first, so that the
        rows emitted so far have surfaced and the accumulators are
        empty."""
        from .checkpoint import snapshot_job

        self.drain_outputs()
        self._prepare_sink_commits()
        return snapshot_job(self)

    def save_checkpoint(self, path: str, keep: int = 1) -> None:
        """``snapshot`` written to ``path`` atomically; ``keep > 1`` keeps
        the latest generations as ``path.1`` .. (``checkpoint.save``)."""
        import os

        from .checkpoint import save

        self.drain_outputs()
        self._prepare_sink_commits()
        # journaled BEFORE the state capture: the save is part of the
        # snapshot, so a restored journal shows the save that made it,
        # once (fspath: the restore's safelisting unpickler refuses a
        # pathlib.Path)
        self.flightrec.record(
            "checkpoint.save", path=os.fspath(path), keep=int(keep),
            processed_events=int(self.processed_events))
        save(self, path, keep=keep)

    def restore(self, snapshot_or_path) -> None:
        """Load a snapshot (a dict, or a file ``save_checkpoint`` wrote,
        either package's) into this job, which runs the same plans. The
        engine state goes to this job's device, or the restore raises."""
        import os

        from .checkpoint import load, restore_job

        if isinstance(snapshot_or_path, (str, os.PathLike)):
            load(self, os.fspath(snapshot_or_path))
        else:
            restore_job(self, snapshot_or_path)
        # after restore_job adopted the checkpointed journal: the restore
        # extends it with the next seq
        self.flightrec.record(
            "checkpoint.restore", processed_events=int(self.processed_events),
            plans=len(self._plans))

    # -- observability ---------------------------------------------------------
    def metrics(self, drain: bool = False) -> Dict[str, object]:
        """The job's snapshot, the reference's blocks: processed and
        emitted, live plans and the tenant rollup, the footprint meter,
        the event-time view (per-source watermark and idle state, the late
        account), the control plane, compiles, the limiting-leg
        attribution, the flight recorder's summary, the SLO watchdog and
        the telemetry registry with the trace view. ``drain=False`` reads
        host-side state only (safe from another thread, as the REST
        service calls it); ``drain=True`` completes the drains first and
        runs on the run loop."""
        if drain:
            self.drain_outputs()
        wm = self._watermark()
        idle = list(self._source_idle) + [False] * len(self._sources)
        telemetry = self.telemetry.snapshot()
        telemetry["trace"] = self.tracer.snapshot()
        return {
            "processed_events": self.processed_events,
            # list() snapshots: the run loop mutates these dicts while an
            # off-thread reader takes the snapshot
            "plans": {
                **{pid: {"enabled": rt.enabled,
                         "tenant": self.tenant_of(pid)}
                   for pid, rt in list(self._plans.items())
                   if not pid.startswith(("@dyn:", "@shr:"))},
                **{pid: {"enabled": on, "tenant": self.tenant_of(pid)}
                   for pid, on in list(self._folded_enabled.items())},
            },
            # plan scopes merged per tenant (counters summed, histograms
            # merged bucket-exactly)
            "tenants": self.tenant_rollup(),
            "footprint": self.footprint_status(),
            "emitted": dict(self.emitted_counts),
            "pending_batches": sum(
                len(b) for b in list(self._pending.values())),
            "watermark": None if wm in (MAX_WM, MIN_WM) else wm,
            "sources": [
                {"stream_id": getattr(src, "stream_id", None),
                 "watermark": (None if swm in (MAX_WM, MIN_WM)
                               else int(swm)),
                 "idle": bool(i), "done": bool(d)}
                for src, swm, i, d in zip(self._sources, self._source_wm,
                                          idle, self._source_done)
            ],
            "idle_sources": self.idle_source_ids(),
            "late_events": self.late_events,
            "late_dropped": self.late_dropped,
            "late_policy": self.late_policy,
            "shed_events": self.shed_events,
            "control": self.control_status(),
            # compile events (graph captures, kernel builds) per plan label
            "compiles": self._compile_sink.snapshot(),
            # the serving fleet (ROADMAP.md Queue 1 item 13): none yet
            "fleet": None,
            # the limiting leg over the live stage ledger (shares of the
            # attributed total)
            "attribution": _attr_limiting_leg(
                telemetry.get("stages", {}), None, "streaming",
                telemetry.get("histograms", {})),
            # the journal's summary (GET /api/v1/flightrecorder serves it)
            "flight_recorder": {
                "seq": self.flightrec.seq,
                "by_kind": self.flightrec.counts_by_kind(),
            },
            "slo": self.slo.snapshot(),
            "telemetry": telemetry,
        }

    def plan_metrics(self, plan_id: str) -> Dict[str, object]:
        """One plan's scoped metrics (GET /api/v1/queries/<id>): its
        scope's counters, gauges and histograms and, for a folded member,
        its host's footprint (the member's state lives in the host's
        group). Safe off-thread."""
        scopes = self.telemetry.scope_map("plan")
        reg = scopes.get(plan_id)
        out: Dict[str, object] = {}
        if reg is not None:
            snap = reg.snapshot()
            out = {
                "counters": snap.get("counters", {}),
                "gauges": snap.get("gauges", {}),
                "histograms": snap.get("histograms", {}),
            }
        f = self._folded.get(plan_id)
        if f is not None:
            host = scopes.get(f[0])
            if host is not None:
                measured = host.gauge_value("footprint.measured_bytes")
                if measured is not None:
                    out["host_footprint"] = {
                        "host": f[0], "measured_bytes": int(measured)}
        return out

    def tenant_rollup(self) -> Dict[str, Dict[str, object]]:
        """``metrics()["tenants"]``: each tenant's plan scopes rolled up
        (counters summed, drain histograms merged with
        ``LatencyHistogram.merge``) with the tenant scope's control
        counters. Group and shared hosts are left out: their drain legs
        are in each member's scope already. The port has no executable
        cache, so ``cache_hits`` and ``cache_misses`` stay 0. Safe
        off-thread."""
        reg = self.telemetry
        by_tenant: Dict[str, List[str]] = {}
        plan_scopes = reg.scope_map("plan")
        for pid in plan_scopes:
            if pid.startswith(("@dyn:", "@shr:")):
                continue
            by_tenant.setdefault(self.tenant_of(pid), []).append(pid)
        for pid in self.plan_ids:  # live plans with no scope yet
            ids = by_tenant.setdefault(self.tenant_of(pid), [])
            if pid not in ids:
                ids.append(pid)
        tenant_scopes = reg.scope_map("tenant")
        out: Dict[str, Dict[str, object]] = {}
        for tenant, pids in sorted(by_tenant.items()):
            rows = matches = late = 0
            for pid in pids:
                sreg = plan_scopes.get(pid)
                if sreg is None:
                    continue
                rows += sreg.counter_value("rows_emitted")
                matches += sreg.counter_value("matches")
                late += sreg.counter_value("late_events")
            treg = tenant_scopes.get(tenant)

            def tcount(name, treg=treg):
                return treg.counter_value(name) if treg is not None else 0

            out[tenant] = {
                "plans": sorted(pids),
                "rows_emitted": rows,
                "matches": matches,
                "late_events": late,
                "drain": reg.merged_scope_histogram(
                    "plan", pids, "drain.total").snapshot(),
                "drain_staleness": reg.merged_scope_histogram(
                    "plan", pids, "drain.staleness").snapshot(),
                "cache_hits": tcount("control.cache_hit"),
                "cache_misses": tcount("control.cache_miss"),
                "stack_joins": tcount("control.stack_join"),
            }
        return out

    def openmetrics(self) -> str:
        """The metrics snapshot as Prometheus text (the body of GET
        /api/v1/metrics/prometheus; ``telemetry/openmetrics.py``), its
        ``fst_build_info`` backend this job's device type. Safe
        off-thread."""
        from ..telemetry.openmetrics import render_openmetrics

        return render_openmetrics(self.metrics(), backend=self.device.type)

    # -- results -------------------------------------------------------------
    def results(self, output_stream: str) -> List[Tuple]:
        self.drain_outputs()
        return [row for _, row in self.collected.get(output_stream, [])]

    def results_with_ts(self, output_stream: str) -> List[Tuple[int, Tuple]]:
        self.drain_outputs()
        return list(self.collected.get(output_stream, []))
