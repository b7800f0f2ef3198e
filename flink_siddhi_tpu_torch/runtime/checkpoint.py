"""Checkpoint / restore of the whole engine state, in the JAX package's
format.

The port of ``flink_siddhi_tpu/runtime/checkpoint.py``. A snapshot is a
plain picklable dict with the same ``FORMAT_VERSION`` and keys, so a file
written by either package loads in the other:

* every plan's engine state as numpy arrays, in the reference's layout per
  artifact (``compiler/plan.py:state_to_numpy`` / ``state_from_numpy``),
  with the group-key encoders whose codes index it;
* the shared string dictionary, the job epoch (device timestamps are
  epoch-relative int32), the processed count;
* the event-time gate (per-source watermarks, the released horizon, the
  monotone gate watermark, idle flags, the late account) and the reorder
  buffer;
* source positions and sink states, for those that expose ``state_dict``;
* the output-rate limiters' phase;
* the control plane: the dynamically added queries (``dynamic``: each
  one's CQL, its group slot, its enable flag and tenant), which a restore
  replays into the same runtimes and slots before the state overlay
  (``Job._replay_dynamic``), and the control events still pending behind
  the watermark (``control_pending``), which the restored job applies
  exactly once. The events are pickled under the JAX package's module
  name, ``flink_siddhi_tpu.control.events``, and either package's name
  loads into this package's own classes, so such a file moves both ways;
* the share table (``shared``: per share key, the producer host's id, its
  mid stream, its prefix CQL, the source stream and the members), whose
  hosts a restore re-forms from their prefix CQL before the dynamic
  replay re-admits the member suffixes (``Job._replay_shared``), so that
  hosts precede their consumers; and the admitted footprints.

The blocks of modules the port does not have yet are written empty, and a
snapshot in which one is not empty is refused, naming its ROADMAP item:
``routers`` (parallel, item 11) and ``fleet`` (item 13). The flight
recorder's journal (``flightrec``: its seq and entries) is written and
restored last, before the transactional sinks, so a journal survives a
restore exactly once, and it moves between the packages with the file.

``save``/``load`` write one file (atomic replace, keep-last-K rotation,
stale-temp sweep; ``load`` reads it under a safelisting unpickler: numpy
scalars and arrays and builtin containers only). Restore targets a job
over the same plans (the same CQL): the state's keys, shapes and dtypes
are checked against the running plans' before anything is loaded onto the
device.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
from typing import Any, Dict

import numpy as np

from ..compiler.plan import state_from_numpy, state_to_numpy
from ..schema.batch import EventBatch

FORMAT_VERSION = 1

_LOG = logging.getLogger(__name__)


def _first_string_table(job):
    """The environment's shared string dictionary: every schema built
    through one CEPEnvironment references one StringTable object, so the
    first one found is the dictionary."""
    for rt in job._plans.values():
        for sch in rt.plan.schemas.values():
            for t in sch.string_tables.values():
                return t
    return None


def _rate_limiter_rows(lim) -> list:
    """A limiter's buffered entries as ``(ts, row)`` pairs: the columnar
    lane buffers ColumnBatch fragments, which the file format (and the
    safelist) does not carry."""
    lim._normalize_buf_rows()
    return list(lim.buf)


def _owned(tree):
    """numpy copies of a fetched state (on the CPU a tensor's numpy view
    shares its memory, and group slots are written in place)."""
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    return np.array(tree)


def snapshot_job(job) -> Dict[str, Any]:
    """Capture everything needed to resume ``job`` in a fresh process."""
    missing_cql = set(job._folded) - set(job._dynamic_cql)
    if missing_cql:
        raise ValueError(
            f"dynamically-added plans {sorted(missing_cql)} have no "
            "recorded CQL, so the checkpoint could not be restored; add "
            "them through control events or pass cql= to "
            "add_plan(dynamic=True)"
        )
    plans = {}
    strings = _first_string_table(job)
    for plan_id, rt in job._plans.items():
        plans[plan_id] = {
            "states": _owned(state_to_numpy(rt.states)),
            "enabled": rt.enabled,
            "encoders": {enc.out_key: enc.encoder.state_dict()
                         for enc in rt.plan.spec.encoded},
        }
    pending = {
        sid: [
            {
                "stream_id": b.stream_id,
                "columns": {k: np.asarray(v) for k, v in b.columns.items()},
                "timestamps": np.asarray(b.timestamps),
            }
            for b in batches
        ]
        for sid, batches in job._pending.items()
    }
    sources = {}
    for i, src in enumerate(job._sources):
        sd = getattr(src, "state_dict", None)
        if sd is not None:
            sources[i] = sd()
    # sinks with a state, keyed by (output stream, attach index): attach
    # order is deterministic per factory, so the index addresses the same
    # sink on a rebuilt job
    sinks = {}
    for sid, fns in job._sinks.items():
        per = {}
        for i, fn in enumerate(fns):
            sd = getattr(fn, "state_dict", None)
            if sd is not None:
                per[i] = sd()
        if per:
            sinks[sid] = per
    return {
        "version": FORMAT_VERSION,
        "epoch_ms": job._epoch_ms,
        "processed_events": job.processed_events,
        "time_mode": job.time_mode,
        # the event-time gate: a restarted job that forgot how far it
        # released would re-admit or re-classify rows around the crash
        # point (source strategies ride the per-source state below)
        "event_time": {
            "source_wm": [int(w) for w in job._source_wm],
            "released_wm": int(job._released_wm),
            "gate_wm": int(job._gate_wm),
            "idle": [bool(b) for b in job._source_idle],
            "max_event_ts": job._max_event_ts,
            "late_events": int(job.late_events),
            "late_dropped": int(job.late_dropped),
        },
        "plans": plans,
        "strings": strings.state_dict() if strings is not None else None,
        "pending": pending,
        "control_pending": list(job._control_pending),
        "sources": sources,
        "routers": {},
        "sinks": sinks,
        # dynamically added queries: CQL and group slots, so a restore
        # replays them into identical runtimes and slots
        "dynamic": {
            "cql": dict(job._dynamic_cql),
            "folded": dict(job._folded),
            "enabled": dict(job._folded_enabled),
            "tenants": dict(job._plan_tenant),
            "admitted_bytes": dict(job._plan_admitted_bytes),
        },
        # the share table: a restore re-forms each host from its prefix
        # CQL before the dynamic replay re-admits the member suffixes
        # (their CQL is in dynamic.cql)
        "shared": {
            key: {
                "host_id": e["host_id"],
                "mid": e["mid"],
                "prefix_cql": e["prefix_cql"],
                "src": e["src"],
                "members": list(e["members"]),
            }
            for key, e in job._shared.items()
        },
        # the flight recorder's journal: entries after this snapshot roll
        # back with a crash; the restored recorder continues the seq
        "flightrec": job.flightrec.state_dict(),
        # events-mode chunk position and buffered rows survive, so that a
        # restored job emits at the same chunk boundaries; time-mode
        # deadlines are monotonic-clock values and re-arm at restore
        "rate_limiters": {
            sid: {
                "count": lim.count,
                "buf": _rate_limiter_rows(lim),
                "snap": list(lim.cur.items()),
            }
            for sid, lim in job._rate_limiters.items()
        },
        "fleet": {"epoch": 0, "last_handoff": None},
    }


def _check_later_blocks(snap: Dict[str, Any]) -> None:
    """Refuse a snapshot that holds state of a module the port does not
    have yet, naming its ROADMAP item (restoring without it would
    silently drop that state)."""
    fleet = snap.get("fleet") or {}
    later = (
        ("sharded routers ('routers')", bool(snap.get("routers")), 11),
        ("the serving fleet's account ('fleet')",
         bool(fleet.get("epoch")) or fleet.get("last_handoff") is not None,
         13),
    )
    for what, present, item in later:
        if present:
            raise ValueError(
                f"the checkpoint holds {what}, which the torch port cannot "
                f"restore yet (ROADMAP.md Queue 1 item {item})"
            )


def restore_job(job, snap: Dict[str, Any]) -> None:
    """Load a snapshot into a job running the same plans. Host
    dictionaries restore first (device codes reference them), then the
    device state replaces the job's, on the job's device."""
    if snap.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {snap.get('version')}")
    if snap["time_mode"] != job.time_mode:
        raise ValueError(
            f"checkpoint was taken in {snap['time_mode']!r} time mode but "
            f"the job runs in {job.time_mode!r}; the reorder buffer "
            "semantics differ — rebuild the job with the original mode"
        )
    _check_later_blocks(snap)
    # dynamically added queries: tenants first, then the replay into the
    # same runtimes and slots, BEFORE the plan-set check below
    dyn = snap.get("dynamic") or {}
    job._plan_tenant.update(dyn.get("tenants") or {})
    job._plan_admitted_bytes.update(
        {k: int(v) for k, v in (dyn.get("admitted_bytes") or {}).items()})
    shared = snap.get("shared") or {}
    if shared or dyn.get("cql"):
        if job._plan_compiler is None:
            raise ValueError(
                "checkpoint contains dynamically-added queries but the "
                "job has no plan compiler; rebuild it through the "
                "dynamic cql() path"
            )
        # shared hosts re-form FIRST: the loopback routing exists, and
        # the hosts precede their member suffixes in runtime order
        if shared:
            job._replay_shared(shared)
        if dyn.get("cql"):
            job._replay_dynamic(dyn["cql"], dyn.get("folded", {}),
                                dyn.get("enabled", {}))
    job_only = set(job._plans) - set(snap["plans"])
    if job_only:
        raise ValueError(
            f"the job has plans {sorted(job_only)} that the checkpoint "
            "does not; rebuild the job with the same plans before restoring"
        )
    for plan_id, prec in snap["plans"].items():
        if plan_id not in job._plans:
            raise ValueError(
                f"checkpoint has plan {plan_id!r} but the job does not; "
                "rebuild the job with the same plans before restoring"
            )
    # queued drains complete before any state is replaced; mid rows still
    # buffered for the loopback belong to the replaced state
    job._settle_drains()
    job._loopback_buf.clear()
    job._epoch_ms = snap["epoch_ms"]
    job.processed_events = snap["processed_events"]

    evt = snap.get("event_time")
    if evt is not None:
        src_wm = [int(w) for w in evt.get("source_wm", ())]
        if len(src_wm) == len(job._source_wm):
            job._source_wm = src_wm
        idle = [bool(b) for b in evt.get("idle", ())]
        if len(idle) == len(job._source_idle):
            job._source_idle = idle
        job._released_wm = int(evt.get("released_wm", job._released_wm))
        job._gate_wm = int(evt.get("gate_wm", job._gate_wm))
        if evt.get("max_event_ts") is not None:
            job._max_event_ts = int(evt["max_event_ts"])
        job.late_events = int(evt.get("late_events", 0))
        job.late_dropped = int(evt.get("late_dropped", 0))

    # 1. the shared string dictionary (in place: every schema of the
    # environment references the same object)
    strings = _first_string_table(job)
    if snap["strings"] is not None and strings is not None:
        strings.load_state_dict(snap["strings"])

    # 2. per plan: the encoders, then the engine state, checked against
    # the running plan grown to the restored encoders' sizes
    for plan_id, prec in snap["plans"].items():
        rt = job._plans[plan_id]
        for enc in rt.plan.spec.encoded:
            if enc.out_key not in prec["encoders"]:
                raise ValueError(
                    f"checkpoint for plan {plan_id!r} has no encoder state "
                    f"for group key {enc.out_key!r}; was the group-by "
                    "clause changed?"
                )
            enc.encoder.load_state_dict(prec["encoders"][enc.out_key])
        ref = rt.plan.grow_state(rt.states)
        _check_compatible(ref, prec["states"], plan_id)
        states = state_from_numpy(rt.plan, prec["states"], job.device,
                                  encoders=prec["encoders"])
        # the lazy ring re-syncs from the restored device ordinal
        # counter: partials carried across the restore decode their lazy
        # columns as None, new matches decode real values
        lazy_base = 0
        if rt.lazy is not None:
            lazy_base = int(np.asarray(
                prec["states"][rt.lazy_state_name]["seen"]))
        job._install_states(rt, states, lazy_base=lazy_base)
        rt.enabled = bool(prec.get("enabled", True))
    job._cycles_since_drain = 0

    # 3. the reorder buffer
    job._pending = {}
    job._pending_t = {}
    schema_of = {}
    for rt in job._plans.values():
        schema_of.update(rt.plan.schemas)
    for sid, blobs in snap["pending"].items():
        job._pending[sid] = [
            EventBatch(
                stream_id=b["stream_id"],
                schema=schema_of.get(sid),
                columns=dict(b["columns"]),
                timestamps=b["timestamps"],
            )
            for b in blobs
        ]
    # ... and the control events still pending behind the watermark
    job._control_pending = list(snap.get("control_pending") or [])

    # 4. source positions
    for i, sd in snap.get("sources", {}).items():
        src = job._sources[int(i)]
        load = getattr(src, "load_state_dict", None)
        if load is not None:
            load(sd)

    # 5. the output-rate limiters' phase (time-mode deadlines re-arm)
    for sid, d in snap.get("rate_limiters", {}).items():
        lim = job._rate_limiters.get(sid)
        if lim is not None:
            lim.count = int(d["count"])
            lim.buf = [tuple(r) for r in d["buf"]]
            lim.cur = {tuple(k): tuple(v) for k, v in d.get("snap", [])}
            lim.deadline = None

    # 6. the flight recorder's journal, LAST before the sinks: it
    # overwrites the entries the restore itself made (the dynamic replay
    # re-runs add_plan, whose control.admit entries reconstruct admits
    # the journal already holds); absent in an older file: a fresh journal
    if snap.get("flightrec"):
        job.flightrec.restore_state(snap["flightrec"])

    # 7. sinks with a state (a rebuilt job may attach fewer: the missing
    # indices are skipped), AFTER the journal: a resumed transaction's
    # commit is a new action of the restored run and extends the journal
    for sid, per in (snap.get("sinks") or {}).items():
        fns = job._sinks.get(sid, [])
        for i, sd in per.items():
            i = int(i)
            if i >= len(fns):
                continue
            load = getattr(fns[i], "load_state_dict", None)
            if load is not None:
                load(sd)


def _leaves(tree, path="") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}[{k!r}]"))
        return out
    return {path: tree}


def _check_compatible(ref, restored, plan_id: str) -> None:
    """The restored state's key paths, shapes and dtypes against the
    running plan's (``ref``, torch tensors)."""
    ref_leaves = _leaves(ref)
    got_leaves = _leaves(restored)
    if set(ref_leaves) != set(got_leaves):
        missing = set(ref_leaves) - set(got_leaves)
        extra = set(got_leaves) - set(ref_leaves)
        raise ValueError(
            f"checkpoint state for plan {plan_id!r} does not match the "
            f"running plan (missing {sorted(missing)[:3]}, "
            f"unexpected {sorted(extra)[:3]}); was the CQL changed?"
        )
    for path, rv in ref_leaves.items():
        gv = np.asarray(got_leaves[path])
        r_shape = tuple(rv.shape)
        r_dtype = str(rv.dtype).replace("torch.", "")
        if gv.shape != r_shape or str(gv.dtype) != r_dtype:
            raise ValueError(
                f"checkpoint state for plan {plan_id!r} leaf {path} has "
                f"shape/dtype {gv.shape}/{gv.dtype} but the running plan "
                f"expects {r_shape}/{r_dtype}; was the CQL (window sizes, "
                "capacities) changed?"
            )


def checkpoint_generations(path: str, keep: int) -> list:
    """The rotation chain, newest first: ``path`` (latest), then
    ``path.1`` .. ``path.<keep-1>`` (older). A crash between the rotation
    renames and the final replace can leave only ``path.1`` on disk."""
    return [path] + [f"{path}.{i}" for i in range(1, max(int(keep), 1))]


def save(job, path: str, keep: int = 1) -> None:
    """Checkpoint ``job`` to ``path`` atomically: the snapshot goes to
    ``path.tmp.<pid>`` (fsynced) and replaces ``path``, so a crash
    mid-write never destroys the previous checkpoint; ``keep > 1``
    rotates the existing generations first (``path`` -> ``path.1`` ->
    ..., the oldest dropped); stale ``path.tmp.*`` files of a writer that
    died are swept after the replace (one writer a path)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    snap = snapshot_job(job)
    with open(tmp, "wb") as f:
        if snap["control_pending"]:
            _EventPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(snap)
        else:
            pickle.dump(snap, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    if keep > 1 and os.path.exists(path):
        gens = checkpoint_generations(path, keep)
        for i in range(len(gens) - 1, 0, -1):
            if os.path.exists(gens[i - 1]):
                os.replace(gens[i - 1], gens[i])
    os.replace(tmp, path)
    for stale in glob.glob(f"{glob.escape(path)}.tmp.*"):
        try:
            os.remove(stale)
            _LOG.warning(
                "swept stale checkpoint temp file %s (a previous "
                "writer crashed mid-save)", stale,
            )
        except OSError:
            pass  # another sweeper removed it first


# ``save`` writes numpy scalars and arrays and builtin containers only, so
# ``load`` admits exactly those and rejects anything else loudly
_SAFE_BUILTINS = {
    "dict", "list", "tuple", "set", "frozenset", "bytes", "bytearray",
    "str", "int", "float", "complex", "bool", "slice", "range",
}
_SAFE_NUMPY = {
    # numpy 2.x pickle globals (and the numpy 1.x module aliases)
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
}


# the control events a snapshot's control_pending holds: written under the
# JAX package's module name, loaded from either package's into this one's
_EVENT_MODULES = ("flink_siddhi_tpu.control.events",
                  "flink_siddhi_tpu_torch.control.events")
_EVENT_CLASSES = ("ControlEvent", "MetadataControlEvent",
                  "OperationControlEvent")


class _EventPickler(pickle._Pickler):
    """A pickler that names this package's control event classes by the
    JAX package's module, so that the JAX package's restore (which admits
    only its own module's events) loads the file too."""

    def save_global(self, obj, name=None):
        from ..control import events

        if (getattr(obj, "__module__", None) == events.__name__
                and obj.__qualname__ in _EVENT_CLASSES):
            self.save(_EVENT_MODULES[0])
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if (module, name) in _SAFE_NUMPY:
            return super().find_class(module, name)
        if module in _EVENT_MODULES and name in _EVENT_CLASSES:
            from ..control import events

            return getattr(events, name)
        raise pickle.UnpicklingError(
            f"checkpoint names {module}.{name}, which is not on the "
            "restore safelist (numpy scalars/arrays, builtin "
            "containers, control events). A checkpoint produced by "
            "save() never contains it — the file is corrupt, from a "
            "different engine version, or hostile."
        )


def safe_load_snapshot(fileobj) -> Dict[str, Any]:
    """Deserialize a checkpoint stream under the safelist."""
    return _CheckpointUnpickler(fileobj).load()


def load(job, path: str) -> None:
    """Restore from ``save``'s file (either package's), read under the
    safelisting unpickler."""
    with open(path, "rb") as f:
        restore_job(job, safe_load_snapshot(f))
