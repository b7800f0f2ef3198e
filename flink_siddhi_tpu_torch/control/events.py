"""Dynamic query control-plane events.

Parity with the reference control plane (control/ControlEvent.java:23-49,
control/MetadataControlEvent.java:26-104, control/OperationControlEvent.java:
20-60, control/ControlMessage.java + ControlEventSchema.java wire format):
queries can be added, updated, deleted, enabled (resumed) and disabled
(paused) while the engine runs. Control events ride the reserved stream
``_internal_control_stream`` and are broadcast to every shard.

The JSON wire format deliberately does NOT rehydrate arbitrary class names
(the reference's ``Class.forName`` on attacker-controlled input,
ControlEventSchema.java:30-41, is an unsafe pattern); a closed two-entry type
registry is used instead.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, Optional

# Reserved stream id (parity: ControlEvent.DEFAULT_INTERNAL_CONTROL_STREAM,
# control/ControlEvent.java:24).
CONTROL_STREAM = "_internal_control_stream"


@dataclass
class ControlEvent:
    created_ms: int = field(
        default_factory=lambda: int(time.time() * 1000)
    )
    expired_ms: Optional[int] = None
    # multi-tenant attribution: which tenant issued this mutation. Pure
    # metadata — admission budgets are enforced per event via the
    # carried verdicts, but rejections/status report by tenant so one
    # tenant's refused add is attributable without log-diving
    tenant: Optional[str] = None


@dataclass
class MetadataControlEvent(ControlEvent):
    """Add / update / delete execution plans at runtime
    (MetadataControlEvent.java:26-56 + Builder :67-104).

    ``admission`` optionally carries the admission-time analysis
    verdict per added/updated plan id (``AdmissionReport.summary()``,
    analysis/admit.py): the JSON-safe resource envelope — shape-bucket
    signature (the AOT-cache key), worst-case state/accumulator bytes,
    amplification, residency, and any ADM findings. A verdict with
    ``admitted=False`` makes the executor REFUSE the add/update instead
    of compiling a plan the admission gate already rejected (the
    control-plane groundwork for ROADMAP direction #1)."""

    added_plans: Dict[str, str] = field(default_factory=dict)       # id -> cql
    updated_plans: Dict[str, str] = field(default_factory=dict)     # id -> cql
    deleted_plan_ids: tuple = ()
    admission: Dict[str, dict] = field(default_factory=dict)  # id -> summary

    @staticmethod
    def new_plan_id() -> str:
        return str(uuid.uuid4())

    class Builder:
        def __init__(self) -> None:
            self._added: Dict[str, str] = {}
            self._updated: Dict[str, str] = {}
            self._deleted: list = []
            self._admission: Dict[str, dict] = {}

        def add_execution_plan(
            self,
            cql: str,
            admission: Optional[dict] = None,
            plan_id: Optional[str] = None,
        ) -> str:
            """``plan_id=None`` mints a fresh uuid (the reference's
            Builder behavior); the control plane passes an explicit id
            so REST callers learn it before the event applies."""
            plan_id = plan_id or MetadataControlEvent.new_plan_id()
            self._added[plan_id] = cql
            if admission is not None:
                self._admission[plan_id] = dict(admission)
            return plan_id

        def update_execution_plan(self, plan_id: str, cql: str) -> "MetadataControlEvent.Builder":
            self._updated[plan_id] = cql
            return self

        def remove_execution_plan(self, plan_id: str) -> "MetadataControlEvent.Builder":
            self._deleted.append(plan_id)
            return self

        def with_admission(
            self, plan_id: str, summary: dict
        ) -> "MetadataControlEvent.Builder":
            """Attach an admission verdict (AdmissionReport.summary())
            to an added/updated plan id."""
            self._admission[plan_id] = dict(summary)
            return self

        def build(self) -> "MetadataControlEvent":
            return MetadataControlEvent(
                added_plans=dict(self._added),
                updated_plans=dict(self._updated),
                deleted_plan_ids=tuple(self._deleted),
                admission=dict(self._admission),
            )

    @staticmethod
    def builder() -> "MetadataControlEvent.Builder":
        return MetadataControlEvent.Builder()


@dataclass
class OperationControlEvent(ControlEvent):
    """Enable (resume) / disable (pause) one query by plan id
    (OperationControlEvent.java:47-54)."""

    action: str = "enable"  # 'enable' | 'disable'
    plan_id: str = ""

    @staticmethod
    def enable_query(plan_id: str) -> "OperationControlEvent":
        return OperationControlEvent(action="enable", plan_id=plan_id)

    @staticmethod
    def disable_query(plan_id: str) -> "OperationControlEvent":
        return OperationControlEvent(action="disable", plan_id=plan_id)


# --------------------------------------------------------------------------
# JSON wire format (ControlMessage analog; closed type registry)
# --------------------------------------------------------------------------

def control_event_to_json(ev: ControlEvent) -> str:
    if isinstance(ev, MetadataControlEvent):
        payload = {
            "type": "metadata",
            "added": ev.added_plans,
            "updated": ev.updated_plans,
            "deleted": list(ev.deleted_plan_ids),
        }
        if ev.admission:
            payload["admission"] = ev.admission
    elif isinstance(ev, OperationControlEvent):
        payload = {
            "type": "operation",
            "action": ev.action,
            "plan_id": ev.plan_id,
        }
    else:
        raise TypeError(f"unknown control event {type(ev)}")
    payload["created_ms"] = ev.created_ms
    if ev.expired_ms is not None:
        payload["expired_ms"] = ev.expired_ms
    if ev.tenant is not None:
        payload["tenant"] = ev.tenant
    return json.dumps(payload)


def control_event_from_json(text: str) -> ControlEvent:
    obj = json.loads(text)
    kind = obj.get("type")
    if kind == "metadata":
        ev: ControlEvent = MetadataControlEvent(
            added_plans=dict(obj.get("added", {})),
            updated_plans=dict(obj.get("updated", {})),
            deleted_plan_ids=tuple(obj.get("deleted", ())),
            admission=dict(obj.get("admission", {})),
        )
    elif kind == "operation":
        ev = OperationControlEvent(
            action=obj["action"], plan_id=obj["plan_id"]
        )
    else:
        raise ValueError(f"unknown control event type {kind!r}")
    if "created_ms" in obj:
        ev.created_ms = obj["created_ms"]
    ev.expired_ms = obj.get("expired_ms")
    ev.tenant = obj.get("tenant")
    return ev
