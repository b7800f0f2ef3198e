"""The dynamic query control plane: control events and the runtime
facade (``events.py`` is an exact copy of the JAX package's)."""

from .events import (
    CONTROL_STREAM,
    ControlEvent,
    MetadataControlEvent,
    OperationControlEvent,
    control_event_from_json,
    control_event_to_json,
)
from .plane import AdmissionGate, ControlPlane, ControlRejected

__all__ = [
    "AdmissionGate",
    "CONTROL_STREAM",
    "ControlEvent",
    "ControlPlane",
    "ControlRejected",
    "MetadataControlEvent",
    "OperationControlEvent",
    "control_event_from_json",
    "control_event_to_json",
]
