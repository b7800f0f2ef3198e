"""Attribute types and the host/device dtype bridge.

Mirrors the bidirectional Java<->Siddhi type table of the reference
(utils/SiddhiTypeFactory.java:42-62) but maps onto device dtypes: the engine is
columnar, so every attribute of every event lives in a device array.

Device representation choices (TPU v5e has no f64 and we keep jax_enable_x64 off):

==========  =============  ====================================================
Attribute   device dtype   notes
==========  =============  ====================================================
STRING      int32          dictionary code into a host-side ``StringTable``
INT         int32
LONG        int32          host keeps int64; device arithmetic is 32-bit
FLOAT       float32
DOUBLE      float32        TPU-native choice; f64 unsupported on v5e MXU/VPU
BOOL        bool
OBJECT      int32          index into a host-side payload list (device sees key)
==========  =============  ====================================================

Timestamps are **int32 milliseconds relative to a per-job epoch** managed by the
host runtime (reference carries Java long epoch millis end-to-end,
operator/AbstractSiddhiOperator.java:209-233); the runtime rebases the epoch so
stream-time spans beyond ~24 days do not overflow.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np


class AttributeType(enum.Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    BOOL = "bool"
    OBJECT = "object"

    @property
    def device_dtype(self) -> np.dtype:
        return _DEVICE_DTYPE[self]

    @property
    def host_dtype(self) -> np.dtype:
        return _HOST_DTYPE[self]

    @property
    def is_numeric(self) -> bool:
        return self in (
            AttributeType.INT,
            AttributeType.LONG,
            AttributeType.FLOAT,
            AttributeType.DOUBLE,
        )

    @property
    def is_encoded(self) -> bool:
        """True when the device column holds a dictionary code, not the value."""
        return self in (AttributeType.STRING, AttributeType.OBJECT)


_DEVICE_DTYPE = {
    AttributeType.STRING: np.dtype(np.int32),
    AttributeType.INT: np.dtype(np.int32),
    AttributeType.LONG: np.dtype(np.int32),
    AttributeType.FLOAT: np.dtype(np.float32),
    AttributeType.DOUBLE: np.dtype(np.float32),
    AttributeType.BOOL: np.dtype(np.bool_),
    AttributeType.OBJECT: np.dtype(np.int32),
}

_HOST_DTYPE = {
    AttributeType.STRING: np.dtype(object),
    AttributeType.INT: np.dtype(np.int32),
    AttributeType.LONG: np.dtype(np.int64),
    AttributeType.FLOAT: np.dtype(np.float32),
    AttributeType.DOUBLE: np.dtype(np.float64),
    AttributeType.BOOL: np.dtype(np.bool_),
    AttributeType.OBJECT: np.dtype(object),
}

# Python-type inference for schema-less registration (reference infers from
# Flink TypeInformation, schema/StreamSchema.java:65-87).
_PY_TYPE_MAP = {
    str: AttributeType.STRING,
    int: AttributeType.LONG,
    float: AttributeType.DOUBLE,
    bool: AttributeType.BOOL,
}

_NAME_ALIASES = {
    "string": AttributeType.STRING,
    "str": AttributeType.STRING,
    "int": AttributeType.INT,
    "integer": AttributeType.INT,
    "long": AttributeType.LONG,
    "float": AttributeType.FLOAT,
    "double": AttributeType.DOUBLE,
    "bool": AttributeType.BOOL,
    "boolean": AttributeType.BOOL,
    "object": AttributeType.OBJECT,
}


def attribute_type_of(spec: Any) -> AttributeType:
    """Coerce a user-facing type spec (AttributeType | str | python type | numpy
    dtype) to an AttributeType."""
    if isinstance(spec, AttributeType):
        return spec
    if isinstance(spec, str):
        try:
            return _NAME_ALIASES[spec.lower()]
        except KeyError:
            raise ValueError(f"unknown attribute type name: {spec!r}") from None
    if isinstance(spec, type) and spec in _PY_TYPE_MAP:
        return _PY_TYPE_MAP[spec]
    try:
        dt = np.dtype(spec)
    except TypeError:
        raise ValueError(f"cannot map {spec!r} to an AttributeType") from None
    if dt.kind == "b":
        return AttributeType.BOOL
    if dt.kind in "iu":
        return AttributeType.LONG if dt.itemsize > 4 else AttributeType.INT
    if dt.kind == "f":
        return AttributeType.DOUBLE if dt.itemsize > 4 else AttributeType.FLOAT
    if dt.kind in "US":
        return AttributeType.STRING
    return AttributeType.OBJECT


def infer_attribute_type(value: Any) -> AttributeType:
    """Infer from a sample value (used by schema-less ``register_stream``)."""
    if isinstance(value, bool):
        return AttributeType.BOOL
    if isinstance(value, (int, np.integer)):
        return AttributeType.LONG
    if isinstance(value, (float, np.floating)):
        return AttributeType.DOUBLE
    if isinstance(value, str):
        return AttributeType.STRING
    return AttributeType.OBJECT
