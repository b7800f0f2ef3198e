from .types import AttributeType
from .stream_schema import StreamSchema
from .strings import StringTable
from .batch import EventBatch

__all__ = ["AttributeType", "StreamSchema", "StringTable", "EventBatch"]
