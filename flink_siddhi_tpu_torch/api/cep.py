"""The fluent user API: define / union / cql / returns.

Parity with the reference entry points (SiddhiCEP.java:119-230,
SiddhiStream.java:53-258): a CEP environment is a registry of
streamId -> (schema, source) plus an extension registry; ``define``/``union``
build the stream set a query binds to; ``cql`` compiles a plan and yields an
``ExecutionStream`` with typed output adapters.

Differences by design: streams here are pull-based sources feeding a
micro-batch executor (no Flink DataStream graph), and ``register_extension``
takes a torch callable instead of a FunctionExecutor class
(SiddhiCEP.java:201-206). The environment names the device its jobs run on:
``device=None`` means the CUDA device, and is an error where there is none.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Union

from ..device import DeviceLike, resolve_device
from ..extensions.registry import ExtensionRegistry, builtin_registry
from ..query.lexer import SiddhiQLError
from ..runtime.sources import ListSource, Source
from ..schema.strings import StringTable
from ..schema.stream_schema import StreamSchema, schema_from_sample
from .stream import SingleStream


class DuplicatedStreamError(RuntimeError):
    """Parity: exception/DuplicatedStreamException.java:20-23."""


class UndefinedStreamError(RuntimeError):
    """Parity: exception/UndefinedStreamException.java:20-23."""


class CEPEnvironment:
    """Registry of streams, schemas and extensions (SiddhiCEP analog)."""

    def __init__(self, time_mode: str = "event", batch_size: int = 4096,
                 device: DeviceLike = None):
        self.time_mode = time_mode
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.schemas: Dict[str, StreamSchema] = {}
        self.sources: Dict[str, Source] = {}
        self.extensions: ExtensionRegistry = builtin_registry().child()
        # one shared dictionary => cross-stream string compares are sound
        self.shared_strings = StringTable()

    # -- registration (SiddhiCEP.registerStream, :174-185) -------------------
    def register_stream(
        self,
        stream_id: str,
        source: Union[Source, Iterable[Any]],
        fields: Optional[Sequence[str]] = None,
        types: Optional[Sequence[Any]] = None,
        ts_field: str = "timestamp",
    ) -> None:
        if stream_id in self.schemas:
            raise DuplicatedStreamError(
                f"The stream {stream_id!r} is already registered"
            )
        if isinstance(source, Source):
            self.schemas[stream_id] = source.schema
            self.sources[stream_id] = source
            return
        records = list(source)
        if fields is None:
            raise SiddhiQLError(
                f"field names required to register stream {stream_id!r} "
                "from raw records"
            )
        if types is not None:
            schema = StreamSchema(
                list(zip(fields, types)),
                shared_strings=self.shared_strings,
            )
        else:
            if not records:
                raise SiddhiQLError(
                    f"cannot infer types for empty stream {stream_id!r}; "
                    "pass types="
                )
            inferred = schema_from_sample(records[0], fields)
            schema = StreamSchema(
                list(zip(inferred.field_names, inferred.field_types)),
                shared_strings=self.shared_strings,
            )
        self.schemas[stream_id] = schema
        self.sources[stream_id] = ListSource(
            stream_id,
            schema,
            records,
            ts_field=ts_field if ts_field in schema else None,
        )

    def get_schema(self, stream_id: str) -> StreamSchema:
        try:
            return self.schemas[stream_id]
        except KeyError:
            raise UndefinedStreamError(
                f"The stream {stream_id!r} is not registered"
            ) from None

    # -- extensions (SiddhiCEP.registerExtension, :201-206) ------------------
    def register_extension(
        self,
        name: str,
        fn: Callable,
        return_type: Any = None,
    ) -> None:
        self.extensions.register(name, fn, return_type)


class SiddhiCEP:
    """Static-style entry points mirroring the reference's fluent API."""

    @staticmethod
    def environment(**kwargs) -> CEPEnvironment:
        return CEPEnvironment(**kwargs)

    @staticmethod
    def define(
        stream_id: str,
        source: Union[Source, Iterable[Any]],
        fields: Optional[Sequence[str]] = None,
        types: Optional[Sequence[Any]] = None,
        env: Optional[CEPEnvironment] = None,
        **env_kwargs,
    ) -> SingleStream:
        """``SiddhiCEP.define(streamId, stream, fieldNames...)`` parity
        (SiddhiCEP.java:119-125)."""
        environment = env or CEPEnvironment(**env_kwargs)
        environment.register_stream(stream_id, source, fields, types)
        return SingleStream(environment, stream_id)
