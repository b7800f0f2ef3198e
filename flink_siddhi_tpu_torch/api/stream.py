"""Fluent stream builders and typed output adapters.

Parity map (SiddhiStream.java):
* ``SingleStream`` / ``UnionStream``  -> SingleSiddhiStream / UnionSiddhiStream
  (:199-257)
* ``.cql(plan)``                      -> ExecutableStream.cql (:116-119)
* ``ExecutionStream.returns``         -> returns(outStreamId) (:287-291)
* ``.return_as_map``                  -> returnAsMap -> GenericRecord (:328-352)
* ``.return_as_row``                  -> returnAsRow (:354-367)
* ``.returns_pojo(cls)``              -> returns(POJO class) (:375-391)

The job underlying an ExecutionStream is created exactly once and reused by
every typed adapter (the reference memoizes the operator DataStream the same
way, SiddhiStream.java:421-432). It runs on the environment's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Type

from ..compiler.plan import CompiledPlan, compile_plan
from ..query.lexer import SiddhiQLError
from ..runtime.executor import Job


class Row(tuple):
    """Positional output row (Flink Row analog)."""

    def __repr__(self) -> str:
        return "Row(" + ", ".join(repr(v) for v in self) + ")"


class _StreamBase:
    def __init__(self, env, stream_ids: List[str]):
        self.env = env
        self.stream_ids = list(stream_ids)

    def cql(self, plan: str, plan_id: str = "plan") -> "ExecutionStream":
        """``cql("from ... insert into ...")`` binds one plan
        (ExecutableStream.cql(String), SiddhiStream.java:116-119)."""
        if not isinstance(plan, str):
            raise SiddhiQLError(
                "control-event driven plans are not in the torch port yet "
                "(ROADMAP.md Queue 1 item 10); pass the plan's CQL text"
            )
        return ExecutionStream(self.env, self.stream_ids, plan, plan_id)


class SingleStream(_StreamBase):
    def __init__(self, env, stream_id: str):
        super().__init__(env, [stream_id])

    def union(
        self,
        stream_id: str,
        source,
        fields: Optional[Sequence[str]] = None,
        types: Optional[Sequence[Any]] = None,
    ) -> "UnionStream":
        """SiddhiCEP.union parity (SiddhiCEP.java:161-165)."""
        self.env.register_stream(stream_id, source, fields, types)
        return UnionStream(self.env, self.stream_ids + [stream_id])


class UnionStream(_StreamBase):
    def union(
        self,
        stream_id: str,
        source,
        fields: Optional[Sequence[str]] = None,
        types: Optional[Sequence[Any]] = None,
    ) -> "UnionStream":
        self.env.register_stream(stream_id, source, fields, types)
        self.stream_ids.append(stream_id)
        return self


class ExecutionStream:
    """A compiled plan bound to its input streams, with typed outputs."""

    def __init__(self, env, stream_ids, plan_text: str, plan_id: str):
        self.env = env
        self.stream_ids = list(stream_ids)
        self.plan_text = plan_text
        self.plan: CompiledPlan = compile_plan(
            plan_text,
            {sid: env.get_schema(sid) for sid in stream_ids},
            extensions=env.extensions,
            plan_id=plan_id,
        )
        self._job: Optional[Job] = None

    @property
    def job(self) -> Job:
        if self._job is None:
            missing = [
                sid
                for sid in self.plan.input_stream_ids
                if sid not in self.env.sources
            ]
            if missing:
                raise RuntimeError(
                    f"streams {missing} have schemas but no sources"
                )
            self._job = Job(
                [self.plan],
                [self.env.sources[sid] for sid in self.plan.input_stream_ids],
                batch_size=self.env.batch_size,
                time_mode=self.env.time_mode,
                device=self.env.device,
            )
        return self._job

    def execute(self) -> Job:
        """Run all finite sources to completion (env.execute analog)."""
        job = self.job
        job.run()
        return job

    # -- typed outputs -------------------------------------------------------
    def returns(self, output_stream: str) -> List[tuple]:
        """Tuples in select-clause order (returns(String) parity)."""
        self.execute()
        return self.job.results(output_stream)

    def return_as_map(self, output_stream: str) -> List[Dict[str, Any]]:
        self.execute()
        fields = self._fields(output_stream)
        return [
            dict(zip(fields, row)) for row in self.job.results(output_stream)
        ]

    def return_as_row(self, output_stream: str) -> List[Row]:
        self.execute()
        return [Row(r) for r in self.job.results(output_stream)]

    def returns_pojo(self, output_stream: str, cls: Type) -> List[Any]:
        self.execute()
        fields = self._fields(output_stream)
        return [
            cls(**dict(zip(fields, row)))
            for row in self.job.results(output_stream)
        ]

    def _fields(self, output_stream: str) -> List[str]:
        schemas = self.plan.output_streams().get(output_stream)
        if schemas:
            return schemas[0].field_names
        raise KeyError(
            f"plan has no query inserting into {output_stream!r}"
        )
