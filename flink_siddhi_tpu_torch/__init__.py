"""flink_siddhi_tpu_torch — the PyTorch/CUDA port of flink_siddhi_tpu.

The same SiddhiQL engine, run by PyTorch on an NVIDIA GPU (the target is
one H100) instead of JAX on a TPU: queries compile to dense artifacts — a
masked filter/projection pass, the chain pattern matcher, the unique
window's slot table — that advance a whole columnar micro-batch per step,
with the hot scans as hand-written CUDA kernels (``compiler/cuda_ops.py``,
``csrc/``).

The port goes slice by slice; this package holds the filter/projection
path (also over a window), chain patterns (``every``, ``within``,
mid-chain and timed absence) and ``#window.unique(attr)`` with
count/sum/avg/min/max, driven by the streaming ``Job`` or, over a bounded
stream staged on the device beforehand, by ``ResidentReplay``; with
``EngineConfig(lazy_projection=True, pred_pushdown=True)`` (the bench's
settings) a plan of one select or one chain ships only packed predicate
bits and the columns the device needs. The runtime has the reference's
event time (watermark strategies, late policies, idle sources), output
rate limiting, checkpoints in the reference's format and the supervisor;
its ingestion (JSON-lines, CSV and socket sources on the native column
decoder, a Kafka wire-protocol source and transactional sink) and
``CEPPipeline``, the deployable job, are the reference's own host code.
The dynamic control plane (``control/``: control events, runtime admit,
update, retire and enable at epoch boundaries, template-able chain
queries folded into padded ``DynamicChainGroup`` slots as data writes,
``ControlPlane`` and the REST ``QueryControlService``) runs in the
streaming ``Job``, its fused mode and ``ResidentReplay``, with the
reference's plan verifier and admission analysis (``analysis/``:
``verify_plan``, ``analyze_plan``, ``AdmissionBudgets``, the
``AdmissionGate`` at the REST boundary and at apply time) and its subplan
sharing (``Job.share_subplans``: tenants with one filter prefix share a
producer host whose rows loop back into their suffixes), with the
reference's serving telemetry (``telemetry/``: the flight recorder,
per-event trace sampling, SLOs, per-plan attribution, OpenMetrics).
Everything else raises ``SiddhiQLError`` naming the later slice;
``flink_siddhi_tpu`` (the JAX package beside this one) is the reference the
port is held against, row for row.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a missing GPU is an error, never a silent CPU run.
Importing the package needs no GPU, no ``nvcc`` and no build: the kernels
compile at their first CUDA use.
"""

from .api.cep import CEPEnvironment, SiddhiCEP
from .api.stream import DynamicExecutionStream, ExecutionStream, Row
from .compiler.config import EngineConfig
from .compiler.plan import CompiledPlan, compile_plan, state_from_numpy
from .runtime.executor import ColumnarSink, Job, late_stream
from .runtime.replay import ResidentReplay
from .runtime.sources import (
    BatchSource,
    BoundedDisorderWatermark,
    CallbackSource,
    ControlListSource,
    CsvSource,
    JsonLinesSource,
    ListSource,
    PunctuatedWatermark,
    ReplayBatchSource,
    SocketLineSource,
    Source,
    WatermarkStrategy,
    WatermarkedSource,
    with_watermarks,
)
from .runtime.supervisor import RestartBudgetExceeded, Supervisor
from .schema.batch import EventBatch
from .schema.stream_schema import StreamSchema
from .schema.types import AttributeType
from .app.pipeline import CEPPipeline, PipelineConfig
from .app.service import ControlQueueSource, QueryControlService
from .control.events import (
    CONTROL_STREAM,
    ControlEvent,
    MetadataControlEvent,
    OperationControlEvent,
)
from .control.plane import AdmissionGate, ControlPlane, ControlRejected

__version__ = "0.1.0"

__all__ = [
    "AttributeType",
    "BatchSource",
    "BoundedDisorderWatermark",
    "CEPEnvironment",
    "CEPPipeline",
    "CallbackSource",
    "CONTROL_STREAM",
    "AdmissionGate",
    "ControlEvent",
    "ControlListSource",
    "ControlPlane",
    "ControlQueueSource",
    "ControlRejected",
    "DynamicExecutionStream",
    "MetadataControlEvent",
    "OperationControlEvent",
    "QueryControlService",
    "ColumnarSink",
    "CompiledPlan",
    "CsvSource",
    "EngineConfig",
    "EventBatch",
    "ExecutionStream",
    "Job",
    "JsonLinesSource",
    "ListSource",
    "PipelineConfig",
    "PunctuatedWatermark",
    "ReplayBatchSource",
    "ResidentReplay",
    "RestartBudgetExceeded",
    "Row",
    "SiddhiCEP",
    "SocketLineSource",
    "Source",
    "StreamSchema",
    "Supervisor",
    "WatermarkStrategy",
    "WatermarkedSource",
    "compile_plan",
    "late_stream",
    "state_from_numpy",
    "with_watermarks",
]
