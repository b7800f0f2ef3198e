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
count/sum/avg/min/max. Everything else raises ``SiddhiQLError`` naming the
later slice;
``flink_siddhi_tpu`` (the JAX package beside this one) is the reference the
port is held against, row for row.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a missing GPU is an error, never a silent CPU run.
Importing the package needs no GPU, no ``nvcc`` and no build: the kernels
compile at their first CUDA use.
"""

from .api.cep import CEPEnvironment, SiddhiCEP
from .api.stream import ExecutionStream, Row
from .compiler.plan import CompiledPlan, compile_plan, state_from_numpy
from .runtime.executor import Job
from .runtime.sources import BatchSource, ListSource, Source
from .schema.batch import EventBatch
from .schema.stream_schema import StreamSchema
from .schema.types import AttributeType

__version__ = "0.1.0"

__all__ = [
    "AttributeType",
    "BatchSource",
    "CEPEnvironment",
    "CompiledPlan",
    "EventBatch",
    "ExecutionStream",
    "Job",
    "ListSource",
    "Row",
    "SiddhiCEP",
    "Source",
    "StreamSchema",
    "compile_plan",
    "state_from_numpy",
]
