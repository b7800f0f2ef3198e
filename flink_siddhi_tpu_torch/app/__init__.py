"""Deployable application layer.

The analog of the reference's ``experimental`` module
(experimental/src/main/scala/...): ``CEPPipeline`` — a config-driven,
restartable ingest -> CEP -> sink job (CEPPipeline.scala:33-78) — and
``QueryControlService`` — the REST query-management API that the
reference only stubbed (CEPService.scala:43-95, all routes ``???``).
"""

from .pipeline import CEPPipeline, PipelineConfig
from .service import ControlQueueSource, QueryControlService

__all__ = [
    "CEPPipeline",
    "PipelineConfig",
    "ControlQueueSource",
    "QueryControlService",
]
