"""Deployable application layer.

The analog of the reference's ``experimental`` module
(experimental/src/main/scala/...): ``CEPPipeline`` — a config-driven,
restartable ingest -> CEP -> sink job (CEPPipeline.scala:33-78). The REST
query-management service (the reference's ``app/service.py``) is built on
the control plane and waits for it (ROADMAP.md Queue 1 item 10).
"""

from .pipeline import CEPPipeline, PipelineConfig

__all__ = ["CEPPipeline", "PipelineConfig"]
