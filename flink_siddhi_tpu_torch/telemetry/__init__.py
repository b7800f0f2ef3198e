"""Host telemetry of the torch port: stage-attributed wall clock, latency
histograms and counters, in one ``MetricsRegistry`` per ``Job``
(``job.telemetry``).

``histogram.py``, ``spans.py`` and ``registry.py`` are exact copies of the
JAX package's modules of the same names (they import neither JAX nor the
JAX package; ``tests/test_torch_host.py`` pins them to their originals).
Spans and records happen on the host at micro-batch, segment and drain
boundaries only, never inside a step or a captured graph.
"""

from .histogram import LatencyHistogram
from .registry import Counter, MetricsRegistry
from .spans import NULL_SPAN, StageTimes

# Stage names that partition the RUN-LOOP thread's wall clock (a span
# opened inside another on the same thread accrues under "nested.<name>",
# see spans.StageTimes): the ones the port records. The drain fetch
# thread's work (device-to-host copies and decode) overlaps this lane and
# is reported by the drain.* histograms instead.
TOP_LEVEL_STAGES = (
    # streaming micro-batch cycle (runtime/executor.py)
    "ingest",
    "reorder",
    "tape_build",
    "dispatch",
    "backpressure_wait",
    "drain",
    # bounded-replay staging (runtime/replay.py)
    "stage.source_pull",
    "stage.h2d",
    "stage.prewarm",
    # bounded-replay execution
    "replay.dispatch",
    "replay.drain",
    # end of stream
    "flush",
)

__all__ = [
    "Counter",
    "LatencyHistogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "StageTimes",
    "TOP_LEVEL_STAGES",
]
