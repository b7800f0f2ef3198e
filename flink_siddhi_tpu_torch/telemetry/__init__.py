"""Host telemetry of the torch port: stage-attributed wall clock, latency
histograms and counters, in one ``MetricsRegistry`` per ``Job``
(``job.telemetry``), with the JAX package's serving layer over it.

``histogram.py``, ``spans.py``, ``registry.py``, ``flightrec.py`` (the
bounded event journal), ``tracing.py`` (per-event trace sampling),
``slo.py`` (the per-tenant SLO watchdog), ``attribution.py`` (the
limiting-leg verdict) and ``prober.py`` (the out-of-process RTT prober)
are exact copies of the JAX package's modules of the same names (they
import neither JAX nor the JAX package; ``tests/test_torch_host.py`` pins
them to their originals). ``compile_events.py`` counts the port's
compiles, CUDA graph captures and kernel builds, where the reference
counts XLA lowerings; ``openmetrics.py`` is the reference's exposition
with a build-info label set of the port's own.

Spans, records, journal entries and trace marks happen on the host at
micro-batch, segment and drain boundaries only, never inside a step or a
captured graph, and read no device tensor.
"""

from .flightrec import FlightRecorder
from .histogram import LatencyHistogram
from .openmetrics import render_openmetrics
from .prober import ProbeReport, SideChannelProber
from .registry import Counter, MetricsRegistry
from .slo import SLOPolicy, SLOWatchdog
from .spans import NULL_SPAN, StageTimes
from .tracing import TraceSampler

# Stage names that partition the RUN-LOOP thread's wall clock (a span
# opened inside another on the same thread accrues under "nested.<name>",
# see spans.StageTimes): the reference's whole tuple, which the leg cover
# of attribution.py must equal. Stages the port never records (the bench's
# set-up stages, "route", "stage.h2d_overlap", "stage.compile",
# "stage.warm", "replay.reset") stay at zero, as the reference's do in a
# mode that does not run them. The drain fetch thread's work
# (device-to-host copies and decode) overlaps this lane and is reported by
# the drain.* histograms instead.
TOP_LEVEL_STAGES = (
    # bench setup
    "input_gen",
    "plan_compile",
    "job_init",
    "prewarm",
    # streaming micro-batch cycle (runtime/executor.py)
    "ingest",
    "reorder",
    "route",
    "tape_build",
    # fused streaming dispatch: the segment upload's host-side enqueue
    "stage.h2d_overlap",
    "dispatch",
    "backpressure_wait",
    "drain",
    # bounded-replay staging (runtime/replay.py)
    "stage.source_pull",
    "stage.h2d",
    "stage.compile",
    "stage.warm",
    "stage.prewarm",
    # bounded-replay execution
    "replay.dispatch",
    "replay.drain",
    "replay.reset",
    # end of stream
    "flush",
)

__all__ = [
    "Counter",
    "FlightRecorder",
    "LatencyHistogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "ProbeReport",
    "SLOPolicy",
    "SLOWatchdog",
    "SideChannelProber",
    "StageTimes",
    "TOP_LEVEL_STAGES",
    "TraceSampler",
    "render_openmetrics",
]
