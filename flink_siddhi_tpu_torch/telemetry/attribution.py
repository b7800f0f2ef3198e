"""Measured limiting-leg attribution: the bench's "limiting leg" as a
derived, gated number instead of a hand-written opinion.

The telemetry subsystem already attributes >= 95% of the run-loop
thread's wall clock to named stages (``TOP_LEVEL_STAGES``, enforced by
the bench ``stage_breakdown`` contract). This module folds those
stages into a small, fixed **leg cover** — the vocabulary a bottleneck
verdict is stated in — computes each leg's share of measured
wall-clock, and names the argmax. Karimov et al. (PAPERS.md #4)
demand that a reported throughput be backed by attributable
measurement; this is the attribution.

Leg cover (every ``TOP_LEVEL_STAGES`` name maps to exactly ONE leg —
checked at import, so a new stage cannot silently fall out of the
verdict):

* ``setup``          — bench/job setup + compile/warm work off the
                       steady state (input_gen, plan_compile,
                       job_init, prewarm, stage.compile, stage.warm,
                       stage.prewarm, and the measurement harness's
                       inter-run replay.reset);
* ``host_staging``   — CPU-side event work: source pull, reorder,
                       routing, wire-tape build;
* ``h2d``            — host->device staging transfers (the async
                       segment device_put's host-side enqueue, and
                       the replay's bulk stage.h2d);
* ``dispatch``       — device-call enqueue (streaming ``dispatch``,
                       replay ``replay.dispatch``; on a synchronous
                       lane — XLA:CPU — the compute retires inside
                       this call, so dispatch absorbs device time
                       there);
* ``device_compute`` — host wall-clock provably spent WAITING on
                       in-flight device work (``backpressure_wait``).
                       A host-side ledger cannot see the device's own
                       clock; what it can measure honestly is the
                       time the host had nothing to do but wait;
* ``drain_fetch``    — result readiness/fetch: drain polling +
                       end-of-stream flush.

Two **overlapped** legs ride along for drill-down but stay OUTSIDE
the coverage sum (their wall-clock runs concurrently with the
run-loop lane, mostly on the drain fetch thread, so adding them would
double-count elapsed time):

* ``decode``         — device-buffer -> typed host rows/columns
                       (mass of the ``drain.decode`` histogram);
* ``sink``           — user-sink delivery (the ``sink``/
                       ``nested.sink`` spans).

Verdict: ``limiting_leg`` is the argmax over the NON-overlapped legs
excluding ``setup`` (setup is real wall-clock — it stays in the
coverage arithmetic — but a one-off compile dominating a short run is
not a steady-state bottleneck; its share is still printed).
``scripts/check_bench_schema.py`` re-derives both the coverage and the
argmax from the published per-leg seconds, so a declared verdict
cannot contradict its own numbers.
"""

from __future__ import annotations

from typing import Dict, Optional

# leg -> the TOP_LEVEL_STAGES names it covers (exhaustive + disjoint;
# asserted below). One mapping serves all modes: a mode simply leaves
# the stages it never runs at zero.
LEG_STAGES: Dict[str, tuple] = {
    "setup": (
        "input_gen",
        "plan_compile",
        "job_init",
        "prewarm",
        "stage.compile",
        "stage.warm",
        "stage.prewarm",
        "replay.reset",
    ),
    "host_staging": (
        "ingest",
        "reorder",
        "route",
        "tape_build",
        "stage.source_pull",
    ),
    "h2d": ("stage.h2d_overlap", "stage.h2d"),
    "dispatch": ("dispatch", "replay.dispatch"),
    "device_compute": ("backpressure_wait",),
    "drain_fetch": ("drain", "replay.drain", "flush"),
}

# overlapped (fetch-lane) legs: reported, never summed into coverage
OVERLAPPED_LEGS = ("decode", "sink")

# legs eligible to be NAMED limiting: steady-state, run-loop-lane
CANDIDATE_LEGS = (
    "host_staging",
    "h2d",
    "dispatch",
    "device_compute",
    "drain_fetch",
)


def _check_cover() -> None:
    from . import TOP_LEVEL_STAGES

    mapped = [s for stages in LEG_STAGES.values() for s in stages]
    assert len(mapped) == len(set(mapped)), "leg cover overlaps"
    assert set(mapped) == set(TOP_LEVEL_STAGES), (
        "leg cover out of sync with TOP_LEVEL_STAGES: "
        f"unmapped={sorted(set(TOP_LEVEL_STAGES) - set(mapped))} "
        f"unknown={sorted(set(mapped) - set(TOP_LEVEL_STAGES))}"
    )


def _hist_mass_s(hist_snapshot: Optional[dict]) -> float:
    """Total seconds represented by one LatencyHistogram snapshot
    (mean * count; the histogram records per-drain decode seconds)."""
    if not isinstance(hist_snapshot, dict):
        return 0.0
    count = hist_snapshot.get("count") or 0
    mean_ms = hist_snapshot.get("mean_ms")
    if not count or not isinstance(mean_ms, (int, float)):
        return 0.0
    return float(mean_ms) * int(count) / 1e3


def limiting_leg(
    stages: Dict[str, dict],
    elapsed_s: Optional[float] = None,
    mode: str = "streaming",
    histograms: Optional[Dict[str, dict]] = None,
) -> dict:
    """Fold a ``StageTimes.snapshot()`` into the leg cover and name
    the limiting leg.

    ``elapsed_s`` is the measured wall-clock window the shares are
    stated against (the bench passes each mode's build..flush window;
    coverage >= 0.95 is the gated honesty contract). When None — the
    live ``Job.metrics()["attribution"]`` view, where no external
    window exists — shares are stated against the attributed total
    and coverage is 1.0 by construction.

    ``histograms`` (a registry snapshot's ``histograms`` map) feeds
    the overlapped ``decode`` leg from ``drain.decode``.
    """
    _check_cover()
    leg_seconds: Dict[str, float] = {}
    leg_stages_seen: Dict[str, list] = {}
    for leg, names in LEG_STAGES.items():
        total = 0.0
        seen = []
        for name in names:
            d = stages.get(name)
            if not isinstance(d, dict):
                continue
            s = float(d.get("seconds", 0.0))
            if s > 0.0:
                total += s
                seen.append(name)
        leg_seconds[leg] = total
        leg_stages_seen[leg] = seen
    attributed = sum(leg_seconds.values())
    denom = float(elapsed_s) if elapsed_s else attributed
    denom = max(denom, 1e-9)

    def share(s: float) -> float:
        return round(s / denom, 4)

    legs = {
        leg: {
            "seconds": round(s, 4),
            "share": share(s),
            "overlapped": False,
            "stages": leg_stages_seen[leg],
        }
        for leg, s in leg_seconds.items()
    }
    # overlapped fetch-lane legs: decode from the drain.decode
    # histogram's mass, sink from its spans (run wherever the sinks
    # run; nested.sink when delivery happens inside a drain span)
    decode_s = _hist_mass_s((histograms or {}).get("drain.decode"))
    sink_s = sum(
        float(stages.get(n, {}).get("seconds", 0.0))
        for n in ("sink", "nested.sink")
    )
    legs["decode"] = {
        "seconds": round(decode_s, 4),
        "share": share(decode_s),
        "overlapped": True,
        "stages": ["drain.decode (histogram mass)"],
    }
    legs["sink"] = {
        "seconds": round(sink_s, 4),
        "share": share(sink_s),
        "overlapped": True,
        "stages": ["sink", "nested.sink"],
    }
    name = max(CANDIDATE_LEGS, key=lambda leg: leg_seconds[leg])
    return {
        "mode": str(mode),
        "elapsed_s": round(denom, 4),
        "coverage": round(attributed / denom, 4),
        "legs": legs,
        "limiting_leg": name,
        "limiting_share": share(leg_seconds[name]),
        "basis": (
            "run-loop StageTimes folded into the leg cover "
            "(telemetry/attribution.py); argmax over "
            + "/".join(CANDIDATE_LEGS)
            + "; setup + overlapped legs reported, not named"
        ),
    }


def render_verdict(att: dict) -> str:
    """One human line per mode (bench prints this to stderr so
    BASELINE.md's limiting-leg column is a copy, not an opinion)."""
    legs = att.get("legs", {})
    parts = ", ".join(
        f"{leg} {legs[leg]['share']:.0%}"
        for leg in CANDIDATE_LEGS
        if leg in legs
    )
    return (
        f"LIMITING LEG ({att.get('mode')}): {att.get('limiting_leg')} "
        f"at {att.get('limiting_share', 0):.0%} of wall-clock "
        f"[{parts}; coverage {att.get('coverage', 0):.1%}]"
    )
