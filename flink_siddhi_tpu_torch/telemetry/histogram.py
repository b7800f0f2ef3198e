"""Log-bucketed (HDR-style) latency histogram with bounded memory.

The scheme is the HdrHistogram one (Tene, hdrhistogram.org; PAPERS.md):
values are integers in a fixed unit (microseconds here); the bucket
index space is one linear region for small values followed by octave
buckets of ``2**(sub_bucket_bits - 1)`` linear sub-buckets each, so the
worst-case relative quantization error is ``2**-(sub_bucket_bits)`` of
the value — sub_bucket_bits=7 gives <0.8% — while the whole count array
stays a few KB of int64 regardless of how many samples are recorded.

Properties the rest of the subsystem builds on:

* ``record_many`` is one vectorized numpy pass (``np.add.at``), so
  feeding thousands of samples costs microseconds;
* two histograms with the same geometry ``merge`` by adding count
  arrays — the cross-shard / cross-process aggregation primitive
  (associative + commutative, tested in tests/test_telemetry.py);
* ``percentile`` answers p50/p99/p99.9 by cumulative-sum walk — exact
  to one bucket, i.e. within the quantization bound above;
* all mutators and readers take the instance lock, so a metrics
  reader thread can snapshot while the run loop records.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Sequence

import numpy as np


class LatencyHistogram:
    """Fixed-size log-bucketed histogram over non-negative int values.

    ``unit`` is documentation only (values are recorded as plain ints);
    the ``record_seconds`` helpers convert wall-clock seconds into the
    default microsecond unit.
    """

    def __init__(
        self,
        sub_bucket_bits: int = 7,
        octaves: int = 40,
        unit: str = "us",
    ) -> None:
        if sub_bucket_bits < 2 or octaves < 1:
            raise ValueError((sub_bucket_bits, octaves))
        self.sub_bucket_bits = int(sub_bucket_bits)
        self.octaves = int(octaves)
        self.unit = unit
        self._full = 1 << self.sub_bucket_bits  # linear-region width
        self._half = 1 << (self.sub_bucket_bits - 1)
        # largest exactly-representable value before clipping
        self._clip = (1 << (self.sub_bucket_bits + self.octaves)) - 1
        self.counts = np.zeros(
            self._full + self.octaves * self._half, dtype=np.int64
        )
        self._count = 0
        self._sum = 0
        self._min: Optional[int] = None
        self._max: Optional[int] = None
        self._lock = threading.Lock()

    # -- geometry ----------------------------------------------------------
    def _indices(self, values: np.ndarray) -> np.ndarray:
        v = np.minimum(
            np.maximum(values.astype(np.int64), 0), self._clip
        )
        # exact MSB position for v < 2**53 (frexp on float64 is exact)
        msb = (
            np.frexp(np.maximum(v, 1).astype(np.float64))[1] - 1
        ).astype(np.int64)
        k = np.maximum(msb - (self.sub_bucket_bits - 1), 0)
        sub = v >> k
        return np.where(
            k == 0, v, self._full + (k - 1) * self._half + (sub - self._half)
        )

    def value_at(self, idx: int) -> float:
        """Representative (mid-bucket) value for a bucket index; exact
        in the linear region, within half a bucket elsewhere."""
        idx = int(idx)
        if idx < self._full:
            return float(idx)
        k = (idx - self._full) // self._half + 1
        off = (idx - self._full) % self._half
        lo = (self._half + off) << k
        return lo + (1 << k) / 2.0

    def _same_geometry(self, other: "LatencyHistogram") -> bool:
        return (
            self.sub_bucket_bits == other.sub_bucket_bits
            and self.octaves == other.octaves
        )

    # -- recording ---------------------------------------------------------
    def record(self, value: int, count: int = 1) -> None:
        self.record_many(np.asarray([value], dtype=np.int64), count)

    def record_many(
        self, values: Sequence, weight: int = 1
    ) -> None:
        v = np.asarray(values, dtype=np.int64)
        if v.size == 0:
            return
        idx = self._indices(v)
        with self._lock:
            np.add.at(self.counts, idx, weight)
            self._count += int(v.size) * weight
            self._sum += int(v.sum()) * weight
            lo, hi = int(v.min()), int(v.max())
            self._min = lo if self._min is None else min(self._min, lo)
            self._max = hi if self._max is None else max(self._max, hi)

    def record_seconds(self, seconds: float) -> None:
        self.record(int(max(seconds, 0.0) * 1e6))

    def record_many_seconds(self, seconds: Iterable[float]) -> None:
        s = np.asarray(list(seconds), dtype=np.float64)
        if s.size:
            self.record_many(
                np.maximum(s, 0.0) * 1e6
            )

    # -- queries -----------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile (q in [0, 100]) in native units, or
        None when empty. Error bounded by one bucket's half-width."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> Optional[float]:
        if self._count == 0:
            return None
        target = max(int(np.ceil(q / 100.0 * self._count)), 1)
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, target, side="left"))
        val = self.value_at(idx)
        # clamp into the observed range: mid-bucket representatives
        # must not report beyond the recorded extremes
        if self._max is not None:
            val = min(val, float(self._max))
        if self._min is not None:
            val = max(val, float(self._min))
        return val

    def percentile_ms(self, q: float) -> Optional[float]:
        v = self.percentile(q)
        return None if v is None else round(v / 1e3, 3)

    # -- merge / snapshot --------------------------------------------------
    def _state_copy(self):
        with self._lock:
            return (
                self.counts.copy(),
                self._count,
                self._sum,
                self._min,
                self._max,
            )

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add ``other``'s counts into self (same geometry required).
        Returns self so merges chain/fold."""
        if not self._same_geometry(other):
            raise ValueError(
                "histogram geometry mismatch: "
                f"({self.sub_bucket_bits},{self.octaves}) vs "
                f"({other.sub_bucket_bits},{other.octaves})"
            )
        counts, count, total, lo, hi = other._state_copy()
        with self._lock:
            self.counts += counts
            self._count += count
            self._sum += total
            if lo is not None:
                self._min = lo if self._min is None else min(self._min, lo)
            if hi is not None:
                self._max = hi if self._max is None else max(self._max, hi)
        return self

    def copy(self) -> "LatencyHistogram":
        out = LatencyHistogram(
            self.sub_bucket_bits, self.octaves, self.unit
        )
        counts, count, total, lo, hi = self._state_copy()
        out.counts[:] = counts
        out._count, out._sum, out._min, out._max = count, total, lo, hi
        return out

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe summary (milliseconds for the default us unit)."""
        with self._lock:
            if self._count == 0:
                return {"count": 0, "unit": self.unit}
            return {
                "count": int(self._count),
                "unit": self.unit,
                "min_ms": round(self._min / 1e3, 3),
                "max_ms": round(self._max / 1e3, 3),
                "mean_ms": round(self._sum / self._count / 1e3, 3),
                "p50_ms": round(self._percentile_locked(50) / 1e3, 3),
                "p90_ms": round(self._percentile_locked(90) / 1e3, 3),
                "p99_ms": round(self._percentile_locked(99) / 1e3, 3),
                "p999_ms": round(
                    self._percentile_locked(99.9) / 1e3, 3
                ),
            }
