"""Log2-bucketed latency histograms (microsecond domain).

Fixed power-of-two bucket bounds from 1 us to ~8.4 s: notification
latencies span nanoseconds (inline execution) to seconds (a starved
poll_only queue), so log buckets hold the whole range in 25 ints. A
single short lock per observe keeps counts exact across threads — the
histogram path only runs while tracing is enabled, and the CI overhead
gate bounds its cost.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional

#: upper bucket bounds in microseconds; the final +inf bucket is implicit.
BOUNDS: List[float] = [float(2 ** i) for i in range(24)]


class Histogram:
    """Latency histogram over microseconds with exact sum/count/max."""

    __slots__ = ("counts", "total", "count", "max", "_lock")

    def __init__(self) -> None:
        self.counts = [0] * (len(BOUNDS) + 1)
        self.total = 0.0       # sum of observed values (us)
        self.count = 0
        self.max = 0.0
        self._lock = threading.Lock()

    def observe(self, value_us: float) -> None:
        idx = bisect_left(BOUNDS, value_us)
        with self._lock:
            self.counts[idx] += 1
            self.total += value_us
            self.count += 1
            if value_us > self.max:
                self.max = value_us

    def merge(self, other: "Histogram") -> None:
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.total += other.total
            self.count += other.count
            self.max = max(self.max, other.max)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket containing quantile ``q`` (0..1)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return BOUNDS[i] if i < len(BOUNDS) else self.max
        return self.max

    def to_dict(self) -> Dict[str, float]:
        return {"count": self.count, "mean_us": round(self.mean, 3),
                "p50_us": self.percentile(0.50),
                "p99_us": self.percentile(0.99),
                "max_us": round(self.max, 3)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Histogram({self.to_dict()})"
