"""Serving telemetry of the port: :class:`LogHistogram`, the mergeable
log-bucket latency histogram that ``ContinuousBatchingEngine.report()``
takes its TTFT and ITL percentiles from. Port of
``repro.serving.telemetry.LogHistogram``; the structured event stream
(``Telemetry``) waits for ROADMAP §1 item 6.
"""
from __future__ import annotations

import math


class LogHistogram:
    """Fixed-size log-bucket histogram for streaming latency percentiles.

    Bucket ``i`` covers ``[lo * g**i, lo * g**(i+1))`` with
    ``g = 10 ** (1 / buckets_per_decade)``; values below ``lo`` land in
    bucket 0, values at or above ``hi`` in the last bucket. Insert is O(1)
    and the memory is a fixed int list, so per-token ITL accounting stays
    bounded on arbitrarily long traces.

    ``percentile(q)`` returns the geometric midpoint of the bucket holding
    the nearest-rank sample — within one bucket (a factor of ``g``) of the
    exact nearest-rank value.

    Histograms with identical bounds **merge** by adding counts
    (:meth:`merge`), so per-engine or per-run histograms aggregate exactly.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 buckets_per_decade: int = 16):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self.lo, self.hi = float(lo), float(hi)
        self.bpd = buckets_per_decade
        self._log_g = math.log(10.0) / buckets_per_decade
        self.n_buckets = (int(math.ceil(
            (math.log(hi) - math.log(lo)) / self._log_g)) + 1)
        self.counts = [0] * self.n_buckets
        self.n = 0

    def _bucket(self, x: float) -> int:
        if x <= self.lo:
            return 0
        i = int((math.log(x) - math.log(self.lo)) / self._log_g)
        return min(i, self.n_buckets - 1)

    def add(self, x: float) -> None:
        self.counts[self._bucket(x)] += 1
        self.n += 1

    def edges(self, i: int) -> tuple[float, float]:
        lo = self.lo * math.exp(i * self._log_g)
        return lo, lo * math.exp(self._log_g)

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile (the sample at index ``ceil(q*n) - 1``
        of the sorted stream), returned as the geometric midpoint of its
        bucket. None on an empty histogram."""
        if not self.n:
            return None
        rank = max(0, math.ceil(q * self.n) - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum > rank:
                a, b = self.edges(i)
                return math.sqrt(a * b)
        return self.edges(self.n_buckets - 1)[1]       # unreachable

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        if (self.lo, self.hi, self.bpd) != (other.lo, other.hi, other.bpd):
            raise ValueError("histogram bounds differ; cannot merge")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        return self

    def reset(self) -> None:
        self.counts = [0] * self.n_buckets
        self.n = 0

