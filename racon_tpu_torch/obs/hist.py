"""Latency histograms: log-bucketed, thread-safe, allocation-free.

The metrics registry (obs/metrics.py) snapshots counters, totals that
answer "how much"; a histogram answers "how is it spread": the p50,
p95 and p99 of one pipeline stage's per-chunk seconds, or of a phase.

  - Log-bucketed: bucket edges grow geometrically (factor 2**0.25, about
    19% a bucket) from `lo` to `hi`, so one fixed array of about 110
    slots spans 0.1 ms to 10,000 s with a bounded relative quantile
    error (at most one bucket width);
  - exact where exactness is cheap: count, sum, min and max are kept
    outside the buckets, so `max` is never an estimate;
  - thread-safe and allocation-free on the hot path: `observe` is a
    bisect into a prebuilt edge tuple plus integer adds under one lock.

`HistogramSet` is the named get-or-create collection the polisher and
the pipeline share: `observe("pipeline.pack", dt)` is the whole wiring
surface, and `merge()` folds one set into another (exact, because every
default-constructed histogram shares the same edge tuple).

The JAX package's exemplar slots and Prometheus export serve its serve
layer; they come with that slice of the port.
"""

from __future__ import annotations

import threading
from bisect import bisect_left


def _edges(lo: float, hi: float, factor: float) -> tuple:
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


#: default bucket edges, shared by every default-constructed Histogram
#: (one tuple per process; sharing is what makes merge() exact)
_DEFAULT_EDGES = _edges(1e-4, 1e4, 2 ** 0.25)


class Histogram:
    """Log-bucketed latency histogram (see module docstring).

    Bucket i counts observations in (edges[i-1], edges[i]]; bucket 0 is
    the underflow bucket (0, edges[0]]; one overflow bucket catches
    values past `hi`. Negative observations clamp to 0."""

    __slots__ = ("edges", "counts", "count", "sum", "min", "max", "_lock")

    def __init__(self, lo: float = 1e-4, hi: float = 1e4,
                 factor: float = 2 ** 0.25):
        if (lo, hi, factor) == (1e-4, 1e4, 2 ** 0.25):
            self.edges = _DEFAULT_EDGES
        else:
            if not (0 < lo < hi and factor > 1):
                raise ValueError(
                    f"Histogram: invalid layout lo={lo} hi={hi} "
                    f"factor={factor}")
            self.edges = _edges(lo, hi, factor)
        self.counts = [0] * (len(self.edges) + 1)  # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = value if value > 0.0 else 0.0
        i = bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def merge(self, other: "Histogram") -> None:
        """Fold `other` into this histogram (bucket layouts must match:
        default-constructed histograms always do)."""
        if other.edges is not self.edges and other.edges != self.edges:
            raise ValueError("Histogram.merge: bucket layouts differ")
        with other._lock:
            counts = list(other.counts)
            count, total = other.count, other.sum
            lo, hi = other.min, other.max
        if not count:
            return
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.count += count
            self.sum += total
            if self.min is None or (lo is not None and lo < self.min):
                self.min = lo
            if self.max is None or (hi is not None and hi > self.max):
                self.max = hi

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1): linear interpolation
        inside the bucket holding rank ceil(q * count); 0.0 when empty.
        The exact min/max clamp the estimate, so p0/p100 are exact."""
        with self._lock:
            counts = list(self.counts)
            count = self.count
            lo, hi = self.min, self.max
        if not count:
            return 0.0
        rank = max(1, min(count, int(q * count + 0.9999999)))
        seen = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if seen + c >= rank:
                left = self.edges[i - 1] if 0 < i < len(self.edges) \
                    else (0.0 if i == 0 else self.edges[-1])
                right = self.edges[i] if i < len(self.edges) else hi
                frac = (rank - seen) / c
                est = left + (right - left) * frac
                return min(max(est, lo), hi)
            seen += c
        return hi

    def snapshot(self) -> dict:
        """JSON-ready summary: count/sum/mean/min/max and p50/p95/p99."""
        with self._lock:
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
        if not count:
            return {"count": 0}
        return {"count": count,
                "sum": round(total, 6),
                "mean": round(total / count, 6),
                "min": round(lo, 6),
                "max": round(hi, 6),
                "p50": round(self.quantile(0.50), 6),
                "p95": round(self.quantile(0.95), 6),
                "p99": round(self.quantile(0.99), 6)}


class HistogramSet:
    """Named get-or-create Histogram collection (one lock for the name
    map; each histogram carries its own)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[str, Histogram] = {}

    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram())
        h.observe(value)

    def items(self) -> list[tuple[str, Histogram]]:
        with self._lock:
            return sorted(self._hists.items())

    def merge(self, other: "HistogramSet") -> None:
        for name, hist in other.items():
            mine = self._hists.get(name)
            if mine is None:
                with self._lock:
                    mine = self._hists.setdefault(name, Histogram())
            mine.merge(hist)

    def snapshot(self) -> dict:
        """{name: histogram summary}: the metrics registry's `latency`
        namespace."""
        return {name: hist.snapshot() for name, hist in self.items()}
