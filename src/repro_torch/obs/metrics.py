"""Host-side metrics: counters, gauges, fixed-bucket histograms.

The registry is the serving stack's single source of operational truth —
``RequestBatcher`` (queue depth, batch occupancy, padding waste),
``StreamingServer`` (request latency, compaction events, epoch age),
``SpeculativeDispatcher`` (deadline misses, replica wins), the query
planner (per-strategy route counts, count-bound error) and the device-side
traversal counters (``repro_torch.obs.stats``) all report here, and
``repro_torch.obs.export`` serializes the whole registry to Prometheus text
exposition or a JSON snapshot.

Design constraints, in order:

  * **cheap on the hot path** — recording is a dict update under one lock;
    no string formatting, no allocation beyond the first observation of a
    label set. Device code never calls into this module (device-side
    counters are a jitted pytree; the *host* folds them in afterwards);
  * **fixed buckets** — histograms pre-declare their bucket upper bounds,
    so export is O(buckets) and two processes' histograms are mergeable
    (the Prometheus model). p50/p90/p99 summaries are bucket-interpolated,
    tightened by the tracked min/max;
  * **few dependencies** — the stdlib, and numpy for ``observe_many``;
    ``repro_torch.obs`` sits below every serving layer and imports none of
    them.

Metric naming follows Prometheus conventions: ``snake_case`` with a
``repro_`` prefix, ``_total`` suffix on counters, unit suffixes
(``_seconds``) on timings. The full catalog lives in
``docs/OBSERVABILITY.md``.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default bucket ladders. Latencies: sub-ms to a minute, roughly
# log-spaced (the classic Prometheus ladder). Counts: powers of two —
# traversal counters (nodes expanded, candidates, visited) are
# capacity-bounded integers, so log2 buckets resolve every regime from
# "converged instantly" to "walked the whole graph".
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
COUNT_BUCKETS: Tuple[float, ...] = tuple(
    float(1 << i) for i in range(0, 21)
)
# Sizes: 1 KiB to 1 GiB in powers of two — snapshot files, WAL segments.
BYTES_BUCKETS: Tuple[float, ...] = tuple(
    float(1 << i) for i in range(10, 31)
)
FRACTION_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
    0.95, 0.99, 1.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Base: one named family holding per-labelset series."""

    type: str = "untyped"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[LabelKey, object] = {}

    def _samples(self) -> List[Tuple[LabelKey, object]]:
        with self._lock:
            return list(self._series.items())


class Counter(_Metric):
    """Monotone counter (resets only with the registry)."""

    type = "counter"

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Point-in-time value (queue depth, epoch number, epoch age)."""

    type = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels: str) -> None:
        self.inc(-value, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)   # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Fixed-bucket histogram with interpolated percentile summaries.

    ``buckets`` are strictly increasing finite upper bounds; an implicit
    ``+Inf`` bucket tops the ladder. ``percentile`` interpolates linearly
    inside the containing bucket, clamped to the observed min/max so a
    histogram fed a single value reports that value at every quantile.
    """

    type = "histogram"

    def __init__(self, name, help, lock, buckets: Sequence[float]):
        super().__init__(name, help, lock)
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("buckets must be strictly increasing and non-empty")
        if not all(math.isfinite(x) for x in b):
            raise ValueError("buckets must be finite (+Inf is implicit)")
        self.buckets = b
        self._edges = np.asarray(b)

    def observe(self, value: float, **labels: str) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            i = 0
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    break
            else:
                i = len(self.buckets)
            s.counts[i] += 1
            s.sum += value
            s.count += 1
            s.min = min(s.min, value)
            s.max = max(s.max, value)

    def observe_many(self, values: Iterable[float], **labels: str) -> None:
        """``observe`` of each value, in one pass under one lock: the same
        buckets, count, min and max, and the sum added in the same order
        (a sequential ``cumsum``), so state and export are equal."""
        # an array converts whole: iterating one makes a scalar per value
        v = (np.asarray(values, dtype=np.float64).ravel() if isinstance(values, np.ndarray)
             else np.fromiter(values, dtype=np.float64))
        if v.size == 0:
            return
        key = _label_key(labels)
        counts = np.bincount(np.searchsorted(self._edges, v, side="left"),
                             minlength=len(self.buckets) + 1)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            s.counts = [a + int(b) for a, b in zip(s.counts, counts)]
            s.sum = float(np.cumsum(np.concatenate(([s.sum], v)))[-1])
            s.count += int(v.size)
            s.min = min(s.min, float(np.fmin.reduce(v)))
            s.max = max(s.max, float(np.fmax.reduce(v)))

    def percentile(self, q: float, **labels: str) -> float:
        """Bucket-interpolated quantile ``q`` in [0, 1]; NaN when empty."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s.count == 0:
                return math.nan
            rank = q * s.count
            cum = 0.0
            for i, c in enumerate(s.counts):
                if c == 0:
                    continue
                lo = self.buckets[i - 1] if i > 0 else min(s.min, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else s.max
                if cum + c >= rank:
                    frac = (rank - cum) / c
                    est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                    return float(min(max(est, s.min), s.max))
                cum += c
            return float(s.max)

    def summary(self, **labels: str) -> Dict[str, float]:
        """{count, sum, min, max, p50, p90, p99} for one labelset."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s.count == 0:
                return {"count": 0, "sum": 0.0, "min": math.nan,
                        "max": math.nan, "p50": math.nan, "p90": math.nan,
                        "p99": math.nan}
        return {
            "count": s.count, "sum": s.sum, "min": s.min, "max": s.max,
            "p50": self.percentile(0.50, **dict(labels)),
            "p90": self.percentile(0.90, **dict(labels)),
            "p99": self.percentile(0.99, **dict(labels)),
        }


class MetricsRegistry:
    """Get-or-create factory + container for one process's metrics.

    ``counter``/``gauge``/``histogram`` are idempotent: asking twice for
    the same name returns the same object (and raises on a type clash), so
    call sites never coordinate creation. One registry-wide RLock guards
    every series (contention is negligible against host-side batching
    granularity, and one lock keeps export snapshots consistent).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, self._lock, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.type}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "",
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def collect(self) -> List[_Metric]:
        """Stable-ordered snapshot of every registered family."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every family (tests / fresh measurement windows)."""
        with self._lock:
            self._metrics.clear()


# The process-default registry: every serving component that is not handed
# an explicit ``MetricsRegistry`` records here, so a deployment gets one
# coherent /metrics page without plumbing.
_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL


def resolve(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """``None`` -> the process-default registry (the common wiring)."""
    return registry if registry is not None else _GLOBAL
