"""Process-wide metrics registry: counters, gauges, bounded histograms.

The registry is the one place the executors publish quantitative
telemetry — :mod:`repro_torch.core.engine` (runs, iterations),
:mod:`repro_torch.core.compilecache` (cache hits/misses) and
:mod:`repro_torch.core.direction` (direction switches).  Unlike the
tracer it is **always on**: every instrument is a couple of arithmetic
ops under a lock, and :func:`MetricsRegistry.snapshot` renders the
whole registry as one flat dict.

Histograms use **fixed buckets** so memory stays constant in the
observation count (the property the serving latency percentiles need:
a server that has answered a million queries holds the same few dozen
ints as one that answered ten).  :meth:`Histogram.percentile`
interpolates within the selected bucket, so estimates are within one
bucket width of the exact order statistic.
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "metrics", "exp_bucket_edges", "latency_bucket_edges",
]


class Counter:
    """Monotonically increasing value (floats allowed: seconds, bytes)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        v = self._v
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-written value, with a tracked high-water mark."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._v = 0.0
        self._hi = float("-inf")
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._v = value
            self._hi = max(self._hi, value)

    def set_max(self, value: float) -> None:
        """Ratchet: keep the max of the current and new value."""
        with self._lock:
            self._v = max(self._v, value)
            self._hi = max(self._hi, self._v)

    @property
    def value(self) -> float:
        return self._v

    @property
    def high_water(self) -> float:
        return self._hi if self._hi != float("-inf") else 0.0

    def snapshot(self):
        v = self._v
        return int(v) if float(v).is_integer() else v


def exp_bucket_edges(lo: float, hi: float,
                     per_decade: int = 5) -> tuple[float, ...]:
    """Log-spaced bucket edges from ``lo`` to ``hi`` (inclusive),
    ``per_decade`` buckets per factor of 10 — relative resolution
    ``10**(1/per_decade)`` everywhere in range."""
    if not (0 < lo < hi):
        raise ValueError("need 0 < lo < hi")
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    edges = [lo * 10 ** (i / per_decade) for i in range(n)]
    edges.append(hi)
    return tuple(edges)


def latency_bucket_edges() -> tuple[float, ...]:
    """The default latency ladder: 10 µs … 1000 s, 5 buckets/decade
    (≈ 58% relative bucket width — p50/p95/p99 land within one bucket
    of the exact sample)."""
    return exp_bucket_edges(1e-5, 1e3, per_decade=5)


class Histogram:
    """Fixed-bucket histogram; memory constant in observation count.

    ``edges`` are the interior bucket boundaries; observations below
    ``edges[0]`` or at/above ``edges[-1]`` land in unbounded end
    buckets whose interpolation is clamped to the observed min/max, so
    :meth:`percentile` never reports a value outside the data range.
    """

    def __init__(self, name: str = "",
                 edges: tuple[float, ...] | None = None) -> None:
        self.name = name
        self.edges = tuple(float(e) for e in
                           (edges if edges is not None
                            else latency_bucket_edges()))
        if sorted(self.edges) != list(self.edges) or len(self.edges) < 2:
            raise ValueError("histogram edges must be sorted, >= 2 entries")
        # bucket i covers [edges[i-1], edges[i]); 0 = underflow,
        # len(edges) = overflow
        self._counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        b = self._bucket(value)
        with self._lock:
            self._counts[b] += 1
            self.count += 1
            self.sum += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)

    def _bucket(self, value: float) -> int:
        # binary search over the fixed edges
        lo, hi = 0, len(self.edges)
        while lo < hi:
            mid = (lo + hi) // 2
            if value < self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def _bounds(self, b: int) -> tuple[float, float]:
        lo = self.edges[b - 1] if b > 0 else self.min
        hi = self.edges[b] if b < len(self.edges) else self.max
        return max(lo, self.min), min(max(hi, self.min), self.max)

    def percentile(self, q: float) -> float | None:
        """Estimate the ``q``-th percentile (0–100): pick the bucket
        holding the target rank, interpolate linearly inside it; the
        exact order statistic lies in the same bucket, so the error is
        bounded by that bucket's width."""
        if self.count == 0:
            return None
        target = max(q / 100.0 * self.count, 1e-12)
        cum = 0
        for b, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo, hi = self._bounds(b)
                frac = (target - cum) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            cum += c
        return float(self.max)      # pragma: no cover — rounding guard

    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> dict:
        out = dict(count=self.count, sum=self.sum)
        if self.count:
            out.update(min=self.min, max=self.max,
                       p50=self.percentile(50), p95=self.percentile(95),
                       p99=self.percentile(99))
        return out


class MetricsRegistry:
    """Named instruments, created on first use, rendered by snapshot().

    Names are dotted paths (``"stream.phase_seconds.assemble"``).
    Re-requesting a name returns the same instrument; requesting it as
    a different type raises.
    """

    def __init__(self) -> None:
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str,
                  edges: tuple[float, ...] | None = None) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(name, edges))

    def snapshot(self) -> dict:
        """Flat ``{name: value-or-dict}`` of every instrument."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def reset(self) -> None:
        """Drop every instrument (tests; the registry is process-wide)."""
        with self._lock:
            self._instruments.clear()


#: The process-wide registry every subsystem publishes into.
REGISTRY = MetricsRegistry()
metrics = REGISTRY
