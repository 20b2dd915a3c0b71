"""Metrics registry — named counters / gauges / histograms: a copy of
``repro.obs.metrics`` (pure Python; the port imports nothing of the JAX
package).

One :class:`MetricsRegistry` per arena holds its runtime tallies, and a
single ``snapshot()`` captures them.  Names the port writes (dotted
``layer.noun[.verb]``, as in the JAX package):

* ``arena.runs`` / ``arena.dispatches`` — cumulative run totals (the
  per-run numbers stay in ``RolloutReport.meta``);
* ``arena.input_cache.hits`` / ``arena.input_cache.misses`` — the
  arena's device-input caches (lane constants, channels, dropout masks,
  learning-rate sequences).

Counters are exact ints, gauges hold the last value, histograms keep a
bounded reservoir (newest kept) plus exact running count/sum so
percentiles degrade gracefully while totals never do.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({n}))")
        self.value += int(n)
        return self.value


class Gauge:
    """Last-value gauge (e.g. cache sizes, queue depth)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value

    def add(self, v: float) -> float:
        self.value = float(self.value) + float(v)
        return self.value


class Histogram:
    """Bounded-reservoir histogram with exact running count/sum.

    The reservoir keeps the newest ``capacity`` observations (a deque,
    not a sampling scheme — the streaming path wants *recent* latency
    percentiles, and the exact count/sum keep long-run totals honest
    regardless of eviction)."""

    __slots__ = ("name", "values", "count", "total")

    def __init__(self, name: str, capacity: int = 2048):
        self.name = name
        self.values: deque = deque(maxlen=capacity)
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.values.append(v)
        self.count += 1
        self.total += v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentiles(self, qs: Iterable[float] = (50.0, 90.0, 99.0)
                    ) -> Dict[float, float]:
        """Nearest-rank percentiles over the (recent) reservoir."""
        out: Dict[float, float] = {}
        vals = sorted(self.values)
        for q in qs:
            if not vals:
                out[float(q)] = math.nan
                continue
            rank = max(0, min(len(vals) - 1,
                              int(math.ceil(q / 100.0 * len(vals))) - 1))
            out[float(q)] = vals[rank]
        return out


class MetricsRegistry:
    """One namespace of counters/gauges/histograms for a subsystem tree
    (an arena plus the service and stores built on it share one
    registry).  Accessors create on first use, so instrumented code
    never has to pre-declare."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- accessors ----------------------------------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, capacity: int = 2048) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, capacity)
        return h

    # -- views --------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Flat JSON-shaped view of everything: counters/gauges by name,
        histograms as ``{count, sum, mean, p50, p90, p99}``."""
        out: Dict[str, Any] = {}
        for name, c in sorted(self._counters.items()):
            out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            out[name] = g.value
        for name, h in sorted(self._histograms.items()):
            ps = h.percentiles()
            out[name] = {"count": h.count, "sum": h.total,
                         "mean": h.mean, "p50": ps[50.0],
                         "p90": ps[90.0], "p99": ps[99.0]}
        return out

    def get(self, name: str, default: Optional[float] = 0) -> Any:
        """Read a metric's current value without creating it."""
        if name in self._counters:
            return self._counters[name].value
        if name in self._gauges:
            return self._gauges[name].value
        if name in self._histograms:
            return self._histograms[name]
        return default

    def names(self) -> List[str]:
        return sorted([*self._counters, *self._gauges, *self._histograms])
