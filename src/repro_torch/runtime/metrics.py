"""Serving metrics plane: counters, gauges, histograms and nearest-rank
percentiles (port of ``repro/runtime/metrics.py``, stdlib only).

The engine samples the registry once per :meth:`ServingEngine.step` (queue
depth, active slots, pages in use, TTFT, per-step decode time), the front
door (``runtime/frontdoor.py``) adds admission-side series (queue wait,
429/408 rejections, cancels), and ``GET /metrics`` renders the whole
registry in Prometheus text exposition format. The same nearest-rank
helpers back :meth:`ServeReport.latency_stats`, so the report and the
``/metrics`` page mean the same thing by "p99".
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "nearest_rank", "summarize",
]

QUANTILES = (0.5, 0.95, 0.99)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest element with at least
    ``ceil(q * n)`` elements ≤ it. Exact (no interpolation), so two code
    paths computing "p99" over the same samples agree bit-for-bit."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {q}")
    vs = sorted(values)
    if not vs:
        return 0.0
    return float(vs[max(1, math.ceil(q * len(vs))) - 1])


def summarize(values: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 + mean/max summary of a latency sample set."""
    vs = list(values)
    out = {f"p{int(q * 100)}": nearest_rank(vs, q) for q in QUANTILES}
    out["max"] = float(max(vs)) if vs else 0.0
    out["mean"] = float(sum(vs) / len(vs)) if vs else 0.0
    out["count"] = float(len(vs))
    return out


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def render(self) -> List[str]:
        raise NotImplementedError

    def _header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines


class Counter(_Metric):
    """Monotonic event count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n

    def render(self) -> List[str]:
        return self._header() + [f"{self.name} {self.value}"]


class Gauge(_Metric):
    """Point-in-time value (queue depth, pages in use); tracks its peak."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.peak = max(self.peak, self.value)

    def render(self) -> List[str]:
        return self._header() + [f"{self.name} {_fmt(self.value)}"]


class Histogram(_Metric):
    """Sample store with exact nearest-rank quantiles.

    Serving runs here are bounded (one report per run), so every sample is
    kept and quantiles are exact — rendered as a Prometheus *summary*
    (which is what client-side exact quantiles are), not a bucketed
    histogram approximation.
    """

    kind = "summary"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.values: List[float] = []
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.values.append(float(v))
        self.sum += float(v)

    @property
    def count(self) -> int:
        return len(self.values)

    def percentile(self, q: float) -> float:
        return nearest_rank(self.values, q)

    def summary(self) -> Dict[str, float]:
        return summarize(self.values)

    def render(self) -> List[str]:
        lines = self._header()
        for q in QUANTILES:
            lines.append(
                f'{self.name}{{quantile="{q}"}} {_fmt(self.percentile(q))}')
        lines.append(f"{self.name}_sum {_fmt(self.sum)}")
        lines.append(f"{self.name}_count {self.count}")
        return lines


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


class MetricsRegistry:
    """Get-or-create registry of named metrics, rendered as one page.

    The registry is touched from the asyncio event loop (front door) and
    from the engine-step executor thread; every mutation is a single
    attribute update on a metric object, but get-or-create itself is
    locked so two threads can't race a metric into existence twice.
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> Iterable[str]:
        return self._metrics.keys()

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict view (reports, tests, JSON artifacts)."""
        out: Dict[str, object] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[name] = m.summary()
            elif isinstance(m, Gauge):
                out[name] = {"value": m.value, "peak": m.peak}
            else:
                out[name] = m.value
        return out

    def render(self) -> str:
        """Prometheus text exposition format (the ``GET /metrics`` body)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"
