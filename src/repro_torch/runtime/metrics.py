"""Nearest-rank percentiles (port of the helpers of
``repro/runtime/metrics.py``): the one definition of "p99" the serve report
uses."""
from __future__ import annotations

import math
from typing import Dict, Sequence

QUANTILES = (0.5, 0.95, 0.99)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The smallest element with at least ``ceil(q * n)`` elements ≤ it."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {q}")
    vs = sorted(values)
    if not vs:
        return 0.0
    return float(vs[max(1, math.ceil(q * len(vs))) - 1])


def summarize(values: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 + mean/max/count of a sample set."""
    vs = list(values)
    out = {f"p{int(q * 100)}": nearest_rank(vs, q) for q in QUANTILES}
    out["max"] = float(max(vs)) if vs else 0.0
    out["mean"] = float(sum(vs) / len(vs)) if vs else 0.0
    out["count"] = float(len(vs))
    return out
