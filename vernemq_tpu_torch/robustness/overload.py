"""The batch collector's pressure signal: a copy of the two functions of
``vernemq_tpu/robustness/overload.py`` it calls (and the constants they
read). The overload governor that consumes the signal is not ported yet."""

from __future__ import annotations

#: dispatch-latency EWMA smoothing for the collector signal (rise time ~3
#: flushes)
LATENCY_EWMA_ALPHA = 0.3
#: latency contribution cap: BELOW the governor's first-level gate by
#: design — a slow-but-covered dispatch (busy/rebuild/degraded sheds serve
#: identical results) is reduced headroom, not overload; only DEPTH
#: (arrivals outpacing service) may escalate
LATENCY_SEVERITY_CAP = 0.2


def fold_latency_ewma(prev_ms: float, dt_ms: float) -> float:
    """One EWMA step for a collector's whole-flush service time."""
    return LATENCY_EWMA_ALPHA * dt_ms + (1 - LATENCY_EWMA_ALPHA) * prev_ms


def collector_pressure(depth: int, depth_bound: int,
                       latency_ewma_ms: float,
                       latency_budget_ms: float) -> float:
    """Queue depth against the collector's own overload bound saturates to
    1.0; the latency EWMA against its budget caps at
    LATENCY_SEVERITY_CAP."""
    d = min(1.0, depth / depth_bound) if depth_bound else 0.0
    lat = 0.0
    if latency_budget_ms > 0:
        lat = LATENCY_SEVERITY_CAP * min(
            1.0, latency_ewma_ms / latency_budget_ms)
    return max(d, lat)
