"""Device dispatch profiler: one bounded-ring record per device call.

The matcher/index layers record every dispatch (publish match, retained
reverse match, delta scatter, table rebuild) with the shape facts the
roofline model needs — K windows fused, batch fill, padded batch/delta
sizes, whether this call compiled a cold signature or executed a warm
one, rows scattered, rebuild phase split — so ``vmq-admin profile
device`` answers "what did the device actually do and at what cost"
from the live broker, and ``vmq-admin timeline dump`` lays the records
on the same Chrome-trace axis as the flight-recorder publish samples.

Process-global like the histogram registry (the matcher has no broker
handle); the ring is per-process — in worker mode each worker profiles
its own client-side view and the service process profiles the real
device calls.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import histogram as hist


class DispatchProfiler:
    """Bounded ring of per-dispatch records + per-kind aggregates."""

    def __init__(self, capacity: int = 2048):
        self.records: deque = deque(maxlen=max(64, int(capacity)))
        self._lock = threading.Lock()
        self._agg: Dict[str, Dict[str, float]] = {}

    def record(self, kind: str, t0: float, dur_ms: float,
               **fields: Any) -> None:
        """Append one dispatch record (``t0`` = CLOCK_MONOTONIC start).
        Gated on the observability flag; deque append is atomic, the
        aggregate update takes a short lock off the loop thread."""
        if not hist.enabled():
            return
        rec: Dict[str, Any] = {"kind": kind, "t0": t0,
                               "dur_ms": round(dur_ms, 4),
                               "pid": os.getpid()}
        rec.update({k: v for k, v in fields.items() if v is not None})
        self.records.append(rec)
        with self._lock:
            agg = self._agg.setdefault(kind, {
                "count": 0.0, "total_ms": 0.0, "max_ms": 0.0,
                "compiles": 0.0})
            agg["count"] += 1
            agg["total_ms"] += dur_ms
            if dur_ms > agg["max_ms"]:
                agg["max_ms"] = dur_ms
            if fields.get("compiled"):
                agg["compiles"] += 1

    def snapshot(self, kind: Optional[str] = None,
                 limit: int = 0) -> List[Dict[str, Any]]:
        out = [r for r in self.records if kind is None or r["kind"] == kind]
        return out[-limit:] if limit else out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-kind aggregates plus p50/p99 over the records still in
        the ring (the ring is the sample window)."""
        with self._lock:
            out = {k: dict(v) for k, v in self._agg.items()}
        by_kind: Dict[str, List[float]] = {}
        for r in list(self.records):
            by_kind.setdefault(r["kind"], []).append(r["dur_ms"])
        for kind, durs in by_kind.items():
            durs.sort()
            agg = out.setdefault(kind, {"count": float(len(durs))})
            agg["ring_p50_ms"] = durs[len(durs) // 2]
            agg["ring_p99_ms"] = durs[min(len(durs) - 1,
                                          int(0.99 * len(durs)))]
            if agg.get("count"):
                agg["mean_ms"] = round(
                    agg.get("total_ms", sum(durs)) / agg["count"], 4)
        return out

    def set_capacity(self, capacity: int) -> None:
        """Re-bound the ring (the ``profiler_capacity`` knob at broker
        start); existing records are kept up to the new cap."""
        self.records = deque(self.records, maxlen=max(64, int(capacity)))

    def reset(self) -> None:
        self.records.clear()
        with self._lock:
            self._agg.clear()


_PROFILER = DispatchProfiler()


def profiler() -> DispatchProfiler:
    return _PROFILER


def record_dispatch(kind: str, t0: float, dur_ms: float,
                    **fields: Any) -> None:
    """Module-level convenience used by the matcher/index seams."""
    _PROFILER.record(kind, t0, dur_ms, **fields)


def timed() -> float:
    return time.monotonic()
