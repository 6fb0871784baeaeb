"""Device dispatch profiler: one bounded-ring record per device call.

A copy of ``vernemq_tpu/observability/profiler.py``. The matcher records
every dispatch (publish match, table rebuild) with its shape facts — K
windows fused, batch fill, padded batch size, rebuild phase split.
Process-global like the histogram registry.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Any, Dict, List, Optional


class DispatchProfiler:
    """Bounded ring of per-dispatch records."""

    def __init__(self, capacity: int = 2048):
        self.records: deque = deque(maxlen=max(64, int(capacity)))

    def record(self, kind: str, t0: float, dur_ms: float,
               **fields: Any) -> None:
        """Append one dispatch record (``t0`` = CLOCK_MONOTONIC start)."""
        rec: Dict[str, Any] = {"kind": kind, "t0": t0,
                               "dur_ms": round(dur_ms, 4),
                               "pid": os.getpid()}
        rec.update({k: v for k, v in fields.items() if v is not None})
        self.records.append(rec)

    def snapshot(self, kind: Optional[str] = None,
                 limit: int = 0) -> List[Dict[str, Any]]:
        out = [r for r in self.records if kind is None or r["kind"] == kind]
        return out[-limit:] if limit else out

    def reset(self) -> None:
        self.records.clear()


_PROFILER = DispatchProfiler()


def profiler() -> DispatchProfiler:
    return _PROFILER


def record_dispatch(kind: str, t0: float, dur_ms: float,
                    **fields: Any) -> None:
    """Module-level convenience used by the matcher seams."""
    _PROFILER.record(kind, t0, dur_ms, **fields)
