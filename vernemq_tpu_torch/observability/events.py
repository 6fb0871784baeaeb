"""Control-plane event journal: a bounded ring of state-machine
transitions (breaker opens and closes, watchdog stalls, abandons and late
discards) with monotonic stamps.

A copy of ``vernemq_tpu/observability/events.py`` for the codes the port
emits. Events are transitions, never per-publish, so one small lock around
the ring is cheap.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


#: The event-code registry: code -> (emitting subsystem, description).
#: Every ``events.emit(<code>)`` site names a code here.
KNOWN_EVENTS: Dict[str, Tuple[str, str]] = {
    "breaker_open": (
        "robustness/breaker",
        "A circuit breaker opened (the device path degraded to its exact "
        "host fallback); detail names the breaker."),
    "breaker_half_open": (
        "robustness/breaker",
        "A circuit breaker granted its single half-open probe."),
    "breaker_close": (
        "robustness/breaker",
        "A circuit breaker closed (probe success or reset)."),
    "watchdog_stall": (
        "robustness/watchdog",
        "A monitored operation overran its deadline (detail names the "
        "point and label)."),
    "watchdog_abandon": (
        "robustness/watchdog",
        "A stalled operation was abandoned: the waiter was released to "
        "the host fallback and the straggler's result will be "
        "discarded."),
    "watchdog_late_discard": (
        "robustness/watchdog",
        "An abandoned operation completed late and its result was "
        "discarded (never delivered)."),
}


class EventJournal:
    """Bounded ring of control-plane events (process-global singleton via
    :func:`journal`)."""

    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(64, int(capacity)))
        self.counts: Dict[str, int] = {}
        self.emitted = 0
        self.dropped = 0  # ring evictions (oldest event lost)

    def emit(self, code: str, detail: str = "", value: float = 0.0) -> None:
        if code not in KNOWN_EVENTS:
            raise KeyError(f"unregistered event code: {code!r} "
                           f"(register it in events.KNOWN_EVENTS)")
        ev = {"t": time.monotonic(), "ts": time.time(), "code": code,
              "pid": os.getpid(), "detail": detail, "value": float(value)}
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
            self.emitted += 1
            self.counts[code] = self.counts.get(code, 0) + 1

    def snapshot(self, limit: int = 0, code: Optional[str] = None,
                 since: Optional[float] = None) -> List[Dict[str, Any]]:
        """Events oldest-first, optionally filtered by code and by
        monotonic stamp (``since``: only events after it)."""
        with self._lock:
            out = list(self._ring)
        if code is not None:
            out = [e for e in out if e["code"] == code]
        if since is not None:
            out = [e for e in out if e["t"] > since]
        return out[-limit:] if limit else out


_JOURNAL = EventJournal()


def journal() -> EventJournal:
    return _JOURNAL


def emit(code: str, detail: str = "", value: float = 0.0) -> None:
    """Record one control-plane event (unregistered codes raise)."""
    _JOURNAL.emit(code, detail, value)
