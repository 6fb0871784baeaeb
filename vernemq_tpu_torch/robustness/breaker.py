"""Circuit breaker for the TPU dispatch path.

The matcher already degrades *per publish* (host fallback on overflow,
trie service during rebuilds); the breaker promotes that into a coherent
degraded **mode**: after ``failure_threshold`` consecutive device
failures it opens, every match serves from the exact host trie (the
correctness oracle — zero dropped or wrong fanouts), and a single
half-open probe per backoff window retries the device. Backoff grows
exponentially with jitter up to ``backoff_max``; on probe success the
matcher re-warms and the breaker closes — the device path returns with
no broker restart.

State machine (classic Nygard breaker, adapted to the matcher's
executor-thread call pattern):

- ``CLOSED``: dispatch normally; a success resets the failure run.
- ``OPEN``: :meth:`allow` is False until the retry deadline; the first
  ``allow`` past it transitions to ``HALF_OPEN`` and grants exactly one
  probe.
- ``HALF_OPEN``: the probe is in flight; everyone else is refused.
  Probe success closes (and resets backoff); failure re-opens with
  doubled backoff.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..observability import events

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

#: The registered breaker paths: every device path that carries a
#: circuit breaker, as spelled by the admin surface (``vmq-admin
#: breaker show|trip|reset path=...``).  A new breakered device phase
#: registers here FIRST — the ``fault-registry`` vmqlint pass proves
#: the admin rows and the trip/reset filter both match this set
#: exactly, so a path can't ship un-drillable.
BREAKER_PATHS = ("match", "retained", "predicate", "wire", "store",
                 "handoff")


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 3,
                 backoff_initial: float = 0.2, backoff_max: float = 10.0,
                 jitter: float = 0.1,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None,
                 name: str = ""):
        #: breaker path name for the control-plane event journal
        #: (BREAKER_PATHS spelling, or "<path>:<mountpoint>"); unnamed
        #: breakers (tests, embedded) journal with an empty detail
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.backoff_initial = backoff_initial
        self.backoff_max = backoff_max
        self.jitter = jitter
        self._clock = clock
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._backoff = backoff_initial
        self._retry_at = 0.0
        self._forced = False  # trip(): pinned open until reset()
        self._degraded_since: Optional[float] = None
        self._time_degraded = 0.0
        # transition / traffic counters (exported as gauges)
        self.opens = 0
        self.closes = 0
        self.probes = 0
        self.probe_aborts = 0
        self.failures = 0
        self.successes = 0

    # ------------------------------------------------------------- queries

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        return _NAMES[self._state]

    @property
    def is_closed(self) -> bool:
        return self._state == CLOSED

    def time_degraded(self) -> float:
        """Total seconds spent open/half-open (including a live stint)."""
        with self._lock:
            t = self._time_degraded
            if self._degraded_since is not None:
                t += self._clock() - self._degraded_since
            return t

    def status(self) -> Dict[str, Any]:
        with self._lock:
            live = (self._clock() - self._degraded_since
                    if self._degraded_since is not None else 0.0)
            return {
                "state": ("forced_open" if self._forced
                          else _NAMES[self._state]),
                "consecutive_failures": self._consecutive,
                "backoff_s": round(self._backoff, 3),
                "retry_in_s": round(max(0.0, self._retry_at - self._clock()), 3)
                if self._state == OPEN else 0.0,
                "time_degraded_s": round(self._time_degraded + live, 3),
                "opens": self.opens, "closes": self.closes,
                "probes": self.probes, "probe_aborts": self.probe_aborts,
                "failures": self.failures,
                "successes": self.successes,
            }

    # ---------------------------------------------------------- transitions

    def allow(self) -> bool:
        """May the caller dispatch to the device now? Open past the
        retry deadline grants exactly ONE half-open probe. A tripped
        (force-opened) breaker never probes — only reset() ends it."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._forced:
                return False
            if self._state == OPEN and self._clock() >= self._retry_at:
                self._state = HALF_OPEN
                self.probes += 1
                events.emit("breaker_half_open", detail=self.name)
                return True
            return False

    def record_success(self) -> bool:
        """A device dispatch completed. Returns True when this success
        closed a half-open breaker (the recovery edge — callers re-warm
        on it)."""
        with self._lock:
            self.successes += 1
            self._consecutive = 0
            if self._state == CLOSED or self._forced:
                # forced-open: a straggler dispatch that was already in
                # flight when the operator tripped must not unpin it
                return False
            # half-open probe succeeded (or a straggler dispatched
            # before the open landed): recover
            self._state = CLOSED
            self._backoff = self.backoff_initial
            self.closes += 1
            if self._degraded_since is not None:
                self._time_degraded += self._clock() - self._degraded_since
                self._degraded_since = None
            events.emit("breaker_close", detail=self.name)
            return True

    def record_failure(self) -> bool:
        """A device dispatch failed. Returns True when this failure
        OPENED the breaker (the degrade edge — callers log/count it)."""
        with self._lock:
            self.failures += 1
            self._consecutive += 1
            if self._state == HALF_OPEN:
                # failed probe: back off harder and re-open
                self._backoff = min(self._backoff * 2, self.backoff_max)
                self._open_locked()
                return False
            if (self._state == CLOSED
                    and self._consecutive >= self.failure_threshold):
                self._open_locked()
                return True
            if self._state == OPEN:
                # stragglers already past allow() when the breaker
                # opened; they don't re-arm the deadline
                return False
            return False

    def probe_aborted(self) -> None:
        """The granted half-open probe never reached a device verdict
        (matcher lock timeout, rebuild shed, cold compile signature):
        return to OPEN with the SAME backoff — nothing was learned
        about device health, so neither recover nor back off harder.
        Without this the probe slot would leak and the breaker wedge
        in HALF_OPEN forever. No-op unless half-open (a real failure
        may already have re-opened)."""
        with self._lock:
            if self._state != HALF_OPEN:
                return
            self.probe_aborts += 1
            self._state = OPEN
            self._retry_at = self._clock() + self._backoff * (
                1.0 + self.jitter * self._rng.random())

    def trip(self) -> None:
        """Force-open and PIN: matching stays on the host trie — no
        half-open probes, no success can close it — until an explicit
        :meth:`reset` (the ``vmq-admin breaker trip`` drill / keep-off
        switch)."""
        with self._lock:
            self._forced = True
            if self._state != OPEN:
                self._open_locked()

    def reset(self) -> None:
        """Force-close, unpin a tripped breaker, forget the failure
        run."""
        with self._lock:
            self._forced = False
            if self._state != CLOSED:
                self.closes += 1
                events.emit("breaker_close", detail=self.name)
            self._state = CLOSED
            self._consecutive = 0
            self._backoff = self.backoff_initial
            if self._degraded_since is not None:
                self._time_degraded += self._clock() - self._degraded_since
                self._degraded_since = None

    def _open_locked(self) -> None:
        self._state = OPEN
        self.opens += 1
        events.emit("breaker_open", detail=self.name,
                    value=float(self._consecutive))
        # full jitter on the retry deadline: concurrent matchers must
        # not probe in lockstep after a shared outage
        self._retry_at = self._clock() + self._backoff * (
            1.0 + self.jitter * self._rng.random())
        if self._degraded_since is None:
            self._degraded_since = self._clock()
