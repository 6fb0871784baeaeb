"""Deterministic fault injection for the device match path.

A copy of ``vernemq_tpu/robustness/faults.py`` for the seams the port has.
One process-global :class:`FaultPlan` (installed with :func:`install`)
decides, at every named **injection point**, whether to fire a fault: raise
:class:`InjectedFault`, add latency, hang, or wedge. Decisions are drawn
from a per-point RNG stream seeded by ``(seed, point)`` and indexed by that
point's hit counter, so identical seeds reproduce identical injection
sequences regardless of how hits on *different* points interleave — the
same streams as the reference's for the same seed and rules.

The no-plan fast path is one module-global ``is None`` check, so the hooks
cost nothing when no plan is installed.
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: faults longer than this are "hangs" capped to a bounded sleep — an
#: injected hang must be escapable by the surrounding timeouts, not wedge
#: the process forever. The uncapped variant is the ``wedge`` kind: it
#: blocks until the stall watchdog abandons the operation (robustness/
#: watchdog.py calls :func:`release` at abandonment).
HANG_CAP_S = 60.0

#: The injection points of the port, under the reference's names. Every
#: ``faults.inject`` call site names one of these; a rule's ``point`` may
#: be one of them or an fnmatch glob over them.
KNOWN_POINTS: Dict[str, str] = {
    "device.dispatch":
        "device match dispatch (GpuMatcher match_batch / match_many, "
        "ops.match_kernel.call_match_many)",
    "device.delta":
        "delta-scatter upload of dirty table slots",
    "device.rebuild":
        "full device-table (re)build, inline or background",
}


class InjectedFault(RuntimeError):
    """A fault fired by the active :class:`FaultPlan`."""

    def __init__(self, point: str, rule_index: int, hit: int,
                 message: str = ""):
        super().__init__(
            message or f"injected fault at {point} (rule {rule_index}, "
                       f"hit {hit})")
        self.point = point
        self.rule_index = rule_index
        self.hit = hit


@dataclass
class FaultRule:
    """One injection rule: where, what, and how often.

    ``point`` may be an exact injection-point name or an fnmatch glob
    (``device.*``). ``after`` skips the first N hits of the point;
    ``count`` bounds total firings (-1 = unlimited); ``probability`` gates
    each eligible hit on a draw from the point's seeded stream. ``kind`` is
    ``error`` (raise), ``latency`` (sleep ``latency_ms``), ``hang`` (sleep
    ``latency_ms`` capped at :data:`HANG_CAP_S`, default the cap) or
    ``wedge`` (block until :func:`release`)."""

    point: str
    kind: str = "error"
    probability: float = 1.0
    after: int = 0
    count: int = -1
    latency_ms: float = 0.0
    message: str = ""
    fired: int = field(default=0, compare=False)

    def as_dict(self) -> Dict[str, Any]:
        return {"point": self.point, "kind": self.kind,
                "probability": self.probability, "after": self.after,
                "count": self.count, "latency_ms": self.latency_ms,
                "fired": self.fired}


class FaultPlan:
    """A seedable set of :class:`FaultRule`\\ s with per-point streams.

    Thread-safe: injection points fire from executor threads (device
    dispatch) and background rebuild workers concurrently."""

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.seed = int(seed)
        self.rules: List[FaultRule] = list(rules)
        self.injected = 0       # faults raised
        self.delayed = 0        # latency/hang faults applied
        self.wedged = 0         # wedge faults entered (monotonic)
        self.wedge_releases = 0  # release() calls that freed a wedge
        self._wedge_now = 0     # waiters currently blocked in a wedge
        self._wedge_evs: Dict[str, threading.Event] = {}
        self._hits: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._lock = threading.Lock()

    def _rng(self, point: str) -> random.Random:
        rng = self._rngs.get(point)
        if rng is None:
            # string seeding hashes via sha512 — stable across processes
            # (unlike hash() of str under PYTHONHASHSEED)
            rng = self._rngs[point] = random.Random(f"{self.seed}:{point}")
        return rng

    def decide(self, point: str) -> Optional[Tuple[str, float, int, int]]:
        """Record one hit of ``point`` and return the fault to apply, if
        any: ``(kind, latency_s, rule_index, hit)``. Pure bookkeeping —
        the caller applies the raise/sleep."""
        with self._lock:
            hit = self._hits.get(point, 0)
            self._hits[point] = hit + 1
            rng = self._rng(point)
            # ONE draw per hit, consumed whether or not any rule wants it:
            # the stream index stays aligned with the hit counter, so live
            # rule edits never shift past decisions
            draw = rng.random()
            for i, r in enumerate(self.rules):
                if r.point != point and not fnmatch.fnmatch(point, r.point):
                    continue
                if hit < r.after:
                    continue
                if 0 <= r.count <= r.fired:
                    continue
                if draw >= r.probability:
                    continue
                r.fired += 1
                if r.kind == "error":
                    self.injected += 1
                else:
                    self.delayed += 1
                delay = (min(r.latency_ms / 1e3, HANG_CAP_S)
                         if r.kind == "latency"
                         else min(r.latency_ms / 1e3 or HANG_CAP_S,
                                  HANG_CAP_S) if r.kind == "hang"
                         else 0.0)
                return (r.kind, delay, i, hit)
        return None

    # --------------------------------------------------------------- wedge

    def wedge_event(self, point: str) -> threading.Event:
        """The gate a ``wedge`` fault at ``point`` blocks on. One event per
        point per episode: :meth:`release` sets AND retires it, so the next
        wedge firing at the same point blocks afresh."""
        with self._lock:
            ev = self._wedge_evs.get(point)
            if ev is None:
                ev = self._wedge_evs[point] = threading.Event()
            return ev

    def wedge_wait(self, point: str,
                   timeout: Optional[float] = None) -> None:
        """Block the injection-point thread until release (or
        ``timeout``)."""
        ev = self.wedge_event(point)
        with self._lock:
            self.wedged += 1
            self._wedge_now += 1
        try:
            ev.wait(timeout)
        finally:
            with self._lock:
                self._wedge_now -= 1

    def release(self, point: str) -> bool:
        """Free the wedge blocked at ``point`` (watchdog abandonment).
        True when a gate was armed."""
        with self._lock:
            ev = self._wedge_evs.pop(point, None)
            if ev is None:
                return False
            self.wedge_releases += 1
        ev.set()
        return True

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"seed": self.seed, "injected": self.injected,
                    "delayed": self.delayed, "wedged": self.wedged,
                    "wedged_now": self._wedge_now,
                    "wedge_releases": self.wedge_releases,
                    "hits": dict(self._hits),
                    "rules": [r.as_dict() for r in self.rules]}


# --------------------------------------------------------------- registry

_active: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (replacing any)."""
    global _active
    _active = plan
    return plan


def clear() -> None:
    """Deactivate fault injection (the hooks return to the free path)."""
    global _active
    _active = None


def active() -> Optional[FaultPlan]:
    return _active


def release(point: str) -> bool:
    """Free a ``wedge`` fault blocked at ``point`` on the active plan
    (no-op without one). Called by the stall watchdog at abandonment."""
    p = _active
    return p.release(point) if p is not None else False


def inject(point: str, max_delay_s: Optional[float] = None) -> None:
    """Synchronous injection hook: raises :class:`InjectedFault` or sleeps
    per the active plan. ``max_delay_s`` caps latency/hang faults (and
    wedges) at sites that must stay bounded."""
    plan = _active
    if plan is None:
        return
    decision = plan.decide(point)
    if decision is None:
        return
    kind, delay, rule_index, hit = decision
    if kind == "error":
        raise InjectedFault(point, rule_index, hit,
                            plan.rules[rule_index].message)
    if kind == "wedge":
        plan.wedge_wait(point, timeout=max_delay_s)
        return
    if max_delay_s is not None:
        delay = min(delay, max_delay_s)
    time.sleep(delay)
