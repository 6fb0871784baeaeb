"""Deterministic fault injection for the broker's failure paths.

One process-global :class:`FaultPlan` (installed via :func:`install`,
config ``fault_injection``/``fault_injection_seed``, or live through
``vmq-admin fault inject``) decides, at every named **injection point**,
whether to fire a fault: raise :class:`InjectedFault`, add latency, or
hang. Decisions are drawn from a per-point RNG stream seeded by
``(seed, point)`` and indexed by that point's hit counter, so identical
seeds reproduce identical injection sequences regardless of how hits on
*different* points interleave — the property the determinism test in
``tests/test_fault_injection.py`` asserts.

The injection points in the tree are registered in
:data:`KNOWN_POINTS` (one authoritative table: ``vmq-admin fault
inject`` validates against it, and the ``fault-registry`` vmqlint pass
proves every ``faults.inject*`` site and every registry entry agree —
a typo'd point on either side fails tier-1, not a chaos drill).

The no-plan fast path is one module-global ``is None`` check, so the
hooks cost nothing in production.
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: faults longer than this are "hangs" capped to a bounded sleep — an
#: injected hang must be escapable by the surrounding timeouts, not
#: wedge the process forever. The uncapped variant is the ``wedge``
#: kind: it blocks until the stall watchdog abandons the operation
#: (robustness/watchdog.py calls :func:`release` at abandonment) or an
#: operator runs ``vmq-admin fault release <point>`` — the drill for
#: sites that HAVE surrounding deadlines. ``hang`` stays capped for
#: sites that still lack them.
HANG_CAP_S = 60.0

#: The authoritative injection-point registry: point -> what lives
#: there.  Every ``faults.inject``/``inject_async`` call site names one
#: of these, every entry has at least one site, and ``vmq-admin fault
#: inject`` refuses points (or globs) matching none of them — all three
#: invariants are enforced statically by ``tools/vmqlint``'s
#: ``fault-registry`` pass and at runtime by :func:`validate_point`.
KNOWN_POINTS: Dict[str, str] = {
    "device.dispatch":
        "device match dispatch (GpuMatcher match_batch / match_many, "
        "ops.match_kernel.call_match_many)",
    "device.delta":
        "delta-scatter upload of dirty table slots",
    "device.rebuild":
        "full device-table (re)build, inline or background",
    "device.retained":
        "retained reverse-match path (retained/index.py): dispatch, "
        "delta scatter and full (re)build",
    "device.predicate":
        "payload-predicate phase (filters/engine.py): pair-mask + "
        "window-fold dispatch",
    "device.pressure":
        "overload-governor device-pressure probe (robustness/"
        "overload.py): an exact-match error rule forces pressure 1.0",
    "cluster.recv":
        "inbound cluster data-plane frames (cluster/com.py)",
    "cluster.spool":
        "delivery-spool journal writes (cluster/spool.py)",
    "cluster.handoff":
        "live-handoff phase entries (cluster/handoff.py): every "
        "freeze/drain/fence/adopt phase of a mesh-slice or session "
        "handoff passes this seam — a wedge here drills the "
        "per-phase watchdog rollback (old owner keeps serving)",
    "store.write":
        "message-store writes (storage/msg_store.py)",
    "store.compact":
        "budgeted segment/kv compaction step (broker store maintenance "
        "tick -> storage/segment.py compact_step): a fault feeds the "
        "store breaker — open pauses compaction (append-only degraded "
        "mode) without touching delivery",
    "store.recover":
        "segment-engine checkpoint load at open (storage/segment.py): "
        "a fault discards the checkpoint and recovery degrades to the "
        "full segment scan (slower, never lossy)",
    "listener.bind":
        "listener (re)bind (broker/listeners.py)",
    "wire.parse":
        "native wire-codec batch parse (protocol/fastpath.py "
        "parse_batch): a fault degrades the batch to the bit-identical "
        "pure-Python codec, never drops the connection",
    "wire.encode":
        "native wire-codec fanout header encode (protocol/fastpath.py "
        "publish_header and the one-call batched "
        "publish_headers_batch): a fault degrades to the pure-Python "
        "encoder",
}


def validate_point(point: str) -> None:
    """Reject an injection point (or fnmatch glob) that matches no
    registered point — a drill against a misspelled seam must fail
    loudly at the admin surface, not pass vacuously."""
    if point in KNOWN_POINTS:
        return
    if any(fnmatch.fnmatch(known, point) for known in KNOWN_POINTS):
        return
    raise ValueError(
        f"unknown injection point {point!r} (known: "
        f"{', '.join(sorted(KNOWN_POINTS))})")


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
    ``count`` bounds total firings (-1 = unlimited); ``probability``
    gates each eligible hit on a draw from the point's seeded stream.
    ``kind`` is ``error`` (raise), ``latency`` (sleep ``latency_ms``),
    ``hang`` (sleep ``latency_ms`` capped at :data:`HANG_CAP_S`,
    default the cap) or ``wedge`` (block until :func:`release` — by the
    stall watchdog's abandonment or ``vmq-admin fault release``)."""

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
    dispatch), the event loop (cluster frames) and background rebuild
    workers concurrently."""

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

    @classmethod
    def from_config(cls, spec: Sequence[Dict[str, Any]],
                    seed: int = 0) -> "FaultPlan":
        """Build a plan from the ``fault_injection`` config list (rule
        dicts with the :class:`FaultRule` field names)."""
        rules = []
        for r in spec or ():
            kw = {k.replace("-", "_"): v for k, v in dict(r).items()}
            kw.pop("fired", None)
            rules.append(FaultRule(**kw))
        return cls(rules, seed=seed)

    def add_rule(self, rule: FaultRule) -> None:
        with self._lock:
            self.rules.append(rule)

    def _rng(self, point: str) -> random.Random:
        rng = self._rngs.get(point)
        if rng is None:
            # string seeding hashes via sha512 — stable across processes
            # (unlike hash() of str under PYTHONHASHSEED)
            rng = self._rngs[point] = random.Random(
                f"{self.seed}:{point}")
        return rng

    def decide(self, point: str) -> Optional[Tuple[str, float, int, int]]:
        """Record one hit of ``point`` and return the fault to apply,
        if any: ``(kind, latency_s, rule_index, hit)``. Pure bookkeeping
        — callers apply the raise/sleep so async contexts can await the
        delay instead of blocking the loop."""
        with self._lock:
            hit = self._hits.get(point, 0)
            self._hits[point] = hit + 1
            rng = self._rng(point)
            # ONE draw per hit, consumed whether or not any rule wants
            # it: the stream index stays aligned with the hit counter,
            # so live rule edits never shift past decisions
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
        """The gate a ``wedge`` fault at ``point`` blocks on. One event
        per point per episode: :meth:`release` sets AND retires it, so
        the next wedge firing at the same point blocks afresh."""
        with self._lock:
            ev = self._wedge_evs.get(point)
            if ev is None:
                ev = self._wedge_evs[point] = threading.Event()
            return ev

    def wedge_wait(self, point: str,
                   timeout: Optional[float] = None) -> None:
        """Block the injection-point thread until release (or
        ``timeout`` — loop-side seams pass their cap so a wedge drill
        stalls the loop boundedly, like ``hang``)."""
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
        """Free the wedge blocked at ``point`` (watchdog abandonment /
        ``vmq-admin fault release``). True when a gate was armed."""
        with self._lock:
            ev = self._wedge_evs.pop(point, None)
            if ev is None:
                return False
            self.wedge_releases += 1
        ev.set()
        return True

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"seed": self.seed, "injected": self.injected,
                    "delayed": self.delayed,
                    "wedged": self.wedged,
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
    (no-op without one). Called by the stall watchdog at abandonment
    and by ``vmq-admin fault release``."""
    p = _active
    return p.release(point) if p is not None else False


def stats() -> Dict[str, float]:
    """Gauge snapshot for the metrics/$SYS surface."""
    p = _active
    if p is None:
        return {"fault_plan_active": 0.0, "faults_injected": 0.0,
                "faults_delayed": 0.0, "faults_wedged_now": 0.0,
                "faults_wedge_releases": 0.0}
    return {"fault_plan_active": 1.0, "faults_injected": float(p.injected),
            "faults_delayed": float(p.delayed),
            "faults_wedged_now": float(p._wedge_now),
            "faults_wedge_releases": float(p.wedge_releases)}


def inject(point: str, max_delay_s: Optional[float] = None) -> None:
    """Synchronous injection hook (executor threads / host prep paths):
    raises :class:`InjectedFault` or sleeps per the active plan.
    ``max_delay_s`` caps latency/hang faults at sites that execute on
    the event-loop thread (a synchronous seam like the msg-store write
    really does block the loop — the cap keeps a drill's stall bounded
    instead of freezing every session for the full hang)."""
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
        # uncapped on sacrificial/executor threads; loop-side seams
        # pass their cap so the drill stalls boundedly like `hang`
        plan.wedge_wait(point, timeout=max_delay_s)
        return
    if max_delay_s is not None:
        delay = min(delay, max_delay_s)
    time.sleep(delay)


async def inject_async(point: str) -> None:
    """Event-loop-safe injection hook: latency/hang faults await instead
    of blocking the loop (every session shares it)."""
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
    import asyncio

    if kind == "wedge":
        # loop-safe wedge: poll the gate instead of blocking the loop —
        # only THIS coroutine stalls; other sessions' IO keeps flowing
        ev = plan.wedge_event(point)
        with plan._lock:
            plan.wedged += 1
            plan._wedge_now += 1
        try:
            while not ev.is_set():
                await asyncio.sleep(0.02)
        finally:
            with plan._lock:
                plan._wedge_now -= 1
        return
    await asyncio.sleep(delay)
