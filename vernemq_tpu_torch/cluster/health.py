"""Membership health plane: accrual failure detection + auto-rebalance.

The handoff FSM (cluster/handoff.py) can move any slice or session with
zero QoS>=1 loss — but until now only when an operator typed
``vmq-admin cluster drain-node``. This module is the closed loop that
drives it automatically:

- **HealthMonitor** — a phi-accrual-style failure detector over the
  traffic the cluster already generates (every inbound ``vmq-send``
  batch is a heartbeat; the idle ``png`` ping guarantees one per
  second). Per peer it keeps an inter-arrival window and scores the
  silence since the last frame as ``phi = elapsed / mean * log10(e)``
  (the exponential-tail simplification of the accrual detector):
  continuous suspicion instead of a binary timeout, so a slow peer and
  a dead peer separate cleanly. Transitions ride the governor's
  hysteresis pattern — re-entering ``alive`` requires phi to stay below
  ``phi_suspect * exit_ratio`` for a full hold window, so a flapping
  member cannot oscillate the planner. Each transition lands in the
  event journal (``member_suspect``/``member_down``/``member_alive``).

- **Load gossip** — every node's idle ping (and hlo) carries its local
  load score: queue depth + loop-lag p99 (sysmon, and worker-stats
  slots when running multi-process) + governor pressure. The scorer
  replaces round-robin target choice everywhere a successor is picked
  (planner evacuation, ``drain_node``, ``rebalance_slices``,
  ``migrate_offline_queues`` retargeting).

- **RebalancePlanner** — fires on membership change (join/leave) and
  detector verdicts (down/alive), debounced, and drives session
  evacuation + slice rebalancing through the handoff engine. Safety
  rails so self-healing can't self-harm: a **quorum gate** (no
  automatic action while this node can't see a majority of the joined
  members — a netsplit minority must sit still and let the CAP
  machinery own the partition), the **handoff breaker** (repeated
  rollbacks stop the planner exactly like they stop operator drains),
  a **per-peer cooldown** (one rebalance cycle per peer per window —
  the anti-ping-pong rail the chaos soak asserts), and a **single
  coordinator** rule for evacuations (the lowest-named live member
  acts; LWW record rewrites converge even if two race).
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..observability import events

log = logging.getLogger("vernemq_tpu_torch.health")

ALIVE = "alive"
SUSPECT = "suspect"
DOWN = "down"

#: inter-arrival samples shorter than this are not recorded — a
#: data-plane burst must not shrink the estimated heartbeat cadence to
#: microseconds (the idle-ping interval is what silence is scored
#: against); the frame still refreshes last_seen
_MIN_SAMPLE_S = 0.05
#: floor on the estimated heartbeat interval: the idle png
#: (NodeWriter.PING_INTERVAL) is the ONLY guaranteed cadence — data-
#: plane chatter is opportunistic. A burst of sub-second frames must
#: not shrink the mean below the ping interval, or the first normal
#: ping gap after the burst scores as death (false down on an idle but
#: healthy peer)
_MIN_MEAN_S = 1.0
#: scoring cadence before the first COMPLETED interval: the idle png
#: guarantees one frame per second per channel, so a peer that dies
#: right after first contact is scored against that floor instead of
#: being unscorable forever (phi would stay 0 with an empty window)
_BOOTSTRAP_MEAN_S = 1.0
_LOG10_E = math.log10(math.e)

#: provisional load added per unit assigned during a greedy spread —
#: matches the queue-depth term's per-queue weight in the score
_ASSIGN_STEP = 0.01


def local_load_score(broker) -> float:
    """This node's gossiped load score: normalized queue depth, event-
    loop lag p99 (the sysmon sample, fused with worker-stats slots when
    running multi-process), and the overload governor's pressure. Unit-
    less — only the ORDER across peers matters to the scorer."""
    try:
        depth = len(broker.registry.queues) + len(broker.sessions)
    except Exception:
        depth = 0
    score = depth * _ASSIGN_STEP
    lag = 0.0
    sysmon = getattr(broker, "sysmon", None)
    if sysmon is not None:
        lag = float(getattr(sysmon, "last_lag", 0.0) or 0.0)
    ws = getattr(broker, "worker_stats", None)
    if ws is not None:
        try:
            samples: List[float] = []
            for i in range(ws.n_workers):
                samples.extend(ws.read_slot(i).get("lag_samples") or ())
            if samples:
                samples.sort()
                lag = max(lag, samples[min(len(samples) - 1,
                                           int(len(samples) * 0.99))])
        except Exception:
            pass  # torn slot read heals next heartbeat; sysmon covers
    score += lag * 10.0
    gov = getattr(broker, "overload", None)
    if gov is not None:
        score += float(getattr(gov, "_last_pressure", 0.0) or 0.0)
    return round(score, 4)


def assign_targets(units: Sequence[Any], candidates: Sequence[str],
                   load_of: Callable[[str], float]) -> Dict[Any, str]:
    """Greedy least-loaded spread: each unit goes to the currently
    cheapest candidate (ties break by name — deterministic), and every
    assignment provisionally charges the target so a bulk move spreads
    instead of dog-piling the one idle node."""
    loads = {c: float(load_of(c)) for c in set(candidates)}
    out: Dict[Any, str] = {}
    for u in units:
        target = min(loads, key=lambda c: (loads[c], c))
        loads[target] += _ASSIGN_STEP
        out[u] = target
    return out


class PeerHealth:
    """One peer's detector state: the inter-arrival window, the current
    alive/suspect/down verdict, the gossiped load score, and the
    hysteresis clock for re-entering alive."""

    __slots__ = ("intervals", "last_seen", "last_sample", "state",
                 "load", "below_since", "changed_at")

    def __init__(self, window: int, now: float):
        self.intervals: deque = deque(maxlen=max(4, int(window)))
        self.last_seen = now
        self.last_sample = now
        self.state = ALIVE
        self.load = 0.0
        self.below_since: Optional[float] = None
        self.changed_at = now

    def heartbeat(self, now: float) -> None:
        dt = now - self.last_sample
        if self.state != ALIVE:
            # recovery frame after a suspicion episode: the gap measures
            # the OUTAGE, not the peer's cadence. Recording it would
            # inflate the mean and slow every later detection of this
            # peer — verdicts for simultaneously-severed peers would
            # skew apart and escape the planner's debounce batch (the
            # quorum gate must see correlated failures together).
            self.last_sample = now
        elif dt >= _MIN_SAMPLE_S:
            self.intervals.append(dt)
            self.last_sample = now
        self.last_seen = now

    def mean_interval(self) -> Optional[float]:
        if not self.intervals:
            return None
        return max(sum(self.intervals) / len(self.intervals), _MIN_MEAN_S)

    def phi(self, now: float) -> float:
        """Suspicion of the CURRENT silence: with heartbeat intervals
        ~exponential(mean), P(silence > t) = exp(-t/mean) and
        phi = -log10(P) = t/mean * log10(e). phi 1.5 ~ 3.5 missed
        intervals, phi 8 ~ 18 — a dead peer's phi grows linearly with
        the silence, a merely slow one plateaus as its window adapts."""
        m = self.mean_interval()
        if m is None:
            m = _BOOTSTRAP_MEAN_S  # no window yet: assume ping cadence
        return max(0.0, (now - self.last_seen) / m * _LOG10_E)


class HealthMonitor:
    """Per-peer accrual failure detector + load-score table (one per
    cluster). Fed by :meth:`heartbeat` from every inbound cluster frame
    batch; verdicts are computed by the periodic :meth:`tick_once`."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.broker = cluster.broker
        cfg = self.broker.config
        self.window = int(cfg.get("health_window", 64))
        self.phi_suspect = float(cfg.get("health_phi_suspect", 1.5))
        self.phi_down = float(cfg.get("health_phi_down", 8.0))
        self.exit_ratio = float(cfg.get("health_exit_ratio", 0.5))
        self.hold_s = float(cfg.get("health_hold_s", 3.0))
        self.tick_s = max(0.05, float(cfg.get("health_tick_ms", 500)) / 1e3)
        self.peers: Dict[str, PeerHealth] = {}
        self.planner: Optional["RebalancePlanner"] = None
        self._task: Optional[asyncio.Task] = None

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.tick_s)
            try:
                self.tick_once()
            except Exception:
                log.exception("health tick failed")

    # ------------------------------------------------------------- feeds

    def heartbeat(self, node: str,
                  load: Optional[float] = None) -> None:
        """Any inbound frame batch from ``node`` is a liveness proof;
        a ping/hlo may also carry the peer's gossiped load score."""
        if node == self.broker.node_name:
            return
        now = time.monotonic()
        ph = self.peers.get(node)
        if ph is None:
            ph = self.peers[node] = PeerHealth(self.window, now)
        ph.heartbeat(now)
        if load is not None:
            try:
                ph.load = float(load)
            except (TypeError, ValueError):
                pass

    def on_channel(self, node: str, status: str) -> None:
        """TCP-level writer transitions sharpen the detector: a torn
        outbound channel makes the peer immediately suspect (the phi
        clock keeps running toward down), a re-established one does NOT
        short-circuit the alive hysteresis — flaps must sit it out."""
        ph = self.peers.get(node)
        if ph is None:
            return
        now = time.monotonic()
        if status == "down" and ph.state == ALIVE:
            self._transition(node, ph, SUSPECT, now, ph.phi(now))

    # ----------------------------------------------------------- verdict

    def tick_once(self, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        members = set(self.cluster.members(include_self=False))
        for node in list(self.peers):
            if node not in members:
                del self.peers[node]  # ex-member: forget its state
        for node in members:
            ph = self.peers.get(node)
            if ph is None:
                # first sight at tick time (warm boot): optimistic
                # alive, the phi clock starts now
                self.peers[node] = PeerHealth(self.window, now)
                continue
            phi = ph.phi(now)
            if ph.state != DOWN and phi >= self.phi_down:
                self._transition(node, ph, DOWN, now, phi)
            elif ph.state == ALIVE and phi >= self.phi_suspect:
                self._transition(node, ph, SUSPECT, now, phi)
            elif ph.state != ALIVE:
                # hysteresis re-entry (the governor's exit-ratio + hold
                # pattern): phi must stay below the deep exit gate for a
                # full hold window — a flapper resets the clock each dip
                if phi < self.phi_suspect * self.exit_ratio:
                    if ph.below_since is None:
                        ph.below_since = now
                    elif now - ph.below_since >= self.hold_s:
                        self._transition(node, ph, ALIVE, now, phi)
                else:
                    ph.below_since = None

    def _transition(self, node: str, ph: PeerHealth, state: str,
                    now: float, phi: float) -> None:
        old, ph.state = ph.state, state
        ph.below_since = None
        ph.changed_at = now
        # literal per-verdict sites: the metrics and events-registry
        # lint passes verify each code statically
        if state == SUSPECT:
            self.broker.metrics.incr("member_suspect_transitions")
            events.emit("member_suspect", detail=node,
                        value=round(phi, 3))
        elif state == DOWN:
            self.broker.metrics.incr("member_down_transitions")
            events.emit("member_down", detail=node, value=round(phi, 3))
        else:
            self.broker.metrics.incr("member_alive_transitions")
            events.emit("member_alive", detail=node,
                        value=round(phi, 3))
        log.log(logging.WARNING if state != ALIVE else logging.INFO,
                "member %s: %s -> %s (phi %.2f)", node, old, state, phi)
        if self.planner is not None:
            if state == DOWN:
                self.planner.note(node, "down")
            elif state == ALIVE and old == DOWN:
                self.planner.note(node, "alive")

    # ------------------------------------------------------------ queries

    def state_of(self, node: str) -> str:
        if node == self.broker.node_name:
            return ALIVE
        ph = self.peers.get(node)
        return ph.state if ph is not None else ALIVE

    def load_of(self, node: str) -> float:
        if node == self.broker.node_name:
            return local_load_score(self.broker)
        ph = self.peers.get(node)
        return ph.load if ph is not None else 0.0

    def quorum_ok(self) -> bool:
        """Can this node see a MAJORITY of the joined membership? A
        singleton is trivially quorate; a peer is visible unless the
        detector has declared it down. The planner refuses automatic
        action without quorum — a partitioned minority evacuating 'dead'
        peers that are alive on the other side is the one way
        self-healing could lose data."""
        members = self.cluster.members()
        if len(members) <= 1:
            return True
        visible = 0
        for n in members:
            if n == self.broker.node_name:
                visible += 1
            else:
                ph = self.peers.get(n)
                if ph is None or ph.state != DOWN:
                    visible += 1
        return visible * 2 > len(members)

    def status_rows(self) -> List[Dict[str, Any]]:
        """`vmq-admin cluster health` / QL ``cluster_health``: one row
        per member with verdict, suspicion, load and heartbeat age."""
        now = time.monotonic()
        rows = [{"node": self.broker.node_name, "state": ALIVE,
                 "phi": 0.0, "load": local_load_score(self.broker),
                 "heartbeat_age_s": 0.0, "self": True}]
        for node in self.cluster.members(include_self=False):
            ph = self.peers.get(node)
            if ph is None:
                rows.append({"node": node, "state": ALIVE, "phi": 0.0,
                             "load": 0.0, "heartbeat_age_s": 0.0,
                             "self": False})
            else:
                rows.append({"node": node, "state": ph.state,
                             "phi": round(ph.phi(now), 3),
                             "load": round(ph.load, 4),
                             "heartbeat_age_s": round(now - ph.last_seen, 3),
                             "self": False})
        return rows


class RebalancePlanner:
    """Membership-change -> handoff planner (one per cluster).

    ``note(node, reason)`` is the only input: reasons are ``down`` and
    ``alive`` from the detector, ``join`` and ``leave`` from the
    membership table. Notes debounce into cycles; each cycle passes the
    safety rails (cooldown, quorum, breaker) before acting — a refused
    cycle is counted and journaled, never retried implicitly (the next
    membership signal re-notes it)."""

    def __init__(self, cluster, health: HealthMonitor):
        self.cluster = cluster
        self.broker = cluster.broker
        self.health = health
        cfg = self.broker.config
        self.enabled = bool(cfg.get("rebalance_enabled", True))
        self.require_quorum = bool(cfg.get("rebalance_require_quorum", True))
        self.debounce_s = float(cfg.get("rebalance_debounce_s", 1.5))
        self.cooldown_s = float(cfg.get("rebalance_cooldown_s", 10.0))
        self._cooldown_until: Dict[str, float] = {}
        self._pending: Dict[str, str] = {}
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self.cycles = 0
        self.suppressed = 0

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._task is None and self.enabled:
            self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def note(self, node: str, reason: str) -> None:
        """A membership signal about ``node``. Later notes for the same
        node within the debounce window supersede earlier ones (a
        down->alive flap collapses to one 'alive' cycle, not two)."""
        if not self.enabled or node == self.broker.node_name:
            return
        self._pending[node] = reason
        self._wake.set()

    async def _run(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            await asyncio.sleep(self.debounce_s)
            pending, self._pending = self._pending, {}
            for node, reason in sorted(pending.items()):
                try:
                    await self.run_cycle(node, reason)
                except Exception:
                    log.exception("rebalance cycle for %s (%s) failed",
                                  node, reason)

    # ------------------------------------------------------------- cycle

    async def run_cycle(self, node: str, reason: str) -> bool:
        """One guarded planning cycle. Returns True when it acted."""
        now = time.monotonic()
        # stale-verdict guard: the verdict can change during the
        # debounce (or a re-noted cycle can fire after recovery) — an
        # evacuation must only run against a peer that is STILL down,
        # and a rebalance-toward must not target one that died since
        state = self.health.state_of(node)
        if (reason == "down") != (state == DOWN):
            events.emit("rebalance_skipped",
                        detail=f"{node}: stale {reason} verdict")
            return False
        if self.require_quorum and not self.health.quorum_ok():
            # checked BEFORE the cooldown so the refusal is always
            # observable — the partition drill must see this counter
            # even when a recent cycle charged the peer's window
            self.broker.metrics.incr("handoff_auto_skipped_no_quorum")
            events.emit("rebalance_skipped", detail=f"{node}: no quorum")
            log.warning("auto-rebalance for %s (%s) refused: this node "
                        "cannot see a membership majority", node, reason)
            return False
        if now < self._cooldown_until.get(node, 0.0):
            # the anti-ping-pong rail: one cycle per peer per window —
            # a flapping member's repeat verdicts land here
            self.suppressed += 1
            self.broker.metrics.incr("handoff_auto_suppressed")
            events.emit("rebalance_skipped", detail=f"{node}: cooldown")
            if reason == "down":
                # a masked death must be revisited when the window
                # opens: the down verdict is sticky, so no further note
                # will ever fire — without this a member that dies
                # right after joining is never evacuated
                delay = self._cooldown_until[node] - now
                asyncio.get_event_loop().call_later(
                    delay, self.note, node, reason)
            return False
        ho = getattr(self.broker, "handoff", None)
        if ho is not None and not ho.breaker.allow():
            self.broker.metrics.incr("handoff_auto_skipped_breaker")
            events.emit("rebalance_skipped", detail=f"{node}: breaker open")
            return False
        self._cooldown_until[node] = now + self.cooldown_s
        self.cycles += 1
        events.emit("rebalance_plan", detail=f"{node}: {reason}")
        if reason == "down":
            await self._evacuate(node)
        else:  # join / alive / leave: spread load onto the new shape
            await self._rebalance()
        return True

    def _live_members(self) -> List[str]:
        out = []
        for n in self.cluster.members():
            if n == self.broker.node_name:
                out.append(n)
            elif (self.health.state_of(n) != DOWN
                    and self.cluster._status.get(n) == "up"):
                out.append(n)
        return sorted(out)

    async def _evacuate(self, node: str) -> int:
        """A member is down without leaving: rewrite every subscriber
        record it owned to the least-loaded survivors (clean sessions
        died with their node — same contract as fix-dead-queues;
        messages stored only on the dead node stay there). Only the
        lowest-named live member acts — one coordinator, and the LWW
        records converge even if a second one races."""
        live = self._live_members()
        if not live or live[0] != self.broker.node_name:
            return 0
        reg = self.broker.registry
        victims = [(sid, rec) for sid, rec in list(reg.db.fold())
                   if rec is not None and rec.node == node]
        if not victims:
            return 0
        persistent = [sid for sid, rec in victims if not rec.clean_session]
        assign = assign_targets(persistent, live, self.health.load_of)
        moved = 0
        for sid, rec in victims:
            if rec.clean_session:
                reg.db.delete(sid)
                continue
            target = assign[sid]
            rec.node = target
            reg.db.store(sid, rec)
            if target == self.broker.node_name:
                # local-origin write: the event path won't build the
                # queue for our own writes — do it directly
                reg.ensure_offline_queue(sid, rec)
            moved += 1
        self.broker.metrics.incr("handoff_auto_evacuations", moved)
        log.warning("auto-evacuated %d session(s) off down member %s "
                    "onto %s", moved, node, live)
        return moved

    async def _rebalance(self) -> None:
        """A member joined (or recovered): move the slices the claim
        rule assigns elsewhere, load-aware. No mesh map = no-op."""
        ho = getattr(self.broker, "handoff", None)
        if ho is None:
            return
        from .handoff import HandoffRefused

        try:
            out = await ho.rebalance_slices(load_of=self.health.load_of)
        except HandoffRefused:
            return
        self.broker.metrics.incr("handoff_auto_rebalances")
        if out["moved"] or out["failed"]:
            log.info("auto-rebalance moved %d slice(s), %d failed",
                     len(out["moved"]), len(out["failed"]))
