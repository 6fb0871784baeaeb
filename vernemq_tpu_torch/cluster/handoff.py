"""Live handoff: freeze -> drain -> fence -> adopt, with rollback.

Elastic rebalancing needs to MOVE things while traffic flows: a mesh
slice from an overloaded node to a fresh one, a persistent session's
queue off a node that is about to leave. Both moves share one failure
shape — the moment between "the old owner stopped serving" and "the new
owner started" is a window where writes can be lost, duplicated, or
accepted by a stale owner — so both ride one reusable four-phase state
machine:

- **freeze**: the current owner stops accepting new writes for the
  moving unit; arrivals are *parked*, not dropped (queue resume-buffer /
  slice claim pin). Bounded by ``handoff_freeze_deadline_ms``.
- **drain**: in-flight state flushes to the successor — the QoS>=1
  backlog in acked ``remote_enqueue`` chunks, pending mesh deltas via a
  matcher ``sync``. Bounded by ``handoff_drain_deadline_s`` and
  observed as ``stage_handoff_drain_ms``.
- **fence**: the epoch-bumped ownership record lands in the replicated
  metadata plane. From here the OLD owner must reject late writes for
  the unit — a stale lower-epoch claim is refused at the slice map, a
  post-fence queue arrival is swept to the new owner instead of landing
  locally (``handoff_fenced_writes``). The epoch rides the same
  ``(claimer, epoch)`` token the adopt-replay guard already keys on.
- **adopt**: the successor replays exactly-once (the adoption token
  dedups) and the unit un-freezes under its new owner.

Every phase runs under a watchdog deadline through the
``cluster.handoff`` fault seam: a wedged drain (injected or real) is
abandoned at the deadline and the whole handoff ROLLS BACK — the unit
un-freezes and the old owner keeps serving, so a failed move degrades
to "nothing happened" rather than a stuck frozen unit. Admission is
gated by the ``handoff`` circuit breaker: repeated rollbacks stop new
handoffs from piling onto a broken successor until a probe recovers.

Operator surface: ``vmq-admin handoff show|drain|rebalance`` and
``vmq-admin cluster drain-node`` (whole-node evacuation: flush closed
filter windows, hand every persistent queue and every owned mesh slice
to the live peers). Bench config 15 ("elastic storm") drills the whole
machine under a QoS1 storm, including the wedged-drain rollback.
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..observability import events
from ..observability import histogram as hist
from ..robustness import faults
from ..robustness.breaker import CircuitBreaker
from .health import assign_targets

log = logging.getLogger("vernemq_tpu_torch.handoff")

#: phases bounded by handoff_freeze_deadline_ms (drain has its own knob)
_FAST_PHASES = ("freeze", "fence", "adopt")


class HandoffRefused(RuntimeError):
    """Handoff not admitted: breaker open, unit not owned here, a move
    for the same unit already in flight, or no viable target."""


class HandoffDeadline(RuntimeError):
    """A handoff phase overran its watchdog deadline and was abandoned
    (the caller rolls back — the old owner keeps serving)."""

    def __init__(self, phase: str, deadline_s: float):
        super().__init__(f"{phase} phase overran its "
                         f"{deadline_s:.3f}s deadline")
        self.phase = phase
        self.deadline_s = deadline_s


class HandoffManager:
    """The reusable freeze/drain/fence/adopt engine (one per broker).

    :meth:`run` is the generic state machine — callers hand it one
    callable per phase plus a rollback; :meth:`transfer_slice` and
    :meth:`handoff_session` are the two unit-specific frontends, and
    :meth:`rebalance_slices` / :meth:`drain_node` the bulk entry points.
    """

    def __init__(self, broker):
        self.broker = broker
        cfg = broker.config
        self.breaker = CircuitBreaker(
            failure_threshold=cfg.get("tpu_breaker_failure_threshold", 3),
            backoff_initial=cfg.get(
                "tpu_breaker_backoff_initial_ms", 200) / 1e3,
            backoff_max=cfg.get("tpu_breaker_backoff_max_ms", 10_000) / 1e3,
            name="handoff")
        #: key ("kind:unit") -> live handoff record (admin `handoff show`)
        self.active: Dict[str, Dict[str, Any]] = {}
        #: completed/rolled-back records, newest last
        self.history: deque = deque(maxlen=64)
        self.started = 0
        self.completed = 0
        self.rollbacks = 0
        self._batch_seq = itertools.count(1)

    # ------------------------------------------------------------ engine

    async def run(self, kind: str, unit: Any, target: str, *,
                  freeze: Callable[[], Any],
                  drain: Callable[[], Any],
                  fence: Callable[[], Any],
                  adopt: Callable[[], Any],
                  rollback: Callable[[], Any]) -> bool:
        """Drive one unit through freeze->drain->fence->adopt.

        Phase callables may be sync or async. Any phase error or
        deadline overrun triggers ``rollback`` (exception-guarded) and
        returns False — the old owner keeps serving. A rollback
        callable that accepts one argument receives the failing phase
        name: the fence is the COMMIT POINT, so a unit can distinguish
        pre-fence failures (undo: old owner serves) from adopt-phase
        failures (roll forward: ownership already transferred). Returns
        True after a completed adopt. Raises :class:`HandoffRefused`
        only for admission failures (nothing was frozen yet)."""
        key = f"{kind}:{unit}"
        if key in self.active:
            raise HandoffRefused(f"handoff already in flight for {key}")
        if not self.breaker.allow():
            raise HandoffRefused(
                f"handoff breaker open (retry in "
                f"{self.breaker.status()['retry_in_s']:.1f}s)")
        cfg = self.broker.config
        max_conc = max(1, int(cfg.get("rebalance_max_concurrent", 4)))
        if len(self.active) >= max_conc:
            # the global limiter: automation (planner cycles racing an
            # operator drain) must not freeze half the node at once
            self.broker.metrics.incr("handoff_auto_limited")
            raise HandoffRefused(
                f"concurrent handoff limit reached "
                f"({len(self.active)}/{max_conc} in flight)")
        freeze_s = max(0.001, float(
            cfg.get("handoff_freeze_deadline_ms", 500)) / 1000.0)
        drain_s = max(0.001, float(
            cfg.get("handoff_drain_deadline_s", 10.0)))
        rec = {"kind": kind, "unit": str(unit), "target": target,
               "phase": "freeze", "started": time.time(),
               "result": "running", "detail": ""}
        self.active[key] = rec
        self.started += 1
        self.broker.metrics.incr("handoff_started")
        events.emit("handoff_start", detail=f"{key}->{target}")
        t0 = time.monotonic()
        try:
            try:
                await self._phase(key, rec, "freeze", freeze, freeze_s)
                td0 = time.monotonic()
                await self._phase(key, rec, "drain", drain, drain_s)
                hist.observe("stage_handoff_drain_ms",
                             (time.monotonic() - td0) * 1e3)
                await self._phase(key, rec, "fence", fence, freeze_s)
                events.emit("handoff_fence", detail=key)
                await self._phase(key, rec, "adopt", adopt, freeze_s)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                phase = rec["phase"]
                self.breaker.record_failure()
                self.rollbacks += 1
                self.broker.metrics.incr("handoff_rollbacks")
                rec["result"] = "rolled_back"
                rec["detail"] = f"{phase}: {e}"
                log.warning("handoff %s -> %s rolled back at %s: %s",
                            key, target, phase, e)
                try:
                    if inspect.signature(rollback).parameters:
                        res = rollback(phase)
                    else:
                        res = rollback()
                    if inspect.isawaitable(res):
                        await res
                except Exception:
                    log.exception("handoff %s rollback itself failed "
                                  "(unit state may need operator "
                                  "attention)", key)
                events.emit("handoff_rollback",
                            detail=f"{key} {phase}: {e}")
                return False
            pause_ms = (time.monotonic() - t0) * 1e3
            self.breaker.record_success()
            self.completed += 1
            self.broker.metrics.incr("handoff_completed")
            hist.observe("stage_handoff_pause_ms", pause_ms)
            rec["result"] = "completed"
            rec["pause_ms"] = round(pause_ms, 3)
            events.emit("handoff_complete", detail=key,
                        value=round(pause_ms, 3))
            log.info("handoff %s -> %s completed (pause %.1fms)",
                     key, target, pause_ms)
            return True
        finally:
            self.active.pop(key, None)
            rec["finished"] = time.time()
            self.history.append(rec)

    async def _phase(self, key: str, rec: Dict[str, Any], phase: str,
                     fn: Callable[[], Any], deadline_s: float) -> Any:
        """One bounded phase. The ``cluster.handoff`` fault seam is
        polled INSIDE the awaited body so an injected wedge is escaped
        by exactly the surrounding deadline (wedge -> timeout ->
        release -> rollback), mirroring the watchdog-abandon contract."""
        rec["phase"] = phase

        async def body():
            await faults.inject_async("cluster.handoff")
            res = fn()
            if inspect.isawaitable(res):
                res = await res
            return res

        wd = getattr(self.broker, "watchdog", None)
        try:
            if wd is not None:
                with wd.monitored("cluster.handoff", deadline_s,
                                  label=f"{key}:{phase}"):
                    return await asyncio.wait_for(body(), deadline_s)
            return await asyncio.wait_for(body(), deadline_s)
        except asyncio.TimeoutError:
            # free a wedge fault the same way watchdog abandonment
            # does, so the seam is reusable for the next drill
            faults.release("cluster.handoff")
            raise HandoffDeadline(phase, deadline_s) from None

    # ------------------------------------------------------- mesh slices

    async def transfer_slice(self, slice_id: int, target: str) -> bool:
        """Move one mesh slice to ``target`` through the four phases:
        pin the claim (freeze), flush pending matcher deltas (drain),
        write the epoch-bumped pinned record (fence — the gossiped
        change IS the successor's adopt trigger), verify + unpin
        (adopt). Rollback unpins; the record never moved, so the old
        owner keeps serving the slice."""
        mm = self.broker.mesh_map
        s = int(slice_id)
        if mm is None:
            raise HandoffRefused("no mesh slice map on this node")
        if not 0 <= s < mm.n_slices:
            raise HandoffRefused(f"slice {s} out of range "
                                 f"(0..{mm.n_slices - 1})")
        if mm.owner(s) != self.broker.node_name:
            raise HandoffRefused(
                f"slice {s} is owned by {mm.owner(s)!r}, not this node")
        if target == self.broker.node_name:
            raise HandoffRefused("target is this node")

        def _drain():
            # flush pending subscription deltas so the successor's
            # adopt-replay starts from a settled table; run off-loop —
            # sync() scatters under the matcher lock
            view = self.broker.registry.reg_views.get("tpu")
            fn = getattr(view, "sync", None)
            if fn is None:
                return None
            loop = asyncio.get_event_loop()
            return loop.run_in_executor(None, fn)

        def _adopt():
            if mm.owner(s) != target:
                raise RuntimeError(
                    f"slice {s} record reads {mm.owner(s)!r} after "
                    f"fence (expected {target!r})")
            mm.unfreeze(s)

        return await self.run(
            "slice", s, target,
            freeze=lambda: mm.freeze(s),
            drain=_drain,
            fence=lambda: mm.transfer_local(s, target),
            adopt=_adopt,
            rollback=lambda: mm.unfreeze(s))

    async def rebalance_slices(
            self, members: Optional[Sequence[str]] = None,
            load_of: Optional[Callable[[str], float]] = None
    ) -> Dict[str, Any]:
        """Move every local slice the deterministic round-robin assigns
        elsewhere (the claim rule, mesh_map.py) to its target, one
        bounded handoff at a time. With ``load_of`` (the health plane's
        gossiped scorer) the claim rule still decides WHICH slices
        leave, but each goes to the least-loaded peer instead of its
        round-robin home. Returns {moved, failed, members}."""
        mm = self.broker.mesh_map
        if mm is None:
            raise HandoffRefused("no mesh slice map on this node")
        if members is None:
            members = (self.broker.cluster.members()
                       if self.broker.cluster is not None
                       else [self.broker.node_name])
        members = sorted(set(members) | {self.broker.node_name})
        provisional: Dict[str, float] = {}
        if load_of is not None:
            provisional = {m: float(load_of(m)) for m in members
                           if m != self.broker.node_name}
        moved: List[int] = []
        failed: List[int] = []
        for s in list(mm.local_slices()):
            target = members[s % len(members)]
            if target == self.broker.node_name:
                continue
            if provisional:
                target = min(provisional,
                             key=lambda m: (provisional[m], m))
            try:
                ok = await self.transfer_slice(s, target)
            except HandoffRefused:
                ok = False
            (moved if ok else failed).append(s)
            if ok and provisional:
                provisional[target] += 0.01  # health._ASSIGN_STEP
        return {"moved": moved, "failed": failed, "members": members}

    # ---------------------------------------------------------- sessions

    async def handoff_session(self, sid, target: str) -> bool:
        """Migrate one persistent session's queue to ``target`` while
        it may be LIVE: park arrivals in the resume buffer (freeze),
        ship the backlog in acked chunks (drain), repoint the
        subscriber record (fence), sweep post-fence stragglers to the
        new owner and terminate locally (adopt). Rollback restores the
        backlog offline and — for a frozen live session — unparks the
        resume buffer so the local session keeps serving."""
        from ..broker.queue import OFFLINE, ONLINE

        broker = self.broker
        queue = broker.registry.queues.get(sid)
        if queue is None:
            raise HandoffRefused(f"no queue for {sid}")
        if queue.opts.clean_session:
            raise HandoffRefused(f"{sid} is clean-session (no state "
                                 "worth moving)")
        if broker.cluster is None:
            raise HandoffRefused("not clustered")
        if target == broker.node_name:
            raise HandoffRefused("target is this node")
        rec0 = broker.registry.db.read(sid)
        if rec0 is None or rec0.node != broker.node_name:
            raise HandoffRefused(f"{sid} is not homed on this node")

        prev = broker.migrations.get(sid) or {}
        mig = {"target": target, "pending": len(queue.offline),
               "retries": 0, "state": "handoff",
               **{k: prev[k] for k in ("tried",) if k in prev}}
        broker.migrations[sid] = mig
        state: Dict[str, Any] = {"frozen_online": False,
                                 "draining": False,
                                 "leftover": [], "shipped": [],
                                 "redirect": None}

        def _freeze():
            if queue.state == ONLINE and not queue._resuming:
                # park live publishes: they buffer instead of hitting
                # the session, exactly the takeover-resume seam
                queue.begin_resume()
                state["frozen_online"] = True

        async def _drain():
            session = broker.sessions.get(sid)
            if (session is not None
                    and getattr(session, "proto_ver", 4) >= 5
                    and broker.config.get("handoff_v5_redirect", True)):
                # MQTT5 server redirect: keep the connection up through
                # the drain — the client learns where its state went
                # only in _adopt (DISCONNECT 0x9C/0x9D with Server
                # Reference, after fence+adopt committed) and then
                # reconnects straight to the new owner instead of
                # bouncing a takeover through this node. Unacked
                # in-flight QoS>=1 detaches into the head of the
                # backlog: redelivery at the target beats loss.
                state["redirect"] = session
                backlog = session.detach_inflight()
                backlog.extend(queue.start_drain())
            else:
                if session is not None:
                    await session.takeover_close()
                backlog = queue.start_drain()  # supersedes the parking
            state["draining"] = True
            state["leftover"] = backlog
            mig["pending"] = len(backlog)
            await self._ship(sid, target, backlog, state, mig)
            while True:
                more = queue.drain_pending()
                if not more:
                    break
                state["leftover"] = more
                mig["pending"] = len(more)
                await self._ship(sid, target, more, state, mig)

        def _fence():
            rec = broker.registry.db.read(sid)
            if rec is None:
                raise RuntimeError(f"subscriber record for {sid} "
                                   "vanished mid-handoff")
            rec.node = target
            broker.registry.db.store(sid, rec)

        async def _adopt():
            # sweep arrivals that raced the fence: they belong to the
            # new owner now, not the local (dying) queue
            while True:
                late = queue.drain_pending()
                if not late:
                    break
                broker.metrics.incr("handoff_fenced_writes", len(late))
                await self._ship(sid, target, late, state, mig)
            sess = state["redirect"]
            if sess is not None:
                # state is fenced and shipped: NOW tell the v5 client
                # where it lives. Its close may park one last
                # straggler — sweep once more behind it.
                await sess.redirect_close(
                    broker.cluster.server_reference(target))
                late = queue.drain_pending()
                if late:
                    broker.metrics.incr("handoff_fenced_writes",
                                        len(late))
                    await self._ship(sid, target, late, state, mig)
            broker.delete_offline(sid)
            broker.metrics.incr("queue_migrated")
            # clean_session stays False: queue_terminated must NOT
            # delete the subscriber record — the new owner owns it now
            queue.terminate("migrated")
            broker.migrations.pop(sid, None)

        def _rollback(phase: str):
            if phase == "adopt":
                # the fence committed: the record points at the target
                # and the backlog already shipped. Rolling BACK would
                # strand the unit between owners — roll FORWARD instead:
                # park any sweep leftovers offline and hand the finish
                # (re-ship tail, delete store, terminate) to the legacy
                # bounded-retry drain, which owns exactly this shape.
                leftover = list(state["leftover"])
                leftover.extend(queue.drain_pending())
                queue.offline.extend(leftover)
                queue.state = OFFLINE
                queue._arm_expiry()
                mig["state"] = "failed"
                mig["pending"] = len(leftover)
                broker.on_subscriber_moved(sid, target)
                return
            if state["draining"]:
                # at-least-once: restore EVERYTHING locally — including
                # chunks the target already acked. The record still
                # points here, so a copy living only in the target's
                # unowned queue would be invisible to the client; the
                # target's copies surface as dupes if a later handoff
                # succeeds — like any QoS1 redelivery, dupes beat loss.
                leftover = list(state["shipped"])
                leftover.extend(state["leftover"])
                leftover.extend(queue.drain_pending())
                sess = state["redirect"]
                if sess is not None and broker.sessions.get(sid) is sess:
                    # redirect drain: the client never saw a DISCONNECT
                    # and is still connected — re-enter ONLINE and
                    # redeliver locally instead of parking offline
                    queue.restore_online(leftover)
                    broker.metrics.incr("queue_drain_failed")
                    broker.migrations.pop(sid, None)
                    return
                queue.offline.extend(leftover)
                queue.state = OFFLINE
                queue._arm_expiry()  # start_drain cancelled the clock
                mig["state"] = "failed"
                mig["pending"] = len(leftover)
                broker.metrics.incr("queue_drain_failed")
            elif state["frozen_online"]:
                # nothing shipped: unpark the resume buffer, the live
                # session never noticed
                queue.finish_resume([])
                broker.migrations.pop(sid, None)
            else:
                broker.migrations.pop(sid, None)

        return await self.run(
            "session", _sid_label(sid), target,
            freeze=_freeze, drain=_drain, fence=_fence, adopt=_adopt,
            rollback=_rollback)

    async def _ship(self, sid, target: str, backlog: List[Any],
                    state: Dict[str, Any], mig: Dict[str, Any]) -> None:
        """Ship ``backlog`` to ``target`` in acked chunks; raises on the
        first failed/unacked chunk (the drain deadline and rollback own
        retry policy). Tracks the unshipped tail for rollback."""
        if not backlog:
            return
        step = max(1, int(self.broker.config.max_msgs_per_drain_step))
        for i in range(0, len(backlog), step):
            chunk = backlog[i:i + step]
            try:
                ok = await self.broker.cluster.remote_enqueue(
                    target, sid, chunk, migrate=True)
            except (ConnectionError, asyncio.TimeoutError) as e:
                raise RuntimeError(f"remote_enqueue to {target} failed: "
                                   f"{e}") from e
            if not ok:
                raise RuntimeError(f"{target} nacked enqueue chunk")
            state["shipped"].extend(chunk)
            state["leftover"] = backlog[i + len(chunk):]
            mig["pending"] = len(state["leftover"])

    async def handoff_sessions_batch(self, sids: Sequence[Any],
                                     target: str) -> Any:
        """Migrate MANY persistent sessions to one ``target`` through a
        single four-phase handoff: freeze all, drain all, then ONE
        fence write for the whole batch (``store_many`` — the
        per-session record rewrite is what made big drains O(sessions)
        metadata epoch bumps), adopt all. A wedge anywhere fails the
        whole batch and rollback is per-session (pre-fence undo /
        post-fence roll-forward), so the caller can retry stragglers
        individually. Returns ``(ok, eligible_sids)``; raises
        :class:`HandoffRefused` when nothing in the batch is movable."""
        from ..broker.queue import OFFLINE, ONLINE

        broker = self.broker
        if broker.cluster is None:
            raise HandoffRefused("not clustered")
        if target == broker.node_name:
            raise HandoffRefused("target is this node")
        units: List[Any] = []
        for sid in sids:
            queue = broker.registry.queues.get(sid)
            if queue is None or queue.opts.clean_session:
                continue
            rec = broker.registry.db.read(sid)
            if rec is None or rec.node != broker.node_name:
                continue
            if f"session:{_sid_label(sid)}" in self.active:
                continue  # an individual move already owns it
            units.append((sid, queue))
        if not units:
            raise HandoffRefused("no eligible sessions in batch")
        states: Dict[Any, Dict[str, Any]] = {}
        for sid, queue in units:
            prev = broker.migrations.get(sid) or {}
            mig = {"target": target, "pending": len(queue.offline),
                   "retries": 0, "state": "handoff",
                   **{k: prev[k] for k in ("tried",) if k in prev}}
            broker.migrations[sid] = mig
            states[sid] = {"mig": mig, "frozen_online": False,
                           "draining": False, "adopted": False,
                           "leftover": [], "shipped": [],
                           "redirect": None}

        def _freeze():
            for sid, queue in units:
                if queue.state == ONLINE and not queue._resuming:
                    queue.begin_resume()
                    states[sid]["frozen_online"] = True

        async def _drain():
            redirect_on = broker.config.get("handoff_v5_redirect", True)
            for sid, queue in units:
                st = states[sid]
                session = broker.sessions.get(sid)
                if (session is not None and redirect_on
                        and getattr(session, "proto_ver", 4) >= 5):
                    st["redirect"] = session
                    backlog = session.detach_inflight()
                    backlog.extend(queue.start_drain())
                else:
                    if session is not None:
                        await session.takeover_close()
                    backlog = queue.start_drain()
                st["draining"] = True
                st["leftover"] = backlog
                st["mig"]["pending"] = len(backlog)
                await self._ship(sid, target, backlog, st, st["mig"])
                while True:
                    more = queue.drain_pending()
                    if not more:
                        break
                    st["leftover"] = more
                    st["mig"]["pending"] = len(more)
                    await self._ship(sid, target, more, st, st["mig"])

        def _fence():
            pairs = []
            for sid, _q in units:
                rec = broker.registry.db.read(sid)
                if rec is None:
                    raise RuntimeError(
                        f"subscriber record for {_sid_label(sid)} "
                        "vanished mid-handoff")
                rec.node = target
                pairs.append((sid, rec))
            # the single logical fence for the whole batch: one sweep,
            # one counter tick, one journal event — not len(units)
            # separate epoch bumps
            broker.registry.db.store_many(pairs)
            broker.metrics.incr("handoff_batch_fence_writes")

        async def _adopt():
            for sid, queue in units:
                st = states[sid]
                while True:
                    late = queue.drain_pending()
                    if not late:
                        break
                    broker.metrics.incr("handoff_fenced_writes",
                                        len(late))
                    await self._ship(sid, target, late, st, st["mig"])
                sess = st["redirect"]
                if sess is not None:
                    await sess.redirect_close(
                        broker.cluster.server_reference(target))
                    late = queue.drain_pending()
                    if late:
                        broker.metrics.incr("handoff_fenced_writes",
                                            len(late))
                        await self._ship(sid, target, late, st,
                                         st["mig"])
                broker.delete_offline(sid)
                broker.metrics.incr("queue_migrated")
                queue.terminate("migrated")
                broker.migrations.pop(sid, None)
                st["adopted"] = True

        def _rollback(phase: str):
            for sid, queue in units:
                st = states[sid]
                mig = st["mig"]
                if st["adopted"]:
                    continue  # fully handed over before the failure
                if phase == "adopt":
                    # the batch fence committed: roll FORWARD — the
                    # legacy bounded-retry drain finishes the tail
                    leftover = list(st["leftover"])
                    leftover.extend(queue.drain_pending())
                    queue.offline.extend(leftover)
                    queue.state = OFFLINE
                    queue._arm_expiry()
                    mig["state"] = "failed"
                    mig["pending"] = len(leftover)
                    broker.on_subscriber_moved(sid, target)
                elif st["draining"]:
                    leftover = list(st["shipped"])
                    leftover.extend(st["leftover"])
                    leftover.extend(queue.drain_pending())
                    sess = st["redirect"]
                    if (sess is not None
                            and broker.sessions.get(sid) is sess):
                        queue.restore_online(leftover)
                        broker.metrics.incr("queue_drain_failed")
                        broker.migrations.pop(sid, None)
                        continue
                    queue.offline.extend(leftover)
                    queue.state = OFFLINE
                    queue._arm_expiry()
                    mig["state"] = "failed"
                    mig["pending"] = len(leftover)
                    broker.metrics.incr("queue_drain_failed")
                elif st["frozen_online"]:
                    queue.finish_resume([])
                    broker.migrations.pop(sid, None)
                else:
                    broker.migrations.pop(sid, None)

        label = f"{len(units)}@{target}#{next(self._batch_seq)}"
        ok = await self.run(
            "batch", label, target,
            freeze=_freeze, drain=_drain, fence=_fence, adopt=_adopt,
            rollback=_rollback)
        return ok, [sid for sid, _q in units]

    # ------------------------------------------------------- node drain

    async def drain_node(
            self, targets: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """Evacuate this node for a restart/scale-in: flush closed
        filter windows (their partial aggregates would otherwise die
        with the process), spread every persistent queue over the live
        peers — greedy least-loaded by the gossiped health score when
        available, name-ordered ties otherwise — then move every owned
        mesh slice the same way. Sessions bound for the same peer move
        in BATCHED handoffs sharing one fence write per (batch,
        target); a failed batch retries its members individually, so
        one wedged session never strands its batch-mates."""
        broker = self.broker
        if targets is None:
            if broker.cluster is None:
                raise HandoffRefused("not clustered")
            targets = [n for n in broker.cluster.members(include_self=False)
                       if broker.cluster._status.get(n) == "up"]
        targets = [t for t in targets if t != broker.node_name]
        if not targets:
            raise HandoffRefused("no live peers to drain to")
        flushed = 0
        if broker.filter_engine is not None:
            try:
                flushed = broker.filter_engine.flush_windows()
            except Exception:
                log.exception("drain-node: filter window flush failed")
        health = (getattr(broker.cluster, "health", None)
                  if broker.cluster is not None else None)
        load_of = (health.load_of if health is not None
                   else (lambda n: 0.0))
        sessions = {"moved": 0, "failed": 0, "skipped": 0}
        eligible: List[Any] = []
        for sid, queue in list(broker.registry.queues.items()):
            if queue.opts.clean_session:
                sessions["skipped"] += 1
                continue
            rec = broker.registry.db.read(sid)
            if rec is None or rec.node != broker.node_name:
                sessions["skipped"] += 1
                continue
            eligible.append(sid)
        assign = assign_targets(eligible, sorted(targets), load_of)
        by_target: Dict[str, List[Any]] = {}
        for sid in eligible:
            by_target.setdefault(assign[sid], []).append(sid)
        batch_max = max(1, int(broker.config.get(
            "handoff_batch_max_sessions", 64)))
        for tgt in sorted(by_target):
            group = by_target[tgt]
            for i in range(0, len(group), batch_max):
                chunk = group[i:i + batch_max]
                if len(chunk) > 1:
                    try:
                        ok, moved_sids = await self.handoff_sessions_batch(
                            chunk, tgt)
                    except HandoffRefused:
                        ok = False
                    if ok:
                        sessions["moved"] += len(moved_sids)
                        continue
                # singleton chunk, or a failed batch retried one by one
                for sid in chunk:
                    rec = broker.registry.db.read(sid)
                    if rec is not None and rec.node != broker.node_name:
                        # the batch adopted (or rolled forward) this
                        # one before failing — it left this node
                        sessions["moved"] += 1
                        continue
                    try:
                        ok = await self.handoff_session(sid, tgt)
                    except HandoffRefused:
                        ok = False
                    sessions["moved" if ok else "failed"] += 1
        slices = {"moved": [], "failed": []}
        if broker.mesh_map is not None:
            provisional = {t: float(load_of(t)) for t in targets}
            for s in list(broker.mesh_map.local_slices()):
                tgt = min(provisional, key=lambda m: (provisional[m], m))
                try:
                    ok = await self.transfer_slice(s, tgt)
                except HandoffRefused:
                    ok = False
                slices["moved" if ok else "failed"].append(s)
                if ok:
                    provisional[tgt] += 0.01  # health._ASSIGN_STEP
        return {"windows_flushed": flushed, "sessions": sessions,
                "slices": slices, "targets": sorted(targets)}

    # ------------------------------------------------------------ status

    def status_rows(self) -> List[Dict[str, Any]]:
        """Admin `handoff show`: in-flight first, then recent history."""
        now = time.time()
        rows = []
        for rec in self.active.values():
            rows.append({"kind": rec["kind"], "unit": rec["unit"],
                         "target": rec["target"], "phase": rec["phase"],
                         "result": rec["result"],
                         "age_s": round(now - rec["started"], 3)})
        for rec in reversed(self.history):
            rows.append({"kind": rec["kind"], "unit": rec["unit"],
                         "target": rec["target"], "phase": rec["phase"],
                         "result": rec["result"],
                         "age_s": round(now - rec.get(
                             "finished", rec["started"]), 3)})
        return rows


def _sid_label(sid) -> str:
    """Stable printable unit id for a subscriber id tuple."""
    try:
        mp, cid = sid
        return f"{mp or ''}/{cid}"
    except Exception:
        return str(sid)
