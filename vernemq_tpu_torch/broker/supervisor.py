"""Crash-restart supervision for broker background work.

The reference's OTP supervision tree (``vmq_server_sup.erl:43-58``,
one_for_one with max-restart intensity) restarts crashed children —
listeners, reporters, cluster writers — without taking the broker down.
asyncio has no supervisor, so this is the analog: named supervised tasks
that restart on unexpected exceptions with exponential backoff, restarts
surfaced in the ``supervisor_restarts`` metric, plus a listener watchdog
that re-binds a listener whose server socket died.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Callable, Dict, Optional

from ..observability import events

log = logging.getLogger("vernemq_tpu_torch.supervisor")


class Supervisor:
    """Restart-on-crash task supervision (one_for_one).

    Hardened against restart storms: backoff is exponential with jitter
    and a hard cap (no thundering-herd restarts, no busy-spin when a
    child crashes instantly every time), and a restart *budget* —
    more than ``max_restarts`` CONSECUTIVE crashy restarts (a stint
    healthier than the current backoff, or longer than
    ``restart_window`` seconds, resets the count) — past which
    supervision of that child ESCALATES instead of looping forever: the
    child is abandoned, ``supervisor_escalations`` counts it, and the
    broker's listeners are torn down so load balancers route around the
    sick node (the OTP max-intensity analog: a supervisor that gives up
    takes its subtree down rather than thrash). The budget is counted
    in restarts, not wall-clock: exponential backoff spaces crashes
    out, so a time window would never fill and escalation would be
    unreachable."""

    def __init__(self, broker, backoff_initial: float = 0.5,
                 backoff_max: float = 30.0, jitter: float = 0.1,
                 max_restarts: int = 0, restart_window: float = 60.0,
                 rng=None):
        import random

        self.broker = broker
        self.backoff_initial = backoff_initial
        self.backoff_max = backoff_max
        self.jitter = jitter
        # 0 = unlimited (no escalation) — the pre-hardening behavior
        self.max_restarts = max_restarts
        self.restart_window = restart_window
        self._rng = rng or random.Random()
        self._tasks: Dict[str, asyncio.Task] = {}
        self.restarts: Dict[str, int] = {}
        self.backoffs: Dict[str, float] = {}  # current per-child backoff
        self.escalated: Dict[str, int] = {}   # children given up on
        self._stopped = False

    def spawn(self, name: str, factory: Callable[[], Awaitable[Any]]) -> None:
        """Supervise ``factory``: it is (re)invoked to produce the child
        coroutine after every crash. Normal return or cancellation ends
        supervision (transient semantics — like OTP ``transient``)."""
        if name in self._tasks and not self._tasks[name].done():
            raise RuntimeError(f"supervised task {name!r} already running")
        self._tasks[name] = asyncio.get_event_loop().create_task(
            self._run(name, factory))

    async def _run(self, name: str,
                   factory: Callable[[], Awaitable[Any]]) -> None:
        backoff = self.backoff_initial
        consecutive = 0
        loop = asyncio.get_event_loop()
        while not self._stopped:
            started = loop.time()
            try:
                await factory()
                return  # clean exit
            except asyncio.CancelledError:
                raise
            except Exception:
                if self._stopped:
                    return
                self.restarts[name] = self.restarts.get(name, 0) + 1
                self.broker.metrics.incr("supervisor_restarts")
                events.emit("supervisor_restart", detail=name,
                            value=float(self.restarts[name]))
                # a healthy stint (longer than the current backoff, or
                # past the restart window outright) resets the ramp AND
                # the budget: only consecutive rapid crashes climb
                # toward the cap / escalation
                healthy_after = min(self.restart_window,
                                    max(backoff, self.backoff_initial))
                if loop.time() - started > healthy_after:
                    backoff = self.backoff_initial
                    consecutive = 0
                consecutive += 1
                if self.max_restarts and consecutive > self.max_restarts:
                    await self._escalate(name)
                    return
                log.exception("supervised task %r crashed (restart #%d in "
                              "%.1fs)", name, self.restarts[name], backoff)
                # jittered sleep, capped: crash-looping children settle
                # at backoff_max instead of busy-spinning, and several
                # children felled by one cause don't restart in lockstep
                await asyncio.sleep(
                    backoff * (1.0 + self.jitter * self._rng.random()))
                backoff = min(backoff * 2, self.backoff_max)
                self.backoffs[name] = backoff

    async def _escalate(self, name: str) -> None:
        """The restart budget is spent: stop supervising ``name`` and
        take the node out of rotation by tearing down its listeners —
        a broker that cannot keep its children alive must fail its
        health checks loudly, not limp with a dead subsystem."""
        self.escalated[name] = self.escalated.get(name, 0) + 1
        self.broker.metrics.incr("supervisor_escalations")
        events.emit("supervisor_escalation", detail=name)
        log.error("supervised task %r exceeded the restart budget "
                  "(%d consecutive crashy restarts); escalating: tearing "
                  "down listeners", name, self.max_restarts)
        mgr = getattr(self.broker, "listeners", None)
        if mgr is not None:
            try:
                await mgr.stop_all()
            except Exception:
                log.exception("listener teardown during escalation failed")

    def watch_listeners(self, interval: float = 1.0) -> None:
        """Listener watchdog: a listener whose asyncio server stopped
        serving (crash, EMFILE storm, ...) without being stopped through
        the manager is re-bound on its address — the role of ranch
        restarting a crashed acceptor pool under vmq_ranch_sup."""
        self.spawn("listener-watchdog", lambda: self._watch_listeners(interval))

    async def _watch_listeners(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            mgr = self.broker.listeners
            if mgr is None:
                continue
            for (addr, port), entry in list(mgr._listeners.items()):
                server = entry.get("server")
                srv = getattr(server, "_server", None)
                if srv is None or srv.is_serving():
                    continue
                self.restarts["listener"] = self.restarts.get("listener", 0) + 1
                self.broker.metrics.incr("supervisor_restarts")
                log.warning("listener %s:%d (%s) died; restarting",
                            addr, port, entry["kind"])
                mgr._listeners.pop((addr, port), None)
                try:
                    await mgr.start_listener(entry["kind"], addr, port,
                                             entry.get("opts"))
                except Exception:
                    log.exception("listener %s:%d restart failed; will "
                                  "retry on next tick", addr, port)
                    # leave the record out; retry happens because the next
                    # scan no longer sees it... so re-insert a dead record
                    mgr._listeners[(addr, port)] = entry

    def stop(self) -> None:
        self._stopped = True
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()
