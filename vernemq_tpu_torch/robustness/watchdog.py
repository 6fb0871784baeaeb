"""Deadline watchdog for *silent* stalls on the broker's hot paths.

Every failure the robustness layer handled before this module is loud:
the breaker counts exceptions, the spool replays on reconnect, the
governor reads lag. The failure mode that dominates accelerator fleets
is silent — a device dispatch that never returns (preemption
mid-transfer, a compile stall), a half-open TCP peer whose writes
succeed but whose acks never arrive, a background rebuild thread that
wedges. None of those raise; they just stop, and whatever awaited them
stops too.

The :class:`StallWatchdog` closes that gap with two mechanisms sharing
one monitored-operation registry:

- **Sacrificial dispatch** (:meth:`StallWatchdog.dispatch_async` /
  :meth:`dispatch`): the blocking call runs on a
  :class:`SacrificialExecutor` worker and the waiter waits at most the
  op's deadline. Past it, the waiter is *released immediately* with
  :class:`StallAbandoned` (the caller serves from its host fallback and
  feeds its breaker); the wedged worker thread is sacrificed — the pool
  simply spawns around it — and carries a generation/abandon token: when
  the call eventually completes, it notices the token, its result is
  **discarded** (``watchdog_late_discarded``), and any success/failure
  verdict it would have recorded is suppressed (see
  ``TpuMatcher._record_device_success``), so a stale fanout from an
  abandoned dispatch can never be delivered after a rebuild, and a late
  success can never close a breaker the stall opened.

- **Registry monitoring** (:meth:`register` / :meth:`monitored`): waits
  that cannot be abandoned from the outside — a background rebuild
  thread, a delta scatter under the matcher lock, a loop-side store
  write, cluster peer ack progress — register ``(point, started_at,
  deadline)``. A monitor thread scans every ``tick_s`` for overdue ops:
  each is counted (``watchdog_stalls``), logged once, and ops registered
  with an ``on_stall`` callback are abandoned through it (the rebuild
  case: the matcher marks the build's token, feeds the breaker, and
  ``sync()`` re-arms — extending the failed-rebuild rule to wedged
  rebuilds).

Abandoning an op also releases any ``wedge`` fault injected at its
point (:func:`faults.release`) — an injected hang is escapable by
exactly the surrounding timeout that abandons it, which is what lets
tests and chaos soaks exercise true hangs end to end (wedge → stall →
abandon → late completion → discard) deterministically.

The registry doubles as the operator surface: ``vmq-admin watchdog
show`` lists in-flight ops with ages, and ``watchdog_inflight_age_max``
is the scrape-time gauge a fleet alert can sit on.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import faults
from ..observability import events

log = logging.getLogger("vernemq_tpu_torch.watchdog")

# the sacrificial worker publishes its current op here so code running
# INSIDE a dispatched call (matcher breaker bookkeeping, late-result
# paths) can ask "was I abandoned?" without plumbing tokens through
# every layer. Module-level: ops are per-call objects, so sharing the
# slot across watchdog instances is safe.
_tls = threading.local()


def current_op() -> Optional["MonitoredOp"]:
    """The op of the sacrificial dispatch running on THIS thread, if
    any (None on the loop, pool threads, and unmonitored calls)."""
    return getattr(_tls, "op", None)


def current_op_abandoned() -> bool:
    """True when this thread is executing a dispatch whose waiter was
    already released by the deadline watchdog: results are stale, must
    be discarded, and must not feed any breaker verdict."""
    op = current_op()
    return op is not None and op.abandoned


class StallAbandoned(Exception):
    """A monitored operation exceeded its deadline: the waiter was
    released (the op itself may still be running on its sacrificial
    thread — its eventual result is discarded)."""

    def __init__(self, point: str, waited_s: float, label: str = ""):
        super().__init__(
            f"{point}{f' [{label}]' if label else ''} stalled past its "
            f"{waited_s:.3f}s deadline; waiter released, result will be "
            f"discarded")
        self.point = point
        self.waited_s = waited_s
        self.label = label


class MonitoredOp:
    """One registered cross-boundary wait."""

    __slots__ = ("id", "point", "label", "started_at", "deadline_s",
                 "abandoned", "stalled", "on_stall", "sacrificial")

    def __init__(self, op_id: int, point: str, deadline_s: float,
                 label: str = "",
                 on_stall: Optional[Callable[["MonitoredOp"], None]] = None,
                 started_at: Optional[float] = None):
        self.id = op_id
        self.point = point
        self.label = label
        self.started_at = (time.monotonic()
                           if started_at is None else started_at)
        self.deadline_s = deadline_s
        self.abandoned = False   # waiter released / op given up
        self.stalled = False     # observed past deadline (counted once)
        self.on_stall = on_stall
        self.sacrificial = False  # runs on an executor worker (dispatch)

    def age(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.monotonic()) \
            - self.started_at


class SacrificialExecutor:
    """Grow-on-wedge thread pool for abandonable dispatches.

    ``submit`` hands work to an idle worker or spawns a new one; a
    worker wedged inside an abandoned call is simply *not idle*, so the
    pool spawns around it — the wedged thread is sacrificed (daemon; it
    either completes late and rejoins the pool, or dies with the
    process). This is why device dispatches must NOT run on the shared
    default executor: one wedge there permanently eats a pool slot that
    session IO and warmups also need."""

    _IDLE_EXIT_S = 30.0  # idle workers wind down (bounds thread count)

    def __init__(self, name: str = "sacrificial"):
        self.name = name
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._idle = 0
        self._seq = itertools.count(1)
        self._closed = False
        self.spawned = 0  # workers ever started (gauge: growth = wedges)

    def submit(self, fn: Callable[[], Any]):
        """Run ``fn()`` on a worker; returns a
        ``concurrent.futures.Future``. The enqueue happens UNDER the
        pool lock: a worker's idle-exit does its final queue drain under
        the same lock, so either that worker sees this item or this
        submit sees ``_idle == 0`` and spawns — an item can never be
        orphaned between a racing timeout and the put (which would
        surface as a spurious StallAbandoned feeding the breaker a
        failure on a healthy device)."""
        import concurrent.futures

        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError("executor closed"))
                return fut
            spawn = self._idle == 0
            if spawn:
                self.spawned += 1
                n = next(self._seq)
            self._q.put((fut, fn))
        if spawn:
            # vmqlint: allow(thread-lifecycle): sacrificial by contract
            # — a worker wedged in an abandoned call is spawned AROUND,
            # never joined; close() flips _closed and live workers exit
            # on their next queue pass (the whole point of this pool)
            threading.Thread(target=self._worker,
                             name=f"{self.name}-{n}",
                             daemon=True).start()
        return fut

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def _worker(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
                self._idle += 1
            try:
                item = self._q.get(timeout=self._IDLE_EXIT_S)
            except queue.Empty:
                with self._lock:
                    self._idle -= 1
                    # final drain under the lock: a submit that saw us
                    # idle (and so did not spawn) enqueues under this
                    # same lock — take its item now or exit knowing the
                    # next submit will observe _idle == 0 and spawn
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        return
            else:
                with self._lock:
                    self._idle -= 1
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                res = fn()
            except BaseException as e:
                fut.set_exception(e)
            else:
                fut.set_result(res)


class StallWatchdog:
    """Monitored-operation registry + overdue-op monitor + sacrificial
    dispatch. One instance per broker (collectors, matchers and the
    cluster all hold the same one); standalone instances are fine for
    unit tests."""

    def __init__(self, tick_s: float = 0.1,
                 clock: Callable[[], float] = time.monotonic):
        self.tick_s = tick_s
        self._clock = clock
        self._lock = threading.Lock()
        self._ops: Dict[int, MonitoredOp] = {}
        self._ids = itertools.count(1)
        self._executor = SacrificialExecutor(name="tpu-dispatch")
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # counters (exported as watchdog_* gauges)
        self.stalls = 0          # ops observed past their deadline
        self.abandoned = 0       # waiters released / ops given up
        self.late_discarded = 0  # abandoned ops that completed late
        self.cluster_stalls = 0  # ack-progress stalls (channel cycled)
        self.sacrificed = 0      # executor workers lost to abandoned ops

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Start the overdue-op monitor (idempotent)."""
        if self._monitor is not None and self._monitor.is_alive():
            return
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="stall-watchdog", daemon=True)
        self._monitor.start()

    def stop(self) -> None:
        self._stop.set()
        m = self._monitor
        if m is not None:
            m.join(timeout=2.0)
            self._monitor = None
        self._executor.close()

    # ------------------------------------------------------------- registry

    def register(self, point: str, deadline_s: float, label: str = "",
                 on_stall: Optional[Callable[[MonitoredOp], None]] = None,
                 started_at: Optional[float] = None) -> MonitoredOp:
        """Register a cross-boundary wait. The monitor counts it as a
        stall once past ``deadline_s``; ``on_stall`` (called from the
        monitor thread, exception-guarded) additionally ABANDONS the op
        through the callback — the registrant marks its token, feeds its
        breaker, releases its waiters."""
        op = MonitoredOp(next(self._ids), point, deadline_s, label,
                         on_stall, started_at)
        with self._lock:
            self._ops[op.id] = op
        return op

    def deregister(self, op: MonitoredOp) -> None:
        with self._lock:
            self._ops.pop(op.id, None)

    def touch(self, op: MonitoredOp,
              started_at: Optional[float] = None) -> None:
        """Progress was observed: restart the op's deadline clock (the
        long-lived cluster-ack ops re-arm per cumulative ack)."""
        with self._lock:
            op.started_at = (self._clock()
                             if started_at is None else started_at)
            op.stalled = False

    class _Monitored:
        __slots__ = ("_wd", "_op", "_args")

        def __init__(self, wd, args):
            self._wd = wd
            self._args = args
            self._op = None

        def __enter__(self):
            self._op = self._wd.register(*self._args)
            return self._op

        def __exit__(self, *exc):
            self._wd.deregister(self._op)
            return False

    def monitored(self, point: str, deadline_s: float, label: str = ""):
        """Context manager: register for the duration of a synchronous
        wait that cannot be abandoned (delta scatter under the matcher
        lock, a loop-side store write) — overdue = counted + logged, so
        a wedge there is at least *visible* while its own bounded seam
        (injection caps, lock timeouts) does the escaping."""
        return self._Monitored(self, (point, deadline_s, label))

    # ------------------------------------------------- sacrificial dispatch

    def _run_op(self, op: MonitoredOp, fn: Callable[[], Any],
                on_late: Optional[Callable[[Any], None]]) -> Any:
        _tls.op = op
        try:
            try:
                res = fn()
            except BaseException:
                if op.abandoned:
                    # late failure of an abandoned call: the waiter is
                    # long gone and already served host-side — swallow
                    # (an unretrieved exception would only spam logs)
                    with self._lock:
                        self.late_discarded += 1
                    events.emit("watchdog_late_discard",
                                detail=f"{op.point} error")
                    log.info("abandoned %s [%s] completed late with an "
                             "error (discarded)", op.point, op.label)
                    return None
                raise
            if op.abandoned:
                with self._lock:
                    self.late_discarded += 1
                events.emit("watchdog_late_discard",
                            detail=f"{op.point} {op.label}".strip(),
                            value=round(op.age(), 4))
                log.warning(
                    "abandoned %s [%s] completed at age %.3fs (deadline "
                    "%.3fs); result discarded (never delivered)",
                    op.point, op.label, op.age(), op.deadline_s)
                if on_late is not None:
                    try:
                        on_late(res)
                    except Exception:
                        log.exception("on_late hook for %s failed",
                                      op.point)
                return None
            return res
        finally:
            _tls.op = None
            self.deregister(op)

    def _abandon(self, op: MonitoredOp) -> None:
        with self._lock:
            if op.abandoned:
                return
            op.abandoned = True
            self.abandoned += 1
            if op.sacrificial:
                # the worker running this op is lost to it until the
                # wedge ends; the pool spawns around it
                self.sacrificed += 1
            newly_stalled = not op.stalled
            if newly_stalled:
                op.stalled = True
                self.stalls += 1
        detail = f"{op.point} {op.label}".strip()
        if newly_stalled:
            # a deadline-released dispatch abandons without passing
            # through the monitor scan: its stall event is owed here
            events.emit("watchdog_stall", detail=detail,
                        value=round(op.age(), 4))
        events.emit("watchdog_abandon", detail=detail,
                    value=round(op.age(), 4))
        # an injected wedge at this point ends at abandonment: the
        # sacrificial thread unblocks, completes late, and exercises
        # the discard path — the deterministic drill for real hangs
        faults.release(op.point)

    def abandon(self, op: MonitoredOp) -> None:
        """Give up on a registered op from outside (cluster ack-stall:
        the channel is cycled, the op's window restarts)."""
        self._abandon(op)

    async def dispatch_async(self, point: str, fn: Callable[[], Any],
                             deadline_s: float, label: str = "",
                             on_late: Optional[Callable[[Any], None]]
                             = None) -> Any:
        """Await ``fn()`` on the sacrificial executor for at most
        ``deadline_s``; past it the op is abandoned and
        :class:`StallAbandoned` raised (the asyncio face of
        :meth:`dispatch`)."""
        import asyncio

        op = self.register(point, deadline_s, label)
        op.sacrificial = True
        cfut = self._executor.submit(
            lambda: self._run_op(op, fn, on_late))
        afut = asyncio.wrap_future(cfut)
        try:
            return await asyncio.wait_for(asyncio.shield(afut),
                                          deadline_s)
        except asyncio.TimeoutError:
            self._abandon(op)
            # a late error that raced the abandon flag may still land on
            # the orphaned future: consume it so asyncio never logs an
            # unretrieved-exception warning for a result we discarded
            afut.add_done_callback(
                lambda f: None if f.cancelled() else f.exception())
            raise StallAbandoned(point, deadline_s, label) from None

    def dispatch(self, point: str, fn: Callable[[], Any],
                 deadline_s: float, label: str = "",
                 on_late: Optional[Callable[[Any], None]] = None) -> Any:
        """Synchronous sacrificial dispatch (tests, non-loop callers)."""
        import concurrent.futures

        op = self.register(point, deadline_s, label)
        op.sacrificial = True
        cfut = self._executor.submit(
            lambda: self._run_op(op, fn, on_late))
        try:
            return cfut.result(timeout=deadline_s)
        except concurrent.futures.TimeoutError:
            self._abandon(op)
            raise StallAbandoned(point, deadline_s, label) from None

    # -------------------------------------------------------------- monitor

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self._scan()
            except Exception:
                log.exception("watchdog scan failed (next tick retries)")

    def _scan(self) -> None:
        now = self._clock()
        overdue: List[MonitoredOp] = []
        with self._lock:
            for op in self._ops.values():
                if (not op.stalled and op.deadline_s > 0
                        and op.age(now) > op.deadline_s):
                    op.stalled = True
                    self.stalls += 1
                    overdue.append(op)
        for op in overdue:
            log.warning("stall: %s [%s] in flight %.3fs past its %.3fs "
                        "deadline", op.point, op.label, op.age(now),
                        op.deadline_s)
            events.emit("watchdog_stall",
                        detail=f"{op.point} {op.label}".strip(),
                        value=round(op.age(now), 4))
            if op.on_stall is not None:
                # on_stall ops carry abandon semantics (rebuild threads):
                # the callback marks the registrant's token/breaker, and
                # the abandon releases any wedge fault at the point so
                # the drill can complete late and exercise the discard
                try:
                    op.on_stall(op)
                except Exception:
                    log.exception("on_stall for %s failed", op.point)
                self._abandon(op)

    # -------------------------------------------------------- introspection

    def note_late_discard(self, point: str, why: str = "") -> None:
        """An abandoned operation completed late OUTSIDE the sacrificial
        path (a rebuild thread discarding its stale install) — count it
        with the dispatch-level late discards."""
        with self._lock:
            self.late_discarded += 1
        events.emit("watchdog_late_discard",
                    detail=f"{point} {why}".strip())
        log.warning("late completion of abandoned %s discarded%s",
                    point, f" ({why})" if why else "")

    def note_cluster_stall(self) -> None:
        """An ack-progress stall cycled a cluster channel (counted on
        top of the op-level stall/abandon bookkeeping)."""
        with self._lock:
            self.cluster_stalls += 1

    def inflight(self) -> List[Dict[str, Any]]:
        """Registered ops with ages — `vmq-admin watchdog show`."""
        now = self._clock()
        with self._lock:
            return [{"point": op.point, "label": op.label,
                     "age_s": round(op.age(now), 3),
                     "deadline_s": op.deadline_s,
                     "stalled": op.stalled, "abandoned": op.abandoned}
                    for op in sorted(self._ops.values(),
                                     key=lambda o: o.started_at)]

    def inflight_age_max(self) -> float:
        now = self._clock()
        with self._lock:
            return max((op.age(now) for op in self._ops.values()),
                       default=0.0)

    def stats(self) -> Dict[str, float]:
        """Gauge snapshot for $SYS / Prometheus."""
        with self._lock:
            inflight = len(self._ops)
            age = max((op.age(self._clock())
                       for op in self._ops.values()), default=0.0)
            return {
                "watchdog_stalls": float(self.stalls),
                "watchdog_abandoned": float(self.abandoned),
                "watchdog_late_discarded": float(self.late_discarded),
                "watchdog_cluster_stalls": float(self.cluster_stalls),
                "watchdog_inflight_ops": float(inflight),
                "watchdog_inflight_age_max": round(age, 3),
                "watchdog_sacrificed_threads": float(self.sacrificed),
            }
