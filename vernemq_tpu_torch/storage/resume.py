"""Reconnect-storm resume collector: coalesce concurrent offline-queue
replays into batched store reads.

The storage sibling of ``retained/collector.RetainedBatchCollector``: a
reconnect storm used to cost one loop-side ``msg_store.read_all`` (scan
+ decode of the whole backlog ON the event loop) plus one Python
enqueue loop per session — the last hot path that had never been
batched. Sessions re-registering within ``window_us`` (or until
``max_batch``) now ride ONE executor call (``store.read_many``), so
the scans and payload decodes for a whole storm batch run off the
loop while the loop stages delivery of the previous batch — loop-side
cost per offline message is O(1) small.

The template's guarantees carry over: flushes at or below
``host_threshold`` are served by the exact per-session ``read_all`` on
the loop (a lone reconnect must not pay an executor round trip), the
overload governor's L2 defer gate stretches the window so replay
storms wait out congestion (bounded by ``MAX_DEFERS``), queued resumes
older than ``item_expiry_ms`` are settled by the exact per-session
fallback even with both pipeline slots busy, and ANY batched-read
failure falls back per session — an outage costs latency, never a lost
or reordered replay. Ordering across the replay window is the queue's
job (``SubscriberQueue.begin_resume``/``finish_resume`` park live
publishes until the stored backlog has been delivered).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Tuple

from ..observability import histogram as obs

log = logging.getLogger("vernemq_tpu_torch.storage")


class ResumeCollector:
    #: batched reads in flight at once. ONE slot, deliberately unlike
    #: the retained collector's two: the read is GIL-bound Python
    #: decode, so a second in-flight read doesn't overlap device time —
    #: it fights the loop's staged delivery for the interpreter
    #: (measured: 2 slots at 20k sessions = loop-lag p99 ~650ms, 1 slot
    #: ~40ms at equal throughput). Late arrivals still coalesce while
    #: the single slot is busy. Revisit when read_many is native-batch.
    MAX_INFLIGHT = 1

    #: consecutive overload deferrals before a flush goes out anyway
    MAX_DEFERS = 8

    #: per-callback loop-yield grain while staging deliveries
    _CHUNK = 64

    def __init__(self, store, window_us: int = 500,
                 max_batch: int = 512, host_threshold: int = 4,
                 item_expiry_ms: float = 0.0,
                 read_timeout_s: float = 30.0,
                 metrics=None):
        self.store = store
        self.window = window_us / 1e6
        self.max_batch = max_batch
        self.host_threshold = host_threshold
        self.item_expiry = item_expiry_ms / 1e3
        self.read_timeout_s = read_timeout_s
        self.metrics = metrics
        self._pending: List[Tuple] = []  # (sid, fut, expiry)
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._expiry_handle: Optional[asyncio.TimerHandle] = None
        self._inflight = 0
        self._closed = False
        self.defer_gate = None
        self._defers_in_row = 0
        self._defer_armed = False
        # observability (broker gauges / bench artifact)
        self.batched_sessions = 0    # sessions served by a batched read
        self.batched_reads = 0       # executor read_many calls
        self.host_sessions = 0       # small flushes served per-session
        self.expired_sessions = 0    # waited out item_expiry -> fallback
        self.fallback_sessions = 0   # batched read failed -> per-session
        self.deferred_flushes = 0

    def close(self) -> None:
        """Settle every pending resume from the per-session read on the
        loop (the store outlives the collector in the stop order) so no
        future leaks unresolved."""
        self._closed = True
        for h in (self._flush_handle, self._expiry_handle):
            if h is not None:
                h.cancel()
        self._flush_handle = self._expiry_handle = None
        pending, self._pending = self._pending, []
        for sid, fut, _exp in pending:
            self._host_read(sid, fut)

    def submit(self, sid) -> asyncio.Future:
        """One reconnecting session's offline replay; resolves to its
        ``[Msg, ...]`` backlog in enqueue order."""
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        if self._closed:
            self._host_read(sid, fut)
            return fut
        exp = (time.monotonic() + self.item_expiry
               if self.item_expiry > 0 else None)
        self._pending.append((sid, fut, exp))
        if exp is not None and self._expiry_handle is None:
            self._expiry_handle = loop.call_later(self.item_expiry,
                                                  self._expire_sweep)
        if len(self._pending) >= self.max_batch:
            if self._defer_armed:
                # an L2+ deferral is waiting out congestion: storm
                # arrivals must not re-trigger the flush path and burn
                # the MAX_DEFERS budget in microseconds
                return fut
            if self._flush_handle is not None:
                self._flush_handle.cancel()
                self._flush_handle = None
            self._flush()
        elif self._flush_handle is None:
            self._flush_handle = loop.call_later(self.window, self._flush)
        return fut

    def _host_read(self, sid, fut) -> None:
        """The exact per-session fallback (and sub-threshold server)."""
        if fut.done():
            return
        try:
            fut.set_result(self.store.read_all(sid))
        except Exception as e:
            fut.set_exception(e)

    def _expire_sweep(self) -> None:
        self._expiry_handle = None
        if not self._pending:
            return
        now = time.monotonic()
        settled = 0
        keep = []
        for item in self._pending:
            sid, fut, exp = item
            if exp is not None and now >= exp and settled < self._CHUNK:
                self.expired_sessions += 1
                self._host_read(sid, fut)
                settled += 1
            else:
                keep.append(item)
        self._pending = keep
        if self._pending and self._pending[0][2] is not None:
            delay = (0.0 if now >= self._pending[0][2]
                     else max(0.005, self._pending[0][2] - now))
            self._expiry_handle = asyncio.get_event_loop().call_later(
                delay, self._expire_sweep)

    def pressure(self) -> float:
        """Resume-path pressure for the overload governor (same fused
        rule as the publish/retained collectors)."""
        from ..robustness.overload import collector_pressure

        return collector_pressure(
            len(self._pending), self.max_batch * self.MAX_INFLIGHT,
            0.0, 1.0)

    def _flush(self) -> None:
        self._flush_handle = None
        self._defer_armed = False
        if not self._pending:
            return
        if (self.defer_gate is not None
                and self._defers_in_row < self.MAX_DEFERS
                and len(self._pending) > self.host_threshold
                and self.defer_gate()):
            # L2+ deferral: the replay storm re-arms a stretched window
            # instead of competing with live traffic; bounded so a
            # pinned level can't starve resumes forever
            self._defers_in_row += 1
            self.deferred_flushes += 1
            self._defer_armed = True
            self._flush_handle = asyncio.get_event_loop().call_later(
                self.window * 8, self._flush)
            return
        self._defers_in_row = 0
        if len(self._pending) <= self.host_threshold:
            pending, self._pending = self._pending, []
            self.host_sessions += len(pending)
            for sid, fut, _exp in pending:
                self._host_read(sid, fut)
            return
        if self._inflight >= self.MAX_INFLIGHT:
            # both slots busy: leave items pending so late arrivals
            # coalesce into one bigger batch; _on_done flushes the
            # moment a slot frees (bounded self-batching backpressure)
            return
        pending, self._pending = (self._pending[:self.max_batch],
                                  self._pending[self.max_batch:])
        self._inflight += 1
        task = asyncio.get_event_loop().create_task(
            self._flush_async(pending))
        task.add_done_callback(self._on_done)

    def _on_done(self, task) -> None:
        self._inflight -= 1
        if not task.cancelled() and task.exception() is not None:
            log.warning("resume flush task failed: %s", task.exception())
        if self._pending:
            if self._flush_handle is not None:
                self._flush_handle.cancel()
                self._flush_handle = None
            self._flush()

    async def _flush_async(self, pending) -> None:
        loop = asyncio.get_event_loop()
        t0 = time.perf_counter()
        now = time.monotonic()
        live: List[Tuple] = []
        for i, (sid, fut, exp) in enumerate(pending):
            if exp is not None and now >= exp:
                # waited out its expiry behind busy slots: the exact
                # per-session read answers instead of deepening the queue
                self.expired_sessions += 1
                self._host_read(sid, fut)
                if (i + 1) % self._CHUNK == 0:
                    await asyncio.sleep(0)
            else:
                live.append((sid, fut))
        if not live:
            return
        sids = [sid for sid, _ in live]
        try:
            # ONE off-loop call scans + decodes the whole batch while
            # the loop keeps serving; wait_for bounds a wedged disk
            # (the executor thread is abandoned, the exact per-session
            # fallback serves — the sacrificial-dispatch discipline)
            backlogs: Dict = await asyncio.wait_for(
                loop.run_in_executor(None, self.store.read_many, sids),
                timeout=self.read_timeout_s)
        except asyncio.TimeoutError:
            # the read WEDGED (not errored): the abandoned thread may
            # still hold the store lock, so the fallback reads must
            # also run off-loop — an inline read_all here would park
            # the event loop on the exact stall the timeout survived.
            # They settle (or queue behind the wedge) on the executor;
            # the loop stays alive either way.
            log.warning("batched resume read timed out after %.1fs; "
                        "%d session(s) fall back to executor-side "
                        "per-session reads", self.read_timeout_s,
                        len(live))
            self.fallback_sessions += len(live)
            for sid, fut in live:
                task = loop.run_in_executor(
                    None, self.store.read_all, sid)

                def _settle(t, fut=fut):
                    if fut.done():
                        return
                    exc = None if t.cancelled() else t.exception()
                    if exc is not None:
                        fut.set_exception(exc)
                    elif t.cancelled():
                        fut.cancel()
                    else:
                        fut.set_result(t.result())

                task.add_done_callback(_settle)
            return
        except Exception as e:
            log.warning("batched resume read failed (%s); per-session "
                        "fallback serves %d session(s)", e, len(live))
            self.fallback_sessions += len(live)
            for i, (sid, fut) in enumerate(live):
                self._host_read(sid, fut)
                if (i + 1) % self._CHUNK == 0:
                    await asyncio.sleep(0)
            return
        self.batched_reads += 1
        self.batched_sessions += len(live)
        for i, (sid, fut) in enumerate(live):
            if not fut.done():
                fut.set_result(backlogs.get(sid, []))
            if (i + 1) % self._CHUNK == 0:
                # staged delivery: resolving a future fires the queue's
                # finish_resume synchronously — yield between chunks so
                # a 100k-session storm never stalls the loop for its
                # whole duration
                await asyncio.sleep(0)
        obs.observe("stage_resume_replay_ms",
                    (time.perf_counter() - t0) * 1e3)

    def stats(self) -> Dict[str, float]:
        return {
            "resume_batched_sessions": float(self.batched_sessions),
            "resume_batched_reads": float(self.batched_reads),
            "resume_host_sessions": float(self.host_sessions),
            "resume_expired_sessions": float(self.expired_sessions),
            "resume_fallback_sessions": float(self.fallback_sessions),
            "resume_deferred_flushes": float(self.deferred_flushes),
            "resume_pending_sessions": float(len(self._pending)),
        }
