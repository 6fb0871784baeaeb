"""Retained-replay batch collector: coalesce concurrent SUBSCRIBE replays
into super-batched reverse-match dispatches.

The retained sibling of ``models/matcher.BatchCollector``: subscribe
storms submit one ``(mountpoint, filter)`` per subscription, replays
arriving within ``window_us`` (or until ``max_batch``) ride ONE device
dispatch, and each caller's future resolves to its own
``[(topic, value), ...]`` match list. Flushes at or below
``host_threshold`` are served by the exact host walk on the event loop
(hybrid dispatch — a lone subscribe must not pay a device round trip),
and every degraded signal (`RebuildInProgress`, `DeviceDegraded`, a
breaker-open retained path) falls back to ``RetainStore.match_filter`` —
the correctness oracle — so an outage costs latency, never wrong or
missing replays. Per-filter ``None`` escapes from the index (fanout > k,
untiled leftovers) resolve against the store on the loop thread, where
store access is race-free. A kernel fault (``tile_match.KernelError``) is
none of these: it reaches the futures as an error.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..observability import histogram as obs
from ..observability.profiler import record_dispatch
from ..models.matcher import DeviceDegraded, MatcherBusy, \
    RebuildInProgress
from ..robustness.watchdog import StallAbandoned

log = logging.getLogger("vernemq_tpu_torch.retained")


class RetainedBatchCollector:
    #: dispatches in flight at once: two slots double-buffer (batch N+1's
    #: encode/prep overlaps batch N's device time, like the publish path)
    MAX_INFLIGHT = 2

    #: consecutive overload deferrals before a flush goes out anyway —
    #: deferral trades replay latency for publish headroom, it must
    #: never starve replays outright
    MAX_DEFERS = 8

    def __init__(self, engine, store, window_us: int = 500,
                 max_batch: int = 1024, host_threshold: int = 4,
                 latency_budget_ms: float = 50.0,
                 watchdog=None, dispatch_deadline_ms: float = 0.0,
                 item_expiry_ms: float = 0.0):
        self.engine = engine
        self.store = store
        self.window = window_us / 1e6
        self.max_batch = max_batch
        self.host_threshold = host_threshold
        self._pending: List[Tuple] = []  # (mp, filter, fut, expiry)
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._inflight = 0
        self._closed = False
        # stall watchdog: reverse-match dispatches become sacrificial
        # (abandoned past dispatch_deadline_ms → host walk serves, the
        # index breaker is fed, the late result is discarded); queued
        # replays older than item_expiry_ms are host-served even while
        # every pipeline slot is wedged. 0 disables either bound.
        self.watchdog = watchdog
        self.dispatch_deadline = dispatch_deadline_ms / 1e3
        self.item_expiry = item_expiry_ms / 1e3
        self.stalled_filters = 0
        self.expired_filters = 0
        self._expiry_handle: Optional[asyncio.TimerHandle] = None
        # overload governor hooks (robustness/overload.py): pressure()
        # feeds the fused signal; defer_gate (set by the broker) returns
        # True at L2+ — replay storms then wait out the congestion
        self.latency_budget_ms = latency_budget_ms
        self.dispatch_ewma_ms = 0.0
        self.defer_gate = None
        self.deferred_flushes = 0
        self._defers_in_row = 0
        self._defer_armed = False  # a stretched window is pending
        # observability (exposed as broker gauges)
        self.device_batches = 0       # flushes served by the device path
        self.device_filters = 0
        self.host_hybrid_filters = 0  # small flushes host-served
        self.degraded_filters = 0     # host-served while the breaker is open
        self.rebuild_filters = 0      # host-served during a table rebuild
        self.fallback_filters = 0     # per-filter None escapes host-resolved

    def close(self) -> None:
        """Quiesce at broker stop: disarm the flush timer and settle
        every pending replay from the host walk (the store outlives the
        collector in the stop order) so no future leaks unresolved and
        no device work dispatches after teardown."""
        self._closed = True
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        if self._expiry_handle is not None:
            self._expiry_handle.cancel()
            self._expiry_handle = None
        pending, self._pending = self._pending, []
        for mp, fw, fut, _exp in pending:
            self._host_match(mp, fw, fut)

    def submit(self, mountpoint: str,
               filter_words: Sequence[str]) -> asyncio.Future:
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        if self._closed:
            self._host_match(mountpoint, tuple(filter_words), fut)
            return fut
        exp = (time.monotonic() + self.item_expiry
               if self.item_expiry > 0 else None)
        self._pending.append((mountpoint, tuple(filter_words), fut, exp))
        if exp is not None and self._expiry_handle is None:
            self._expiry_handle = loop.call_later(self.item_expiry,
                                                  self._expire_sweep)
        if len(self._pending) >= self.max_batch:
            if self._defer_armed:
                # an L2+ deferral is waiting out the congestion: more
                # arrivals must not re-trigger the flush path, or every
                # storm submit would consume one of the MAX_DEFERS and
                # burn through the deferral in microseconds
                return fut
            if self._flush_handle is not None:
                self._flush_handle.cancel()
                self._flush_handle = None
            self._flush()
        elif self._flush_handle is None:
            self._flush_handle = loop.call_later(self.window, self._flush)
        return fut

    #: expired filters settled per sweep callback (loop-side host
    #: walks): the remainder re-arms at zero delay so a storm backlog
    #: drains across loop iterations instead of one long stall
    _EXPIRE_CHUNK = 256

    def _expire_sweep(self) -> None:
        """Queued-replay deadline: pending filters older than their
        expiry are served by the exact host walk now — a subscribe's
        retained replay is bounded even with both pipeline slots wedged
        (the dispatch deadline bounds the in-flight half)."""
        self._expiry_handle = None
        if not self._pending:
            return
        now = time.monotonic()
        settled = 0
        keep = []
        for item in self._pending:
            mp, fw, fut, exp = item
            if (exp is not None and now >= exp
                    and settled < self._EXPIRE_CHUNK):
                self.expired_filters += 1
                self._host_match(mp, fw, fut)
                settled += 1
            else:
                keep.append(item)
        self._pending = keep
        if self._pending and self._pending[0][3] is not None:
            delay = (0.0 if now >= self._pending[0][3]
                     else max(0.005, self._pending[0][3] - now))
            self._expiry_handle = asyncio.get_event_loop().call_later(
                delay, self._expire_sweep)

    def _host_match(self, mp: str, fw: Tuple[str, ...], fut) -> None:
        if fut.done():
            return  # caller cancelled
        try:
            fut.set_result(self.store.match_filter(mp, list(fw)))
        except Exception as e:
            fut.set_exception(e)

    def pressure(self) -> float:
        """Replay-path pressure in [0, 1] for the overload governor:
        depth against two full batches (past that, subscribe storms are
        queueing faster than the device serves) plus the dispatch
        latency EWMA, fused by the shared overload.collector_pressure
        rule (latency caps below the L1 gate — slow-but-covered
        dispatch is reduced headroom, not overload)."""
        from ..robustness.overload import collector_pressure

        return collector_pressure(
            len(self._pending), self.max_batch * self.MAX_INFLIGHT,
            self.dispatch_ewma_ms, self.latency_budget_ms)

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
            # instead of competing with live publishes for the device;
            # bounded so a pinned level can't starve replays forever
            self._defers_in_row += 1
            self.deferred_flushes += 1
            self._defer_armed = True
            self._flush_handle = asyncio.get_event_loop().call_later(
                self.window * 8, self._flush)
            return
        self._defers_in_row = 0
        if len(self._pending) <= self.host_threshold:
            pending, self._pending = self._pending, []
            self.host_hybrid_filters += len(pending)
            for mp, fw, fut, _exp in pending:
                self._host_match(mp, fw, fut)
            return
        if self._inflight >= self.MAX_INFLIGHT:
            # both slots busy: leave items pending so late arrivals
            # coalesce into one bigger batch; _on_done flushes the moment
            # a slot frees (bounded self-batching backpressure)
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
            log.warning("retained flush task failed: %s", task.exception())
        if self._pending:
            if self._flush_handle is not None:
                self._flush_handle.cancel()
                self._flush_handle = None
            self._flush()

    async def _flush_async(self, pending) -> None:
        loop = asyncio.get_event_loop()
        flush_t0 = time.perf_counter()
        now = time.monotonic()
        by_mp: Dict[str, List[Tuple[Tuple[str, ...], asyncio.Future]]] = {}
        expired: List[Tuple[str, Tuple[str, ...], asyncio.Future]] = []
        for mp, fw, fut, exp in pending:
            if exp is not None and now >= exp:
                expired.append((mp, fw, fut))
            else:
                by_mp.setdefault(mp, []).append((fw, fut))
        for i, (mp, fw, fut) in enumerate(expired):
            # waited out its expiry behind a slow/wedged device: the
            # exact host walk answers instead of deepening the queue
            self.expired_filters += 1
            self._host_match(mp, fw, fut)
            if (i + 1) % 64 == 0:
                await asyncio.sleep(0)
        for mp, items in by_mp.items():
            filters = [fw for fw, _ in items]
            wd = self.watchdog
            t_disp = time.monotonic()
            try:
                # first use chunk-loads the retained snapshot with loop
                # yields; a failed load serves this flush host-side
                idx = await self.engine.index_async(mp)
                if wd is not None and self.dispatch_deadline > 0:
                    # sacrificial dispatch: bounded await, late result
                    # discarded (see models/matcher.BatchCollector)
                    results = await wd.dispatch_async(
                        "device.retained",
                        lambda ix=idx, fs=filters: ix.match_filters(fs),
                        self.dispatch_deadline,
                        label=f"match_filters:{mp or '(default)'}")
                else:
                    results = await loop.run_in_executor(
                        None, idx.match_filters, filters)
            except StallAbandoned as sa:
                # deadline overrun: stall feeds the index breaker and
                # the host walk serves this flush (identical results)
                self.stalled_filters += len(items)
                if hasattr(idx, "record_stall"):
                    idx.record_stall(sa)
                for i, (fw, fut) in enumerate(items):
                    self._host_match(mp, fw, fut)
                    if (i + 1) % 64 == 0:
                        await asyncio.sleep(0)
                continue
            except (RebuildInProgress, MatcherBusy, DeviceDegraded) as rb:
                # degraded window: the host walk serves (identical
                # results); chunk with yields so a big storm flush can't
                # stall every session's IO for its whole duration
                if isinstance(rb, DeviceDegraded):
                    self.degraded_filters += len(items)
                else:
                    self.rebuild_filters += len(items)
                for i, (fw, fut) in enumerate(items):
                    self._host_match(mp, fw, fut)
                    if (i + 1) % 64 == 0:
                        await asyncio.sleep(0)
                continue
            except Exception as e:
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self.device_batches += 1
            self.device_filters += len(items)
            dur = (time.monotonic() - t_disp) * 1e3
            obs.observe("stage_retained_dispatch_ms", dur)
            record_dispatch("retained", t_disp, dur,
                            batch=len(filters),
                            mountpoint=mp or "(default)")
            for i, ((fw, fut), rows) in enumerate(zip(items, results)):
                if rows is None:
                    # per-filter device escape: exact host resolution
                    self.fallback_filters += 1
                    self._host_match(mp, fw, fut)
                elif not fut.done():
                    fut.set_result(rows)
                if (i + 1) % 256 == 0:
                    await asyncio.sleep(0)
        from ..robustness.overload import fold_latency_ewma

        self.dispatch_ewma_ms = fold_latency_ewma(
            self.dispatch_ewma_ms, (time.perf_counter() - flush_t0) * 1e3)

    def stats(self) -> Dict[str, float]:
        return {
            "retained_replay_deferred_flushes": self.deferred_flushes,
            "retained_replay_device_batches": self.device_batches,
            "retained_replay_device_filters": self.device_filters,
            "retained_replay_host_filters": self.host_hybrid_filters,
            "retained_replay_degraded_filters": self.degraded_filters,
            "retained_replay_rebuild_filters": self.rebuild_filters,
            "retained_replay_fallback_filters": self.fallback_filters,
            "retained_replay_stalled_filters": self.stalled_filters,
            "retained_replay_expired_filters": self.expired_filters,
        }
