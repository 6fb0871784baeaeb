"""System monitor: event-loop health + memory watermark + overload signal.

Plays the role of ``vmq_sysmon`` (224 LoC, riak_sysmon-based): the
reference watches the BEAM for long_gc / long_schedule / busy_port events
and forces a GC on large_heap (``vmq_sysmon_handler.erl:221``). The
asyncio equivalents:

- **loop lag**: a periodic sleep measures scheduling drift — the analog of
  long_schedule. Sustained lag beyond the threshold sets the broker's
  ``overloaded`` flag, which the session layer turns into read throttling
  (the load-shedding role of the reference's throttle return,
  ``vmq_ranch.erl:198-203``).
- **memory watermark**: RSS read from ``/proc/self/statm``; crossing the
  high watermark triggers ``gc.collect()`` (the forced-GC response to
  large_heap) and counts a metric.

CRL refresh (``vmq_crl_srv.erl``): TLS listeners configured with a CRL
file get it re-read periodically so revocations take effect without a
restart; each refresh rebuilds the listener's SSLContext verify store.
"""

from __future__ import annotations

import asyncio
import gc
import logging
import os
import time
from typing import Any, Dict, Optional

log = logging.getLogger("vernemq_tpu_torch.sysmon")

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


class Sysmon:
    def __init__(self, broker, interval: float = 1.0,
                 lag_threshold: float = 0.25,
                 memory_high_watermark: int = 0,
                 overload_cooldown: float = 5.0,
                 lag_exit_ratio: float = 0.5):
        self.broker = broker
        self.interval = interval
        self.lag_threshold = lag_threshold
        # bytes; 0 = no watermark (the reference defaults large_heap off
        # too unless configured)
        self.memory_high_watermark = memory_high_watermark
        self.overload_cooldown = overload_cooldown
        # hysteresis: overload ENTERS at lag_threshold but only EXITS
        # once lag stays below lag_threshold * lag_exit_ratio for a full
        # cooldown — lag hovering at the boundary (the common overload
        # shape: shedding lowers lag just below the threshold, which
        # unsheds, which raises lag ...) must not flap the flag
        self.lag_exit_ratio = lag_exit_ratio
        self.lag_events = 0
        self.overload_extends = 0  # cooldowns re-armed by boundary lag
        self.gc_forced = 0
        self.last_lag = 0.0
        self.overloaded_until = 0.0
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    @property
    def overloaded(self) -> bool:
        return time.monotonic() < self.overloaded_until

    def observe_lag(self, lag: float) -> None:
        """Fold one loop-lag sample into the overload state (split out
        of the sampling loop so tests drive the hysteresis directly)."""
        self.last_lag = lag
        now = time.monotonic()
        if lag > self.lag_threshold:
            self.lag_events += 1
            self.overloaded_until = now + self.overload_cooldown
            self.broker.metrics.incr("sysmon_long_schedule")
            log.warning("event loop lag %.3fs over threshold %.3fs — "
                        "shedding load for %.1fs",
                        lag, self.lag_threshold, self.overload_cooldown)
        elif (self.overloaded
              and lag > self.lag_threshold * self.lag_exit_ratio):
            # boundary lag while shedding: keep the window armed (no
            # log/metric spam — it's the same overload episode)
            self.overload_extends += 1
            self.overloaded_until = max(self.overloaded_until,
                                        now + self.overload_cooldown)

    async def _run(self) -> None:
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.interval)
            lag = time.monotonic() - t0 - self.interval
            self.observe_lag(lag)
            gov = getattr(self.broker, "overload", None)
            if gov is not None:
                # feed the governor's lag-EWMA signal (it recomputes the
                # level inline so the L1 response lands this sample)
                gov.observe_lag(lag)
            ws = getattr(self.broker, "worker_stats", None)
            if ws is not None:
                # multi-process front end: every lag sample also lands
                # in this worker's shared slot — the per-worker
                # loop-lag p99 bench config 11 and `workers show` read
                try:
                    ws.push_lag(self.broker.worker_index, lag)
                except Exception:
                    pass
            if self.memory_high_watermark:
                rss = rss_bytes()
                if gov is not None:
                    gov.observe_rss(rss, self.memory_high_watermark)
                if rss > self.memory_high_watermark:
                    self.gc_forced += 1
                    self.broker.metrics.incr("sysmon_large_heap")
                    gc.collect()  # forced GC (vmq_sysmon_handler.erl:221)

    def status(self) -> Dict[str, Any]:
        return {
            "last_loop_lag_s": round(self.last_lag, 4),
            "lag_events": self.lag_events,
            "overload_extends": self.overload_extends,
            "gc_forced": self.gc_forced,
            "overloaded": self.overloaded,
            "rss_bytes": rss_bytes(),
        }


class CrlRefresher:
    """Periodic CRL re-load for TLS listeners (vmq_crl_srv.erl: periodic
    fetch keyed by ``crl_refresh_interval``). File-based: operators drop an
    updated CRL PEM in place; we rebuild each listener's verify store."""

    def __init__(self, broker, interval: float = 60.0):
        self.broker = broker
        self.interval = interval
        self.refreshes = 0
        self._task: Optional[asyncio.Task] = None
        self._mtimes: Dict[str, float] = {}

    def start(self) -> None:
        try:
            self.refresh()  # pick up listeners that pre-date the refresher
        except Exception:
            log.exception("initial CRL refresh failed")
        self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                self.refresh()
            except Exception:
                log.exception("CRL refresh failed")

    def refresh(self) -> int:
        """Re-load changed CRL files into their listeners' SSL contexts;
        returns how many listeners were refreshed."""
        manager = self.broker.listeners
        if manager is None:
            return 0
        n = 0
        for rec in manager.listener_records():
            crl_file = rec.get("opts", {}).get("crl_file")
            ctx = rec.get("ssl_context")
            if not crl_file or ctx is None:
                continue
            try:
                mtime = os.stat(crl_file).st_mtime
            except OSError:
                continue
            if self._mtimes.get(crl_file) == mtime:
                continue
            try:
                import ssl

                ctx.load_verify_locations(cafile=crl_file)
                ctx.verify_flags |= ssl.VERIFY_CRL_CHECK_LEAF
                self._mtimes[crl_file] = mtime
                self.refreshes += 1
                n += 1
                log.info("reloaded CRL %s", crl_file)
            except Exception:
                log.exception("loading CRL %s failed", crl_file)
        return n
