"""The broker's full-collection policy: freeze the heap a bulk load leaves.

CPython's cyclic collector walks every tracked object in a full
collection and holds the interpreter lock while it does. Over a broker
holding a million subscriptions that pause is 1.7-4.6 s on an H100 host,
8-23x the collector's 200 ms queued-publish expiry: publishes queued
across it are answered by the host trie. The reference broker has the
same pause and no policy for it (its sysmon only forces a collection at a
memory watermark, ``vmq_sysmon_handler.erl:221``; ``broker/sysmon.py``
keeps that).

The port's broker picks the moment instead. The layer that knows a bulk
load has just ended calls :meth:`HeapPolicy.settled`, and nothing else
does:

- a GPU matcher's first build and warm dispatch
  (``GpuMatcher.sync``, ``ShardedGpuMatcher.sync``);
- a background rebuild swapped in (``GpuMatcher`` and the retained
  index, ``RetainedIndex``, whose first build is a background one too);
- a cluster node's metadata exchange on a (re)connected channel that
  applied entries: the join's bulk load (``cluster/com.py``,
  ``cluster/swc_store.py``).

There the policy runs ``gc.unfreeze`` → one timed ``gc.collect`` →
``gc.freeze`` and logs the pause: the surviving heap moves into the
permanent generation, and later full collections, sysmon's forced one
included, walk only what was allocated since. Unfreezing first keeps
cyclic garbage among frozen objects from living forever. A delta sync or
an inline resize build on the publish path never triggers it.

The re-freeze walks the whole heap, so it runs only when it pays: when
the objects the collector would walk now (``gc.get_objects()``, a walk
of the unfrozen heap alone) are at least as many as the last re-freeze
left frozen. Otherwise what was loaded since the last freeze is small
beside it (a second broker's first build in a process whose heap is
frozen, a join that brought a few records), a full collection over it
stays short, and the heap is left as it is. That check never asks
``gc.get_freeze_count()``: CPython 3.12 counts the permanent generation
by walking it, which under a million subscriptions holds the
interpreter lock for hundreds of milliseconds; the policy keeps its own
count instead.

gc is process-wide, so is the policy: :data:`POLICY`. It acts only while
a broker (or a match service) of the process holds it
(:meth:`HeapPolicy.hold`, from ``Broker.start``); a matcher used alone
leaves the heap as it is. When the last holder lets go
(:meth:`HeapPolicy.release`, the broker's stop) the heap is unfrozen.
"""

from __future__ import annotations

import gc
import logging
import threading
import time
from typing import Any, Dict, Hashable, Set

log = logging.getLogger("vernemq_tpu_torch.heap")


class HeapPolicy:
    """The process's freeze policy (see the module docstring). ``status``
    reports its re-freezes, the last and the longest pause, and the
    objects in the permanent generation after the last one."""

    def __init__(self) -> None:
        self.refreezes = 0
        self.skipped = 0  # settled() calls that found too little to freeze
        self.unfrozen = 0  # objects the last settled() call found unfrozen
        self.check_ms = 0.0  # what counting them took
        self.last_ms = 0.0
        self.max_ms = 0.0
        self.frozen = 0
        self.last_reason = ""
        self._holders: Set[Hashable] = set()
        self._lock = threading.Lock()

    def hold(self, owner: Hashable) -> None:
        """``owner`` (a broker, a match service) runs: the policy acts."""
        with self._lock:
            self._holders.add(owner)

    def release(self, owner: Hashable) -> None:
        """``owner`` stops: unfreeze the heap once no holder is left."""
        with self._lock:
            if owner not in self._holders:
                return
            self._holders.discard(owner)
            if not self._holders:
                gc.unfreeze()
                self.frozen = 0

    def settled(self, reason: str) -> bool:
        """A bulk load has just ended (``reason`` says which): re-freeze
        while a holder runs and the unfrozen heap is at least as large as
        the frozen one. Returns whether it did; a failure is logged, never
        raised into the caller."""
        if not self._holders:
            return False
        try:
            t0 = time.perf_counter()
            walked = self.unfrozen = len(gc.get_objects())
            self.check_ms = (time.perf_counter() - t0) * 1e3
            if walked < self.frozen:
                self.skipped += 1
                log.debug("heap left as it is after %s: %d objects "
                          "unfrozen, %d frozen at the last re-freeze",
                          reason, walked, self.frozen)
                return False
            self.refreeze(reason)
        except Exception:
            log.exception("heap re-freeze after %s failed", reason)
            return False
        return True

    def refreeze(self, reason: str) -> float:
        """Unfreeze, collect, freeze: returns the pause in ms."""
        with self._lock:
            t0 = time.perf_counter()
            gc.unfreeze()
            found = gc.collect()
            gc.freeze()
            self.frozen = gc.get_freeze_count()  # a walk: inside the pause
            ms = (time.perf_counter() - t0) * 1e3
            self.refreezes += 1
            self.last_ms = ms
            self.max_ms = max(self.max_ms, ms)
            self.last_reason = reason
        log.info("heap frozen after %s: one full collection took %.1f ms "
                 "(%d unreachable objects), %d objects in the permanent "
                 "generation", reason, ms, found, self.frozen)
        return ms

    def status(self) -> Dict[str, Any]:
        return {"refreezes": self.refreezes,
                "skipped": self.skipped,
                "unfrozen_at_last_check": self.unfrozen,
                "last_check_ms": round(self.check_ms, 3),
                "last_pause_ms": round(self.last_ms, 3),
                "max_pause_ms": round(self.max_ms, 3),
                "frozen_objects": self.frozen,
                "last_reason": self.last_reason}


#: the one policy of the process
POLICY = HeapPolicy()
