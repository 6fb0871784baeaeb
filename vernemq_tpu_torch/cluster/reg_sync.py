"""Cluster-wide per-SubscriberId action serialization.

Mirrors ``vmq_reg_sync.erl`` (used by ``vmq_reg.erl:115-126`` to serialize
register/cleanup per ClientId): a SyncKey hashes to a coordinator node;
callers acquire the key's lock through it (FIFO), run their action
locally, then release. Guarantees, in a consistent cluster:

1. one action per key at a time,
2. a dead owner's running action releases (lease expiry + channel-down
   release),
3. a dead owner's queued requests are dropped.

Transport: three data-plane frames (``syq`` acquire / ``syg`` grant /
``syr`` release) over the same framed channel as publish forwarding —
no separate control connection (the reference rides erlang dist here).
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

log = logging.getLogger("vernemq_tpu_torch.cluster")

# margin added to the caller's timeout for the coordinator-side lease:
# covers the action runtime after the grant
LEASE_MARGIN = 30.0


class RegSync:
    def __init__(self, cluster):
        self.cluster = cluster
        # coordinator-side state
        self._waiting: Dict[Any, Deque[Tuple[str, int, float]]] = {}
        self._held: Dict[Any, str] = {}  # key -> owner node
        self._lease: Dict[Any, asyncio.TimerHandle] = {}
        # caller-side pending grants: ref_id -> future
        self._pending: Dict[int, asyncio.Future] = {}
        self._ref_ids = iter(_counter())

    # ------------------------------------------------------------- caller API

    def coordinator(self, key: Any) -> str:
        """Deterministic coordinator for a key: hash over the sorted
        member view (vmq_reg_sync sync_node). crc32 over a stable string,
        NOT hash() — python string hashing is per-process randomized and
        every node must pick the same coordinator."""
        import zlib

        members = self.cluster.members()
        if not members:
            return self.cluster.node_name
        h = zlib.crc32(repr(key).encode())
        return members[h % len(members)]

    async def sync(self, key: Any, fn: Callable[[], Any],
                   timeout: float = 10.0) -> Any:
        """Run ``fn`` (sync or async) holding the cluster-wide lock for
        ``key``. Raises RuntimeError('not_ready') on acquire failure."""
        node = self.coordinator(key)
        me = self.cluster.node_name
        if node == me:
            await self._acquire(key, me, timeout)
        else:
            await self._acquire_remote(node, key, timeout)
        try:
            res = fn()
            if asyncio.iscoroutine(res):
                res = await res
            return res
        finally:
            if node == me:
                self.handle_release(me, key)
            else:
                self.cluster.sync_release(node, key)

    async def _acquire(self, key: Any, owner: str, timeout: float) -> None:
        """Local acquire on the coordinator (origin may be this node)."""
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        ref_id = next(self._ref_ids)
        self._pending[ref_id] = fut
        self.handle_acquire(owner, ref_id, key, timeout + LEASE_MARGIN,
                            local=True)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._drop_request(key, owner, ref_id)
            raise RuntimeError("not_ready") from None
        finally:
            self._pending.pop(ref_id, None)

    async def _acquire_remote(self, node: str, key: Any,
                              timeout: float) -> None:
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        ref_id = next(self._ref_ids)
        self._pending[ref_id] = fut
        try:
            if not self.cluster.sync_acquire(node, ref_id, key,
                                             timeout + LEASE_MARGIN):
                raise RuntimeError("not_ready")
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise RuntimeError("not_ready") from None
        finally:
            self._pending.pop(ref_id, None)

    def on_grant(self, ref_id: int) -> None:
        fut = self._pending.get(ref_id)
        if fut is not None and not fut.done():
            fut.set_result(True)

    # ------------------------------------------------------ coordinator side

    def handle_acquire(self, origin: str, ref_id: int, key: Any,
                       lease: float, local: bool = False) -> None:
        self._waiting.setdefault(key, deque()).append((origin, ref_id, lease))
        self._try_grant(key)

    def handle_release(self, origin: str, key: Any) -> None:
        if self._held.get(key) == origin:
            self._release(key)

    def _release(self, key: Any) -> None:
        self._held.pop(key, None)
        t = self._lease.pop(key, None)
        if t is not None:
            t.cancel()
        self._try_grant(key)

    def _try_grant(self, key: Any) -> None:
        if key in self._held:
            return
        q = self._waiting.get(key)
        while q:
            origin, ref_id, lease = q.popleft()
            self._held[key] = origin
            loop = asyncio.get_event_loop()
            self._lease[key] = loop.call_later(
                lease, self._lease_expired, key, origin)
            if origin == self.cluster.node_name:
                self.on_grant(ref_id)
            else:
                if not self.cluster.sync_grant(origin, ref_id):
                    # grant undeliverable: treat as immediately released
                    self._release(key)
                    continue
            return
        if q is not None and not q:
            self._waiting.pop(key, None)

    def _lease_expired(self, key: Any, owner: str) -> None:
        if self._held.get(key) == owner:
            log.warning("reg_sync lease for %r held by %s expired", key, owner)
            self._lease.pop(key, None)
            self._held.pop(key, None)
            self._try_grant(key)

    def _drop_request(self, key: Any, origin: str, ref_id: int) -> None:
        q = self._waiting.get(key)
        if q:
            kept = deque(t for t in q if (t[0], t[1]) != (origin, ref_id))
            if kept:
                self._waiting[key] = kept
            else:
                self._waiting.pop(key, None)

    def on_node_down(self, node: str) -> None:
        """Channel to a node dropped: its held locks release, its queued
        requests drop (properties 2 + 3)."""
        for key, owner in list(self._held.items()):
            if owner == node:
                self._release(key)
        for key, q in list(self._waiting.items()):
            self._waiting[key] = deque(
                (o, r, l) for (o, r, l) in q if o != node)
            if not self._waiting[key]:
                self._waiting.pop(key, None)


def _counter():
    i = 0
    while True:
        i += 1
        yield i
