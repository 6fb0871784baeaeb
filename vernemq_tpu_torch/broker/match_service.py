"""Shared-memory device-match service: ONE matcher process serving N
SO_REUSEPORT session workers.

The multi-process front end (``broker/workers.py``) shards sessions
across N worker processes — parse, auth, session FSM, queues and the
cluster data plane all run worker-local. Matching is the one hot-path
piece that must NOT be replicated per worker: the device table is big
(HBM-resident at scale) and the whole point of the batch pipeline is to
coalesce EVERY concurrent publish on the node into few large dispatches.
So one **match service** process owns the subscription trie + device
mirror, and each worker talks to it over two shared-memory rings
(:class:`~vernemq_tpu_torch.parallel.shm_ring.ShmRing`):

- worker -> service: pickled records, in order per worker —
  ``("fold", req_id, mountpoint, topics)`` publish batches, and the
  subscription write path ``("sub"|"unsub", mountpoint, filter, key,
  opts)`` + ``("resync", node)`` stream that keeps the service's table
  the union of every worker's locally-owned rows;
- service -> worker: ``(req_id, "ok", rows_per_topic)`` match results
  (or ``(req_id, "err", reason)``).

The service-side drainer feeds fold requests from ALL workers into the
same :class:`~vernemq_tpu_torch.models.matcher.BatchCollector` the
in-process path uses — the submitters are now processes instead of
tasks, and K worker batches super-batch into one ``match_many``
dispatch exactly as K tasks did. Rows come back **node-qualified**
(``opts.node`` names the owning worker); the worker-side stub localizes
them — own rows stay direct, foreign rows collapse to node-pointer rows
— so ``route_rows`` sees exactly what the worker's own trie fold would
have produced.

Degradation is the usual discipline: a full ring, a dead service or a
timed-out reply raises :class:`DeviceDegraded` through the worker's
client breaker, and the worker's BatchCollector serves the flush from
its LOCAL trie (every worker keeps the full replicated trie — it is the
correctness oracle, results are identical). A respawned service starts
empty under a new epoch; every worker notices the epoch bump in the
stats block and replays its owned rows (``resync``), healing the
partition without operator action.

Pickle is safe here: both ring ends are processes of the same broker
install on one host, created by the same parent — the rings are not a
network surface.

The port's seam (ROADMAP Queue 1 item 9): the service's ``"tpu"`` view is
the GPU match engine (``GpuRegView`` behind a ``BatchCollector``) on an
explicit ``device``, and the service process is the only process of a
worker group that creates a CUDA context; workers import the port but never
touch the card. A fault of the device code in the service (``KernelError``)
comes back as a ``"fault"`` reply and raises ``KernelError`` in the worker:
it is not fed to the client breaker and the worker's trie does not answer
it (the reference replies ``"err"`` and the worker's trie serves).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import pickle
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Sequence, \
    Set, Tuple

from ..models.trie import SubscriptionTrie
from ..models.matcher import DeviceDegraded
from ..ops import extract as EX
from ..ops import match_kernel as MK
from ..ops import tile_match as TM
from ..ops.tile_match import KernelError
from ..observability import events as _events
from ..observability import histogram as obs
from ..parallel.shm_ring import RingClosed, RingFull, ShmRing, \
    WorkerStatsBlock
from ..robustness import watchdog as watchdog_mod
from ..robustness.breaker import CircuitBreaker
from .heap import POLICY

log = logging.getLogger("vernemq_tpu_torch.match_service")

#: pickled records keep tuple identity cheap (protocol 5 memoizes the
#: interned per-batch topic words)
_PICKLE = 5


def _enc(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=_PICKLE)


def _dec(data: bytes) -> Any:
    return pickle.loads(data)


def collector_host_pubs(col) -> int:
    """Publishes a ``BatchCollector`` served from the trie instead of the
    device: the sum of its ``*_host_pubs`` counters."""
    return sum(getattr(col, k) for k in dir(col) if k.endswith("_host_pubs"))


def owned_delta(node: str, key: Any, opts: Any) -> bool:
    """Should a worker forward this registry delta to the service?

    Node-pointer rows never forward (the service derives pointers per
    querying worker from ``opts.node``). Plain-sid rows only ever fire
    locally (``reg._trie_add/_trie_remove`` emit them when node ==
    self), so they forward. Shared-group adds are emitted by EVERY
    worker for every replicated record — only the owner forwards;
    removes carry no opts, so they forward from everyone and the
    service applies them idempotently."""
    if isinstance(key, str):
        return False
    if isinstance(key, tuple) and len(key) == 3 and key[0] == "$g":
        if opts is None:
            return True
        return getattr(opts, "node", node) == node
    return True


def localize_rows(rows: Iterable[Tuple], node: str) -> List[Tuple]:
    """Translate service (node-qualified) rows into the shape THIS
    worker's own trie fold would return: own plain rows stay direct,
    foreign plain rows become node-pointer rows (route_rows dedups the
    forwards per node), shared rows pass through (their opts.node
    already drives the shared-sub policy)."""
    out: List[Tuple] = []
    for fw, key, opts in rows:
        if isinstance(key, tuple) and len(key) == 3 and key[0] == "$g":
            out.append((fw, key, opts))
            continue
        owner = getattr(opts, "node", None) if opts is not None else None
        if owner is None or owner == node:
            out.append((fw, key, opts))
        else:
            out.append((fw, owner, None))
    return out


class _ServiceRegistryShim:
    """The minimal registry surface TpuRegView/BatchCollector need,
    backed by the service's own sub state: ``trie(mp)`` (warm-load +
    host fallback oracle) and ``fold_subscriptions(mp)``."""

    def __init__(self, service: "MatchService"):
        self._service = service

    def trie(self, mountpoint: str = "") -> SubscriptionTrie:
        return self._service.trie(mountpoint)

    def fold_subscriptions(self, mountpoint: str = ""):
        return self.trie(mountpoint).entries()


class MatchService:
    """Service-process core: subscription state + the drainer that
    super-batches ring fold requests into the match pipeline."""

    def __init__(self, stats: WorkerStatsBlock,
                 rings: Sequence[Tuple[ShmRing, ShmRing]],
                 view: str = "trie",
                 tpu_opts: Optional[Dict[str, Any]] = None,
                 collector_window_us: int = 200,
                 super_batch_k: int = 8, device=None):
        """``view`` ``"tpu"`` serves folds through the GPU match engine
        on ``device`` (default the CUDA card; without one it raises),
        ``"trie"`` through the service's host trie."""
        self.stats = stats
        self.rings = list(rings)  # [(req, resp), ...] per worker
        for _req, resp in self.rings:
            # this process is the sole producer of every response ring:
            # a predecessor's orderly close() left them marked closed,
            # and without this reset a respawned service could never
            # answer a fold again (workers would degrade to the local
            # trie forever despite the epoch-bump resync)
            resp.mark_open()
        self.view_kind = view
        self._tries: Dict[str, SubscriptionTrie] = {}
        # (mountpoint, filter, key) -> opts; the dedup/idempotency layer
        # that makes worker resync replays and duplicate shared-row
        # removes harmless
        self._subs: Dict[Tuple[str, Tuple[str, ...], Any], Any] = {}
        self.ops_applied = 0
        self.stale_unsubs = 0
        # ring index -> node name, learned from each worker's "resync"
        # announcement (always its first record): lets apply_unsub
        # reject a previous owner's racing remove after a reconnect
        # handed the row to another worker
        self._ring_node: Dict[int, str] = {}
        self.folds = 0
        self.fold_pubs = 0
        self.resyncs = 0
        self.fold_errors = 0
        self.responses_dropped = 0
        self._pending_resp: List[Deque[Tuple[float, bytes]]] = \
            [deque() for _ in self.rings]
        self._view = None
        self._collector = None
        if view == "tpu":
            from ..models.matcher import BatchCollector, GpuRegView

            shim = _ServiceRegistryShim(self)
            opts = dict(tpu_opts or {})
            # the service process holds the GPU table: the broker's
            # full-collection policy (broker/heap.py) runs here
            POLICY.hold(self)
            self._view = GpuRegView(shim, device=device, **opts)
            self._collector = BatchCollector(
                self._view, window_us=collector_window_us,
                super_batch_k=super_batch_k)

    # --------------------------------------------------------- sub state

    def trie(self, mountpoint: str = "") -> SubscriptionTrie:
        t = self._tries.get(mountpoint)
        if t is None:
            t = self._tries[mountpoint] = SubscriptionTrie()
        return t

    def _emit_tpu_delta(self, op: str, mp: str, fw, key, opts) -> None:
        if self._view is not None:
            try:
                self._view.on_delta(op, mp, list(fw), key, opts)
            except Exception:
                log.exception("device-table delta failed (the trie "
                              "oracle stays correct; dispatch degrades)")

    def apply_sub(self, mp: str, fw, key, opts) -> None:
        fw = tuple(fw)
        k = (mp, fw, key)
        prev = self._subs.get(k, _MISSING)
        if prev is not _MISSING and _opts_eq(prev, opts):
            return  # duplicate forward (resync replay): no-op
        self._subs[k] = opts
        self.trie(mp).add(list(fw), key, opts)
        self._emit_tpu_delta("add", mp, fw, key, opts)
        self.ops_applied += 1
        self.stats.bump_generation()

    def apply_unsub(self, mp: str, fw, key,
                    from_node: Optional[str] = None) -> None:
        fw = tuple(fw)
        k = (mp, fw, key)
        if from_node is not None and not (
                isinstance(key, tuple) and len(key) == 3
                and key[0] == "$g"):
            # plain rows only ever fire from their owner's worker: an
            # unsub from any OTHER ring is a previous owner's racing
            # remove after a reconnect moved the client — the new
            # owner's re-add must survive it. Shared ($g) removes are
            # deliberately exempt: every worker forwards them for every
            # replicated record and the pop below dedups.
            cur = self._subs.get(k, _MISSING)
            if cur is not _MISSING and \
                    getattr(cur, "node", from_node) != from_node:
                self.stale_unsubs += 1
                return
        if self._subs.pop(k, _MISSING) is _MISSING:
            return  # duplicate/unknown remove: idempotent
        self.trie(mp).remove(list(fw), key)
        self._emit_tpu_delta("remove", mp, fw, key, None)
        self.ops_applied += 1
        self.stats.bump_generation()

    def apply_resync(self, node: str) -> None:
        """A worker (re)starts its forward stream: drop every row it
        owns — it replays them all right after, so a respawned worker
        (same identity, empty session set) can never leave stale rows
        matching into its dead sessions."""
        self.resyncs += 1
        dead = [(mp, fw, key) for (mp, fw, key), opts in self._subs.items()
                if _row_owner(key, opts) == node]
        for mp, fw, key in dead:
            self.apply_unsub(mp, fw, key)
        self.stats.bump_generation()

    # ------------------------------------------------------------ serving

    def subscriptions(self) -> int:
        return len(self._subs)

    def handle_record(self, widx: int, raw: bytes) -> None:
        try:
            rec = _dec(raw)
            kind = rec[0]
        except Exception:
            log.exception("undecodable ring record from worker %d", widx)
            return
        if kind == "fold":
            _, req_id, mp, topics = rec[:4]
            # flight-recorder envelope: a 5th element marks a traced
            # fold — the reply then carries this process's receive/done
            # CLOCK_MONOTONIC stamps + pid so the worker's recorder can
            # split the ring round trip into request transit / service
            # residency / reply transit (recorder.PublishTrace.meta)
            traced = len(rec) > 4 and bool(rec[4])
            t_recv = time.monotonic() if traced else 0.0
            self.folds += 1
            self.fold_pubs += len(topics)
            if self._collector is not None:
                fut = self._collector.submit_batch(mp, topics)

                def _done(f, widx=widx, req_id=req_id,
                          mp=mp, topics=topics, t_recv=t_recv,
                          traced=traced):
                    exc = f.exception()
                    if isinstance(exc, KernelError):
                        # a fault of the device code: the worker raises
                        # it, its trie does not answer it
                        self.fold_errors += 1
                        self._respond(widx, (req_id, "fault", str(exc)))
                    elif exc is not None:
                        # the collector itself degrades to the service
                        # trie internally; an error here is exceptional
                        self.fold_errors += 1
                        self._respond(widx,
                                      (req_id, "err", repr(exc)))
                    elif traced:
                        self._respond(widx, (req_id, "ok", f.result(),
                                             self._fold_meta(t_recv)))
                    else:
                        self._respond(widx, (req_id, "ok", f.result()))

                fut.add_done_callback(_done)
            else:
                trie = self.trie(mp)
                rows = [trie.match(list(t)) for t in topics]
                if traced:
                    self._respond(widx, (req_id, "ok", rows,
                                         self._fold_meta(t_recv)))
                else:
                    self._respond(widx, (req_id, "ok", rows))
        elif kind == "sub":
            _, mp, fw, key, opts = rec
            self.apply_sub(mp, fw, key, opts)
        elif kind == "unsub":
            _, mp, fw, key = rec
            self.apply_unsub(mp, fw, key,
                             from_node=self._ring_node.get(widx))
        elif kind == "resync":
            self._ring_node[widx] = rec[1]
            self.apply_resync(rec[1])
        else:
            log.warning("unknown ring record kind %r from worker %d",
                        kind, widx)

    @staticmethod
    def _fold_meta(t_recv: float) -> Dict[str, float]:
        return {"svc_recv": t_recv, "svc_done": time.monotonic(),
                "svc_pid": os.getpid()}

    #: unsent responses older than this are dropped — the worker's fold
    #: timed out long ago and is serving its local trie already
    RESP_TTL_S = 10.0

    def _respond(self, widx: int, payload: Tuple) -> None:
        data = _enc(payload)
        ring = self.rings[widx][1]
        try:
            if not ring.push(data):
                self._pending_resp[widx].append((time.monotonic(), data))
        except (RingClosed, RingFull):
            self.responses_dropped += 1

    def _retry_pending(self) -> None:
        now = time.monotonic()
        for widx, pend in enumerate(self._pending_resp):
            while pend:
                ts, data = pend[0]
                if now - ts > self.RESP_TTL_S:
                    pend.popleft()
                    self.responses_dropped += 1
                    continue
                try:
                    if not self.rings[widx][1].push(data):
                        break
                except (RingClosed, RingFull):
                    self.responses_dropped += 1
                pend.popleft()

    def poll_once(self, max_records: int = 64) -> int:
        """One drain pass over every worker's request ring; returns the
        number of records handled."""
        n = 0
        for widx, (req, _resp) in enumerate(self.rings):
            for raw in req.pop_many(max_records):
                self.handle_record(widx, raw)
                n += 1
        self._retry_pending()
        return n

    def host_served(self) -> int:
        """Publishes the service answered off the device: its collector's
        trie-served publishes and its matchers' host fallbacks."""
        if self._collector is None:
            return 0
        return collector_host_pubs(self._collector) + sum(
            m.host_fallbacks for m in self._view._matchers.values())

    def publish_stats(self) -> None:
        self.stats.service_heartbeat()
        self.stats.set_service_counters(self.ops_applied, self.folds,
                                        self.fold_pubs)
        batches = (sum(m.match_batches for m in self._view._matchers.values())
                   if self._view is not None else 0)
        self.stats.set_service_device(self.host_served(), self.fold_errors,
                                      batches)
        self.stats.set_service_launches(TM.launches, EX.launches,
                                        MK.plain_cuda_extractions)
        self.stats.set_service_dense(TM.dense_launches, MK.plain_cuda_packs)
        # the device-side stage histograms (dispatch/delta/rebuild/
        # collector wait) live in THIS process; publishing the packed
        # block is the only way they reach a worker's scrape endpoint
        try:
            self.stats.write_service_hist(obs.pack_all())
            self.stats.write_service_events(_events.journal().pack())
        except Exception:
            pass  # an old-layout block (no hist region) stays healthy

    async def run(self, stop: asyncio.Event,
                  idle_min_s: float = 0.0003,
                  idle_max_s: float = 0.005) -> None:
        """The drainer loop: busy while records flow, exponential
        poll backoff when idle (bounded at ``idle_max_s`` so fold
        latency stays sub-window even from cold)."""
        idle = idle_min_s
        last_hb = 0.0
        while not stop.is_set():
            n = self.poll_once()
            now = time.monotonic()
            if now - last_hb >= 0.25:
                self.publish_stats()
                last_hb = now
            if n:
                idle = idle_min_s
                # yield even when busy: in view='tpu' mode the fold
                # replies come from BatchCollector call_later flushes and
                # executor-completion callbacks on THIS loop — a sustained
                # record stream (e.g. a worker's resync replay) must not
                # starve them or every in-flight fold times out
                await asyncio.sleep(0)
            else:
                await asyncio.sleep(idle)
                idle = min(idle * 2, idle_max_s)

    def close(self) -> None:
        for req, resp in self.rings:
            try:
                resp.mark_closed()
            except Exception:
                pass
        if self._view is not None:
            self._view.close()
            POLICY.release(self)


_MISSING = object()


def _opts_eq(a: Any, b: Any) -> bool:
    # SubOpts is a dataclass whose generated __eq__ ignores the
    # dynamically-assigned .node — but node is exactly what changes when
    # a reconnecting client lands on a different worker (ownership
    # transfer). Swallowing that re-add as a duplicate leaves the row
    # owned by the OLD worker, whose racing unsub then deletes it.
    try:
        return (a == b
                and getattr(a, "node", None) == getattr(b, "node", None))
    except Exception:
        return False


def _row_owner(key: Any, opts: Any) -> Optional[str]:
    if opts is not None:
        node = getattr(opts, "node", None)
        if node is not None:
            return node
    return None


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


class _ResponseMux:
    """Demultiplex the (single-consumer) response ring across concurrent
    fold threads: exactly one waiting thread drains the ring at a time;
    everyone else waits on the condition for its req_id to land."""

    #: stored replies nobody claims (their fold timed out and forgot the
    #: req_id before the drain landed it) are pruned after this long —
    #: req ids are pid-salted and never reused, so an unclaimed entry is
    #: garbage forever and a persistently-slow service would otherwise
    #: grow ``_resp`` without bound
    STALE_TTL_S = 30.0

    def __init__(self, ring: ShmRing):
        self._ring = ring
        self._cond = threading.Condition()
        self._resp: Dict[int, Tuple[float, str, Any]] = {}
        self._draining = False
        self._last_prune = 0.0

    def wait_for(self, req_id: int,
                 deadline: float) -> Tuple[str, Any, Optional[dict]]:
        while True:
            with self._cond:
                if req_id in self._resp:
                    _, status, payload, meta = self._resp.pop(req_id)
                    return (status, payload, meta)
                if self._draining:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("match service reply timeout")
                    self._cond.wait(min(remaining, 0.05))
                    continue
                self._draining = True
            try:
                got = self._drain(req_id, deadline)
                if got is not None:
                    return got
            finally:
                with self._cond:
                    self._draining = False
                    self._cond.notify_all()

    def _drain(self, req_id: int,
               deadline: float) -> Optional[Tuple[str, Any,
                                                  Optional[dict]]]:
        while True:
            recs = self._ring.pop_many()
            if recs:
                now = time.monotonic()
                with self._cond:
                    out = None
                    for raw in recs:
                        try:
                            rec = _dec(raw)
                            rid, status, payload = rec[0], rec[1], rec[2]
                            meta = rec[3] if len(rec) > 3 else None
                        except Exception:
                            continue
                        if rid == req_id:
                            out = (status, payload, meta)
                        else:
                            self._resp[rid] = (now, status, payload, meta)
                    if self._resp and now - self._last_prune > 1.0:
                        self._last_prune = now
                        cutoff = now - self.STALE_TTL_S
                        for rid in [r for r, (ts, *_)
                                    in self._resp.items() if ts < cutoff]:
                            del self._resp[rid]
                    self._cond.notify_all()
                    if out is not None:
                        return out
                continue
            if time.monotonic() >= deadline:
                raise TimeoutError("match service reply timeout")
            if self._ring.closed:
                raise RingClosed(self._ring.name)
            time.sleep(0.0003)

    def forget(self, req_id: int) -> None:
        with self._cond:
            self._resp.pop(req_id, None)


class MatchServiceClient:
    """Worker-side stub: marshals fold batches and subscription write
    ops into the request ring, demuxes replies, tracks the service
    epoch and replays owned rows after a service respawn."""

    #: op backlog bound while the ring is full / the service is down:
    #: past it the backlog is dropped and a FULL resync is owed (the
    #: resync replays everything, so dropping loses nothing). A resync
    #: replay itself never contributes more than RESYNC_CHUNK queued
    #: rows (the pump backpressures on backlog depth), so overflow only
    #: ever means live deltas alone outran the ring — re-arming the
    #: resync then cannot livelock.
    MAX_OP_BACKLOG = 65536
    #: resync rows encoded per pump call while the backlog has room —
    #: bounds the per-tick event-loop hold (a million-row replay streams
    #: across ticks instead of freezing session IO for one giant encode)
    RESYNC_CHUNK = 2048
    #: max rows replayed per keeper tick when the ring keeps up
    RESYNC_TICK_BUDGET = 16384

    def __init__(self, req_ring: str, resp_ring: str, stats_block: str,
                 worker_index: int, node_name: str,
                 timeout_ms: float = 2000.0,
                 breaker: Optional[CircuitBreaker] = None):
        self.req = ShmRing.attach(req_ring)
        self.resp = ShmRing.attach(resp_ring)
        self.stats = WorkerStatsBlock.attach(stats_block)
        self.worker_index = worker_index
        self.node_name = node_name
        self.timeout_s = timeout_ms / 1e3
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, backoff_initial=0.5, backoff_max=5.0,
            name="match_client")
        self._mux = _ResponseMux(self.resp)
        self._req_lock = threading.Lock()  # single-producer discipline
        # drain stale replies a dead predecessor (same worker identity,
        # earlier pid) never read, and salt req ids with the pid: a
        # leftover reply must never satisfy a NEW request's id
        while self.resp.pop_many(256):
            pass
        self._ids = itertools.count(((os.getpid() & 0xFFFF) << 32) + 1)
        self._op_backlog: Deque[bytes] = deque()
        # the construction-time epoch is the one this client serves
        # against; a mismatch later (service respawned) fences folds to
        # the local trie until the keeper finishes the resync. start()
        # arms the first-boot announcement resync; keeper-less direct
        # use (unit tests, tooling) serves immediately.
        self._need_resync = False
        self._seen_epoch: int = self.stats.epoch()
        # active chunked resync: a snapshot of owned rows still to
        # stream, and the keys live ops superseded since the snapshot
        # (their snapshot rows must not replay over the newer op)
        self._resync_rows: Optional[Deque[Tuple]] = None
        self._resync_superseded: Set[Tuple] = set()
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self.folds_sent = 0
        self.fold_pubs_sent = 0
        self.fold_timeouts = 0
        self.fold_stalls = 0
        self.fold_degraded = 0
        self.fold_held = 0
        self.ops_sent = 0
        self.ops_dropped = 0
        self.resyncs_sent = 0

    # ------------------------------------------------------------- fold

    def fold(self, mountpoint: str,
             topics: Sequence[Tuple[str, ...]],
             meta_out: Optional[dict] = None) -> List[List[Tuple]]:
        """Round-trip one batch of publish topics through the service.
        BLOCKING — call from an executor/sacrificial thread only (the
        BatchCollector already runs its flushes there). Raises
        DeviceDegraded when the service can't serve promptly; the
        caller's shed path serves the local trie.

        ``meta_out`` (flight recorder): when given, the fold is marked
        traced in the envelope and this dict is filled with the ring
        send/receive stamps plus the service's own receive/done stamps
        and pid — the cross-process half of ONE publish record."""
        if self._closed:
            raise DeviceDegraded("match service client closed")
        if not self.breaker.allow():
            self.fold_degraded += 1
            raise DeviceDegraded("match service circuit open")
        if self._op_backlog or self._need_resync \
                or self._resync_rows is not None \
                or self.stats.epoch() != self._seen_epoch:
            # ordering fence: a queued ("sub", ...) op means the service
            # trie is missing an already-SUBACKed row — a fold pushed
            # now would overtake it in the ring and return results the
            # in-process (synchronous trie add) path could never produce.
            # Same for an epoch bump the keeper hasn't resynced yet (a
            # respawned service is empty) and for an in-flight resync
            # replay (service state is partial). Serve the local trie
            # until the op channel is caught up. NOT a breaker event:
            # the service isn't failing, we are simply not allowed to
            # overtake our own write stream.
            self.fold_held += 1
            raise DeviceDegraded("match service op backlog pending")
        req_id = next(self._ids)
        if meta_out is None:
            data = _enc(("fold", req_id, mountpoint,
                         [tuple(t) for t in topics]))
        else:
            data = _enc(("fold", req_id, mountpoint,
                         [tuple(t) for t in topics], True))
        send_t = time.monotonic()
        try:
            with self._req_lock:
                ok = self.req.push(data)
        except (RingClosed, RingFull) as e:
            self._fold_failed()
            raise DeviceDegraded(f"match service ring: {e!r}") from e
        if not ok:
            self._fold_failed()
            raise DeviceDegraded("match service request ring full")
        self.folds_sent += 1
        self.fold_pubs_sent += len(topics)
        deadline = time.monotonic() + self.timeout_s
        try:
            status, payload, meta = self._mux.wait_for(req_id, deadline)
        except TimeoutError as e:
            self.fold_timeouts += 1
            self._mux.forget(req_id)
            self._fold_failed()
            raise DeviceDegraded("match service reply timeout") from e
        except RingClosed as e:
            self._fold_failed()
            raise DeviceDegraded("match service ring closed") from e
        recv_t = time.monotonic()
        # per-fold ring round trip (request push -> reply landed): the
        # seam the match_service_timeout_ms knob is judged against.
        # Straggler-guarded: a watchdog-abandoned fold's late reply
        # must not record its wedge-inflated RTT into the tuning base
        if not watchdog_mod.current_op_abandoned():
            obs.observe("stage_ring_rtt_ms", (recv_t - send_t) * 1e3)
        if status == "fault":
            raise KernelError(f"match service: {payload}")
        if status != "ok":
            self._fold_failed()
            raise DeviceDegraded(f"match service error: {payload}")
        if meta_out is not None:
            meta_out["send_t"] = send_t
            meta_out["recv_t"] = recv_t
            if meta:
                meta_out.update(meta)
        if not watchdog_mod.current_op_abandoned():
            # a watchdog-abandoned fold's straggler reply must not close
            # the breaker its own stall just fed (record_stall) — same
            # guard as TpuMatcher._record_device_success
            self.breaker.record_success()
        return [localize_rows(rows, self.node_name) for rows in payload]

    def _fold_failed(self) -> None:
        if watchdog_mod.current_op_abandoned():
            # the stall already recorded this fold's failure at
            # abandonment; a late timeout/error must not double-count
            return
        if self.breaker.record_failure():
            log.error("match service path OPENED (worker %d): folds "
                      "degrade to the local trie until a probe succeeds",
                      self.worker_index)

    # ------------------------------------------------- subscription ops

    def send_op(self, record: Tuple) -> None:
        """Queue one subscription write op (loop-side, non-blocking).
        Ring-full ops buffer in the backlog; overflow forces a full
        resync instead of silently dropping a row."""
        if self._closed:
            return
        if self._resync_rows is not None and record[0] in ("sub", "unsub"):
            # a live op during an active resync wins over the snapshot:
            # its row must not be replayed underneath (a snapshot sub
            # landing after a live unsub would resurrect a dead row)
            self._resync_superseded.add(
                (record[1], tuple(record[2]), record[3]))
        self._op_backlog.append(_enc(record))
        if len(self._op_backlog) > self.MAX_OP_BACKLOG:
            self.ops_dropped += len(self._op_backlog)
            self._op_backlog.clear()
            self._resync_rows = None
            self._resync_superseded = set()
            self._need_resync = True
        self._flush_ops()

    def _flush_ops(self) -> int:
        sent = 0
        while self._op_backlog:
            data = self._op_backlog[0]
            try:
                with self._req_lock:
                    ok = self.req.push(data)
            except RingFull:
                # this record can NEVER fit (> ring capacity / 2):
                # keeping it at the backlog head would wedge every op
                # behind it until the overflow resync loops on the same
                # row — drop it and count, the local trie still serves
                self._op_backlog.popleft()
                self.ops_dropped += 1
                log.error("match service op record exceeds ring bound; "
                          "dropped (%dB)", len(data))
                continue
            except RingClosed:
                break
            if not ok:
                break
            self._op_backlog.popleft()
            self.ops_sent += 1
            sent += 1
        return sent

    def resync(self, registry) -> None:
        """Replay every locally-owned row: the service dropped (or never
        had) this worker's rows — announce ownership, then stream them
        through the same ordered op channel.

        The replay is CHUNKED: this call only snapshots row references
        (no pickling) and enqueues the ownership marker; the keeper
        pumps the snapshot into the ring RESYNC_CHUNK rows at a time,
        so a million-row replay never freezes the worker loop for one
        giant encode and never balloons the op backlog past its bound.
        Folds degrade to the local trie while the replay is in flight
        (the fold() ordering fence), so partial service state is never
        served."""
        self.resyncs_sent += 1
        rows: Deque[Tuple] = deque()
        for mp in list(getattr(registry, "_tries", {})):
            for fw, key, opts in registry.fold_subscriptions(mp):
                if owned_delta(self.node_name, key, opts) \
                        and not isinstance(key, str) and opts is not None:
                    rows.append((mp, tuple(fw), key, opts))
        self._op_backlog.appendleft(_enc(("resync", self.node_name)))
        self._resync_rows = rows
        self._resync_superseded = set()
        self._pump_resync()

    def _pump_resync(self) -> None:
        """Stream queued resync rows into the op channel, bounded per
        call: at most RESYNC_TICK_BUDGET rows encoded, never growing the
        backlog past RESYNC_CHUNK (ring-full backpressure — the next
        tick resumes where this one stopped)."""
        rows = self._resync_rows
        if rows is None:
            return
        budget = self.RESYNC_TICK_BUDGET
        while rows and budget > 0:
            if len(self._op_backlog) >= self.RESYNC_CHUNK:
                if not self._flush_ops():
                    return  # ring full: resume next tick
                continue
            mp, fw, key, opts = rows.popleft()
            if (mp, fw, key) in self._resync_superseded:
                continue
            self._op_backlog.append(_enc(("sub", mp, fw, key, opts)))
            budget -= 1
        self._flush_ops()
        if not rows:
            self._resync_rows = None
            self._resync_superseded = set()

    # ------------------------------------------------------- supervision

    def generation(self) -> int:
        return self.stats.generation()

    def service_info(self) -> Dict[str, Any]:
        return self.stats.service_info()

    def start(self, registry, interval_s: float = 0.25) -> None:
        """Loop-side keeper task: flushes the op backlog and watches the
        service epoch — a bump means the service respawned empty, so
        every owned row replays (partition healing). The first tick
        always resyncs: a respawned WORKER (same identity, fresh
        sessions) must drop its predecessor's stale rows even when the
        service epoch never moved."""
        self._need_resync = True

        async def _keeper() -> None:
            while not self._closed:
                try:
                    epoch = self.stats.epoch()
                    if epoch and (self._need_resync
                                  or epoch != self._seen_epoch):
                        # resync() installs _resync_rows before _seen_epoch
                        # advances or _need_resync clears, so the fold()
                        # fence never has a gap between "replay needed"
                        # and "replay in flight" — clearing the flag first
                        # would open the fence for the whole snapshot
                        # build when the epoch never moved (worker
                        # respawn); a resync() failure retries next tick
                        self.resync(registry)
                        self._seen_epoch = epoch
                        self._need_resync = False
                    elif self._resync_rows is not None:
                        self._pump_resync()
                    elif self._op_backlog:
                        self._flush_ops()
                except Exception:
                    log.exception("match service keeper tick failed")
                await asyncio.sleep(interval_s)

        self._task = asyncio.get_event_loop().create_task(_keeper())

    def stats_dict(self) -> Dict[str, float]:
        return {
            "match_client_folds": float(self.folds_sent),
            "match_client_fold_pubs": float(self.fold_pubs_sent),
            "match_client_timeouts": float(self.fold_timeouts),
            "match_client_stalls": float(self.fold_stalls),
            "match_client_degraded": float(self.fold_degraded),
            "match_client_held": float(self.fold_held),
            "match_client_ops_sent": float(self.ops_sent),
            "match_client_ops_dropped": float(self.ops_dropped),
            "match_client_resyncs": float(self.resyncs_sent),
            "match_client_breaker_state": float(self.breaker.state),
            "match_client_op_backlog": float(len(self._op_backlog)),
        }

    def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.req.close()
        self.resp.close()
        self.stats.close()


class _ClientMatcherStub:
    """What BatchCollector sees as 'the matcher' in client mode: stall
    reports feed the client breaker (a deadline-abandoned ring fold is
    a service failure like any other)."""

    def __init__(self, client: MatchServiceClient):
        self._client = client

    def record_stall(self, exc: Optional[BaseException] = None) -> None:
        self._client.fold_stalls += 1
        self._client._fold_failed()


class ShmMatchView:
    """The reg-view seam adapter workers mount at ``reg_views["tpu"]``:
    fold batches go to the match service over the rings; subscription
    deltas forward ownership-filtered; everything degrades to the
    worker's local trie through the standard shed exceptions."""

    name = "tpu"
    #: BatchCollector probes this: fold_batch/fold_many accept a
    #: meta_out box that comes back filled with the cross-process ring
    #: stamps for a traced flush (flight recorder envelope)
    fold_meta_capable = True

    def __init__(self, registry, client: MatchServiceClient):
        self.registry = registry
        self.client = client
        self._stub = _ClientMatcherStub(client)

    # BatchCollector surface ------------------------------------------

    def matcher(self, mountpoint: str = "") -> _ClientMatcherStub:
        return self._stub

    def fold(self, mountpoint: str, topic: Sequence[str]) -> List[Tuple]:
        try:
            return self.client.fold(mountpoint, [tuple(topic)])[0]
        except DeviceDegraded:
            return self.registry.trie(mountpoint).match(list(topic))

    def fold_batch(self, mountpoint: str,
                   topics: Sequence[Sequence[str]],
                   lock_timeout: Optional[float] = None,
                   meta_out: Optional[dict] = None):
        return self.client.fold(mountpoint, [tuple(t) for t in topics],
                                meta_out=meta_out)

    def fold_many(self, mountpoint: str,
                  batches: Sequence[Sequence[Sequence[str]]],
                  lock_timeout: Optional[float] = None,
                  meta_out: Optional[dict] = None):
        flat: List[Tuple[str, ...]] = []
        for b in batches:
            flat.extend(tuple(t) for t in b)
        rows = self.client.fold(mountpoint, flat, meta_out=meta_out)
        out, i = [], 0
        for b in batches:
            out.append(rows[i:i + len(b)])
            i += len(b)
        return out

    def supports_many(self, mountpoint: str = "") -> bool:
        return True

    # registry delta feed ---------------------------------------------

    def on_delta(self, op: str, mountpoint: str, filter_words, key,
                 opts) -> None:
        if not owned_delta(self.client.node_name, key, opts):
            return
        if op == "add":
            self.client.send_op(("sub", mountpoint, tuple(filter_words),
                                 key, opts))
        else:
            self.client.send_op(("unsub", mountpoint,
                                 tuple(filter_words), key))

    # admin/metrics surface -------------------------------------------

    def breaker_status(self) -> Dict[str, Any]:
        return {"(match-service)": self.client.breaker.status()}

    def close(self) -> None:
        self.client.close()


# ---------------------------------------------------------------------------
# service process entry point (spawn-safe, top-level)
# ---------------------------------------------------------------------------


def _service_main(stats_name: str,
                  ring_names: List[Tuple[str, str]],
                  view: str, epoch: int,
                  tpu_opts: Optional[Dict[str, Any]] = None,
                  device: Optional[str] = None) -> None:
    """The match service process: serves every worker's rings until
    SIGTERM. With ``view`` ``"tpu"`` it is the one process of the group
    that runs on ``device`` (default the CUDA card)."""
    import faulthandler
    import signal

    dump_s = int(os.environ.get("TIER1_FAULTHANDLER_S") or 0)
    if dump_s > 0:
        # hung-child forensics: same contract as tests/conftest.py —
        # the parent's wall kills us, but the log says where we hung
        faulthandler.enable()
        faulthandler.dump_traceback_later(dump_s, repeat=True, exit=False)

    async def amain() -> None:
        stats = WorkerStatsBlock.attach(stats_name)
        rings = [(ShmRing.attach(rq), ShmRing.attach(rs))
                 for rq, rs in ring_names]
        svc = MatchService(stats, rings, view=view, tpu_opts=tpu_opts,
                           device=device)
        stats.set_service(epoch, os.getpid())
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        try:
            await svc.run(stop)
        finally:
            svc.close()
            for rq, rs in rings:
                rq.close()
                rs.close()
            stats.close()

    asyncio.run(amain())
