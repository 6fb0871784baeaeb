"""SWC metadata store: causally-consistent replicated KV on Server Wide
Clocks — the second metadata backend, as ``vmq_swc`` is to ``vmq_plumtree``
in the reference (selected by ``metadata_plugin`` config the way
``metadata_impl`` picks the store at ``vmq_metadata.erl:24-28``).

Structure mirrors the reference:

- ``SWCGroupStore`` ⇢ ``vmq_swc_store.erl``: one replica group holding
  node clock + watermark + dot-key-map (``vmq_swc_store.erl:63-77``),
  write path ``fill → discard → event → add → strip`` (process_write_op),
  replicate path ``sync`` (process_replicate_op), sync-repair
  (fill_strip_save_batch), watermark-driven incremental GC.
- ``SWCMetadata`` ⇢ ``vmq_swc_plugin.erl``: hash-partitioned replication
  groups (``vmq_swc_plugin.erl:36-44``), LWW timestamping of values so
  concurrent siblings resolve deterministically (``:97-100,143-147``),
  plus the anti-entropy exchange loop ⇢ ``vmq_swc_exchange_fsm.erl``:
  lock → clock/watermark exchange → missing-dot batches → sync_repair
  (``:34-116``).

The exchange runs over the cluster's framed TCP channel (``swc``/``swr``
request-response frames) instead of erlang-dist rpc
(``vmq_swc_edist_srv.erl:63-66``) — the broker deliberately has no second
control-plane transport.

Public API matches ``cluster.metadata.MetadataStore`` so the broker and
cluster layers are backend-agnostic (the ``vmq_metadata`` facade role).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from . import codec
from . import swc_kernel as K
from .com import joined
from .swc_kernel import DELETED, DCC, BVV, Dot, DotKeyMap, Watermark

log = logging.getLogger("vernemq_tpu_torch.swc")

Key = Tuple[str, Any]


class SWCGroupStore:
    """One replication group: full SWC state over a slice of the keyspace."""

    def __init__(self, owner: "SWCMetadata", group: int):
        self.owner = owner
        self.group = group
        self.id = owner.node_name
        self.objects: Dict[Key, DCC] = {}   # live + tombstoned (stripped) objs
        self.nodeclock: BVV = K.bvv_new()
        self.watermark: Watermark = K.wm_new()
        self.dkm = DotKeyMap()
        self.peers: List[str] = []          # replica peers, excluding self

    # ------------------------------------------------------------ write path

    def write(self, skey: Key, value: Any) -> Tuple[Key, DCC]:
        """Local write/delete; returns the (key, obj) to replicate
        (process_write_op at vmq_swc_store.erl)."""
        disk = K.dcc_fill(self.objects.get(skey, K.dcc_new()), self.nodeclock)
        ctx = K.dcc_context(disk)
        discarded = K.dcc_discard(disk, ctx)
        counter, self.nodeclock = K.bvv_event(self.nodeclock, self.id)
        new_obj = K.dcc_add(discarded, (self.id, counter), value)
        self._strip_save(skey, new_obj, disk, self.id)
        return skey, new_obj

    def merge_object(self, skey: Key, obj: DCC, origin: str) -> None:
        """Apply a replicated object from a peer broadcast
        (process_replicate_op). The local object is filled against the clock
        *before* the incoming dots are absorbed — filling after would make
        the new dots look causally covered and discard them."""
        clock0 = self.nodeclock
        self.nodeclock = K.bvv_add_dcc(self.nodeclock, obj)
        disk = K.dcc_fill(self.objects.get(skey, K.dcc_new()), clock0)
        final = K.dcc_sync(obj, disk)
        self._strip_save(skey, final, disk, origin)

    def _strip_save(self, skey: Key, obj: DCC, old: DCC, origin: str) -> None:
        """strip_save_batch: log dots, strip causality, classify into
        live / tombstone / hard-delete, fire the change event."""
        for dot in obj[0]:
            self.dkm.insert(dot[0], dot[1], skey)
            self.owner._persist_dot(self.group, dot, skey)
        dots, ctx = K.dcc_strip(obj, self.nodeclock)
        live = {d: v for d, v in dots.items() if v != DELETED}
        old_values = K.dcc_values(old)
        if not live:
            if not ctx or not self.peers:
                # case 1: no value, no (needed) causal history → gone
                self.objects.pop(skey, None)
                self.dkm.mark_for_gc(skey)
            else:
                # case 0: delete, but the tombstone must persist until AE
                # has spread it
                self.objects[skey] = (live, ctx)
                self.dkm.mark_for_gc(skey)
            self.owner._persist_obj(self.group, skey, None)
            if old_values:
                self.owner._fire(skey, old_values, [], origin)
        else:
            self.dkm.unmark(skey)
            self.objects[skey] = (live, ctx)
            self.owner._persist_obj(self.group, skey, (live, ctx))
            self.owner._fire(skey, old_values, list(live.values()), origin)

    # ------------------------------------------------------------- sync API

    def sync_missing(self, dots: List[Dot]) -> List[Tuple[Key, DCC]]:
        """Objects for the dots a peer is missing; a dot whose object was
        hard-deleted becomes an explicit delete-marker object
        (handle_call sync_missing, vmq_swc_store.erl)."""
        out: List[Tuple[Key, DCC]] = []
        seen = set()
        for dot in dots:
            skey = self.dkm.lookup(dot)
            if skey is None or skey in seen:
                continue
            seen.add(skey)
            obj = self.objects.get(skey)
            if obj is None:
                out.append((skey, K.dcc_add(K.dcc_new(), dot, DELETED)))
            else:
                out.append((skey, obj))
        return out

    def sync_repair(self, missing: List[Tuple[Key, DCC]], remote_clock: BVV,
                    origin: str) -> int:
        """fill_strip_save_batch: merge remote objects that genuinely add
        information; returns how many were applied.

        Remote objects arrive *stripped relative to the sender's clock*
        (strip/fill invariant), so they are filled with ``remote_clock``
        first — without that, a tombstone whose context the sender's base
        covered would fail to dominate our live sibling dots and deleted
        values would resurrect."""
        applied = 0
        clock0 = self.nodeclock
        for skey, obj in missing:
            obj = K.dcc_fill(obj, remote_clock)
            local = K.dcc_fill(self.objects.get(skey, K.dcc_new()), clock0)
            synced = K.dcc_sync(obj, local)
            if synced[0] != local[0] or (not synced[0] and not local[0]):
                self.nodeclock = K.bvv_add_dcc(self.nodeclock, synced)
                self._strip_save(skey, synced, local, origin)
                applied += 1
        return applied

    def finish_sync(self, remote_node: str, remote_clock: BVV,
                    remote_watermark: Watermark) -> None:
        """Last batch of an exchange: absorb the remote node's own clock
        entry, update the watermark matrix, GC (sync_repair LastBatch
        branch + update_watermark_after_sync + sync_clocks)."""
        own_entry = {n: e for n, e in remote_clock.items() if n == remote_node}
        self.nodeclock = K.bvv_merge(self.nodeclock, K.bvv_base(own_entry))
        wm = K.wm_update_peer(self.watermark, self.id, self.nodeclock)
        wm = K.wm_update_peer(wm, remote_node, remote_clock)
        self.watermark = K.wm_left_join(wm, remote_watermark)
        self.gc()

    def set_peers(self, peers: List[str]) -> None:
        """Replica membership change (set_peers at vmq_swc_store.erl):
        seed clock entries for new peers, drop logs of leavers, reshape
        the watermark."""
        me_and_peers = sorted(set(peers) | {self.id})
        old = set(self.nodeclock.keys())
        for nid in me_and_peers:
            self.nodeclock.setdefault(nid, (0, 0))
        for left in old - set(me_and_peers):
            self.dkm.prune_for_peer(left)
            self.owner._purge_peer_dots(self.group, left)
        self.watermark = K.wm_fix(self.watermark, me_and_peers)
        self.peers = [p for p in me_and_peers if p != self.id]

    def gc(self) -> None:
        """Watermark-driven pruning of the dot log; tombstones whose dots
        everyone has seen are removed for good (incremental_gc)."""
        members = sorted(set(self.peers) | {self.id})
        wm = K.wm_update_peer(self.watermark, self.id, self.nodeclock)
        self.watermark = wm
        deletable, pruned = self.dkm.prune(wm, members)
        self.owner._delete_dot_records(self.group, pruned)
        for skey in deletable:
            self.objects.pop(skey, None)
            self.owner._persist_obj(self.group, skey, None)

    # -------------------------------------------------------------- helpers

    def read(self, skey: Key) -> List[Any]:
        obj = self.objects.get(skey)
        return K.dcc_values(obj) if obj is not None else []

    def wire_state(self) -> dict:
        return {"clock": {n: list(e) for n, e in self.nodeclock.items()},
                "watermark": {a: dict(r) for a, r in self.watermark.items()}}


def _wire_clock(w) -> BVV:
    return {n: (e[0], e[1]) for n, e in w.items()}


class SWCMetadata:
    """Metadata facade over hash-partitioned SWC groups; API-compatible
    with the LWW ``MetadataStore`` so either backend plugs into the broker
    (vmq_metadata facade, vmq_metadata.erl:24-28)."""

    DEFAULT_GROUPS = 8  # the reference runs 10 (meta1..meta10, vmq_swc_plugin.erl:36-44)

    def __init__(self, node_name: str, persist_dir: Optional[str] = None,
                 n_groups: int = DEFAULT_GROUPS,
                 sync_interval: float = 2.0,
                 db_backend: str = "kvstore"):
        self.node_name = node_name
        self.n_groups = n_groups
        self.sync_interval = sync_interval
        self.groups = [SWCGroupStore(self, g) for g in range(n_groups)]
        self._subscribers: Dict[str, List[Callable[[Any, Any, Any, str], None]]] = {}
        self.cluster: Optional[Any] = None
        self._ae_task: Optional[asyncio.Task] = None
        self._exchange_tasks: set = set()
        self._exchange_lock: Optional[asyncio.Lock] = None
        self.exchanges_done = 0
        # storage behind the vmq_swc_db seam (cluster/swc_db.py):
        # backend selected by the swc_db_backend knob, None = memory-only
        self._kv = None
        if persist_dir is not None:
            self._open_kv(persist_dir, db_backend)

    # -------------------------------------------------------- wiring points

    def attach_cluster(self, cluster: Any) -> None:
        """Called by the Cluster so exchanges ride the framed data plane."""
        self.cluster = cluster

    def set_peers(self, members: List[str]) -> None:
        peers = [m for m in members if m != self.node_name]
        for g in self.groups:
            g.set_peers(peers)

    def start_ae(self) -> None:
        if self._ae_task is None:
            self._exchange_lock = asyncio.Lock()
            self._ae_task = asyncio.get_event_loop().create_task(self._ae_loop())

    def stop_ae(self) -> None:
        if self._ae_task is not None:
            self._ae_task.cancel()
            self._ae_task = None

    def schedule_exchange(self, peer: str) -> None:
        """Peer channel (re)connected → sync soon (replaces the LWW
        full-state push on connect)."""
        try:
            loop = asyncio.get_event_loop()
        except RuntimeError:
            return
        # hold a strong reference: the loop keeps only weak refs to tasks,
        # and a GC'd exchange would neither finish nor report its failure
        task = loop.create_task(self.exchange_with(peer))
        self._exchange_tasks.add(task)

        def _done(t: "asyncio.Task") -> None:
            self._exchange_tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                log.error("scheduled exchange with %s failed", peer,
                          exc_info=t.exception())
            elif not t.cancelled():
                # the exchange on a new channel is a join's bulk load: the
                # broker's full-collection policy runs after it
                joined(peer, t.result())

        task.add_done_callback(_done)

    # ------------------------------------------------------------------ API

    def _group_for(self, prefix: str, key: Any) -> SWCGroupStore:
        import zlib

        h = zlib.crc32(codec.encode([prefix, codec.enkey(key)]))
        return self.groups[h % self.n_groups]

    def put(self, prefix: str, key: Any, value: Any) -> None:
        """LWW-timestamped write (vmq_swc_plugin.erl:97-100 wraps values in
        a timestamp for deterministic sibling resolution)."""
        stamped = [time.time(), value] if value is not None else DELETED
        skey = (prefix, key)
        group = self._group_for(prefix, key)
        _, obj = group.write(skey, stamped)
        self._broadcast(group.group, [(skey, obj)])

    def delete(self, prefix: str, key: Any) -> None:
        self.put(prefix, key, None)

    def get(self, prefix: str, key: Any, default: Any = None) -> Any:
        vals = self._group_for(prefix, key).read((prefix, key))
        resolved = _resolve(vals)
        return default if resolved is None else resolved

    def fold(self, prefix: str) -> Iterable[Tuple[Any, Any]]:
        for g in self.groups:
            for (p, k), obj in list(g.objects.items()):
                if p != prefix:
                    continue
                v = _resolve(K.dcc_values(obj))
                if v is not None:
                    yield k, v

    def subscribe(self, prefix: str,
                  fn: Callable[[Any, Any, Any, str], None]) -> None:
        self._subscribers.setdefault(prefix, []).append(fn)

    def unsubscribe(self, prefix: str,
                    fn: Callable[[Any, Any, Any, str], None]) -> None:
        fns = self._subscribers.get(prefix)
        if fns and fn in fns:
            fns.remove(fn)

    def stats(self) -> Dict[str, int]:
        return {
            "metadata_entries": sum(len(g.objects) for g in self.groups),
            "swc_object_count": sum(g.dkm.object_count() for g in self.groups),
            "swc_tombstone_count": sum(g.dkm.tombstone_count() for g in self.groups),
            "swc_exchanges": self.exchanges_done,
        }

    def close(self) -> None:
        self.stop_ae()
        if self._kv is not None:
            self._kv.close()
            self._kv = None

    # --------------------------------------------------------------- events

    def _fire(self, skey: Key, old_values: List[Any], new_values: List[Any],
              origin: str) -> None:
        prefix, key = skey
        fns = self._subscribers.get(prefix)
        if not fns:
            return
        old = _resolve(old_values)
        new = _resolve(new_values)
        if old is None and new is None:
            return
        for fn in fns:
            try:
                fn(key, old, new, origin)
            except Exception:
                log.exception("metadata event handler failed for %s", skey)

    # ----------------------------------------------------------- replication

    def _broadcast(self, group: int, objs: List[Tuple[Key, DCC]]) -> None:
        """Eager object push to every peer (rpc_broadcast path — keeps
        convergence latency low; AE covers losses)."""
        if self.cluster is None:
            return
        wire = [([sk[0], codec.enkey(sk[1])], K.dcc_to_wire(obj))
                for sk, obj in objs]
        self.cluster.swc_send_all(("bcast", group, wire))

    def handle_swc_cast(self, origin: str, term: Any) -> None:
        """Fire-and-forget SWC frame from a peer (object broadcast)."""
        kind = term[0]
        if kind != "bcast":
            log.warning("unknown swc cast %r from %s", kind, origin)
            return
        _, gidx, wire = term
        group = self.groups[gidx]
        if origin not in group.peers:
            return  # not (yet) a replica peer — drop like the reference
        for skey_w, obj_w in wire:
            skey = (skey_w[0], codec.dekey(skey_w[1]))
            group.merge_object(skey, K.dcc_from_wire(obj_w), origin)

    def handle_swc_call(self, origin: str, term: Any) -> Any:
        """Request half of the exchange protocol (the rpc endpoints
        rpc_node_clock / rpc_watermark / rpc_sync_missing)."""
        kind, gidx = term[0], term[1]
        group = self.groups[gidx]
        if kind == "clock+wm":
            return group.wire_state()
        if kind == "missing":
            dots = [(d[0], d[1]) for d in term[2]]
            return [([sk[0], codec.enkey(sk[1])], K.dcc_to_wire(obj))
                    for sk, obj in group.sync_missing(dots)]
        raise ValueError(f"unknown swc call {kind!r}")

    # ----------------------------------------------------------- AE exchange

    async def _ae_loop(self) -> None:
        """Periodic anti-entropy against a random up peer (the sync timer
        at vmq_swc_store.erl init/handle_info(sync))."""
        while True:
            await asyncio.sleep(self.sync_interval * (0.75 + random.random() / 2))
            try:
                peers = [n for n, up in (self.cluster.status() if self.cluster else [])
                         if up and n != self.node_name]
                if peers:
                    await self.exchange_with(random.choice(peers))
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("anti-entropy round failed")

    async def exchange_with(self, peer: str, batch_size: int = 100,
                            timeout: float = 10.0) -> int:
        """One full AE exchange with ``peer`` across all groups
        (vmq_swc_exchange_fsm.erl prepare → update_local →
        local_sync_repair)."""
        if self.cluster is None:
            return 0
        if self._exchange_lock is None:
            self._exchange_lock = asyncio.Lock()
        if self._exchange_lock.locked():
            return 0  # already_locked — one exchange at a time
        applied_total = 0
        async with self._exchange_lock:
            for group in self.groups:
                if peer not in group.peers:
                    continue
                try:
                    state = await self.cluster.swc_call(
                        peer, ("clock+wm", group.group), timeout)
                    remote_clock = _wire_clock(state["clock"])
                    remote_wm = {a: dict(r) for a, r in state["watermark"].items()}
                    missing = K.bvv_missing_dots(remote_clock, group.nodeclock)
                    for i in range(0, len(missing), batch_size):
                        batch = [list(d) for d in missing[i:i + batch_size]]
                        objs_w = await self.cluster.swc_call(
                            peer, ("missing", group.group, batch), timeout)
                        objs = [((sw[0], codec.dekey(sw[1])), K.dcc_from_wire(ow))
                                for sw, ow in objs_w]
                        applied_total += group.sync_repair(
                            objs, remote_clock, peer)
                    group.finish_sync(peer, remote_clock, remote_wm)
                except (asyncio.TimeoutError, ConnectionError) as e:
                    log.debug("AE with %s group %d aborted: %s",
                              peer, group.group, e)
                    break
            self.exchanges_done += 1
        return applied_total

    # ----------------------------------------------------------- persistence

    def _open_kv(self, persist_dir: str, db_backend: str = "kvstore") -> None:
        from ..native.kvstore import KVError
        from .swc_db import open_backend

        self._kv = open_backend(db_backend, persist_dir)
        if self._kv is None:
            return
        try:
            self._load_persisted()
        except (KVError, OSError) as e:
            # corrupt on-disk state must degrade to memory-only (the
            # pre-seam posture), not fail broker boot
            log.warning("swc metadata persistence unavailable: %s", e)
            try:
                self._kv.close()
            except Exception:
                pass
            self._kv = None

    def _load_persisted(self) -> None:
        for kb, vb in self._kv.scan(b""):
            tag, gidx = kb[:1], kb[1]
            group = self.groups[gidx]
            if tag == b"o":
                skey_w = codec.decode(kb[2:])
                skey = (skey_w[0], codec.dekey(skey_w[1]))
                obj = K.dcc_from_wire(codec.decode(vb))
                group.objects[skey] = obj
                if not K.dcc_values(obj):
                    group.dkm.mark_for_gc(skey)
            elif tag == b"d":
                # legacy whole-log blob (pre per-dot records): import and
                # rewrite as b"e" records, then drop the blob
                for nid, row in codec.decode(vb).items():
                    for counter, skey_w in row.items():
                        skey = (skey_w[0], codec.dekey(skey_w[1]))
                        group.dkm.insert(nid, counter, skey)
                        self._persist_dot(gidx, (nid, counter), skey)
                self._kv.delete(kb)
            elif tag == b"e":
                # dot-key-map log entry (one per dot): tombstone dots live
                # only here, so the log must be durable or reloaded
                # tombstones never GC
                nid, counter = codec.decode(kb[2:])
                skey_w = codec.decode(vb)
                group.dkm.insert(nid, counter,
                                 (skey_w[0], codec.dekey(skey_w[1])))
            elif tag == b"c":
                group.nodeclock = _wire_clock(codec.decode(vb))
            elif tag == b"w":
                group.watermark = {a: dict(r)
                                   for a, r in codec.decode(vb).items()}

    def _persist_obj(self, gidx: int, skey: Key, obj: Optional[DCC]) -> None:
        if self._kv is None:
            return
        kb = b"o" + bytes([gidx]) + codec.encode([skey[0], codec.enkey(skey[1])])
        if obj is None or not obj[0]:
            tomb = self.groups[gidx].objects.get(skey)
            if tomb is not None:  # persist the tombstone's causal context
                self._kv.put(kb, codec.encode(K.dcc_to_wire(tomb)))
            else:
                self._kv.delete(kb)
        else:
            self._kv.put(kb, codec.encode(K.dcc_to_wire(obj)))
        g = self.groups[gidx]
        self._kv.put(b"c" + bytes([gidx]),
                     codec.encode({n: list(e) for n, e in g.nodeclock.items()}))
        self._kv.put(b"w" + bytes([gidx]),
                     codec.encode({a: dict(r) for a, r in g.watermark.items()}))

    def _persist_dot(self, gidx: int, dot: Dot, skey: Key) -> None:
        """One durable record per log dot — per-write cost stays O(1)
        instead of re-encoding the whole group log each operation."""
        if self._kv is None:
            return
        self._kv.put(b"e" + bytes([gidx]) + codec.encode([dot[0], dot[1]]),
                     codec.encode([skey[0], codec.enkey(skey[1])]))

    def _delete_dot_records(self, gidx: int, dots: List[Dot]) -> None:
        if self._kv is None or not dots:
            return
        for nid, c in dots:
            self._kv.delete(b"e" + bytes([gidx]) + codec.encode([nid, c]))

    def _purge_peer_dots(self, gidx: int, nid: str) -> None:
        """A peer left the group: drop its durable log records (rare)."""
        if self._kv is None:
            return
        prefix = b"e" + bytes([gidx])
        for kb in list(self._kv.scan_keys(prefix)):
            if codec.decode(kb[2:])[0] == nid:
                self._kv.delete(kb)


def _resolve(values: List[Any]) -> Any:
    """LWW sibling resolution over [ts, value] pairs
    (vmq_swc_plugin.erl:143-147). A delete concurrent with a put loses
    (add-wins) — the reference behaves the same: deletes reach the store
    as unstamped ``'$deleted'`` dots whose siblings survive strip."""
    best = None
    for v in values:
        if v == DELETED:
            continue
        if best is None or v[0] > best[0]:
            best = v
    return best[1] if best is not None else None
