"""Cluster facade: membership, channel status, is_ready gate, remote ops.

Mirrors ``vmq_cluster.erl`` + ``vmq_cluster_mon.erl`` + the peer-service
facade: a status table fed by channel up/down transitions, the
``is_ready``/``if_ready`` consistency gate (``vmq_cluster.erl:67-92``),
netsplit detect/resolve counters (``:183-203``), and the remote-op API —
``publish(node, msg)`` fire-and-forget over the data plane and
``remote_enqueue(node, sid, msgs)`` with ack + timeout
(``vmq_cluster.erl:94-113``).

Membership lives in the replicated metadata store under the ``members``
prefix (the reference keeps it in an ORSWOT CRDT via plumtree; LWW
entries per node give the same single-writer-per-key semantics since each
node writes only its own record — except ``leave`` which any node may
write, mirroring `vmq-admin cluster leave`).
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import logging
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ..observability import events
from ..observability import histogram as _hist
from .com import ClusterCom
from .metadata import MetadataStore
from .node import NodeWriter, frame, msg_to_term

log = logging.getLogger("vernemq_tpu_torch.cluster")

MEMBERS = "members"


class _SpoolIn:
    """Per-origin receive state for spooled (``msq``) frames.

    ``cum`` is the cumulative-ack cursor: it advances only along
    CONTIGUOUS sequences, anchored by the sender's ``msb`` stream-base
    declaration (everything below the base is already acked sender-side).
    Acking across a gap would make the sender trim frames the receiver
    never saw — the one unrecoverable mistake. The cursor resets on
    every inbound (re)connection: it must only cover what arrived over a
    live stream, never a stale pre-partition watermark.

    Frames at-or-below ``cum`` are duplicates by definition (only seen
    frames advance it, and the base only covers sender-acked history);
    frames ABOVE a gap dedup through the bounded ``(seq, msg_ref)``
    window, which persists across connections and is keyed on the ref so
    a sender whose sequence space restarted (fresh in-memory spool) is
    never mistaken for a replay. The window bounds exactly-once for
    above-gap QoS 2 frames to DEDUP_WINDOW frames per retransmit
    interval — beyond it redelivery degrades to at-least-once."""

    DEDUP_WINDOW = 8192

    __slots__ = ("seen", "order", "cum", "acked_sent", "last_ack_t",
                 "timer", "reack")

    def __init__(self) -> None:
        self.seen: Set[Tuple[int, bytes]] = set()
        self.order: collections.deque = collections.deque()
        self.cum = 0
        self.acked_sent = 0
        self.last_ack_t = 0.0
        self.timer: Optional[asyncio.TimerHandle] = None
        # a duplicate was seen: the origin is replaying because an ack
        # was lost — re-ack even though cum did not advance
        self.reack = False


class Cluster:
    def __init__(self, broker, listen_host: str = "127.0.0.1",
                 listen_port: int = 0):
        self.broker = broker
        self.metrics = broker.metrics
        self.node_name = broker.node_name
        self.metadata: MetadataStore = broker.metadata
        self.listen_host = listen_host
        self.listen_port = listen_port
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: Dict[str, NodeWriter] = {}
        self._bootstrap: List[NodeWriter] = []
        self._status: Dict[str, str] = {}  # node -> up|down (vmq_status ETS)
        self._inbound: Dict[str, int] = {}
        self._pending_acks: Dict[int, asyncio.Future] = {}
        self._ack_ids = itertools.count(1)
        self.netsplit_detected = 0
        self.netsplit_resolved = 0
        self._pending_swc: Dict[int, asyncio.Future] = {}
        # store-and-forward spool for QoS>=1 data-plane frames
        # (cluster/spool.py); peers advertise support via the hlo "caps"
        # field so old peers keep the fire-and-forget framing
        self.spool: Optional[Any] = None
        if broker.config.get("cluster_spool_enabled", True):
            from .spool import ClusterSpool

            self.spool = ClusterSpool(
                broker.config.get("cluster_spool_dir", ""),
                max_bytes=broker.config.get("cluster_spool_max_bytes",
                                            128 * 1024 * 1024),
                metrics=self.metrics)
        self._peer_caps: Dict[str, Set[str]] = {}
        self._spool_in: Dict[str, _SpoolIn] = {}
        self._spool_task: Optional[asyncio.Task] = None
        from .reg_sync import RegSync

        self.reg_sync = RegSync(self)
        # membership health plane: accrual failure detector + automatic
        # rebalance planner (cluster/health.py). Gossip side-tables fed
        # by hlo/png terms: the peer's advertised client address (what
        # a v5 server-redirect DISCONNECT carries) and load score.
        self._peer_caddr: Dict[str, str] = {}
        self._advertised = str(
            broker.config.get("cluster_advertised_address", "") or "")
        self.health: Optional[Any] = None
        self.planner: Optional[Any] = None
        if broker.config.get("health_enabled", True):
            from .health import HealthMonitor, RebalancePlanner

            self.health = HealthMonitor(self)
            self.planner = RebalancePlanner(self, self.health)
            self.health.planner = self.planner
        self._com = ClusterCom(self)
        # the joined peers the is_ready gate reads, kept while member
        # records' change events reach this object
        self._ready_peers: Optional[List[str]] = None
        self._watching = True
        self.metadata.subscribe(MEMBERS, self._members_changed)
        self.metadata.subscribe(MEMBERS, self._on_member_change)
        if hasattr(self.metadata, "attach_cluster"):  # SWC backend
            self.metadata.attach_cluster(self)
            self.plumtree = None
        else:  # LWW backend: plumtree broadcast tree + digest AE
            from .plumtree import Plumtree

            self.plumtree = Plumtree(
                self.node_name, self._pt_send,
                outstanding_limit=broker.config.get(
                    "plumtree_outstanding_limit", 10_000),
                drop_ihave_threshold=broker.config.get(
                    "plumtree_drop_ihave_threshold", 0))
            self.metadata.broadcast = self._broadcast_meta
        broker.cluster = self
        broker.registry.remote_publish = self.publish
        broker.registry.remote_enqueue_nowait = self.enqueue_nowait

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._com.handle_conn, self.listen_host, self.listen_port)
        self.listen_port = self._server.sockets[0].getsockname()[1]
        # register ourselves in the membership table
        self.metadata.put(MEMBERS, self.node_name, {
            "addr": [self.listen_host, self.listen_port],
            "state": "joined",
            "joined_at": time.time(),
        })
        # writers are normally created by member-change events; members
        # ALREADY in the table (listener restart, warm boot from persisted
        # metadata) fire none — replay them or the restarted channel has
        # no outbound writers and peers' acked ops at us time out
        for node, rec in self.metadata.fold(MEMBERS):
            if node != self.node_name and rec:
                self._on_member_change(node, None, rec, self.node_name)
        if hasattr(self.metadata, "start_ae"):
            self._sync_metadata_peers()
            self.metadata.start_ae()
        if self.spool is not None:
            self._spool_task = asyncio.get_event_loop().create_task(
                self._spool_retransmit_loop())
        if self.health is not None:
            self.health.start()
        if self.planner is not None:
            self.planner.start()

    async def stop(self) -> None:
        if self.planner is not None:
            self.planner.stop()
        if self.health is not None:
            self.health.stop()
        if hasattr(self.metadata, "stop_ae"):
            self.metadata.stop_ae()
        if self._spool_task is not None:
            self._spool_task.cancel()
            self._spool_task = None
        for st in self._spool_in.values():
            if st.timer is not None:
                st.timer.cancel()
                st.timer = None
        for w in list(self._writers.values()) + self._bootstrap:
            w.stop()
        self._writers.clear()
        if self._server is not None:
            self._server.close()
        self._com.close_all()  # peers must see the channels drop
        self._bootstrap.clear()
        if self.spool is not None:
            # unacked frames stay journaled: a restarted cluster channel
            # (or a new process over the same spool dir) replays them
            self.spool.close()
        # Detach from the broker so the vmq listener can be RESTARTED:
        # start_listener refuses while broker.cluster is set, and the
        # registry must stop forwarding into dead writers. The metadata
        # store outlives us (broker.metadata), so drop EVERY hook wiring
        # it to this cluster — the member-change handler, the LWW
        # broadcast fn, the SWC transport ref — or a later restart would
        # feed two clusters (and local puts would flood dead writers).
        if hasattr(self.metadata, "unsubscribe"):
            self.metadata.unsubscribe(MEMBERS, self._members_changed)
            self.metadata.unsubscribe(MEMBERS, self._on_member_change)
        self._watching, self._ready_peers = False, None
        if getattr(self.metadata, "broadcast", None) == self._broadcast_meta:
            self.metadata.broadcast = None
        if getattr(self.metadata, "cluster", None) is self:
            self.metadata.cluster = None
        if self.broker.cluster is self:
            # a node that is STILL a joined member but has no channel must
            # not report ready (the is_ready gate this object was serving
            # falls back to broker._cluster_ready once we detach) — a bare
            # `listener stop` keeps the CAP gates engaged exactly as the
            # attached-but-down channel did; a genuinely standalone node
            # (no other joined members) stays ready
            self.broker._cluster_ready = not self.members(include_self=False)
            self.broker.cluster = None
            self.broker.registry.remote_publish = None
            self.broker.registry.remote_enqueue_nowait = None

    def join(self, seed_host: str, seed_port: int) -> None:
        """Join via a seed node (vmq_peer_service:join): a bootstrap
        channel pushes our metadata; the seed's member table flows back on
        its own connect, after which named writers replace the bootstrap."""
        w = NodeWriter(self, f"bootstrap:{seed_host}:{seed_port}",
                       (seed_host, seed_port),
                       self.broker.config.outgoing_clustering_buffer_size)
        self._bootstrap.append(w)
        w.start()

    def leave(self, node_name: str) -> None:
        """Membership removal (the bare state flip). For the full operator
        workflow — migrate offline queues, then leave — use
        :meth:`leave_gracefully` on the leaving node; for a node that died
        without leaving, :meth:`fix_dead_queues`."""
        rec = self.metadata.get(MEMBERS, node_name)
        if rec:
            rec = dict(rec)
            rec["state"] = "left"
            self.metadata.put(MEMBERS, node_name, rec)

    async def leave_gracefully(self, timeout: float = 60.0) -> int:
        """`vmq-admin cluster leave` on the leaving node
        (vmq_reg:migrate_offline_queues behind the leave command,
        vmq_reg.erl:433-477): rewrite every locally-homed persistent
        subscriber to a live peer, wait for the drains, then flip
        membership. Raises (and does NOT leave) if any drain failed or is
        still pending at the timeout — the reference blocks on
        block_until_migrated before leaving. Returns queues migrated."""
        moved = await self.migrate_offline_queues(timeout=timeout)
        stuck = {sid: m for sid, m in self.broker.migrations.items()
                 if m["state"] in ("draining", "failed")}
        if stuck:
            detail = ", ".join(
                f"{s[0]}/{s[1]}:{m['state']}" for s, m in stuck.items())
            raise RuntimeError(
                f"leave aborted: {len(stuck)} queue migration(s) incomplete "
                f"({detail})")
        self.leave(self.node_name)
        return moved

    async def migrate_offline_queues(self, targets: Optional[List[str]] = None,
                                     timeout: float = 60.0) -> int:
        """Rewrite each local offline persistent queue's subscriber record
        to a target node (round-robin) and wait for the resulting drains.

        The record rewrite replicates; the target creates the offline
        queue (reg_mgr event path) and this node's migration task drains
        the backlog over acked ``enq`` batches (broker._migrate_queue).
        """
        reg = self.broker.registry
        if targets is None:
            targets = [n for n in self.members(include_self=False)
                       if self._status.get(n) == "up"]
        if not targets:
            raise RuntimeError("no live migration targets")
        rr = itertools.cycle(targets)
        moved = 0
        for sid, queue in list(reg.queues.items()):
            if sid in self.broker.sessions:
                continue  # live session: not an offline queue
            rec = reg.db.read(sid)
            if rec is None or rec.node != self.node_name or rec.clean_session:
                continue
            rec.node = next(rr)
            reg.db.store(sid, rec)  # event triggers the drain task
            moved += 1
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            # a migration whose target died mid-drain is retried against
            # the surviving targets (each peer tried at most once per
            # queue) instead of wedging the leave or stranding the queue;
            # progress stays visible via `vmq-admin cluster migrations`
            retargeted = self._retarget_failed_migrations(targets)
            live = [m for m in self.broker.migrations.values()
                    if m["state"] == "draining"]
            if not live and not retargeted:
                break
            await asyncio.sleep(0.05)
        return moved

    def _retarget_failed_migrations(self, targets: List[str]) -> bool:
        reg = self.broker.registry
        retargeted = False
        for sid, m in list(self.broker.migrations.items()):
            if m.get("state") != "failed":
                continue
            tried = m.setdefault("tried", [m["target"]])
            alive = [t for t in targets
                     if self._status.get(t) == "up" and t not in tried]
            if not alive:
                continue  # nothing left to try; leave reports it stuck
            rec = reg.db.read(sid)
            if rec is None:
                self.broker.migrations.pop(sid, None)
                continue
            if self.health is not None:
                # least-loaded surviving peer, not "next untried": the
                # first-listed target would otherwise absorb every
                # retargeted queue of a mid-drain node death
                new_target = min(
                    alive, key=lambda t: (self.health.load_of(t), t))
            else:
                new_target = alive[0]
            tried.append(new_target)
            rec.node = new_target
            reg.db.store(sid, rec)
            # the record already pointed away from this node, so the
            # change event won't re-fire the drain — start it directly
            self.broker.on_subscriber_moved(sid, new_target)
            log.warning("migration of %s retargeted %s -> %s after drain "
                        "failure", sid, m["target"], new_target)
            retargeted = True
        return retargeted

    def fix_dead_queues(self, targets: Optional[List[str]] = None) -> int:
        """`vmq-admin cluster fix-dead-queues` (vmq_reg:fix_dead_queues,
        vmq_reg.erl:479-520): repair routing after a node died without
        leaving. Every subscriber record pointing at a node that is neither
        a live member nor this node is rewritten to a live target
        (round-robin; persistent sessions keep their subscriptions and get
        fresh offline queues there) or dropped (clean sessions died with
        their node). Messages already stored on the dead node stay there —
        same data-loss contract as the reference. Returns records fixed."""
        reg = self.broker.registry
        alive = {self.node_name}
        for n in self.members(include_self=False):
            if self._status.get(n) == "up":
                alive.add(n)
        if targets is None:
            targets = sorted(alive)
        else:
            bad = [t for t in targets if t not in alive]
            if bad:
                raise RuntimeError(f"targets not alive: {bad}")
        rr = itertools.cycle(targets)
        fixed = 0
        for sid, rec in list(reg.db.fold()):
            if rec is None or rec.node in alive:
                continue
            if rec.clean_session:
                reg.db.delete(sid)
            else:
                rec.node = next(rr)
                reg.db.store(sid, rec)
                # a record assigned to THIS node is a local-origin write, so
                # the event path won't build the queue — do it directly
                reg.ensure_offline_queue(sid, rec)
            fixed += 1
        return fixed

    # ----------------------------------------------------------- membership

    def members(self, include_self: bool = True) -> List[str]:
        out = []
        for node, rec in self.metadata.fold(MEMBERS):
            if rec.get("state") == "joined" and (include_self or node != self.node_name):
                out.append(node)
        return sorted(out)

    def _members_changed(self, node, old, new, origin) -> None:
        self._ready_peers = None

    def member_info(self) -> Dict[str, Any]:
        """hlo payload: identity, capabilities (spool negotiation — old
        peers ignore unknown fields, we treat a missing "caps" as none),
        and the writer drop totals, split frames/bytes."""
        writers = list(self._writers.values()) + self._bootstrap
        caps = ["spool"] if self.spool is not None else []
        if getattr(self.broker, "filter_engine", None) is not None:
            # payload-predicate evaluation (vernemq_tpu/filters/): the
            # subscription's filter suffix replicates verbatim either
            # way (subscriber_db "flt" field); the cap only advertises
            # which peers EVALUATE it, for `cluster show` diagnosis of
            # mixed-version deployments
            caps.append("flt")
        if _hist.enabled():
            # cross-node trace propagation (observability/recorder.py):
            # this node RESUMES a sampled publish's trace context from
            # the envelope's optional trace field. Peers without the
            # cap (old versions, observability off) get byte-identical
            # pre-trace framing — the field is never attached to them.
            caps.append("trace")
        info = {"node": self.node_name,
                "addr": [self.listen_host, self.listen_port],
                "caps": caps,
                "frames_dropped": sum(w.dropped_frames for w in writers),
                "bytes_dropped": sum(w.dropped_bytes for w in writers)}
        if self.health is not None:
            # seed the peer's load table before the first idle ping, and
            # advertise the CLIENT-facing address a v5 server-redirect
            # DISCONNECT should hand out for sessions moved to us
            from .health import local_load_score

            info["load"] = local_load_score(self.broker)
            if self._advertised:
                info["caddr"] = self._advertised
        return info

    def on_hello(self, origin: str, info: Dict[str, Any]) -> None:
        """First contact from a node we may not know yet (bootstrap join):
        record it so the full-mesh forms (the ORSWOT merge equivalent).
        Every hello also refreshes the peer's capability set; learning a
        peer spools unblocks any journaled backlog for it."""
        node, addr = info.get("node"), info.get("addr")
        if node and node != self.node_name and \
                self.metadata.get(MEMBERS, node) is None:
            self.metadata.put(MEMBERS, node, {
                "addr": addr, "state": "joined", "joined_at": time.time()})
        if node:
            caps = set(info.get("caps") or ())
            newly_spools = ("spool" in caps
                            and "spool" not in self._peer_caps.get(node, ()))
            self._peer_caps[node] = caps
            if info.get("caddr"):
                self._peer_caddr[node] = str(info["caddr"])
            if self.health is not None:
                self.health.heartbeat(node, load=info.get("load"))
            if newly_spools:
                # bootstrap case: our channel came up before we knew the
                # peer spools, so the channel-up replay was skipped. On a
                # routine reconnect the capability is already known and
                # the channel-up hook replays — don't send it all twice.
                self._maybe_replay_spool(node)

    def ping_term(self) -> Optional[Dict[str, Any]]:
        """Term for the idle ``png`` frame: this node's gossiped load
        score (+ advertised client address for v5 redirects). ``None``
        when the health plane is off — byte-compatible with the
        pre-health ping, and old receivers ignore the term anyway."""
        if self.health is None:
            return None
        from .health import local_load_score

        term: Dict[str, Any] = {"load": local_load_score(self.broker)}
        if self._advertised:
            term["caddr"] = self._advertised
        return term

    def on_ping(self, origin: str, term: Any) -> None:
        """Inbound idle ping (com.py ``png``): refresh the peer's
        gossiped load/address. Liveness itself was already credited by
        on_peer_traffic for the enclosing batch."""
        if not isinstance(term, dict):
            return  # pre-health peer: bare ping
        if term.get("caddr"):
            self._peer_caddr[origin] = str(term["caddr"])
        if self.health is not None and "load" in term:
            self.health.heartbeat(origin, load=term.get("load"))

    def on_peer_traffic(self, origin: str) -> None:
        """Every delivered inbound batch from ``origin`` is a heartbeat
        for the accrual failure detector."""
        if self.health is not None:
            self.health.heartbeat(origin)

    def server_reference(self, node: str) -> str:
        """What a v5 DISCONNECT 0x9C/0x9D Server Reference should carry
        for a session moved to ``node``: the peer's advertised client
        address when gossiped, else the node name (the operator's
        naming scheme is often resolvable as-is)."""
        return self._peer_caddr.get(node) or node

    def _sync_metadata_peers(self) -> None:
        """Keep the SWC replica groups' peer set in lock-step with cluster
        membership (set_group_members → vmq_swc_store:set_peers)."""
        if hasattr(self.metadata, "set_peers"):
            self.metadata.set_peers(self.members())

    def _on_member_change(self, node: str, old: Any, new: Any,
                          origin: str) -> None:
        self._sync_metadata_peers()
        if node == self.node_name:
            return
        if new is not None and new.get("state") == "joined":
            w = self._writers.get(node)
            addr = (new["addr"][0], new["addr"][1])
            if w is None or w.addr != addr:
                if w is not None:
                    w.stop()
                w = NodeWriter(self, node, addr,
                               self.broker.config.outgoing_clustering_buffer_size)
                self._writers[node] = w
                self._status.setdefault(node, "init")
                try:
                    w.start()
                except RuntimeError:
                    pass  # no loop yet (tests constructing synchronously)
            # a joined member supersedes any bootstrap channel to that addr
            for b in self._bootstrap[:]:
                if b.addr == addr:
                    b.stop()
                    self._bootstrap.remove(b)
            if old is None and self.planner is not None:
                # a NEW member (not an addr refresh) reshapes the
                # cluster: let the planner spread load onto it
                self.planner.note(node, "join")
        else:  # left or tombstoned
            w = self._writers.pop(node, None)
            if w is not None:
                w.stop()
            self._status.pop(node, None)
            if self.plumtree is not None:
                self.plumtree.peer_down(node)
            # an ex-member's spooled backlog is undeliverable: discard it
            # (queue migration owns the member-leave delivery story)
            if self.spool is not None:
                self.spool.flush(node)
            self._peer_caps.pop(node, None)
            st = self._spool_in.pop(node, None)
            if st is not None and st.timer is not None:
                st.timer.cancel()
            self._peer_caddr.pop(node, None)
            self.broker.registry.node_left(node)
            if old is not None and self.planner is not None:
                self.planner.note(node, "leave")

    # -------------------------------------------------------- channel status

    def on_channel_status(self, node: str, status: str) -> None:
        """Writer up/down transitions feed the status table
        (vmq_cluster_node.erl:202-212 → vmq_status)."""
        if node.startswith("bootstrap:"):
            return
        old = self._status.get(node)
        self._status[node] = status
        if self.health is not None:
            # a torn outbound channel sharpens the detector (immediate
            # suspect); the phi clock owns the down verdict
            self.health.on_channel(node, status)
        if self.plumtree is not None:
            if status == "up":
                self.plumtree.peer_up(node)
            elif status == "down":
                self.plumtree.peer_down(node)
        if old == "up" and status == "down":
            self.netsplit_detected += 1
            self.metrics.incr("netsplit_detected")
            # a dead peer's reg_sync locks release, its queued requests drop
            self.reg_sync.on_node_down(node)
        elif old == "down" and status == "up":
            self.netsplit_resolved += 1
            self.metrics.incr("netsplit_resolved")
        if status == "up":
            # partition healed / first contact: replay the journaled
            # backlog AFTER the hlo/anti-entropy frames already queued by
            # on_peer_connected (buffer order is send order)
            self._maybe_replay_spool(node)

    def inbound_up(self, origin: str) -> None:
        self._inbound[origin] = self._inbound.get(origin, 0) + 1
        st = self._spool_in.get(origin)
        if st is not None:
            # the sender's stream restarted: the cumulative ack may only
            # cover frames seen on THIS connection (a restarted sender's
            # sequence space can regress; the dedup window persists)
            st.cum = 0
            st.acked_sent = 0

    def inbound_down(self, origin: str) -> None:
        n = self._inbound.get(origin, 0) - 1
        if n <= 0:
            self._inbound.pop(origin, None)
        else:
            self._inbound[origin] = n

    def is_ready(self) -> bool:
        """Consistency gate (vmq_cluster:is_ready/0): every joined member's
        data channel is up. The gate is asked on every publish and a fold
        of the membership walks every record of the store (each
        subscriber's too), so the joined peers are kept until a member
        record changes."""
        peers = self._ready_peers
        if peers is None:
            peers = self.members(include_self=False)
            if self._watching:
                self._ready_peers = peers
        for node in peers:
            if self._status.get(node) != "up":
                return False
        return True

    def status(self) -> List[Tuple[str, bool]]:
        """vmq-admin cluster show."""
        out = [(self.node_name, True)]
        for node in self.members(include_self=False):
            out.append((node, self._status.get(node) == "up"))
        return out

    def netsplit_statistics(self) -> Tuple[int, int]:
        return self.netsplit_detected, self.netsplit_resolved

    # ------------------------------------------------------------ remote ops

    def writer(self, node: str) -> Optional[NodeWriter]:
        return self._writers.get(node)

    def publish(self, node: str, msg, trace=None) -> bool:
        """Data-plane publish forward (vmq_cluster:publish/2). The QoS
        split: QoS 0 keeps the reference's fire-and-forget ``msg`` frame
        (sheddable under buffer pressure); QoS ≥ 1 to a spool-capable
        peer is journaled first and shipped as a seq-tagged ``msq`` frame
        — True then means durably accepted, not necessarily sent.

        ``trace`` (a sampled publish's flight-recorder context) rides
        the msg term's optional ``trc`` field to a trace-capable peer —
        negotiated via the hlo caps, so a peer without the cap (old
        version, observability off) receives byte-identical pre-trace
        framing on BOTH the legacy and the spooled path. A spooled
        traced frame journals its context too: a replay re-delivers it
        and the receiver's dedup gate decides exactly once."""
        w = self._writers.get(node)
        if w is None:
            self.metrics.incr("cluster_publish_no_channel")
            return False
        term = msg_to_term(msg)
        if trace is not None and self._peer_traces(node):
            term["trc"] = trace.export_wire(self.node_name)
            if not trace.marks or trace.marks[-1][0] != "forward":
                # one forward mark per PUBLISH, not per remote node: a
                # multi-node fanout calls this per node, and duplicate
                # labels would overwrite each other in the finished
                # record's stage dict (last hop wins, first hop lost)
                trace.stamp("forward")
        if msg.qos > 0 and self._peer_spools(node):
            return self._spool_send(node, w, "msg", term)
        return w.send_frame(frame(b"msg", term), sheddable=msg.qos == 0)

    def enqueue_nowait(self, node: str, sid, msgs: List[Any]) -> bool:
        """Fire-and-forget remote enqueue (shared-subscription delivery to a
        remote member); QoS ≥ 1 batches ride the spool like publishes."""
        w = self._writers.get(node)
        if w is None:
            return False
        term = (0, list(sid), [msg_to_term(m) for m in msgs], False)
        if any(m.qos > 0 for m in msgs) and self._peer_spools(node):
            return self._spool_send(node, w, "enq", term)
        return w.send_frame(frame(b"enq", term))

    # -------------------------------------------------------------- spool

    def _peer_spools(self, node: str) -> bool:
        return (self.spool is not None
                and "spool" in self._peer_caps.get(node, ()))

    def _peer_traces(self, node: str) -> bool:
        """May a trace context ride the envelope to ``node``? Both ends
        must opt in: the peer advertised the "trace" cap AND this
        node's observability is on (off must keep the wire byte-
        identical, per the config-3 zero-cost guarantee)."""
        return (_hist.enabled()
                and "trace" in self._peer_caps.get(node, ()))

    def _spool_send(self, node: str, w: NodeWriter, kind: str, term) -> bool:
        """Journal-then-send for one QoS ≥ 1 frame. A refused journal
        write (byte cap, injected/real IO failure) degrades to the
        legacy best-effort frame ONLY while the stream is in-order
        (channel up, nothing journaled-but-unsent that it would
        overtake) — otherwise it is a visible drop. A journaled frame is
        accepted even when the channel is down or the stream is paused;
        replay resyncs it."""
        st = self.spool.state(node)
        res = self.spool.journal(node, kind, term)
        if res is None:
            if w.status == "up" and not st.blocked:
                return w.send_frame(frame(kind.encode(), term))
            return False
        seq, data = res
        if st.blocked or w.status != "up":
            return True  # journaled; replay on channel-up / retransmit
        if len(st.pending) == 1:
            # this frame starts the in-flight stream: declare the ack
            # base so the receiver anchors its contiguity cursor here
            if not w.send_frame(frame(b"msb", seq)):
                st.blocked = True
                return True
        if not w.send_frame(data):
            st.blocked = True  # order-preserving pause until replay
        return True

    def _maybe_replay_spool(self, node: str) -> None:
        if not self._peer_spools(node):
            return
        w = self._writers.get(node)
        if w is None or w.status != "up":
            return  # channel-up replays when the writer connects
        self.spool.replay(node, w.send_frame)

    async def _spool_retransmit_loop(self) -> None:
        """Ack watchdog: frames unacked for a full interval are replayed
        over the LIVE channel — the recovery path for in-channel loss
        (injected ``cluster.recv`` drops, a receiver that lost the ack)
        where no reconnect ever fires the channel-up replay.

        Also the connection-level STALL detector: a peer with unacked
        spooled bytes whose cumulative ack has made no progress for
        ``cluster_stall_timeout_s`` is half-open — its TCP writes
        succeed (retransmits included), its acks never arrive, and no
        exception will ever fire. The channel is cycled (bounce →
        reconnect → channel-up spool replay), which either lands on a
        healthy connection or surfaces the peer as genuinely down; the
        spool makes the cycle loss-free either way. Each stalled-capable
        peer holds a monitored op in the broker's stall watchdog so the
        wait is visible in `vmq-admin watchdog show`."""
        interval = self.broker.config.get(
            "cluster_spool_retransmit_ms", 1000) / 1000.0
        burst = int(self.broker.config.get(
            "cluster_spool_replay_burst", 512))
        stall_s = float(self.broker.config.get(
            "cluster_stall_timeout_s", 10.0) or 0.0)
        wd = getattr(self.broker, "watchdog", None)
        ack_ops: dict = {}  # peer -> MonitoredOp while acks are owed
        try:
            await self._spool_retransmit_ticks(interval, burst, stall_s,
                                               wd, ack_ops)
        finally:
            if wd is not None:
                for op in ack_ops.values():
                    wd.deregister(op)

    async def _spool_retransmit_ticks(self, interval, burst, stall_s,
                                      wd, ack_ops) -> None:
        while True:
            await asyncio.sleep(interval)
            try:
                for node in self.spool.peers():
                    st = self.spool.state(node)
                    if not st.pending or not self._peer_spools(node):
                        op = ack_ops.pop(node, None)
                        if op is not None and wd is not None:
                            wd.deregister(op)
                        continue
                    w = self._writers.get(node)
                    now = time.monotonic()
                    if st.last_progress_at == 0.0:
                        # journal recovered from disk before any live
                        # traffic: start the progress clock now
                        st.last_progress_at = now
                    if wd is not None and stall_s > 0:
                        op = ack_ops.get(node)
                        if op is None:
                            ack_ops[node] = wd.register(
                                "cluster.ack", stall_s, label=node,
                                started_at=st.last_progress_at)
                        elif op.started_at != st.last_progress_at:
                            wd.touch(op, st.last_progress_at)
                    if (stall_s > 0 and w is not None
                            and w.status == "up"
                            and now - st.last_progress_at >= stall_s):
                        self.metrics.incr("cluster_stall_reconnects")
                        events.emit("cluster_ack_stall", detail=node,
                                    value=round(
                                        now - st.last_progress_at, 3))
                        if wd is not None:
                            wd.note_cluster_stall()
                            op = ack_ops.pop(node, None)
                            if op is not None:
                                wd.abandon(op)
                                wd.deregister(op)
                        log.warning(
                            "cluster channel to %s ack-stalled: %d "
                            "frame(s)/%d byte(s) spooled with no "
                            "cumulative-ack progress for %.1fs — "
                            "cycling the connection (spool replays on "
                            "reconnect)", node, len(st.pending),
                            st.bytes, now - st.last_progress_at)
                        st.last_progress_at = now  # full window for the
                        w.bounce()                 # fresh connection
                        continue
                    if (w is not None and w.status == "up"
                            and now - st.last_ack_at >= interval):
                        # budgeted: at most `burst` frames per tick from
                        # the per-peer cursor — linear wire cost through
                        # a long storm (cursor-based partial replay)
                        self.spool.replay(node, w.send_frame,
                                          budget=burst or None)
            except Exception:
                # a transient journal/IO error must not kill the
                # watchdog — it is the only replay trigger for
                # in-channel loss; the next tick retries
                log.exception("spool retransmit pass failed")

    def spool_base(self, origin: str, base: int) -> None:
        """``msb`` frame: the origin's lowest unacked seq is ``base`` —
        everything below is acked history, so the contiguity cursor may
        anchor there (and only there: anchoring on an arbitrary first
        frame would silently ack across an in-channel-dropped batch)."""
        st = self._spool_in.get(origin)
        if st is None:
            st = self._spool_in[origin] = _SpoolIn()
        if base - 1 > st.cum:
            st.cum = base - 1

    def spool_accept(self, origin: str, seq: int, ref: bytes) -> bool:
        """Receiver-side gate for one ``msq`` frame: True when it is
        fresh (dispatch it), False for a duplicate (at-or-below the
        cumulative cursor, or in the dedup window — a replay after a
        lost ack). Either way the cumulative ack advances/re-fires so
        the origin can trim."""
        st = self._spool_in.get(origin)
        if st is None:
            st = self._spool_in[origin] = _SpoolIn()
        key = (seq, ref)
        dup = seq <= st.cum or key in st.seen
        if seq == st.cum + 1:
            # contiguous: advance the cursor (also over an already-seen
            # above-gap frame a retransmit just filled in below)
            st.cum = seq
        if not dup:
            st.seen.add(key)
            st.order.append(key)
            while len(st.order) > st.DEDUP_WINDOW:
                st.seen.discard(st.order.popleft())
        else:
            self.metrics.incr("cluster_spool_deduped")
        self._schedule_spool_ack(origin, reack=dup)
        return not dup

    def _schedule_spool_ack(self, origin: str, reack: bool = False) -> None:
        """Cumulative-ack pacing: at most one ack per
        ``cluster_spool_ack_interval`` ms per origin, via a trailing
        timer so the last frames of a burst are never left unacked. A
        detected duplicate marks the origin for re-ack (it is replaying
        because an ack was lost) — still paced, so a replay burst of N
        duplicates yields one ack, not N."""
        st = self._spool_in.get(origin)
        if st is None or st.cum <= 0:
            return
        if reack:
            st.reack = True
        if st.cum <= st.acked_sent and not st.reack:
            return  # nothing new to tell the origin
        loop = asyncio.get_event_loop()
        interval = self.broker.config.get(
            "cluster_spool_ack_interval", 50) / 1000.0
        now = loop.time()
        if now - st.last_ack_t >= interval:
            self._send_spool_ack(origin)
        elif st.timer is None:
            st.timer = loop.call_later(
                max(0.0, interval - (now - st.last_ack_t)),
                self._spool_ack_timer, origin)

    def _spool_ack_timer(self, origin: str) -> None:
        st = self._spool_in.get(origin)
        if st is None:
            return
        st.timer = None
        if st.cum > st.acked_sent or st.reack:
            self._send_spool_ack(origin)

    def _send_spool_ack(self, origin: str) -> None:
        st = self._spool_in.get(origin)
        w = self._writers.get(origin)
        if st is None or w is None:
            return  # no back-channel yet; the origin's retransmit covers
        if w.send_frame(frame(b"ack", st.cum)):
            st.acked_sent = st.cum
            st.reack = False
            st.last_ack_t = asyncio.get_event_loop().time()
            self.metrics.incr("cluster_spool_acks_sent")

    def resolve_spool_ack(self, origin: str, seq: int) -> None:
        if self.spool is not None:
            self.spool.ack(origin, seq)

    async def remote_enqueue(self, node: str, sid, msgs: List[Any],
                             timeout: Optional[float] = None,
                             migrate: bool = False) -> bool:
        """Acked remote enqueue with backpressure — the migration/drain path
        (vmq_cluster:remote_enqueue/3, blocking with timeout
        vmq_cluster_node.erl:67-83). Default timeout comes from the
        remote_enqueue_timeout knob (ms, vmq_server.schema:300)."""
        if timeout is None:
            timeout = self.broker.config.get(
                "remote_enqueue_timeout", 5000) / 1000.0
        w = self._writers.get(node)
        if w is None:
            raise ConnectionError(f"no channel to {node}")
        if w.status == "down":
            # fail fast instead of buffering into a dead channel and
            # waiting out the ack timeout (the reference's enqueue errors
            # when the peer is unreachable, vmq_cluster_node.erl:124-147)
            raise ConnectionError(f"channel to {node} is down")
        ref_id = next(self._ack_ids)
        fut = asyncio.get_event_loop().create_future()
        self._pending_acks[ref_id] = fut
        try:
            if not w.send_frame(frame(b"enq", (ref_id, list(sid),
                                               [msg_to_term(m) for m in msgs],
                                               True, migrate))):
                raise ConnectionError(f"channel buffer to {node} full")
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending_acks.pop(ref_id, None)

    def send_ack(self, origin: str, ref_id: int, ok: bool) -> None:
        w = self._writers.get(origin)
        if w is not None:
            w.send_frame(frame(b"akn", (ref_id, ok)))

    def resolve_ack(self, ref_id: int, ok: bool) -> None:
        fut = self._pending_acks.get(ref_id)
        if fut is not None and not fut.done():
            fut.set_result(ok)

    # --------------------------------------------------------- metadata wire

    def on_peer_connected(self, w: NodeWriter) -> None:
        """Channel (re)established: exchange member info, then reconcile
        metadata — full-state push for the LWW backend, a scheduled SWC
        exchange for the SWC backend."""
        w.send_frame(frame(b"hlo", self.member_info()))
        ms = self.metadata
        if hasattr(ms, "digests"):
            # digest-based partial AE: ship the (bucket, digest) vector;
            # the peer answers with entries of mismatching buckets only —
            # O(delta) per reconnect, not O(state)
            w.send_frame(frame(b"dgq", ms.digests()))
        elif hasattr(ms, "full_state"):
            w.send_frame(frame(b"mtf", ms.full_state()))
        if hasattr(ms, "schedule_exchange") and \
                not w.node_name.startswith("bootstrap:"):
            ms.schedule_exchange(w.node_name)

    def send_meta_frame(self, node: str, cmd: bytes, term: Any) -> None:
        """Metadata AE frame to one peer (dgr/dgp replies)."""
        w = self._writers.get(node)
        if w is not None:
            w.send_frame(frame(cmd, term))

    def swc_send_all(self, term: Any) -> None:
        """Fire-and-forget SWC frame (object broadcast) to every peer."""
        data = frame(b"swb", term)
        for w in self._writers.values():
            w.send_frame(data)

    async def swc_call(self, node: str, term: Any, timeout: float = 10.0) -> Any:
        """Request/response over the data plane — the SWC exchange's rpc
        transport (replaces vmq_swc_edist_srv's erlang-dist rpc)."""
        w = self._writers.get(node)
        if w is None:
            raise ConnectionError(f"no channel to {node}")
        ref_id = next(self._ack_ids)
        fut = asyncio.get_event_loop().create_future()
        self._pending_swc[ref_id] = fut
        try:
            if not w.send_frame(frame(b"swc", (ref_id, term))):
                raise ConnectionError(f"channel buffer to {node} full")
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending_swc.pop(ref_id, None)

    def swc_respond(self, origin: str, ref_id: int, ok: bool, result: Any) -> None:
        w = self._writers.get(origin)
        if w is not None:
            w.send_frame(frame(b"swr", (ref_id, ok, result)))

    def resolve_swc(self, ref_id: int, ok: bool, result: Any) -> None:
        fut = self._pending_swc.get(ref_id)
        if fut is not None and not fut.done():
            if ok:
                fut.set_result(result)
            else:
                fut.set_exception(ConnectionError(str(result)))

    # ---------------------------------------------------- reg_sync transport

    def sync_acquire(self, node: str, ref_id: int, key: Any,
                     lease: float) -> bool:
        w = self._writers.get(node)
        if w is None or w.status == "down":
            return False
        return w.send_frame(frame(b"syq", (ref_id, key, lease)))

    def sync_grant(self, node: str, ref_id: int) -> bool:
        w = self._writers.get(node)
        if w is None or w.status == "down":
            return False
        return w.send_frame(frame(b"syg", ref_id))

    def sync_release(self, node: str, key: Any) -> None:
        w = self._writers.get(node)
        if w is not None:
            w.send_frame(frame(b"syr", key))

    def _pt_send(self, node: str, cmd: bytes, term: Any) -> bool:
        w = self._writers.get(node)
        if w is None or w.status == "down":
            return False
        return w.send_frame(frame(cmd, term))

    def _broadcast_meta(self, prefix: str, key: Any, entry) -> None:
        # the codec preserves tuple/list distinction, so keys travel as-is.
        # Joined peers get the write via the plumtree broadcast tree
        # (eager gossip + lazy IHAVE, vmq_plumtree.erl:46-104 analog);
        # pre-handshake bootstrap channels still get a plain flood frame.
        self.plumtree.broadcast(prefix, key, list(entry))
        if self._bootstrap:
            data = frame(b"mta", (prefix, key, list(entry)))
            for w in self._bootstrap:
                w.send_frame(data)
