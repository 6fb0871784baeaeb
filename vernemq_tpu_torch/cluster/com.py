"""Inbound cluster data-plane handler.

Mirrors ``vmq_cluster_com.erl``: per inbound connection, parse the
``vmq-connect`` handshake, then ``vmq-send`` batches of sub-frames.
``msg`` frames fold the local reg view with remote/group rows ignored —
they were already covered by the origin node (``vmq_cluster_com.erl:
198-203``); ``enq`` frames enqueue into local queues off the channel's
critical path and ack back to the origin (``:153-196``). Metadata frames
(``mta``/``mtf``/``hlo``) merge into the replicated store.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Optional

from . import codec
from ..broker import heap
from ..robustness import faults
from .node import term_to_msg

log = logging.getLogger("vernemq_tpu_torch.cluster")


def joined(peer: str, applied: int) -> None:
    """A metadata exchange on a (re)connected channel applied ``applied``
    entries from ``peer``: a join's bulk load has ended, the moment of the
    broker's full-collection policy (``broker/heap.py``)."""
    if applied:
        heap.POLICY.settled(
            f"a metadata exchange with {peer} ({applied} entries)")


def _count_subframes(blob: bytes) -> int:
    """Sub-frames in a ``vmq-send`` batch (header walk, no decode) — the
    frame count for drop accounting when a whole batch is discarded."""
    pos = n = 0
    while pos + 7 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos + 3:pos + 7])
        pos += 7 + length
        if pos > len(blob):
            break
        n += 1
    return n


class ClusterCom:
    def __init__(self, cluster):
        self.cluster = cluster
        self._conns: set = set()  # live inbound writers, closed on stop

    def close_all(self) -> None:
        """Tear down established inbound channels (node shutdown: peers
        must observe the drop, not keep writing into a stopped broker)."""
        for w in list(self._conns):
            w.close()

    async def handle_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        origin: Optional[str] = None
        self._conns.add(writer)
        try:
            magic = await reader.readexactly(11)
            if magic != b"vmq-connect":
                return
            (n,) = struct.unpack(">I", await reader.readexactly(4))
            origin = (await reader.readexactly(n)).decode()
            self.cluster.inbound_up(origin)
            while True:
                hdr = await reader.readexactly(12)
                if hdr[:8] != b"vmq-send":
                    log.warning("bad cluster frame header from %s", origin)
                    return
                (length,) = struct.unpack(">I", hdr[8:12])
                blob = await reader.readexactly(length)
                self.cluster.metrics.incr("cluster_bytes_received", length)
                try:
                    # fault-injection point for the inter-node link:
                    # `error` drops this batch (the partition/packet-loss
                    # probe — AE repairs the gap), `latency` delays it
                    # without blocking other connections
                    await faults.inject_async("cluster.recv")
                except faults.InjectedFault:
                    # same split accounting as the writer-side drop path
                    self.cluster.metrics.incr("cluster_bytes_dropped",
                                              length)
                    self.cluster.metrics.incr("cluster_frames_dropped",
                                              _count_subframes(blob))
                    log.warning("injected fault dropped a %d-byte "
                                "cluster batch from %s", length, origin)
                    continue
                self._process(origin, blob)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._conns.discard(writer)
            if origin is not None:
                self.cluster.inbound_down(origin)
            writer.close()

    def _process(self, origin: str, blob: bytes) -> None:
        # every delivered batch is a liveness proof for the failure
        # detector — data-plane traffic keeps a busy peer alive without
        # waiting for its idle ping (dropped batches, e.g. the
        # cluster.recv fault seam, deliberately do NOT count: an
        # isolated peer must look silent)
        self.cluster.on_peer_traffic(origin)
        pos = 0
        while pos < len(blob):
            try:
                cmd = blob[pos:pos + 3]
                (length,) = struct.unpack(">I", blob[pos + 3:pos + 7])
                payload = blob[pos + 7:pos + 7 + length]
                if len(payload) != length:
                    raise ValueError("truncated sub-frame")
            except (struct.error, ValueError):
                # malformed header: no way to resync inside this batch —
                # drop the remainder but keep the channel alive
                log.warning("malformed cluster sub-frame from %s at +%d",
                            origin, pos)
                return
            pos += 7 + length
            try:
                term = codec.decode(payload)
                self._dispatch(origin, bytes(cmd), term)
            except Exception:
                log.exception("cluster frame %r from %s failed", cmd, origin)

    def _dispatch(self, origin: str, cmd: bytes, term) -> None:
        cluster = self.cluster
        if cmd == b"msg":
            # remote publish: local subscribers only (origin covered the
            # rest). The optional "trc" field is the origin's sampled
            # flight-recorder context (negotiated via the "trace" hlo
            # cap): RESUME it so the record carries both nodes' stamps
            # — publish_from_remote is an admission point either way.
            trc = term.pop("trc", None) if isinstance(term, dict) else None
            msg = term_to_msg(term)
            trace = None
            if trc is not None:
                trace = cluster.broker.recorder.resume(trc, origin)
            cluster.broker.registry.publish_from_remote(msg, trace=trace)
        elif cmd == b"msq":
            # spooled seq-tagged envelope (cluster/spool.py): dedup on
            # (seq, msg_ref) per origin — a replay after a lost ack must
            # not double-route QoS 2 — then dispatch the inner msg/enq
            # frame and schedule the cumulative ack back to the origin
            seq, kind, inner = term
            if kind == "msg":
                ref = inner.get("ref") or b""
            else:  # enq: (ref_id, sid, msgs, want_ack)
                msgs = inner[2]
                ref = (msgs[0].get("ref") or b"") if msgs else b""
            if cluster.spool_accept(origin, int(seq), ref):
                self._dispatch(origin, kind.encode(), inner)
        elif cmd == b"msb":
            # spool stream base: the origin's lowest unacked seq — the
            # anchor for the receiver's contiguous-ack cursor
            cluster.spool_base(origin, int(term))
        elif cmd == b"ack":
            # cumulative spool ack: the peer received every spooled frame
            # up to seq (contiguously) — delete them from our journal
            cluster.resolve_spool_ack(origin, int(term))
        elif cmd == b"enq":
            ref_id, sid, msgs, want_ack = term[:4]
            # 5th element (optional): coordinated-handoff drain — the
            # sender is the record owner shipping ahead of the fence
            migrate = bool(term[4]) if len(term) > 4 else False
            sid = (sid[0], sid[1])
            # enqueue off the channel path (the reference spawns,
            # vmq_cluster_com.erl:160-166)
            async def _enq():
                ok = cluster.broker.registry.enqueue_remote(
                    sid, [term_to_msg(m) for m in msgs], migrate=migrate)
                if want_ack:
                    cluster.send_ack(origin, ref_id, ok)

            asyncio.get_event_loop().create_task(_enq())
        elif cmd == b"akn":
            ref_id, ok = term
            cluster.resolve_ack(ref_id, ok)
        elif cmd == b"mta":
            if hasattr(cluster.metadata, "merge"):
                prefix, key, entry = term
                cluster.metadata.merge(prefix, codec.dekey(key), tuple(entry))
        elif cmd == b"mtg":
            # plumtree eager gossip: merge on first sight of the id, then
            # the tree re-pushes (Plumtree.on_gossip); duplicates prune
            pt = cluster.plumtree
            if pt is not None and hasattr(cluster.metadata, "merge"):
                mid, prefix, key, entry = term
                if pt.on_gossip(origin, mid, prefix, key, list(entry)):
                    cluster.metadata.merge(prefix, codec.dekey(key),
                                           tuple(entry))
        elif cmd == b"mti":
            if cluster.plumtree is not None:
                cluster.plumtree.on_ihave(origin, term[0])
        elif cmd == b"mtr":
            if cluster.plumtree is not None:
                cluster.plumtree.on_graft(origin, term[0])
        elif cmd == b"mtp":
            if cluster.plumtree is not None:
                cluster.plumtree.on_prune(origin)
        elif cmd == b"mtf":
            if hasattr(cluster.metadata, "merge_full"):
                applied = cluster.metadata.merge_full(
                    (p, k, tuple(e)) for p, k, e in term)
                if applied:
                    log.debug("anti-entropy from %s applied %d entries",
                              origin, applied)
                    joined(origin, applied)
        elif cmd == b"dgq":
            # partial-AE digest vector: answer with entries of buckets
            # whose digest differs (both sides run this symmetric flow)
            ms = cluster.metadata
            if hasattr(ms, "diff_buckets"):
                diff = ms.diff_buckets((b, d) for b, d in term)
                if diff:
                    cluster.send_meta_frame(
                        origin, b"dgr", (diff, ms.bucket_entries(diff)))
        elif cmd == b"dgr":
            ms = cluster.metadata
            if hasattr(ms, "merge_full"):
                buckets, entries = term
                # snapshot OUR side BEFORE merging: reciprocation must
                # carry only entries the peer doesn't have, not echo the
                # ones it just sent us back at it
                ours = ms.bucket_entries(buckets)
                applied = ms.merge_full(
                    (p, k, tuple(e)) for p, k, e in entries)
                log.debug("partial AE from %s: %d buckets, %d applied",
                          origin, len(buckets), applied)
                cluster.send_meta_frame(origin, b"dgp", ours)
                joined(origin, applied)
        elif cmd == b"dgp":
            ms = cluster.metadata
            if hasattr(ms, "merge_full"):
                joined(origin, ms.merge_full(
                    (p, k, tuple(e)) for p, k, e in term))
        elif cmd == b"swb":
            if hasattr(cluster.metadata, "handle_swc_cast"):
                cluster.metadata.handle_swc_cast(origin, term)
        elif cmd == b"swc":
            ref_id, body = term
            try:
                result, ok = cluster.metadata.handle_swc_call(origin, body), True
            except Exception as e:
                result, ok = str(e), False
            cluster.swc_respond(origin, ref_id, ok, result)
        elif cmd == b"swr":
            ref_id, ok, result = term
            cluster.resolve_swc(ref_id, ok, result)
        elif cmd == b"syq":
            # reg_sync acquire request: this node coordinates `key`
            ref_id, key, lease = term
            cluster.reg_sync.handle_acquire(origin, ref_id,
                                            codec.dekey(key), lease)
        elif cmd == b"syg":
            cluster.reg_sync.on_grant(term)  # term = ref_id
        elif cmd == b"syr":
            cluster.reg_sync.handle_release(origin, codec.dekey(term))
        elif cmd == b"hlo":
            cluster.on_hello(origin, term)
        elif cmd == b"png":
            # liveness ping; a health-plane peer gossips its load score
            # and advertised client address in the term (None from
            # pre-health peers — the batch itself already counted as
            # the heartbeat in _process)
            cluster.on_ping(origin, term)
        else:
            log.warning("unknown cluster frame %r from %s", cmd, origin)

