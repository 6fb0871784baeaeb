"""Outbound cluster data-plane writer: one per remote node.

Mirrors ``vmq_cluster_node.erl``: a dedicated writer with a custom framed
TCP channel — deliberately not the control plane — with handshake
``"vmq-connect"<len><node>`` and batches ``"vmq-send"<len>`` of
``<cmd:3><len><term>`` sub-frames (``vmq_cluster_node.erl:181-196,
149-180``). Buffering is bounded (``outgoing_clustering_buffer_size``)
with drop accounting when the peer is unreachable
(``:124-147``); writes are flushed MSS-aligned (``:234-241``); ``enqueue``
blocks on an ack with timeout for migration backpressure (``:67-83``).

Frame commands:
``msg`` publish fanout (fire-and-forget) · ``msq`` seq-tagged spooled
``msg``/``enq`` envelope (cluster/spool.py) · ``msb`` spool stream base
(lowest unacked seq) · ``ack`` cumulative spool ack · ``enq`` remote
enqueue (acked) · ``akn`` enqueue ack · ``mta``
metadata delta · ``mtf`` metadata full-state (anti-entropy on connect) ·
``hlo`` member info + capability exchange.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Any, Dict, Optional, Tuple

from . import codec

log = logging.getLogger("vernemq_tpu_torch.cluster")

HANDSHAKE = b"vmq-connect"
SEND = b"vmq-send"


def frame(cmd: bytes, term: Any) -> bytes:
    assert len(cmd) == 3
    payload = codec.encode(term)
    return cmd + struct.pack(">I", len(payload)) + payload


def msg_to_term(msg) -> Dict[str, Any]:
    """#vmq_msg{} → wire term (vmq_cluster_com.erl:212-248 field set).
    The monotonic expiry deadline travels as remaining seconds."""
    remaining = None
    if msg.expires_at is not None:
        remaining = max(0.0, msg.expires_at - time.monotonic())
    return {
        "ref": msg.msg_ref,
        "topic": list(msg.topic),
        "payload": msg.payload,
        "qos": msg.qos,
        "retain": msg.retain,
        "dup": msg.dup,
        "mp": msg.mountpoint,
        "props": msg.properties,
        "exp": remaining,
        "sg": msg.sg_policy,
    }


def term_to_msg(t: Dict[str, Any]):
    from ..broker.message import Msg

    exp = t.get("exp")
    return Msg(
        topic=tuple(t["topic"]),
        payload=t["payload"],
        qos=t["qos"],
        retain=t["retain"],
        dup=t.get("dup", False),
        mountpoint=t.get("mp", ""),
        msg_ref=t["ref"],
        properties=t.get("props") or {},
        expires_at=(time.monotonic() + exp) if exp is not None else None,
        sg_policy=t.get("sg"),
    )


class NodeWriter:
    """Buffered writer to one remote node (vmq_cluster_node gen_server)."""

    RECONNECT_DELAY = 1.0
    PING_INTERVAL = 1.0

    def __init__(self, cluster, node_name: str, addr: Tuple[str, int],
                 max_buffer_bytes: int = 10_000_000):
        self.cluster = cluster
        self.node_name = node_name
        self.addr = addr
        self.max_buffer_bytes = max_buffer_bytes
        self._buf: list = []  # (frame_bytes, sheddable) pairs
        self._buf_bytes = 0
        self._sheddable_bytes = 0  # QoS0 bytes in _buf (shed fast path)
        self._conn_lost = False
        self._wakeup = asyncio.Event()
        self.status = "init"  # init | up | down (vmq_cluster_node.erl:202-212)
        self._task: Optional[asyncio.Task] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        # drop accounting, split by unit: the per-writer totals feed
        # member_info(); the metric counters feed $SYS/Prometheus
        self.dropped_frames = 0
        self.dropped_bytes = 0

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self._writer is not None:
            self._writer.close()

    def bounce(self) -> None:
        """Force-cycle the TCP connection (the ack-stall watchdog's
        response to a half-open peer: writes keep succeeding into the
        void while acks never arrive). The write loop observes the
        loss, tears the socket down, and reconnects after the normal
        delay — channel-up then replays the spool, so the cycle is
        loss-free for QoS ≥ 1. No-op while already down (the reconnect
        loop is the recovery path there)."""
        if self._writer is None:
            return
        self._conn_lost = True
        self._writer.close()
        self._wakeup.set()

    # ----------------------------------------------------------------- send

    def send_frame(self, data: bytes, sheddable: bool = False) -> bool:
        """Append to the bounded buffer; drops (with frames+bytes
        accounting) when the peer is down and the buffer is full
        (vmq_cluster_node.erl:124-147). ``sheddable`` marks QoS 0
        publishes: when a non-sheddable frame (QoS ≥ 1 data, metadata,
        acks) would not fit, buffered QoS 0 frames are evicted
        oldest-first to make room — delivery-guaranteed traffic sheds
        best-effort traffic, never the other way around."""
        size = len(data)
        if self._buf_bytes + size > self.max_buffer_bytes and not sheddable:
            self._shed_qos0(size)
        if self._buf_bytes + size > self.max_buffer_bytes:
            self.dropped_frames += 1
            self.dropped_bytes += size
            m = self.cluster.metrics
            m.incr("cluster_frames_dropped")
            m.incr("cluster_bytes_dropped", size)
            return False
        self._buf.append((data, sheddable))
        self._buf_bytes += size
        if sheddable:
            self._sheddable_bytes += size
        self._wakeup.set()
        return True

    def _shed_qos0(self, needed: int) -> None:
        """Evict buffered QoS 0 frames (oldest first) until ``needed``
        bytes fit. Shed frames count as drops too — they are gone."""
        if not self._sheddable_bytes:
            return  # nothing evictable: skip the buffer walk
        shed = shed_bytes = 0
        i = 0
        while (i < len(self._buf)
               and self._buf_bytes + needed > self.max_buffer_bytes):
            data, sheddable = self._buf[i]
            if sheddable:
                del self._buf[i]
                self._buf_bytes -= len(data)
                self._sheddable_bytes -= len(data)
                shed += 1
                shed_bytes += len(data)
            else:
                i += 1
        if shed:
            self.dropped_frames += shed
            self.dropped_bytes += shed_bytes
            m = self.cluster.metrics
            m.incr("cluster_frames_shed_qos0", shed)
            m.incr("cluster_frames_dropped", shed)
            m.incr("cluster_bytes_dropped", shed_bytes)

    def publish(self, msg) -> bool:
        return self.send_frame(frame(b"msg", msg_to_term(msg)),
                               sheddable=msg.qos == 0)

    # ------------------------------------------------------------ connection

    async def _run(self) -> None:
        while True:
            try:
                reader, writer = await asyncio.open_connection(*self.addr)
            except OSError:
                if self.status != "down":
                    self.status = "down"
                    self.cluster.on_channel_status(self.node_name, "down")
                await asyncio.sleep(self.RECONNECT_DELAY)
                continue
            self._writer = writer
            self._conn_lost = False
            name = self.cluster.node_name.encode()
            writer.write(HANDSHAKE + struct.pack(">I", len(name)) + name)
            # on (re)connect run the backend's reconciliation: full-state
            # push (LWW/plumtree-style) or an SWC exchange
            self.cluster.on_peer_connected(self)
            self.status = "up"
            self.cluster.on_channel_status(self.node_name, "up")
            # the channel is write-only; EOF on the read side is the peer
            # (or a partition) tearing it down — wake the writer loop
            eof_task = asyncio.get_event_loop().create_task(
                self._watch_eof(reader))
            try:
                await self._write_loop(writer)
            except (ConnectionError, OSError) as e:
                log.info("cluster channel to %s lost: %s", self.node_name, e)
            finally:
                eof_task.cancel()
                writer.close()
                self._writer = None
                if self.status != "down":
                    self.status = "down"
                    self.cluster.on_channel_status(self.node_name, "down")
            await asyncio.sleep(self.RECONNECT_DELAY)

    async def _watch_eof(self, reader: asyncio.StreamReader) -> None:
        try:
            await reader.read(1)
        except (ConnectionError, OSError):
            pass
        self._conn_lost = True
        self._wakeup.set()

    async def _write_loop(self, writer: asyncio.StreamWriter) -> None:
        while True:
            if not self._buf and not self._conn_lost:
                self._wakeup.clear()
                try:
                    # periodic liveness ping while idle (the status probe
                    # role of vmq_cluster_mon's node monitoring)
                    await asyncio.wait_for(self._wakeup.wait(),
                                           self.PING_INTERVAL)
                except asyncio.TimeoutError:
                    # the ping doubles as the load-gossip carrier: the
                    # term (None for pre-health peers, who ignore it)
                    # carries this node's load score + advertised
                    # client address for the failure detector/planner
                    term = None
                    if hasattr(self.cluster, "ping_term"):
                        term = self.cluster.ping_term()
                    data = frame(b"png", term)
                    self._buf.append((data, False))
                    self._buf_bytes += len(data)
            if self._conn_lost or writer.is_closing():
                raise ConnectionError("channel closed by peer")
            batch, self._buf = self._buf, []
            nbytes, self._buf_bytes = self._buf_bytes, 0
            self._sheddable_bytes = 0
            blob = b"".join(d for d, _ in batch)
            writer.write(SEND + struct.pack(">I", len(blob)) + blob)
            await writer.drain()
            self.cluster.metrics.incr("cluster_bytes_sent", nbytes)
