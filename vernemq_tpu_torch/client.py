"""Asyncio MQTT client (v4 + v5).

Plays the role of the reference's ``gen_mqtt_client`` behaviour
(``apps/vmq_commons/src/gen_mqtt_client.erl``): a programmatic client used
by the bridge for broker-to-broker links and by the test suites as the
"real protocol over TCP" client (the reference suites build frames with the
parser's gen_* helpers and speak raw TCP — ``packet.erl``; this client is
that, structured).
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

from .protocol import codec_v4, codec_v5
from .protocol.types import (
    PROTO_5,
    Auth,
    Connack,
    Connect,
    Disconnect,
    Frame,
    Pingreq,
    Pingresp,
    Puback,
    Pubcomp,
    Publish,
    Pubrec,
    Pubrel,
    SubOpts,
    Suback,
    Subscribe,
    Unsuback,
    Unsubscribe,
    Will,
)


class MQTTClient:
    def __init__(self, host: str, port: int, client_id: str = "",
                 proto_ver: int = 4, clean_start: bool = True,
                 username: Optional[str] = None, password: Optional[bytes] = None,
                 keepalive: int = 60, will: Optional[Will] = None,
                 properties: Optional[Dict[str, Any]] = None,
                 ssl_context=None):
        self.host, self.port = host, port
        self.client_id = client_id
        self.proto_ver = proto_ver
        self.codec = codec_v5 if proto_ver == PROTO_5 else codec_v4
        self.clean_start = clean_start
        self.username, self.password = username, password
        self.keepalive = keepalive
        self.will = will
        self.connect_properties = properties or {}
        self.ssl_context = ssl_context
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._buf = b""
        self._next_pid = 0
        self.connack: Optional[Connack] = None
        # inbound publishes land here; acks handled inline by recv loop
        self.messages: asyncio.Queue = asyncio.Queue()
        self.disconnect_frame: Optional[Disconnect] = None
        self._acks: Dict[int, asyncio.Future] = {}
        self._recv_task: Optional[asyncio.Task] = None
        self._auto_ack = True
        self.closed = False

    # ------------------------------------------------------------ plumbing

    def _pid(self) -> int:
        self._next_pid = (self._next_pid % 65535) + 1
        return self._next_pid

    def _send(self, frame: Frame) -> None:
        assert self._writer is not None
        self._writer.write(self.codec.serialise(frame))

    async def _read_frame(self) -> Optional[Frame]:
        while True:
            frame, rest = self.codec.parse(self._buf)
            self._buf = bytes(rest)
            if frame is not None:
                return frame
            chunk = await self._reader.read(65536)
            if not chunk:
                return None
            self._buf += chunk

    # ------------------------------------------------------------- connect

    async def connect(self, timeout: float = 5.0) -> Connack:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=self.ssl_context)
        self._send(Connect(
            proto_ver=self.proto_ver, client_id=self.client_id,
            username=self.username, password=self.password,
            clean_start=self.clean_start, keepalive=self.keepalive,
            will=self.will, properties=self.connect_properties,
        ))
        frame = await asyncio.wait_for(self._read_frame(), timeout)
        if isinstance(frame, Auth):
            # enhanced auth continuation is driven by the caller via auth()
            self._pending_auth = frame
            return frame
        if not isinstance(frame, Connack):
            raise ConnectionError(f"expected CONNACK, got {frame!r}")
        self.connack = frame
        self._recv_task = asyncio.get_event_loop().create_task(self._recv_loop())
        return frame

    async def auth(self, reason_code: int, properties: Dict[str, Any],
                   timeout: float = 5.0) -> Frame:
        """Send an AUTH frame during enhanced auth; returns the next
        CONNACK/AUTH frame."""
        self._send(Auth(reason_code=reason_code, properties=properties))
        frame = await asyncio.wait_for(self._read_frame(), timeout)
        if isinstance(frame, Connack):
            self.connack = frame
            self._recv_task = asyncio.get_event_loop().create_task(self._recv_loop())
        return frame

    async def _recv_loop(self) -> None:
        try:
            while True:
                frame = await self._read_frame()
                if frame is None:
                    break
                t = type(frame)
                if t is Publish:
                    if self._auto_ack and frame.qos == 1:
                        self._send(Puback(packet_id=frame.packet_id))
                    elif self._auto_ack and frame.qos == 2:
                        self._send(Pubrec(packet_id=frame.packet_id))
                    await self.messages.put(frame)
                elif t is Pubrel:
                    if self._auto_ack:
                        self._send(Pubcomp(packet_id=frame.packet_id))
                elif t in (Puback, Pubrec, Pubcomp, Suback, Unsuback):
                    if t is Pubrec:
                        self._send(Pubrel(packet_id=frame.packet_id))
                        continue  # wait for PUBCOMP to resolve the future
                    fut = self._acks.pop(frame.packet_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result(frame)
                elif t is Pingresp:
                    pass
                elif t is Disconnect:
                    self.disconnect_frame = frame
                    await self.messages.put(frame)
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self.closed = True
            await self.messages.put(None)  # EOF marker

    # ------------------------------------------------------------- actions

    async def subscribe(self, topics, qos: int = 0,
                        properties: Optional[Dict[str, Any]] = None,
                        opts: Optional[SubOpts] = None,
                        timeout: float = 5.0) -> Suback:
        if isinstance(topics, str):
            topics = [topics]
        pid = self._pid()
        fut = asyncio.get_event_loop().create_future()
        self._acks[pid] = fut
        self._send(Subscribe(
            packet_id=pid,
            topics=[(t, opts or SubOpts(qos=qos)) for t in topics],
            properties=properties or {},
        ))
        return await asyncio.wait_for(fut, timeout)

    async def unsubscribe(self, topics, timeout: float = 5.0) -> Unsuback:
        if isinstance(topics, str):
            topics = [topics]
        pid = self._pid()
        fut = asyncio.get_event_loop().create_future()
        self._acks[pid] = fut
        self._send(Unsubscribe(packet_id=pid, topics=topics))
        return await asyncio.wait_for(fut, timeout)

    async def publish(self, topic: str, payload: bytes = b"", qos: int = 0,
                      retain: bool = False,
                      properties: Optional[Dict[str, Any]] = None,
                      timeout: float = 5.0) -> Optional[Frame]:
        pid = self._pid() if qos else None
        frame = Publish(topic=topic, payload=payload, qos=qos, retain=retain,
                        packet_id=pid, properties=properties or {})
        if qos == 0:
            self._send(frame)
            return None
        fut = asyncio.get_event_loop().create_future()
        self._acks[pid] = fut
        self._send(frame)
        return await asyncio.wait_for(fut, timeout)  # Puback or Pubcomp

    async def ping(self) -> None:
        self._send(Pingreq())

    async def recv(self, timeout: float = 5.0) -> Optional[Frame]:
        """Next inbound PUBLISH (or server DISCONNECT/None-EOF)."""
        return await asyncio.wait_for(self.messages.get(), timeout)

    async def disconnect(self, reason_code: int = 0,
                         properties: Optional[Dict[str, Any]] = None) -> None:
        if self._writer is not None and not self.closed:
            try:
                if self.proto_ver == PROTO_5:
                    self._send(Disconnect(reason_code=reason_code,
                                          properties=properties or {}))
                else:
                    self._send(Disconnect())
                await self._writer.drain()
            except ConnectionError:
                pass
        await self.close()

    async def close(self) -> None:
        self.closed = True
        if self._recv_task is not None:
            self._recv_task.cancel()
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:
                pass


class _ConnackRejected(ConnectionError):
    """Broker refused the CONNECT (rc != 0) — reported via
    on_connect_error, NOT on_disconnect (one event per attempt)."""

    def __init__(self, rc: int):
        super().__init__(f"CONNACK rc={rc}")
        self.rc = rc


class ReconnectingClient:
    """The behaviour-surface client of the reference (`gen_mqtt_client.erl`):
    a supervised connect/consume loop with reconnect backoff, a bounded
    offline publish queue with drop accounting, resubscribe-on-connect and
    keepalive pings, exposing the callback surface the reference defines —
    ``on_connect`` (gen_mqtt_client.erl:398-416 CONNACK dispatch),
    ``on_connect_error`` (per-rc, same lines), ``on_disconnect``
    (maybe_reconnect, :624-631), ``on_publish`` (:482-520 deliver path),
    ``on_subscribe``/``on_unsubscribe`` (:423-447).

    The reference reconnects on a FIXED ``reconnect_timeout`` (:343);
    ``backoff="exponential"`` optionally doubles up to ``backoff_max``
    (the vmq_bridge restart discipline). The offline queue mirrors
    ``o_queue``/``max_queue_size`` (:337,346): publishes while down are
    queued up to the cap, beyond it dropped WITH accounting (:658-660,
    ``out_queue_dropped`` in info, :538-541), and drained on CONNACK
    (publish_from_queue, :650-656). ``max_queue_size=0`` queues nothing
    (every offline publish drops), matching the reference default.

    Used by :class:`~vernemq_tpu.plugins.bridge.Bridge`; also the public
    client for long-lived integrations (the test suites use the
    bare :class:`MQTTClient`)."""

    def __init__(self, host: str, port: int,
                 reconnect_timeout: float = 10.0,
                 backoff: str = "fixed", backoff_max: float = 300.0,
                 max_queue_size: int = 0, resubscribe: bool = True,
                 connect_timeout: float = 10.0,
                 on_connect=None, on_connect_error=None,
                 on_disconnect=None, on_publish=None,
                 on_subscribe=None, on_unsubscribe=None,
                 subscriptions: Optional[Dict[str, SubOpts]] = None,
                 **client_kw: Any):
        self.host, self.port = host, port
        self.reconnect_timeout = reconnect_timeout
        self.backoff = backoff
        self.backoff_max = backoff_max
        self.max_queue_size = max_queue_size
        self.resubscribe = resubscribe
        self.connect_timeout = connect_timeout
        self.client_kw = client_kw
        self.on_connect = on_connect
        self.on_connect_error = on_connect_error
        self.on_disconnect = on_disconnect
        self.on_publish = on_publish
        self.on_subscribe = on_subscribe
        self.on_unsubscribe = on_unsubscribe
        self.client: Optional[MQTTClient] = None
        self.connected = asyncio.Event()
        self.connected_since: Optional[float] = None
        #: inbound publishes when no on_publish callback is given
        self.messages: asyncio.Queue = asyncio.Queue()
        self._subs: Dict[str, SubOpts] = dict(subscriptions or {})
        self._queue: List[Tuple[str, bytes, int, bool, Dict[str, Any]]] = []
        self.out_queue_dropped = 0
        self._task: Optional[asyncio.Task] = None
        self._ping_task: Optional[asyncio.Task] = None
        self._cb_tasks: set = set()
        self._stopped = False

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped = True
        for t in (self._task, self._ping_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        if self.client is not None:
            try:
                await self.client.disconnect()
            except Exception:
                pass
            self.client = None
        self.connected.clear()

    def _fire(self, cb, *args) -> None:
        if cb is None:
            return
        try:
            res = cb(*args)
            if asyncio.iscoroutine(res):
                # strong-ref the task: the loop only weak-refs tasks, so
                # an unreferenced async callback could be GC'd mid-run
                t = asyncio.get_event_loop().create_task(res)
                self._cb_tasks.add(t)
                t.add_done_callback(self._cb_tasks.discard)
        except Exception:
            import logging

            logging.getLogger("vernemq_tpu_torch.client").exception(
                "reconnecting-client callback failed")

    async def _run(self) -> None:
        delay = self.reconnect_timeout
        loop = asyncio.get_event_loop()
        while not self._stopped:
            client = MQTTClient(self.host, self.port, **self.client_kw)
            try:
                ack = await client.connect(timeout=self.connect_timeout)
                if getattr(ack, "rc", 1) != 0:
                    self._fire(self.on_connect_error, ack.rc)
                    raise _ConnackRejected(ack.rc)
                self.client = client
                self.connected_since = loop.time()
                delay = self.reconnect_timeout  # success resets backoff
                if self.resubscribe:
                    for topic, opts in list(self._subs.items()):
                        await client.subscribe(topic, opts=opts)
                self.connected.set()
                self._fire(self.on_connect, ack.session_present)
                # drain the offline queue (publish_from_queue): pop only
                # AFTER a publish succeeds, so a failure mid-drain keeps
                # the unsent remainder queued for the next connect (a
                # retried head may duplicate — QoS1 at-least-once)
                while self._queue:
                    topic, payload, qos, retain, props = self._queue[0]
                    await client.publish(topic, payload, qos=qos,
                                         retain=retain, properties=props)
                    self._queue.pop(0)
                self._ping_task = loop.create_task(
                    self._keepalive(client))
                while True:
                    frame = await client.messages.get()
                    if frame is None:
                        raise ConnectionError("connection closed")
                    if isinstance(frame, Publish):
                        if self.on_publish is not None:
                            self._fire(self.on_publish, frame)
                        else:
                            await self.messages.put(frame)
            except asyncio.CancelledError:
                raise
            except _ConnackRejected:
                pass  # already reported via on_connect_error — one event
            except Exception as e:
                self._fire(self.on_disconnect, e)
            finally:
                self.connected.clear()
                self.connected_since = None
                self.client = None
                if self._ping_task is not None:
                    self._ping_task.cancel()
                    self._ping_task = None
                try:
                    await client.close()
                except Exception:
                    pass
            if self._stopped:
                return
            await asyncio.sleep(delay)
            if self.backoff == "exponential":
                delay = min(delay * 2, self.backoff_max)

    async def _keepalive(self, client: MQTTClient) -> None:
        """PINGREQ at half the keepalive interval — an idle link must not
        be culled by the broker's 1.5x keepalive reaper."""
        interval = max(1.0, self.client_kw.get("keepalive", 60) / 2)
        try:
            while True:
                await asyncio.sleep(interval)
                await client.ping()
        except (asyncio.CancelledError, ConnectionError):
            pass

    # -------------------------------------------------------------- actions

    async def subscribe(self, topic: str, qos: int = 0,
                        opts: Optional[SubOpts] = None):
        """Record for resubscribe-on-reconnect; subscribe now when up."""
        self._subs[topic] = opts or SubOpts(qos=qos)
        if self.connected.is_set() and self.client is not None:
            suback = await self.client.subscribe(topic,
                                                 opts=self._subs[topic])
            self._fire(self.on_subscribe, topic, suback)
            return suback
        return None

    async def unsubscribe(self, topic: str):
        self._subs.pop(topic, None)
        if self.connected.is_set() and self.client is not None:
            unsuback = await self.client.unsubscribe(topic)
            self._fire(self.on_unsubscribe, topic)
            return unsuback
        return None

    async def publish(self, topic: str, payload: bytes = b"",
                      qos: int = 0, retain: bool = False,
                      properties: Optional[Dict[str, Any]] = None):
        """Publish now, or queue while down (bounded; beyond the cap the
        publish is DROPPED with accounting, gen_mqtt_client.erl:658-660)."""
        if self.connected.is_set() and self.client is not None:
            return await self.client.publish(topic, payload, qos=qos,
                                             retain=retain,
                                             properties=properties)
        if len(self._queue) < self.max_queue_size:
            self._queue.append((topic, payload, qos, retain,
                                properties or {}))
        else:
            self.out_queue_dropped += 1
        return None

    def info(self) -> Dict[str, Any]:
        return {
            "connected": self.connected.is_set(),
            "out_queue_size": len(self._queue),
            "out_queue_dropped": self.out_queue_dropped,
            "subscriptions": sorted(self._subs),
        }
