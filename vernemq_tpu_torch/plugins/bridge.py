"""MQTT bridge: connects this broker to a remote MQTT broker and maps
topics between the two.

Plays the role of ``vmq_bridge`` (``apps/vmq_bridge/src/vmq_bridge.erl``):
per-bridge topic rules ``(pattern, direction in|out|both, qos,
local_prefix, remote_prefix)`` with prefix rewriting
(``vmq_bridge.erl:143-170,178-224``), a reconnecting MQTT client
(``vernemq_tpu_torch.client.ReconnectingClient`` — the ``gen_mqtt_client``
behaviour surface) with restart backoff (``restart_timeout``), and
registration on the local broker
through the plugin-subscriber seam — the reference acquires local
publish/subscribe functions via ``vmq_reg:direct_plugin_exports``
(``vmq_bridge_sup`` RegistryMFA); here the bridge owns a plugin queue on
the registry directly.

Directions:

- ``in``   — subscribe ``pattern`` on the REMOTE broker; matching remote
  publishes are re-published locally under ``local_prefix``.
- ``out``  — subscribe ``pattern`` on the LOCAL broker; matching local
  publishes are forwarded to the remote broker under ``remote_prefix``.
- ``both`` — both of the above.

Outbound messages are buffered (bounded, drop-with-accounting) while the
remote is unreachable — the reference inherits this from gen_mqtt_client's
internal queue with ``max_queued_messages``.

A small LRU of recently-imported msg-refs stops a ``both`` rule from
re-exporting the very message it just imported (one-hop loop guard; as in
the reference, multi-broker routing loops remain the operator's prefix
discipline to avoid)."""

from __future__ import annotations

import asyncio
import logging
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..broker.message import Msg
from ..broker.queue import QueueOpts
from ..protocol import topic as T
from ..protocol.types import SubOpts

log = logging.getLogger("vernemq_tpu_torch.bridge")


class BridgeRule:
    __slots__ = ("pattern", "direction", "qos", "local_prefix", "remote_prefix")

    def __init__(self, pattern: str, direction: str = "out", qos: int = 0,
                 local_prefix: str = "", remote_prefix: str = ""):
        if direction not in ("in", "out", "both"):
            raise ValueError(f"bad bridge direction {direction!r}")
        self.pattern = T.validate_topic("subscribe", pattern)
        self.direction = direction
        self.qos = qos
        self.local_prefix = tuple(local_prefix.split("/")) if local_prefix else ()
        self.remote_prefix = tuple(remote_prefix.split("/")) if remote_prefix else ()

    @property
    def inbound(self) -> bool:
        return self.direction in ("in", "both")

    @property
    def outbound(self) -> bool:
        return self.direction in ("out", "both")


class Bridge:
    """One remote-broker link (one vmq_bridge gen_server)."""

    IMPORT_LRU = 2048

    def __init__(self, broker, name: str, host: str, port: int,
                 rules: Sequence[BridgeRule],
                 client_id: str = "", username: Optional[str] = None,
                 password: Optional[bytes] = None, cleansession: bool = False,
                 keepalive: int = 60, restart_timeout: float = 10.0,
                 max_outgoing_buffered: int = 100, proto_ver: int = 4,
                 ssl_context=None):
        self.broker = broker
        self.name = name
        self.host, self.port = host, port
        self.rules = list(rules)
        self.client_id = client_id or f"bridge-{name}"
        self.username, self.password = username, password
        self.cleansession = cleansession
        self.keepalive = keepalive
        self.restart_timeout = restart_timeout
        self.proto_ver = proto_ver
        self.ssl_context = ssl_context
        self.sid = ("", self.client_id)
        self._rc = None  # ReconnectingClient (the gen_mqtt_client seat)
        self._pump: Optional[asyncio.Task] = None
        self._out: deque = deque()
        self._max_out = max_outgoing_buffered
        self._out_wakeup = asyncio.Event()
        self._imported: "OrderedDict[bytes, None]" = OrderedDict()
        self.out_dropped = 0

    # ---------------------------------------------------------------- local

    def attach_local(self) -> None:
        """Register the bridge as a plugin subscriber on the local broker
        and subscribe its out/both patterns (bridge_subscribe(local,...),
        vmq_bridge.erl:191-224)."""
        reg = self.broker.registry
        queue, _ = reg.register_subscriber(
            self.sid, clean_start=True,
            queue_opts=QueueOpts(clean_session=True, is_plugin=True))
        queue.add_session(self, self._local_deliver)
        topics = [(list(r.pattern), SubOpts(qos=r.qos))
                  for r in self.rules if r.outbound]
        if topics:
            reg.subscribe(self.sid, topics)

    def detach_local(self) -> None:
        self.broker.registry.cleanup_subscriber(self.sid)

    def _local_deliver(self, msg: Msg) -> bool:
        """Queue-deliver callback: forward matching local publishes to the
        remote broker (the {deliver,...} clause, vmq_bridge.erl:155-171)."""
        if msg.msg_ref in self._imported:
            return True  # we just imported this one — don't bounce it back
        for rule in self.rules:
            if not rule.outbound or not T.match(list(msg.topic), list(rule.pattern)):
                continue
            if len(self._out) >= self._max_out:
                self.out_dropped += 1
                self.broker.metrics.incr("bridge_dropped")
                return True
            self._out.append((rule, msg))
            self._out_wakeup.set()
        return True

    # --------------------------------------------------------------- remote

    def start(self) -> None:
        """Link through :class:`~vernemq_tpu_torch.client.ReconnectingClient` —
        the gen_mqtt_client behaviour surface (connect/backoff/
        resubscribe/keepalive) the reference's bridge rides on
        (vmq_bridge.erl:123-137 init_client + reconnect_timeout)."""
        from ..client import ReconnectingClient

        loop = asyncio.get_event_loop()
        self._rc = ReconnectingClient(
            self.host, self.port,
            reconnect_timeout=self.restart_timeout,
            subscriptions={"/".join(r.pattern): SubOpts(qos=r.qos)
                           for r in self.rules if r.inbound},
            on_connect=self._on_link_up,
            on_disconnect=self._on_link_down,
            on_connect_error=lambda rc: self._on_link_down(
                ConnectionError(f"remote CONNACK rc={rc}")),
            on_publish=self._import_remote,
            client_id=self.client_id, proto_ver=self.proto_ver,
            clean_start=self.cleansession, username=self.username,
            password=self.password, keepalive=self.keepalive,
            ssl_context=self.ssl_context)
        self._rc.start()
        self._pump = loop.create_task(self._pump_out())

    async def stop(self) -> None:
        if self._pump is not None:
            self._pump.cancel()
            try:
                await self._pump
            except (asyncio.CancelledError, Exception):
                pass
        if self._rc is not None:
            await self._rc.stop()
        self.detach_local()

    # --------------------------------------------------------- link events

    def _on_link_up(self, session_present: bool) -> None:
        self.broker.metrics.incr("bridge_connected")
        in_topics = ["/".join(r.pattern) for r in self.rules if r.inbound]
        if in_topics:
            log.info("bridge %s subscribed remotely to %s",
                     self.name, in_topics)

    def _on_link_down(self, exc: BaseException) -> None:
        log.info("bridge %s link down: %s", self.name, exc)

    def _import_remote(self, frame) -> None:
        """Remote publish → local publish with the local prefix
        ({deliver_remote,...}, vmq_bridge.erl:138-154)."""
        words = tuple(frame.topic.split("/"))
        for rule in self.rules:
            if not rule.inbound or not T.match(list(words), list(rule.pattern)):
                continue
            msg = Msg(topic=rule.local_prefix + words,
                      payload=frame.payload,
                      qos=min(frame.qos, rule.qos),
                      retain=frame.retain)
            self._imported[msg.msg_ref] = None
            while len(self._imported) > self.IMPORT_LRU:
                self._imported.popitem(last=False)
            try:
                reg = self.broker.registry
                if reg.batched_view_active():
                    # matched on the card in arrival order, as a
                    # session's publish is, not on the host trie
                    reg.publish_nowait(msg, from_sid=self.sid)
                else:
                    reg.publish(msg, from_sid=self.sid)
                self.broker.metrics.incr("bridge_publish_in")
            except RuntimeError:
                self.broker.metrics.incr("bridge_dropped")

    async def _pump_out(self) -> None:
        """Drain the outbound buffer whenever the link is up."""
        while True:
            if not self._out:
                self._out_wakeup.clear()
                await self._out_wakeup.wait()
            await self._rc.connected.wait()
            client = self._rc.client if self._rc is not None else None
            if client is None:
                continue
            rule, msg = self._out.popleft()
            topic_str = "/".join(rule.remote_prefix + msg.topic)
            try:
                await client.publish(topic_str, msg.payload, qos=rule.qos,
                                     retain=msg.retain)
                self.broker.metrics.incr("bridge_publish_out")
            except asyncio.CancelledError:
                raise
            except Exception:
                # publish failed (ack timeout or link death): requeue the
                # head and retry. _connected is owned by _run — clearing it
                # here would deadlock the pump when the link is still up
                # (a lost PUBACK is not a reconnect)
                self._out.appendleft((rule, msg))
                await asyncio.sleep(0.5)

    # ----------------------------------------------------------------- info

    def info(self) -> Dict[str, Any]:
        """vmq-admin bridge show row (vmq_bridge:info/1)."""
        return {
            "name": self.name,
            "endpoint": f"{self.host}:{self.port}",
            "connected": (self._rc is not None
                          and self._rc.connected.is_set()),
            "buffered_out": len(self._out),
            "dropped_out": self.out_dropped,
            "rules": [f"{'/'.join(r.pattern)} {r.direction} {r.qos}"
                      for r in self.rules],
        }


class BridgePlugin:
    """Plugin wrapper owning all configured bridges (vmq_bridge_sup +
    change_config reconfiguration, vmq_bridge_sup.erl:66-96)."""

    def __init__(self, broker, bridges: Optional[List[Dict[str, Any]]] = None):
        self.broker = broker
        self.bridges: Dict[str, Bridge] = {}
        self._stop_tasks: set = set()
        for i, cfg in enumerate(bridges or broker.config.get("bridges", [])):
            self.add_bridge(cfg.get("name", f"br{i}"), cfg)

    def add_bridge(self, name: str, cfg: Dict[str, Any]) -> Bridge:
        if name in self.bridges:
            raise ValueError(f"bridge {name} already configured")
        rules = [BridgeRule(
            pattern=r["pattern"], direction=r.get("direction", "out"),
            qos=r.get("qos", 0), local_prefix=r.get("local_prefix", ""),
            remote_prefix=r.get("remote_prefix", ""))
            for r in cfg.get("topics", [])]
        b = Bridge(
            self.broker, name, cfg["host"], cfg["port"], rules,
            client_id=cfg.get("client_id", ""),
            username=cfg.get("username"),
            password=cfg.get("password"),
            cleansession=cfg.get("cleansession", False),
            keepalive=cfg.get("keepalive_interval", 60),
            restart_timeout=cfg.get("restart_timeout", 10.0),
            max_outgoing_buffered=cfg.get("max_outgoing_buffered_messages", 100),
            proto_ver=cfg.get("proto_ver", 4),
            ssl_context=cfg.get("ssl_context"))
        self.bridges[name] = b
        return b

    def register(self, hooks) -> None:
        """PluginManager seam: bridges don't hook the auth chain — they
        attach as plugin subscribers and dial out."""
        for b in self.bridges.values():
            b.attach_local()
            b.start()

    def unregister(self, hooks) -> None:
        loop = asyncio.get_event_loop()
        for b in self.bridges.values():
            # hold strong refs: the loop keeps only weak task refs, and a
            # GC'd stop task would leave the reconnect loop running
            task = loop.create_task(b.stop())
            self._stop_tasks.add(task)

            def _done(t: "asyncio.Task", name=b.name) -> None:
                self._stop_tasks.discard(t)
                if not t.cancelled() and t.exception() is not None:
                    log.error("bridge %s failed to stop", name,
                              exc_info=t.exception())

            task.add_done_callback(_done)
        self.bridges.clear()

    async def stop_all(self) -> None:
        """Awaited variant of unregister for broker shutdown: the remote
        links must actually be down before listeners are reaped."""
        for b in list(self.bridges.values()):
            await b.stop()
        self.bridges.clear()

    def show(self) -> List[Dict[str, Any]]:
        return [b.info() for b in self.bridges.values()]
