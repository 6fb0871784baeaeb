"""Runtime listener management (``vmq_ranch_config.erl``).

Listener kinds map to transports exactly like the reference
(``vmq_ranch_config.erl:224-227``): ``mqtt``/``mqtts`` plain and TLS MQTT,
``ws``/``wss`` (the reference's ``mqttws``/``mqttwss``) WebSocket MQTT,
``http``/``https`` the admin endpoints, ``vmq``/``vmqs`` the cluster
data-plane channel. Listeners can be started/stopped/reconfigured at
runtime via ``vmq-admin listener ...``."""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger("vernemq_tpu_torch.listeners")

KINDS = ("mqtt", "mqtts", "ws", "wss", "http", "https", "vmq", "vmqs")
# accept the reference's own names too
ALIASES = {"mqttws": "ws", "mqttwss": "wss"}


class ListenerManager:
    def __init__(self, broker):
        self.broker = broker
        broker.listeners = self
        # (addr, port) -> {"kind":…, "server":…, "opts":…}
        self._listeners: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._start_tasks: List[asyncio.Task] = []

    # ------------------------------------------------------------- lifecycle

    async def start_listener(self, kind: str, addr: str, port: int,
                             opts: Optional[Dict[str, Any]] = None):
        """Start one listener; returns the server object. ``opts`` follows
        the reference listener schema (max_connections is advisory here;
        TLS opts per make_server_context; ``mountpoint`` for multitenancy)."""
        kind = ALIASES.get(kind, kind)
        if kind not in KINDS:
            raise ValueError(f"unknown listener kind {kind!r}")
        # fault-injection point: a simulated bind failure (EADDRINUSE,
        # EMFILE, ...) — the watchdog's rebind-retry path is exercised
        # by tests/test_restart_storm.py through this hook. Async
        # variant: latency faults must not block the event loop.
        from ..robustness import faults

        await faults.inject_async("listener.bind")
        opts = dict(opts or {})
        ssl_context = None
        if kind in ("mqtts", "wss", "https", "vmqs"):
            from .ssl_util import make_server_context

            ssl_context = make_server_context(opts)
        server: Any
        if kind in ("mqtt", "mqtts"):
            from .server import MQTTServer

            server = MQTTServer(
                self.broker, addr, port,
                max_frame_size=int(opts.get("max_frame_size", 0) or 0),
                ssl_context=ssl_context,
                proxy_protocol=bool(opts.get("proxy_protocol")),
                use_identity_as_username=bool(
                    opts.get("use_identity_as_username")),
                mountpoint=str(opts.get("mountpoint", "")),
                allowed_protocol_versions=opts.get(
                    "allowed_protocol_versions"),
                max_connections=int(opts.get("max_connections", 0) or 0),
                reuse_port=bool(opts.get("reuse_port")))
            await server.start()
            port = server.port
        elif kind in ("ws", "wss"):
            from .websocket import WebSocketServer

            server = WebSocketServer(
                self.broker, addr, port, ssl_context=ssl_context,
                max_frame_size=int(opts.get("max_frame_size", 0) or 0),
                use_identity_as_username=bool(
                    opts.get("use_identity_as_username")),
                mountpoint=str(opts.get("mountpoint", "")),
                allowed_protocol_versions=opts.get(
                    "allowed_protocol_versions"),
                max_connections=int(opts.get("max_connections", 0) or 0),
                reuse_port=bool(opts.get("reuse_port")))
            await server.start()
            port = server.port
        elif kind in ("http", "https"):
            from ..admin.http import DEFAULT_MODULES, HttpServer

            modules = opts.get("http_modules") or DEFAULT_MODULES
            server = HttpServer(self.broker, addr, port,
                                modules=tuple(modules),
                                ssl_context=ssl_context)
            await server.start()
            port = server.port
        else:  # vmq / vmqs — the cluster data-plane listener
            if self.broker.cluster is not None:
                # stop_listener schedules Cluster.stop() as a task; a
                # stop-then-start sequence must wait for that detach
                # instead of refusing against the half-stopped cluster.
                # Never gather OURSELVES: an admin `listener start` runs
                # inside a tracked task, and awaiting it here would
                # deadlock the listener manager permanently.
                cur = asyncio.current_task()
                pending = [t for t in self._start_tasks
                           if not t.done() and t is not cur]
                if pending:
                    await asyncio.gather(*pending, return_exceptions=True)
            if self.broker.cluster is None:
                from ..cluster import Cluster

                cluster = Cluster(self.broker, addr, port)
                try:
                    await cluster.start()
                except BaseException:
                    # __init__ attached broker.cluster/metadata hooks; a
                    # failed bind (stolen port, moved cert) must detach or
                    # every later start hits 'already running' forever
                    await cluster.stop()
                    raise
                server = cluster
                port = cluster.listen_port
            else:
                raise ValueError("cluster listener already running")
        self._listeners[(addr, port)] = {
            "kind": kind, "server": server, "opts": opts,
            "ssl_context": ssl_context,
        }
        log.info("started %s listener on %s:%d", kind, addr, port)
        return server

    def listener_records(self) -> List[Dict[str, Any]]:
        """Raw listener records (kind/server/opts/ssl_context) — consumed
        by the CRL refresher and introspection."""
        return list(self._listeners.values())

    def stop_listener(self, addr: str, port: int) -> None:
        """Stop accepting on a listener but KEEP its configuration so
        ``restart`` can bring it back (vmq_ranch_config suspend/resume
        split between listener stop and listener delete)."""
        entry = self._listeners.get((addr, port))
        if entry is None:
            raise KeyError(f"no listener on {addr}:{port}")
        server = entry["server"]
        entry["server"] = None  # stopped; opts/kind retained for restart
        stop = getattr(server, "stop", None) if server is not None else None
        if stop is not None:
            task = asyncio.get_event_loop().create_task(stop())
            self._track(task)

    def delete_listener(self, addr: str, port: int) -> None:
        """Stop (if running) and forget the listener entirely."""
        if (addr, port) in self._listeners:
            self.stop_listener(addr, port)
        self._listeners.pop((addr, port), None)

    async def restart_listener(self, addr: str, port: int):
        """Stop-and-start with the retained kind/opts (listener restart).
        A fixed port is required: a port-0 listener's bound port is its
        identity, and rebinding 0 would mint a different one."""
        entry = self._listeners.get((addr, port))
        if entry is None:
            raise KeyError(f"no listener on {addr}:{port}")
        if entry["server"] is not None:
            server = entry["server"]
            entry["server"] = None
            stop = getattr(server, "stop", None)
            if stop is not None:
                await stop()
        # the record stays until the new server is up: a failed start
        # (moved cert, stolen port) must leave the listener stopped and
        # RESTARTABLE, never erase its configuration. start_listener
        # overwrites the record on success.
        return await self.start_listener(entry["kind"], addr, port,
                                         entry["opts"])

    async def stop_all(self) -> None:
        for addr, port in list(self._listeners):
            try:
                self.delete_listener(addr, port)
            except KeyError:
                pass
        for t in self._start_tasks:
            try:
                await t
            except Exception:
                pass
        self._start_tasks.clear()

    def _track(self, task: asyncio.Task) -> None:
        """Retain a pending stop/start task (pruning finished ones — a
        long-lived broker restarts listeners indefinitely)."""
        self._start_tasks = [t for t in self._start_tasks if not t.done()]
        self._start_tasks.append(task)

    def track_start_task(self, task: asyncio.Task) -> None:
        """Keep a handle on listener starts launched from sync command
        context so failures surface in logs."""
        def _done(t: asyncio.Task) -> None:
            if not t.cancelled() and t.exception() is not None:
                log.error("listener start failed", exc_info=t.exception())

        task.add_done_callback(_done)
        self._track(task)

    # ---------------------------------------------------------------- admin

    def show(self) -> List[Dict[str, Any]]:
        rows = []
        for (addr, port), entry in sorted(self._listeners.items()):
            rows.append({
                "type": entry["kind"], "address": addr, "port": port,
                "mountpoint": entry["opts"].get("mountpoint", ""),
                "status": ("running" if entry["server"] is not None
                           else "stopped"),
            })
        return rows
