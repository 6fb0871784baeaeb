"""HTTP endpoints: Prometheus metrics, health, status, management API.

One small asyncio HTTP/1.1 server replaces the reference's cowboy
listeners; the module set per listener is configurable the way
``vmq_http_config.erl:8`` assembles a cowboy dispatch from the
``http_modules`` config:

- ``metrics`` → ``GET /metrics`` Prometheus text (vmq_metrics_http.erl:42-84)
- ``health``  → ``GET /health`` cluster+listener checks (vmq_health_http.erl)
- ``status``  → ``GET /status.json`` node/cluster stats (vmq_status_http.erl)
- ``mgmt``    → ``GET|POST /api/v1/<cmd>/<sub>?flags`` mapped onto the
  vmq-admin command tree with api-key Basic auth (vmq_http_mgmt_api.erl)
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from .commands import CommandError, CommandRegistry, register_core_commands, valid_api_key

log = logging.getLogger("vernemq_tpu_torch.http")

MAX_HEADER = 65536
DEFAULT_MODULES = ("metrics", "health", "status", "mgmt")


class HttpServer:
    def __init__(self, broker, host: str = "127.0.0.1", port: int = 8888,
                 modules: Tuple[str, ...] = DEFAULT_MODULES,
                 registry: Optional[CommandRegistry] = None,
                 ssl_context=None):
        self.broker = broker
        self.host = host
        self.port = port
        self.modules = modules
        self.registry = registry or register_core_commands(CommandRegistry())
        self.ssl_context = ssl_context
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, ssl=self.ssl_context)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self.broker._servers.append(self._server)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------- plumbing

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"), 30.0)
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        asyncio.LimitOverrunError):
                    return
                if len(head) > MAX_HEADER:
                    return
                request = head.decode("latin1")
                lines = request.split("\r\n")
                try:
                    method, target, _version = lines[0].split(" ", 2)
                except ValueError:
                    return
                headers: Dict[str, str] = {}
                for ln in lines[1:]:
                    if ":" in ln:
                        k, _, v = ln.partition(":")
                        headers[k.strip().lower()] = v.strip()
                body = b""
                clen = int(headers.get("content-length", 0) or 0)
                if clen:
                    if clen > MAX_HEADER:
                        # drain and refuse; close so the stream can't desync
                        remaining = clen
                        while remaining > 0:
                            chunk = await reader.read(min(remaining, 65536))
                            if not chunk:
                                break
                            remaining -= len(chunk)
                        writer.write(
                            b"HTTP/1.1 413 Payload Too Large\r\n"
                            b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                        await writer.drain()
                        return
                    body = await reader.readexactly(clen)
                status, ctype, payload = self._dispatch(
                    method.upper(), target, headers, body)
                keep = headers.get("connection", "").lower() != "close"
                writer.write(
                    b"HTTP/1.1 " + status.encode() + b"\r\n"
                    b"Content-Type: " + ctype.encode() + b"\r\n"
                    b"Content-Length: " + str(len(payload)).encode() + b"\r\n"
                    b"Connection: " + (b"keep-alive" if keep else b"close") +
                    b"\r\n\r\n" + payload)
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:
            log.exception("http handler crashed")
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # ------------------------------------------------------------- routing

    def _dispatch(self, method: str, target: str, headers: Dict[str, str],
                  body: bytes) -> Tuple[str, str, bytes]:
        parts = urlsplit(target)
        path = unquote(parts.path)
        qs = dict(parse_qsl(parts.query, keep_blank_values=True))
        if path == "/metrics" and "metrics" in self.modules:
            return ("200 OK", "text/plain; version=0.0.4",
                    self.broker.metrics.prometheus_text(
                        self.broker.node_name).encode())
        if path == "/health" and "health" in self.modules:
            return self._health()
        if path in ("/status", "/status.json") and "status" in self.modules:
            return ("200 OK", "application/json",
                    json.dumps(self._status()).encode())
        if path.startswith("/api/v1/") and "mgmt" in self.modules:
            return self._mgmt(path[len("/api/v1/"):], qs, headers)
        if path.startswith("/api/v1") and "mgmt" in self.modules:
            return self._mgmt("", qs, headers)
        return ("404 Not Found", "text/plain", b"not found\n")

    def _health(self) -> Tuple[str, str, bytes]:
        """OK when the cluster is ready and listeners are up
        (vmq_health_http.erl:30-60)."""
        problems: List[str] = []
        if not self.broker.cluster_ready():
            problems.append("cluster_not_ready")
        if problems:
            return ("503 Service Unavailable", "application/json",
                    json.dumps({"status": "DOWN", "problems": problems}).encode())
        return ("200 OK", "application/json",
                json.dumps({"status": "OK"}).encode())

    def _status(self) -> Dict[str, Any]:
        b = self.broker
        nodes = [{"node": b.node_name, "running": True}]
        if b.cluster is not None:
            nodes = [{"node": n, "running": up} for n, up in b.cluster.status()]
        m = b.metrics.all_metrics()
        return {
            "node": b.node_name,
            "ready": b.cluster_ready(),
            "nodes": nodes,
            "active_sessions": m.get("active_sessions", 0),
            "router_subscriptions": m.get("router_subscriptions", 0),
            "retain_messages": m.get("retain_messages", 0),
            "publish_received": m.get("mqtt_publish_received", 0),
            "publish_sent": m.get("mqtt_publish_sent", 0),
            **({"sysmon": b.sysmon.status()} if b.sysmon is not None else {}),
        }

    # ----------------------------------------------------------- mgmt API

    def _authorized(self, headers: Dict[str, str], qs: Dict[str, str]) -> bool:
        if not self.broker.config.get("http_mgmt_api_auth", True):
            return True
        key = qs.get("api_key")
        auth = headers.get("authorization", "")
        if key is None and auth.lower().startswith("basic "):
            try:
                decoded = base64.b64decode(auth[6:]).decode()
                key = decoded.partition(":")[0]
            except Exception:
                key = None
        return key is not None and valid_api_key(self.broker, key)

    def _mgmt(self, cmd_path: str, qs: Dict[str, str],
              headers: Dict[str, str]) -> Tuple[str, str, bytes]:
        if not self._authorized(headers, qs):
            return ("401 Unauthorized", "application/json",
                    json.dumps({"error": "unauthorized"}).encode())
        words = [w for w in cmd_path.split("/") if w]
        words += [f"{k}={v}" if v != "" else k for k, v in qs.items()
                  if k != "api_key"]
        try:
            result = self.registry.run(self.broker, words)
        except CommandError as e:
            return ("400 Bad Request", "application/json",
                    json.dumps({"error": e.message, "usage": e.usage}).encode())
        except Exception as e:  # command crashed
            log.exception("mgmt command failed: %s", words)
            return ("500 Internal Server Error", "application/json",
                    json.dumps({"error": str(e)}).encode())
        if isinstance(result, dict) and "table" in result:
            payload = {"type": "table", "table": result["table"]}
        else:
            payload = {"type": "text", "text": result}
        return ("200 OK", "application/json",
                json.dumps(payload, default=str).encode())
