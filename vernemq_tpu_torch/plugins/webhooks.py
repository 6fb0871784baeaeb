"""Webhooks plugin: forward broker hooks to HTTP endpoints as JSON.

Mirrors ``apps/vmq_webhooks``: every auth/lifecycle hook can be registered
to one or more HTTP endpoints; the broker POSTs a JSON document with a
``vernemq-hook: <name>`` header (``vmq_webhooks_plugin.erl:572-576``); the
response body carries ``{"result": "ok" | "next" | {"error": ...},
"modifiers": {...}}`` (``:648-678``); auth_on_register/publish/subscribe
responses are cached per (endpoint, hook, args-sans-payload) with a TTL
taken from the response's ``cache-control: max-age`` header
(``:550-568``, ``vmq_webhooks_cache.erl``). Payloads can be base64-coded
via the endpoint's ``base64_payload`` option.

The HTTP client is a minimal asyncio HTTP/1.1 POST with per-endpoint
connection reuse (the reference uses a hackney pool per endpoint).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import time
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ..broker.plugins import NEXT, OK

log = logging.getLogger("vernemq_tpu_torch.webhooks")

AUTH_HOOKS = {
    "auth_on_register", "auth_on_publish", "auth_on_subscribe",
    "auth_on_register_m5", "auth_on_publish_m5", "auth_on_subscribe_m5",
}
ALL_TILL_OK_HOOKS = AUTH_HOOKS | {
    "on_unsubscribe", "on_unsubscribe_m5", "on_deliver", "on_deliver_m5",
    "on_auth_m5",
}
ALL_HOOKS = ALL_TILL_OK_HOOKS | {
    "on_register", "on_publish", "on_subscribe", "on_offline_message",
    "on_client_wakeup", "on_client_offline", "on_client_gone",
    "on_register_m5", "on_publish_m5", "on_subscribe_m5",
}


class _HttpClient:
    """Tiny keep-alive HTTP/1.1 POST client (hackney-pool stand-in)."""

    def __init__(self, timeout: float = 5.0):
        self.timeout = timeout
        self._conns: Dict[Tuple[str, int], Tuple[Any, Any]] = {}

    async def post(self, url: str, headers: Dict[str, str], body: bytes
                   ) -> Tuple[int, Dict[str, str], bytes]:
        u = urlparse(url)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"unsupported webhook scheme {u.scheme!r}")
        tls = u.scheme == "https"
        host = u.hostname or "localhost"
        port = u.port or (443 if tls else 80)
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        for attempt in (0, 1):  # one retry on a stale kept-alive socket
            conn = self._conns.pop((host, port), None)
            fresh = conn is None
            if fresh:
                import ssl as _ssl

                conn = await asyncio.wait_for(
                    asyncio.open_connection(
                        host, port,
                        ssl=_ssl.create_default_context() if tls else None),
                    self.timeout)
            reader, writer = conn
            try:
                head = (f"POST {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                        f"Content-Length: {len(body)}\r\n")
                for k, v in headers.items():
                    head += f"{k}: {v}\r\n"
                writer.write(head.encode() + b"\r\n" + body)
                await writer.drain()
                status_line = await asyncio.wait_for(
                    reader.readline(), self.timeout)
                if not status_line:
                    raise ConnectionResetError("empty response")
                status = int(status_line.split()[1])
                resp_headers: Dict[str, str] = {}
                while True:
                    line = await asyncio.wait_for(reader.readline(), self.timeout)
                    line = line.strip()
                    if not line:
                        break
                    k, _, v = line.decode().partition(":")
                    resp_headers[k.strip().lower()] = v.strip()
                clen = int(resp_headers.get("content-length", "0"))
                resp_body = await asyncio.wait_for(
                    reader.readexactly(clen), self.timeout) if clen else b""
                if (resp_headers.get("connection", "").lower() != "close"
                        and (host, port) not in self._conns):
                    self._conns[(host, port)] = (reader, writer)
                else:
                    writer.close()
                return status, resp_headers, resp_body
            except (ConnectionError, asyncio.IncompleteReadError):
                writer.close()
                if fresh or attempt == 1:
                    raise
            except asyncio.TimeoutError:
                writer.close()  # a timed-out socket is never pooled again
                raise
        raise ConnectionError("unreachable")

    def close(self) -> None:
        for _, writer in self._conns.values():
            writer.close()
        self._conns.clear()


class _Cache:
    """(endpoint, hook, key) -> (expiry_ts, modifiers)
    (vmq_webhooks_cache.erl; payload/port excluded from the key)."""

    def __init__(self) -> None:
        self._data: Dict[Tuple[str, str, str], Tuple[float, Any]] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(args: Dict[str, Any]) -> str:
        slim = {k: v for k, v in args.items() if k not in ("payload", "port")}
        return json.dumps(slim, sort_keys=True, default=str)

    def lookup(self, endpoint: str, hook: str, args: Dict[str, Any]):
        entry = self._data.get((endpoint, hook, self.key(args)))
        if entry is None:
            self.misses += 1
            return None
        expiry, mods = entry
        if expiry < time.monotonic():
            del self._data[(endpoint, hook, self.key(args))]
            self.misses += 1
            return None
        self.hits += 1
        return mods

    MAX_ENTRIES = 10_000

    def insert(self, endpoint: str, hook: str, args: Dict[str, Any],
               ttl: float, mods: Any) -> None:
        if len(self._data) >= self.MAX_ENTRIES:
            # sweep expired first (the reference ages entries out); if still
            # full, drop oldest-expiring to bound memory under key churn
            now = time.monotonic()
            self._data = {k: v for k, v in self._data.items() if v[0] >= now}
            while len(self._data) >= self.MAX_ENTRIES:
                self._data.pop(min(self._data, key=lambda k: self._data[k][0]))
        self._data[(endpoint, hook, self.key(args))] = (
            time.monotonic() + ttl, mods)

    def purge(self) -> None:
        self._data.clear()


class WebhooksPlugin:
    name = "vmq_webhooks"

    def __init__(self, broker=None, timeout: float = 5.0):
        self.broker = broker
        self.http = _HttpClient(timeout=timeout)
        self.cache = _Cache()
        # hook -> [(endpoint_url, opts)]
        self.endpoints: Dict[str, List[Tuple[str, Dict[str, Any]]]] = {}
        self._registered: Dict[str, Any] = {}
        self._hooks = None  # the broker HookRegistry once register()ed

    # -- endpoint management (vmq-admin webhooks register/deregister) ------

    def register_endpoint(self, hook: str, endpoint: str,
                          base64_payload: bool = True) -> None:
        if hook not in ALL_HOOKS:
            raise ValueError(f"unknown webhook hook {hook!r}")
        self.endpoints.setdefault(hook, []).append(
            (endpoint, {"base64_payload": base64_payload}))
        # hooks are installed per-endpoint, not wholesale — an idle
        # vmq_webhooks adds zero hot-path cost (enable_hook,
        # vmq_webhooks_plugin.erl:152)
        if self._hooks is not None and hook not in self._registered:
            h = self._make_handler(hook)
            self._registered[hook] = h
            self._hooks.register(hook, h, priority=10)

    def deregister_endpoint(self, hook: str, endpoint: str) -> None:
        lst = self.endpoints.get(hook, [])
        self.endpoints[hook] = [(e, o) for e, o in lst if e != endpoint]
        if not self.endpoints[hook] and hook in self._registered:
            if self._hooks is not None:
                self._hooks.unregister(hook, self._registered.pop(hook))
            else:
                self._registered.pop(hook)

    def show(self) -> List[Tuple[str, str]]:
        return [(h, e) for h, lst in self.endpoints.items() for e, _ in lst]

    # -- hook plumbing -----------------------------------------------------

    def _args_for(self, hook: str, args: tuple) -> Dict[str, Any]:
        """Map broker hook args onto the reference's JSON field names
        (vmq_webhooks_plugin.erl:254-438)."""
        def sid_fields(sid):
            return {"mountpoint": sid[0], "client_id": sid[1]}

        if hook.startswith("auth_on_register") or hook.startswith("on_register"):
            if hook.startswith("auth"):
                peer, sid, username, password, clean = args[:5]
                pw = password
                if isinstance(pw, bytes):
                    pw = pw.decode("utf-8", "replace")
                return {"addr": peer[0] if peer else None,
                        "port": peer[1] if peer else None,
                        **sid_fields(sid), "username": username,
                        "password": pw, "clean_session": clean}
            peer, sid, username = args[:3]
            return {"addr": peer[0] if peer else None,
                    "port": peer[1] if peer else None,
                    **sid_fields(sid), "username": username}
        if "publish" in hook:
            username, sid, qos, topic, payload, retain = args[:6]
            return {"username": username, **sid_fields(sid), "qos": qos,
                    "topic": "/".join(topic), "payload": payload,
                    "retain": retain}
        if "subscribe" in hook and "un" not in hook:
            username, sid, topics = args[:3]
            return {"username": username, **sid_fields(sid),
                    "topics": [["/".join(w), q] for w, q in topics]}
        if "unsubscribe" in hook:
            username, sid, topics = args[:3]
            return {"username": username, **sid_fields(sid),
                    "topics": ["/".join(w) for w in topics]}
        if "deliver" in hook:
            username, sid, topic, payload = args[:4]
            return {"username": username, **sid_fields(sid),
                    "topic": "/".join(topic), "payload": payload}
        if hook == "on_auth_m5":
            sid, method, data = args[:3]
            return {**sid_fields(sid),
                    "properties": {"authentication_method": method,
                                   "authentication_data":
                                       base64.b64encode(data or b"").decode()}}
        if hook == "on_offline_message":
            sid, msg = args[:2]
            return {**sid_fields(sid), "qos": msg.qos,
                    "topic": "/".join(msg.topic), "payload": msg.payload,
                    "retain": msg.retain}
        # on_client_wakeup / offline / gone / on_message_drop
        sid = args[0]
        return sid_fields(sid) if isinstance(sid, tuple) else {"arg": repr(sid)}

    async def _call(self, hook: str, endpoint: str, opts: Dict[str, Any],
                    args: Dict[str, Any]):
        body_args = dict(args)
        payload = body_args.get("payload")
        if isinstance(payload, bytes):
            if opts.get("base64_payload", True):
                body_args["payload"] = base64.b64encode(payload).decode()
            else:
                body_args["payload"] = payload.decode("utf-8", "replace")
        body = json.dumps(body_args).encode()
        status, headers, resp = await self.http.post(
            endpoint,
            {"Content-Type": "application/json", "vernemq-hook": hook},
            body,
        )
        if status != 200:
            return ("error", f"invalid_response_code_{status}")
        try:
            decoded = json.loads(resp)
        except ValueError:
            return ("error", "received_payload_not_json")
        result = decoded.get("result")
        max_age = _parse_max_age(headers.get("cache-control"))
        if result == "ok":
            mods = decoded.get("modifiers") or {}
            if "payload" in mods and opts.get("base64_payload", True):
                mods["payload"] = base64.b64decode(mods["payload"])
            if "topic" in mods and isinstance(mods["topic"], str):
                # JSON carries slash-joined topics; the broker expects word
                # lists (normalize_modifiers, vmq_webhooks_plugin.erl:709-746)
                mods["topic"] = mods["topic"].split("/")
            if hook in ("auth_on_subscribe", "auth_on_subscribe_m5",
                        "on_unsubscribe", "on_unsubscribe_m5"):
                raw = decoded.get("topics", mods if isinstance(mods, list) else [])
                if raw and isinstance(raw[0], list) and len(raw[0]) == 2:
                    mods = [(t.split("/"), q) for t, q in raw]
                else:
                    mods = [t.split("/") for t in raw]
            if hook in AUTH_HOOKS and max_age:
                self.cache.insert(endpoint, hook, args, max_age, mods)
            return ("ok", mods) if mods else OK
        if result == "next":
            return NEXT
        if isinstance(result, dict):
            return ("error", result.get("error", "unknown_error"))
        return NEXT

    def _make_handler(self, hook: str):
        if hook in ALL_TILL_OK_HOOKS:
            async def handler(*args):
                for endpoint, opts in self.endpoints.get(hook, []):
                    jargs = self._args_for(hook, args)
                    if hook in AUTH_HOOKS:
                        cached = self.cache.lookup(endpoint, hook, jargs)
                        if cached is not None:
                            return ("ok", cached) if cached else OK
                    try:
                        res = await self._call(hook, endpoint, opts, jargs)
                    except (OSError, asyncio.TimeoutError) as e:
                        log.error("webhook %s -> %s failed: %s", hook, endpoint, e)
                        continue
                    if res != NEXT:
                        if isinstance(res, tuple) and res[0] == "error":
                            return res
                        return res
                return NEXT
        else:
            async def handler(*args):
                for endpoint, opts in self.endpoints.get(hook, []):
                    try:
                        await self._call(hook, endpoint, opts,
                                         self._args_for(hook, args))
                    except (OSError, asyncio.TimeoutError) as e:
                        log.error("webhook %s -> %s failed: %s", hook, endpoint, e)
                return None
        handler.__name__ = f"webhook_{hook}"
        return handler

    def register(self, hooks) -> None:
        self._hooks = hooks
        for hook in sorted(self.endpoints):
            if self.endpoints[hook] and hook not in self._registered:
                h = self._make_handler(hook)
                self._registered[hook] = h
                hooks.register(hook, h, priority=10)

    def unregister(self, hooks) -> None:
        for hook, h in self._registered.items():
            hooks.unregister(hook, h)
        self._registered.clear()
        self._hooks = None
        self.http.close()


def _parse_max_age(cache_control: Optional[str]) -> Optional[float]:
    if not cache_control:
        return None
    for part in cache_control.split(","):
        k, _, v = part.strip().partition("=")
        if k == "max-age":
            try:
                return float(v)
            except ValueError:
                return None
    return None
