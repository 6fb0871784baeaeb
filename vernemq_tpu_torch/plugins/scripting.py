"""Script-driven plugins: operator-provided scripts exposing the full
auth/lifecycle hook surface, with an ACL cache so per-publish authorization
does not re-enter the script.

Plays the role of ``vmq_diversity`` (4.6k LoC): the reference embeds a Lua
interpreter (luerl) and hands Lua scripts the hook surface plus datastore
connectors (``vmq_diversity_plugin.erl:18-50``), a per-script KV store
(``vmq_diversity_ets.erl``), and an auth/ACL cache
(``vmq_diversity_cache.erl``) so ``auth_on_publish``/``auth_on_subscribe``
hit cached ACLs instead of the datastore. Two script engines share this
machinery, selected by file extension: ``.lua`` runs on the in-tree Lua
5.1 interpreter (``utils/lua.py`` + ``plugins/lua_bridge.py`` — the
reference's script language, including its bundled-auth-script shapes and
datastore modules), anything else as a plain Python file exec'd with the
helper namespace below — same trust model either way (operator-provided
scripts run in-process with broker privileges).

Script surface (any subset):

- ``auth_on_register(peer, sid, username, password, clean_start)``
- ``auth_on_publish(username, sid, qos, topic, payload, retain)``
- ``auth_on_subscribe(username, sid, topics)``
- the ``_m5`` variants, ``on_auth_m5(sid, method, data)``
- lifecycle: ``on_register``, ``on_publish``, ``on_subscribe``,
  ``on_unsubscribe``, ``on_deliver``, ``on_offline_message``,
  ``on_client_wakeup``, ``on_client_offline``, ``on_client_gone``,
  ``on_message_drop``

Injected helpers:

- ``kv``: per-script dict-backed store (vmq_diversity_ets role)
- ``cache``: the ACL cache — ``cache.insert(mountpoint, client_id,
  username, publish=[...], subscribe=[...])`` from ``auth_on_register``;
  ``%u``/``%c`` in patterns substitute username/client-id at insert
  (vmq_diversity_cache.erl)
- ``log``: a logger
- ``topic``: the topic algebra module (match/validate)

Datastore connectors: pure-Python wire-protocol clients for redis,
memcached and postgres ship in ``plugins/connectors.py`` (the reference's
bundled eredis/mcd/epgsql pools); Lua scripts reach them as the
``redis``/``memcached``/``postgres`` modules, Python scripts can import
them directly. mysql/mongodb keep the module surface but report
"driver not built in".
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..broker.plugins import HookError
from ..protocol import topic as T

log = logging.getLogger("vernemq_tpu_torch.scripting")

#: every hook a script may implement (the vernemq_dev hook behaviours)
SCRIPT_HOOKS = (
    "auth_on_register", "auth_on_publish", "auth_on_subscribe",
    "auth_on_register_m5", "auth_on_publish_m5", "auth_on_subscribe_m5",
    "on_auth_m5",
    "on_register", "on_publish", "on_subscribe", "on_unsubscribe",
    "on_deliver", "on_offline_message", "on_client_wakeup",
    "on_client_offline", "on_client_gone", "on_message_drop",
)


class AclCache:
    """Per-subscriber cached ACLs (vmq_diversity_cache.erl): populated by
    a successful ``auth_on_register``, consulted by the publish/subscribe
    auth hooks without re-entering the script."""

    def __init__(self) -> None:
        self._entries: Dict[Tuple[str, str], Dict[str, List[Any]]] = {}

    @staticmethod
    def _expand(pattern: str, username: Optional[str], client_id: str) -> List[str]:
        """%u/%c substitution at insert time (mosquitto-style, as the
        reference's Lua cache does)."""
        out = pattern
        if username is not None:
            out = out.replace("%u", username)
        out = out.replace("%c", client_id)
        return out.split("/")

    def insert(self, mountpoint: str, client_id: str,
               username: Optional[str],
               publish: Sequence[Any] = (),
               subscribe: Sequence[Any] = ()) -> None:
        def norm(acls):
            normed = []
            for a in acls:
                if isinstance(a, str):
                    normed.append((self._expand(a, username, client_id), {}))
                else:  # {"pattern": ..., **modifiers}
                    a = dict(a)
                    normed.append((self._expand(a.pop("pattern"), username,
                                                client_id), a))
            return normed

        self._entries[(mountpoint, client_id)] = {
            "publish": norm(publish), "subscribe": norm(subscribe)}

    def remove(self, mountpoint: str, client_id: str) -> None:
        self._entries.pop((mountpoint, client_id), None)

    def lookup(self, sid, kind: str, topic: Sequence[str]) -> Optional[Tuple[bool, Dict]]:
        """None = no entry for this client (fall through to scripts);
        (True, modifiers) = allowed; (False, {}) = cached ACL says no."""
        entry = self._entries.get((sid[0], sid[1]))
        if entry is None:
            return None
        for pattern, modifiers in entry[kind]:
            if T.match(list(topic), pattern):
                return True, modifiers
        return False, {}

    def __len__(self) -> int:
        return len(self._entries)


class HttpConnector:
    """Minimal HTTP client for auth scripts (vmq_diversity's hackney
    pool seat): get/post_json with a hard timeout, JSON decoding, no
    redirects. Kept deliberately tiny — scripts needing more roll their
    own with the stdlib."""

    def __init__(self, timeout: float = 2.0):
        self.timeout = timeout

    def _req(self, method, url, body=None, headers=None):
        import json as _json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(url, data=body, method=method,
                                     headers=dict(headers or {}))

        def package(status, data):
            try:
                j = _json.loads(data) if data[:1] in (b"{", b"[") else None
            except ValueError:
                j = None
            return {"status": status, "body": data, "json": j}

        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return package(resp.status, resp.read())
        except urllib.error.HTTPError as e:
            # non-2xx is a REAL response (401 from an auth backend is a
            # credential verdict, not an outage) — keep status + body
            return package(e.code, e.read())
        except Exception as e:  # network failure: status 0
            return {"status": 0, "body": b"", "json": None,
                    "error": str(e)}

    def get(self, url, headers=None):
        return self._req("GET", url, None, headers)

    def post_json(self, url, obj, headers=None):
        import json as _json

        h = {"Content-Type": "application/json"}
        h.update(headers or {})
        return self._req("POST", url, _json.dumps(obj).encode(), h)


class Script:
    """One loaded script file (one vmq_diversity script state)."""

    def __init__(self, path: str, plugin: "ScriptingPlugin"):
        self.path = path
        self.plugin = plugin
        self.kv: Dict[Any, Any] = {}
        self.hooks: Dict[str, Any] = {}
        self.load()

    def load(self) -> None:
        with open(self.path) as f:
            src = f.read()
        from ..native import bcrypt as _bcrypt

        ns: Dict[str, Any] = {
            "kv": self.kv,
            "cache": self.plugin.cache,
            "log": logging.getLogger(f"vernemq_tpu_torch.script.{self.path}"),
            "topic": T,
            # bcrypt helpers (vmq_diversity's bcrypt dep,
            # vmq_diversity_bcrypt.erl): auth scripts verify datastore
            # password hashes with bcrypt.checkpw / create with hashpw
            "bcrypt": _bcrypt,
            # http connector (the hackney seat of vmq_diversity): auth
            # scripts talk to REST auth backends; blocking with a short
            # timeout — the reference's Lua pools block a worker the same
            # way. Datastore wire clients (redis/memcached/postgres) live
            # in plugins/connectors.py for scripts that want them.
            "http": HttpConnector(),
        }
        exec(compile(src, self.path, "exec"), ns)
        self.hooks = {h: ns[h] for h in SCRIPT_HOOKS if callable(ns.get(h))}


class ScriptingPlugin:
    """The vmq_diversity equivalent: loads scripts, registers their hooks,
    fronts publish/subscribe auth with the ACL cache."""

    def __init__(self, broker, scripts: Optional[Sequence[str]] = None):
        self.broker = broker
        self.cache = AclCache()
        self.scripts: Dict[str, Script] = {}
        self._registered: List[Tuple[str, Any]] = []
        # per-script hook registrations so `script unload` can retract
        # exactly one script's handlers (vmq_diversity_cli unload)
        self._script_hooks: Dict[str, List[Tuple[str, Any]]] = {}
        self._hookreg = None  # set by register(); None until enabled
        for path in (scripts or broker.config.get("diversity_scripts", [])):
            self.load_script(path)

    # ------------------------------------------------------------- scripts

    def load_script(self, path: str):
        """Engine by extension: ``.lua`` runs on the in-tree Lua
        interpreter (utils/lua.py via lua_bridge — the reference's
        native script language), anything else as a Python script."""
        if path in self.scripts and self._script_hooks.get(path):
            # re-load of a live path: retract the old script's handlers
            # first or every hook would fire twice (once per generation)
            self.unload_script(path)
        if path.endswith(".lua"):
            from .lua_bridge import LuaScript

            s = LuaScript(path, self)
        else:
            s = Script(path, self)
        self.scripts[path] = s
        if self._hookreg is not None:
            # loaded into a LIVE plugin (vmq-admin script load): its
            # hooks must take effect now, not at the next enable
            self._register_script_hooks(self._hookreg, s)
        return s

    def reload_script(self, path: str) -> None:
        """vmq-admin script reload path=... (vmq_diversity_cli)."""
        self.scripts[path].load()

    def unload_script(self, path: str) -> None:
        """vmq-admin script unload path=...: retract this script's hook
        handlers and forget it (vmq_diversity_cli unload)."""
        self.scripts.pop(path)
        for name, fn in self._script_hooks.pop(path, []):
            if self._hookreg is not None:
                self._hookreg.unregister(name, fn)
            if (name, fn) in self._registered:
                self._registered.remove((name, fn))

    # ----------------------------------------------------------- hook glue

    def register(self, hooks) -> None:
        # the cache front-ends the script chain: a cached entry answers
        # authoritatively, no entry falls through ("next") to the scripts
        for hook_name, kind in (("auth_on_publish", "publish"),
                                ("auth_on_publish_m5", "publish"),
                                ("auth_on_subscribe", "subscribe"),
                                ("auth_on_subscribe_m5", "subscribe")):
            fn = self._make_cache_hook(kind, subscribe="subscribe" in hook_name)
            # priority 0 + registration-before-the-scripts: the cache
            # answers ahead of THIS plugin's script hooks (same-priority
            # order is insertion order) but does NOT preempt other plugins
            # enabled earlier — plugin enable order stays the operator's
            # chain order, as in the reference
            hooks.register(hook_name, fn)
            self._registered.append((hook_name, fn))
        # cache invalidation: the entry dies with the session's queue so
        # the cache cannot grow past live subscribers (the reference's
        # vmq_diversity_cache clears on client-gone)
        hooks.register("on_client_gone", self._on_client_gone)
        self._registered.append(("on_client_gone", self._on_client_gone))
        self._hookreg = hooks
        for script in self.scripts.values():
            self._register_script_hooks(hooks, script)

    def _register_script_hooks(self, hooks, script) -> None:
        regs = self._script_hooks.setdefault(script.path, [])
        for name in script.hooks:
            wrapped = self._wrap(script, name)
            hooks.register(name, wrapped)
            self._registered.append((name, wrapped))
            regs.append((name, wrapped))

    def unregister(self, hooks) -> None:
        for name, fn in self._registered:
            hooks.unregister(name, fn)
        self._registered.clear()

    def _make_cache_hook(self, kind: str, subscribe: bool):
        if not subscribe:
            def cache_pub(username, sid, qos, topic, payload, retain):
                res = self.cache.lookup(sid, kind, topic)
                if res is None:
                    return "next"
                allowed, modifiers = res
                if not allowed:
                    return ("error", "not_authorized")
                return ("ok", modifiers) if modifiers else "ok"

            return cache_pub

        def cache_sub(username, sid, topics):
            if not topics:
                return "next"
            res_all = []
            for words, qos in topics:
                res = self.cache.lookup(sid, kind, words)
                if res is None:
                    return "next"  # no cached ACLs for this client at all
                allowed, _ = res
                res_all.append((list(words), qos if allowed else 128))
            return ("ok", res_all)

        return cache_sub

    def _on_client_gone(self, sid) -> None:
        self.cache.remove(sid[0], sid[1])

    def _wrap(self, script: Script, name: str):
        # resolve through script.hooks at call time so reload_script takes
        # effect without re-registering (hook bodies swap; the set of hooks
        # a script exports is fixed at enable time)
        auth = name.startswith("auth_") or name == "on_auth_m5"

        def call(*args):
            fn = script.hooks.get(name)
            if fn is None:
                return "next"
            try:
                return fn(*args)
            except HookError:
                raise
            except Exception as e:
                log.exception("script %s hook %s failed", script.path, name)
                if auth:
                    return ("error", f"script_error: {e}")
                return None

        if auth:
            # auth hooks may block on a datastore (the http connector):
            # run them in the executor so a slow backend stalls one
            # worker, not the whole event loop (the reference's Lua pool
            # blocks a poolboy worker the same way). The auth chain
            # already awaits handlers, so an async wrapper slots in.
            import asyncio
            import functools

            async def wrapped(*args):
                loop = asyncio.get_event_loop()
                return await loop.run_in_executor(
                    None, functools.partial(call, *args))
        else:
            wrapped = call

        wrapped.__name__ = f"{name}@{script.path}"
        return wrapped

    # -------------------------------------------------------------- ops

    def show(self) -> List[Dict[str, Any]]:
        return [{"script": p, "hooks": sorted(s.hooks)}
                for p, s in self.scripts.items()]

    def stats(self) -> Dict[str, int]:
        return {"scripts": len(self.scripts), "cached_acls": len(self.cache)}
