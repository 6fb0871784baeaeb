"""Lua script bridge — runs operator Lua scripts on the broker's hook
surface, completing the ``vmq_diversity`` seat.

The reference embeds the luerl VM and hands every Lua script the hook
API + datastore modules (``vmq_diversity_plugin.erl:18-50``); its hook
calling convention passes ONE table of named fields per hook
(``vmq_diversity_plugin.erl:202-348``: ``auth_on_register`` gets
``{addr, port, mountpoint, client_id, username, password,
clean_session}`` etc.) and interprets returns as
true → ok / false → not_authorized / table → modifiers.

This bridge mirrors that exactly on top of the in-tree Lua interpreter
(``utils/lua.py``): :class:`LuaScript` quacks like ``scripting.Script``
(same ``hooks`` dict of Python callables), so the existing
:class:`~vernemq_tpu_torch.plugins.scripting.ScriptingPlugin` machinery — ACL
cache front-ending, executor offload for auth hooks, reload — drives
Lua and Python scripts identically; ``load_script`` picks the engine by
file extension.

Injected Lua modules (the vmq_diversity script surface):

- ``json.encode/decode``
- ``auth_cache.insert(mp, client_id, username, publish_acl,
  subscribe_acl)`` — ACL arrays of ``{pattern=..., [modifiers]}``
- ``kv.insert/lookup/delete/delete_all`` — per-script store
  (``vmq_diversity_ets`` seat)
- ``http.get/post_json``
- ``bcrypt.hashpw/checkpw/gensalt`` (native bcrypt)
- ``redis.ensure_pool/cmd``, ``memcached.ensure_pool/get/set/delete``,
  ``postgres.ensure_pool/execute``, ``mysql.ensure_pool/execute/
  hash_method``, ``mongodb.ensure_pool/find_one/command`` — pure-Python
  wire-protocol clients (``plugins/connectors.py``), covering every
  datastore the reference bundles a driver for
- ``log.info/warning/error/debug``

``require "auth/auth_commons"`` resolves to the bundled commons module
(``plugins/lua/auth_commons.lua`` — a fresh implementation of the
documented commons API), then to files next to the operator's script.
"""

from __future__ import annotations

import json as _json
import logging
import os
from typing import Any, Callable, Dict, List, Optional

from ..protocol import topic as T
from ..utils.lua import (LuaError, LuaRuntime, LuaTable, from_lua, to_lua)
from .scripting import SCRIPT_HOOKS

log = logging.getLogger("vernemq_tpu_torch.lua")

_BUILTIN_DIR = os.path.join(os.path.dirname(__file__), "lua")


def _topic_str(words) -> str:
    return "/".join(words)


class LuaScript:
    """One loaded Lua script (mirrors ``scripting.Script``) backed by a
    POOL of interpreter states.

    The reference runs ``num_states`` luerl states per script behind a
    balancing supervisor (``vmq_diversity_script_sup_sup.erl``) because
    auth hooks block on datastores; one shared state would serialise
    every concurrent hook (and the interpreter's step/depth accounting
    is per-state). Same here: each state executes the script once (pool
    declarations are idempotent by pool_id) and hook calls check a free
    state out, run, and return it. ``self.runtime`` stays the first
    state for introspection (script reload marker checks etc.); the
    per-script ``kv`` store and the ACL cache are plugin-level objects
    shared across states, like the reference's ets tables."""

    def __init__(self, path: str, plugin, num_states: Optional[int] = None) -> None:
        import queue

        self.path = path
        self.plugin = plugin
        self.kv: Dict[str, Dict[Any, Any]] = {}
        self.hooks: Dict[str, Callable] = {}
        self.runtime: Optional[LuaRuntime] = None
        if num_states is None:
            cfg = getattr(plugin.broker, "config", None)
            try:
                num_states = int(cfg.get("diversity_num_states", 4))
            except (TypeError, ValueError, AttributeError):
                num_states = 4
        self.num_states = max(1, int(num_states))
        self._free: "queue.Queue" = queue.Queue()
        self.load()

    # ------------------------------------------------------------- loading

    def _chunk_loader(self, name: str) -> Optional[str]:
        """require() resolution: bundled modules first (the reference
        resolves its own priv/ modules the same way), then files next to
        the operator's script."""
        rel = name if name.endswith(".lua") else name + ".lua"
        candidates = [
            os.path.join(_BUILTIN_DIR, os.path.basename(rel)),
            os.path.join(os.path.dirname(os.path.abspath(self.path)), rel),
            os.path.join(os.path.dirname(os.path.abspath(self.path)),
                         os.path.basename(rel)),
        ]
        for c in candidates:
            if os.path.exists(c):
                with open(c) as f:
                    return f.read()
        return None

    def load(self) -> None:
        import queue

        with open(self.path) as f:
            src = f.read()
        states = []
        for _ in range(self.num_states):
            rt = LuaRuntime(chunk_loader=self._chunk_loader)
            self._install_modules(rt)
            rt.execute(src, os.path.basename(self.path))
            states.append((rt, self._collect_raw(rt)))
        self.runtime = states[0][0]
        self._free = queue.Queue()
        for s in states:
            self._free.put(s)
        self.hooks = {name: self._make_hook(name)
                      for name in states[0][1]}

    def _collect_raw(self, rt: LuaRuntime) -> Dict[str, Any]:
        """The ``hooks = {...}`` global names what registers (the
        reference contract); scripts without it fall back to global
        functions named after hooks. Returns this STATE's lua function
        objects — each pooled state has its own."""
        found: Dict[str, Any] = {}
        hooks_tbl = rt.get_global("hooks")
        if isinstance(hooks_tbl, LuaTable):
            for name in SCRIPT_HOOKS:
                fn = hooks_tbl.get(name)
                if fn is not None:
                    found[name] = fn
        else:
            for name in SCRIPT_HOOKS:
                fn = rt.get_global(name)
                if callable(fn):
                    found[name] = fn
        return found

    # -------------------------------------------------- hook arg conversion

    def _make_hook(self, name: str) -> Callable:
        def hook(*args):
            lua_args = _convert_args(name, args)
            # check a state out of the pool (balancing-supervisor seat):
            # blocks when every state is busy — bounded by the executor's
            # worker count, so no timeout needed. Pin THIS generation's
            # queue: a reload mid-call rebinds self._free, and returning
            # an old state into the new pool would serve stale script
            # code forever — the old queue just gets collected instead.
            free = self._free
            rt, raw = free.get()
            try:
                fn = raw.get(name)
                if fn is None:  # hook absent in this generation (reload)
                    return "next"
                res = rt.call(fn, lua_args)
            except LuaError as e:
                # exc_info surfaces the chained host-function traceback
                # (LuaError.__cause__) when the fault is broker-side, not
                # script-side — see utils/lua.py host-call conversion
                log.error("lua script %s hook %s: %s", self.path, name,
                          e.value, exc_info=e.__cause__ is not None)
                raise
            finally:
                free.put((rt, raw))
            return _convert_result(name, res)

        hook.__name__ = f"lua:{name}"
        return hook

    # ------------------------------------------------------ module install

    def _install_modules(self, rt: LuaRuntime) -> None:
        from ..native import bcrypt as _bcrypt
        from . import connectors as C
        from .scripting import HttpConnector

        def module(name: str, fns: Dict[str, Callable]) -> None:
            t = LuaTable()
            for k, v in fns.items():
                t.set(k, v)
            rt.set_global(name, t)

        # json — compact encoding (no spaces), like cjson/jsx: the bundled
        # redis script builds its key with json.encode and ships it through
        # a space-split command string, so spaces would corrupt the command
        module("json", {
            "encode": lambda v=None: _json.dumps(
                from_lua(v), separators=(",", ":")),
            "decode": lambda s=None: (to_lua(_json.loads(s))
                                      if s is not None else None),
        })

        # auth cache (vmq_diversity_cache seat — feeds the plugin's
        # AclCache, which front-ends publish/subscribe auth)
        cache = self.plugin.cache

        def cache_insert(mp, client_id, username, pub_acl=None,
                         sub_acl=None):
            cache.insert(mp, client_id, username,
                         publish=_acls(pub_acl), subscribe=_acls(sub_acl))
            return True

        module("auth_cache", {"insert": cache_insert})

        # per-script kv store (vmq_diversity_ets seat)
        kv = self.kv

        def _tbl(tid) -> Dict[Any, Any]:
            return kv.setdefault(str(tid), {})

        module("kv", {
            "insert": lambda tid, k, v=None: (_tbl(tid).__setitem__(
                from_lua(k) if isinstance(k, LuaTable) else k,
                v), True)[1],
            "lookup": lambda tid, k: _tbl(tid).get(
                from_lua(k) if isinstance(k, LuaTable) else k),
            "delete": lambda tid, k: (_tbl(tid).pop(
                from_lua(k) if isinstance(k, LuaTable) else k, None),
                True)[1],
            "delete_all": lambda tid: (_tbl(tid).clear(), True)[1],
        })

        # http (hackney seat)
        http = HttpConnector()

        def _http_res(res) -> LuaTable:
            return to_lua({
                "status": res.get("status", 0),
                "body": res.get("body", b""),
                "json": res.get("json"),
            })

        module("http", {
            "get": lambda url, headers=None:
                _http_res(http.get(url, from_lua(headers)
                                   if headers else None)),
            "post_json": lambda url, body=None, headers=None:
                _http_res(http.post_json(url, from_lua(body),
                                         from_lua(headers)
                                         if headers else None)),
        })

        # bcrypt (vmq_diversity_bcrypt seat): hashpw(password, salt) —
        # passing an existing hash as salt re-derives it (the verify
        # idiom the bundled redis/mongodb scripts use)
        module("bcrypt", {
            "hashpw": lambda pw, salt=None: _bcrypt.hashpw(pw, salt),
            "gensalt": lambda cost=12: _bcrypt.gensalt(int(cost)),
            "checkpw": lambda pw, hashed: _bcrypt.checkpw(pw, hashed),
        })

        # datastore connectors
        def ensure(kind):
            def _ensure(cfg=None):
                c = from_lua(cfg) if cfg is not None else {}
                if not isinstance(c, dict):
                    raise LuaError(f"{kind}.ensure_pool expects a table")
                try:
                    return C.ensure_pool(kind, c)
                except C.PoolError as e:
                    raise LuaError(str(e)) from None
            return _ensure

        def pool_call(kind, method):
            def _call(pool_id, *args):
                try:
                    client = C.get_pool(kind, pool_id)
                    res = getattr(client, method)(
                        *[from_lua(a) if isinstance(a, LuaTable) else a
                          for a in args])
                except C.PoolError as e:
                    raise LuaError(str(e)) from None
                return to_lua(res)
            return _call

        module("redis", {"ensure_pool": ensure("redis"),
                         "cmd": pool_call("redis", "cmd")})
        module("memcached", {"ensure_pool": ensure("memcached"),
                             "get": pool_call("memcached", "get"),
                             "set": pool_call("memcached", "set"),
                             "delete": pool_call("memcached", "delete")})
        module("postgres", {"ensure_pool": ensure("postgres"),
                            "execute": pool_call("postgres", "execute")})

        def mysql_hash_method(pool_id=None):
            # the reference maps the configured password_hash_method to
            # the SQL hashing call (vmq_diversity_mysql.erl:119-129 —
            # there a single app-level mysql config). Here a pool_id
            # argument resolves that pool's own setting (from its
            # ensure_pool config) so two pools can hash differently;
            # without one, the broker-global knob applies.
            method = None
            if pool_id is not None:
                method = C.POOL_CONFIGS["mysql"].get(
                    str(pool_id), {}).get("password_hash_method")
            if method is None:
                try:
                    method = str(self.plugin.broker.config.get(
                        "mysql_password_hash_method", "password"))
                except Exception:
                    method = "password"
            return {"password": "PASSWORD(?)", "md5": "MD5(?)",
                    "sha1": "SHA1(?)",
                    "sha256": "SHA2(?, 256)"}.get(str(method),
                                                  "PASSWORD(?)")

        module("mysql", {"ensure_pool": ensure("mysql"),
                         "execute": pool_call("mysql", "execute"),
                         "hash_method": mysql_hash_method})

        def mongo_find_one(pool_id, collection, selector=None):
            # the bundled mongodb.lua checks `doc ~= false` — a missing
            # document must come back as false, not nil
            try:
                client = C.get_pool("mongodb", pool_id)
                doc = client.find_one(
                    collection, from_lua(selector) if selector else {})
            except C.PoolError as e:
                raise LuaError(str(e)) from None
            return to_lua(doc) if doc is not None else False

        module("mongodb", {"ensure_pool": ensure("mongodb"),
                           "find_one": mongo_find_one,
                           "command": pool_call("mongodb", "command")})

        # logger
        lg = logging.getLogger(f"vernemq_tpu_torch.lua.{os.path.basename(self.path)}")
        module("log", {
            "info": lambda *a: lg.info(" ".join(str(x) for x in a)),
            "warning": lambda *a: lg.warning(" ".join(str(x) for x in a)),
            "error": lambda *a: lg.error(" ".join(str(x) for x in a)),
            "debug": lambda *a: lg.debug(" ".join(str(x) for x in a)),
        })


def _acls(v) -> List[Any]:
    if v is None:
        return []
    out = from_lua(v)
    if isinstance(out, dict):
        # an empty Lua table decodes as {} — that is an empty ACL list,
        # not a patternless entry
        out = [out] if out else []
    if not isinstance(out, list):
        return []
    return [a for a in out
            if isinstance(a, str) or (isinstance(a, dict) and "pattern" in a)]


# ------------------------------------------------------------- conversions


def _peer_parts(peer):
    if isinstance(peer, (tuple, list)) and len(peer) >= 2:
        return str(peer[0]), int(peer[1])
    return (str(peer) if peer is not None else None), 0


def _payload_str(payload) -> str:
    if isinstance(payload, bytes):
        return payload.decode("utf-8", "surrogateescape")
    return payload if isinstance(payload, str) else str(payload)


def _convert_args(name: str, args) -> List[Any]:
    """Native hook args → the reference's single named-field table
    (``vmq_diversity_plugin.erl:202-348``)."""
    if name.startswith("auth_on_register"):
        peer, sid, username, password, clean = args[:5]
        addr, port = _peer_parts(peer)
        d = {"addr": addr, "port": port, "mountpoint": sid[0],
             "client_id": sid[1], "username": username,
             "password": password}
        d["clean_start" if name.endswith("_m5") else "clean_session"] = clean
        return [to_lua(d)]
    if name.startswith("auth_on_publish") or name == "on_publish":
        username, sid, qos, words, payload, retain = args[:6]
        return [to_lua({
            "username": username, "mountpoint": sid[0],
            "client_id": sid[1], "qos": qos,
            "topic": _topic_str(words),
            "payload": _payload_str(payload), "retain": bool(retain),
        })]
    if name == "on_deliver":
        username, sid, words, payload = args[:4]
        return [to_lua({
            "username": username, "mountpoint": sid[0],
            "client_id": sid[1], "topic": _topic_str(words),
            "payload": _payload_str(payload),
        })]
    if name in ("on_offline_message", "on_message_drop"):
        sid, msg = args[0], args[1]
        d = {"mountpoint": sid[0], "client_id": sid[1],
             "topic": _topic_str(getattr(msg, "topic", ()) or ()),
             "payload": _payload_str(getattr(msg, "payload", b"")),
             "qos": getattr(msg, "qos", 0),
             "retain": bool(getattr(msg, "retain", False))}
        if name == "on_message_drop" and len(args) > 2:
            d["reason"] = str(args[2])
        return [to_lua(d)]
    if name == "on_register":
        peer, sid, username = args[:3]
        addr, port = _peer_parts(peer)
        return [to_lua({"addr": addr, "port": port, "mountpoint": sid[0],
                        "client_id": sid[1], "username": username})]
    if name == "on_subscribe" or name.startswith("auth_on_subscribe"):
        username, sid, topics = args[:3]
        return [to_lua({
            "username": username, "mountpoint": sid[0],
            "client_id": sid[1],
            "topics": [[_topic_str(w), q] for (w, q) in topics],
        })]
    if name == "on_unsubscribe":
        username, sid, topics = args[:3]
        return [to_lua({
            "username": username, "mountpoint": sid[0],
            "client_id": sid[1],
            "topics": [_topic_str(w) for w in topics],
        })]
    if name == "on_auth_m5":
        sid, method, data = args[:3]
        return [to_lua({
            "mountpoint": sid[0], "client_id": sid[1],
            "method": method,
            "data": _payload_str(data) if data is not None else None,
        })]
    if name in ("on_client_gone", "on_client_offline", "on_client_wakeup"):
        sid = args[0]
        return [to_lua({"mountpoint": sid[0], "client_id": sid[1]})]
    # generic: positional conversion (sid tuples become {mp, cid} pairs)
    return [to_lua(list(a) if isinstance(a, tuple) else a) for a in args]


def _convert_result(name: str, res: List[Any]):
    """Lua hook return → the broker's hook protocol (conv_res):
    true → ok, false → not_authorized, nil → next, table → modifiers."""
    auth = name.startswith("auth_") or name == "on_auth_m5"
    v = res[0] if res else None
    if not auth:
        return None
    if v is None:
        return "next"
    if v is True:
        return "ok"
    if v is False:
        return ("error", "not_authorized")
    if isinstance(v, LuaTable):
        mods = from_lua(v)
        if name.startswith("auth_on_subscribe"):
            out = []
            for item in (mods if isinstance(mods, list) else []):
                if isinstance(item, (list, tuple)) and len(item) >= 2:
                    out.append((str(item[0]).split("/"), int(item[1])))
                elif isinstance(item, dict):
                    out.append((str(item.get("topic", "")).split("/"),
                                int(item.get("qos", 0))))
            return ("ok", out)
        if isinstance(mods, dict):
            if "topic" in mods and isinstance(mods["topic"], str):
                mods["topic"] = mods["topic"].split("/")
            if "payload" in mods and isinstance(mods["payload"], str):
                mods["payload"] = mods["payload"].encode(
                    "utf-8", "surrogateescape")
            return ("ok", mods)
        return ("ok", mods)
    return "ok"
