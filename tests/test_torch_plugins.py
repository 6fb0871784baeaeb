"""The bundled plugins on the port's broker, beside the reference's.

Each scenario of the reference's plugin tests (``test_plugins.py``,
``test_bridge.py``, ``test_scripting.py``, the broker and admin cases of
``test_lua.py`` and the passwd/bcrypt cases of ``test_native.py``) runs
twice on the same inputs: on the reference's broker (its trie view) and on
the port's broker (the GPU view on the CPU, every flush on its device path).
Each run returns a transcript of what the clients and hooks saw (CONNACK and
SUBACK codes, deliveries, hook calls, admin tables); the two must be equal.
Each port broker must also have matched every publish on its device path:
where the scenario publishes, its matcher served publishes and no publish
was served on the host."""

import asyncio
import base64
import hashlib
import http.server
import importlib
import json
import os
import pathlib
import subprocess
import textwrap
import threading
import types

import pytest

import _torch_port  # noqa: F401  (one intra-op thread per worker)
import test_lua as LUA
from test_plugins import HookEndpoint

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the port broker's GPU view on the CPU, every flush on its device path,
#: a queued-publish expiry of 5 s so a slow CPU flush is not served by
#: the trie
PORT_VIEW = dict(default_reg_view="tpu", tpu_host_batch_threshold=0,
                 tpu_batch_window_us=500, tpu_lock_busy_shed_ms=0,
                 watchdog_collector_expiry_budgets=100)
COLLECTOR_HOST = ("degraded_host_pubs", "busy_host_pubs", "rebuild_host_pubs",
                  "overload_host_pubs", "expired_host_pubs",
                  "stalled_host_pubs", "host_hybrid_pubs")
MATCHER_HOST = ("host_fallbacks", "degraded_sheds", "device_failures")


def side(pkg: str):
    """One broker package's modules, and the record of its brokers."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        pkg=pkg, port=pkg == "vernemq_tpu_torch",
        server=mod("broker.server"), Config=mod("broker.config").Config,
        client=mod("client"), passwd=mod("plugins.passwd"),
        bcrypt=mod("native.bcrypt"), native=mod("native"),
        plugins_api=mod("broker.plugins"), commands=mod("admin.commands"),
        conf=mod("broker.conf"), served=[])


async def boot(S, node_name="node1", config=None, **cfg):
    """A broker of side ``S`` on an ephemeral port (``config`` and ``cfg``
    on top): the port's on its GPU view on the CPU, the reference's on its
    default trie view."""
    config = config or S.Config()
    cfg.update(systree_enabled=False, sysmon_enabled=False)
    if S.port:
        cfg.update(PORT_VIEW)
    for k, v in cfg.items():
        config.set(k, v)
    kw = dict(device="cpu") if S.port else {}
    return await S.server.start_broker(config, port=0, node_name=node_name,
                                       **kw)


async def stop(S, b, s):
    """Stop a broker; on the port, record what its device path served."""
    if S.port and "tpu" in b.registry.reg_views:  # made at first use
        m = b.registry.reg_views["tpu"].matcher("")
        col = b.batch_collector()
        host = {k: getattr(col, k) for k in COLLECTOR_HOST}
        host.update({k: getattr(m, k) for k in MATCHER_HOST})
        S.served.append((m.match_publishes, host))
    await b.stop()
    await s.stop()


def client(S, s, cid, **kw):
    return S.client.MQTTClient(s.host, s.port, client_id=cid, **kw)


async def outcome(c, timeout):
    """The next delivery's (topic, payload), or "none" within
    ``timeout``."""
    try:
        m = await c.recv(timeout)
    except asyncio.TimeoutError:
        return "none"
    return (m.topic, bytes(m.payload))


async def wait_until(pred, timeout=5.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise AssertionError("wait_until timed out")
        await asyncio.sleep(0.02)


# -------------------------------------------------------- test_plugins.py


async def sc_passwd_auth(S, tmp):
    """test_plugins.py::test_passwd_auth_e2e, with a bcrypt entry beside
    the sha512 one (vmq_passwd reads both)."""
    b, s = await boot(S, allow_anonymous=False)
    out = {}
    try:
        pw = tmp / "passwd"
        pw.write_text(S.passwd.make_entry("alice", "secret") + "\n"
                      + "bob:" + S.bcrypt.hashpw("b0b", cost=4) + "\n")
        b.plugins.enable("vmq_passwd", passwd_file=str(pw))
        for cid, user, word in (("anon", None, None),
                                ("alice1", "alice", b"wrong"),
                                ("alice2", "alice", b"secret"),
                                ("bob1", "bob", b"b0b"),
                                ("bob2", "bob", b"b0")):
            c = client(S, s, cid, username=user, password=word)
            out[cid] = (await c.connect()).rc
            await c.close()
    finally:
        await stop(S, b, s)
    return out


async def sc_acl_gates(S, tmp):
    """test_plugins.py::test_acl_gates_publish_subscribe, and the
    allowed publish delivered to a reader of it."""
    b, s = await boot(S, allow_anonymous=False)
    out = {}
    try:
        pw = tmp / "passwd"
        pw.write_text(S.passwd.make_entry("alice", "pw") + "\n")
        aclf = tmp / "acl"
        aclf.write_text("user alice\ntopic read in/#\ntopic write out/alice\n"
                        "topic read out/#\n")
        b.plugins.enable("vmq_passwd", passwd_file=str(pw))
        b.plugins.enable("vmq_acl", acl_file=str(aclf))
        c = client(S, s, "a", username="alice", password=b"pw")
        out["connack"] = (await c.connect()).rc
        out["suback"] = (await c.subscribe("in/temp", qos=1)).reason_codes
        out["denied"] = (await c.subscribe("other/topic",
                                           qos=1)).reason_codes
        sub = client(S, s, "s", username="alice", password=b"pw")
        await sub.connect()
        out["sub"] = (await sub.subscribe(["in/#", "out/#"],
                                          qos=0)).reason_codes
        await c.publish("out/alice", b"x", qos=1)
        out["allowed"] = await outcome(sub, 5.0)
        await c.publish("in/evil", b"x", qos=0)  # no write on in/#
        out["denied publish"] = await outcome(sub, 0.3)
        await c.disconnect()
        await sub.disconnect()
    finally:
        await stop(S, b, s)
    return out


async def sc_webhooks_auth_and_modifiers(S, tmp):
    """test_plugins.py::test_webhooks_auth_and_modifiers."""
    def responder(hook, body):
        if hook in ("auth_on_register", "auth_on_register_m5"):
            if body["username"] == "good":
                return 200, {}, {"result": "ok"}
            return 200, {}, {"result": {"error": "not_allowed"}}
        if hook in ("auth_on_publish", "auth_on_publish_m5"):
            return 200, {}, {"result": "ok", "modifiers": {
                "payload": base64.b64encode(b"rewritten").decode()}}
        if hook in ("auth_on_subscribe", "auth_on_subscribe_m5"):
            return 200, {}, {"result": "ok"}
        return 200, {}, {"result": "next"}

    b, s = await boot(S, allow_anonymous=False)
    ep = await HookEndpoint(responder).start()
    out = {}
    try:
        wh = b.plugins.enable("vmq_webhooks")
        for hook in ("auth_on_register", "auth_on_publish",
                     "auth_on_subscribe"):
            wh.register_endpoint(hook, ep.url)
        bad = client(S, s, "x", username="bad", password=b"pw")
        out["bad"] = (await bad.connect()).rc
        await bad.close()
        good = client(S, s, "g", username="good", password=b"pw")
        out["good"] = (await good.connect()).rc
        sub = client(S, s, "g2", username="good", password=b"pw")
        await sub.connect()
        await sub.subscribe("t/#", qos=0)
        await good.publish("t/1", b"original", qos=0)
        out["delivered"] = await outcome(sub, 5.0)
        out["hooks"] = sorted({h for h, _ in ep.requests})
        await good.disconnect()
        await sub.disconnect()
        b.plugins.disable("vmq_webhooks")
    finally:
        await ep.stop()
        await stop(S, b, s)
    return out


async def sc_webhooks_cache(S, tmp):
    """test_plugins.py::test_webhooks_cache."""
    calls = {"n": 0}

    def responder(hook, body):
        calls["n"] += 1
        return 200, {"cache-control": "max-age=60"}, {"result": "ok"}

    b, s = await boot(S, allow_anonymous=False)
    ep = await HookEndpoint(responder).start()
    out = {"rc": []}
    try:
        wh = b.plugins.enable("vmq_webhooks")
        wh.register_endpoint("auth_on_register", ep.url)
        for _ in range(3):
            c = client(S, s, "same", username="u", password=b"pw")
            out["rc"].append((await c.connect()).rc)
            await c.disconnect()
        out["calls"], out["hits"] = calls["n"], wh.cache.hits
        b.plugins.disable("vmq_webhooks")
    finally:
        await ep.stop()
        await stop(S, b, s)
    return out


async def sc_webhooks_topic_rewrite(S, tmp):
    """An ``auth_on_publish`` webhook answering a ``topic`` modifier: the
    publish is matched and delivered under the rewritten topic, on the
    port by the GPU view."""
    def responder(hook, body):
        return 200, {}, {"result": "ok", "modifiers": {
            "topic": "new/" + body["topic"].split("/", 1)[1]}}

    b, s = await boot(S, allow_anonymous=True)
    ep = await HookEndpoint(responder).start()
    out = {}
    try:
        wh = b.plugins.enable("vmq_webhooks")
        wh.register_endpoint("auth_on_publish", ep.url)
        old, new = client(S, s, "old"), client(S, s, "new", proto_ver=5)
        for c in (old, new):
            await c.connect()
        await old.subscribe("old/#", qos=1)
        await new.subscribe(["new/+/x", "new/#"], qos=1)
        pub = client(S, s, "pub")
        await pub.connect()
        for i in range(4):
            await pub.publish(f"old/{i}/x", b"%d" % i, qos=i % 2)
        out["new"] = sorted([await outcome(new, 5.0) for _ in range(8)])
        out["old"] = await outcome(old, 0.3)
        out["calls"] = len(ep.requests)
        for c in (old, new, pub):
            await c.disconnect()
        b.plugins.disable("vmq_webhooks")
    finally:
        await ep.stop()
        await stop(S, b, s)
    return out


# --------------------------------------------------------- test_bridge.py


async def bridged(S, rules, **bridge):
    """A remote and a local broker of side ``S`` with a bridge from the
    local one; returns (rb, rs, lb, ls, bridge)."""
    rb, rs = await boot(S, node_name="remote", allow_anonymous=True)
    lb, ls = await boot(S, node_name="local", allow_anonymous=True)
    plugin = lb.plugins.enable("vmq_bridge", bridges=[{
        "host": rs.host, "port": rs.port, "restart_timeout": 0.2,
        "topics": rules, **bridge}])
    br = plugin.bridges["br0"]
    await wait_until(lambda: br.info()["connected"])
    return rb, rs, lb, ls, br


async def unbridge(S, rb, rs, lb, ls):
    # the bridge owner first: its link must be gone before the remote
    # listener's wait_closed can return
    await stop(S, lb, ls)
    await stop(S, rb, rs)


async def sc_bridge_out(S, tmp):
    """test_bridge.py::test_bridge_out_direction_with_prefix."""
    rb, rs, lb, ls, _ = await bridged(S, [{
        "pattern": "sensors/#", "direction": "out", "qos": 1,
        "remote_prefix": "site1"}])
    try:
        sub = client(S, rs, "remote-sub")
        await sub.connect()
        await sub.subscribe("site1/sensors/#", qos=1)
        pub = client(S, ls, "local-pub")
        await pub.connect()
        await pub.publish("sensors/t1", b"42", qos=1)
        out = {"remote": await outcome(sub, 5.0)}
        await pub.close()
        await sub.close()
    finally:
        await unbridge(S, rb, rs, lb, ls)
    return out


async def sc_bridge_in(S, tmp):
    """test_bridge.py::test_bridge_in_direction_with_prefix."""
    rb, rs, lb, ls, _ = await bridged(S, [{
        "pattern": "alerts/#", "direction": "in", "qos": 1,
        "local_prefix": "from-remote"}])
    try:
        sub = client(S, ls, "local-sub")
        await sub.connect()
        await sub.subscribe("from-remote/alerts/#", qos=1)
        pub = client(S, rs, "remote-pub")
        await pub.connect()
        await pub.publish("alerts/fire", b"hot", qos=1)
        out = {"local": await outcome(sub, 5.0)}
        await pub.close()
        await sub.close()
    finally:
        await unbridge(S, rb, rs, lb, ls)
    return out


async def sc_bridge_both_no_loop(S, tmp):
    """test_bridge.py::test_bridge_both_no_loop."""
    rb, rs, lb, ls, _ = await bridged(S, [{
        "pattern": "shared/#", "direction": "both", "qos": 0}])
    out = {}
    try:
        remote_sub, local_sub = client(S, rs, "remote-sub"), \
            client(S, ls, "local-sub")
        for c in (remote_sub, local_sub):
            await c.connect()
            await c.subscribe("shared/#", qos=0)
        pub = client(S, rs, "remote-pub")
        await pub.connect()
        await pub.publish("shared/x", b"one", qos=0)
        out["local"] = await outcome(local_sub, 5.0)
        out["remote own"] = await outcome(remote_sub, 5.0)
        out["bounced"] = await outcome(remote_sub, 0.5)
        lpub = client(S, ls, "local-pub")
        await lpub.connect()
        await lpub.publish("shared/y", b"two", qos=0)
        out["exported"] = await outcome(remote_sub, 5.0)
        for c in (pub, lpub, local_sub, remote_sub):
            await c.close()
    finally:
        await unbridge(S, rb, rs, lb, ls)
    return out


async def sc_bridge_buffers(S, tmp):
    """test_bridge.py::test_bridge_buffers_while_down_and_reconnects."""
    rb, rs, lb, ls, br = await bridged(
        S, [{"pattern": "buf/#", "direction": "out", "qos": 1}],
        max_outgoing_buffered_messages=2)
    rs2 = None
    out = {}
    try:
        # a crashed remote: the listener record dropped first so its
        # supervisor does not restart it, the live bridge session killed
        if rb.listeners is not None:
            rb.listeners._listeners.pop((rs.host, rs.port), None)
        rs._server.close()
        for sess in list(rb.sessions.values()):
            await sess.close("remote_crash", send_will=False)
        await asyncio.sleep(0.1)
        pub = client(S, ls, "local-pub")
        await pub.connect()
        for i in range(4):
            await pub.publish("buf/t", f"m{i}".encode(), qos=1)
        await wait_until(lambda: br.info()["buffered_out"]
                         + br.info()["dropped_out"] >= 3)
        out["dropped"] = br.info()["dropped_out"] >= 1
        rs2 = S.server.MQTTServer(rb, rs.host, rs.port)
        for _ in range(50):
            try:
                await rs2.start()
                break
            except OSError:  # the port not released yet
                await asyncio.sleep(0.1)
        sub = client(S, rs2, "remote-sub")
        await sub.connect()
        await sub.subscribe("buf/#", qos=1)
        await wait_until(lambda: br.info()["connected"], timeout=10.0)
        out["flushed"] = len({(await sub.recv(10.0)).payload
                              for _ in range(2)})
        await pub.close()
        await sub.close()
    finally:
        await stop(S, lb, ls)
        if rs2 is not None:
            await rs2.stop()
        await stop(S, rb, rs)
    return out


async def sc_bridge_admin_show(S, tmp):
    """test_bridge.py::test_bridge_admin_show."""
    rb, rs = await boot(S, node_name="remote", allow_anonymous=True)
    lb, ls = await boot(S, node_name="local", allow_anonymous=True)
    try:
        lb.plugins.enable("vmq_bridge", bridges=[{
            "name": "edge", "host": rs.host, "port": rs.port,
            "topics": [{"pattern": "a/#", "direction": "out", "qos": 0}]}])
        reg = S.commands.register_core_commands(S.commands.CommandRegistry())
        table = reg.run(lb, ["bridge", "show"])["table"]
        out = {k: table[0][k] for k in ("name", "rules")}
    finally:
        await unbridge(S, rb, rs, lb, ls)
    return out


# ------------------------------------------------------ test_scripting.py

AUTH_SCRIPT = textwrap.dedent('''
    USERS = {"alice": b"wonder", "bob": b"builder"}

    def auth_on_register(peer, sid, username, password, clean_start):
        kv["registers"] = kv.get("registers", 0) + 1
        if username not in USERS:
            return "next"
        if USERS[username] != password:
            return ("error", "invalid_credentials")
        cache.insert(sid[0], sid[1], username,
                     publish=["data/%u/#"],
                     subscribe=["data/#", {"pattern": "ctrl/%c"}])
        return "ok"

    def on_client_gone(sid):
        kv.setdefault("gone", []).append(sid[1])
''')


async def scripted(S, tmp, src=AUTH_SCRIPT, **cfg):
    path = tmp / "auth_script.py"
    path.write_text(src)
    b, s = await boot(S, node_name="scripted", allow_anonymous=False, **cfg)
    plugin = b.plugins.enable("vmq_diversity", scripts=[str(path)])
    return b, s, plugin, path


async def sc_script_auth_and_acl_cache(S, tmp):
    """test_scripting.py::test_script_auth_and_acl_cache."""
    b, s, plugin, _ = await scripted(S, tmp)
    out = {}
    try:
        for cid, user, word in (("c1", "alice", b"nope"),
                                ("cx", "eve", b"x")):
            c = client(S, s, cid, username=user, password=word)
            out[f"{cid} {user}"] = (await c.connect()).rc
            await c.close()
        c = client(S, s, "c1", username="alice", password=b"wonder")
        out["good"] = (await c.connect()).rc
        out["cached"] = plugin.stats()["cached_acls"]
        out["suback"] = (await c.subscribe(["data/#", "secret/#"],
                                           qos=1)).reason_codes
        await c.publish("data/alice/t", b"mine", qos=1)
        out["mine"] = await outcome(c, 5.0)
        await c.publish("data/bob/t", b"not-mine", qos=1)
        out["not mine"] = await outcome(c, 0.4)
        out["ctrl"] = (await c.subscribe("ctrl/c1", qos=0)).reason_codes
        await c.close()
        await asyncio.sleep(0.1)
        script = next(iter(plugin.scripts.values()))
        out["registers"] = script.kv["registers"]
        out["gone"] = "c1" in script.kv.get("gone", [])
    finally:
        await stop(S, b, s)
    return out


async def sc_script_reload(S, tmp):
    """test_scripting.py::test_script_reload_changes_behavior."""
    b, s, plugin, path = await scripted(S, tmp)
    out = {}
    try:
        c = client(S, s, "c9", username="carol", password=b"pw")
        out["before"] = (await c.connect()).rc
        await c.close()
        path.write_text(AUTH_SCRIPT.replace(
            '{"alice": b"wonder", "bob": b"builder"}', '{"carol": b"pw"}'))
        plugin.reload_script(str(path))
        c = client(S, s, "c9", username="carol", password=b"pw")
        out["after"] = (await c.connect()).rc
        await c.close()
    finally:
        await stop(S, b, s)
    return out


async def sc_script_error(S, tmp):
    """test_scripting.py::test_script_error_is_auth_error_not_crash."""
    b, s, _, _ = await scripted(S, tmp, textwrap.dedent('''
        def auth_on_register(peer, sid, username, password, clean_start):
            raise ValueError("boom")
    '''))
    out = []
    try:
        for cid in ("cc", "cd"):
            c = client(S, s, cid, username="anyone", password=b"x")
            out.append((await c.connect()).rc)
            await c.close()
    finally:
        await stop(S, b, s)
    return out


async def sc_mqtt5_demo_two_rounds(S, tmp):
    """test_scripting.py::test_mqtt5_demo_enhanced_auth_two_rounds."""
    b, s = await boot(S, node_name="demo5", allow_anonymous=True)
    b.plugins.enable("vmq_mqtt5_demo_plugin")
    out = {}
    try:
        c = client(S, s, "eauth", proto_ver=5, properties={
            "authentication_method": "method1",
            "authentication_data": b"client1"})
        first = await c.connect()
        out["first"] = (type(first).__name__,
                        first.properties.get("authentication_data"))
        ack = await c.auth(0x18, {"authentication_method": "method1",
                                  "authentication_data": b"client2"})
        out["second"] = (type(ack).__name__, ack.rc,
                         ack.properties.get("authentication_data"))
        await c.subscribe("e/#", qos=1)
        await c.publish("e/t", b"hello", qos=1)
        out["delivered"] = await outcome(c, 5.0)
        await c.close()
    finally:
        await stop(S, b, s)
    return out


async def sc_mqtt5_demo_bad_data(S, tmp):
    """test_scripting.py::test_mqtt5_demo_enhanced_auth_bad_data_rejected."""
    b, s = await boot(S, node_name="demo5b", allow_anonymous=True)
    b.plugins.enable("vmq_mqtt5_demo_plugin")
    try:
        c = client(S, s, "eauth-bad", proto_ver=5, properties={
            "authentication_method": "method1",
            "authentication_data": b"baddata"})
        frame = await c.connect()
        out = (type(frame).__name__, frame.rc)
        await c.close()
    finally:
        await stop(S, b, s)
    return out


async def sc_http_backend_auth_script(S, tmp):
    """test_scripting.py::test_http_backend_auth_script: the shipped
    examples/auth/http_backend.py against a REST endpoint in a thread."""
    hits = []

    class AuthHandler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers.get("Content-Length", 0))))
            hits.append(body)
            resp = json.dumps({
                "ok": body == {"user": "erin", "pass": "s3cret"},
                "publish_acl": ["data/%u/#"],
                "subscribe_acl": ["data/#"]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(resp)))
            self.end_headers()
            self.wfile.write(resp)

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), AuthHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}/auth"
    script = tmp / "http_auth.py"
    src = (REPO_ROOT / "examples" / "auth" / "http_backend.py").read_text()
    script.write_text(src.replace(
        'kv.get("auth_url", "http://127.0.0.1:8080/auth")', repr(url)))
    b, s = await boot(S)
    out = {}
    try:
        b.plugins.enable("vmq_diversity", scripts=[str(script)])
        good = client(S, s, "e1", username="erin", password=b"s3cret")
        out["good"] = (await good.connect()).rc
        await good.subscribe("data/#", qos=1)
        await good.publish("data/erin/t1", b"x", qos=1)
        out["delivered"] = await outcome(good, 5.0)
        bad = client(S, s, "e2", username="erin", password=b"wrong")
        out["bad"] = (await bad.connect()).rc
        out["hits"] = hits
        await good.disconnect()
    finally:
        httpd.shutdown()
        await stop(S, b, s)
    return out


# ------------------------------------------------------------- test_lua.py

async def lua_hooks(S, tmp, name, src, calls):
    """A Lua script enabled on a broker of side ``S`` through the plugin
    manager, its hooks called as ``calls(plugin, script)`` does."""
    path = tmp / name
    path.write_text(src)
    b, s = await boot(S)
    try:
        plugin = b.plugins.enable("vmq_diversity", scripts=[str(path)])
        return calls(plugin, plugin.scripts[str(path)])
    finally:
        await stop(S, b, s)


def _cache(plugin, sid, kind, words):
    hit = plugin.cache.lookup(sid, kind, words)
    return None if hit is None else hit[0]


async def sc_lua_redis_auth(S, tmp):
    """test_lua.py::test_lua_redis_auth_script_flow."""
    db = {}
    port, srv = LUA._fake_redis(db)
    try:
        key = json.dumps(["", "client-9", "alice"], separators=(",", ":"))
        db[key.encode()] = json.dumps({
            "passhash": S.bcrypt.hashpw("secret123", cost=4),
            "publish_acl": [{"pattern": "sensors/%c/+"}],
            "subscribe_acl": [{"pattern": "cmd/%u/#"}]}).encode()
        sid, peer = ("", "client-9"), ("10.0.0.1", 1883)

        def calls(plugin, s):
            reg = s.hooks["auth_on_register"]
            out = [sorted(s.hooks), reg(peer, sid, "alice", "wrong", True),
                   reg(peer, sid, "alice", "secret123", True),
                   s.hooks["auth_on_register_m5"](peer, sid, "alice",
                                                  "secret123", True),
                   _cache(plugin, sid, "publish", ["sensors", "client-9", "t"]),
                   _cache(plugin, sid, "publish", ["sensors", "other", "t"]),
                   _cache(plugin, sid, "subscribe", ["cmd", "alice", "x"]),
                   reg(peer, ("", "nobody"), "eve", "x", True),
                   s.hooks["auth_on_publish"]("alice", sid, 0, ["x"], b"p",
                                              False)]
            plugin._on_client_gone(sid)
            return out + [_cache(plugin, sid, "publish",
                                 ["sensors", "client-9", "t"])]

        return await lua_hooks(S, tmp, "redis_auth.lua",
                               LUA.REDIS_AUTH_LUA % ("torch", port), calls)
    finally:
        srv.close()


async def sc_lua_postgres_auth(S, tmp):
    """test_lua.py::test_lua_postgres_auth_script_flow."""
    def rows_for(sql, params):
        cols = ["publish_acl", "subscribe_acl"]
        if params and params[1] == "bob" and params[2] == "builder":
            return cols, [('[{"pattern":"site/#"}]', '[]')]
        return cols, []

    port, srv = LUA._fake_postgres("vmq", "pgpw", rows_for)
    try:
        sid, peer = ("", "dev-1"), ("10.0.0.2", 1883)

        def calls(plugin, s):
            reg = s.hooks["auth_on_register"]
            return [reg(peer, sid, "bob", "builder", True),
                    _cache(plugin, sid, "publish", ["site", "a"]),
                    reg(peer, sid, "bob", "wrongpw", True)]

        return await lua_hooks(S, tmp, "pg_auth.lua",
                               LUA.POSTGRES_AUTH_LUA % ("torch", port), calls)
    finally:
        srv.close()


async def sc_lua_subscribe_modifier(S, tmp):
    """test_lua.py::test_lua_subscribe_modifier_rewrite, then the same
    script on a live broker: the rewritten filter is the subscription that
    a publish matches (on the port, a row of the GPU table)."""
    src = """
function auth_on_subscribe(sub)
    out = {}
    for i, tq in ipairs(sub.topics) do
        out[i] = {"rewritten/" .. sub.client_id, tq[2]}
    end
    return out
end
hooks = { auth_on_subscribe = auth_on_subscribe }
"""
    direct = await lua_hooks(
        S, tmp, "rw.lua", src,
        lambda plugin, s: s.hooks["auth_on_subscribe"](
            "u", ("", "c7"), [(["a", "b"], 1)]))
    path = tmp / "rw.lua"
    b, s = await boot(S, allow_anonymous=True)
    out = {"direct": direct}
    try:
        b.plugins.enable("vmq_diversity", scripts=[str(path)])
        c = client(S, s, "c7")
        await c.connect()
        out["suback"] = (await c.subscribe("a/b", qos=1)).reason_codes
        pub = client(S, s, "p")
        await pub.connect()
        await pub.publish("a/b", b"old", qos=1)
        await pub.publish("rewritten/c7", b"new", qos=1)
        out["delivered"] = [await outcome(c, 5.0), await outcome(c, 0.3)]
        for x in (c, pub):
            await x.disconnect()
    finally:
        await stop(S, b, s)
    return out


async def sc_lua_brokered_mqtt_flow(S, tmp):
    """test_lua.py::test_lua_script_brokered_mqtt_flow."""
    path = tmp / "auth.lua"
    path.write_text(LUA.INLINE_AUTH_LUA)
    b, s = await boot(S, node_name="lua-scripted", allow_anonymous=False)
    out = {}
    try:
        plugin = b.plugins.enable("vmq_diversity", scripts=[str(path)])
        bad = client(S, s, "c1", username="alice", password=b"nope")
        out["bad"] = (await bad.connect()).rc
        await bad.close()
        c = client(S, s, "c1", username="alice", password=b"wonder")
        out["good"] = (await c.connect()).rc
        out["cached"] = plugin.stats()["cached_acls"]
        out["suback"] = (await c.subscribe(["data/#", "secret/#"],
                                           qos=1)).reason_codes
        await c.publish("data/alice/t", b"mine", qos=1)
        out["mine"] = await outcome(c, 5.0)
        await c.publish("data/bob/t", b"not-mine", qos=1)
        out["not mine"] = await outcome(c, 0.4)
        await c.close()
    finally:
        await stop(S, b, s)
    return out


async def sc_lua_publish_rewrite(S, tmp):
    """A Lua ``auth_on_publish`` returning a ``topic`` modifier: the
    publish reaches exactly the subscribers of the rewritten topic."""
    path = tmp / "pub_rw.lua"
    path.write_text("""
function auth_on_publish(pub)
    if string.sub(pub.topic, 1, 4) == "old/" then
        return {topic = "new/" .. string.sub(pub.topic, 5)}
    end
    return true
end
hooks = { auth_on_publish = auth_on_publish }
""")
    b, s = await boot(S, allow_anonymous=True)
    out = {}
    try:
        b.plugins.enable("vmq_diversity", scripts=[str(path)])
        subs = [client(S, s, f"s{i}", proto_ver=5 if i % 2 else 4)
                for i in range(3)]
        for c, f in zip(subs, ("new/+/t", "new/#", "old/#")):
            await c.connect()
            await c.subscribe(f, qos=1)
        pub = client(S, s, "p")
        await pub.connect()
        for i in range(3):
            await pub.publish(f"old/{i}/t", b"%d" % i, qos=i % 2)
        out["got"] = [sorted([await outcome(c, 5.0) for _ in range(3)])
                      for c in subs[:2]]
        out["old"] = await outcome(subs[2], 0.3)
        for c in subs + [pub]:
            await c.disconnect()
    finally:
        await stop(S, b, s)
    return out


async def sc_lua_mysql_auth(S, tmp):
    """test_lua.py::test_lua_mysql_auth_script_flow."""
    def rows_for(sql):
        assert "PASSWORD(" in sql
        if ("X'" + b"carol".hex() + "'" in sql
                and "X'" + b"mqtt-pw".hex() + "'" in sql):
            return ["publish_acl", "subscribe_acl"], [
                ('[{"pattern":"site/%u/#"}]', "[]")]
        return ["publish_acl", "subscribe_acl"], []

    port, srv = LUA._fake_mysql("vmq", "mypw", rows_for)
    try:
        sid, peer = ("", "m-1"), ("10.0.0.3", 1883)

        def calls(plugin, s):
            reg = s.hooks["auth_on_register"]
            return [reg(peer, sid, "carol", "mqtt-pw", True),
                    _cache(plugin, sid, "publish", ["site", "carol", "x"]),
                    reg(peer, sid, "carol", "badpw", True)]

        return await lua_hooks(S, tmp, "mysql_auth.lua",
                               LUA.MYSQL_AUTH_LUA % ("torch", port), calls)
    finally:
        srv.close()


async def sc_lua_mongodb_auth(S, tmp):
    """test_lua.py::test_lua_mongodb_auth_script_flow."""
    docs = [{"mountpoint": "", "client_id": "m-9", "username": "dana",
             "passhash": S.bcrypt.hashpw("mqtt-secret", cost=4),
             "publish_acl": [{"pattern": "farm/%c/#"}],
             "subscribe_acl": [{"pattern": "farm/#"}]}]
    port, srv = LUA._fake_mongo("vmq", "mongopw", docs)
    try:
        sid, peer = ("", "m-9"), ("10.0.0.4", 1883)

        def calls(plugin, s):
            reg = s.hooks["auth_on_register"]
            return [reg(peer, sid, "dana", "mqtt-secret", True),
                    _cache(plugin, sid, "publish", ["farm", "m-9", "x"]),
                    reg(peer, sid, "dana", "bad", True),
                    reg(peer, ("", "ghost"), "dana", "mqtt-secret", True)]

        return await lua_hooks(S, tmp, "mongo_auth.lua",
                               LUA.MONGO_AUTH_LUA % ("torch", port), calls)
    finally:
        srv.close()


async def sc_lua_script_admin_commands(S, tmp):
    """test_lua.py::test_script_admin_commands."""
    path = tmp / "adm.lua"
    path.write_text('marker = "v1"\nfunction auth_on_register(reg) return '
                    'true end\nhooks = { auth_on_register = '
                    'auth_on_register }\n')
    b, s = await boot(S, allow_anonymous=True)
    out = {}
    try:
        b.plugins.enable("vmq_diversity", scripts=[str(path)])
        reg = S.commands.register_core_commands(S.commands.CommandRegistry())
        out["show"] = reg.run(b, ["script", "show"])
        path.write_text(path.read_text().replace('"v1"', '"v2"')
                        .replace("return true", "return false"))
        out["reload"] = reg.run(b, ["script", "reload", f"path={path}"])
        script = b.plugins.get("vmq_diversity").scripts[str(path)]
        out["marker"] = script.runtime.get_global("marker")
        with pytest.raises(S.commands.CommandError) as e:
            reg.run(b, ["script", "reload", "path=/nope.lua"])
        out["missing"] = str(e.value)
    finally:
        await stop(S, b, s)
    return json.loads(json.dumps(out).replace(str(tmp), "<tmp>"))


# ----------------------------------------------------- test_native.py, conf


async def sc_bcrypt_known_vectors(S, tmp):
    """test_native.py::test_bcrypt_known_vectors."""
    vectors = [
        ("U*U", "$2a$05$CCCCCCCCCCCCCCCCCCCCC.",
         "$2a$05$CCCCCCCCCCCCCCCCCCCCC.E5YPO9kmyuRGyh0XouQYb4YMJKvyOeW"),
        ("U*U*", "$2a$05$CCCCCCCCCCCCCCCCCCCCC.",
         "$2a$05$CCCCCCCCCCCCCCCCCCCCC.VGOzA784oUp/Z0DY336zx7pLYAy0lwK"),
        ("U*U*U", "$2a$05$XXXXXXXXXXXXXXXXXXXXXO",
         "$2a$05$XXXXXXXXXXXXXXXXXXXXXOAcXxm9kjPGEMsLznoKqmqw7tc8WCx4a")]
    out = []
    for pw, salt, want in vectors:
        h = S.bcrypt.hashpw(pw, salt)
        out.append((h == want, S.bcrypt.checkpw(pw, want),
                    S.bcrypt.checkpw(pw + "x", want)))
    return out


async def sc_passwd_tool_roundtrip(S, tmp):
    """test_native.py::test_passwd_tool_roundtrip, read by the side's
    PasswdPlugin."""
    tool = S.native.passwd_tool_path()
    pw_file = str(tmp / "users.passwd")
    for user, word, flags in (("alice", "hunter2", ["-c"]),
                              ("bob", "b0b", [])):
        subprocess.run([tool, *flags, pw_file, user], check=True,
                       env={**os.environ, "VMQ_PASSWORD": word})
    lines = open(pw_file).read().splitlines()
    out = {"lines": len(lines), "sha512": []}
    for line, pw in zip(lines, ["hunter2", "b0b"]):
        _, _, salt_b64, hash_b64 = line.split(":", 1)[1].split("$")
        out["sha512"].append(hash_b64 == base64.b64encode(hashlib.sha512(
            pw.encode() + base64.b64decode(salt_b64)).digest()).decode())
    plug = S.passwd.PasswdPlugin()
    plug.load_from_lines(lines)
    out["checks"] = [plug.check("alice", "hunter2") == S.plugins_api.OK,
                     plug.check("alice", "wrong")]
    subprocess.run([tool, pw_file, "alice"], check=True,
                   env={**os.environ, "VMQ_PASSWORD": "new-pass"})
    plug.load_from_file(pw_file)
    out["updated"] = plug.check("alice", "new-pass") == S.plugins_api.OK
    subprocess.run([tool, "-D", pw_file, "alice"], check=True)
    out["after delete"] = [ln.split(":")[0]
                           for ln in open(pw_file).read().splitlines()]
    return out


async def sc_conf_file_boot(S, tmp):
    """The shipped defaults from a vernemq.conf file through
    ``broker/conf.py``: ``allow_anonymous = off`` with vmq_passwd and
    vmq_acl on boot a broker that authenticates, authorizes and
    delivers."""
    pw, aclf = tmp / "vmq.passwd", tmp / "vmq.acl"
    pw.write_text(S.passwd.make_entry("dev", "pw") + "\n")
    aclf.write_text("topic read tele/#\ntopic read own/#\nuser dev\n"
                    "topic write tele/+/up\npattern write own/%c/#\n")
    conf = tmp / "vernemq.conf"
    conf.write_text(textwrap.dedent(f"""\
        allow_anonymous = off
        plugins.vmq_passwd = on
        vmq_passwd.password_file = {pw}
        plugins.vmq_acl = on
        vmq_acl.acl_file = {aclf}
        """))
    b, s = await boot(S, config=S.conf.load_conf_file(str(conf)))
    out = {}
    try:
        out["plugins"] = [name for name, _ in b.plugins.show()]
        for cid, user, word in (("anon", None, None), ("bad", "dev", b"x")):
            c = client(S, s, cid, username=user, password=word)
            out[cid] = (await c.connect()).rc
            await c.close()
        sub = client(S, s, "d1", username="dev", password=b"pw")
        pub = client(S, s, "d2", username="dev", password=b"pw", proto_ver=5)
        out["connack"] = [(await c.connect()).rc for c in (sub, pub)]
        out["suback"] = [(await sub.subscribe(f, qos=1)).reason_codes
                         for f in (["tele/#", "own/#"], "x/#")]
        for topic in ("tele/a/up", "tele/a/down", "own/d2/x", "own/d1/x"):
            await pub.publish(topic, topic.encode(), qos=1)
        out["got"] = sorted([await outcome(sub, 5.0) for _ in range(2)])
        out["more"] = await outcome(sub, 0.3)
        for c in (sub, pub):
            await c.disconnect()
    finally:
        await stop(S, b, s)
    return out


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}
#: scenarios that publish: every port broker of theirs must have matched
#: publishes on its device path
PUBLISHING = {"acl_gates", "webhooks_auth_and_modifiers",
              "webhooks_topic_rewrite", "bridge_out", "bridge_in",
              "bridge_both_no_loop", "bridge_buffers",
              "script_auth_and_acl_cache", "mqtt5_demo_two_rounds",
              "http_backend_auth_script", "lua_subscribe_modifier",
              "lua_brokered_mqtt_flow", "lua_publish_rewrite",
              "conf_file_boot"}


@pytest.mark.asyncio
@pytest.mark.parametrize("name", sorted(SCENARIOS))
async def test_plugin_scenario_as_reference(name, tmp_path):
    ref, port = side("vernemq_tpu"), side("vernemq_tpu_torch")
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = await SCENARIOS[name](ref, tmp_path / "ref")
    got = await SCENARIOS[name](port, tmp_path / "port")
    assert got == want
    for publishes, host in port.served:
        assert not any(host.values()), host
    if name in PUBLISHING:
        assert any(publishes for publishes, _ in port.served), port.served
    if name == "bridge_in":  # the bridge owner matched the import
        assert port.served[0][0] > 0, port.served
