"""The port's admin surface (``vernemq_tpu_torch/admin/``) beside the
reference's: the same clients, subscriptions and command script run on a
reference broker (its JAX tpu view on the CPU) and on the port's broker
(the GPU view, ``device="cpu"``), each driven over its own HTTP management
API through its own ``admin/cli.py``. Every table must be equal, apart
from timing fields and the fields the port leaves out (``LEFT_OUT``,
README "PyTorch/CUDA port"); the device-facing commands must read the GPU
objects, and a breaker trip must send matching to the trie and a reset
bring it back."""

import asyncio
import json
import random
import urllib.request

import pytest

import _torch_port  # one intra-op thread per worker; shared helpers
from vernemq_tpu.admin import cli as ref_cli
from vernemq_tpu.admin.commands import CommandRegistry as RefRegistry
from vernemq_tpu.admin.commands import \
    register_core_commands as ref_commands
from vernemq_tpu.broker.config import Config as RefConfig
from vernemq_tpu.broker.server import start_broker as ref_start_broker
from vernemq_tpu.models.trie import SubscriptionTrie as RefTrie
from vernemq_tpu_torch.admin import cli
from vernemq_tpu_torch.admin.commands import (CommandError, CommandRegistry,
                                              register_core_commands)
from vernemq_tpu_torch.broker.config import Config
from vernemq_tpu_torch.broker.server import start_broker
from vernemq_tpu_torch.client import MQTTClient
from vernemq_tpu_torch.models.trie import SubscriptionTrie

SCHEMAS = [{"mountpoint": "", "topic": "sensors/+/temp",
            "fields": "value:number,unit:enum(c|f)"}]

#: both brokers: the tpu view (the reference's JAX view, the port's GPU
#: view on the CPU) with every flush on the device, the retained index and
#: the predicate phase on their device paths, the admin HTTP API with its
#: key check on, and a Graphite reporter pushing every 0.2 s
BASE = dict(allow_anonymous=True, systree_enabled=False,
            sysmon_enabled=False, default_reg_view="tpu",
            tpu_host_batch_threshold=0, tpu_batch_window_us=500,
            tpu_lock_busy_shed_ms=0, watchdog_collector_expiry_budgets=100,
            payload_schemas=SCHEMAS, predicate_host_threshold=1,
            tpu_retained_host_threshold=0, http_enabled=True, http_port=0,
            graphite_enabled=True, graphite_interval=0.2)

#: fields whose values are timings, ports or pids: compared by presence
TIMING = {"peer_port", "dur_ms", "age_s", "retry_in_s", "time_degraded_s",
          "upload_ms", "operands_ms", "pid", "total_ms", "max_ms", "mean_ms",
          "ring_p50_ms", "ring_p99_ms", "t", "time", "uptime_seconds",
          "heartbeat_age_s", "loop_lag_ms_p99", "started"}
#: fields of the reference's rows the port leaves out (no XLA compiles)
LEFT_OUT = {"compiled"}
#: metrics of the reference the port leaves out: the XLA warm-ups
LEFT_OUT_METRICS = {"tpu_delta_shapes_warmed", "tpu_warmup_batches"}
#: the collector's and the matcher's host-served publish counters
HOST_SERVED = ("tpu_hybrid_host_pubs", "tpu_overload_shed_pubs",
               "tpu_rebuild_shed_pubs", "tpu_busy_shed_pubs",
               "tpu_degraded_host_pubs", "tpu_stalled_host_pubs",
               "tpu_expired_host_pubs", "tpu_host_fallbacks",
               "tpu_degraded_sheds", "tpu_device_failures")


def _norm(x, drop=()):
    """Timing fields kept by presence, ``drop`` fields removed."""
    if isinstance(x, dict):
        return {k: ("<t>" if k in TIMING else _norm(v, drop))
                for k, v in x.items() if k not in drop}
    if isinstance(x, list):
        return [_norm(v, drop) for v in x]
    return x


async def _sink():
    """A Graphite plaintext sink on an ephemeral port: returns (server,
    port, lines received)."""
    lines = []

    async def handle(reader, writer):
        while True:
            ln = await reader.readline()
            if not ln:
                break
            lines.append(ln.decode())
        writer.close()

    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1], lines


async def _script(port_side: bool) -> dict:
    """One broker through the whole script; returns the transcript: each
    command's (normalised) answer and the counters the checks read."""
    if port_side:
        from vernemq_tpu_torch.observability.profiler import profiler
        from vernemq_tpu_torch.robustness import faults
    else:
        from vernemq_tpu.observability.profiler import profiler
        from vernemq_tpu.robustness import faults
    # the dispatch profile and the fault plan are process-global: the
    # script starts from empty ones whatever ran before it in this process
    profiler().reset()
    faults.clear()
    start = start_broker if port_side else ref_start_broker
    conf = Config if port_side else RefConfig
    run_remote = cli.run_remote if port_side else ref_cli.run_remote
    commands = (register_core_commands(CommandRegistry()) if port_side
                else ref_commands(RefRegistry()))
    sink, gport, glines = await _sink()
    kw = {"device": "cpu"} if port_side else {}
    b, s = await start(conf(**BASE, graphite_host="127.0.0.1",
                            graphite_port=gport), port=0, **kw)
    loop = asyncio.get_running_loop()
    base = f"http://127.0.0.1:{b.http.port}"
    out = {}

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    async def admin(*words):
        return await loop.run_in_executor(None, run_remote, base, api_key,
                                          list(words))

    try:
        # the retained index built before the first replayed subscribe,
        # so every replay of the script rides its device path
        await _torch_port.retained_ready(b)
        api_key = commands.run(b, ["api-key", "create"])["table"][0]["key"]
        out["refused without a key"] = await loop.run_in_executor(
            None, get, "/api/v1/node/status")
        c1 = MQTTClient("127.0.0.1", s.port, client_id="c1")
        await c1.connect()
        await c1.subscribe(["a/+", "b/#"], qos=1)
        c2 = MQTTClient("127.0.0.1", s.port, client_id="c2", proto_ver=5)
        await c2.connect()
        await c2.subscribe("sensors/+/temp?$gt(value,30)", qos=1)
        await c1.publish("r/1", b"kept", qos=1, retain=True)
        await c2.subscribe("r/#", qos=1)  # a replay on the device index
        got = [(await c2.recv(10)).payload]
        for v in (25, 55):
            await c1.publish("sensors/a/temp",
                             json.dumps({"value": v}).encode(), qos=1)
        got.append((await c2.recv(10)).payload)
        # trace c2's frames; a one-shot latency fault at device.dispatch
        out["trace client"] = await admin("trace", "client",
                                          "client-id=c2")
        out["fault inject"] = (await admin(
            "fault", "inject", "point=device.dispatch", "kind=latency",
            "latency-ms=1", "count=1"))["type"]
        await c2.publish("a/x", b"hi", qos=1)
        got.append((await c1.recv(10)).payload)
        trace = (await admin("trace", "show"))["text"]["text"]
        out["trace show"] = sorted(ln.split("MQTT ", 1)[1].split("(")[0]
                                   for ln in trace.splitlines()
                                   if " MQTT " in ln)
        out["trace stop"] = await admin("trace", "stop")
        for words in (("session", "show"), ("subscription", "show"),
                      ("watchdog", "show"), ("profile", "device"),
                      ("filter", "show"), ("retain", "index"),
                      ("fault", "show"), ("mesh", "show"),
                      ("webhooks", "show"), ("script", "show"),
                      ("script", "load", "path=x.lua"), ("bridge", "show"),
                      ("plugin", "show"), ("workers", "show")):
            out[" ".join(words[:2])] = _norm(await admin(*words),
                                            drop=LEFT_OUT)
        # the rules and the hits of the seam they name are compared; the
        # other seams' hits count socket reads and periodic ticks, which
        # depend on timing
        out["fault show"]["table"] = [
            r for r in out["fault show"]["table"] if r["rule"] != ""
            or r["point"] in ("device.dispatch", "(wedges)")]
        out["filter at show"] = b.filter_engine.status()
        out["ql query"] = await admin(
            "ql", "query", "q=SELECT client_id, topic, qos FROM "
            "subscriptions WHERE client_id='c1' ORDER BY topic")
        await admin("fault", "clear")
        # breaker drill on the match path: trip → the trie serves, reset →
        # the device serves again
        m = b.registry.reg_views["tpu"].matcher("")
        col = b.batch_collector()
        before = (m.match_publishes, col.degraded_host_pubs)
        out["breaker trip"] = await admin("breaker", "trip", "path=match")
        out["breaker show tripped"] = _norm(await admin("breaker", "show"))
        await c2.publish("a/y", b"on the trie", qos=1)
        got.append((await c1.recv(10)).payload)
        tripped = (m.match_publishes - before[0],
                   col.degraded_host_pubs - before[1])
        out["breaker reset"] = await admin("breaker", "reset", "path=match")
        await c2.publish("b/z", b"on the device", qos=1)
        got.append((await c1.recv(10)).payload)
        reset = (m.match_publishes - before[0],
                 col.degraded_host_pubs - before[1])
        out["breaker drill"] = {"tripped": tripped, "reset": reset,
                                "deliveries": got}
        show = await admin("breaker", "show")
        out["breaker show"] = _norm(show)
        out["port match breaker"] = (show["table"][0], m.breaker.status())
        metrics = {r["metric"]: r["value"]
                   for r in (await admin("metrics", "show"))["table"]}
        out["metrics show"] = metrics
        out["gpu objects"] = dict(
            match_publishes=m.match_publishes,
            match_batches=m.match_batches, rows=m.table.count,
            host=[getattr(col, k) for k in (
                "degraded_host_pubs", "busy_host_pubs", "rebuild_host_pubs",
                "overload_host_pubs", "expired_host_pubs",
                "stalled_host_pubs", "host_hybrid_pubs")],
            retained=b.retained_engine().index("").status())
        status, text = await loop.run_in_executor(None, get, "/metrics")
        out["/metrics"] = (status, sorted(
            {ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE")}))
        # a report taken once the GPU view's matcher exists: the
        # tpu_match_publishes counter is in every report from the first,
        # the table's gauges only from then on
        while not any("tpu_table_rows" in ln for ln in glines):
            await asyncio.sleep(0.05)
        out["graphite"] = {ln.split()[0].rsplit(".", 1)[-1]
                           for ln in glines}
        out["graphite lines"] = list(glines)
        for c in (c1, c2):
            await c.disconnect()
    finally:
        await b.stop()
        await s.stop()
        sink.close()
    return out


@pytest.fixture(scope="module")
def transcripts():
    return {"ref": asyncio.run(_script(False)),
            "port": asyncio.run(_script(True))}


#: the commands whose answers must be equal, timing fields aside
SAME = ["refused without a key", "trace client", "fault inject",
        "trace show", "trace stop", "session show", "subscription show",
        "watchdog show", "filter show", "retain index",
        "fault show", "mesh show", "webhooks show", "script show",
        "script load", "bridge show", "plugin show", "workers show",
        "ql query", "breaker trip", "breaker reset", "breaker drill"]


@pytest.mark.parametrize("cmd", SAME)
def test_admin_answer_equals_reference(transcripts, cmd):
    assert transcripts["port"][cmd] == transcripts["ref"][cmd]


def test_breaker_tables_equal_the_reference(transcripts):
    """``breaker show`` has the reference's rows and fields, before and
    after a trip. The match breaker's ``successes`` differ by design: the
    reference counts its XLA warm-ups as successes, the port has none
    (ROADMAP "No XLA compile bounds"); the port's equals the device
    dispatches its matcher made. The wire codec's breaker is
    process-global, so its counters hold whatever ran before in this
    process: its state is compared."""
    for key in ("breaker show", "breaker show tripped"):
        ref, port = (transcripts[s][key]["table"] for s in ("ref", "port"))
        assert [r["path"] for r in port] == [r["path"] for r in ref]
        for r, p in zip(ref, port):
            assert p.keys() == r.keys()
            if r["path"] == "wire":
                assert p["state"] == r["state"]
                continue
            r, p = dict(r), dict(p)
            if r["path"] == "match":
                assert p.pop("successes") <= r.pop("successes")
            assert p == r
    row, status = transcripts["port"]["port match breaker"]
    assert {k: v for k, v in row.items() if k not in ("path", "mountpoint",
                                                      "retry_in_s",
                                                      "time_degraded_s")} \
        == {k: v for k, v in status.items()
            if k not in ("retry_in_s", "time_degraded_s")}
    assert status["successes"] == transcripts["port"]["gpu objects"][
        "match_batches"]


def test_breaker_trip_serves_on_the_trie_and_reset_on_the_device(
        transcripts):
    """After ``breaker trip path=match`` the publish is delivered and the
    trie served it (the collector's degraded counter, not the matcher);
    after ``breaker reset`` the device serves again."""
    drill = transcripts["port"]["breaker drill"]
    assert drill["tripped"] == (0, 1)
    assert drill["reset"] == (1, 1)
    assert drill["deliveries"] == [b"kept", b'{"value": 55}', b"hi",
                                   b"on the trie", b"on the device"]


def test_profile_device_has_the_reference_records(transcripts):
    """``profile device``: the same dispatch records (kind and fields;
    the HTTP API carries the table, not the summary). The order of the first delta and the
    retained dispatch is the race of two threads, and the reference pads a
    delta's slots to a power of two (``dpad``), the port does not (ROADMAP
    "No XLA compile bounds")."""
    ref, port = (transcripts[s]["profile device"] for s in ("ref", "port"))

    def rows(t):
        return sorted((r["kind"], sorted((k, "<n>" if k == "dpad" else v)
                                         for k, v in r.items()))
                      for r in t["table"])

    assert rows(port) == rows(ref)
    dpad = [[r["dpad"] for r in t["table"] if r["kind"] == "delta"]
            for t in (ref, port)]
    assert all(p <= r for r, p in zip(*dpad))


def test_metrics_show_has_the_reference_names(transcripts):
    ref, port = (set(transcripts[s]["metrics show"]) for s in ("ref", "port"))
    assert ref - port == LEFT_OUT_METRICS
    assert port - ref == set()


def test_device_counters_are_read_from_the_gpu_objects(transcripts):
    """``metrics show`` reports what the port's GPU view, collector,
    retained index and predicate engine hold; nothing was host-served but
    the one publish of the breaker drill."""
    t = transcripts["port"]
    m, gpu = t["metrics show"], t["gpu objects"]
    assert m["tpu_match_publishes"] == gpu["match_publishes"] > 0
    assert m["tpu_match_batches"] == gpu["match_batches"]
    assert m["tpu_table_rows"] == gpu["rows"]
    # the drill's one publish: refused by the open breaker (a degraded
    # shed of the matcher) and served by the trie (the collector)
    assert sum(gpu["host"]) == m["tpu_degraded_host_pubs"] == 1
    assert m["tpu_degraded_sheds"] == 1
    assert sum(m[k] for k in HOST_SERVED) == 2
    assert t["retain index"]["table"][0]["dispatches"] \
        == gpu["retained"]["dispatches"] > 0
    assert t["filter show"]["text"] == _norm(t["filter at show"])
    assert t["filter at show"]["dispatches"] > 0
    assert t["filter at show"]["pairs_host"] == 0
    assert any(r["kind"] == "match" for r in t["profile device"]["table"])


def test_prometheus_and_graphite_carry_the_device_counters(transcripts):
    """``/metrics`` (200, the reference's families, the left-out metrics
    aside) and the Graphite lines both carry the device counters."""
    ref, port = transcripts["ref"], transcripts["port"]
    assert port["/metrics"][0] == ref["/metrics"][0] == 200
    assert set(ref["/metrics"][1]) - set(port["/metrics"][1]) \
        == LEFT_OUT_METRICS
    assert set(port["/metrics"][1]) <= set(ref["/metrics"][1])
    assert {"tpu_match_publishes", "tpu_table_rows",
            "tpu_degraded_host_pubs"} <= port["graphite"]
    assert port["graphite"] - ref["graphite"] <= {"p50", "p99", "p999"}
    for ln in port["graphite lines"]:
        name, value, ts = ln.split()
        assert name.startswith("vmq.node1.") and float(value) == float(value)


async def _plugin_script(port_side: bool, tmp) -> list:
    """Every bundled plugin enabled, driven and disabled through the admin
    commands on one broker; returns each command's answer (or error)."""
    start = start_broker if port_side else ref_start_broker
    conf = Config if port_side else RefConfig
    commands = (register_core_commands(CommandRegistry()) if port_side
                else ref_commands(RefRegistry()))
    errors = (CommandError, ValueError) if port_side else (Exception,)
    kw = {"device": "cpu"} if port_side else {}
    acl, passwd, lua = tmp / "acl", tmp / "passwd", tmp / "s.lua"
    acl.write_text("topic read a/#\n")
    passwd.write_text("")
    lua.write_text("function auth_on_register(reg) return true end\n"
                   "hooks = { auth_on_register = auth_on_register }\n")
    b, s = await start(conf(**BASE), port=0, **kw)
    out = []
    try:
        for words in (
                ["plugin", "show"], ["webhooks", "show"], ["script", "show"],
                ["bridge", "show"],
                ["plugin", "enable", "name=vmq_acl", f"acl_file={acl}"],
                ["plugin", "enable", "name=vmq_passwd",
                 f"passwd_file={passwd}"],
                ["plugin", "enable", "name=vmq_webhooks"],
                ["webhooks", "register", "hook=auth_on_publish",
                 "endpoint=http://127.0.0.1:9/hook"],
                ["webhooks", "show"], ["webhooks", "cache"],
                ["plugin", "enable", "name=vmq_diversity"],
                ["script", "load", f"path={lua}"], ["script", "show"],
                ["plugin", "enable", "name=vmq_mqtt5_demo_plugin"],
                ["plugin", "enable", "name=vmq_bridge"], ["bridge", "show"],
                ["plugin", "show"], ["plugin", "enable", "name=vmq_acl"],
                ["webhooks", "deregister", "hook=auth_on_publish",
                 "endpoint=http://127.0.0.1:9/hook"], ["webhooks", "show"],
                *(["plugin", "disable", f"name={n}"] for n in (
                    "vmq_acl", "vmq_passwd", "vmq_webhooks", "vmq_diversity",
                    "vmq_mqtt5_demo_plugin", "vmq_bridge")),
                ["plugin", "show"], ["webhooks", "show"]):
            try:
                res = commands.run(b, list(words))
            except errors as e:
                res = {"error": type(e).__name__, "text": str(e)}
            out.append((" ".join(words[:2]), res))
    finally:
        await b.stop()
        await s.stop()
    pkg = "vernemq_tpu_torch." if port_side else "vernemq_tpu."
    return json.loads(json.dumps(out).replace(str(tmp), "<tmp>")
                      .replace(pkg, "<pkg>."))


@pytest.mark.asyncio
async def test_plugin_commands_answer_as_without_the_plugin(tmp_path):
    """The bundled plugins are ported (ROADMAP Queue 1 item 11b): before
    a plugin is enabled its commands answer as the reference's do without
    it, and with it enabled ``plugin enable|show|disable``, ``webhooks
    register|show|cache|deregister``, ``script load|show`` and ``bridge
    show`` answer as the reference's do (the plugins' module paths aside),
    down to ``plugin show`` empty again after every plugin is disabled."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = await _plugin_script(False, tmp_path / "ref")
    port = await _plugin_script(True, tmp_path / "port")
    assert port == ref
    shown = dict(port)
    assert shown["plugin show"] == {"table": []}
    assert [r["plugin"] for r in port[16][1]["table"]] == [
        "vmq_acl", "vmq_passwd", "vmq_webhooks", "vmq_diversity",
        "vmq_mqtt5_demo_plugin", "vmq_bridge"]
    assert port[8][1]["table"] == [{
        "hook": "auth_on_publish", "endpoint": "http://127.0.0.1:9/hook",
        "base64payload": True}]


def test_trie_stats_keep_the_reference_node_count():
    """The port's trie keeps its node count as it adds and prunes, so a
    metrics scrape does not walk the trie on the event loop; the count
    equals the reference's walk after every step of a random script."""
    rng = random.Random(7)
    ref, port = RefTrie(), SubscriptionTrie()
    live = []
    for step in range(3000):
        if live and rng.random() < 0.4:
            f, k = live.pop(rng.randrange(len(live)))
            assert port.remove(f, k) == ref.remove(f, k)
        else:
            f, k = _torch_port.rand_filter(rng), f"c{rng.randrange(50)}"
            ref.add(f, k)
            port.add(f, k)
            live.append((f, k))
        if step % 100 == 0:
            assert port.stats() == ref.stats()
    assert port.stats() == ref.stats()
    for f, k in live:
        port.remove(f, k)
        ref.remove(f, k)
    assert port.stats() == ref.stats() and port.stats()["nodes"] == 1


@pytest.mark.asyncio
async def test_workers_show_reads_the_stats_block():
    """``workers show`` in worker mode: one worker slot and the match
    service's header out of the shared stats block, as the reference
    shows them; the port's header carries its off-card counters besides
    (the service's trie-served publishes, failed folds and device
    batches, ROADMAP "Worker mode")."""
    import time

    from vernemq_tpu.broker.server import start_broker as rsb
    from vernemq_tpu.parallel.shm_ring import WorkerStatsBlock as RefBlock
    from vernemq_tpu_torch.parallel.shm_ring import WorkerStatsBlock

    tag = f"aw{time.time_ns() & 0xFFFFFF:x}"
    out = {}
    for side, block_cls, start, conf, commands in (
            ("ref", RefBlock, rsb, RefConfig, ref_commands(RefRegistry())),
            ("port", WorkerStatsBlock, start_broker, Config,
             register_core_commands(CommandRegistry()))):
        stats = block_cls.create(tag + side, 1)
        stats.set_service(3, 4242)
        stats.set_service_counters(10, 4, 7)
        try:
            b, s = await start(conf(
                allow_anonymous=True, systree_enabled=False,
                sysmon_enabled=False, worker_stats_block=stats.name,
                worker_index=0, workers_total=1), port=0, node_name="w0")
            try:
                while not stats.read_all()[0]["pid"]:  # the first heartbeat
                    await asyncio.sleep(0.02)
                out[side] = commands.run(b, ["workers", "show"])
            finally:
                await b.stop()
                await s.stop()
        finally:
            stats.close()
            stats.unlink()
    ref, port = out["ref"], out["port"]
    assert _norm(port["table"]) == _norm(ref["table"])
    assert port["table"][0]["worker"] == 0 and port["table"][0]["alive"]
    extra = set(port["match_service"]) - set(ref["match_service"])
    assert extra == {"host_pubs", "fold_errors", "device_batches"}
    assert {k: v for k, v in port["match_service"].items()
            if k not in extra | TIMING} \
        == {k: v for k, v in ref["match_service"].items() if k not in TIMING}
    assert port["match_service"]["epoch"] == 3
    assert port["match_service"]["host_pubs"] == 0
