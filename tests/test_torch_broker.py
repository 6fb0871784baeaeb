"""The port's broker end to end: MQTT clients over TCP → sessions →
registry → the port's BatchCollector → GpuRegView → GpuMatcher (plain
PyTorch path on the CPU) → delivery, held against the reference broker.

One MQTT script per case runs against the reference broker and against the
port's broker, both in-process on 127.0.0.1 (port 0), through the port's
client; each client's received ``(topic, payload, qos, retain)`` multiset
must be equal. The reference serves the ``wildcards`` case on its JAX tpu
view (on the CPU) and the other cases on its trie view; the port serves
every case on its GPU view (``device="cpu"``, hybrid dispatch off), and its
device matcher must have served the publishes: no host-served publish."""

import asyncio
import collections
import json
import time
import urllib.request

import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread per worker)
from _torch_port import retained_ready
from vernemq_tpu.broker.config import Config as RefConfig
from vernemq_tpu.broker.server import start_broker as ref_start_broker
from vernemq_tpu_torch.broker.broker import Broker
from vernemq_tpu_torch.broker.config import Config
from vernemq_tpu_torch.broker.server import start_broker
from vernemq_tpu_torch.client import MQTTClient
from vernemq_tpu_torch.protocol.types import SubOpts

SCHEMAS = [{"mountpoint": "", "topic": "sensors/+/temp",
            "fields": "value:number,unit:enum(c|f)"}]

#: the config both brokers share: no periodic $SYS traffic or loop-lag
#: sampling, every flush on the device (no hybrid host dispatch, no lock
#: bound — which on the reference also sheds a batch shape JAX has not
#: compiled yet), a queued-item expiry of 5 s so a slow CPU flush is not
#: served by the trie, and every predicate pair on the predicate phase's
#: device path where the broker has one (host threshold 1)
BASE = dict(allow_anonymous=True, systree_enabled=False,
            sysmon_enabled=False, tpu_host_batch_threshold=0,
            tpu_batch_window_us=500, tpu_lock_busy_shed_ms=0,
            watchdog_collector_expiry_budgets=100,
            payload_schemas=SCHEMAS, predicate_host_threshold=1)

#: publishes the collector or the matcher served on the host
COLLECTOR_HOST = ("degraded_host_pubs", "busy_host_pubs", "rebuild_host_pubs",
                  "overload_host_pubs", "expired_host_pubs",
                  "stalled_host_pubs", "host_hybrid_pubs")
MATCHER_HOST = ("host_fallbacks", "degraded_sheds", "device_failures")


async def _client(port, cid, v5=False):
    c = MQTTClient("127.0.0.1", port, client_id=cid, proto_ver=5 if v5 else 4)
    await c.connect()
    return c


async def _drain(c, quiet=0.3):
    """Every PUBLISH the client receives until it has been quiet for
    ``quiet`` seconds."""
    out = []
    while True:
        try:
            m = await asyncio.wait_for(c.messages.get(), quiet)
        except asyncio.TimeoutError:
            return out
        if m is None:
            return out
        out.append((m.topic, bytes(m.payload), m.qos, bool(m.retain)))


#: the end-of-script marker topics: a $-topic, so no wildcard filter of a
#: case matches it (MQTT-4.7.2-1)
MARKER = "$end"


async def _settle(flat, limit=60.0):
    """End a case's script alike on every broker: each client subscribes
    to the marker topics, then each publishes one QoS 1 marker. A broker
    delivers one publisher's messages in order, so a client that holds every
    marker holds every delivery of the script, however slowly the last
    flush ran; it then drains as before. Returns each client's deliveries,
    markers left out."""
    for _, c in flat:
        await c.subscribe(MARKER + "/#", qos=1)
    for i, (_, c) in enumerate(flat):
        # a payload: after a QoS 1 publish with an empty one, the reference
        # broker's stop() waits on that connection forever
        await c.publish(f"{MARKER}/{i}", b"end", qos=1)

    async def one(c):
        out, seen = [], set()
        while len(seen) < len(flat):
            m = await asyncio.wait_for(c.messages.get(), limit)
            assert m is not None, "connection closed before every marker"
            if m.topic.startswith(MARKER + "/"):
                seen.add(m.topic)
            else:
                out.append((m.topic, bytes(m.payload), m.qos,
                            bool(m.retain)))
        return out + [x for x in await _drain(c)
                      if not x[0].startswith(MARKER + "/")]

    return await asyncio.gather(*(one(c) for _, c in flat))


async def _case_wildcards(port):
    a = await _client(port, "a")
    await a.subscribe(["w/+/x", "w/#"], qos=1)
    b = await _client(port, "b", v5=True)
    await b.subscribe("#", qos=2)
    d = await _client(port, "d", v5=True)
    await d.subscribe("$ctl/#", qos=1)
    e = await _client(port, "e")
    await e.subscribe(["+/+/x", "w/b/+", "w/b/x/#"])
    p = await _client(port, "p")
    for i, t in enumerate(["w/a/x", "w/b/x", "w/b/x/y", "w", "v/a/x",
                           "$ctl/a", "$ctl/a/x", "w/b/x"]):
        await p.publish(t, b"m%d" % i, qos=i % 3)
    return {"a": a, "b": b, "d": d, "e": e, "p": p}


async def _case_shared(port):
    s1 = await _client(port, "s1")
    s2 = await _client(port, "s2", v5=True)
    for s in (s1, s2):
        await s.subscribe("$share/g/sh/+", qos=1)
    o = await _client(port, "o")
    await o.subscribe("sh/#")
    p = await _client(port, "p")
    for i in range(12):
        await p.publish(f"sh/{i % 3}", b"s%d" % i, qos=i % 2)
    return {("s1", "s2"): (s1, s2), "o": o, "p": p}


async def _case_v5(port):
    n = await _client(port, "n", v5=True)
    await n.subscribe("nl/t", opts=SubOpts(qos=1, no_local=True))
    m = await _client(port, "m", v5=True)
    await m.subscribe("nl/t", qos=1)
    r = await _client(port, "r", v5=True)
    await r.subscribe("rap/#", opts=SubOpts(qos=1, rap=True))
    r2 = await _client(port, "r2", v5=True)
    await r2.subscribe("rap/#", qos=1)
    for i in range(3):
        await n.publish("nl/t", b"own%d" % i, qos=1)
        await m.publish("nl/t", b"other%d" % i, qos=1)
    await m.publish("rap/t", b"live-retained", qos=1, retain=True)
    await m.publish("rap/u", b"live", qos=0)
    return {"n": n, "m": m, "r": r, "r2": r2}


async def _case_qos(port):
    p = await _client(port, "p", v5=True)
    await p.publish("ret/a", b"kept", qos=1, retain=True)
    await p.publish("ret/b/c", b"kept2", qos=2, retain=True)
    subs = {}
    for q in range(3):
        s = await _client(port, f"q{q}", v5=q == 2)
        await s.subscribe("ret/#", qos=q)  # the retained replay
        subs[f"q{q}"] = s
    for i in range(9):
        await p.publish(f"ret/{'ab'[i % 2]}", b"p%d" % i, qos=i % 3)
    return {**subs, "p": p}


async def _case_filter(port):
    f = await _client(port, "f")
    await f.subscribe("sensors/+/temp?$gt(value,30)", qos=1)
    u = await _client(port, "u")
    await u.subscribe("sensors/+/temp", qos=1)
    p = await _client(port, "p")
    for v in (25, 55, 35, 10, 99):
        await p.publish("sensors/a/temp",
                        json.dumps({"value": v, "unit": "c"}).encode(),
                        qos=1)
    return {"f": f, "u": u, "p": p}


CASES = {"wildcards": _case_wildcards, "shared": _case_shared,
         "v5": _case_v5, "qos": _case_qos, "filter": _case_filter}


async def _run(case, port):
    """Run a case's script and settle it (:func:`_settle`); returns {client
    or group: Counter of deliveries}. A shared group's deliveries are
    counted together: which member gets a message is the policy's
    choice."""
    clients = await CASES[case](port)
    flat = [(k, c) for k, v in clients.items()
            for c in (v if isinstance(v, tuple) else (v,))]
    got = await _settle(flat)
    out = collections.defaultdict(collections.Counter)
    for (k, _), msgs in zip(flat, got):
        out[k].update(msgs)
    for _, c in flat:
        await c.disconnect()
    return dict(out)


def _host_served(b):
    m = b.registry.reg_views["tpu"].matcher("")
    col = b.batch_collector()
    hs = {k: getattr(col, k) for k in COLLECTOR_HOST}
    hs.update({k: getattr(m, k) for k in MATCHER_HOST})
    return m, hs


@pytest.mark.asyncio
@pytest.mark.parametrize("case", list(CASES))
async def test_port_broker_delivers_as_reference(case):
    ref_view = "tpu" if case == "wildcards" else "trie"
    rb, rs = await ref_start_broker(
        RefConfig(**BASE, default_reg_view=ref_view), port=0)
    try:
        want = await _run(case, rs.port)
        if ref_view == "tpu":  # the JAX device path served the script
            rm, rhs = _host_served(rb)
            assert rm.match_publishes > 0 and not any(rhs.values()), rhs
    finally:
        await rb.stop()
        await rs.stop()
    pb, ps = await start_broker(Config(**BASE, default_reg_view="tpu"),
                                port=0, device="cpu")
    try:
        got = await _run(case, ps.port)
        m, hs = _host_served(pb)
        assert pb.registry.batched_view_active()
        assert m.match_publishes > 0 and not any(hs.values()), hs
        eng = pb.filter_engine
        if case == "filter":  # the predicate phase ran on the device path
            assert eng.dispatches > 0 and eng.pairs_host == 0, eng.stats()
    finally:
        await pb.stop()
        await ps.stop()
    assert got == want
    assert sum(sum(c.values()) for c in got.values()) > 0


@pytest.mark.asyncio
async def test_slow_last_flush_is_waited_for_not_cut(monkeypatch):
    """The v5 case ends on a QoS 0 publish. With the port's flush of it
    delayed 0.6 s (a stand-in for a loaded machine), the client receives it
    late but receives it: the settled script waits for it, and the
    deliveries equal the reference's. A fixed quiet period of 0.3 s alone
    would have ended before it arrived."""
    from vernemq_tpu_torch.models.matcher import GpuMatcher
    from vernemq_tpu_torch.robustness import faults as PF

    delayed = []  # the topics of each matcher call the rule fired in

    def record(name):
        impl = getattr(GpuMatcher, name)

        def wrapped(self, batches, *a, **kw):
            before = rule.fired
            try:
                return impl(self, batches, *a, **kw)
            finally:
                if rule.fired != before:
                    flat = batches if name == "_match_batch_impl" else \
                        [t for b in batches for t in b]
                    delayed.append({"/".join(t) for t in flat})
        monkeypatch.setattr(GpuMatcher, name, wrapped)

    rb, rs = await ref_start_broker(
        RefConfig(**BASE, default_reg_view="trie"), port=0)
    try:
        want = await _run("v5", rs.port)
    finally:
        await rb.stop()
        await rs.stop()
    pb, ps = await start_broker(Config(**BASE, default_reg_view="tpu"),
                                port=0, device="cpu")
    # the script's eighth device dispatch is the final rap/u publish's:
    # six QoS 1 nl/t publishes and the retained rap/t before it, one each
    rule = PF.FaultRule("device.dispatch", kind="latency", after=7,
                        count=1, latency_ms=600)
    for name in ("_match_batch_impl", "_match_many_impl"):
        record(name)
    PF.install(PF.FaultPlan([rule], seed=1))
    try:
        t0 = time.monotonic()
        got = await _run("v5", ps.port)
        took = time.monotonic() - t0
        m, hs = _host_served(pb)
        assert m.match_publishes > 0 and not any(hs.values()), hs
    finally:
        PF.clear()
        await pb.stop()
        await ps.stop()
    assert rule.fired == 1 and took > 0.6
    # the delayed flush is the final publish's, whatever the collector
    # merged into it
    assert delayed and all("rap/u" in topics for topics in delayed), delayed
    assert got == want
    assert got["r"][("rap/u", b"live", 0, False)] == 1


async def _case_retained(port):
    """Retained replay on SUBSCRIBE (port of test_retained_index.py::
    test_broker_replay_semantics_device_path): retain_handling 2 (never) and
    1 (new subscriptions only), no replay to a shared subscription, a root
    wildcard skips $-topics while a concrete $SYS filter replays, and a
    multi-filter SUBSCRIBE whose filters ride one replay flush."""
    p = await _client(port, "rp", v5=True)
    for topic, payload in (("rh/t", b"kept"), ("rh/u/v", b"deep"),
                           ("$SYS/stat", b"sys"), ("other/x", b"o")):
        await p.publish(topic, payload, qos=1, retain=True)
    c = await _client(port, "rs", v5=True)
    await c.subscribe("rh/t", opts=SubOpts(qos=0, retain_handling=2))
    await c.subscribe("rh/+", opts=SubOpts(qos=0, retain_handling=1))
    await c.subscribe("rh/+", opts=SubOpts(qos=0, retain_handling=1))
    await c.subscribe("$share/grp/rh/t", qos=0)
    await c.subscribe("#", qos=0)
    await c.subscribe("$SYS/stat", qos=1)
    d = await _client(port, "rd")
    await d.subscribe(["rh/#", "+/x", "+/+/v", "other/+", "$SYS/+"], qos=1)
    return {"p": p, "c": c, "d": d}


@pytest.mark.asyncio
async def test_retained_replays_ride_the_device_collector_on_both_brokers():
    """The retained case on both brokers' GPU/TPU views with every replay
    flush on the device (host threshold 0): equal deliveries, and on both
    the replay collector's device path served the filters, with no
    degraded, rebuild, stalled or expired replay. Each client waits for
    the replays it is due (the reference compiles its first replay shapes
    meanwhile), then for any more within the quiet period."""
    cfg = dict(BASE, default_reg_view="tpu", tpu_retained_host_threshold=0,
               tpu_retained_window_us=100)
    due = {"c": 5, "d": 6}
    results, stats = [], []
    for start, Cfg, kw in ((ref_start_broker, RefConfig, {}),
                           (start_broker, Config, {"device": "cpu"})):
        b, s = await start(Cfg(**cfg), port=0, **kw)
        try:
            await retained_ready(b)
            clients = await _case_retained(s.port)
            got = {}
            for name, c in clients.items():
                msgs = []
                for _ in range(due.get(name, 0)):
                    m = await asyncio.wait_for(c.messages.get(), 60)
                    msgs.append((m.topic, bytes(m.payload), m.qos,
                                 bool(m.retain)))
                got[name] = collections.Counter(msgs + await _drain(c))
            for c in clients.values():
                await c.disconnect()
            results.append(got)
            stats.append(b._retained_collector.stats())
        finally:
            await b.stop()
            await s.stop()
    assert results[0] == results[1]
    assert {k: sum(v.values()) for k, v in results[1].items()} == \
        {"p": 0, **due}
    for st in stats:
        assert st["retained_replay_device_filters"] > 0, st
        assert not any(st[f"retained_replay_{k}_filters"] for k in (
            "degraded", "rebuild", "stalled", "expired", "host")), st
    keys = ("retained_replay_device_filters",
            "retained_replay_fallback_filters")
    assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys]


@pytest.mark.asyncio
async def test_broker_e2e_with_gpu_reg_view():
    """Port of test_tpu_match.py::test_broker_e2e_with_tpu_reg_view: real
    MQTT over TCP routes through the batched device matcher."""
    b, server = await start_broker(
        Config(systree_enabled=False, allow_anonymous=True,
               default_reg_view="tpu", tpu_batch_window_us=500,
               tpu_host_batch_threshold=0),
        port=0, device="cpu")
    try:
        sub = MQTTClient(server.host, server.port, "tpu-sub")
        await sub.connect()
        await sub.subscribe("tpu/+/x", qos=1)
        pub = MQTTClient(server.host, server.port, "tpu-pub")
        await pub.connect()
        for i in range(5):
            await pub.publish(f"tpu/{i}/x", f"m{i}".encode(), qos=1)
        got = sorted([(await sub.recv()).payload for _ in range(5)])
        assert got == [f"m{i}".encode() for i in range(5)]
        # no warm gate in the port: every flush went to the device
        m = b.registry.reg_view("tpu").matcher("")
        assert m.match_publishes >= 5, (m.match_publishes, m.busy_sheds)
        await sub.disconnect()
        await pub.disconnect()
    finally:
        await b.stop()
        await server.stop()


@pytest.mark.asyncio
async def test_hybrid_dispatch_small_flush_serves_host_side():
    """Port of test_tpu_match.py::test_hybrid_dispatch_small_flush_serves_
    host_side: flushes at or below tpu_host_batch_threshold resolve on the
    host trie; the device matcher sees nothing and delivery is exact."""
    b, server = await start_broker(
        Config(systree_enabled=False, allow_anonymous=True,
               default_reg_view="tpu", tpu_batch_window_us=200,
               tpu_host_batch_threshold=8),
        port=0, device="cpu")
    try:
        sub = MQTTClient(server.host, server.port, "hy-sub")
        await sub.connect()
        await sub.subscribe("hy/+/x", qos=1)
        pub = MQTTClient(server.host, server.port, "hy-pub")
        await pub.connect()
        for i in range(4):  # sequential QoS1: one-pub flushes
            await pub.publish(f"hy/{i}/x", f"m{i}".encode(), qos=1)
        got = sorted([(await sub.recv()).payload for _ in range(4)])
        assert got == [f"m{i}".encode() for i in range(4)]
        col = b.batch_collector()
        assert col.host_hybrid_pubs >= 4
        mm = b.registry.reg_view("tpu")._matchers.get("")
        assert mm is None or mm.match_publishes == 0
        await sub.disconnect()
        await pub.disconnect()
    finally:
        await b.stop()
        await server.stop()


@pytest.mark.asyncio
async def test_per_publisher_order_preserved_under_slow_device():
    """Port of test_batch_collector.py::test_per_publisher_order_preserved_
    under_slow_device: one publisher streams QoS0 publishes through the
    batched device view while device batches of variable latency race in
    the two pipeline slots; the subscriber sees every message in order."""
    b, s = await start_broker(
        Config(systree_enabled=False, allow_anonymous=True,
               default_reg_view="tpu", sysmon_enabled=False,
               tpu_batch_window_us=2000, tpu_host_batch_threshold=2,
               tpu_lock_busy_shed_ms=0),
        port=0, device="cpu")
    try:
        view = b.registry.reg_view("tpu")
        m = view.matcher("")
        orig = m.match_batch
        calls = []

        def slow_match(topics, lock_timeout=None):
            calls.append(len(topics))
            # odd batches are much slower than even ones, so a newer
            # batch finishes before an older one: the reorder window the
            # submission-order release must absorb
            time.sleep(0.08 if len(calls) % 2 else 0.005)
            return orig(topics, lock_timeout=lock_timeout)

        m.match_batch = slow_match
        sub = MQTTClient(s.host, s.port, "ord-sub")
        await sub.connect()
        await sub.subscribe("ord/#", qos=0)
        await asyncio.sleep(0.2)
        pub = MQTTClient(s.host, s.port, "ord-pub")
        await pub.connect()
        n = 120
        for i in range(n):
            await pub.publish("ord/t", b"%04d" % i, qos=0)
            if i % 10 == 0:
                await asyncio.sleep(0.005)  # spread across batch windows
        got = []
        for _ in range(n):
            f = await sub.recv(10.0)
            assert f is not None
            got.append(int(f.payload))
        assert got == list(range(n))
        assert len(calls) >= 2
        await sub.disconnect()
        await pub.disconnect()
    finally:
        await b.stop()
        await s.stop()


@pytest.mark.asyncio
@pytest.mark.parametrize("qos", [0, 1])
async def test_stop_returns_after_an_empty_payload_delivery(qos):
    """A PUBLISH with an empty payload delivered to a client that then
    disconnects does not hang ``Broker.stop()``/``MQTTServer.stop()``:
    the transport drops an empty last chunk before the socket transport's
    buffer would keep it forever (ROADMAP Queue 3). Bounded by a time
    limit, so a regression fails instead of hanging the run."""
    b, s = await start_broker(Config(**BASE, default_reg_view="tpu"),
                              port=0, device="cpu")
    stopped = False
    try:
        sub = await _client(s.port, "empty-sub")
        await sub.subscribe("e/#", qos=qos)
        pub = await _client(s.port, "empty-pub", v5=True)
        await pub.publish("e/x", b"", qos=qos)
        m = await sub.recv(10.0)
        assert (m.topic, bytes(m.payload), m.qos) == ("e/x", b"", qos)
        await sub.disconnect()
        await pub.disconnect()
        await asyncio.wait_for(b.stop(), 10)
        await asyncio.wait_for(s.stop(), 10)
        stopped = True
    finally:
        if not stopped:
            s._server.close()


def test_gpu_view_without_a_card_raises(monkeypatch):
    """No probe, no silent trie: the default device is the card, and a
    broker whose default view is the GPU view raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Broker(Config(default_reg_view="tpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Broker(Config(reg_views=["trie", "tpu"]))
    assert Broker(Config()).device is None  # the trie view needs no card


@pytest.mark.asyncio
@pytest.mark.parametrize("knob", [
    dict(tpu_mesh="2x4"), dict(metadata_plugin="swc"),
    dict(http_enabled=True), dict(graphite_enabled=True),
    dict(bridges=[{"name": "br0", "host": "127.0.0.1", "port": 1}]),
    dict(plugins=[{"name": "vmq_acl"}]), dict(observability_enabled=False)],
    ids=lambda k: next(iter(k)))
async def test_unported_configs_raise(knob, tmp_path):
    """No configuration is refused since the bundled plugins were ported
    (ROADMAP Queue 1 item 11b): each of these knobs boots a broker on the
    GPU view that delivers a publish. A device mesh (the mesh-native seat,
    on the CPU repeated), the SWC metadata store, the admin HTTP API, the
    Graphite reporter, observability off, a conf-file bridge (to a remote
    that is not there: its link retries while local traffic is served) and
    a conf-file plugin (vmq_acl with an ACL file that lets the client read
    and write its topics) each boot as the reference's do. (Worker mode,
    item 9, is served too: test_torch_workers.py.)"""
    from vernemq_tpu_torch.observability import histogram as hist

    name = next(iter(knob))
    if name == "plugins":
        acl = tmp_path / "acl"
        acl.write_text("topic k/#\n")
        knob = dict(plugins=[{"name": "vmq_acl",
                              "opts": {"acl_file": str(acl)}}])
    b, s = await start_broker(Config(**BASE, default_reg_view="tpu",
                                     http_port=0, **knob),
                              port=0, device="cpu")
    try:
        c = await _client(s.port, "k")
        await c.subscribe("k/+", qos=1)
        if name == "metadata_plugin":
            from vernemq_tpu_torch.broker.subscriber_db import PREFIX
            from vernemq_tpu_torch.cluster.swc_store import SWCMetadata

            assert isinstance(b.metadata, SWCMetadata)
            assert b.metadata.get(PREFIX, ("", "k")) is not None
        await c.publish("k/x", b"served", qos=1)
        assert (await c.recv(10)).payload == b"served"
        await c.disconnect()
        m, hs = _host_served(b)
        assert m.match_publishes > 0 and not any(hs.values()), hs
        if name == "http_enabled":
            loop = asyncio.get_running_loop()
            url = f"http://127.0.0.1:{b.http.port}/health"
            body = await loop.run_in_executor(
                None, lambda: urllib.request.urlopen(url, timeout=5).read())
            assert json.loads(body) == {"status": "OK"}
        elif name == "graphite_enabled":
            assert b.graphite is not None and not b.graphite._task.done()
        elif name == "observability_enabled":
            assert not hist.enabled()
        elif name == "bridges":
            assert b.plugins.get("vmq_bridge").show()[0]["name"] == "br0"
        elif name == "plugins":
            assert [n for n, _ in b.plugins.show()] == ["vmq_acl"]
        elif name == "tpu_mesh":
            from vernemq_tpu_torch.parallel.mesh_match import MeshGpuMatcher

            assert isinstance(m, MeshGpuMatcher)
            assert m.mesh.shape == {"batch": 2, "sub": 4}
    finally:
        await b.stop()
        await s.stop()
        hist.set_enabled(True)


@pytest.mark.asyncio
@pytest.mark.parametrize("knob", ["worker_stats_block",
                                  "match_service_req_ring"])
async def test_worker_mode_configs_are_served(knob):
    """Worker mode (ROADMAP item 9) is served, no longer refused: a broker
    configured as worker 0 of a group attaches the shared stats block and,
    with the match-service rings, mounts the ring stub as its tpu view —
    resolving no device, so its predicate phase stays on the exact host
    evaluator — and delivers through the port's match service on the GPU
    match engine (``device="cpu"``; a thread stands in for the service
    process)."""
    import threading

    from vernemq_tpu_torch.broker.match_service import (MatchService,
                                                        ShmMatchView)
    from vernemq_tpu_torch.parallel.shm_ring import ShmRing, WorkerStatsBlock

    tag = f"bw{time.time_ns() & 0xFFFFFF:x}"
    stats = WorkerStatsBlock.create(tag + "s", 1)
    stats.set_service(1, 4242)
    cfg = dict(BASE, worker_stats_block=stats.name, worker_index=0,
               workers_total=1)
    rings, svc, stop, th = [], None, threading.Event(), None
    if knob == "match_service_req_ring":
        rings = [ShmRing.create(tag + "q", 1 << 20),
                 ShmRing.create(tag + "r", 1 << 20)]
        svc = MatchService(stats, [(ShmRing.attach(rings[0].name),
                                    ShmRing.attach(rings[1].name))],
                           view="tpu", device="cpu",
                           tpu_opts=dict(max_levels=8))
        svc._view.matcher("")

        def serve():
            async def run():
                ev = asyncio.Event()
                task = asyncio.get_running_loop().create_task(svc.run(ev))
                while not stop.is_set():
                    await asyncio.sleep(0.01)
                ev.set()
                await task
            asyncio.run(run())

        th = threading.Thread(target=serve, daemon=True)
        th.start()
        cfg.update(match_service_req_ring=rings[0].name,
                   match_service_resp_ring=rings[1].name,
                   default_reg_view="tpu", tpu_retained_enabled=False)
    try:
        b, s = await start_broker(Config(**cfg), port=0, node_name="w0")
        try:
            assert b.worker_stats is not None and b.device is None
            f = await _client(s.port, "f")
            await f.subscribe("sensors/+/temp?$gt(value,30)", qos=1)
            u = await _client(s.port, "u")
            await u.subscribe("w/#", qos=1)
            p = await _client(s.port, "p")
            if svc is not None:
                assert isinstance(b.registry.reg_views["tpu"], ShmMatchView)
                deadline = time.monotonic() + 20.0
                while svc.subscriptions() < 2:  # the owned rows' resync
                    assert time.monotonic() < deadline
                    await asyncio.sleep(0.05)
            for v in (25, 55):
                await p.publish("sensors/a/temp",
                                json.dumps({"value": v}).encode(), qos=1)
            assert json.loads((await f.recv(5.0)).payload)["value"] == 55
            for i in range(3):
                await p.publish(f"w/{i}", b"%d" % i, qos=1)
                assert (await u.recv(5.0)).payload == b"%d" % i
            eng = b.filter_engine
            assert eng.dispatches == 0 and eng.pairs_host >= 2
            if svc is not None:
                assert svc.folds > 0 and b.match_client.folds_sent > 0
                m = svc._view.matcher("")
                assert m.match_publishes > 0 and not m.host_fallbacks
            for c in (f, u, p):
                await c.disconnect()
        finally:
            await b.stop()
            await s.stop()
    finally:
        stop.set()
        if th is not None:
            th.join(5.0)
            svc.close()
        for h in rings:
            h.close()
            h.unlink()
        stats.close()
        stats.unlink()


@pytest.mark.asyncio
async def test_observability_off_delivers_as_reference():
    """``observability_enabled`` off: the port's broker delivers what the
    reference's delivers on the same script, and no histogram of the
    port's records an observation (each seam is one boolean test)."""
    from vernemq_tpu.observability import histogram as ref_hist
    from vernemq_tpu_torch.observability import histogram as hist
    from vernemq_tpu_torch.observability.profiler import profiler

    rb, rs = await ref_start_broker(
        RefConfig(**BASE, default_reg_view="trie",
                  observability_enabled=False), port=0)
    try:
        want = await _run("shared", rs.port)
    finally:
        await rb.stop()
        await rs.stop()
        ref_hist.set_enabled(True)
    hist.reset_all()
    profiler().reset()
    pb, ps = await start_broker(Config(**BASE, default_reg_view="tpu",
                                       observability_enabled=False),
                                port=0, device="cpu")
    try:
        got = await _run("shared", ps.port)
        m, hs = _host_served(pb)
        assert m.match_publishes > 0 and not any(hs.values()), hs
        observed = {name: n for name, (_c, _s, n)
                    in hist.snapshot_all().items() if n}
        assert not hist.enabled() and observed == {}
        assert profiler().snapshot() == []
    finally:
        await pb.stop()
        await ps.stop()
        hist.set_enabled(True)
    assert got == want


@pytest.mark.asyncio
@pytest.mark.parametrize("kind", ["http", "vmq"])
async def test_unported_listener_kinds_raise(kind):
    """No listener kind is refused since items 11a and 11c: a conf-file
    listener of the admin kind serves the HTTP endpoints, one of the
    cluster kind starts the cluster channel."""
    b = Broker(Config(allow_anonymous=True, systree_enabled=False,
                      sysmon_enabled=False,
                      listeners=[{"kind": kind, "addr": "127.0.0.1",
                                  "port": 0}]))
    try:
        await b.start()
        (row,) = b.listeners.show()
        assert row["type"] == kind and row["status"] == "running", row
        if kind == "http":
            loop = asyncio.get_running_loop()
            url = f"http://127.0.0.1:{row['port']}/status.json"
            body = await loop.run_in_executor(
                None, lambda: urllib.request.urlopen(url, timeout=5).read())
            assert json.loads(body)["node"] == "node1"
        else:
            assert b.cluster is not None and b.cluster.listen_port \
                == row["port"]
    finally:
        if b.cluster is not None:
            await b.cluster.stop()
        await b.stop()


@pytest.mark.parametrize("enabled", [True, False])
def test_breaker_knob_reaches_the_gpu_view(enabled):
    """tpu_breaker_enabled means what it means to the reference: off, the
    matcher has no breaker and a device error reaches the caller."""
    from vernemq_tpu_torch.robustness.breaker import CircuitBreaker

    b = Broker(Config(default_reg_view="tpu", tpu_breaker_enabled=enabled,
                      tpu_breaker_failure_threshold=5), device="cpu")
    br = b.registry.reg_view("tpu").matcher("").breaker
    if enabled:
        assert isinstance(br, CircuitBreaker) and br.failure_threshold == 5
    else:
        assert br is None


def test_gpu_view_close_joins_a_background_rebuild():
    """GpuRegView.close, called by Broker.stop: a running background
    rebuild is joined and respawns no more."""
    import threading

    from vernemq_tpu_torch.models.matcher import (GpuRegView,
                                                  RebuildInProgress)
    from vernemq_tpu_torch.models.trie import SubscriptionTrie

    class Reg:
        def fold_subscriptions(self, mp):
            return iter(())

        def trie(self, mp):
            return SubscriptionTrie()

    view = GpuRegView(Reg(), max_levels=4, initial_capacity=64,
                      device="cpu")
    m = view.matcher("")
    m.table.add(["a"], "k0", None)
    view.fold_batch("", [("a",)])  # the first build, inline
    barrier = threading.Event()
    m._rebuild_barrier = barrier
    for i in range(200):  # outgrow the capacity: a background rebuild
        m.table.add(["b", str(i)], f"g{i}", None)
    with pytest.raises(RebuildInProgress):
        view.fold_batch("", [("a",)])
    th = m._rebuild_thread
    assert th is not None and th.is_alive()
    threading.Timer(0.1, barrier.set).start()
    view.close()
    assert not th.is_alive() and m._closed


@pytest.mark.asyncio
async def test_flight_recorder_stamps_the_collector_stages():
    """A sampled publish (every one, at sample_n 1) carries the
    collector's submit / dequeue / match stamps between the session's
    admit and the route, at QoS 0 (routed when the batch resolves) and
    QoS 1 (awaited in the session)."""
    b, s = await start_broker(
        Config(**BASE, default_reg_view="tpu", flight_recorder_sample_n=1),
        port=0, device="cpu")
    try:
        sub = await _client(s.port, "rec-sub")
        await sub.subscribe("rec/#", qos=1)
        pub = await _client(s.port, "rec-pub")
        for q in (0, 1):
            await pub.publish("rec/t", b"x", qos=q)
            assert (await sub.recv()).payload == b"x"
        recs = [r for r in b.recorder.snapshot() if r["topic"] == "rec/t"]
        assert sorted(r["qos"] for r in recs) == [0, 1]
        for r in recs:
            assert [label for label, _ in r["marks"]] == [
                "start", "admit", "submit", "dequeue", "match", "route"], r
        await sub.disconnect()
        await pub.disconnect()
    finally:
        await b.stop()
        await s.stop()


def _walks(kept=(), gen=2):
    """A ``gc.callbacks`` hook and its record: at the start of each
    collection of ``gen``, the objects it walks and how many of ``kept``
    (loaded objects) are among them rather than frozen."""
    import gc

    seen = []

    def hook(phase, info):
        if phase == "start" and info["generation"] == gen:
            walked = gc.get_objects()
            ids = {id(o) for o in walked}
            seen.append((len(walked), sum(id(o) in ids for o in kept)))

    return hook, seen


async def _bulk_loaded_broker(n_ids=200, per_id=100):
    """A CPU broker whose GPU view holds ``n_ids * per_id`` subscriptions
    registered under ``n_ids`` subscriber ids after its matcher exists (so
    the table fills in order); nothing is built on the device yet."""
    b, s = await start_broker(Config(**BASE, default_reg_view="tpu"),
                              port=0, device="cpu")
    reg = b.registry
    view = reg.reg_view("tpu")
    m = view.matcher("")  # empty: the load below fills it in order
    for i in range(n_ids):
        reg.subscribe(("", f"bulk{i}"), _bulk_filters(i, per_id))
    assert m.table.count == n_ids * per_id
    return b, s, view, m


def _bulk_filters(i, per_id):
    opts = SubOpts(qos=0)
    return [([f"r{i % 16}", f"d{j}", "+" if j % 3 else f"m{i}"], opts)
            for j in range(per_id)]


def _publish_load(view, n=8):
    rows = [view.fold_batch("", [(f"r{i % 16}", f"d{j}", f"m{i}")
                                 for j in range(32)]) for i in range(n)]
    assert sum(len(r) for batch in rows for r in batch) > 0


@pytest.mark.asyncio
async def test_bulk_load_freezes_the_heap_by_the_brokers_policy():
    """The broker's full-collection policy (broker/heap.py): after a bulk
    load of 20,000 subscriptions the GPU view's first build collects once
    and freezes the heap, so the loaded table sits in the permanent
    generation and a full collection during the following publish load
    walks only what the load allocated; the broker's stop unfreezes it.
    Object counts, not wall time."""
    import gc

    b, s, view, m = await _bulk_loaded_broker()
    reg = b.registry
    try:
        r0 = b.heap.refreezes
        view.fold_batch("", [("r1", "d1", "m1")])  # the first build
        assert b.heap.refreezes == r0 + 1, b.heap.status()
        assert "first build of 20000 rows" in b.heap.last_reason
        frozen = gc.get_freeze_count()
        assert frozen >= m.table.count and b.heap.frozen >= frozen
        loaded = (m.table.entries, m._entries_snapshot, reg.trie("")._root,
                  *(e for e in m.table.entries[:64] if gc.is_tracked(e)))
        unfrozen = {id(o) for o in gc.get_objects()}
        assert not any(id(o) in unfrozen for o in loaded)
        hook, walked = _walks(loaded)
        gc.callbacks.append(hook)
        try:
            _publish_load(view)
            gc.collect()  # a full collection during the load
        finally:
            gc.callbacks.remove(hook)
        assert walked and max(n for n, _ in walked) < frozen // 10, \
            (walked, frozen)
        assert all(k == 0 for _, k in walked), walked
        assert b.heap.refreezes == r0 + 1  # the publish load freezes nothing
    finally:
        await b.stop()
        await s.stop()
    assert gc.get_freeze_count() == 0


@pytest.mark.asyncio
async def test_a_delta_of_10k_rows_under_publish_load_walks_no_frozen_heap():
    """A live burst between two flushes (10,000 subscriptions removed and
    added again, a delta sync of 10,000 slots each way, no resize) during
    a publish load: the heap policy does not re-freeze, every full
    collection of the load runs with the loaded heap still frozen and
    walks only the unfrozen objects. Object counts, not wall time."""
    import gc

    b, s, view, m = await _bulk_loaded_broker()
    reg = b.registry
    try:
        view.fold_batch("", [("r1", "d1", "m1")])  # the first build
        r0, frozen, cap = b.heap.refreezes, gc.get_freeze_count(), m.table.cap
        # the loaded routing trie's nodes, all frozen by the first build
        kept, stack = [m.table.entries], [reg.trie("")._root]
        while stack:
            kept.append(stack.pop())
            stack.extend(kept[-1].children.values())
        assert len(kept) > 1000
        hook, walked = _walks(kept)
        gc.callbacks.append(hook)
        try:
            for i in range(100):  # 10,000 subscriptions go
                reg.unsubscribe(("", f"bulk{i}"),
                                [f for f, _ in _bulk_filters(i, 100)])
            assert len(m.table.dirty) >= 10_000
            _publish_load(view)  # the delta lands on the first fold
            gc.collect()
            for i in range(100):  # and come back
                reg.subscribe(("", f"bulk{i}"), _bulk_filters(i, 100))
            assert len(m.table.dirty) >= 10_000
            _publish_load(view)
            gc.collect()
        finally:
            gc.callbacks.remove(hook)
        assert m.table.cap == cap and not m.table.dirty
        assert b.heap.refreezes == r0, b.heap.status()
        assert len(walked) >= 2
        assert all(k == 0 for _, k in walked), walked
        assert max(n for n, _ in walked) < frozen // 4, (walked, frozen)
        # a second broker of the process (a bridge's far end): its first
        # build of a few rows is no reason to walk the frozen heap again
        b2, s2 = await start_broker(Config(**BASE, default_reg_view="tpu"),
                                    port=0, device="cpu")
        # nor is the check that skips it: gc.get_freeze_count() walks the
        # whole permanent generation (CPython 3.12), never asked there
        counted, real_count = [], gc.get_freeze_count
        try:
            skipped = b.heap.skipped
            b2.registry.subscribe(("", "far"), _bulk_filters(0, 4))
            gc.get_freeze_count = lambda: counted.append(1) or real_count()
            try:
                rows = b2.registry.reg_view("tpu").fold_batch(
                    "", [("r0", "d1", "m0")])  # b2's first build
            finally:
                gc.get_freeze_count = real_count
            assert not counted
            assert [k for _f, k, _o in rows[0]] == [("", "far")]
            assert b2.registry.reg_view("tpu").matcher("").warm_ms \
                is not None
            assert b.heap.refreezes == r0 and b.heap.skipped == skipped + 1
        finally:
            await b2.stop()
            await s2.stop()
        assert gc.get_freeze_count() > 0  # b still holds it
    finally:
        await b.stop()
        await s.stop()
    assert gc.get_freeze_count() == 0
