"""The port's multi-node plane: a two-node port cluster (the GPU view on
the CPU on both nodes, ``metadata_plugin=swc``) delivers what a two-node
reference cluster delivers on the same MQTT script — cross-node pubsub, a
``$share`` group across the nodes, an unsubscribe that propagates. The port
is joined once through a ``vmq`` listener in the conf (and the admin
``cluster join`` command) and once through
``start_broker(cluster_listen=, join=)``, the path of ``server.py``'s
``--cluster-listen``/``--join``. On the port, each node's GPU table takes
the peer's subscriptions as node-pointer rows through the view's delta
path, and each node's device matches every publish that arrives at it (a
forwarded one is folded on the receiver's trie, as in the reference)."""

import asyncio
import collections
import time

import pytest

import _torch_port  # noqa: F401  (one intra-op thread per worker)
from vernemq_tpu.broker.config import Config as RefConfig
from vernemq_tpu.broker.server import start_broker as ref_start_broker
from vernemq_tpu_torch.admin.commands import (CommandRegistry,
                                              register_core_commands)
from vernemq_tpu_torch.broker.config import Config
from vernemq_tpu_torch.broker.server import start_broker
from vernemq_tpu_torch.client import MQTTClient

#: both clusters: the SWC store with a short anti-entropy interval; the
#: port's nodes serve on the GPU view (every flush on the device, the wide
#: expiry of the CPU tests)
BASE = dict(allow_anonymous=True, systree_enabled=False,
            sysmon_enabled=False, metadata_plugin="swc",
            swc_sync_interval=0.2)
PORT = dict(default_reg_view="tpu", tpu_host_batch_threshold=0,
            tpu_batch_window_us=500, watchdog_collector_expiry_budgets=100)
COLLECTOR_HOST = ("degraded_host_pubs", "busy_host_pubs", "rebuild_host_pubs",
                  "overload_host_pubs", "expired_host_pubs",
                  "stalled_host_pubs", "host_hybrid_pubs")


async def _until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.02)


async def _nodes(side: str):
    """Two started nodes A and B, B joined to A: ``ref`` (the reference's
    start_broker), ``port`` (the port's start_broker with cluster_listen
    and join) or ``port-conf`` (a vmq listener in each node's conf, B
    joined by the admin ``cluster join`` command)."""
    if side == "ref":
        a, sa = await ref_start_broker(RefConfig(**BASE), port=0,
                                       node_name="A",
                                       cluster_listen=("127.0.0.1", 0))
        b, sb = await ref_start_broker(
            RefConfig(**BASE), port=0, node_name="B",
            cluster_listen=("127.0.0.1", 0),
            join=(a.cluster.listen_host, a.cluster.listen_port))
    elif side == "port":
        a, sa = await start_broker(Config(**BASE, **PORT), port=0,
                                   node_name="A", device="cpu",
                                   cluster_listen=("127.0.0.1", 0))
        b, sb = await start_broker(
            Config(**BASE, **PORT), port=0, node_name="B", device="cpu",
            cluster_listen=("127.0.0.1", 0),
            join=(a.cluster.listen_host, a.cluster.listen_port))
    else:
        conf = dict(BASE, **PORT, listeners=[
            {"kind": "vmq", "addr": "127.0.0.1", "port": 0}])
        a, sa = await start_broker(Config(**conf), port=0, node_name="A",
                                   device="cpu")
        b, sb = await start_broker(Config(**conf), port=0, node_name="B",
                                   device="cpu")
        reg = register_core_commands(CommandRegistry())
        reg.run(b, ["cluster", "join", "discovery-node=127.0.0.1:"
                    f"{a.cluster.listen_port}"])
    await _until(lambda: all(len(n.cluster.members()) == 2
                             and n.cluster.is_ready() for n in (a, b)))
    return (a, sa), (b, sb)


def _pointer(node, words, peer):
    """True when ``node``'s routing trie holds ``peer``'s node-pointer
    row for a filter matching ``words``."""
    return any(k == peer for _f, k, _o in node.registry.trie("").match(words))


async def _script(side: str):
    """The MQTT script on one cluster; returns each client's deliveries,
    what each port node's GPU view folds for ``tv/5/x`` before the
    clients leave, and the nodes (still running: the caller stops them)."""
    (a, sa), (b, sb) = await _nodes(side)
    got = collections.defaultdict(collections.Counter)

    async def client(srv, cid):
        c = MQTTClient("127.0.0.1", srv.port, client_id=cid)
        await c.connect()
        return c

    async def take(name, c, n):
        for _ in range(n):
            m = await c.recv(10)
            got[name][(m.topic, bytes(m.payload), m.qos)] += 1

    sub = await client(sa, "sub")
    await sub.subscribe("tv/+/x", qos=1)
    sub2 = await client(sb, "sub2")
    await sub2.subscribe("tv/#", qos=0)
    await _until(lambda: _pointer(b, ["tv", "1", "x"], "A")
                 and _pointer(a, ["tv", "1", "x"], "B"))
    pub = await client(sb, "pub")
    for i in range(3):
        await pub.publish(f"tv/{i}/x", b"cross%d" % i, qos=i % 2)
    await take("sub", sub, 3)
    await take("sub2", sub2, 3)
    pa = await client(sa, "pa")
    await pa.publish("tv/9/x", b"from A", qos=1)
    await take("sub", sub, 1)
    await take("sub2", sub2, 1)
    # a $share group across the nodes: prefer_local serves the member on
    # the publisher's node; once it leaves, the remote member
    local = await client(sa, "s-local")
    remote = await client(sb, "s-remote")
    await local.subscribe("$share/g2/jobs/#", qos=0)
    await remote.subscribe("$share/g2/jobs/#", qos=0)
    await _until(lambda: len([k for _f, k, _o in a.registry.trie("").match(
        ["jobs", "1"])]) == 2)
    for i in range(4):
        await pa.publish("jobs/1", b"t%d" % i, qos=0)
    await take("s-local", local, 4)
    await local.disconnect()
    await _until(lambda: len([k for _f, k, _o in a.registry.trie("").match(
        ["jobs", "1"])]) == 1)
    await pa.publish("jobs/2", b"fo", qos=0)
    await take("s-remote", remote, 1)
    # an unsubscribe on A leaves B's table through the same path
    await sub.unsubscribe("tv/+/x")
    await _until(lambda: not _pointer(b, ["tv", "1", "x"], "A"))
    await pub.publish("tv/3/x", b"only2", qos=0)
    await take("sub2", sub2, 1)
    await asyncio.sleep(0.3)
    for name, c in (("sub", sub), ("sub2", sub2), ("s-remote", remote)):
        while not c.messages.empty():  # nothing more may arrive
            m = c.messages.get_nowait()
            if m is not None:
                got[name][(m.topic, bytes(m.payload), m.qos)] += 1
    # a device fold on each node: after the unsubscribe only B's own
    # subscriber holds tv/#, so A's table has B's node-pointer row and
    # B's table the local row
    folds = {n.node_name: [k for _f, k, _o in n.registry.reg_views[
        "tpu"].fold("", ["tv", "5", "x"])]
        for n in (a, b) if "tpu" in n.registry.reg_views}
    for c in (sub, sub2, pub, pa, remote):
        await c.disconnect()
    return dict(got), folds, [(a, sa), (b, sb)]


async def _stop(nodes):
    for br, srv in nodes:
        if br.cluster is not None:
            await br.cluster.stop()
        await br.stop()
        await srv.stop()


@pytest.fixture(scope="module")
def reference_deliveries():
    async def run():
        got, _, nodes = await _script("ref")
        await _stop(nodes)
        return got

    return asyncio.run(run())


@pytest.mark.parametrize("side", ["port", "port-conf"])
def test_two_node_cluster_delivers_as_reference(side, reference_deliveries):
    async def run():
        got, folds, nodes = await _script(side)
        try:
            served = {}
            for br, _ in nodes:
                m = br.registry.reg_views["tpu"].matcher("")
                col = br.batch_collector()
                served[br.node_name] = (
                    m.match_publishes, m.host_fallbacks,
                    [getattr(col, k) for k in COLLECTOR_HOST])
            return got, folds, served
        finally:
            await _stop(nodes)

    got, folds, served = asyncio.run(run())
    assert got == reference_deliveries
    assert sum(sum(c.values()) for c in got.values()) == 14
    assert folds == {"A": ["B"], "B": [("", "sub2")]}
    for name, (pubs, fallbacks, host) in served.items():
        assert pubs > 0 and fallbacks == 0 and not any(host), (name, host)


async def _gate_script(side: str):
    """The is_ready gate of node A through membership changes, on a
    two-node cluster whose store holds 2,000 subscriber records: its
    answers, and how many times A's store was folded for 500 gates."""
    if side == "ref":
        from vernemq_tpu.cluster.cluster import MEMBERS
        from vernemq_tpu.protocol.types import SubOpts
    else:
        from vernemq_tpu_torch.cluster.cluster import MEMBERS
        from vernemq_tpu_torch.protocol.types import SubOpts

    (a, sa), (b, sb) = await _nodes(side)
    cl = a.cluster
    try:
        for i in range(2000):
            a.registry.subscribe(("", f"rec{i}"), [("r/%d" % i, SubOpts())])
        folds = [0]
        fold = a.metadata.fold

        def counted(prefix):
            folds[0] += 1
            return fold(prefix)

        a.metadata.fold = counted
        gates = [all(cl.is_ready() for _ in range(500))]
        busy = folds[0]
        cl._status["B"] = "down"  # B's data channel drops
        gates.append(cl.is_ready())
        cl._status["B"] = "up"
        gates.append(cl.is_ready())
        # a third member joins (its channel never comes up), leaves, and
        # its record is deleted
        rec = {"addr": ["127.0.0.1", 9], "state": "joined",
               "joined_at": time.time()}
        a.metadata.put(MEMBERS, "C", rec)
        gates.append(cl.is_ready())
        a.metadata.put(MEMBERS, "C", dict(rec, state="leaving"))
        gates.append(cl.is_ready())
        a.metadata.put(MEMBERS, "C", dict(rec))
        gates.append(cl.is_ready())
        a.metadata.delete(MEMBERS, "C")
        gates.append(cl.is_ready())
        return gates, busy
    finally:
        await _stop([(a, sa), (b, sb)])


def test_is_ready_folds_the_store_once_per_member_change():
    """``Cluster.is_ready`` (the CAP gate of every publish) answers as the
    reference's through a member's channel going down and up and a third
    member joining, leaving, rejoining and being deleted; but it folds the
    metadata store (every record, each subscriber's too) only when a
    member record changed, not on each call as the reference does."""
    want, _ = asyncio.run(_gate_script("ref"))
    got, busy = asyncio.run(_gate_script("port"))
    assert got == want == [True, False, True, False, True, False, True]
    assert busy <= 1


def test_a_join_freezes_the_heap_after_its_metadata_exchange():
    """The broker's full-collection policy (broker/heap.py) at a cluster
    join: the exchange on B's new channel to A applies A's metadata (the
    join's bulk load), and that exchange, not a delta or a publish, runs
    the policy's collection and freezes the heap; the nodes' stop
    unfreezes it."""
    import gc

    from vernemq_tpu_torch.broker.heap import POLICY

    async def run():
        r0 = POLICY.refreezes
        (a, sa), (b, sb) = await _nodes("port")
        try:
            await _until(lambda: POLICY.refreezes > r0)
            assert "metadata exchange with" in POLICY.last_reason, \
                POLICY.status()
            assert gc.get_freeze_count() > 0
        finally:
            await _stop([(a, sa), (b, sb)])

    asyncio.run(run())
    assert gc.get_freeze_count() == 0
