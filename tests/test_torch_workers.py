"""The port's worker mode (``vernemq_tpu_torch/broker/workers.py``): N broker
worker processes on one SO_REUSEPORT MQTT port, meshed as local cluster
nodes, and one match service process fed over shared-memory rings. A port
of tests/test_workers.py, driven black-box over real TCP with the port's
client: cross-worker delivery, per-worker direct ports, supervision
restart, kill -9 mid-storm with no QoS 1 loss, the match service's folds
(here on the port's GPU match engine, ``match_view="tpu"`` on the CPU),
its kill / respawn / resync, and conf-file listeners.

The reference's file boots five groups; this one boots three (the plain
group has three workers with direct ports and serves the first four
tests, in file order), so the file stays inside the tier-1 budget. The
conf-file case has no admin HTTP endpoint (not ported, ROADMAP Queue 1
item 11). Fixed ports stay below the kernel's ephemeral range.
"""

import asyncio
import socket
import time

import pytest

from vernemq_tpu_torch.broker.workers import WorkerGroup
from vernemq_tpu_torch.client import MQTTClient

pytestmark = pytest.mark.multiproc  # conftest reaps leaked children

DIRECT = 27810


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_ready(port: int, timeout: float = 45.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            return True
        except OSError:
            time.sleep(0.25)
    return False


@pytest.fixture(scope="module")
def group():
    """3 workers with per-worker direct ports (DIRECT + idx), booted
    outside the async test bodies."""
    port = _free_port()
    g = WorkerGroup(3, "127.0.0.1", port, cluster_base=27100,
                    direct_base=DIRECT, allow_anonymous=True,
                    systree_enabled=False)
    g.start()
    assert _wait_ready(port), "workers never became reachable"
    for i in range(3):
        assert _wait_ready(DIRECT + i)
    time.sleep(1.5)  # worker mesh formation
    yield g
    g.stop()
    assert g.alive_count() == 0


@pytest.mark.asyncio
async def test_cross_worker_delivery(group):
    """Subscribers land on every worker (kernel accept balancing); each
    receives a publish regardless of the owning worker."""
    port = group.port
    subs = []
    for i in range(8):
        c = MQTTClient("127.0.0.1", port, f"xw-sub{i}")
        await c.connect()
        await c.subscribe("xw/#", qos=1)
        subs.append(c)
    await asyncio.sleep(1.0)  # subscription replication
    pub = MQTTClient("127.0.0.1", port, "xw-pub")
    await pub.connect()
    await pub.publish("xw/t", b"fanout", qos=1)
    for c in subs:
        f = await c.recv(5.0)
        assert f is not None and f.payload == b"fanout"
    for c in subs:
        await c.disconnect()
    await pub.disconnect()


@pytest.mark.asyncio
async def test_worker_direct_ports(group):
    """Per-worker direct ports address ONE worker; a publish through
    worker 1 reaches a subscriber pinned to worker 0."""
    sub = MQTTClient("127.0.0.1", DIRECT, "dp-sub")  # worker 0
    await sub.connect()
    await sub.subscribe("dp/#", qos=1)
    await asyncio.sleep(0.8)  # replication to the other workers
    pub = MQTTClient("127.0.0.1", DIRECT + 1, "dp-pub")  # worker 1
    await pub.connect()
    await pub.publish("dp/t", b"pinned", qos=1)
    f = await sub.recv(5.0)
    assert f is not None and f.payload == b"pinned"
    await sub.disconnect()
    await pub.disconnect()


def test_worker_kill9_midstorm_qos1_no_loss(group):
    """kill -9 of worker 2 while QoS 1 traffic flows between sessions
    pinned to workers 0 and 1: every acknowledged message arrives, and
    the dead worker is respawned. (Sync test on its own loop: storm plus
    respawn exceed the async shim's per-test cap.)"""
    asyncio.run(_kill9_storm_body(group))
    assert group.poll_restart() == 1
    assert _wait_ready(DIRECT + 2, 45.0), "killed worker never respawned"


async def _kill9_storm_body(g):
    sub = MQTTClient("127.0.0.1", DIRECT, "st-sub")  # worker 0
    await sub.connect()
    await sub.subscribe("st/#", qos=1)
    await asyncio.sleep(1.0)  # replication
    pub = MQTTClient("127.0.0.1", DIRECT + 1, "st-pub")  # worker 1
    await pub.connect()
    sent = []

    async def storm(n=60):
        for i in range(n):
            await pub.publish(f"st/{i}", b"s%d" % i, qos=1, timeout=10.0)
            sent.append(b"s%d" % i)
            await asyncio.sleep(0.01)

    task = asyncio.get_event_loop().create_task(storm())
    await asyncio.sleep(0.2)  # storm in flight
    g._procs[2].kill()  # SIGKILL, no cleanup
    await task  # every publish ACKED by a surviving worker
    got = set()
    deadline = time.monotonic() + 20.0
    while len(got) < len(sent) and time.monotonic() < deadline:
        try:
            f = await sub.recv(1.0)
        except asyncio.TimeoutError:
            continue
        if f is not None:
            got.add(f.payload)
    assert got == set(sent)
    await sub.disconnect()
    await pub.disconnect()


@pytest.mark.asyncio
async def test_worker_restart_supervision(group):
    """A killed worker is relaunched by poll_restart and the port stays
    serviceable throughout (the surviving workers keep accepting)."""
    deadline = time.time() + 30.0
    while time.time() < deadline and group.alive_count() < 3:
        await asyncio.sleep(0.25)  # the storm test's respawn
    victim = group._procs[1]
    victim.kill()
    victim.join(5.0)
    assert group.alive_count() == 2
    c = MQTTClient("127.0.0.1", group.port, "surv")
    await c.connect()
    await c.disconnect()
    assert group.poll_restart() == 1
    assert _wait_ready(DIRECT + 1, 30.0)
    deadline = time.time() + 30.0
    while time.time() < deadline and group.alive_count() < 3:
        await asyncio.sleep(0.25)
    assert group.alive_count() == 3


# ------------------------------------------------------ match service mode


@pytest.fixture(scope="module")
def ms_group():
    """2 workers + ONE match service on the port's GPU match engine
    (``match_view="tpu"``, the plain PyTorch path on the CPU);
    host_threshold 0 sends every flush through the rings."""
    port = _free_port()
    g = WorkerGroup(2, "127.0.0.1", port, cluster_base=27700,
                    match_service=True, match_view="tpu",
                    match_device="cpu",
                    match_tpu_opts=dict(max_levels=8, initial_capacity=1024),
                    allow_anonymous=True, systree_enabled=False,
                    tpu_host_batch_threshold=0,
                    match_service_timeout_ms=500)
    g.start()
    assert _wait_ready(port), "ms workers never became reachable"
    time.sleep(1.5)  # worker mesh formation + first resync
    yield g
    g.stop()
    assert g.alive_count() == 0


async def _qos1_burst(pub, sub, tag, n):
    """Publish n distinct QoS 1 messages and drain the subscriber;
    returns the payload set received."""
    for i in range(n):
        await pub.publish(f"mq/{tag}/{i}", b"%s-%d" % (tag.encode(), i),
                          qos=1)
    got = set()
    deadline = time.monotonic() + 20.0
    while len(got) < n and time.monotonic() < deadline:
        try:
            f = await sub.recv(1.0)
        except asyncio.TimeoutError:
            continue
        if f is not None:
            got.add(f.payload)
    return got


@pytest.mark.asyncio
async def test_match_service_fanout_and_ring_folds(ms_group):
    """Publishes route through the service's GPU match engine over the
    rings (the service's fold counter moves), delivery is exact, and the
    workers' admitted counters land in the shared stats block."""
    g = ms_group
    sub = MQTTClient("127.0.0.1", g.port, "mq-sub")
    await sub.connect()
    await sub.subscribe("mq/#", qos=1)
    await asyncio.sleep(1.2)  # replication + service forward
    pub = MQTTClient("127.0.0.1", g.port, "mq-pub")
    await pub.connect()
    folds0 = g.stats_block().service_info()["folds"]
    got = await _qos1_burst(pub, sub, "a", 40)
    assert got == {b"a-%d" % i for i in range(40)}
    # as in the reference's test: a loaded host can catch the client
    # breaker open on an early slow fold (the local trie serves, exactly);
    # nudge small bursts until the service's fold counter moves
    deadline = time.monotonic() + 25.0
    extra = 0
    while (g.stats_block().service_info()["folds"] <= folds0
           and time.monotonic() < deadline):
        got = await _qos1_burst(pub, sub, f"x{extra}", 5)
        assert got == {b"x%d-%d" % (extra, i) for i in range(5)}
        extra += 1
    info = g.stats_block().service_info()
    assert info["folds"] > folds0, (
        f"service saw no folds: info={info} alive={g.service_alive()} "
        f"slots={g.stats_block().read_all()}")
    await asyncio.sleep(0.6)  # one heartbeat interval
    slots = g.stats_block().read_all()
    assert sum(s["admitted_pubs"] for s in slots) >= 40
    assert any(s["sessions"] for s in slots)
    await sub.disconnect()
    await pub.disconnect()


@pytest.mark.asyncio
async def test_match_service_kill_respawn_resync(ms_group):
    """kill -9 of the match service mid-traffic: folds degrade to the
    workers' local tries (no loss), the supervisor respawns the service
    under a new epoch, the workers replay their owned rows, and the ring
    path serves again."""
    g = ms_group
    sub = MQTTClient("127.0.0.1", g.port, "kr-sub")
    await sub.connect()
    await sub.subscribe("mq/#", qos=1)
    await asyncio.sleep(1.2)
    pub = MQTTClient("127.0.0.1", g.port, "kr-pub")
    await pub.connect()
    epoch0 = g.stats_block().service_info()["epoch"]
    g._service_proc.kill()
    g._service_proc.join(5.0)
    assert not g.service_alive()
    got = await _qos1_burst(pub, sub, "deg", 15)
    assert got == {b"deg-%d" % i for i in range(15)}
    assert g.poll_restart() >= 1
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        info = g.stats_block().service_info()
        if (info["epoch"] > epoch0 and info["heartbeat_age_s"] is not None
                and info["heartbeat_age_s"] < 2.0):
            break
        await asyncio.sleep(0.2)
    info = g.stats_block().service_info()
    assert info["epoch"] > epoch0, "service never respawned"
    deadline = time.monotonic() + 10.0
    while (g.stats_block().service_info()["ops"] == 0
           and time.monotonic() < deadline):
        await asyncio.sleep(0.2)
    assert g.stats_block().service_info()["ops"] >= 1
    got = await _qos1_burst(pub, sub, "heal", 15)
    assert got == {b"heal-%d" % i for i in range(15)}
    await sub.disconnect()
    await pub.disconnect()


@pytest.mark.asyncio
async def test_workers_from_conf_file(tmp_path):
    """Conf-declared MQTT listeners join the SO_REUSEPORT set on every
    worker (no EADDRINUSE crash loop); cross-worker delivery works through
    the conf listener."""
    mqtt_port = _free_port()
    conf = tmp_path / "vernemq.conf"
    conf.write_text(
        f"""
        allow_anonymous = on
        systree_enabled = off
        listener.tcp.default = 127.0.0.1:{mqtt_port}
        """
    )
    g = WorkerGroup(2, "127.0.0.1", _free_port(), cluster_base=27300,
                    conf_path=str(conf))
    g.start()
    try:
        assert _wait_ready(mqtt_port), "conf listener never came up"
        time.sleep(2.0)
        assert g.alive_count() == 2  # no EADDRINUSE crash loop
        sub = MQTTClient("127.0.0.1", mqtt_port, "cw-sub")
        await sub.connect()
        await sub.subscribe("cw/#", qos=0)
        await asyncio.sleep(1.0)
        pub = MQTTClient("127.0.0.1", mqtt_port, "cw-pub")
        await pub.connect()
        await pub.publish("cw/t", b"conf-route", qos=0)
        f = await sub.recv(5.0)
        assert f is not None and f.payload == b"conf-route"
        await sub.disconnect()
        await pub.disconnect()
    finally:
        g.stop()
