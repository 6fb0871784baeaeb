"""The port's shared-memory match service (``vernemq_tpu_torch/parallel/
shm_ring.py`` + ``broker/match_service.py``): a port of
tests/test_match_service.py run on the port's modules — ring framing
across wraps, fold parity against the trie oracle, row localization,
ownership filtering, idempotent resync, the degraded path (full ring /
dead service / timeout -> DeviceDegraded -> local trie) and the broker's
worker wiring — plus what the port adds: the ``"tpu"`` view of the
reference's service and of the port's (the GPU match engine on the CPU)
answering the same ring ops with the same rows, a fault of the device
code in the service raising in the worker instead of being served by its
trie, and test_filters.py's worker-mode envelope case.

Everything runs in ONE process, as in the reference's file: the ring and
stats segments are plain shared memory, so producer and consumer roles
are two handles, and a drainer thread stands in for the service process.
"""

import asyncio
import threading
import time

import pytest

import _torch_port  # noqa: F401  (one intra-op thread per worker)
from vernemq_tpu_torch.broker.match_service import (
    MatchService,
    MatchServiceClient,
    localize_rows,
    owned_delta,
)
from vernemq_tpu_torch.models.matcher import DeviceDegraded
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.ops.tile_match import KernelError
from vernemq_tpu_torch.parallel.shm_ring import (
    LAG_SAMPLES,
    RingFull,
    ShmRing,
    WorkerStatsBlock,
)
from vernemq_tpu_torch.protocol.types import SubOpts

_seq = [0]


def _name(tag: str) -> str:
    _seq[0] += 1
    return f"t{tag}{time.time_ns() & 0xFFFFFF:x}{_seq[0]}"


# ------------------------------------------------------------------ ShmRing


def test_ring_fifo_and_wrap_integrity():
    """Records of mixed sizes come out byte-identical and in order,
    through many wrap-arounds of a deliberately tiny ring."""
    ring = ShmRing.create(_name("rw"), 4096)
    try:
        sent, got = [], []
        for i in range(500):
            payload = bytes([i & 0xFF]) * (1 + (i * 37) % 300)
            while not ring.push(payload):
                got.extend(ring.pop_many())
            sent.append(payload)
        got.extend(ring.pop_many(10_000))
        while True:
            more = ring.pop_many(10_000)
            if not more:
                break
            got.extend(more)
        assert got == sent
    finally:
        ring.close()
        ring.unlink()


def test_ring_fence_mode_and_fallback_warning(monkeypatch, caplog):
    """The tail-publish release fence: fence_active() reflects the
    native shim, pushes still work with the fences forcibly absent
    (the x86-TSO fallback), and fence_startup_check warns EXACTLY once
    on a weakly-ordered machine while staying silent on x86."""
    import logging
    import platform

    from vernemq_tpu_torch.parallel import shm_ring as sr

    # whatever mode this box is in, push/pop round-trips
    ring = ShmRing.create(_name("fz"), 4096)
    try:
        assert ring.push(b"fenced")
        assert ring.pop_many() == [b"fenced"]
    finally:
        ring.close()
        ring.unlink()
    # force the pure-Python fallback and a weakly-ordered machine
    monkeypatch.setattr(sr, "_fence_checked", True)
    monkeypatch.setattr(sr, "_release_fence", None)
    monkeypatch.setattr(sr, "_acquire_fence", None)
    monkeypatch.setattr(sr, "_fence_warned", False)
    monkeypatch.setattr(platform, "machine", lambda: "aarch64")
    assert sr.fence_active() is False
    with caplog.at_level(logging.WARNING, "vernemq_tpu_torch.shm_ring"):
        assert sr.fence_startup_check() is False
        assert sr.fence_startup_check() is False  # once, not per ring
    warns = [r for r in caplog.records
             if "x86-TSO" in r.getMessage()]
    assert len(warns) == 1
    # fallback rings still function
    ring = ShmRing.create(_name("fz2"), 4096)
    try:
        assert ring.push(b"tso")
        assert ring.pop_many() == [b"tso"]
    finally:
        ring.close()
        ring.unlink()
    # x86 stays silent
    monkeypatch.setattr(sr, "_fence_warned", False)
    monkeypatch.setattr(platform, "machine", lambda: "x86_64")
    with caplog.at_level(logging.WARNING, "vernemq_tpu_torch.shm_ring"):
        caplog.clear()
        sr.fence_startup_check()
    assert not [r for r in caplog.records
                if "x86-TSO" in r.getMessage()]


def test_ring_survives_a_cross_process_stream():
    """A producer process streams numbered records through a small ring for
    two seconds while this process drains it: every record arrives intact
    and in order. The reference's ring (cursors stored with
    ``struct.pack_into``, which zero-fills before it writes) loses its
    framing under this load within about a second (ROADMAP Queue 3)."""
    import multiprocessing
    import struct

    from _torch_port import ring_producer

    ring = ShmRing.create(_name("xs"), 4096)
    proc = multiprocessing.get_context("spawn").Process(
        target=ring_producer, args=(ring.name, 2.0), daemon=True)
    proc.start()
    try:
        n, deadline = 0, time.monotonic() + 60.0
        while time.monotonic() < deadline:
            recs = ring.pop_many(256)
            if not recs:
                time.sleep(0.0002)
                continue
            if recs[-1] == b"END":
                recs.pop()
                deadline = 0
            for rec in recs:
                assert rec == struct.pack("<Q", n) * (1 + n % 7), n
                n += 1
        assert deadline == 0, "the producer never finished"
        assert n > 10_000
    finally:
        proc.join(10)
        ring.close()
        ring.unlink()


def test_ring_full_and_oversized():
    ring = ShmRing.create(_name("rf"), 4096)
    try:
        n = 0
        while ring.push(b"x" * 100):
            n += 1
        assert n > 0  # filled without error...
        assert ring.push(b"x" * 100) is False  # ...then refuses
        with pytest.raises(RingFull):
            ring.push(b"y" * 8192)  # can never fit
        # drain frees space again
        assert len(ring.pop_many(10_000)) == n
        assert ring.push(b"x" * 100)
    finally:
        ring.close()
        ring.unlink()


def test_ring_attach_sees_producer_records():
    """The consumer side attaches by name (the cross-process path)."""
    ring = ShmRing.create(_name("ra"), 8192)
    other = ShmRing.attach(ring.name)
    try:
        ring.push(b"hello")
        assert other.pop_many() == [b"hello"]
        other.mark_closed()
        assert ring.closed
    finally:
        other.close()
        ring.close()
        ring.unlink()


# --------------------------------------------------------- WorkerStatsBlock


def test_stats_block_slots_roundtrip():
    stats = WorkerStatsBlock.create(_name("sb"), 3)
    try:
        stats.write_health(1, pid=4242, sessions=7, admitted=99)
        stats.write_overload(1, 2, 0.625)
        for i in range(LAG_SAMPLES + 5):  # ring overwrites oldest
            stats.push_lag(1, 0.001 * i)
        s = stats.read_slot(1)
        assert s["pid"] == 4242 and s["sessions"] == 7
        assert s["admitted_pubs"] == 99
        assert s["level"] == 2 and abs(s["pressure"] - 0.625) < 1e-9
        assert len(s["lag_samples"]) == LAG_SAMPLES
        assert s["heartbeat_age_s"] < 5.0
        # untouched slots read as empty, not garbage
        assert stats.read_slot(0)["heartbeat_age_s"] is None
        stats.set_service(3, 777)
        stats.bump_generation(2)
        svc = stats.service_info()
        assert svc["epoch"] == 3 and svc["pid"] == 777
        assert stats.generation() == 2
    finally:
        stats.close()
        stats.unlink()


def test_stats_block_carries_the_service_kernel_launches():
    """The port's service header fields beside the reference's layout: the
    service's tile and extraction launches and plain extractions on the
    card, written by one aligned store and read back, with the service
    info and the hist/event widths untouched."""
    stats = WorkerStatsBlock.create(_name("sl"), 2)
    try:
        assert stats.service_launches() == {"tile": 0, "extract": 0,
                                            "plain": 0}
        stats.set_service(5, 99)
        stats.set_service_device(1, 2, 3)
        widths = stats._buf[120:128].tobytes()
        stats.set_service_launches(2 ** 40, 7, 0)
        assert stats.service_launches() == {"tile": 2 ** 40, "extract": 7,
                                            "plain": 0}
        svc = stats.service_info()
        assert (svc["epoch"], svc["pid"], svc["host_pubs"],
                svc["fold_errors"], svc["device_batches"]) == (5, 99, 1, 2, 3)
        assert stats._buf[120:128].tobytes() == widths
    finally:
        stats.close()
        stats.unlink()


def test_stats_block_carries_the_service_dense_launches_and_plain_packs():
    """The port's second service field pair (header bytes 112-119): the
    service's dense-mode tile launches and plain bit-packs on the card, two
    uint32 kept modulo 2^32, beside the launch counters and the hist/event
    widths, which stay untouched."""
    stats = WorkerStatsBlock.create(_name("sd"), 2)
    try:
        assert stats.service_dense() == {"dense": 0, "plain_packs": 0}
        widths = stats._buf[120:128].tobytes()
        stats.set_service_launches(11, 22, 0)
        stats.set_service_dense(2 ** 32 + 5, 3)
        assert stats.service_dense() == {"dense": 5, "plain_packs": 3}
        assert stats.service_launches() == {"tile": 11, "extract": 22,
                                            "plain": 0}
        assert stats._buf[120:128].tobytes() == widths
    finally:
        stats.close()
        stats.unlink()


def test_peer_pressure_ignores_self_and_stale():
    stats = WorkerStatsBlock.create(_name("pp"), 3)
    try:
        stats.write_health(0, pid=1, sessions=0, admitted=0)
        stats.write_overload(0, 3, 0.95)  # self: must be excluded
        stats.write_overload(2, 3, 0.99)  # never heartbeat: stale
        assert stats.peer_pressure(0)["pressure"] == 0.0
        stats.write_health(1, pid=2, sessions=0, admitted=0)
        stats.write_overload(1, 2, 0.5)
        fused = stats.peer_pressure(0)
        assert fused["pressure"] == 0.5 and fused["level"] == 2.0
    finally:
        stats.close()
        stats.unlink()


def test_governor_fuses_peer_pressure():
    """A drowning peer escalates THIS worker's governor (the
    cluster-style aggregate level), and the slot this governor writes
    carries only its LOCAL pressure — peers can't echo-amplify."""
    from vernemq_tpu_torch.broker.config import Config
    from vernemq_tpu_torch.broker.metrics import Metrics
    from vernemq_tpu_torch.robustness.overload import OverloadGovernor

    class FakeBroker:  # tests/test_overload.py's, on the port's modules
        config = Config()
        metrics = Metrics(native=False)
        sessions = {}
        sysmon = None
        cluster = None

    stats = WorkerStatsBlock.create(_name("gf"), 2)
    try:
        gov = OverloadGovernor(FakeBroker(), hold_s=0.15, tick_s=0.01)
        gov.attach_worker_stats(stats, 0)
        gov.tick()
        assert gov.level == 0
        stats.write_health(1, pid=9, sessions=0, admitted=0)
        stats.write_overload(1, 3, 0.9)
        gov.tick()
        assert gov.level == 3  # fused: peer pressure over the L3 gate
        assert gov._last_signals["workers"] == pytest.approx(0.9)
        # the exported slot: level 3 (enforced) but pressure 0 (local)
        own = stats.read_slot(0)
        assert own["level"] == 3 and own["pressure"] == 0.0
        # peer recovers -> fused signal drops -> hysteresis de-escalates
        stats.write_overload(1, 0, 0.0)
        deadline = time.monotonic() + 5.0
        while gov.level > 0 and time.monotonic() < deadline:
            gov.tick()
            time.sleep(0.01)
        assert gov.level == 0
    finally:
        stats.close()
        stats.unlink()


# ------------------------------------------------- ownership / localization


class _Opts(SubOpts):
    pass


def _opts(node):
    o = SubOpts(qos=1)
    o.node = node
    return o


def test_owned_delta_filtering():
    # plain local rows forward
    assert owned_delta("w0", ("", "c1"), _opts("w0"))
    # node-pointer rows never forward (string key)
    assert not owned_delta("w0", "w1", None)
    # shared adds forward only from the owner
    g = ("$g", "grp", ("", "c2"))
    assert owned_delta("w0", g, _opts("w0"))
    assert not owned_delta("w0", g, _opts("w1"))
    # shared removes (no opts) forward from everyone (idempotent apply)
    assert owned_delta("w0", g, None)


def test_localize_rows_shapes():
    own = _opts("w0")
    foreign = _opts("w1")
    shared = _opts("w1")
    rows = [
        (("a", "b"), ("", "c-own"), own),
        (("a", "#"), ("", "c-far"), foreign),
        (("a", "+"), ("$g", "g1", ("", "c-sh")), shared),
    ]
    out = localize_rows(rows, "w0")
    assert out[0] == (("a", "b"), ("", "c-own"), own)  # own: direct
    assert out[1] == (("a", "#"), "w1", None)  # foreign: node pointer
    assert out[2] == rows[2]  # shared: pass through (policy uses node)


# ------------------------------------------------- service core + client


class _Env:
    """One worker's ring pair + stats + service core + client, all
    in-process; a drainer thread plays the service process."""

    def __init__(self, ring_bytes=1 << 16, timeout_ms=500.0):
        tag = _name("e")
        self.stats = WorkerStatsBlock.create(tag + "s", 1)
        self.req = ShmRing.create(tag + "q", ring_bytes)
        self.resp = ShmRing.create(tag + "r", ring_bytes)
        self.svc = MatchService(
            self.stats, [(ShmRing.attach(self.req.name),
                          ShmRing.attach(self.resp.name))])
        self.stats.set_service(1, 12345)
        self.client = MatchServiceClient(
            self.req.name, self.resp.name, self.stats.name,
            worker_index=0, node_name="w0", timeout_ms=timeout_ms)
        self._stop = threading.Event()
        self._thread = None

    def start_drainer(self):
        def run():
            while not self._stop.is_set():
                if not self.svc.poll_once():
                    time.sleep(0.0005)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
        self.client.close()
        for h in (self.req, self.resp):
            h.close()
            h.unlink()
        self.stats.close()
        self.stats.unlink()


@pytest.fixture
def env():
    e = _Env()
    yield e
    e.close()


def test_fold_parity_and_localization(env):
    """Folds through the rings return exactly what the service trie's
    match would: own rows direct, foreign rows as node pointers."""
    oracle = SubscriptionTrie()
    for node, cid, fw in (
        ("w0", "c0", ("s", "t1")),
        ("w0", "c1", ("s", "+")),
        ("w1", "c2", ("s", "t1")),
        ("w1", "c3", ("#",)),
    ):
        opts = _opts(node)
        env.svc.apply_sub("", fw, ("", cid), opts)
        oracle.add(list(fw), ("", cid), opts)
    env.start_drainer()
    rows_per_topic = env.client.fold("", [("s", "t1"), ("q", "x")])
    assert len(rows_per_topic) == 2
    keys = {r[1] for r in rows_per_topic[0]}
    # own subscribers stay direct; both foreign rows collapse to ONE
    # node-pointer identity each ("w1" appears per matched filter, the
    # same shape the local trie's remote-ref rows give route_rows)
    assert ("", "c0") in keys and ("", "c1") in keys
    assert "w1" in keys
    assert not any(isinstance(k, tuple) and k[1] in ("c2", "c3")
                   for k in keys if isinstance(k, tuple))
    assert rows_per_topic[1] == [] or rows_per_topic[1] == [
        r for r in rows_per_topic[1]]  # no-match topic: empty-ish
    oracle_keys = {("w1" if getattr(o, "node", "w0") != "w0" else k[1])
                   for _f, k, o in oracle.match(["s", "t1"])}
    assert {k[1] if isinstance(k, tuple) else k
            for k in keys} == oracle_keys
    assert env.svc.folds == 1 and env.svc.fold_pubs == 2


def test_sub_ops_ride_the_ring_and_dedup(env):
    """sub/unsub ops forwarded by the client apply to the service
    table; duplicate forwards (resync replays) are no-ops."""
    env.start_drainer()
    opts = _opts("w0")
    env.client.send_op(("sub", "", ("a", "b"), ("", "c9"), opts))
    env.client.send_op(("sub", "", ("a", "b"), ("", "c9"), opts))  # dup
    deadline = time.monotonic() + 2.0
    while env.svc.subscriptions() < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert env.svc.subscriptions() == 1
    assert env.svc.ops_applied == 1  # the dup was deduped
    rows = env.client.fold("", [("a", "b")])[0]
    assert [r[1] for r in rows] == [("", "c9")]
    env.client.send_op(("unsub", "", ("a", "b"), ("", "c9")))
    env.client.send_op(("unsub", "", ("a", "b"), ("", "c9")))  # dup
    deadline = time.monotonic() + 2.0
    while env.svc.subscriptions() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert env.client.fold("", [("a", "b")])[0] == []
    assert env.svc.ops_applied == 2


def test_reconnect_handoff_transfers_ownership(env):
    """A client reconnecting onto a DIFFERENT worker re-adds its row
    with a new opts.node; the dataclass-equal re-add must not be
    swallowed as a resync dup, and the old owner's racing unsub (its
    ring drains after the new owner's) must not delete the transferred
    row."""
    svc = env.svc
    svc._ring_node[0] = "w0"
    svc._ring_node[1] = "w1"
    key = ("", "bounce")
    svc.apply_sub("", ("h", "t"), key, _opts("w0"))
    assert svc.ops_applied == 1
    # new owner's re-add: identical SubOpts fields, different node
    svc.apply_sub("", ("h", "t"), key, _opts("w1"))
    assert svc.ops_applied == 2, "node-only change swallowed as dup"
    stored = svc._subs[("", ("h", "t"), key)]
    assert stored.node == "w1"
    # old owner's unsub arrives late on its own ring: gated, row lives
    svc.apply_unsub("", ("h", "t"), key, from_node="w0")
    assert svc.stale_unsubs == 1
    assert [k for _f, k, _o in svc.trie("").match(["h", "t"])] == [key]
    # the CURRENT owner's unsub still deletes it
    svc.apply_unsub("", ("h", "t"), key, from_node="w1")
    assert svc.trie("").match(["h", "t"]) == []
    # shared rows stay exempt: any ring may remove them
    g = ("$g", "grp", ("", "bounce"))
    svc.apply_sub("", ("h", "s"), g, _opts("w1"))
    svc.apply_unsub("", ("h", "s"), g, from_node="w0")
    assert svc.trie("").match(["h", "s"]) == []


def test_respawned_service_reopens_response_rings(env):
    """An orderly service shutdown marks the response rings closed; the
    respawned service (same shm, new epoch) is the sole producer and
    must re-open them, or every fold would degrade to the local trie
    forever despite the epoch-bump resync."""
    env.svc.close()
    assert env.resp.closed
    svc2 = MatchService(
        env.stats, [(ShmRing.attach(env.req.name),
                     ShmRing.attach(env.resp.name))])
    assert not env.resp.closed
    env.svc = svc2  # env drainer/close operate on the respawn
    # (epoch stays put: the keeper that would resync on a bump is not
    # running in this unit env — the reopen property is what's pinned)
    svc2.apply_sub("", ("r", "o"), ("", "cR"), _opts("w0"))
    env.start_drainer()
    rows = env.client.fold("", [("r", "o")])[0]
    assert [r[1] for r in rows] == [("", "cR")]


def test_resync_drops_stale_rows_then_replays(env):
    """A respawned worker's resync first drops every row it owns (its
    dead sessions must stop matching), then replays its live set —
    while OTHER workers' rows survive untouched."""
    env.svc.apply_sub("", ("x", "old"), ("", "dead"), _opts("w0"))
    env.svc.apply_sub("", ("x", "keep"), ("", "other"), _opts("w1"))

    class Reg:
        _tries = {"": None}

        @staticmethod
        def fold_subscriptions(mp):
            return [(("x", "new"), ("", "live"), _opts("w0"))]

    env.start_drainer()
    env.client.resync(Reg())
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        keys = {k for (_mp, _fw, k) in env.svc._subs}
        if keys == {("", "other"), ("", "live")}:
            break
        time.sleep(0.005)
    assert {k for (_mp, _fw, k) in env.svc._subs} == \
        {("", "other"), ("", "live")}
    assert env.svc.resyncs == 1


def test_dead_service_times_out_to_degraded(env):
    """No drainer: the fold must degrade (DeviceDegraded) at the reply
    deadline, repeated failures open the breaker, and a later drained
    probe closes it again."""
    env.client.timeout_s = 0.05
    with pytest.raises(DeviceDegraded):
        env.client.fold("", [("a",)])
    assert env.client.fold_timeouts == 1
    for _ in range(5):  # exhaust the failure threshold
        try:
            env.client.fold("", [("a",)])
        except DeviceDegraded:
            pass
    assert env.client.breaker.state_name in ("open", "half_open")
    t0 = time.monotonic()
    with pytest.raises(DeviceDegraded):
        env.client.fold("", [("a",)])
    assert time.monotonic() - t0 < 0.04  # refused, not re-timed-out
    # service comes back: wait out the backoff, probe succeeds
    env.client.timeout_s = 1.0
    env.start_drainer()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        try:
            assert env.client.fold("", [("a",)]) == [[]]
            break
        except DeviceDegraded:
            time.sleep(0.05)
    else:
        pytest.fail("breaker never recovered with the service back")
    assert env.client.breaker.state_name == "closed"


def test_full_request_ring_degrades_immediately():
    env = _Env(ring_bytes=4096, timeout_ms=200.0)
    try:
        while env.req.push(b""):
            pass  # jam the request ring solid (service not draining)
        with pytest.raises(DeviceDegraded):
            env.client.fold("", [("a",)])
        assert env.client.folds_sent == 0  # refused before the wait
    finally:
        env.close()


def test_stale_responses_from_previous_pid_are_dropped():
    """A predecessor worker (same identity, earlier pid) died leaving
    replies in the response ring: the new client drains them at attach
    and its pid-salted req ids can never collide with them."""
    tag = _name("st")
    stats = WorkerStatsBlock.create(tag + "s", 1)
    req = ShmRing.create(tag + "q", 8192)
    resp = ShmRing.create(tag + "r", 8192)
    try:
        import pickle

        resp.push(pickle.dumps((1, "ok", [["stale"]]), protocol=5))
        client = MatchServiceClient(req.name, resp.name, stats.name,
                                    worker_index=0, node_name="w0",
                                    timeout_ms=60.0)
        try:
            assert resp.depth_bytes() == 0  # drained at attach
            with pytest.raises(DeviceDegraded):
                client.fold("", [("a",)])  # times out; never sees stale
        finally:
            client.close()
    finally:
        for h in (req, resp):
            h.close()
            h.unlink()
        stats.close()
        stats.unlink()


# ------------------------------------------- broker-side worker wiring


@pytest.mark.asyncio
async def test_broker_attaches_stats_and_exposes_worker_surface():
    """An in-process broker configured as worker 0 of 2: it attaches
    the shared stats block, heartbeats its health row, the sysmon
    pushes lag samples into the slot, the governor exports its level,
    and the aggregate workers_* gauges ride the Prometheus scrape with
    HELP text. (The reference's test also renders `vmq-admin workers
    show`; the admin surface is not ported, ROADMAP Queue 1 item 11.)"""
    from vernemq_tpu_torch.broker.config import Config
    from vernemq_tpu_torch.broker.server import start_broker

    stats = WorkerStatsBlock.create(_name("bw"), 2)
    try:
        broker, server = await start_broker(
            Config(systree_enabled=False, allow_anonymous=True,
                   worker_stats_block=stats.name, worker_index=0,
                   workers_total=2),
            port=0, node_name="worker0")
        try:
            assert broker.worker_stats is not None
            # sysmon lag sample + health heartbeat land in slot 0
            broker.sysmon.interval = 0.05
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                s = stats.read_slot(0)
                if (s["heartbeat_age_s"] is not None
                        and s["lag_samples"]):
                    break
                await asyncio.sleep(0.05)
            s = stats.read_slot(0)
            assert s["pid"] != 0 and s["heartbeat_age_s"] is not None
            assert s["lag_samples"], "sysmon never pushed a lag sample"
            # governor tick exports level/pressure into the slot
            broker.overload.tick()
            assert stats.read_slot(0)["level"] == broker.overload.level
            # scrape-point aggregation with HELP text
            text = broker.metrics.prometheus_text(broker.node_name)
            for g in ("workers_total", "workers_alive",
                      "workers_admitted_pubs_total",
                      "workers_level_max", "overload_peer_pressure"):
                assert f"\n{g}{{" in text or text.startswith(f"{g}{{"), g
                help_line = next(
                    (ln for ln in text.splitlines()
                     if ln.startswith(f"# HELP {g} ")), None)
                assert help_line and len(help_line) > len(
                    f"# HELP {g} "), g
            # a drowning PEER escalates this worker's governor
            stats.write_health(1, pid=7, sessions=0, admitted=0)
            stats.write_overload(1, 3, 0.95)
            broker.overload.tick()
            assert broker.overload.level == 3
            assert broker.overload._last_signals["workers"] == \
                pytest.approx(0.95)
        finally:
            await broker.stop()
            await server.stop()
    finally:
        stats.close()
        stats.unlink()


@pytest.mark.asyncio
async def test_workers_total_mismatch_warns_on_stale_block(caplog):
    """``workers_total`` is the parent's declared group size; a stats
    block whose slot count disagrees is a STALE segment from a previous
    group generation. Regression for the dead knob the vmqlint
    knob-registry pass flagged: WorkerGroup always set it, nothing
    read it, so a torn rolling restart attached silently."""
    import logging

    from vernemq_tpu_torch.broker.config import Config
    from vernemq_tpu_torch.broker.server import start_broker

    stats = WorkerStatsBlock.create(_name("wt"), 2)
    try:
        with caplog.at_level(logging.WARNING,
                             logger="vernemq_tpu_torch.broker"):
            broker, server = await start_broker(
                Config(systree_enabled=False, allow_anonymous=True,
                       worker_stats_block=stats.name, worker_index=0,
                       workers_total=3),  # block says 2
                port=0, node_name="wt0")
            try:
                assert broker.worker_stats is not None
            finally:
                await broker.stop()
                await server.stop()
        assert any("workers_total=3" in r.getMessage()
                   for r in caplog.records), caplog.records
    finally:
        stats.close()
        stats.unlink()


# ------------------------------------------- the port's "tpu" service view


def _service_round(svc_mod, ring_mod, sub_opts, records, n_folds,
                   view_kw):
    """One service of package ``svc_mod`` over fresh rings: push the
    pickled ``records`` into its request ring, run its drainer loop until
    ``n_folds`` replies land, and return ``(replies by req id, service)``.
    ``records`` holds ("sub", fw, cid) and ("fold", req_id, topics)."""
    import pickle

    tag = _name("tv")
    stats = ring_mod.WorkerStatsBlock.create(tag + "s", 1)
    req = ring_mod.ShmRing.create(tag + "q", 1 << 20)
    resp = ring_mod.ShmRing.create(tag + "r", 1 << 20)
    svc = svc_mod.MatchService(stats, [(ring_mod.ShmRing.attach(req.name),
                                        ring_mod.ShmRing.attach(resp.name))],
                               view="tpu", **view_kw)
    svc._view.matcher("")  # before the loop runs, on an empty table
    for rec in records:
        if rec[0] == "sub":
            o = sub_opts(qos=1)
            o.node = "w0"
            rec = ("sub", "", rec[1], ("", rec[2]), o)
        else:
            rec = ("fold", rec[1], "", rec[2])
        assert req.push(pickle.dumps(rec, protocol=5))
    replies = {}

    async def drive():
        stop = asyncio.Event()
        task = asyncio.get_running_loop().create_task(svc.run(stop))
        deadline = time.monotonic() + 120.0
        while len(replies) < n_folds and time.monotonic() < deadline:
            for raw in resp.pop_many():
                rid, status, payload = pickle.loads(raw)[:3]
                replies[rid] = (status, payload)
            await asyncio.sleep(0.005)
        stop.set()
        await task
        m = svc._view._matchers.get("")
        while getattr(m, "_warming", None):  # the reference's JAX warm-up
            assert time.monotonic() < deadline, "warm-up never ended"
            await asyncio.sleep(0.01)

    try:
        asyncio.run(drive())
    finally:
        svc.close()
        for h in (req, resp):
            h.close()
            h.unlink()
        stats.close()
        stats.unlink()
    return replies, svc


def test_tpu_view_service_folds_as_reference():
    """The reference's service on its JAX ``"tpu"`` view (on the CPU) and
    the port's on the GPU match engine (``device="cpu"``), fed the same
    ring ops — subscription writes, then fold batches — reply with the
    same rows for every topic, equal to the trie oracle's; the port's
    device matcher served every fold (no host-served publish)."""
    import random

    from _torch_port import rand_filter, rand_topic
    from vernemq_tpu.broker import match_service as RMS
    from vernemq_tpu.parallel import shm_ring as RSR
    from vernemq_tpu.protocol.types import SubOpts as RefSubOpts
    from vernemq_tpu_torch.broker import match_service as PMS
    from vernemq_tpu_torch.parallel import shm_ring as PSR

    rng = random.Random(9)
    oracle = SubscriptionTrie()
    records = []
    for i in range(300):
        fw = tuple(rand_filter(rng))
        records.append(("sub", fw, f"c{i}"))
        oracle.add(list(fw), ("", f"c{i}"), None)
    folds = [[tuple(rand_topic(rng)) for _ in range(rng.randrange(1, 24))]
             for _ in range(6)]
    records += [("fold", k + 1, topics) for k, topics in enumerate(folds)]
    kw = dict(tpu_opts=dict(max_levels=8, initial_capacity=1024))
    ref, _ = _service_round(RMS, RSR, RefSubOpts, records, len(folds), kw)
    port, psvc = _service_round(PMS, PSR, SubOpts, records, len(folds),
                                dict(kw, device="cpu"))
    assert sorted(ref) == sorted(port) == list(range(1, len(folds) + 1))
    for k, topics in enumerate(folds):
        (rs, rrows), (ps, prows) = ref[k + 1], port[k + 1]
        assert rs == ps == "ok"
        for t, r, p in zip(topics, rrows, prows):
            want = sorted((tuple(f), key) for f, key, _ in
                          oracle.match(list(t)))
            assert sorted((tuple(f), key) for f, key, _ in p) == want
            assert sorted((tuple(f), key) for f, key, _ in r) == want
    m = psvc._view.matcher("")
    col = psvc._collector
    assert m.match_publishes == sum(map(len, folds))
    assert not (col.degraded_host_pubs or col.busy_host_pubs
                or col.rebuild_host_pubs or col.host_hybrid_pubs
                or m.host_fallbacks)


def test_service_kernel_fault_raises_in_the_worker(env, monkeypatch):
    """A fault of the device code in the service (KernelError from its
    matcher) comes back as a "fault" reply: the worker's fold raises
    KernelError — the reg view's single fold too — without feeding the
    client breaker, and its local trie does not answer it. (The
    reference replies "err" and the worker's trie serves.)"""
    from vernemq_tpu_torch.broker.match_service import ShmMatchView
    from vernemq_tpu_torch.models.matcher import GpuMatcher

    svc = MatchService(env.stats, [(ShmRing.attach(env.req.name),
                                    ShmRing.attach(env.resp.name))],
                       view="tpu", device="cpu",
                       tpu_opts=dict(max_levels=8, initial_capacity=1024))
    svc.apply_sub("", ("k", "t"), ("", "cK"), _opts("w0"))

    def broken(self, *a, **kw):
        raise KernelError("tile_match kernel launch failed: CUDA error 9")

    monkeypatch.setattr(GpuMatcher, "match_batch", broken)
    stop = threading.Event()

    def loop():
        async def run():
            stop_ev = asyncio.Event()
            task = asyncio.get_running_loop().create_task(svc.run(stop_ev))
            while not stop.is_set():
                await asyncio.sleep(0.01)
            stop_ev.set()
            await task
        asyncio.run(run())

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        with pytest.raises(KernelError):
            env.client.fold("", [("k", "t")])

        class Reg:
            def trie(self, mp):
                raise AssertionError("the trie must not answer a fault")

        with pytest.raises(KernelError):
            ShmMatchView(Reg(), env.client).fold("", ("k", "t"))
        assert env.client.breaker.state_name == "closed"
        assert env.client.fold_timeouts == 0 and svc.fold_errors == 2
    finally:
        stop.set()
        th.join(5.0)
        svc.close()


def test_worker_mode_filter_over_real_rings():
    """Port of test_filters.py::test_worker_mode_filter_over_real_rings:
    a predicated subscription's SubOpts (filter_expr included) survives
    the ring round trip in the fold reply, and the WORKER's exact host
    evaluator filters the rows — device-less, as workers never touch the
    card — while the service never sees payloads."""
    from vernemq_tpu_torch.cluster.metadata import MetadataStore
    from vernemq_tpu_torch.filters.engine import FilterEngine
    from vernemq_tpu_torch.filters.schema_registry import SchemaRegistry

    tag = f"tf{time.time_ns() & 0xFFFFFF:x}"
    stats = WorkerStatsBlock.create(tag + "s", 1)
    req = ShmRing.create(tag + "q", 1 << 16)
    resp = ShmRing.create(tag + "r", 1 << 16)
    svc = MatchService(stats, [(ShmRing.attach(req.name),
                                ShmRing.attach(resp.name))])
    stats.set_service(1, 12345)
    client = MatchServiceClient(req.name, resp.name, stats.name,
                                worker_index=0, node_name="w0",
                                timeout_ms=2000.0)
    stop = threading.Event()

    def drain():
        while not stop.is_set():
            if not svc.poll_once():
                time.sleep(0.0005)

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    try:
        o = SubOpts(qos=1)
        o.filter_expr = "$gt(value,30)"
        o.node = "w0"
        svc.apply_sub("", ("s", "+"), ("", "cf"), o)
        plain = SubOpts()
        plain.node = "w0"
        svc.apply_sub("", ("s", "+"), ("", "cp"), plain)
        rows = client.fold("", [("s", "t")])[0]
        got = {r[1]: getattr(r[2], "filter_expr", None) for r in rows}
        assert got == {("", "cf"): "$gt(value,30)", ("", "cp"): None}
        sreg = SchemaRegistry(MetadataStore("w0"), "w0")
        sreg.set_schema("", "s/+", "value:number")
        eng = FilterEngine(sreg, device_gate=lambda: False,
                           host_threshold=1)
        eng.on_sub_delta("add", "", o)
        topic = ("s", "t")
        lo = eng.filter_single("", topic,
                               eng.encode("", topic, b'{"value": 10}'),
                               list(rows))
        hi = eng.filter_single("", topic,
                               eng.encode("", topic, b'{"value": 99}'),
                               list(rows))
        assert [r[1] for r in lo] == [("", "cp")]
        assert sorted(r[1] for r in hi) == [("", "cf"), ("", "cp")]
        assert eng.dispatches == 0  # host-only in worker mode
    finally:
        stop.set()
        th.join(2.0)
        client.close()
        for h in (req, resp):
            h.close()
            h.unlink()
        stats.close()
        stats.unlink()
