"""The port's mesh-native matcher (vernemq_tpu_torch/parallel/mesh.py,
mesh_match.py) against the JAX package's, on the reference tests' corpora
(tests/test_mesh_match.py, tests/test_mesh_distributed.py): the port's
4-slice meshes repeat the one CPU device, the reference's span 4 of the 8
virtual CPU devices. Matched slot ids and overflow flags are compared per
publish (``_torch_mesh.same_dispatch``), delta routing and per-slice
partials against the reference's on the same table, rows against the
port's host trie; the two-process case runs on torch.distributed's gloo
backend."""

import json
import os
import random
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from _torch_mesh import build_bucketed, meshes, norm, same_dispatch, \
    topics_for
from vernemq_tpu.parallel import mesh as RM
from vernemq_tpu.parallel.mesh_match import MeshMatcher as RefMeshMatcher
from vernemq_tpu_torch.models.matcher import RebuildInProgress
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.parallel.mesh import (MATCHER_PARTITION_RULES,
                                             MATCHER_STATE_NAMES, make_mesh,
                                             make_shard_and_gather_fns,
                                             match_partition_rules)
from vernemq_tpu_torch.parallel.mesh_match import MeshGpuMatcher, MeshMatcher
from vernemq_tpu_torch.parallel.sharded_match import ShardedWindowedMatcher


def mesh4():
    return make_mesh(["cpu"] * 4, batch=1)


def _spec(p):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(p)


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------


def test_partition_rules_cover_matcher_state():
    arrays = {
        "F_t": np.zeros((8, 64)), "t1": np.zeros(64),
        "eff_len": np.zeros(64), "has_hash": np.zeros(64, bool),
        "first_wild": np.zeros(64), "active": np.zeros(64, bool),
        "g/F_t": np.zeros((8, 16)), "g/t1": np.zeros(16),
        "g/eff_len": np.zeros(16), "g/has_hash": np.zeros(16, bool),
        "g/first_wild": np.zeros(16), "g/active": np.zeros(16, bool),
    }
    specs = match_partition_rules(MATCHER_PARTITION_RULES, arrays)
    ref = RM.match_partition_rules(RM.MATCHER_PARTITION_RULES, arrays)
    assert MATCHER_STATE_NAMES == RM.MATCHER_STATE_NAMES
    assert specs == {k: _spec(v) for k, v in ref.items()}
    assert specs["F_t"] == (None, "sub") and specs["g/active"] == (None,)
    # scalars are never partitioned; unmatched names are loud
    assert match_partition_rules(MATCHER_PARTITION_RULES,
                                 {"F_t": np.zeros(())})["F_t"] == ()
    with pytest.raises(ValueError):
        match_partition_rules([(r"^only$", None)], {"other": np.zeros(4)})


def test_shard_and_gather_fns_roundtrip():
    """Sharded 2-D (columns over 'sub'), sharded 1-D and replicated arrays
    round-trip host -> mesh -> host bit for bit, with the reference's
    block starts; the per-process gather (local shards in row order,
    replicated copies once) reproduces the full array when every shard is
    local."""
    mesh = mesh4()
    arrays = {
        "F_t": np.arange(8 * 64, dtype=np.float32).reshape(8, 64),
        "t1": np.arange(64, dtype=np.float32),
        "g/t1": np.arange(16, dtype=np.float32),
        "g/F_t": np.arange(8 * 16, dtype=np.float32).reshape(8, 16),
    }
    specs = match_partition_rules(MATCHER_PARTITION_RULES, arrays)
    shard_fns, gather_fns = make_shard_and_gather_fns(specs, mesh)
    rmesh = RM.make_mesh(jax.devices()[:4], batch=1)
    rshard, _ = RM.make_shard_and_gather_fns(
        RM.match_partition_rules(RM.MATCHER_PARTITION_RULES, arrays), rmesh)
    for name, host in arrays.items():
        dev = shard_fns[name](host)
        assert dev.shape == host.shape
        assert np.array_equal(gather_fns[name](dev), host), name
        assert sorted(sh.index[-1].start for sh in dev.shards) == sorted(
            (s.index[-1].start or 0)
            for s in rshard[name](host).addressable_shards), name
    dev = shard_fns["F_t"](arrays["F_t"])
    assert sorted(sh.index[-1].start for sh in dev.addressable_shards) \
        == [0, 16, 32, 48]

    class _Partial:
        """Reports partial addressability: the per-process gather."""
        is_fully_addressable = False

        def __init__(self, arr):
            self.addressable_shards = arr.addressable_shards

    for name in ("F_t", "t1", "g/t1"):
        assert np.array_equal(
            gather_fns[name](_Partial(shard_fns[name](arrays[name]))),
            arrays[name]), name


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def four_slices():
    """The corpus of the parity and routing cases, in both packages, with
    a ``$SYS`` filter; a reference and a port MeshMatcher over it."""
    c, pools, rng = build_bucketed(7, 30_000, 1 << 15, with_ref=True)
    c.add(["$SYS", "stats", "#"], "sys")
    rmesh, pmesh = meshes(4)
    return (c, pools, rng, RefMeshMatcher(c.ref, rmesh, max_fanout=128),
            MeshMatcher(c.table, pmesh, max_fanout=128))


def test_mesh_parity_4slice_vs_trie_and_sharded_oracle(four_slices):
    """MeshMatcher's slot ids and flags equal the reference MeshMatcher's
    on a 4-slice mesh, its rows the port's ShardedWindowedMatcher's and
    the trie's; random corpus with +, # and $."""
    c, pools, rng, ref_m, m = four_slices
    topics = topics_for(rng, pools, 96) + [
        ("$SYS", "stats", "x"), ("neverseen", "word", "here"),
        ("$SYS", "other", "y")]
    assert same_dispatch(ref_m, m, topics, c) > len(topics) // 2
    oracle = ShardedWindowedMatcher(c.table, mesh4(), max_fanout=128)
    for tp, a, b in zip(topics, m.match_batch(topics),
                        oracle.match_batch(topics)):
        assert norm(a) == norm(b) == c.expect(tp), tp


def test_mesh_parity_merged_output():
    c, pools, rng = build_bucketed(23, 20_000, 1 << 15)
    m = MeshMatcher(c.table, mesh4(), max_fanout=128, merge=True)
    topics = topics_for(rng, pools, 48)
    for tp, rows in zip(topics, m.match_batch(topics)):
        assert norm(rows) == c.expect(tp), tp


def test_mesh_view_mountpoints_fold_parity():
    """The seat behind the reg-view seam, one matcher per mountpoint."""
    from vernemq_tpu_torch.models.matcher import GpuRegView

    rng = random.Random(5)
    tries = {"": SubscriptionTrie(), "tenant2": SubscriptionTrie()}
    subs = {"": [], "tenant2": []}

    class FakeRegistry:
        def fold_subscriptions(self, mountpoint):
            return list(subs[mountpoint])

        def trie(self, mountpoint):
            return tries[mountpoint]

    l0 = [f"r{i}" for i in range(16)]
    l1 = [f"d{i}" for i in range(24)]
    for mp in ("", "tenant2"):
        for i in range(3000):
            f = [rng.choice(l0), rng.choice(l1),
                 "x" if rng.random() < 0.5 else "#"]
            subs[mp].append((tuple(f), (mp, i), None))
            tries[mp].add(list(f), (mp, i), None)
    view = GpuRegView(FakeRegistry(), max_levels=8,
                      initial_capacity=1 << 14, max_fanout=128,
                      mesh=mesh4(), mesh_native=True)
    for mp in ("", "tenant2"):
        assert isinstance(view.matcher(mp), MeshGpuMatcher)
        view.on_delta("add", mp, [l0[0], l1[0], "late"], (mp, "late"),
                      None)
        tries[mp].add([l0[0], l1[0], "late"], (mp, "late"), None)
        for _ in range(8):
            tp = (rng.choice(l0), rng.choice(l1), "x")
            assert norm(view.fold(mp, tp)) == \
                norm(tries[mp].match(list(tp))), (mp, tp)
        tp = (l0[0], l1[0], "late")
        assert norm(view.fold(mp, tp)) == \
            norm(tries[mp].match(list(tp))), (mp, tp)
    st = view.mesh_status()
    assert st is not None and st["slices"] == 4
    assert sum(st["rows_per_slice"]) > 0
    view.close()


def test_mesh_seat_match_many_parity():
    """match_many under the mesh seat: results equal to the trie's, one
    mesh dispatch per batch."""
    c, pools, rng = build_bucketed(13, 15_000, 1 << 15)
    m = MeshGpuMatcher(mesh4(), max_levels=8, max_fanout=128)
    for e in c.table.entries:
        if e is not None:
            m.table.add(list(e[0]), e[1], e[2])
    batches = [topics_for(rng, pools, 16) for _ in range(3)]
    res = m.match_many(batches)
    assert m.supports_match_many
    for topics, rr in zip(batches, res):
        for tp, rows in zip(topics, rr):
            assert norm(rows) == c.expect(tp), tp
    assert m._swm.mesh_dispatches >= len(batches)


# ---------------------------------------------------------------------------
# slice-routed delta scatter
# ---------------------------------------------------------------------------


def test_mesh_delta_routes_to_owning_slice_only(four_slices):
    """A single-bucket subscribe burst flushes as a sub-delta on ONE
    slice, the same slice and counts as the reference's routing; the
    build count never moves; a wildcard-first filter updates the
    replicated g-zone mirrors (counted apart), still no full placement."""
    c, pools, rng, ref_m, m = four_slices
    l0, l1, l2 = pools
    for x in (ref_m, m):
        x.sync()
    builds0, flushes0 = m.full_scatters, m.route_flushes
    gz0 = m.route_gzone_flushes
    for j in range(5):
        c.add([l0[3], rng.choice(l1), f"fresh{j}"], 900_000 + j)
    for x in (ref_m, m):
        x.sync()
    assert m.last_route == ref_m.last_route
    assert m.route_flushes == flushes0 + 1
    assert len(m.last_route["dirty_slices"]) == 1
    assert m.full_scatters == builds0  # routed, never re-placed
    c.add(["+", l1[0], l2[0]], "gz")
    for x in (ref_m, m):
        x.sync()
    assert m.last_route == ref_m.last_route and m.last_route["gzone"]
    assert m.route_gzone_flushes == gz0 + 1
    assert m.full_scatters == builds0
    topics = topics_for(rng, pools, 16) + [(l0[3], l1[0], "fresh0"),
                                           (l0[0], l1[0], l2[0])]
    for tp, rows in zip(topics, m.match_batch(topics)):
        assert norm(rows) == c.expect(tp), tp


def test_mesh_delta_churn_keeps_parity():
    c, pools, rng = build_bucketed(29, 15_000, 1 << 15, with_ref=True)
    rmesh, pmesh = meshes(4)
    ref_m = RefMeshMatcher(c.ref, rmesh, max_fanout=128)
    m = MeshMatcher(c.table, pmesh, max_fanout=128)
    l0, l1, l2 = pools
    m.match_batch(topics_for(rng, pools, 8))
    ref_m.sync()
    for round_i in range(3):
        for j in range(150):
            c.add([rng.choice(l0), rng.choice(l1), rng.choice(l2)],
                  1_000_000 + round_i * 1000 + j)
        removed = 0
        for e in list(c.table.entries):
            if removed >= 60:
                break
            if e is not None and rng.random() < 0.01:
                c.remove(e[0], e[1])
                removed += 1
        ref_m.sync()
        topics = topics_for(rng, pools, 32)
        for tp, rows in zip(topics, m.match_batch(topics)):
            assert norm(rows) == c.expect(tp), tp
        assert m.last_route == ref_m.last_route
    assert m.full_scatters == 1  # every churn round rode the delta path
    assert m.route_flushes == 3
    assert (m.route_rows, m.route_dirty_slices) == (ref_m.route_rows,
                                                    ref_m.route_dirty_slices)


# ---------------------------------------------------------------------------
# resharding (growth past a slice's window)
# ---------------------------------------------------------------------------


def test_mesh_growth_rebuild_repartitions_rows():
    """Growing the table past capacity re-partitions rows over the
    slices: callers shed to the host trie during the background rebuild,
    and after the install the device path serves the new layout."""
    c, pools, rng = build_bucketed(31, 12_000, 1 << 14)
    m = MeshGpuMatcher(mesh4(), max_levels=8, max_fanout=128)
    for e in c.table.entries:
        if e is not None:
            m.table.add(list(e[0]), e[1], e[2])
    topics = topics_for(rng, pools, 16)
    for tp, rows in zip(topics, m.match_batch(topics)):
        assert norm(rows) == c.expect(tp), tp
    Sl0 = m._swm._S // m._swm.nslices
    m.async_rebuild = True
    i = 0
    while not m.table.resized:
        f = [f"grow{i % 40}", f"lvl{i % 60}", f"leaf{i % 9}"]
        m.table.add(f, 5_000_000 + i, None)
        c.trie.add(list(f), 5_000_000 + i, None)
        i += 1
    shed = 0
    deadline = time.time() + 120
    while True:
        try:
            after = m.match_batch(topics)
            break
        except RebuildInProgress:
            shed += 1
            time.sleep(0.02)
            assert time.time() < deadline, "rebuild never installed"
    assert shed >= 1, "growth must shed at least one batch to the trie"
    assert m._swm._S // m._swm.nslices > Sl0
    for tp, rows in zip(topics, after):
        assert norm(rows) == c.expect(tp), tp


def test_mesh_adopt_slices_replays_exactly_once():
    """A slice-map change replays the newly-owned slice's rows exactly
    once: one slice-routed flush touching only that slice; a repeat
    adoption of the same epoch is a no-op."""
    c, pools, rng = build_bucketed(37, 12_000, 1 << 14)
    m = MeshGpuMatcher(mesh4(), max_levels=8, max_fanout=128)
    for e in c.table.entries:
        if e is not None:
            m.table.add(list(e[0]), e[1], e[2])
    topics = topics_for(rng, pools, 8)
    m.match_batch(topics)
    flushes0 = m._swm.route_flushes
    assert m.adopt_slices([2], epoch=9) > 0
    assert m.adopt_slices([2], epoch=9) == 0  # exactly once per epoch
    got = m.match_batch(topics)
    assert m._swm.route_flushes == flushes0 + 1
    assert m._swm.last_route["dirty_slices"] == [2]
    assert m.adopt_slices([2], epoch=9) == 0
    m.match_batch(topics)
    assert m._swm.route_flushes == flushes0 + 1  # no second replay
    for tp, rows in zip(topics, got):
        assert norm(rows) == c.expect(tp), tp
    assert m.mesh_status()["slice_adoptions"] == 1


# ---------------------------------------------------------------------------
# the per-process path (single-process simulation) and two processes
# ---------------------------------------------------------------------------


def test_mesh_local_slice_union_and_failure_degradation(four_slices):
    """match_local_slices returns each slice's exact partial fanout (the
    reference's partials, id for id): the union over all slices equals
    the trie, and with a 'failed' slice the survivors' partials plus the
    host walk over the failed rows still reproduce it."""
    from vernemq_tpu_torch.protocol.topic import match_dollar_aware

    c, pools, rng, ref_m, m = four_slices
    topics = topics_for(rng, pools, 12) + [("$SYS", "stats", "q")]
    ref_m.sync()
    ids, ranges = m.match_local_slices(topics)
    rids, rranges = ref_m.match_local_slices(topics)
    assert ranges == [tuple(r) for r in rranges] and len(ranges) == 4
    ent = list(c.table.entries)
    for tp, sl, rsl in zip(topics, ids, rids):
        assert np.array_equal(np.sort(sl), np.sort(rsl)), tp
        rows = [ent[i] for i in sl if ent[i] is not None]
        assert norm(rows) == c.expect(tp), tp
    lo, hi = ranges[3]
    for tp, sl in zip(topics, ids):
        surviving = [ent[i] for i in sl
                     if not (lo <= i < hi) and ent[i] is not None]
        degraded = [e for e in ent[lo:hi]
                    if e is not None
                    and match_dollar_aware(list(tp), list(e[0]))]
        assert norm(surviving + degraded) == c.expect(tp), tp


HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_mesh_dist_helper.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.multiproc
def test_two_process_mesh_match_route_and_degradation():
    """Two processes on gloo place complementary halves of ONE table: the
    union of their slice partials equals the trie (and the JAX package's
    helper corpus is the same), each routes a write-through only to its
    own dirty slices, the group-summed total equals the partials', the
    windowed dispatch is refused and the seat degrades it, and process 0's
    partials plus the host walk over the dead peer's rows reproduce the
    trie."""
    import _mesh_dist_helper as ref_helper
    import _torch_mesh_dist_helper as helper

    from vernemq_tpu_torch.models.table import SubscriptionTable

    port = _free_port()
    env = dict(os.environ)
    env.pop("TIER1_FAULTHANDLER_S", None)
    procs = [subprocess.Popen(
        [sys.executable, HELPER, str(i), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    recs = {}
    for rc, out, err in outs:
        assert rc == 0, f"helper failed rc={rc}:\n{err[-2000:]}"
        rec = json.loads(out.strip().splitlines()[-1])
        recs[rec["pid"]] = rec
    assert recs[0]["addressable"] == [0, 1]
    assert recs[1]["addressable"] == [2, 3]
    assert not ({tuple(r) for r in recs[0]["ranges"]}
                & {tuple(r) for r in recs[1]["ranges"]})

    table = SubscriptionTable(max_levels=8, initial_capacity=1 << 14)
    trie = SubscriptionTrie()
    pools, topics = helper.corpus(table, trie)
    assert helper.corpus.__code__.co_code == ref_helper.corpus.__code__.co_code
    n_rows = 0
    for i, tp in enumerate(topics):
        got = sorted(recs[0]["partial"][i] + recs[1]["partial"][i])
        want = sorted(repr(k) for _, k, _ in trie.match(list(tp)))
        assert got == want, (tp, got, want)
        n_rows += len(got)
    assert recs[0]["total"] == recs[1]["total"] == n_rows
    for pid in (0, 1):
        route = recs[pid]["route"]
        assert route["full_scatters"] == 1
        assert route["routed"] <= len(route["addressable"])
        assert recs[pid]["refused"] and recs[pid]["seat_degraded"]
    l0, l1, _l2 = pools
    trie.add([l0[1], l1[1], "fresh"], "late", None)
    got = sorted(recs[0]["partial2"][len(topics)]
                 + recs[1]["partial2"][len(topics)])
    want = sorted(repr(k) for _, k, _ in trie.match([l0[1], l1[1], "fresh"]))
    assert got == want and "'late'" in got
    assert recs[0]["degraded_ok"] is True


# ---------------------------------------------------------------------------
# slice map + broker surface
# ---------------------------------------------------------------------------


def test_slice_map_claim_and_gossip_adoption():
    from vernemq_tpu_torch.cluster.mesh_map import PREFIX, MeshSliceMap
    from vernemq_tpu_torch.cluster.metadata import MetadataStore

    md = MetadataStore("n1")
    adopted = []
    mm = MeshSliceMap(md, "n1", 4,
                      on_adopt=lambda s, e: adopted.append((s, e)))
    assert mm.claim_local() == [0, 1, 2, 3]
    assert mm.local_slices() == [0, 1, 2, 3]
    assert adopted and adopted[0][0] == [0, 1, 2, 3]
    assert mm.claim_local() == []
    assert mm.claim_local(["n1", "n2"]) == []
    assert mm.counts_by_node() == {"n1": 4}
    adopted.clear()
    md.merge(PREFIX, 1, (md._clock + 10, "n2", {"node": "n2", "epoch": 3}))
    assert adopted == []
    md.merge(PREFIX, 1, (md._clock + 20, "n2", {"node": "n1", "epoch": 4}))
    assert adopted == [([1], ("n2", 4))]
    assert set(mm.release_local()) == {0, 1, 2, 3}
    assert mm.local_slices() == []
    assert mm.counts_by_node() == {}


@pytest.mark.asyncio
async def test_broker_mesh_surface_and_admin_show():
    """A port broker with tpu_mesh claims every slice at start and answers
    `vmq-admin mesh show` and `cluster show` as the reference's broker
    does; after a publish through the mesh seat `mesh show` carries its
    routing and rows, and the mesh_* gauges are live. Without a mesh,
    `mesh show` refuses and the gauges read zero."""
    from vernemq_tpu.admin.commands import (
        CommandRegistry as RefCommands,
        register_core_commands as ref_register)
    from vernemq_tpu.broker.config import Config as RefConfig
    from vernemq_tpu.broker.server import start_broker as ref_start
    from vernemq_tpu_torch.admin.commands import (CommandError,
                                                  CommandRegistry,
                                                  register_core_commands)
    from vernemq_tpu_torch.broker.config import Config
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.client import MQTTClient

    kw = dict(systree_enabled=False, allow_anonymous=True, tpu_mesh="1x2",
              tpu_host_batch_threshold=0, tpu_lock_busy_shed_ms=0)
    rb, rs = await ref_start(RefConfig(**kw), port=0, node_name="mesh1")
    broker, server = await start_broker(Config(**kw, default_reg_view="tpu"),
                                        port=0, node_name="mesh1",
                                        device="cpu")
    try:
        reg = register_core_commands(CommandRegistry())
        rreg = ref_register(RefCommands())
        assert broker.mesh_map.local_slices() == [0, 1]
        for cmd in (["mesh", "show"], ["cluster", "show"]):
            assert reg.run(broker, cmd) == rreg.run(rb, cmd), cmd
        g, rg = broker._gauges(), rb._gauges()
        assert {k: g[k] for k in g if k.startswith("mesh_")} == \
            {k: rg[k] for k in rg if k.startswith("mesh_")}
        assert g["mesh_slices_total"] == g["mesh_slices_local"] == 2.0
        sub = MQTTClient("127.0.0.1", server.port, client_id="ms")
        assert (await sub.connect()).rc == 0
        await sub.subscribe("mesh/+", qos=1)
        pub = MQTTClient("127.0.0.1", server.port, client_id="mp")
        assert (await pub.connect()).rc == 0
        await pub.publish("mesh/x", b"on-the-mesh", qos=1)
        assert (await sub.recv()).payload == b"on-the-mesh"
        out = reg.run(broker, ["mesh", "show"])
        assert [r["node"] for r in out["table"]] == ["mesh1", "mesh1"]
        assert sum(r["rows"] for r in out["table"]) == 1
        assert out["routing"]["full_scatters"] >= 1
        assert broker._gauges()["mesh_rows_resident"] == 1.0
        assert broker._gauges()["mesh_dispatches"] >= 1.0
        await sub.disconnect()
        await pub.disconnect()
    finally:
        await broker.stop()
        await server.stop()
        await rb.stop()
        await rs.stop()

    broker2, server2 = await start_broker(
        Config(systree_enabled=False, allow_anonymous=True), port=0)
    try:
        reg = register_core_commands(CommandRegistry())
        with pytest.raises(CommandError):
            reg.run(broker2, ["mesh", "show"])
        assert broker2._gauges()["mesh_slices_total"] == 0.0
    finally:
        await broker2.stop()
        await server2.stop()
