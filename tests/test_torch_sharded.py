"""The port's sharded matcher (vernemq_tpu_torch/parallel/sharded_match.py)
against the JAX package's, on the reference tests' corpora and shapes
(tests/test_sharded_match.py, tests/test_sharded_seat.py): the port's
meshes repeat the one CPU device, the reference's span the 8 virtual CPU
devices of tests/conftest.py.

Where a case compares the two packages it requires, per publish, the same
matched slot ids in the same order and the same overflow flags and
leftovers (``_torch_mesh.same_dispatch``); those cases share one corpus
and one batch shape, so the JAX side compiles each mesh shape once. Every
case also holds the port's rows against the port's host trie. Also here:
the tile kernel's shard row mode, whose plain version is held against the
reference's sharded probe epilogue."""

import asyncio
import os
import random
import re
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import (build_bucketed, meshes, norm, same_dispatch,
                         topics_for)
from _torch_port import n, t
from vernemq_tpu.ops import match_kernel as JK
from vernemq_tpu.parallel.sharded_match import (
    ShardedWindowedMatcher as RefSWM, build_sharded_matcher as ref_build,
    shard_pubs as ref_shard_pubs, shard_table as ref_shard_table)
from vernemq_tpu_torch.models.matcher import RebuildInProgress
from vernemq_tpu_torch.models.table import SubscriptionTable
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.ops import match_kernel as TK
from vernemq_tpu_torch.ops import tile_match as TM
from vernemq_tpu_torch.parallel.mesh import make_mesh
from vernemq_tpu_torch.parallel.sharded_match import (ShardedGpuMatcher,
                                                      ShardedMatcher,
                                                      ShardedWindowedMatcher,
                                                      shard_pubs)

CPU8 = ["cpu"] * 8


# ---------------------------------------------------------------------------
# the level-wise sharded matcher (reference: test_sharded_match.py :1-55)
# ---------------------------------------------------------------------------

def _flat_corpus(seed, n_filters=200, L=8, cap=256):
    from tests.test_tpu_match import rand_filter, rand_topic

    from vernemq_tpu.models.tpu_table import SubscriptionTable as RefTable

    rng = random.Random(seed)
    ref = RefTable(max_levels=L, initial_capacity=cap)
    table = SubscriptionTable(max_levels=L, initial_capacity=cap)
    trie = SubscriptionTrie()
    for i in range(n_filters):
        f = rand_filter(rng)
        for x in (ref, table, trie):
            x.add(list(f), i, None)
    topics = [rand_topic(rng) for _ in range(64)]
    return ref, table, trie, topics


def test_mesh_may_repeat_a_device():
    """The reference's 8-device CPU mesh exists; the port's mesh of the
    one CPU device repeated has the same axes."""
    assert len(jax.devices()) == 8
    m = make_mesh(CPU8, batch=2)
    assert m.shape == {"batch": 2, "sub": 4}
    assert {str(d.device) for d in m.devices.flat} == {"cpu"}


@pytest.mark.parametrize("batch_axis", [1, 2])
def test_sharded_parity(batch_axis):
    """ShardedMatcher's rows equal the trie's, and its per-shard
    candidates (idx where valid, valid, summed counts) the reference's."""
    from vernemq_tpu.parallel.mesh import make_mesh as ref_make_mesh

    ref, table, trie, topics = _flat_corpus(seed=7)
    m = ShardedMatcher(table, make_mesh(CPU8, batch=batch_axis),
                       max_fanout=64)
    assert m.mesh.shape["sub"] == 8 // batch_axis
    got = m.match_batch(topics)
    for topic, rows in zip(topics, got):
        assert norm(rows) == norm(trie.match(list(topic))), topic
    # the raw candidates against the reference's shard_map on one batch
    rmesh = ref_make_mesh(batch=batch_axis)
    B = 64
    pw = np.full((B, 8), -2, np.int32)
    pl = np.zeros(B, np.int32)
    pd = np.zeros(B, bool)
    for i, tp in enumerate(topics):
        pw[i], pl[i], pd[i] = table.encode_topic(tp)
    args = (table.words, table.eff_len, table.has_hash, table.first_wild,
            table.active)
    want = ref_build(rmesh, 64)(*ref_shard_table(rmesh, *args),
                                *ref_shard_pubs(rmesh, pw, pl, pd))
    got = m._fn(*m._dev, *shard_pubs(m.mesh, pw, pl, pd))
    wi, wv, wc = (np.asarray(x) for x in want)
    gi, gv, gc = got
    assert np.array_equal(gv, wv) and np.array_equal(gc, wc)
    assert np.array_equal(np.where(gv, gi, 0), np.where(wv, wi, 0))


def test_sharded_delta_resync():
    _, table, trie, topics = _flat_corpus(seed=11)
    m = ShardedMatcher(table, make_mesh(CPU8), max_fanout=64)
    m.match_batch(topics[:4])
    table.add(["#"], "late", None)
    trie.add(["#"], "late", None)
    got = m.match_batch(topics[:8])
    for topic, rows in zip(topics[:8], got):
        assert norm(rows) == norm(trie.match(list(topic))), topic


# ---------------------------------------------------------------------------
# the windowed matcher (reference: test_sharded_match.py :57-301)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared():
    """The corpus the cases comparing with the JAX package share (one
    table, one batch shape: 99 publishes → Bpad 128), with a ``$SYS``
    filter, and their matchers per (batch axis, merge), each reference one
    compiled once."""
    c, pools, rng = build_bucketed(23, 30_000, 1 << 15, with_ref=True)
    c.add(["$SYS", "stats", "#"], "sys")
    topics = topics_for(rng, pools, 96) + [
        ("$SYS", "stats", "x"), ("neverseen", "word", "here"),
        ("$SYS", "other", "y")]
    pairs = {}

    def pair(batch_axis, merge):
        key = (batch_axis, merge)
        if key not in pairs:
            rmesh, pmesh = meshes(8, batch_axis)
            pairs[key] = (RefSWM(c.ref, rmesh, max_fanout=128, merge=merge),
                          ShardedWindowedMatcher(c.table, pmesh,
                                                 max_fanout=128, merge=merge))
        return pairs[key]

    return c, pools, topics, pair


def _check_rows(m, c, topics):
    got = m.match_batch(topics)
    for tp, rows in zip(topics, got):
        assert norm(rows) == c.expect(tp), tp


@pytest.mark.parametrize("batch_axis", [1, 2])
def test_windowed_sharded_parity(shared, batch_axis):
    """The shared corpus on the 'sub'-sharded windowed matcher: slot ids
    and flags equal the reference's, rows the trie's."""
    c, _, topics, pair = shared
    ref_m, m = pair(batch_axis, False)
    assert same_dispatch(ref_m, m, topics, c) > len(topics) // 2


@pytest.mark.parametrize("batch_axis", [1, 2])
def test_windowed_sharded_parity_100k(batch_axis):
    """>= 100k filters, bucketed table sharded over 'sub': parity with the
    host trie."""
    c, pools, rng = build_bucketed(7, 100_000, 1 << 17)
    m = ShardedWindowedMatcher(c.table, make_mesh(CPU8, batch=batch_axis),
                               max_fanout=128)
    _check_rows(m, c, topics_for(rng, pools, 200))


def test_windowed_sharded_churn():
    """Subscribe/unsubscribe churn between batches: the delta keeps
    parity."""
    c, pools, rng = build_bucketed(13, 20_000, 1 << 15)
    m = ShardedWindowedMatcher(c.table, make_mesh(CPU8, batch=2),
                               max_fanout=128)
    l0, l1, l2 = pools
    for round_i in range(3):
        base = 1_000_000 + round_i * 1000
        for j in range(200):
            c.add([rng.choice(l0), rng.choice(l1), rng.choice(l2)],
                  base + j)
        removed = 0
        for e in list(c.table.entries):
            if removed >= 100:
                break
            if e is not None and rng.random() < 0.01:
                c.remove(e[0], e[1])
                removed += 1
        _check_rows(m, c, topics_for(rng, pools, 64))


def test_windowed_sharded_uneven_shards():
    """Zipf-skewed corpus and publishes: hot buckets overload one shard's
    tile slots; overflow publishes still match exactly (host fallback)."""
    c, pools, rng = build_bucketed(17, 30_000, 1 << 15, skew=True)
    m = ShardedWindowedMatcher(c.table, make_mesh(CPU8, batch=1),
                               max_fanout=128)
    _check_rows(m, c, topics_for(rng, pools, 300, skew=True))


def test_windowed_sharded_dollar_and_unknown(shared):
    """$-topics and never-subscribed words under sharding, on a 2 x 4
    mesh: the same slot ids as the reference."""
    c, _, topics, pair = shared
    ref_m, m = pair(2, False)
    specials = topics[-3:] + topics[:96]
    assert same_dispatch(ref_m, m, specials, c) > len(specials) // 2
    _check_rows(m, c, topics[-3:])


def test_windowed_sharded_relocation_churn():
    """A bucket overflowing after the matcher is warm relocates into the
    spare tail (owned by the last 'sub' shard): the delta plus the
    geometry refresh keep parity without a resize."""
    c, pools, rng = build_bucketed(29, 20_000, 1 << 15)
    m = ShardedWindowedMatcher(c.table, make_mesh(CPU8, batch=2),
                               max_fanout=128)
    m.match_batch(topics_for(rng, pools, 32) + [("hotword", "a", "b")])
    for i in range(8000):
        c.add(["hotword", f"d{i}", f"m{i % 5}"], 500_000 + i)
        if c.table.resized:
            break
    probe = [("hotword", f"d{i}", f"m{i % 5}") for i in range(0, 8000, 257)]
    _check_rows(m, c, probe + topics_for(rng, pools, 16))


def test_windowed_sharded_overflow_and_clip_fall_back_exact():
    """A starved flat buffer (flat_avg 1) and a tiny k on the sharded flat
    kernel: the clipped and capacity-overflowed publishes carry the
    reference's overflow flags and fall back to the exact host path
    without corrupting their neighbours' ranges."""
    c, pools, rng = build_bucketed(11, 40_000, 1 << 16, with_ref=True)
    l0, l1, l2 = pools
    for d in range(40):
        c.add([l0[0], l1[0], l2[0]], ("dup", d))
    rmesh, pmesh = meshes(8, 2)
    ref_m = RefSWM(c.ref, rmesh, max_fanout=8, flat_avg=1)
    m = ShardedWindowedMatcher(c.table, pmesh, max_fanout=8, flat_avg=1)
    topics = [(l0[0], l1[0], l2[0])] * 3 + topics_for(rng, pools, 29)
    served = same_dispatch(ref_m, m, topics)
    assert served < len(topics)  # the flags engaged
    _check_rows(m, c, topics)


@pytest.mark.parametrize("batch_axis", [1, 2])
def test_windowed_sharded_merged_output_parity(shared, batch_axis):
    """merge=True (each batch row's buffers merged on its first device,
    the seat's posture): the reference's merged slot ids, the trie's rows;
    then churn keeps parity through the merged layout."""
    c, pools, topics, pair = shared
    ref_m, m = pair(batch_axis, True)
    assert same_dispatch(ref_m, m, topics, c) > len(topics) // 2
    rng = random.Random(batch_axis)
    l0, l1, l2 = pools
    for j in range(120):
        c.add([rng.choice(l0), rng.choice(l1), rng.choice(l2)],
              (2_000_000 + j, batch_axis))
    _check_rows(m, c, topics[:32])


def test_merged_output_survives_per_shard_cnt_over_k():
    """A shard whose dense-chunk matches plus probe-tile matches for ONE
    publish total more than k (each part <= k, so nothing clips) holds up
    to 2k entries in its range; the merge must copy all 2k. The topic is
    chosen so its bucket's shard, its g-bucket's dense-column shard and
    tiling line up, and the engagement is asserted on an unmerged twin."""
    c, pools, rng = build_bucketed(31, 20_000, 1 << 15)
    mesh = make_mesh(CPU8, batch=1)
    nsub = mesh.shape["sub"]
    k = 8
    m = ShardedWindowedMatcher(c.table, mesh, max_fanout=k, merge=True)
    m.sync()
    Sl = m._S // nsub
    GW = m._glob // nsub
    table = c.table
    cands = []
    for a in range(400):
        w = (f"qx{a}", f"qy{a}", f"qz{a}")
        _, _, _, bucket, gb = table.encode_topic_ex(w)
        sb = min(int(m._reg_start[bucket]) // Sl, nsub - 1)
        sg = min(int(m._reg_start[gb]) // GW, nsub - 1)
        if sb == sg:
            cands.append(w)
    assert cands, "no colocated candidates"
    hit = None
    for (w0, w1, w2) in cands[:20]:
        key = hash((w0, w1, w2)) & 0xffff
        for i in range(6):   # probe side: exact, one bucket
            c.add([w0, w1, w2], 5_000_000 + key * 100 + i)
        for i in range(6):   # dense side: wildcard-first, one g-bucket
            c.add(["+", w1, w2], 6_000_000 + key * 100 + i)
        m.sync()
        if 0 in m._prep([(w0, w1, w2)])["leftovers"]:
            continue
        # an unmerged twin over the same table (a fresh build: m's sync
        # consumed the dirty rows)
        m2 = ShardedWindowedMatcher(table, mesh, max_fanout=k, merge=False)
        m2.sync()
        flat2, pre2, cnt2, ovf2 = m2._dispatch(m2._prep([(w0, w1, w2)]))
        if ovf2[0, :, 0].any():
            continue
        if int(cnt2[0, :, 0].max()) > k:
            hit = (w0, w1, w2)
            break
    assert hit, "no tiled colocated >k candidate engaged the merge window"
    rows = m.match_batch([hit])[0]
    assert norm(rows) == c.expect(hit)
    assert len(rows) >= 12


# ---------------------------------------------------------------------------
# the tile kernel's shard row mode (plain version) against the reference's
# sharded probe epilogue (vernemq_tpu/parallel/sharded_match.py:262-282)
# ---------------------------------------------------------------------------

def _ref_shard_probe(F_sh, t1_sh, eff, hh, fw, act, pw, pl, pd, start,
                     seg, row_base, glob_pad, bits):
    """One tile of the reference's sharded probe A, in jnp as it is
    written there: the coded product, its epilogue and the global row
    guard, packed."""
    Fseg = F_sh[:, start:start + seg]
    Gt = JK.build_pub_operand(jnp.asarray(pw), bits)
    mm = jax.lax.dot_general(Gt, Fseg, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32)
    sl = slice(start, start + seg)
    j = jnp.arange(seg, dtype=jnp.int32)
    rowok = (j[None, :] + row_base + start) >= glob_pad
    m = (mm + t1_sh[None, sl] == 0.0) & JK._epilogue(
        jnp.asarray(pl), jnp.asarray(pd), eff[sl], hh[sl], fw[sl],
        act[sl]) & rowok
    return np.asarray(JK._pack_mask(m))


@pytest.mark.parametrize("case", ["past", "straddles", "guard_off"])
def test_shard_row_guard_equals_the_reference_probe_epilogue(case):
    """The shard mode's plain version (``window_tiles_packed_ref``, what
    the kernel is held against on the card) equals the reference's sharded
    probe-A tile bit for bit: a shard whose rows all lie past glob_pad, one
    that straddles it, and the guard off (glob_pad 0, the per-slice
    match); with $-publishes against wildcard-first rows."""
    c, pools, rng = build_bucketed(5, 12_000, 1 << 14)
    table = c.table
    nsub = 4
    Sl = table.cap // nsub
    glob = table.gb_end
    s = {"past": nsub - 1, "straddles": glob // Sl, "guard_off": 1}[case]
    row_base = s * Sl
    assert case != "straddles" or row_base < glob < row_base + Sl
    glob_pad = 0 if case == "guard_off" else glob
    seg = 2048
    start = {"past": 512, "straddles": glob - row_base - 1024,
             "guard_off": 256}[case]
    rows = slice(row_base, row_base + Sl)
    topics = topics_for(rng, pools, 30) + [("$SYS", "a", "b"),
                                           ("r1", "d1", "m1")]
    TP = 32
    pw = np.zeros((TP, 8), np.int32)
    pl = np.zeros(TP, np.int32)
    pd = np.zeros(TP, bool)
    for i, tp in enumerate(topics):
        pw[i], pl[i], pd[i] = table.encode_topic(tp)
    bits = table.id_bits
    F_t, t1 = JK.build_operands(table.words[rows], table.eff_len[rows],
                                id_bits=bits)
    meta = [table.eff_len[rows], table.has_hash[rows],
            table.first_wild[rows], table.active[rows]]
    want = _ref_shard_probe(F_t, t1, *meta, pw, pl, pd, start, seg,
                            row_base, glob_pad, bits)
    flags = TM.row_flags(*(t(a) for a in meta[1:]))
    G = TK.build_pub_operand(t(pw), bits)
    got = TM.window_tiles_packed(
        t(n(F_t)).to(torch.bfloat16), t(n(t1)), t(meta[0]), flags,
        G[None], t(pl)[None], t(pd.astype(np.int32))[None],
        torch.tensor([start], dtype=torch.int32), seg_max=seg,
        glob_pad=glob_pad, mode="shard", row_base=row_base,
        start_host=np.array([start], np.int32))[0]
    assert np.array_equal(got.numpy(), want.view(np.int32))
    assert int(TK._popcount(got).sum()) > 0


# ---------------------------------------------------------------------------
# the seat (reference: tests/test_sharded_seat.py)
# ---------------------------------------------------------------------------

def _seat(c, mesh, **kw):
    m = ShardedGpuMatcher(mesh, max_levels=8, **kw)
    with m.lock:
        for e in c.table.entries:
            if e is not None:
                m.table.add(list(e[0]), e[1], None)
    return m


@pytest.mark.parametrize("batch_axis", [1, 2])
def test_seat_parity_20k(batch_axis):
    c, pools, rng = build_bucketed(7, 20_000, 1 << 15)
    m = _seat(c, make_mesh(CPU8, batch=batch_axis), max_fanout=128)
    topics = topics_for(rng, pools, 100)
    got = m.match_batch(topics)
    assert m.match_batches == 1 and m.match_publishes == 100
    for topic, rows in zip(topics, got):
        assert norm(rows) == c.expect(topic), topic


def test_seat_delta_stream_parity():
    """Subscribe/unsubscribe churn between batches rides the sharded delta
    (no full rebuild) and stays exact."""
    c, pools, rng = build_bucketed(11, 10_000, 1 << 15)
    m = _seat(c, make_mesh(CPU8, batch=2), max_fanout=128)
    m.match_batch(topics_for(rng, pools, 16))  # first full build
    dev0 = m._swm._dev
    l0, l1, l2 = pools
    for round_i in range(3):
        base = 1_000_000 + round_i * 1000
        with m.lock:
            for j in range(50):
                f = [rng.choice(l0), rng.choice(l1), rng.choice(l2)]
                m.table.add(f, base + j, None)
                c.trie.add(list(f), base + j, None)
            removed = 0
            for e in list(m.table.entries):
                if removed >= 25:
                    break
                if e is not None and rng.random() < 0.01:
                    m.table.remove(list(e[0]), e[1])
                    c.trie.remove(list(e[0]), e[1])
                    removed += 1
        assert not m.table.resized  # still the delta path
        topics = topics_for(rng, pools, 32)
        for topic, rows in zip(topics, m.match_batch(topics)):
            assert norm(rows) == c.expect(topic), topic
    # scattered in place: the same shard tensors, no rebuild
    assert m._swm._dev[0].data(0, 0) is dev0[0].data(0, 0)


def test_seat_busy_shed_and_no_cold_gate():
    """A held lock past lock_timeout sheds (MatcherBusy) instead of
    head-blocking. The reference also refuses a cold compile signature
    (MatcherBusy(cold=True)); the port compiles nothing per shape, so a
    first batch with a lock bound is served."""
    from vernemq_tpu_torch.models.matcher import MatcherBusy

    c, pools, rng = build_bucketed(13, 5_000, 1 << 15)
    m = _seat(c, make_mesh(CPU8, batch=1), max_fanout=64)
    topics = topics_for(rng, pools, 8)
    got = m.match_batch(topics, lock_timeout=1.0)
    for topic, rows in zip(topics, got):
        assert norm(rows) == c.expect(topic), topic
    m.lock.acquire()
    try:
        with pytest.raises(MatcherBusy):
            m.match_batch(topics, lock_timeout=0.05)
    finally:
        m.lock.release()
    assert m.busy_sheds == 1


def test_seat_async_rebuild_sheds_then_installs():
    """A growth rebuild with async_rebuild on sheds (RebuildInProgress)
    instead of stalling, and the background install restores service."""
    c, pools, rng = build_bucketed(17, 5_000, 1 << 15)
    m = _seat(c, make_mesh(CPU8, batch=2), max_fanout=64)
    m.match_batch(topics_for(rng, pools, 8))
    m.async_rebuild = True
    with m.lock:
        m.table.resized = True  # simulate a capacity change
    with pytest.raises(RebuildInProgress):
        m.match_batch(topics_for(rng, pools, 8))
    topics = topics_for(rng, pools, 16)
    deadline = time.time() + 60
    while True:
        try:
            got = m.match_batch(topics)
            break
        except RebuildInProgress:
            assert time.time() < deadline, "rebuild never installed"
            time.sleep(0.05)
    assert m.rebuilds_async >= 1
    for topic, rows in zip(topics, got):
        assert norm(rows) == c.expect(topic), topic


@pytest.mark.asyncio
async def test_broker_serves_through_sharded_view():
    """A port broker with a tpu_mesh boots on the CPU mesh, an MQTT
    subscribe/publish round-trips through it, and the serving matcher is
    the sharded seat ({'batch': 2, 'sub': 4})."""
    from vernemq_tpu_torch.broker.config import Config
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.client import MQTTClient

    cfg = Config(systree_enabled=False, allow_anonymous=True,
                 default_reg_view="tpu", tpu_mesh="2x4")
    broker, server = await start_broker(cfg, port=0, device="cpu")
    try:
        view = broker.registry.reg_view("tpu")
        sub = MQTTClient("127.0.0.1", server.port, client_id="shs")
        assert (await sub.connect()).rc == 0
        await sub.subscribe("sh/+/t", qos=1)
        m = view.matcher("")
        assert isinstance(m, ShardedGpuMatcher)
        assert m.mesh.shape == {"batch": 2, "sub": 4}
        pub = MQTTClient("127.0.0.1", server.port, client_id="shp")
        assert (await pub.connect()).rc == 0
        await pub.publish("sh/1/t", b"via-mesh", qos=1)
        msg = await sub.recv()
        assert msg.payload == b"via-mesh"
        rows = view.fold("", ["sh", "1", "t"])
        assert len(rows) == 1 and rows[0][1] == ("", "shs")
        assert m.match_batches >= 1
        await sub.unsubscribe("sh/+/t")
        assert view.fold("", ["sh", "1", "t"]) == []
        await sub.disconnect()
        await pub.disconnect()
    finally:
        await broker.stop()
        await server.stop()


def test_cli_tpu_mesh_flag_boots_and_serves():
    """``python -m vernemq_tpu_torch.broker.server --tpu-mesh 2x4 --device
    cpu`` boots a broker serving on the mesh and a client round-trips
    through it; ``--reg-view trie --tpu-mesh`` is refused at parse time."""
    r = subprocess.run(
        [sys.executable, "-m", "vernemq_tpu_torch.broker.server",
         "--reg-view", "trie", "--tpu-mesh", "2x4"],
        capture_output=True, text=True, timeout=60)
    assert r.returncode != 0 and "--tpu-mesh requires" in r.stderr

    errf = tempfile.NamedTemporaryFile(suffix=".err", delete=False)
    outf = tempfile.NamedTemporaryFile(suffix=".out", delete=False)
    p = subprocess.Popen(
        [sys.executable, "-m", "vernemq_tpu_torch.broker.server",
         "--port", "0", "--allow-anonymous", "--tpu-mesh", "2x4",
         "--device", "cpu"], stdout=outf, stderr=errf,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        deadline = time.time() + 90
        port = None
        while time.time() < deadline:
            got = re.search(rb"listening on [\d.]+:(\d+)",
                            open(outf.name, "rb").read())
            if got:
                port = int(got.group(1))
                break
            assert p.poll() is None, open(errf.name).read()[-500:]
            time.sleep(0.2)
        assert port, open(errf.name).read()[-500:]

        async def drive():
            from vernemq_tpu_torch.client import MQTTClient

            s = MQTTClient("127.0.0.1", port, client_id="cli-s")
            assert (await s.connect()).rc == 0
            await s.subscribe("cli/+", qos=1)
            pub = MQTTClient("127.0.0.1", port, client_id="cli-p")
            assert (await pub.connect()).rc == 0
            await pub.publish("cli/x", b"mesh-cli", qos=1)
            assert (await s.recv()).payload == b"mesh-cli"
            await s.disconnect()
            await pub.disconnect()

        asyncio.run(drive())
    finally:
        p.terminate()
        p.wait(10)
        for f in (errf, outf):
            os.unlink(f.name)
