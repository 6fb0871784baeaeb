"""The port's GpuMatcher / GpuRegView (device="cpu") against the host trie
and the JAX TpuMatcher, plus the port's host prep, the table carry-over and
the device rule (CUDA by default, never a silent CPU fallback)."""

import random

import numpy as np
import pytest
import torch

from _torch_port import fill, n, norm, rand_filter, rand_topic
from vernemq_tpu.models import tpu_matcher as JM
from vernemq_tpu.models.trie import SubscriptionTrie as RefTrie
from vernemq_tpu_torch import resolve_device
from vernemq_tpu_torch.carry import table_state_from_reference
from vernemq_tpu_torch.models import matcher as GM
from vernemq_tpu_torch.models.trie import SubscriptionTrie


def _pair(seed, n_subs, cap, L=8, **kw):
    rng = random.Random(seed)
    m = GM.GpuMatcher(max_levels=L, initial_capacity=cap, device="cpu", **kw)
    trie = SubscriptionTrie()
    fill(rng, n_subs, m.table, trie)
    return rng, m, trie


def _check(m, trie, topics):
    for topic, rows in zip(topics, m.match_batch(topics)):
        assert norm(rows) == norm(trie.match(list(topic))), topic


@pytest.mark.parametrize("seed,n_subs,cap,bucketed", [
    (0, 5000, 8192, True),     # bucketed: windowed path, probe A only
    (1, 3000, 32768, True),    # bucketed with g-buckets: probe B too
    (2, 600, 1024, False),     # unbucketed: dense mask path
])
def test_matches_trie(seed, n_subs, cap, bucketed):
    rng, m, trie = _pair(seed, n_subs, cap)
    topics = [rand_topic(rng) for _ in range(64)]
    _check(m, trie, topics)
    assert m.table.bucketed == bucketed
    assert m.host_fallbacks == 0


@pytest.mark.parametrize("cap", [8192, 1024])
def test_dollar_hash_and_long_filters(cap):
    """$-rule, '#' matching its parent level, and filters longer than L
    (the table's host overflow store), on both paths."""
    rng, m, trie = _pair(3, 3000 if cap > 1024 else 300, cap, L=4)
    specials = (["#"], ["+", "x"], ["$SYS", "#"], ["$SYS", "+", "x"],
                ["a", "#"], ["a", "b", "c", "d", "e", "f"],
                ["a", "+", "c", "d", "e", "#"])
    for i, f in enumerate(specials):
        m.table.add(f, f"s{i}", None)
        trie.add(f, f"s{i}", None)
    assert len(m.table.overflow) >= 2  # longer than L: host-side rows
    topics = [["$SYS", "node", "x"], ["$SYS", "x"], ["a"], ["x"], ["$SYS"],
              ["a", "b", "c", "d", "e", "f"], ["a", "q", "c", "d", "e"],
              ["a", "q", "c", "d", "e", "f", "g"]] \
        + [rand_topic(rng) for _ in range(16)]
    _check(m, trie, topics)


def test_fanout_past_max_fanout_falls_back_to_host():
    rng, m, trie = _pair(4, 5000, 8192, max_fanout=8)
    for i in range(40):
        m.table.add(["hot", "+"], f"h{i}", None)
        trie.add(["hot", "+"], f"h{i}", None)
    topics = [["hot", "x"]] + [rand_topic(rng) for _ in range(8)]
    _check(m, trie, topics)
    assert m.host_fallbacks >= 1


@pytest.mark.parametrize("cap", [8192, 1024])
def test_delta_then_match(cap):
    """Adds and removes after the first build go through the in-place
    delta scatter (and a relocation or rebuild when a region fills)."""
    rng, m, trie = _pair(5, 4000 if cap > 1024 else 400, cap)
    topics = [rand_topic(rng) for _ in range(48)]
    _check(m, trie, topics)
    for i in range(0, 400, 3):  # remove some present filters
        for f, k, _ in trie.match(rand_topic(random.Random(i)))[:2]:
            trie.remove(list(f), k)
            assert m.table.remove(list(f), k)
    rng2 = random.Random(55)
    for i in range(300):
        f = rand_filter(rng2)
        m.table.add(f, f"n{i}", None)
        trie.add(f, f"n{i}", None)
    _check(m, trie, topics)


@pytest.fixture(scope="module")
def ref_pair():
    """The JAX TpuMatcher and the port's GpuMatcher over one corpus (a
    g-bucketed table, so both probes run) after the same removals, with
    the reference's results for a batch of topics (one JAX compile serves
    every test of the module)."""
    rng = random.Random(6)
    ref = JM.TpuMatcher(max_levels=8, initial_capacity=32768)
    m = GM.GpuMatcher(max_levels=8, initial_capacity=32768, device="cpu")
    fill(rng, 3000, ref.table, m.table)
    for i in range(60):  # leave free slots behind
        f = rand_filter(random.Random(i))
        assert ref.table.remove(f, f"c{i}") == m.table.remove(f, f"c{i}")
    topics = [rand_topic(rng) for _ in range(64)] + [["$SYS", "w1"]]
    return ref, m, topics, ref.match_batch(topics), rng


def test_matches_reference_matcher(ref_pair):
    """Same corpus and topics: identical rows from the port and from the
    JAX TpuMatcher (both windowed, both with probe B)."""
    ref, m, topics, want, _ = ref_pair
    for a, b in zip(m.match_batch(topics), want):
        assert norm(a) == norm(b)
    np.testing.assert_array_equal(m._reg_start, ref._reg_start)
    assert m._ng and m.host_fallbacks == ref.host_fallbacks == 0


def test_host_prep_matches_reference():
    """window_params / prepare_windows / _pad_pub_block are copies: same
    outputs as the reference's (align 0, selector emit)."""
    rng = np.random.default_rng(8)
    S, Bpad, n_pub, nreg = 200_000, 1024, 900, 40
    caps = rng.integers(1, 20, nreg) * 256
    reg_start = np.concatenate([[0], np.cumsum(caps)[:-1]]) + 2048
    reg_end = reg_start + caps
    for zone, bmax in ((S - 2048, int(caps.max())), (None, 4096)):
        assert GM.window_params(S, 2048, bmax, Bpad, zone=zone) \
            == JM.window_params(S, 2048, bmax, Bpad, zone=zone)
    T, seg, _ = GM.window_params(S, 2048, int(caps.max()), Bpad)
    pb = rng.integers(0, nreg, n_pub)
    got = GM.prepare_windows(pb, n_pub, reg_start, reg_end, S, T, seg,
                             row_lo=2048)
    pw = np.zeros((Bpad, 4), np.int32)
    want = JM.prepare_windows(pw, pw[:, 0], pw[:, 0] > 0, pb, n_pub,
                              reg_start, reg_end, S, T, seg, row_lo=2048,
                              emit="sel")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    blk = (pw[:5], np.ones(5, np.int32), np.ones(5, bool))
    for x, y in zip(GM._pad_pub_block(*blk, 16), JM._pad_pub_block(*blk, 16)):
        np.testing.assert_array_equal(x, y)


def test_carry_round_trip(ref_pair):
    """The reference's table state carried into the port: same rows and
    regions, operands equal to the JAX build_operands, the port matches
    exactly what the reference matches, and the carried table keeps
    taking subscriptions."""
    ref, _, topics, want, rng = ref_pair
    with ref.lock:
        state = ref._snapshot_host_locked(copy=True, clear=False)
    table, dev = table_state_from_reference(
        state, ref.table.interner, ref.table.entries, device="cpu")
    F_j, t1_j = ref._operands
    np.testing.assert_array_equal(n(dev[0]), n(F_j))
    np.testing.assert_array_equal(n(dev[1]), n(t1_j))
    for x, y in zip(dev[2:], ref._dev_arrays[1:5]):
        np.testing.assert_array_equal(n(x), n(y))
    assert table.count == ref.table.count
    m = GM.GpuMatcher(max_levels=8, device="cpu")
    m.table = table
    for a, b in zip(m.match_batch(topics), want):
        assert norm(a) == norm(b)
    trie = SubscriptionTrie()
    for e in table.entries:
        if e is not None:
            trie.add(list(e[0]), e[1], e[2])
    for i in range(200):
        f = rand_filter(rng)
        m.table.add(f, f"z{i}", None)
        trie.add(f, f"z{i}", None)
    _check(m, trie, topics)


def test_default_device_is_cuda_and_never_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GM.GpuMatcher()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GM.GpuRegView(registry=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        table_state_from_reference({}, None, [])
    assert resolve_device("cpu") == torch.device("cpu")


class _Registry:
    """Duck-typed registry: fold_subscriptions(mp) + trie(mp)."""

    def __init__(self):
        self.tries = {"": SubscriptionTrie()}

    def fold_subscriptions(self, mp):
        return self.tries[mp].entries()

    def trie(self, mp):
        return self.tries[mp]


def test_reg_view_fold_and_deltas():
    rng = random.Random(9)
    reg = _Registry()
    fill(rng, 2500, reg.tries[""])
    view = GM.GpuRegView(reg, max_levels=8, initial_capacity=8192,
                         device="cpu")
    topics = [rand_topic(rng) for _ in range(32)]
    for topic, rows in zip(topics, view.fold_batch("", topics)):
        assert norm(rows) == norm(reg.trie("").match(topic))
    for i in range(100):
        f = rand_filter(rng)
        reg.trie("").add(f, f"d{i}", None)
        view.on_delta("add", "", f, f"d{i}", None)
    victim = next(iter(reg.trie("").entries()))
    reg.trie("").remove(list(victim[0]), victim[1])
    view.on_delta("remove", "", victim[0], victim[1], None)
    for topic in topics[:8]:
        assert norm(view.fold("", topic)) == norm(reg.trie("").match(topic))
    assert view.matcher("").host_fallbacks == 0


def test_trie_copy_matches_reference_trie():
    rng = random.Random(10)
    ours, ref = SubscriptionTrie(), RefTrie()
    fill(rng, 800, ours, ref)
    for topic in [rand_topic(rng) for _ in range(64)] + [["$SYS", "w1"]]:
        assert norm(ours.match(topic)) == norm(ref.match(topic))
    assert len(ours) == len(ref)


def test_ids_too_wide_to_code_use_the_level_scan(monkeypatch):
    """Past 2^24 interned words there are no coded operands: the full
    build and the delta scatter carry the base arrays only, and matching
    takes the level-scan path (the reference's VPU scan)."""
    from vernemq_tpu_torch.models import table as TB

    monkeypatch.setattr(TB.SubscriptionTable, "id_bits",
                        property(lambda self: 0))
    rng, m, trie = _pair(12, 300, 1024)
    topics = [rand_topic(rng) for _ in range(24)]
    _check(m, trie, topics)
    assert m._operands is None
    for i in range(50):
        f = rand_filter(rng)
        m.table.add(f, f"w{i}", None)
        trie.add(f, f"w{i}", None)
    _check(m, trie, topics)
