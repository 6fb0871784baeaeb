"""Shared corpora and comparisons of the port's mesh tests
(tests/test_torch_sharded.py, tests/test_torch_mesh.py): the reference
tests' bucketed corpora (tests/test_sharded_match.py ``build_bucketed``,
the same random sequence) added to the reference's table, the port's table
and the port's trie at once, and the per-publish comparison of a port
matcher with a reference one on the same batch."""

import random

import jax
import numpy as np

import _torch_port  # noqa: F401  (one intra-op thread per worker)
from vernemq_tpu.models.tpu_table import SubscriptionTable as RefTable
from vernemq_tpu.parallel.mesh import make_mesh as ref_make_mesh
from vernemq_tpu_torch.models.table import SubscriptionTable
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.parallel.mesh import make_mesh


def norm(rows):
    return sorted((k for _, k, _ in rows), key=repr)


class Corpus:
    """One corpus in three places: ``ref`` (the reference's table, or None
    when a test compares with the trie only), ``table`` (the port's) and
    ``trie`` (the port's host trie, the oracle)."""

    def __init__(self, cap: int, with_ref: bool, L: int = 8):
        self.ref = RefTable(max_levels=L, initial_capacity=cap) \
            if with_ref else None
        self.table = SubscriptionTable(max_levels=L, initial_capacity=cap)
        self.trie = SubscriptionTrie()

    def add(self, f, key) -> None:
        for t in (self.ref, self.table, self.trie):
            if t is not None:
                t.add(list(f), key, None)

    def remove(self, f, key) -> None:
        for t in (self.ref, self.table, self.trie):
            if t is not None:
                t.remove(list(f), key)

    def expect(self, topic):
        return norm(self.trie.match(list(topic)))


def build_bucketed(seed, n_filters, cap, l0n=32, l1n=64, l2n=16,
                   skew=False, with_ref=False):
    """The reference tests' corpus over a 3-level tree (bucketed from cap
    >= 8192); ``skew`` puts half the filters on one hot level-0 word.
    Returns (corpus, pools, rng)."""
    rng = random.Random(seed)
    c = Corpus(cap, with_ref)
    l0 = [f"r{i}" for i in range(l0n)]
    l1 = [f"d{i}" for i in range(l1n)]
    l2 = [f"m{i}" for i in range(l2n)]
    for i in range(n_filters):
        r = rng.random()
        w0 = l0[0] if skew and rng.random() < 0.5 else rng.choice(l0)
        w = [w0, rng.choice(l1), rng.choice(l2)]
        if r < 0.6:
            f = w
        elif r < 0.8:
            f = [w[0], "+", w[2]]
        elif r < 0.9:
            f = ["+", w[1], w[2]]
        else:
            f = [w[0], w[1], "#"]
        c.add(f, i)
    assert c.table.bucketed
    return c, (l0, l1, l2), rng


def topics_for(rng, pools, n, skew=False):
    l0, l1, l2 = pools
    return [((l0[0] if skew and rng.random() < 0.5 else rng.choice(l0)),
             rng.choice(l1), rng.choice(l2)) for _ in range(n)]


def meshes(n: int, batch: int = 1):
    """The reference's mesh of the first ``n`` virtual CPU devices and the
    port's of the CPU repeated ``n`` times, both ``batch`` x ``n/batch``."""
    return (ref_make_mesh(jax.devices()[:n], batch=batch),
            make_mesh(["cpu"] * n, batch=batch))


def same_dispatch(ref_m, port_m, topics, corpus=None):
    """Sync both matchers, prep and dispatch ``topics`` on each, and
    require, for every publish the reference serves on its device, the
    same matched slot ids in the same order and the same overflow flag.
    The port's leftovers are the reference's less the publishes whose
    bucket region straddles a shard cut, which the port probes on each
    shard's piece (``ShardedWindowedMatcher._split_straddlers``; the
    callers hold their rows against the trie). With ``corpus`` every
    publish the port's device served has the trie's rows. Returns the
    number of publishes the port's device served."""
    ref_m.sync()
    port_m.sync()
    rp, pp = ref_m._prep(topics), port_m._prep(topics)
    (Bpad, T, seg, gc, Cl), (Bpad2, T2, seg2, gc2, Cl2) = rp["geom"], \
        pp["geom"]
    assert (Bpad, seg, gc, Cl) == (Bpad2, seg2, gc2, Cl2) and T2 >= T
    assert pp["leftovers"] <= rp["leftovers"]
    rr, pr = ref_m._dispatch(rp), port_m._dispatch(pp)
    served = 0
    for i, tp in enumerate(topics):
        ovf = port_m._overflowed(i, pr[3], pp["Bl"])
        if not ovf and i not in pp["leftovers"]:
            served += 1
            if corpus is not None:
                ids = port_m.slots_for(i, *pr[:3], pp["Bl"])
                ent = corpus.table.entries
                assert norm([ent[j] for j in ids if ent[j] is not None]) \
                    == corpus.expect(tp), tp
        if i in rp["leftovers"]:
            continue
        want = np.asarray(ref_m.slots_for(i, *rr[:3], rp["Bl"]))
        got = port_m.slots_for(i, *pr[:3], pp["Bl"])
        assert np.array_equal(got, want), (tp, got, want)
        assert ovf == ref_m._overflowed(i, rr[3], rp["Bl"]), tp
    return served
