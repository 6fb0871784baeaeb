"""The headline corpus of the tools and ``chip_smoke.py``: bench.py's mixed
subscription corpus over a 3-level topic tree (60% exact, 20% ``w0/+/w2``,
10% ``+/w1/w2``, 10% ``w0/w1/#`` over 64 x 256 x 64 words), its zipf
publish stream, and the host trie's rate on the same corpus — the port's
own copy of bench.py's ``build_corpus``, ``zipf_topics`` and
``host_trie_like_for_like``, drawing the same values from the same seed.
Also the headline matcher the tools measure and the host prep of one
batch, as the serving path makes it."""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

import numpy as np


def build_corpus(rng: random.Random, n_subs: int,
                 add: Callable[[list, int], None]):
    """``add(filter_words, key)`` for each of ``n_subs`` subscriptions of
    the mix; returns the three word pools."""
    l0 = [f"region{i}" for i in range(64)]
    l1 = [f"dev{i}" for i in range(256)]
    l2 = [f"metric{i}" for i in range(64)]
    for i in range(n_subs):
        r = rng.random()
        w0, w1, w2 = rng.choice(l0), rng.choice(l1), rng.choice(l2)
        if r < 0.60:
            f = [w0, w1, w2]
        elif r < 0.80:
            f = [w0, "+", w2]
        elif r < 0.90:
            f = ["+", w1, w2]
        else:
            f = [w0, w1, "#"]
        add(f, i)
    return l0, l1, l2


def zipf_topics(rng: random.Random, pools, n: int):
    """``n`` publish topics, each level drawn with a Pareto(1.2) skew
    towards the head of its pool."""
    l0, l1, l2 = pools

    def pick(pool):
        z = min(int(rng.paretovariate(1.2)) - 1, len(pool) - 1)
        return pool[z]

    return [(pick(l0), pick(l1), pick(l2)) for _ in range(n)]


def host_trie_like_for_like(entries, pools, seed: int, n_probe: int = 5000):
    """The host trie on the same corpus and publish distribution: build
    it from ``entries`` (``(filter, key, value)`` or None), match
    ``n_probe`` zipf topics from a separate ``seed``, and return its
    publishes/s, matches/s and average fanout."""
    from ..models.trie import SubscriptionTrie

    rng = random.Random(seed)
    trie = SubscriptionTrie()
    t0 = time.perf_counter()
    for e in entries:
        if e is not None:
            trie.add(list(e[0]), e[1], e[2])
    build_s = time.perf_counter() - t0
    probes = [list(t) for t in zipf_topics(rng, pools, n_probe)]
    for t in probes[:200]:
        trie.match(t)
    t0 = time.perf_counter()
    total = 0
    for t in probes:
        total += len(trie.match(t))
    dt = time.perf_counter() - t0
    return {"trie_pubs_per_sec": round(n_probe / dt),
            "trie_matches_per_sec": round(total / dt),
            "trie_avg_fanout": round(total / n_probe, 2),
            "trie_build_s": round(build_s, 1)}


def headline_matcher(subs: int, *, device, levels: int = 8,
                     max_fanout: int = 256, flat_avg: int = 128,
                     seed: int = 42, build: bool = True):
    """A :class:`~..models.matcher.GpuMatcher` holding ``subs``
    subscriptions of the corpus, added in subscription order (the layout
    the serving path builds), capacity ``subs`` rounded up to a power of
    two; with ``build`` its table is on ``device``. Returns ``(matcher,
    pools, rng)``, the rng positioned after the corpus."""
    from ..models.matcher import GpuMatcher

    m = GpuMatcher(max_levels=levels,
                   initial_capacity=1 << max(subs - 1, 1).bit_length(),
                   max_fanout=max_fanout, flat_avg=flat_avg, device=device)
    rng = random.Random(seed)
    pools = build_corpus(rng, subs, lambda f, i: m.table.add(f, i, None))
    if build:
        with m.lock:
            m.sync()
    return m, pools, rng


def table_layout(m) -> dict:
    """The layout :meth:`GpuMatcher._flat_prep` reads, from the matcher's
    host table (no device build needed)."""
    t = m.table
    return {"reg_start": t.reg_start.copy(),
            "reg_end": (t.reg_start + t.reg_cap).copy(),
            "glob_pad": int(t.reg_cap[0]),
            "gb_end": t.gb_end if t.bucketed else int(t.reg_cap[0]),
            "ng": t.NG, "bits": t.id_bits}


def prep_batch(m, topics, Bpad: Optional[int] = None, layout=None):
    """Encode and window-prep one batch as the serving path does (padded
    to ``Bpad`` when given): ``(args, statics, left)`` of
    :meth:`GpuMatcher._flat_prep`."""
    from ..models.matcher import _pad_pub_block

    with m.lock:
        pw, pl, pd, pb, gb = m._encode_batch_ex(topics)
        if layout is None:
            layout = m._layout_locked()
    if Bpad is not None:
        pw, pl, pd = _pad_pub_block(pw, pl, pd, Bpad)
    S = int(m.table.cap)
    return m._flat_prep(layout, S, pw, pl, pd, pb, gb, len(topics))


def staged_windows(m, pools, rng, k: int, batch: int):
    """``k`` zipf windows of ``batch`` publishes prepped against one
    snapshot of a built matcher: ``(preps, statics, lefts)``."""
    preps, lefts, statics = [], [], None
    with m.lock:
        layout = m._layout_locked()
    for _ in range(k):
        args, statics, left = prep_batch(
            m, zipf_topics(rng, pools, batch), layout=layout)
        preps.append(args)
        lefts.append(left)
    return preps, statics, lefts


def leftover_counts(preps, statics, out: np.ndarray, lefts) -> tuple:
    """(window-leftover publishes, overflow publishes) of stacked results
    ``out [K, C + 3B]``: the publishes the host would serve."""
    B, C = preps[0][0].shape[0], statics["C"]
    left = sum(len(x) for x in lefts)
    ovf = 0
    for args, row in zip(preps, out):
        n = int(args[3])
        ovf += int(row[C + 2 * B:C + 2 * B + n].astype(bool).sum())
    return left, ovf
