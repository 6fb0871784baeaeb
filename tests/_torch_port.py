"""Shared inputs of the port's parity tests (tests/test_torch_*.py): random
filter/topic corpora over a small vocabulary, and numpy/torch/JAX hand-offs.
Everything is made from a seed; tensors are handed over as numpy arrays."""

import random

import numpy as np
import torch

from vernemq_tpu_torch.filters.predicate import (OP_EQ, OP_EXISTS, OP_GE,
                                                 OP_GT, OP_IN, OP_LE, OP_LT,
                                                 OP_NE, OP_NULL, OP_PAD,
                                                 OP_RANGE, OP_TRUE)

# the suite runs several workers on one machine: small plain-PyTorch
# matches gain nothing from intra-op threads, which only contend
torch.set_num_threads(1)

WORDS = [f"w{i}" for i in range(150)]

# word ids at the byte-plane edges of the coded operands (UNKNOWN_ID = -2
# is a publish-side id: its planes are 254, 255(, 255))
EDGE_IDS = np.array([0, 1, 2, 254, 255, 256, 65535, 65536], dtype=np.int32)
UNKNOWN_ID = -2


def rand_filter(rng: random.Random, max_len: int = 5):
    f = [rng.choice(WORDS + ["+"]) for _ in range(rng.randint(1, max_len))]
    if rng.random() < 0.2:
        f.append("#")
    return f


def rand_topic(rng: random.Random, max_len: int = 5):
    return [rng.choice(WORDS) for _ in range(rng.randint(1, max_len))]


def norm(rows):
    return sorted((tuple(f), str(k)) for f, k, _ in rows)


def fill(rng: random.Random, n: int, *tables, prefix: str = "c"):
    """Add the same n random filters to every table (anything with
    ``add(filter, key, value)``)."""
    for i in range(n):
        f = rand_filter(rng)
        for t in tables:
            t.add(list(f), f"{prefix}{i}", None)


def t(a) -> torch.Tensor:
    """numpy (or JAX) array → CPU tensor (bf16 arrays via float32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """JAX array or tensor → numpy (bf16 as float32, uint32 as int32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def bucket_filter(rng: random.Random):
    """A bucketed-table corpus filter over r0..15 / d0..39 / m0..15:
    concrete level-0 words dominate, with wildcard-first, '#' and
    $-rooted filters mixed in."""
    w = [f"r{rng.randrange(16)}", f"d{rng.randrange(40)}",
         f"m{rng.randrange(16)}"]
    r = rng.random()
    if r < 0.5:
        return w
    if r < 0.65:
        return [w[0], "+", w[2]]
    if r < 0.75:
        return ["+", w[1], w[2]]
    if r < 0.85:
        return [w[0], w[1], "#"]
    if r < 0.92:
        return [w[0], "+", "#"]
    return ["$SYS", w[1], "#"]


def bucket_corpus(n: int = 3000, seed: int = 101):
    """The serving tests' corpus: n :func:`bucket_filter` s from one seed.
    The robustness, match_many and collector files share it (and a table
    capacity of 8192, max_fanout 64 and batches of 16), so the JAX
    reference compiles each table and batch shape once per process."""
    rng = random.Random(seed)
    return [bucket_filter(rng) for _ in range(n)]


def bucket_topics(rng: random.Random, n: int):
    """Publish topics for :func:`bucket_filter` corpora (a few $SYS)."""
    return [(("$SYS" if rng.random() < 0.05 else f"r{rng.randrange(16)}"),
             f"d{rng.randrange(40)}", f"m{rng.randrange(16)}")
            for _ in range(n)]


def reverse_inputs(seed: int, N: int, L: int, B: int, bits: int = 16,
                   lc=None):
    """Operands of the retained reverse match: a table of ``N`` retained
    topics (1..lc levels, ~10% ``$``-topics, ~10% inactive, pad words past
    each row's length) and ``B`` query filters, half of them copied from
    rows and then widened with ``+``, cut to a ``#`` prefix or given an
    unknown word, so many pairs match. Returns ``(row_words, row_len,
    row_dollar, row_active), (q_words, q_eff, q_hh, q_fw)`` as numpy."""
    rng = np.random.default_rng(seed)
    lc = lc or L
    vocab = np.array([3, 4, 5, 6, 7, 255, 256, 65535]
                     + ([65536, (1 << 24) - 1] if bits == 24 else []),
                     np.int32)
    words = rng.choice(vocab, (N, L)).astype(np.int32)
    row_len = rng.integers(1, lc + 1, N).astype(np.int32)
    words[np.arange(L)[None, :] >= row_len[:, None]] = 0  # PAD_ID
    dollar = rng.random(N) < 0.1
    active = rng.random(N) < 0.9
    src = rng.integers(0, N, B)
    qw = words[src].copy()
    qe = row_len[src].copy()
    qh = rng.random(B) < 0.25
    qe[qh] = rng.integers(0, qe[qh] + 1)
    fresh = rng.random(B) < 0.5  # the other half: random filters
    qw[fresh] = rng.choice(vocab, (int(fresh.sum()), L))
    qe[fresh] = rng.integers(1, lc + 2, int(fresh.sum()))
    qw[rng.random((B, L)) < 0.2] = 1  # PLUS_ID
    qw[rng.random((B, L)) < 0.03] = UNKNOWN_ID
    qw[np.arange(L)[None, :] >= qe[:, None]] = 0
    qf = (qw[:, 0] == 1) | ((qe == 0) & qh)
    return (words, row_len, dollar, active), (qw, qe.astype(np.int32), qh,
                                               qf)


# ------------------------------------------------ the predicate phase

#: (NP, B, F, P, A, W) of the parity tests: predicate rows, publishes,
#: feature columns, pairs, folds, window slots
PREDICATE_SHAPE = (40, 24, 4, 600, 300, 16)

OPS = [OP_PAD, OP_GT, OP_GE, OP_LT, OP_LE, OP_EQ, OP_NE, OP_RANGE, OP_IN,
       OP_EXISTS, OP_NULL, OP_TRUE]
#: feature values that sit on the traps: codes 31/32/63/64, a non-integral
#: code, ±inf, both zeros, a negative, NaN (missing)
TRAPS = np.array([31, 32, 63, 64, 2.5, np.inf, -np.inf, 0.0, -0.0, -1.0,
                  5.0, np.nan], np.float32)


def predicate_inputs(seed, NP, B, F, P, A, W):
    """Inputs of the predicate phase (``ops/predicate_kernel.py``): a
    predicate table (rows 0/1 PAD/TRUE as the engine keeps them), feats
    with trap values and NaNs, pairs and folds (the last 4 of W slots
    untouched); numpy arrays."""
    rng = np.random.default_rng(seed)
    op = rng.choice(OPS, NP).astype(np.int32)
    op[0], op[1] = OP_PAD, OP_TRUE
    field = rng.integers(0, F, NP, dtype=np.int32)
    a = rng.choice(np.concatenate([TRAPS[:-1], [0.5, 3.0]]),
                   NP).astype(np.float32)
    b = (a + rng.choice([0, 1, 10], NP)).astype(np.float32)
    mlo = rng.integers(-2**31, 2**31, NP, dtype=np.int64).astype(np.int32)
    mhi = rng.integers(-2**31, 2**31, NP, dtype=np.int64).astype(np.int32)
    feats = rng.choice(TRAPS, (B, F)).astype(np.float32)
    ints = rng.integers(0, 64, (B, F)).astype(np.float32)
    feats = np.where(rng.random((B, F)) < 0.4, ints, feats)
    pp = rng.integers(0, B, P, dtype=np.int32)
    pr = rng.integers(0, NP, P, dtype=np.int32)
    slot = rng.integers(0, W - 4, A, dtype=np.int32)  # the last 4 stay empty
    apub = rng.integers(0, B, A, dtype=np.int32)
    afield = rng.integers(-1, F, A, dtype=np.int32)  # -1: $COUNT
    gate = rng.choice([0, 1, 1, 1] + list(range(2, NP)), A).astype(np.int32)
    valid = rng.random(A) < 0.9
    acc = np.zeros((W, 4), np.float32)
    acc[:, 2], acc[:, 3] = np.inf, -np.inf
    acc[::3] = rng.choice([-0.0, 0.0, 1.5, -7.0], (len(acc[::3]), 4))
    return dict(table=(op, field, a, b, mlo, mhi), feats=feats, pp=pp, pr=pr,
                agg=(slot, apub, afield, gate, valid), acc=acc)


def ring_producer(name: str, seconds: float) -> None:
    """Stream numbered records into the port's ShmRing ``name`` from a
    process of its own for ``seconds``, then an ``END`` record: record i
    is i (u64) repeated 1 + i % 7 times."""
    import struct
    import time

    from vernemq_tpu_torch.parallel.shm_ring import ShmRing

    ring = ShmRing.attach(name)
    i, end = 0, time.monotonic() + seconds
    while time.monotonic() < end:
        if ring.push(struct.pack("<Q", i) * (1 + i % 7)):
            i += 1
    while not ring.push(b"END"):
        time.sleep(0.001)
    ring.close()


async def retained_ready(b):
    """A broker's retained index for mountpoint "", built (either
    package's broker): a first build still in the background would send
    the first replays to the host walk."""
    idx = await b.retained_engine().index_async("")
    while True:
        with idx.lock:
            try:
                idx.sync()
                return
            except Exception as e:  # either package's RebuildInProgress
                if type(e).__name__ != "RebuildInProgress":
                    raise
                th = idx._rebuild_thread
        if th is not None:
            th.join()
