"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a card every test skips (a kernel has no CPU
mode). This file imports neither JAX nor the JAX package, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from _torch_port import EDGE_IDS, UNKNOWN_ID
from vernemq_tpu_torch.ops import match_kernel as TK
from vernemq_tpu_torch.ops import tile_match as TM


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _tile_inputs(seed, bits, L=8, TP=256, seg=8192, S=32768, starts=None,
                 vocab=None, eff_lo=1, long_pubs=0.0):
    """Random kernel operands with many true matches: tile publishes are
    copied from rows of their own window (words and length), then ~5% of
    their words are made unknown and a ``long_pubs`` share is given a
    length past L (and past the kernel's key clamp of 31)."""
    rng = np.random.default_rng(seed)
    if vocab is None:
        vocab = np.concatenate([np.arange(3, 9), EDGE_IDS[3:]])
        plus, unknown = 0.2, 0.05
    else:
        plus, unknown = 0.0, 0.0
    vocab = np.asarray(vocab, np.int32)
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < plus] = TK.PLUS_ID
    eff = rng.integers(eff_lo, 4 if eff_lo == 1 else L + 1, S, dtype=np.int32)
    flags = ((rng.random(S) < 0.2) * 1 | (rng.random(S) < 0.5) * 2
             | (rng.random(S) < 0.9) * 4).astype(np.int32)
    if starts is None:
        starts = [0, 777, S - seg]  # any start, not aligned; one ends at S
    start = np.array(starts, np.int32)
    T = len(start)
    src = start[:, None] + rng.integers(0, seg, (T, TP))
    pw = words[src]
    pw[pw == TK.PLUS_ID] = vocab[0]
    pw[rng.random(pw.shape) < unknown] = UNKNOWN_ID
    plt = np.where(rng.random((T, TP)) < 0.5, eff[src],
                   rng.integers(1, 4, (T, TP))).astype(np.int32)
    long = rng.random((T, TP)) < long_pubs
    plt[long] = rng.integers(L + 1, L + 40, int(long.sum()))
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    F_t, t1 = TK.build_operands(c(words), c(eff), bits)
    Gt = TK.build_pub_operand(c(pw.reshape(-1, L)), bits).reshape(T, TP, -1)
    pdt = c((rng.random((T, TP)) < 0.25).astype(np.int32))
    return (F_t, t1, c(eff), c(flags), Gt.contiguous(), c(plt), pdt,
            c(start)), dict(seg_max=seg, glob_pad=2048, start_host=start)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,wild_rows", [(16, False), (16, True),
                                            (24, False)])
def test_tile_match_kernel_matches_plain_version(bits, wild_rows):
    _card()
    x, kw = _tile_inputs(5 + bits, bits)
    TM.window_tiles_packed(*x, wild_rows=wild_rows, **kw)  # build, allocate
    before = TM.launches
    torch.cuda.set_sync_debug_mode("error")  # a device→host copy raises
    try:
        got = TM.window_tiles_packed(*x, wild_rows=wild_rows, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    kw.pop("start_host")
    want = TM.window_tiles_packed_ref(*x, wild_rows=wild_rows, **kw)
    torch.cuda.synchronize()
    assert TM.launches == before + 1
    assert torch.equal(got, want)
    assert int(TK._popcount(want).sum()) > 100  # not vacuous


# (label, _tile_inputs arguments, wild_rows)
EDGES = [
    # K = 96: 16 levels of 24-bit ids, every id 2^24 - 1 or 65535 and every
    # level weighted, the largest partial sums the exactness argument allows
    ("k96-max", dict(bits=24, L=16, vocab=[(1 << 24) - 1, 65535], eff_lo=15),
     False),
    # publishes longer than L and than the key clamp; $ publishes against
    # wildcard-first rows (probe B keeps only those)
    ("plen>L", dict(bits=16, long_pubs=0.3), True),
    ("TP=16", dict(bits=16, TP=16), False),
    ("TP=256", dict(bits=16, TP=256), True),
    ("unaligned-and-end", dict(bits=16, starts=[3, 4101, 32768 - 8192]),
     False),
    ("seg=17x256", dict(bits=16, seg=4352, starts=[5, 32768 - 4352]), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,kw,wild_rows", EDGES, ids=[e[0] for e in EDGES])
def test_tile_match_kernel_at_its_edges(label, kw, wild_rows):
    _card()
    x, kw = _tile_inputs(7, **kw)
    got = TM.window_tiles_packed(*x, wild_rows=wild_rows, **kw)
    kw.pop("start_host")
    want = TM.window_tiles_packed_ref(*x, wild_rows=wild_rows, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), label
    hits = TK._popcount(want).sum(dim=2)
    assert int(hits.sum()) > 50  # not vacuous
    if label == "plen>L":  # the long publishes do match (hash rows)
        assert int(hits[x[5] > 31].sum()) > 0


@pytest.mark.cuda
def test_tile_match_rejects_what_it_cannot_take():
    _card()
    x, kw = _tile_inputs(1, 16)
    with pytest.raises(ValueError, match="leave the table"):
        bad = x[:7] + (x[7] + 30_000,)
        TM.window_tiles_packed(*bad, wild_rows=False,
                               **{**kw, "start_host": kw["start_host"] + 30_000})
    with pytest.raises(ValueError, match="leave the table"):  # wrong T
        TM.window_tiles_packed(*x, wild_rows=False,
                               **{**kw, "start_host": kw["start_host"][:2]})
    with pytest.raises(ValueError, match="F_t must be"):
        TM.window_tiles_packed(x[0].float(), *x[1:], wild_rows=False, **kw)
    with pytest.raises(ValueError, match="multiple of 16"):
        TM.window_tiles_packed(*x[:4], x[4][:, :24].contiguous(),
                               x[5][:, :24].contiguous(),
                               x[6][:, :24].contiguous(), x[7],
                               wild_rows=False, **kw)
