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


def _tile_inputs(seed, bits, L=8, TP=256, seg=8192, S=32768):
    rng = np.random.default_rng(seed)
    vocab = np.concatenate([np.arange(3, 9), EDGE_IDS[3:]]).astype(np.int32)
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < 0.2] = TK.PLUS_ID
    eff = rng.integers(1, 4, S, dtype=np.int32)
    flags = ((rng.random(S) < 0.2) * 1 | (rng.random(S) < 0.5) * 2
             | (rng.random(S) < 0.9) * 4).astype(np.int32)
    start = np.array([0, 777, S - seg], np.int32)  # any start, not aligned
    pw = words[start[:, None] + rng.integers(0, seg, (3, TP))]
    pw[pw == TK.PLUS_ID] = vocab[0]
    pw[rng.random(pw.shape) < 0.05] = UNKNOWN_ID
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    F_t, t1 = TK.build_operands(c(words), c(eff), bits)
    Gt = TK.build_pub_operand(c(pw.reshape(-1, L)), bits).reshape(3, TP, -1)
    plt = c(rng.integers(1, 4, (3, TP)).astype(np.int32))
    pdt = c((rng.random((3, TP)) < 0.25).astype(np.int32))
    return (F_t, t1, c(eff), c(flags), Gt.contiguous(), plt, pdt, c(start)), \
        dict(seg_max=seg, glob_pad=2048)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,wild_rows", [(16, False), (16, True),
                                            (24, False)])
def test_tile_match_kernel_matches_plain_version(bits, wild_rows):
    _card()
    x, kw = _tile_inputs(5 + bits, bits)
    before = TM.launches
    got = TM.window_tiles_packed(*x, wild_rows=wild_rows, **kw)
    want = TM.window_tiles_packed_ref(*x, wild_rows=wild_rows, **kw)
    torch.cuda.synchronize()
    assert TM.launches == before + 1
    assert torch.equal(got, want)
    assert int(TK._popcount(want).sum()) > 100  # not vacuous


@pytest.mark.cuda
def test_tile_match_rejects_what_it_cannot_take():
    _card()
    x, kw = _tile_inputs(1, 16)
    with pytest.raises(ValueError, match="leave the table"):
        bad = x[:7] + (x[7] + 30_000,)
        TM.window_tiles_packed(*bad, wild_rows=False, **kw)
    with pytest.raises(ValueError, match="F_t must be"):
        TM.window_tiles_packed(x[0].float(), *x[1:], wild_rows=False, **kw)
