"""The tile matcher's dense mode (ops/tile_match.py, ``mode="dense"``)
against the reference's dense region 0 (vernemq_tpu/ops/match_kernel.py,
``_dense_region0``: the coded product over region 0, the epilogue and
``_pack_mask``, under ``jax.jit`` on the CPU).

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel's
dense mode is held against that version and against
``match_kernel._dense_region0_packed`` on a card by tests/test_torch_cuda.py
and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_port import EDGE_IDS, UNKNOWN_ID, n, t
from vernemq_tpu.ops import match_kernel as JK
from vernemq_tpu_torch.ops import match_kernel as TK
from vernemq_tpu_torch.ops import tile_match as TM


@jax.jit
def _ref_words(F_t, t1, eff, hh, fw, act, G, pl, pd):
    """The packed mask of the reference's _dense_region0 (its body for one
    publish chunk, before the extraction); region 0 is the operands'
    width."""
    mm = lax.dot_general(G, F_t, (((1,), (0,)), ((), ())),
                         preferred_element_type=jnp.float32) + t1[None, :]
    m = (mm == 0.0) & JK._epilogue(pl, pd, eff, hh, fw, act)
    return JK._pack_mask(m)


def _inputs(seed, bits, B, glob_pad, S, L=4):
    """Region-0 operands with many true matches: publishes copied from
    region-0 rows, ids drawn from a few words and the byte-plane edges,
    ~5% unknown words, a quarter of the publishes ``$`` topics and a tenth
    longer than L; a few rows past glob_pad that would match too."""
    rng = np.random.default_rng(seed)
    vocab = np.concatenate([np.arange(3, 6), EDGE_IDS[3:] if bits == 24
                            else EDGE_IDS[3:7]]).astype(np.int32)
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < 0.25] = TK.PLUS_ID
    eff = rng.integers(1, L + 1, S, dtype=np.int32)
    hh = rng.random(S) < 0.2
    fw = rng.random(S) < 0.5
    act = rng.random(S) < 0.9
    src = rng.integers(0, glob_pad, B)
    words[glob_pad:glob_pad + 64] = words[src[:1]]  # matches to be dropped
    pw = words[src]
    pw[pw == TK.PLUS_ID] = vocab[0]
    pw[rng.random(pw.shape) < 0.05] = UNKNOWN_ID
    pl = np.where(rng.random(B) < 0.6, eff[src],
                  rng.integers(1, L + 1, B)).astype(np.int32)
    pl[rng.random(B) < 0.1] = L + 30
    pd = rng.random(B) < 0.25
    F, t1 = JK.build_operands(words, eff, bits)
    G = JK.build_pub_operand(pw, bits)
    return dict(F_t=np.asarray(F), t1=np.asarray(t1), eff=eff, hh=hh, fw=fw,
                act=act, G=np.asarray(G), pl=pl, pd=pd)


# (bits, B, glob_pad, S): a glob_pad that is not a multiple of 256, a
# batch that is not a multiple of 16, 24-bit ids, a table whose end clips
# the window (to S's whole words)
SHAPES = [(16, 37, 2080, 4096), (24, 64, 96, 2048), (16, 16, 2048, 2048),
          (24, 5, 224, 240)]


@pytest.mark.parametrize("bits,B,gp,S", SHAPES)
def test_dense_mode_matches_reference_dense_region0(bits, B, gp, S):
    """The plain version in dense mode, as the wrapper calls it (tiles of
    consecutive publishes padded to whole tiles, every window from row 0),
    equals the reference's packed dense-region-0 mask word for word; the
    words past glob_pad/32 are 0."""
    x = _inputs(bits + B + gp, bits, B, gp, S)
    want = np.asarray(_ref_words(
        x["F_t"][:, :gp], x["t1"][:gp], x["eff"][:gp], x["hh"][:gp],
        x["fw"][:gp], x["act"][:gp], x["G"], x["pl"], x["pd"])).view(np.int32)
    flags = TM.row_flags(t(x["hh"]), t(x["fw"]), t(x["act"]))
    got = TM.dense_region0_packed(t(x["F_t"]), t(x["t1"]), t(x["eff"]), flags,
                                  t(x["G"]), t(x["pl"]), t(x["pd"]),
                                  glob_pad=gp)
    T, TP, seg = TM.dense_geometry(B, gp, S)
    assert got.dtype == torch.int32 and got.shape == (B, seg // 32)
    assert T * TP >= B and TP % TM.PUB_TILE == 0 and seg >= min(gp, S)
    np.testing.assert_array_equal(n(got)[:, :gp // 32], want)
    assert not n(got)[:, gp // 32:].any()
    assert np.unpackbits(want.view(np.uint8)).sum() > 20  # not vacuous


def test_dense_mode_row_masks_match_the_plain_version():
    """The kernel's epilogue in plain form (t1 - 1 in three bf16 F rows
    against G = 1, a verdict = product < 0 and bit pub_keys[p] of
    row_masks[r]) in dense mode equals the plain version."""
    bits, B, gp, S = 16, 48, 2080, 4096
    x = _inputs(5, bits, B, gp, S)
    flags = TM.row_flags(t(x["hh"]), t(x["fw"]), t(x["act"]))
    T, TP, seg = TM.dense_geometry(B, gp, S)
    F = torch.cat([t(x["F_t"]).to(torch.float32), TM.t1_columns(t(x["t1"]))])
    rows = torch.arange(seg)
    G = torch.cat([t(x["G"]).to(torch.float32),
                   torch.ones(B, TM.T1_COLS)], dim=1)
    masks = TM.row_masks(t(x["eff"]), flags, rows, glob_pad=gp, mode="dense")
    keys = TM.pub_keys(t(x["pl"]), t(x["pd"]).to(torch.int32))
    bit = (masks[None, :] >> keys.clamp(max=63)[:, None]) & 1
    words = TK._pack_mask(((G @ F[:, rows]) < 0) & (bit > 0)
                          & (keys[:, None] < 64))
    want = TM.dense_region0_packed(t(x["F_t"]), t(x["t1"]), t(x["eff"]),
                                   flags, t(x["G"]), t(x["pl"]), t(x["pd"]),
                                   glob_pad=gp)
    np.testing.assert_array_equal(n(words), n(want))


def test_wrappers_take_the_plain_version_on_cpu_in_dense_mode():
    """For CPU tensors the wrapper and the dense helper run the plain
    version: no launch of either count, and the result equals
    window_tiles_packed_ref in dense mode; an unknown mode is refused."""
    bits, B, gp, S = 16, 32, 2048, 4096
    x = _inputs(9, bits, B, gp, S)
    flags = TM.row_flags(t(x["hh"]), t(x["fw"]), t(x["act"]))
    T, TP, seg = TM.dense_geometry(B, gp, S)
    args = (t(x["F_t"]), t(x["t1"]), t(x["eff"]), flags,
            t(x["G"]).reshape(T, TP, -1), t(x["pl"]).reshape(T, TP),
            t(x["pd"]).to(torch.int32).reshape(T, TP),
            torch.zeros(T, dtype=torch.int32))
    kw = dict(seg_max=seg, glob_pad=gp, mode="dense")
    before = TM.launches, TM.dense_launches, TK.plain_cuda_packs
    got = TM.window_tiles_packed(*args, **kw, start_host=np.zeros(T))
    helper = TM.dense_region0_packed(t(x["F_t"]), t(x["t1"]), t(x["eff"]),
                                     flags, t(x["G"]), t(x["pl"]),
                                     t(x["pd"]), glob_pad=gp)
    assert (TM.launches, TM.dense_launches, TK.plain_cuda_packs) == before
    want = TM.window_tiles_packed_ref(*args, **kw)
    np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(n(helper), n(want).reshape(B, -1))
    with pytest.raises(ValueError, match="mode"):
        TM.window_tiles_packed(*args, seg_max=seg, glob_pad=gp, mode="c",
                               start_host=np.zeros(T))


@pytest.mark.parametrize("B,gp,S,want", [
    (4096, 2048, 1_613_824, (32, 128, 2048)),
    (1000, 2048, 1 << 20, (8, 128, 2048)),
    (8, 2080, 1 << 20, (1, 16, 2304)),
    (37, 224, 240, (1, 48, 224))])
def test_dense_geometry(B, gp, S, want):
    """Tiles of DENSE_TP publishes (B rounded up to the tensor-core step
    when smaller), one window of glob_pad rounded up to the kernel's row
    chunk, clipped to the table's whole words."""
    assert TM.dense_geometry(B, gp, S) == want
