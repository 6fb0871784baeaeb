"""The port's probe-window tile matcher (ops/tile_match.py) against the
Pallas kernel it replaces (vernemq_tpu/ops/pallas_match.py, interpret mode).

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel is
held against that version on a card by tests/test_torch_cuda.py and by
``chip_smoke.py``.
"""

import random

import numpy as np
import pytest
import torch

from _torch_port import EDGE_IDS, UNKNOWN_ID, fill, n, rand_topic, t
from vernemq_tpu.models.tpu_matcher import TpuMatcher
from vernemq_tpu.ops import match_kernel as JK
from vernemq_tpu.ops import pallas_match as P
from vernemq_tpu_torch.ops import match_kernel as TK
from vernemq_tpu_torch.ops import tile_match as TM


def tile_inputs(seed, bits, L=4, T=3, TP=16, seg=4096, S=12288):
    """Random tile-matcher operands (numpy) with many true matches: a small
    vocabulary plus byte-plane edge ids, tile publishes copied from rows
    of their own window."""
    rng = np.random.default_rng(seed)
    vocab = np.concatenate([np.arange(3, 7), EDGE_IDS[3:] if bits == 24
                            else EDGE_IDS[3:7]]).astype(np.int32)
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < 0.2] = TK.PLUS_ID
    eff = rng.integers(1, L + 1, S, dtype=np.int32)
    flags = ((rng.random(S) < 0.2) * 1 | (rng.random(S) < 0.5) * 2
             | (rng.random(S) < 0.9) * 4).astype(np.int32)
    F, t1 = JK.build_operands(words, eff, bits)
    start = np.array([0, 2048, S - seg], np.int32)[:T]
    pw = np.empty((T, TP, L), np.int32)
    for i in range(T):
        rows = start[i] + rng.integers(0, seg, TP)
        pw[i] = words[rows]
    pw[pw == TK.PLUS_ID] = vocab[0]
    pw[rng.random(pw.shape) < 0.05] = UNKNOWN_ID
    G = np.asarray(JK.build_pub_operand(pw.reshape(T * TP, L), bits)) \
        .reshape(T, TP, -1)
    plt = rng.integers(1, L + 1, (T, TP)).astype(np.int32)
    pdt = (rng.random((T, TP)) < 0.25).astype(np.int32)
    return dict(F_t=np.asarray(F), t1=np.asarray(t1), eff=eff, flags=flags,
                Gt=G, plt=plt, pdt=pdt, start=start, seg_max=seg,
                glob_pad=2048)


def _pallas_words(x, wild_rows):
    """The Pallas kernel's packed mask (interpret mode) as the port's int32
    words."""
    p16 = P.window_tiles_packed(
        x["F_t"], x["t1"][None], x["eff"][None], x["flags"][None], x["Gt"],
        x["plt"][..., None], x["pdt"][..., None], x["start"] // P.SEG_BLK,
        seg_max=x["seg_max"], glob_pad=x["glob_pad"], wild_rows=wild_rows,
        interpret=True)
    p = np.asarray(p16).astype(np.uint32)
    return (p[..., 0::2] | (p[..., 1::2] << 16)).view(np.int32)


@pytest.mark.parametrize("wild_rows,bits", [(False, 16), (True, 16),
                                            (False, 24)])
def test_ref_matches_pallas_kernel(wild_rows, bits):
    """Probe A (concrete-first rows) and B (wildcard-first rows), 16- and
    24-bit ids: the plain version equals the Pallas kernel bit for bit
    (its 16-bit words joined into the 32-bit words of the port)."""
    x = tile_inputs(1 + bits + wild_rows, bits)
    seg, gp = x["seg_max"], x["glob_pad"]
    want = _pallas_words(x, wild_rows)
    got = TM.window_tiles_packed_ref(
        *(t(x[k]) for k in ("F_t", "t1", "eff", "flags", "Gt", "plt", "pdt",
                            "start")),
        seg_max=seg, glob_pad=gp, mode="b" if wild_rows else "a")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(n(got), want)
    assert np.unpackbits(want.view(np.uint8)).sum() > 50  # not vacuous


@pytest.mark.parametrize("wild_rows", [False, True])
def test_kernel_epilogue_masks_match_pallas_kernel(wild_rows):
    """The CUDA kernel's operands and epilogue in plain form — t1 - 1 rides
    in three extra bf16 F rows against G = 1, and a verdict is (product <
    0) & bit pub_keys[p] of row_masks[r] — equal the Pallas kernel, with
    publishes longer than L and than the key clamp among them."""
    x = tile_inputs(31 + wild_rows, 16)
    x["plt"][:, :6] = [0, 4, 5, 31, 32, 40]  # L = 4
    want = _pallas_words(x, wild_rows)
    cols = TM.t1_columns(t(x["t1"]))
    assert torch.equal(cols.to(torch.bfloat16).to(torch.float32), cols)
    F = torch.cat([t(x["F_t"]).to(torch.float32), cols])
    eff, flags = t(x["eff"]), t(x["flags"])
    seg = x["seg_max"]
    words = []
    for i in range(len(x["start"])):
        rows = int(x["start"][i]) + torch.arange(seg)
        G = t(x["Gt"][i]).to(torch.float32)
        G = torch.cat([G, torch.ones(G.shape[0], TM.T1_COLS)], dim=1)
        mm = G @ F[:, rows]
        masks = TM.row_masks(eff, flags, rows, glob_pad=x["glob_pad"],
                             mode="b" if wild_rows else "a")
        keys = TM.pub_keys(t(x["plt"][i]), t(x["pdt"][i]))
        bit = (masks[None, :] >> keys.clamp(max=63)[:, None]) & 1
        words.append(TK._pack_mask((mm < 0) & (bit > 0)
                                   & (keys[:, None] < 64)))
    np.testing.assert_array_equal(n(torch.stack(words)), want)
    assert np.unpackbits(want[:, :6].view(np.uint8)).sum() > 0


def test_wrapper_runs_plain_version_on_cpu_only():
    x = {k: (t(v) if isinstance(v, np.ndarray) else v)
         for k, v in tile_inputs(9, 16).items()}
    kw = dict(seg_max=x.pop("seg_max"), glob_pad=x.pop("glob_pad"),
              mode="a")
    start = n(x["start"])
    before = TM.launches
    got = TM.window_tiles_packed(*x.values(), **kw, start_host=start)
    assert TM.launches == before  # no kernel launch for CPU tensors
    np.testing.assert_array_equal(
        n(got), n(TM.window_tiles_packed_ref(*x.values(), **kw)))
    meta = [v.to("meta") for v in x.values()]
    with pytest.raises(ValueError, match="unsupported device"):
        TM.window_tiles_packed(*meta, **kw, start_host=start)


@pytest.mark.parametrize("bad", ["past-the-end", "wrong-T"])
def test_wrapper_checks_window_bounds_on_host_starts(bad):
    """The window bounds are checked on the host starts, before any device
    work: a window past the table's end, or a start array that is not one
    start per tile, raises."""
    x = {k: (t(v) if isinstance(v, np.ndarray) else v)
         for k, v in tile_inputs(9, 16).items()}
    kw = dict(seg_max=x.pop("seg_max"), glob_pad=x.pop("glob_pad"),
              mode="a")
    start = n(x["start"])
    start = start + 2048 if bad == "past-the-end" else start[:2]
    with pytest.raises(ValueError, match="leave the table"):
        TM.window_tiles_packed(*x.values(), **kw, start_host=start)


def test_flat_path_matches_pallas_path():
    """The port's windowed flat path against the reference's Pallas flat
    path on the reference's own 2048-aligned window prep."""
    rng = random.Random(21)
    m = TpuMatcher(max_levels=8, initial_capacity=32768, use_pallas=True,
                   packed_io=False)
    fill(rng, 4000, m.table)
    with m.lock:
        m.sync()
    topics = [rand_topic(rng) for _ in range(64)] + [["$SYS", "w1"]]
    enc = m._encode_batch_ex(topics)
    S = int(m.table.cap)
    args, statics, left = m._flat_prep(m._reg_start, m._reg_end, m._glob_pad,
                                       m._ops_bits, S, *enc, len(topics),
                                       align=P.SEG_BLK)
    assert statics["seg2_max"] and not left
    assert all(int(s) % P.SEG_BLK == 0 for s in args[5])
    F_j, t1_j = m._operands
    want = P.match_extract_windowed_flat_pallas(
        F_j, t1_j, *m._dev_arrays[1:5], *args, **statics, interpret=True)
    tab = m.table
    F_t, t1 = TK.build_operands(t(tab.words), t(tab.eff_len), tab.id_bits)
    host = [t(a) for a in args[:3]] + [int(args[3])] + [t(a) for a in args[4:]]
    got = TK.match_extract_windowed_flat(
        F_t, t1, t(tab.eff_len), t(tab.has_hash), t(tab.first_wild),
        t(tab.active), *host, **statics)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(n(x), n(y))
    assert int(n(got[2]).sum()) > 100
