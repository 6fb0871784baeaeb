"""Parity of the port's retained reverse-match engine with the JAX reference.

Two halves, on the CPU:

- the device program: numpy-seeded inputs through ``vernemq_tpu.ops.
  reverse_kernel`` and ``vernemq_tpu_torch.ops.reverse_kernel`` (and the
  hand kernel's plain version, ``ops/reverse_tiles.py``): masks, packed
  words, extraction results, delta scatters and window prep, compared
  exactly (integer masks: no tolerance);
- the serving layer: ports of tests/test_retained_index.py, each run on the
  reference's ``RetainedIndex`` and on the port's (``device="cpu"``) beside
  it, with every replay held to ``RetainStore.match_filter``, the oracle.

Table capacity 2048 and the reference tests' batch sizes throughout, so the
JAX side compiles the shapes that file compiles.
"""

import asyncio
import random
import time

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_port import n, reverse_inputs, t
from vernemq_tpu.broker.retain import RetainStore as RefStore
from vernemq_tpu.models import tpu_matcher as JM
from vernemq_tpu.ops import match_kernel as JK
from vernemq_tpu.ops import reverse_kernel as JR
from vernemq_tpu.retained.collector import \
    RetainedBatchCollector as RefCollector
from vernemq_tpu.retained.index import RetainedEngine as RefEngine
from vernemq_tpu.retained.index import RetainedIndex as RefIndex
from vernemq_tpu.robustness import faults as JF
from vernemq_tpu.robustness.breaker import CircuitBreaker as RefBreaker
from vernemq_tpu_torch.broker.retain import RetainStore
from vernemq_tpu_torch.models import matcher as GM
from vernemq_tpu_torch.ops import extract as EX
from vernemq_tpu_torch.ops import reverse_kernel as TR
from vernemq_tpu_torch.ops import reverse_tiles as RT
from vernemq_tpu_torch.ops.tile_match import KernelError
from vernemq_tpu_torch.retained.collector import RetainedBatchCollector
from vernemq_tpu_torch.retained.index import RetainedEngine, RetainedIndex
from vernemq_tpu_torch.robustness import faults as PF
from vernemq_tpu_torch.robustness.breaker import CircuitBreaker

_tile_masks_ref = jax.jit(JR._tile_masks, static_argnames=("seg", "lc"))
_dense_compare_ref = jax.jit(JR._dense_compare,
                             static_argnames=("k", "nc", "lc"))
_dense_coded_ref = jax.jit(JR._dense_coded,
                           static_argnames=("id_bits", "k", "nc"))
_pack_ref = jax.jit(JK._pack_mask)
_extract_ref = jax.jit(JK.extract_indices_packed, static_argnums=(1, 2))


@pytest.fixture(autouse=True)
def _no_fault_plans():
    yield
    JF.clear()
    PF.clear()


# ------------------------------------------------------- the device program

N, L, B, TP = 2048, 8, 96, 32


def rev_inputs(seed, bits=16, lc=None):
    return reverse_inputs(seed, N, L, B, bits=bits, lc=lc)


def tiles(seed, seg):
    """Probe tiles over the query block: 3 tiles of TP slots hold 80
    queries (the rest untiled), windows anywhere in the table; the untiled
    queries and a few others fill BW = 24 dense slots (4 of them dead)."""
    rng = np.random.default_rng(seed + 100)
    order = rng.permutation(B)
    T = 3
    t_sel = np.zeros((T, TP), np.int32)
    q_tile = np.full(B, -1, np.int32)
    q_pos = np.zeros(B, np.int32)
    for slot, q in enumerate(order[:80]):
        t_sel[slot // TP, slot % TP] = q
        q_tile[q], q_pos[q] = slot // TP, slot % TP
    t_start = rng.integers(0, N - seg + 1, T).astype(np.int32)
    d_sel = np.concatenate([order[80:], order[:8]]).astype(np.int32)
    d_valid = np.ones(len(d_sel), bool)
    d_valid[[1, 5, 17, 20]] = False
    return t_sel, t_start, q_tile, q_pos, d_sel, d_valid


def test_row_meta_round_trip():
    rng = np.random.default_rng(0)
    ln, dl, ac = (rng.integers(0, 1 << 16, 64), rng.random(64) < 0.5,
                  rng.random(64) < 0.5)
    meta = TR.pack_row_meta(ln, dl, ac)
    np.testing.assert_array_equal(meta, np.asarray(JR.pack_row_meta(ln, dl,
                                                                     ac)))
    for got, want in zip(TR._unpack_row_meta(t(meta)),
                         JR._unpack_row_meta(meta)):
        np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_reverse_mask_unrolled_parity(seed):
    (rw, rl, rd, ra), (qw, qe, qh, qf) = rev_inputs(seed)
    want = np.asarray(JR.reverse_mask_unrolled(qw, qe, qh, qf, rw, rl, rd,
                                               ra))
    got = TR.reverse_mask_unrolled(t(qw), t(qe), t(qh), t(qf), t(rw), t(rl),
                                   t(rd), t(ra))
    np.testing.assert_array_equal(n(got), want)
    assert want.sum() > 50  # not vacuous


@pytest.mark.parametrize("seg,lc", [(512, 8), (1024, 3)])
def test_tile_masks_and_the_kernels_plain_version(seg, lc):
    """_tile_masks equals the reference's; the kernel's plain version (the
    wrapper on CPU tensors) equals the reference's mask packed by the
    reference's _pack_mask, word for word."""
    (rw, rl, rd, ra), (qw, qe, qh, qf) = rev_inputs(seg + lc, lc=lc)
    t_sel, t_start, *_ = tiles(seg, seg)
    want = np.asarray(_tile_masks_ref(rw, rl, rd, ra, qw, qe, qh, qf, t_sel,
                                      t_start, seg=seg, lc=lc))
    got = TR._tile_masks(t(rw), t(rl), t(rd), t(ra), t(qw), t(qe), t(qh),
                         t(qf), t(t_sel), t(t_start), seg=seg, lc=lc)
    np.testing.assert_array_equal(n(got), want)
    assert want.sum() > 20
    meta = TR.pack_row_meta(rl, rd, ra)
    flags = TR.query_flags(t(qh), t(qf))
    before = RT.launches
    packed, counts = RT.reverse_tiles_packed(
        t(rw), t(meta), t(qw), t(qe), flags, t(t_sel), t(t_start), seg=seg,
        lc=lc, start_host=t_start)
    assert RT.launches == before  # the CPU takes the plain version
    np.testing.assert_array_equal(n(packed), n(_pack_ref(want)))
    np.testing.assert_array_equal(
        n(counts), want.reshape(len(want), -1, RT.CHUNK).sum(2))


def test_kernel_wrapper_checks_windows_on_the_host():
    (rw, rl, rd, ra), (qw, qe, qh, qf) = rev_inputs(3)
    meta = t(TR.pack_row_meta(rl, rd, ra))
    sel = torch.zeros((1, TP), dtype=torch.int32)
    for start in ([N - 511], [-1]):
        with pytest.raises(KernelError, match="leave the table"):
            RT.reverse_tiles_packed(
                t(rw), meta, t(qw), t(qe), TR.query_flags(t(qh), t(qf)),
                sel, torch.tensor(start, dtype=torch.int32), seg=512, lc=4,
                start_host=np.array(start, np.int32))


@pytest.mark.parametrize("bits", [16, 24])
def test_dense_phases_parity(bits):
    """_dense_compare and _dense_coded (with the coded row operand of
    build_row_operands) equal the reference's on a table of both id widths,
    in two row chunks."""
    (rw, rl, rd, ra), (qw, qe, qh, qf) = rev_inputs(bits, bits=bits)
    valid = np.arange(B) % 7 != 3
    G_j = JR.build_row_operands(rw, id_bits=bits)
    G_t = TR.build_row_operands(t(rw), bits)
    np.testing.assert_array_equal(n(G_t), n(G_j))
    args = (rl, rd, ra, qw, qe, qh, qf, valid)
    targs = [t(a) for a in args]
    for label, want, got in (
            ("compare", _dense_compare_ref(rw, *args, k=16, nc=1024, lc=L),
             TR._dense_compare(t(rw), *targs, k=16, nc=1024, lc=L)),
            ("coded", _dense_coded_ref(G_j, *args, id_bits=bits, k=16,
                                       nc=1024),
             TR._dense_coded(G_t, *targs, id_bits=bits, k=16, nc=1024))):
        (wi, wv, wc), (gi, gv, gc) = [[n(x) for x in r] for r in (want, got)]
        np.testing.assert_array_equal(gc, wc, err_msg=label)
        np.testing.assert_array_equal(gv, wv, err_msg=label)
        np.testing.assert_array_equal(gi[gv], wi[wv], err_msg=label)
        assert (wc > 16).any() and wv.sum() > 50  # past k, not vacuous


@pytest.mark.parametrize("dense_mode", ["coded", "compare"])
@pytest.mark.parametrize("seg,lc", [(512, 8), (1024, 3)])
def test_reverse_match_parity(dense_mode, seg, lc):
    """The whole dispatch: the six arrays equal the reference's (idx where
    valid) under either of its dense variants."""
    (rw, rl, rd, ra), (qw, qe, qh, qf) = rev_inputs(seg * lc, lc=lc)
    t_sel, t_start, q_tile, q_pos, d_sel, d_valid = tiles(lc, seg)
    meta = TR.pack_row_meta(rl, rd, ra)
    want = JR.reverse_match(
        rw, meta, JR.build_row_operands(rw, id_bits=16), qw, qe, qh, qf,
        t_sel, t_start, q_tile, q_pos, d_sel, d_valid, id_bits=16, k=16,
        seg=seg, lc=lc, dense_mode=dense_mode)
    got = TR.reverse_match(t(rw), t(meta), t(qw), t(qe), t(qh), t(qf),
                           t(t_sel), t_start, t(q_tile), t(q_pos), t(d_sel),
                           t(d_valid), k=16, seg=seg, lc=lc)
    want, got = [n(x) for x in want], [n(x) for x in got]
    for phase, (wi, wv, wc), (gi, gv, gc) in (
            ("probe", want[:3], got[:3]), ("dense", want[3:], got[3:])):
        np.testing.assert_array_equal(gc, wc, err_msg=phase)
        np.testing.assert_array_equal(gv, wv, err_msg=phase)
        np.testing.assert_array_equal(gi[gv], wi[wv], err_msg=phase)
        assert wv.sum() > 20 and (wc > 16).any(), phase


def test_plain_version_counts_and_empty_slots():
    """The plain version's chunk counts are the popcounts of its own packed
    words per 256-row chunk, and a negative selector is an empty slot: its
    row is 0 in words and counts, the other rows are the clamped gather."""
    (rw, rl, rd, ra), (qw, qe, qh, qf) = rev_inputs(17, lc=4)
    t_sel, t_start, *_ = tiles(17, 1024)
    t_sel = t_sel.copy()
    t_sel[1, ::3] = -1
    x = (t(rw), t(TR.pack_row_meta(rl, rd, ra)), t(qw), t(qe),
         TR.query_flags(t(qh), t(qf)))
    packed, counts = RT.reverse_tiles_packed_ref(
        *x, t(t_sel), t(t_start), seg=1024, lc=4)
    bits = np.unpackbits(n(packed).view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(
        n(counts), bits.reshape(len(packed), -1, RT.CHUNK).sum(2))
    empty = (t_sel < 0).reshape(-1)
    assert not n(packed)[empty].any() and not n(counts)[empty].any()
    full, _ = RT.reverse_tiles_packed_ref(
        *x, t(np.maximum(t_sel, 0)), t(t_start), seg=1024, lc=4)
    np.testing.assert_array_equal(n(packed)[~empty], n(full)[~empty])
    assert n(counts).sum() > 100
    with pytest.raises(KernelError, match="multiple of 256"):
        RT.reverse_tiles_packed(*x, t(t_sel), t(t_start), seg=640, lc=4,
                                start_host=t_start)


def _extract_cases():
    """Packed masks ``[12, 4096 rows]``: random rows at three densities,
    rows with more than k matches, empty rows, and matches in the last
    bit of the last chunk."""
    rng = np.random.default_rng(5)
    m = np.zeros((12, 4096), bool)
    m[0:3] = rng.random((3, 4096)) < 0.002
    m[3:6] = rng.random((3, 4096)) < 0.05   # past k
    m[6:8] = rng.random((2, 4096)) < 0.5    # far past k
    m[9, -1] = True                          # only the very last bit
    m[10, [0, 31, 32, 255, 256, 4095]] = True
    m[11, -40:] = True                       # the last chunk only
    return m                                 # row 8: empty


@pytest.mark.parametrize("k", [16, 64])
def test_two_level_extraction_equals_both_references(k):
    """The two-level extraction over the chunk counts (the extraction
    kernel's plain version, and its wrapper on the CPU) equals the port's
    full-width
    extract_indices_packed and the JAX reference's (block 2048) on the same
    packed input: counts, validity, and the ids where valid; a row selector
    and a liveness mask select and empty rows as the dispatch uses them."""
    m = _extract_cases()
    packed = np.asarray(_pack_ref(m))
    pt = t(packed)
    counts = RT.chunk_counts(pt)
    np.testing.assert_array_equal(n(counts),
                                  m.reshape(12, -1, RT.CHUNK).sum(2))
    every = dict(rows=torch.arange(12, dtype=torch.int32),
                 ok=torch.ones(12, dtype=torch.bool))
    got = [n(x) for x in RT.extract_chunks_ref(pt, counts, k, **every)]
    port = [n(x) for x in TR.MK.extract_indices_packed(pt, k)]
    ref = [n(x) for x in _extract_ref(packed, k, 2048)]
    for want in (port, ref):
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0][got[1]], want[0][want[1]])
    for r in range(12):
        np.testing.assert_array_equal(got[0][r][got[1][r]],
                                      np.nonzero(m[r])[0][:k])
    assert (got[2] > k).any() and got[2][8] == 0 and got[1][9, 0]
    rows = torch.tensor([11, 3, 9, 3, 0], dtype=torch.int32)
    ok = torch.tensor([True, True, False, True, True])
    before = EX.launches
    idx, valid, cnt = [n(x) for x in RT.extract_chunks(pt, counts, k,
                                                        rows=rows, ok=ok)]
    assert EX.launches == before  # the CPU takes the plain version
    for i, (r, live) in enumerate(zip(rows.tolist(), ok.tolist())):
        if not live:
            assert cnt[i] == 0 and not valid[i].any()
            continue
        assert cnt[i] == got[2][r]
        np.testing.assert_array_equal(valid[i], got[1][r])
        np.testing.assert_array_equal(idx[i][valid[i]],
                                      got[0][r][got[1][r]])


def test_prep_launches_only_the_tiles_in_use():
    """_prep launches the tiles in use only, at a width that holds the
    busiest region, its unused slots empty, over windows of the widest
    live region in whole chunks; the dispatch gives the same six arrays as
    the same queries on the reference geometry (tiles of 32 slots, the tile
    count padded to the reference's ladder, power-of-two windows of at
    least 512 rows)."""
    p = Pair(cap=2048, k=256, extract_k=256)
    rng = random.Random(21)
    for i in range(1500):
        p.insert((f"r{rng.randrange(8)}", f"d{rng.randrange(30)}",
                  f"m{rng.randrange(12)}"), i)
    idx = p.gpu
    with idx.lock:
        idx.sync()
        layout = idx._layout_locked()
        filters = ([(f"r{rng.randrange(8)}", "+", f"m{rng.randrange(12)}")
                    for _ in range(150)]
                   + [("+", f"d{rng.randrange(30)}", "+")
                      for _ in range(20)])
        enc = idx._encode_locked(filters)
    a, *_ = idx._prep(layout, *enc, len(filters))
    T, TP = a["t_sel"].shape
    tiled = a["q_tile"] >= 0
    per_region = np.bincount(enc[4][enc[4] > 0])
    assert TP == -(-per_region.max() // 32) * 32 and TP > 32
    assert T == a["q_tile"].max() + 1  # no pad tiles
    assert (a["t_sel"] >= 0).sum() == tiled.sum()  # the rest empty
    assert len(a["d_sel"]) == 32  # the dense slots: one warp, not a pow2
    assert a["seg"] == -(-layout["bucket_max"] // 256) * 256

    # the reference's geometry for the same filters: tiles of 32, the
    # tile count padded as its compile ladder does, pad slots query 0
    seg = min(GM._pow2ceil(max(512, layout["bucket_max"])), layout["cap"])
    assert seg > a["seg"]
    cidx = np.nonzero(enc[4][:len(filters)] > 0)[0].astype(np.int32)
    budget = min(len(cidx), layout["nb"]) + -(-len(cidx) // 32) + 2
    sel, start, tile_of, pos_of, left = GM.prepare_windows(
        enc[4][cidx], len(cidx), layout["reg_start"], layout["reg_end"],
        layout["cap"], budget, seg, tp=32)
    assert not left
    used = int(tile_of.max()) + 1
    Tpad = max(8, -(-used // 8) * 8)
    sel = np.concatenate([cidx[sel], np.zeros((max(0, Tpad - len(sel)), 32),
                                              np.int32)])[:Tpad]
    start = np.concatenate([start, np.zeros(max(0, Tpad - len(start)),
                                            np.int32)])[:Tpad]
    q_tile = np.full_like(a["q_tile"], -1)
    q_pos = np.zeros_like(a["q_pos"])
    q_tile[cidx], q_pos[cidx] = tile_of, pos_of
    BW = 256
    d_sel = np.zeros(BW, np.int32)
    d_valid = np.zeros(BW, bool)
    d_sel[:len(a["d_sel"])], d_valid[:len(a["d_sel"])] = (a["d_sel"],
                                                          a["d_valid"])
    rw, meta = idx._dev
    q = [t(a[x]) for x in ("qw", "qe", "qh", "qf")]
    new = TR.reverse_match(rw, meta, *q, t(a["t_sel"]), a["t_start"],
                           t(a["q_tile"]), t(a["q_pos"]), t(a["d_sel"]),
                           t(a["d_valid"]), k=a["k"], seg=a["seg"],
                           lc=a["lc"])
    old = TR.reverse_match(rw, meta, *q, t(sel), start, t(q_tile),
                           t(q_pos), t(d_sel), t(d_valid), k=a["k"],
                           seg=seg, lc=a["lc"])
    (ni, nv, nc, ndi, ndv, ndc), (oi, ov, oc, odi, odv, odc) = [
        [n(x) for x in r] for r in (new, old)]
    np.testing.assert_array_equal(nc, oc)
    np.testing.assert_array_equal(nv, ov)
    np.testing.assert_array_equal(ni[nv], oi[ov])
    bw = len(a["d_sel"])
    np.testing.assert_array_equal(ndc, odc[:bw])
    np.testing.assert_array_equal(ndv, odv[:bw])
    np.testing.assert_array_equal(ndi[ndv], odi[:bw][odv[:bw]])
    assert nv.sum() > 500 and ndv.sum() > 100


@pytest.mark.parametrize("copy", [False, True])
def test_retained_apply_delta_parity(copy):
    (rw, rl, rd, ra), _ = rev_inputs(9)
    meta = TR.pack_row_meta(rl, rd, ra)
    rng = np.random.default_rng(9)
    slots = rng.choice(N, 40, replace=False).astype(np.int32)
    d_words = rng.integers(3, 99, (40, L)).astype(np.int32)
    d_meta = TR.pack_row_meta(rng.integers(1, L, 40), rng.random(40) < 0.5,
                              rng.random(40) < 0.5)
    G = JR.build_row_operands(rw, id_bits=16)
    fn = JR.retained_apply_delta_copy if copy else JR.retained_apply_delta
    w_rw, w_meta, _ = fn(jax.numpy.asarray(rw), jax.numpy.asarray(meta), G,
                         slots, d_words, d_meta, id_bits=16)
    dev = (t(rw), t(meta))
    tfn = TR.retained_apply_delta_copy if copy else TR.retained_apply_delta
    g_rw, g_meta = tfn(*dev, t(slots).long(), t(d_words), t(d_meta))
    np.testing.assert_array_equal(n(g_rw), np.asarray(w_rw))
    np.testing.assert_array_equal(n(g_meta), np.asarray(w_meta))
    # in place unless copying
    assert (g_rw is dev[0]) != copy and (g_meta is dev[1]) != copy
    if copy:
        np.testing.assert_array_equal(n(dev[0]), rw)


@pytest.mark.parametrize("tp", [32, None])
def test_prepare_windows_tp(tp):
    """The port's prepare_windows(tp=32) packs the reference's retained
    probe tiles (emit="sel", tp=32); without tp it keeps TILE_PUBS."""
    rng = np.random.default_rng(11)
    reg_start = np.array([0, 0, 512, 1024, 1536, 2560, 3072], np.int64)
    reg_end = reg_start + np.array([0, 300, 480, 100, 900, 512, 40])
    nq = 700
    region = rng.integers(1, 7, nq).astype(np.int32)
    T, seg = 30, 1024
    kw = {} if tp is None else {"tp": tp}
    want = JM.prepare_windows(
        np.zeros((nq, 4), np.int32), np.zeros(nq, np.int32),
        np.zeros(nq, bool), region, nq, reg_start, reg_end, 4096, T, seg,
        emit="sel", **kw)
    got = GM.prepare_windows(region, nq, reg_start, reg_end, 4096, T, seg,
                             **kw)
    assert got[0].shape == (T, tp or GM.TILE_PUBS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------------------------ the serving layer

WORDS = ["a", "b", "c", "d", "sensor", "dev", "x1", ""]


def rand_topic(rng, max_len=6):
    words = [rng.choice(WORDS) for _ in range(rng.randint(1, max_len))]
    if rng.random() < 0.1:
        words[0] = "$SYS"
    return tuple(words)


def rand_filter(rng, max_len=6):
    words = ["+" if rng.random() < 0.2 else rng.choice(WORDS)
             for _ in range(rng.randint(1, max_len))]
    if rng.random() < 0.25:
        words.append("#")
    return tuple(words)


def norm(rows):
    return sorted((t_, v) for t_, v in rows)


class Pair:
    """A write-through (store, index) pair of each package for mountpoint
    "", as the reference's ``make_pair`` wires it: the same mutations reach
    both, and each index serves its own store's replays."""

    def __init__(self, max_levels=8, cap=2048, k=64, ref_kw=(), **idx_kw):
        self.stores, self.indexes = [], []
        for Store, Index, kw in ((RefStore, RefIndex, {}),
                                 (RetainStore, RetainedIndex,
                                  {"device": "cpu"})):
            holder = {}
            store = Store(on_dirty=lambda mp, t_, v, h=holder:
                          h["idx"].on_retain(t_, v))
            idx = Index(store, max_levels=max_levels, initial_capacity=cap,
                        max_fanout=k, **kw)
            idx.async_rebuild = False
            # the device dense phase on the CPU too ("auto" routes
            # wildcard-first filters to the host walk there)
            idx.dense_policy = "device"
            for key, val in idx_kw.items():
                setattr(idx, key, val)
            if Index is RefIndex:  # the reference's own knobs
                for key, val in dict(ref_kw).items():
                    setattr(idx, key, val)
            holder["idx"] = idx
            self.stores.append(store)
            self.indexes.append(idx)
        self.ref, self.gpu = self.indexes

    def insert(self, topic, value):
        for s in self.stores:
            s.insert("", topic, value)

    def delete(self, topic):
        for s in self.stores:
            s.delete("", topic)

    def match(self, filters):
        """Each index's raw results (None escapes kept)."""
        return [idx.match_filters(filters) for idx in self.indexes]

    def exact(self, filters):
        """Both packages' production contract — device rows, None escapes
        resolved against the store — held to the oracle and to each other;
        returns the port's rows."""
        outs = []
        for store, res in zip(self.stores, self.match(filters)):
            outs.append([rows if rows is not None
                         else store.match_filter("", list(fw))
                         for fw, rows in zip(filters, res)])
        for fw, r, g in zip(filters, *outs):
            want = norm(self.stores[1].match_filter("", list(fw)))
            assert norm(g) == want, fw
            assert norm(r) == want, fw
        return outs[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_random_corpus(seed):
    rng = random.Random(seed)
    p = Pair()
    for i in range(400):
        p.insert(rand_topic(rng), b"v%d" % i)
    filters = [rand_filter(rng) for _ in range(120)]
    ref, gpu = p.match(filters)
    # the same escapes: identical per-filter None contract
    assert [r is None for r in ref] == [g is None for g in gpu]
    p.exact(filters)
    assert p.gpu.host_fallback_queries == p.ref.host_fallback_queries


@pytest.mark.parametrize("dense_mode", ["coded", "compare"])
def test_dense_phase_parity_both_kernels(dense_mode):
    """Wildcard-first filters (the dense phase): both of the reference's
    variants and the port's one path give the oracle's rows, including the
    MQTT-4.7.2-1 $-skip."""
    rng = random.Random(7)
    p = Pair(ref_kw={"dense_mode": dense_mode})
    for i in range(300):
        p.insert(rand_topic(rng, max_len=4), i)
    p.insert(("$SYS", "node", "x"), "sys")
    filters = [("#",), ("+",), ("+", "#"), ("+", "b", "#"),
               ("+", "b"), ("+", "+", "+")]
    for rows in p.exact(filters):
        assert all(t_[0] != "$SYS" for t_, _ in rows)
    (rows,) = p.exact([("$SYS", "node", "x")])
    assert ("$SYS", "node", "x") in [t_ for t_, _ in rows]
    assert p.gpu.match_dispatches == 2
    assert p.gpu.host_fallback_queries == p.ref.host_fallback_queries


def test_delta_set_delete_update_parity():
    rng = random.Random(3)
    p = Pair()
    topics = [rand_topic(rng) for _ in range(300)]
    for i, tp in enumerate(topics):
        p.insert(tp, b"v%d" % i)
    filters = [rand_filter(rng) for _ in range(60)]
    p.exact(filters)  # first full build
    builds = p.gpu.rebuilds
    for i in range(150):
        r = rng.random()
        tp = rng.choice(topics)
        if r < 0.4:
            p.delete(tp)
        else:
            p.insert(tp, b"n%d" % i)
    p.exact(filters)
    assert p.gpu.rebuilds == builds == p.ref.rebuilds  # the delta path


def test_growth_rebuild_parity():
    rng = random.Random(4)
    p = Pair(cap=2048)
    filters = [rand_filter(rng) for _ in range(40)]
    for i in range(5000):  # overflows the 2048-slot initial layout
        p.insert((f"g{i % 97}", f"h{i}"), i)
    p.exact(filters)
    assert p.gpu.rebuilds >= 1 and p.gpu.table.cap == p.ref.table.cap > 2048


def test_async_rebuild_sheds_to_host():
    """With async_rebuild a capacity rebuild raises RebuildInProgress
    (callers host-walk) and installs in the background."""
    p = Pair(cap=2048, k=256, extract_k=256)
    for i in range(100):
        p.insert(("w", str(i)), i)
    p.exact([("w", "+")])  # first inline build
    for i in range(4000):
        p.insert((f"z{i % 31}", f"q{i}"), i)
    for idx, exc in ((p.ref, JM.RebuildInProgress),
                     (p.gpu, GM.RebuildInProgress)):
        idx.async_rebuild = True
        with pytest.raises(exc):
            idx.match_filters([("w", "+")])
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                rows = idx.match_filters([("w", "+")])[0]
                break
            except exc:
                time.sleep(0.02)
        else:
            pytest.fail("background rebuild never installed")
        assert norm(rows) == norm(p.stores[1].match_filter("", ["w", "+"]))
    assert p.gpu.rebuilds_async == p.ref.rebuilds_async == 1


def test_mountpoint_isolation():
    for Store, Engine, kw in ((RefStore, RefEngine, {}),
                              (RetainStore, RetainedEngine,
                               {"device": "cpu"})):
        store = Store()
        eng = Engine(store, **kw)
        store._on_dirty = eng.on_retain
        store.insert("", ("t", "a"), "default")
        store.insert("mp2", ("t", "a"), "other")
        for mp, want in [("", "default"), ("mp2", "other")]:
            idx = eng.index(mp)
            idx.async_rebuild = False
            rows = idx.match_filters([("t", "+")])[0]
            assert rows is not None and [v for _, v in rows] == [want]
        stats = eng.stats()
        assert stats["retained_index_rows"] == 2
        assert stats["retained_match_dispatches"] == 2


def test_fanout_over_k_host_fallback():
    p = Pair(k=8)
    for i in range(50):
        p.insert(("hot", f"t{i}"), i)
    for res in p.match([("hot", "+"), ("hot", "t1")]):
        assert res[0] is None  # 50 matches > k=8: exact host contract
        assert res[1] is not None and len(res[1]) == 1
    assert p.gpu.host_fallback_queries == p.ref.host_fallback_queries == 1


def test_overflow_topics_and_long_filters():
    """Topics deeper than L live host-side but a '#' filter still reaches
    them; filters with more concrete levels than L come back None."""
    p = Pair(max_levels=4)
    deep = ("a", "b", "c", "d", "e", "f")
    p.insert(deep, "deep")
    p.insert(("a", "b"), "shallow")
    for res in p.match([("a", "#"), ("a", "b"), deep]):
        assert {t_ for t_, _ in res[0]} == {deep, ("a", "b")}
        assert norm(res[1]) == [(("a", "b"), "shallow")]
        assert res[2] is None  # 6 concrete levels > L=4: host
    p.delete(deep)
    for res in p.match([("a", "#")]):
        assert {t_ for t_, _ in res[0]} == {("a", "b")}


def test_payload_update_visible_without_rebuild():
    p = Pair()
    p.insert(("u", "t"), "old")
    assert p.exact([("u", "t")])[0][0][1] == "old"
    builds = p.gpu.rebuilds
    p.insert(("u", "t"), "new")
    assert p.exact([("u", "t")])[0][0][1] == "new"
    assert p.gpu.rebuilds == builds


def install_both(**rule):
    JF.install(JF.FaultPlan([JF.FaultRule("device.retained", **rule)],
                            seed=5))
    PF.install(PF.FaultPlan([PF.FaultRule("device.retained", **rule)],
                            seed=5))


def test_fault_injection_breaker_and_recovery():
    """device.retained faults: the breaker opens after its threshold, calls
    shed with DeviceDegraded (the host walk serves) and a half-open probe
    recovers after the fault clears — step for step on both indexes."""
    p = Pair(k=256, extract_k=256)
    p.ref.breaker = RefBreaker(failure_threshold=2, backoff_initial=0.05,
                               backoff_max=0.2)
    p.gpu.breaker = CircuitBreaker(failure_threshold=2, backoff_initial=0.05,
                                   backoff_max=0.2)
    for i in range(100):
        p.insert(("f", str(i)), i)
    fw = ("f", "+")
    p.exact([fw])
    install_both(kind="error")
    steps = []
    for idx, exc in ((p.ref, JM.DeviceDegraded), (p.gpu, GM.DeviceDegraded)):
        out = []
        for _ in range(4):
            try:
                idx.match_filters([fw])
                out.append("ok")
            except exc:
                out.append("degraded")
        steps.append(out)
        assert idx.breaker.state_name == "open"
    assert steps[0] == steps[1] and steps[1].count("degraded") == 4
    assert p.gpu.degraded_sheds == p.ref.degraded_sheds >= 1
    assert p.gpu.device_failures == p.ref.device_failures == 2
    JF.clear()
    PF.clear()
    for idx, exc in ((p.ref, JM.DeviceDegraded), (p.gpu, GM.DeviceDegraded)):
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                if idx.match_filters([fw])[0] is not None:
                    break
            except exc:
                time.sleep(0.02)
        assert idx.breaker.state_name == "closed"
    p.exact([fw])


def test_breaker_counts_delta_and_build_failures():
    """device.retained covers the upload half too: a failed delta scatter
    feeds the breaker and re-arms a full rebuild, after which host and
    device re-converge."""
    p = Pair()
    for i in range(50):
        p.insert(("d", str(i)), i)
    p.exact([("d", "+")])
    install_both(kind="error", count=1)
    p.insert(("d", "extra"), "x")  # dirties a slot
    with pytest.raises(JM.DeviceDegraded):
        p.ref.match_filters([("d", "+")])
    with pytest.raises(GM.DeviceDegraded):
        p.gpu.match_filters([("d", "+")])
    assert p.gpu.device_failures == p.ref.device_failures == 1
    rows = p.exact([("d", "+")])[0]
    assert any(t_ == ("d", "extra") for t_, _ in rows)


def test_cuda_fault_raises_kernel_error_not_the_breaker(monkeypatch):
    """A CUDA fault of the device path (simulated: the error a faulted
    kernel leaves for the next call) raises KernelError: the breaker is not
    fed, no host walk answers, and every later sync raises it too."""
    p = Pair()
    for i in range(20):
        p.insert(("c", str(i)), i)
    p.exact([("c", "+")])

    def faulted(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(TR, "reverse_match", faulted)
    for _ in range(2):
        with pytest.raises(KernelError):
            p.gpu.match_filters([("c", "+")])
    monkeypatch.undo()
    with pytest.raises(KernelError, match="illegal memory access"):
        p.gpu.match_filters([("c", "+")])  # sticky: the sync raises it
    assert p.gpu.device_failures == 0
    assert p.gpu.breaker.state_name == "closed"


def _engines(n_topics, prefix, **idx_kw):
    """A write-through (store, engine) of each package with ``n_topics``
    retained topics ``prefix/<i>`` (payload i)."""
    out = []
    for Store, Engine, kw in ((RefStore, RefEngine, {}),
                              (RetainStore, RetainedEngine,
                               {"device": "cpu"})):
        store = Store()
        eng = Engine(store, **kw)
        store._on_dirty = eng.on_retain
        for i in range(n_topics):
            store.insert("", (prefix, str(i)), i)
        out.append((store, eng))
    return out


@pytest.mark.asyncio
async def test_collector_batches_and_host_threshold():
    for (store, eng), Col in zip(_engines(64, "c"),
                                 (RefCollector, RetainedBatchCollector)):
        eng.index("").async_rebuild = False
        col = Col(eng, store, window_us=2000, max_batch=64,
                  host_threshold=2)
        rows = await col.submit("", ("c", "3"))  # under the threshold
        assert [v for _, v in rows] == [3]
        assert col.host_hybrid_filters == 1
        futs = [col.submit("", ("c", str(i))) for i in range(16)]
        for i, rows in enumerate(await asyncio.gather(*futs)):
            assert [v for _, v in rows] == [i]
        assert col.device_batches >= 1 and col.device_filters >= 16


@pytest.mark.asyncio
async def test_collector_degraded_serves_host():
    for (store, eng), Col, Br in zip(
            _engines(32, "g"), (RefCollector, RetainedBatchCollector),
            (RefBreaker, CircuitBreaker)):
        idx = eng.index("")
        idx.async_rebuild = False
        idx.breaker = Br(failure_threshold=1, backoff_initial=5.0)
        idx.breaker.trip()  # pinned open: every dispatch refuses
        col = Col(eng, store, window_us=500, max_batch=32, host_threshold=0)
        futs = [col.submit("", ("g", str(i))) for i in range(8)]
        for i, rows in enumerate(await asyncio.gather(*futs)):
            assert [v for _, v in rows] == [i]
        assert col.degraded_filters == 8 and col.device_batches == 0


@pytest.mark.asyncio
async def test_collector_close_settles_pending():
    for (store, eng), Col in zip(_engines(8, "cl"),
                                 (RefCollector, RetainedBatchCollector)):
        col = Col(eng, store, window_us=10_000_000, max_batch=64,
                  host_threshold=0)
        futs = [col.submit("", ("cl", str(i))) for i in range(4)]
        col.close()
        for i, rows in enumerate(await asyncio.gather(*futs)):
            assert [v for _, v in rows] == [i]
        assert [v for _, v in await col.submit("", ("cl", "5"))] == [5]
        assert col.device_batches == 0


@pytest.mark.asyncio
async def test_collector_kernel_error_reaches_the_futures(monkeypatch):
    """A kernel fault is no degraded signal: the collector hands the
    KernelError to every future of the flush and serves no host walk."""
    (_, _), (store, eng) = _engines(16, "k")
    idx = eng.index("")
    idx.async_rebuild = False

    def refused(*a, **kw):
        raise KernelError("reverse_match kernel launch failed")

    monkeypatch.setattr(TR, "reverse_match", refused)
    col = RetainedBatchCollector(eng, store, window_us=500, max_batch=32,
                                 host_threshold=0)
    futs = [col.submit("", ("k", str(i))) for i in range(6)]
    res = await asyncio.gather(*futs, return_exceptions=True)
    assert all(isinstance(r, KernelError) for r in res), res
    stats = col.stats()
    assert stats["retained_replay_device_filters"] == 0
    assert not any(v for k, v in stats.items()
                   if k.endswith(("degraded_filters", "rebuild_filters",
                                  "fallback_filters", "host_filters")))
    assert idx.device_failures == 0


def test_encode_cache_survives_region_remap():
    """A growth rebuild re-ranks the dedicated word->region map even when
    the interner does not grow; cached filter encodings must not keep
    probing the OLD region."""
    p = Pair(cap=2048, k=1024, extract_k=1024)
    words = [f"w{i}" for i in range(40)]
    tails = [f"s{k}" for k in range(80)]
    for k, tl in enumerate(tails):
        p.insert(("seed", tl), k)
    for i, w in enumerate(words):
        for k in range(60 if i == 1 else 20):
            p.insert((w, tails[k]), ("a", i, k))
    for idx in p.indexes:
        with idx.lock:
            idx.table._rebuild()  # establish the dedicated layout
    fw = ("w1", "+")
    assert len(p.exact([fw])[0]) == 60  # the encode caches fill
    tab = p.gpu.table
    region_a = tab.query_region(tab.interner.lookup("w1"))
    for k in range(1, 60):  # w1 goes cold; re-rank
        p.delete(("w1", tails[k]))
    for idx in p.indexes:
        with idx.lock:
            idx.table._rebuild()
    assert tab.query_region(tab.interner.lookup("w1")) != region_a
    assert len(p.exact([fw])[0]) == 1


@pytest.mark.asyncio
async def test_async_warm_load_buffers_racing_deltas():
    """warm_load_async: a delete arriving mid-load for a topic the load has
    NOT inserted yet is not resurrected, and a mid-load insert lands."""
    for store, eng in _engines(200, "wl"):
        idx = eng._mk("")
        eng._indexes[""] = idx
        load = asyncio.get_event_loop().create_task(
            idx.warm_load_async(chunk=16))
        await asyncio.sleep(0)  # first chunk landed, rest pending
        store.delete("", ("wl", "150"))  # not-yet-loaded topic
        store.insert("", ("wl", "fresh"), "nv")
        await load
        idx.async_rebuild = False
        idx.max_fanout = idx.extract_k = 512
        rows = idx.match_filters([("wl", "+")])[0]
        assert norm(rows) == norm(store.match_filter("", ["wl", "+"]))
        topics = {t_ for t_, _ in rows}
        assert ("wl", "150") not in topics and ("wl", "fresh") in topics


topic_word = st.sampled_from(["a", "b", "c", "$x", "dev"])
filter_word = st.sampled_from(["a", "b", "c", "$x", "dev", "+"])


@given(st.lists(st.lists(topic_word, min_size=1, max_size=5),
                min_size=0, max_size=40),
       st.lists(st.tuples(st.lists(filter_word, min_size=1, max_size=5),
                          st.booleans()),
                min_size=1, max_size=12))
@settings(max_examples=20, deadline=None)
def test_property_reverse_match_parity(topics, filters):
    p = Pair(max_levels=8, cap=2048)
    for i, tp in enumerate(topics):
        p.insert(tuple(tp), i)
    p.exact([tuple(fw) + (("#",) if hash_suffix else ())
             for fw, hash_suffix in filters])
