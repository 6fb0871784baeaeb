"""The port's CUDA kernels against their plain PyTorch versions, on a card
(the tile matcher's probe and dense modes, the predicate kernel at its
edges, over dispatches in a row and after a failure), and the device paths
that only a card can show: match_many equal to K
match_batch dispatches with no host sync between its launches, a kernel
library that fails to build raising from the matcher, a kernel that faults
on the card failing the collector's futures, the extraction kernel against
its plain version at the main path's shapes and its edges, the forward
windowed path equal to the same call with the plain extraction, the
retained reverse match on the card equal to its plain path (the compare
kernel and the extraction over its chunk counts), a refused reverse kernel failing the replay futures,
the retained index's warm first build, the tile kernel's shard row mode, a
2-slice mesh of one card equal to the single-GPU matcher, and match_many
over misaligned staged pub_len views.

Marked ``cuda``: without a card every test skips (a kernel has no CPU
mode). This file imports neither JAX nor the JAX package, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import os
import pathlib
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import (EDGE_IDS, UNKNOWN_ID, bucket_corpus, bucket_topics,
                         reverse_inputs)
from vernemq_tpu_torch.models import matcher as GM
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.ops import _build
from vernemq_tpu_torch.ops import extract as EX
from vernemq_tpu_torch.ops import match_kernel as TK
from vernemq_tpu_torch.ops import reverse_kernel as TR
from vernemq_tpu_torch.ops import reverse_tiles as RT
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
    mode = "b" if wild_rows else "a"
    TM.window_tiles_packed(*x, mode=mode, **kw)  # build, allocate
    before = TM.launches
    torch.cuda.set_sync_debug_mode("error")  # a device→host copy raises
    try:
        got = TM.window_tiles_packed(*x, mode=mode, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    kw.pop("start_host")
    want = TM.window_tiles_packed_ref(*x, mode=mode, **kw)
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
    mode = "b" if wild_rows else "a"
    got = TM.window_tiles_packed(*x, mode=mode, **kw)
    kw.pop("start_host")
    want = TM.window_tiles_packed_ref(*x, mode=mode, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), label
    hits = TK._popcount(want).sum(dim=2)
    assert int(hits.sum()) > 50  # not vacuous
    if label == "plen>L":  # the long publishes do match (hash rows)
        assert int(hits[x[5] > 31].sum()) > 0


# (label, window starts, glob_pad, row_base) of the shard mode on a table
# slice of S = 32768 rows: a slice whose rows all lie past glob_pad, one
# whose windows cross it (one below it entirely), and the guard off
# (glob_pad 0, the per-slice match)
SHARD_CASES = [
    ("past", [0, 777, 32768 - 8192], 40_000, 65_536),
    ("straddles", [0, 9000 - 4096, 9000 - 1, 20_000], 9000 + 98_304, 98_304),
    ("guard off", [0, 333, 32768 - 8192], 0, 32_768),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,starts,gp,row_base", SHARD_CASES,
                         ids=[c[0] for c in SHARD_CASES])
def test_shard_mode_is_bit_equal_to_the_plain_version(label, starts, gp,
                                                      row_base):
    """The shard row mode (rows kept by their global index ``row_base`` +
    row, no first-level split) is bit-equal to window_tiles_packed_ref,
    and counted as a probe launch."""
    _card()
    x, kw = _tile_inputs(11, 16, starts=starts)
    kw.update(glob_pad=gp, row_base=row_base, mode="shard")
    before = TM.launches
    got = TM.window_tiles_packed(*x, **kw)
    kw.pop("start_host")
    want = TM.window_tiles_packed_ref(*x, **kw)
    torch.cuda.synchronize()
    assert TM.launches == before + 1
    assert torch.equal(got, want), label
    hits = TK._popcount(want).sum(dim=(1, 2))
    assert int(hits.sum()) > 100  # not vacuous
    if label == "straddles":  # the tile below glob_pad keeps nothing
        assert int(hits[0]) == 0 and int(hits[1]) > 0


@pytest.mark.cuda
def test_concurrent_launches_at_other_tile_widths_are_not_refused():
    """Four host threads launch one kernel template (K = 40) at tile widths
    whose shared memory all pass 48 KB (TP 16, 64, 128 and 256), each on
    its own stream, 500 times, as a broker's dispatches in flight do (dense
    tiles of small and large flushes beside a probe): no launch is refused
    — the cap a launch needs is raised, never lowered under another
    thread's launch — and each thread's last result equals the plain
    version's."""
    _card()
    import threading

    jobs = [_tile_inputs(21 + i, 16, TP=tp)
            for i, tp in enumerate((16, 64, 128, 256))]
    errors, last = [], [None] * len(jobs)

    def run(i):
        x, kw = jobs[i]
        stream = torch.cuda.Stream()
        try:
            with torch.cuda.stream(stream):
                for _ in range(500):
                    last[i] = TM.window_tiles_packed(*x, mode="a", **kw)
            stream.synchronize()
        except Exception as e:  # a refused launch: KernelError
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
        assert not th.is_alive()
    assert not errors, errors
    for (x, kw), got in zip(jobs, last):
        kw = dict(kw)
        kw.pop("start_host")
        assert torch.equal(got, TM.window_tiles_packed_ref(*x, mode="a",
                                                           **kw))


@pytest.mark.cuda
def test_two_slice_mesh_on_the_card_equals_match_batch():
    """A 2-slice mesh of cuda:0 (MeshGpuMatcher) serves the rows
    GpuMatcher.match_batch serves, launching the tile kernel in dense and
    shard mode and the extraction kernel on both shards, with no plain
    extraction or bit-pack on the card; its per-slice match unions to the
    same rows."""
    _card()
    from vernemq_tpu_torch.parallel import sharded_match as SM
    from vernemq_tpu_torch.parallel.mesh import make_mesh
    from vernemq_tpu_torch.parallel.mesh_match import MeshGpuMatcher

    corpus = bucket_corpus()
    single = GM.GpuMatcher(max_levels=8, initial_capacity=8192,
                           device="cuda")
    mesh = MeshGpuMatcher(make_mesh(["cuda:0"] * 2), max_levels=8,
                          initial_capacity=8192)
    for i, f in enumerate(corpus):
        for m in (single, mesh):
            m.table.add(f, i, None)
    topics = bucket_topics(random.Random(9), 256)
    single.match_batch(topics[:4])
    mesh.match_batch(topics[:4])  # builds and warms both
    SM.shard_launches.clear()
    plain = TK.plain_cuda_extractions, TK.plain_cuda_packs
    got = mesh.match_batch(topics)
    torch.cuda.synchronize()
    want = single.match_batch(topics)
    key = lambda rows: sorted(k for _, k, _ in rows)
    assert [key(r) for r in got] == [key(r) for r in want]
    assert sum(len(r) for r in want) > 100  # not vacuous
    assert (TK.plain_cuda_extractions, TK.plain_cuda_packs) == plain
    assert set(SM.shard_launches) == {(0, 0), (0, 1)}
    for c in SM.shard_launches.values():
        assert c["dense"] == 1 and c["tile"] == 1 and c["extract"] == 2
    assert mesh.host_fallbacks == 0 and mesh._swm.mesh_dispatches >= 2
    ids, _ = mesh._swm.match_local_slices(topics[:32])
    ent = mesh.table.entries
    assert [sorted(ent[i][1] for i in sl if ent[i] is not None)
            for sl in ids] == [key(r) for r in want[:32]]


@pytest.mark.cuda
def test_match_many_reads_misaligned_pub_len_views():
    """K = 4 batches staged in one block placed 4 bytes past a 16-byte
    boundary, so row 0's pub_len view (and any row whose start is not a
    multiple of 16 bytes) is off the boundary the kernel reads in 16-byte
    pieces; the dense launch copies such a view (ops/tile_match.py
    dense_tiles_packed). Every row of the result equals that batch's
    single dispatch (match_batch's), and match_many's rows equal K
    match_batch calls."""
    _card()
    m, batches, args, statics, table = _many_inputs(K=4, n=200)
    staged = TK.stage_many(args, "cuda")
    K, P = staged.shape
    buf = torch.zeros(K * P + 4, dtype=torch.int32, device="cuda")
    shifted = buf[1:1 + K * P].view(K, P)
    shifted.copy_(staged)
    views = [TK._unpack_transport(shifted[i], **TK._packed_geometry(a))[1]
             for i, a in enumerate(args)]
    assert views[0].data_ptr() % 16
    out = TK.match_many_staged(*table, shifted, args, statics).cpu().numpy()
    for row, a in zip(out, args):
        np.testing.assert_array_equal(
            row, m._dispatch_flat(m._dev_arrays, m._operands, a, statics))
    C, B = statics["C"], args[0][0].shape[0]
    assert int(out[:, C + B:C + 2 * B].sum()) > 100  # not vacuous
    got = m.match_many(batches)
    want = [m.match_batch(b) for b in batches]
    assert [[[(f, k) for f, k, _ in r] for r in b] for b in got] == \
        [[[(f, k) for f, k, _ in r] for r in b] for b in want]


@pytest.mark.cuda
def test_tile_match_rejects_what_it_cannot_take():
    _card()
    x, kw = _tile_inputs(1, 16)
    with pytest.raises(ValueError, match="leave the table"):
        bad = x[:7] + (x[7] + 30_000,)
        TM.window_tiles_packed(*bad, mode="a",
                               **{**kw, "start_host": kw["start_host"] + 30_000})
    with pytest.raises(ValueError, match="leave the table"):  # wrong T
        TM.window_tiles_packed(*x, mode="a",
                               **{**kw, "start_host": kw["start_host"][:2]})
    with pytest.raises(ValueError, match="F_t must be"):
        TM.window_tiles_packed(x[0].float(), *x[1:], mode="a", **kw)
    with pytest.raises(ValueError, match="multiple of 16"):
        TM.window_tiles_packed(*x[:4], x[4][:, :24].contiguous(),
                               x[5][:, :24].contiguous(),
                               x[6][:, :24].contiguous(), x[7],
                               mode="a", **kw)


# (label, id bits, B publishes, glob_pad, S rows): the headline's class
# (4096 publishes against region 0 of 2048 rows of a large table), a batch
# that is not a multiple of 16 (padded to whole tiles), a glob_pad that is
# not a multiple of 256 with 24-bit ids, a batch smaller than one tile
DENSE_SHAPES = [
    ("headline", 16, 4096, 2048, 1_613_824),
    ("B=1000", 16, 1000, 2048, 1 << 20),
    ("gp=2080-24bit", 24, 512, 2080, 65536),
    ("B=8", 16, 8, 4096, 8192),
]


def _dense_operands(seed, bits, B, glob_pad, S, L=8):
    """Random table and publish operands on the card with many region-0
    matches: publishes copied from region-0 rows (byte-plane edge ids,
    ~5% unknown words, a tenth longer than the key clamp, a quarter $)."""
    rng = np.random.default_rng(seed)
    vocab = np.concatenate([np.arange(3, 9), EDGE_IDS[3:]]).astype(np.int32)
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < 0.25] = TK.PLUS_ID
    eff = rng.integers(1, 4, S, dtype=np.int32)
    src = rng.integers(0, glob_pad, B)
    pw = words[src]
    pw[pw == TK.PLUS_ID] = vocab[0]
    pw[rng.random(pw.shape) < 0.05] = UNKNOWN_ID
    pl = np.where(rng.random(B) < 0.6, eff[src],
                  rng.integers(1, 4, B)).astype(np.int32)
    pl[rng.random(B) < 0.1] = 40
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    F_t, t1 = TK.build_operands(c(words), c(eff), bits)
    return (F_t, t1, c(eff), c(rng.random(S) < 0.2), c(rng.random(S) < 0.5),
            c(rng.random(S) < 0.9), c(pw), c(pl), c(rng.random(B) < 0.25))


@pytest.mark.cuda
@pytest.mark.parametrize("label,bits,B,gp,S", DENSE_SHAPES,
                         ids=[d[0] for d in DENSE_SHAPES])
def test_dense_mode_is_bit_equal_to_the_plain_dense_region0(label, bits, B,
                                                            gp, S):
    """Dense region 0 by one tile launch in dense mode equals the plain
    compare-and-pack (``match_kernel._dense_region0_packed``) word for word,
    its words past glob_pad/32 are 0, and it counted one dense launch and
    no probe launch."""
    _card()
    F_t, t1, eff, hh, fw, act, pw, pl, pd = _dense_operands(3, bits, B, gp, S)
    flags = TM.row_flags(hh, fw, act)
    G = TK.build_pub_operand(pw, bits)
    before = TM.launches, TM.dense_launches
    got = TM.dense_region0_packed(F_t, t1, eff, flags, G, pl, pd,
                                  glob_pad=gp)
    torch.cuda.synchronize()
    assert (TM.launches, TM.dense_launches) == (before[0], before[1] + 1)
    want = TK._dense_region0_packed(F_t, t1, eff, hh, fw, act, pw, pl, pd,
                                    id_bits=bits, glob_pad=gp, gc=1024)
    W0 = want.shape[1]
    assert got.shape == (B, TM.dense_geometry(B, gp, S)[2] // 32), label
    assert torch.equal(got[:, :W0], want), label
    assert not bool(got[:, W0:].any())
    assert int(TK._popcount(want).sum()) > 50  # not vacuous


@pytest.mark.cuda
def test_forward_dispatch_runs_dense_region0_on_the_tile_kernel():
    """One forward dispatch launches the tile kernel once in dense mode and
    packs nothing in plain PyTorch on the card."""
    _card()
    m, _, args, statics, table = _many_inputs(K=1, n=256)
    a = args[0]
    host = [_cuda(x) for x in a[:3]] + [int(a[3]), _cuda(a[4]), a[5],
                                        _cuda(a[6]), a[7]] \
        + [_cuda(x) for x in a[8:]]
    dense, packs = TM.dense_launches, TK.plain_cuda_packs
    got = TK.match_extract_windowed_flat(*table, *host, **statics)
    torch.cuda.synchronize()
    assert TM.dense_launches == dense + 1
    assert TK.plain_cuda_packs == packs
    assert int(got[2].sum()) > 100  # not vacuous


def _many_inputs(K=4, n=256):
    """A CUDA matcher over the serving corpus and K windows of ``n``
    publishes prepped from one snapshot at one Bpad."""
    m = GM.GpuMatcher(max_levels=8, initial_capacity=8192, device="cuda")
    for i, f in enumerate(bucket_corpus()):
        m.table.add(f, i, None)
    rng = random.Random(12)
    batches = [bucket_topics(rng, n) for _ in range(K)]
    with m.lock:
        m.sync()
        layout = m._layout_locked()
        encs = [m._encode_batch_ex(b) for b in batches]
    S = int(m._operands[0].shape[1])
    preps = [m._flat_prep(layout, S, *e, n) for e in encs]
    args, statics = [p[0] for p in preps], preps[0][1]
    assert all(p[1] == statics for p in preps)
    return m, batches, args, statics, (*m._operands, *m._dev_arrays[1:])


@pytest.mark.cuda
def test_first_build_warms_the_device_path_without_changing_it():
    """The first build runs one match dispatch and one delta scatter on
    the card (CUDA loads each kernel's module at its first launch): the
    table on the card still equals the host table, the warm-up counted no
    match and no dispatch, and the first real batch matches the trie."""
    _card()
    m = GM.GpuMatcher(max_levels=8, initial_capacity=8192, device="cuda")
    corpus = bucket_corpus()
    for i, f in enumerate(corpus):
        m.table.add(f, i, None)
    with m.lock:
        m.sync()
    assert m.warm_ms is not None and m.warm_ms > 0 and m.table.bucketed
    t = m.table
    for dev, host in zip(m._dev_arrays, (t.words, t.eff_len, t.has_hash,
                                         t.first_wild, t.active)):
        np.testing.assert_array_equal(dev.cpu().numpy(), host)
    assert m.match_batches == 0 and m.match_publishes == 0
    topics = bucket_topics(random.Random(5), 64)
    rows = m.match_batch(topics)
    trie = SubscriptionTrie()
    for i, f in enumerate(corpus):
        trie.add(list(f), i, None)
    for topic, got in zip(topics, rows):
        assert sorted(k for _, k, _ in got) == sorted(
            k for _, k, _ in trie.match(list(topic)))


@pytest.mark.cuda
def test_match_many_equals_match_batch_on_card():
    """The [K, C + 3B] result equals K single dispatches element for
    element, and match_many's rows equal K match_batch calls."""
    _card()
    m, batches, args, statics, table = _many_inputs()
    before = TM.launches
    many = TK.call_match_many(*table, args, statics)
    assert TM.launches > before  # the kernel ran
    for row, a in zip(many, args):
        single = m._dispatch_flat(m._dev_arrays, m._operands, a, statics)
        np.testing.assert_array_equal(row, single)
    C, B = statics["C"], args[0][0].shape[0]
    assert int(many[:, C + B:C + 2 * B].sum()) > 100  # not vacuous
    got = m.match_many(batches)
    want = [m.match_batch(b) for b in batches]
    assert [[[(f, k) for f, k, _ in r] for r in b] for b in got] == \
        [[[(f, k) for f, k, _ in r] for r in b] for b in want]
    assert m.super_dispatches == 1


@pytest.mark.cuda
def test_match_many_launches_without_host_sync():
    """From after the staging upload to before the one download, match_many's
    K device paths run under sync debug mode "error": nothing in them waits
    for the card."""
    _card()
    m, _, args, statics, table = _many_inputs()
    want = TK.call_match_many(*table, args, statics)  # builds, allocates
    staged = TK.stage_many(args, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = TK.match_many_staged(*table, staged, args, statics)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(out.cpu().numpy(), want)


@pytest.mark.cuda
def test_kernel_build_failure_raises_from_the_matcher(tmp_path,
                                                      monkeypatch):
    """A kernel library that does not build makes GpuMatcher and GpuRegView
    raise when they are created: no matcher exists to serve, so the error
    never reaches a breaker or a trie answer. The build is pointed at a
    broken copy of the source in a temporary directory."""
    _card()
    src = tmp_path / "csrc"
    src.mkdir()
    shutil.copy(_build.CSRC / "tile_match.cu", src / "tile_match.cu")
    with open(src / "tile_match.cu", "a") as f:
        f.write("\nthis does not compile;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="kernel build failed"):
        GM.GpuMatcher(device="cuda")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        GM.GpuRegView(registry=None, device="cuda")


# Run in a process of its own: a CUDA fault is sticky, and it would fail
# every later test of this process.
FAULT_SCRIPT = r"""
import asyncio, json, random, sys
import torch
from _torch_port import bucket_corpus, bucket_topics
from vernemq_tpu_torch.models import matcher as GM
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.ops import tile_match as TM

class Registry:
    def __init__(self, trie):
        self._trie = trie
    def fold_subscriptions(self, mp):
        return self._trie.entries()
    def trie(self, mp):
        return self._trie

trie = SubscriptionTrie()
for i, f in enumerate(bucket_corpus()):
    trie.add(f, i, None)
view = GM.GpuRegView(Registry(trie), max_levels=8, initial_capacity=8192,
                     max_fanout=64, device="cuda", breaker_failure_threshold=1)
m = view.matcher("")
col = GM.BatchCollector(view, window_us=200, max_batch=16,
                        lock_busy_shed_ms=500, super_batch_k=4)
launch = TM.window_tiles_packed

def out_of_range(*a, **kw):
    # the host copy of the starts passes the bounds check; the kernel
    # reads its windows from the device copy, 2^31 rows before the table
    a = list(a)
    a[7] = torch.full_like(a[7], -(1 << 31))
    return launch(*a, **kw)

async def main():
    rng = random.Random(6)
    healthy = await asyncio.gather(
        *[col.submit("", t) for t in bucket_topics(rng, 16)])
    TM.window_tiles_packed = out_of_range
    outs = []
    for n in (16, 16 * 6):  # one window; two slots and a super-batch
        got = await asyncio.gather(
            *[col.submit("", t) for t in bucket_topics(rng, n)],
            return_exceptions=True)
        outs.append(sorted({type(g).__name__ for g in got}))
    return healthy, outs

healthy, outs = asyncio.run(main())
print(json.dumps(dict(
    healthy=all(isinstance(r, list) for r in healthy), outs=outs,
    host_pubs={k: getattr(col, k) for k in dir(col)
               if k.endswith("_host_pubs")},
    device_failures=m.device_failures, breaker=m.breaker.state_name,
    launches=TM.launches)))
"""


@pytest.mark.cuda
def test_kernel_fault_fails_the_collector_futures():
    """A kernel that reads outside the table (a window start past the host
    bounds check) faults on the card. The fault is sticky and surfaces from
    later launches and copies, not from the launch: every future of the
    collector fails with KernelError, none is answered from the trie, and
    the breaker hears nothing."""
    _card()
    tests = pathlib.Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-c", FAULT_SCRIPT], capture_output=True,
        text=True, timeout=600, cwd=tests.parent,
        env={**os.environ,
             "PYTHONPATH": f"{tests}:{tests.parent}"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["healthy"] and res["launches"] > 0
    assert res["outs"] == [["KernelError"], ["KernelError"]], res
    assert not any(res["host_pubs"].values()), res
    assert res["device_failures"] == 0 and res["breaker"] == "closed"


@pytest.mark.cuda
def test_broker_serves_mqtt_through_the_tile_kernel():
    """The port's broker on the card: one subscriber and one publisher over
    TCP, a bucketed table (the bucket corpus under one subscriber id with
    no session) so the publishes take the windowed path; every delivery
    is exact, the tile kernel launched, nothing was served by the host."""
    import asyncio

    from vernemq_tpu_torch.broker.config import Config
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.client import MQTTClient
    from vernemq_tpu_torch.protocol.types import SubOpts

    _card()
    rng = random.Random(7)
    filters = ["r1/+/m2", "+/d3/m4", "r5/d6/#", "r1/d3/m2"]
    topics = ["/".join(t) for t in bucket_topics(rng, 200)] \
        + ["r1/d3/m2", "r5/d6/m0"] * 5

    async def main():
        b, s = await start_broker(
            Config(allow_anonymous=True, systree_enabled=False,
                   sysmon_enabled=False, default_reg_view="tpu",
                   tpu_initial_capacity=8192, tpu_max_fanout=64,
                   tpu_host_batch_threshold=0,
                   watchdog_collector_expiry_budgets=100),
            port=0, device="cuda")
        try:
            b.registry.subscribe(("", "bulk"), [
                (f, SubOpts()) for f in bucket_corpus()])
            m = b.registry.reg_view("tpu").matcher("")
            sub = MQTTClient(s.host, s.port, "sub", proto_ver=5)
            await sub.connect()
            await sub.subscribe(filters, qos=1)
            pub = MQTTClient(s.host, s.port, "pub")
            await pub.connect()
            TM.launches = 0
            for i, t in enumerate(topics):
                await pub.publish(t, b"%d" % i, qos=i % 2)
            trie = b.registry.trie("")
            want = sorted(
                (t, b"%d" % i) for i, t in enumerate(topics)
                for _f, key, _o in trie.match(t.split("/"))
                if key == ("", "sub"))
            got = []
            while len(got) < len(want):
                f = await sub.recv(10.0)
                got.append((f.topic, bytes(f.payload)))
            col = b.batch_collector()
            host = {k: getattr(col, k) for k in dir(col)
                    if k.endswith("_host_pubs")}
            host.update(host_fallbacks=m.host_fallbacks,
                        device_failures=m.device_failures)
            await sub.disconnect()
            await pub.disconnect()
            return want, sorted(got), TM.launches, host, m.table.bucketed
        finally:
            await b.stop()
            await s.stop()

    want, got, launches, host, bucketed = asyncio.run(main())
    assert bucketed and want and got == want
    assert launches > 0 and not any(host.values()), (launches, host)


@pytest.mark.cuda
def test_publish_rewritten_by_a_plugin_is_matched_on_the_card(tmp_path):
    """A Lua ``auth_on_publish`` (vmq_diversity) rewrites ``old/...`` to
    ``r1/...``: the rewritten topic is what the card matches. The
    subscriber receives exactly the trie's rows of the rewritten topics,
    the tile kernel launches, nothing is served by the host, and the
    matcher's rows of the rewritten topics equal the trie's."""
    import asyncio

    from vernemq_tpu_torch.broker.config import Config
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.client import MQTTClient
    from vernemq_tpu_torch.protocol.types import SubOpts

    _card()
    script = tmp_path / "rewrite.lua"
    script.write_text("""
function auth_on_publish(pub)
    if string.sub(pub.topic, 1, 4) == "old/" then
        return {topic = "r1/" .. string.sub(pub.topic, 5)}
    end
    return true
end
hooks = { auth_on_publish = auth_on_publish }
""")
    filters = ["r1/+/m2", "+/d3/m4", "r1/d3/#", "old/#"]
    tails = [f"d{i % 8}/m{i % 5}" for i in range(60)]

    async def main():
        b, s = await start_broker(
            Config(allow_anonymous=True, systree_enabled=False,
                   sysmon_enabled=False, default_reg_view="tpu",
                   tpu_initial_capacity=8192, tpu_max_fanout=64,
                   tpu_host_batch_threshold=0,
                   watchdog_collector_expiry_budgets=100),
            port=0, device="cuda")
        try:
            b.plugins.enable("vmq_diversity", scripts=[str(script)])
            b.registry.subscribe(("", "bulk"), [
                (f, SubOpts()) for f in bucket_corpus()])
            m = b.registry.reg_view("tpu").matcher("")
            sub = MQTTClient(s.host, s.port, "sub", proto_ver=5)
            await sub.connect()
            await sub.subscribe(filters, qos=1)
            pub = MQTTClient(s.host, s.port, "pub")
            await pub.connect()
            TM.launches = 0
            for i, t in enumerate(tails):
                await pub.publish("old/" + t, b"%d" % i, qos=i % 2)
            trie = b.registry.trie("")
            want = sorted(
                ("r1/" + t, b"%d" % i) for i, t in enumerate(tails)
                for _f, key, _o in trie.match(["r1", *t.split("/")])
                if key == ("", "sub"))
            got = []
            while len(got) < len(want):
                f = await sub.recv(10.0)
                got.append((f.topic, bytes(f.payload)))
            late = []
            try:
                late.append(await sub.recv(0.5))
            except asyncio.TimeoutError:
                pass
            launches = TM.launches
            col = b.batch_collector()
            host = {k: getattr(col, k) for k in dir(col)
                    if k.endswith("_host_pubs")}
            host.update(host_fallbacks=m.host_fallbacks,
                        device_failures=m.device_failures)
            rewritten = [["r1", *t.split("/")] for t in tails]
            rows = m.match_batch(rewritten)
            parity = all(
                sorted((f, str(k)) for f, k, _ in r)
                == sorted((f, str(k)) for f, k, _ in trie.match(t))
                for r, t in zip(rows, rewritten))
            await sub.disconnect()
            await pub.disconnect()
            return want, sorted(got), late, launches, host, parity
        finally:
            await b.stop()
            await s.stop()

    want, got, late, launches, host, parity = asyncio.run(main())
    assert want and got == want and not late
    assert launches > 0 and not any(host.values()), (launches, host)
    assert parity


@pytest.mark.cuda
def test_broker_starts_on_the_card_in_a_fresh_process():
    """A broker process that has imported nothing else starts on the card
    with the GPU view, the retained index and the predicate phase (each
    loading its kernel library at boot) and stops cleanly."""
    _card()
    code = (
        "import asyncio, sys\n"
        f"sys.path.insert(0, {str(pathlib.Path(__file__).resolve().parent.parent)!r})\n"
        "from vernemq_tpu_torch.broker.config import Config\n"
        "from vernemq_tpu_torch.broker.server import start_broker\n"
        "async def main():\n"
        "    b, s = await start_broker(Config(default_reg_view='tpu',\n"
        "        systree_enabled=False, sysmon_enabled=False), port=0,\n"
        "        device='cuda')\n"
        "    ok = b.filter_engine is not None and \\\n"
        "        b.registry.batched_view_active()\n"
        "    await b.stop()\n"
        "    await s.stop()\n"
        "    print('started', ok)\n"
        "asyncio.run(main())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["started", "True"], out.stdout


async def _two_nodes_pointer_rows(device, filters, topics):
    """Two port nodes in this process on ``device`` (GPU view, SWC
    metadata, B joined to A): the bucket corpus and ``filters`` of a live
    subscriber on A, replicated to B as node-pointer rows; then a device
    fold on B of ``topics`` and the same topics published on B. Returns,
    per topic, whether B's fold returned A's pointer and whether A holds a
    matching subscription; the fold's tile launches; the subscriber's
    deliveries and what A's trie predicts for it; both nodes' off-card
    counters, device publishes and layouts."""
    import asyncio
    import time

    from vernemq_tpu_torch.broker.config import Config
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.client import MQTTClient
    from vernemq_tpu_torch.protocol.types import SubOpts

    conf = dict(allow_anonymous=True, systree_enabled=False,
                sysmon_enabled=False, default_reg_view="tpu",
                metadata_plugin="swc", tpu_initial_capacity=8192,
                tpu_max_fanout=64, tpu_host_batch_threshold=0,
                watchdog_collector_expiry_budgets=100)
    a, sa = await start_broker(Config(**conf), port=0, node_name="A",
                               device=device, cluster_listen=("127.0.0.1", 0))
    b, sb = await start_broker(Config(**conf), port=0, node_name="B",
                               device=device, cluster_listen=("127.0.0.1", 0),
                               join=(a.cluster.listen_host,
                                     a.cluster.listen_port))
    try:
        deadline = time.monotonic() + 30
        while not all(len(n.cluster.members()) == 2 and n.cluster.is_ready()
                      for n in (a, b)):  # the CAP gate refuses subscribes
            assert time.monotonic() < deadline, "the nodes never joined"
            await asyncio.sleep(0.05)
        views = [n.registry.reg_view("tpu") for n in (a, b)]
        ms = [v.matcher("") for v in views]
        a.registry.subscribe(("", "bulk"), [
            (f, SubOpts()) for f in bucket_corpus(300)])
        sub = MQTTClient(sa.host, sa.port, "sub", proto_ver=5)
        await sub.connect()
        await sub.subscribe(filters, qos=1)
        want_refs = {tuple(f) for f in bucket_corpus(300)} \
            | {tuple(f.split("/")) for f in filters}
        deadline = time.monotonic() + 30
        while {fw for _mp, fw, node in b.registry._remote_refs
               if node == "A"} != want_refs:
            assert time.monotonic() < deadline, "replication timed out"
            await asyncio.sleep(0.05)
        TM.launches = 0
        rows = views[1].fold_batch("", [t.split("/") for t in topics])
        fold_launches = TM.launches
        trie = a.registry.trie("")
        fold = [("A" in {k for _f, k, _o in r},
                 any(isinstance(k, tuple) for _f, k, _o in
                     trie.match(t.split("/"))))
                for t, r in zip(topics, rows)]
        pub = MQTTClient(sb.host, sb.port, "pub")
        await pub.connect()
        for i, t in enumerate(topics):
            await pub.publish(t, b"%d" % i, qos=i % 2)
        want = sorted((t, b"%d" % i) for i, t in enumerate(topics)
                      for _f, key, _o in trie.match(t.split("/"))
                      if key == ("", "sub"))
        got = []
        while len(got) < len(want):
            f = await sub.recv(10.0)
            got.append((f.topic, bytes(f.payload)))
        host = []
        for n, m in zip((a, b), ms):
            col = n.batch_collector()
            host.append({k: getattr(col, k) for k in dir(col)
                         if k.endswith("_host_pubs")})
            host[-1].update(host_fallbacks=m.host_fallbacks,
                            device_failures=m.device_failures)
        await sub.disconnect()
        await pub.disconnect()
        return (fold, fold_launches, sorted(got), want, host,
                [m.match_publishes for m in ms],
                [m.table.bucketed for m in ms])
    finally:
        for n, s in ((b, sb), (a, sa)):
            await n.cluster.stop()
            await n.stop()
            await s.stop()


@pytest.mark.cuda
def test_two_nodes_on_the_card_match_the_peer_pointer_rows():
    """Two port nodes on the card (the multi-node plane): node A's
    subscriptions reach node B's GPU table as node-pointer rows through
    the SWC store and the view's delta path; B's tile kernel matches them
    (a fold on B returns A's pointer for every topic one of A's
    subscriptions matches), and a publish on B reaches A's subscriber
    exactly, with no publish served off the card on either node."""
    import asyncio

    _card()
    filters = ["r1/+/m2", "+/d3/m4", "r5/d6/#", "r1/d3/m2"]
    topics = ["r1/d3/m2", "r1/d9/m2", "r7/d3/m4", "r5/d6/m0", "r8/d8/m8"] * 4
    fold, launches, got, want, host, pubs, bucketed = asyncio.run(
        _two_nodes_pointer_rows("cuda", filters, topics))
    assert all(bucketed) and want and got == want
    assert all(pointer == held for pointer, held in fold), fold
    assert any(pointer for pointer, _ in fold)
    # B's device matched every publish; A folds a forwarded publish for
    # its local subscribers on its trie (reg.publish_from_remote, as the
    # reference does, vmq_cluster_com.erl:153-157)
    assert launches > 0 and pubs[1] >= len(topics) and pubs[0] == 0
    assert not any(v for h in host for v in h.values()), host


def _cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


# (label, N, L, id bits, lc, tiles, TP, seg, ragged): probe windows of 512
# and 16,384 rows, 24-bit ids, a dense window of the whole table with
# lc < L, tiles of 64 and 256 slots, lc = 1 and 16 at L = 16, a table of
# no whole number of 256-row chunks with windows off the chunk grid, rows
# of L = 10 words (no 16-byte loads) under the lc 12 template, and lc = 20
# under the lc 24 template
REVERSE_SHAPES = [
    ("probe seg=512 lc=3", 1 << 14, 8, 16, 3, 40, 32, 512, False),
    ("probe seg=16384 24-bit", 1 << 16, 8, 24, 8, 6, 32, 16384, False),
    ("dense lc<L", 1 << 16, 16, 16, 5, 2, 32, 1 << 16, False),
    ("TP=64 lc=1 L=16", 1 << 15, 16, 16, 1, 12, 64, 4096, False),
    ("TP=256 lc=16 L=16", 1 << 15, 16, 16, 16, 1, 256, 1 << 15, False),
    ("ragged", (1 << 15) - 100, 8, 16, 3, 6, 96, 4096, True),
    ("L=10 lc=9", 1 << 14, 10, 16, 9, 8, 64, 2048, False),
    ("lc=20 L=24 TP=256", 1 << 14, 24, 24, 20, 2, 256, 4096, False),
]


def _reverse_operands(seed, N, L, bits, lc, T, TP, seg, ragged=False,
                      B=256):
    """Kernel operands on the card (~10% empty slots) and the host
    starts; with ``ragged`` the first two windows start at 777 and at
    N - seg."""
    (rw, rl, rd, ra), (qw, qe, qh, qf) = reverse_inputs(seed, N, L, B,
                                                        bits=bits, lc=lc)
    rng = np.random.default_rng(T)
    sel = rng.integers(0, B, (T, TP)).astype(np.int32)
    sel[rng.random((T, TP)) < 0.1] = -1
    start = rng.integers(0, N - seg + 1, T).astype(np.int32)
    if ragged:
        start[:2] = [777, N - seg]
    return (_cuda(rw), _cuda(TR.pack_row_meta(rl, rd, ra)), _cuda(qw),
            _cuda(qe), TR.query_flags(_cuda(qh), _cuda(qf)), _cuda(sel),
            _cuda(start)), start


@pytest.mark.cuda
@pytest.mark.parametrize("label,N,L,bits,lc,T,TP,seg,ragged", REVERSE_SHAPES,
                         ids=[r[0] for r in REVERSE_SHAPES])
def test_reverse_kernel_matches_plain_version(label, N, L, bits, lc, T, TP,
                                              seg, ragged):
    """The reverse-compare kernel equals its plain version bit for bit,
    packed words and chunk counts ($-topics, inactive rows, unknown words,
    pad levels and empty slots included), launches once and waits for
    nothing on the host."""
    _card()
    x, start = _reverse_operands(T + seg, N, L, bits, lc, T, TP, seg, ragged)
    RT.reverse_tiles_packed(*x, seg=seg, lc=lc, start_host=start)  # build
    before = RT.launches
    torch.cuda.set_sync_debug_mode("error")  # a device→host copy raises
    try:
        got = RT.reverse_tiles_packed(*x, seg=seg, lc=lc, start_host=start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = RT.reverse_tiles_packed_ref(*x, seg=seg, lc=lc)
    torch.cuda.synchronize()
    assert RT.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum()) > 100  # not vacuous
    assert not want[0][(x[5] < 0).reshape(-1)].any()  # empty slots


@pytest.mark.cuda
def test_reverse_kernel_rejects_what_it_cannot_take():
    _card()
    (rw, rl, rd, ra), (qw, qe, qh, qf) = reverse_inputs(1, 4096, 8, 64)
    x = [_cuda(rw), _cuda(TR.pack_row_meta(rl, rd, ra)), _cuda(qw),
         _cuda(qe), TR.query_flags(_cuda(qh), _cuda(qf)),
         _cuda(np.zeros((1, 32), np.int32)), _cuda(np.zeros(1, np.int32))]
    ok = dict(seg=512, lc=4, start_host=np.zeros(1, np.int32))
    with pytest.raises(TM.KernelInputError, match="leave the table"):
        RT.reverse_tiles_packed(*x, **{**ok, "start_host": [4000]})
    with pytest.raises(TM.KernelInputError, match="seg"):
        RT.reverse_tiles_packed(*x, **{**ok, "seg": 320})  # not 256-whole
    for tp in (16, 48, 288):  # not a multiple of 32, or above 256
        bad = list(x)
        bad[5] = _cuda(np.zeros((1, tp), np.int32))
        with pytest.raises(TM.KernelInputError, match="TP"):
            RT.reverse_tiles_packed(*bad, **ok)
    bad = list(x)
    bad[0] = x[0].long()
    with pytest.raises(TM.KernelInputError, match="int32"):
        RT.reverse_tiles_packed(*bad, **ok)


def _extract_operands(seed, R0=96, nchunks=40):
    """A packed mask of R0 rows of nchunks 256-row chunks: rows at several
    densities (some far past any k), empty rows, a row whose only match is
    its last bit, a row of only its last chunk; its chunk counts."""
    rng = np.random.default_rng(seed)
    m = rng.random((R0, nchunks * 256)) < rng.choice(
        [0.0005, 0.01, 0.2, 0.7], (R0, 1))
    m[0] = False
    m[1] = False
    m[1, -1] = True
    m[2] = False
    m[2, -256:] = True
    bits = (m.reshape(R0, -1, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(axis=2)
    packed = _cuda(bits.astype(np.uint32).view(np.int32))
    return packed, RT.chunk_counts(packed), m


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 256])
def test_extraction_kernel_matches_plain_version(k):
    """The extraction kernel equals its plain version (count, validity, the
    ids where valid; 0 past the count) on selected, repeated and dead rows,
    launches once and waits for nothing on the host."""
    _card()
    packed, counts, m = _extract_operands(k)
    rng = np.random.default_rng(k)
    rows = _cuda(np.concatenate([[0, 1, 2, 1], rng.integers(
        0, len(m), 300)]).astype(np.int32))
    ok = _cuda(rng.random(rows.shape[0]) < 0.9)
    RT.extract_chunks(packed, counts, k, rows=rows, ok=ok)  # build
    before = EX.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        gi, gv, gc = RT.extract_chunks(packed, counts, k, rows=rows, ok=ok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wi, wv, wc = RT.extract_chunks_ref(packed, counts, k, rows=rows, ok=ok)
    torch.cuda.synchronize()
    assert EX.launches == before + 1
    assert torch.equal(gc, wc) and torch.equal(gv, wv)
    assert torch.equal(gi[gv], wi[wv]) and not gi[~gv].any()
    r, o = rows.cpu().numpy(), ok.cpu().numpy()
    for i in (1, 2, 3, 7):
        want = np.nonzero(m[r[i]])[0][:k] if o[i] else []
        np.testing.assert_array_equal(gi[i][gv[i]].cpu().numpy(), want)
    assert (gc > k).any() and gv.sum() > 1000


@pytest.mark.cuda
def test_extraction_kernel_rejects_what_it_cannot_take():
    _card()
    packed, counts, _ = _extract_operands(1, R0=8, nchunks=4)
    rows = _cuda(np.arange(8, dtype=np.int32))
    ok = _cuda(np.ones(8, bool))
    with pytest.raises(TM.KernelInputError, match="int32"):
        RT.extract_chunks(packed, counts, 8, rows=rows.long(), ok=ok)
    with pytest.raises(TM.KernelInputError, match="bool"):
        RT.extract_chunks(packed, counts, 8, rows=rows, ok=ok.int())
    with pytest.raises(TM.KernelInputError, match="chunks of the packed"):
        RT.extract_chunks(packed, counts[:, :3], 8, rows=rows, ok=ok)


# (label, R0, W, k, with counts, R): the headline's forward probes A / B
# and dense region 0 (rows cut, widths kept; probe A split over warps and
# one warp a row), the retained dense (4,136 chunks a row) and probe
# launches, then the edges — a row too long to split, ragged widths (a last
# chunk under 8 words), one row, k = 1
EXTRACT_SHAPES = [
    ("probe A", 96, 8192, 256, False, 300),
    ("probe A, one warp a row", 96, 8192, 256, False, 2100),
    ("long row", 8, 16384, 256, False, 8),
    ("probe B", 256, 1024, 256, False, 300),
    ("dense region 0", 512, 64, 256, False, None),
    ("retained dense", 24, 4136 * 8, 256, True, 24),
    ("retained probe", 256, 64, 64, True, 300),
    ("ragged", 40, 61, 16, False, 50),
    ("ragged, one word", 8, 1, 8, False, 8),
    ("one row", 4, 8192, 256, False, 1),
    ("one row, counts", 4, 8192, 256, True, 1),
    ("k = 1", 64, 1024, 1, False, 64),
    ("k = 1, counts", 64, 1024, 1, True, 64),
]


def _extract_case(seed, R0, W, R):
    """A packed mask of R0 rows at mixed densities with an empty row and an
    all-ones row, and R selected rows (repeats, out of order, the two edge
    rows first) with about a tenth of them dead; None selects every row."""
    rng = np.random.default_rng(seed)
    dens = rng.choice([0.0, 0.0005, 0.01, 0.3, 1.0], R0)
    keep = rng.random((R0, W * 32)) < dens[:, None]
    words = (keep.reshape(R0, W, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(axis=2)
    words[0] = 0
    words[-1] = 0xFFFFFFFF
    packed = _cuda(words.astype(np.uint32).view(np.int32))
    if R is None:
        return packed, None, None
    rows = rng.integers(0, R0, R).astype(np.int32)
    rows[:2] = [R0 - 1, 0][:R]
    ok = rng.random(R) < 0.9
    ok[:2] = True
    return packed, _cuda(rows), _cuda(ok)


@pytest.mark.cuda
@pytest.mark.parametrize("label,R0,W,k,with_counts,R", EXTRACT_SHAPES,
                         ids=[e[0] for e in EXTRACT_SHAPES])
def test_extract_kernel_matches_plain_version(label, R0, W, k, with_counts,
                                              R):
    """The extraction kernel equals its plain version bit for bit (idx,
    0 past the count, valid, count), launches once and waits for nothing
    on the host."""
    _card()
    packed, rows, ok = _extract_case(len(label), R0, W, R)
    counts = RT.chunk_counts(packed) if with_counts else None
    kw = dict(rows=rows, ok=ok, counts=counts)
    EX.extract_rows(packed, k, **kw)  # build
    before = EX.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = EX.extract_rows(packed, k, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = EX.extract_rows_ref(packed, k, **kw)
    torch.cuda.synchronize()
    assert EX.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), label
    count = got[2]
    assert (count > k).any() and (R == 1 or (count == 0).any())


@pytest.mark.cuda
def test_extract_rows_rejects_what_it_cannot_take():
    _card()
    packed, rows, ok = _extract_case(3, 16, 64, 16)
    with pytest.raises(TM.KernelInputError, match="contiguous 2-D int32"):
        EX.extract_rows(packed.t(), 8, rows=rows, ok=ok)
    with pytest.raises(TM.KernelInputError, match="rows must be"):
        EX.extract_rows(packed, 8, rows=rows.cpu(), ok=ok)
    with pytest.raises(TM.KernelInputError, match="one length"):
        EX.extract_rows(packed, 8, rows=rows, ok=ok[:3])
    with pytest.raises(TM.KernelInputError, match="k > 0"):
        EX.extract_rows(packed, 0, rows=rows, ok=ok)
    with pytest.raises(TM.KernelInputError, match="chunks of the packed"):
        EX.extract_rows(packed[:, :60].contiguous(), 8,
                        counts=RT.chunk_counts(packed))


@pytest.mark.cuda
def test_windowed_flat_on_card_equals_the_plain_extraction(monkeypatch):
    """The forward device path (dense region 0, probes A and B, flat
    compaction) through the extraction kernel equals, element for
    element, the same call with the plain extraction; it launched the
    kernel once per zone."""
    _card()
    m, _, args, statics, table = _many_inputs(K=1, n=256)
    a = args[0]
    host = [_cuda(x) for x in a[:3]] + [int(a[3]), _cuda(a[4]), a[5],
                                        _cuda(a[6]), a[7]] \
        + [_cuda(x) for x in a[8:]]
    before = EX.launches
    got = TK.match_extract_windowed_flat(*table, *host, **statics)
    launched = EX.launches - before
    monkeypatch.setattr(EX, "extract_rows", EX.extract_rows_ref)
    want = TK.match_extract_windowed_flat(*table, *host, **statics)
    assert launched == (3 if statics["seg2_max"] else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 100  # not vacuous


@pytest.mark.cuda
@pytest.mark.parametrize("TP", [32, 64])
def test_reverse_match_on_card_equals_the_plain_path(TP):
    """The whole dispatch (probe tiles, dense tiles, the two-level
    extraction over the kernel's counts) on the card equals the same call
    on the CPU, where the wrapper takes the kernel's plain version; with
    64-slot tiles a quarter of the slots are empty."""
    _card()
    N, L, B, T, seg = 8192, 8, 160, 4, 1024
    (rw, rl, rd, ra), (qw, qe, qh, qf) = reverse_inputs(21, N, L, B, lc=4)
    rng = np.random.default_rng(21)
    order = rng.permutation(B)
    per = 32 if TP == 32 else 24
    t_sel = np.full((T, TP), -1, np.int32)
    t_sel[:, :per] = order[:T * per].reshape(T, per)
    q_tile = np.full(B, -1, np.int32)
    q_pos = np.zeros(B, np.int32)
    q_tile[t_sel[:, :per].ravel()] = np.repeat(np.arange(T), per)
    q_pos[t_sel[:, :per].ravel()] = np.tile(np.arange(per), T)
    t_start = rng.integers(0, N - seg + 1, T).astype(np.int32)
    d_sel = order[T * per:].astype(np.int32)  # 32 or 64 dense slots
    d_valid = np.arange(len(d_sel)) % 5 != 2
    meta = TR.pack_row_meta(rl, rd, ra)
    arrs = (rw, meta, qw, qe, qh, qf, t_sel)
    tail = (q_tile, q_pos, d_sel, d_valid)
    cpu = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    want = TR.reverse_match(*map(cpu, arrs), t_start, *map(cpu, tail),
                            k=64, seg=seg, lc=4)
    before, ex_before = RT.launches, EX.launches
    got = TR.reverse_match(*map(_cuda, arrs), t_start, *map(_cuda, tail),
                           k=64, seg=seg, lc=4)
    assert RT.launches == before + 2  # the probe and the dense phase
    assert EX.launches == ex_before + 2
    got = [g.cpu().numpy() for g in got]
    want = [w.numpy() for w in want]
    for (gi, gv, gc), (wi, wv, wc) in ((got[:3], want[:3]),
                                       (got[3:], want[3:])):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gi[gv], wi[wv])
        assert wv.sum() > 100


@pytest.mark.cuda
def test_kernel_refusal_fails_the_replay_futures():
    """A reverse kernel that refuses its inputs (a retained topic deeper
    than the kernel's 32 compared levels) fails every future of the replay
    flush with KernelError: none is answered by the host walk and the
    breaker hears nothing. Before that the first build warmed the path and
    the card served exact replays."""
    import asyncio

    from vernemq_tpu_torch.broker.retain import RetainStore
    from vernemq_tpu_torch.retained import (RetainedBatchCollector,
                                            RetainedEngine)

    _card()
    store = RetainStore()
    eng = RetainedEngine(store, max_levels=40, device="cuda")
    store._on_dirty = eng.on_retain
    for i in range(64):
        store.insert("", ("k", str(i)), i)
    idx = eng.index("")
    idx.async_rebuild = False
    col = RetainedBatchCollector(eng, store, window_us=500, max_batch=64,
                                 host_threshold=0)

    async def main():
        healthy = await asyncio.gather(
            *[col.submit("", ("k", str(i))) for i in range(8)])
        store.insert("", tuple(f"l{j}" for j in range(33)), "deep")
        bad = await asyncio.gather(
            *[col.submit("", ("k", str(i))) for i in range(8)],
            return_exceptions=True)
        return healthy, bad

    before = RT.launches
    healthy, bad = asyncio.run(main())
    assert idx.warm_ms is not None and RT.launches > before
    assert [[v for _, v in rows] for rows in healthy] == \
        [[i] for i in range(8)]
    assert all(isinstance(b, TM.KernelError) for b in bad), bad
    st = col.stats()
    assert st["retained_replay_device_filters"] == 8
    assert not any(st[f"retained_replay_{k}_filters"] for k in (
        "host", "degraded", "rebuild", "fallback", "stalled", "expired"))
    assert idx.device_failures == 0 and idx.breaker.state_name == "closed"


@pytest.mark.cuda
def test_retained_first_build_warms_without_changing_it():
    """The retained index's first build runs one reverse dispatch on the
    card (all its slots empty): the table on the card still equals the
    host table, the warm-up counted no dispatch and no query, and the
    first real batch equals the store, dense phase included."""
    from vernemq_tpu_torch.broker.retain import RetainStore
    from vernemq_tpu_torch.retained import RetainedIndex

    _card()
    holder = {}
    store = RetainStore(on_dirty=lambda mp, t, v: holder["idx"].on_retain(
        t, v))
    idx = holder["idx"] = RetainedIndex(store, max_levels=8, device="cuda")
    idx.async_rebuild = False
    idx.dense_policy = "device"
    rng = random.Random(3)
    for i in range(3000):
        store.insert("", (f"r{rng.randrange(16)}", f"d{rng.randrange(40)}",
                          f"m{i % 50}"), i)
    before = RT.launches
    with idx.lock:
        idx.sync()
    assert idx.warm_ms is not None and idx.warm_ms > 0
    assert RT.launches == before + 2  # the warm dispatch's two launches
    state = idx._snapshot_locked(copy=True)
    rw, meta = idx._dev
    np.testing.assert_array_equal(rw.cpu().numpy(), state["words"])
    np.testing.assert_array_equal(
        meta.cpu().numpy(), TR.pack_row_meta(state["row_len"],
                                             state["row_dollar"],
                                             state["active"]))
    assert idx.match_dispatches == 0 and idx.match_queries == 0
    filters = [("r3", "+", "m7"), ("r5", "d1", "#"), ("+", "d2", "+"),
               ("#",), ("r9", "#")] * 4
    for f, rows in zip(filters, idx.match_filters(filters)):
        want = store.match_filter("", list(f))
        got = want if rows is None else rows
        assert sorted(got) == sorted(want), f
    assert idx.host_fallback_queries <= 4  # only "#" may pass k


# ------------------------------------------------ the predicate phase


def _pred_tensors(inp, dev):
    t = lambda x: torch.from_numpy(np.array(x)).to(dev)  # noqa: E731
    return ([t(x) for x in inp["table"]], t(inp["acc"]), t(inp["feats"]),
            t(inp["pp"]), t(inp["pr"]), [t(x) for x in inp["agg"]])


def _pred_run(fn, inp, dev, W):
    table, acc, feats, pp, pr, agg = _pred_tensors(inp, dev)
    out = fn(*table, acc, feats, pp, pr, *agg, W=W)
    return [x.cpu().numpy() for x in out]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (40, 24, 4, 600, 300, 16), (300, 2048, 4, 1 << 20, 1 << 18, 8192),
    (3, 5, 2, 1, 1, 1)], ids=["small", "storm", "tiny"])
def test_predicate_kernel_matches_plain(shape):
    """The predicate kernel against its plain version on the same card
    tensors: verdicts bit for bit, count, min and max bit for bit (-0.0
    below +0.0 in both), sums allclose (rtol 1e-5: atomic float adds in
    another order), acc likewise; at the parity tests' shape, at the
    telemetry storm's (2^20 pairs, 2^18 folds into 8192 slots) and at one
    pair and one fold."""
    from _torch_port import predicate_inputs
    from vernemq_tpu_torch.ops import predicate_kernel as PK

    _card()
    W = shape[-1]
    inp = predicate_inputs(7, *shape) if shape[-1] > 1 else \
        predicate_inputs(7, *shape[:-1], 5)
    if W == 1:  # every fold into slot 0 of a one-slot table
        inp["agg"][0][:] = 0
        inp["acc"] = inp["acc"][:1]
    before = PK.launches
    got = _pred_run(PK.predicate_phase, inp, "cuda", W)
    torch.cuda.synchronize()
    assert PK.launches == before + 1
    want = _pred_run(PK.predicate_phase_ref, inp, "cuda", W)
    keep, acc, cnt, sm, mn, mx = got
    np.testing.assert_array_equal(keep, want[0])
    for g, w in ((cnt, want[2]), (mn, want[4]), (mx, want[5]),
                 (acc[:, [0, 2, 3]], want[1][:, [0, 2, 3]])):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    np.testing.assert_allclose(sm, want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(acc[:, 1], want[1][:, 1], rtol=1e-5,
                               atol=1e-5)
    table, _, feats, pp, pr, _ = _pred_tensors(inp, "cuda")
    ek = PK.eval_pairs(*table, feats, pp, pr).cpu().numpy()
    np.testing.assert_array_equal(ek, want[0])


def _pred_check(got, want, label=""):
    """Kernel against plain: verdicts, count, min, max and acc's count /
    min / max bit for bit, sums allclose (atomic float adds in another
    order)."""
    keep, acc, cnt, sm, mn, mx = [x.cpu().numpy() for x in got]
    w = [x.cpu().numpy() for x in want]
    np.testing.assert_array_equal(keep, w[0], err_msg=label)
    for g, x in ((cnt, w[2]), (mn, w[4]), (mx, w[5]),
                 (acc[:, [0, 2, 3]], w[1][:, [0, 2, 3]])):
        np.testing.assert_array_equal(g.view(np.int32), x.view(np.int32),
                                      err_msg=label)
    np.testing.assert_allclose(sm, w[3], rtol=1e-5, atol=1e-5, err_msg=label)
    np.testing.assert_allclose(acc[:, 1], w[1][:, 1], rtol=1e-5, atol=1e-5,
                               err_msg=label)


# (label, NP, B, F, P, A, W, offset of the pair arrays in one int32 block):
# P = 1, 2, 3 (mod 4) with 16-byte aligned arrays and with pair_pred one
# entry off alignment (the kernel's one-pair-at-a-time path), no pair, no
# fold, and a table larger than the kernel stages in shared memory
PRED_EDGES = [
    ("P%4=1", 40, 24, 4, 4097, 300, 16, 0),
    ("P%4=2", 40, 24, 4, 4098, 300, 16, 0),
    ("P%4=3", 40, 24, 4, 4099, 300, 16, 0),
    ("P%4=3-unaligned", 40, 24, 4, 4099, 300, 16, 1),
    ("P=0", 40, 24, 4, 0, 3000, 64, 0),
    ("A=0", 40, 24, 4, 5000, 0, 16, 0),
    ("table>smem", 5000, 64, 6, 1 << 16, 1 << 14, 512, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,NP,B,F,P,A,W,off", PRED_EDGES,
                         ids=[e[0] for e in PRED_EDGES])
def test_predicate_kernel_at_its_edges(label, NP, B, F, P, A, W, off):
    """The redesigned kernel against its plain version where its design
    branches: the four-pair vector path and its scalar tail, misaligned
    pair arrays, an empty pair or fold stream (the merge still writes the
    partials and leaves acc's empty slots as they were), and a predicate
    table read from global memory."""
    from _torch_port import predicate_inputs
    from vernemq_tpu_torch.ops import predicate_kernel as PK

    _card()
    inp = predicate_inputs(11, NP, B, F, max(P, 1), max(A, 1), W)
    table, acc, feats, pp, pr, agg = _pred_tensors(inp, "cuda")
    pp, pr = pp[:P], pr[:P]
    if off:  # pair_pred at an odd entry of one block
        blk = torch.empty(2 * P + off, dtype=torch.int32, device="cuda")
        blk[:P] = pp
        blk[P + off:] = pr
        pp, pr = blk[:P], blk[P + off:]
    agg = [x[:A] for x in agg]
    before = PK.launches
    got = PK.predicate_phase(*table, acc.clone(), feats, pp, pr, *agg, W=W)
    torch.cuda.synchronize()
    assert PK.launches == before + 1
    want = PK.predicate_phase_ref(*table, acc.clone(), feats, pp, pr, *agg,
                                  W=W)
    _pred_check(got, want, label)
    if P:
        assert torch.equal(PK.eval_pairs(*table, feats, pp, pr), want[0])


@pytest.mark.cuda
def test_predicate_count_stays_exact_past_2_to_the_24_folds():
    """2^24 + 3 folds into one slot: past 2^24 folds a dispatch keeps the
    count as an unsigned add (a float count would stop at 2^24), so count,
    min and max still equal the plain version's bit for bit (both round
    the count to float32 once, in the partials and in acc)."""
    from vernemq_tpu_torch.filters.predicate import OP_PAD, OP_TRUE
    from vernemq_tpu_torch.ops import predicate_kernel as PK

    _card()
    A, W = (1 << 24) + 3, 2
    i32 = dict(dtype=torch.int32, device="cuda")
    table = (torch.tensor([OP_PAD, OP_TRUE], **i32), torch.zeros(2, **i32),
             torch.zeros(2, dtype=torch.float32, device="cuda"),
             torch.zeros(2, dtype=torch.float32, device="cuda"),
             torch.zeros(2, **i32), torch.zeros(2, **i32))
    feats = torch.tensor([[1.5], [-2.0]], device="cuda")
    acc = torch.zeros((W, 4), device="cuda")
    acc[:, 2], acc[:, 3] = float("inf"), float("-inf")
    pub = (torch.arange(A, **i32) % 2)
    agg = (torch.zeros(A, **i32), pub, torch.full((A,), -1, **i32),
           torch.ones(A, **i32), torch.ones(A, dtype=torch.bool,
                                            device="cuda"))
    agg[2][:5] = 0  # a few folds of the value itself, the rest $COUNT
    none = torch.zeros(0, **i32)
    got = PK.predicate_phase(*table, acc.clone(), feats, none, none, *agg,
                             W=W)
    want = PK.predicate_phase_ref(*table, acc.clone(), feats, none, none,
                                  *agg, W=W)
    _pred_check(got, want, "wide")
    # float32 partials round A once; a float count would stop at 2^24
    assert float(got[2][0]) == float(np.float32(A)) > float(1 << 24)


@pytest.mark.cuda
def test_predicate_dispatches_in_a_row_share_one_zeroed_scratch():
    """Several dispatches in a row on one held scratch, each against a
    fresh plain run on its own acc: the scratch is made once, zero again
    after every dispatch, and every dispatch's partials and acc are
    right (a slot left folded would add to the next dispatch's)."""
    from _torch_port import predicate_inputs
    from vernemq_tpu_torch.ops import predicate_kernel as PK

    _card()
    PK.drop_scratch()
    W = 8192
    for i in range(4):
        inp = predicate_inputs(20 + i, 300, 2048, 4, 1 << 18, 1 << 16, W)
        table, acc, feats, pp, pr, agg = _pred_tensors(inp, "cuda")
        got = PK.predicate_phase(*table, acc.clone(), feats, pp, pr, *agg,
                                 W=W)
        want = PK.predicate_phase_ref(*table, acc.clone(), feats, pp, pr,
                                      *agg, W=W)
        _pred_check(got, want, f"dispatch {i}")
        held = list(PK._scratch.values())
        assert len(held) == 1 and not bool(held[0].any())
        if i == 0:
            first = held[0]
        assert held[0] is first


@pytest.mark.cuda
def test_predicate_dispatch_after_a_failure_runs_on_a_fresh_scratch():
    """An engine dispatch that fails after a half-folded dispatch (the
    held scratch dirtied by hand, as a launch that stopped part way would
    leave it) drops the scratch with the device acc; the next dispatch
    makes a zeroed one and equals the host evaluator."""
    from vernemq_tpu_torch.cluster.metadata import MetadataStore
    from vernemq_tpu_torch.filters.engine import FilterEngine
    from vernemq_tpu_torch.filters.schema_registry import SchemaRegistry
    from vernemq_tpu_torch.ops import predicate_kernel as PK
    from vernemq_tpu_torch.protocol.types import SubOpts
    from vernemq_tpu_torch.robustness import faults

    _card()
    reg = SchemaRegistry(MetadataStore("n1"), "n1")
    reg.set_schema("", "s/#", "v:number")
    eng = FilterEngine(reg, device_gate=lambda: True, host_threshold=1,
                       device="cuda")
    rows = []
    for key, expr in (("c", "$gt(v,50)"), ("a", "$avg(v,2)"),
                      ("m", "$max(v,3)")):
        o = SubOpts()
        o.filter_expr = expr
        eng.on_sub_delta("add", "", o)
        rows.append((("s", "#"), ("", key), o))
    items = [(("s", "x"), eng.encode("", ("s", "x"), b'{"v": %d}' % v))
             for v in (10, 90, 55, 70)]

    def batch():
        return [[r[1] for r in x] for x in eng.filter_batch(
            "", items, [list(rows) for _ in items])]

    PK.drop_scratch()
    batch()
    W = eng._win.cap
    (held,) = [v for k, v in PK._scratch.items() if k[2] == W]
    held.fill_(12345)  # half folded
    faults.install(faults.FaultPlan(
        [faults.FaultRule("device.predicate", kind="error")]))
    try:
        batch()  # fails on the device, served by the host evaluator
    finally:
        faults.clear()
    assert not PK._scratch and eng._win.dev is None
    d0 = eng.dispatches
    got = batch()
    assert eng.dispatches == d0 + 1
    assert got == [[r[1] for r in x] for x in eng.filter_batch_host(
        "", items, [list(rows) for _ in items])]
    (fresh,) = [v for k, v in PK._scratch.items() if k[2] == W]
    torch.cuda.synchronize()
    assert fresh is not held and not bool(fresh.any())


PRED_FAULT_SCRIPT = r"""
import json, torch
from vernemq_tpu_torch.cluster.metadata import MetadataStore
from vernemq_tpu_torch.filters.engine import FilterEngine
from vernemq_tpu_torch.filters.schema_registry import SchemaRegistry
from vernemq_tpu_torch.ops import _build
from vernemq_tpu_torch.ops import predicate_kernel as PK
from vernemq_tpu_torch.ops.tile_match import KernelError
from vernemq_tpu_torch.protocol.types import SubOpts

reg = SchemaRegistry(MetadataStore("n1"), "n1")
reg.set_schema("", "s/#", "v:number")
eng = FilterEngine(reg, device_gate=lambda: True, host_threshold=1,
                   device="cuda")
o = SubOpts()
o.filter_expr = "$gt(v,50)"
eng.on_sub_delta("add", "", o)
rows = [(("s", "#"), ("", "c"), o)]
items = [(("s", "x"), eng.encode("", ("s", "x"), b'{"v": %d}' % v))
         for v in (10, 90)]
healthy = eng.filter_batch("", items, [list(rows), list(rows)])
# a real fault: one launch with feats in the never-mapped first page
one = torch.ones(1, dtype=torch.int32, device="cuda")
keep = torch.empty(1, dtype=torch.bool, device="cuda")
lib = _build.load("predicate")
t = [x.data_ptr() for x in eng._tables[""].dev]
lib.predicate_phase_launch(*t, 2, 256, 1, 1, one.data_ptr(),
                           one.data_ptr(), keep.data_ptr(), 1, None, None,
                           None, None, None, 0, None, 0, None, None,
                           torch.cuda.current_stream().cuda_stream)
try:
    eng.filter_batch("", items, [list(rows), list(rows)])
    out = "served"
except KernelError as e:
    out = "KernelError"
print(json.dumps(dict(
    healthy=[[r[1] for r in x] for x in healthy], out=out,
    device_failures=eng.device_failures, breaker=eng.breaker.state_name,
    pairs_host=eng.pairs_host, dispatches=eng.dispatches)))
"""


@pytest.mark.cuda
def test_predicate_fault_raises_and_is_not_host_served():
    """A real CUDA fault (a launch reading an unmapped address) is sticky:
    the engine's next dispatch raises KernelError out of filter_batch —
    the host evaluator does not answer it and the breaker hears nothing.
    In a subprocess, because the fault poisons the whole process."""
    _card()
    tests = pathlib.Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-c", PRED_FAULT_SCRIPT], capture_output=True,
        text=True, timeout=600, cwd=tests.parent,
        env={**os.environ, "PYTHONPATH": f"{tests}:{tests.parent}"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["healthy"] == [[], [["", "c"]]], res
    assert res["out"] == "KernelError", res
    assert res["device_failures"] == 0 and res["breaker"] == "closed"
    assert res["pairs_host"] == 0 and res["dispatches"] == 1


@pytest.mark.cuda
def test_predicate_engine_warms_without_changing_it():
    """An engine created on the card builds the kernel and runs one warm
    dispatch on scratch tensors: one launch, and nothing of the engine
    touched (no table, no device acc, every counter 0)."""
    from vernemq_tpu_torch.cluster.metadata import MetadataStore
    from vernemq_tpu_torch.filters.engine import FilterEngine
    from vernemq_tpu_torch.filters.schema_registry import SchemaRegistry
    from vernemq_tpu_torch.ops import predicate_kernel as PK

    _card()
    before = PK.launches
    eng = FilterEngine(SchemaRegistry(MetadataStore("n1"), "n1"),
                       device="cuda")
    assert PK.launches == before + 1
    assert not eng._tables and eng._win.dev is None
    assert eng._win.acc[:, :2].sum() == 0
    assert all(v == 0 for k, v in eng.stats().items()
               if not k.startswith("aggregate_window_capacity"))
