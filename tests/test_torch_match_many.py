"""The port's match_many — K publish batches from one staged upload to one
download — against the JAX TpuMatcher.match_many and against K match_batch
calls of the port itself, on the CPU (device="cpu"): the staged block is
the reference's flat_pack_args layout, the rows equal the reference's for
K in {2, 4} (mixed batch sizes), K = 1 or an unbucketed table runs
match_batch, and the raw
[K, C + 3B] result equals K single dispatches at one Bpad, element for
element."""

import random

import numpy as np
import pytest
import torch

from _torch_port import bucket_corpus, bucket_topics, norm
from vernemq_tpu.models import tpu_matcher as JM
from vernemq_tpu.ops import match_kernel as JK
from vernemq_tpu_torch.models import matcher as GM
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.ops import match_kernel as TK


def rows_of(batches_rows):
    """Rows in their order, keys as strings (comparable across packages)."""
    return [[[(tuple(f), str(k)) for f, k, _ in rows] for rows in batch]
            for batch in batches_rows]


@pytest.fixture(scope="module")
def pair():
    """The reference and the port over the 3,000-subscription bucketed
    serving corpus, and the trie."""
    kw = dict(max_levels=8, initial_capacity=8192, max_fanout=64)
    ref = JM.TpuMatcher(**kw)
    gpu = GM.GpuMatcher(**kw, device="cpu")
    trie = SubscriptionTrie()
    for i, f in enumerate(bucket_corpus()):
        for t in (ref.table, gpu.table, trie):
            t.add(list(f), i, None)
    assert gpu.table.bucketed and gpu.supports_match_many
    return ref, gpu, trie, random.Random(5)


def _prep(m, topics, Bpad=None):
    """Encode + window-prep one batch on the port's matcher."""
    with m.lock:
        m.sync()
        pw, pl, pd, pb, gb = m._encode_batch_ex(topics)
        layout = m._layout_locked()
    if Bpad is not None:
        pw, pl, pd = GM._pad_pub_block(pw, pl, pd, Bpad)
    S = int(m._operands[0].shape[1])
    return m._flat_prep(layout, S, pw, pl, pd, pb, gb, len(topics))


def test_staged_block_is_the_reference_layout(pair):
    """flat_pack_args equals the reference's element for element; the
    staged [K, P] block holds one such vector per batch, and its device
    views are the prep arguments again."""
    _, gpu, _, rng = pair
    preps = [_prep(gpu, bucket_topics(rng, n), Bpad=16)[0]
             for n in (16, 5)]
    for args in preps:
        np.testing.assert_array_equal(TK.flat_pack_args(args),
                                      np.asarray(JK.flat_pack_args(args)))
    staged = TK.stage_many(preps, "cpu")
    assert staged.dtype == torch.int32 and staged.shape[0] == 2
    geom = TK._packed_geometry(preps[0])
    assert geom == JK._packed_geometry(preps[0])
    for row, args in zip(staged, preps):
        np.testing.assert_array_equal(row.numpy(), TK.flat_pack_args(args))
        views = TK._unpack_transport(row, **geom)
        for v, a in zip(views, args):
            if v.dtype != torch.bool:  # pub_dollar is converted
                assert v.untyped_storage().data_ptr() == \
                    staged.untyped_storage().data_ptr()
            np.testing.assert_array_equal(v.numpy(), np.asarray(a))


@pytest.mark.parametrize("sizes", [(16, 16), (5, 16, 9, 16)],
                         ids=["K2", "K4-mixed"])
def test_match_many_matches_reference(pair, sizes):
    """Same corpus and batches: the port's match_many rows equal the
    reference's, in order, and the trie's; one K-batch dispatch each."""
    ref, gpu, trie, rng = pair
    batches = [bucket_topics(rng, n) for n in sizes]
    before = (ref.super_dispatches, gpu.super_dispatches)
    got = gpu.match_many(batches)
    want = ref.match_many(batches)
    assert rows_of(got) == rows_of(want)
    for topics, rows in zip(batches, got):
        for t, r in zip(topics, rows):
            assert norm(r) == norm(trie.match(list(t))), t
    assert (ref.super_dispatches, gpu.super_dispatches) == \
        (before[0] + 1, before[1] + 1)
    assert gpu.host_fallbacks == ref.host_fallbacks == 0


@pytest.mark.parametrize("k,bucketed", [(1, True), (2, False)],
                         ids=["K1", "unbucketed"])
def test_match_many_sequential_fallback(pair, k, bucketed):
    """K == 1, or an unbucketed table, runs match_batch per batch: no
    K-batch dispatch, the reference's rows."""
    ref, gpu, _, rng = pair
    if not bucketed:  # a table too small to bucket
        kw = dict(max_levels=8, initial_capacity=1024, max_fanout=64)
        ref, gpu = JM.TpuMatcher(**kw), GM.GpuMatcher(**kw, device="cpu")
        for i, f in enumerate(bucket_corpus(200)):
            for m in (ref, gpu):
                m.table.add(list(f), i, None)
        assert not gpu.table.bucketed and not gpu.supports_match_many
    batches = [bucket_topics(rng, 16) for _ in range(k)]
    before = (ref.super_dispatches, gpu.super_dispatches)
    got, want = gpu.match_many(batches), ref.match_many(batches)
    assert rows_of(got) == rows_of(want)
    assert sum(map(len, (r for b in got for r in b))) > 0  # not vacuous
    assert (ref.super_dispatches, gpu.super_dispatches) == before


def test_match_many_bit_identical_to_match_batch(pair):
    """The [K, C + 3B] result equals K single dispatches at the same Bpad
    element for element, and match_many's rows equal K match_batch calls
    (same Bpad) in order."""
    _, gpu, _, rng = pair
    batches = [bucket_topics(rng, n) for n in (16, 11)]
    preps = [_prep(gpu, b, Bpad=16) for b in batches]
    statics = preps[0][1]
    assert all(p[1] == statics for p in preps)  # one geometry
    args = [p[0] for p in preps]
    F_t, t1 = gpu._operands
    stacked = TK.call_match_many(F_t, t1, *gpu._dev_arrays[1:], args,
                                 statics)
    C, B = statics["C"], 16
    assert stacked.shape == (2, C + 3 * B) and stacked.dtype == np.int32
    for row, a in zip(stacked, args):
        single = gpu._dispatch_flat(gpu._dev_arrays, gpu._operands, a,
                                    statics)
        np.testing.assert_array_equal(row, single)
    assert int(stacked[:, C + B:C + 2 * B].sum()) > 50  # rows matched
    same = [bucket_topics(rng, 16) for _ in range(2)]
    assert rows_of(gpu.match_many(same)) == \
        rows_of([gpu.match_batch(b) for b in same])
