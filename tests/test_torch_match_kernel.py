"""Parity of the port's ops/match_kernel.py with the JAX reference.

Same-seed numpy inputs go through each JAX function and its PyTorch
counterpart on the CPU. Every comparison is exact: all outputs are integers
and the float32 sums are exact integer sums (build_operands' proof).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import EDGE_IDS, UNKNOWN_ID, fill, n, rand_topic, t
from vernemq_tpu.models.tpu_matcher import TpuMatcher
from vernemq_tpu.ops import match_kernel as JK
from vernemq_tpu_torch.ops import match_kernel as TK

# the reference helpers that are not jitted themselves, compiled whole
# (one XLA compile instead of one per eager op)
_extract_ref = jax.jit(JK.extract_indices_packed, static_argnums=(1, 2))
_combine_ref = jax.jit(JK._flat_combine, static_argnums=(1, 2))
_dense_ref = jax.jit(JK._dense_region0,
                     static_argnames=("id_bits", "k", "glob_pad", "gc"))


def _ids(rng, shape, bits, edge_frac=0.3):
    ids = rng.integers(0, 1 << bits, shape, dtype=np.int32)
    edge = rng.random(shape) < edge_frac
    ids[edge] = rng.choice(EDGE_IDS, int(edge.sum()))
    return ids


@pytest.mark.parametrize("bits", [16, 24])
def test_build_operands_parity_and_exact(bits):
    rng = np.random.default_rng(bits)
    S, L, B = 384, 4, 64
    words = _ids(rng, (S, L), bits)
    words[rng.random((S, L)) < 0.15] = TK.PLUS_ID
    eff = rng.integers(0, L + 1, S, dtype=np.int32)
    pubs = _ids(rng, (B, L), bits)
    pubs[rng.random((B, L)) < 0.1] = UNKNOWN_ID
    pubs[:16] = words[:16]  # guaranteed matches
    F_j, t1_j = JK.build_operands(words, eff, bits)
    F_t, t1 = TK.build_operands(t(words), t(eff), bits)
    assert F_t.dtype == torch.bfloat16 and F_t.shape == (5 * L if bits == 16
                                                         else 6 * L, S)
    np.testing.assert_array_equal(n(F_t), n(F_j))
    np.testing.assert_array_equal(n(t1), n(t1_j))
    G_j = JK.build_pub_operand(pubs, bits)
    G_t = TK.build_pub_operand(t(pubs), bits)
    np.testing.assert_array_equal(n(G_t), n(G_j))
    # the coded product is exact: mismatch == 0 iff every concrete level's
    # byte planes agree
    mm = G_t.float() @ F_t.float() + t1
    mask = (1 << bits) - 1
    lvl = np.arange(L)[None, None, :]
    conc = (words[None] != TK.PLUS_ID) & (lvl < eff[None, :, None])
    same = (pubs[:, None, :] & mask) == (words[None] & mask)
    want = np.all(same | ~conc, axis=2)
    np.testing.assert_array_equal((mm == 0).numpy(), want)
    assert want.sum() >= 16


def test_pack_mask_parity():
    rng = np.random.default_rng(3)
    m = rng.random((5, 4096)) < 0.3
    np.testing.assert_array_equal(n(TK._pack_mask(t(m))),
                                  n(JK._pack_mask(jnp.asarray(m))))


@pytest.mark.parametrize("density", [0.0, 0.001, 0.3])
def test_extract_indices_packed_parity(density):
    k = 16  # one shape for every case: the eager reference compiles once
    rng = np.random.default_rng(int(density * 1000))
    m = rng.random((12, 8192)) < density
    packed = np.asarray(JK._pack_mask(jnp.asarray(m)))
    idx_j, valid_j, cnt_j = _extract_ref(packed, k, 2048)
    idx, valid, cnt = TK.extract_indices_packed(t(packed), k)
    np.testing.assert_array_equal(n(cnt), n(cnt_j))
    np.testing.assert_array_equal(n(valid), n(valid_j))
    v = n(valid)
    np.testing.assert_array_equal(n(idx)[v], n(idx_j)[v])
    # and the ids are the set bits, in order
    for r in range(m.shape[0]):
        np.testing.assert_array_equal(n(idx)[r][v[r]], np.nonzero(m[r])[0][:k])


def _rand_table(rng, S, L, vocab):
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < 0.2] = TK.PLUS_ID
    eff = rng.integers(0, L + 1, S, dtype=np.int32)
    hh = rng.random(S) < 0.2
    fw = words[:, 0] == TK.PLUS_ID
    act = rng.random(S) < 0.9
    return words, eff, hh, fw, act


def test_match_mask_and_extract_indices_parity():
    """The unbucketed path: one plain mask + extraction against the
    reference's match_extract (match_extract_mxu computes the same)."""
    rng = np.random.default_rng(7)
    S, L, B, k = 1024, 4, 32, 96
    vocab = np.arange(3, 11, dtype=np.int32)
    table = _rand_table(rng, S, L, vocab)
    pw = rng.choice(vocab, (B, L)).astype(np.int32)
    pl = rng.integers(0, L + 1, B, dtype=np.int32)
    pd = rng.random(B) < 0.2
    m = TK.match_mask_unrolled(*map(t, table), t(pw), t(pl), t(pd))
    np.testing.assert_array_equal(
        n(m), n(JK.match_mask_unrolled(*table, pw, pl, pd)))
    idx, valid, cnt = TK.extract_indices(m, k)
    idx_j, valid_j, cnt_j = JK.match_extract(*table, pw, pl, pd, k=k)
    np.testing.assert_array_equal(n(cnt), n(cnt_j))
    np.testing.assert_array_equal(n(valid), n(valid_j))
    v = n(valid)
    np.testing.assert_array_equal(n(idx)[v], n(idx_j)[v])
    assert (n(cnt) > k).any() and (n(cnt) < k).any()


@pytest.mark.parametrize("C", [4096, 200])
def test_flat_combine_parity(C):
    """Per-part clip at k and flat-capacity overflow (C=200) included."""
    rng = np.random.default_rng(C)
    B, k = 48, 16
    real = np.arange(B) < 40

    def part():
        cnt = rng.integers(0, k + 6, B).astype(np.int32)  # some > k
        idx = rng.integers(0, 10_000, (B, k)).astype(np.int32)
        valid = np.arange(k)[None, :] < cnt[:, None]
        return idx, valid, cnt

    g, a, b = part(), part(), part()
    want = _combine_ref(jnp.asarray(real), k, C,
                            *[tuple(map(jnp.asarray, p)) for p in (g, a, b)])
    got = TK._flat_combine(t(real), k, C,
                           *[tuple(map(t, p)) for p in (g, a, b)])
    for x, y in zip(got, want):
        np.testing.assert_array_equal(n(x), n(y))
    assert n(got[3]).any()  # clipped parts
    assert (n(got[1]) + n(got[2]) > C).any() == (C == 200)  # capacity


@pytest.fixture(scope="module")
def bucketed():
    """A bucketed reference matcher (its device state built) plus a batch
    of topics encoded by it, and the port's tensors of the same table."""
    rng = random.Random(5)
    # 32k rows: enough buckets for the level-1 g-buckets (probe B)
    m = TpuMatcher(max_levels=8, initial_capacity=32768, packed_io=False)
    fill(rng, 4000, m.table)
    for i, f in enumerate((["#"], ["+", "+", "x"], ["$SYS", "#"],
                           ["w1", "w2", "w3", "w4", "w5", "w6", "w7", "w8"])):
        m.table.add(f, f"e{i}", None)
    with m.lock:
        m.sync()
    topics = [rand_topic(rng) for _ in range(70)] + [["$SYS", "x"], ["x"]]
    enc = m._encode_batch_ex(topics)
    tab = m.table
    port = dict(words=t(tab.words), eff=t(tab.eff_len), hh=t(tab.has_hash),
                fw=t(tab.first_wild), act=t(tab.active))
    port["F_t"], port["t1"] = TK.build_operands(port["words"], port["eff"],
                                                tab.id_bits)
    return m, topics, enc, port


def _port_flat(port, args, statics):
    host = [t(a) for a in args[:3]] + [int(args[3])] + [t(a) for a in args[4:]]
    return TK.match_extract_windowed_flat(
        port["F_t"], port["t1"], port["eff"], port["hh"], port["fw"],
        port["act"], *host, **statics)


def test_windowed_flat_parity(bucketed):
    m, topics, enc, port = bucketed
    S = int(m.table.cap)
    args, statics, left = m._flat_prep(m._reg_start, m._reg_end,
                                       m._glob_pad, m._ops_bits, S, *enc,
                                       len(topics))
    assert statics["seg2_max"] and not left  # both probes, no leftovers
    F_j, t1_j = m._operands
    want = JK.match_extract_windowed_flat(F_j, t1_j, *m._dev_arrays[1:5],
                                          *args, **statics)
    got = _port_flat(port, args, statics)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(n(x), n(y))
    assert int(n(got[2]).sum()) > 100  # the batch really matched rows


def test_dense_region0_parity(bucketed):
    m, topics, enc, port = bucketed
    pw, pl, pd = enc[:3]
    gp = m._glob_pad
    F_j, t1_j = m._operands
    kw = dict(id_bits=m._ops_bits, k=32, glob_pad=gp, gc=64)
    want = _dense_ref(F_j, t1_j, *m._dev_arrays[1:5], pw, pl, pd, **kw)
    got = TK._dense_region0(port["F_t"], port["t1"], port["eff"], port["hh"],
                            port["fw"], port["act"], t(pw), t(pl), t(pd),
                            **kw)
    np.testing.assert_array_equal(n(got[2]), n(want[2]))
    v = n(got[1])
    np.testing.assert_array_equal(v, n(want[1]))
    np.testing.assert_array_equal(n(got[0])[v], n(want[0])[v])
    assert n(got[2]).sum() > 0  # '#' and '+/+/x' live in region 0


@pytest.mark.parametrize("bits", [16, 24])
def test_apply_delta_parity(bits):
    rng = np.random.default_rng(11 + bits)
    S, L, D = 512, 4, 37
    base = _rand_table(rng, S, L, _ids(rng, 8, bits, 0.5))
    new = _rand_table(rng, D, L, _ids(rng, 8, bits, 0.5))
    slots = rng.choice(S, D, replace=False).astype(np.int32)
    F_j, t1_j = JK.build_operands(base[0], base[1], bits)
    packed = JK.delta_pack_args(slots, *new)
    (arr_j, ops_j) = JK.apply_delta_fused_nometa_copy(
        *base, F_j, t1_j, packed, D=D, L=L, id_bits=bits)
    dev = tuple(t(a.copy()) for a in base)
    ops = TK.build_operands(dev[0], dev[1], bits)
    TK.apply_delta_fused_nometa(dev, ops, t(slots).long(), *map(t, new),
                                id_bits=bits)
    for x, y in zip(dev + ops, tuple(arr_j) + tuple(ops_j)):
        np.testing.assert_array_equal(n(x), n(y))
