"""The port's operator tools (vernemq_tpu_torch/tools/) and the kernel-
resident scan probe they stand on, on the CPU (device="cpu"), against the
JAX package where it has the same function:

- ``match_packed_scan``: K = 3 windows, each package's own prep and
  staging, equal (chk, tot) to the reference's ``match_packed_scan``;
  and on result rows whose sums pass 2^31, both accumulations wrap alike;
- the roofline's geometry equal to the reference's ``window_params`` on
  the same table, and its tile bound equal to chip_smoke's;
- a short paced collector-latency run whose every publish's rows are the
  trie's;
- an in-process load test over MQTT whose deliveries are the trie's.

The matcher cases share the serving corpus of ``_torch_port`` (capacity
8192, batches of 16) so JAX compiles each shape once."""

import asyncio
import random

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port import bucket_corpus, bucket_topics
from vernemq_tpu.models import tpu_matcher as JM
from vernemq_tpu.models.tpu_table import SubscriptionTable as JTable
from vernemq_tpu.ops import match_kernel as JK
from vernemq_tpu_torch.models import matcher as GM
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.ops import match_kernel as TK
from vernemq_tpu_torch.tools import collector_latency as CL
from vernemq_tpu_torch.tools import corpus as CO
from vernemq_tpu_torch.tools import loadtest as LT
from vernemq_tpu_torch.tools import roofline as RF

KW = dict(max_levels=8, initial_capacity=8192, max_fanout=64)


@pytest.fixture(scope="module")
def pair():
    """The reference and the port over the bucketed serving corpus."""
    ref = JM.TpuMatcher(**KW)
    gpu = GM.GpuMatcher(**KW, device="cpu")
    for i, f in enumerate(bucket_corpus()):
        for t in (ref.table, gpu.table):
            t.add(list(f), i, None)
    with ref.lock:
        ref.sync()
    with gpu.lock:
        gpu.sync()
    assert gpu.table.bucketed and ref.packed_io and ref._meta is not None
    return ref, gpu


def _ref_preps(m, batches, Bpad):
    """The reference's own encode and window prep of each batch."""
    S = int(m._dev_arrays[0].shape[0])
    out = []
    for topics in batches:
        with m.lock:
            pw, pl, pd, pb, gb = m._encode_batch_ex(topics)
        pw, pl, pd = JM._pad_pub_block(pw, pl, pd, Bpad)
        out.append(m._flat_prep(m._reg_start, m._reg_end, m._glob_pad,
                                m._ops_bits, S, pw, pl, pd, pb, gb,
                                len(topics))[:2])
    return [a for a, _ in out], out[0][1]


def _ref_scan(m, preps, statics, stack=None):
    stack = np.stack([JK.flat_pack_args(a) for a in preps]) \
        if stack is None else stack
    F_t, t1 = m._operands
    chk, tot = JK.match_packed_scan(F_t, t1, m._meta, stack,
                                    **JK._packed_geometry(preps[0]),
                                    **statics)
    return int(chk), int(tot)


def test_packed_scan_matches_reference(pair):
    """K = 3 windows: the port's match_packed_scan (the plain loop on the
    CPU) returns the reference's (chk, tot), and its rows are K single
    dispatches' element for element."""
    ref, gpu = pair
    rng = random.Random(11)
    batches = [bucket_topics(rng, n) for n in (16, 9, 16)]
    r_preps, r_statics = _ref_preps(ref, batches, 16)
    g_preps, g_statics, _ = zip(*(CO.prep_batch(gpu, b, Bpad=16)
                                  for b in batches))
    assert g_statics[0] == r_statics
    staged = TK.stage_many(g_preps, "cpu")
    head = (*gpu._operands, *gpu._dev_arrays[1:])
    got = TK.match_packed_scan(*head, staged, g_preps, g_statics[0])
    assert got == _ref_scan(ref, r_preps, r_statics)
    assert got[1] > 20  # rows matched: not vacuous
    scan = TK.PackedScan(*head, staged, g_preps, g_statics[0])
    assert scan.graph is None and scan.result() == got
    for row, args in zip(scan.rows.numpy(), g_preps):
        np.testing.assert_array_equal(
            row, gpu._dispatch_flat(gpu._dev_arrays, gpu._operands, args,
                                    g_statics[0]))


def test_packed_scan_sums_wrap_like_the_reference(pair, monkeypatch):
    """Result rows whose flat entries and totals sum past 2^31 (both
    packages' per-window results replaced by the same staged rows): the
    port's int64 sums folded to int32 equal the reference's int32
    lax.scan accumulation, wrap-around included."""
    ref, gpu = pair
    rng = random.Random(12)
    batches = [bucket_topics(rng, 16) for _ in range(3)]
    preps, _ = _ref_preps(ref, batches, 16)
    B, C = 16, 40  # C unlike any real geometry's: a fresh JAX trace
    statics = dict(id_bits=16, k=8, glob_pad=0, seg_max=256, seg2_max=0,
                   gc=16, C=C)
    big = np.random.default_rng(3).integers(
        2**30, 2**31 - 1, (3, C + 3 * B + 5), dtype=np.int64)
    big = big.astype(np.int32)
    assert big[:, :C].astype(np.int64).sum() > 2**32
    monkeypatch.setattr(JK, "_packed_core",
                        lambda F_t, t1, meta, p, **kw: p[:C + 3 * B])
    monkeypatch.setattr(TK, "match_many_staged",
                        lambda *a: a[6][:, :C + 3 * B])
    want = _ref_scan(ref, preps, statics, stack=big)
    got = TK.match_packed_scan(*gpu._operands, *gpu._dev_arrays[1:],
                               torch.from_numpy(big), preps, statics)
    assert got == want
    exact = (int(big[:, :C].astype(np.int64).sum()),
             int(big[:, C + B:C + 2 * B].astype(np.int64).sum()))
    assert got != exact and all(-2**31 <= v < 2**31 for v in got)


def test_roofline_geometry_and_bound():
    """On a 20,000-subscription corpus the roofline's geometry is the
    reference's window_params on the same table (T, seg_max, gc, T2,
    seg2), and its tile bound is chip_smoke's probe_bound."""
    subs = 20_000
    m, pools, rng = CO.headline_matcher(subs, device="cpu", build=False)
    jt = JTable(max_levels=8, initial_capacity=1 << (subs - 1).bit_length())
    CO.build_corpus(random.Random(42), subs,
                    lambda f, i: jt.add(f, i, None))
    out = RF.analytic(m, pools, rng, 256, 1.0)
    g = out["geometry"]
    S, glob, ng = jt.cap, int(jt.reg_cap[0]), jt.NG
    reg_end = jt.reg_start + jt.reg_cap
    amax = int((reg_end[1 + ng:] - jt.reg_start[1 + ng:]).max())
    want = JM.window_params(S, glob, amax, 256, zone=S - jt.gb_end)
    gmax = int((reg_end[1:1 + ng] - jt.reg_start[1:1 + ng]).max())
    want2 = JM.window_params(S, glob, gmax, 256, zone=jt.gb_end - glob)
    assert ng and (g["S"], g["glob_pad"], g["gb_end"]) == \
        (S, glob, jt.gb_end)
    assert (g["T"], g["seg_max"], g["gc"]) == want
    assert (g["T2"], g["seg2"]) == want2[:2]
    args, statics, _ = CO.prep_batch(
        m, CO.zipf_topics(random.Random(5), pools, 256),
        layout=CO.table_layout(m))
    T, TP = args[4].shape
    inputs = (torch.zeros((g["K"], 8)), None, None, None,
              torch.zeros((T, TP, g["K"])), None, None,
              torch.from_numpy(args[5]))
    assert RF.tile_bound(g["K"], T, TP, args[5], g["seg_max"]) == \
        chip_smoke.probe_bound(inputs, g["seg_max"])
    assert out["bound_ms"]["total"] > 0 and out["ceiling_pubs_per_sec"] > 0


def test_collector_latency_rows_equal_the_trie(pair):
    """Two short paced rates through the port's collector over the
    serving corpus: every publish's rows are the trie's, all served on
    the device."""
    _, gpu = pair
    trie = SubscriptionTrie()
    for e in gpu.table.entries:
        if e is not None:
            trie.add(list(e[0]), e[1], e[2])
    view = CL.serving_view(gpu, trie)
    rng = random.Random(13)

    async def run():
        return await CL.ladder(view, gpu, trie,
                               lambda n: bucket_topics(rng, n), [200, 800],
                               0.4, window_us=500, max_batch=64)

    rows = asyncio.run(run())
    for r in rows:
        assert r["checked"] >= 0.3 * r["rate_pubs_per_sec"] * 0.4, r
        assert r["mismatched"] == r["failed"] == 0, r
        assert r["host_served_pubs"] == 0, r
        assert r["served_device_pubs"] == r["checked"], r


def test_loadtest_deliveries_equal_the_trie():
    """One in-process run of the load test on the CPU broker's GPU view:
    every subscriber's deliveries equal the trie's for what was
    published."""
    out = LT.main(["--device", "cpu", "--subs", "8", "--pubs", "2",
                   "--secs", "0.8", "--rate", "150", "--qos", "1",
                   "--drain-s", "0.3"])
    assert out["sent"] > 100 and out["failed"] == 0
    assert out["received"] == out["expected"] > 0
    assert out["mismatched_subscribers"] == 0 and out["ok"]
    assert out["collector"]["device_pubs"] > 0
