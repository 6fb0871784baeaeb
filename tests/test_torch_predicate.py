"""The payload-predicate phase of the port (``vernemq_tpu_torch/ops/
predicate_kernel.py`` and ``filters/engine.py``'s device path) against the
reference (``vernemq_tpu/ops/predicate_kernel.py`` under JAX on the CPU,
``vernemq_tpu/filters/engine.py``).

- The plain functions: verdicts exact, count/min/max exact, sums allclose
  (rtol 1e-6: float32 sums of at most a few dozen values taken in another
  order), on inputs made from a numpy seed, with the traps of the phase:
  empty segments, ``-0.0`` against ``0.0`` in min and max, ``OP_IN`` codes
  at 31, 32, 63 and 64, a non-integral code and ±inf, pads.
- The engine: ``test_filters.py``'s device cases with the port's engine
  (``device="cpu"``) beside the reference's on the same batches, and the
  port's own rule that a fault of the device code raises ``KernelError``
  instead of being answered by the host evaluator.
"""

import asyncio
import json
import random
import time

import numpy as np
import pytest
import torch

from _torch_port import PREDICATE_SHAPE, predicate_inputs
from vernemq_tpu.cluster.metadata import MetadataStore as RefMetadataStore
from vernemq_tpu.filters.engine import FilterEngine as RefFilterEngine
from vernemq_tpu.filters.schema_registry import \
    SchemaRegistry as RefSchemaRegistry
from vernemq_tpu.ops import predicate_kernel as RPK
from vernemq_tpu.protocol.types import SubOpts as RefSubOpts
from vernemq_tpu_torch.cluster.metadata import MetadataStore
from vernemq_tpu_torch.filters import engine as ENG
from vernemq_tpu_torch.filters.engine import FilterEngine
from vernemq_tpu_torch.filters.predicate import OP_IN, OP_PAD, OP_TRUE
from vernemq_tpu_torch.filters.schema_registry import SchemaRegistry
from vernemq_tpu_torch.ops import predicate_kernel as PK
from vernemq_tpu_torch.ops.tile_match import KernelError
from vernemq_tpu_torch.protocol.types import SubOpts
from vernemq_tpu_torch.robustness import faults
from vernemq_tpu_torch.robustness.faults import FaultPlan, FaultRule

# one shape for every random case, so the JAX side compiles each once
NP, B, F, P, A, W = PREDICATE_SHAPE


def _inputs(seed):
    return predicate_inputs(seed, *PREDICATE_SHAPE)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(inp, fn=PK.predicate_phase_ref):
    acc = _t(inp["acc"])
    out = fn(*map(_t, inp["table"]), acc, _t(inp["feats"]), _t(inp["pp"]),
             _t(inp["pr"]), *map(_t, inp["agg"]), W=W)
    return [np.asarray(x) for x in out]


def _ref(inp):
    out = RPK.predicate_phase(*inp["table"], inp["acc"].copy(),
                              inp["feats"], inp["pp"], inp["pr"],
                              *inp["agg"], W=W)
    return [np.asarray(x) for x in out]


def _same_floats(x, y):
    """Equal as floats (``-0.0 == 0.0``, ``inf == inf``), no NaN."""
    assert not np.isnan(x).any() and not np.isnan(y).any()
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_phase_matches_reference(seed):
    """Verdicts bit for bit; count, min and max exact; sums allclose; the
    updated acc likewise — against the JAX phase on the same inputs."""
    inp = _inputs(seed)
    keep, acc, cnt, sm, mn, mx = _port(inp)
    rk, racc, rcnt, rsm, rmn, rmx = _ref(inp)
    np.testing.assert_array_equal(keep, rk)
    assert keep.any() and not keep.all()
    _same_floats(cnt, rcnt)
    _same_floats(mn, rmn)
    _same_floats(mx, rmx)
    np.testing.assert_allclose(sm, rsm, rtol=1e-6, atol=1e-6)
    for col in (0, 2, 3):
        _same_floats(acc[:, col], racc[:, col])
    np.testing.assert_allclose(acc[:, 1], racc[:, 1], rtol=1e-6, atol=1e-6)
    # the eval-only dispatch gives the same verdicts
    ek = PK.eval_pairs_ref(*map(_t, inp["table"]), _t(inp["feats"]),
                           _t(inp["pp"]), _t(inp["pr"]))
    np.testing.assert_array_equal(ek.numpy(), np.asarray(RPK.eval_pairs(
        *inp["table"], inp["feats"], inp["pp"], inp["pr"])))


def test_empty_segments_keep_acc_bit_for_bit():
    """A slot no fold touched keeps its acc min and max bit for bit (here
    -0.0, which a maximum with the -inf identity would turn into +0.0 under
    a sign-blind merge), and its partials are the identities: count 0, sum
    0, min +inf, max -inf."""
    inp = _inputs(3)
    inp["acc"][W - 4:] = (3.0, 1.25, -0.0, -0.0)
    keep, acc, cnt, sm, mn, mx = _port(inp)
    empty = slice(W - 4, W)
    assert (cnt[empty] == 0).all() and (sm[empty] == 0).all()
    assert np.isposinf(mn[empty]).all() and np.isneginf(mx[empty]).all()
    np.testing.assert_array_equal(acc[empty].view(np.int32),
                                  inp["acc"][empty].view(np.int32))


def test_negative_zero_orders_below_zero_in_min_and_max():
    """The rule for min and max: -0.0 < +0.0 (an integer order over the
    float's bits), in the partials and in the merge with acc. The reference
    compares as floats, where the two are equal: its values agree with
    ours as floats."""
    f32 = np.float32
    table = (np.array([OP_PAD, OP_TRUE], np.int32), np.zeros(2, np.int32),
             np.zeros(2, f32), np.zeros(2, f32), np.zeros(2, np.int32),
             np.zeros(2, np.int32))
    feats = np.array([[0.0], [-0.0]], f32)
    agg = (np.array([0, 0, 1, 1], np.int32), np.array([0, 1, 1, 0], np.int32),
           np.zeros(4, np.int32), np.ones(4, np.int32), np.ones(4, bool))
    acc = np.array([[0, 0, np.inf, -np.inf], [0, 0, 0.0, -0.0]], f32)
    out = PK.predicate_phase_ref(*map(_t, table), _t(acc), _t(feats),
                                 _t(np.zeros(0, np.int32)),
                                 _t(np.zeros(0, np.int32)), *map(_t, agg),
                                 W=2)
    _, acc_p, _, _, mn, mx = [np.asarray(x) for x in out]
    assert np.signbit(mn).all() and not np.signbit(mx).any()
    assert np.signbit(acc_p[:, 2]).all() and not np.signbit(acc_p[:, 3]).any()
    ref = RPK.predicate_phase(*table, acc.copy(), feats,
                              np.zeros(0, np.int32), np.zeros(0, np.int32),
                              *agg, W=2)
    _same_floats(mn, np.asarray(ref[4]))
    _same_floats(mx, np.asarray(ref[5]))


def test_in_codes_at_the_word_edges():
    """OP_IN against masks with bits 31, 32 and 63 set: codes 31, 32, 63
    keep; 64, 2.5, ±inf, -1 and a missing value do not; -0.0 is code 0."""
    f32 = np.float32
    lo = np.int32(-2**31 | 1)          # bits 0 and 31
    hi = np.int32(-2**31 | 1)          # bits 32 and 63
    table = (np.array([OP_PAD, OP_TRUE, OP_IN], np.int32),
             np.zeros(3, np.int32), np.zeros(3, f32), np.zeros(3, f32),
             np.array([0, 0, lo], np.int32), np.array([0, 0, hi], np.int32))
    vals = np.array([31, 32, 63, 64, 2.5, np.inf, -np.inf, -1, np.nan, -0.0,
                     0.0, 1.0], f32)
    want = [True, True, True, False, False, False, False, False, False, True,
            True, False]
    feats = vals[:, None]
    pp = np.arange(len(vals), dtype=np.int32)
    pr = np.full(len(vals), 2, np.int32)
    got = PK.eval_pairs_ref(*map(_t, table), _t(feats), _t(pp), _t(pr))
    assert got.tolist() == want
    assert np.asarray(RPK.eval_pairs(*table, feats, pp, pr)).tolist() == want


def test_pads_are_inert():
    """The pad row keeps no pair, whatever the value, and a fold gated by
    it folds nothing."""
    inp = _inputs(4)
    inp["pr"][:] = 0
    slot, apub, afield, gate, valid = inp["agg"]
    inp["agg"] = (slot, apub, afield, np.zeros_like(gate), np.ones_like(valid))
    keep, acc, cnt, sm, mn, mx = _port(inp)
    assert not keep.any() and not cnt.any()
    np.testing.assert_array_equal(acc[:, 2:].view(np.int32),
                                  inp["acc"][:, 2:].view(np.int32))
    _same_floats(acc[:, :2], inp["acc"][:, :2])


def test_wrappers_take_the_plain_version_on_the_cpu():
    """CPU tensors go to the plain version (no launch counted); a tensor
    on another device type is refused."""
    inp = _inputs(5)
    PK.launches = 0
    a = _port(inp, PK.predicate_phase)
    b = _port(inp)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
    assert PK.launches == 0
    with pytest.raises(KernelError):
        PK.eval_pairs(*map(_t, inp["table"]),
                      _t(inp["feats"]).to("meta"), _t(inp["pp"]),
                      _t(inp["pr"]))


# ------------------------------------------------------------ the engine


_EXPRS = [
    "$gt(value,50)", "$ge(value,50)", "$lt(value,10)", "$le(value,10)",
    "$eq(value,42)", "$ne(value,42)", "$range(value,20,60)",
    "$eq(unit,c)", "$ne(unit,f)", "$in(unit,c,f)", "$in(unit,f)",
    "$exists(value)", "$null(value)", "$exists(ghost)", "$null(ghost)",
    "$gt(ghost,1)",                      # unknown field: never matches
    "$gt(value,10)&$eq(unit,c)",         # conjunction: host escape
    "$range(value,0,100)&$ne(unit,f)",   # conjunction: host escape
]


class Pair:
    """The reference's engine and the port's (``device="cpu"``) over one
    schema, each with its own rows (its own SubOpts class) and emissions."""

    def __init__(self, schema_topic, fields, **kw):
        kw.setdefault("host_threshold", 1)
        kw.setdefault("breaker_backoff_initial", 0.05)
        kw.setdefault("breaker_backoff_max", 0.2)
        self.sides = []
        for md, sr, eng, so, dev in (
                (RefMetadataStore, RefSchemaRegistry, RefFilterEngine,
                 RefSubOpts, {}),
                (MetadataStore, SchemaRegistry, FilterEngine, SubOpts,
                 {"device": "cpu"})):
            reg = sr(md("n1"), "n1")
            reg.set_schema("", schema_topic, fields)
            e = eng(reg, device_gate=lambda: True, **kw, **dev)
            emitted = []
            e.emit = (lambda mp, key, o, t, p, out=emitted:
                      out.append(json.loads(p)))
            self.sides.append((e, so, emitted))
        self.rows = [[], []]

    def sub(self, key, expr, fw):
        for (e, so, _), rows in zip(self.sides, self.rows):
            o = so()
            o.filter_expr = expr
            e.on_sub_delta("add", "", o)
            rows.append((fw, ("", key), o))

    def plain(self, key, fw):
        for (_, so, _), rows in zip(self.sides, self.rows):
            rows.append((fw, ("", key), so()))

    def run(self, topic, payloads, host=False):
        """Both engines over one batch: each side's kept row keys per
        publish (device path, or the host path with ``host``)."""
        out = []
        for (e, _, _), rows in zip(self.sides, self.rows):
            items = [(topic, e.encode("", topic, p)) for p in payloads]
            f = e.filter_batch_host if host else e.filter_batch
            res = f("", items, [list(rows) for _ in payloads])
            out.append([[r[1] for r in o] for o in res])
        return out

    @property
    def port(self):
        return self.sides[1][0]

    @property
    def ref(self):
        return self.sides[0][0]


def test_oracle_parity_random_corpora():
    """Port of test_filters.py::test_oracle_parity_random_corpora: every
    operator, missing fields, non-JSON payloads and conjunction escapes —
    the port's device path == its host path == the reference's device
    path, row for row, on the same batches."""
    rng = random.Random(7)
    pair = Pair("s/+/t", "value:number,unit:enum(c|f)")
    for i, expr in enumerate(_EXPRS):
        pair.sub(f"c{i}", expr, ("s", "+", "t"))
    pair.plain("plain", ("s", "+", "t"))

    def payload(r):
        x = r.random()
        if x < 0.1:
            return b"not json at all"
        if x < 0.2:
            return json.dumps({"other": 1}).encode()
        d = {}
        if r.random() < 0.9:
            d["value"] = r.choice([r.uniform(-5, 105), 42, 42.0, 10, 50])
        if r.random() < 0.8:
            d["unit"] = r.choice(["c", "f", "x"])
        return json.dumps(d).encode()

    topic = ("s", "a", "t")
    for trial in range(6):
        payloads = [payload(rng) for _ in range(rng.randrange(3, 40))]
        ref_dev, port_dev = pair.run(topic, payloads)
        _, port_host = pair.run(topic, payloads, host=True)
        assert port_dev == port_host == ref_dev, f"trial {trial}"
        assert all(o[-1] == ("", "plain") for o in port_dev)
    eng = pair.port
    assert eng.dispatches > 0 and eng.dispatches == pair.ref.dispatches
    assert eng.pairs_escaped > 0 and eng.rows_filtered > 0
    assert eng.pairs_host == pair.ref.pairs_host


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_count_windows_as_reference(host):
    """Port of test_count_window_aggregation_vs_reference: $avg, $max and
    $count over count windows of 5, on the device or the host path: the
    same emissions as the reference's, count/min/max exact, avg allclose."""
    rng = random.Random(11)
    pair = Pair("s/#", "v:number")
    for key, expr in (("avg", "$avg(v,5)"), ("mx", "$max(v,5)"),
                      ("mn", "$min(v,5)"), ("ct", "$count(5)")):
        pair.sub(key, expr, ("s", "#"))
    vals = [round(rng.uniform(-50, 50), 3) for _ in range(25)]
    for c in range(0, 25, 5):
        outs = pair.run(("s", "x"), [json.dumps({"v": v}).encode()
                                     for v in vals[c:c + 5]], host=host)
        assert outs[0] == outs[1] == [[]] * 5  # agg rows consumed
    ref_em, port_em = pair.sides[0][2], pair.sides[1][2]
    assert len(port_em) == len(ref_em) == 20
    for r, p in zip(ref_em, port_em):
        assert (p["$agg"], p["count"]) == (r["$agg"], r["count"])
        if p["$agg"] == "avg":
            assert p["value"] == pytest.approx(r["value"], rel=1e-6)
        else:
            assert p["value"] == r["value"]
    assert (pair.port.dispatches > 0) == (not host)


def test_gated_aggregation_folds_only_passing():
    """Port of test_gated_aggregation_folds_only_passing: the gate row is
    evaluated in the dispatch; only passing messages fold, as the
    reference folds them."""
    pair = Pair("s/#", "v:number")
    pair.sub("g", "$gt(v,50)&$avg(v,3)", ("s", "#"))
    vals = [10, 60, 20, 70, 80, 5, 90, 100, 110]  # 6 pass
    for c in range(0, 9, 3):
        pair.run(("s", "x"), [json.dumps({"v": v}).encode()
                              for v in vals[c:c + 3]])
    ref_em, port_em = pair.sides[0][2], pair.sides[1][2]
    assert [e["value"] for e in port_em] == pytest.approx(
        [(60 + 70 + 80) / 3, (90 + 100 + 110) / 3])
    assert [e["value"] for e in port_em] == pytest.approx(
        [e["value"] for e in ref_em])
    assert pair.port.dispatches == pair.ref.dispatches == 3


def test_breaker_outage_and_recovery():
    """Port of test_breaker_degradation_mid_storm_and_recovery on the
    port's engine: an injected device.predicate outage is served exactly by
    the host evaluator, the breaker opens, and the half-open probe closes
    it; the device path then serves again."""
    pair = Pair("s/#", "v:number")
    pair.sub("c", "$gt(v,50)", ("s", "#"))
    pair.plain("p", ("s", "#"))
    eng = pair.port
    payloads = [json.dumps({"v": v}).encode()
                for v in (10, 60, 55, 5, 99, 51, 2)]

    def run(host=False):
        return pair.run(("s", "x"), payloads, host=host)[1]

    oracle = pair.run(("s", "x"), payloads)[0]  # the reference's device path
    assert run() == run(host=True) == oracle
    faults.install(FaultPlan([FaultRule("device.predicate", kind="error")]))
    try:
        for _ in range(5):
            assert run() == oracle
        assert eng.breaker.state_name == "open"
        assert eng.device_failures >= 3
        sheds0 = eng.degraded_sheds
        run()
        assert eng.degraded_sheds > sheds0
    finally:
        faults.clear()
    time.sleep(0.3)
    d0 = eng.dispatches
    deadline = time.monotonic() + 5.0
    while eng.breaker.state_name != "closed" \
            and time.monotonic() < deadline:
        assert run() == oracle
        time.sleep(0.06)
    assert eng.breaker.state_name == "closed"
    assert eng.dispatches > d0


@pytest.mark.parametrize("fault", ["kernel", "cuda"])
def test_device_code_fault_raises_and_is_not_host_served(monkeypatch, fault):
    """A fault of the device code — a KernelError, or a CUDA runtime error
    surfacing from the dispatch — raises KernelError out of filter_batch:
    no verdict from the host evaluator, nothing fed to the breaker, and the
    device acc dropped (its in-place update may be half done)."""
    pair = Pair("s/#", "v:number")
    pair.sub("c", "$gt(v,50)", ("s", "#"))
    pair.sub("a", "$avg(v,2)", ("s", "#"))
    eng = pair.port
    payload = [json.dumps({"v": 70}).encode()] * 2
    pair.run(("s", "x"), payload)  # healthy: acc lives on the device
    assert eng._win.dev is not None and eng.dispatches == 1

    def broken(*a, **kw):
        if fault == "kernel":
            raise KernelError("predicate kernel launch failed: CUDA error 9")
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(PK, "predicate_phase", broken)
    items = [(("s", "x"), eng.encode("", ("s", "x"), p)) for p in payload]
    rows = pair.rows[1]
    with pytest.raises(KernelError):
        eng.filter_batch("", items, [list(rows) for _ in payload])
    assert eng.device_failures == 0 and eng.errors == 0
    assert eng.breaker.state_name == "closed"
    assert eng.pairs_host == 0 and eng.host_batches == 0
    assert eng._win.dev is None and eng._win.dev_stale


def test_collector_fails_the_futures_on_a_predicate_kernel_fault(
        monkeypatch):
    """Through the port's BatchCollector: a KernelError from the predicate
    phase reaches every future of the flush, none is served unfiltered."""
    from vernemq_tpu_torch.models.matcher import BatchCollector

    pair = Pair("s/#", "v:number")
    pair.sub("c", "$gt(v,50)", ("s", "#"))
    eng = pair.port
    rows = pair.rows[1]

    class View:
        def matcher(self, mp):
            return None

        def fold_batch(self, mp, topics, lock_timeout=None):
            return [list(rows) for _ in topics]

    def broken(*a, **kw):
        raise KernelError("predicate kernel launch failed: CUDA error 9")

    monkeypatch.setattr(PK, "eval_pairs", broken)

    async def main():
        col = BatchCollector(View(), window_us=1000, filter_engine=eng)
        futs = [col.submit("", ("s", "x"), feat=eng.encode(
            "", ("s", "x"), json.dumps({"v": v}).encode())) for v in (1, 99)]
        return await asyncio.gather(*futs, return_exceptions=True)

    outs = asyncio.run(main())
    assert [type(o).__name__ for o in outs] == ["KernelError"] * 2
    assert eng.pairs_host == 0


def test_no_device_means_host_only():
    """Without a device (a worker, a broker on the trie view) the engine
    has no device path: the host evaluator serves, nothing dispatches."""
    reg = SchemaRegistry(MetadataStore("n1"), "n1")
    reg.set_schema("", "s/#", "v:number")
    eng = FilterEngine(reg, device_gate=lambda: True, host_threshold=1)
    o = SubOpts()
    o.filter_expr = "$gt(v,50)"
    eng.on_sub_delta("add", "", o)
    rows = [(("s", "#"), ("", "c"), o)]
    items = [(("s", "x"), eng.encode("", ("s", "x"), b'{"v": %d}' % v))
             for v in (10, 90)]
    out = eng.filter_batch("", items, [list(rows), list(rows)])
    assert [[r[1] for r in x] for x in out] == [[], [("", "c")]]
    assert eng.dispatches == 0 and eng.pairs_host == 2
    assert ENG.ROW_PAD == 0 and ENG.ROW_TRUE == 1


# ------------------------------------------------ the held fold scratch


def test_held_scratch_is_made_zeroed_once_and_dropped():
    """The wrapper's fold scratch: zeroed int32 [W, 4] made once per
    (device, stream, W) and handed out again; drop_scratch forgets a
    device's (every device's with no argument) so the next is made
    anew."""
    dev = torch.device("cpu")
    PK.drop_scratch()
    s = PK.held_scratch(dev, 12, 0)
    assert s.dtype == torch.int32 and s.shape == (12, 4) and not s.any()
    assert PK.held_scratch(dev, 12, 0) is s
    assert PK.held_scratch(dev, 12, 1) is not s  # another stream
    assert PK.held_scratch(dev, 16, 0) is not s  # another W
    s.fill_(7)  # as a dispatch that failed half way would leave it
    PK.drop_scratch(dev)
    t = PK.held_scratch(dev, 12, 0)
    assert t is not s and not t.any()
    PK.drop_scratch()
    assert not PK._scratch


@pytest.mark.parametrize("fault", ["injected", "kernel"])
def test_failed_dispatch_drops_the_held_scratch(monkeypatch, fault):
    """Any failure of a dispatch with folds — an injected device fault fed
    to the breaker, or a KernelError raised to the caller — drops the
    kernel's held fold scratch with the device acc, so a half-folded
    scratch never reaches the next dispatch; the next dispatch serves
    exactly."""
    pair = Pair("s/#", "v:number")
    pair.sub("c", "$gt(v,50)", ("s", "#"))
    pair.sub("a", "$avg(v,2)", ("s", "#"))
    eng = pair.port
    payload = [json.dumps({"v": v}).encode() for v in (70, 20, 90)]
    pair.run(("s", "x"), payload)  # healthy: acc lives on the device
    dropped = []
    real_drop = PK.drop_scratch
    monkeypatch.setattr(PK, "drop_scratch",
                        lambda dev=None: (dropped.append(dev),
                                          real_drop(dev)))
    items = [(("s", "x"), eng.encode("", ("s", "x"), p)) for p in payload]
    rows = pair.rows[1]
    if fault == "injected":
        faults.install(FaultPlan([FaultRule("device.predicate",
                                            kind="error")]))
        try:
            eng.filter_batch("", items, [list(rows) for _ in payload])
        finally:
            faults.clear()
        assert eng.device_failures == 1
    else:
        real = PK.predicate_phase

        def broken(*a, **kw):
            raise KernelError("predicate kernel launch failed: CUDA error 9")

        monkeypatch.setattr(PK, "predicate_phase", broken)
        with pytest.raises(KernelError):
            eng.filter_batch("", items, [list(rows) for _ in payload])
        monkeypatch.setattr(PK, "predicate_phase", real)
    assert dropped == [eng._device]
    assert eng._win.dev is None and eng._win.dev_stale
    got, want = pair.run(("s", "y"), payload)[::-1]
    assert got == want


@pytest.mark.parametrize("n_pubs", [1, 2, 3, 4])
def test_engine_places_each_index_array_at_a_16_byte_offset(monkeypatch,
                                                            n_pubs):
    """The engine's one int32 index block holds the pair publishes, the
    pair predicates and the fold rows each at a multiple of 4 entries (16
    bytes: the kernel's vector loads) whatever P % 4 is; the kernel sees
    exactly the batch's pairs."""
    pair = Pair("s/#", "v:number")
    pair.sub("c", "$gt(v,50)", ("s", "#"))
    pair.sub("a", "$avg(v,2)", ("s", "#"))
    seen = []
    real = PK.predicate_phase

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(PK, "predicate_phase", spy)
    payload = [json.dumps({"v": 40 + 20 * i}).encode()
               for i in range(n_pubs)]
    got, want = pair.run(("s", "x"), payload)[::-1]
    assert got == want
    (a,) = seen
    pp, pr, slot = a[8], a[9], a[10]
    assert pp.numel() == pr.numel() == n_pubs
    for x in (pp, pr, slot):
        assert x.storage_offset() % 4 == 0
    assert pp.untyped_storage().data_ptr() == pr.untyped_storage().data_ptr()
