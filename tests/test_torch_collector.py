"""The port's BatchCollector: the reference's collector tests ported to
stand-in views (double-buffered dispatch, bounded in-flight, self-batching
under saturation, back-to-back dispatch, error propagation, overload shed,
a loop that never blocks on the device, per-publisher release order,
super-batches and their errors, the stall watchdog's dispatch deadline and
item expiry), and the whole serving layer beside the
reference's: BatchCollector over GpuRegView(device="cpu") and over
TpuRegView, the same submissions, the same rows per future in submission
order and the same counters."""

import asyncio
import random
import threading
import time
import types

import pytest

from _torch_port import bucket_corpus, bucket_topics, norm
from vernemq_tpu.models import tpu_matcher as JM
from vernemq_tpu_torch.models import matcher as GM
from vernemq_tpu_torch.models.matcher import BatchCollector
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.robustness.watchdog import StallWatchdog


class _SlowView:
    """Stand-in view whose device call takes device_ms and records
    concurrency."""

    registry = None  # no host path

    def __init__(self, device_ms: float = 30.0):
        self.device_ms = device_ms
        self.active = 0
        self.max_active = 0
        self.batches = []

    def matcher(self, mp):
        return None

    def fold_batch(self, mp, topics, lock_timeout=None):
        self.active += 1
        self.max_active = max(self.max_active, self.active)
        time.sleep(self.device_ms / 1000.0)
        self.active -= 1
        self.batches.append(len(topics))
        return [[("row", t)] for t in topics]


class _HostRows:
    """Stand-in registry whose trie answers with a marked row."""

    class _T:
        @staticmethod
        def match(topic):
            return [("host-row", tuple(topic))]

    def trie(self, mp):
        return self._T


class _ManyView(_SlowView):
    """Stand-in view with a fold_many seam: records the chunking of every
    super-batch."""

    def __init__(self, device_ms: float = 20.0, fail_super: bool = False):
        super().__init__(device_ms)
        self.fail_super = fail_super
        self.super_calls = []

    def fold_many(self, mp, batches, lock_timeout=None):
        self.super_calls.append([len(b) for b in batches])
        if self.fail_super:
            raise RuntimeError("super-batch device failure")
        time.sleep(self.device_ms / 1000.0)
        return [[[("row", t)] for t in topics] for topics in batches]


def _release_order(futs):
    order = []
    for i, f in enumerate(futs):
        f.add_done_callback(lambda f, i=i: order.append(i))
    return order


@pytest.mark.asyncio
async def test_collector_bounded_inflight_and_merge():
    view = _SlowView(device_ms=40)
    col = BatchCollector(view, window_us=200, max_batch=64,
                         host_threshold=0)
    futs = []
    for wave in range(12):
        for i in range(16):
            futs.append(col.submit("", ("t", f"w{wave}", f"i{i}")))
        await asyncio.sleep(0.005)
    rows = await asyncio.gather(*futs)
    assert len(rows) == 192 and all(r for r in rows)
    # never more than the two pipeline slots on the "device"
    assert view.max_active <= BatchCollector.MAX_INFLIGHT
    # saturation coalesced waves into bigger batches instead of queueing
    assert col.saturated_merges > 0
    assert max(view.batches) > 16
    assert col._inflight == 0 and not col._pending


@pytest.mark.asyncio
async def test_collector_back_to_back_dispatch():
    """A batch waiting on a busy slot goes out the moment the slot frees,
    not after another window."""
    view = _SlowView(device_ms=20)
    col = BatchCollector(view, window_us=100_000,  # 100 ms window
                         max_batch=8, host_threshold=0)
    futs = [col.submit("", ("a", str(i))) for i in range(8)]  # full: flush
    await asyncio.sleep(0.002)
    late = [col.submit("", ("b", str(i))) for i in range(8)]  # full: flush
    extra = [col.submit("", ("c",))]  # partial: would wait out the window
    t0 = time.perf_counter()
    await asyncio.gather(*futs, *late, *extra)
    assert time.perf_counter() - t0 < 0.1


@pytest.mark.asyncio
async def test_collector_device_error_resolves_futures():
    class _Boom(_SlowView):
        def fold_batch(self, mp, topics, lock_timeout=None):
            raise RuntimeError("device on fire")

    col = BatchCollector(_Boom(), window_us=100, max_batch=8,
                         host_threshold=0)
    futs = [col.submit("", ("x", str(i))) for i in range(12)]
    res = await asyncio.gather(*futs, return_exceptions=True)
    assert all(isinstance(r, RuntimeError) for r in res)
    assert col._inflight == 0


@pytest.mark.asyncio
async def test_slow_device_never_blocks_the_loop():
    """The device call runs off the loop: while a 300 ms flush is on the
    "device", the loop keeps ticking and a small flush is answered by the
    host trie at once (the loop-side hybrid path)."""
    view = _SlowView(device_ms=300)
    view.registry = _HostRows()
    col = BatchCollector(view, window_us=200, max_batch=16,
                         host_threshold=4)
    slow = [col.submit("", ("s", str(i))) for i in range(16)]
    lags = []
    for _ in range(10):
        t0 = time.perf_counter()
        await asyncio.sleep(0.005)
        lags.append(time.perf_counter() - t0)
    assert max(lags) < 0.1, lags  # nothing held the loop
    assert not any(f.done() for f in slow)
    # the flush this small is matched host-side on the loop; it releases
    # after the earlier submissions, in order
    quick = col.submit("", ("q",))
    await asyncio.gather(*slow, quick)
    assert quick.result() == [("host-row", ("q",))]
    assert col.host_hybrid_pubs == 1


@pytest.mark.asyncio
async def test_collector_overload_sheds_to_host_trie():
    """Arrivals above the device service rate: once both slots are busy and
    a full batch waits, submits are matched on the host trie — and still
    release in submission order."""
    view = _SlowView(device_ms=40)
    view.registry = _HostRows()
    col = BatchCollector(view, window_us=100, max_batch=8,
                         host_threshold=0)
    futs = [col.submit("", ("x", str(i))) for i in range(40)]
    assert col.overload_host_pubs > 0
    assert not any(f.done() for f in futs[24:])
    order = _release_order(futs)
    rows = await asyncio.gather(*futs)
    assert order == sorted(order), "futures released out of order"
    assert rows[-1][0][0] == "host-row"  # the tail was host-shed
    assert view.max_active <= BatchCollector.MAX_INFLIGHT


@pytest.mark.asyncio
async def test_per_publisher_order_preserved_under_slow_device():
    """One publisher's stream through racing device batches of variable
    latency (odd batches slow, even fast, so a newer batch finishes first):
    every result releases in publish order and carries its own topic."""

    class _Racing(_SlowView):
        def fold_batch(self, mp, topics, lock_timeout=None):
            self.batches.append(len(topics))
            time.sleep(0.04 if len(self.batches) % 2 else 0.005)
            return [[("row", t)] for t in topics]

    view = _Racing()
    view.registry = _HostRows()
    col = BatchCollector(view, window_us=2000, max_batch=64,
                         host_threshold=2)
    futs = []
    for i in range(120):
        futs.append(col.submit("", ("ord", "t", "%04d" % i)))
        if i % 10 == 0:
            await asyncio.sleep(0.005)  # spread across windows
    order = _release_order(futs)
    rows = await asyncio.gather(*futs)
    assert order == list(range(120))
    assert [r[0][1][2] for r in rows] == ["%04d" % i for i in range(120)]
    assert len(view.batches) >= 3


@pytest.mark.asyncio
async def test_collector_coalesces_super_batches_under_load():
    """With both slots busy and several windows queued, up to
    super_batch_k windows ship as ONE fold_many call, chunked at
    max_batch; every future resolves to its own topic, in order."""
    view = _ManyView(device_ms=40)
    col = BatchCollector(view, window_us=200, max_batch=8,
                         host_threshold=0, super_batch_k=4)
    futs = []
    for wave in range(8):
        for i in range(16):
            futs.append(col.submit("", ("t", f"w{wave}", f"i{i}")))
        await asyncio.sleep(0.004)
    order = _release_order(futs)
    rows = await asyncio.gather(*futs)
    assert col.super_batches > 0 and view.super_calls
    for chunks in view.super_calls:
        assert len(chunks) >= 2
        assert all(c <= 8 for c in chunks)
        assert sum(chunks) <= 8 * col.super_batch_k
    for i, r in enumerate(rows):
        assert r == [("row", ("t", f"w{i // 16}", f"i{i % 16}"))]
    assert order == sorted(order), "futures released out of order"
    assert col._inflight == 0 and not col._pending


@pytest.mark.asyncio
async def test_collector_super_batch_error_propagates():
    """A failure inside a super-batch errors every future of it and only
    those."""
    view = _ManyView(device_ms=40, fail_super=True)
    col = BatchCollector(view, window_us=200, max_batch=8,
                         host_threshold=0, super_batch_k=4)
    ok_futs = [col.submit("", ("ok", str(i))) for i in range(16)]
    bad_futs = [col.submit("", ("bad", str(i))) for i in range(24)]
    res_ok = await asyncio.gather(*ok_futs, return_exceptions=True)
    res_bad = await asyncio.gather(*bad_futs, return_exceptions=True)
    assert all(not isinstance(r, Exception) for r in res_ok)
    assert view.super_calls, "no super-batch formed"
    assert all(isinstance(r, RuntimeError) for r in res_bad)
    assert col._inflight == 0


# ------------------------------------------------ stall watchdog, expiry

class _TrieRows:
    """Stand-in registry whose trie answers with a "trie" row."""

    class _T:
        @staticmethod
        def match(topic):
            return [("trie", tuple(topic), None)]

    def trie(self, mp):
        return self._T


class _WedgedView:
    """Stand-in view whose device call blocks until released, with a
    matcher that counts the stalls fed to it."""

    def __init__(self):
        self.registry = _TrieRows()
        self.release = threading.Event()
        self.calls = 0
        self.m = types.SimpleNamespace(stalls=0)
        self.m.record_stall = lambda exc=None: setattr(
            self.m, "stalls", self.m.stalls + 1)

    def matcher(self, mp):
        return self.m

    def fold_batch(self, mp, topics, lock_timeout=None):
        self.calls += 1
        self.release.wait(30)
        return [[("device", tuple(t), None)] for t in topics]


async def _until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        await asyncio.sleep(0.01)


@pytest.mark.asyncio
async def test_collector_dispatch_deadline_serves_trie_and_discards_late():
    """A wedged dispatch is abandoned at its deadline: the trie answers,
    the matcher's breaker hook is fed once, and the late device rows are
    discarded."""
    w = StallWatchdog(tick_s=0.02)
    w.start()
    view = _WedgedView()
    col = BatchCollector(view, window_us=100, max_batch=8, host_threshold=0,
                         super_batch_k=1, watchdog=w,
                         dispatch_deadline_ms=200)
    try:
        t0 = time.perf_counter()
        rows = await asyncio.gather(
            *[col.submit("", ("x", str(i))) for i in range(8)])
        assert time.perf_counter() - t0 < 2.0
        assert all(r[0][0] == "trie" for r in rows)
        assert col.stalled_host_pubs == 8 and view.m.stalls == 1
        assert w.stats()["watchdog_abandoned"] == 1
        view.release.set()  # the wedged call completes late: discarded
        await _until(lambda: w.stats()["watchdog_late_discarded"] == 1)
        assert col._inflight == 0 and not col._pending
    finally:
        view.release.set()
        w.stop()


@pytest.mark.asyncio
async def test_collector_item_expiry_bounds_queued_tail():
    """Items queued behind two wedged pipeline slots are answered by the
    trie at their expiry: the wait is bounded by the dispatch deadline
    plus the expiry, not by the wedge."""
    w = StallWatchdog(tick_s=0.02)
    w.start()
    view = _WedgedView()
    col = BatchCollector(view, window_us=100, max_batch=4, host_threshold=0,
                         super_batch_k=1, watchdog=w,
                         dispatch_deadline_ms=400, item_expiry_ms=150)
    try:
        t0 = time.perf_counter()
        flights = [col.submit("", ("a", str(i))) for i in range(8)]
        await asyncio.sleep(0.02)
        assert view.calls >= 1
        queued = [col.submit("", ("q", str(i))) for i in range(4)]
        rows = await asyncio.gather(*flights, *queued)
        assert time.perf_counter() - t0 < 3.0
        assert all(r[0][0] == "trie" for r in rows)
        assert col.expired_host_pubs >= 1 and col.stalled_host_pubs >= 8
    finally:
        view.release.set()
        w.stop()


@pytest.mark.asyncio
@pytest.mark.parametrize("bound,message", [
    (dict(dispatch_deadline_ms=150), "stalled past its deadline"),
    (dict(dispatch_deadline_ms=2000, item_expiry_ms=150),
     "expired in the collector queue")])
async def test_late_publishes_answered_by_the_trie_are_logged(
        caplog, bound, message):
    """A publish the device path was too slow for is never answered by
    the trie silently: besides its counter, the collector logs a
    warning."""
    w = StallWatchdog(tick_s=0.02)
    w.start()
    view = _WedgedView()
    col = BatchCollector(view, window_us=100, max_batch=4, host_threshold=0,
                         super_batch_k=1, watchdog=w, **bound)
    try:
        with caplog.at_level("WARNING", logger="vernemq_tpu_torch.matcher"):
            flights = [col.submit("", ("a", str(i))) for i in range(8)]
            await asyncio.sleep(0.02)
            queued = [col.submit("", ("q", str(i))) for i in range(4)]
            view_rows = asyncio.gather(*flights, *queued)
            await _until(lambda: any(message in r.getMessage()
                                     for r in caplog.records))
        view.release.set()
        rows = await view_rows
        late = col.expired_host_pubs + col.stalled_host_pubs
        assert late >= 4 and sum(r[0][0] == "trie" for r in rows) == late
    finally:
        view.release.set()
        w.stop()


# ------------------------------------------ the serving layer end to end

class _Registry:
    """fold_subscriptions(mp) + trie(mp) over one shared trie."""

    def __init__(self, trie):
        self._trie = trie

    def fold_subscriptions(self, mp):
        return self._trie.entries()

    def trie(self, mp):
        return self._trie


@pytest.fixture
def views():
    """The reference's and the port's view over one 3,000-subscription
    corpus (`_torch_port.bucket_corpus`), with each
    matcher created here, before any event loop runs: under a running
    loop the reference's view starts its warm ladder."""
    trie = SubscriptionTrie()
    for i, f in enumerate(bucket_corpus()):
        trie.add(f, i, None)
    reg = _Registry(trie)
    kw = dict(max_levels=8, initial_capacity=8192, max_fanout=64)
    ref = JM.TpuRegView(reg, **kw)
    gpu = GM.GpuRegView(reg, **kw, device="cpu")
    for v in (ref, gpu):
        v.matcher("")
    return ref, gpu, trie


COLLECTOR_COUNTERS = ("super_batches", "super_batch_pubs",
                      "host_hybrid_pubs", "overload_host_pubs",
                      "busy_host_pubs", "rebuild_host_pubs",
                      "degraded_host_pubs", "saturated_merges")


async def _serve(col, rounds):
    """Submit each round's topics at once, await them; per round the rows
    (keys as strings) and the release order."""
    out = []
    for topics in rounds:
        futs = [col.submit("", t) for t in topics]
        order = _release_order(futs)
        rows = await asyncio.gather(*futs)
        out.append(([[(tuple(f), str(k)) for f, k, _ in r] for r in rows],
                    order))
    return out


@pytest.mark.asyncio
async def test_serving_layer_matches_reference(views):
    """Two windows fill both slots, four more leave as one super-batch,
    the next five shed at overload, and a later three are served by the
    trie on the loop: the port's collector and the reference's give the
    same rows per future, in submission order, and the same counters."""
    ref, gpu, trie = views
    rng = random.Random(3)
    rounds = [bucket_topics(rng, 16 * 6 + 5), bucket_topics(rng, 3)]
    got = []
    for view in (ref, gpu):
        col_cls = JM.BatchCollector if view is ref else BatchCollector
        col = col_cls(view, window_us=200, max_batch=16, host_threshold=8,
                      lock_busy_shed_ms=0, super_batch_k=4)
        served = await _serve(col, rounds)
        got.append((served, {c: getattr(col, c)
                             for c in COLLECTOR_COUNTERS}))
    (ref_served, ref_counts), (gpu_served, gpu_counts) = got
    assert gpu_served == ref_served
    assert gpu_counts == ref_counts
    assert gpu_counts["super_batches"] == 1
    assert gpu_counts["overload_host_pubs"] == 5
    assert gpu_counts["host_hybrid_pubs"] == 3
    for (rows, order), topics in zip(gpu_served, rounds):
        assert order == list(range(len(topics)))
        for t, r in zip(topics, rows):
            assert sorted(r) == norm(trie.match(list(t))), t
    assert gpu.matcher("").super_dispatches == 1


@pytest.mark.asyncio
async def test_cold_signature_sheds_like_reference(views):
    """With the lock bound on, a flush that finds the matcher lock busy
    past the bound sheds to the trie (MatcherBusy) on both sides alike. A
    shape never run before is where the two part: the reference sheds it
    as a cold signature (its bound on XLA compiles) and warms it off to the
    side; the port compiles nothing per shape and serves it on the device."""
    ref, gpu, trie = views
    rng = random.Random(4)
    rounds = [bucket_topics(rng, 16), bucket_topics(rng, 16)]
    busy = []
    for view in (ref, gpu):
        col_cls = JM.BatchCollector if view is ref else BatchCollector
        col = col_cls(view, window_us=200, max_batch=16, host_threshold=8,
                      lock_busy_shed_ms=50, super_batch_k=4)
        m = view.matcher("")
        m.lock.acquire()  # busy past the 50 ms bound
        try:
            served = await _serve(col, rounds[:1])
        finally:
            m.lock.release()
        served += await _serve(col, rounds[1:])
        deadline = time.monotonic() + 30
        while getattr(m, "_warming", None):  # the reference's side warm-up
            assert time.monotonic() < deadline, "warm-up never ended"
            await asyncio.sleep(0.01)
        busy.append((col.busy_host_pubs, m.busy_sheds, m.match_batches))
        for (rows, _), topics in zip(served, rounds):
            for t, r in zip(topics, rows):
                assert sorted(r) == norm(trie.match(list(t))), t
    # (busy publishes, busy sheds, batches matched): the lock-busy flush
    # alike; then the reference sheds its cold shape (counted as matched)
    # and the port serves it on the device
    assert busy[0] == (32, 2, 1)
    assert busy[1] == (16, 1, 1)
    assert gpu.matcher("").host_fallbacks == 0


@pytest.mark.asyncio
async def test_cuda_fault_fails_the_futures(monkeypatch):
    """A kernel that faulted on the card surfaces as a sticky CUDA error.
    The collector's futures fail with KernelError, window after window and
    for super-batches too: none is answered from the trie and the breaker
    stays closed."""
    from vernemq_tpu_torch.ops import tile_match as TM

    trie = SubscriptionTrie()
    for i, f in enumerate(bucket_corpus()):
        trie.add(f, i, None)
    view = GM.GpuRegView(_Registry(trie), max_levels=8,
                         initial_capacity=8192, max_fanout=64, device="cpu",
                         breaker_failure_threshold=1)
    m = view.matcher("")
    col = BatchCollector(view, window_us=200, max_batch=16,
                         lock_busy_shed_ms=500, super_batch_k=4)
    rng = random.Random(6)
    assert all(isinstance(r, list) for r in
               await asyncio.gather(*[col.submit("", t)
                                      for t in bucket_topics(rng, 16)]))

    def faulted(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(TM, "window_tiles_packed", faulted)
    for n in (16, 16 * 6):  # one window; two slots and a super-batch
        got = await asyncio.gather(
            *[col.submit("", t) for t in bucket_topics(rng, n)],
            return_exceptions=True)
        assert all(isinstance(g, TM.KernelError) for g in got), got[:2]
    assert col.super_batches == 0
    assert {c: getattr(col, c) for c in COLLECTOR_COUNTERS
            if c.endswith("host_pubs")} == dict.fromkeys(
        (c for c in COLLECTOR_COUNTERS if c.endswith("host_pubs")), 0)
    assert m.device_failures == 0 and m.breaker.state_name == "closed"
