"""The port's robustness layer against the JAX package's: the copied
FaultPlan and CircuitBreaker step for step, and GpuMatcher(device="cpu")
beside TpuMatcher under the same fault scripts — device degrade and
recovery, a failed delta upload, a failed first build, no breaker, the
background rebuild (shed, stale discard, crash) and a wedged rebuild
abandoned by the stall watchdog. Rows are held against the trie and
against each other, counters against each other, exactly."""

import random
import threading
import time

import pytest
import torch

from _torch_port import bucket_corpus, bucket_topics, norm
from vernemq_tpu.models import tpu_matcher as JM
from vernemq_tpu.robustness import breaker as JB
from vernemq_tpu.robustness import faults as JF
from vernemq_tpu.robustness import watchdog as JW
from vernemq_tpu_torch.models import matcher as GM
from vernemq_tpu_torch.models.trie import SubscriptionTrie
from vernemq_tpu_torch.robustness import breaker as PB
from vernemq_tpu_torch.robustness import faults as PF
from vernemq_tpu_torch.robustness import watchdog as PW

COUNTERS = ("device_failures", "degraded_sheds", "rebuilds_async",
            "rebuild_abandons", "busy_sheds", "host_fallbacks",
            "match_batches", "match_publishes")
BREAKER = ("state", "consecutive_failures", "opens", "closes", "probes",
           "failures", "successes")


@pytest.fixture(autouse=True)
def _no_leaked_plans():
    JF.clear()
    PF.clear()
    yield
    JF.clear()
    PF.clear()


def install_both(*rules, seed=0):
    """The same rules, as a plan of each package, in each registry."""
    JF.install(JF.FaultPlan([JF.FaultRule(**r) for r in rules], seed=seed))
    PF.install(PF.FaultPlan([PF.FaultRule(**r) for r in rules], seed=seed))


class Pair:
    """The reference TpuMatcher and the port's GpuMatcher over one corpus,
    plus the trie that holds the expected rows."""

    def __init__(self, threshold=None, backoff=0.05):
        kw = dict(max_levels=8, initial_capacity=8192, max_fanout=64)
        self.ref = JM.TpuMatcher(**kw)
        self.gpu = GM.GpuMatcher(**kw, device="cpu")
        self.trie = SubscriptionTrie()
        if threshold is not None:
            self.ref.breaker = JB.CircuitBreaker(
                failure_threshold=threshold, backoff_initial=backoff,
                backoff_max=backoff, jitter=0.0)
            self.gpu.breaker = PB.CircuitBreaker(
                failure_threshold=threshold, backoff_initial=backoff,
                backoff_max=backoff, jitter=0.0)
        self.rng = random.Random(7)
        for i, f in enumerate(bucket_corpus()):
            self.add(f, i)

    @property
    def both(self):
        return (self.ref, self.gpu)

    def add(self, f, key):
        for m in self.both:
            m.table.add(list(f), key, None)
        self.trie.add(list(f), key, None)

    def topics(self, n=16):
        return bucket_topics(self.rng, n)

    def outcome(self, m, topics):
        """The rows of one match_batch (checked against the trie), or the
        name of the exception it raised."""
        try:
            rows = m.match_batch(topics)
        except Exception as e:  # compared by name across the packages
            return type(e).__name__
        got = [norm(r) for r in rows]
        assert got == [norm(self.trie.match(list(t))) for t in topics]
        return got

    def step(self, topics):
        """One match on both: the same outcome, returned."""
        a, b = (self.outcome(m, topics) for m in self.both)
        assert a == b
        return a

    def grow_until_resize(self, tag):
        """Add subscriptions until the tables mark a capacity change;
        returns a topic matching each added filter."""
        added = []
        while not self.gpu.table.resized:
            f = [f"r{self.rng.randrange(8)}", "+", f"{tag}{len(added)}"]
            self.add(f, (tag, len(added)))
            added.append((f[0], "x", f[2]))
            assert len(added) < 200_000, "table never resized"
        assert self.ref.table.resized
        return added

    def same_counters(self, names=COUNTERS):
        deadline = time.monotonic() + 30
        while self.ref._warming:  # the reference's re-warm threads
            assert time.monotonic() < deadline, "warm-up never ended"
            time.sleep(0.01)
        for name in names:
            assert getattr(self.ref, name) == getattr(self.gpu, name), name
        if self.ref.breaker is not None:
            a, b = self.ref.breaker.status(), self.gpu.breaker.status()
            # the reference re-warms the last batch shape once its breaker
            # closes, and each warm-up batch is one more success; the port
            # compiles nothing per shape and has no warm-up
            a = {**a, "successes": a["successes"] - self.ref.warmup_batches}
            assert {k: a[k] for k in BREAKER} == {k: b[k] for k in BREAKER}


# ------------------------------------------------------- copied machinery

def test_fault_plan_decisions_match_reference():
    """Same seed and rules: the same decision at every hit of every point,
    however hits on the points interleave, and the same raises."""
    rules = [dict(point="device.dispatch", probability=0.5),
             dict(point="device.*", kind="latency", probability=0.3,
                  after=2, count=5, latency_ms=1.0),
             dict(point="device.rebuild", kind="hang", count=1, after=40)]
    plans = [JF.FaultPlan([JF.FaultRule(**r) for r in rules], seed=11),
             PF.FaultPlan([PF.FaultRule(**r) for r in rules], seed=11)]
    rng = random.Random(5)
    points = ("device.dispatch", "device.delta", "device.rebuild")
    seq = [rng.choice(points) for _ in range(300)]
    got = [[p.decide(pt) for pt in seq] for p in plans]
    assert got[0] == got[1]
    assert sum(d is not None for d in got[0]) > 50  # not vacuous
    assert plans[0].status() == plans[1].status()

    def raises(mod):
        mod.install(mod.FaultPlan([mod.FaultRule(
            "device.delta", after=2, count=2)], seed=3))
        out = []
        for _ in range(6):
            try:
                mod.inject("device.delta")
                out.append(None)
            except mod.InjectedFault as e:
                out.append((e.point, e.rule_index, e.hit))
        return out

    assert raises(JF) == raises(PF) == [None, None, ("device.delta", 0, 2),
                                        ("device.delta", 0, 3), None, None]


def test_breaker_state_sequence_matches_reference():
    """One scripted allow / record / probe_aborted / trip / reset sequence
    under one clock and one jitter stream: the same returns, states and
    status at every step."""
    now = [0.0]
    brs = [mod.CircuitBreaker(failure_threshold=3, backoff_initial=0.2,
                              backoff_max=1.0, clock=lambda: now[0],
                              rng=random.Random(4), name="match")
           for mod in (JB, PB)]
    script = (["allow", "failure", "success", "failure", "failure",
               "failure", "allow", ("tick", 0.1), "allow", ("tick", 0.2),
               "allow", "allow", "probe_aborted", "allow", ("tick", 0.25),
               "allow", "failure", ("tick", 0.3), "allow", ("tick", 0.2),
               "allow", "success", "failure", "trip", "allow",
               ("tick", 5.0), "allow", "success", "reset", "allow",
               "failure", "failure", "failure", ("tick", 2.0), "allow",
               "failure", ("tick", 3.0), "allow", "failure", ("tick", 3.0),
               "allow", "success"])
    for step in script:
        if isinstance(step, tuple):
            now[0] += step[1]
            continue
        fn = {"failure": "record_failure", "success": "record_success"} \
            .get(step, step)
        rets = [getattr(b, fn)() for b in brs]
        assert rets[0] == rets[1], step
        assert brs[0].state_name == brs[1].state_name, step
        assert brs[0].status() == brs[1].status(), step
    assert brs[1].opens >= 4 and brs[1].closes >= 3


# ------------------------------------------ matcher: breaker and faults

def test_matcher_degrades_to_host_and_recovers():
    """Persistent device faults: every batch still gets exact rows (the
    host match on DeviceDegraded), both breakers open after the same
    failures, and after the faults clear the half-open probe restores the
    device path on both."""
    p = Pair(threshold=2, backoff=0.25)
    p.step(p.topics())  # first build, healthy
    install_both(dict(point="device.*", kind="error"))
    batches = [p.topics() for _ in range(6)]
    outcomes = [p.step(topics) for topics in batches]  # inside the backoff
    assert outcomes == ["DeviceDegraded"] * 6
    for m in p.both:  # the caller's exact host fallback
        for t in batches[0]:
            assert norm(m._host_match(t)) == norm(p.trie.match(list(t)))
    assert p.gpu.breaker.state_name == "open"
    assert p.gpu.device_failures == 2 and p.gpu.degraded_sheds == 4
    p.same_counters()
    JF.clear()
    PF.clear()
    time.sleep(0.3)  # past the 0.25 s backoff: the next batch probes
    assert isinstance(p.step(p.topics()), list)
    assert p.gpu.breaker.state_name == "closed"
    assert p.gpu.breaker.closes == 1
    p.same_counters()


def test_delta_upload_fault_forces_rebuild_and_stays_exact():
    """A failed delta scatter re-arms a full rebuild on both sides, and
    the next sync re-converges."""
    p = Pair(threshold=99)
    p.step(p.topics())
    install_both(dict(point="device.delta", count=1))
    p.add(["r1", "d1", "mnew"], "new-key")
    assert p.step(p.topics()) == "DeviceDegraded"
    assert p.ref.table.resized and p.gpu.table.resized
    got = p.step([("r1", "d1", "mnew")] + p.topics(15))
    assert got[0]  # the new row, among others
    assert ("('r1', 'd1', 'mnew')", "new-key") in \
        [(str(f), k) for f, k in got[0]]
    p.same_counters()


def test_first_build_fault_is_retryable():
    p = Pair(threshold=99)
    install_both(dict(point="device.rebuild", count=1))
    topics = p.topics()
    assert p.step(topics) == "DeviceDegraded"
    assert isinstance(p.step(topics), list)
    p.same_counters()


def test_no_breaker_propagates_raw_error():
    p = Pair()
    for m in p.both:
        m.breaker = None
    p.step(p.topics())
    install_both(dict(point="device.dispatch"))
    assert p.step(p.topics()) == "InjectedFault"
    p.same_counters(COUNTERS)


# ----------------------------------------------- matcher: async rebuild

def _join_rebuilds(p, timeout=60.0):
    """Wait until each matcher's rebuild thread (and any build it went
    round again into) has ended."""
    deadline = time.monotonic() + timeout
    for m in p.both:
        while True:
            th = m._rebuild_thread
            if th is None or (not th.is_alive() and m._rebuild_thread is th):
                break
            th.join(timeout=0.1)
            assert time.monotonic() < deadline, "rebuild never finished"


def _async_pair():
    # one corpus and one batch size for every rebuild case: the reference
    # compiles each table shape once per process
    p = Pair()
    for m in p.both:
        m.async_rebuild = True
    return p


def test_async_rebuild_sheds_and_recovers():
    p = _async_pair()
    topics = p.topics()
    p.step(topics)  # the first build is synchronous
    gate = threading.Event()
    for m in p.both:
        m._rebuild_barrier = gate
    grown = p.grow_until_resize("g")
    assert p.step(topics) == "RebuildInProgress"
    assert p.step(topics) == "RebuildInProgress"
    assert p.gpu.rebuilds_async == 1
    gate.set()
    _join_rebuilds(p)
    for m in p.both:
        m._rebuild_barrier = None
    assert isinstance(p.step(topics), list)
    # the growth rows serve from the new table
    assert all(p.step(p.rng.sample(grown, 16)))
    p.same_counters()


def test_second_resize_mid_rebuild_discards_stale_build():
    p = _async_pair()
    topics = p.topics()
    p.step(topics)
    gate = threading.Event()
    for m in p.both:
        m._rebuild_barrier = gate
    p.grow_until_resize("g")
    assert p.step(topics) == "RebuildInProgress"
    # the layout moves AGAIN while the first build waits at the gate
    grown = p.grow_until_resize("h")
    gate.set()  # the first build must discard itself and go again
    _join_rebuilds(p)
    for m in p.both:
        m._rebuild_barrier = None
    assert p.gpu.rebuilds_async >= 2 and p.ref.rebuilds_async >= 2
    assert isinstance(p.step(topics), list)
    assert all(p.step(p.rng.sample(grown, 16)))
    p.same_counters()


def test_crashed_rebuild_rearms_and_retries():
    """A worker that dies mid-build must not leave the matcher on the
    delta path against the pre-resize arrays: the resize re-arms and the
    next sync goes again."""
    p = _async_pair()
    topics = p.topics()
    p.step(topics)
    real = [m._build_device for m in p.both]
    crashes = []

    def exploding(state):
        crashes.append(1)
        raise RuntimeError("injected device failure")

    for m in p.both:
        m._build_device = exploding
    grown = p.grow_until_resize("g")
    assert p.step(topics) == "RebuildInProgress"
    for m in p.both:
        m._rebuild_thread.join(timeout=60)
    assert crashes == [1, 1]
    for m, fn in zip(p.both, real):
        m._build_device = fn
    assert p.step(topics) == "RebuildInProgress"  # reaped, re-armed
    _join_rebuilds(p)
    assert isinstance(p.step(topics), list)
    assert all(p.step(p.rng.sample(grown, 16)))
    p.same_counters()


def test_wedged_rebuild_abandoned_feeds_breaker_and_discards_install():
    """A background rebuild that WEDGES is abandoned at its deadline on
    both sides: the breaker opens, sync() re-arms the build, the wedge is
    released by the abandonment and the stale install is discarded — then
    a fresh rebuild recovers with full parity, growth rows included."""
    p = Pair(threshold=1)
    wds = (JW.StallWatchdog(tick_s=0.03), PW.StallWatchdog(tick_s=0.03))
    try:
        for m, w in zip(p.both, wds):
            w.start()
            m.watchdog = w
            m.rebuild_deadline_s = 0.25
        topics = p.topics()
        p.step(topics)  # first build: synchronous, healthy
        for m in p.both:
            m.async_rebuild = True
        install_both(dict(point="device.rebuild", kind="wedge", count=1))
        grown = p.grow_until_resize("g")
        assert p.step(topics) == "RebuildInProgress"  # the wedging build
        deadline = time.monotonic() + 5
        while not (p.ref.rebuild_abandons and p.gpu.rebuild_abandons):
            assert time.monotonic() < deadline, "rebuild never abandoned"
            time.sleep(0.02)
        assert p.gpu.breaker.state_name == "open"
        assert p.step(topics) == "DeviceDegraded"  # degraded, loudly
        # abandonment released the wedge: the stale thread completes and
        # its install is discarded, while probes drive a fresh rebuild
        deadline = time.monotonic() + 30
        recovered = {}
        while len(recovered) < 2:
            assert time.monotonic() < deadline, "never recovered"
            for i, m in enumerate(p.both):
                if i not in recovered:
                    got = p.outcome(m, topics)
                    if isinstance(got, list):
                        recovered[i] = got
            time.sleep(0.05)
        assert recovered[0] == recovered[1]
        for w in wds:
            assert w.stats()["watchdog_late_discarded"] >= 1
        assert p.gpu.breaker.state_name == "closed"
        assert all(p.step(p.rng.sample(grown, 16)))
        p.same_counters(("rebuild_abandons", "device_failures"))
    finally:
        for w in wds:
            w.stop()


def test_kernel_error_is_never_degraded(monkeypatch):
    """A kernel that refuses its inputs or fails to launch is a fault of
    the code: match_batch and match_many raise it as it is, the breaker
    hears nothing, and nothing is answered from the host."""
    from vernemq_tpu_torch.ops import tile_match as TM

    p = Pair(threshold=1)
    gpu = p.gpu
    p.outcome(gpu, p.topics())  # first build, healthy

    def broken(*a, **k):
        raise TM.KernelError("tile_match kernel launch failed: CUDA error 9")

    monkeypatch.setattr(TM, "window_tiles_packed", broken)
    for call in (lambda: gpu.match_batch(p.topics()),
                 lambda: gpu.match_many([p.topics(), p.topics()])):
        with pytest.raises(TM.KernelError):
            call()
    assert gpu.device_failures == 0 and gpu.host_fallbacks == 0
    assert gpu.breaker.state_name == "closed"


CUDA_FAULT = "CUDA error: an illegal memory access was encountered"


def _cuda_fault():
    """What torch raises after a kernel faulted on the card: a
    ``torch.AcceleratorError`` where torch has it, else a RuntimeError with
    CUDA's message."""
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    try:
        return cls(CUDA_FAULT)
    except TypeError:  # a constructor that wants more than a message
        return RuntimeError(CUDA_FAULT)


def _faulted(*a, **k):
    raise _cuda_fault()


@pytest.mark.parametrize("call", ["match_batch", "match_many"])
@pytest.mark.parametrize("seam", ["kernel", "download"])
def test_cuda_fault_is_a_kernel_error(monkeypatch, seam, call):
    """A kernel that faults on the card (an illegal address, a launch
    failure) is not seen at its launch: torch raises the CUDA error from
    the next launch or copy, and again from every later one. The matcher
    raises it as KernelError, and from then on every call does, from its
    sync, without another launch; the breaker hears nothing and nothing is
    answered from the host."""
    from vernemq_tpu_torch.ops import tile_match as TM

    p = Pair(threshold=1)
    gpu = p.gpu
    p.outcome(gpu, p.topics())  # first build, healthy
    if seam == "kernel":
        monkeypatch.setattr(TM, "window_tiles_packed", _faulted)
    else:  # the device→host copy of the result
        monkeypatch.setattr(GM.K, "unpack_flat_result", _faulted)
        monkeypatch.setattr(GM.K, "unpack_many_results", _faulted)
    run = {"match_batch": lambda: gpu.match_batch(p.topics()),
           "match_many": lambda: gpu.match_many([p.topics(), p.topics()])}
    with pytest.raises(TM.KernelError, match="illegal memory access"):
        run[call]()
    monkeypatch.undo()  # the seam is healthy again; the context is not
    for again in run.values():
        with pytest.raises(TM.KernelError, match="illegal memory access"):
            again()
    assert gpu.device_failures == 0 and gpu.host_fallbacks == 0
    assert gpu.super_dispatches == 0
    assert gpu.breaker.state_name == "closed"
    assert gpu.breaker.status()["failures"] == 0


def test_cuda_fault_in_background_build_is_a_kernel_error(monkeypatch):
    """A background rebuild that hits a CUDA fault is not retried build
    after build while the trie serves: the next sync raises KernelError,
    and so does every one after it, with the breaker untouched. A delta
    scatter that hits one does the same, without a rebuild."""
    from vernemq_tpu_torch.ops import tile_match as TM

    p = _async_pair()
    gpu = p.gpu
    p.outcome(gpu, p.topics())  # the first build is synchronous
    monkeypatch.setattr(GM.K, "build_operands", _faulted)
    p.grow_until_resize("g")
    assert p.outcome(gpu, p.topics()) == "RebuildInProgress"
    gpu._rebuild_thread.join(timeout=60)
    for _ in range(2):
        with pytest.raises(TM.KernelError, match="illegal memory access"):
            gpu.match_batch(p.topics())
    assert gpu.rebuilds_async == 1 and gpu.device_failures == 0
    assert gpu.breaker.state_name == "closed"


def test_cuda_fault_in_delta_sync_is_a_kernel_error(monkeypatch):
    """A delta scatter that hits a CUDA fault raises KernelError, and the
    sync after it raises again instead of starting a rebuild into the same
    fault while the trie serves."""
    from vernemq_tpu_torch.ops import tile_match as TM

    p = _async_pair()
    gpu = p.gpu
    p.outcome(gpu, p.topics())
    monkeypatch.setattr(GM.K, "apply_delta_fused_nometa", _faulted)
    p.add(["r1", "d1", "m1"], "late")
    for _ in range(2):
        with pytest.raises(TM.KernelError, match="illegal memory access"):
            gpu.match_batch(p.topics())
    assert gpu.rebuilds_async == 0 and gpu.device_failures == 0
    assert gpu.breaker.state_name == "closed"
