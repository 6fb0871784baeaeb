"""The port's SWC metadata plane (``vernemq_tpu_torch/cluster/swc_*``)
beside the reference's: the logical-clock kernel's functions on the same
operation sequences, made from a seed, give equal results in both
packages, and two port ``SWCMetadata`` stores converge as the reference's
do under the same script of writes, deletes, partitions, anti-entropy
exchanges and garbage collection."""

import asyncio
import random

from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_port  # noqa: F401  (one intra-op thread per worker)
from vernemq_tpu.cluster import swc_kernel as RK
from vernemq_tpu.cluster import swc_store as RS
from vernemq_tpu_torch.cluster import swc_kernel as PK
from vernemq_tpu_torch.cluster import swc_store as PS

NODES = ["n1", "n2", "n3"]


def _kernel_steps(rng: random.Random, K, n: int):
    """Apply ``n`` random kernel operations (drawn from ``rng``) to one
    kernel module; returns every result in order."""
    out = []
    clock, other = K.bvv_new(), K.bvv_new()
    obj, obj2 = K.dcc_new(), K.dcc_new()
    wm, dkm = K.wm_new(), K.DotKeyMap()
    for _ in range(n):
        op = rng.randrange(12)
        nid = rng.choice(NODES)
        if op == 0:
            c, clock = K.bvv_event(clock, nid)
            out.append(("event", c, dict(clock)))
        elif op == 1:
            other = K.bvv_add(other, (nid, rng.randint(1, 40)))
            out.append(("add", dict(other)))
        elif op == 2:
            out.append(("merge", K.bvv_merge(clock, other),
                        K.bvv_base(K.bvv_merge(other, clock))))
        elif op == 3:
            out.append(("missing", sorted(K.bvv_missing_dots(clock, other)),
                        sorted(K.bvv_missing_dots(other, clock))))
        elif op == 4:
            e = (rng.randint(0, 9), rng.getrandbits(12))
            f = (rng.randint(0, 9), rng.getrandbits(12))
            out.append(("entry", K.entry_norm(e), K.entry_join(e, f),
                        K.entry_missing(e, f), K.entry_add(e, rng.randint(1, 30)),
                        K.entry_contains(e, rng.randint(1, 30))))
        elif op == 5:
            obj = K.dcc_add(K.dcc_discard(K.dcc_fill(obj, clock),
                                          K.dcc_context(obj)),
                            (nid, rng.randint(1, 40)), rng.randint(0, 99))
            out.append(("write", sorted(obj[0].items()), dict(obj[1])))
        elif op == 6:
            obj2 = K.dcc_add(obj2, (nid, rng.randint(1, 40)),
                             rng.choice([K.DELETED, rng.randint(0, 99)]))
            synced = K.dcc_sync(obj, obj2)
            out.append(("sync", sorted(synced[0].items(), key=repr),
                        dict(synced[1]), sorted(map(repr, K.dcc_values(synced)))))
        elif op == 7:
            s = K.dcc_strip(obj, clock)
            out.append(("strip", sorted(s[0].items(), key=repr), dict(s[1]),
                        dict(K.dcc_fill(s, clock)[1])))
        elif op == 8:
            out.append(("bvv+dcc", K.bvv_add_dcc(other, obj),
                        K.bvv_contains(clock, (nid, rng.randint(1, 9)))))
        elif op == 9:
            wm = K.wm_update_peer(wm, nid, clock)
            wm = K.wm_update_cell(wm, nid, rng.choice(NODES),
                                  rng.randint(0, 20))
            out.append(("wm", {k: dict(v) for k, v in wm.items()},
                        K.wm_min(wm, nid, NODES[:2]),
                        K.wm_fix(wm, NODES[:2]),
                        K.wm_left_join(wm, K.wm_new())))
        elif op == 10:
            c = rng.randint(1, 20)
            dkm.insert(nid, c, f"k{c % 5}")
            if rng.random() < 0.5:
                dkm.mark_for_gc(f"k{rng.randrange(5)}")
            out.append(("dkm", dkm.lookup((nid, c)), dkm.object_count(),
                        dkm.tombstone_count()))
        else:
            deletable, pruned = dkm.prune(wm, NODES[:2])
            out.append(("prune", sorted(deletable), sorted(pruned),
                        K.dcc_from_wire(K.dcc_to_wire(obj)) == obj))
    return out


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 60))
def test_kernel_sequences_equal_the_reference(seed, n):
    assert _kernel_steps(random.Random(seed), PK, n) \
        == _kernel_steps(random.Random(seed), RK, n)


class _Clock:
    """A wall clock that ticks once per read: LWW timestamps then follow
    the script's order alike in both packages."""

    def __init__(self):
        self.now = 1_000_000.0

    def time(self):
        self.now += 1.0
        return self.now

    def monotonic(self):
        return self.now


class _Hub:
    """The framed TCP channel of the reference's store tests, as a
    loopback between in-process stores (tests/test_swc.py ``Hub``)."""

    def __init__(self, stores):
        self.stores = {s.node_name: s for s in stores}
        self.cut = False
        for s in stores:
            s.attach_cluster(_Port(self, s.node_name))
            s.set_peers(list(self.stores))


class _Port:
    def __init__(self, hub, me):
        self.hub, self.me = hub, me

    def swc_send_all(self, term):
        if not self.hub.cut:
            for name, store in self.hub.stores.items():
                if name != self.me:
                    store.handle_swc_cast(self.me, term)

    async def swc_call(self, node, term, timeout=10.0):
        if self.hub.cut:
            raise ConnectionError(f"{self.me} cut from {node}")
        return self.hub.stores[node].handle_swc_call(self.me, term)

    def status(self):
        return [(n, True) for n in self.hub.stores if n != self.me]


def _store_script(S, steps):
    """Run ``steps`` on two stores of package module ``S``; returns the
    state of both after every step and after the final heal."""
    clock = _Clock()
    saved = S.time
    S.time = clock
    try:
        a = S.SWCMetadata("n1", n_groups=2, sync_interval=999)
        b = S.SWCMetadata("n2", n_groups=2, sync_interval=999)
        hub = _Hub([a, b])
        events = []
        for s in (a, b):
            s.subscribe("subs", lambda k, old, new, origin, s=s: events.append(
                (s.node_name, k, old, new, origin)))
        stores = {"n1": a, "n2": b}
        trace = []

        def state():
            return ([sorted(dict(s.fold("subs")).items()) for s in (a, b)],
                    [s.stats() for s in (a, b)])

        async def run():
            for op, who, key, val in steps:
                s = stores[who]
                if op == "put":
                    s.put("subs", key, val)
                elif op == "del":
                    s.delete("subs", key)
                elif op == "cut":
                    hub.cut = True
                elif op == "heal":
                    hub.cut = False
                elif op == "ae" and not hub.cut:
                    await s.exchange_with("n2" if who == "n1" else "n1")
                elif op == "gc":
                    for g in s.groups:
                        g.gc()
                trace.append(state())
            hub.cut = False
            for _ in range(3):
                await a.exchange_with("n2")
                await b.exchange_with("n1")
                for g in a.groups + b.groups:
                    g.gc()
            trace.append(state())

        asyncio.run(run())
        return trace, events
    finally:
        S.time = saved


_steps = st.lists(st.tuples(
    st.sampled_from(["put", "put", "put", "del", "cut", "heal", "ae", "gc"]),
    st.sampled_from(["n1", "n2"]),
    st.sampled_from([("", "c0"), ("", "c1"), ("", "c2"), ("mp", "c0")]),
    st.lists(st.sampled_from(["a/+", "b/#", "c"]), max_size=3)),
    min_size=1, max_size=25)


@settings(max_examples=25, deadline=None)
@given(steps=_steps)
def test_two_stores_converge_as_the_reference(steps):
    """Step for step the port's two stores hold what the reference's hold
    (values and store stats), they fire the same change events, and after
    the partition heals and anti-entropy runs both converge to one
    state."""
    got, got_events = _store_script(PS, steps)
    want, want_events = _store_script(RS, steps)
    assert got == want
    assert got_events == want_events
    (final_a, final_b), _ = got[-1]
    assert final_a == final_b
