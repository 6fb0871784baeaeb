"""One process of the port's two-process mesh case
(tests/test_torch_mesh.py runs two of these): the counterpart of
tests/_mesh_dist_helper.py on ``torch.distributed`` with the gloo backend
on the CPU. Each process builds the SAME deterministic table, joins the
process group (two CPU devices each → a 4-slice mesh), places the
mesh-native matcher's state (each process only its own slices), and
prints ONE JSON line with

- per-topic partial fanout over its own slices (``match_local_slices``);
- the delta-route accounting of one write-through applied in both
  processes (each scatters only its own dirty slices);
- the match total of its partials summed over the group
  (``sharded_match._all_reduce_sum``, the sharded matcher's total);
- the windowed dispatch refused (no process holds every shard) and the
  seat degrading that to DeviceDegraded (the host trie serves);
- process 0 only: the slice-failure check — its partials plus the exact
  host walk over the OTHER process's rows reproduce the trie.
"""

import json
import os
import random
import sys


def corpus(table, trie, n=2000, seed=3):
    rng = random.Random(seed)
    l0 = [f"r{i}" for i in range(16)]
    l1 = [f"d{i}" for i in range(24)]
    l2 = [f"m{i}" for i in range(8)]
    for i in range(n):
        r = rng.random()
        w = [rng.choice(l0), rng.choice(l1), rng.choice(l2)]
        if r < 0.7:
            f = w
        elif r < 0.9:
            f = [w[0], "+", w[2]]
        else:
            f = [w[0], w[1], "#"]
        table.add(f, i, None)
        trie.add(list(f), i, None)
    table.add(["$SYS", "stats", "#"], "sys", None)
    trie.add(["$SYS", "stats", "#"], "sys", None)
    topics = [(rng.choice(l0), rng.choice(l1), rng.choice(l2))
              for _ in range(12)]
    topics += [("$SYS", "stats", "x"), ("never", "seen", "words")]
    return (l0, l1, l2), topics


def main() -> int:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=pid)
    from vernemq_tpu_torch.models.matcher import DeviceDegraded
    from vernemq_tpu_torch.models.table import SubscriptionTable
    from vernemq_tpu_torch.models.trie import SubscriptionTrie
    from vernemq_tpu_torch.parallel.mesh import global_devices, make_mesh
    from vernemq_tpu_torch.parallel.mesh_match import (MeshGpuMatcher,
                                                       MeshMatcher)
    from vernemq_tpu_torch.parallel.sharded_match import _all_reduce_sum
    from vernemq_tpu_torch.protocol.topic import match_dollar_aware

    table = SubscriptionTable(max_levels=8, initial_capacity=1 << 14)
    trie = SubscriptionTrie()
    pools, topics = corpus(table, trie)
    devices = global_devices(["cpu", "cpu"])
    assert [d.rank for d in devices] == [0, 0, 1, 1]
    mesh = make_mesh(devices, batch=1)
    m = MeshMatcher(table, mesh, max_fanout=128)
    m.sync()
    addressable = sorted(m.addressable_slices())

    def resolve(slot_ids):
        ent = table.entries
        return sorted(repr(ent[i][1]) for i in slot_ids
                      if ent[i] is not None)

    ids, ranges = m.match_local_slices(topics)
    partial = [resolve(sl) for sl in ids]
    total = _all_reduce_sum(sum(len(sl) for sl in ids))

    # the windowed dispatch needs every shard: refused here, and the seat
    # turns that into DeviceDegraded (its breaker fed, the trie serves)
    try:
        m.match_batch(topics[:2])
        refused = False
    except RuntimeError as e:
        refused = "held by process" in str(e)
    seat = MeshGpuMatcher(mesh, max_levels=8, initial_capacity=1 << 14,
                          max_fanout=128)
    with seat.lock:
        for e in table.entries:
            if e is not None:
                seat.table.add(list(e[0]), e[1], None)
    try:
        seat.match_batch(topics[:2])
        degraded = False
    except DeviceDegraded:
        degraded = seat.device_failures == 1

    # delta-route phase: BOTH processes apply the same write-through (the
    # metadata plane replicates subscription events everywhere); each
    # scatters only its own dirty slices
    l0, l1, l2 = pools
    table.add([l0[1], l1[1], "fresh"], "late", None)
    trie.add([l0[1], l1[1], "fresh"], "late", None)
    m.sync()
    route = {
        "dirty": m.last_route["dirty_slices"],
        "addressable": addressable,
        "routed": m.route_dirty_slices,
        "full_scatters": m.full_scatters,
    }
    ids2, _ = m.match_local_slices(topics + [(l0[1], l1[1], "fresh")])
    partial2 = [resolve(sl) for sl in ids2]

    degraded_ok = None
    if pid == 0:
        # slice failure: the peer's slices are gone — this process's
        # partial device fanout + the exact host walk over the FAILED row
        # ranges must reproduce the trie
        owned = set()
        for lo, hi in ranges:
            owned.update(range(lo, hi))
        degraded_ok = True
        ent = table.entries
        for tp, sl in zip(topics, ids):
            host_rows = sorted(
                repr(e[1]) for i, e in enumerate(ent)
                if e is not None and i not in owned
                and match_dollar_aware(list(tp), list(e[0])))
            want = sorted(repr(k) for _, k, _ in trie.match(list(tp)))
            if sorted(resolve(sl) + host_rows) != want:
                degraded_ok = False
                break

    print(json.dumps({
        "pid": pid, "addressable": addressable,
        "ranges": ranges, "partial": partial, "partial2": partial2,
        "route": route, "degraded_ok": degraded_ok, "total": total,
        "refused": refused, "seat_degraded": degraded,
    }), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
