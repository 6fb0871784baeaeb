"""The collector's added latency over the trie, at paced arrival rates.

    python -m vernemq_tpu_torch.tools.collector_latency [--subs 1000000]
        [--secs 10] [--rates 2000,10000,40000,80000] [--window-us 200]
        [--max-batch 4096] [--host-threshold 0] [--device cuda|cpu]
        [--json FILE]

In one process, no sockets: the object under test is the serving path
between ``reg.publish``'s fold call and its match rows — the port's
``BatchCollector`` (window close, host prep, device dispatch, result
scatter) over a ``GpuRegView`` whose matcher holds the headline corpus
(:mod:`.corpus`). For each rate of the ladder the same paced arrival
process of zipf publishes runs first against the synchronous trie fold
(the reference broker's inline fold, ``vmq_reg.erl:257-319``), then
through the collector, so the added latency is a like-for-like
difference on one corpus and one publish distribution. Each rate prints
the trie's and the collector's p50 / p99 (from submit to rows), their
difference, the publishes the device served and those served on the host
(per collector counter and the matcher's host fallbacks), the queue wait
at flush start (``stage_collector_wait_ms``, p50 / p99), and with
``--check`` (the default) the publishes whose rows differ from the
trie's, which must be none.

The port's collector takes ``host_threshold`` 0 by default, so the device
serves every flush at every rate: a departure from the reference's
hybrid dispatch, whose tool defaults to a threshold of 8 (small flushes
on the host) and reads where the device engages. ``--host-threshold``
sets it (the broker's ``tpu_host_batch_threshold`` keeps the
reference's 8).

On the card by default (``RuntimeError`` without one); ``--device cpu``
runs the plain path at a smoke size (at most 20,000 subscriptions).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Dict, List, Sequence

import numpy as np

#: the collector's counters of publishes served off the device
HOST_COUNTERS = ("host_hybrid_pubs", "busy_host_pubs", "rebuild_host_pubs",
                 "overload_host_pubs", "degraded_host_pubs",
                 "expired_host_pubs", "stalled_host_pubs")


def pctl(vals, q) -> float:
    return float(np.percentile(np.asarray(vals), q)) if len(vals) else 0.0


class _Registry:
    """The two seams ``GpuRegView`` and ``BatchCollector`` read: the host
    trie (the shed target) and the warm-load iterator (empty: the matcher
    is handed in built)."""

    def __init__(self, trie):
        self._trie = trie

    def trie(self, mountpoint=""):
        return self._trie

    def fold_subscriptions(self, mountpoint=""):
        return iter(())


def serving_view(m, trie):
    """A ``GpuRegView`` seating the built matcher ``m`` for mountpoint
    ``""``, over a registry whose trie is ``trie``."""
    from ..models.matcher import GpuRegView

    view = GpuRegView(_Registry(trie), max_levels=m.table.L,
                      device=m.device)
    view._matchers[""] = m
    return view


async def drive(submit, topics: Sequence, rate: float, secs: float):
    """Paced arrivals: ``rate`` submissions a second for ``secs`` seconds,
    in order from ``topics``. Returns ``(latencies_s, results)``, a result
    per submitted topic (the rows, or the future that held them). Behind
    schedule it still yields, so the collector's timers and completions
    run (holding the loop would charge the load generator's delay to
    them)."""
    lat: List[float] = []
    results: List = []
    pending = []
    interval = 1.0 / rate
    t_end = time.perf_counter() + secs
    next_at = time.perf_counter()
    for topic in topics:
        if time.perf_counter() >= t_end:
            break
        now = time.perf_counter()
        await asyncio.sleep(max(0.0, next_at - now))
        next_at += interval
        t0 = time.perf_counter()
        res = submit(topic)
        if asyncio.isfuture(res):
            pending.append(res)
            res.add_done_callback(
                lambda f, t0=t0: lat.append(time.perf_counter() - t0))
        else:
            lat.append(time.perf_counter() - t0)
        results.append(res)
    if pending:
        await asyncio.gather(*pending, return_exceptions=True)
    return lat, results


def _key(rows):
    return sorted((tuple(f), str(k)) for f, k, _ in rows)


async def ladder(view, m, trie, draw, rates: Sequence[float],
                 secs: float, window_us: int = 200, max_batch: int = 4096,
                 host_threshold: int = 0, lock_busy_shed_ms: int = 500,
                 check: bool = True) -> List[Dict]:
    """One row per rate (see the module docstring); ``draw(n)`` gives n
    publish topics. A fresh collector per rate, so its counters are that
    rate's."""
    from ..models.matcher import BatchCollector
    from ..observability import histogram as hist

    rows = []
    for rate in rates:
        n = int(rate * secs) + 16
        col = BatchCollector(view, window_us=window_us, max_batch=max_batch,
                             host_threshold=host_threshold,
                             lock_busy_shed_ms=lock_busy_shed_ms)
        tr_lat, _ = await drive(lambda t: trie.match(list(t)), draw(n),
                                rate, secs)
        pubs0, fb0 = m.match_publishes, m.host_fallbacks
        wait0 = hist.get("stage_collector_wait_ms").snapshot()
        topics = draw(n)
        dv_lat, futs = await drive(lambda t: col.submit("", t), topics,
                                   rate, secs)
        wait = hist.summary(hist.diff(
            hist.get("stage_collector_wait_ms").snapshot(), wait0))
        wrong = failed = 0
        if check:
            for t, f in zip(topics, futs):
                if f.exception() is not None:
                    failed += 1
                elif _key(f.result()) != _key(trie.match(list(t))):
                    wrong += 1
        host = {c: getattr(col, c, 0) for c in HOST_COUNTERS}
        host["host_fallbacks"] = m.host_fallbacks - fb0
        rows.append({
            "rate_pubs_per_sec": rate,
            "achieved_trie_rate": len(tr_lat) / secs,
            "achieved_device_rate": len(dv_lat) / secs,
            "trie_ms_p50": 1e3 * pctl(tr_lat, 50),
            "trie_ms_p99": 1e3 * pctl(tr_lat, 99),
            "device_ms_p50": 1e3 * pctl(dv_lat, 50),
            "device_ms_p99": 1e3 * pctl(dv_lat, 99),
            "added_ms_p50": 1e3 * (pctl(dv_lat, 50) - pctl(tr_lat, 50)),
            "added_ms_p99": 1e3 * (pctl(dv_lat, 99) - pctl(tr_lat, 99)),
            "served_device_pubs": m.match_publishes - pubs0,
            "host_served_pubs": sum(host.values()), "host": host,
            "queue_wait_ms_p50": wait.get("p50_ms", 0.0),
            "queue_wait_ms_p99": wait.get("p99_ms", 0.0),
            "flushes": wait.get("count", 0),
            "checked": len(futs) if check else 0,
            "mismatched": wrong, "failed": failed,
        })
    return rows


def main(argv=None) -> Dict:
    from ..device import resolve_device
    from ..models.trie import SubscriptionTrie
    from .corpus import headline_matcher, zipf_topics

    ap = argparse.ArgumentParser(
        prog="python -m vernemq_tpu_torch.tools.collector_latency")
    ap.add_argument("--subs", type=int, default=1_000_000)
    ap.add_argument("--secs", type=float, default=10.0)
    ap.add_argument("--rates", default="2000,10000,40000,80000",
                    type=lambda s: [float(x) for x in s.split(",")])
    ap.add_argument("--window-us", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--max-fanout", type=int, default=256)
    ap.add_argument("--flat-avg", type=int, default=128)
    ap.add_argument("--host-threshold", type=int, default=0)
    ap.add_argument("--lock-busy-shed-ms", type=int, default=500)
    ap.add_argument("--no-check", dest="check", action="store_false")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (a smoke size)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    subs = min(args.subs, 20_000) if dev.type == "cpu" else args.subs
    t0 = time.perf_counter()
    m, pools, rng = headline_matcher(subs, device=dev,
                                     max_fanout=args.max_fanout,
                                     flat_avg=args.flat_avg, seed=args.seed)
    trie = SubscriptionTrie()
    for e in m.table.entries:
        if e is not None:
            trie.add(list(e[0]), e[1], e[2])
    print(f"# corpus of {subs} subscriptions on {dev} in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    view = serving_view(m, trie)

    async def run():
        return await ladder(view, m, trie,
                            lambda n: zipf_topics(rng, pools, n), args.rates,
                            args.secs, args.window_us, args.max_batch,
                            args.host_threshold, args.lock_busy_shed_ms,
                            args.check)

    rows = asyncio.run(run())
    for r in rows:
        print(json.dumps(r), flush=True)
    out = {"device": str(dev), "subs": subs, "window_us": args.window_us,
           "max_batch": args.max_batch,
           "host_threshold": args.host_threshold, "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    if any(r["mismatched"] or r["failed"] for r in rows):
        raise SystemExit("collector_latency: rows differ from the trie's")
    return out


if __name__ == "__main__":
    main()
