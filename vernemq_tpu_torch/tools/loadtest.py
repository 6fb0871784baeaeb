"""Broker load test: real MQTT clients over TCP on localhost against the
port's broker.

    python -m vernemq_tpu_torch.tools.loadtest [--subs 50] [--pubs 8]
        [--secs 5] [--view tpu|trie] [--qos 0] [--window 32]
        [--workers 4] [--client-procs 4] [--latency] [--device cuda|cpu]

It measures publish→delivery throughput through the whole broker (parser,
session, registry, the reg view — the GPU view's collector and matcher
with ``--view tpu``, the default —, queue, writer), the layer above the
kernels' numbers. Two modes:

- one process (default): the broker in this process on ``--device``, the
  clients inline on its event loop;
- ``--workers N``: the port's ``WorkerGroup`` of N ``SO_REUSEPORT``
  worker processes, with ``--view tpu`` behind one match service that
  holds the GPU view on ``--device``, and the clients spread over
  ``--client-procs`` processes so the harness is not the interpreter lock
  it measures around.

Subscriber i subscribes ``lt/{i % 16}/+``; publisher p sends ``lt/{j %
16}/m{p}`` in turn. After the publishers stop, each subscriber drains
until it has been quiet for ``--drain-s``; every subscriber's deliveries
are then held against the trie's rows for the topics that were published
(``expected`` and ``mismatched_subscribers`` in the report); the command
exits 1 when they differ.
``--latency`` stamps every 16th payload with the sender's monotonic clock
(system-wide, so comparable across processes) and reports p50 / p99.

With ``--view tpu`` every flush goes to the device
(``tpu_host_batch_threshold`` 0; the broker's configuration keeps the
reference's 8, which serves flushes of fewer publishes on the host trie).
On the card by default (``RuntimeError`` without one, also for ``--view
trie``, whose broker still builds its device views); ``--device cpu`` runs
the plain path.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import multiprocessing as mp
import socket
import struct
import sys
import time
from typing import Dict

_LAT_MAGIC = b"LT1"
_SAMPLE_EVERY = 16


def _now_ns() -> int:
    return time.monotonic_ns()


def sub_filter(i: int) -> str:
    return f"lt/{i % 16}/+"


async def run_clients(host: str, port: int, sub_ids, pub_ids, secs: float,
                      qos: int = 0, window: int = 1, payload_len: int = 64,
                      latency: bool = False, tag: str = "",
                      rate: float = 0.0, lat_skip_secs: float = 0.0,
                      drain_s: float = 0.5, barrier=None) -> Dict:
    """Drive one shard of subscribers and publishers. With ``barrier`` (a
    ``multiprocessing`` barrier of every shard) no shard publishes before
    every shard's subscriptions are acknowledged: a publish sent earlier
    would miss a later shard's subscriber that the expected count holds.
    Returns sent, failed (QoS 1 publishes whose ack failed), received,
    each subscriber's deliveries, each topic's publishes, the publishing
    window's wall and the latency samples (ns)."""
    from ..client import MQTTClient

    received = collections.Counter()
    topics = collections.Counter()
    lat_ns = []
    done = asyncio.Event()
    subscribed = asyncio.Event()
    n_subscribed = 0
    lat_from = time.perf_counter() + lat_skip_secs

    async def subscriber(i: int) -> None:
        c = MQTTClient(host, port, f"lt-sub{tag}{i}")
        await c.connect()
        await c.subscribe(sub_filter(i), qos=qos)
        nonlocal n_subscribed
        n_subscribed += 1
        if n_subscribed == len(sub_ids):
            subscribed.set()
        while True:
            try:
                f = await c.recv(drain_s)
            except asyncio.TimeoutError:
                if done.is_set():
                    break
                continue
            if f is None:
                break
            received[i] += 1
            if latency and f.payload[:3] == _LAT_MAGIC \
                    and time.perf_counter() >= lat_from:
                t0 = struct.unpack(">Q", f.payload[3:11])[0]
                lat_ns.append(_now_ns() - t0)
        await c.disconnect()

    sent = failed = 0

    async def publisher(i: int, stop: asyncio.Event) -> None:
        nonlocal sent, failed
        c = MQTTClient(host, port, f"lt-pub{tag}{i}")
        await c.connect()
        base_payload = b"x" * payload_len
        j = 0
        inflight: set = set()

        def reap(f):
            nonlocal failed
            inflight.discard(f)
            if not f.cancelled() and f.exception() is not None:
                failed += 1

        interval = (1.0 / rate) if rate > 0 else 0.0
        next_at = time.perf_counter()
        while not stop.is_set():
            if interval:
                now = time.perf_counter()
                if now < next_at:
                    await asyncio.sleep(next_at - now)
                next_at += interval
            payload = base_payload
            if latency and j % _SAMPLE_EVERY == 0:
                stamp = _LAT_MAGIC + struct.pack(">Q", _now_ns())
                payload = stamp + base_payload[len(stamp):] \
                    if payload_len > len(stamp) else stamp
            topic = f"lt/{j % 16}/m{tag}{i}"
            if qos and window > 1:
                # up to `window` unacked QoS 1 publishes in flight
                fut = asyncio.ensure_future(c.publish(topic, payload,
                                                      qos=qos))
                inflight.add(fut)
                fut.add_done_callback(reap)
                if len(inflight) >= window:
                    await asyncio.wait(inflight,
                                       return_when=asyncio.FIRST_COMPLETED)
            else:
                await c.publish(topic, payload, qos=qos)
            topics[topic] += 1
            sent += 1
            j += 1
            if j % 64 == 0:
                await asyncio.sleep(0)
        if inflight:
            await asyncio.gather(*inflight, return_exceptions=True)
        await c.disconnect()

    subs = [asyncio.create_task(subscriber(i)) for i in sub_ids]
    if sub_ids:
        await asyncio.wait_for(subscribed.wait(), 60)
    if barrier is not None:
        await asyncio.get_running_loop().run_in_executor(None, barrier.wait,
                                                         60)
    # the subscriptions reach the other workers' tables
    await asyncio.sleep(0.5)
    stop = asyncio.Event()
    t0 = time.perf_counter()
    pubs = [asyncio.create_task(publisher(i, stop)) for i in pub_ids]
    await asyncio.sleep(secs)
    stop.set()
    await asyncio.gather(*pubs)
    elapsed = time.perf_counter() - t0
    done.set()
    await asyncio.gather(*subs)
    return {"sent": sent, "failed": failed,
            "received": sum(received.values()),
            "by_sub": dict(received), "topics": dict(topics),
            "elapsed": elapsed, "lat_ns": lat_ns}


def client_proc(host, port, sub_ids, pub_ids, secs, qos, window,
                payload_len, latency, tag, out_q, rate=0.0,
                lat_skip_secs=0.0, drain_s=0.5, barrier=None) -> None:
    """Spawn-safe entry point of one client shard: puts
    :func:`run_clients`' result on ``out_q``."""
    out_q.put(asyncio.run(run_clients(host, port, sub_ids, pub_ids, secs,
                                      qos, window, payload_len, latency,
                                      tag, rate, lat_skip_secs, drain_s,
                                      barrier)))


def expected_deliveries(sub_ids, topics: Dict[str, int]) -> Dict[int, int]:
    """Each subscriber's deliveries as the trie gives them: the sum, over
    the published topics its filter matches, of their publishes."""
    from ..models.trie import SubscriptionTrie

    trie = SubscriptionTrie()
    for i in sub_ids:
        trie.add(sub_filter(i).split("/"), i, None)
    want = collections.Counter()
    for topic, n in topics.items():
        for _, i, _ in trie.match(topic.split("/")):
            want[i] += n
    return {i: want[i] for i in sub_ids}


def _pctile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def merge(results, sub_ids) -> Dict:
    """One report of the shards' results: rates, latency and the
    deliveries held against the trie's."""
    topics = collections.Counter()
    by_sub = collections.Counter()
    for r in results:
        topics.update(r["topics"])
        by_sub.update(r["by_sub"])
    sent = sum(r["sent"] for r in results)
    failed = sum(r["failed"] for r in results)
    received = sum(r["received"] for r in results)
    elapsed = max(r["elapsed"] for r in results)
    want = expected_deliveries(sub_ids, topics)
    lat = sorted(x for r in results for x in r["lat_ns"])
    out = {"sent": sent, "failed": failed, "received": received,
           "expected": sum(want.values()),
           "mismatched_subscribers": sum(by_sub[i] != n
                                         for i, n in want.items()),
           "elapsed_s": elapsed,
           "pubs_per_s": (sent - failed) / elapsed,
           "deliveries_per_s": received / elapsed}
    if lat:
        out.update(latency_ms_p50=_pctile(lat, 0.50) / 1e6,
                   latency_ms_p99=_pctile(lat, 0.99) / 1e6,
                   latency_samples=len(lat))
    return out


def free_port_block(n: int = 1, start: int = 20000) -> int:
    """The first base from ``start`` (below the ephemeral range) with
    ``n`` consecutive free loopback ports."""
    for base in range(start, 32000 - n, 97):
        socks = []
        try:
            for i in range(n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError(f"no block of {n} free ports")


async def run_inproc(args, dev) -> Dict:
    """The broker in this process on ``dev``, the clients on its loop."""
    from ..broker.config import Config
    from ..broker.server import start_broker

    b, server = await start_broker(
        Config(systree_enabled=False, allow_anonymous=True,
               default_reg_view=args.view, sysmon_enabled=False,
               tpu_host_batch_threshold=0),
        port=0, device=dev)
    try:
        res = await run_clients(
            server.host, server.port, range(args.subs), range(args.pubs),
            args.secs, args.qos, args.window, args.payload, args.latency,
            "", args.rate, args.lat_skip_secs, args.drain_s)
        out = merge([res], list(range(args.subs)))
        col = getattr(b, "_collector", None)  # made by the first flush
        if col is not None:
            ms = list(getattr(col.view, "_matchers", {}).values())
            out["collector"] = {
                "device_batches": sum(m.match_batches for m in ms),
                "device_pubs": sum(m.match_publishes for m in ms),
                "host_fallbacks": sum(m.host_fallbacks for m in ms),
                **{c: getattr(col, c) for c in (
                    "host_hybrid_pubs", "overload_host_pubs",
                    "busy_host_pubs", "rebuild_host_pubs",
                    "degraded_host_pubs", "expired_host_pubs")}}
    finally:
        await b.stop()
        await server.stop()
    return out


def run_workers(args, dev) -> Dict:
    """A ``WorkerGroup`` of ``--workers`` processes (with ``--view tpu``
    behind one match service on ``dev``), the clients in
    ``--client-procs`` processes."""
    import queue

    from ..broker.workers import WorkerGroup

    port = free_port_block()
    kw = {}
    if args.view == "tpu":
        kw = dict(match_service=True, match_view="tpu",
                  match_device=str(dev), tpu_host_batch_threshold=0)
    group = WorkerGroup(args.workers, "127.0.0.1", port,
                        cluster_base=free_port_block(args.workers, port + 1),
                        allow_anonymous=True,
                        systree_enabled=False, sysmon_enabled=False, **kw)
    group.start()
    procs = []
    try:
        deadline = time.time() + 120
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 0.5).close()
                break
            except OSError:
                if time.time() > deadline:
                    raise RuntimeError("workers never became reachable")
                time.sleep(0.3)
        time.sleep(1.5)  # the worker mesh forms
        nproc = args.client_procs or args.workers
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue()
        barrier = ctx.Barrier(nproc)
        for p in range(nproc):
            procs.append(ctx.Process(target=client_proc, args=(
                "127.0.0.1", port,
                [i for i in range(args.subs) if i % nproc == p],
                [i for i in range(args.pubs) if i % nproc == p],
                args.secs, args.qos, args.window, args.payload,
                args.latency, f"p{p}-", out_q, args.rate,
                args.lat_skip_secs, args.drain_s, barrier)))
        for p in procs:
            p.start()
        results = []
        try:
            for _ in procs:
                results.append(out_q.get(timeout=args.secs + 120))
        except queue.Empty:
            print(f"loadtest: only {len(results)} of {len(procs)} client "
                  f"shards reported", file=sys.stderr, flush=True)
        if not results:
            raise RuntimeError("no client shard reported")
        out = merge(results, list(range(args.subs)))
        out["shards_reported"] = len(results)
        return out
    finally:
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
        group.stop()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m vernemq_tpu_torch.tools.loadtest")
    ap.add_argument("--subs", type=int, default=50)
    ap.add_argument("--pubs", type=int, default=8)
    ap.add_argument("--secs", type=float, default=5.0)
    ap.add_argument("--qos", type=int, default=0)
    ap.add_argument("--view", default="tpu", choices=("tpu", "trie"))
    ap.add_argument("--payload", type=int, default=64)
    ap.add_argument("--window", type=int, default=1,
                    help="unacked QoS 1 publishes per publisher (1: await "
                         "each ack)")
    ap.add_argument("--workers", type=int, default=0,
                    help="N SO_REUSEPORT worker processes (0: one "
                         "in-process broker)")
    ap.add_argument("--client-procs", type=int, default=0,
                    help="client shard processes (default: --workers)")
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--lat-skip-secs", type=float, default=0.0,
                    help="drop latency samples of the first N seconds")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="publishes a second per publisher (0: as fast as "
                         "it can)")
    ap.add_argument("--drain-s", type=float, default=2.0,
                    help="a subscriber stops after this long quiet, once "
                         "the publishers stopped")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> Dict:
    from ..device import resolve_device

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.workers:
        out = run_workers(args, dev)
    else:
        out = asyncio.run(run_inproc(args, dev))
    out.update(view=args.view, qos=args.qos, workers=args.workers,
               device=str(dev), subscribers=args.subs,
               publishers=args.pubs)
    line = (f"view={args.view} qos={args.qos} workers={args.workers} "
            f"device={dev} pubs/s={out['pubs_per_s']:.0f} "
            f"deliveries/s={out['deliveries_per_s']:.0f} "
            f"deliveries {out['received']} of {out['expected']} "
            f"(subscribers={args.subs}, publishers={args.pubs}, "
            f"mismatched={out['mismatched_subscribers']})")
    if "latency_ms_p50" in out:
        line += (f" latency_ms p50={out['latency_ms_p50']:.2f} "
                 f"p99={out['latency_ms_p99']:.2f} "
                 f"(n={out['latency_samples']})")
    out["ok"] = (out["received"] == out["expected"]
                 and not out["mismatched_subscribers"])
    print(line, flush=True)
    if not out["ok"]:
        print("loadtest: FAILED: the deliveries differ from the trie's",
              flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
