"""Cross-worker fanout efficiency of the port's worker mode.

    python -m vernemq_tpu_torch.tools.worker_efficiency [--secs 20]
        [--subs 16] [--pubs 4] [--qos 1] [--window 32] [--trials 1]
        [--view tpu|trie] [--device cuda|cpu] [--json FILE]

Subscribers and publishers are pinned to chosen workers of a
``WorkerGroup`` through its per-worker direct ports, and deliveries/s are
measured for three placements:

- ``local1``: one worker, subscribers and publishers on it (the baseline
  T1);
- ``local2``: two workers, both sides on worker 0 (the group's overhead
  without the hop; worker 1 idle);
- ``cross2``: two workers, subscribers on worker 0 and publishers on
  worker 1 (every delivery takes the cross-worker hop).

With ``--view tpu`` (the default) each group matches through one match
service holding the GPU view on ``--device``; with ``trie`` each worker
folds on its own trie. Beside them it times the hop's ingredients: the
cluster codec's encode and decode of a representative publish frame and a
loopback TCP round trip. With per-delivery local cost L and hop cost H, a
k-worker deployment whose cross fraction is f delivers per worker
``e = L / (L + f·H)``; ``c = H / L`` is read from each round as
``local1 / cross2 - 1`` and reported as the median over ``--trials``
interleaved rounds (absolute rates drift, ratios within a round
compare). The clients are :mod:`.loadtest`'s shard process.

On the card by default (``RuntimeError`` without one); ``--device cpu``
runs the match service's plain path.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import socket
import threading
import time
from typing import Dict

from .loadtest import client_proc, free_port_block

LAYOUT = {"local1": (1, 0, 0), "local2": (2, 0, 0), "cross2": (2, 0, 1)}


def run_scenario(n_workers: int, sub_worker: int, pub_worker: int,
                 secs: float, n_subs: int, n_pubs: int, qos: int,
                 window: int, view: str, dev) -> Dict:
    """One placement: a fresh group, subscribers in one client process on
    ``sub_worker``'s direct port, publishers in another on
    ``pub_worker``'s; rates over the publishing window."""
    from ..broker.workers import WorkerGroup

    port = free_port_block()
    direct_base = free_port_block(n_workers, port + 1)
    kw = {}
    if view == "tpu":
        kw = dict(match_service=True, match_view="tpu",
                  match_device=str(dev), tpu_host_batch_threshold=0)
    group = WorkerGroup(n_workers, "127.0.0.1", port,
                        cluster_base=free_port_block(n_workers,
                                                     direct_base + n_workers),
                        direct_base=direct_base,
                        allow_anonymous=True, systree_enabled=False,
                        sysmon_enabled=False, **kw)
    group.start()
    procs = []
    try:
        deadline = time.time() + 120
        for w in range(n_workers):
            while True:
                try:
                    socket.create_connection(
                        ("127.0.0.1", direct_base + w), 0.5).close()
                    break
                except OSError:
                    if time.time() > deadline:
                        raise RuntimeError(f"worker {w} never came up")
                    time.sleep(0.25)
        time.sleep(1.0)  # the worker mesh forms
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue()
        # the publishers start once the subscriptions are acknowledged
        barrier = ctx.Barrier(2)
        procs = [
            ctx.Process(target=client_proc, args=(
                "127.0.0.1", direct_base + sub_worker, list(range(n_subs)),
                [], secs + 2.0, qos, window, 64, False, "s", out_q, 0.0,
                0.0, 0.5, barrier)),
            ctx.Process(target=client_proc, args=(
                "127.0.0.1", direct_base + pub_worker, [],
                list(range(n_pubs)), secs, qos, window, 64, False, "p",
                out_q, 0.0, 0.0, 0.5, barrier))]
        for p in procs:
            p.start()
        res = [out_q.get(timeout=secs + 120) for _ in procs]
        sent = sum(r["sent"] for r in res)
        failed = sum(r["failed"] for r in res)
        received = sum(r["received"] for r in res)
        # the publishing window's wall: the subscriber shard runs 2 s
        # longer to drain
        pub_elapsed = next(r["elapsed"] for r in res if r["sent"] > 0)
        return {"deliveries_per_s": received / pub_elapsed,
                "acked_pubs_per_s": (sent - failed) / pub_elapsed,
                "received": received, "sent": sent, "failed": failed,
                "elapsed_s": pub_elapsed}
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(5)
        group.stop()


def micro_hop() -> Dict:
    """Per-message cost of the hop's ingredients (host clock)."""
    from ..broker.message import Msg
    from ..cluster.codec import decode, encode
    from ..cluster.node import frame, msg_to_term, term_to_msg

    msg = Msg(topic=("lt", "3", "mX0"), payload=b"x" * 64, qos=1,
              retain=False, mountpoint="", msg_ref=b"r" * 16,
              properties={})
    N = 20_000
    t0 = time.perf_counter()
    for _ in range(N):
        frame(b"msg", msg_to_term(msg))
    enc_us = (time.perf_counter() - t0) / N * 1e6
    wire = encode(msg_to_term(msg))
    t0 = time.perf_counter()
    for _ in range(N):
        term_to_msg(decode(wire))
    dec_us = (time.perf_counter() - t0) / N * 1e6
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def echo():
        conn, _ = srv.accept()
        while True:
            b = conn.recv(4096)
            if not b:
                return
            conn.sendall(b)

    threading.Thread(target=echo, daemon=True).start()
    c = socket.create_connection(srv.getsockname())
    c.sendall(b"w" * 64)
    c.recv(4096)
    N2 = 2_000
    t0 = time.perf_counter()
    for _ in range(N2):
        c.sendall(b"w" * 64)
        c.recv(4096)
    rtt_us = (time.perf_counter() - t0) / N2 * 1e6
    c.close()
    srv.close()
    return {"encode_us": enc_us, "decode_us": dec_us,
            "loopback_rtt_us": rtt_us}


def _med(vals):
    s = sorted(vals)
    return s[len(s) // 2]


def main(argv=None) -> Dict:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m vernemq_tpu_torch.tools.worker_efficiency")
    ap.add_argument("--secs", type=float, default=20.0)
    ap.add_argument("--subs", type=int, default=16)
    ap.add_argument("--pubs", type=int, default=4)
    ap.add_argument("--qos", type=int, default=1)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--trials", type=int, default=1,
                    help="interleaved rounds; medians are reported")
    ap.add_argument("--view", default="tpu", choices=("tpu", "trie"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    micro = micro_hop()
    print(f"hop: cluster-codec encode {micro['encode_us']:.1f} us, decode "
          f"{micro['decode_us']:.1f} us, loopback RTT "
          f"{micro['loopback_rtt_us']:.1f} us", flush=True)
    runs: Dict[str, list] = {n: [] for n in LAYOUT}
    round_c, round_g = [], []
    for t in range(args.trials):
        for name, (nw, sw, pw) in LAYOUT.items():
            r = run_scenario(nw, sw, pw, args.secs, args.subs, args.pubs,
                             args.qos, args.window, args.view, dev)
            runs[name].append(r)
            print(f"round {t} {name}: deliveries/s="
                  f"{r['deliveries_per_s']:.0f}", flush=True)
        t1 = runs["local1"][-1]["deliveries_per_s"]
        t2l = runs["local2"][-1]["deliveries_per_s"]
        t2x = runs["cross2"][-1]["deliveries_per_s"]
        if min(t1, t2l, t2x) <= 0:
            print(f"round {t}: a placement delivered nothing; left out of "
                  f"the ratios", flush=True)
            continue
        round_c.append(t1 / t2x - 1.0)
        round_g.append(t1 / t2l - 1.0)
    if not round_c:
        raise SystemExit("worker_efficiency: no complete round")
    c = _med(round_c)
    out = {"micro": micro, "view": args.view, "device": str(dev),
           "scenarios": {n: {"deliveries_per_s_median": _med(
               [r["deliveries_per_s"] for r in rs]),
               "rounds": [r["deliveries_per_s"] for r in rs]}
               for n, rs in runs.items()},
           "model": {"hop_cost_ratio_c": c, "hop_cost_ratio_rounds": round_c,
                     "group_overhead_ratio": _med(round_g),
                     "per_worker_efficiency": {
                         str(k): 1.0 / (1.0 + c * (k - 1) / k)
                         for k in (2, 4, 8)}},
           "config": vars(args)}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
