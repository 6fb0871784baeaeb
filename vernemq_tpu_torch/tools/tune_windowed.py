"""Geometry sweep of the forward match path on the card.

    python -m vernemq_tpu_torch.tools.tune_windowed [--subs 1000000]
        [--tp 128,256] [--fm 1,2] [--dtp 64,128,256] [--b 2048,4096,8192]
        [--fa 128] [--batches 8] [--device cuda|cpu] [--json FILE]

Over the headline corpus (:mod:`.corpus`) it runs every configuration of
the grid — ``TILE_PUBS`` (publishes per window tile, ``models/matcher.py``),
``FAIR_MULT`` (window width against a tile's fair share of the zone),
``DENSE_TP`` (publishes per dense-mode tile, ``ops/tile_match.py``), the
batch and the flat capacity per publish (``flat_avg``) — and prints one
line per configuration:

- publishes/s and matches/s through ``GpuMatcher.match_batch`` (the
  serving call: encode, prep, dispatch, download, row resolve) over
  ``--batches`` zipf batches;
- the device path per batch by CUDA events (the dispatches back to back,
  the wrappers' host work between kernels included) and from a CUDA graph
  (``PackedScan`` replayed: the kernels and small operations alone);
- the publishes left to the host by window overflow and by flat
  overflow.

A configuration the kernel or the prep refuses is reported as FAILED with
its error, never skipped. Two lines end the output: the configuration
with the most matches/s through ``match_batch`` (host-bound, so noisy
between runs) and the one with the least device time per publish from
the graph.

On the card by default (``RuntimeError`` without one); ``--device cpu``
sweeps a smoke size (at most 20,000 subscriptions, batches of at most
512).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from typing import Dict, List


def _axis(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def run_config(m, pools, rng, tp: int, fm: int, dtp: int, batch: int,
               fa: int, batches: int, reps: int = 3) -> Dict:
    """One configuration on the built matcher ``m`` (its module knobs set
    for the call and restored)."""
    from ..models import matcher as GM
    from ..ops import match_kernel as TK
    from ..ops import tile_match as TM
    from .corpus import leftover_counts, staged_windows, zipf_topics
    from .roofline import _timer

    saved = (GM.TILE_PUBS, GM.FAIR_MULT, TM.DENSE_TP, m.flat_avg)
    GM.TILE_PUBS, GM.FAIR_MULT, TM.DENSE_TP, m.flat_avg = tp, fm, dtp, fa
    try:
        dev = m.device
        time_it = _timer(dev)
        work = [zipf_topics(rng, pools, batch) for _ in range(batches)]
        m.match_batch(work[0])  # this geometry's first launches
        t0 = time.perf_counter()
        pubs0, fb0 = m.match_publishes, m.host_fallbacks
        matches = sum(len(r) for topics in work
                      for r in m.match_batch(topics))
        wall = time.perf_counter() - t0
        k = min(batches, 4)
        preps, statics, lefts = staged_windows(m, pools, rng, k, batch)
        staged = TK.stage_many(preps, dev)
        head = (*m._operands, *m._dev_arrays[1:])
        events_ms = time_it(lambda: TK.match_many_staged(
            *head, staged, preps, statics), reps) / k
        scan = TK.PackedScan(*head, staged, preps, statics)
        graph_ms = time_it(scan.run, reps) / k
        left, ovf = leftover_counts(preps, statics, scan.rows.cpu().numpy(),
                                    lefts)
        return {"TP": tp, "FM": fm, "DTP": dtp, "B": batch, "FA": fa,
                "publishes_per_s": batch * batches / wall,
                "matches_per_s": matches / wall,
                "device_path_ms_events": events_ms,
                "device_path_ms_graph": graph_ms,
                "T": int(preps[0][4].shape[0]),
                "seg_max": statics["seg_max"], "seg2": statics["seg2_max"],
                "leftover_pubs": left, "overflow_pubs": ovf,
                "host_fallbacks": m.host_fallbacks - fb0,
                "served": m.match_publishes - pubs0}
    finally:
        GM.TILE_PUBS, GM.FAIR_MULT, TM.DENSE_TP, m.flat_avg = saved


def sweep(m, pools, rng, tps, fms, dtps, bs, fas, batches: int,
          out=print) -> List[Dict]:
    """Every configuration of the grid, one line each through ``out``;
    a refused one is a row with ``failed``."""
    rows = []
    src = "from a graph" if m.device.type == "cuda" else "by the plain loop"
    for tp, fm, dtp, b, fa in itertools.product(tps, fms, dtps, bs, fas):
        tag = f"TP={tp} FM={fm} DTP={dtp} B={b} FA={fa}"
        try:
            r = run_config(m, pools, rng, tp, fm, dtp, b, fa, batches)
            out(f"{tag}: {r['matches_per_s'] / 1e6:.3f}M matches/s "
                f"{r['publishes_per_s'] / 1e3:.1f}k pubs/s device path "
                f"{r['device_path_ms_events']:.4f} ms by events, "
                f"{r['device_path_ms_graph']:.4f} ms {src} "
                f"(T={r['T']} seg={r['seg_max']} seg2={r['seg2']}) "
                f"left={r['leftover_pubs']} ovf={r['overflow_pubs']}")
        except Exception as e:
            r = {"TP": tp, "FM": fm, "DTP": dtp, "B": b, "FA": fa,
                 "failed": f"{type(e).__name__}: {str(e)[:200]}"}
            out(f"{tag} FAILED: {r['failed']}")
        rows.append(r)
    return rows


def main(argv=None) -> Dict:
    from ..device import resolve_device
    from .corpus import headline_matcher

    ap = argparse.ArgumentParser(
        prog="python -m vernemq_tpu_torch.tools.tune_windowed")
    ap.add_argument("--subs", type=int, default=1_000_000)
    ap.add_argument("--tp", type=_axis, default=[128, 256])
    ap.add_argument("--fm", type=_axis, default=[1, 2])
    ap.add_argument("--dtp", type=_axis, default=[64, 128, 256])
    ap.add_argument("--b", type=_axis, default=[2048, 4096, 8192])
    ap.add_argument("--fa", type=_axis, default=[128])
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (a smoke size)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    subs, bs = args.subs, args.b
    if dev.type == "cpu":
        subs, bs = min(subs, 20_000), [min(b, 512) for b in bs]
    t0 = time.perf_counter()
    m, pools, rng = headline_matcher(subs, device=dev, seed=args.seed)
    print(f"# corpus of {subs} subscriptions on {dev} in "
          f"{time.perf_counter() - t0:.1f}s; grid TP={args.tp} FM={args.fm} "
          f"DTP={args.dtp} B={bs} FA={args.fa}", file=sys.stderr, flush=True)
    rows = sweep(m, pools, rng, args.tp, args.fm, args.dtp, bs, args.fa,
                 args.batches, out=lambda s: print(s, flush=True))
    ok = [r for r in rows if "failed" not in r]
    best = max(ok, key=lambda r: r["matches_per_s"]) if ok else None
    lean = min(ok, key=lambda r: r["device_path_ms_graph"] / r["B"]) \
        if ok else None
    for label, r, val in (
            ("BEST by matches/s through match_batch", best,
             lambda r: f"{r['matches_per_s'] / 1e6:.3f}M matches/s"),
            ("BEST device path per publish", lean,
             lambda r: f"{1e3 * r['device_path_ms_graph'] / r['B']:.4f} "
                       f"us a publish ({r['device_path_ms_graph']:.4f} ms "
                       f"a batch)")):
        if r is not None:
            print(f"{label}: TP={r['TP']} FM={r['FM']} DTP={r['DTP']} "
                  f"B={r['B']} FA={r['FA']} {val(r)}", flush=True)
    out = {"device": str(dev), "subs": subs, "rows": rows, "best": best,
           "best_device_per_publish": lean}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
