"""Roofline of the port's forward match dispatch on the card, and the
K-window probe that measures it.

    python -m vernemq_tpu_torch.tools.roofline [--subs 1000000]
        [--batch 4096] [--device cuda|cpu]
    python -m vernemq_tpu_torch.tools.roofline --probe [--probe-ks 1,2,4,8,16]
        [--probe-reps 3] [--device cuda|cpu]

The analytic half builds the headline corpus at ``--subs`` (bench.py's
mix, :mod:`.corpus`), preps one zipf batch of ``--batch`` publishes as the
serving path does, and reads the port's geometry (``models/matcher.py``
``window_params`` / ``GpuMatcher._geometry``; the dense mode's tiles from
``ops/tile_match.py`` ``dense_geometry``). For each launch of one dispatch
it counts the bytes the function must move and the operations it must do
on these inputs — the tile kernel by :func:`tile_bound` (the formula
``chip_smoke.py``'s kernel lines use: every table row its windows touch
read once, the tile operands read once, the packed mask written once, 2·K
FLOP per publish and window row), each extraction by
:func:`extract_bound` — and the bound is the larger of bytes over the
card's memory rate and FLOP over its dense bf16 rate, launch by launch.
Defaults are the H100 SXM data sheet's 3.35 TB/s HBM3 and 989 TFLOP/s
(``--hbm-tbps``, ``--bf16-tflops``). It prints the bound per batch and
the ceiling of publishes/s and matches/s it allows (matches at the host
trie's average fanout on the same corpus).

``--probe`` measures, on a built headline matcher, a ladder of K staged
windows (:func:`k_ladder`): for each K the K windows run as one
:class:`~..ops.match_kernel.PackedScan` replayed from its CUDA graph (the
kernel-resident time per window: no host work between windows), and
through ``call_match_many`` with its one upload and its one device→host
copy of every result byte (the serving path's super-batch dispatch).
``W(K) = a + b·K`` fitted over the second ladder splits the per-dispatch
host cost ``a`` from the per-window cost ``b``; both are printed beside
the graph's time per window and the bound.

On the card by default (``RuntimeError`` without one); ``--device cpu``
runs the plain path at a smoke size (at most 20,000 subscriptions and 256
publishes a batch), where every time is the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def window_rows(starts, seg: int) -> int:
    """Distinct table rows in the windows [s, s + seg) of ``starts``."""
    rows, hi = 0, -1
    for s in sorted(int(x) for x in starts):
        lo = max(s, hi)
        if s + seg > lo:
            rows += s + seg - lo
        hi = max(hi, s + seg)
    return rows


def tile_bound(K: int, T: int, TP: int, starts, seg: int):
    """(bytes, FLOP) one tile-kernel launch must move and do: every table
    row its T windows of ``seg`` rows at ``starts`` touch read once (its K
    bf16 operands, t1, eff, flags), the ``[T, TP]`` tile operands read
    once, the packed mask written once; 2·K FLOP per (publish, window
    row)."""
    rows = window_rows(starts, seg)
    nbytes = (rows * (2 * K + 12) + T * TP * (2 * K + 8) + T * 4
              + T * TP * seg // 8)
    return nbytes, 2.0 * T * TP * seg * K


def extract_bound(R: int, W: int, k: int) -> int:
    """Bytes one extraction of ``R`` distinct rows of ``W`` packed words
    must move: the rows' words, row selectors and liveness read once,
    ``idx``, ``valid`` and the count written once."""
    return R * W * 4 + R * 4 + R + R * k * 5 + R * 4


def launch_ms(nbytes: float, flop: float, hbm: float = HBM_BYTES_PER_S,
              peak: float = BF16_FLOP_PER_S) -> float:
    """The least time of one launch: the larger of its bytes over the
    memory rate and its FLOP over the tensor rate (ms)."""
    return max(nbytes / hbm, flop / peak) * 1e3


def dispatch_bound(m, args, statics, hbm: float = HBM_BYTES_PER_S,
                   peak: float = BF16_FLOP_PER_S) -> Dict:
    """The bound of one forward dispatch of the prepped batch ``args``:
    per launch (dense region 0, probes A and B, three extractions, the
    flat result written once) and in all, in ms."""
    from ..ops.tile_match import dense_geometry

    K = (5 if statics["id_bits"] == 16 else 6) * m.table.L
    B = args[0].shape[0]
    S = int(m.table.cap)
    k = statics["k"]
    T, TP = args[4].shape
    seg, seg2 = statics["seg_max"], statics["seg2_max"]
    Td, TPd, segd = dense_geometry(B, statics["glob_pad"], S)
    parts = {
        "dense": launch_ms(*tile_bound(K, Td, TPd, [0] * Td, segd), hbm,
                           peak),
        "probe_a": launch_ms(*tile_bound(K, T, TP, args[5], seg), hbm, peak),
        "extract_dense": launch_ms(extract_bound(B, segd // 32, k), 0, hbm,
                                   peak),
        "extract_a": launch_ms(extract_bound(B, seg // 32, k), 0, hbm, peak),
        "flat": launch_ms(B * (statics["C"] // B + 3) * 4, 0, hbm, peak),
    }
    if seg2:
        T2 = args[6].shape[0]
        parts["probe_b"] = launch_ms(*tile_bound(K, T2, TP, args[7], seg2),
                                     hbm, peak)
        parts["extract_b"] = launch_ms(extract_bound(B, seg2 // 32, k), 0,
                                       hbm, peak)
    parts["total"] = sum(parts.values())
    return parts


def geometry(m, statics, args) -> Dict:
    """The dispatch geometry of a prepped batch (the analytic report)."""
    from ..ops.tile_match import dense_geometry

    B = args[0].shape[0]
    Td, TPd, segd = dense_geometry(B, statics["glob_pad"], int(m.table.cap))
    return {"S": int(m.table.cap), "L": m.table.L,
            "K": (5 if statics["id_bits"] == 16 else 6) * m.table.L,
            "id_bits": statics["id_bits"], "Bpad": B,
            "glob_pad": statics["glob_pad"], "gb_end": int(m.table.gb_end),
            "T": int(args[4].shape[0]), "TP": int(args[4].shape[1]),
            "seg_max": statics["seg_max"], "gc": statics["gc"],
            "T2": int(args[6].shape[0]), "seg2": statics["seg2_max"],
            "dense_T": Td, "dense_TP": TPd, "dense_seg": segd,
            "C": statics["C"], "k": statics["k"]}


def _fit(ks: Sequence[int], walls: Sequence[float]):
    """Least-squares ``W(K) = a + b·K``: (a, b) in the walls' unit."""
    xs = np.asarray(ks, dtype=np.float64)
    A = np.vstack([np.ones_like(xs), xs]).T
    (a, b), *_ = np.linalg.lstsq(A, np.asarray(walls, np.float64),
                                 rcond=None)
    return float(a), float(b)


def _timer(dev):
    """``time(fn, reps) -> ms per call``: CUDA events on the card (the
    device's time for the calls), the host clock on the CPU."""
    import torch

    if dev.type == "cuda":
        def time_it(fn, reps):
            fn()
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize(dev)
            return a.elapsed_time(b) / reps
    else:
        def time_it(fn, reps):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
    return time_it


def k_ladder(m, pools, rng, ks: Sequence[int] = (1, 2, 4, 8, 16),
             reps: int = 3, batch: int = 4096) -> Dict:
    """The K-window probe on a built matcher: for each K, K zipf windows of
    ``batch`` publishes staged once, then (1) their :class:`PackedScan`
    replayed ``reps`` times (device time per window; from its CUDA graph on
    the card), (2) ``call_match_many`` ``reps`` times, host clock, best of
    them (``W(K)``: staging, upload, K dispatches, one download). Also the
    graph's ``(chk, tot)`` against the downloaded rows' int32 sums, the
    bound per window and the leftover / overflow publishes. Returns the
    ladder and the fit ``W(K) = a + b·K``."""
    import torch

    from ..ops import match_kernel as TK
    from .corpus import leftover_counts, staged_windows

    dev = m.device
    time_it = _timer(dev)
    F_t, t1 = m._operands
    rest = m._dev_arrays[1:]
    rows = []
    for k in ks:
        preps, statics, lefts = staged_windows(m, pools, rng, k, batch)
        staged = TK.stage_many(preps, dev)
        scan = TK.PackedScan(F_t, t1, *rest, staged, preps, statics)
        graph_ms = time_it(scan.run, reps) / k
        chk, tot = scan.result()
        walls = []
        out = None
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            out = TK.call_match_many(F_t, t1, *rest, preps, statics)
            walls.append((time.perf_counter() - t0) * 1e3)
        B, C = preps[0][0].shape[0], statics["C"]
        want = TK.scan_sums(torch.from_numpy(out), B, C)
        if (chk, tot) != tuple(want.tolist()):
            raise AssertionError(
                f"K={k}: the graph's (chk, tot) {(chk, tot)} against the "
                f"downloaded rows' {tuple(want.tolist())}")
        bounds = [dispatch_bound(m, a, statics)["total"] for a in preps]
        left, ovf = leftover_counts(preps, statics, out, lefts)
        rows.append({"K": k, "graph_ms_per_window": graph_ms,
                     "match_many_ms": min(walls),
                     "match_many_ms_per_window": min(walls) / k,
                     "bound_ms_per_window": sum(bounds) / k,
                     "chk": chk, "tot": tot,
                     "matches_per_window": tot / k if tot >= 0 else None,
                     "leftover_pubs": left, "overflow_pubs": ovf})
        del scan, staged
    a, b = _fit([r["K"] for r in rows], [r["match_many_ms"] for r in rows])
    return {"batch": batch, "ladder": rows, "fit_a_ms": a, "fit_b_ms": b,
            "graph_ms_per_window": float(np.mean(
                [r["graph_ms_per_window"] for r in rows])),
            "bound_ms_per_window": float(np.mean(
                [r["bound_ms_per_window"] for r in rows]))}


def analytic(m, pools, rng, batch: int, fanout: float,
             hbm: float = HBM_BYTES_PER_S,
             peak: float = BF16_FLOP_PER_S) -> Dict:
    """The bound of one zipf batch at the port's geometry and the ceilings
    it allows."""
    from .corpus import prep_batch, table_layout, zipf_topics

    args, statics, left = prep_batch(m, zipf_topics(rng, pools, batch),
                                     layout=table_layout(m))
    parts = dispatch_bound(m, args, statics, hbm, peak)
    pubs = batch / (parts["total"] / 1e3)
    return {"geometry": geometry(m, statics, args),
            "bound_ms": parts, "leftover_pubs": len(left),
            "avg_fanout": fanout,
            "ceiling_pubs_per_sec": pubs,
            "ceiling_matches_per_sec": pubs * fanout,
            "hbm_bytes_per_s": hbm, "bf16_flop_per_s": peak}


def main(argv=None) -> Dict:
    from ..device import resolve_device
    from .corpus import headline_matcher, host_trie_like_for_like

    ap = argparse.ArgumentParser(prog="python -m vernemq_tpu_torch.tools."
                                 "roofline")
    ap.add_argument("--subs", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--hbm-tbps", type=float, default=HBM_BYTES_PER_S / 1e12)
    ap.add_argument("--bf16-tflops", type=float,
                    default=BF16_FLOP_PER_S / 1e12)
    ap.add_argument("--fanout", type=float, default=None,
                    help="average matches per publish (default: the host "
                         "trie's on 5,000 zipf topics of the corpus)")
    ap.add_argument("--flat-avg", type=int, default=128)
    ap.add_argument("--probe", action="store_true",
                    help="run the K-window ladder on the device")
    ap.add_argument("--probe-ks", default="1,2,4,8,16")
    ap.add_argument("--probe-reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (a smoke size)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    subs, batch = args.subs, args.batch
    if dev.type == "cpu":
        subs, batch = min(subs, 20_000), min(batch, 256)
    t0 = time.perf_counter()
    m, pools, rng = headline_matcher(subs, device=dev, levels=args.levels,
                                     flat_avg=args.flat_avg, seed=args.seed,
                                     build=args.probe)
    print(f"# corpus of {subs} subscriptions on {dev} in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    if args.probe:
        ks = [int(x) for x in args.probe_ks.split(",") if x.strip()]
        out = k_ladder(m, pools, rng, ks, args.probe_reps, batch)
        out.update(mode="probe", device=str(dev), subs=subs)
    else:
        fanout = args.fanout
        if fanout is None:
            fanout = host_trie_like_for_like(
                m.table.entries, pools, args.seed + 103)["trie_avg_fanout"]
        out = analytic(m, pools, rng, batch, fanout, args.hbm_tbps * 1e12,
                       args.bf16_tflops * 1e12)
        out.update(mode="analytic", device=str(dev), subs=subs)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
