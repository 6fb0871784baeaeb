"""Per-call host cost of the hand-kernel wrappers and of an empty launch.

    python -m vernemq_tpu_torch.tools.probe_overhead [--calls 20]
        [--device cuda|cpu] [--json FILE]

For each hand-kernel wrapper of the port — ``tile_match
.window_tiles_packed`` (the forward probe A launch), ``extract
.extract_rows`` (probe A's extraction of a 4096 batch), ``reverse_tiles
.reverse_tiles_packed`` (a retained storm batch's probe) and
``predicate_kernel.predicate_phase`` (one 2^20-pair dispatch with its
folds) — on seeded random operands at the headline shapes, three times
per call:

- ``host_us``: the host clock over ``--calls`` calls issued back to back
  without waiting for the card (the wrapper's own work: argument checks,
  allocation, the launch);
- ``events_ms``: the card's time for the same calls back to back (CUDA
  events), which the host's work stretches when a call's kernel is
  shorter than it;
- ``graph_ms``: the same calls captured in one CUDA graph and replayed
  (the kernels alone).

Then an empty PyTorch launch (``x + 1`` on one element), chained (each on
the last one's result) and independent, on the host clock and by events.
This is the "~50 µs of host work per wrapper call" that the forward
dispatch's ~90 launches pay.

On the card by default (``RuntimeError`` without one); ``--device cpu``
runs each wrapper's plain version at small shapes (host times only).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import numpy as np
import torch

#: (label, builder) at the headline shapes; the CPU runs the small ones
SHAPES = {
    "cuda": dict(tile=(40, 1_613_824, 24, 256, 262_144),
                 extract=(6144, 8192, 4096, 256),
                 reverse=(1 << 20, 8, 3, 16, 256, 16_384, 4096),
                 predicate=(672, 2048, 8, 1 << 20, 1 << 18, 1 << 14)),
    "cpu": dict(tile=(40, 65_536, 2, 32, 4096),
                extract=(64, 128, 32, 16),
                reverse=(8192, 8, 3, 2, 32, 2048, 64),
                predicate=(16, 64, 4, 4096, 1024, 256)),
}


def _put(dev):
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def tile_call(dev, rng, K, S, T, TP, seg) -> Callable:
    """One probe-A launch of the tile matcher on random operands."""
    from ..ops import tile_match as TM

    put = _put(dev)
    F_t = put(rng.integers(0, 256, (K, S)).astype(np.float32)) \
        .to(torch.bfloat16)
    t1 = put(rng.integers(0, 1 << 16, S).astype(np.float32))
    eff = put(rng.integers(1, 4, S).astype(np.int32))
    flags = put(rng.integers(0, 8, S).astype(np.int32))
    Gt = put(-rng.integers(0, 256, (T, TP, K)).astype(np.float32)) \
        .to(torch.bfloat16)
    plt = put(rng.integers(1, 4, (T, TP)).astype(np.int32))
    pdt = put(np.zeros((T, TP), np.int32))
    starts = (rng.integers(0, (S - seg) // 8, T) * 8).astype(np.int32)
    start = put(starts)
    return lambda: TM.window_tiles_packed(
        F_t, t1, eff, flags, Gt, plt, pdt, start, seg_max=seg, glob_pad=0,
        mode="a", start_host=starts)


def extract_call(dev, rng, R0, W, R, k) -> Callable:
    """One extraction of R selected rows of a sparse packed mask."""
    from ..ops import extract as EX

    put = _put(dev)
    bits = rng.random((R0, W)) < 0.002
    packed = put(np.where(bits, rng.integers(-2**31, 2**31, (R0, W)),
                          0).astype(np.int32))
    rows = put(rng.integers(0, R0, R).astype(np.int32))
    ok = put(np.ones(R, bool))
    return lambda: EX.extract_rows(packed, k, rows=rows, ok=ok)


def reverse_call(dev, rng, N, L, lc, T, TP, seg, B) -> Callable:
    """One probe launch of the reverse-compare matcher."""
    from ..ops import reverse_kernel as RK
    from ..ops import reverse_tiles as RT

    put = _put(dev)
    words = rng.integers(3, 64, (N, L)).astype(np.int32)
    row_len = rng.integers(1, lc + 1, N).astype(np.int32)
    words[np.arange(L)[None, :] >= row_len[:, None]] = RK.PAD_ID
    meta = RK.pack_row_meta(row_len, rng.random(N) < 0.1,
                            rng.random(N) < 0.9)
    qw = words[rng.integers(0, N, B)].copy()
    qw[rng.random((B, L)) < 0.2] = RK.PLUS_ID
    qe = rng.integers(1, lc + 1, B).astype(np.int32)
    qf = RK.query_flags(put(rng.random(B) < 0.25),
                        put(qw[:, 0] == RK.PLUS_ID))
    sel = put(rng.integers(0, B, (T, TP)).astype(np.int32))
    starts = rng.integers(0, N - seg + 1, T).astype(np.int32)
    args = (put(words), put(meta), put(qw), put(qe), qf, sel, put(starts))
    return lambda: RT.reverse_tiles_packed(*args, seg=seg, lc=lc,
                                           start_host=starts)


def predicate_call(dev, rng, NP, B, F, P, A, W) -> Callable:
    """One predicate-phase dispatch: P pair verdicts and A gated folds."""
    from ..filters.predicate import OP_GT
    from ..ops import predicate_kernel as PK

    put = _put(dev)
    i32 = lambda lo, hi, n: put(rng.integers(lo, hi, n).astype(np.int32))
    table = (put(np.full(NP, OP_GT, np.int32)), i32(0, F, NP),
             put(rng.random(NP).astype(np.float32)),
             put(rng.random(NP).astype(np.float32) + 1),
             i32(0, 1, NP), i32(0, 1, NP))
    feats = put(rng.random((B, F)).astype(np.float32))
    acc = torch.zeros((W, 4), dtype=torch.float32, device=dev)
    agg = (i32(0, W, A), i32(0, B, A), i32(0, F, A), i32(0, NP, A),
           put(np.ones(A, bool)))
    pair = (i32(0, B, P), i32(0, NP, P))
    return lambda: PK.predicate_phase(*table, acc, feats, *pair, *agg, W=W)


def _host_us(fn, calls: int, sync) -> float:
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    sync()
    return us


def _events_ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def _graph_ms(fn, calls: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(calls):
                fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    ms = _events_ms(graph.replay, 3) / calls
    del graph
    return ms


def measure(dev, calls: int = 20, seed: int = 7) -> Dict:
    """Every row of the report (see the module docstring)."""
    rng = np.random.default_rng(seed)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    shapes = SHAPES["cuda" if cuda else "cpu"]
    builders = dict(tile=tile_call, extract=extract_call,
                    reverse=reverse_call, predicate=predicate_call)
    out: Dict = {"device": str(dev), "calls": calls, "wrappers": {}}
    for name, build in builders.items():
        fn = build(dev, rng, *shapes[name])
        row = {"shape": shapes[name], "host_us": _host_us(fn, calls, sync)}
        if cuda:
            row["events_ms"] = _events_ms(fn, calls)
            row["graph_ms"] = _graph_ms(fn, calls)
            row["host_share"] = 1.0 - row["graph_ms"] / row["events_ms"]
        out["wrappers"][name] = row
        del fn
    x = torch.zeros(1, device=dev)
    state = {"x": x}

    def chained():
        state["x"] = state["x"] + 1

    out["empty_launch"] = {
        "chained_host_us": _host_us(chained, 100, sync),
        "independent_host_us": _host_us(lambda: x + 1, 100, sync)}
    if cuda:
        out["empty_launch"].update(
            chained_events_ms=_events_ms(chained, 100),
            independent_events_ms=_events_ms(lambda: x + 1, 100))
    return out


def main(argv=None) -> Dict:
    from ..device import resolve_device
    from ..ops import _build
    # each wrapper module registers its library's binder when imported
    from ..ops import extract, predicate_kernel, reverse_tiles  # noqa: F401
    from ..ops import tile_match  # noqa: F401

    ap = argparse.ArgumentParser(
        prog="python -m vernemq_tpu_torch.tools.probe_overhead")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        for lib in ("tile_match", "extract", "reverse_match", "predicate"):
            _build.load(lib)
    out = measure(dev, args.calls, args.seed)
    print(json.dumps(out, indent=1), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
