"""Chip smoke run of the PyTorch/CUDA port (vernemq_tpu_torch) on one card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card (Hopper: the
kernels are built for sm_90a). It

1. prints the card's name and power limit and builds every kernel of the
   port from the sources in the checkout (``nvcc``);
2. holds the tile-match kernel against its plain PyTorch version, bit for
   bit, at the headline probe-A and probe-B shapes (K = 40) and at a
   24-bit-id shape (K = 48), on operands that include ids at the byte-plane
   edges;
3. drives the port's main path — ``GpuRegView.fold_batch`` over a
   1,000,000-subscription table (the bench.py headline corpus: 60% exact,
   20% ``w0/+/w2``, 10% ``+/w1/w2``, 10% ``w0/w1/#``; L = 8, max_fanout 256,
   flat_avg 128) with zipf batches of 4096 publishes — and checks exact
   ``(filter, key)`` set equality with the port's own host trie on 1024
   publishes of every batch, that no publish fell back to the host, and
   that the tile kernel was launched on that path;
4. adds and removes 1,000 subscriptions, syncs and checks parity again;
5. times the kernel (CUDA events), its plain version, a batched fp32
   ``torch.bmm`` of the same product (a yardstick the port never calls),
   a whole batch and the host encode/prep, and prints them beside the card.

Its last line is ``{"ok": true, "device": {...}}``; any failed check exits
non-zero before it. Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

SEED = 42
N_SUBS = 1_000_000
BATCH = 4096
BATCHES = 16
DELTA = 1000
PARITY_PUBS = 1024
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
DEVICE = "cuda"
# kernel phase: (label, id bits, L, S, T, TP, seg_max, wild_rows) — the
# headline geometry (1M subs, L=8, B=4096: S rows, K=40, probe A 24 x 256 x
# 262144, probe B 24 x 256 x 32768) and a 24-bit-id shape (K=48)
KERNEL_SHAPES = [("probe A K=40", 16, 8, 1_613_824, 24, 256, 262_144, False),
                 ("probe B K=40", 16, 8, 1_613_824, 24, 256, 32_768, True),
                 ("24-bit K=48", 24, 8, 1 << 20, 8, 256, 65_536, False)]


def build_corpus(rng: random.Random, n_subs: int, add):
    """The bench.py headline mix over a 3-level topic tree (a copy of its
    ``build_corpus``): ``add(filter_words, key)`` per subscription."""
    l0 = [f"region{i}" for i in range(64)]
    l1 = [f"dev{i}" for i in range(256)]
    l2 = [f"metric{i}" for i in range(64)]
    for i in range(n_subs):
        r = rng.random()
        w0, w1, w2 = rng.choice(l0), rng.choice(l1), rng.choice(l2)
        if r < 0.60:
            f = [w0, w1, w2]
        elif r < 0.80:
            f = [w0, "+", w2]
        elif r < 0.90:
            f = ["+", w1, w2]
        else:
            f = [w0, w1, "#"]
        add(f, i)
    return l0, l1, l2


def zipf_topics(rng: random.Random, pools, n: int):
    """bench.py's skewed publish stream (a copy of its ``zipf_topics``)."""
    l0, l1, l2 = pools

    def pick(pool):
        z = min(int(rng.paretovariate(1.2)) - 1, len(pool) - 1)
        return pool[z]

    return [(pick(l0), pick(l1), pick(l2)) for _ in range(n)]


class Registry:
    """The registry surface GpuRegView reads (fold_subscriptions + trie).
    The warm load replays subscriptions in the order they were made, as
    bench.py fills its table, so the table gets the bench's layout."""

    def __init__(self, trie_cls):
        self._trie = trie_cls()
        self._rows = {}  # (filter, key) -> None, in subscription order

    def add(self, f, key):
        self._trie.add(f, key, None)
        self._rows[(tuple(f), key)] = None

    def remove(self, f, key):
        self._trie.remove(f, key)
        del self._rows[(tuple(f), key)]

    def fold_subscriptions(self, mountpoint):
        return ((f, key, None) for f, key in self._rows)

    def trie(self, mountpoint):
        return self._trie


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def mask_diff(x, y) -> int:
    """Largest |difference| between two packed masks' bits (0 = equal)."""
    return int(((x ^ y) != 0).any()) if x.shape == y.shape else 1


def synthetic_probe(torch, TK, bits: int, L: int, S: int, T: int, TP: int,
                    seg: int, seed: int):
    """Random tile-matcher operands on the card: a corpus-like vocabulary
    plus byte-plane edge ids, tile publishes copied from rows of their own
    window (so many rows match), ~5% unknown publish words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2, 254, 255, 256, 65535, 65536], np.int32)
    vocab = np.concatenate([rng.integers(3, 1 << bits, 380).astype(np.int32),
                            edges])
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < 0.2] = TK.PLUS_ID
    eff = rng.integers(1, 4, S, dtype=np.int32)
    flags = ((rng.random(S) < 0.1) * 1 | (rng.random(S) < 0.3) * 2
             | (rng.random(S) < 0.95) * 4).astype(np.int32)
    start = rng.integers(0, S - seg + 1, T).astype(np.int32)
    pw = words[(start[:, None] + rng.integers(0, seg, (T, TP)))]
    pw[pw == TK.PLUS_ID] = vocab[0]
    pw[rng.random(pw.shape) < 0.05] = -2  # UNKNOWN_ID
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    F_t, t1 = TK.build_operands(cuda(words), cuda(eff), bits)
    Gt = TK.build_pub_operand(cuda(pw.reshape(T * TP, L)), bits) \
        .reshape(T, TP, -1).contiguous()
    plt = cuda(rng.integers(1, 4, (T, TP)).astype(np.int32))
    pdt = cuda((rng.random((T, TP)) < 0.1).astype(np.int32))
    return (F_t, t1, cuda(eff), cuda(flags), Gt, plt, pdt, cuda(start))


def probe_bound(inputs, seg: int):
    """(bytes, FLOP) the tile function must move and do: every table row
    the windows touch read once (its K bf16 operands, t1, eff, flags), the
    tile operands read once, the packed mask written once; 2·K FLOP per
    (publish, window row)."""
    F_t, _t1, _eff, _flags, Gt, _plt, _pdt, start = inputs
    K = F_t.shape[0]
    T, TP, _ = Gt.shape
    rows, hi = 0, -1
    for s in sorted(int(x) for x in start.cpu()):
        lo = max(s, hi)
        if s + seg > lo:
            rows += s + seg - lo
        hi = max(hi, s + seg)
    nbytes = (rows * (2 * K + 12) + T * TP * (2 * K + 8) + T * 4
              + T * TP * seg // 8)
    return nbytes, 2.0 * T * TP * seg * K


def profile_device_path(torch, fn, card: str, reps: int = 3) -> None:
    """Where the device path's time goes: torch.profiler over ``reps``
    batches — the device-busy share of the window (kernel time over wall
    time), the top operators by the device time of their kernels (with
    input shapes), and the hand kernel's own rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {card} | device path x{reps}: wall {wall_ms:.2f} ms, "
          f"kernels {busy_ms:.2f} ms (device busy "
          f"{100 * busy_ms / wall_ms:.1f}%)")
    ops = [e for e in avg if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:10] + [e for e in kernels if "tile_match" in e.key]:
        shapes = str(getattr(e, "input_shapes", "") or "")[:60]
        print(f"[profile]   {e.self_device_time_total / 1e3 / reps:8.3f} ms "
              f"per batch  x{e.count // reps:<3d} {e.key[:44]} {shapes}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vernemq_tpu_torch.models.matcher import GpuRegView
    from vernemq_tpu_torch.models.trie import SubscriptionTrie
    from vernemq_tpu_torch.ops import _build
    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import tile_match as TM

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    _build.build(["tile_match"])
    print(f"[build] tile_match built in {time.perf_counter() - t0:.1f}s "
          f"({_build.lib_path('tile_match')})", flush=True)
    log = _build.log_path("tile_match")
    if log.exists():
        for ln in log.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {ln.strip()}")

    # ------------------------------------------------------- kernel phase
    kernel_err = 0
    for i, (name, bits, L, S, T, TP, seg, wild) in enumerate(KERNEL_SHAPES):
        x = synthetic_probe(torch, TK, bits, L, S, T, TP, seg, SEED + i)
        kw = dict(seg_max=seg, glob_pad=2048, wild_rows=wild)
        got = TM.window_tiles_packed(*x, **kw)
        want = TM.window_tiles_packed_ref(*x, **kw)
        torch.cuda.synchronize()
        err = mask_diff(got, want)
        ones = int(TK._popcount(want).sum())
        print(f"[kernel] {name}: T={T} TP={TP} seg={seg} K={x[0].shape[0]} "
              f"set bits {ones} max_abs_err {err}", flush=True)
        if err or not ones:
            fail(f"kernel disagrees with its plain version at {name}"
                 if err else f"no matches at {name}: comparison is vacuous")
        kernel_err = max(kernel_err, err)
        del x, got, want
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- path phase
    t0 = time.perf_counter()
    rng = random.Random(SEED)
    reg = Registry(SubscriptionTrie)
    trie = reg.trie("")
    corpus = []

    def add(f, key):
        reg.add(f, key)
        corpus.append((f, key))

    pools = build_corpus(rng, N_SUBS, add)
    view = GpuRegView(reg, max_levels=8,
                      initial_capacity=1 << (N_SUBS - 1).bit_length(),
                      max_fanout=256, flat_avg=128, device=DEVICE)
    m = view.matcher("")
    warm = zipf_topics(rng, pools, BATCH)
    view.fold_batch("", warm)  # first build + first use of every op
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    tab = m.table
    print(f"[path] {N_SUBS} subscriptions, table S={tab.cap} "
          f"K={m._operands[0].shape[0]} glob_pad={m._glob_pad} "
          f"gb_end={m._gb_end} NB={tab.NB} NG={tab.NG} "
          f"set-up {t_setup:.1f}s", flush=True)

    def drive(n_batches: int, label: str):
        lat = []
        for b in range(n_batches):
            topics = zipf_topics(rng, pools, BATCH)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = view.fold_batch("", topics)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
            for topic, got in list(zip(topics, rows))[:PARITY_PUBS]:
                want = trie.match(list(topic))
                if sorted((f, str(k)) for f, k, _ in got) != \
                        sorted((f, str(k)) for f, k, _ in want):
                    fail(f"{label} batch {b}: topic {topic} got "
                         f"{len(got)} rows, trie {len(want)}")
        return lat

    fb0 = m.host_fallbacks
    TM.launches = 0
    lat = drive(BATCHES, "path")
    path_launches = TM.launches
    if path_launches <= 0:
        fail("the main path never launched the tile kernel")
    if m.host_fallbacks != fb0:
        fail(f"{m.host_fallbacks - fb0} publishes fell back to the host")
    print(f"[path] {BATCHES} batches x {BATCH}: parity exact on "
          f"{PARITY_PUBS} publishes per batch, tile launches "
          f"{path_launches}, host fallbacks 0", flush=True)

    # --------------------------------------------------------- delta phase
    drng = random.Random(SEED + 1)
    for f, key in drng.sample(corpus, DELTA):
        reg.remove(f, key)
        view.on_delta("remove", "", f, key, None)
    l0, l1, l2 = pools
    for i in range(DELTA):
        f = [drng.choice(l0), drng.choice(l1), drng.choice(l2)]
        f[drng.randrange(3)] = drng.choice(["+", f[0]])
        reg.add(f, f"delta{i}")
        view.on_delta("add", "", f, f"delta{i}", None)
    TM.launches = 0
    drive(2, "delta")
    if TM.launches <= 0 or m.host_fallbacks != fb0:
        fail("delta phase: kernel not launched or host fallbacks")
    print(f"[delta] -{DELTA}/+{DELTA} subscriptions synced; parity exact, "
          f"tile launches {TM.launches}", flush=True)

    # -------------------------------------------------------------- timing
    topics = zipf_topics(rng, pools, BATCH)
    t1 = time.perf_counter()
    with m.lock:
        m.sync()
        enc = m._encode_batch_ex(topics)
        args, statics, left = m._flat_prep(
            m._reg_start, m._reg_end, m._glob_pad, m._ops_bits,
            int(tab.cap), *enc, len(topics))
    prep_ms = (time.perf_counter() - t1) * 1e3
    F_t, t1d = m._operands
    _w, eff, hh, fw, act = m._dev_arrays
    flags = TM.row_flags(hh, fw, act)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    G_all = TK.build_pub_operand(cuda(args[0]), statics["id_bits"])
    pl, pd = cuda(args[1]), cuda(args[2]).to(torch.int32)
    probes = []
    for name, sel, start, seg, wild in (
            ("A", args[4], args[5], statics["seg_max"], False),
            ("B", args[6], args[7], statics["seg2_max"], True)):
        if not seg:
            continue
        inputs = (F_t, t1d, eff, flags,
                  *TM.tile_operands(G_all, pl, pd, cuda(sel)), cuda(start))
        kw = dict(seg_max=seg, glob_pad=statics["glob_pad"], wild_rows=wild)
        got = TM.window_tiles_packed(*inputs, **kw)
        want = TM.window_tiles_packed_ref(*inputs, **kw)
        torch.cuda.synchronize()
        if mask_diff(got, want):
            fail(f"kernel disagrees with its plain version on path probe "
                 f"{name}")
        kernel_ms = event_ms(lambda: TM.window_tiles_packed(*inputs, **kw),
                             20)
        plain_ms = event_ms(
            lambda: TM.window_tiles_packed_ref(*inputs, **kw), 3)
        Gt = inputs[4].to(torch.float32)
        rows = cuda(start).long()[:, None] \
            + torch.arange(seg, device=DEVICE)[None, :]
        Fw = F_t.to(torch.float32)[:, rows].permute(1, 0, 2).contiguous()
        bmm_ms = event_ms(lambda: torch.bmm(Gt, Fw), 10)
        del Fw, rows
        nbytes, flop = probe_bound(inputs, seg)
        probes.append(dict(name=name, T=int(sel.shape[0]), seg=seg,
                           kernel_ms=kernel_ms, plain_ms=plain_ms,
                           bmm_ms=bmm_ms, bytes=nbytes, flop=flop))
        print(f"[time] {card} | probe {name} T={sel.shape[0]} "
              f"TP={sel.shape[1]} seg={seg}: kernel {kernel_ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, fp32 bmm yardstick {bmm_ms:.3f} ms, "
              f"bound {max(nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S) * 1e3:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {flop / 1e9:.1f} GFLOP)", flush=True)
    host = [cuda(a) for a in args[:3]] + [int(args[3])] \
        + [cuda(a) for a in args[4:]]
    flat_ms = event_ms(lambda: TK.match_extract_windowed_flat(
        F_t, t1d, eff, hh, fw, act, *host, **statics), 5)
    print(f"[time] {card} | device path per batch (dense region 0, both "
          f"probes, extraction, flat compaction): {flat_ms:.2f} ms",
          flush=True)
    profile_device_path(torch, lambda: TK.match_extract_windowed_flat(
        F_t, t1d, eff, hh, fw, act, *host, **statics), card)
    lat_s = sorted(lat)
    p50 = float(np.percentile(lat_s, 50))
    p99 = float(np.percentile(lat_s, 99))
    print(f"[time] {card} | batch of {BATCH} through fold_batch: p50 "
          f"{p50:.2f} ms p99 {p99:.2f} ms over {len(lat)} batches "
          f"(host resolve included)", flush=True)
    print(f"[time] {card} | host encode + window prep per batch: "
          f"{prep_ms:.2f} ms", flush=True)

    nbytes = sum(p["bytes"] for p in probes)
    flop = sum(p["flop"] for p in probes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S
    kernels = [{
        "name": "tile_match",
        "route": "cuda",
        "source": "vernemq_tpu_torch/csrc/tile_match.cu",
        "replaces": "vernemq_tpu/ops/pallas_match.py:117",
        "launches": path_launches,
        "max_abs_err": kernel_err,
        "ms": sum(p["kernel_ms"] for p in probes),
        "plain_ms": sum(p["plain_ms"] for p in probes),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "bmm_yardstick_ms": sum(p["bmm_ms"] for p in probes),
        "bit_equal": kernel_err == 0,
        "per_batch": f"probe A + probe B launches of one {BATCH}-publish batch",
    }]
    print(f"[done] {time.perf_counter() - t_start:.1f}s total", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
