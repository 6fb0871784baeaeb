"""Chip smoke run of the PyTorch/CUDA port (vernemq_tpu_torch) on one card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card (Hopper: the
kernels are built for sm_90a). It

1. prints the card's name and power limit and builds every kernel of the
   port from the sources in the checkout (``nvcc``);
2. holds the tile-match kernel against its plain PyTorch version, bit for
   bit, at the headline probe-A and probe-B shapes (K = 40), at a
   24-bit-id shape (K = 48) on operands that include ids at the byte-plane
   edges, at K = 96 with every id 2^24 - 1 or 65535 (the largest partial
   sums its exactness argument allows), and with publishes longer than L
   and ``$`` publishes against wildcard-first rows;
3. drives the port's main path — ``GpuRegView.fold_batch`` over a
   1,000,000-subscription table (the bench.py headline corpus: 60% exact,
   20% ``w0/+/w2``, 10% ``+/w1/w2``, 10% ``w0/w1/#``; L = 8, max_fanout 256,
   flat_avg 128) with zipf batches of 4096 publishes — and checks exact
   ``(filter, key)`` set equality with the port's own host trie on 1024
   publishes of every batch, that no publish fell back to the host, and
   that the tile kernel was launched on that path;
4. adds and removes 1,000 subscriptions, syncs and checks parity again;
5. times the kernel (CUDA events) per probe and per batch beside its bound
   (achieved TFLOP/s, share of the bound), its plain version, a batched
   fp32 ``torch.bmm`` of the same product (a yardstick the port never
   calls), the device path and its profile, a whole batch and the host
   encode/prep, and prints them beside the card and the ptxas register /
   spill report of every kernel template the run launched.

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
# the tile kernel's first version (fp32 FMAs on the CUDA cores), probe A + B
# per batch, measured by this script's first version on one H100 80GB HBM3 at
# 700 W; printed for reference beside this run's time, never as this run's
EARLIER_MS = 7.32
# kernel phase: (label, id bits, L, S, T, TP, seg_max, wild_rows, options of
# synthetic_probe) — the headline geometry (1M subs, L=8, B=4096: S rows,
# K=40, probe A 24 x 256 x 262144, probe B 24 x 256 x 32768), a 24-bit-id
# shape (K=48), K=96 at the largest partial sums (every id 2^24-1 or 65535,
# every level weighted), and publishes longer than L (and than the kernel's
# key clamp of 31) with $ publishes on wildcard-first rows
KERNEL_SHAPES = [
    ("probe A K=40", 16, 8, 1_613_824, 24, 256, 262_144, False, {}),
    ("probe B K=40", 16, 8, 1_613_824, 24, 256, 32_768, True, {}),
    ("24-bit K=48", 24, 8, 1 << 20, 8, 256, 65_536, False, {}),
    ("K=96 max ids", 24, 16, 1 << 20, 8, 256, 65_536, False,
     dict(vocab=[(1 << 24) - 1, 65535], eff_lo=15)),
    ("plen>L $ wild", 16, 8, 1 << 20, 8, 256, 65_536, True,
     dict(long_pubs=0.3)),
]


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
                    seg: int, seed: int, vocab=None, eff_lo: int = 1,
                    long_pubs: float = 0.0):
    """Random tile-matcher operands on the card and the host copy of the
    window starts. By default a corpus-like vocabulary plus byte-plane edge
    ids, 20% ``+`` levels, eff 1..3, tile publishes copied from rows of
    their own window (so many rows match), ~5% unknown publish words and
    random lengths 1..3. With ``vocab`` every id is drawn from it (no ``+``,
    no unknown words), eff from ``eff_lo``..L, and half the publishes take
    their source row's length; ``long_pubs`` of them get a length in
    L+1..L+39."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if vocab is None:
        edges = np.array([0, 1, 2, 254, 255, 256, 65535, 65536], np.int32)
        vocab = np.concatenate(
            [rng.integers(3, 1 << bits, 380).astype(np.int32), edges])
        plus, unknown, eff_hi = 0.2, 0.05, 4
    else:
        vocab = np.asarray(vocab, np.int32)
        plus, unknown, eff_hi = 0.0, 0.0, L + 1
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < plus] = TK.PLUS_ID
    eff = rng.integers(eff_lo, eff_hi, S, dtype=np.int32)
    flags = ((rng.random(S) < 0.1) * 1 | (rng.random(S) < 0.3) * 2
             | (rng.random(S) < 0.95) * 4).astype(np.int32)
    start = rng.integers(0, S - seg + 1, T).astype(np.int32)
    src = start[:, None] + rng.integers(0, seg, (T, TP))
    pw = words[src]
    pw[pw == TK.PLUS_ID] = vocab[0]
    pw[rng.random(pw.shape) < unknown] = -2  # UNKNOWN_ID
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    F_t, t1 = TK.build_operands(cuda(words), cuda(eff), bits)
    Gt = TK.build_pub_operand(cuda(pw.reshape(T * TP, L)), bits) \
        .reshape(T, TP, -1).contiguous()
    plt = rng.integers(1, 4, (T, TP)).astype(np.int32)
    if eff_lo > 1 or long_pubs:
        plt = np.where(rng.random((T, TP)) < 0.5, eff[src], plt)
        long = rng.random((T, TP)) < long_pubs
        plt[long] = rng.integers(L + 1, L + 40, int(long.sum()))
    pdt = cuda((rng.random((T, TP)) < 0.1).astype(np.int32))
    return (F_t, t1, cuda(eff), cuda(flags), Gt, cuda(plt.astype(np.int32)),
            pdt, cuda(start)), start


def ptxas_report(text: str):
    """{KP: (registers, spill-store bytes, spill-load bytes)} of every
    tile_match_kernel<KP> in an ``nvcc -Xptxas -v`` log."""
    import re

    out, kp, spill = {}, None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"tile_match_kernelILi(\d+)E", ln)
        if m and "Compiling entry function" in ln:
            kp, spill = int(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and kp is not None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and kp is not None:
            out[kp] = (int(m.group(1)), *spill)
            kp = None
    return out


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


def profile_device_path(torch, fn, card: str, path_ms: float,
                        reps: int = 3) -> None:
    """Where the device path's time goes: torch.profiler over ``reps``
    batches — the device-busy share (kernel time over the profiled window's
    wall time, and over ``path_ms``, the path's time per batch measured
    with CUDA events and no profiler), the top operators by the device time
    of their kernels (with input shapes), and the hand kernel's own rows."""
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
          f"{100 * busy_ms / wall_ms:.1f}% of the profiled wall, "
          f"{100 * busy_ms / reps / path_ms:.1f}% of the unprofiled "
          f"{path_ms:.2f} ms per batch)")
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
    built = _build.build(["tile_match"])
    print(f"[build] tile_match {'built' if built else 'up to date'} in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({_build.lib_path('tile_match')})", flush=True)
    # registers and spills only from a compile of this run: an older log
    # need not describe the library that is loaded
    ptxas = ptxas_report(_build.log_path("tile_match").read_text()) \
        if built else {}

    # ------------------------------------------------------- kernel phase
    kernel_err = 0
    launched_kp = set()  # compiled widths KP the run launched
    for i, (name, bits, L, S, T, TP, seg, wild, opts) in \
            enumerate(KERNEL_SHAPES):
        x, start_host = synthetic_probe(torch, TK, bits, L, S, T, TP, seg,
                                        SEED + i, **opts)
        kw = dict(seg_max=seg, glob_pad=2048, wild_rows=wild)
        got = TM.window_tiles_packed(*x, **kw, start_host=start_host)
        want = TM.window_tiles_packed_ref(*x, **kw)
        torch.cuda.synchronize()
        err = mask_diff(got, want)
        hits = TK._popcount(want).sum(dim=2)
        ones = int(hits.sum())
        long_hits = int(hits[x[5] > L].sum())
        launched_kp.add(TM.padded_k(x[0].shape[0]))
        print(f"[kernel] {name}: T={T} TP={TP} seg={seg} K={x[0].shape[0]} "
              f"set bits {ones} (publishes longer than L: {long_hits}) "
              f"max_abs_err {err}", flush=True)
        if err or not ones:
            fail(f"kernel disagrees with its plain version at {name}"
                 if err else f"no matches at {name}: comparison is vacuous")
        if opts.get("long_pubs") and not long_hits:
            fail(f"no match of a publish longer than L at {name}")
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
    launched_kp.add(TM.padded_k(F_t.shape[0]))
    probes = []
    for name, sel, start, seg, wild in (
            ("A", args[4], args[5], statics["seg_max"], False),
            ("B", args[6], args[7], statics["seg2_max"], True)):
        if not seg:
            continue
        inputs = (F_t, t1d, eff, flags,
                  *TM.tile_operands(G_all, pl, pd, cuda(sel)), cuda(start))
        kw = dict(seg_max=seg, glob_pad=statics["glob_pad"], wild_rows=wild)
        got = TM.window_tiles_packed(*inputs, **kw, start_host=start)
        want = TM.window_tiles_packed_ref(*inputs, **kw)
        torch.cuda.synchronize()
        if mask_diff(got, want):
            fail(f"kernel disagrees with its plain version on path probe "
                 f"{name}")
        del got, want
        kernel_ms = event_ms(lambda: TM.window_tiles_packed(
            *inputs, **kw, start_host=start), 20)
        plain_ms = event_ms(
            lambda: TM.window_tiles_packed_ref(*inputs, **kw), 3)
        Gt = inputs[4].to(torch.float32)
        rows = cuda(start).long()[:, None] \
            + torch.arange(seg, device=DEVICE)[None, :]
        Fw = F_t.to(torch.float32)[:, rows].permute(1, 0, 2).contiguous()
        bmm_ms = event_ms(lambda: torch.bmm(Gt, Fw), 10)
        del Fw, rows
        nbytes, flop = probe_bound(inputs, seg)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S) * 1e3
        probes.append(dict(name=name, T=int(sel.shape[0]), seg=seg,
                           kernel_ms=kernel_ms, plain_ms=plain_ms,
                           bmm_ms=bmm_ms, bytes=nbytes, flop=flop,
                           bound_ms=bound_ms))
        print(f"[time] {card} | probe {name} T={sel.shape[0]} "
              f"TP={sel.shape[1]} seg={seg}: kernel {kernel_ms:.4f} ms "
              f"({flop / kernel_ms / 1e9:.1f} TFLOP/s, "
              f"{100 * bound_ms / kernel_ms:.1f}% of its bound "
              f"{bound_ms:.4f} ms: {nbytes / 1e6:.1f} MB, "
              f"{flop / 1e9:.1f} GFLOP), plain {plain_ms:.3f} ms, fp32 bmm "
              f"yardstick {bmm_ms:.3f} ms", flush=True)
    k_ms = sum(p["kernel_ms"] for p in probes)
    k_flop = sum(p["flop"] for p in probes)
    nbytes = sum(p["bytes"] for p in probes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, k_flop / BF16_FLOP_PER_S
    batch_bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"[time] {card} | tile kernel per batch (probes A + B): "
          f"{k_ms:.4f} ms ({k_flop / k_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * batch_bound_ms / k_ms:.1f}% of its bound "
          f"{batch_bound_ms:.4f} ms), fp32 bmm yardstick "
          f"{sum(p['bmm_ms'] for p in probes):.3f} ms (the CUDA-core "
          f"kernel of the first slice, not timed here: {EARLIER_MS} ms)",
          flush=True)
    for kp in sorted(launched_kp):
        regs, st_b, ld_b = ptxas.get(kp, (None, None, None))
        print(f"[build] ptxas tile_match_kernel<KP={kp}> (launched): "
              f"{regs} registers, {st_b} bytes spill stores, {ld_b} bytes "
              f"spill loads", flush=True)
    # the window starts (args[5], args[7]) stay on the host
    host = [cuda(a) for a in args[:3]] + [int(args[3]), cuda(args[4]),
                                          args[5], cuda(args[6]), args[7]] \
        + [cuda(a) for a in args[8:]]
    flat_ms = event_ms(lambda: TK.match_extract_windowed_flat(
        F_t, t1d, eff, hh, fw, act, *host, **statics), 5)
    print(f"[time] {card} | device path per batch (dense region 0, both "
          f"probes, extraction, flat compaction): {flat_ms:.2f} ms",
          flush=True)
    profile_device_path(torch, lambda: TK.match_extract_windowed_flat(
        F_t, t1d, eff, hh, fw, act, *host, **statics), card, flat_ms)
    lat_s = sorted(lat)
    p50 = float(np.percentile(lat_s, 50))
    p99 = float(np.percentile(lat_s, 99))
    print(f"[time] {card} | batch of {BATCH} through fold_batch: p50 "
          f"{p50:.2f} ms p99 {p99:.2f} ms over {len(lat)} batches "
          f"(host resolve included)", flush=True)
    print(f"[time] {card} | host encode + window prep per batch: "
          f"{prep_ms:.2f} ms", flush=True)

    kernels = [{
        "name": "tile_match",
        "route": "cuda",
        "source": "vernemq_tpu_torch/csrc/tile_match.cu",
        "replaces": "vernemq_tpu/ops/pallas_match.py:117",
        "launches": path_launches,
        "max_abs_err": kernel_err,
        "ms": k_ms,
        "plain_ms": sum(p["plain_ms"] for p in probes),
        "bound_ms": batch_bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "bmm_yardstick_ms": sum(p["bmm_ms"] for p in probes),
        "bit_equal": kernel_err == 0,
        "design": "mma.sync",
        "tflops": k_flop / k_ms / 1e9,
        "per_probe": {p["name"]: {k: p[k] for k in (
            "kernel_ms", "bound_ms", "plain_ms", "bmm_ms")} for p in probes},
        "ptxas": {str(kp): ptxas.get(kp) for kp in sorted(launched_kp)}
        if built else None,
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
