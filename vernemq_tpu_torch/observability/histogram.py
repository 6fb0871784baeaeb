"""Latency histograms for the match engine's seams.

A copy of ``vernemq_tpu/observability/histogram.py`` for the families the
port observes. Fixed log2 buckets (1 µs .. ~36 min, in milliseconds) shared
by every family. Each writer thread buffers increments in a thread-local
block and folds into the shared arrays every ``_FLUSH_OPS`` observations;
reads merge the shared arrays plus every live thread's buffer, sweeping
dead-thread buffers exactly once — totals are fresh and the hot path takes
no lock.

The registry is process-global: matcher and collector code observes
without threading a metrics handle through every layer.
"""

from __future__ import annotations

import threading
import weakref
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

#: log2 bucket upper bounds in milliseconds: 0.001 ms (1 µs) doubling up
#: to ~2.1e6 ms (~36 min); one implicit +Inf overflow bucket on top.
N_BUCKETS = 32
BUCKET_BOUNDS_MS: Tuple[float, ...] = tuple(
    0.001 * (1 << i) for i in range(N_BUCKETS))

#: the instrumented seams; every ``observe()`` call site names one.
STAGE_FAMILIES: List[Tuple[str, str]] = [
    ("stage_device_dispatch_ms",
     "Device match dispatch latency: encode + kernels + result download "
     "for one match_batch/match_many call (informs the collector's "
     "dispatch deadline)."),
    ("stage_rebuild_ms",
     "Device table (re)build latency: upload + operand build (informs "
     "the rebuild deadline)."),
    ("stage_collector_wait_ms",
     "Publish wait in the batch-collector queue from submit to flush "
     "start (informs the batch window and the dispatch budget)."),
]

class _Buf:
    """One writer thread's buffered observations for one histogram."""

    __slots__ = ("counts", "sum", "n", "ops")

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.sum = 0.0
        self.n = 0
        self.ops = 0


class Histogram:
    """One latency family: fixed log buckets + sum + count."""

    _FLUSH_OPS = 64

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._counts = [0] * (N_BUCKETS + 1)
        self._sum = 0.0
        self._count = 0
        self._tl = threading.local()
        # every thread's live buffer (weakref to its owner thread so reads
        # can sweep dead threads' residuals exactly once)
        self._bufs: List[Tuple[object, _Buf]] = []

    def observe(self, ms: float) -> None:
        tl = self._tl
        buf: Optional[_Buf] = getattr(tl, "buf", None)
        if buf is None:
            buf = tl.buf = _Buf()
            with self._lock:
                self._bufs.append(
                    (weakref.ref(threading.current_thread()), buf))
        i = bisect_left(BUCKET_BOUNDS_MS, ms)
        buf.counts[i] = buf.counts.get(i, 0) + 1
        buf.sum += ms
        buf.n += 1
        buf.ops += 1
        if buf.ops >= self._FLUSH_OPS:
            self._flush_own()

    def _flush_own(self) -> None:
        buf: Optional[_Buf] = getattr(self._tl, "buf", None)
        if buf is None:
            return
        with self._lock:
            for i, n in list(buf.counts.items()):
                self._counts[i] += n
            self._sum += buf.sum
            self._count += buf.n
        buf.counts.clear()
        buf.sum = 0.0
        buf.n = 0
        buf.ops = 0

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. overflow, sum_ms, count) — shared
        arrays plus every live thread's buffer; dead-thread residuals fold
        into the shared arrays exactly once."""
        self._flush_own()
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
            total_n = self._count
            kept = []
            for wr, buf in self._bufs:
                t = wr()
                alive = t is not None and t.is_alive()
                for i, n in list(buf.counts.items()):
                    counts[i] += n
                    if not alive:
                        self._counts[i] += n
                total_sum += buf.sum
                total_n += buf.n
                if alive:
                    kept.append((wr, buf))
                else:
                    self._sum += buf.sum
                    self._count += buf.n
                    buf.counts.clear()
                    buf.sum = 0.0
                    buf.n = 0
            self._bufs = kept
        return counts, total_sum, total_n

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (N_BUCKETS + 1)
            self._sum = 0.0
            self._count = 0
            for _wr, buf in self._bufs:
                buf.counts.clear()
                buf.sum = 0.0
                buf.n = 0
                buf.ops = 0


_REGISTRY: Dict[str, Histogram] = {
    name: Histogram(name, help_text) for name, help_text in STAGE_FAMILIES}


def observe(name: str, ms: float) -> None:
    """Record one observation (milliseconds) into a registered family;
    unknown names raise."""
    _REGISTRY[name].observe(ms)


def get(name: str) -> Histogram:
    return _REGISTRY[name]


def reset_all() -> None:
    for h in _REGISTRY.values():
        h.reset()


def quantile(counts: Sequence[int], q: float) -> Optional[float]:
    """Estimate the q-quantile (ms) from per-bucket counts with geometric
    interpolation inside the landing bucket."""
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            if i >= N_BUCKETS:
                return BUCKET_BOUNDS_MS[-1]  # overflow: clamp to top
            hi = BUCKET_BOUNDS_MS[i]
            lo = BUCKET_BOUNDS_MS[i - 1] if i else hi / 2.0
            frac = (rank - cum) / c
            return lo * ((hi / lo) ** max(0.0, min(1.0, frac)))
        cum += c
    return BUCKET_BOUNDS_MS[-1]


def summary(snap: Tuple[Sequence[int], float, int]) -> Dict[str, float]:
    """p50/p99/p99.9 + count/mean for one family snapshot."""
    counts, s, n = snap
    out: Dict[str, float] = {"count": float(n)}
    if n:
        out["mean_ms"] = s / n
        for key, q in (("p50_ms", 0.50), ("p99_ms", 0.99),
                       ("p999_ms", 0.999)):
            v = quantile(counts, q)
            if v is not None:
                out[key] = v
    return out
