"""Native-friendly latency histograms for the broker's hot-path seams.

Fixed log2 buckets (1 µs .. ~36 min, in milliseconds) shared by every
family, so cross-process aggregation is elementwise addition over a
fixed-width block — exactly what the ``WorkerStatsBlock`` histogram
slots carry. Observation follows the counter-block pattern of
``broker/metrics.py``: each writer thread buffers increments in a
thread-local block and folds into the shared arrays every
``_FLUSH_OPS`` observations; reads merge the shared arrays plus every
live thread's buffer (dict/list reads are GIL-atomic), sweeping
dead-thread buffers exactly once — totals are fresh, nothing strands on
an idle pool thread, and the hot path takes no lock.

The registry is process-global (like ``robustness/faults``): matcher
and collector code observes without threading a metrics handle through
every layer, and the broker's ``Metrics`` object reads the registry at
scrape time. ``set_enabled(False)`` (the ``observability_enabled``
knob) reduces every seam to one module-global boolean test.
"""

from __future__ import annotations

import threading
import weakref
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: log2 bucket upper bounds in milliseconds: 0.001 ms (1 µs) doubling up
#: to ~2.1e6 ms (~36 min); one implicit +Inf overflow bucket on top.
#: Shared by every family so shm aggregation is a fixed-width add.
N_BUCKETS = 32
BUCKET_BOUNDS_MS: Tuple[float, ...] = tuple(
    0.001 * (1 << i) for i in range(N_BUCKETS))

#: per-family flat-pack width in the worker stats block:
#: N_BUCKETS + overflow bucket + sum + count
FLAT_WIDTH = N_BUCKETS + 3

#: the instrumented seams. Every ``observe()`` call site must name one
#: of these (tools/lint_metrics.py enforces it), and every family gets
#: HELP/TYPE in the Prometheus exposition.
STAGE_FAMILIES: List[Tuple[str, str]] = [
    ("stage_device_dispatch_ms",
     "Device match dispatch latency: encode + kernel + result pull for "
     "one match_batch/match_many call (informs "
     "watchdog_dispatch_deadline_ms)."),
    ("stage_retained_dispatch_ms",
     "Retained reverse-match dispatch latency (RetainedIndex "
     "match_filters; informs the retained host_threshold and "
     "watchdog_dispatch_deadline_ms)."),
    ("stage_delta_scatter_ms",
     "Device subscription-delta scatter latency (fused slot scatter "
     "into the live table; informs sub_to_matchable_ms_max)."),
    ("stage_rebuild_ms",
     "Device table (re)build latency: host snapshot + operand build + "
     "upload (informs watchdog_rebuild_deadline_s)."),
    ("stage_collector_wait_ms",
     "Publish wait in the batch-collector queue from submit to flush "
     "start (informs tpu_batch_window_us and the overload dispatch "
     "budget)."),
    ("stage_ring_rtt_ms",
     "Worker->match-service shared-memory ring round trip: fold "
     "request push to reply landing (informs "
     "match_service_timeout_ms)."),
    ("stage_parse_route_ms",
     "Sampled publish parse->route wall time inside the session/worker "
     "process (flight-recorder samples; end-to-end broker residency)."),
    ("stage_queue_flush_ms",
     "Subscriber-queue backlog flush latency per notify_ready drain "
     "(informs max_online_messages sizing)."),
    ("stage_spool_journal_ms",
     "Cluster spool journal write latency per QoS>=1 frame (informs "
     "cluster_spool_dir placement and msg_store_fsync)."),
    ("stage_store_append_ms",
     "Offline message-store append latency per stored message (the "
     "index-entry write burst on the loop; informs msg_store_fsync / "
     "msg_store_group_commit and store_segment_max_bytes)."),
    ("stage_resume_replay_ms",
     "Batched reconnect resume flush latency: one off-loop read_many "
     "for a storm batch plus staged future resolution (storage/"
     "resume.py; informs resume_window_us and resume_max_batch)."),
    ("stage_cluster_ack_rtt_ms",
     "Cluster frame journal->cumulative-ack round trip per spooled "
     "frame (informs cluster_stall_timeout_s and "
     "cluster_spool_retransmit_ms)."),
    ("stage_mesh_dispatch_ms",
     "Mesh-native match dispatch latency: launch-to-results-pulled wall "
     "per pjit'd batch over the NamedSharding mesh (informs "
     "watchdog_dispatch_deadline_ms on multi-slice topologies)."),
    ("stage_mesh_delta_route_ms",
     "Slice-routed delta flush latency: per-slice sub-delta build + "
     "scatter over only the dirty slices' shards (informs "
     "sub_to_matchable_ms_max at mesh scale)."),
    ("stage_predicate_dispatch_ms",
     "Payload-predicate phase device dispatch latency: pair upload + "
     "kernel + verdict/partial pull per fold batch "
     "(vernemq_tpu/filters/; informs predicate_host_threshold and "
     "watchdog_dispatch_deadline_ms)."),
    ("stage_predicate_host_ms",
     "Exact host-evaluator latency per predicate batch served "
     "host-side (breaker-open/degraded, sub-threshold, or "
     "unrepresentable-escape pairs; the device-vs-host comparison "
     "base for bench config 13)."),
    ("stage_wire_parse_ms",
     "Wire-plane batch parse latency: one recv buffer -> packed frame "
     "table call (native codec or pure-Python twin), observed PER "
     "BATCH, not per frame (protocol/fastpath.py parse_batch)."),
    ("stage_wire_encode_ms",
     "Wire-plane fanout encode+write latency: one PUBLISH fanout's "
     "iovec build and per-recipient transport writes, observed PER "
     "FANOUT (the writev-ready encode seam; informs the wire "
     "fast-path share vs the classic Msg path)."),
    ("e2e_canary_ms",
     "Canary SLO probe end-to-end latency: a synthetic loopback "
     "publish through the FULL path (admission -> collector -> device "
     "-> route -> queue delivery), the broker's continuous black-box "
     "signal (observability/canary.py; canary_slo_ms breaches burn "
     "the canary_slo_breaches counter)."),
    ("stage_handoff_drain_ms",
     "Live-handoff drain-phase latency: flushing the moving unit's "
     "in-flight state (QoS>=1 backlog chunks over acked enq batches, "
     "or pending mesh slice deltas) to the successor, observed per "
     "handoff (cluster/handoff.py; informs handoff_drain_deadline_s)."),
    ("stage_handoff_pause_ms",
     "Live-handoff freeze-to-adopt pause: the window during which the "
     "moving unit parks new arrivals, observed per completed handoff "
     "(the bounded-pause guarantee; informs "
     "handoff_freeze_deadline_ms and bench config 15's pause p99)."),
]

_ENABLED = True


def bucket_index(ms: float) -> int:
    """Bucket index for one observation (N_BUCKETS = overflow/+Inf)."""
    return bisect_left(BUCKET_BOUNDS_MS, ms)


class _Buf:
    """One writer thread's buffered observations for one histogram."""

    __slots__ = ("counts", "sum", "n", "ops")

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.sum = 0.0
        self.n = 0
        self.ops = 0


class Histogram:
    """One latency family: fixed log buckets + sum + count.

    Hot-path ``observe`` touches only this thread's buffer; the shared
    arrays are written under ``_lock`` every ``_FLUSH_OPS``
    observations (same bounded-lag discipline as Metrics counters)."""

    _FLUSH_OPS = 64

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._counts = [0] * (N_BUCKETS + 1)
        self._sum = 0.0
        self._count = 0
        self._tl = threading.local()
        # every thread's live buffer (weakref to its owner thread so
        # reads can sweep dead threads' residuals exactly once)
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
        tl = self._tl
        buf: Optional[_Buf] = getattr(tl, "buf", None)
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
        arrays plus every live thread's buffer; dead-thread residuals
        fold into the shared arrays exactly once."""
        self._flush_own()
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
            total_n = self._count
            kept = []
            for wr, buf in self._bufs:
                t = wr()
                alive = t is not None and t.is_alive()
                # read the buffer either way (GIL-atomic per key); a
                # dead thread's residuals also fold into the shared
                # arrays so the NEXT read still sees them
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


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


def observe(name: str, ms: float) -> None:
    """Record one observation (milliseconds) into a registered family.
    One boolean test when observability is off; unknown names raise —
    register the family in STAGE_FAMILIES."""
    if _ENABLED:
        _REGISTRY[name].observe(ms)


def get(name: str) -> Histogram:
    return _REGISTRY[name]


def families() -> List[Tuple[str, str]]:
    return list(STAGE_FAMILIES)


def snapshot_all() -> Dict[str, Tuple[List[int], float, int]]:
    return {name: h.snapshot() for name, h in _REGISTRY.items()}


def reset_all() -> None:
    for h in _REGISTRY.values():
        h.reset()


# ------------------------------------------------------------ aggregation

def pack_all() -> List[float]:
    """Flatten every family's snapshot into one fixed-width float block
    (family order = STAGE_FAMILIES order) for the worker stats slot."""
    out: List[float] = []
    for name, _ in STAGE_FAMILIES:
        counts, s, n = _REGISTRY[name].snapshot()
        out.extend(float(c) for c in counts)
        out.append(s)
        out.append(float(n))
    return out


def unpack_flat(flat: Sequence[float]) -> Dict[str,
                                               Tuple[List[int], float, int]]:
    """Inverse of :func:`pack_all` (tolerates a short/empty block from a
    worker that has not heartbeated histograms yet)."""
    out: Dict[str, Tuple[List[int], float, int]] = {}
    for fi, (name, _) in enumerate(STAGE_FAMILIES):
        base = fi * FLAT_WIDTH
        if base + FLAT_WIDTH > len(flat):
            break
        counts = [int(c) for c in flat[base:base + N_BUCKETS + 1]]
        out[name] = (counts, float(flat[base + N_BUCKETS + 1]),
                     int(flat[base + N_BUCKETS + 2]))
    return out


def merge(a: Tuple[List[int], float, int],
          b: Tuple[List[int], float, int]) -> Tuple[List[int], float, int]:
    return ([x + y for x, y in zip(a[0], b[0])], a[1] + b[1], a[2] + b[2])


def diff(after: Tuple[List[int], float, int],
         before: Tuple[List[int], float, int]) -> Tuple[List[int], float,
                                                        int]:
    """Observation delta between two snapshots of the same family
    (bench per-config attribution)."""
    return ([max(0, x - y) for x, y in zip(after[0], before[0])],
            max(0.0, after[1] - before[1]), max(0, after[2] - before[2]))


def quantile(counts: Sequence[int], q: float) -> Optional[float]:
    """Estimate the q-quantile (ms) from per-bucket counts with
    geometric interpolation inside the landing bucket (log2 ladder, so
    geometric is the max-entropy choice; Prometheus histogram_quantile
    interpolates linearly — both agree to within a bucket)."""
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
    """p50/p99/p99.9 + count/mean for one family snapshot (bench
    artifacts, graphite exporter)."""
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
