"""Broker metrics: counter/gauge registry with Prometheus text exposition.

Mirrors the reference metric system (``vmq_metrics.erl``): named counters
incremented on every protocol event, gauge providers sampled at scrape time,
per-metric type/description metadata (``vmq_metrics.erl:627-1080``), and a
``check_rate`` helper backing ``max_message_rate`` throttling
(``vmq_metrics.erl:286``). The reference keeps counters in a wait-free C NIF
(mzmetrics); here registered counters live in the C++ counter block
(``native/counters.cc``) behind per-thread Python increment buffers — the
buffer bounds ctypes-call frequency (flush every ``_FLUSH_OPS``), and reads
sum the native block plus every thread's live buffer, so totals are fresh
and nothing strands on an idle pool thread.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..observability import histogram as _hist

COUNTERS: List[Tuple[str, str]] = [
    # socket / session counters (vmq_metrics.hrl names)
    ("socket_open", "The number of AF_INET opens."),
    ("socket_close", "The number of AF_INET closes."),
    ("socket_error", "The number of socket errors."),
    ("bytes_received", "The total number of bytes received."),
    ("bytes_sent", "The total number of bytes sent."),
    ("mqtt_connect_received", "The number of CONNECT packets received."),
    ("mqtt_connack_sent", "The number of CONNACK packets sent."),
    # v4 per-return-code CONNACK counters (vmq_metrics.erl:655-660)
    ("mqtt_connack_accepted_sent",
     "The number of times a connection has been accepted."),
    ("mqtt_connack_unacceptable_protocol_sent",
     "The number of times the broker could not support the requested "
     "protocol."),
    ("mqtt_connack_identifier_rejected_sent",
     "The number of times a client was rejected due to an unacceptable "
     "identifier."),
    ("mqtt_connack_server_unavailable_sent",
     "The number of times a client was rejected due to the broker being "
     "unavailable."),
    ("mqtt_connack_bad_credentials_sent",
     "The number of times a client sent bad credentials."),
    ("mqtt_connack_not_authorized_sent",
     "The number of times a client was rejected due to insufficient "
     "authorization."),
    ("mqtt_publish_received", "The number of PUBLISH packets received."),
    ("mqtt_publish_sent", "The number of PUBLISH packets sent."),
    ("mqtt_puback_received", "The number of PUBACK packets received."),
    ("mqtt_puback_sent", "The number of PUBACK packets sent."),
    ("mqtt_pubrec_received", "The number of PUBREC packets received."),
    ("mqtt_pubrec_sent", "The number of PUBREC packets sent."),
    ("mqtt_pubrel_received", "The number of PUBREL packets received."),
    ("mqtt_pubrel_sent", "The number of PUBREL packets sent."),
    ("mqtt_pubcomp_received", "The number of PUBCOMP packets received."),
    ("mqtt_pubcomp_sent", "The number of PUBCOMP packets sent."),
    ("mqtt_subscribe_received", "The number of SUBSCRIBE packets received."),
    ("mqtt_suback_sent", "The number of SUBACK packets sent."),
    ("mqtt_unsubscribe_received", "The number of UNSUBSCRIBE packets received."),
    ("mqtt_unsuback_sent", "The number of UNSUBACK packets sent."),
    ("mqtt_pingreq_received", "The number of PINGREQ packets received."),
    ("mqtt_pingresp_sent", "The number of PINGRESP packets sent."),
    ("mqtt_disconnect_received", "The number of DISCONNECT packets received."),
    ("mqtt_disconnect_sent", "The number of DISCONNECT packets sent (MQTT5)."),
    ("mqtt_auth_received", "The number of AUTH packets received (MQTT5)."),
    ("mqtt_auth_sent", "The number of AUTH packets sent (MQTT5)."),
    ("mqtt_connect_error", "Failed CONNECT attempts."),
    ("mqtt_publish_error", "Failed PUBLISH attempts."),
    ("mqtt_publish_auth_error", "Unauthorized PUBLISH attempts."),
    ("mqtt_subscribe_error", "Failed SUBSCRIBE attempts."),
    ("mqtt_subscribe_auth_error", "Unauthorized SUBSCRIBE attempts."),
    ("mqtt_unsubscribe_error", "Failed UNSUBSCRIBE attempts."),
    ("mqtt_invalid_msg_size_error", "Oversized messages dropped."),
    ("mqtt_puback_invalid_error",
     "The number of unexpected PUBACK messages received."),
    ("mqtt_pubrec_invalid_error",
     "The number of unexpected PUBREC messages received."),
    ("mqtt_pubcomp_invalid_error",
     "The number of unexpected PUBCOMP messages received."),
    ("mqtt_publish_throttled",
     "PUBLISHes paused by max_message_rate / overload shedding."),
    ("queue_setup", "The number of queue processes created."),
    ("queue_teardown", "The number of queue processes terminated."),
    ("queue_message_in", "Messages enqueued."),
    ("queue_message_out", "Messages delivered from queues."),
    ("queue_message_drop", "Messages dropped (queue full / offline QoS0)."),
    ("queue_message_expired", "Expired messages dropped from queues."),
    ("queue_message_unhandled", "Messages not handled (offline session)."),
    ("queue_initialized_from_storage", "Queues re-initialized from offline storage."),
    ("client_expired", "Persistent sessions expired."),
    ("cluster_bytes_received", "Bytes received over cluster channels."),
    ("cluster_bytes_sent", "Bytes sent over cluster channels."),
    ("cluster_bytes_dropped", "Bytes dropped on cluster channels."),
    ("cluster_frames_dropped", "Frames dropped on cluster channels."),
    ("cluster_frames_shed_qos0",
     "Buffered QoS0 cluster frames evicted to make room for QoS>=1 "
     "traffic (also counted in cluster_frames_dropped)."),
    ("cluster_spool_journaled",
     "QoS>=1 cluster frames journaled to the delivery spool."),
    ("cluster_spool_replayed",
     "Spooled cluster frames replayed after reconnect/ack timeout."),
    ("cluster_spool_deduped",
     "Replayed cluster frames suppressed by the receiver dedup window."),
    ("cluster_spool_acks_sent",
     "Cumulative spool acks sent back to origin nodes."),
    ("cluster_spool_overflow",
     "Frames refused by the spool byte cap (sent best-effort instead)."),
    ("cluster_spool_errors",
     "Spool journal write failures (frame sent best-effort instead)."),
    ("cluster_publish_drop",
     "Remote publish forwards dropped (buffer full / spool refused "
     "while the stream was paused)."),
    ("cluster_stall_reconnects",
     "Cluster channels cycled by the ack-progress stall detector "
     "(unacked spooled bytes with no cumulative-ack progress for "
     "cluster_stall_timeout_s; the spool replays on reconnect)."),
    ("netsplit_detected", "Netsplits detected."),
    ("netsplit_resolved", "Netsplits resolved."),
    ("router_matches_local", "Subscriptions matched for local delivery."),
    ("router_matches_remote", "Subscriptions matched for remote delivery."),
    ("tpu_match_batches", "Batched TPU match kernel invocations."),
    ("tpu_match_publishes", "Publishes matched on the TPU path."),
    ("msg_store_ops_write", "Message store writes."),
    ("msg_store_ops_delete", "Message store deletes."),
    ("msg_store_write_errors",
     "Message store writes that failed (message kept in memory only)."),
    ("msg_store_read_errors",
     "Message store recovery reads that failed (batched resume AND "
     "per-session fallback; the session resumes with what storage "
     "could serve)."),
    ("msg_store_recover_skipped",
     "Corrupt message-store records skipped during recovery."),
    ("msg_store_fsync_coalesced",
     "Per-record fsyncs coalesced into one group commit at the "
     "flush-tick boundary (msg_store_fsync on)."),
    ("store_compactions",
     "Budgeted store maintenance passes that reclaimed garbage "
     "(segment evacuations / native compactions)."),
    ("store_compacted_bytes",
     "Garbage bytes reclaimed by budgeted store compaction."),
    ("store_compact_paused",
     "Maintenance ticks skipped while the store breaker was open "
     "(append-only degraded mode)."),
    ("store_compact_errors",
     "Store compaction steps that failed or were abandoned at the "
     "watchdog deadline (fed to the store breaker)."),
    ("store_recover_fallbacks",
     "Engine opens that discarded an unusable checkpoint and fell "
     "back to the full segment scan."),
    ("store_bucket_probe_hits",
     "Bucketed-store reads probing a bucket the sid→bucket membership "
     "index named that held messages."),
    ("store_bucket_probe_misses",
     "Bucketed-store reads probing a bucket whose membership turned "
     "out stale (cleaned from the index)."),
    ("msg_store_expired_swept",
     "Expired parked offline message copies deleted by the budgeted "
     "TTL sweep riding the store maintenance tick."),
    ("retain_messages_stored", "Retained messages persisted."),
    # robustness (supervision tree analog + fault harness)
    ("supervisor_restarts", "Supervised tasks restarted after a crash."),
    ("supervisor_escalations",
     "Supervised tasks abandoned after exceeding the restart budget "
     "(listeners torn down)."),
    ("sysmon_long_schedule",
     "Event-loop lag events over the sysmon threshold."),
    ("sysmon_large_heap",
     "Forced GCs after crossing the memory high watermark."),
    # adaptive overload governor (robustness/overload.py): one counter
    # per shed stage so operators see WHICH response is carrying load
    ("overload_publish_throttled",
     "PUBLISHes delayed by the governor's graded read throttle (L1+)."),
    ("overload_rate_limited",
     "PUBLISHes delayed by the per-client token bucket at overload "
     "level 2+."),
    ("overload_qos0_shed",
     "QoS0 publishes shed at the fanout admission gate at overload "
     "level 2+."),
    ("overload_replay_deferred",
     "Retained-replay flushes deferred at overload level 2+."),
    ("overload_connects_refused",
     "CONNECTs refused at the listener while at overload level 3."),
    ("overload_talker_disconnects",
     "Heaviest-talker sessions disconnected (Server busy) entering "
     "overload level 3."),
    # observability (admin/tracer.py): frames the per-client tracer's
    # rate limiter suppressed — a traced storm is visibly truncated
    ("trace_rate_limited",
     "Traced frames suppressed by the tracer rate limiter "
     "(max_rate); the trace output carries a '... N frames "
     "suppressed' marker when the window reopens."),
    # payload filtering & windowed aggregation (vernemq_tpu/filters/):
    # the predicate_*/aggregate_* families — one counter per path so
    # operators see device-vs-host split, escapes, and the zero-cost
    # skip gate working
    ("predicate_dispatches",
     "Predicate-phase device dispatches (one per fold batch carrying "
     "compiled predicates)."),
    ("predicate_pairs_evaluated",
     "(matched-subscriber x predicate) pairs evaluated on the device "
     "path."),
    ("predicate_host_evals",
     "Predicate pairs evaluated by the exact host evaluator "
     "(breaker-open/degraded, sub-threshold batches, and "
     "unrepresentable escapes)."),
    ("predicate_escapes",
     "Predicate pairs host-resolved because the predicate cannot be "
     "represented as one device row (conjunctions, enum alphabets "
     "past 64 codes)."),
    ("predicate_rows_filtered",
     "Matched fanout rows removed by payload predicates before any "
     "per-subscriber queue work."),
    ("predicate_phase_skips",
     "Fold batches that skipped the predicate phase entirely (no "
     "compiled predicates for the batch — the zero-cost gate)."),
    ("predicate_device_failures",
     "Predicate-phase device failures (dispatch errors and watchdog "
     "stalls) fed to the predicate breaker."),
    ("predicate_degraded_sheds",
     "Predicate dispatches refused while the predicate breaker was "
     "open (host evaluator served)."),
    ("predicate_errors",
     "Predicate-phase internal errors that delivered a batch "
     "unfiltered (fail-open, logged loudly)."),
    ("aggregate_values_folded",
     "Payload values folded into aggregation windows (device and "
     "host paths)."),
    ("aggregate_windows_closed",
     "Aggregation windows closed (count target reached or time "
     "window elapsed)."),
    ("aggregate_publishes",
     "Synthesized aggregate PUBLISHes emitted by closed windows."),
    ("aggregate_publishes_delivered",
     "Synthesized aggregate PUBLISHes enqueued to a live subscriber "
     "queue."),
    ("aggregate_window_overflow",
     "Aggregation subscriptions served raw per-message delivery "
     "because the window table hit aggregate_max_windows."),
    # QoS2 exactly-once dedup bound (broker/session.py awaiting_rel):
    # the per-session pid-window is capped at qos2_dedup_max — a
    # slow-release storm evicts oldest-first instead of growing the
    # dict unboundedly (groundwork for the native bitmap in ROADMAP)
    ("qos2_dedup_evictions",
     "QoS2 awaiting-release pids evicted oldest-first because a "
     "session's dedup window hit qos2_dedup_max; an evicted pid's DUP "
     "retransmission re-routes (at-least-once degradation, counted)."),
    # live handoff (cluster/handoff.py): the freeze→drain→fence→adopt
    # state machine moving mesh slices and sessions between nodes
    ("handoff_started",
     "Live handoffs admitted (freeze phase entered) for mesh slices "
     "and session migrations."),
    ("handoff_completed",
     "Live handoffs that reached adopt: the successor owns the unit "
     "and replayed exactly-once; zero QoS>=1 loss."),
    ("handoff_rollbacks",
     "Live handoffs rolled back at a phase failure or watchdog "
     "deadline — the unit un-froze and the old owner kept serving."),
    ("handoff_fenced_writes",
     "Late writes caught by a handoff fence: stale lower-epoch mesh "
     "slice claims rejected, plus post-fence queue arrivals swept to "
     "the new owner instead of landing locally."),
    ("handoff_batch_fence_writes",
     "Shared fence writes issued by batched session handoffs — one "
     "per (batch, target), amortizing the per-session record rewrite "
     "a bulk drain used to pay."),
    # membership health plane (cluster/health.py): accrual failure
    # detector verdicts + the automatic rebalance planner's actions
    # and refusals
    ("member_suspect_transitions",
     "Peers the accrual failure detector marked suspect (phi crossed "
     "health_phi_suspect, or the outbound channel tore)."),
    ("member_down_transitions",
     "Peers the accrual failure detector declared down (phi crossed "
     "health_phi_down); each verdict notes the rebalance planner."),
    ("member_alive_transitions",
     "Peers re-admitted to alive after sustaining low suspicion for "
     "the full hysteresis hold (health_exit_ratio/health_hold_s)."),
    ("handoff_auto_rebalances",
     "Automatic slice-rebalance cycles the planner drove to the "
     "handoff engine (join/alive membership changes)."),
    ("handoff_auto_evacuations",
     "Subscriber records auto-evacuated off a down member onto the "
     "least-loaded survivors by the rebalance planner."),
    ("handoff_auto_skipped_no_quorum",
     "Planner cycles refused because this node could not see a "
     "majority of the joined membership (netsplit minority sits "
     "still)."),
    ("handoff_auto_skipped_breaker",
     "Planner cycles refused because the handoff circuit breaker was "
     "open (repeated rollbacks; a probe must recover it first)."),
    ("handoff_auto_suppressed",
     "Planner cycles suppressed by the per-peer cooldown — the "
     "anti-ping-pong rail for flapping members."),
    ("handoff_auto_limited",
     "Handoffs refused by the global concurrent-handoff limiter "
     "(rebalance_max_concurrent already in flight)."),
]


class Metrics:
    #: buffered increments per thread before a native flush: one ctypes
    #: fetch_add costs ~10x a dict add, and the publish path fires several
    #: counters per delivery (profiled at 13% of broker wall time at 10k
    #: pubs/s) — batching keeps the native block the source of truth with
    #: a bounded lag of < _FLUSH_OPS increments per writer thread
    _FLUSH_OPS = 64

    def __init__(self, native: bool = True) -> None:
        import threading

        self._counters: Dict[str, int] = {name: 0 for name, _ in COUNTERS}
        self._descriptions: Dict[str, str] = dict(COUNTERS)
        # labeled series, keyed (family, (("label","value"),...)) — the
        # reference's per-reason-code counter families
        # (vmq_metrics.erl:787-915: mqtt_connack_sent / mqtt_disconnect_*
        # by reason_code). Event-rate mutation only (CONNACK/DISCONNECT),
        # so a plain dict is fine.
        self._labeled: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], int] = {}
        self._gauge_providers: List[Callable[[], Dict[str, float]]] = []
        self._gauge_desc: Dict[str, str] = {}
        self._rate_state: Dict[object, Tuple[float, int]] = {}
        # worker-mode scrape aggregation hook: a callable returning
        # peer workers' histogram blocks (name -> (counts, sum, count))
        # merged into prometheus_text/histogram_snapshot
        self.histogram_extra: Optional[
            Callable[[], Dict[str, Tuple[List[int], float, int]]]] = None
        # wait-free native counter block for the registered counters (the
        # mzmetrics seat); unknown/dynamic names stay in the dict
        self._native = None
        self._native_idx: Dict[str, int] = {}
        self._tl = threading.local()
        # every thread's live buffer, registered at creation: reads SUM
        # these (dict.get is GIL-atomic) on top of the native block, so
        # another thread's buffered increments are visible immediately —
        # buffering bounds ctypes-call frequency, not read freshness,
        # and nothing is lost if a pool thread goes idle. Entries carry a
        # weakref to their owner thread so reads can sweep buffers of
        # dead threads (fold residuals into the native block once) —
        # otherwise executor churn grows the list without bound.
        self._bufs: List[Tuple[object, Dict[int, int]]] = []
        self._bufs_lock = threading.Lock()
        if native:
            try:
                from ..native import counters as nc

                if nc.available():
                    self._native = nc.CounterBlock([n for n, _ in COUNTERS])
                    self._native_idx = {
                        n: i for i, n in enumerate(n for n, _ in COUNTERS)}
            except Exception:  # toolchain missing etc. — pure-Python path
                self._native = None

    def incr(self, name: str, n: int = 1) -> None:
        idx = self._native_idx.get(name)
        if idx is None:
            self._counters[name] = self._counters.get(name, 0) + n
            return
        tl = self._tl
        buf = getattr(tl, "buf", None)
        if buf is None:
            import threading
            import weakref

            buf = tl.buf = {}
            tl.ops = 0
            with self._bufs_lock:
                self._bufs.append(
                    (weakref.ref(threading.current_thread()), buf))
        buf[idx] = buf.get(idx, 0) + n
        tl.ops += 1
        if tl.ops >= self._FLUSH_OPS:
            self._flush_own()

    def observe(self, name: str, ms: float) -> None:
        """Record one latency observation into a registered stage
        histogram (observability/histogram.py). The registry is
        process-global; this seam exists so layers holding a Metrics
        handle (cluster spool, queues) need no second import."""
        _hist.observe(name, ms)  # lint: observe-passthrough

    def histogram_snapshot(self) -> Dict[str, Tuple[List[int], float, int]]:
        """Merged histogram families: this process's registry plus
        whatever ``histogram_extra`` contributes (the broker wires the
        other workers' shm stat-slot blocks in worker mode) — name ->
        (bucket counts incl. overflow, sum_ms, count)."""
        snap = _hist.snapshot_all()
        extra = self.histogram_extra
        if extra is not None:
            try:
                for name, peer in extra().items():
                    cur = snap.get(name)
                    snap[name] = (_hist.merge(cur, peer)
                                  if cur is not None else peer)
            except Exception:
                pass  # a torn slot read must never break the scrape
        return snap

    def incr_labeled(self, name: str, n: int = 1, **labels: str) -> None:
        """Count into a labeled series (per-reason-code families). The
        flat family counter is incremented separately by the caller where
        the reference keeps both (e.g. mqtt_connack_sent)."""
        key = (name, tuple(sorted(labels.items())))
        self._labeled[key] = self._labeled.get(key, 0) + n

    def _flush_own(self) -> None:
        """Drain this thread's buffered increments into the native block
        (one ctypes call per touched counter instead of per increment)."""
        tl = self._tl
        buf = getattr(tl, "buf", None)
        if buf:
            native_incr = self._native.incr
            for idx, n in list(buf.items()):
                native_incr(idx, n)
            buf.clear()
        tl.ops = 0

    def _swept_pending(
        self,
    ) -> Tuple[List[Dict[int, int]], Dict[int, int]]:
        """Snapshot live threads' buffers, sweeping dead-thread entries
        (bounds _bufs under executor/thread churn). A dead thread can no
        longer mutate its buffer, so its residual counts are folded into
        the native block exactly once AND returned — callers took their
        native reading before this call, so they must add the residuals
        themselves to see them this read; later reads get them from the
        native block. Per-key dict.get on live buffers is GIL-atomic, so
        other threads' buffers are read without locks; a racing flush
        could briefly double- or under-count by one buffer's worth
        (< _FLUSH_OPS) — monotonic-exact totals land at the next read."""
        live: List[Dict[int, int]] = []
        residual: Dict[int, int] = {}
        with self._bufs_lock:
            kept = []
            for wr, buf in self._bufs:
                t = wr()
                if t is not None and t.is_alive():
                    kept.append((wr, buf))
                    live.append(buf)
                else:
                    for idx, n in list(buf.items()):
                        residual[idx] = residual.get(idx, 0) + n
                    buf.clear()
            self._bufs = kept
            # fold under the lock: once the entries are gone from
            # _bufs, a concurrent reader can only see the residuals via
            # the native block — folding outside the lock would open a
            # window where a scrape reads a non-monotonic dip
            if residual:
                native_incr = self._native.incr
                for idx, n in residual.items():
                    native_incr(idx, n)
        return live, residual

    def _pending(self, idx: int) -> int:
        """Buffered (not yet natively flushed) increments for one counter
        that a native reading taken BEFORE this call does not include:
        live threads' buffers plus just-folded dead-thread residuals."""
        live, residual = self._swept_pending()
        return sum(b.get(idx, 0) for b in live) + residual.get(idx, 0)

    def value(self, name: str) -> int:
        idx = self._native_idx.get(name)
        if idx is not None:
            self._flush_own()
            return self._native.read(idx) + self._pending(idx)
        return self._counters.get(name, 0)

    def describe(self, name: str) -> str:
        return self._descriptions.get(name) or self._gauge_desc.get(name, "")

    def register_gauges(
        self, provider: Callable[[], Dict[str, float]], descriptions: Dict[str, str]
    ) -> None:
        """Pluggable gauge providers, like the reference's pluggable
        ``metrics/0`` modules (vmq_metrics.erl metrics plugins)."""
        self._gauge_providers.append(provider)
        self._gauge_desc.update(descriptions)

    def check_rate(self, key: object, max_per_sec: int) -> bool:
        """Sliding-window rate check for max_message_rate
        (vmq_metrics.erl:286). True = within budget."""
        if max_per_sec <= 0:
            return True
        now = time.monotonic()
        start, count = self._rate_state.get(key, (now, 0))
        if now - start >= 1.0:
            start, count = now, 0
        count += 1
        self._rate_state[key] = (start, count)
        return count <= max_per_sec

    def rate_wait_s(self, key: object) -> float:
        """Seconds until ``key``'s current rate window rolls over — the
        precise pause for a throttled publisher (the old path slept a
        blind 1.0s however much of the window had already elapsed)."""
        start, _ = self._rate_state.get(key, (0.0, 0))
        # +2ms past the rollover so the post-wake re-check lands firmly
        # inside the fresh window despite timer/float granularity
        return max(0.005, start + 1.0 - time.monotonic() + 0.002)

    def drop_rate_state(self, key: object) -> None:
        self._rate_state.pop(key, None)

    def _native_totals(self) -> Dict[str, int]:
        """Native block snapshot plus every thread's buffered counts —
        one sweep for the whole scrape (snapshot is taken first, so
        just-folded dead-thread residuals are added explicitly)."""
        self._flush_own()
        snap = self._native.snapshot()
        live, residual = self._swept_pending()
        for name, idx in self._native_idx.items():
            snap[name] += (sum(b.get(idx, 0) for b in live)
                           + residual.get(idx, 0))
        return snap

    def all_metrics(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self._counters)
        if self._native is not None:
            out.update(self._native_totals())
        for (name, labels), val in self._labeled.items():
            lbl = ",".join(f'{k}="{v}"' for k, v in labels)
            out[f"{name}{{{lbl}}}"] = val
        for provider in self._gauge_providers:
            out.update(provider())
        # histogram families surface in the $SYS feed as count/sum
        # scalars (rate + mean are derivable); the bucket vectors are
        # Prometheus-exposition-only and the quantiles are the graphite
        # reporter's <name>.p50/p99/p999 — one home per representation
        for name, snap in self.histogram_snapshot().items():
            _counts, s, n = snap
            out[f"{name}_count"] = float(n)
            out[f"{name}_sum"] = round(s, 3)
        return out

    def prometheus_text(self, node: str = "local") -> str:
        """Prometheus exposition format (vmq_metrics_http.erl:42-84).
        Labeled series join their flat family under ONE HELP/TYPE header
        (exposition-format requirement: one metadata block per family,
        samples contiguous)."""
        lines: List[str] = []
        gauges: Dict[str, float] = {}
        for provider in self._gauge_providers:
            gauges.update(provider())
        counters = dict(self._counters)
        if self._native is not None:
            counters.update(self._native_totals())
        labeled: Dict[str, List[Tuple[str, int]]] = {}
        for (name, labels), val in sorted(self._labeled.items()):
            lbl = "".join(f',{k}="{v}"' for k, v in labels)
            labeled.setdefault(name, []).append((lbl, val))
        for name in sorted(set(counters) | set(labeled)):
            desc = self._descriptions.get(name, name)
            lines.append(f"# HELP {name} {desc}")
            lines.append(f"# TYPE {name} counter")
            if name in counters:
                lines.append(f'{name}{{node="{node}"}} {counters[name]}')
            for lbl, val in labeled.get(name, ()):
                lines.append(f'{name}{{node="{node}"{lbl}}} {val}')
        for name, val in sorted(gauges.items()):
            desc = self._gauge_desc.get(name, name)
            lines.append(f"# HELP {name} {desc}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f'{name}{{node="{node}"}} {val}')
        # stage latency histograms: proper _bucket/_sum/_count families
        # with cumulative le buckets (observability/histogram.py); in
        # worker mode the snapshot already merged every live worker's
        # shm slot, so any worker's scrape is the node-level view
        helps = dict(_hist.STAGE_FAMILIES)
        for name, snap in sorted(self.histogram_snapshot().items()):
            counts, s, n = snap
            lines.append(f"# HELP {name} {helps.get(name, name)}")
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for i, bound in enumerate(_hist.BUCKET_BOUNDS_MS):
                cum += counts[i]
                lines.append(f'{name}_bucket{{node="{node}",'
                             f'le="{bound:g}"}} {cum}')
            cum += counts[_hist.N_BUCKETS]
            lines.append(
                f'{name}_bucket{{node="{node}",le="+Inf"}} {cum}')
            lines.append(f'{name}_sum{{node="{node}"}} {round(s, 6)}')
            lines.append(f'{name}_count{{node="{node}"}} {n}')
        return "\n".join(lines) + "\n"
