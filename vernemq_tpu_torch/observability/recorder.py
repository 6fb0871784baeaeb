"""Publish-path flight recorder: stage-stamped samples in a bounded ring.

One :class:`PublishTrace` per SAMPLED publish (1-in-N, decided once at
admission in ``session._handle_publish``), carried through the routing
layers and the batch-collector fold envelope: the session stamps
admission and route completion, the collector stamps dequeue/dispatch,
and in worker mode the match-service fold meta (service receive/done
monotonic stamps + pid, carried back in the ring reply) lands in the
same trace — ONE record per publish with per-stage deltas including the
cross-process ring transit, computable because ``time.monotonic`` is
CLOCK_MONOTONIC and system-wide on the deployment target (Linux).

Records are plain dicts in a ``deque(maxlen=...)``: admission under
load evicts the oldest sample, never blocks, never grows. The ring is
drained by ``vmq-admin timeline show`` and exported as Chrome
trace-event JSON by ``vmq-admin timeline dump`` (Perfetto-loadable).
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import histogram as hist

#: trace mark label -> human stage name used in records/trace events
_STAGE_OF = {
    "admit": "admission",
    "submit": "collector_submit",
    "dequeue": "collector_wait",
    "match": "match",
    "route": "route",
    "forward": "cluster_forward",
    "remote_recv": "cluster_ingress",
}


class PublishTrace:
    """Stage stamps for one sampled publish. ``stamp()`` is append-only
    and thread-safe enough for its single-writer-per-stage reality (the
    session, then the collector flush, then the route callback)."""

    __slots__ = ("t0", "wall", "info", "marks", "meta", "origin")

    def __init__(self, info: Tuple[str, str, int]):
        self.t0 = time.monotonic()
        self.wall = time.time()
        self.info = info  # (client_id, topic, qos)
        self.marks: List[Tuple[str, float]] = []
        self.meta: Optional[Dict[str, Any]] = None  # service fold meta
        # cross-NODE resume context (cluster/com.py): the origin node's
        # stamps, carried in the negotiated trace field of the cluster
        # envelope, so the receiving node's record alone renders BOTH
        # nodes' tracks in one Perfetto trace
        self.origin: Optional[Dict[str, Any]] = None

    def stamp(self, label: str) -> None:
        self.marks.append((label, time.monotonic()))

    def export_wire(self, node: str) -> Dict[str, Any]:
        """The trace context that rides the cluster data plane to a
        trace-capable peer: identity, the origin's monotonic stamps,
        and a send stamp the receiver uses for clock-offset estimation.
        Small, plain-codec-able types only."""
        cid, topic, qos = self.info
        return {"n": node, "c": cid, "t": topic, "q": qos,
                "t0": self.t0, "m": [list(m) for m in self.marks],
                "s": time.monotonic()}


class ClockSync:
    """Per-peer CLOCK_MONOTONIC offset estimation for merged traces.

    Two feeds, both piggybacked on traffic that already flows:

    - ``observe_delta(peer, remote_send_t, local_recv_t)`` — every
      traced cluster frame carries the origin's send stamp; the raw
      delta ``local - remote`` equals the true clock offset PLUS the
      one-way transit delay.
    - ``observe_rtt(peer, rtt_ms)`` — the spool's journal→cumulative-ack
      round trip (already histogrammed as ``stage_cluster_ack_rtt_ms``)
      estimates that delay as RTT/2.

    The delta estimate is a **windowed minimum** (the NTP-style filter),
    not an EWMA: a spool-REPLAYED traced frame carries its original
    export-time send stamp, so its delta is inflated by the whole
    outage/queueing delay — a mean-style fold would jump the offset by
    that much, while a min is only ever lowered by the freshest,
    fastest samples (min delta ≈ offset + minimal transit). The window
    bounds drift: old minima age out after ``_WINDOW`` samples.

    ``offset(peer)`` = min(delta window) − EWMA(rtt)/2: add it to a
    remote stamp to place it on the local axis. In-process/one-host
    deployments share the clock, so the estimate degrades gracefully to
    ≈ transit time when no RTT feed exists yet."""

    _ALPHA = 0.2
    _WINDOW = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._deltas: Dict[str, deque] = {}  # seconds, last _WINDOW
        self._rtt: Dict[str, float] = {}     # seconds

    def observe_delta(self, peer: str, remote_send_t: Optional[float],
                      local_recv_t: float) -> None:
        if remote_send_t is None:
            return
        d = local_recv_t - float(remote_send_t)
        with self._lock:
            win = self._deltas.get(peer)
            if win is None:
                win = self._deltas[peer] = deque(maxlen=self._WINDOW)
            win.append(d)

    def observe_rtt(self, peer: str, rtt_ms: float) -> None:
        r = rtt_ms / 1e3
        with self._lock:
            prev = self._rtt.get(peer)
            self._rtt[peer] = (r if prev is None
                               else prev + self._ALPHA * (r - prev))

    def _delta_locked(self, peer: str) -> Optional[float]:
        win = self._deltas.get(peer)
        return min(win) if win else None

    def offset(self, peer: str) -> float:
        """Seconds to ADD to ``peer``'s monotonic stamps to land them on
        the local axis (0.0 until a delta sample exists)."""
        with self._lock:
            d = self._delta_locked(peer)
            if d is None:
                return 0.0
            return d - self._rtt.get(peer, 0.0) / 2.0

    def peers(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for p in self._deltas:
                d = self._delta_locked(p)
                if d is None:
                    continue
                out[p] = {"delta_s": round(d, 6),
                          "rtt_ms": round(
                              self._rtt.get(p, 0.0) * 1e3, 3),
                          "offset_s": round(
                              d - self._rtt.get(p, 0.0) / 2.0, 6)}
            return out


_CLOCK_SYNC = ClockSync()


def clock_sync() -> ClockSync:
    """Process-global per-peer clock-offset estimator (fed by the
    cluster ingress path and the spool ack path)."""
    return _CLOCK_SYNC


class FlightRecorder:
    """Bounded ring of per-publish stage records."""

    def __init__(self, sample_n: int = 32, capacity: int = 4096,
                 node: str = ""):
        self.sample_n = max(0, int(sample_n))
        self.records: deque = deque(maxlen=max(16, int(capacity)))
        self.node = node  # track identity in multi-node merged traces
        self._admitted = 0
        self.sampled = 0
        self.finished = 0
        self.resumed = 0  # traces resumed from a cluster peer's context

    # ------------------------------------------------------------ sampling

    def admit(self, client_id: str, topic: str,
              qos: int) -> Optional[PublishTrace]:
        """The ONE sample decision, made at admission: every
        ``sample_n``-th publish gets a trace that rides the whole path.
        Deterministic (a counter, not a RNG) so tests and drills can
        predict exactly which publishes record. Cluster-ingress
        publishes (``publish_from_remote``) are admission points too —
        a remote publish without a propagated trace context competes
        in the same 1-in-N count as local ones."""
        if not hist.enabled() or self.sample_n <= 0:
            return None
        self._admitted += 1
        if self._admitted % self.sample_n:
            return None
        self.sampled += 1
        return PublishTrace((client_id, topic, qos))

    def resume(self, ctx: Dict[str, Any],
               origin: str) -> Optional[PublishTrace]:
        """Resume a trace whose sample decision was made on the ORIGIN
        node (the context arrived in the cluster envelope's negotiated
        trace field). The local trace starts now; the origin's stamps
        ride along so the finished record renders both nodes' tracks,
        and the send→recv delta feeds the per-peer clock-offset
        estimator."""
        if not hist.enabled() or not isinstance(ctx, dict):
            return None
        try:
            tr = PublishTrace((str(ctx.get("c", "")),
                               str(ctx.get("t", "")),
                               int(ctx.get("q", 0) or 0)))
            node = str(ctx.get("n") or origin)
            tr.origin = {
                "node": node,
                "t0": ctx.get("t0"),
                "marks": [(str(l), float(t))
                          for l, t in (ctx.get("m") or [])],
                "send_t": ctx.get("s"),
                "recv_t": tr.t0,
            }
            _CLOCK_SYNC.observe_delta(node, ctx.get("s"), tr.t0)
        except Exception:
            # malformed context from a peer is telemetry, never worth a
            # dropped message: the caller routes with trace=None. Broad
            # by design — any shape a peer (or a future version) puts
            # here must degrade to "no trace", not an exception that
            # aborts the cluster dispatch (a spooled frame's seq was
            # already accepted, so the origin would trim it: QoS1 loss)
            return None
        tr.stamp("remote_recv")
        self.sampled += 1
        self.resumed += 1
        return tr

    # ------------------------------------------------------------- records

    def finish(self, trace: PublishTrace) -> Dict[str, Any]:
        """Compute per-stage deltas and append ONE record. Also feeds
        the sampled ``stage_parse_route_ms`` histogram (total broker
        residency of the sampled publish)."""
        cid, topic, qos = trace.info
        stages: Dict[str, float] = {}
        prev = trace.t0
        last = trace.t0
        for label, t in trace.marks:
            name = _STAGE_OF.get(label, label)
            stages[f"{name}_ms"] = round((t - prev) * 1e3, 4)
            prev = t
            last = max(last, t)
        meta = trace.meta
        if meta and "svc_recv" in meta:
            # cross-process split of the ring round trip: request
            # transit, service residency (its own collector + device
            # dispatch), reply transit — stamps are system-wide
            # CLOCK_MONOTONIC, comparable across processes
            send_t = meta.get("send_t")
            recv_t = meta.get("recv_t")
            if send_t is not None:
                stages["ring_request_ms"] = round(
                    (meta["svc_recv"] - send_t) * 1e3, 4)
            if "svc_done" in meta:
                stages["service_ms"] = round(
                    (meta["svc_done"] - meta["svc_recv"]) * 1e3, 4)
                if recv_t is not None:
                    stages["ring_reply_ms"] = round(
                        (recv_t - meta["svc_done"]) * 1e3, 4)
        total_ms = (last - trace.t0) * 1e3
        rec: Dict[str, Any] = {
            "ts": trace.wall,
            "t0": trace.t0,
            "client": cid,
            "topic": topic,
            "qos": qos,
            "pid": os.getpid(),
            "total_ms": round(total_ms, 4),
            "stages": stages,
            "marks": [("start", trace.t0)] + list(trace.marks),
        }
        if self.node:
            rec["node"] = self.node
        origin = trace.origin
        if origin:
            offset = _CLOCK_SYNC.offset(origin["node"])
            rec["origin"] = dict(origin, offset_s=round(offset, 6))
            send_t = origin.get("send_t")
            if send_t is not None:
                # transit on the LOCAL axis: recv - (send + offset);
                # sub-RTT noise can push the estimate slightly negative
                # — keep it raw, a clamped number would hide clock-sync
                # error instead of displaying it
                stages["cluster_transit_ms"] = round(
                    (origin["recv_t"] - (send_t + offset)) * 1e3, 4)
        if meta:
            rec["svc_pid"] = meta.get("svc_pid")
            if "svc_recv" in meta:
                rec["svc_span"] = (meta["svc_recv"],
                                   meta.get("svc_done", meta["svc_recv"]))
        self.records.append(rec)
        self.finished += 1
        hist.observe("stage_parse_route_ms", total_ms)
        return rec

    def snapshot(self, limit: int = 0) -> List[Dict[str, Any]]:
        out = list(self.records)
        return out[-limit:] if limit else out

    def stats(self) -> Dict[str, float]:
        return {
            "flight_sampled": float(self.sampled),
            "flight_records": float(len(self.records)),
            "flight_sample_n": float(self.sample_n),
            "flight_resumed": float(self.resumed),
        }


# ------------------------------------------------------- trace-event export

def chrome_trace(records: List[Dict[str, Any]],
                 dispatches: Optional[List[Dict[str, Any]]] = None,
                 node: str = "broker",
                 journal_events: Optional[List[Dict[str, Any]]] = None,
                 ) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` object
    format Perfetto/chrome://tracing load): one complete ("ph": "X")
    event per publish stage and per device-dispatch record, plus one
    instant ("ph": "i") event per control-plane journal event, all
    pid-tagged so worker, match-service and REMOTE-NODE spans land in
    separate tracks. Timestamps are CLOCK_MONOTONIC microseconds — one
    shared axis for every process on the host; a record resumed from a
    cluster peer carries the origin node's stamps, which are shifted by
    the per-peer clock-offset estimate and rendered as that node's own
    process track with a flow arrow across the wire, so ONE dump shows
    a publish that traversed origin worker → spool → peer node →
    remote fanout."""
    events: List[Dict[str, Any]] = []
    pids: Dict[Tuple[str, int], int] = {}
    used: set = set()

    def _proc(pid: Optional[int], name: str) -> int:
        """One output pid per (track name, real pid): two in-process
        brokers share a real pid but must not share a Perfetto track,
        and a REMOTE node has no local pid at all — its track pid is
        synthesized from the node name (stable across dumps)."""
        key = (name, int(pid or 0))
        if key in pids:
            return pids[key]
        p = (int(pid) if pid
             else 0x40000000 + zlib.crc32(name.encode()) % 0xFFFF)
        while p in used:
            p += 1
        used.add(p)
        pids[key] = p
        events.append({"name": "process_name", "ph": "M", "pid": p,
                       "tid": 0, "args": {"name": f"{name} ({p})"}})
        return p

    flow_id = 0
    for rec in records or []:
        rnode = rec.get("node") or node
        pid = _proc(rec.get("pid"), f"{rnode}-worker")
        marks = rec.get("marks") or []
        for (l0, t0), (l1, t1) in zip(marks, marks[1:]):
            events.append({
                "name": _STAGE_OF.get(l1, l1), "cat": "publish",
                "ph": "X", "ts": round(t0 * 1e6, 1),
                "dur": max(0.1, round((t1 - t0) * 1e6, 1)),
                "pid": pid, "tid": 1,
                "args": {"client": rec.get("client"),
                         "topic": rec.get("topic"),
                         "qos": rec.get("qos")},
            })
        span = rec.get("svc_span")
        if span:
            spid = _proc(rec.get("svc_pid"), "match-service")
            events.append({
                "name": "service_fold", "cat": "publish", "ph": "X",
                "ts": round(span[0] * 1e6, 1),
                "dur": max(0.1, round((span[1] - span[0]) * 1e6, 1)),
                "pid": spid, "tid": 1,
                "args": {"client": rec.get("client"),
                         "topic": rec.get("topic")},
            })
        origin = rec.get("origin")
        if origin:
            # the origin NODE's stamps, shifted onto the local axis by
            # the clock-offset estimate — no real pid exists for a
            # remote process, so the track pid is synthesized from the
            # node name (stable across dumps)
            onode = origin.get("node", "origin")
            opid = _proc(None, f"{onode}-worker")
            off = float(origin.get("offset_s") or 0.0)
            omarks = [("start", origin.get("t0"))] \
                + [tuple(m) for m in (origin.get("marks") or [])]
            omarks = [(l, t) for l, t in omarks if t is not None]
            for (l0, t0), (l1, t1) in zip(omarks, omarks[1:]):
                events.append({
                    "name": _STAGE_OF.get(l1, l1), "cat": "publish",
                    "ph": "X", "ts": round((t0 + off) * 1e6, 1),
                    "dur": max(0.1, round((t1 - t0) * 1e6, 1)),
                    "pid": opid, "tid": 1,
                    "args": {"client": rec.get("client"),
                             "topic": rec.get("topic"),
                             "qos": rec.get("qos")},
                })
            send_t = origin.get("send_t")
            recv_t = origin.get("recv_t")
            if send_t is not None and recv_t is not None:
                # flow arrow across the cluster wire (Perfetto renders
                # the hop between the two node tracks)
                flow_id += 1
                events.append({
                    "name": "cluster_hop", "cat": "publish", "ph": "s",
                    "id": flow_id, "ts": round((send_t + off) * 1e6, 1),
                    "pid": opid, "tid": 1})
                events.append({
                    "name": "cluster_hop", "cat": "publish", "ph": "f",
                    "bp": "e", "id": flow_id,
                    "ts": round(recv_t * 1e6, 1), "pid": pid, "tid": 1})
    for d in dispatches or []:
        pid = _proc(d.get("pid"), f"{node}-worker")
        args = {k: v for k, v in d.items()
                if k not in ("t0", "dur_ms", "pid", "kind")}
        events.append({
            "name": f"device.{d.get('kind', 'dispatch')}", "cat": "device",
            "ph": "X", "ts": round(d["t0"] * 1e6, 1),
            "dur": max(0.1, round(d["dur_ms"] * 1e3, 1)),
            "pid": pid, "tid": 2, "args": args,
        })
    for ev in journal_events or []:
        enode = ev.get("node") or node
        pid = _proc(ev.get("pid"), f"{enode}-worker")
        events.append({
            "name": ev.get("code", "event"), "cat": "events",
            "ph": "i", "s": "p",
            "ts": round(ev["t"] * 1e6, 1), "pid": pid, "tid": 3,
            "args": {"detail": ev.get("detail", ""),
                     "value": ev.get("value", 0.0)},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"node": node, "clock": "CLOCK_MONOTONIC"}}
