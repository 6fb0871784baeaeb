"""Control-plane event journal: the broker's black-box flight log.

Every state machine the robustness work added (circuit breakers, the
overload governor, the stall watchdog, the supervisor, the mesh slice
map, the cluster spool, the wire plane) already *logs* its transitions —
but a log line is neither queryable nor correlatable with a latency
spike. This module is the structured twin: a bounded ring of fixed-shape
events with monotonic stamps, fed by ``events.emit(<code>, ...)`` at
each transition, drained by ``vmq-admin events show|dump`` (and the QL
``events`` table), interleaved into ``chrome_trace()`` as instant
events on the emitting process's track, and — in worker mode — packed
into per-worker ``WorkerStatsBlock`` slots so any worker can fold the
whole node's event stream into ONE artifact (``--merge``).

Design rules:

- **Fixed code registry.** Every emit site names a code in
  :data:`KNOWN_EVENTS` and every registered code has at least one emit
  site — the ``events-registry`` vmqlint pass enforces both directions,
  exactly like the fault-point registry. A typo'd code is a tree-red
  finding, not a silently empty timeline.
- **Rare by construction.** Events are state *transitions* (a breaker
  opening, a governor level change), never per-publish — so one small
  lock around the ring is cheap and the hot path never sees it.
- **One gate.** Emission is behind the same ``observability_enabled``
  boolean as the histograms: off, ``emit`` is one module-global test.
- **Monotonic stamps.** ``time.monotonic()`` — the same system-wide
  clock the flight recorder uses, so events and publish stages share
  one Perfetto axis with no conversion.

The journal is process-global (like the fault registry and the
histogram registry): breaker code emits without threading a handle
through every layer, and the broker's gauge provider reads per-code
counts at scrape time (``event_<code>`` counter gauges).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import histogram as hist

#: The event-code registry: code -> (emitting subsystem, HELP text).
#: Every ``events.emit(<code>)`` site must name a code here and every
#: code must have at least one emit site (tools/vmqlint events-registry
#: pass, mirroring faults.KNOWN_POINTS). The HELP text doubles as the
#: ``event_<code>`` gauge description in the Prometheus exposition.
KNOWN_EVENTS: Dict[str, Tuple[str, str]] = {
    "breaker_open": (
        "robustness/breaker",
        "A circuit breaker opened (device/wire path degraded to its "
        "exact host fallback); detail names the breaker path."),
    "breaker_half_open": (
        "robustness/breaker",
        "A circuit breaker granted its single half-open probe; detail "
        "names the breaker path."),
    "breaker_close": (
        "robustness/breaker",
        "A circuit breaker closed (probe success or operator reset — "
        "the degraded path recovered); detail names the breaker path."),
    "overload_level_enter": (
        "robustness/overload",
        "The overload governor escalated to a higher level; value is "
        "the new level, detail carries the triggering signal set."),
    "overload_level_exit": (
        "robustness/overload",
        "The overload governor de-escalated to a lower level; value is "
        "the new level."),
    "watchdog_stall": (
        "robustness/watchdog",
        "A monitored operation overran its deadline (detail names the "
        "point and label)."),
    "watchdog_abandon": (
        "robustness/watchdog",
        "A stalled operation was abandoned — the waiter was released "
        "to the host fallback and the straggler's eventual result is "
        "doomed to discard."),
    "watchdog_late_discard": (
        "robustness/watchdog",
        "An abandoned operation completed late and its result was "
        "DISCARDED (never delivered)."),
    "cluster_ack_stall": (
        "cluster",
        "The ack-progress stall detector cycled a half-open cluster "
        "channel (detail names the peer; the spool replays on "
        "reconnect)."),
    "supervisor_restart": (
        "broker/supervisor",
        "A supervised background task crashed and was restarted "
        "(detail names the task)."),
    "supervisor_escalation": (
        "broker/supervisor",
        "A supervised task exceeded its restart budget and was "
        "abandoned (listeners torn down)."),
    "mesh_slice_claim": (
        "cluster/mesh_map",
        "This node claimed mesh slices in a claim pass (value is the "
        "number of newly owned slices)."),
    "mesh_slice_adopt": (
        "cluster/mesh_map",
        "A remote claim transferred a slice to this node and the "
        "adopt-replay hook fired (detail names the slice)."),
    "mesh_slice_release": (
        "cluster/mesh_map",
        "This node retracted its mesh slice claims (degraded tpu view "
        "or shutdown; value is the number of slices released)."),
    "spool_replay_start": (
        "cluster/spool",
        "A spool replay sweep started for a peer (channel-up resync or "
        "retransmit watchdog; detail names the peer)."),
    "spool_replay_end": (
        "cluster/spool",
        "A spool replay sweep finished for a peer (value is frames "
        "shipped; a paused sweep ends without covering the backlog)."),
    "wire_fallback": (
        "protocol/fastpath",
        "The native wire codec failed and the wire breaker opened — "
        "frames are served by the bit-identical pure-Python twin until "
        "a probe recovers (detail: parse|encode)."),
    "canary_slo_breach": (
        "observability/canary",
        "A canary probe's end-to-end latency exceeded canary_slo_ms "
        "(value is the measured e2e in ms)."),
    "handoff_start": (
        "cluster/handoff",
        "A live handoff entered its freeze phase (detail is "
        "kind:unit->target); the moving unit parks new arrivals until "
        "adopt or rollback."),
    "handoff_fence": (
        "cluster/handoff",
        "A handoff fenced the old owner: the epoch-bumped ownership "
        "record landed in the metadata plane and late writes at the "
        "old epoch are rejected/forwarded (detail is kind:unit)."),
    "handoff_complete": (
        "cluster/handoff",
        "A handoff finished its adopt phase — the successor owns the "
        "unit and replayed exactly-once (value is the freeze-to-adopt "
        "pause in ms)."),
    "handoff_rollback": (
        "cluster/handoff",
        "A handoff phase failed or overran its deadline and was rolled "
        "back — the unit un-froze and the OLD owner keeps serving "
        "(detail names the phase and cause)."),
    "member_suspect": (
        "cluster/health",
        "The accrual failure detector marked a peer suspect — phi "
        "crossed health_phi_suspect or its channel tore (detail names "
        "the peer, value is phi)."),
    "member_down": (
        "cluster/health",
        "The accrual failure detector declared a peer down (phi "
        "crossed health_phi_down); the rebalance planner is notified "
        "(detail names the peer, value is phi)."),
    "member_alive": (
        "cluster/health",
        "A suspect/down peer re-entered alive after sustaining low "
        "suspicion for the full hysteresis hold (detail names the "
        "peer)."),
    "rebalance_plan": (
        "cluster/health",
        "The rebalance planner started a cycle — evacuation for a "
        "down member, load-aware slice spread for a join/recovery "
        "(detail is peer: reason)."),
    "rebalance_skipped": (
        "cluster/health",
        "A planner cycle was refused by a safety rail — per-peer "
        "cooldown, missing quorum, or the open handoff breaker "
        "(detail is peer: cause)."),
}

#: stable code order for the fixed-width shm packing (index = wire id)
EVENT_CODES: List[str] = sorted(KNOWN_EVENTS)
_CODE_INDEX: Dict[str, int] = {c: i for i, c in enumerate(EVENT_CODES)}

#: events retained per worker stats-block slot, and the flat f64 width
#: of one packed slot region: a write counter plus (t_mono, wall,
#: code_index, value) per event. Detail strings do NOT cross the shm
#: boundary — the merged artifact carries code/stamps/value for remote
#: workers and full detail for the local journal.
EVENT_SLOTS = 256
PACK_WIDTH = 1 + EVENT_SLOTS * 4


class EventJournal:
    """Bounded ring of control-plane events (process-global singleton
    via :func:`journal`). ``emit`` is transition-rate, not publish-rate,
    so one small lock covers the ring and the per-code counters."""

    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(64, int(capacity)))
        self.counts: Dict[str, int] = {}
        self.emitted = 0
        self.dropped = 0  # ring evictions (oldest event lost)

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            if self._ring.maxlen != max(64, int(capacity)):
                self._ring = deque(self._ring,
                                   maxlen=max(64, int(capacity)))

    def emit(self, code: str, detail: str = "", value: float = 0.0) -> None:
        if code not in KNOWN_EVENTS:
            raise KeyError(f"unregistered event code: {code!r} "
                           f"(register it in events.KNOWN_EVENTS)")
        ev = {"t": time.monotonic(), "ts": time.time(), "code": code,
              "pid": os.getpid(), "detail": detail,
              "value": float(value)}
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
            self.emitted += 1
            self.counts[code] = self.counts.get(code, 0) + 1

    def snapshot(self, limit: int = 0, code: Optional[str] = None,
                 since: Optional[float] = None) -> List[Dict[str, Any]]:
        """Events oldest-first, optionally filtered by code and by
        monotonic stamp (``since`` — the tail-follow cursor: pass the
        last event's ``t`` back to read only what is new)."""
        with self._lock:
            out = list(self._ring)
        if code is not None:
            out = [e for e in out if e["code"] == code]
        if since is not None:
            out = [e for e in out if e["t"] > since]
        return out[-limit:] if limit else out

    def stats(self) -> Dict[str, float]:
        """Per-code counter gauges + totals for $SYS/Prometheus."""
        with self._lock:
            out = {f"event_{c}": float(self.counts.get(c, 0))
                   for c in EVENT_CODES}
            out["events_emitted"] = float(self.emitted)
            out["events_dropped"] = float(self.dropped)
            return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.counts.clear()
            self.emitted = 0
            self.dropped = 0

    # -------------------------------------------------- shm aggregation

    def pack(self) -> List[float]:
        """The newest EVENT_SLOTS events as one fixed-width float block
        for this worker's stats slot: [n, (t, wall, code_idx, value) x
        EVENT_SLOTS]. Single writer (the heartbeat), torn reads heal on
        the next heartbeat exactly like the histogram blocks."""
        with self._lock:
            tail = list(self._ring)[-EVENT_SLOTS:]
        flat: List[float] = [float(len(tail))]
        for e in tail:
            flat.extend((e["t"], e["ts"],
                         float(_CODE_INDEX.get(e["code"], -1)),
                         e["value"]))
        flat.extend([0.0] * (PACK_WIDTH - len(flat)))
        return flat


def unpack(flat: Sequence[float], pid: int = 0) -> List[Dict[str, Any]]:
    """Inverse of :meth:`EventJournal.pack` (tolerates a short/empty
    block from a worker that has not heartbeated events yet)."""
    if not flat:
        return []
    n = min(int(flat[0]), EVENT_SLOTS, (len(flat) - 1) // 4)
    out = []
    for i in range(n):
        t, wall, idx, value = flat[1 + i * 4:5 + i * 4]
        idx = int(idx)
        if not 0 <= idx < len(EVENT_CODES):
            continue  # torn slot entry: skip, the ring heals next write
        out.append({"t": t, "ts": wall, "code": EVENT_CODES[idx],
                    "pid": pid, "detail": "", "value": value})
    return out


def gauge_help() -> Dict[str, str]:
    """HELP text for the ``event_<code>`` counter gauges plus totals
    (registered by the broker's gauge provider)."""
    out = {f"event_{c}": f"[{sub}] {help_}"
           for c, (sub, help_) in KNOWN_EVENTS.items()}
    out["events_emitted"] = ("Control-plane events appended to the "
                             "event journal.")
    out["events_dropped"] = ("Control-plane events evicted from the "
                             "bounded journal ring (oldest first).")
    return out


_JOURNAL = EventJournal()


def journal() -> EventJournal:
    return _JOURNAL


def emit(code: str, detail: str = "", value: float = 0.0) -> None:
    """Record one control-plane event. One module-global boolean test
    when observability is off; unregistered codes raise (register in
    KNOWN_EVENTS — the events-registry vmqlint pass checks call sites
    statically too)."""
    if hist.enabled():
        _JOURNAL.emit(code, detail, value)
