"""Store-and-forward spool for the cluster data plane.

The reference forwards ``msg`` frames fire-and-forget: a QoS 1/2 publish
routed to a subscriber on a partitioned or restarting peer is dropped from
the bounded in-memory buffer (``vmq_cluster_node.erl:124-147``) or lost
outright on local crash — metadata heals via anti-entropy, the messages
never do. This module closes that gap: QoS ≥ 1 ``msg``/``enq`` frames to a
spool-capable peer (negotiated via the ``hlo`` exchange, see
``Cluster.member_info``) are journaled here *before* they reach the
writer, tagged with a per-peer monotonic sequence number, shipped as
``msq`` frames, and deleted only when the receiver's cumulative ``ack``
covers them. On channel re-establishment (and on the retransmit timer,
for in-channel loss drills) the spool replays unacked frames in order.
The receiver acks only along CONTIGUOUS sequence runs anchored by the
sender's ``msb`` stream-base frame — an ack across a gap would trim
frames the receiver never saw — suppresses anything at-or-below its
cursor, and keeps a bounded ``(seq, msg_ref)`` dedup window for
above-gap frames, so a sender whose sequence space restarted is never
mistaken for a replay and redelivery is safe for QoS 2.

Storage is the SAME engine layer as ``storage/msg_store.py`` — one
``storage/segment.py`` :func:`~vernemq_tpu_torch.storage.segment.open_engine`
call serves both facades: the native C++ kvstore when the toolchain
built it, the pure-Python segment-log twin otherwise (sealed segments,
checkpointed recovery, broker-driven budgeted compaction), and a memory
engine when ``cluster_spool_dir`` is unset (replay across partitions,
no crash durability). Key families:

- ``s<len16><peer><seq:8>`` → the ready-to-send ``msq`` frame bytes
- ``h<len16><peer>``        → high-water seq (survives full acks, so a
  restarted sender never reuses a sequence number against a peer)

The spool is bounded by ``cluster_spool_max_bytes``; past the cap new
frames are refused (counted) and sent best-effort on the legacy path
when that cannot overtake journaled-but-unsent frames (dropped visibly
otherwise) — durability is shed before delivery, order before either.
``cluster.spool`` is a fault-injection
point (``robustness/faults.py``): an injected error models a journal
write failure, latency a slow disk (capped — the journal write runs on
the event loop like the msg-store write seam).
"""

from __future__ import annotations

import logging
import os
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from ..observability import events
from ..observability.recorder import clock_sync
from ..robustness import faults
from .node import frame

log = logging.getLogger("vernemq_tpu_torch.cluster")


def _peer_key(peer: str) -> bytes:
    b = peer.encode()
    return len(b).to_bytes(2, "big") + b


def _parse_peer(key: bytes) -> Tuple[str, bytes]:
    """``key`` without its family byte → (peer, rest)."""
    n = int.from_bytes(key[:2], "big")
    return key[2:2 + n].decode(), key[2 + n:]


class _NullMetrics:
    def incr(self, name: str, n: int = 1) -> None:
        pass

    def observe(self, name: str, ms: float) -> None:
        pass


class _PeerState:
    """Per-peer spool bookkeeping (all event-loop-thread)."""

    __slots__ = ("next_seq", "pending", "bytes", "blocked", "last_ack_at",
                 "cursor", "last_progress_at", "journaled_at")

    def __init__(self) -> None:
        self.next_seq = 1
        # seq -> frame bytes length, ascending insertion order
        self.pending: "OrderedDict[int, int]" = OrderedDict()
        # seq -> journal time (monotonic) for the ack-RTT histogram;
        # parallels pending (recovered-from-disk seqs have no stamp and
        # are skipped — a restart must not pollute the RTT tail)
        self.journaled_at: Dict[int, float] = {}
        self.bytes = 0
        # True once a frame failed to buffer: subsequent spooled frames
        # journal without sending (per-peer order must not invert) until
        # a replay resyncs the stream
        self.blocked = False
        self.last_ack_at = 0.0
        # budgeted-replay resume point (next seq the watchdog ships);
        # 0 = start a fresh sweep at the lowest pending seq
        self.cursor = 0
        # ack-PROGRESS clock for the connection-level stall detector:
        # reset only when pending transitions empty→nonempty and when a
        # cumulative ack actually trims — NOT by replays (a retransmit
        # bumps last_ack_at, so a half-open peer that absorbs writes
        # but never acks would look alive forever on that clock)
        self.last_progress_at = 0.0


class ClusterSpool:
    """Durable per-peer journal of QoS ≥ 1 cluster data-plane frames."""

    def __init__(self, directory: str = "",
                 max_bytes: int = 128 * 1024 * 1024,
                 metrics=None):
        self.directory = directory
        self.max_bytes = max_bytes
        self.metrics = metrics if metrics is not None else _NullMetrics()
        self._peers: Dict[str, _PeerState] = {}
        self._bytes = 0
        self._kv = self._open_journal(directory)
        self._load()

    @staticmethod
    def _open_journal(directory: str):
        # the unified storage engine (storage/segment.py): native C++
        # kvstore when built, the segment-log twin otherwise, memory
        # when no directory — the SAME engine classes the offline
        # message store mounts, so spool and msg store share recovery
        # and compaction discipline
        from ..storage.segment import SegmentLogEngine, open_engine

        if directory:
            # a pre-unification _FileJournal spool.log may still hold
            # unacked QoS>=1 frames — its record framing IS the segment
            # record framing, so it becomes segment #1 of a segment
            # engine verbatim (orphaning it would silently lose the
            # frames owed to a partitioned peer)
            legacy = os.path.join(directory, "spool.log")
            seg_dir = os.path.join(directory, "spool.seg")
            if os.path.exists(legacy) and not os.path.isdir(seg_dir):
                os.makedirs(seg_dir, exist_ok=True)
                os.replace(legacy,
                           os.path.join(seg_dir, "seg-00000001.log"))
                log.warning("cluster spool: migrated legacy spool.log "
                            "into the segment engine at %s", seg_dir)
            if os.path.isdir(seg_dir):
                # data continuity beats engine preference: once the
                # journal lives in the segment layout, keep serving it
                # there even where the native kvstore is built
                return SegmentLogEngine(seg_dir)
        return open_engine(directory, filename="spool")

    @property
    def engine(self):
        """The journal engine (broker maintenance/introspection)."""
        return self._kv

    @property
    def engine_kind(self) -> str:
        """Which engine serves the journal — ``native`` / ``segment`` /
        ``memory`` (recorded in the bench partition-storm artifact so
        replay numbers are comparable across boxes)."""
        return getattr(self._kv, "kind", "unknown")

    def _load(self) -> None:
        for key, val in self._kv.scan(b"s"):
            peer, rest = _parse_peer(key[1:])
            seq = int.from_bytes(rest[:8], "big")
            st = self._state(peer)
            st.pending[seq] = len(val)
            st.bytes += len(val)
            self._bytes += len(val)
            if seq >= st.next_seq:
                st.next_seq = seq + 1
        for key, val in self._kv.scan(b"h"):
            peer, _ = _parse_peer(key[1:])
            st = self._state(peer)
            high = int.from_bytes(val, "big")
            if high >= st.next_seq:
                st.next_seq = high + 1
        if self._bytes:
            log.info("cluster spool recovered %d unacked frame(s) "
                     "(%d bytes) for %d peer(s)",
                     sum(len(s.pending) for s in self._peers.values()),
                     self._bytes, sum(1 for s in self._peers.values()
                                      if s.pending))

    def _state(self, peer: str) -> _PeerState:
        st = self._peers.get(peer)
        if st is None:
            st = self._peers[peer] = _PeerState()
        return st

    state = _state  # public accessor (cluster send path, tests)

    def peers(self) -> List[str]:
        return list(self._peers)

    # ------------------------------------------------------------- journal

    def journal(self, peer: str, kind: str, term) -> Optional[Tuple[int, bytes]]:
        """Assign the next seq for ``peer`` and durably journal the ready
        ``msq`` frame. Returns ``(seq, frame_bytes)``, or None when the
        byte cap refuses the frame or the journal write fails (injected
        or real) — the caller then sends best-effort on the legacy path.
        """
        st = self._state(peer)
        t0 = time.monotonic()
        try:
            # event-loop-side seam like broker.store_offline: injected
            # latency models a slow spool disk, capped so a hang drill
            # stalls rather than freezes the loop
            faults.inject("cluster.spool", max_delay_s=1.0)
            seq = st.next_seq
            data = frame(b"msq", (seq, kind, term))
            if self._bytes + len(data) > self.max_bytes:
                self.metrics.incr("cluster_spool_overflow")
                return None
            pk = _peer_key(peer)
            self._kv.put_many([
                (b"s" + pk + seq.to_bytes(8, "big"), data),
                (b"h" + pk, seq.to_bytes(8, "big")),
            ])
        except Exception:
            self.metrics.incr("cluster_spool_errors")
            log.exception("spool journal write for %s failed "
                          "(frame sent best-effort, durability lost)", peer)
            return None
        done = time.monotonic()
        self.metrics.observe("stage_spool_journal_ms", (done - t0) * 1e3)
        st.next_seq = seq + 1
        if not st.pending:
            st.last_ack_at = done
            st.last_progress_at = st.last_ack_at
        st.journaled_at[seq] = done
        st.pending[seq] = len(data)
        st.bytes += len(data)
        self._bytes += len(data)
        self.metrics.incr("cluster_spool_journaled")
        return seq, data

    def ack(self, peer: str, seq: int) -> int:
        """Cumulative ack from ``peer``: delete journaled frames ≤ seq."""
        st = self._peers.get(peer)
        if st is None:
            return 0
        pk = _peer_key(peer)
        now = time.monotonic()
        n = 0
        for s in list(st.pending):
            if s > seq:
                break  # pending is seq-ascending
            size = st.pending.pop(s)
            st.bytes -= size
            self._bytes -= size
            self._kv.delete(b"s" + pk + s.to_bytes(8, "big"))
            t_j = st.journaled_at.pop(s, None)
            if t_j is not None:
                # journal->cumulative-ack round trip per frame: the
                # measured base for cluster_stall_timeout_s tuning AND
                # the per-peer clock-offset estimate merged cross-node
                # traces ride on (observability/recorder.ClockSync)
                rtt_ms = (now - t_j) * 1e3
                self.metrics.observe("stage_cluster_ack_rtt_ms", rtt_ms)
                clock_sync().observe_rtt(peer, rtt_ms)
            n += 1
        if n:
            st.last_ack_at = time.monotonic()
            st.last_progress_at = st.last_ack_at
            if not st.pending:
                st.blocked = False
        return n

    def replay(self, peer: str, send: Callable[[bytes], bool],
               budget: Optional[int] = None) -> int:
        """Resend unacked frames for ``peer`` in seq order (channel
        re-establishment / retransmit timer / buffer-drain resync),
        preceded by an ``msb`` stream-base frame: pending is always a
        contiguous run [low..high] (acks are cumulative), and the base
        tells the receiver everything below ``low`` is acked so it can
        anchor its contiguity cursor there — without it, a receiver that
        missed the first batch could ack past frames it never saw.
        Frames the receiver did get are absorbed by its dedup state.
        ``send`` returning False (writer buffer full) pauses the stream
        blocked — a later replay picks it up.

        Without ``budget`` the whole backlog ships (the channel-up
        resync — a reconnected peer needs everything). With ``budget``
        (the retransmit watchdog, ``cluster_spool_replay_burst``) at
        most that many frames ship per call, resuming at the per-peer
        cursor where the previous call stopped: a long partition at
        high publish rates pays linear wire cost across ticks instead
        of re-shipping the whole journal every ``retransmit_ms``. An
        ack advancing past the cursor restarts the sweep at the new
        lowest pending seq (the head is what the receiver is missing —
        its ack IS the cursor acknowledgement)."""
        st = self._peers.get(peer)
        if st is None or not st.pending:
            return 0
        low = next(iter(st.pending))
        start = low
        if budget is not None and budget > 0:
            if low < st.cursor <= next(reversed(st.pending)):
                start = st.cursor
        else:
            budget = None  # 0/None = unbudgeted full sweep
        if not send(frame(b"msb", low)):
            st.blocked = True
            return 0
        events.emit("spool_replay_start", detail=peer,
                    value=float(len(st.pending)))
        # pending is a CONTIGUOUS seq run [low..high] (acks are
        # cumulative), so the sweep walks seqs directly and point-reads
        # the journal — O(frames shipped) per call, never a full
        # journal scan+sort per watchdog tick (the host-side half of
        # the quadratic-storm cost the budget bounds on the wire)
        pk = _peer_key(peer)
        high = next(reversed(st.pending))
        sent = 0
        exhausted = False
        completed = True
        for seq in range(start, high + 1):
            if budget is not None and sent >= budget:
                st.cursor = seq  # resume here next tick
                exhausted = True
                completed = False
                break
            data = self._kv.get(b"s" + pk + seq.to_bytes(8, "big"))
            if data is None:
                continue  # defensive: acked/flushed under our feet
            if not send(data):
                st.blocked = True
                completed = False
                break
            sent += 1
        if completed:
            st.blocked = False
        if not exhausted:
            st.cursor = 0  # sweep finished (or pausing): restart at low
        if sent:
            st.last_ack_at = time.monotonic()
            self.metrics.incr("cluster_spool_replayed", sent)
        events.emit("spool_replay_end", detail=peer, value=float(sent))
        return sent

    def flush(self, peer: Optional[str] = None) -> Tuple[int, int]:
        """Operator escape hatch (`vmq-admin cluster spool flush`): drop
        journaled frames — for one peer or all — and return (frames,
        bytes) discarded. High-water marks are kept so sequence numbers
        never regress."""
        peers = [peer] if peer is not None else list(self._peers)
        frames = nbytes = 0
        for p in peers:
            st = self._peers.get(p)
            if st is None:
                continue
            pk = _peer_key(p)
            for s, size in list(st.pending.items()):
                self._kv.delete(b"s" + pk + s.to_bytes(8, "big"))
                frames += 1
                nbytes += size
            self._bytes -= st.bytes
            st.pending.clear()
            st.journaled_at.clear()
            st.bytes = 0
            st.blocked = False
            st.cursor = 0
        return frames, nbytes

    # ------------------------------------------------------- introspection

    def stats(self) -> Dict[str, float]:
        """Gauge snapshot for the $SYS tree / Prometheus."""
        return {
            "cluster_spool_depth_frames": float(
                sum(len(s.pending) for s in self._peers.values())),
            "cluster_spool_depth_bytes": float(self._bytes),
            "cluster_spool_outstanding_acks": float(
                sum(1 for s in self._peers.values() if s.pending)),
            "cluster_spool_peers_blocked": float(
                sum(1 for s in self._peers.values() if s.blocked)),
        }

    def peer_stats(self) -> List[Dict[str, object]]:
        out = []
        for peer, st in sorted(self._peers.items()):
            out.append({
                "peer": peer,
                "pending_frames": len(st.pending),
                "pending_bytes": st.bytes,
                "next_seq": st.next_seq,
                "lowest_unacked": next(iter(st.pending), None),
                "replay_cursor": st.cursor or None,
                "blocked": st.blocked,
            })
        return out

    def sync(self) -> None:
        self._kv.sync()

    def close(self) -> None:
        self._kv.close()
