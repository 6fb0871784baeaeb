"""Per-subscriber queue: the broker-side mailbox between the registry fanout
and the client session(s).

Mirrors the reference queue gen_fsm (``apps/vmq_server/src/vmq_queue.erl``):
states ``online`` (≥1 attached session) / ``offline`` (persistent session,
no attachment) / ``drain`` (migration, later rounds); per-session delivery
with ``fanout``/``balance`` modes for multiple sessions per ClientId
(``vmq_queue.erl:826-835``); an offline queue capped by
``max_offline_messages`` with FIFO tail-drop or LIFO oldest-drop
(``vmq_queue.erl:845-865``); QoS0 dropped when offline; session-expiry
timer (``vmq_queue.erl:913-930``); lifecycle hooks ``on_client_wakeup`` /
``on_client_offline`` / ``on_client_gone`` / ``on_offline_message`` /
``on_message_drop`` (``vmq_queue.erl:614,658-700,1059-1070``).

The reference's active/passive/notify backpressure protocol between queue
and session process (``vmq_queue.erl:752-774``, ``vmq_mqtt_fsm.erl:264-293``)
collapses here to a two-level window: the session holds an inflight window
plus a ``pending`` list; when every attached session refuses a message the
queue keeps it in its own ``backlog`` (the passive-state queue) and the
session pulls it back via :meth:`SubscriberQueue.notify_ready` once acks
free its window (the notify→active transition). Only past
``max_online_messages`` of queue-level backlog do messages drop, with
accounting — matching the reference's online-queue cap.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import TYPE_CHECKING, Callable, Deque, Dict, List, Optional

from .message import Msg, SubscriberId

if TYPE_CHECKING:
    from .broker import Broker

ONLINE = "online"
OFFLINE = "offline"
DRAIN = "drain"
TERMINATED = "terminated"


class QueueOpts:
    __slots__ = (
        "clean_session",
        "max_offline_messages",
        "max_online_messages",
        "deliver_mode",
        "queue_type",
        "session_expiry",
        "is_plugin",
    )

    def __init__(
        self,
        clean_session: bool = True,
        max_offline_messages: int = 1000,
        max_online_messages: int = 1000,
        deliver_mode: str = "fanout",
        queue_type: str = "fifo",
        session_expiry: int = 0,  # seconds; 0 = persistent_client_expiration config
        is_plugin: bool = False,
    ):
        self.clean_session = clean_session
        self.max_offline_messages = max_offline_messages
        self.max_online_messages = max_online_messages
        self.deliver_mode = deliver_mode
        self.queue_type = queue_type
        self.session_expiry = session_expiry
        self.is_plugin = is_plugin


class SubscriberQueue:
    """One queue per SubscriberId (the reference partitions these across
    phash2 supervisors, vmq_queue_sup_sup.erl:65-92; a Python dict gives the
    same O(1) lookup without the supervision tree)."""

    def __init__(self, broker: "Broker", subscriber_id: SubscriberId, opts: QueueOpts):
        self.broker = broker
        self.subscriber_id = subscriber_id
        self.opts = opts
        self.state = OFFLINE
        # session_handle -> deliver callback; a handle is the Session object
        self.sessions: Dict[object, Callable[[Msg], bool]] = {}
        self._rr: int = 0  # round-robin cursor for balance mode
        self.offline: Deque[Msg] = deque()
        # online backpressure backlog: messages every session refused
        # (windows full) parked until notify_ready — the passive-state
        # per-session queue of the reference (vmq_queue.erl:752-774)
        self.backlog: Deque[Msg] = deque()
        # batched-resume window (storage/resume.py): while the stored
        # offline backlog is in flight through the ResumeCollector, live
        # publishes park here — delivering them first would reorder
        # same-topic delivery against the older stored messages
        # (MQTT-4.6.0)
        self._resuming = False
        self._resume_buf: Deque[Msg] = deque()
        # lazy boot recovery: True when this queue's stored backlog was
        # NOT loaded at queue (re)creation — a million parked sessions
        # boot without a million read_alls; the backlog loads on first
        # attach (through the ResumeCollector) or at drain time
        self.offline_in_store = False
        self._expiry_task: Optional[asyncio.Task] = None
        self.created = time.time()

    # -- lifecycle ---------------------------------------------------------

    def add_session(self, session: object, deliver: Callable[[Msg], bool]) -> None:
        """Attach a session; offline→online wakes the queue and flushes the
        offline backlog through the new session (vmq_queue.erl:458-460 +
        init_offline_queue)."""
        was_offline = self.state == OFFLINE
        self.sessions[session] = deliver
        self.state = ONLINE
        self._cancel_expiry()
        if was_offline:
            self.broker.hooks_fire_all("on_client_wakeup", self.subscriber_id)
            if self.offline_in_store and not self._resuming:
                # lazily-booted queue: the stored backlog loads NOW —
                # batched through the ResumeCollector when available
                # (begin_resume parks live publishes), synchronously
                # into the offline deque otherwise (flushed below)
                self.offline_in_store = False
                self.broker.recover_offline(self.subscriber_id, self,
                                            may_defer=True)
            if self._resuming:
                # a batched resume is still in flight for this queue: the
                # offline deque holds only messages NEWER than the stored
                # backlog being read — finish_resume delivers stored +
                # deque + parked in order and clears storage ONCE.
                # Flushing (and delete_offline-ing) here would race the
                # executor read and could delete stored messages that
                # were never delivered.
                return
            backlog, self.offline = self.offline, deque()
            if backlog:
                # handed to the session's inflight tracking; clear storage
                # (per-ref deletes on ack come with the native store)
                self.broker.delete_offline(self.subscriber_id)
            for msg in backlog:
                if msg.expires_at is not None and msg.expires_at < time.monotonic():
                    self.broker.metrics.incr("queue_message_expired")
                    continue
                self._deliver_online(msg)

    def del_session(self, session: object) -> None:
        """Detach; last session out moves the queue offline (persistent) or
        tears it down (clean session), vmq_queue wait_for_offline."""
        self.sessions.pop(session, None)
        if self.sessions:
            return
        if self.opts.clean_session:
            self.terminate("normal")
        else:
            self.state = OFFLINE
            # park the backpressure backlog offline (insert_from_session,
            # vmq_queue.erl:867-881: undelivered messages survive the session)
            backlog, self.backlog = self.backlog, deque()
            for msg in backlog:
                self._enqueue_offline(msg)
            # publishes parked behind an in-flight resume go offline
            # too; finish_resume later puts the (older) stored backlog
            # at the FRONT, preserving arrival order
            buf, self._resume_buf = self._resume_buf, deque()
            for msg in buf:
                self._enqueue_offline(msg)
            self.broker.hooks_fire_all("on_client_offline", self.subscriber_id)
            self._arm_expiry()

    def start_drain(self) -> List[Msg]:
        """Enter the drain state and hand the offline backlog to the
        migration (vmq_queue drain state, vmq_queue.erl:338-400).
        Enqueues arriving mid-drain are queued (drain({enqueue,..})
        inserts, vmq_queue.erl:383-390) and picked up by
        :meth:`drain_pending` — never dropped."""
        prev_state = self.state
        self.state = DRAIN
        self._cancel_expiry()
        if self._resuming:
            # supersede an in-flight batched resume: the drain needs
            # the stored backlog NOW — read it synchronously; the
            # late-landing collector read becomes a no-op (finish_resume
            # guards on _resuming) so nothing is dropped or doubled.
            # Stored messages merge to the FRONT of the offline deque,
            # the parked live publishes (newest) go AFTER them — the
            # drained list keeps per-subscriber order (MQTT-4.6.0)
            self._resuming = False
            buf, self._resume_buf = self._resume_buf, deque()
            try:
                self.broker.recover_offline(self.subscriber_id, self)
            except Exception:
                self._drain_read_failed(prev_state, buf)
                raise
            self.offline.extend(buf)
        if self.offline_in_store:
            # a lazily-booted queue drains its STORED backlog too: load
            # it synchronously (migration correctness beats boot speed)
            self.offline_in_store = False
            try:
                self.broker.recover_offline(self.subscriber_id, self)
            except Exception:
                self._drain_read_failed(prev_state)
                raise
        backlog = list(self.backlog)
        self.backlog.clear()
        backlog += list(self._resume_buf)
        self._resume_buf.clear()
        backlog += list(self.offline)
        self.offline.clear()
        return [m for m in backlog
                if m.expires_at is None or m.expires_at >= time.monotonic()]

    def _drain_read_failed(self, prev_state: str,
                           parked: Optional[Deque[Msg]] = None) -> None:
        """A drain could not load the stored backlog: leave the queue
        exactly as it was — state restored, parked live publishes back
        in the offline deque, the stored backlog STILL marked in-store
        (nothing read, so nothing may be deleted) — and let the raised
        error fail the migration, which retries or retargets. Zero
        loss: the store keeps every message the read could not serve."""
        if parked:
            self.offline.extend(parked)
        self.offline_in_store = True
        self.broker.metrics.incr("msg_store_read_errors")
        self.state = prev_state
        if prev_state == OFFLINE:
            self._arm_expiry()

    def restore_online(self, msgs: List[Msg]) -> None:
        """Cancel a drain whose session is STILL ATTACHED (the MQTT5
        redirect path keeps the connection up through the drain): the
        handoff rolled back before the client was told anything, so
        re-enter ONLINE and redeliver ``msgs`` — the restored backlog,
        including chunks the target may have acked — locally. Chunks
        the target kept surface as QoS1 dupes if a later handoff
        succeeds; dupes beat loss."""
        self.state = ONLINE
        self._resuming = False
        buf, self._resume_buf = self._resume_buf, deque()
        for msg in msgs:
            self._deliver_online(msg)
        for msg in buf:
            self._deliver_online(msg)

    def drain_pending(self) -> List[Msg]:
        """Messages that raced into the queue after start_drain — the
        migration keeps draining until this runs dry (the reference
        re-fires drain_start on every mid-drain enqueue)."""
        more = [m for m in self.offline
                if m.expires_at is None or m.expires_at >= time.monotonic()]
        self.offline.clear()
        return more

    def terminate(self, reason: str) -> None:
        if self.state == TERMINATED:
            return
        self.state = TERMINATED
        self._cancel_expiry()
        for msg in self.offline:
            self._drop(msg)
        self.offline.clear()
        for msg in self.backlog:
            self._drop(msg)
        self.backlog.clear()
        for msg in self._resume_buf:
            self._drop(msg)
        self._resume_buf.clear()
        self._resuming = False
        self.broker.registry.queue_terminated(self.subscriber_id)
        self.broker.hooks_fire_all("on_client_gone", self.subscriber_id)
        self.broker.metrics.incr("queue_teardown")

    def _arm_expiry(self) -> None:
        """Persistent-session expiry (persistent_client_expiration config or
        MQTT5 session_expiry_interval), vmq_queue.erl:913-930."""
        expiry = self.opts.session_expiry or self.broker.config.persistent_client_expiration
        if expiry <= 0:
            return
        loop = asyncio.get_event_loop()

        async def _expire():
            await asyncio.sleep(expiry)
            while self.state == OFFLINE:
                try:
                    # serialized: expiry racing a re-register on another
                    # node must not delete the record it just claimed
                    await self.broker.registry.cleanup_subscriber_synced(
                        self.subscriber_id)
                    self.broker.metrics.incr("client_expired")
                    return
                except RuntimeError:
                    # coordinator unreachable (netsplit): retry — an
                    # expired client must eventually be cleaned, not leak
                    await asyncio.sleep(5.0)

        self._expiry_task = loop.create_task(_expire())

    def _cancel_expiry(self) -> None:
        if self._expiry_task is not None:
            self._expiry_task.cancel()
            self._expiry_task = None

    # -- enqueue path ------------------------------------------------------

    def enqueue(self, msg: Msg) -> None:
        """Hot-path entry from the registry fanout (vmq_queue:enqueue/2)."""
        self.broker.metrics.incr("queue_message_in")
        if self.state == ONLINE:
            if self._resuming:
                # the stored offline backlog is still in flight through
                # the batched resume: park live publishes until it has
                # been delivered (finish_resume drains this buffer) —
                # delivering now would reorder against older messages
                self._resume_buf.append(msg)
                return
            self._deliver_online(msg)
        elif self.state == OFFLINE:
            self._enqueue_offline(msg)
        elif self.state == DRAIN:
            # mid-drain arrival: queue it so the drain forwards it to the
            # new node (vmq_queue.erl:383-390) — dropping here was the
            # migration message-loss window. Goes through the normal
            # offline path: caps apply and the message is persisted in
            # case the broker dies mid-migration.
            self._enqueue_offline(msg)
        else:  # terminated: drop with accounting
            self._drop(msg)

    def _deliver_online(self, msg: Msg) -> None:
        if not self.sessions:
            self._enqueue_offline(msg)
            return
        if not self._try_sessions(msg):
            self._backpressure(msg)

    def _try_sessions(self, msg: Msg) -> bool:
        """Offer to the attached session(s); True iff someone took it."""
        if self.opts.deliver_mode == "balance" and len(self.sessions) > 1:
            # balance: one session per message, round-robin (the reference
            # picks randomly, vmq_queue.erl:826-835 — RR gives fairer tests)
            handlers = list(self.sessions.values())
            self._rr = (self._rr + 1) % len(handlers)
            ok = handlers[self._rr](msg)
            if ok:
                self.broker.metrics.incr("queue_message_out")
            return ok
        delivered = False
        for deliver in list(self.sessions.values()):
            if deliver(msg):
                delivered = True
                self.broker.metrics.incr("queue_message_out")
        return delivered

    def _backpressure(self, msg: Msg) -> None:
        """Every session refused (inflight + pending windows full): park in
        the queue-level backlog instead of dropping; cap + drop policy as
        the reference's online-queue cap (vmq_queue.erl:845-865)."""
        cap = self.opts.max_online_messages
        if cap > 0 and len(self.backlog) >= cap:
            if self.opts.queue_type == "fifo":
                self._drop(msg)  # tail-drop the new message
                return
            self._drop(self.backlog.popleft())  # lifo: oldest makes room
        self.backlog.append(msg)

    def notify_ready(self, session: object) -> None:
        """A session's window freed up (the notify→active transition,
        vmq_mqtt_fsm.erl:264-293): replay the parked backlog in arrival
        order until it refuses again. Peek-then-pop: a refused head must
        stay at the FRONT or same-subscriber delivery reorders
        (MQTT-4.6.0)."""
        if not self.backlog or self._resuming:
            return
        t0 = time.monotonic()
        while self.backlog and self.state == ONLINE and self.sessions:
            if not self._try_sessions(self.backlog[0]):
                break
            self.backlog.popleft()
        self.broker.metrics.observe(
            "stage_queue_flush_ms", (time.monotonic() - t0) * 1e3)

    # -- batched resume (storage/resume.py) --------------------------------

    def begin_resume(self) -> None:
        """The stored offline backlog is being read through the
        ResumeCollector: hold live delivery order until it lands."""
        self._resuming = True

    def merge_recovered(self, msgs: List[Msg]) -> None:
        """Merge a store-read backlog with whatever already sits in the
        offline deque: stored messages FIRST (they are the oldest),
        then deque entries that are NOT copies of a stored one. On the
        lazy-boot path the deque is a suffix of the store content (a
        publish arriving while parked lands in both), so a plain extend
        would deliver those twice; the multiset dedup keeps only the
        deque's store-write-failed stragglers (kept in memory only)."""
        if not msgs:
            return
        have: Dict[bytes, int] = {}
        for m in msgs:
            have[m.msg_ref] = have.get(m.msg_ref, 0) + 1
        keep = []
        for m in self.offline:
            if have.get(m.msg_ref, 0) > 0:
                have[m.msg_ref] -= 1
            else:
                keep.append(m)
        self.offline = deque(list(msgs) + keep)

    def finish_resume(self, msgs: List[Msg]) -> None:
        """The collector resolved this queue's stored backlog. Deliver
        it FIRST (it is older than anything parked), then drain the
        parked live publishes — same per-queue order a synchronous
        ``recover_offline`` + ``add_session`` flush would have
        produced."""
        if not self._resuming:
            return
        self._resuming = False
        buf, self._resume_buf = self._resume_buf, deque()
        if self.state == ONLINE and self.sessions:
            # delivery order: stored backlog (oldest) → offline-deque
            # stragglers (a detach window mid-resume, deduped against
            # the store read) → parked live publishes (newest) — the
            # same per-queue order the synchronous recover + flush
            # produced
            self.merge_recovered(msgs)
            parked, self.offline = self.offline, deque()
            if msgs:
                self.broker.metrics.incr("queue_initialized_from_storage")
            if parked:
                # handed to the session's inflight tracking; clear
                # storage exactly like the add_session offline flush
                self.broker.delete_offline(self.subscriber_id)
            for msg in parked:
                if (msg.expires_at is not None
                        and msg.expires_at < time.monotonic()):
                    self.broker.metrics.incr("queue_message_expired")
                    continue
                self._deliver_online(msg)
            for msg in buf:
                self._deliver_online(msg)
        elif self.state in (OFFLINE, DRAIN):
            # the session left (or a drain started) before the read
            # landed: stored messages merge to the FRONT of the offline
            # deque (deduped — anything the deque already holds from a
            # mid-resume detach is the same stored message); they stay
            # in the store, matching the sync recover path's
            # post-recover state. Parked live publishes were already
            # moved by del_session/start_drain; stragglers take the
            # offline path.
            self.merge_recovered(msgs)
            for msg in buf:
                self._enqueue_offline(msg)
        else:  # terminated while resuming: drop with accounting
            for msg in list(msgs) + list(buf):
                self._drop(msg)

    def _enqueue_offline(self, msg: Msg) -> None:
        if self.opts.clean_session:
            self._drop(msg)
            return
        if msg.qos == 0:
            # QoS0 is not stored for offline sessions (vmq_queue offline drop)
            self._drop(msg)
            return
        cap = self.opts.max_offline_messages
        if cap > 0 and len(self.offline) >= cap:
            if self.opts.queue_type == "fifo":
                self._drop(msg)  # tail-drop the new message
                return
            # lifo: drop the oldest to make room (vmq_queue.erl:845-865)
            self._drop(self.offline.popleft())
        self.offline.append(msg)
        self.broker.hooks_fire_all("on_offline_message", self.subscriber_id, msg)
        self.broker.store_offline(self.subscriber_id, msg)

    def _drop(self, msg: Msg) -> None:
        self.broker.metrics.incr("queue_message_drop")
        self.broker.hooks_fire_all("on_message_drop", self.subscriber_id, msg, "queue_drop")

    # -- introspection -----------------------------------------------------

    def info(self) -> Dict[str, object]:
        return {
            "subscriber_id": self.subscriber_id,
            "state": self.state,
            "sessions": len(self.sessions),
            "offline_messages": len(self.offline),
            "backlog_messages": len(self.backlog),
            "resuming": self._resuming,
            "clean_session": self.opts.clean_session,
            "deliver_mode": self.opts.deliver_mode,
            "started": self.created,
        }
