"""Offline message store.

Mirrors the reference message-store seam: the store is itself a plugin
(``msg_store_write/read/delete/find`` hooks, used from the queue at
``vmq_queue.erl:420,797,946,970``), with the LevelDB implementation
(``vmq_lvldb_store.erl``) keeping three key families — message payload by
ref, per-subscriber ref entries, and a per-subscriber index for recovery
scans (``vmq_lvldb_store.erl:339-416``) — plus payload refcounting across
subscribers.

The durable stores now share ONE engine layer (``storage/segment.py``,
also backing the cluster spool): :class:`EngineMsgStore` implements the
3-key-family layout over any engine, :class:`NativeMsgStore` mounts it
on the C++ kvstore, :class:`SegmentMsgStore` on the pure-Python
segment-log twin (sealed segments, checkpointed recovery, budgeted
compaction driven by the broker off the event loop). The legacy
:class:`FileMsgStore` flat JSON log is kept for on-disk compatibility
(an existing ``msgstore.log`` is honoured at boot) but new ``file``
stores open the segment engine.

When ``msg_store_fsync`` is on, stores **group-commit**: a write burst
marks the store dirty and the broker issues ONE fsync at the flush-tick
boundary (``commit()``), counting the coalesced syncs — per-record
fsync made every offline enqueue a disk round trip on the event loop.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..broker.message import Msg, SubscriberId

log = logging.getLogger("vernemq_tpu_torch.storage")


class MsgStore:
    """Interface (msg_store_* plugin hooks)."""

    #: True when read_many may run on an executor thread concurrently
    #: with loop-side writes (the store locks internally) — the gate
    #: the batched ResumeCollector checks before going off-loop
    supports_batched_read = False

    def write(self, sid: SubscriberId, msg: Msg) -> None:
        raise NotImplementedError

    def read_all(self, sid: SubscriberId) -> List[Msg]:
        raise NotImplementedError

    def read_many(self, sids: List[SubscriberId]
                  ) -> Dict[SubscriberId, List[Msg]]:
        """Batched recovery read for a reconnect storm: one call
        resolves every subscriber's offline backlog (the reference's
        msg_store_find per queue, amortized)."""
        return {sid: self.read_all(sid) for sid in sids}

    def delete(self, sid: SubscriberId, msg_ref: bytes) -> None:
        raise NotImplementedError

    def delete_all(self, sid: SubscriberId) -> None:
        raise NotImplementedError

    def needs_commit(self) -> bool:
        """True when fsync work is parked for the group commit."""
        return False

    def commit(self) -> int:
        """Flush the parked fsync (one sync per write burst); returns
        the number of COALESCED syncs (writes beyond the first since
        the last commit — what per-record fsync would have cost
        extra)."""
        return 0

    def close(self) -> None:
        pass


class MemoryMsgStore(MsgStore):
    def __init__(self) -> None:
        # payload table: ref -> (msg, refcount)  (dedup across subscribers,
        # vmq_lvldb_store.erl:347,455-472)
        self._msgs: Dict[bytes, Tuple[Msg, int]] = {}
        # index: sid -> [ref] in arrival order (the sext-ordered idx family)
        self._idx: Dict[SubscriberId, List[bytes]] = {}

    def write(self, sid: SubscriberId, msg: Msg) -> None:
        entry = self._msgs.get(msg.msg_ref)
        if entry is None:
            self._msgs[msg.msg_ref] = (msg, 1)
        else:
            self._msgs[msg.msg_ref] = (entry[0], entry[1] + 1)
        self._idx.setdefault(sid, []).append(msg.msg_ref)

    def read_all(self, sid: SubscriberId) -> List[Msg]:
        return [self._msgs[r][0] for r in self._idx.get(sid, []) if r in self._msgs]

    def delete(self, sid: SubscriberId, msg_ref: bytes) -> None:
        idx = self._idx.get(sid)
        if idx and msg_ref in idx:
            idx.remove(msg_ref)
            self._deref(msg_ref)

    def delete_all(self, sid: SubscriberId) -> None:
        for ref in self._idx.pop(sid, []):
            self._deref(ref)

    def _deref(self, ref: bytes) -> None:
        entry = self._msgs.get(ref)
        if entry is None:
            return
        if entry[1] <= 1:
            del self._msgs[ref]
        else:
            self._msgs[ref] = (entry[0], entry[1] - 1)

    def stats(self) -> Dict[str, int]:
        return {"stored_messages": len(self._msgs),
                "stored_refs": sum(len(v) for v in self._idx.values())}


class SeqCounter:
    """Monotonic enqueue-order counter, shareable across store instances so
    a bucketed store's per-subscriber recovery merge preserves global
    arrival order."""

    __slots__ = ("_next", "_lock")

    def __init__(self) -> None:
        self._next = 1
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            n = self._next
            self._next += 1
            return n

    def bump(self, seen: int) -> None:
        with self._lock:
            if seen >= self._next:
                self._next = seen + 1


class EngineMsgStore(MsgStore):
    """The reference's 3-key-family layout (``vmq_lvldb_store.erl:
    339-416``) over any ``storage/segment.py`` engine:

    - ``m\\x00<ref>``                       → encoded message (payload family)
    - ``r\\x00<sid><ref>``                  → b"" (per-subscriber ref entry)
    - ``i\\x00<sid><seq:8>``                → ref (ordered recovery index)

    Payloads are deduplicated across subscribers via an in-memory refcount
    rebuilt from the ``i`` family on open; unreferenced payloads are
    garbage-collected by a startup scan (``vmq_lvldb_store.erl:418-453``).

    Thread-safety: one lock per store instance around the host-side maps
    (the engines serialize their own file/C-side ops) — the analog of the
    reference's one gen_server per bucket serializing that bucket's ops.
    Reads (``read_all_seq``/``read_many``) may therefore run on executor
    threads concurrently with loop-side writes.
    """

    supports_batched_read = True

    def __init__(self, engine, seq: Optional[SeqCounter] = None,
                 fsync: bool = False, group_commit: bool = True):
        import time as _time

        from ..cluster.codec import decode, encode
        from ..cluster.node import msg_to_term, term_to_msg

        # wrap the wire term with the wall-clock store time: the codec's
        # "remaining seconds" expiry is rebased at decode, so time spent in
        # the store counts against MQTT5 message_expiry_interval
        def _enc(m):
            return encode([msg_to_term(m), _time.time()])

        def _dec(b):
            term, stored_at = decode(b)
            if term.get("exp") is not None:
                elapsed = max(0.0, _time.time() - stored_at)
                term["exp"] = max(0.0, term["exp"] - elapsed)
            return term_to_msg(term)

        def _peek_deadline(b):
            # wall-clock expiry deadline WITHOUT building a Msg: the
            # TTL sweep classifies recovered records with this
            term, stored_at = decode(b)
            exp = term.get("exp")
            return None if exp is None else stored_at + exp

        self._enc = _enc
        self._dec = _dec
        self._peek_deadline = _peek_deadline
        self.engine = engine
        self._kv = engine
        # refcount + sid→ref→[seq] maps, rebuilt from the r/i families
        self._refcount: Dict[bytes, int] = {}
        self._seqs: Dict[SubscriberId, Dict[bytes, List[int]]] = {}
        self._seq = seq or SeqCounter()
        self._fsync = fsync
        self._group_commit = group_commit
        self._sync_pending = 0
        self._lock = threading.Lock()
        # TTL sweep state: ref -> wall-clock expiry deadline (only
        # expiring messages carry an entry); refs recovered from disk
        # have no in-memory deadline yet and queue for budgeted
        # classification on the maintenance tick
        self._exp: Dict[bytes, float] = {}
        self._exp_scan: List[bytes] = []
        self._recover()
        self._exp_scan = list(self._refcount)

    @property
    def engine_kind(self) -> str:
        return getattr(self.engine, "kind", "native")

    @staticmethod
    def _sid_key(sid: SubscriberId) -> bytes:
        mp = sid[0].encode()
        cid = sid[1].encode()
        return (len(mp).to_bytes(2, "big") + mp
                + len(cid).to_bytes(2, "big") + cid)

    @staticmethod
    def _parse_sid(b: bytes) -> Tuple[SubscriberId, bytes]:
        n = int.from_bytes(b[:2], "big")
        mp = b[2:2 + n].decode()
        rest = b[2 + n:]
        n2 = int.from_bytes(rest[:2], "big")
        cid = rest[2:2 + n2].decode()
        return (mp, cid), rest[2 + n2:]

    def _recover(self) -> None:
        # refcounts must be rebuilt one-per-enqueue (per i-entry), matching
        # the runtime write path — counting r-keys (one per sid+ref) would
        # undercount a message enqueued twice to the same subscriber and a
        # later delete would free the payload while a copy is still owed
        live_refs: Dict[bytes, int] = {}
        for key, ref in self._kv.scan(b"i\x00"):
            sid, seq_b = self._parse_sid(key[2:])
            seq = int.from_bytes(seq_b, "big")
            self._seqs.setdefault(sid, {}).setdefault(ref, []).append(seq)
            self._seq.bump(seq)
            live_refs[ref] = live_refs.get(ref, 0) + 1
        self._refcount = live_refs
        for key in self._kv.scan_keys(b"r\x00"):
            _, ref = self._parse_sid(key[2:])
            if ref not in live_refs:
                self._kv.delete(key)  # stale ref marker with no idx entries
        # startup GC: drop payloads nobody references (keys-only scan — no
        # payload bytes cross the engine boundary)
        for key in self._kv.scan_keys(b"m\x00"):
            if key[2:] not in live_refs:
                self._kv.delete(key)

    def write(self, sid: SubscriberId, msg: Msg) -> None:
        with self._lock:
            ref = msg.msg_ref
            # the 2-3 records of one message write go down in a single
            # batched append (one engine lock acquisition) — the analog
            # of the reference's one gen_server call covering the whole
            # 3-key write (vmq_lvldb_store.erl:339-358)
            batch = []
            first = ref not in self._refcount
            if first:
                batch.append((b"m\x00" + ref, self._enc(msg)))
            sk = self._sid_key(sid)
            seq = self._seq.next()
            batch.append((b"r\x00" + sk + ref, b""))
            batch.append((b"i\x00" + sk + seq.to_bytes(8, "big"), ref))
            # durable records FIRST: if the append fails (disk full), the
            # in-memory maps are untouched and a retry of the same
            # msg_ref still writes the payload record — mutating
            # _refcount first would make a retried first-delivery skip
            # the m-record forever (silent loss after restart)
            self._kv.put_many(batch)
            if self._fsync:
                if self._group_commit:
                    # park the sync for the broker's flush-tick commit:
                    # one fsync per write burst, not per record
                    self._sync_pending += 1
                else:
                    self._kv.sync()  # per-write power-loss durability
            if first:
                self._refcount[ref] = 0
            self._refcount[ref] += 1
            self._seqs.setdefault(sid, {}).setdefault(ref, []).append(seq)
            if msg.expires_at is not None and ref not in self._exp:
                # monotonic deadline → wall clock, so the sweep can
                # compare against time.time() without a Msg decode
                self._exp[ref] = time.time() + max(
                    0.0, msg.expires_at - time.monotonic())

    def needs_commit(self) -> bool:
        return self._sync_pending > 0

    def commit(self) -> int:
        with self._lock:
            pending, self._sync_pending = self._sync_pending, 0
        if pending == 0:
            return 0
        self._kv.sync()
        return pending - 1

    def read_all(self, sid: SubscriberId) -> List[Msg]:
        return [m for _, m in self.read_all_seq(sid)]

    def read_all_seq(self, sid: SubscriberId,
                     decoded: Optional[Dict[bytes, Msg]] = None
                     ) -> List[Tuple[int, Msg]]:
        """(enqueue-seq, msg) pairs in seq order — the merge key for a
        bucketed store's cross-instance recovery (the reference's ordset
        union in msg_store_collect, vmq_lvldb_store.erl:104-107).

        Served from the in-memory sid→ref→[seq] map (rebuilt from the
        ``i`` family at recovery, mirrored on every write/delete) with
        one engine point-get per distinct ref: a reconnect-storm read
        is O(backlog) per session, never an O(total-keys) prefix scan
        per session (the quadratic-storm cost the old per-sid engine
        scans paid). ``decoded`` is an optional shared ref→Msg cache —
        the payload family is refcounted ACROSS subscribers, so a
        broadcast's single m-record decodes once per batch, not once
        per session (sharing the Msg object mirrors the live fanout
        path, which enqueues one Msg to every queue)."""
        out: List[Tuple[int, Msg]] = []
        if decoded is None:
            decoded = {}
        with self._lock:
            pairs = [(seq, ref)
                     for ref, seqs in self._seqs.get(sid, {}).items()
                     for seq in seqs]
            pairs.sort()
            for seq, ref in pairs:
                msg = decoded.get(ref)
                if msg is None:
                    data = self._kv.get(b"m\x00" + ref)
                    if data is None:
                        continue
                    msg = decoded[ref] = self._dec(data)
                out.append((seq, msg))
        return out

    def read_many(self, sids: List[SubscriberId]
                  ) -> Dict[SubscriberId, List[Msg]]:
        """One batched recovery read (executor-friendly): a whole
        reconnect-storm batch resolves in ONE off-loop call, and the
        shared decode cache collapses cross-subscriber payload refs —
        a fan-out notification parked in 100k offline queues is ONE
        stored payload and decodes ONCE per batch here, where the
        per-session read_all baseline pays the decode per session."""
        decoded: Dict[bytes, Msg] = {}
        return {sid: [m for _, m in self.read_all_seq(sid, decoded)]
                for sid in sids}

    def delete(self, sid: SubscriberId, msg_ref: bytes) -> None:
        with self._lock:
            seqs = self._seqs.get(sid, {}).get(msg_ref)
            if not seqs:
                return
            seq = seqs.pop(0)
            if not seqs:
                self._seqs[sid].pop(msg_ref, None)
            sk = self._sid_key(sid)
            keys = [b"i\x00" + sk + seq.to_bytes(8, "big")]
            if not self._seqs.get(sid, {}).get(msg_ref):
                keys.append(b"r\x00" + sk + msg_ref)
            keys.extend(self._deref_keys(msg_ref, 1))
            self._kv.delete_many(keys)

    def delete_all(self, sid: SubscriberId) -> None:
        with self._lock:
            sk = self._sid_key(sid)
            # the in-memory map names every live i/r key for this sid:
            # point deletes batched into ONE engine append+flush, not an
            # O(total-keys) prefix scan + a flush per record
            keys: List[bytes] = []
            for ref, seqs in self._seqs.pop(sid, {}).items():
                for seq in seqs:
                    keys.append(b"i\x00" + sk + seq.to_bytes(8, "big"))
                keys.append(b"r\x00" + sk + ref)
                keys.extend(self._deref_keys(ref, len(seqs)))
            if keys:
                self._kv.delete_many(keys)

    def _deref_keys(self, ref: bytes, n: int) -> List[bytes]:
        """Drop ``n`` refcounts; returns the payload key to delete when
        nobody references it anymore (caller batches the engine op)."""
        left = self._refcount.get(ref, 0) - n
        if left <= 0:
            self._refcount.pop(ref, None)
            self._exp.pop(ref, None)
            return [b"m\x00" + ref]
        self._refcount[ref] = left
        return []

    def sweep_expired(self, budget: int = 256) -> int:
        """Budgeted TTL sweep riding the store maintenance tick: delete
        parked copies whose v5 message-expiry deadline has passed, so a
        million-session store doesn't hold dead payloads until each
        owner reconnects. Refs recovered from disk carry no in-memory
        deadline — up to ``budget`` of them are classified per call
        (one point-get each, no Msg built), so a huge restarted store
        never stalls the tick. Returns the number of parked
        per-subscriber copies removed."""
        swept = 0
        with self._lock:
            now = time.time()
            examined = 0
            while self._exp_scan and examined < budget:
                ref = self._exp_scan.pop()
                examined += 1
                if ref not in self._refcount or ref in self._exp:
                    continue
                data = self._kv.get(b"m\x00" + ref)
                if data is None:
                    continue
                deadline = self._peek_deadline(data)
                if deadline is not None:
                    self._exp[ref] = deadline
            expired = {r for r, dl in self._exp.items() if dl <= now}
            if not expired:
                return 0
            # ONE pass over the sid map resolves every expired ref's
            # owners (there is no ref→sid reverse index to maintain)
            keys: List[bytes] = []
            for sid in list(self._seqs):
                table = self._seqs[sid]
                hit = expired.intersection(table)
                if not hit:
                    continue
                sk = self._sid_key(sid)
                for ref in hit:
                    seqs = table.pop(ref)
                    for seq in seqs:
                        keys.append(b"i\x00" + sk
                                    + seq.to_bytes(8, "big"))
                    keys.append(b"r\x00" + sk + ref)
                    keys.extend(self._deref_keys(ref, len(seqs)))
                    swept += len(seqs)
                if not table:
                    del self._seqs[sid]
            for ref in expired:
                self._exp.pop(ref, None)
            if keys:
                self._kv.delete_many(keys)
        return swept

    def stats(self) -> Dict[str, int]:
        out = {"stored_messages": len(self._refcount),
               "stored_refs": sum(len(m) for m in self._seqs.values()),
               "kv_keys": self._kv.count(),
               "kv_garbage_bytes": self._kv.garbage_bytes()}
        return out

    def sync(self) -> None:
        self._kv.sync()

    def close(self) -> None:
        if self._sync_pending:
            self.commit()
        self._kv.close()


class NativeMsgStore(EngineMsgStore):
    """C++ storage-engine-backed store (the kvstore engine mounted under
    :class:`EngineMsgStore`'s 3-key-family layout)."""

    def __init__(self, directory: str, seq: Optional[SeqCounter] = None,
                 fsync: bool = False, group_commit: bool = True):
        from .segment import NativeEngine

        os.makedirs(directory, exist_ok=True)
        super().__init__(
            NativeEngine(os.path.join(directory, "msgstore.kv")),
            seq=seq, fsync=fsync, group_commit=group_commit)


class SegmentMsgStore(EngineMsgStore):
    """Segment-log-backed store: the pure-Python twin of the native
    engine (``storage/segment.py``) under the same key families —
    sealed segments, checkpointed recovery (a million parked sessions
    boot by loading the checkpoint index, not replaying history), and
    broker-driven budgeted compaction off the event loop."""

    def __init__(self, directory: str, seq: Optional[SeqCounter] = None,
                 fsync: bool = False, group_commit: bool = True,
                 segment_max_bytes: int = 8 * 1024 * 1024,
                 checkpoint_every_bytes: int = 32 * 1024 * 1024):
        from .segment import SegmentLogEngine

        os.makedirs(directory, exist_ok=True)
        super().__init__(
            SegmentLogEngine(os.path.join(directory, "msgstore.seg"),
                             segment_max_bytes=segment_max_bytes,
                             checkpoint_every_bytes=checkpoint_every_bytes),
            seq=seq, fsync=fsync, group_commit=group_commit)

    @property
    def recover_skipped(self) -> int:
        return self.engine.recover_skipped

    def stats(self) -> Dict[str, int]:
        out = super().stats()
        for k, v in self.engine.stats().items():
            out[f"segment_{k}"] = v
        return out


class FileMsgStore(MemoryMsgStore):
    """Legacy flat append-log store: every op is one JSON line, state
    rebuilt by whole-file replay on open. Superseded by
    :class:`SegmentMsgStore` for new ``message_store = file`` data dirs
    (the broker keeps opening this class when a ``msgstore.log``
    already exists, so old data dirs stay readable)."""

    engine_kind = "file"

    def __init__(self, directory: str, fsync: bool = False,
                 group_commit: bool = True):
        super().__init__()
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, "msgstore.log")
        self._fsync = fsync
        self._group_commit = group_commit
        self._sync_pending = 0
        #: corrupt mid-file records skipped at recovery (surfaced as the
        #: msg_store_recover_skipped metric by the broker)
        self.recover_skipped = 0
        self._recover()
        self._fh = open(self._path, "ab")

    def _recover(self) -> None:
        """Rebuild state from the journal, streaming (a long-lived log
        must not be slurped into memory). A torn final record (crash
        mid-append: no trailing newline) is expected — it is not applied
        and the file is TRUNCATED past it, or the next append would
        merge with the partial line and corrupt a good record. A corrupt
        newline-terminated record is skipped and counted — every later
        record still recovers (the old behavior discarded the whole
        tail)."""
        if not os.path.exists(self._path):
            return
        torn_at = None
        pos = 0
        with open(self._path, "rb") as fh:
            for line in fh:
                if not line.endswith(b"\n"):
                    torn_at = pos  # torn tail write
                    break
                pos += len(line)
                try:
                    rec = json.loads(line)
                    op = rec["op"]
                    sid = (rec["mp"], rec["cid"])
                    if op == "w":
                        msg = Msg(
                            topic=tuple(rec["topic"]),
                            payload=bytes.fromhex(rec["payload"]),
                            qos=rec["qos"],
                            retain=rec.get("retain", False),
                            mountpoint=rec["mp"],
                            msg_ref=rec["ref"].encode(),
                            properties=rec.get("props", {}),
                        )
                        super().write(sid, msg)
                    elif op == "d":
                        super().delete(sid, rec["ref"].encode())
                    elif op == "da":
                        super().delete_all(sid)
                except (json.JSONDecodeError, KeyError, ValueError,
                        TypeError):
                    self.recover_skipped += 1
        if torn_at is not None:
            with open(self._path, "r+b") as fh:
                fh.truncate(torn_at)
        if self.recover_skipped:
            log.warning("msg store %s: skipped %d corrupt record(s) "
                        "during recovery", self._path, self.recover_skipped)

    def _log(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec).encode() + b"\n")
        self._fh.flush()
        if self._fsync:  # opt-in power-loss durability
            if self._group_commit:
                self._sync_pending += 1  # one fsync per burst (commit)
            else:
                os.fsync(self._fh.fileno())

    def needs_commit(self) -> bool:
        return self._sync_pending > 0

    def commit(self) -> int:
        pending, self._sync_pending = self._sync_pending, 0
        if pending == 0:
            return 0
        os.fsync(self._fh.fileno())
        return pending - 1

    def write(self, sid: SubscriberId, msg: Msg) -> None:
        super().write(sid, msg)
        self._log({
            "op": "w", "mp": sid[0], "cid": sid[1], "ref": msg.msg_ref.decode(),
            "topic": list(msg.topic), "payload": msg.payload.hex(),
            "qos": msg.qos, "retain": msg.retain,
            "props": {k: v for k, v in msg.properties.items()
                      if isinstance(v, (int, str, float))},
        })

    def delete(self, sid: SubscriberId, msg_ref: bytes) -> None:
        super().delete(sid, msg_ref)
        self._log({"op": "d", "mp": sid[0], "cid": sid[1], "ref": msg_ref.decode()})

    def delete_all(self, sid: SubscriberId) -> None:
        super().delete_all(sid)
        self._log({"op": "da", "mp": sid[0], "cid": sid[1]})

    def close(self) -> None:
        if self._sync_pending:
            self.commit()
        self._fh.close()


class BucketedMsgStore(MsgStore):
    """N independent store instances hashed by MsgRef — the reference's
    bucket supervision (``vmq_lvldb_store_sup.erl:47-54``: ``phash2(Key)
    rem NR_OF_BUCKETS``, default 12 instances) so concurrent writers hit
    different engines/locks instead of serializing on one WAL mutex.

    Per-subscriber reads merge on the shared enqueue-seq (the
    reference's cross-bucket ordset union in ``msg_store_find``,
    ``vmq_lvldb_store.erl:84-107``) — but probe ONLY the buckets a
    sid→bucket membership index (exact set, rebuilt from each
    instance's recovery map at open) names: a reconnect-storm read for
    a session whose backlog landed in one bucket touches one engine,
    not all twelve. ``probe_hits``/``probe_misses`` count probed
    buckets that held messages vs stale memberships (cleaned on
    miss); the broker drains them into the
    ``store_bucket_probe_hits/misses`` counters on the maintenance
    tick.
    """

    supports_batched_read = True

    def __init__(self, directory: str, instances: int = 12,
                 fsync: bool = False, group_commit: bool = True):
        os.makedirs(directory, exist_ok=True)
        # the bucket count is part of the on-disk layout: ref→bucket hashing
        # must match what wrote the data, or deletes silently miss. Persist
        # it on first open and honour the persisted value thereafter.
        marker = os.path.join(directory, "INSTANCES")
        if os.path.exists(marker):
            with open(marker, "r", encoding="ascii") as fh:
                persisted = int(fh.read().strip())
            if persisted != instances:
                import logging

                logging.getLogger("vernemq_tpu_torch.storage").warning(
                    "msg store in %s was created with %d instances; "
                    "ignoring configured %d", directory, persisted, instances)
            instances = persisted
        else:
            with open(marker, "w", encoding="ascii") as fh:
                fh.write(str(max(1, instances)))
        self._seqc = SeqCounter()
        self.instances: List[NativeMsgStore] = []
        try:
            for i in range(max(1, instances)):
                self.instances.append(NativeMsgStore(
                    os.path.join(directory, f"bucket{i}"), seq=self._seqc,
                    fsync=fsync, group_commit=group_commit))
        except Exception:
            for inst in self.instances:  # no half-open engines left locked
                inst.close()
            raise
        # sid → {bucket index}: membership rebuilt from each engine's
        # recovery map, maintained on write/delete. Reads probe only
        # member buckets; a stale member (emptied behind our back by
        # the TTL sweep) is a counted probe miss and is cleaned.
        self._index_lock = threading.Lock()
        self._sid_buckets: Dict[SubscriberId, set] = {}
        for i, inst in enumerate(self.instances):
            for sid in inst._seqs:
                self._sid_buckets.setdefault(sid, set()).add(i)
        self.probe_hits = 0
        self.probe_misses = 0

    @property
    def engine_kind(self) -> str:
        return self.instances[0].engine_kind

    def _bucket_idx(self, ref: bytes) -> int:
        return zlib.crc32(ref) % len(self.instances)

    def _bucket(self, ref: bytes) -> NativeMsgStore:
        return self.instances[self._bucket_idx(ref)]

    def _probe(self, sid: SubscriberId, decoded=None
               ) -> List[Tuple[int, Msg]]:
        """Merged (seq, msg) rows for ``sid`` from its member buckets
        only; counts hits/misses and drops memberships proven stale
        (the instance's recovery map no longer knows the sid)."""
        with self._index_lock:
            members = sorted(self._sid_buckets.get(sid, ()))
        merged: List[Tuple[int, Msg]] = []
        hits = misses = 0
        for i in members:
            inst = self.instances[i]
            rows = inst.read_all_seq(sid, decoded)
            if rows:
                merged.extend(rows)
                hits += 1
                continue
            misses += 1
            with self._index_lock:
                # re-check under the lock: a concurrent write adds the
                # membership only AFTER its instance write landed, so
                # an absent sid here is genuinely stale
                if sid not in inst._seqs:
                    s = self._sid_buckets.get(sid)
                    if s is not None:
                        s.discard(i)
                        if not s:
                            self._sid_buckets.pop(sid, None)
        if hits or misses:
            with self._index_lock:
                self.probe_hits += hits
                self.probe_misses += misses
        merged.sort(key=lambda p: p[0])
        return merged

    def write(self, sid: SubscriberId, msg: Msg) -> None:
        i = self._bucket_idx(msg.msg_ref)
        self.instances[i].write(sid, msg)
        with self._index_lock:
            self._sid_buckets.setdefault(sid, set()).add(i)

    def read_all(self, sid: SubscriberId) -> List[Msg]:
        return [m for _, m in self._probe(sid)]

    def read_many(self, sids: List[SubscriberId]
                  ) -> Dict[SubscriberId, List[Msg]]:
        decoded: Dict[bytes, Msg] = {}
        return {sid: [m for _, m in self._probe(sid, decoded)]
                for sid in sids}

    def delete(self, sid: SubscriberId, msg_ref: bytes) -> None:
        i = self._bucket_idx(msg_ref)
        inst = self.instances[i]
        inst.delete(sid, msg_ref)
        if sid not in inst._seqs:
            with self._index_lock:
                s = self._sid_buckets.get(sid)
                if s is not None:
                    s.discard(i)
                    if not s:
                        self._sid_buckets.pop(sid, None)

    def delete_all(self, sid: SubscriberId) -> None:
        with self._index_lock:
            members = sorted(self._sid_buckets.pop(sid, ()))
        for i in members:
            self.instances[i].delete_all(sid)

    def sweep_expired(self, budget: int = 256) -> int:
        return sum(inst.sweep_expired(budget) for inst in self.instances)

    def needs_commit(self) -> bool:
        return any(inst.needs_commit() for inst in self.instances)

    def commit(self) -> int:
        return sum(inst.commit() for inst in self.instances)

    def stats(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for inst in self.instances:
            for k, v in inst.stats().items():
                agg[k] = agg.get(k, 0) + v
        agg["instances"] = len(self.instances)
        agg["bucket_index_sids"] = len(self._sid_buckets)
        agg["bucket_probe_hits"] = self.probe_hits
        agg["bucket_probe_misses"] = self.probe_misses
        return agg

    def sync(self) -> None:
        for inst in self.instances:
            inst.sync()

    def close(self) -> None:
        for inst in self.instances:
            inst.close()
