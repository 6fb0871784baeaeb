"""Unified segment-log storage engine.

One engine now backs BOTH durable key families of the broker: the
offline message store (``storage/msg_store.py`` — the ``m``/``r``/``i``
families mirroring ``vmq_lvldb_store.erl:339-416``) and the cluster
delivery spool (``cluster/spool.py`` — the per-peer ``s``/``h``
families). Before this module each grew its own journal: the msg store
a flat JSON append log replayed whole-file on every open, the spool a
private ``_FileJournal`` with its own compaction heuristics. At
million-offline-session scale that means two divergent recovery
disciplines and an O(total-history) boot.

The engine is an ordered byte-key store with prefix scans — exactly the
seat eleveldb occupies in the reference — in three interchangeable
implementations behind :func:`open_engine`:

- :class:`NativeEngine` — the C++ kvstore (``native/kvstore.cc``) when
  the toolchain built it; compaction and crash recovery are the
  engine's own.
- :class:`SegmentLogEngine` — the pure-Python twin: append-only
  **sealed segments** (``seg-<id>.log``), an in-memory key → (segment,
  offset, length) index (values stay ON DISK — a million parked
  offline queues must not live in the Python heap), **checkpointed
  recovery** (load the serialized index, then replay only the records
  past the checkpoint frontier — never the whole history), and
  **budgeted compaction**: :meth:`~SegmentLogEngine.compact_step`
  evacuates at most ``budget`` live bytes from the deadest sealed
  segment per call, so the broker can run it off the event loop under
  the watchdog with a per-tick byte budget (``store.compact`` is a
  registered fault point; the broker's store breaker pauses compaction
  — append-only degraded mode — without touching delivery).
- :class:`MemEngine` — dict-backed, for ``message_store = memory`` /
  an unset spool dir (no crash durability, same interface).

Record framing is the spool journal's proven discipline: ``P`` +
u32 klen + key + u32 vlen + value, ``D`` + u32 klen + key; a torn tail
(crash mid-append) truncates to the last whole record on recovery.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from ..robustness import faults

log = logging.getLogger("vernemq_tpu_torch.storage")

#: fixed per-record framing overhead (opcode byte + u32 length fields)
_PUT_OVERHEAD = 9   # b"P" + klen:4 + ... + vlen:4
_DEL_OVERHEAD = 5   # b"D" + klen:4

_CKPT_MAGIC = b"VMQCKPT1"


def _seg_name(seg_id: int) -> str:
    return f"seg-{seg_id:08d}.log"


class MemEngine:
    """In-process engine: full interface, no durability (the
    ``message_store = memory`` seat and the dir-less spool journal)."""

    kind = "memory"
    durable = False

    def __init__(self) -> None:
        self._d: Dict[bytes, bytes] = {}

    def put_many(self, pairs) -> None:
        self._d.update(dict(pairs))

    def get(self, key: bytes) -> Optional[bytes]:
        return self._d.get(key)

    def delete(self, key: bytes) -> bool:
        return self._d.pop(key, None) is not None

    def delete_many(self, keys) -> int:
        return sum(1 for k in keys if self._d.pop(k, None) is not None)

    def scan(self, prefix: bytes = b"") -> List[Tuple[bytes, bytes]]:
        return sorted((k, v) for k, v in self._d.items()
                      if k.startswith(prefix))

    def scan_keys(self, prefix: bytes = b"") -> List[bytes]:
        return sorted(k for k in self._d if k.startswith(prefix))

    def count(self) -> int:
        return len(self._d)

    def garbage_bytes(self) -> int:
        return 0

    def compact_step(self, budget: int = 0) -> int:
        return 0

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass

    def stats(self) -> Dict[str, int]:
        return {"keys": len(self._d), "live_bytes":
                sum(len(k) + len(v) for k, v in self._d.items())}


class SegmentLogEngine:
    """Pure-Python segment-compacted log engine (the native kvstore's
    twin — same interface, same crash discipline).

    Thread model: callers on the event loop (writes, point gets) and
    maintenance on executor threads (compaction, batched recovery
    reads) share ``_lock`` for index/accounting mutations; segment
    bytes at a given (segment, offset) are IMMUTABLE once written
    (append-only, compaction copies then unlinks whole files), so value
    reads happen outside the lock via ``os.pread`` — a compaction
    running under an executor never blocks a loop-side read for the
    duration of a file copy.
    """

    kind = "segment"
    durable = True

    def __init__(self, directory: str,
                 segment_max_bytes: int = 8 * 1024 * 1024,
                 checkpoint_every_bytes: int = 32 * 1024 * 1024,
                 compact_dead_ratio: float = 0.5):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.segment_max_bytes = max(256, int(segment_max_bytes))
        self.checkpoint_every_bytes = int(checkpoint_every_bytes)
        self.compact_dead_ratio = compact_dead_ratio
        self._lock = threading.Lock()
        # key -> (segment id, value offset, value length)
        self._index: Dict[bytes, Tuple[int, int, int]] = {}
        self._seg_size: Dict[int, int] = {}   # on-disk bytes per segment
        self._seg_live: Dict[int, int] = {}   # live record bytes per seg
        self._read_fh: Dict[int, object] = {}
        self._active = 1
        self._active_fh = None
        #: recovery/compaction observability (surfaced as broker gauges)
        self.recover_skipped = 0      # corrupt mid-log records skipped
        self.recover_fallbacks = 0    # checkpoint unusable -> full scan
        self.recover_replayed = 0     # records replayed past the frontier
        self.compactions = 0          # segments fully evacuated+unlinked
        self.compacted_bytes = 0      # live bytes copied by compaction
        self.checkpoints = 0
        self._since_checkpoint = 0    # appended bytes since last ckpt
        # in-progress evacuation: (victim seg, remaining keys, bytes
        # copied so far across budgeted ticks)
        self._evac: Optional[Tuple[int, List[bytes], int]] = None
        # serializes maintenance entry points (the periodic tick vs an
        # admin `store compact`) without blocking either
        self._compact_mutex = threading.Lock()
        # segments sealed since the last sync(): their tails are still
        # page-cache-only; a group commit must fsync THEM too or the
        # fsync promise has a hole exactly at every seal boundary
        self._sealed_unsynced: List[int] = []
        self._recover()
        self._open_active()

    # ------------------------------------------------------------ recovery

    def _segments_on_disk(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("seg-") and name.endswith(".log"):
                try:
                    out.append(int(name[4:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def _ckpt_path(self) -> str:
        return os.path.join(self.directory, "CHECKPOINT")

    def _load_checkpoint(self):
        """Parse the checkpoint -> (index, frontier_seg, frontier_off),
        or None when absent/corrupt/stale. ``store.recover`` is the
        injected-fault seam: a drill here exercises the full-scan
        degradation (data still recovers, just slower)."""
        faults.inject("store.recover", max_delay_s=1.0)
        path = self._ckpt_path()
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            blob = fh.read()
        # minimum = magic + ">IQQ" header (20) + crc (4): an EMPTY
        # index checkpoint (a drained store's clean state) is valid
        if len(blob) < len(_CKPT_MAGIC) + 20 + 4 \
                or not blob.startswith(_CKPT_MAGIC):
            raise ValueError("checkpoint header corrupt")
        body, (crc,) = blob[:-4], struct.unpack(">I", blob[-4:])
        if zlib.crc32(body) != crc:
            raise ValueError("checkpoint crc mismatch")
        pos = len(_CKPT_MAGIC)
        front_seg, front_off, n = struct.unpack(">IQQ", body[pos:pos + 20])
        pos += 20
        index: Dict[bytes, Tuple[int, int, int]] = {}
        for _ in range(n):
            (klen,) = struct.unpack(">I", body[pos:pos + 4])
            pos += 4
            key = body[pos:pos + klen]
            pos += klen
            seg, off, vlen = struct.unpack(">IQI", body[pos:pos + 16])
            pos += 16
            index[key] = (seg, off, vlen)
        return index, front_seg, front_off

    def _recover(self) -> None:
        segs = self._segments_on_disk()
        if not segs:
            return
        ckpt = None
        try:
            ckpt = self._load_checkpoint()
        except Exception as e:
            self.recover_fallbacks += 1
            log.warning("segment engine %s: checkpoint unusable (%s); "
                        "full segment scan", self.directory, e)
        start_seg, start_off = segs[0], 0
        if ckpt is not None:
            index, front_seg, front_off = ckpt
            # every indexed segment and the frontier itself must still
            # exist (a checkpoint written before a compaction unlink
            # can reference nothing that is gone — unlinks happen only
            # AFTER the post-evacuation checkpoint — but be defensive)
            known = set(segs)
            if (front_seg in known or front_seg == segs[-1] + 1) and all(
                    loc[0] in known for loc in index.values()):
                self._index = index
                start_seg, start_off = front_seg, front_off
            else:
                self.recover_fallbacks += 1
                self._index = {}
                log.warning("segment engine %s: checkpoint references "
                            "missing segments; full scan",
                            self.directory)
        for seg in segs:
            if seg < start_seg:
                continue
            self._replay_segment(
                seg, start_off if seg == start_seg else 0,
                truncate_torn=(seg == segs[-1]))
        # rebuild live/size accounting from the recovered index: the
        # index IS the live set, everything else on disk is garbage
        self._seg_size = {
            s: os.path.getsize(os.path.join(self.directory, _seg_name(s)))
            for s in segs}
        self._seg_live = {s: 0 for s in segs}
        for key, (seg, _off, vlen) in self._index.items():
            self._seg_live[seg] = (self._seg_live.get(seg, 0)
                                   + _PUT_OVERHEAD + len(key) + vlen)
        self._active = segs[-1]

    def _replay_segment(self, seg: int, start: int,
                        truncate_torn: bool) -> None:
        path = os.path.join(self.directory, _seg_name(seg))
        with open(path, "rb") as fh:
            if start:
                fh.seek(start)
            blob = fh.read()
        pos = 0
        n = len(blob)
        while pos < n:
            rec_start = pos
            op = blob[pos:pos + 1]
            if op not in (b"P", b"D") or pos + 5 > n:
                break  # torn/garbage tail
            (klen,) = struct.unpack(">I", blob[pos + 1:pos + 5])
            pos += 5
            key = blob[pos:pos + klen]
            pos += klen
            if len(key) != klen:
                pos = rec_start
                break
            if op == b"P":
                if pos + 4 > n:
                    pos = rec_start
                    break
                (vlen,) = struct.unpack(">I", blob[pos:pos + 4])
                pos += 4
                if pos + vlen > n:
                    pos = rec_start
                    break
                self._index[key] = (seg, start + pos, vlen)
                pos += vlen
            else:
                self._index.pop(key, None)
            self.recover_replayed += 1
        if pos < n:
            if truncate_torn:
                log.warning("segment %s: torn tail at +%d of %d bytes "
                            "(truncating)", path, start + pos, start + n)
                with open(path, "r+b") as fh:
                    fh.truncate(start + pos)
            else:
                # a torn record in a SEALED segment is corruption, not a
                # crash artifact: skip the remainder, count it, keep
                # every later segment's records
                self.recover_skipped += 1
                log.warning("segment %s: corrupt record at +%d; skipping "
                            "the remainder of the segment",
                            path, start + pos)

    # ------------------------------------------------------------- append

    def _open_active(self) -> None:
        path = os.path.join(self.directory, _seg_name(self._active))
        self._active_fh = open(path, "ab")
        self._seg_size.setdefault(self._active, self._active_fh.tell())
        self._seg_live.setdefault(self._active, 0)

    def _roll_segment_locked(self) -> None:
        """Seal the active segment and start the next one. Called with
        the lock held; the open is a local file create on the data dir
        — microseconds, not device work."""
        self._active_fh.close()
        self._sealed_unsynced.append(self._active)
        self._active += 1
        path = os.path.join(self.directory, _seg_name(self._active))
        # vmqlint: allow(lock-discipline): sealing must swap the append
        # handle atomically with the segment-id frontier; a local
        # O_APPEND create is a bounded syscall, not device/compile work
        self._active_fh = open(path, "ab")
        self._seg_size[self._active] = 0
        self._seg_live[self._active] = 0

    def put_many(self, pairs) -> None:
        pairs = list(pairs)
        if not pairs:
            return
        with self._lock:
            self._put_many_locked(pairs)

    def _put_many_locked(self, pairs) -> None:
        out = bytearray()
        base = self._seg_size[self._active]
        seg = self._active
        locs: List[Tuple[bytes, Tuple[int, int, int]]] = []
        for k, v in pairs:
            # value starts after P + klen + key + vlen
            voff = base + len(out) + _PUT_OVERHEAD + len(k)
            out += b"P" + struct.pack(">I", len(k)) + k
            out += struct.pack(">I", len(v)) + v
            locs.append((k, (seg, voff, len(v))))
        self._active_fh.write(out)
        self._active_fh.flush()
        self._seg_size[seg] = base + len(out)
        self._since_checkpoint += len(out)
        for k, loc in locs:
            old = self._index.get(k)
            if old is not None:
                self._seg_live[old[0]] -= (_PUT_OVERHEAD + len(k)
                                           + old[2])
            self._index[k] = loc
            self._seg_live[seg] += _PUT_OVERHEAD + len(k) + loc[2]
        if self._seg_size[seg] >= self.segment_max_bytes:
            self._roll_segment_locked()

    def delete(self, key: bytes) -> bool:
        return self.delete_many([key]) == 1

    def delete_many(self, keys) -> int:
        """Batched deletes: ONE append + flush for a whole dequeue
        burst (a delivered offline backlog's i/r/m teardown) — the
        loop-side cost per dequeued message is an index-entry append,
        not a write+flush each."""
        out = bytearray()
        n = 0
        with self._lock:
            for key in keys:
                old = self._index.pop(key, None)
                if old is None:
                    continue
                self._seg_live[old[0]] -= _PUT_OVERHEAD + len(key) + old[2]
                out += b"D" + struct.pack(">I", len(key)) + key
                n += 1
            if not out:
                return 0
            self._active_fh.write(out)
            self._active_fh.flush()
            self._seg_size[self._active] += len(out)
            self._since_checkpoint += len(out)
            if self._seg_size[self._active] >= self.segment_max_bytes:
                self._roll_segment_locked()
            return n

    # -------------------------------------------------------------- reads

    def _read_handle(self, seg: int):
        fh = self._read_fh.get(seg)
        if fh is None:
            fh = open(os.path.join(self.directory, _seg_name(seg)), "rb")
            # loop-side get and executor-side compaction may race the
            # first open of a segment: exactly one handle wins the cache
            won = self._read_fh.setdefault(seg, fh)
            if won is not fh:
                fh.close()
                fh = won
        return fh

    def _read_loc(self, loc: Tuple[int, int, int]) -> bytes:
        seg, off, vlen = loc
        if vlen == 0:
            return b""
        fh = self._read_handle(seg)
        return os.pread(fh.fileno(), vlen, off)

    def get(self, key: bytes) -> Optional[bytes]:
        # bytes at a (segment, offset) never change (append-only;
        # compaction copies then unlinks whole files, and an already-
        # open read handle survives the unlink) — so the read itself
        # runs outside the lock. Retry once if the segment handle
        # raced a compaction unlink before first open.
        for _ in range(3):
            with self._lock:
                loc = self._index.get(key)
            if loc is None:
                return None
            try:
                return self._read_loc(loc)
            except FileNotFoundError:
                with self._lock:
                    self._read_fh.pop(loc[0], None)
                continue
        with self._lock:  # pathological race: serve under the lock
            loc = self._index.get(key)
            return None if loc is None else self._read_loc(loc)

    def scan(self, prefix: bytes = b"") -> List[Tuple[bytes, bytes]]:
        with self._lock:
            items = sorted((k, loc) for k, loc in self._index.items()
                           if k.startswith(prefix))
        out = []
        for k, loc in items:
            try:
                out.append((k, self._read_loc(loc)))
            except FileNotFoundError:
                v = self.get(k)  # re-resolve through the moved index
                if v is not None:
                    out.append((k, v))
        return out

    def scan_keys(self, prefix: bytes = b"") -> List[bytes]:
        with self._lock:
            return sorted(k for k in self._index if k.startswith(prefix))

    def count(self) -> int:
        with self._lock:
            return len(self._index)

    def live_bytes(self) -> int:
        with self._lock:
            return sum(self._seg_live.values())

    def garbage_bytes(self) -> int:
        with self._lock:
            return max(0, sum(self._seg_size.values())
                       - sum(self._seg_live.values()))

    # --------------------------------------------------------- compaction

    def _pick_victim_locked(self) -> Optional[int]:
        best, best_dead = None, 0
        for seg, size in self._seg_size.items():
            if seg == self._active or size == 0:
                continue
            dead = size - self._seg_live.get(seg, 0)
            if self._seg_live.get(seg, 0) == 0 or (
                    size and dead / size >= self.compact_dead_ratio):
                if dead >= best_dead:
                    best, best_dead = seg, dead
        return best

    def compact_step(self, budget: int = 1 * 1024 * 1024) -> int:
        """One budgeted maintenance step, intended for an executor
        thread: evacuate up to ``budget`` live bytes from the deadest
        sealed segment into the active log (copies are re-appends, so
        logical order is preserved: the copy IS the live value), unlink
        the victim once empty, and refresh the checkpoint when due.
        Returns bytes of garbage reclaimed (0 = nothing to do). Crash
        at ANY point is safe: re-appended copies are idempotent
        last-write-wins on replay, and the victim is unlinked only
        after its records are all duplicated. Entry points are
        serialized (the periodic tick vs an admin `store compact`): a
        concurrent second caller returns 0 instead of racing the
        shared evacuation state."""
        if not self._compact_mutex.acquire(blocking=False):
            return 0
        try:
            return self._compact_step_serialized(budget)
        finally:
            self._compact_mutex.release()

    def _compact_step_serialized(self, budget: int) -> int:
        reclaimed = 0
        if self._evac is None:
            with self._lock:
                victim = self._pick_victim_locked()
                if victim is not None:
                    keys = [k for k, loc in self._index.items()
                            if loc[0] == victim]
                    self._evac = (victim, keys, 0)
        if self._evac is not None:
            victim, keys, total_copied = self._evac
            copied = 0
            while keys and copied < budget:
                # budget checked per record; the lock is held for at
                # most 32 copies so loop-side writers never wait long
                with self._lock:
                    for _ in range(32):
                        if not keys or copied >= budget:
                            break
                        k = keys.pop()
                        loc = self._index.get(k)
                        if loc is None or loc[0] != victim:
                            continue  # deleted/overwritten meanwhile
                        val = self._read_loc(loc)
                        self._put_many_locked([(k, val)])
                        copied += _PUT_OVERHEAD + len(k) + len(val)
            self.compacted_bytes += copied
            total_copied += copied
            if not keys:
                # fully evacuated: drop accounting, close the read
                # handle, unlink the file — reclaiming its dead bytes
                with self._lock:
                    size = self._seg_size.pop(victim, 0)
                    self._seg_live.pop(victim, None)
                    fh = self._read_fh.pop(victim, None)
                self._evac = None
                if fh is not None:
                    fh.close()
                try:
                    os.unlink(os.path.join(self.directory,
                                           _seg_name(victim)))
                except OSError:
                    pass
                self.compactions += 1
                # garbage actually reclaimed = the victim's on-disk
                # bytes minus EVERY live byte copied out of it across
                # all budgeted ticks, not just this tick's share
                reclaimed = max(0, size - total_copied)
                self.checkpoint()
            else:
                self._evac = (victim, keys, total_copied)
        elif self._since_checkpoint >= self.checkpoint_every_bytes:
            self.checkpoint()
        return reclaimed

    def checkpoint(self) -> None:
        """Serialize the index + frontier so the next open replays only
        records appended after this point. Atomic (tmp + rename); the
        snapshot is taken in ONE lock acquisition, the file write runs
        outside it. Segment data is fsynced FIRST — a durable (fsynced)
        checkpoint must never index bytes that only exist in the page
        cache, or power loss leaves it pointing past EOF."""
        self.sync()
        with self._lock:
            front_seg = self._active
            front_off = self._seg_size[self._active]
            entries = list(self._index.items())
            self._since_checkpoint = 0
        body = bytearray(_CKPT_MAGIC)
        body += struct.pack(">IQQ", front_seg, front_off, len(entries))
        for key, (seg, off, vlen) in entries:
            body += struct.pack(">I", len(key)) + key
            body += struct.pack(">IQI", seg, off, vlen)
        tmp = self._ckpt_path() + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(bytes(body) + struct.pack(">I", zlib.crc32(body)))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._ckpt_path())
        self.checkpoints += 1

    # ---------------------------------------------------------- lifecycle

    def sync(self) -> None:
        with self._lock:
            self._active_fh.flush()
            # dup the active fd: a compaction-driven roll may close the
            # handle between lock release and the fsync below — the
            # dup'd descriptor survives that close
            fd = os.dup(self._active_fh.fileno())
            sealed, self._sealed_unsynced = self._sealed_unsynced, []
        try:
            # segments sealed since the last sync first: their tails
            # hold records older than the active segment's
            for seg in sealed:
                try:
                    os.fsync(self._read_handle(seg).fileno())
                except FileNotFoundError:
                    # evacuated + unlinked meanwhile: its live records
                    # were re-appended to the active log, synced below
                    continue
            os.fsync(fd)
        finally:
            os.close(fd)

    def close(self) -> None:
        try:
            self.checkpoint()
        except Exception:
            log.exception("segment engine %s: checkpoint at close "
                          "failed (next open falls back to a full scan)",
                          self.directory)
        with self._lock:
            if self._active_fh is not None:
                self._active_fh.close()
                self._active_fh = None
            for fh in self._read_fh.values():
                fh.close()
            self._read_fh.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            live = sum(self._seg_live.values())
            size = sum(self._seg_size.values())
            nseg = len(self._seg_size)
            keys = len(self._index)
        return {
            "keys": keys, "segments": nseg, "live_bytes": live,
            "garbage_bytes": max(0, size - live),
            "compactions": self.compactions,
            "compacted_bytes": self.compacted_bytes,
            "checkpoints": self.checkpoints,
            "recover_skipped": self.recover_skipped,
            "recover_fallbacks": self.recover_fallbacks,
            "recover_replayed": self.recover_replayed,
        }


class NativeEngine:
    """The C++ kvstore behind the shared engine interface. Recovery and
    incremental compaction are the native engine's own; ``compact_step``
    maps to a full native compaction once garbage crosses the
    threshold (the native store also self-compacts on writes, so the
    broker's budgeted loop is a backstop here, not the only trigger).
    """

    kind = "native"
    durable = True

    def __init__(self, path: str,
                 compact_threshold: int = 64 * 1024 * 1024):
        from ..native.kvstore import KVStore

        self._kv = KVStore(path, compact_threshold=compact_threshold)
        self.path = path
        self.compactions = 0

    def put_many(self, pairs) -> None:
        self._kv.put_many(pairs)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._kv.get(key)

    def delete(self, key: bytes) -> bool:
        return self._kv.delete(key)

    def delete_many(self, keys) -> int:
        return sum(1 for k in keys if self._kv.delete(k))

    def scan(self, prefix: bytes = b"") -> List[Tuple[bytes, bytes]]:
        return self._kv.scan(prefix)

    def scan_keys(self, prefix: bytes = b"") -> List[bytes]:
        return self._kv.scan_keys(prefix)

    def count(self) -> int:
        return self._kv.count()

    def garbage_bytes(self) -> int:
        return self._kv.garbage_bytes()

    def compact_step(self, budget: int = 0) -> int:
        g = self._kv.garbage_bytes()
        if g <= self._kv.compact_threshold:
            return 0
        self._kv.compact()
        self.compactions += 1
        return g

    def sync(self) -> None:
        self._kv.sync()

    def close(self) -> None:
        self._kv.close()

    def stats(self) -> Dict[str, int]:
        return {"keys": self._kv.count(),
                "garbage_bytes": self._kv.garbage_bytes(),
                "compactions": self.compactions}


def open_engine(directory: str, filename: str = "store",
                prefer: str = "auto",
                segment_max_bytes: int = 8 * 1024 * 1024,
                checkpoint_every_bytes: int = 32 * 1024 * 1024):
    """Open the storage engine for ``directory``: the native kvstore
    when the toolchain built it (``prefer`` "auto"/"native"), the
    pure-Python segment twin otherwise (or with ``prefer="segment"``),
    a :class:`MemEngine` when ``directory`` is empty. Same interface
    across all three — callers learn which one served from
    ``engine.kind`` (the bench artifacts record it so partition-storm /
    reconnect-storm numbers are comparable across boxes)."""
    if not directory:
        return MemEngine()
    os.makedirs(directory, exist_ok=True)
    if prefer in ("auto", "native"):
        try:
            return NativeEngine(os.path.join(directory, filename + ".kv"))
        except Exception as e:
            log.warning("native kvstore unavailable for %s (%s); using "
                        "the segment-log engine", directory, e)
    return SegmentLogEngine(
        os.path.join(directory, filename + ".seg"),
        segment_max_bytes=segment_max_bytes,
        checkpoint_every_bytes=checkpoint_every_bytes)
