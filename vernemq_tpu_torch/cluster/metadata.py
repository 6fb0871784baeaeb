"""Replicated metadata store: LWW registers with change events.

Plays the role of the reference's ``vmq_metadata`` facade
(``vmq_metadata.erl:47-60``: put/get/delete/fold/subscribe) with a
plumtree-flavored implementation: every write is applied locally
synchronously (read-your-writes on the local node, matching the
synchronous trie events the reference relies on), broadcast to peers, and
reconciled on (re)connect by a full-state exchange (the eager-push +
anti-entropy shape of plumtree; the SWC store arrives as the second
metadata backend the way ``vmq_swc`` does).

Conflict resolution is last-writer-wins on a (lamport, origin-node) pair —
the reference's plumtree backend resolves concurrent metadata writes LWW
too (``vmq_plumtree.erl:91-104``).

Reconnect reconciliation is DIGEST-BASED partial anti-entropy (the role of
plumtree's AE exchange / ``vmq_swc_exchange_fsm.erl:34-116``'s
clock-then-missing-dots shape): keys hash into ``AE_BUCKETS`` buckets whose
XOR-of-entry-hash digests are maintained incrementally (O(1) per write);
peers exchange the non-zero digests (~KBs) and transfer only the entries
of mismatching buckets — O(delta) per reconnect instead of O(state).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from . import codec

Key = Tuple[str, Any]  # (prefix, key)
Entry = Tuple[int, str, Any]  # (lamport, origin_node, value | None tombstone)

AE_BUCKETS = 512


def term_hash(obj: Any) -> int:
    """Deterministic 64-bit structural hash — identical on every node for
    equal terms (dict iteration order canonicalised; Python hash() is
    per-process randomised so unusable here)."""
    h = hashlib.blake2b(digest_size=8)

    def feed(o: Any) -> None:
        if o is None:
            h.update(b"\x00N")
        elif isinstance(o, bool):
            h.update(b"\x00B1" if o else b"\x00B0")
        elif isinstance(o, int):
            h.update(b"\x00I" + str(o).encode())
        elif isinstance(o, float):
            h.update(b"\x00F" + repr(o).encode())
        elif isinstance(o, str):
            h.update(b"\x00S" + o.encode("utf-8", "surrogatepass"))
        elif isinstance(o, bytes):
            h.update(b"\x00Y" + o)
        elif isinstance(o, (list, tuple)):
            h.update(b"\x00L")
            for x in o:
                feed(x)
            h.update(b"\x00/")
        elif isinstance(o, dict):
            h.update(b"\x00D")
            for k in sorted(o, key=lambda k: (str(type(k)), str(k))):
                feed(k)
                feed(o[k])
            h.update(b"\x00/")
        else:
            h.update(b"\x00O" + repr(o).encode())

    feed(obj)
    return int.from_bytes(h.digest(), "big")


class MetadataStore:
    def __init__(self, node_name: str, persist_dir: Optional[str] = None):
        self.node_name = node_name
        self._data: Dict[Key, Entry] = {}
        self._clock = 0
        # per-bucket XOR of entry hashes, maintained incrementally — the
        # AE digest vector (zero = empty bucket) — plus a bucket→keys
        # index so bucket_entries is O(requested), not an O(state) rescan
        self._digests = [0] * AE_BUCKETS
        self._bucket_keys: List[set] = [set() for _ in range(AE_BUCKETS)]
        self._lock = threading.Lock()
        # prefix -> [fn(key, old_value, new_value)]
        self._subscribers: Dict[str, List[Callable[[Any, Any, Any], None]]] = {}
        # wired by the cluster layer: fn(prefix, key, entry) -> None
        self.broadcast: Optional[Callable[[str, Any, Entry], None]] = None
        # optional durability through the native storage engine (the
        # reference's metadata store persists via eleveldb)
        self._kv = None
        if persist_dir is not None:
            import os

            from ..native.kvstore import KVError, KVStore

            try:
                os.makedirs(persist_dir, exist_ok=True)
                self._kv = KVStore(os.path.join(persist_dir, "metadata.kv"))
                self._load_persisted()
            except (KVError, OSError) as e:
                import logging

                logging.getLogger("vernemq_tpu_torch.metadata").warning(
                    "metadata persistence unavailable: %s", e)
                self._kv = None

    # tombstones older than this are dropped at load time — long enough for
    # anti-entropy to have spread the delete cluster-wide, short enough that
    # clean-session churn cannot grow the store unboundedly
    TOMBSTONE_RETENTION_S = 86400.0

    def _load_persisted(self) -> None:
        import time

        from .codec import decode, encode

        now = time.time()
        for kb, vb in self._kv.scan(b""):
            prefix, key = decode(kb)
            stored = decode(vb)
            entry = tuple(stored[:3])
            if entry[2] is None:  # tombstone: [clock, origin, None, wall_ts]
                ts = stored[3] if len(stored) > 3 else 0.0
                if now - ts > self.TOMBSTONE_RETENTION_S:
                    self._kv.delete(kb)
                    continue
            k = (prefix, codec.dekey(key))
            self._data[k] = entry
            b = self._bucket(k)
            self._digests[b] ^= term_hash((k, entry))
            self._bucket_keys[b].add(k)
            self._clock = max(self._clock, entry[0])

    def _persist(self, prefix: str, key: Any, entry: Entry) -> None:
        if self._kv is None:
            return
        import time

        from .codec import encode

        stored = list(entry)
        if entry[2] is None:
            stored.append(time.time())  # tombstone GC clock
        self._kv.put(encode([prefix, key]), encode(stored))

    def close(self) -> None:
        if self._kv is not None:
            self._kv.close()
            self._kv = None

    # ------------------------------------------------------------------ API

    def put(self, prefix: str, key: Any, value: Any) -> None:
        with self._lock:
            self._clock += 1
            entry = (self._clock, self.node_name, value)
        self._apply(prefix, key, entry, local=True)

    def delete(self, prefix: str, key: Any) -> None:
        self.put(prefix, key, None)  # tombstone

    def get(self, prefix: str, key: Any, default: Any = None) -> Any:
        entry = self._data.get((prefix, key))
        if entry is None or entry[2] is None:
            return default
        return entry[2]

    def fold(self, prefix: str) -> Iterable[Tuple[Any, Any]]:
        """Iterate live (key, value) under a prefix
        (vmq_metadata:fold equivalent)."""
        for (p, k), (_, _, v) in list(self._data.items()):
            if p == prefix and v is not None:
                yield k, v

    def subscribe(self, prefix: str,
                  fn: Callable[[Any, Any, Any, str], None]) -> None:
        """Change events for a prefix: fn(key, old_value, new_value,
        origin_node) — the subscriber-db event feed
        (vmq_subscriber_db.erl:56-71). ``origin_node`` lets write-through
        caches skip re-applying their own local writes."""
        self._subscribers.setdefault(prefix, []).append(fn)

    def unsubscribe(self, prefix: str,
                    fn: Callable[[Any, Any, Any, str], None]) -> None:
        fns = self._subscribers.get(prefix)
        if fns and fn in fns:
            fns.remove(fn)

    # ----------------------------------------------------------- replication

    def _newer(self, a: Entry, b: Optional[Entry]) -> bool:
        if b is None:
            return True
        return (a[0], a[1]) > (b[0], b[1])

    @staticmethod
    def _bucket(k: Key) -> int:
        return term_hash(k) % AE_BUCKETS

    def _apply(self, prefix: str, key: Any, entry: Entry, local: bool) -> bool:
        with self._lock:
            k = (prefix, key)
            old = self._data.get(k)
            if not local and not self._newer(entry, old):
                return False
            self._clock = max(self._clock, entry[0])
            self._data[k] = entry
            b = self._bucket(k)
            if old is not None:
                self._digests[b] ^= term_hash((k, old))
            self._digests[b] ^= term_hash((k, entry))
            self._bucket_keys[b].add(k)
            self._persist(prefix, key, entry)
        old_value = old[2] if old else None
        for fn in self._subscribers.get(prefix, []):
            fn(key, old_value, entry[2], entry[1])
        if local and self.broadcast is not None:
            self.broadcast(prefix, key, entry)
        return True

    def merge(self, prefix: str, key: Any, entry: Tuple) -> bool:
        """Apply a replicated entry from a peer (broadcast or AE sync)."""
        return self._apply(prefix, key, tuple(entry), local=False)

    def full_state(self) -> List[Tuple[str, Any, Entry]]:
        """Snapshot for a full anti-entropy exchange (bootstrap / fallback
        for peers without the digest protocol)."""
        with self._lock:
            return [(p, k, e) for (p, k), e in self._data.items()]

    # --------------------------------------------- digest-based partial AE

    def digests(self) -> List[Tuple[int, int]]:
        """Non-zero (bucket, digest) pairs — the exchange request payload.
        ~16 bytes per OCCUPIED bucket regardless of key count."""
        with self._lock:
            return [(i, d) for i, d in enumerate(self._digests) if d]

    def diff_buckets(self, remote: Iterable[Tuple[int, int]]) -> List[int]:
        """Buckets whose digest differs from the remote's (missing = 0)."""
        rd = dict(remote)
        with self._lock:
            return [i for i in range(AE_BUCKETS)
                    if self._digests[i] != rd.get(i, 0)]

    def bucket_entries(self, buckets: Iterable[int]) -> List[Tuple[str, Any, Entry]]:
        out: List[Tuple[str, Any, Entry]] = []
        with self._lock:
            for b in buckets:
                for k in self._bucket_keys[b]:
                    e = self._data.get(k)
                    if e is not None:
                        out.append((k[0], k[1], e))
        return out

    def merge_full(self, state: Iterable[Tuple[str, Any, Tuple]]) -> int:
        applied = 0
        for prefix, key, entry in state:
            if self.merge(prefix, codec.dekey(key), entry):
                applied += 1
        return applied

    def stats(self) -> Dict[str, int]:
        return {"metadata_entries": len(self._data), "clock": self._clock}

