"""SWC metadata storage-backend seam.

The reference defines a storage behaviour for the SWC store
(``apps/vmq_swc/src/vmq_swc_db.erl``: ``put/delete/get/fold`` callbacks)
with three engines behind it (leveldb / rocksdb / leveled) selected by
the ``vmq_swc.db_backend`` config. This module is that seam: a small
key-value backend interface consumed by :mod:`cluster.swc_store`'s
persistence layer, with two engines —

- ``kvstore`` (default): one native C++ append-log engine
  (``native/kvstore.cc``), the eleveldb seat.
- ``bucketed``: N kvstore engines hashed by record key — the same
  sharded-write posture as the bucketed message store
  (``storage/msg_store.py``), for metadata-churn-heavy deployments
  (the reference's rocksdb-vs-leveldb choice is likewise about write
  amplification under churn).

Select with the ``swc_db_backend`` config knob.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Iterable, List, Optional, Tuple


class SWCDBBackend(ABC):
    """vmq_swc_db behaviour equivalent (vmq_swc_db.erl:33-60)."""

    @abstractmethod
    def put(self, key: bytes, value: bytes) -> None: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abstractmethod
    def scan(self, prefix: bytes = b"") -> Iterable[Tuple[bytes, bytes]]:
        """All (key, value) records with the prefix; order not
        significant (the consumer rebuilds in-memory state)."""

    @abstractmethod
    def scan_keys(self, prefix: bytes = b"") -> Iterable[bytes]: ...

    @abstractmethod
    def sync(self) -> None: ...

    @abstractmethod
    def close(self) -> None: ...


class KVBackend(SWCDBBackend):
    """Single native append-log engine (the default)."""

    def __init__(self, persist_dir: str):
        from ..native.kvstore import KVStore

        os.makedirs(persist_dir, exist_ok=True)
        self._kv = KVStore(os.path.join(persist_dir, "metadata-swc.kv"))

    def put(self, key: bytes, value: bytes) -> None:
        self._kv.put(key, value)

    def delete(self, key: bytes) -> None:
        self._kv.delete(key)

    def scan(self, prefix: bytes = b"") -> List[Tuple[bytes, bytes]]:
        return self._kv.scan(prefix)

    def scan_keys(self, prefix: bytes = b"") -> List[bytes]:
        return self._kv.scan_keys(prefix)

    def sync(self) -> None:
        self._kv.sync()

    def close(self) -> None:
        self._kv.close()


class BucketedKVBackend(SWCDBBackend):
    """N engines hashed by key — bounds per-file compaction pauses and
    spreads write amplification under metadata churn."""

    def __init__(self, persist_dir: str, n_buckets: int = 4):
        from ..native.kvstore import KVStore

        os.makedirs(persist_dir, exist_ok=True)
        self.n_buckets = max(1, int(n_buckets))
        self._kvs = [
            KVStore(os.path.join(persist_dir, f"metadata-swc.{i}.kv"))
            for i in range(self.n_buckets)
        ]

    def _pick(self, key: bytes):
        # stable non-crypto hash; Python hash() is salted per process
        h = 2166136261
        for b in key:
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
        return self._kvs[h % self.n_buckets]

    def put(self, key: bytes, value: bytes) -> None:
        self._pick(key).put(key, value)

    def delete(self, key: bytes) -> None:
        self._pick(key).delete(key)

    def scan(self, prefix: bytes = b"") -> List[Tuple[bytes, bytes]]:
        out: List[Tuple[bytes, bytes]] = []
        for kv in self._kvs:
            out.extend(kv.scan(prefix))
        return out

    def scan_keys(self, prefix: bytes = b"") -> List[bytes]:
        out: List[bytes] = []
        for kv in self._kvs:
            out.extend(kv.scan_keys(prefix))
        return out

    def sync(self) -> None:
        for kv in self._kvs:
            kv.sync()

    def close(self) -> None:
        for kv in self._kvs:
            kv.close()


BACKENDS = {"kvstore": KVBackend, "bucketed": BucketedKVBackend}


def open_backend(name: str, persist_dir: str,
                 **opts) -> Optional[SWCDBBackend]:
    """Factory (the vmq_swc_db:backend/0 resolution). Returns None when
    the engine can't open (consumer degrades to memory-only, same as
    today's posture)."""
    import logging

    from ..native.kvstore import KVError

    cls = BACKENDS.get(name)
    if cls is None:
        raise ValueError(
            f"unknown swc_db_backend {name!r} "
            f"(valid: {', '.join(sorted(BACKENDS))})")
    try:
        return cls(persist_dir, **opts)
    except (KVError, OSError) as e:
        logging.getLogger(__name__).warning(
            "swc metadata persistence unavailable: %s", e)
        return None
