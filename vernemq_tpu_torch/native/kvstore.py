"""ctypes binding for the C++ storage engine (``native/kvstore.cc``).

Ordered byte-key store with prefix scans and crash recovery — the seat
eleveldb occupies in the reference (``vmq_lvldb_store.erl:316-358``)."""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, List, Optional, Tuple

from . import load_library

_lib = None
_lib_checked = False


def _bind(lib):
    """Declare every symbol's signature. Raises AttributeError when the
    loaded artifact predates a symbol (stale build dir) — the caller
    rebuilds once and retries rather than crashing the first KVStore
    construction mid-broker-boot."""
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_open.argtypes = [ctypes.c_char_p]
    lib.kv_close.argtypes = [ctypes.c_void_p]
    lib.kv_put.restype = ctypes.c_int
    lib.kv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                   ctypes.c_uint32, ctypes.c_char_p,
                   ctypes.c_uint32]
    lib.kv_put_batch.restype = ctypes.c_int
    lib.kv_put_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32)]
    lib.kv_get.restype = ctypes.c_int
    lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                   ctypes.c_uint32,
                   ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                   ctypes.POINTER(ctypes.c_uint32)]
    lib.kv_delete.restype = ctypes.c_int
    lib.kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                      ctypes.c_uint32]
    lib.kv_scan.restype = ctypes.c_long
    lib.kv_scan.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.c_uint32,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.POINTER(ctypes.c_uint64)]
    lib.kv_scan_keys.restype = ctypes.c_long
    lib.kv_scan_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                         ctypes.c_uint32,
                         ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                         ctypes.POINTER(ctypes.c_uint64)]
    lib.kv_count.restype = ctypes.c_uint64
    lib.kv_count.argtypes = [ctypes.c_void_p]
    lib.kv_garbage_bytes.restype = ctypes.c_uint64
    lib.kv_garbage_bytes.argtypes = [ctypes.c_void_p]
    lib.kv_sync.restype = ctypes.c_int
    lib.kv_sync.argtypes = [ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_free.argtypes = [ctypes.c_void_p]


def _get_lib():
    global _lib, _lib_checked
    if not _lib_checked:
        _lib_checked = True
        lib = load_library("libvmq_kvstore.so")
        if lib is not None:
            try:
                _bind(lib)
            except AttributeError:
                # stale prebuilt .so missing a newer symbol: rebuild for
                # this checkout and reload once, else fall back to the
                # pure-Python store
                lib = _rebuild_and_reload()
        _lib = lib
    return _lib


def _rebuild_and_reload():
    import subprocess

    from . import BUILD_DIR, NATIVE_DIR, fresh_artifact_copy

    try:
        subprocess.run(["make", "-C", NATIVE_DIR, "-B",
                        "build/libvmq_kvstore.so"],
                       check=True, capture_output=True, timeout=120)
        # dlopen dedups by inode and the Makefile relinks in place, so a
        # same-path CDLL would hand back the STALE handle — load the
        # rebuilt artifact from a unique copy instead
        lib = ctypes.CDLL(fresh_artifact_copy(
            os.path.join(BUILD_DIR, "libvmq_kvstore.so")))
        _bind(lib)
        return lib
    except Exception:
        return None


def available() -> bool:
    return _get_lib() is not None


class KVError(Exception):
    pass


class KVStore:
    """One open store (one log file). Compaction is triggered automatically
    when garbage exceeds ``compact_threshold`` bytes (the role of LevelDB's
    background compaction)."""

    def __init__(self, path: str, compact_threshold: int = 64 * 1024 * 1024):
        lib = _get_lib()
        if lib is None:
            raise KVError("native kvstore library unavailable")
        self._lib = lib
        self._h = lib.kv_open(path.encode())
        if not self._h:
            raise KVError(f"cannot open store at {path}")
        self.path = path
        self.compact_threshold = compact_threshold
        self._compactor: Optional[threading.Thread] = None

    def put(self, key: bytes, value: bytes) -> None:
        if self._lib.kv_put(self._h, key, len(key), value, len(value)) != 0:
            raise KVError("put failed")
        self._maybe_compact()

    def put_many(self, pairs) -> None:
        """Write N records under ONE native lock acquisition — the
        offline path's 3-record message write (payload/ref/idx) and
        fanout bursts amortise the per-call overhead (the reference's
        one-gen_server-call-per-write, vmq_lvldb_store.erl:339-358)."""
        pairs = list(pairs)
        if not pairs:
            return
        n = len(pairs)
        keys = b"".join(k for k, _ in pairs)
        vals = b"".join(v for _, v in pairs)
        klens = (ctypes.c_uint32 * n)(*(len(k) for k, _ in pairs))
        vlens = (ctypes.c_uint32 * n)(*(len(v) for _, v in pairs))
        if self._lib.kv_put_batch(self._h, n, keys, klens,
                                  vals, vlens) != 0:
            raise KVError("put_batch failed")
        self._maybe_compact()

    def get(self, key: bytes) -> Optional[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint32()
        rc = self._lib.kv_get(self._h, key, len(key),
                              ctypes.byref(out), ctypes.byref(out_len))
        if rc < 0:
            raise KVError("get failed")
        if rc == 0:
            return None
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.kv_free(out)

    def delete(self, key: bytes) -> bool:
        rc = self._lib.kv_delete(self._h, key, len(key))
        if rc < 0:
            raise KVError("delete failed")
        return rc == 1

    def scan(self, prefix: bytes = b"") -> List[Tuple[bytes, bytes]]:
        """All (key, value) pairs under prefix, in key order."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        count = self._lib.kv_scan(self._h, prefix, len(prefix),
                                  ctypes.byref(out), ctypes.byref(out_len))
        if count < 0:
            raise KVError("scan failed")
        try:
            blob = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.kv_free(out)
        items: List[Tuple[bytes, bytes]] = []
        pos = 0
        for _ in range(count):
            klen = int.from_bytes(blob[pos:pos + 4], "little")
            pos += 4
            key = blob[pos:pos + klen]
            pos += klen
            vlen = int.from_bytes(blob[pos:pos + 4], "little")
            pos += 4
            items.append((key, blob[pos:pos + vlen]))
            pos += vlen
        return items

    def scan_keys(self, prefix: bytes = b"") -> List[bytes]:
        """Keys under prefix, in order — no value copies (boot scans)."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        count = self._lib.kv_scan_keys(self._h, prefix, len(prefix),
                                       ctypes.byref(out), ctypes.byref(out_len))
        if count < 0:
            raise KVError("scan_keys failed")
        try:
            blob = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.kv_free(out)
        keys: List[bytes] = []
        pos = 0
        for _ in range(count):
            klen = int.from_bytes(blob[pos:pos + 4], "little")
            pos += 4
            keys.append(blob[pos:pos + klen])
            pos += klen
        return keys

    def count(self) -> int:
        return int(self._lib.kv_count(self._h))

    def garbage_bytes(self) -> int:
        return int(self._lib.kv_garbage_bytes(self._h))

    def sync(self) -> None:
        if self._lib.kv_sync(self._h) != 0:
            raise KVError("sync failed")

    def compact(self) -> None:
        if self._lib.kv_compact(self._h) != 0:
            raise KVError("compact failed")

    def _maybe_compact(self) -> None:
        """Kick compaction on a background thread once garbage crosses the
        threshold — the put() caller (often the asyncio event loop) must not
        block on a full-store rewrite (LevelDB compacts in background
        threads for the same reason). Concurrent store ops simply queue on
        the C-side mutex for their own short critical sections."""
        if (not self.compact_threshold
                or self.garbage_bytes() <= self.compact_threshold):
            return
        if self._compactor is not None and self._compactor.is_alive():
            return

        def _run() -> None:
            try:
                self.compact()
            except KVError:
                pass  # next threshold crossing retries

        self._compactor = threading.Thread(target=_run, daemon=True,
                                           name="kv-compact")
        self._compactor.start()

    def close(self) -> None:
        # the native handle is freed below, so a still-running compactor
        # would use-after-free: join without a timeout (compaction is
        # bounded by file size; shutdown correctness beats promptness)
        if self._compactor is not None and self._compactor.is_alive():
            self._compactor.join()
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None

    def __enter__(self) -> "KVStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
