"""ctypes binding for the C++ wait-free counters (``native/counters.cc``)
— the mzmetrics seat (``vmq_metrics.erl:267-301``)."""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence

from . import load_library

_lib = None
_lib_checked = False


def _get_lib():
    global _lib, _lib_checked
    if not _lib_checked:
        _lib_checked = True
        lib = load_library("libvmq_counters.so")
        if lib is not None:
            lib.ctr_create.restype = ctypes.c_void_p
            lib.ctr_create.argtypes = [ctypes.c_uint32]
            lib.ctr_destroy.argtypes = [ctypes.c_void_p]
            lib.ctr_shards.restype = ctypes.c_int
            lib.ctr_incr.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                     ctypes.c_int64, ctypes.c_uint32]
            lib.ctr_read.restype = ctypes.c_int64
            lib.ctr_read.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.ctr_snapshot.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def available() -> bool:
    return _get_lib() is not None


class CounterBlock:
    """Named counters over one native block. Writers on any thread are
    wait-free (relaxed fetch_add on a per-thread shard)."""

    def __init__(self, names: Sequence[str]):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native counters library unavailable")
        self._lib = lib
        self._names: List[str] = list(names)
        self._idx: Dict[str, int] = {n: i for i, n in enumerate(self._names)}
        self._h = lib.ctr_create(len(self._names))
        if not self._h:
            raise MemoryError("ctr_create failed")
        self._nshards = lib.ctr_shards()
        self._local = threading.local()

    def _shard(self) -> int:
        s = getattr(self._local, "shard", None)
        if s is None:
            s = threading.get_ident() % self._nshards
            self._local.shard = s
        return s

    def index_of(self, name: str) -> Optional[int]:
        return self._idx.get(name)

    def incr(self, idx: int, n: int = 1) -> None:
        self._lib.ctr_incr(self._h, idx, n, self._shard())

    def read(self, idx: int) -> int:
        return int(self._lib.ctr_read(self._h, idx))

    def snapshot(self) -> Dict[str, int]:
        buf = (ctypes.c_int64 * len(self._names))()
        self._lib.ctr_snapshot(self._h, buf)
        return {n: int(buf[i]) for i, n in enumerate(self._names)}

    def close(self) -> None:
        if self._h:
            self._lib.ctr_destroy(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover - GC path
        try:
            self.close()
        except Exception:
            pass
