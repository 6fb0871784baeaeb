"""ctypes binding for the C++ bcrypt engine (``native/bcrypt.cc``) — the
``vmq_diversity`` bcrypt dependency's seat (``vmq_diversity_bcrypt.erl``,
erlang-bcrypt C port). No pure-Python fallback: bcrypt's cost model only
makes sense at native speed; callers gate on :func:`available`.
"""

from __future__ import annotations

import ctypes
import hmac
import os
from typing import Optional

from . import load_library

_lib = None
_loaded = False


def _get():
    global _lib, _loaded
    if not _loaded:
        _loaded = True
        lib = load_library("libvmq_bcrypt.so")
        if lib is not None:
            lib.vmq_bcrypt_hash.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                            ctypes.c_char_p]
            lib.vmq_bcrypt_hash.restype = ctypes.c_int
            lib.vmq_bcrypt_gensalt.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                               ctypes.c_char_p]
            lib.vmq_bcrypt_gensalt.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    return _get() is not None


def gensalt(cost: int = 12, rand16: Optional[bytes] = None) -> str:
    lib = _get()
    if lib is None:
        raise RuntimeError("native bcrypt unavailable")
    rand16 = rand16 if rand16 is not None else os.urandom(16)
    if len(rand16) != 16:
        raise ValueError("salt entropy must be 16 bytes")
    out = ctypes.create_string_buffer(32)
    if lib.vmq_bcrypt_gensalt(cost, rand16, out) != 0:
        raise ValueError(f"bad bcrypt cost {cost}")
    return out.value.decode()


def hashpw(password: str, salt: Optional[str] = None, cost: int = 12) -> str:
    """Hash ``password``; ``salt`` may be a $2b$ salt or a full hash
    (rehash-with-same-salt, the crypt(3) convention)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native bcrypt unavailable")
    out = ctypes.create_string_buffer(64)
    s = salt if salt is not None else gensalt(cost)
    rc = lib.vmq_bcrypt_hash(password.encode("utf-8", "surrogateescape"),
                             s.encode(), out)
    if rc != 0:
        raise ValueError("malformed bcrypt salt/hash")
    return out.value.decode()


def checkpw(password: str, hashed: str) -> bool:
    try:
        return hmac.compare_digest(hashpw(password, hashed), hashed)
    except (ValueError, RuntimeError):
        return False
