"""Self-describing binary term codec for the cluster channel.

The reference ships Erlang external term format over its cluster sockets
(``term_to_binary`` at ``vmq_cluster_node.erl:149-180``, decoded at
``vmq_cluster_com.erl:131-160``). This is the equivalent: a compact
tagged binary encoding for the Python value shapes the cluster planes
exchange (frames, metadata entries, messages). Deliberately NOT pickle —
decoding attacker-controlled pickle executes code; this codec can only
produce plain data.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

_T_NONE = 0
_T_TRUE = 1
_T_FALSE = 2
_T_INT = 3       # signed 64-bit
_T_BIGINT = 4    # length-prefixed decimal string (rare)
_T_FLOAT = 5
_T_STR = 6
_T_BYTES = 7
_T_LIST = 8
_T_TUPLE = 9
_T_DICT = 10


def _pack_len(n: int) -> bytes:
    return struct.pack(">I", n)


def encode(obj: Any, out: bytearray = None) -> bytes:
    top = out is None
    if out is None:
        out = bytearray()
    if obj is None:
        out.append(_T_NONE)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif isinstance(obj, int):
        if -(1 << 63) <= obj < (1 << 63):
            out.append(_T_INT)
            out += struct.pack(">q", obj)
        else:
            s = str(obj).encode()
            out.append(_T_BIGINT)
            out += _pack_len(len(s)) + s
    elif isinstance(obj, float):
        out.append(_T_FLOAT)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_T_STR)
        out += _pack_len(len(b)) + b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_T_BYTES)
        out += _pack_len(len(b)) + b
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST if isinstance(obj, list) else _T_TUPLE)
        out += _pack_len(len(obj))
        for item in obj:
            encode(item, out)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        out += _pack_len(len(obj))
        for k, v in obj.items():
            encode(k, out)
            encode(v, out)
    else:
        raise TypeError(f"cluster codec can't encode {type(obj).__name__}")
    return bytes(out) if top else b""


class DecodeError(ValueError):
    pass


def _decode(buf: memoryview, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise DecodeError("truncated")
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT:
        return struct.unpack_from(">q", buf, pos)[0], pos + 8
    if tag == _T_FLOAT:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if tag in (_T_STR, _T_BYTES, _T_BIGINT):
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        if pos + n > len(buf):
            raise DecodeError("truncated payload")
        raw = bytes(buf[pos:pos + n])
        pos += n
        if tag == _T_BYTES:
            return raw, pos
        if tag == _T_STR:
            return raw.decode("utf-8"), pos
        return int(raw), pos
    if tag in (_T_LIST, _T_TUPLE, _T_DICT):
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        if n > len(buf):  # cheap bound: each element is ≥1 byte
            raise DecodeError("implausible collection size")
        if tag == _T_DICT:
            d = {}
            for _ in range(n):
                k, pos = _decode(buf, pos)
                v, pos = _decode(buf, pos)
                d[k] = v
            return d, pos
        items = []
        for _ in range(n):
            item, pos = _decode(buf, pos)
            items.append(item)
        return (items if tag == _T_LIST else tuple(items)), pos
    raise DecodeError(f"unknown tag {tag}")


def decode(data: bytes) -> Any:
    value, pos = _decode(memoryview(data), 0)
    if pos != len(data):
        raise DecodeError("trailing bytes")
    return value


def enkey(key: Any) -> Any:
    """Tuple→list for wire shapes that must not rely on tuple keys."""
    if isinstance(key, tuple):
        return [enkey(k) for k in key]
    return key


def dekey(key: Any) -> Any:
    """Restore tuple-ness of keys that traveled as lists (dict lookups in
    the metadata stores are tuple-keyed)."""
    if isinstance(key, list):
        return tuple(dekey(k) for k in key)
    return key
