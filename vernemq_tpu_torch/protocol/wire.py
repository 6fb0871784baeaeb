"""Low-level MQTT wire primitives shared by both codecs: variable-length
integers, length-prefixed strings/binaries, fixed-header assembly.

Equivalent to the binary pattern-match helpers in the reference parsers
(``vmq_parser.erl`` remaining-length loop, ``vmq_parser_mqtt5.erl`` varint/
utf8 helpers) — implemented as explicit cursor functions since Python lacks
binary pattern matching.
"""

from __future__ import annotations

import struct
from typing import Tuple

from .types import ParseError

MAX_VARINT = 268435455  # 0xFFFFFF7F encoded — 4 varint bytes max


def encode_varint(n: int) -> bytes:
    if n < 0 or n > MAX_VARINT:
        raise ParseError("varint_out_of_range")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Returns (value, new_pos). Raises IndexError when buffer is short
    (caller treats as incomplete) and ParseError on >4-byte encodings."""
    mult = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << mult
        if not b & 0x80:
            return val, pos
        mult += 7
        if mult > 21:
            raise ParseError("invalid_varint")


def take_u16(buf: bytes, pos: int) -> Tuple[int, int]:
    if pos + 2 > len(buf):
        raise ParseError("incomplete_u16")
    return struct.unpack_from(">H", buf, pos)[0], pos + 2


def take_u32(buf: bytes, pos: int) -> Tuple[int, int]:
    if pos + 4 > len(buf):
        raise ParseError("incomplete_u32")
    return struct.unpack_from(">I", buf, pos)[0], pos + 4


def take_bin(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = take_u16(buf, pos)
    if pos + n > len(buf):
        raise ParseError("incomplete_binary")
    return bytes(buf[pos : pos + n]), pos + n


def take_utf8(buf: bytes, pos: int) -> Tuple[str, int]:
    raw, pos = take_bin(buf, pos)
    try:
        s = raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ParseError("invalid_utf8") from e
    if "\x00" in s:
        raise ParseError("no_null_allowed")
    return s, pos


def put_bin(b: bytes) -> bytes:
    if len(b) > 0xFFFF:
        raise ParseError("binary_too_long")
    return struct.pack(">H", len(b)) + b


def put_utf8(s: str) -> bytes:
    return put_bin(s.encode("utf-8"))


def fixed_header(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | (flags & 0x0F)]) + encode_varint(len(body)) + body


def split_frame(data, max_size: int = 0):
    """Split one frame off ``data``.

    Returns ``(ptype, flags, body, rest)`` or ``None`` when more bytes are
    needed (the reference parser returns ``more``, vmq_parser.erl:parse/1).
    Raises ParseError for oversized frames (``max_size`` 0 = unlimited).

    Pass a ``memoryview`` to get a zero-copy ``rest`` (O(1) slice) — the
    socket loop parses many pipelined frames off one buffer and must not pay
    O(n) per frame re-copying the tail; only ``body`` is materialised.
    """
    if len(data) < 2:
        return None
    b0 = data[0]
    try:
        length, pos = decode_varint(data, 1)
    except IndexError:
        return None
    if max_size and length > max_size:
        raise ParseError("frame_too_large")
    if len(data) < pos + length:
        return None
    return b0 >> 4, b0 & 0x0F, bytes(data[pos : pos + length]), data[pos + length :]
