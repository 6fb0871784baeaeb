"""HAProxy PROXY protocol v1/v2 (``vmq_ranch_proxy_protocol.erl``).

A load balancer in front of the broker prepends one header carrying the
real client address (and, for v2 with TLS, the client-cert common name via
the PP2_SUBTYPE_SSL_CN TLV) before the MQTT byte stream starts. The
listener reads it, rewrites the peer, and can use the CN as the
authenticated username (``vmq_ranch.erl:59-72`` CN-as-username support).
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

V2_SIG = b"\r\n\r\n\x00\r\nQUIT\n"

# v2 TLV types (PP2)
PP2_TYPE_SSL = 0x20
PP2_SUBTYPE_SSL_CN = 0x22


class ProxyProtoError(Exception):
    pass


@dataclass
class ProxyInfo:
    src: Optional[Tuple[str, int]]  # real client address; None for LOCAL
    dst: Optional[Tuple[str, int]]
    cn: Optional[str] = None  # client-cert common name (v2 SSL TLV)


async def read_proxy_header(reader: asyncio.StreamReader) -> ProxyInfo:
    """Consume exactly one PROXY header from the stream; the MQTT bytes
    start right after (no buffered overshoot — reads are exact-length)."""
    probe = await reader.readexactly(1)
    if probe == b"P":
        line = probe + await reader.readuntil(b"\r\n")
        return _parse_v1(line)
    if probe == b"\r":
        rest = await reader.readexactly(len(V2_SIG) - 1)
        if probe + rest != V2_SIG:
            raise ProxyProtoError("bad v2 signature")
        return await _parse_v2(reader)
    raise ProxyProtoError("not a PROXY header")


def _parse_v1(line: bytes) -> ProxyInfo:
    if len(line) > 107:
        raise ProxyProtoError("v1 header too long")
    parts = line.decode("ascii", "replace").rstrip("\r\n").split(" ")
    if parts[0] != "PROXY":
        raise ProxyProtoError("bad v1 magic")
    if len(parts) >= 2 and parts[1] == "UNKNOWN":
        return ProxyInfo(src=None, dst=None)
    if len(parts) != 6 or parts[1] not in ("TCP4", "TCP6"):
        raise ProxyProtoError("bad v1 fields")
    try:
        return ProxyInfo(src=(parts[2], int(parts[4])),
                         dst=(parts[3], int(parts[5])))
    except ValueError as e:
        raise ProxyProtoError(f"bad v1 ports: {e}") from None


async def _parse_v2(reader: asyncio.StreamReader) -> ProxyInfo:
    hdr = await reader.readexactly(4)
    ver_cmd, fam, length = hdr[0], hdr[1], struct.unpack(">H", hdr[2:4])[0]
    if ver_cmd >> 4 != 2:
        raise ProxyProtoError("bad v2 version")
    body = await reader.readexactly(length) if length else b""
    cmd = ver_cmd & 0x0F
    if cmd == 0x00:  # LOCAL (health check): no address override
        return ProxyInfo(src=None, dst=None)
    if cmd != 0x01:
        raise ProxyProtoError("bad v2 command")
    import socket

    src = dst = None
    off = 0
    proto = fam >> 4
    if proto == 0x1:  # AF_INET
        if length < 12:
            raise ProxyProtoError("short v2 inet body")
        s, d, sp, dp = struct.unpack(">4s4sHH", body[:12])
        src = (socket.inet_ntop(socket.AF_INET, s), sp)
        dst = (socket.inet_ntop(socket.AF_INET, d), dp)
        off = 12
    elif proto == 0x2:  # AF_INET6
        if length < 36:
            raise ProxyProtoError("short v2 inet6 body")
        s, d, sp, dp = struct.unpack(">16s16sHH", body[:36])
        src = (socket.inet_ntop(socket.AF_INET6, s), sp)
        dst = (socket.inet_ntop(socket.AF_INET6, d), dp)
        off = 36
    else:  # AF_UNSPEC / AF_UNIX: ignore addresses
        return ProxyInfo(src=None, dst=None)
    cn = _find_cn(body[off:])
    return ProxyInfo(src=src, dst=dst, cn=cn)


def _find_cn(tlvs: bytes) -> Optional[str]:
    """Walk v2 TLVs for the SSL sub-TLV carrying the client-cert CN."""
    i = 0
    while i + 3 <= len(tlvs):
        t = tlvs[i]
        ln = struct.unpack(">H", tlvs[i + 1:i + 3])[0]
        v = tlvs[i + 3:i + 3 + ln]
        if t == PP2_TYPE_SSL and len(v) >= 5:
            # client(1) verify(4) then sub-TLVs
            j = 5
            while j + 3 <= len(v):
                st = v[j]
                sln = struct.unpack(">H", v[j + 1:j + 3])[0]
                if st == PP2_SUBTYPE_SSL_CN:
                    return v[j + 3:j + 3 + sln].decode("utf-8", "replace")
                j += 3 + sln
        i += 3 + ln
    return None


def build_v1(src: Tuple[str, int], dst: Tuple[str, int]) -> bytes:
    fam = "TCP6" if ":" in src[0] else "TCP4"
    return (f"PROXY {fam} {src[0]} {dst[0]} {src[1]} {dst[1]}\r\n"
            .encode("ascii"))


def build_v2(src: Tuple[str, int], dst: Tuple[str, int],
             cn: Optional[str] = None) -> bytes:
    import socket

    body = (socket.inet_pton(socket.AF_INET, src[0])
            + socket.inet_pton(socket.AF_INET, dst[0])
            + struct.pack(">HH", src[1], dst[1]))
    if cn is not None:
        cn_b = cn.encode()
        sub = bytes([PP2_SUBTYPE_SSL_CN]) + struct.pack(">H", len(cn_b)) + cn_b
        ssl_v = b"\x01" + b"\x00\x00\x00\x00" + sub
        body += bytes([PP2_TYPE_SSL]) + struct.pack(">H", len(ssl_v)) + ssl_v
    return V2_SIG + b"\x21\x11" + struct.pack(">H", len(body)) + body
