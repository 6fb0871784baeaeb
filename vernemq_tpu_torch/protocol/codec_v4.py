"""MQTT 3.1 / 3.1.1 codec: parse and serialise control packets.

Functional equivalent of the reference zero-copy parser
(``apps/vmq_commons/src/vmq_parser.erl``): ``parse(data)`` returns
``(frame, rest)`` or ``(None, data)`` when more bytes are needed, raising
:class:`ParseError` on protocol violations; ``serialise(frame)`` produces the
wire bytes. The same functions double as test-side frame generators (the
reference exposes ``gen_connect``/``gen_publish``/... for its suites).
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import wire
from .types import (
    AUTH,
    CONNACK,
    CONNECT,
    DISCONNECT,
    PINGREQ,
    PINGRESP,
    PROTO_31,
    PROTO_311,
    PUBACK,
    PUBCOMP,
    PUBLISH,
    PUBREC,
    PUBREL,
    SUBACK,
    SUBSCRIBE,
    UNSUBACK,
    UNSUBSCRIBE,
    Connack,
    Connect,
    Disconnect,
    Frame,
    ParseError,
    Pingreq,
    Pingresp,
    Puback,
    Pubcomp,
    Publish,
    Pubrec,
    Pubrel,
    SubOpts,
    Suback,
    Subscribe,
    Unsuback,
    Unsubscribe,
    Will,
)

PROTO_NAMES = {PROTO_31: "MQIsdp", PROTO_311: "MQTT"}

# native wire-codec fast path (native/codec.cc via protocol/fastpath.py):
# accelerates PUBLISH and the 2-byte ack family — the per-frame hot
# shapes — and declines everything else, so this module stays the single
# source of truth for all other frame types and for every
# malformed-input error. None when no toolchain / VMQ_NO_NATIVE.
from .fastpath import FALLBACK as _FALLBACK
from .fastpath import load_native as _load_native
from .fastpath import parse_native as _parse_native

_C = _load_native()


def parse(data: bytes, max_size: int = 0) -> Tuple[Optional[Frame], bytes]:
    if _C is not None:
        res = _parse_native(_C, data, max_size, False)
        if res is not _FALLBACK:
            return res
    split = wire.split_frame(data, max_size)
    if split is None:
        return None, data
    ptype, flags, body, rest = split
    return _parse_body(ptype, flags, body), rest


def _parse_body(ptype: int, flags: int, body: bytes) -> Frame:
    if ptype == PUBLISH:
        return _parse_publish(flags, body)
    if ptype == PUBACK:
        return Puback(packet_id=_packet_id_only(flags, 0, body))
    if ptype == PUBREC:
        return Pubrec(packet_id=_packet_id_only(flags, 0, body))
    if ptype == PUBREL:
        return Pubrel(packet_id=_packet_id_only(flags, 2, body))
    if ptype == PUBCOMP:
        return Pubcomp(packet_id=_packet_id_only(flags, 0, body))
    if ptype == CONNECT:
        return _parse_connect(flags, body)
    if ptype == CONNACK:
        if flags != 0 or len(body) != 2:
            raise ParseError("malformed_connack")
        return Connack(session_present=bool(body[0] & 0x01), rc=body[1])
    if ptype == SUBSCRIBE:
        return _parse_subscribe(flags, body)
    if ptype == SUBACK:
        return _parse_suback(flags, body)
    if ptype == UNSUBSCRIBE:
        return _parse_unsubscribe(flags, body)
    if ptype == UNSUBACK:
        return Unsuback(packet_id=_packet_id_only(flags, 0, body))
    if ptype == PINGREQ:
        _expect_empty(flags, 0, body)
        return Pingreq()
    if ptype == PINGRESP:
        _expect_empty(flags, 0, body)
        return Pingresp()
    if ptype == DISCONNECT:
        _expect_empty(flags, 0, body)
        return Disconnect()
    if ptype == AUTH:
        raise ParseError("auth_not_allowed_in_mqtt_v4")
    raise ParseError("invalid_packet_type")


def _expect_empty(flags: int, want_flags: int, body: bytes) -> None:
    if flags != want_flags or body:
        raise ParseError("malformed_packet")


def _packet_id_only(flags: int, want_flags: int, body: bytes) -> int:
    if flags != want_flags or len(body) != 2:
        raise ParseError("malformed_packet")
    pid, _ = wire.take_u16(body, 0)
    return pid


def _parse_publish(flags: int, body: bytes) -> Publish:
    dup = bool(flags & 0x08)
    qos = (flags >> 1) & 0x03
    retain = bool(flags & 0x01)
    if qos == 3:
        raise ParseError("invalid_qos")
    topic, pos = wire.take_utf8(body, 0)
    packet_id = None
    if qos > 0:
        packet_id, pos = wire.take_u16(body, pos)
        if packet_id == 0:
            raise ParseError("invalid_packet_id")
    return Publish(
        topic=topic, payload=bytes(body[pos:]), qos=qos, retain=retain, dup=dup, packet_id=packet_id
    )


def _parse_connect(flags: int, body: bytes) -> Connect:
    if flags != 0:
        raise ParseError("malformed_connect")
    name, pos = wire.take_utf8(body, 0)
    if pos >= len(body):
        raise ParseError("malformed_connect")
    level = body[pos]
    pos += 1
    base_level = level & 0x7F  # bridge bit (0x80) tolerated like the reference
    if name not in ("MQTT", "MQIsdp") or PROTO_NAMES.get(base_level) != name:
        raise ParseError("unknown_protocol_version")
    if pos >= len(body):
        raise ParseError("malformed_connect")
    cflags = body[pos]
    pos += 1
    if cflags & 0x01:
        raise ParseError("reserved_connect_flag_set")
    keepalive, pos = wire.take_u16(body, pos)
    client_id, pos = wire.take_utf8(body, pos)
    will = None
    if cflags & 0x04:
        will_topic, pos = wire.take_utf8(body, pos)
        will_payload, pos = wire.take_bin(body, pos)
        will = Will(
            topic=will_topic,
            payload=will_payload,
            qos=(cflags >> 3) & 0x03,
            retain=bool(cflags & 0x20),
        )
        if will.qos == 3:
            raise ParseError("invalid_will_qos")
    elif cflags & 0x38:
        raise ParseError("will_flags_without_will")
    username = None
    password = None
    if cflags & 0x80:
        username, pos = wire.take_utf8(body, pos)
    if cflags & 0x40:
        if not cflags & 0x80:
            raise ParseError("password_without_username")
        password, pos = wire.take_bin(body, pos)
    if pos != len(body):
        raise ParseError("trailing_bytes_in_connect")
    return Connect(
        proto_ver=base_level,
        client_id=client_id,
        username=username,
        password=password,
        clean_start=bool(cflags & 0x02),
        keepalive=keepalive,
        will=will,
    )


def _parse_subscribe(flags: int, body: bytes) -> Subscribe:
    if flags != 2:
        raise ParseError("malformed_subscribe")
    pid, pos = wire.take_u16(body, 0)
    if pid == 0:
        raise ParseError("invalid_packet_id")
    topics = []
    while pos < len(body):
        t, pos = wire.take_utf8(body, pos)
        if pos >= len(body):
            raise ParseError("malformed_subscribe")
        qos = body[pos]
        pos += 1
        if qos > 2:
            raise ParseError("invalid_qos")
        topics.append((t, SubOpts(qos=qos)))
    if not topics:
        raise ParseError("empty_subscribe")
    return Subscribe(packet_id=pid, topics=topics)


def _parse_suback(flags: int, body: bytes) -> Suback:
    if flags != 0:
        raise ParseError("malformed_suback")
    pid, pos = wire.take_u16(body, 0)
    codes = list(body[pos:])
    for c in codes:
        if c not in (0, 1, 2, 0x80):
            raise ParseError("invalid_suback_code")
    return Suback(packet_id=pid, reason_codes=codes)


def _parse_unsubscribe(flags: int, body: bytes) -> Unsubscribe:
    if flags != 2:
        raise ParseError("malformed_unsubscribe")
    pid, pos = wire.take_u16(body, 0)
    if pid == 0:
        raise ParseError("invalid_packet_id")
    topics = []
    while pos < len(body):
        t, pos = wire.take_utf8(body, pos)
        topics.append(t)
    if not topics:
        raise ParseError("empty_unsubscribe")
    return Unsubscribe(packet_id=pid, topics=topics)


# ---------------------------------------------------------------------------
# serialise
# ---------------------------------------------------------------------------


def serialise(frame: Frame) -> bytes:
    t = type(frame)
    if t is Publish:
        if frame.qos and not frame.packet_id:
            raise ParseError("missing_packet_id")
        if _C is not None:
            try:
                return _C.serialise_publish(
                    frame.topic, frame.payload, frame.qos,
                    1 if frame.retain else 0, 1 if frame.dup else 0,
                    frame.packet_id if frame.qos else None)
            except ValueError:
                pass  # C refuses (pid range, topic length, frame size):
                # the pure path below raises the CANONICAL error type
        if frame.qos == 0:
            pid = b""
        else:
            pid = frame.packet_id.to_bytes(2, "big")
        flags = (0x08 if frame.dup else 0) | (frame.qos << 1) | (0x01 if frame.retain else 0)
        return wire.fixed_header(PUBLISH, flags, wire.put_utf8(frame.topic) + pid + frame.payload)
    if t is Puback:
        return wire.fixed_header(PUBACK, 0, frame.packet_id.to_bytes(2, "big"))
    if t is Pubrec:
        return wire.fixed_header(PUBREC, 0, frame.packet_id.to_bytes(2, "big"))
    if t is Pubrel:
        return wire.fixed_header(PUBREL, 2, frame.packet_id.to_bytes(2, "big"))
    if t is Pubcomp:
        return wire.fixed_header(PUBCOMP, 0, frame.packet_id.to_bytes(2, "big"))
    if t is Connect:
        return _ser_connect(frame)
    if t is Connack:
        return wire.fixed_header(CONNACK, 0, bytes([1 if frame.session_present else 0, frame.rc]))
    if t is Subscribe:
        body = frame.packet_id.to_bytes(2, "big") + b"".join(
            wire.put_utf8(topic) + bytes([opts.qos]) for topic, opts in frame.topics
        )
        return wire.fixed_header(SUBSCRIBE, 2, body)
    if t is Suback:
        return wire.fixed_header(
            SUBACK, 0, frame.packet_id.to_bytes(2, "big") + bytes(frame.reason_codes)
        )
    if t is Unsubscribe:
        body = frame.packet_id.to_bytes(2, "big") + b"".join(
            wire.put_utf8(topic) for topic in frame.topics
        )
        return wire.fixed_header(UNSUBSCRIBE, 2, body)
    if t is Unsuback:
        return wire.fixed_header(UNSUBACK, 0, frame.packet_id.to_bytes(2, "big"))
    if t is Pingreq:
        return b"\xc0\x00"
    if t is Pingresp:
        return b"\xd0\x00"
    if t is Disconnect:
        return b"\xe0\x00"
    raise ParseError(f"cannot_serialise_{t.__name__}_in_v4")


def _ser_connect(f: Connect) -> bytes:
    name = PROTO_NAMES.get(f.proto_ver & 0x7F)
    if name is None:
        raise ParseError("unknown_protocol_version")
    cflags = 0
    if f.clean_start:
        cflags |= 0x02
    tail = b""
    if f.will is not None:
        cflags |= 0x04 | (f.will.qos << 3) | (0x20 if f.will.retain else 0)
        tail += wire.put_utf8(f.will.topic) + wire.put_bin(f.will.payload)
    if f.username is not None:
        cflags |= 0x80
        tail_user = wire.put_utf8(f.username)
    else:
        tail_user = b""
    if f.password is not None:
        cflags |= 0x40
        tail_pass = wire.put_bin(f.password)
    else:
        tail_pass = b""
    body = (
        wire.put_utf8(name)
        + bytes([f.proto_ver])
        + bytes([cflags])
        + f.keepalive.to_bytes(2, "big")
        + wire.put_utf8(f.client_id)
        + tail
        + tail_user
        + tail_pass
    )
    return wire.fixed_header(CONNECT, 0, body)
