"""MQTT 5.0 codec: full control-packet set including properties, reason
codes, subscription options, and AUTH.

Functional equivalent of ``apps/vmq_commons/src/vmq_parser_mqtt5.erl`` (~30
properties parsed into a map, reason-code validation per packet); properties
here are a plain dict keyed by spec name (see PROPS table), with
``user_property`` accumulated as a list of pairs and ``subscription_identifier``
as a list of ints.
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
    PROTO_5,
    PUBACK,
    PUBCOMP,
    PUBLISH,
    PUBREC,
    PUBREL,
    SUBACK,
    SUBSCRIBE,
    UNSUBACK,
    UNSUBSCRIBE,
    Auth,
    Connack,
    Connect,
    Disconnect,
    Frame,
    ParseError,
    Pingreq,
    Pingresp,
    Properties,
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

# property id -> (name, type); types: byte,u16,u32,varint,utf8,bin,pair
PROPS = {
    1: ("payload_format_indicator", "byte"),
    2: ("message_expiry_interval", "u32"),
    3: ("content_type", "utf8"),
    8: ("response_topic", "utf8"),
    9: ("correlation_data", "bin"),
    11: ("subscription_identifier", "varint"),
    17: ("session_expiry_interval", "u32"),
    18: ("assigned_client_identifier", "utf8"),
    19: ("server_keep_alive", "u16"),
    21: ("authentication_method", "utf8"),
    22: ("authentication_data", "bin"),
    23: ("request_problem_information", "byte"),
    24: ("will_delay_interval", "u32"),
    25: ("request_response_information", "byte"),
    26: ("response_information", "utf8"),
    28: ("server_reference", "utf8"),
    31: ("reason_string", "utf8"),
    33: ("receive_maximum", "u16"),
    34: ("topic_alias_maximum", "u16"),
    35: ("topic_alias", "u16"),
    36: ("maximum_qos", "byte"),
    37: ("retain_available", "byte"),
    38: ("user_property", "pair"),
    39: ("maximum_packet_size", "u32"),
    40: ("wildcard_subscription_available", "byte"),
    41: ("subscription_identifier_available", "byte"),
    42: ("shared_subscription_available", "byte"),
}
PROP_IDS = {name: (pid, typ) for pid, (name, typ) in PROPS.items()}
_MULTI = {"user_property", "subscription_identifier"}


def parse_properties(body: bytes, pos: int) -> Tuple[Properties, int]:
    try:
        plen, pos = wire.decode_varint(body, pos)
    except IndexError:
        raise ParseError("malformed_properties") from None
    end = pos + plen
    if end > len(body):
        raise ParseError("malformed_properties")
    props: Properties = {}
    while pos < end:
        try:
            pid, pos = wire.decode_varint(body, pos)
        except IndexError:
            raise ParseError("malformed_properties") from None
        spec = PROPS.get(pid)
        if spec is None:
            raise ParseError("malformed_packet_unknown_property")
        name, typ = spec
        if typ == "byte":
            if pos >= end:
                raise ParseError("malformed_properties")
            val = body[pos]
            pos += 1
        elif typ == "u16":
            val, pos = wire.take_u16(body, pos)
        elif typ == "u32":
            val, pos = wire.take_u32(body, pos)
        elif typ == "varint":
            try:
                val, pos = wire.decode_varint(body, pos)
            except IndexError:
                raise ParseError("malformed_properties") from None
        elif typ == "utf8":
            val, pos = wire.take_utf8(body, pos)
        elif typ == "bin":
            val, pos = wire.take_bin(body, pos)
        else:  # pair
            k, pos = wire.take_utf8(body, pos)
            v, pos = wire.take_utf8(body, pos)
            val = (k, v)
        if pos > end:
            raise ParseError("malformed_properties")
        if name in _MULTI:
            props.setdefault(name, []).append(val)
        elif name in props:
            raise ParseError("duplicate_property")
        else:
            props[name] = val
    return props, pos


# Valid v5 reason-code sets per ack packet (vmq_types_mqtt5.hrl reason table)
SUBACK_CODES = frozenset([0, 1, 2, 0x80, 0x83, 0x87, 0x8F, 0x91, 0x97, 0x9E, 0xA1, 0xA2])
UNSUBACK_CODES = frozenset([0x00, 0x11, 0x80, 0x83, 0x87, 0x8F, 0x91])


def serialise_properties(props: Properties) -> bytes:
    out = bytearray()
    for name, val in props.items():
        try:
            pid, typ = PROP_IDS[name]
        except KeyError:
            raise ParseError(f"unknown_property_{name}") from None
        vals = val if name in _MULTI else [val]
        for v in vals:
            out += wire.encode_varint(pid)
            if typ == "byte":
                out.append(int(v) & 0xFF)
            elif typ == "u16":
                out += int(v).to_bytes(2, "big")
            elif typ == "u32":
                out += int(v).to_bytes(4, "big")
            elif typ == "varint":
                out += wire.encode_varint(int(v))
            elif typ == "utf8":
                out += wire.put_utf8(v)
            elif typ == "bin":
                out += wire.put_bin(v)
            else:  # pair
                out += wire.put_utf8(v[0]) + wire.put_utf8(v[1])
    return wire.encode_varint(len(out)) + bytes(out)


# native fast path for the v5 hot shapes (shared dispatch in
# protocol/fastpath.py): PUBLISH with an EMPTY property block and 2-byte
# (rc=0) acks; everything else — properties, reason codes, all other
# frame types, every malformed-input error — stays on this module's
# pure-Python parser
from .fastpath import ACK_CTORS as _ACK_CTORS
from .fastpath import FALLBACK as _FALLBACK
from .fastpath import load_native as _load_native
from .fastpath import parse_native as _parse_native

_C = _load_native()


def parse(data: bytes, max_size: int = 0) -> Tuple[Optional[Frame], bytes]:
    if _C is not None:
        res = _parse_native(_C, data, max_size, True)
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
    if ptype in (PUBACK, PUBREC, PUBREL, PUBCOMP):
        want = 2 if ptype == PUBREL else 0
        if flags != want:
            raise ParseError("malformed_packet")
        cls = _ACK_CTORS[ptype]
        pid, pos = wire.take_u16(body, 0)
        if pid == 0:
            raise ParseError("invalid_packet_id")
        if len(body) == 2:
            return cls(packet_id=pid)
        rc = body[pos]
        pos += 1
        props: Properties = {}
        if pos < len(body):
            props, pos = parse_properties(body, pos)
        return cls(packet_id=pid, reason_code=rc, properties=props)
    if ptype == CONNECT:
        return _parse_connect(flags, body)
    if ptype == CONNACK:
        if flags != 0 or len(body) < 2:
            raise ParseError("malformed_connack")
        props, pos = parse_properties(body, 2)
        if pos != len(body):
            raise ParseError("trailing_bytes_in_connack")
        return Connack(session_present=bool(body[0] & 0x01), rc=body[1], properties=props)
    if ptype == SUBSCRIBE:
        if flags != 2:
            raise ParseError("malformed_subscribe")
        pid, pos = wire.take_u16(body, 0)
        if pid == 0:
            raise ParseError("invalid_packet_id")
        props, pos = parse_properties(body, pos)
        topics = []
        while pos < len(body):
            t, pos = wire.take_utf8(body, pos)
            if pos >= len(body):
                raise ParseError("malformed_subscribe")
            topics.append((t, SubOpts.from_byte(body[pos])))
            pos += 1
        if not topics:
            raise ParseError("empty_subscribe")
        return Subscribe(packet_id=pid, topics=topics, properties=props)
    if ptype == SUBACK:
        if flags != 0:
            raise ParseError("malformed_suback")
        pid, pos = wire.take_u16(body, 0)
        props, pos = parse_properties(body, pos)
        codes = list(body[pos:])
        if any(c not in SUBACK_CODES for c in codes):
            raise ParseError("invalid_suback_code")
        return Suback(packet_id=pid, reason_codes=codes, properties=props)
    if ptype == UNSUBSCRIBE:
        if flags != 2:
            raise ParseError("malformed_unsubscribe")
        pid, pos = wire.take_u16(body, 0)
        if pid == 0:
            raise ParseError("invalid_packet_id")
        props, pos = parse_properties(body, pos)
        topics = []
        while pos < len(body):
            t, pos = wire.take_utf8(body, pos)
            topics.append(t)
        if not topics:
            raise ParseError("empty_unsubscribe")
        return Unsubscribe(packet_id=pid, topics=topics, properties=props)
    if ptype == UNSUBACK:
        if flags != 0:
            raise ParseError("malformed_unsuback")
        pid, pos = wire.take_u16(body, 0)
        props, pos = parse_properties(body, pos)
        codes = list(body[pos:])
        if any(c not in UNSUBACK_CODES for c in codes):
            raise ParseError("invalid_unsuback_code")
        return Unsuback(packet_id=pid, reason_codes=codes, properties=props)
    if ptype == PINGREQ:
        _expect_empty(flags, body)
        return Pingreq()
    if ptype == PINGRESP:
        _expect_empty(flags, body)
        return Pingresp()
    if ptype == DISCONNECT:
        if flags != 0:
            raise ParseError("malformed_disconnect")
        if not body:
            return Disconnect()
        rc = body[0]
        props = {}
        if len(body) > 1:
            props, pos = parse_properties(body, 1)
            if pos != len(body):
                raise ParseError("trailing_bytes_in_disconnect")
        return Disconnect(reason_code=rc, properties=props)
    if ptype == AUTH:
        if flags != 0:
            raise ParseError("malformed_auth")
        if not body:
            return Auth()
        rc = body[0]
        props = {}
        if len(body) > 1:
            props, pos = parse_properties(body, 1)
            if pos != len(body):
                raise ParseError("trailing_bytes_in_auth")
        return Auth(reason_code=rc, properties=props)
    raise ParseError("invalid_packet_type")


def _expect_empty(flags: int, body: bytes) -> None:
    if flags != 0 or body:
        raise ParseError("malformed_packet")


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
    props, pos = parse_properties(body, pos)
    return Publish(
        topic=topic,
        payload=bytes(body[pos:]),
        qos=qos,
        retain=retain,
        dup=dup,
        packet_id=packet_id,
        properties=props,
    )


def _parse_connect(flags: int, body: bytes) -> Connect:
    if flags != 0:
        raise ParseError("malformed_connect")
    name, pos = wire.take_utf8(body, 0)
    if pos >= len(body):
        raise ParseError("malformed_connect")
    level = body[pos]
    pos += 1
    if name != "MQTT" or level != PROTO_5:
        raise ParseError("unknown_protocol_version")
    if pos >= len(body):
        raise ParseError("malformed_connect")
    cflags = body[pos]
    pos += 1
    if cflags & 0x01:
        raise ParseError("reserved_connect_flag_set")
    keepalive, pos = wire.take_u16(body, pos)
    props, pos = parse_properties(body, pos)
    client_id, pos = wire.take_utf8(body, pos)
    will = None
    if cflags & 0x04:
        wprops, pos = parse_properties(body, pos)
        wtopic, pos = wire.take_utf8(body, pos)
        wpayload, pos = wire.take_bin(body, pos)
        will = Will(
            topic=wtopic,
            payload=wpayload,
            qos=(cflags >> 3) & 0x03,
            retain=bool(cflags & 0x20),
            properties=wprops,
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
        password, pos = wire.take_bin(body, pos)
    if pos != len(body):
        raise ParseError("trailing_bytes_in_connect")
    return Connect(
        proto_ver=PROTO_5,
        client_id=client_id,
        username=username,
        password=password,
        clean_start=bool(cflags & 0x02),
        keepalive=keepalive,
        will=will,
        properties=props,
    )


# ---------------------------------------------------------------------------
# serialise
# ---------------------------------------------------------------------------


def serialise(frame: Frame) -> bytes:
    t = type(frame)
    if t is Publish:
        if frame.qos and not frame.packet_id:
            raise ParseError("missing_packet_id")
        if _C is not None and not frame.properties:
            try:
                return _C.serialise_publish(
                    frame.topic, frame.payload, frame.qos,
                    1 if frame.retain else 0, 1 if frame.dup else 0,
                    frame.packet_id if frame.qos else None, True)
            except ValueError:
                pass  # C refuses: the pure path raises the canonical error
        if frame.qos == 0:
            pid = b""
        else:
            pid = frame.packet_id.to_bytes(2, "big")
        flags = (0x08 if frame.dup else 0) | (frame.qos << 1) | (0x01 if frame.retain else 0)
        body = (
            wire.put_utf8(frame.topic)
            + pid
            + serialise_properties(frame.properties)
            + frame.payload
        )
        return wire.fixed_header(PUBLISH, flags, body)
    if t in (Puback, Pubrec, Pubrel, Pubcomp):
        ptype = {Puback: PUBACK, Pubrec: PUBREC, Pubrel: PUBREL, Pubcomp: PUBCOMP}[t]
        flags = 2 if t is Pubrel else 0
        if frame.reason_code == 0 and not frame.properties:
            return wire.fixed_header(ptype, flags, frame.packet_id.to_bytes(2, "big"))
        body = (
            frame.packet_id.to_bytes(2, "big")
            + bytes([frame.reason_code])
            + serialise_properties(frame.properties)
        )
        return wire.fixed_header(ptype, flags, body)
    if t is Connect:
        return _ser_connect(frame)
    if t is Connack:
        body = (
            bytes([1 if frame.session_present else 0, frame.rc])
            + serialise_properties(frame.properties)
        )
        return wire.fixed_header(CONNACK, 0, body)
    if t is Subscribe:
        body = (
            frame.packet_id.to_bytes(2, "big")
            + serialise_properties(frame.properties)
            + b"".join(wire.put_utf8(tp) + bytes([o.to_byte()]) for tp, o in frame.topics)
        )
        return wire.fixed_header(SUBSCRIBE, 2, body)
    if t is Suback:
        body = (
            frame.packet_id.to_bytes(2, "big")
            + serialise_properties(frame.properties)
            + bytes(frame.reason_codes)
        )
        return wire.fixed_header(SUBACK, 0, body)
    if t is Unsubscribe:
        body = (
            frame.packet_id.to_bytes(2, "big")
            + serialise_properties(frame.properties)
            + b"".join(wire.put_utf8(tp) for tp in frame.topics)
        )
        return wire.fixed_header(UNSUBSCRIBE, 2, body)
    if t is Unsuback:
        body = (
            frame.packet_id.to_bytes(2, "big")
            + serialise_properties(frame.properties)
            + bytes(frame.reason_codes)
        )
        return wire.fixed_header(UNSUBACK, 0, body)
    if t is Pingreq:
        return b"\xc0\x00"
    if t is Pingresp:
        return b"\xd0\x00"
    if t is Disconnect:
        if frame.reason_code == 0 and not frame.properties:
            return b"\xe0\x00"
        body = bytes([frame.reason_code]) + serialise_properties(frame.properties)
        return wire.fixed_header(DISCONNECT, 0, body)
    if t is Auth:
        if frame.reason_code == 0 and not frame.properties:
            return b"\xf0\x00"
        body = bytes([frame.reason_code]) + serialise_properties(frame.properties)
        return wire.fixed_header(AUTH, 0, body)
    raise ParseError(f"cannot_serialise_{t.__name__}_in_v5")


def _ser_connect(f: Connect) -> bytes:
    cflags = 0
    if f.clean_start:
        cflags |= 0x02
    tail = b""
    if f.will is not None:
        cflags |= 0x04 | (f.will.qos << 3) | (0x20 if f.will.retain else 0)
        tail += (
            serialise_properties(f.will.properties)
            + wire.put_utf8(f.will.topic)
            + wire.put_bin(f.will.payload)
        )
    if f.username is not None:
        cflags |= 0x80
        tail += wire.put_utf8(f.username)
    if f.password is not None:
        cflags |= 0x40
        tail += wire.put_bin(f.password)
    body = (
        wire.put_utf8("MQTT")
        + bytes([PROTO_5])
        + bytes([cflags])
        + f.keepalive.to_bytes(2, "big")
        + serialise_properties(f.properties)
        + wire.put_utf8(f.client_id)
        + tail
    )
    return wire.fixed_header(CONNECT, 0, body)
