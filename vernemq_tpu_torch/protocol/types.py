"""Wire-level MQTT frame types shared by the v4 (3.1/3.1.1) and v5 codecs.

Mirrors the frame records of the reference parsers
(``apps/vmq_commons/src/vmq_parser.erl`` / ``vmq_parser_mqtt5.erl`` with
``vmq_types_mqtt.hrl`` / ``vmq_types_mqtt5.hrl``): one dataclass per control
packet, with v5-only fields (properties, reason codes) defaulted so the same
session code can handle both protocol levels. Topics are kept as raw wire
strings here; word-list validation happens in the session layer via
:mod:`vernemq_tpu.protocol.topic`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Control packet types (MQTT fixed header, high nibble)
CONNECT = 1
CONNACK = 2
PUBLISH = 3
PUBACK = 4
PUBREC = 5
PUBREL = 6
PUBCOMP = 7
SUBSCRIBE = 8
SUBACK = 9
UNSUBSCRIBE = 10
UNSUBACK = 11
PINGREQ = 12
PINGRESP = 13
DISCONNECT = 14
AUTH = 15  # v5 only

PROTO_31 = 3
PROTO_311 = 4
PROTO_5 = 5
# Bridge variants set bit 7 of the protocol level (vmq_parser.erl CONNECT
# handling accepts 131/132 for bridges).
PROTO_BRIDGE_MASK = 0x80

# v4 CONNACK return codes (vmq_types_mqtt.hrl)
CONNACK_ACCEPT = 0
CONNACK_PROTO_VER = 1
CONNACK_INVALID_ID = 2
CONNACK_SERVER = 3
CONNACK_CREDENTIALS = 4
CONNACK_AUTH = 5

# Common v5 reason codes (vmq_types_mqtt5.hrl has the full table)
RC_SUCCESS = 0x00
RC_NORMAL_DISCONNECT = 0x00
RC_GRANTED_QOS0 = 0x00
RC_GRANTED_QOS1 = 0x01
RC_GRANTED_QOS2 = 0x02
RC_DISCONNECT_WITH_WILL = 0x04
RC_NO_MATCHING_SUBSCRIBERS = 0x10
RC_NO_SUBSCRIPTION_EXISTED = 0x11
RC_CONTINUE_AUTHENTICATION = 0x18
RC_REAUTHENTICATE = 0x19
RC_UNSPECIFIED_ERROR = 0x80
RC_MALFORMED_PACKET = 0x81
RC_PROTOCOL_ERROR = 0x82
RC_IMPL_SPECIFIC_ERROR = 0x83
RC_UNSUPPORTED_PROTOCOL_VERSION = 0x84
RC_CLIENT_IDENTIFIER_NOT_VALID = 0x85
RC_BAD_USERNAME_OR_PASSWORD = 0x86
RC_NOT_AUTHORIZED = 0x87
RC_SERVER_UNAVAILABLE = 0x88
RC_SERVER_BUSY = 0x89
RC_BANNED = 0x8A
RC_SERVER_SHUTTING_DOWN = 0x8B
RC_BAD_AUTHENTICATION_METHOD = 0x8C
RC_KEEP_ALIVE_TIMEOUT = 0x8D
RC_SESSION_TAKEN_OVER = 0x8E
RC_TOPIC_FILTER_INVALID = 0x8F
RC_TOPIC_NAME_INVALID = 0x90
RC_PACKET_ID_IN_USE = 0x91
RC_PACKET_ID_NOT_FOUND = 0x92
RC_RECEIVE_MAX_EXCEEDED = 0x93
RC_TOPIC_ALIAS_INVALID = 0x94
RC_PACKET_TOO_LARGE = 0x95
RC_MESSAGE_RATE_TOO_HIGH = 0x96
RC_QUOTA_EXCEEDED = 0x97
RC_ADMINISTRATIVE_ACTION = 0x98
RC_PAYLOAD_FORMAT_INVALID = 0x99
RC_RETAIN_NOT_SUPPORTED = 0x9A
RC_QOS_NOT_SUPPORTED = 0x9B
RC_USE_ANOTHER_SERVER = 0x9C
RC_SERVER_MOVED = 0x9D
RC_SHARED_SUBS_NOT_SUPPORTED = 0x9E
RC_CONNECTION_RATE_EXCEEDED = 0x9F
RC_MAX_CONNECT_TIME = 0xA0
RC_SUBSCRIPTION_IDS_NOT_SUPPORTED = 0xA1
RC_WILDCARD_SUBS_NOT_SUPPORTED = 0xA2

# textual reason names for metric labels (the reference's rcn_to_str,
# vmq_metrics.erl:727-729 — atom names of vmq_types_mqtt5.hrl). 0x00 is
# context-dependent (success vs normal_disconnect); callers of
# reason_name pick via the `zero` argument.
_RC_NAMES = {
    0x01: "granted_qos1", 0x02: "granted_qos2",
    0x04: "disconnect_with_will_msg", 0x10: "no_matching_subscribers",
    0x11: "no_subscription_existed", 0x18: "continue_authentication",
    0x19: "reauthenticate", 0x80: "unspecified_error",
    0x81: "malformed_packet", 0x82: "protocol_error",
    0x83: "impl_specific_error", 0x84: "unsupported_protocol_version",
    0x85: "client_identifier_not_valid", 0x86: "bad_username_or_password",
    0x87: "not_authorized", 0x88: "server_unavailable",
    0x89: "server_busy", 0x8A: "banned", 0x8B: "server_shutting_down",
    0x8C: "bad_authentication_method", 0x8D: "keep_alive_timeout",
    0x8E: "session_taken_over", 0x8F: "topic_filter_invalid",
    0x90: "topic_name_invalid", 0x91: "packet_id_in_use",
    0x92: "packet_id_not_found", 0x93: "receive_max_exceeded",
    0x94: "topic_alias_invalid", 0x95: "packet_too_large",
    0x96: "message_rate_too_high", 0x97: "quota_exceeded",
    0x98: "administrative_action", 0x99: "payload_format_invalid",
    0x9A: "retain_not_supported", 0x9B: "qos_not_supported",
    0x9C: "use_another_server", 0x9D: "server_moved",
    0x9E: "shared_subs_not_supported", 0x9F: "connection_rate_exceeded",
    0xA0: "max_connect_time", 0xA1: "subscription_ids_not_supported",
    0xA2: "wildcard_subs_not_supported",
}


def reason_name(rc: int, zero: str = "success") -> str:
    """Label string for a v5 reason code (rcn_to_str analog)."""
    if rc == 0:
        return zero
    return _RC_NAMES.get(rc, f"rc_0x{rc:02x}")


# v5 properties: dict keyed by these names (reference uses #{p_<name> => V}
# maps, vmq_parser_mqtt5.erl property section). ``user_property`` is a list of
# (key, value) pairs; ``subscription_identifier`` a list of ints in PUBLISH.
Properties = Dict[str, Any]


class ParseError(ValueError):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class Will:
    topic: str
    payload: bytes
    qos: int = 0
    retain: bool = False
    properties: Properties = field(default_factory=dict)  # v5 will properties


@dataclass
class Connect:
    proto_ver: int = PROTO_311
    client_id: str = ""
    username: Optional[str] = None
    password: Optional[bytes] = None
    clean_start: bool = True
    keepalive: int = 60
    will: Optional[Will] = None
    properties: Properties = field(default_factory=dict)


@dataclass
class Connack:
    session_present: bool = False
    rc: int = 0  # v4 return code or v5 reason code
    properties: Properties = field(default_factory=dict)


@dataclass
class Publish:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    dup: bool = False
    packet_id: Optional[int] = None
    properties: Properties = field(default_factory=dict)


@dataclass
class Puback:
    packet_id: int
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


@dataclass
class Pubrec:
    packet_id: int
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


@dataclass
class Pubrel:
    packet_id: int
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


@dataclass
class Pubcomp:
    packet_id: int
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


@dataclass
class SubOpts:
    """Per-topic subscription options. v4 carries only ``qos``; v5 adds
    no-local / retain-as-published / retain-handling (MQTT5 3.8.3.1).
    ``filter_expr`` is the MQTT+ payload-filter suffix carried past the
    ``?`` of the SUBSCRIBE topic string (``sensors/+/temp?$gt(value,30)``
    — vernemq_tpu/filters/): it replicates with the subscription and is
    preserved verbatim even on nodes with payload filters disabled, so a
    mixed-version cluster never truncates it into a plain topic sub."""

    qos: int = 0
    no_local: bool = False
    rap: bool = False  # retain as published
    retain_handling: int = 0  # 0 send, 1 send-if-new, 2 don't send
    filter_expr: Optional[str] = None  # MQTT+ payload-filter suffix

    def to_byte(self) -> int:
        return (
            (self.qos & 0x03)
            | (0x04 if self.no_local else 0)
            | (0x08 if self.rap else 0)
            | ((self.retain_handling & 0x03) << 4)
        )

    @classmethod
    def from_byte(cls, b: int) -> "SubOpts":
        if b & 0xC0:
            raise ParseError("reserved_subscription_option_bits")
        rh = (b >> 4) & 0x03
        if rh == 3:
            raise ParseError("invalid_retain_handling")
        qos = b & 0x03
        if qos == 3:
            raise ParseError("invalid_qos")
        return cls(qos=qos, no_local=bool(b & 0x04), rap=bool(b & 0x08), retain_handling=rh)


@dataclass
class Subscribe:
    packet_id: int
    topics: List[Tuple[str, SubOpts]] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)


@dataclass
class Suback:
    packet_id: int
    reason_codes: List[int] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)


@dataclass
class Unsubscribe:
    packet_id: int
    topics: List[str] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)


@dataclass
class Unsuback:
    packet_id: int
    reason_codes: List[int] = field(default_factory=list)  # v5 only on wire
    properties: Properties = field(default_factory=dict)


@dataclass
class Pingreq:
    pass


@dataclass
class Pingresp:
    pass


@dataclass
class Disconnect:
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


@dataclass
class Auth:
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


Frame = Any  # union of the dataclasses above
