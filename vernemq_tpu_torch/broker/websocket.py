"""MQTT over WebSocket (``vmq_websocket.erl``): RFC 6455 server handshake
negotiating the ``mqtt`` / ``mqttv3.1`` subprotocols
(``vmq_websocket.erl:37-50``), binary frames carrying the MQTT byte stream
into the same session loop all other transports use. No cowboy — the
handshake and framing are implemented directly over asyncio streams."""

from __future__ import annotations

import asyncio
import base64
import hashlib
import logging
import struct
from typing import Optional, Tuple

from .session import Transport

log = logging.getLogger("vernemq_tpu_torch.websocket")

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
SUBPROTOCOLS = ("mqtt", "mqttv3.1")

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

MAX_WS_FRAME = 1 << 24
MAX_WS_MESSAGE = 1 << 26  # cumulative cap across fragments (DoS guard)


class WsError(Exception):
    pass


def accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + GUID).encode()).digest()).decode()


async def server_handshake(reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           path_prefix: str = "/mqtt") -> Optional[str]:
    """Read the HTTP Upgrade request, answer 101. Returns the negotiated
    subprotocol (or None on a failed handshake, after answering 400/404)."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
        return None
    lines = head.decode("latin1").split("\r\n")
    try:
        method, path, _ = lines[0].split(" ", 2)
    except ValueError:
        return None
    if path_prefix and not path.split("?", 1)[0].startswith(path_prefix):
        writer.write(b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        return None
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key")
    upgrade_ok = (
        method == "GET"
        and "websocket" in headers.get("upgrade", "").lower()
        and "upgrade" in headers.get("connection", "").lower()
        and key is not None
    )
    offered = [p.strip() for p in
               headers.get("sec-websocket-protocol", "").split(",") if p.strip()]
    chosen = next((p for p in offered if p in SUBPROTOCOLS), None)
    if not upgrade_ok or (offered and chosen is None):
        writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        return None
    resp = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
    )
    if chosen:
        resp += f"Sec-WebSocket-Protocol: {chosen}\r\n"
    writer.write((resp + "\r\n").encode())
    await writer.drain()
    return chosen or "mqtt"


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    b0 = 0x80 | opcode  # FIN always set (no outbound fragmentation)
    n = len(payload)
    if n < 126:
        hdr = bytes([b0, (0x80 if mask else 0) | n])
    elif n < 65536:
        hdr = bytes([b0, (0x80 if mask else 0) | 126]) + struct.pack(">H", n)
    else:
        hdr = bytes([b0, (0x80 if mask else 0) | 127]) + struct.pack(">Q", n)
    if mask:
        import os

        key = os.urandom(4)
        masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return hdr + key + masked
    return hdr + payload


class WsConnection:
    """Frame reader/writer over asyncio streams; handles control frames and
    reassembles fragmented messages."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, require_masked: bool = True):
        self.reader = reader
        self.writer = writer
        self.require_masked = require_masked
        self._frag: bytearray = bytearray()
        self._frag_opcode: Optional[int] = None
        self.closed = False

    async def _read_frame(self) -> Tuple[int, bool, bytes]:
        hdr = await self.reader.readexactly(2)
        fin = bool(hdr[0] & 0x80)
        if hdr[0] & 0x70:
            raise WsError("RSV bits set")
        opcode = hdr[0] & 0x0F
        masked = bool(hdr[1] & 0x80)
        n = hdr[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", await self.reader.readexactly(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", await self.reader.readexactly(8))[0]
        if n > MAX_WS_FRAME:
            raise WsError("frame too large")
        if masked:
            key = await self.reader.readexactly(4)
            data = await self.reader.readexactly(n)
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(data))
        else:
            if self.require_masked and opcode in (OP_BINARY, OP_TEXT, OP_CONT):
                raise WsError("client frames must be masked")
            payload = await self.reader.readexactly(n)
        return opcode, fin, payload

    async def read_message(self) -> bytes:
        """Next data message's payload; b'' on close/EOF. Pings are answered
        inline."""
        while True:
            if self.closed:
                return b""
            try:
                opcode, fin, payload = await self._read_frame()
            except (asyncio.IncompleteReadError, ConnectionError):
                self.closed = True
                return b""
            if opcode == OP_PING:
                self.send(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self.send(OP_CLOSE, payload[:2])
                self.closed = True
                return b""
            if opcode in (OP_BINARY, OP_TEXT):
                if not fin:
                    self._frag_opcode = opcode
                    self._frag = bytearray(payload)
                    continue
                return payload
            if opcode == OP_CONT:
                if self._frag_opcode is None:
                    raise WsError("unexpected continuation")
                if len(self._frag) + len(payload) > MAX_WS_MESSAGE:
                    raise WsError("fragmented message too large")
                self._frag += payload
                if fin:
                    out = bytes(self._frag)
                    self._frag = bytearray()
                    self._frag_opcode = None
                    return out
                continue
            raise WsError(f"bad opcode {opcode}")

    def send(self, opcode: int, payload: bytes) -> None:
        if self.closed:
            return
        try:
            self.writer.write(encode_frame(opcode, payload))
        except Exception:
            self.closed = True


class WebSocketTransport(Transport):
    """Session-facing transport: MQTT bytes written by the session are
    coalesced per event-loop tick into one binary WS frame (the MSS-flush
    batching of the TCP path, vmq_ranch.erl:253-262)."""

    def __init__(self, ws: WsConnection):
        self.ws = ws
        self._buf = bytearray()
        self._flush_scheduled = False
        self.closed = False

    def write(self, data: bytes) -> None:
        if self.closed:
            return
        self._buf += data
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        if self.closed or not self._buf:
            return
        self.ws.send(OP_BINARY, bytes(self._buf))
        self._buf.clear()

    def close(self) -> None:
        if self.closed:
            return
        self._flush()
        self.ws.send(OP_CLOSE, b"\x03\xe8")  # 1000 normal closure
        self.closed = True
        self.ws.closed = True
        try:
            self.ws.writer.close()
        except Exception:
            pass


class WebSocketServer:
    """``mqttws``/``mqttwss`` listener (vmq_ranch_config.erl:224-227)."""

    def __init__(self, broker, host: str = "127.0.0.1", port: int = 8080,
                 ssl_context=None, max_frame_size: int = 0,
                 use_identity_as_username: bool = False, mountpoint: str = "",
                 allowed_protocol_versions=None, max_connections: int = 0,
                 reuse_port: bool = False):
        self.broker = broker
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self.max_frame_size = max_frame_size
        self.use_identity_as_username = use_identity_as_username
        self.mountpoint = mountpoint
        self.allowed_protocol_versions = (
            tuple(allowed_protocol_versions)
            if allowed_protocol_versions else None)
        self.max_connections = int(max_connections or 0)
        self.connection_count = 0
        self.reuse_port = reuse_port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, ssl=self.ssl_context,
            reuse_port=self.reuse_port or None)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self.broker._servers.append(self._server)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        if (self.max_connections
                and self.connection_count >= self.max_connections):
            # listener connection cap, same contract as MQTTServer
            self.broker.metrics.incr("socket_error")
            writer.close()
            return
        self.connection_count += 1
        try:
            await self._handle_inner(reader, writer)
        finally:
            self.connection_count -= 1

    async def _handle_inner(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        from .server import MAX_FRAME_SIZE, mqtt_connection

        peer = writer.get_extra_info("peername") or ("", 0)
        from .ssl_util import preauth_from_cert

        ok, preauth = preauth_from_cert(
            writer, self.use_identity_as_username, self.ssl_context)
        if not ok:
            writer.close()
            return
        try:
            subproto = await asyncio.wait_for(
                server_handshake(reader, writer), 10.0)
        except (asyncio.TimeoutError, ConnectionError):
            writer.close()
            return
        if subproto is None:
            writer.close()
            return
        ws = WsConnection(reader, writer)
        transport = WebSocketTransport(ws)
        try:
            # malformed ws frames (WsError) are handled inside the shared
            # connection loop alongside MQTT parse errors
            await mqtt_connection(
                self.broker, ws.read_message, transport, peer,
                # same fallback chain as MQTTServer: per-listener
                # override, else the broker-wide max_message_size
                # total-frame cap, else unlimited
                (self.max_frame_size
                 or self.broker.config.get("max_message_size", 0)
                 or MAX_FRAME_SIZE),
                preauth_user=preauth, mountpoint=self.mountpoint,
                allowed_protocol_versions=self.allowed_protocol_versions)
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass
