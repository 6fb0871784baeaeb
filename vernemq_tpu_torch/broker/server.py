"""asyncio TCP listeners + per-connection socket loop.

Mirrors the reference socket layer: one lightweight task per connection
(``vmq_ranch.erl:41-43`` — one Erlang process per socket), buffered reparse
of incoming bytes driving the session FSM (``vmq_ranch.erl:167-251``),
write coalescing per event-loop tick (the MSS flush-threshold batching of
``vmq_ranch.erl:253-262``), and protocol detection on the first CONNECT
frame choosing the v4 or v5 FSM (``vmq_mqtt_pre_init.erl:58-70``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional, Tuple

from ..protocol import codec_v4, codec_v5, fastpath, wire
from ..protocol.types import (
    PROTO_5,
    RC_PACKET_TOO_LARGE,
    Connect,
    ParseError,
)
from .broker import Broker
from .session import Session, Transport
from .websocket import WsError

log = logging.getLogger("vernemq_tpu_torch.server")

CONNECT_TIMEOUT = 10.0
MAX_FRAME_SIZE = 268435455


class StreamTransport(Transport):
    """Write-coalescing wrapper over an asyncio StreamWriter: session
    writes within one loop tick collect into ONE iovec (a chunk list)
    that the flush hands to ``writelines`` — one C-level join + one
    syscall-bound send per loop iteration, however many small
    PUBACK/PUBLISH frames landed in it. Compared to the previous
    single-bytearray coalescer this removes the per-write append copy
    entirely: a fanout's shared payload bytes object is referenced from
    every recipient's iovec and only touched once, inside the
    transport's join. The list swap at flush keeps the
    swap-not-copy behaviour whether or not the native encoder is
    present."""

    def __init__(self, writer: asyncio.StreamWriter):
        self._writer = writer
        self._chunks: list = []
        self._flush_scheduled = False
        self.closed = False

    def write(self, data: bytes) -> None:
        if self.closed:
            return
        self._chunks.append(data)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush)

    def write_iov(self, chunks) -> None:
        """Queue a writev-ready iovec (e.g. the native encoder's
        (header, payload) pair) without assembling a per-frame bytes
        object."""
        if self.closed:
            return
        self._chunks.extend(chunks)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        if self.closed or not self._chunks:
            return
        chunks, self._chunks = self._chunks, []
        # an empty last chunk (a PUBLISH with no payload) would stay in
        # the socket transport's buffer forever: CPython's
        # _adjust_leftover_buffer stops popping at 0 bytes left, so the
        # buffer never drains, close() never reaches connection_lost and
        # wait_closed() never returns
        while not len(chunks[-1]):
            chunks.pop()
            if not chunks:
                return
        try:
            if len(chunks) == 1:
                self._writer.write(chunks[0])
            else:
                self._writer.writelines(chunks)
        except Exception:
            self.closed = True

    def close(self) -> None:
        if self.closed:
            return
        self._flush()
        self.closed = True
        try:
            self._writer.close()
        except Exception:
            pass


def parse_nodelay_option(raw: str) -> Optional[bool]:
    """Extract the ``nodelay`` flag from the tcp_listen_options knob
    (vmq_server.schema:1454, an erlang proplist string). ``nodelay`` is
    the option that matters for publish latency; the rest of the
    proplist is accepted for compatibility (asyncio owns send
    timeouts/linger). Returns None when the option is absent."""
    if "nodelay" not in raw:
        return None
    return "{nodelay,true}" in raw.replace(" ", "")


def _apply_nodelay(writer: asyncio.StreamWriter, want: bool) -> None:
    sock = writer.get_extra_info("socket")
    if sock is not None:
        import socket as _socket

        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY,
                            1 if want else 0)
        except OSError:
            pass


def sniff_proto_ver(body: bytes) -> int:
    """Read the protocol level out of a CONNECT body without committing to a
    codec (vmq_mqtt_pre_init.erl:44-70)."""
    name, pos = wire.take_utf8(body, 0)
    if pos >= len(body):
        raise ParseError("malformed_connect")
    return body[pos] & 0x7F


async def mqtt_connection(
    broker: Broker,
    read_chunk,
    transport: Transport,
    peer: Tuple[str, int],
    max_frame_size: int = MAX_FRAME_SIZE,
    initial: bytes = b"",
    preauth_user: Optional[str] = None,
    mountpoint: str = "",
    allowed_protocol_versions: Optional[Tuple[int, ...]] = None,
) -> None:
    """The per-connection MQTT byte loop, transport-agnostic: ``read_chunk``
    is an awaitable returning the next bytes (b"" on EOF), ``transport``
    writes outbound frames. TCP, TLS, WebSocket and PROXY-wrapped listeners
    all drive their sockets through this one loop (the reference funnels all
    transports into the same FSM contract, vmq_ranch.erl:167-251).
    ``preauth_user`` overrides the CONNECT username (TLS client-cert CN or
    PROXY identity, vmq_ranch.erl:59-72); ``mountpoint`` is the listener's
    multitenancy prefix (per-listener mountpoint config)."""
    metrics = broker.metrics
    metrics.incr("socket_open")
    session: Optional[Session] = None
    buf = initial
    try:
        # ---- pre-init: wait for CONNECT, pick protocol ----------------
        first = wire.split_frame(buf, max_frame_size) if buf else None

        async def _read_connect():
            # wait_for (not asyncio.timeout) — the latter is 3.11+ and
            # this must run on the image's 3.10
            nonlocal buf
            f = first
            while f is None:
                chunk = await read_chunk()
                if not chunk:
                    return None
                metrics.incr("bytes_received", len(chunk))
                buf += chunk
                f = wire.split_frame(buf, max_frame_size)
            return f

        first = await asyncio.wait_for(_read_connect(), CONNECT_TIMEOUT)
        if first is None:
            return
        ptype, flags, body, rest = first
        if ptype != 1:  # must be CONNECT
            return
        proto_ver = sniff_proto_ver(body)
        if (allowed_protocol_versions is not None
                and proto_ver not in allowed_protocol_versions):
            # per-listener version gate (listener.*.allowed_protocol_versions,
            # vmq_server.schema): refuse like an unknown level
            if proto_ver == PROTO_5:
                transport.write(b"\x20\x03\x00\x84\x00")  # v5 rc=0x84
            else:
                transport.write(b"\x20\x02\x00\x01")  # v4 rc=1
            metrics.incr("mqtt_connect_error")
            return
        if proto_ver == PROTO_5:
            codec = codec_v5
        elif proto_ver in (3, 4):
            codec = codec_v4
        else:
            # unknown protocol level: v4-style CONNACK rc=1
            transport.write(b"\x20\x02\x00\x01")
            return
        gov = getattr(broker, "overload", None)
        if gov is not None and gov.refuse_connects():
            # L3 admission control (robustness/overload.py): refuse
            # before any session/auth/registry cost. This is the
            # earliest protocol-aware point we control — with asyncio
            # listeners the TLS handshake has already run by the time
            # the stream reaches us, so "before TLS" is only possible
            # for plain listeners (where there is no handshake to
            # save). v5: CONNACK 0x97 Quota exceeded; v3/4: rc=3
            # Server unavailable.
            metrics.incr("mqtt_connect_error")
            if proto_ver == PROTO_5:
                transport.write(b"\x20\x03\x00\x97\x00")
            else:
                transport.write(b"\x20\x02\x00\x03")
            return
        connect_frame = codec._parse_body(ptype, flags, body)
        if preauth_user is not None:
            connect_frame.username = preauth_user
        session = Session(broker, transport, proto_ver, peer=peer,
                          mountpoint=mountpoint)
        if max_frame_size and max_frame_size < MAX_FRAME_SIZE:
            # the cap THIS listener actually parses with — what the
            # CONNACK maximum_packet_size must announce (a later config
            # change or per-listener override must not let the two lie
            # apart)
            session.max_frame_in = max_frame_size
        ok = await session.handle_connect(connect_frame)
        if not ok and not session._pending_connect:
            return

        # ---- steady-state frame loop ---------------------------------
        # The wire plane (protocol/fastpath.py): each buffered chunk is
        # batch-parsed into a packed frame table in ONE call (native
        # codec when built, bit-identical pure-Python twin otherwise).
        # Admitted PUBLISHes — QoS0 AND QoS1/2 — flow from the table
        # straight into the routing fanout without materialising
        # frame/Msg objects (session.wire_publish_qos0/_qos), and the
        # 2-byte ack family resolves its pid against the in-flight
        # bookkeeping the same way (session.wire_ack); every other
        # record — reason-code acks, retained/dup publishes, protocol
        # edges, malformed input — materialises its frame object and
        # takes the classic handler unchanged.
        buf = bytes(rest)
        frames_run = 0
        v5 = codec is codec_v5
        rec_size = fastpath.REC_SIZE
        unpack_rec = fastpath.REC.unpack_from
        while not session.closed:
            if buf:
                t0 = time.monotonic()
                table, nrec, consumed = fastpath.parse_batch(
                    buf, max_frame_size, v5)
                metrics.observe("stage_wire_parse_ms",
                                (time.monotonic() - t0) * 1e3)
                fast_gate = nrec > 0 and session.wire_fast_ready()
                fast_pubs = 0
                fast_qpubs = 0
                try:
                    for off in range(0, nrec * rec_size, rec_size):
                        rec = unpack_rec(table, off)
                        handled = False
                        if fast_gate:
                            kind = rec[0]
                            if kind == fastpath.K_PUB0 \
                                    and rec[1] == 0x30:
                                if session.wire_publish_qos0(buf, rec):
                                    fast_pubs += 1
                                    handled = True
                            elif kind == fastpath.K_PUB \
                                    and rec[1] in (0x32, 0x34):
                                # QoS1/2, no retain, no dup: the dup
                                # retransmit and retained forms keep
                                # the classic path (dedup/store edges)
                                if session.wire_publish_qos(buf, rec):
                                    fast_qpubs += 1
                                    handled = True
                            elif kind == fastpath.K_ACK:
                                # always resolves (invalid pids count
                                # *_invalid_error exactly like classic)
                                session.wire_ack(rec)
                                handled = True
                        if not handled:
                            try:
                                frame = fastpath.materialize(
                                    codec, buf, rec, max_frame_size)
                            except ParseError as e:
                                if e.reason == "frame_too_large":
                                    # the metric monitoring keys on,
                                    # now that the parser (not the
                                    # session payload check) is the
                                    # enforcement point
                                    metrics.incr(
                                        "mqtt_invalid_msg_size_error")
                                    if session.proto_ver == PROTO_5 \
                                            and not session.closed:
                                        # tell a v5 client WHY before
                                        # dropping the socket (MQTT5
                                        # 3.2.2.3.6 / DISCONNECT 0x95)
                                        await session._disconnect_v5(
                                            RC_PACKET_TOO_LARGE)
                                raise
                            await session.handle_frame(frame)
                            if session.closed:
                                break
                            # every classic frame is an await — policy
                            # (governor level, hooks, tracer) may have
                            # moved while we yielded, so the remaining
                            # fast records must re-pass the gate
                            fast_gate = (fast_gate
                                         and session.wire_fast_ready())
                        frames_run += 1
                        if frames_run >= 64:
                            # bound the synchronous run per read chunk:
                            # a 64KB chunk can hold ~700 small
                            # PUBLISHes, and a handler that never truly
                            # awaits would process them all in ONE loop
                            # callback — a flood connection must not
                            # stall every other session's IO (and the
                            # sysmon sampler) for the whole chunk
                            frames_run = 0
                            await asyncio.sleep(0)
                            if session.closed:  # closed while yielded
                                break
                            # re-check the batch gate after yielding:
                            # the governor/hooks may have moved while
                            # we slept
                            fast_gate = (fast_gate
                                         and session.wire_fast_ready())
                finally:
                    # a mid-batch error (malformed frame after admitted
                    # publishes) must not lose the bookkeeping for
                    # fast-path messages already routed and delivered
                    if fast_pubs or fast_qpubs:
                        session.wire_fast_done(fast_pubs, fast_qpubs)
                if session.closed:
                    break
                buf = buf[consumed:] if consumed else buf
            if session.connected:
                chunk = await read_chunk()
            else:
                # still inside the CONNECT/enhanced-AUTH exchange: keep
                # the pre-init deadline so parked half-auth connections
                # can't pin sockets forever
                chunk = await asyncio.wait_for(read_chunk(), CONNECT_TIMEOUT)
            if not chunk:
                break
            metrics.incr("bytes_received", len(chunk))
            buf += chunk
    except (asyncio.TimeoutError, TimeoutError):
        pass
    except ParseError as e:
        log.debug("parse error from %s: %s", peer, e.reason)
        metrics.incr("socket_error")
    except WsError as e:
        log.debug("websocket error from %s: %s", peer, e)
        metrics.incr("socket_error")
    except ConnectionError:
        metrics.incr("socket_error")
    except Exception:
        log.exception("connection handler crashed")
        metrics.incr("socket_error")
    finally:
        if session is not None and not session.closed:
            await session.close("connection_lost")
        transport.close()
        metrics.incr("socket_close")


class MQTTServer:
    def __init__(self, broker: Broker, host: str = "127.0.0.1", port: int = 1883,
                 max_frame_size: int = 0, ssl_context=None,
                 proxy_protocol: bool = False,
                 use_identity_as_username: bool = False,
                 mountpoint: str = "",
                 allowed_protocol_versions=None,
                 max_connections: int = 0,
                 reuse_port: bool = False):
        self.broker = broker
        self.host = host
        self.port = port
        # per-listener override, else the broker-wide max_message_size
        # (the reference's semantic: vmq_parser.erl enforces it on every
        # packet type as a REMAINING-LENGTH cap — total accepted bytes
        # are at most cap + 5B of fixed header, the lenient direction
        # the spec allows relative to the announced value)
        self.max_frame_size = (max_frame_size
                               or broker.config.get("max_message_size", 0)
                               or MAX_FRAME_SIZE)
        self.ssl_context = ssl_context
        self.proxy_protocol = proxy_protocol
        self.use_identity_as_username = use_identity_as_username
        self.mountpoint = mountpoint
        self.allowed_protocol_versions = (
            tuple(allowed_protocol_versions)
            if allowed_protocol_versions else None)
        self.max_connections = int(max_connections or 0)
        self.connection_count = 0
        # SO_REUSEPORT lets N worker processes share one listen port with
        # kernel-level accept balancing (the multi-process scale-out path,
        # broker/workers.py — the vmq_ranch all-schedulers seat)
        self.reuse_port = reuse_port
        # parsed once at listener construction — the accept path only
        # applies the cached flag
        self._nodelay = parse_nodelay_option(
            str(broker.config.get("tcp_listen_options", "") or ""))
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, ssl=self.ssl_context,
            reuse_port=self.reuse_port or None,
        )
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self.broker._servers.append(self._server)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if (self.max_connections
                and self.connection_count >= self.max_connections):
            # listener connection cap (listener.*.max_connections): refuse
            # at accept like ranch's max_connections
            self.broker.metrics.incr("socket_error")
            writer.close()
            return
        self.connection_count += 1
        try:
            await self._handle_conn_inner(reader, writer)
        finally:
            self.connection_count -= 1

    async def _handle_conn_inner(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername") or ("", 0)
        if self._nodelay is not None:
            _apply_nodelay(writer, self._nodelay)
        initial = b""
        preauth: Optional[str] = None
        if self.proxy_protocol:
            from .proxy_proto import ProxyProtoError, read_proxy_header

            try:
                info = await asyncio.wait_for(read_proxy_header(reader),
                                              CONNECT_TIMEOUT)
            except (ProxyProtoError, asyncio.TimeoutError, ConnectionError,
                    asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                writer.close()
                return
            if info.src is not None:
                peer = info.src
            if self.use_identity_as_username:
                if not info.cn:
                    # identity mapping requires the PP2 SSL CN TLV — same
                    # policy as the TLS path (no silent fall-through)
                    writer.close()
                    return
                preauth = info.cn
        else:
            from .ssl_util import preauth_from_cert

            ok, preauth = preauth_from_cert(
                writer, self.use_identity_as_username, self.ssl_context)
            if not ok:
                writer.close()  # cert required for identity mapping
                return
        transport = StreamTransport(writer)
        try:
            await mqtt_connection(
                self.broker, lambda: reader.read(65536), transport, peer,
                self.max_frame_size, initial=initial, preauth_user=preauth,
                mountpoint=self.mountpoint,
                allowed_protocol_versions=self.allowed_protocol_versions)
        finally:
            try:
                await writer.wait_closed()
            except Exception:
                pass


async def start_broker(
    config=None, host: str = "127.0.0.1", port: int = 1883,
    node_name: str = "node1", device=None,
    cluster_listen: Optional[Tuple[str, int]] = None,
    join: Optional[Tuple[str, int]] = None,
    reuse_port: bool = False,
) -> Tuple[Broker, MQTTServer]:
    """Boot a broker with one MQTT listener (vmq_test_utils:setup-style
    convenience; port=0 picks a random free port). ``device`` is where the
    ``tpu`` reg view runs (default the CUDA card; see :class:`Broker`).
    ``cluster_listen`` additionally starts the inter-node channel listener
    (the reference's ``vmq`` listener type, vmq_ranch_config.erl:224-227);
    ``join`` dials a seed node. ``reuse_port`` lets worker processes share
    the MQTT port (broker/workers.py)."""
    broker = Broker(config, node_name=node_name, device=device)
    await broker.start()
    from .listeners import ListenerManager

    manager = ListenerManager(broker)
    server = await manager.start_listener(
        "mqtt", host, port, {"reuse_port": reuse_port} if reuse_port else None)
    if cluster_listen is not None:
        from ..cluster import Cluster

        cluster = Cluster(broker, cluster_listen[0], cluster_listen[1])
        await cluster.start()
        if join is not None:
            cluster.join(*join)
    return broker, server


def main() -> None:  # pragma: no cover
    import argparse

    parser = argparse.ArgumentParser(
        description="vernemq_tpu_torch broker: MQTT with the subscription "
                    "matcher on a CUDA GPU")
    parser.add_argument("--conf", default=None, metavar="PATH",
                        help="vernemq.conf-style config file (broker/conf.py)")
    parser.add_argument("--allow-anonymous", action="store_true",
                        help="accept connects without an auth plugin "
                             "(allow_anonymous=on)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=1883)
    parser.add_argument("--reg-view", default="tpu", choices=["trie", "tpu"],
                        help="subscription matcher (the default_reg_view "
                             "seam; overrides --conf): tpu, the default, is "
                             "the GPU match engine, trie the host trie")
    parser.add_argument("--device", default="cuda",
                        help="device of the tpu reg view (default cuda; "
                             "cpu runs its plain PyTorch path)")
    parser.add_argument("--tpu-mesh", default=None, metavar="BxS",
                        help="serve matching on a device mesh (e.g. 1x4: "
                             "batch x sub axes) over this process's cards; "
                             "needs the tpu reg view")
    parser.add_argument("--node-name", default="node1")
    parser.add_argument("--http-port", type=int, default=None,
                        help="start the HTTP endpoint (metrics/health/"
                             "status/mgmt API) on this port")
    parser.add_argument("--no-mgmt-auth", action="store_true",
                        help="disable api-key auth on the management API")
    parser.add_argument("--cluster-listen", default=None, metavar="HOST:PORT",
                        help="start the inter-node cluster listener")
    parser.add_argument("--join", default=None, metavar="HOST:PORT",
                        help="join an existing cluster via this seed node")
    args = parser.parse_args()
    if args.tpu_mesh and args.reg_view == "trie":
        parser.error("--tpu-mesh requires the tpu reg view; drop "
                     "--reg-view trie")

    def _addr(s):
        h, _, p = s.rpartition(":")
        return (h or "127.0.0.1", int(p))

    async def _run():
        from .config import Config

        cfg = Config.from_file(args.conf) if args.conf else Config()
        cfg.set("default_reg_view", args.reg_view)
        if args.tpu_mesh:
            cfg.set("tpu_mesh", args.tpu_mesh)
        if args.allow_anonymous:
            cfg.set("allow_anonymous", True)
        if args.http_port is not None:
            cfg.set("http_enabled", True)
            cfg.set("http_port", args.http_port)
            cfg.set("http_host", args.host)
        if args.no_mgmt_auth:
            cfg.set("http_mgmt_api_auth", False)
        broker, server = await start_broker(
            cfg, host=args.host, port=args.port, node_name=args.node_name,
            device=args.device,
            cluster_listen=_addr(args.cluster_listen) if args.cluster_listen else None,
            join=_addr(args.join) if args.join else None,
        )
        print(f"vernemq_tpu_torch broker {args.node_name} listening on "
              f"{args.host}:{server.port} (reg view {args.reg_view}"
              f"{' on ' + str(broker.device) if args.reg_view == 'tpu' else ''})",
              flush=True)
        if broker.http is not None:
            print(f"http endpoint on {broker.http.host}:{broker.http.port}",
                  flush=True)
        if broker.cluster is not None:
            print(f"cluster listener on {broker.cluster.listen_host}:"
                  f"{broker.cluster.listen_port}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(_run())


if __name__ == "__main__":  # pragma: no cover
    main()
