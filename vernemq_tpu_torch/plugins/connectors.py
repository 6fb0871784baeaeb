"""Pure-Python datastore connectors for the scripting plugins — the
"batteries" seat of the reference's ``vmq_diversity`` bundled drivers
(epgsql/eredis/mcd pools, ``vmq_diversity.erl`` pool supervision).

This image ships no DB client libraries and has no package egress, so
each connector speaks the wire protocol directly over a TCP socket:

- :class:`RedisPool` — RESP2 (the protocol of ``eredis``): inline
  command arrays, bulk/array/integer/error replies, AUTH + SELECT on
  connect.
- :class:`MemcachedPool` — memcached text protocol (``mcd`` seat):
  get/set/delete.
- :class:`PostgresPool` — PostgreSQL v3 wire protocol (``epgsql`` seat):
  startup, cleartext + MD5 auth, the extended-query flow
  (Parse/Bind/Describe/Execute/Sync) with text-format results so
  ``$1``-style parameters work exactly like the reference's bundled
  ``postgres.lua`` expects.
- :class:`MysqlPool` — MySQL client protocol (``emysql`` seat):
  mysql_native_password handshake + COM_QUERY text protocol with
  escaped client-side ``?`` substitution, the contract of the bundled
  ``mysql.lua``.

- :class:`MongodbPool` — MongoDB OP_MSG command transport over a BSON
  subset with SCRAM-SHA-256 auth; ``find_one(collection, selector)`` is
  the bundled ``mongodb.lua`` contract.

With that, every datastore the reference bundles a driver for is
covered by a built-in wire client.

Each `*Pool` name above is a single lazily-connecting client (socket +
lock, reconnect-on-error); the registry wraps every one in a
:class:`ClientPool` of ``size`` independently-connected clients (the
poolboy seat, default 5 — ``ensure_pool{size=...}``), so concurrent
auth hooks run against distinct sockets instead of serialising on one
connection. See test_lua.py::test_client_pool_concurrent_checkout and
test_lua_auth_hooks_overlap for the proof.
"""

from __future__ import annotations

import functools
import hashlib
import queue
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["RedisPool", "MemcachedPool", "PostgresPool", "MysqlPool",
           "MongodbPool", "ClientPool", "PoolError", "POOL_REGISTRIES",
           "ensure_pool", "get_pool", "bson_encode", "bson_decode"]


class PoolError(Exception):
    pass


class _SocketClient:
    """Shared plumbing: lazy connect, lock, reconnect-once-on-error."""

    def __init__(self, host: str, port: int, timeout: float = 3.0):
        self.host = host
        self.port = int(port)
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self.lock = threading.Lock()

    def _connect(self) -> None:
        self.close()
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        s.settimeout(self.timeout)
        self.sock = s
        try:
            self._on_connect()
        except BaseException:
            # a half-set-up session must not linger as self.sock: the next
            # call would reuse the socket WITHOUT the auth/verification
            # that just failed (e.g. a mongod session whose SCRAM server
            # signature didn't verify is authenticated server-side — every
            # call after the first would silently bypass the check)
            self.close()
            raise

    def _on_connect(self) -> None:  # override
        pass

    def _ensure(self) -> socket.socket:
        if self.sock is None:
            self._connect()
        return self.sock  # type: ignore[return-value]

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def _recv_exact(self, n: int) -> bytes:
        s = self._ensure()
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise PoolError("connection closed")
            buf += chunk
        return buf


# ------------------------------------------------------------------- redis


class RedisPool(_SocketClient):
    """Minimal RESP2 client. ``cmd`` takes either an args list or a
    single command string split on whitespace (the shape the reference's
    ``redis.cmd(pool, "get " .. key)`` scripts use; keys produced by
    ``json.encode`` contain no spaces)."""

    def __init__(self, host="127.0.0.1", port=6379, password=None,
                 database=0, timeout=3.0):
        super().__init__(host, port, timeout)
        self.password = password
        self.database = int(database or 0)

    def _on_connect(self) -> None:
        if self.password:
            self._roundtrip(["AUTH", self.password])
        if self.database:
            self._roundtrip(["SELECT", str(self.database)])

    def _encode(self, args: List[Any]) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    def _read_line(self) -> bytes:
        buf = b""
        while not buf.endswith(b"\r\n"):
            buf += self._recv_exact(1)
        return buf[:-2]

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise PoolError(f"redis: {rest.decode()}")
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._recv_exact(n + 2)[:-2]
            try:
                return data.decode()
            except UnicodeDecodeError:
                return data
        if t == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise PoolError(f"redis: bad reply type {t!r}")

    def _roundtrip(self, args: List[Any]):
        s = self._ensure()
        s.sendall(self._encode(args))
        return self._read_reply()

    def cmd(self, command, *args):
        if isinstance(command, str) and not args:
            parts: List[Any] = command.split()
        else:
            parts = [command, *args]
        if not parts:
            raise PoolError("redis: empty command")
        with self.lock:
            try:
                return self._roundtrip(parts)
            except PoolError as e:
                if str(e) == "connection closed":  # _recv_exact: stale socket
                    self._connect()
                    return self._roundtrip(parts)
                raise  # server-reported error (-ERR): do not re-send
            except OSError:
                # one reconnect attempt (stale pool socket)
                self._connect()
                return self._roundtrip(parts)


# ---------------------------------------------------------------- memcached


class MemcachedPool(_SocketClient):
    """Memcached text protocol: get/set/delete (flags unused)."""

    def __init__(self, host="127.0.0.1", port=11211, timeout=3.0):
        super().__init__(host, port, timeout)

    def _read_line(self) -> bytes:
        buf = b""
        while not buf.endswith(b"\r\n"):
            buf += self._recv_exact(1)
        return buf[:-2]

    @staticmethod
    def _check_key(key: str) -> str:
        """The text protocol delimits on whitespace/CRLF, so a key built
        from client-controlled input (client ids!) could otherwise desync
        the stream or inject commands (a CRLF in a ``set`` key would smuggle
        arbitrary follow-on commands). Same limits as memcached itself:
        <=250 bytes, no whitespace/control characters."""
        if not key or len(key) > 250 \
                or any(c.isspace() or ord(c) < 33 for c in key):
            raise PoolError(f"memcached: invalid key {key[:64]!r} "
                            "(whitespace/control chars not allowed)")
        return key

    def get(self, key: str):
        key = self._check_key(key)
        with self.lock:
            s = self._ensure()
            s.sendall(b"get %s\r\n" % key.encode())
            line = self._read_line()
            if line == b"END":
                return None
            if not line.startswith(b"VALUE "):
                raise PoolError(f"memcached: {line!r}")
            _v, _k, _flags, length = line.split()[:4]
            data = self._recv_exact(int(length) + 2)[:-2]
            end = self._read_line()
            if end != b"END":
                raise PoolError(f"memcached: expected END, got {end!r}")
            try:
                return data.decode()
            except UnicodeDecodeError:
                return data

    def set(self, key: str, value, exptime: int = 0) -> bool:
        key = self._check_key(key)
        data = value if isinstance(value, bytes) else str(value).encode()
        with self.lock:
            s = self._ensure()
            s.sendall(b"set %s 0 %d %d\r\n%s\r\n"
                      % (key.encode(), int(exptime), len(data), data))
            return self._read_line() == b"STORED"

    def delete(self, key: str) -> bool:
        key = self._check_key(key)
        with self.lock:
            s = self._ensure()
            s.sendall(b"delete %s\r\n" % key.encode())
            return self._read_line() == b"DELETED"


# ------------------------------------------------------------------ mongodb


def bson_encode(doc: Dict[str, Any]) -> bytes:
    """Encode a Python dict as a BSON document (the subset auth documents
    use: str, int32/64, float, bool, None, bytes, nested dict/list)."""
    out = bytearray()
    for k, v in doc.items():
        key = str(k).encode() + b"\0"
        if isinstance(v, bool):
            out += b"\x08" + key + (b"\x01" if v else b"\x00")
        elif isinstance(v, int):
            if -(1 << 31) <= v < (1 << 31):
                out += b"\x10" + key + struct.pack("<i", v)
            else:
                out += b"\x12" + key + struct.pack("<q", v)
        elif isinstance(v, float):
            out += b"\x01" + key + struct.pack("<d", v)
        elif isinstance(v, str):
            b = v.encode()
            out += b"\x02" + key + struct.pack("<i", len(b) + 1) + b + b"\0"
        elif v is None:
            out += b"\x0a" + key
        elif isinstance(v, bytes):
            out += b"\x05" + key + struct.pack("<i", len(v)) + b"\x00" + v
        elif isinstance(v, dict):
            out += b"\x03" + key + bson_encode(v)
        elif isinstance(v, (list, tuple)):
            out += b"\x04" + key + bson_encode(
                {str(i): x for i, x in enumerate(v)})
        else:
            raise PoolError(f"mongodb: cannot BSON-encode {type(v).__name__}")
    return struct.pack("<i", len(out) + 5) + bytes(out) + b"\0"


def bson_decode(data: bytes, off: int = 0) -> Tuple[Dict[str, Any], int]:
    """Decode one BSON document starting at ``off``; returns (doc, end)."""
    (total,) = struct.unpack_from("<i", data, off)
    end = off + total
    off += 4
    doc: Dict[str, Any] = {}
    while off < end - 1:
        t = data[off]
        off += 1
        zero = data.index(b"\0", off)
        key = data[off:zero].decode()
        off = zero + 1
        if t == 0x01:
            (val,) = struct.unpack_from("<d", data, off)
            off += 8
        elif t == 0x02:
            (n,) = struct.unpack_from("<i", data, off)
            val = data[off + 4:off + 4 + n - 1].decode("utf-8", "replace")
            off += 4 + n
        elif t in (0x03, 0x04):
            sub, off = bson_decode(data, off)
            val = ([sub[str(i)] for i in range(len(sub))] if t == 0x04
                   else sub)
        elif t == 0x05:
            (n,) = struct.unpack_from("<i", data, off)
            val = data[off + 5:off + 5 + n]
            off += 5 + n
        elif t == 0x07:  # ObjectId → hex string
            val = data[off:off + 12].hex()
            off += 12
        elif t == 0x08:
            val = data[off] == 1
            off += 1
        elif t == 0x09 or t == 0x12:  # datetime(ms) / int64
            (val,) = struct.unpack_from("<q", data, off)
            off += 8
        elif t == 0x0A:
            val = None
        elif t == 0x10:
            (val,) = struct.unpack_from("<i", data, off)
            off += 4
        else:
            raise PoolError(f"mongodb: unsupported BSON type 0x{t:02x}")
        doc[key] = val
    return doc, end


class MongodbPool(_SocketClient):
    """MongoDB wire protocol (the reference's mongodb driver seat):
    OP_MSG (opcode 2013, kind-0 section) command transport over a BSON
    subset, with optional SCRAM-SHA-256 authentication (RFC 5802 over
    the ``saslStart``/``saslContinue`` command round-trips). The script
    surface is ``find_one(collection, selector)`` — the shape the
    bundled ``mongodb.lua`` auth script uses — plus ``command`` for
    anything else."""

    _OP_MSG = 2013

    def __init__(self, host="127.0.0.1", port=27017, user=None,
                 password="", database="vernemq_db", timeout=5.0):
        super().__init__(host, port, timeout)
        self.user = user
        self.password = password or ""
        self.database = database
        self._req_id = 0

    # wire
    def _send_msg(self, cmd_doc: Dict[str, Any]) -> None:
        s = self._ensure()
        self._req_id += 1
        body = struct.pack("<I", 0) + b"\x00" + bson_encode(cmd_doc)
        s.sendall(struct.pack("<iiii", 16 + len(body), self._req_id, 0,
                              self._OP_MSG) + body)

    def _read_msg(self) -> Dict[str, Any]:
        head = self._recv_exact(16)
        (ln, _rid, _resp, opcode) = struct.unpack("<iiii", head)
        body = self._recv_exact(ln - 16)
        if opcode != self._OP_MSG:
            raise PoolError(f"mongodb: unexpected opcode {opcode}")
        # flags(4) + kind byte, then one BSON doc (kind 0)
        if body[4] != 0:
            raise PoolError("mongodb: unsupported OP_MSG section kind")
        doc, _ = bson_decode(body, 5)
        return doc

    def command(self, doc: Dict[str, Any], db: Optional[str] = None):
        with self.lock:
            try:
                return self._command(doc, db)
            except PoolError as e:
                if str(e).startswith("mongodb:"):
                    raise
                self._connect()
                return self._command(doc, db)
            except OSError:
                self._connect()
                return self._command(doc, db)

    def _command(self, doc: Dict[str, Any], db: Optional[str] = None):
        """One command round-trip (no locking — ``command`` wraps this,
        and ``_on_connect`` runs inside an in-progress ``_connect``)."""
        self._ensure()
        out = dict(doc)
        out["$db"] = db or self.database
        self._send_msg(out)
        reply = self._read_msg()
        if not reply.get("ok"):
            raise PoolError(f"mongodb: {reply.get('errmsg', 'command failed')}")
        return reply

    def find_one(self, collection: str, selector: Dict[str, Any]):
        """Returns the first matching document or None."""
        reply = self.command({"find": str(collection),
                              "filter": dict(selector or {}), "limit": 1})
        batch = (reply.get("cursor") or {}).get("firstBatch") or []
        return batch[0] if batch else None

    # SCRAM-SHA-256 (RFC 5802/7677 over saslStart/saslContinue)
    def _on_connect(self) -> None:
        if not self.user:
            return
        import base64
        import hmac as hmac_mod
        import os as os_mod

        user = str(self.user).replace("=", "=3D").replace(",", "=2C")
        nonce = base64.b64encode(os_mod.urandom(18)).decode()
        first_bare = f"n={user},r={nonce}"
        start = self._command({
            "saslStart": 1, "mechanism": "SCRAM-SHA-256",
            "payload": ("n,," + first_bare).encode(),
            "options": {"skipEmptyExchange": True}})
        server_first = start["payload"].decode()
        fields = dict(p.split("=", 1) for p in server_first.split(","))
        if not fields["r"].startswith(nonce):
            raise PoolError("mongodb: SCRAM server nonce mismatch")
        salt = base64.b64decode(fields["s"])
        iters = int(fields["i"])
        salted = hashlib.pbkdf2_hmac("sha256", self.password.encode(),
                                     salt, iters)
        client_key = hmac_mod.new(salted, b"Client Key",
                                  hashlib.sha256).digest()
        stored = hashlib.sha256(client_key).digest()
        without_proof = "c=biws,r=" + fields["r"]
        auth_msg = ",".join((first_bare, server_first,
                             without_proof)).encode()
        sig = hmac_mod.new(stored, auth_msg, hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, sig))
        final = (without_proof + ",p="
                 + base64.b64encode(proof).decode())
        cont = self._command({
            "saslContinue": 1, "conversationId":
                start.get("conversationId", 1),
            "payload": final.encode()})
        server_final = cont["payload"].decode()
        server_key = hmac_mod.new(salted, b"Server Key",
                                  hashlib.sha256).digest()
        want_v = hmac_mod.new(server_key, auth_msg,
                              hashlib.sha256).digest()
        got_v = base64.b64decode(
            dict(p.split("=", 1)
                 for p in server_final.split(","))["v"])
        if got_v != want_v:
            raise PoolError("mongodb: SCRAM server signature invalid "
                            "(server does not know the password)")
        while not cont.get("done", True):
            cont = self._command({
                "saslContinue": 1,
                "conversationId": start.get("conversationId", 1),
                "payload": b""})



# ------------------------------------------------------------------- mysql


class MysqlPool(_SocketClient):
    """MySQL client protocol (the ``emysql`` seat): ``mysql_native_password``
    handshake + ``COM_QUERY`` text protocol with client-side ``?``
    parameter substitution (properly escaped string literals — the same
    contract the reference's bundled ``mysql.lua`` uses:
    ``mysql.execute(pool, "... WHERE username=?", u)``).

    Auth: mysql_native_password (token = SHA1(pw) XOR SHA1(salt +
    SHA1(SHA1(pw)))). caching_sha2_password (the 8.0 default) is not
    implemented — point the broker at a user created WITH
    mysql_native_password, as the epgsql-era reference required."""

    def __init__(self, host="127.0.0.1", port=3306, user="root",
                 password="", database="vernemq_db", timeout=5.0):
        super().__init__(host, port, timeout)
        self.user = user
        self.password = password or ""
        self.database = database
        self._seq = 0

    # packet framing: 3-byte little-endian length + 1-byte sequence id
    def _send_packet(self, payload: bytes) -> None:
        s = self._ensure()
        s.sendall(len(payload).to_bytes(3, "little")
                  + bytes([self._seq & 0xFF]) + payload)
        self._seq += 1

    def _read_packet(self) -> bytes:
        head = self._recv_exact(4)
        n = int.from_bytes(head[:3], "little")
        self._seq = head[3] + 1
        return self._recv_exact(n)

    @staticmethod
    def _lenenc(data: bytes, off: int) -> Tuple[Optional[int], int]:
        first = data[off]
        if first < 0xFB:
            return first, off + 1
        if first == 0xFB:  # NULL
            return None, off + 1
        if first == 0xFC:
            return int.from_bytes(data[off + 1:off + 3], "little"), off + 3
        if first == 0xFD:
            return int.from_bytes(data[off + 1:off + 4], "little"), off + 4
        return int.from_bytes(data[off + 1:off + 9], "little"), off + 9

    def _lenenc_str(self, data: bytes, off: int) -> Tuple[Optional[bytes], int]:
        n, off = self._lenenc(data, off)
        if n is None:
            return None, off
        return data[off:off + n], off + n

    def _on_connect(self) -> None:
        self._seq = 0
        greet = self._read_packet()
        if greet[:1] == b"\xff":
            raise PoolError(f"mysql: {self._err_text(greet)}")
        # v10 handshake: version byte, server version (nul), thread id,
        # 8 bytes auth data, filler, caps, ..., 12+ more auth bytes
        off = 1
        off = greet.index(b"\0", off) + 1   # server version
        off += 4                             # thread id
        salt = greet[off:off + 8]
        off += 8 + 1                         # auth-part-1 + filler
        off += 2 + 1 + 2 + 2                 # caps-lo, charset, status, caps-hi
        alen = greet[off]
        off += 1 + 10                        # auth data len + reserved
        part2 = greet[off:off + max(13, alen - 8)]
        salt = salt + part2.rstrip(b"\0")[:12]
        token = self._native_token(salt)
        CLIENT_PROTOCOL_41 = 0x0200
        CLIENT_SECURE_CONNECTION = 0x8000
        CLIENT_PLUGIN_AUTH = 0x80000
        CLIENT_CONNECT_WITH_DB = 0x08
        caps = (CLIENT_PROTOCOL_41 | CLIENT_SECURE_CONNECTION
                | CLIENT_PLUGIN_AUTH | CLIENT_CONNECT_WITH_DB)
        resp = (struct.pack("<IIB23x", caps, 1 << 24, 33)
                + self.user.encode() + b"\0"
                + bytes([len(token)]) + token
                + (self.database or "").encode() + b"\0"
                + b"mysql_native_password\0")
        self._send_packet(resp)
        ok = self._read_packet()
        if ok[:1] == b"\xff":
            raise PoolError(f"mysql: {self._err_text(ok)}")
        if ok[:1] == b"\xfe":
            raise PoolError("mysql: server requested an auth switch "
                            "(only mysql_native_password is supported)")

    def _native_token(self, salt: bytes) -> bytes:
        if not self.password:
            return b""
        s1 = hashlib.sha1(self.password.encode()).digest()
        s2 = hashlib.sha1(s1).digest()
        s3 = hashlib.sha1(salt + s2).digest()
        return bytes(a ^ b for a, b in zip(s1, s3))

    @staticmethod
    def _err_text(pkt: bytes) -> str:
        # 0xff, errno(2), '#' + sqlstate(5) when CLIENT_PROTOCOL_41
        body = pkt[3:]
        if body[:1] == b"#":
            body = body[6:]
        return body.decode("utf-8", "replace")

    @staticmethod
    def _escape(v) -> str:
        if v is None:
            return "NULL"
        if v is True:
            return "1"
        if v is False:
            return "0"
        if isinstance(v, (int, float)):
            return str(v)
        # strings go out as hex literals (X'...'): no escaping at all, so
        # the encoding is immune to sql_mode — backslash-escaping would be
        # injectable under NO_BACKSLASH_ESCAPES, and '' doubling under the
        # default mode if the value ends with a backslash. A bare hex
        # literal is binary-charset though, which would force byte-exact
        # (case/trailing-space sensitive) comparisons against text
        # columns; CONVERT(... USING utf8mb4) restores the text charset
        # so comparisons use the column's collation like a quoted
        # literal would. Raw bytes stay binary.
        if isinstance(v, bytes):
            return "X'" + v.hex() + "'" if v else "''"
        try:
            b = str(v).encode("utf-8")
        except UnicodeEncodeError:
            # non-UTF-8 bytes smuggled through surrogateescape (binary
            # MQTT passwords): CONVERT would truncate at the first bad
            # byte — keep the byte-exact binary literal instead
            b = str(v).encode("utf-8", "surrogateescape")
            return "X'" + b.hex() + "'" if b else "''"
        if not b:
            return "''"
        return f"CONVERT(X'{b.hex()}' USING utf8mb4)"

    def _substitute(self, sql: str, params) -> str:
        """Replace ``?`` placeholders outside string literals; placeholder
        and parameter counts must agree exactly (a silently dropped
        parameter in an auth query could skip the password predicate)."""
        out = []
        it = iter(params)
        used = 0
        in_str: Optional[str] = None
        i = 0
        while i < len(sql):
            c = sql[i]
            if in_str:
                out.append(c)
                if c == "\\" and i + 1 < len(sql):
                    out.append(sql[i + 1])
                    i += 1
                elif c == in_str:
                    in_str = None
            elif c in ("'", '"'):
                in_str = c
                out.append(c)
            elif c == "?":
                try:
                    out.append(self._escape(next(it)))
                    used += 1
                except StopIteration:
                    raise PoolError("mysql: more ? placeholders than "
                                    "parameters") from None
            else:
                out.append(c)
            i += 1
        if used != len(params):
            raise PoolError(f"mysql: {len(params)} parameters for "
                            f"{used} ? placeholders")
        return "".join(out)

    def execute(self, sql: str, *params) -> List[Dict[str, Any]]:
        with self.lock:
            try:
                return self._execute(sql, params)
            except PoolError as e:
                if str(e).startswith("mysql:"):
                    raise  # server-reported: do not blind-retry
                self._connect()
                return self._execute(sql, params)
            except OSError:
                self._connect()
                return self._execute(sql, params)

    def _execute(self, sql: str, params) -> List[Dict[str, Any]]:
        self._ensure()
        self._seq = 0
        self._send_packet(b"\x03" + self._substitute(sql, params).encode())
        first = self._read_packet()
        if first[:1] == b"\xff":
            raise PoolError(f"mysql: {self._err_text(first)}")
        if first[:1] == b"\x00":   # OK packet (no result set)
            return []
        ncols, _ = self._lenenc(first, 0)
        cols: List[str] = []
        for _ in range(ncols):
            cdef = self._read_packet()
            # column def 41: catalog, schema, table, org_table, name, ...
            off = 0
            parts = []
            for _f in range(5):
                v, off = self._lenenc_str(cdef, off)
                parts.append(v)
            cols.append((parts[4] or b"").decode())
        eof = self._read_packet()
        if eof[:1] != b"\xfe":
            raise PoolError("mysql: missing EOF after column definitions")
        rows: List[Dict[str, Any]] = []
        while True:
            pkt = self._read_packet()
            if pkt[:1] == b"\xfe" and len(pkt) < 9:   # EOF
                return rows
            if pkt[:1] == b"\xff":
                raise PoolError(f"mysql: {self._err_text(pkt)}")
            off = 0
            row: Dict[str, Any] = {}
            for i in range(ncols):
                v, off = self._lenenc_str(pkt, off)
                row[cols[i]] = None if v is None else v.decode(
                    "utf-8", "replace")
            rows.append(row)


# ----------------------------------------------------------------- postgres


class PostgresPool(_SocketClient):
    """PostgreSQL v3 wire protocol, extended-query flow with text-format
    params/results (``vmq_lvldb`` has no seat here — this is purely the
    epgsql role for auth scripts: ``postgres.execute(pool, sql, $1...)``).

    Auth supported: trust, cleartext password (3), MD5 (5). SCRAM is not
    implemented — the operator points the broker at a user with md5 or
    password auth (or trust on localhost), as was the norm for the
    reference's epgsql era."""

    def __init__(self, host="127.0.0.1", port=5432, user="vmq",
                 password="", database="vmq", timeout=5.0):
        super().__init__(host, port, timeout)
        self.user = user
        self.password = password or ""
        self.database = database

    # wire helpers
    def _send_msg(self, type_: bytes, payload: bytes) -> None:
        s = self._ensure()
        s.sendall(type_ + struct.pack(">I", len(payload) + 4) + payload)

    def _read_msg(self) -> Tuple[bytes, bytes]:
        t = self._recv_exact(1)
        (n,) = struct.unpack(">I", self._recv_exact(4))
        return t, self._recv_exact(n - 4)

    def _on_connect(self) -> None:
        # StartupMessage (no type byte): protocol 3.0 + params
        params = (f"user\0{self.user}\0database\0{self.database}\0\0"
                  .encode())
        payload = struct.pack(">I", 196608) + params
        self.sock.sendall(struct.pack(">I", len(payload) + 4) + payload)
        while True:
            t, body = self._read_msg()
            if t == b"R":
                (code,) = struct.unpack(">I", body[:4])
                if code == 0:        # AuthenticationOk
                    continue
                if code == 3:        # CleartextPassword
                    self._send_msg(b"p", self.password.encode() + b"\0")
                    continue
                if code == 5:        # MD5Password
                    salt = body[4:8]
                    inner = hashlib.md5(
                        (self.password + self.user).encode()).hexdigest()
                    outer = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._send_msg(b"p", b"md5" + outer.encode() + b"\0")
                    continue
                raise PoolError(f"postgres: unsupported auth method {code}"
                                " (use trust/password/md5)")
            elif t == b"E":
                raise PoolError(f"postgres: {self._parse_error(body)}")
            elif t == b"Z":          # ReadyForQuery
                return
            # S (ParameterStatus) / K (BackendKeyData): ignore

    @staticmethod
    def _parse_error(body: bytes) -> str:
        fields = {}
        for part in body.split(b"\0"):
            if part:
                fields[chr(part[0])] = part[1:].decode("utf-8", "replace")
        return fields.get("M", "unknown error")

    def execute(self, sql: str, *params) -> List[Dict[str, Any]]:
        """Run one parameterised statement; returns rows as dicts keyed
        by column name (the shape the bundled Lua scripts index:
        ``row.publish_acl``)."""
        with self.lock:
            try:
                return self._execute(sql, params)
            except (OSError, PoolError) as e:
                if isinstance(e, PoolError) and "postgres:" in str(e):
                    raise  # server-reported error: do not blind-retry
                self._connect()
                return self._execute(sql, params)

    def _execute(self, sql: str, params) -> List[Dict[str, Any]]:
        self._ensure()
        # Parse (unnamed statement) / Bind (text params, text results) /
        # Describe portal / Execute / Sync
        self._send_msg(b"P", b"\0" + sql.encode() + b"\0"
                       + struct.pack(">H", 0))
        bind = [b"\0\0", struct.pack(">H", 0),
                struct.pack(">H", len(params))]
        for p in params:
            if p is None:
                bind.append(struct.pack(">i", -1))
            else:
                b = (p if isinstance(p, bytes)
                     else _pg_text(p).encode())
                bind.append(struct.pack(">I", len(b)) + b)
        bind.append(struct.pack(">H", 0))
        self._send_msg(b"B", b"".join(bind))
        self._send_msg(b"D", b"P\0")
        self._send_msg(b"E", b"\0" + struct.pack(">I", 0))
        self._send_msg(b"S", b"")

        cols: List[str] = []
        rows: List[Dict[str, Any]] = []
        err: Optional[str] = None
        while True:
            t, body = self._read_msg()
            if t == b"T":            # RowDescription
                (n,) = struct.unpack(">H", body[:2])
                cols = []
                off = 2
                for _ in range(n):
                    end = body.index(b"\0", off)
                    cols.append(body[off:end].decode())
                    off = end + 1 + 18  # fixed per-field tail
            elif t == b"D":          # DataRow
                (n,) = struct.unpack(">H", body[:2])
                off = 2
                row: Dict[str, Any] = {}
                for i in range(n):
                    (ln,) = struct.unpack(">i", body[off:off + 4])
                    off += 4
                    if ln < 0:
                        val = None
                    else:
                        val = body[off:off + ln].decode("utf-8", "replace")
                        off += ln
                    row[cols[i] if i < len(cols) else str(i + 1)] = val
                rows.append(row)
            elif t == b"E":
                err = self._parse_error(body)
            elif t == b"Z":          # ReadyForQuery — done
                if err is not None:
                    raise PoolError(f"postgres: {err}")
                return rows
            # C (CommandComplete), 1/2 (Parse/BindComplete), n — ignore


def _pg_text(p) -> str:
    if p is True:
        return "t"
    if p is False:
        return "f"
    return str(p)


# ------------------------------------------------------------- client pools


class ClientPool:
    """N independently-connected clients behind one facade — the poolboy
    seat of the reference's vmq_diversity pools: auth hooks run on
    executor threads, and a single socket+lock would serialise every
    datastore query in the broker. Method calls check a client out of
    the free queue (blocking up to ``checkout_timeout``), run, and check
    it back in; non-callable attributes (host/port/...) read through to
    the first client."""

    def __init__(self, factory, size: int = 5,
                 checkout_timeout: float = 10.0):
        self._clients = [factory() for _ in range(max(1, int(size)))]
        self._free: queue.Queue = queue.Queue()
        for c in self._clients:
            self._free.put(c)
        self._timeout = checkout_timeout

    def _call(self, name, *args, **kw):
        try:
            c = self._free.get(timeout=self._timeout)
        except queue.Empty:
            raise PoolError(
                f"pool exhausted: all {len(self._clients)} connections "
                f"busy for {self._timeout}s") from None
        try:
            return getattr(c, name)(*args, **kw)
        finally:
            self._free.put(c)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        attr = getattr(self._clients[0], name)
        if not callable(attr):
            return attr
        wrapper = (self._close_all if name == "close"
                   else functools.partial(self._call, name))
        # cache so subsequent lookups skip __getattr__ entirely (this is
        # the auth-hook hot path)
        self.__dict__[name] = wrapper
        return wrapper

    def _close_all(self):
        for c in self._clients:
            try:
                c.close()
            except Exception:
                pass

    @property
    def size(self) -> int:
        return len(self._clients)


# ------------------------------------------------------------ pool registry

#: pool_id → client, per driver kind
POOL_REGISTRIES: Dict[str, Dict[str, Any]] = {
    "redis": {}, "memcached": {}, "postgres": {}, "mysql": {},
    "mongodb": {},
}

#: pool_id -> the config dict it was created with (secrets included —
#: in-process only, never serialised); lets per-pool settings like
#: mysql password_hash_method be resolved after creation
POOL_CONFIGS: Dict[str, Dict[str, Dict[str, Any]]] = {
    k: {} for k in POOL_REGISTRIES
}

_FACTORIES = {
    "redis": lambda cfg: RedisPool(
        host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 6379),
        password=cfg.get("password"), database=cfg.get("database", 0)),
    "memcached": lambda cfg: MemcachedPool(
        host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 11211)),
    "postgres": lambda cfg: PostgresPool(
        host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 5432),
        user=cfg.get("user", "root"), password=cfg.get("password", ""),
        database=cfg.get("database", "vernemq_db")),
    "mysql": lambda cfg: MysqlPool(
        host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 3306),
        user=cfg.get("user", "root"), password=cfg.get("password", ""),
        database=cfg.get("database", "vernemq_db")),
    "mongodb": lambda cfg: MongodbPool(
        host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 27017),
        user=cfg.get("login") or cfg.get("user"),
        password=cfg.get("password", ""),
        database=cfg.get("database", "vernemq_db")),
}


def _build(kind: str, config: Dict[str, Any]):
    """A ClientPool of ``size`` lazily-connecting clients (the
    reference's per-pool ``size`` knob; poolboy default 5)."""
    return ClientPool(lambda: _FACTORIES[kind](config),
                      size=config.get("size", 5))


def ensure_pool(kind: str, config: Dict[str, Any]) -> str:
    """Create (or reuse) a named pool; returns the pool id. Mirrors the
    Lua-visible ``<driver>.ensure_pool{pool_id=...}`` contract."""
    if kind not in _FACTORIES:
        raise PoolError(f"unknown datastore kind {kind!r}")
    pool_id = str(config.get("pool_id") or f"{kind}_default")
    reg = POOL_REGISTRIES[kind]
    cfg = dict(config)
    if pool_id not in reg:
        reg[pool_id] = _build(kind, config)
        POOL_CONFIGS[kind][pool_id] = cfg
    elif POOL_CONFIGS[kind].get(pool_id) != cfg:
        # re-declared with different settings (script reload): rebuild so
        # the new host/credentials/options actually apply — otherwise a
        # reload would report success while the pool silently kept its
        # old connection settings
        old = reg[pool_id]
        reg[pool_id] = _build(kind, config)
        POOL_CONFIGS[kind][pool_id] = cfg
        try:
            old.close()
        except Exception:
            pass
    return pool_id


def get_pool(kind: str, pool_id: str):
    try:
        return POOL_REGISTRIES[kind][str(pool_id)]
    except KeyError:
        raise PoolError(f"no such {kind} pool {pool_id!r} "
                        "(call ensure_pool first)") from None
