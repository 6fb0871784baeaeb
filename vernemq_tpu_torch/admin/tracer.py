"""Live per-client session tracing.

Plays the role of ``vmq_tracer.erl`` (791 LoC): ``vmq-admin trace client
client-id=X`` attaches a trace to every current and future session of a
client and pretty-prints each MQTT frame in/out, rate-limited and with
payload truncation (``max_rate`` / ``payload_limit``,
``vmq_tracer.erl:45-48,106-122``; the rate limiter shape ``:377-390``).

The reference implements this with ``erlang:trace/3`` + match specs on
the FSM functions (``:340-350,392-444``) — VM-level tracing with zero
cost when off. Here the session layer calls ``broker.trace_frame``
directly; the whole path is behind a ``broker.tracer is None`` check so
the untraced hot path pays one attribute test. Single tracer at a time,
like the reference (``:73``: "another trace is already running")."""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional, Tuple

from ..protocol.types import (
    Auth, Connack, Connect, Disconnect, Pingreq, Pingresp, Puback, Pubcomp,
    Publish, Pubrec, Pubrel, Suback, Subscribe, Unsuback, Unsubscribe,
)


def _fmt_payload(payload: bytes, limit: int) -> str:
    shown = payload[:limit] if limit else payload
    txt = repr(shown)
    if limit and len(payload) > limit:
        txt += f"... ({len(payload)} bytes)"
    return txt


def format_frame(direction: str, client_id: str, frame: Any,
                 payload_limit: int = 1000) -> str:
    """One human line per frame (format_frame, vmq_tracer.erl:475+)."""
    t = type(frame)
    if t is Connect:
        body = (f"CONNECT c: {frame.client_id!r} v: {frame.proto_ver} "
                f"u: {frame.username!r} ks: {frame.keepalive} "
                f"cs: {int(frame.clean_start)}")
    elif t is Connack:
        body = f"CONNACK rc: {frame.rc} sp: {int(frame.session_present)}"
    elif t is Publish:
        body = (f"PUBLISH(d{int(frame.dup)}, q{frame.qos}, "
                f"r{int(frame.retain)}, m{frame.packet_id or 0}) "
                f"{frame.topic!r} {_fmt_payload(frame.payload, payload_limit)}")
    elif t is Subscribe:
        tops = ", ".join(f"{tp!r}/q{so.qos}" for tp, so in frame.topics)
        body = f"SUBSCRIBE(m{frame.packet_id}) [{tops}]"
    elif t is Suback:
        body = f"SUBACK(m{frame.packet_id}) {list(frame.reason_codes)}"
    elif t is Unsubscribe:
        body = f"UNSUBSCRIBE(m{frame.packet_id}) {list(frame.topics)}"
    elif t is Unsuback:
        body = f"UNSUBACK(m{frame.packet_id})"
    elif t in (Puback, Pubrec, Pubrel, Pubcomp):
        body = f"{t.__name__.upper()}(m{frame.packet_id})"
    elif t is Pingreq:
        body = "PINGREQ"
    elif t is Pingresp:
        body = "PINGRESP"
    elif t is Disconnect:
        body = f"DISCONNECT rc: {getattr(frame, 'reason_code', 0)}"
    elif t is Auth:
        body = f"AUTH rc: {frame.reason_code}"
    else:
        body = t.__name__.upper()
    arrow = "RECV" if direction == "in" else "SEND"
    ts = time.strftime("%H:%M:%S", time.localtime())
    return f"{ts} [{client_id}] MQTT {arrow}: {body}"


class Tracer:
    """One active trace (the vmq_tracer gen_server + rate_tracer pair)."""

    def __init__(self, client_id: str, mountpoint: str = "",
                 max_rate: Tuple[int, float] = (10, 0.1),
                 payload_limit: int = 1000,
                 sink: Optional[Callable[[str], None]] = None,
                 buffer_size: int = 10_000,
                 metrics: Optional[Any] = None):
        self.client_id = client_id
        self.mountpoint = mountpoint
        self.max_rate = max_rate  # (messages, seconds) — recon-style
        self.payload_limit = payload_limit
        self.sink = sink
        self.metrics = metrics  # trace_rate_limited counter sink
        self.lines: Deque[str] = deque(maxlen=buffer_size)
        self._rate_count = 0
        self._rate_start = time.monotonic()
        self.rate_tripped = False
        self.started = time.time()
        self.traced_frames = 0
        # frames the rate limiter dropped: per-window (for the '... N
        # frames suppressed' marker when the window reopens) and total
        self._suppressed_window = 0
        self.suppressed_frames = 0

    def matches(self, mountpoint: str, client_id: Optional[str]) -> bool:
        return client_id == self.client_id and mountpoint == self.mountpoint

    def _emit(self, line: str) -> None:
        self.lines.append(line)
        if self.sink is not None:
            self.sink(line)

    def _rate_ok(self) -> bool:
        """Allowance check (rate_tracer, vmq_tracer.erl:377-390): at most
        ``max`` events per ``interval``; when tripped, one notice line,
        and the drops are COUNTED — the window-reopen marker says how
        many frames the trace is missing, so a traced storm reads as
        visibly truncated instead of quietly complete."""
        maxn, interval = self.max_rate
        now = time.monotonic()
        if now - self._rate_start > interval:
            if self._suppressed_window:
                self._emit(f"... {self._suppressed_window} frames "
                           "suppressed")
                self._suppressed_window = 0
            self._rate_start = now
            self._rate_count = 0
            self.rate_tripped = False
        if self._rate_count < maxn:
            self._rate_count += 1
            return True
        if not self.rate_tripped:
            self.rate_tripped = True
            self._emit("Trace rate limit triggered, dropping.")
        self._suppressed_window += 1
        self.suppressed_frames += 1
        if self.metrics is not None:
            self.metrics.incr("trace_rate_limited")
        return False

    def trace(self, direction: str, client_id: str, frame: Any) -> None:
        self.traced_frames += 1
        if self._rate_ok():
            self._emit(format_frame(direction, client_id, frame,
                                    self.payload_limit))

    def session_event(self, text: str) -> None:
        self._emit(f"{time.strftime('%H:%M:%S')} [{self.client_id}] {text}")

    def drain(self) -> List[str]:
        out = list(self.lines)
        self.lines.clear()
        return out

    def info(self) -> dict:
        return {
            "client_id": self.client_id,
            "mountpoint": self.mountpoint,
            "started": self.started,
            "traced_frames": self.traced_frames,
            "suppressed_frames": self.suppressed_frames,
            "buffered_lines": len(self.lines),
        }
