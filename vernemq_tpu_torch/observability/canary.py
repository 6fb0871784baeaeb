"""Canary SLO probe: a continuous black-box end-to-end latency signal.

A loopback subscriber plus a periodic synthetic publish that rides the
FULL production path — admission gates, retain short-circuit, the batch
collector (and therefore the device matcher when the tpu view serves),
route_rows, queue delivery — so the ``e2e_canary_ms`` histogram is the
first number that moves when ANY stage of that path degrades, before
any real client notices. Each probe past ``canary_slo_ms`` burns the
``canary_slo_breaches`` counter and emits a ``canary_slo_breach``
journal event; a probe that never arrives within the probe interval
counts ``canary_timeouts`` (the strongest possible signal: the path is
not just slow, it is broken).

The probe topic lives under ``$canary/`` — ``$``-prefixed topics never
match ``#``/``+`` wildcards of ordinary subscriptions (MQTT spec), so
the canary is invisible to real subscribers and its subscription row is
the only routing-table footprint. The loopback "session" is a minimal
queue consumer (the bridge-endpoint seat): ``proto_ver = 5`` keeps it
out of the shared-frame QoS0 fanout collection, so delivery always
lands in :meth:`_deliver` with the Msg in hand.

Gated like everything else in this package: ``canary_enabled`` AND
``observability_enabled``; off, the broker never constructs the probe.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Any, Dict, Optional

from . import events
from . import histogram as hist

log = logging.getLogger("vernemq_tpu_torch.observability")


class CanaryProbe:
    """One per broker (``broker.canary``); ``run()`` is supervised."""

    #: fan0/fast-path classifiers read these; PROTO 5 + no transport
    #: routes every delivery through the queue's deliver callable
    proto_ver = 5
    closed = False

    def __init__(self, broker, interval_ms: float = 1000.0,
                 slo_ms: float = 250.0):
        self.broker = broker
        self.interval_s = max(0.01, float(interval_ms) / 1e3)
        self.slo_ms = float(slo_ms)
        self.sid = ("", f"$canary-{broker.node_name}")
        self.words = ("$canary", "probe")
        self._seq = 0
        self._inflight: Dict[int, float] = {}  # seq -> send monotonic
        self.probes = 0
        self.received = 0
        self.slo_breaches = 0
        self.timeouts = 0
        self.last_e2e_ms: Optional[float] = None
        self._armed = False

    # ------------------------------------------------------------- loopback

    def arm(self) -> None:
        """Create the loopback queue + subscription (idempotent)."""
        if self._armed:
            return
        from ..broker.queue import QueueOpts
        from ..protocol.types import SubOpts

        reg = self.broker.registry
        q = reg.queues.get(self.sid)
        if q is None:
            q = reg._start_queue(self.sid, QueueOpts(clean_session=True))
        q.add_session(self, self._deliver)
        reg.subscribe(self.sid, [(list(self.words), SubOpts(qos=0))])
        self._armed = True

    def disarm(self) -> None:
        if not self._armed:
            return
        self._armed = False
        reg = self.broker.registry
        try:
            reg.unsubscribe(self.sid, [list(self.words)])
        except Exception:
            pass  # netsplit CAP gate at shutdown: the queue teardown wins
        q = reg.queues.get(self.sid)
        if q is not None:
            q.del_session(self)
            q.terminate("canary_disarm")

    def _deliver(self, msg) -> bool:
        """Queue delivery callback: close the loop, feed the histogram,
        burn the SLO counter on a breach."""
        try:
            (seq,) = struct.unpack_from(">Q", msg.payload, 0)
        except (struct.error, TypeError):
            return True  # foreign publish on the canary topic: ignore
        t0 = self._inflight.pop(seq, None)
        if t0 is None:
            return True  # late arrival already counted as a timeout
        e2e_ms = (time.monotonic() - t0) * 1e3
        self.received += 1
        self.last_e2e_ms = round(e2e_ms, 4)
        hist.observe("e2e_canary_ms", e2e_ms)
        if e2e_ms > self.slo_ms:
            self.slo_breaches += 1
            events.emit("canary_slo_breach", detail=self.broker.node_name,
                        value=round(e2e_ms, 3))
        return True

    # ---------------------------------------------------------------- probe

    async def _probe_once(self) -> None:
        from ..broker.message import Msg

        self._seq += 1
        seq = self._seq
        payload = struct.pack(">Qd", seq, time.time())
        msg = Msg(topic=self.words, payload=payload, qos=0, mountpoint="")
        # register the inflight slot BEFORE routing: a same-tick
        # loopback delivery races the publish call itself
        self._inflight[seq] = time.monotonic()
        self.probes += 1
        reg = self.broker.registry
        try:
            # mirror the session routing split exactly: the batched
            # view (collector staging -> device fold) when it serves,
            # else the synchronous fold — the canary must measure the
            # path real publishes take, not a private shortcut
            if reg.batched_view_active():
                await reg.publish_async(msg)
            else:
                reg.publish(msg)
        except RuntimeError:
            # not_ready (netsplit CAP gate): the probe was never
            # injected — roll back so the sweep can't count a publish
            # that never happened as a path-dropped timeout
            self._inflight.pop(seq, None)
            self.probes -= 1

    def _sweep_timeouts(self) -> None:
        """A probe older than one full interval that never arrived is a
        timeout — the black-box 'path is broken' signal. Bounded: at
        most interval/interval entries are ever in flight."""
        cutoff = time.monotonic() - max(self.interval_s, 5.0)
        for seq, t0 in list(self._inflight.items()):
            if t0 < cutoff:
                del self._inflight[seq]
                self.timeouts += 1
                log.warning("canary probe %d never arrived (> %.1fs): "
                            "the end-to-end path is dropping synthetic "
                            "publishes", seq, max(self.interval_s, 5.0))

    async def run(self) -> None:
        """The supervised probe loop. Arming retries through not_ready
        (the netsplit CAP gate at a clustered boot): raising there
        would crash-loop the supervised task into its restart budget —
        an opt-in probe must never escalate into a listener teardown."""
        while True:
            try:
                self.arm()
                break
            except RuntimeError:
                await asyncio.sleep(self.interval_s)
        try:
            while True:
                await asyncio.sleep(self.interval_s)
                if not hist.enabled():
                    continue
                self._sweep_timeouts()
                await self._probe_once()
        finally:
            self.disarm()

    # ------------------------------------------------------- introspection

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "canary_probes": float(self.probes),
            "canary_received": float(self.received),
            "canary_slo_breaches": float(self.slo_breaches),
            "canary_timeouts": float(self.timeouts),
        }
        if self.last_e2e_ms is not None:
            out["canary_last_e2e_ms"] = self.last_e2e_ms
        return out


#: gauge HELP for the broker's provider (register_gauges descriptions)
GAUGE_HELP: Dict[str, str] = {
    "canary_probes": "Synthetic canary publishes sent through the full "
                     "end-to-end path.",
    "canary_received": "Canary probes that completed the loopback "
                       "delivery.",
    "canary_slo_breaches": "Canary probes whose end-to-end latency "
                           "exceeded canary_slo_ms (the SLO burn "
                           "counter).",
    "canary_timeouts": "Canary probes that never arrived within a full "
                       "probe interval (the path dropped them).",
    "canary_last_e2e_ms": "Most recent canary end-to-end latency "
                          "(milliseconds).",
}
