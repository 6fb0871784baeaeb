"""Churney: built-in session-churn self-test.

Plays the role of ``vmq_churney.erl`` (201 LoC, part of vmq_swc): spawn
one full MQTT session after another against the local broker — connect,
subscribe, publish qos1, receive own message, disconnect — and histogram
the end-to-end latency, bucketing failures by stage. The reference runs
sessions back-to-back and logs a histogram every 10s; here the loop is
an asyncio task and the histogram is pulled via ``vmq-admin churney
report`` (or the returned stats object).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, Optional

BUCKETS_MS = (1, 2, 5, 10, 25, 50, 100, 250, 1000, float("inf"))


class Churney:
    def __init__(self, broker, host: str, port: int, concurrency: int = 1):
        self.broker = broker
        self.host, self.port = host, port
        self.concurrency = concurrency
        self.histogram: Dict[Any, int] = {}
        self.outcomes: Dict[str, int] = {}
        self.sessions = 0
        self.started = time.time()
        self._tasks: list = []
        self._running = False

    def start(self) -> None:
        self._running = True
        loop = asyncio.get_event_loop()
        for i in range(self.concurrency):
            self._tasks.append(loop.create_task(self._churn(i)))

    def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()

    async def _one_session(self, n: int) -> str:
        """One full session life cycle; returns the outcome stage label
        (the reference buckets DOWN reasons the same way)."""
        from ..client import MQTTClient

        c = MQTTClient(self.host, self.port, client_id=f"churney-{n}")
        try:
            # the client's own timeout covers only the CONNACK read; TCP
            # establishment against a black-holed host needs its own bound
            ack = await asyncio.wait_for(c.connect(timeout=5.0), 7.0)
            if getattr(ack, "rc", 1) != 0:
                return "error_connect"
            topic = f"churney/{n}"
            sub = await c.subscribe(topic, qos=1)
            if sub.reason_codes[0] not in (0, 1):
                return "error_subscribe"
            await c.publish(topic, b"churn", qos=1)
            msg = await c.recv(5.0)
            if msg is None or getattr(msg, "payload", None) != b"churn":
                return "error_deliver"
            await c.disconnect()
            return "ok"
        except asyncio.TimeoutError:
            return "error_timeout"
        except ConnectionError:
            return "error_conn"
        except asyncio.CancelledError:
            raise
        except Exception:  # gaierror, codec errors… never kill the worker
            return "error_other"
        finally:
            await c.close()

    async def _churn(self, worker: int) -> None:
        n = worker
        while self._running:
            t0 = time.perf_counter()
            outcome = await self._one_session(n)
            latency_ms = (time.perf_counter() - t0) * 1000
            self.sessions += 1
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
            for b in BUCKETS_MS:
                if latency_ms <= b:
                    self.histogram[b] = self.histogram.get(b, 0) + 1
                    break
            n += self.concurrency
            await asyncio.sleep(0)  # yield; back-to-back like the reference

    def report(self) -> Dict[str, Any]:
        elapsed = max(time.time() - self.started, 1e-9)
        return {
            "sessions": self.sessions,
            "sessions_per_sec": round(self.sessions / elapsed, 1),
            "outcomes": dict(self.outcomes),
            "latency_histogram_ms": {
                ("inf" if b == float("inf") else b): n
                for b, n in sorted(self.histogram.items())
            },
        }
