"""Graphite reporter: periodic plaintext-protocol push of all metrics
(``vmq_graphite.erl:118-130`` — one ``<prefix>vmq.<node>.<metric> <value>
<ts>\\n`` line per metric over TCP, reconnect on failure)."""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

log = logging.getLogger("vernemq_tpu_torch.graphite")


class GraphiteReporter:
    def __init__(self, broker):
        self.broker = broker
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._run())
        self.broker._bg_tasks.append(self._task)

    async def _run(self) -> None:
        cfg = self.broker.config
        writer: Optional[asyncio.StreamWriter] = None
        # connect/reconnect pacing follows the graphite_*_timeout knobs
        # (vmq_graphite.erl connect_timeout / reconnect backoff)
        connect_timeout = float(cfg.get("graphite_connect_timeout", 5.0))
        reconnect_wait = float(cfg.get("graphite_reconnect_timeout", 10.0))
        if cfg.graphite_interval <= 0:
            return  # 0 = disabled (reference schema graphite_interval)
        while True:
            await asyncio.sleep(cfg.graphite_interval)
            if writer is None:
                try:
                    _, writer = await asyncio.wait_for(
                        asyncio.open_connection(cfg.graphite_host,
                                                cfg.graphite_port),
                        connect_timeout)
                except (OSError, asyncio.TimeoutError) as e:
                    log.debug("graphite connect failed: %s", e)
                    await asyncio.sleep(
                        max(0.0, reconnect_wait - cfg.graphite_interval))
                    continue
            prefix = cfg.graphite_prefix
            if prefix and not prefix.endswith("."):
                prefix += "."
            # hosted-graphite API key is the leading path segment
            api_key = cfg.get("graphite_api_key", "")
            if api_key:
                prefix = f"{api_key}.{prefix}"
            node = self.broker.node_name
            now = int(time.time())
            lines = [
                f"{prefix}vmq.{node}.{name} {value} {now}\n"
                for name, value in self.broker.metrics.all_metrics().items()
            ]
            # histogram families go out as bucket-derived quantile
            # summaries (<name>.p50/p99/p999) — parity with the
            # Prometheus _bucket surface without shipping 33 bucket
            # series per family over plaintext
            from ..observability import histogram as _hist

            for name, snap in sorted(
                    self.broker.metrics.histogram_snapshot().items()):
                counts, _s, n_obs = snap
                if not n_obs:
                    continue
                for key, q in (("p50", 0.50), ("p99", 0.99),
                               ("p999", 0.999)):
                    v = _hist.quantile(counts, q)
                    if v is not None:
                        lines.append(f"{prefix}vmq.{node}.{name}.{key} "
                                     f"{round(v, 4)} {now}\n")
            try:
                writer.write("".join(lines).encode())
                await writer.drain()
            except (OSError, ConnectionError):
                try:
                    writer.close()
                except Exception:
                    pass
                writer = None
