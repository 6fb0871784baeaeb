"""Hot-path flight recorder & stage-level latency attribution.

Three pieces, all always-on and cheap enough for the publish hot path:

- :mod:`.histogram` — fixed log-bucket latency histograms following the
  counter-block pattern (per-thread increment buffers, single merge at
  read), one family per load-bearing seam (device dispatch, delta
  scatter, rebuild, collector queue wait, ring round-trip, parse→route,
  queue flush, spool journal write, cluster ack RTT). Exposed as proper
  Prometheus ``_bucket``/``_sum``/``_count`` families and aggregated
  across worker processes at the scrape point via
  ``WorkerStatsBlock`` histogram slots.

- :mod:`.recorder` — the publish-path flight recorder: a bounded ring
  of stage-stamped samples. The 1-in-N sample decision is made ONCE at
  admission and the trace context rides the fold envelope (including
  the shared-memory ring to the match service), so a
  worker→service→device→route publish yields ONE record with per-stage
  deltas spanning both processes.

- :mod:`.profiler` — per-dispatch device profiling records (K, batch
  fill, Bpad/Dpad, compile-vs-execute, delta rows, rebuild timings)
  plus Chrome trace-event JSON export (``vmq-admin timeline dump``,
  loadable in Perfetto).

- :mod:`.events` — the control-plane event journal: a bounded ring of
  registry-checked state-machine transitions (breaker opens, governor
  level changes, watchdog abandons, slice adoptions, spool replays,
  wire fallbacks) with monotonic stamps — ``vmq-admin events
  show|dump``, the QL ``events`` table, instant events in
  ``chrome_trace()``, per-worker shm slots merged at scrape.

- :mod:`.canary` — the canary SLO probe: a loopback subscriber plus a
  periodic synthetic publish through the FULL path, feeding the
  ``e2e_canary_ms`` histogram and an SLO burn counter — the broker's
  continuous black-box end-to-end signal.

A trace resumed from a cluster peer (``FlightRecorder.resume``)
carries the origin node's stamps across the negotiated cluster
envelope, so ONE ``chrome_trace()`` dump renders per-node process
tracks for a publish that crossed the wire (per-peer clock offsets
estimated by :class:`~.recorder.ClockSync` from the spool ack RTT).

The whole subsystem is gated by one flag (``observability_enabled``):
off, every seam pays a single module-global boolean test.
"""

from . import events, histogram
from .histogram import observe, enabled
from .profiler import DispatchProfiler, profiler
from .recorder import (ClockSync, FlightRecorder, PublishTrace,
                       chrome_trace, clock_sync)

__all__ = [
    "events", "histogram", "observe", "enabled",
    "DispatchProfiler", "profiler",
    "ClockSync", "FlightRecorder", "PublishTrace", "chrome_trace",
    "clock_sync",
]
