"""Robustness subsystem: deterministic fault injection + circuit breaking.

A production broker must stay up when the device path doesn't — TPU
preemption, compile failures, rebuild stalls, dispatch timeouts. This
package supplies the two halves of that story:

- :mod:`faults` — a seedable :class:`~faults.FaultPlan` registry with
  named injection points threaded through device dispatch, delta-scatter
  uploads, background rebuilds, cluster channels, listener binds and
  msg-store writes, so the failure paths can be *exercised on purpose*
  (and reproduced: identical seeds yield identical injection sequences);
- :mod:`breaker` — the :class:`~breaker.CircuitBreaker` the matchers put
  around device dispatch: N consecutive failures open it, matching
  serves from the exact host trie (degraded mode), a half-open probe
  with exponential backoff + jitter brings the device path back;
- :mod:`overload` — the :class:`~overload.OverloadGovernor` fusing
  loop-lag/RSS/collector-depth/breaker/cluster signals into pressure
  levels 0-3 with staged, cheapest-first shedding (proportional read
  throttle → token buckets + QoS0 shed + replay deferral → connect
  refusal + top-talker disconnects);
- :mod:`watchdog` — the :class:`~watchdog.StallWatchdog` for SILENT
  failures the other three can't see (a dispatch that never returns, a
  half-open peer, a wedged rebuild thread): monitored-operation
  registry, deadline abandonment with sacrificial dispatch, and
  late-result discard so a stale fanout is never delivered.
"""

from . import faults  # noqa: F401
from .breaker import CircuitBreaker  # noqa: F401
from .faults import FaultPlan, FaultRule, InjectedFault  # noqa: F401
from .overload import OverloadGovernor  # noqa: F401
from .watchdog import StallAbandoned, StallWatchdog  # noqa: F401
