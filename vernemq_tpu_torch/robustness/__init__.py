"""Robustness of the device match path: deterministic fault injection
(:mod:`.faults`), the device circuit breaker (:mod:`.breaker`), the stall
watchdog (:mod:`.watchdog`) and the collector's pressure signal
(:mod:`.overload`) — copies of what the matcher and the batch collector
use from ``vernemq_tpu/robustness``."""
