"""Payload filtering & windowed aggregation (the MQTT+ broker surface).

Subscriptions gain an optional content predicate and/or aggregation
window expressed as an MQTT+-style suffix on the topic filter
(``sensors/+/temp?$gt(value,30)``); publishes on schema-registered
topics are decoded into fixed-width float32 feature rows and the
matched fanout shrinks on-device as a second phase behind topic match
(``ops/predicate_kernel.py``), with the exact host evaluator standing
by behind the CircuitBreaker/StallWatchdog machinery.

- :mod:`.predicate` — filter-suffix grammar, compiler, host evaluator;
- :mod:`.schema_registry` — per-mountpoint payload schemas, replicated
  through the metadata plane like the mesh slice map;
- :mod:`.engine` — the serving engine (device phase, window table,
  synthesized aggregate PUBLISHes, degradation discipline).
"""

from .predicate import (  # noqa: F401
    FilterError,
    FilterSpec,
    parse_filter,
    split_filter_suffix,
)
from .schema_registry import SchemaRegistry, TopicSchema  # noqa: F401
