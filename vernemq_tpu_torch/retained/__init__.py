"""The GPU-resident retained-message index: device retained-topic table +
batched reverse matching (the subscribe-storm replay engine), the port of
``vernemq_tpu/retained/``.

Pieces:
- :mod:`.table` — host-side bucketed retained-topic table (numpy mirrors,
  dirty-slot delta tracking, interned word ids);
- :mod:`.index` — :class:`RetainedIndex` (device mirror + batched
  reverse-match serving behind a circuit breaker) and
  :class:`RetainedEngine` (one index per mountpoint);
- :mod:`.collector` — :class:`RetainedBatchCollector`, coalescing
  concurrent SUBSCRIBE replays into super-batched dispatches.

The device program lives in :mod:`vernemq_tpu_torch.ops.reverse_kernel`,
its hand kernel in :mod:`vernemq_tpu_torch.ops.reverse_tiles`.
"""

from .collector import RetainedBatchCollector  # noqa: F401
from .index import RetainedEngine, RetainedIndex  # noqa: F401
from .table import RetainedTopicTable  # noqa: F401
