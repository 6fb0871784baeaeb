"""Observability seams of the match engine: latency histograms
(:mod:`.histogram`), the control-plane event journal (:mod:`.events`) and
the per-dispatch device profiler (:mod:`.profiler`) — copies of the parts
of ``vernemq_tpu/observability`` the matcher, breaker, watchdog and
collector call."""
