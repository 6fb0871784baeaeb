"""Operator tools of the port: instruments that drive the GPU engine on the
card and print what it costs.

- :mod:`.corpus`: the headline corpus (bench.py's mix) and its zipf
  publish stream, one code for the tools and ``chip_smoke.py``.
- :mod:`.roofline`: the tile kernel's bound per batch at the port's
  geometry, and with ``--probe`` the K-window ladder that splits the
  per-dispatch host cost from the per-window device cost.
- :mod:`.tune_windowed`: the geometry sweep (tile width, window fairness,
  dense tile, batch, flat capacity).
- :mod:`.collector_latency`: the collector's added latency over the trie
  at paced arrival rates.
- :mod:`.loadtest` and :mod:`.worker_efficiency`: MQTT clients over TCP
  against the port's broker, in one process or through worker mode.
- :mod:`.probe_overhead`: the host time of each hand-kernel wrapper call
  and of an empty launch.

Each runs with ``python -m vernemq_tpu_torch.tools.<name>``, on the CUDA
card by default (``RuntimeError`` without one); ``--device cpu`` runs the
plain PyTorch path at a smoke size.
"""
