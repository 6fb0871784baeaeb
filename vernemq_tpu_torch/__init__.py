"""PyTorch/CUDA port of vernemq_tpu: the MQTT broker with its subscription
matcher on a CUDA GPU.

The broker (``broker/``, served by ``python -m
vernemq_tpu_torch.broker.server``) routes every PUBLISH through the batched
wildcard subscription matcher (``models/matcher.py``: ``BatchCollector``,
``GpuRegView``, ``GpuMatcher``) over a device-resident subscription table,
with the probe-window tile matcher as a hand-written Hopper kernel
(``csrc/tile_match.cu``). The package imports ``torch`` and numpy, never
JAX or the JAX package it was ported from, which is its reference in the
tests.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
