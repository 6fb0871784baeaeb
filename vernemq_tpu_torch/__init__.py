"""PyTorch/CUDA port of the vernemq_tpu device match engine.

The batched wildcard subscription matcher (``models/matcher.py``:
``GpuMatcher``, ``GpuRegView``) over a device-resident subscription table,
with the probe-window tile matcher as a hand-written Hopper kernel
(``csrc/tile_match.cu``). The package imports ``torch`` and numpy only; the
JAX package it was ported from is its reference in the tests.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
