"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. The default is the CUDA
card; without one it raises instead of quietly running on the CPU. The CPU
is used only when the caller asks for it (the tests do), and then every
kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (default ``cuda``); raises
    ``RuntimeError`` for a CUDA device when CUDA is not available."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the match engine runs on the GPU. "
            "Pass device='cpu' explicitly to run its plain PyTorch path.")
    return dev
