"""Device policy shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Never falls back quietly: asking for CUDA on a machine
    without it raises."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU"
        )
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {resolved}")
    return resolved
