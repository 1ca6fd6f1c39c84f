"""Device resolution shared by every entry point of the port.

The card is the default: ``None`` means ``cuda``. A request for ``cuda`` on a
machine without a usable GPU raises instead of carrying on on the CPU; the
CPU is used only when the caller asks for it (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
