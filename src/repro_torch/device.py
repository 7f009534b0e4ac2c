"""Device resolution shared by every entry point of the port.

``None`` means the CUDA device: the port is written for the GPU and never
carries on silently on the CPU. A caller that wants the CPU (the tests, a
rehearsal run) asks for it by name.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for (or
    defaulted to) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly")
        if dev.index is None:   # compare equal to a tensor's device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
