"""Device dispatch for the port's kernels.

The counterpart of ``repro.kernels.runtime``, which chose between a
compiled Pallas lowering and the interpreter per backend. Here the rule is
one line per device type, decided by where the operands lie:

* a CUDA tensor -> the hand-written kernel (it launches, or the call
  raises; nothing falls back to the plain version on the card);
* a CPU tensor -> the kernel's plain PyTorch version (the CPU tests);
* anything else, or operands on different devices -> ``ValueError``.
"""
from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the operands lie on a CUDA device (launch the kernel),
    False when they lie on the CPU (take the plain version)."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"kernel operands must share one device, got "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {dev}")


def route_takes(name: str, dtype: torch.dtype, own: str) -> bool:
    """Whether K2's or K3's route ``name`` takes operands of ``dtype`` whose
    own route is ``own``: ``cuda_cores`` any float32 and ``mma_sync`` any
    bf16; ``tf32x3`` and ``wgmma`` only the operands that route to them."""
    f32 = dtype == torch.float32
    return {"cuda_cores": f32, "mma_sync": not f32, "tf32x3": own == "tf32x3",
            "wgmma": own == "wgmma"}.get(name, False)
