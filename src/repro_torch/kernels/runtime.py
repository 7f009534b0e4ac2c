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



def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` on its device whose data starts one element
    (2 bytes in bf16, 4 in float32) past a 16-byte line. Neither TMA nor a
    16-byte cp.async can copy it, so K2 and K3 take it on their mma_sync
    (bf16) or cuda_cores (float32) route: the operands that reach those
    routes."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    if out.data_ptr() % 16 == 0:
        raise RuntimeError("the allocator returned memory off a 16-byte line")
    return out.copy_(t)
