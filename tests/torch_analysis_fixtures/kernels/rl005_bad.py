"""Known-bad RL005 fixture: device parameters defaulting to the CPU, and
kernel wrappers whose `except` falls back to the plain version or
swallows the kernel's error."""
import torch

from . import build, ref


def fused_step(x, hist, device="cpu"):
    return x.to(device), hist


def make_state(shape, *, device=torch.device("cpu")):
    return torch.zeros(shape, device=device)


def flash(q, k, v):
    try:
        fn = build.entry("flash_attention", "flash_attention_fwd", [])
    except RuntimeError:
        return ref.flash_attention_ref(q, k, v)
    return fn(q, k, v)


def scan(x, a, B, C):
    try:
        fn = build.entry("ssd_scan", "ssd_scan_fwd", [])
    except ImportError:
        return None
    return fn(x, a, B, C)
