"""Known-good RL005 fixture: device=None resolved by the caller's rule, a
CUDA default, and an `except` that re-raises a clearer error."""
import subprocess

from . import build


def fused_step(x, hist, device=None):
    return x if device is None else x.to(device), hist


def warm(shape, device="cuda"):
    return shape, device


def flash(q, k, v):
    try:
        fn = build.entry("flash_attention", "flash_attention_fwd", [])
    except subprocess.CalledProcessError as e:
        raise RuntimeError("the flash_attention kernel did not build") from e
    return fn(q, k, v)
