"""Known-good RL001 fixture: host-side bookkeeping the taint pass must
recognize (numpy/math results, tensor metadata, coercions of already-host
values), and device work that never leaves the device."""
# repro: hot-path
import math

import numpy as np
import torch


def plan_table(n, x):
    ts = np.linspace(0.0, 1.0, n)
    tab = np.asarray(ts, dtype=np.float64)
    total = float(np.sum(tab))
    if len(ts) > 3 and math.isfinite(total):
        tab = tab * 2.0
    k = int(len(ts))
    if x.ndim != 3 or x.dtype != torch.float32 or not torch.is_floating_point(x):
        raise ValueError("x must be (R, M, D) float32")
    rows = int(x.shape[0]) + x.numel() // max(1, x.size(0))
    err = torch.where((x > 0).any(dim=-1), x.amax(dim=-1), x.amin(dim=-1))
    return tab, total, k, rows, err
