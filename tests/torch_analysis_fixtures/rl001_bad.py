"""Known-bad RL001 fixture: one of every hot-path sync pattern, in torch."""
# repro: hot-path
import numpy as np
import torch


def leaky_step(plan, k, x, stream):
    err = x.item()
    rows = x.amax(dim=1).tolist()
    host = x.cpu()
    back = x.to("cpu", torch.float64)
    torch.cuda.synchronize()
    stream.synchronize()
    arr = np.asarray(x)
    print("step", k)
    scale = float(torch.max(x))
    if torch.any(x > 0):
        x = x * scale
    while (x > 0).all():
        x = x - err
    return x, rows, host, back, arr
