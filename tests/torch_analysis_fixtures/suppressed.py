"""Suppression fixture: a real RL001 finding carrying a justified allow
comment -- reported as [allowed], does not fail the run."""
# repro: hot-path


def boundary(x):
    # repro: allow[RL001] boundary decode: the solve is already complete here
    return x.cpu()
