"""The 95th percentile of every request's time in the window, from the
call to its labels on the host (numpy's linear interpolation)."""
import numpy as np


def read(run):
    if not run.units:
        return None
    return float(np.percentile([1e3 * u["wall_s"] for u in run.units], 95))
