"""The 90th percentile of the seconds of every pair of the window, each
from the call of `match()` to its return with host arrays."""

import numpy as np


def read(run):
    if not run.items or not hasattr(run.loop, "pairs"):
        return None
    return float(np.percentile(run.items, 90))
