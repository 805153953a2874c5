"""The 90th percentile of every wave's time in the window (linear between
the closest ranks): the time a burst waits for all its decisions."""

import numpy as np


def read(rec):
    return float(np.percentile([w["wave_s"] for w in rec["waves"]], 90)
                 * 1e3)
