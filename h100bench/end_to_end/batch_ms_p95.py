"""The 95th percentile, over every batch of the window, of the time from
the submit call that took a batch to the moment its labels were on the
host (numpy's linear percentile)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
