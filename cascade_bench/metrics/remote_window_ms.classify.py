"""The mean transport window over the window: the program's
``TransportStats.latency_samples`` (submit of a window of at most 8
escalated rows to its answer on the host, successful windows)."""

import numpy as np


def read(run):
    s = run.window.transport_s
    return float(np.mean(s)) * 1e3 if s else None
