"""The 95th percentile, over every request due in the window, of its
hand-back time less its due time (host clock); a request that failed or
never came back counts as missing (infinite)."""

import math

import numpy as np

from cascade_bench.check import transport_failed


def read(run):
    w = run.window
    failed = {r.uid for r in w.responses if transport_failed(r)}
    lat = [math.inf if i in failed else s
           for i, s in enumerate(w.latencies_s)]
    p = float(np.percentile(lat, 95)) * 1e3
    return p if math.isfinite(p) else None
