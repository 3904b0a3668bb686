"""The scheduler's median hand-back time: each request's
``Response.latency_s`` (from its due time, which the open loop stamps as
its enqueue time) less the generator's lag in submitting it, so from
``submit`` to hand-back."""

import numpy as np


def read(run):
    w = run.window
    lag = w.lags_s
    t = [r.latency_s - lag[r.uid] for r in w.responses if r.uid < len(lag)]
    return float(np.median(t)) * 1e3 if t else None
