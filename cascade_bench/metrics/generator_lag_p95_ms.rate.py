"""The load generator's 95th percentile lag: a request's submit time
less its due time (host clock). A large lag means the harness, not the
system, held requests back."""

import numpy as np


def read(run):
    lag = run.window.lags_s
    return float(np.percentile(lag, 95)) * 1e3 if lag else None
