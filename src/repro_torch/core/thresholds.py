"""Threshold selection strategies for supervisors (paper §4.5).

Three calibration modes:
  * nominal-distribution fit (Stocco et al. [54]): threshold at a target
    false-alarm quantile of NOMINAL validation confidences;
  * two-distribution separation (Dola et al. [10]): best separator between
    a nominal and an invalid confidence sample;
  * escalation-rate targeting (ours, for the runtime cascade): threshold
    whose expected remote fraction equals a budget rho — this is how the
    paper's "percentage of remote predictions" axis is hit in production.

All return plain floats; the runtime treats thresholds as *runtime-tunable
configuration* (paper §4.5 "Runtime Configuration"), see serving.scheduler.
"""

from __future__ import annotations

import numpy as np


def nominal_quantile_threshold(nominal_conf: np.ndarray,
                               false_alarm_rate: float) -> float:
    """Threshold so that `false_alarm_rate` of nominal inputs are rejected."""
    conf = np.sort(np.asarray(nominal_conf, np.float64))
    k = int(np.floor(false_alarm_rate * conf.size))
    if k <= 0:
        return float(conf[0]) - 1e-9
    return float(conf[k - 1])


def separation_threshold(nominal_conf: np.ndarray,
                         invalid_conf: np.ndarray) -> float:
    """Dola et al.: threshold maximising balanced accuracy of separating
    nominal (should be accepted) from invalid (should be rejected)."""
    nominal = np.asarray(nominal_conf, np.float64)
    invalid = np.asarray(invalid_conf, np.float64)
    cand = np.unique(np.concatenate([nominal, invalid]))
    best_t, best_sc = float(cand[0]) - 1e-9, -1.0
    for t in cand:
        tpr = np.mean(nominal > t)          # nominal accepted
        tnr = np.mean(invalid <= t)         # invalid rejected
        sc = 0.5 * (tpr + tnr)
        if sc > best_sc:
            best_sc, best_t = sc, float(t)
    return best_t


def escalation_rate_threshold(conf: np.ndarray, remote_fraction: float) -> float:
    """Threshold whose escalation rate (conf <= t) equals remote_fraction."""
    conf = np.sort(np.asarray(conf, np.float64))
    k = int(round(remote_fraction * conf.size))
    if k <= 0:
        return float(conf[0]) - 1e-9
    if k >= conf.size:
        return float(conf[-1]) + 1e-9
    return float(conf[k - 1])
