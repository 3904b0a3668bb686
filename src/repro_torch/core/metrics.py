"""Evaluation metrics from the paper (§5.1, §5.2) — the port's own copy of
``repro.core.metrics`` (pure numpy; the port imports nothing of
``repro``).

RQ1: Request-Accuracy Curve (RAC) + AUC-RAC (Eq. 1).
RQ2: supervised accuracy, acceptance rate Delta, S-beta score
     [Weiss & Tonella 2021].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RAC:
    """Request-Accuracy Curve: system accuracy as a function of the remote
    fraction r, sweeping the 1st-level supervisor threshold over every
    input's confidence value (threshold-agnostic, as in §5.1)."""
    remote_fraction: np.ndarray   # [n+1] in [0, 1]
    accuracy: np.ndarray          # [n+1] system accuracy at that fraction

    @property
    def local_only(self) -> float:
        return float(self.accuracy[0])

    @property
    def remote_only(self) -> float:
        return float(self.accuracy[-1])

    def knee_points(self) -> dict[str, float]:
        """Named operating points used in §5.4.3: the best fraction and the
        remote-even fraction (fewest remote calls matching remote-only)."""
        best_i = int(np.argmax(self.accuracy))
        even = np.nonzero(self.accuracy >= self.remote_only - 1e-12)[0]
        even_i = int(even[0]) if len(even) else len(self.accuracy) - 1
        return {
            "best": float(self.remote_fraction[best_i]),
            "best_accuracy": float(self.accuracy[best_i]),
            "remote_even": float(self.remote_fraction[even_i]),
            "remote_even_accuracy": float(self.accuracy[even_i]),
        }


def request_accuracy_curve(local_conf: np.ndarray, local_correct: np.ndarray,
                           remote_correct: np.ndarray) -> RAC:
    """Exact paper semantics: for each i in 0..n, escalate the i inputs with
    the LOWEST local confidence to the remote model and measure system
    accuracy.

    local_conf: [n] 1st-level supervisor confidences,
    local_correct / remote_correct: [n] 0/1 per-input correctness.
    """
    n = local_conf.shape[0]
    order = np.argsort(local_conf, kind="stable")  # ascending: escalate first
    lc = np.asarray(local_correct, np.float64)[order]
    rc = np.asarray(remote_correct, np.float64)[order]
    # prefix i escalated -> remote; suffix -> local
    gain = np.concatenate([[0.0], np.cumsum(rc - lc)])
    acc = (np.sum(lc) + gain) / n
    return RAC(remote_fraction=np.arange(n + 1) / n, accuracy=acc)


def auc_rac(rac: RAC) -> float:
    """Eq. 1: mean accuracy over all thresholds, normalised to the
    local-only/remote-only accuracies. Random supervision -> 0.5; can
    exceed 1 under strong superaccuracy, or go below 0."""
    mean_acc = float(np.mean(rac.accuracy))
    denom = rac.remote_only - rac.local_only
    if abs(denom) < 1e-12:
        return float("nan")
    return (mean_acc - rac.local_only) / denom


# --------------------------------------------------------------------------
# RQ2 metrics
# --------------------------------------------------------------------------

def supervised_metrics(accepted: np.ndarray, correct: np.ndarray,
                       betas: tuple[float, ...] = (0.5, 1.0, 2.0)) -> dict:
    """Supervised accuracy (ACC-bar), acceptance rate (Delta) and S-beta.

    accepted: [n] bool — inputs the (two-level) supervisor trusts;
    correct:  [n] bool — correctness of the prediction the system returns.
    S_beta = (1+beta^2) * (acc * delta) / (beta^2 * acc + delta) —
    the weighted harmonic mean of supervised accuracy and acceptance rate
    [Weiss & Tonella 2021]; beta>1 weighs acceptance more.
    """
    accepted = np.asarray(accepted, bool)
    correct = np.asarray(correct, bool)
    n = accepted.shape[0]
    delta = float(np.mean(accepted)) if n else 0.0
    acc = float(np.mean(correct[accepted])) if accepted.any() else 0.0
    out = {"acc_supervised": acc, "delta": delta}
    for b in betas:
        b2 = b * b
        denom = b2 * acc + delta
        out[f"s_{b}"] = (1 + b2) * acc * delta / denom if denom > 0 else 0.0
    return out


def threshold_for_fpr(conf: np.ndarray, correct: np.ndarray,
                      target_fpr: float) -> float:
    """Pick a threshold such that the false-positive rate — correct
    predictions that get REJECTED — equals target_fpr (paper §5.2, in line
    with Stocco et al. / Catak et al.).

    Returns t such that P(conf <= t | correct) ~= target_fpr.
    """
    conf_correct = np.sort(np.asarray(conf)[np.asarray(correct, bool)])
    if conf_correct.size == 0:
        return float("-inf")
    k = int(np.floor(target_fpr * conf_correct.size))
    if k <= 0:
        return float(conf_correct[0]) - 1e-9
    return float(conf_correct[k - 1])
