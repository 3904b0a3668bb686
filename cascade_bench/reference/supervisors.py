"""The plain reference of the two supervisors and the escalation gate.

* 1st supervisor: the local logits' max-softmax confidence and argmax;
  the gate escalates the ``k = min(eligible, capacity, real)`` least
  confident of the window's real rows, eligible being those under the
  threshold ``t_local`` (none set: every row), ascending by confidence;
  ``capacity = ceil(budget * batch)``, clipped to [1, batch].
* 2nd supervisor: the remote answer's max-softmax confidence against
  ``t_remote`` (accepted above it); for a generated answer, the least
  likely of its tokens (``seq_min_likelihood``).
* ``t_remote``: the nominal false-alarm quantile of a calibration
  sample (the paper's §4.5 fit).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def max_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), -1).amax(-1)


def capacity(batch: int, budget: float) -> int:
    return max(1, min(batch, math.ceil(budget * batch)))


def escalations(conf: np.ndarray, real: int, cap: int,
                t_local: float | None = None) -> np.ndarray:
    """The window's escalated rows, ascending by confidence (the lower
    row first on ties)."""
    conf = np.asarray(conf, np.float64)[:real]
    rows = np.flatnonzero(conf < (np.inf if t_local is None else t_local))
    rows = rows[np.argsort(conf[rows], kind="stable")]
    return rows[:min(rows.size, cap, real)]


def seq_min_likelihood(token_likelihoods: torch.Tensor) -> torch.Tensor:
    return token_likelihoods.amin(-1)


def nominal_quantile_threshold(conf, false_alarm_rate: float) -> float:
    """The threshold that rejects ``false_alarm_rate`` of the nominal
    sample: its k-th smallest value, k = floor(rate * n)."""
    conf = np.sort(np.asarray(conf, np.float64))
    k = int(np.floor(false_alarm_rate * conf.size))
    return float(conf[0]) - 1e-9 if k <= 0 else float(conf[k - 1])
