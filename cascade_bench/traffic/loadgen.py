"""Open-loop arrivals: every request's due time fixed before serving.

The Poisson process is the one of ``benchmarks/loadgen.py``
(exponential gaps at ``rate``), rewritten without the program. Every
seed gets the same multiset of gaps, drawn once from ``ARRIVAL_SEED``;
the run's seed only orders them. So each run offers the same number of
requests over the same span, and a seed changes when they come, not how
much work there is.
"""

from __future__ import annotations

import numpy as np

ARRIVAL_SEED = 0


def poisson_gaps(rate: float, seconds: float) -> np.ndarray:
    """round(rate * seconds) exponential gaps of mean 1 / rate, scaled so
    that they sum to ``seconds`` (the last arrival falls at the close)."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(ARRIVAL_SEED).exponential(1.0 / rate, n)
    return gaps * (seconds / gaps.sum())


def due_times(rng: np.random.Generator, rate: float,
              seconds: float) -> np.ndarray:
    """Due times in [0, seconds], ascending: the gaps in the order that
    ``rng`` (the run's seed) draws."""
    gaps = poisson_gaps(rate, seconds)
    return np.cumsum(gaps[rng.permutation(gaps.size)])
